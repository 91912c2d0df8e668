"""The port's INT8 / FP8 scaled matmuls, the DeepSeek-V3 projection GEMMs,
the E2M1 codes and the NVFP4 GEMMs against the JAX package's on the same
inputs (numpy, from a seed). None of these is a TPU kernel in JAX.

Tolerances: int8 products are exact on both sides, then the same float32
epilogue: 1e-6 relative. fp8 and bf16 products sum in float32 in another
order: 1e-5 of the output's scale (float32 outputs), one bf16 ulp (2^-7 of
the scale) for bf16 outputs. The E2M1 codes, the NVFP4 packed bytes and
their fp8 scales are equal bit for bit."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops import quant as jquant
from sgl_kernel_tpu.ops.gemm import fp4 as jfp4
from sgl_kernel_tpu.ops.gemm import scaled_mm as jsm
from sgl_kernel_tpu.ops.quant import formats as jformats
from sgl_kernel_tpu_torch import tensor_from_numpy
from sgl_kernel_tpu_torch.ops.gemm import fp4, scaled_mm
from sgl_kernel_tpu_torch.ops.quant import formats

torch.set_num_threads(1)


def t_(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def close(out, ref, rel):
    ref = np.asarray(ref, np.float32)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(out.float().numpy() - ref).max()) <= tol


@pytest.mark.parametrize("m,n,k", [(32, 128, 256), (7, 512, 384), (1, 256, 128)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_scaled_mm(m, n, k, with_bias):
    rng = np.random.default_rng(m + n)
    a = rng.integers(-128, 127, (m, k)).astype(np.int8)
    b = rng.integers(-128, 127, (k, n)).astype(np.int8)
    sa = (rng.random(m) * 0.01 + 0.001).astype(np.float32)
    sb = (rng.random(n) * 0.01 + 0.001).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
    for dt, jdt, rel in ((torch.float32, jnp.float32, 1e-6), (torch.bfloat16, jnp.bfloat16, 2.0 ** -7)):
        ref = jsm.int8_scaled_mm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa), jnp.asarray(sb), out_dtype=jdt,
                                 bias=None if bias is None else jnp.asarray(bias))
        out = scaled_mm.int8_scaled_mm(t_(a), t_(b), t_(sa), t_(sb), dt, None if bias is None else t_(bias))
        assert out.dtype == dt
        close(out, ref, rel)
    assert torch.equal(scaled_mm.int_mm_exact(t_(a), t_(b)),
                       torch.from_numpy(a.astype(np.int64) @ b.astype(np.int64)).to(torch.int32))


def test_fp8_scaled_mm_and_bmm():
    rng = np.random.default_rng(1)
    af = rng.standard_normal((16, 512)).astype(np.float32)
    bf = rng.standard_normal((512, 256)).astype(np.float32)
    aq, sa = jquant.per_token_quant_fp8(jnp.asarray(af))
    bqt, sb = jquant.per_token_quant_fp8(jnp.asarray(bf.T))
    ref = jsm.fp8_scaled_mm(aq, bqt.T, sa[:, 0], sb[:, 0], out_dtype=jnp.float32)
    out = scaled_mm.fp8_scaled_mm(t_(aq), t_(np.asarray(bqt).T), t_(sa[:, 0]), t_(sb[:, 0]), torch.float32)
    close(out, ref, 1e-5)
    a = rng.standard_normal((3, 8, 128)).astype(np.float32)
    w = rng.standard_normal((3, 128, 64)).astype(np.float32)
    aq, s_a = jquant.per_tensor_quant_fp8(jnp.asarray(a))
    wq, s_w = jquant.per_tensor_quant_fp8(jnp.asarray(w))
    ref = jsm.bmm_fp8(aq, wq, s_a[0], s_w[0], out_dtype=jnp.float32)
    out = scaled_mm.bmm_fp8(t_(aq), t_(wq), t_(s_a[0]), t_(s_w[0]), torch.float32)
    close(out, ref, 1e-5)
    assert scaled_mm.bmm_fp8(t_(aq), t_(wq), t_(s_a[0]), t_(s_w[0])).dtype == torch.bfloat16


def test_dsv3_gemms():
    rng = np.random.default_rng(2)
    h = rng.standard_normal((5, 256)).astype(ml_dtypes.bfloat16)
    rw = rng.standard_normal((16, 256)).astype(ml_dtypes.bfloat16)
    ref = jsm.dsv3_router_gemm(jnp.asarray(h), jnp.asarray(rw))
    out = scaled_mm.dsv3_router_gemm(t_(h), t_(rw))
    assert out.dtype == torch.float32
    close(out, ref, 1e-5)
    wa = rng.standard_normal((256, 64)).astype(ml_dtypes.bfloat16)
    ref = jsm.dsv3_fused_a_gemm(jnp.asarray(h), jnp.asarray(wa))
    out = scaled_mm.dsv3_fused_a_gemm(t_(h), t_(wa))
    assert out.dtype == torch.bfloat16
    close(out, ref, 2.0 ** -7)


def test_e2m1_codes():
    """Every code decodes to JAX's value (-0.0 included); encoding hits the
    round-to-even boundaries, both signs, beyond the largest value, NaN."""
    codes = np.arange(16, dtype=np.uint8)
    np.testing.assert_array_equal(formats.e2m1_decode(t_(codes)).numpy(), np.asarray(jformats.e2m1_decode(codes)))
    assert np.signbit(formats.e2m1_decode(t_(codes)).numpy()[8])
    grid = np.concatenate([np.arange(-8, 8.01, 0.125), [0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, 1e9, -1e-9, np.nan]])
    grid = grid.astype(np.float32)
    np.testing.assert_array_equal(formats.e2m1_encode(t_(grid)).numpy(), np.asarray(jformats.e2m1_encode(grid)))


def quant_inputs(rng, m, k):
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    x[0, :16] = 1e-6  # a near-zero group: zero codes
    return x


@pytest.mark.parametrize("gs", [1.0, 448.0 * 6 / 3.7])
def test_scaled_fp4_quant_bytes(gs):
    rng = np.random.default_rng(3)
    x = quant_inputs(rng, 6, 64)
    jp, js = jfp4.scaled_fp4_quant(jnp.asarray(x), jnp.float32(gs))
    tp, ts = fp4.scaled_fp4_quant(t_(x), gs)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert ts.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(ts.view(torch.uint8).numpy(), np.asarray(js).view(np.uint8))
    if gs == 1.0:  # the near-zero group's scale clamps at 2^-9: zero codes (tests/test_gemm.py:441-450)
        assert ((tp[0, :8].numpy() & 0x77) == 0).all()


def test_scaled_fp4_experts_quant_bytes():
    rng = np.random.default_rng(4)
    x = quant_inputs(rng, 10, 32)
    gsc = np.array([1.0, 20.0, 300.0], np.float32)
    offs = np.array([0, 3, 3, 10], np.int32)
    jp, js = jfp4.scaled_fp4_experts_quant(jnp.asarray(x), jnp.asarray(gsc), jnp.asarray(offs))
    tp, ts = fp4.scaled_fp4_experts_quant(t_(x), t_(gsc), t_(offs))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.view(torch.uint8).numpy(), np.asarray(js).view(np.uint8))


def test_fp4_scaled_mm_and_group_mm():
    rng = np.random.default_rng(5)
    m, n, k = 12, 48, 64
    ap, sa = jfp4.scaled_fp4_quant(jnp.asarray(quant_inputs(rng, m, k)), jnp.float32(100.0))
    bp, sb = jfp4.scaled_fp4_quant(jnp.asarray(rng.standard_normal((n, k)).astype(np.float32)), jnp.float32(50.0))
    alpha = np.float32(1 / 5000.0)
    ref = jfp4.fp4_scaled_mm(ap, bp, sa, sb, jnp.asarray(alpha), out_dtype=jnp.float32)
    out = fp4.fp4_scaled_mm(t_(ap), t_(bp), t_(sa), t_(sb), torch.tensor(alpha), torch.float32)
    close(out, ref, 1e-5)
    e = 3
    bp, sb = jfp4.scaled_fp4_quant(jnp.asarray(rng.standard_normal((e, n, k)).astype(np.float32)), jnp.float32(50.0))
    sizes = np.array([5, 0, 4], np.int32)  # 9 of 12 rows: the last three come out zero
    alphas = np.array([1e-4, 2e-4, 3e-4], np.float32)
    ref = jfp4.fp4_group_mm(ap, bp, sa, sb, jnp.asarray(alphas), jnp.asarray(sizes), out_dtype=jnp.float32)
    out = fp4.fp4_group_mm(t_(ap), t_(bp), t_(sa), t_(sb), t_(alphas), t_(sizes), torch.float32)
    close(out, ref, 1e-5)
    assert not out[9:].any()
    assert fp4.fp4_group_mm(t_(ap), t_(bp), t_(sa), t_(sb), t_(alphas), t_(sizes)).dtype == torch.bfloat16
