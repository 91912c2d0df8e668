"""The port's QServe W4A8 GEMMs against the JAX package's on the same inputs
(numpy, from a seed): K19's twin (``qserve_w4a8_per_group_gemm`` on CPU
tensors) against the Pallas kernel in interpret mode, on the
progressive-quant operands of tests/test_gemm.py (groups 128 and 32, K not
a multiple of the TPU's k-tile, int8 or float zeros), and the per-channel
GEMM; the uint4 / int4 arrays JAX takes arrive as one code a byte.

Tolerances: both sides dequantize W8 with the same float32 operations and
one bf16 rounding, and sum exact products in float32: 1e-5 of the output's
row's largest output for float32 outputs, one f16 ulp (2^-10 of the row's
largest output) for f16 outputs. The per-channel int8 product is exact on
both sides: 1e-6 of the row's largest output."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops.gemm import qserve as jqs
from sgl_kernel_tpu_torch import tensor_from_numpy
from sgl_kernel_tpu_torch.ops.gemm import qserve

torch.set_num_threads(1)


def t_(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def quant_act(a):
    s = np.abs(a).max(-1, keepdims=True) / 127.0
    return np.clip(np.round(a / s), -128, 127).astype(np.int8), s.astype(np.float32)


def progressive(rng, m, n, k, g):
    """tests/test_gemm.py:278-292: int8 channel quant, then 4-bit groups."""
    a = (rng.standard_normal((m, k)) * 0.01).astype(np.float32)
    b = (rng.standard_normal((n, k)) * 0.01).astype(np.float32)
    aq, sa = quant_act(a)
    chn = np.abs(b).max(-1, keepdims=True) / 119
    bg = np.clip(np.round(b / chn), -119, 119).reshape(-1, g)
    s2 = np.maximum(np.round((bg.max(-1, keepdims=True) - bg.min(-1, keepdims=True)) / 15), 1.0)
    z2 = -np.round(bg.min(-1, keepdims=True) / s2)
    bq = np.clip(np.round(bg / s2) + z2, 0, 15).reshape(n, k).astype(np.uint8)
    s2 = s2.reshape(n, k // g).astype(np.int8)
    z2 = z2.reshape(n, k // g).astype(np.float32)
    return aq, bq, z2 * s2, s2, chn[:, 0].astype(np.float32), sa[:, 0]


def close(out, ref, dtype, rel=None):
    """Per row: |out - ref| <= rel * max|ref| of the row."""
    ref = np.asarray(ref, np.float32)
    rel = rel if rel is not None else (1e-5 if dtype == torch.float32 else 2.0 ** -10)
    tol = rel * np.abs(ref).max(-1, keepdims=True)
    err = np.abs(out.float().numpy() - ref)
    assert (err <= tol).all(), float((err / tol).max())


@pytest.mark.parametrize("m,n,k,g", [(16, 256, 512, 128), (5, 128, 1376, 32), (33, 256, 512, 64)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16])
def test_per_group_twin_matches_pallas(m, n, k, g, out_dtype):
    rng = np.random.default_rng(m + k)
    aq, bq, zs2, s2, ws, as_ = progressive(rng, m, n, k, g)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.float16
    ref = jqs.qserve_w4a8_per_group_gemm(jnp.asarray(aq), jnp.asarray(bq).astype(jnp.uint4), jnp.asarray(zs2),
                                         jnp.asarray(s2), jnp.asarray(ws), jnp.asarray(as_), group_size=g,
                                         out_dtype=jdt)
    w4 = np.asarray(jnp.asarray(bq).astype(jnp.uint4))  # the ml_dtypes uint4 array a JAX caller holds
    out = qserve.qserve_w4a8_per_group_gemm(t_(aq), t_(w4), t_(zs2), t_(s2), t_(ws), t_(as_), group_size=g,
                                            out_dtype=out_dtype)
    assert out.dtype == out_dtype and out.shape == (m, n)
    close(out, ref, out_dtype)


def test_per_group_f16_scales_and_int8_zeros():
    """f16 per-channel / per-token scales (the default contract) and int8
    zeros_x_s2, the default f16 output."""
    rng = np.random.default_rng(7)
    aq, bq, _, s2, ws, as_ = progressive(rng, 16, 256, 512, 128)
    zs2 = rng.integers(-20, 20, s2.shape).astype(np.int8)
    ws16, as16 = ws.astype(np.float16), (as_ * 10).astype(np.float16)
    ref = jqs.qserve_w4a8_per_group_gemm(jnp.asarray(aq), jnp.asarray(bq).astype(jnp.uint4), jnp.asarray(zs2),
                                         jnp.asarray(s2), jnp.asarray(ws16), jnp.asarray(as16))
    out = qserve.qserve_w4a8_per_group_gemm(t_(aq), t_(bq), t_(zs2), t_(s2), t_(ws16), t_(as16))
    assert out.dtype == torch.float16
    close(out, ref, torch.float16)


def test_per_group_w8_rounding_is_jax():
    """W8 = bf16(code * s2 - zs2) with float32 product and difference: the
    port's dequant equals the same numpy float32 arithmetic, bit for bit."""
    rng = np.random.default_rng(8)
    n, k, g = 64, 256, 128
    codes = rng.integers(0, 16, (n, k)).astype(np.uint8)
    s2 = (rng.random((n, k // g)) * 3).astype(np.float32)
    zs2 = (rng.standard_normal((n, k // g)) * 5).astype(np.float32)
    want = (codes.astype(np.float32).reshape(n, -1, g) * s2[..., None] - zs2[..., None]).reshape(n, k)
    want = want.astype(ml_dtypes.bfloat16)
    got = qserve.dequant_w8(t_(codes), t_(zs2), t_(s2), g)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16])
def test_per_chn_matches_jax(out_dtype):
    rng = np.random.default_rng(9)
    m, n, k = 16, 256, 512
    a = (rng.standard_normal((m, k)) * 0.01).astype(np.float32)
    b = (rng.standard_normal((n, k)) * 0.01).astype(np.float32)
    aq, sa = quant_act(a)
    bmin, bmax = b.min(-1, keepdims=True), b.max(-1, keepdims=True)
    sw = ((bmax - bmin) / 15).astype(np.float32)
    zw = -np.round(bmin / sw)
    bq = np.clip(np.round(b / sw) + zw, 0, 15).astype(np.uint8)
    args = (sw[:, 0], sa[:, 0], (zw * sw)[:, 0].astype(np.float32), a.sum(-1).astype(np.float32))
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.float16
    ref = np.asarray(jqs.qserve_w4a8_per_chn_gemm(jnp.asarray(aq), jnp.asarray(bq).astype(jnp.uint4),
                                                  *(jnp.asarray(x) for x in args), out_dtype=jdt), np.float32)
    out = qserve.qserve_w4a8_per_chn_gemm(t_(aq), t_(bq), *(t_(x) for x in args), out_dtype=out_dtype)
    assert out.dtype == out_dtype
    close(out, ref, out_dtype, 1e-6 if out_dtype == torch.float32 else 2.0 ** -10)


def test_nibble_arrays_arrive_as_bytes():
    codes = np.array([[0, 7, 15], [3, 8, 1]], np.uint8)
    u4 = np.asarray(jnp.asarray(codes).astype(jnp.uint4))
    t = t_(u4)
    assert t.dtype == torch.uint8 and t.tolist() == codes.tolist()
    s4 = np.array([-8, -1, 0, 7], np.int8).astype(ml_dtypes.int4)
    t = t_(s4)
    assert t.dtype == torch.int8 and t.tolist() == [-8, -1, 0, 7]
