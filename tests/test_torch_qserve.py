"""The port's QServe W4A8 GEMMs against the JAX package's on the same inputs
(numpy, from a seed): K19's twin (``qserve_w4a8_per_group_gemm`` on CPU
tensors) against the Pallas kernel in interpret mode, on the
progressive-quant operands of tests/test_gemm.py (groups 128 and 32, K not
a multiple of the TPU's k-tile, int8 or float zeros), and the per-channel
GEMM; the uint4 / int4 arrays JAX takes arrive as one code a byte. The
K19 kernel's int8 route, plainly: ``w8_int8_exact`` on QServe-made and
other weights, and the int32 product of the int8 W8 with the epilogue
against the Pallas kernel; the kernel's split plan.

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
from sgl_kernel_tpu_torch.ops.gemm.scaled_mm import int_mm_exact
from sgl_kernel_tpu_torch.utils import row_tile

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


@pytest.mark.parametrize("m,n,k,g", [(16, 256, 512, 128), (5, 128, 1376, 32), (33, 256, 512, 64)])
def test_w8_int8_exact_on_qserve_weights(m, n, k, g):
    """QServe's progressive quantization keeps every W8 an int8: the
    kernel's int8 route holds on its weights."""
    _, bq, zs2, s2, _, _ = progressive(np.random.default_rng(m + k), m, n, k, g)
    assert qserve.w8_int8_exact(t_(bq), t_(zs2), t_(s2), g)
    assert qserve.w8_int8_exact(t_(bq), t_(zs2).half(), t_(s2).to(torch.bfloat16), g)


@pytest.mark.parametrize("n,k,g", [(256, 512, 128), (128, 1376, 32), (256, 512, 64), (64, 4096, 128)])
def test_qserve_quantize_is_progressive(n, k, g):
    """``qserve_quantize`` (the card tests' and chip_smoke.py's weights)
    gives the bytes of tests/test_gemm.py's recipe (``progressive``, numpy)
    on the same float weight, and every W8 of them is an int8."""
    _, bq, zs2, s2, ws, _ = progressive(np.random.default_rng(n + k), 1, n, k, g)
    rng = np.random.default_rng(n + k)
    rng.standard_normal((1, k))  # progressive's activations, then its weight
    b = (rng.standard_normal((n, k)) * 0.01).astype(np.float32)
    codes, zs2_t, s2_t, chn = qserve.qserve_quantize(t_(b), g)
    assert codes.dtype == torch.uint8 and s2_t.dtype == torch.int8 and zs2_t.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), bq)
    np.testing.assert_array_equal(s2_t.numpy(), s2)
    np.testing.assert_array_equal(zs2_t.numpy(), zs2)
    np.testing.assert_array_equal(chn.numpy(), ws)
    assert qserve.w8_int8_exact(codes, zs2_t, s2_t, g)


@pytest.mark.parametrize("case", ["pm240", "fractional", "one_past", "nan"])
def test_w8_int8_exact_rejects(case):
    """W8 reaching +-240 (codes and zeros drawn in 0..15, s2 in 1..16), a
    fractional s2, a single W8 of 128 and a NaN scale are not int8-exact."""
    rng = np.random.default_rng(11)
    n, k, g = 64, 256, 128
    codes = rng.integers(0, 16, (n, k)).astype(np.uint8)
    s2 = rng.integers(1, 17, (n, k // g)).astype(np.float32)
    zs2 = rng.integers(0, 16, (n, k // g)).astype(np.float32) * s2
    if case != "pm240":
        codes[:] = 3
        s2[:] = 2.0
        zs2[:] = 8.0
    if case == "fractional":
        s2[5, 1] = 1.3
    elif case == "one_past":
        codes[7, 130] = 15
        s2[7, 1], zs2[7, 1] = 9.0, 7.0  # 15 * 9 - 7 = 128
    elif case == "nan":
        s2[0, 0] = np.nan
    assert not qserve.w8_int8_exact(t_(codes), t_(zs2), t_(s2), g)
    assert qserve.w8_int8_exact(t_(codes[8:]), t_(zs2[8:]), t_(s2[8:]), g) == (case != "pm240")


def test_fast_form_is_jax_rounding():
    """The kernel's fast form of W8 (csrc/qserve_gemm.cu, w8x4_fast) in
    numpy uint32 arithmetic: two codes spread into the 16-bit lanes of a
    word, times s2, plus (1024 - zs2) in both lanes; a lane is flagged when
    (word - 0x03800380) has bits under 0xFF00FF00, and its low byte is W8.
    Over every pair of uint4 codes, s2 in 0..128 and zs2 in -512..512 (every
    seventh), a pair is flagged exactly where JAX's bf16(code * s2 - zs2)
    is not an integer in [-128, 127], and the bytes equal it elsewhere."""
    c0, c1 = (x.ravel().astype(np.uint32) for x in np.meshgrid(np.arange(16), np.arange(16)))
    s2 = np.arange(129, dtype=np.uint32)[:, None, None]
    zs2 = np.arange(-512, 513, 7, dtype=np.int64)[None, :, None]
    word = (c0 | (c1 << 16))[None, None, :] * s2 + ((1024 - zs2) * 0x10001).astype(np.uint32)
    flagged = ((word - np.uint32(0x03800380)) & np.uint32(0xFF00FF00)) != 0
    w8 = [(c.astype(np.float32)[None, None, :] * s2.astype(np.float32) - zs2.astype(np.float32))
          .astype(ml_dtypes.bfloat16).astype(np.float32) for c in (c0, c1)]
    exact = [(w == np.round(w)) & (w >= -128) & (w <= 127) for w in w8]
    np.testing.assert_array_equal(flagged, ~(exact[0] & exact[1]))
    ok = ~flagged
    for lane, w in enumerate(w8):
        got = ((word >> (16 * lane)) & 0xFF).astype(np.uint8).view(np.int8)
        np.testing.assert_array_equal(got[ok].astype(np.float32), w[ok])


@pytest.mark.parametrize("m,n,k,g", [(16, 256, 512, 128), (5, 128, 1376, 32), (33, 256, 512, 64)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16])
def test_int8_route_matches_pallas(m, n, k, g, out_dtype):
    """The kernel's int8 route in plain form, ``int_mm_exact(A_q, W8^T)``
    and the epilogue, against the Pallas kernel in interpret mode on
    progressive-quant operands. The int32 sum is exact and JAX's float32
    sum of the same integer products is exact while its partial sums stay
    below 2^24 (here |sum| < 2^21), so the two differ by the output
    rounding only: ``close``'s bound (1e-5 of the row's largest for float32,
    one f16 ulp of it for f16)."""
    rng = np.random.default_rng(m + k)
    aq, bq, zs2, s2, ws, as_ = progressive(rng, m, n, k, g)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.float16
    ref = jqs.qserve_w4a8_per_group_gemm(jnp.asarray(aq), jnp.asarray(bq).astype(jnp.uint4), jnp.asarray(zs2),
                                         jnp.asarray(s2), jnp.asarray(ws), jnp.asarray(as_), group_size=g,
                                         out_dtype=jdt)
    w8 = qserve.dequant_w8(t_(bq), t_(zs2), t_(s2), g)
    assert qserve.w8_int8_exact(t_(bq), t_(zs2), t_(s2), g)
    acc = int_mm_exact(t_(aq), w8.to(torch.int8).T)
    assert int(acc.abs().max()) < 2 ** 21
    out = qserve._epilogue(acc.float(), t_(as_), t_(ws), out_dtype)
    close(out, ref, out_dtype)


@pytest.mark.parametrize("m,n,k", [(16, 6144, 4096), (16, 4096, 4096), (16, 28672, 4096), (16, 4096, 14336),
                                   (1, 256, 512), (33, 200, 1376), (1024, 6144, 4096), (130, 128, 131072)])
def test_k19_split_plan(m, n, k):
    """The kernel's launch plan: K splits over blocks in whole 256-deep
    k-tiles only while the tiles leave the SMs' block slots (132 SMs, two
    blocks an SM at 16 rows) unfilled; every split non-empty, the k
    range covered once, and never more blocks than slots."""
    rows = row_tile(m)
    tiles = -(-n // qserve.TILE_N) * -(-m // rows)
    n_k = -(-k // qserve.TILE_K)
    slots = 132 * qserve.blocks_per_sm(rows)
    split, per = qserve.split_plan(tiles, n_k, slots)
    assert (split - 1) * per < n_k <= split * per
    assert split == 1 if tiles >= slots else tiles * split <= slots


def test_nibble_arrays_arrive_as_bytes():
    codes = np.array([[0, 7, 15], [3, 8, 1]], np.uint8)
    u4 = np.asarray(jnp.asarray(codes).astype(jnp.uint4))
    t = t_(u4)
    assert t.dtype == torch.uint8 and t.tolist() == codes.tolist()
    s4 = np.array([-8, -1, 0, 7], np.int8).astype(ml_dtypes.int4)
    t = t_(s4)
    assert t.dtype == torch.int8 and t.tolist() == [-8, -1, 0, 7]
