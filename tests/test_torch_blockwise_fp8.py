"""The port's blockwise-fp8 GEMMs against the JAX package's on the same
inputs (numpy, from a seed): K17's twin (``fp8_blockwise_scaled_mm`` on CPU
tensors) and K18's (``fp8_blockwise_scaled_grouped_mm``) against the Pallas
kernels in interpret mode, on production-scaled data (per-128 amax scaling:
normal e4m3 codes), compact and prepared scale forms, a bf16 A; the port
against a float64 oracle; every e4m3 code converted exactly.

Tolerances: JAX rounds a * sa to bf16 before each group's dot (and the
port does not), so the two agree within that rounding: 2^-8 of the row's
largest |output|. The port against the float64 oracle: 1e-5 of the
output's scale (float32 sums). The prepared and the compact scale forms
give the port's outputs bit for bit."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops.gemm import blockwise_fp8 as jbw
from sgl_kernel_tpu_torch import tensor_from_numpy
from sgl_kernel_tpu_torch.ops.gemm import blockwise_fp8 as bw

torch.set_num_threads(1)

E4M3 = ml_dtypes.float8_e4m3fn


def t_(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def production(rng, m, k, n, e=None):
    """Per-128 amax-scaled operands (codes spread toward +-448) and scales."""
    lead = () if e is None else (e,)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((*lead, k, n)).astype(np.float32)
    sa = np.abs(a).reshape(m, k // 128, 128).max(-1) / 448.0
    aq = (a / np.repeat(sa, 128, 1)).astype(E4M3)
    sb = np.abs(b.reshape(*lead, k // 128, 128, n // 128, 128)).max(axis=(-3, -1)) / 448.0
    sb_full = np.repeat(np.repeat(sb, 128, -2), 128, -1)
    bq = (b / sb_full).astype(E4M3)
    return aq, bq, sa.astype(np.float32), sb.astype(np.float32)


def oracle(aq, bq, sa, sb):
    sb_full = np.repeat(np.repeat(sb.astype(np.float64), 128, -2), 128, -1)
    return (aq.astype(np.float64) * np.repeat(sa.astype(np.float64), 128, 1)) @ (bq.astype(np.float64) * sb_full)


def row_close(out, ref, rel=2.0 ** -8):
    out, ref = out.float().numpy(), np.asarray(ref, np.float64)
    tol = rel * np.abs(ref).max(-1, keepdims=True)
    assert (np.abs(out - ref) <= tol).all(), float((np.abs(out - ref) / tol).max())


@pytest.mark.parametrize("m,k,n", [(1, 256, 256), (16, 512, 384), (100, 256, 128)])
@pytest.mark.parametrize("prepared", [False, True])
def test_blockwise_mm_twin_matches_pallas(m, k, n, prepared):
    rng = np.random.default_rng(m + k + n)
    aq, bq, sa, sb = production(rng, m, k, n)
    sbj = jbw.prepare_blockwise_scales(jnp.asarray(sb)) if prepared else jnp.asarray(sb)
    ref = jbw.fp8_blockwise_scaled_mm(jnp.asarray(aq), jnp.asarray(bq), jnp.asarray(sa), sbj,
                                      out_dtype=jnp.float32)
    sbt = t_(np.asarray(sbj))
    out = bw.fp8_blockwise_scaled_mm(t_(aq), t_(bq), t_(sa), sbt, torch.float32)
    assert out.shape == (m, n) and out.dtype == torch.float32
    row_close(out, ref)
    exact = oracle(aq, bq, sa, sb)
    assert np.abs(out.numpy() - exact).max() <= 1e-5 * np.abs(exact).max()


def test_prepared_scales_are_jax_bytes_and_equal_compact():
    rng = np.random.default_rng(1)
    aq, bq, sa, sb = production(rng, 8, 256, 256)
    prep = bw.prepare_blockwise_scales(t_(sb))
    np.testing.assert_array_equal(prep.numpy(), np.asarray(jbw.prepare_blockwise_scales(jnp.asarray(sb))))
    np.testing.assert_array_equal(bw.prepare_blockwise_scales(t_(sb), rebias=False).numpy(),
                                  np.asarray(jbw.prepare_blockwise_scales(jnp.asarray(sb), rebias=False)))
    o1 = bw.fp8_blockwise_scaled_mm(t_(aq), t_(bq), t_(sa), t_(sb), torch.float32)
    o2 = bw.fp8_blockwise_scaled_mm(t_(aq), t_(bq), t_(sa), prep, torch.float32)
    assert torch.equal(o1, o2)
    for dt in (torch.bfloat16, torch.float16):
        assert bw.fp8_blockwise_scaled_mm(t_(aq), t_(bq), t_(sa), prep, dt).dtype == dt


def test_bf16_activations_on_the_twin():
    """JAX also takes a non-fp8 A (upcast); so does the twin (the card raises)."""
    rng = np.random.default_rng(2)
    aq, bq, sa, sb = production(rng, 16, 256, 256)
    a = (aq.astype(np.float32) * 0.5).astype(ml_dtypes.bfloat16)
    ref = jbw.fp8_blockwise_scaled_mm(jnp.asarray(a), jnp.asarray(bq), jnp.asarray(sa), jnp.asarray(sb),
                                      out_dtype=jnp.float32)
    row_close(bw.fp8_blockwise_scaled_mm(t_(a), t_(bq), t_(sa), t_(sb), torch.float32), ref)


def test_every_e4m3_code_converts_exactly():
    """Every finite e4m3 code, subnormals included, times an identity B with
    unit scales: the exact ml_dtypes values (JAX flushes the subnormals)."""
    codes = np.arange(256, dtype=np.uint8).view(E4M3)
    vals = codes.astype(np.float64)
    codes = np.where(np.isnan(vals), np.zeros((), E4M3), codes).reshape(2, 128)
    out = bw.fp8_blockwise_scaled_mm(t_(codes), t_(np.eye(128).astype(E4M3)), torch.ones(2, 1), torch.ones(1, 1),
                                     torch.float32)
    np.testing.assert_array_equal(out.numpy(), codes.astype(np.float32))
    assert (np.abs(codes.astype(np.float32)) < 2.0 ** -6).sum() > 2  # subnormals are in the set


@pytest.mark.parametrize("bm", [16, 32])
@pytest.mark.parametrize("prepared", [False, True])
def test_grouped_twin_matches_pallas(bm, prepared):
    """K18's twin: 5 row blocks over 3 experts (one twice, apart), every
    block computed."""
    rng = np.random.default_rng(bm + prepared)
    e, k, n = 3, 256, 256
    aq, bq, sa, sb = production(rng, 5 * bm, k, n, e)
    eids = np.array([2, 0, 0, 1, 2], np.int32)
    sbj = jbw.prepare_blockwise_scales(jnp.asarray(sb)) if prepared else jnp.asarray(sb)
    ref = jbw.fp8_blockwise_scaled_grouped_mm(jnp.asarray(aq), jnp.asarray(bq), jnp.asarray(sa), sbj,
                                              jnp.asarray(eids), out_dtype=jnp.float32, bm=bm, bn=128)
    out = bw.fp8_blockwise_scaled_grouped_mm(t_(aq), t_(bq), t_(sa), t_(np.asarray(sbj)), t_(eids),
                                             torch.float32, bm=bm)
    row_close(out, ref)
    for blk, ex in enumerate(eids):
        rows = slice(blk * bm, (blk + 1) * bm)
        exact = oracle(aq[rows], bq[ex], sa[rows], sb[ex])
        assert np.abs(out[rows].numpy() - exact).max() <= 1e-5 * np.abs(exact).max()


def test_contract_errors():
    rng = np.random.default_rng(3)
    aq, bq, sa, sb = production(rng, 32, 256, 256, 2)
    with pytest.raises(ValueError):  # one expert id per row, not per block
        bw.fp8_blockwise_scaled_grouped_mm(t_(aq), t_(bq), t_(sa), t_(sb), torch.zeros(32, dtype=torch.int32), bm=16)
    with pytest.raises(ValueError):
        bw.fp8_blockwise_scaled_mm(t_(aq), t_(bq[0]), t_(sa), t_(sb[0][:1]))


@pytest.mark.parametrize("m_tiles,n_tiles", [(1, 1), (1, 28), (8, 32), (13, 2), (318, 32), (128, 16)])
def test_kernel_work_order(m_tiles, n_tiles):
    """The K17 / K18 kernel's raster (it derives it from the block index)
    against a brute-force order: every (row tile, column tile) once; groups
    of 8 row tiles in order, each walking its column tiles in turn with the
    group's row tiles side by side."""
    order = bw.work_order(m_tiles, n_tiles)
    assert sorted(order) == [(mt, nt) for mt in range(m_tiles) for nt in range(n_tiles)]
    assert order == sorted(order, key=lambda it: (it[0] // bw.RASTER_ROWS, it[1], it[0]))


@pytest.mark.parametrize("tiles,n_groups", [(16, 56), (28, 128), (28, 16), (1, 32), (10, 2), (66, 56), (67, 56),
                                            (131, 8), (132, 56), (2048, 56), (3, 1)])
def test_kernel_split_plan(tiles, n_groups):
    """The split over K: whole groups, every split non-empty, the blocks
    within the 132 SMs, and no split once the tiles fill more than half of
    them;
    the largest split of those whose blocks fit (a brute-force search)."""
    split, per = bw.split_plan(tiles, n_groups, 132)
    assert split * per >= n_groups and (split - 1) * per < n_groups
    assert split == 1 or tiles * split <= 132
    if 2 * tiles > 132:
        assert split == 1
    fits = [s for s in range(1, n_groups + 1) if tiles * s <= 132 or s == 1]
    assert split == -(-n_groups // -(-n_groups // max(fits)))


def test_kernel_tile_columns():
    """Row tiles 16 / 32 take 256 columns (two 128-byte boxes a k-row), 64 /
    128 take 128."""
    assert [bw.tile_cols(bm) for bm in (16, 32, 64, 128)] == [256, 256, 128, 128]
