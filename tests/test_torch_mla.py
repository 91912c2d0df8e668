"""The port's MLA operators against the JAX package's on the same inputs
(numpy, from a seed): ``mla_decode`` (K13a's plain twin; the Pallas kernel
in interpret mode) on bf16, int8 and fp8 e4m3 pools, with lse, with
``num_splits``, stacked and 640 wide; K13b's twin (``engine="dma"``)
against JAX's manual-DMA engine; ``mla_prefill`` (K7 at head dim 576)
with extend offsets and lse; ``mla_qkv_prep`` (K14's twin); and
``store_cache_mla``.

Tolerances. float32 q over an exactly converted pool: 2e-5 of the output's
scale (another summation order). bf16 q: the TPU kernel rounds P to bf16
before P.V (mla.py:99-101) where the port's twin keeps float32 (and its
kernel carries P as two bf16 terms), so 2^-6 of the scale. lse: 1e-4
absolute (base-2 logits of order 10). Integer outputs and copies: exact.
fp8 pools hold normal values only: the JAX upcast flushes denormals, a
known reference quirk (ROADMAP queue 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops import kvcache as jkv
from sgl_kernel_tpu.ops import rope as jrope
from sgl_kernel_tpu.ops.attention import mla as jmla
from sgl_kernel_tpu_torch import tensor_from_numpy
from sgl_kernel_tpu_torch.ops import kvcache, rope
from sgl_kernel_tpu_torch.ops.attention import mla

torch.set_num_threads(1)


def t_(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def close(out, ref, rel):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    assert np.abs(out - ref).max() <= tol, (float(np.abs(out - ref).max()), tol)


def paged_latents(rng, lengths, page, width=576, layers=1, dtype="bf16"):
    """Random latent rows for ``lengths`` paged into a [L, P, page, width]
    pool (64 zero lanes when width is 640), its page table, the pool as a
    JAX array of ``dtype`` (int8 codes, or normal fp8 values)."""
    b = len(lengths)
    n_blocks = max(1, -(-max(lengths) // page))
    n_pages = b * n_blocks + 1
    perm = rng.permutation(n_pages - 1) + 1
    table = np.zeros((b, n_blocks + 1), np.int32)  # one spare column, as the engine's tables have
    for i, n in enumerate(lengths):
        table[i, : -(-n // page)] = perm[i * n_blocks: i * n_blocks + -(-n // page)]
    shape = (layers, n_pages, page, width)
    if dtype == "int8":
        pool = jnp.asarray(rng.integers(-127, 128, shape).astype(np.int8))
    elif dtype == "e4m3":
        mag = rng.uniform(0.05, 4.0, shape) * rng.choice([-1.0, 1.0], shape)
        pool = jnp.asarray(mag.astype(np.float32)).astype(jnp.float8_e4m3fn)
    else:
        pool = jnp.asarray((rng.standard_normal(shape) * 0.5).astype(np.float32)).astype(
            jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    if width == 640:
        pool = pool.at[..., 576:].set(0)
    return pool, table


@pytest.mark.parametrize("pool_dtype,q_dtype,width,splits", [
    ("f32", "f32", 576, 1),
    ("bf16", "bf16", 576, 1),
    ("int8", "f32", 576, 1),
    ("int8", "bf16", 576, 1),
    ("e4m3", "bf16", 576, 1),
    ("f32", "f32", 576, 2),
    ("bf16", "bf16", 640, 1),
    ("f32", "f32", 640, 3),
])
def test_mla_decode_twin(pool_dtype, q_dtype, width, splits):
    rng = np.random.default_rng(11)
    lengths = [1, 0, 37, 16, 100]  # a length-0 padding row, page edges
    page, h, layers = 16, 4, 3
    pool, table = paged_latents(rng, lengths, page, width, layers, pool_dtype)
    qdt = jnp.bfloat16 if q_dtype == "bf16" else jnp.float32
    q_nope = jnp.asarray(rng.standard_normal((len(lengths), h, 512)) * 0.3, qdt)
    q_pe = jnp.asarray(rng.standard_normal((len(lengths), h, 64)) * 0.3, qdt)
    scale = 0.07 if pool_dtype in ("int8", "e4m3") else 1 / 576 ** 0.5
    lens = np.array(lengths, np.int32)
    jo, jl = jmla.mla_decode(q_nope, q_pe, pool, jnp.asarray(lens), jnp.asarray(table), 2, sm_scale=scale,
                             return_lse=True, num_splits=splits)
    to, tl = mla.mla_decode(t_(q_nope), t_(q_pe), t_(pool), t_(lens), t_(table), 2, sm_scale=scale,
                            return_lse=True, num_splits=splits)
    assert to.dtype == (torch.bfloat16 if q_dtype == "bf16" else torch.float32)
    # a length-0 padding row is compared apart: o = 0 here, while the JAX
    # function's split form gives NaN there (a reference quirk)
    valid = lens > 0
    close(to[valid], np.asarray(jo)[valid], 2.0 ** -6 if q_dtype == "bf16" else 2e-5)
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], rtol=1e-5, atol=1e-4)
    assert not to[1].any() and torch.isfinite(tl).all()
    # the unstacked pool form
    if splits == 1 and width == 576:
        jo1 = jmla.mla_decode(q_nope, q_pe, pool[2], jnp.asarray(lens), jnp.asarray(table), sm_scale=scale)
        to1 = mla.mla_decode(t_(q_nope), t_(q_pe), t_(pool[2]), t_(lens), t_(table), sm_scale=scale)
        close(to1, jo1, 2.0 ** -6 if q_dtype == "bf16" else 2e-5)


@pytest.mark.parametrize("page", [1, 16, 64, 128])
@pytest.mark.parametrize("grid", [1, 2, 17, 132, 264])
@pytest.mark.parametrize("heads", [1, 16, 40])
def test_mla_decode_work_units(page, grid, heads):
    """K13a's division of work (``work_units`` mirrors what the kernel
    computes on the device from the lengths): the blocks' shares tile all
    units in order over min(grid, ceil(units / 2)) blocks (two units a block
    where the grid allows) and differ by at most one unit; every (sequence, head
    group, 64-token unit) is covered exactly once and a run's units cover its
    tokens [0, min(length, capacity)) once (a length-0 run: one empty unit);
    the blocks that share a run are the ones whose shares meet it, and their
    partial slots never collide."""
    n_blocks = -(-130 // page)  # a table of 130 tokens or just over
    cap = n_blocks * page
    lengths = [0, 1, 63, 64, 65, cap, cap + 77]  # the last two: the table's capacity and beyond it
    units, blocks, runs = mla.work_units(lengths, n_blocks, page, heads, grid)
    groups = -(-heads // 16)
    total = groups * sum(cnt for _, cnt in units)
    sizes = [u1 - u0 for u0, u1 in blocks]
    assert len(blocks) == min(grid, -(-total // 2)) and min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert blocks[0][0] == 0 and blocks[-1][1] == total
    assert all(blocks[c][1] == blocks[c + 1][0] for c in range(len(blocks) - 1))
    order = [(b, h, j) for b, (_, cnt) in enumerate(units) for h in range(groups) for j in range(cnt)]
    assert len(order) == total and len(set(order)) == total  # each (sequence, group, unit) once
    used, u = set(), 0
    for b, (n, cnt) in enumerate(units):
        assert n == max(0, min(lengths[b], cap)) and cnt == (max(1, -(-n // 64)))
        covered = [t for j in range(cnt) for t in range(j * 64, min(n, j * 64 + 64))]
        assert covered == list(range(n))
        for h in range(groups):
            cf, cl, slots = runs[(b, h)]
            owners = [c for c, (u0, u1) in enumerate(blocks) if u0 < u + cnt and u1 > u]
            assert owners == list(range(cf, cl + 1))
            assert len(slots) == (0 if cf == cl else cl - cf + 1)
            for c, slot in zip(range(cf, cl + 1), slots):
                assert (c, slot) not in used
                used.add((c, slot))
            u += cnt
    assert u == total


def test_mla_decode_raises():
    """Unknown engines and pool widths raise; ``engine="dma"`` (K13b) runs
    its twin on CPU tensors (lse -inf for a length-0 row) and takes a
    one-byte 576-wide pool to K13a's twin, as JAX's dispatch does."""
    q = torch.zeros(1, 2, 512)
    args = (torch.ones(1, 2, 64), torch.ones(4, 16, 576), torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, 2, dtype=torch.int32))
    with pytest.raises(ValueError):
        mla.mla_decode(q, *args, engine="pallas")
    with pytest.raises(ValueError):
        mla.mla_decode(q, torch.zeros(1, 2, 64), torch.zeros(4, 16, 512), torch.ones(1, dtype=torch.int32),
                       torch.zeros(1, 2, dtype=torch.int32))
    out, lse = mla.mla_decode(q, *args, engine="dma", return_lse=True)
    assert not out.any() and torch.isneginf(lse).all()
    out, lse = mla.mla_decode(q, args[0], args[1].to(torch.int8), *args[2:], engine="dma", return_lse=True)
    assert not out.any() and torch.isfinite(lse).all()  # K13a's -1e30 * log2(e)
    assert mla.mla_decode_dma.launches == 0 and mla.mla_decode.launches == 0


@pytest.mark.parametrize("pool_dtype,q_dtype,width,splits", [
    ("bf16", "bf16", 576, 1),
    ("f32", "f32", 576, 1),
    ("bf16", "bf16", 640, 1),
    ("e4m3", "bf16", 640, 1),
    ("int8", "f32", 640, 1),
    ("bf16", "bf16", 576, 2),
    ("e4m3", "bf16", 576, 1),  # a one-byte 576 pool: K13a on both sides
])
def test_mla_decode_dma_twin(pool_dtype, q_dtype, width, splits):
    """``mla_decode(engine="dma")``: K13b's twin against JAX's manual-DMA
    engine in interpret mode on a stacked pool, with lse; with splits, the
    pseudo-sequences merged by lse (a length-0 row merges lses of -inf only:
    NaN in JAX, o = 0 and lse -inf in the port, as unsplit). Tolerances as
    test_mla_decode_twin."""
    rng = np.random.default_rng(15)
    lengths = [1, 0, 37, 16, 100]
    page, h, layers = 16, 4, 2
    pool, table = paged_latents(rng, lengths, page, width, layers, pool_dtype)
    qdt = jnp.bfloat16 if q_dtype == "bf16" else jnp.float32
    q_nope = jnp.asarray(rng.standard_normal((len(lengths), h, 512)) * 0.3, qdt)
    q_pe = jnp.asarray(rng.standard_normal((len(lengths), h, 64)) * 0.3, qdt)
    scale = 0.07 if pool_dtype in ("int8", "e4m3") else 1 / 576 ** 0.5
    lens = np.array(lengths, np.int32)
    kw = dict(sm_scale=scale, return_lse=True, num_splits=splits, engine="dma")
    jo, jl = jmla.mla_decode(q_nope, q_pe, pool, jnp.asarray(lens), jnp.asarray(table), 1, **kw)
    to, tl = mla.mla_decode(t_(q_nope), t_(q_pe), t_(pool), t_(lens), t_(table), 1, **kw)
    valid = lens > 0
    close(to[valid], np.asarray(jo)[valid], 2.0 ** -6 if q_dtype == "bf16" else 2e-5)
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], rtol=1e-5, atol=1e-4)
    assert not to[1].any()
    if splits == 1 and (pool_dtype in ("bf16", "f32") or width == 640):  # K13b: lse -inf on both sides
        assert np.isneginf(tl.numpy()[1]).all() and np.isneginf(np.asarray(jl)[1]).all()
    if splits > 1:
        assert np.isneginf(tl.numpy()[1]).all() and np.isnan(np.asarray(jo, np.float32)[1]).all()


@pytest.mark.parametrize("offsets", [False, True])
def test_mla_prefill(offsets):
    """Causal prefill over the fresh latents, and the extend form: the
    queries as the last q_len of kv_len at global offsets (q_start /
    kv_start), with lse; q rows past q_len are padding and not compared."""
    rng = np.random.default_rng(12)
    b, s, skv, h = 2, 24, 40 if offsets else 24, 4
    q_nope = (rng.standard_normal((b, s, h, 512)) * 0.3).astype(np.float32)
    q_pe = (rng.standard_normal((b, s, h, 64)) * 0.3).astype(np.float32)
    kv = (rng.standard_normal((b, skv, 576)) * 0.5).astype(np.float32)
    q_lens = np.array([24, 9], np.int32)
    kv_lens = np.array([40, 30], np.int32) if offsets else q_lens
    kw = dict(q_start=np.array([16, 21], np.int32), kv_start=np.array([0, 0], np.int32)) if offsets else {}
    jo, jl = jmla.mla_prefill(jnp.asarray(q_nope), jnp.asarray(q_pe), jnp.asarray(kv), jnp.asarray(q_lens),
                              jnp.asarray(kv_lens), sm_scale=0.08, return_lse=True,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    to, tl = mla.mla_prefill(t_(q_nope), t_(q_pe), t_(kv), t_(q_lens), t_(kv_lens), sm_scale=0.08,
                             return_lse=True, **{k: t_(v) for k, v in kw.items()})
    assert to.shape == (b, s, h, 512) and tl.shape == (b, h, s)
    for i, n in enumerate(q_lens):
        close(to[i, :n], np.asarray(jo)[i, :n], 2e-5)
        np.testing.assert_allclose(tl.numpy()[i, :, :n], np.asarray(jl)[i, :, :n], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("offsets", [False, True])
@pytest.mark.parametrize("h", [16, 4])
def test_flash_attention_mla_twin(offsets, h):
    """K7's MLA entry (V the first 512 columns of the latent K, 512-wide
    output) on the CPU, its plain twin, against JAX's ``mla_prefill`` (V the
    latent zero-padded to 576, sliced back) on the same bytes: causal over the
    fresh latents, then the extend form at global offsets and a prefix pass
    in which one sequence has no prefix (o = 0, lse -1e30 * log2(e) on the
    port's side); float32, 2e-5 of the scale, lse 1e-4."""
    from sgl_kernel_tpu_torch.ops.attention import flash_prefill

    rng = np.random.default_rng(14)
    b, s, skv = 2, 24, 40 if offsets else 24
    q_nope = (rng.standard_normal((b, s, h, 512)) * 0.3).astype(np.float32)
    q_pe = (rng.standard_normal((b, s, h, 64)) * 0.3).astype(np.float32)
    kv = (rng.standard_normal((b, skv, 576)) * 0.5).astype(np.float32)
    q_lens = np.array([24, 9], np.int32)
    kv_lens = np.array([40, 0], np.int32) if offsets else q_lens
    kw = dict(q_start=np.array([40, 0], np.int32), kv_start=np.array([0, 0], np.int32)) if offsets else {}
    jo, jl = jmla.mla_prefill(jnp.asarray(q_nope), jnp.asarray(q_pe), jnp.asarray(kv), jnp.asarray(q_lens),
                              jnp.asarray(kv_lens), sm_scale=0.08, return_lse=True,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    args = (t_(q_nope), t_(q_pe), t_(kv)[:, :, None], t_(q_lens), t_(kv_lens),
            *(t_(kw[k]) if kw else None for k in ("q_start", "kv_start")))
    before = flash_prefill.flash_attention.launches_576
    for fn in (flash_prefill.flash_attention_mla, flash_prefill.flash_attention_mla_ref):
        to, tl = fn(*args, causal=True, sm_scale=0.08, return_lse=True)
        assert to.shape == (b, s, h, 512) and tl.shape == (b, h, s)
        for i, n in enumerate(q_lens):
            if kv_lens[i] == 0:  # no key: the port's convention, not compared with JAX
                assert not to[i].any() and torch.all(tl[i] == np.float32(-1e30 * flash_prefill.LOG2E))
                continue
            close(to[i, :n], np.asarray(jo)[i, :n], 2e-5)
            np.testing.assert_allclose(tl.numpy()[i, :, :n], np.asarray(jl)[i, :, :n], rtol=1e-5, atol=1e-4)
    assert flash_prefill.flash_attention.launches_576 == before  # CPU tensors: the twin, no launch


@pytest.mark.parametrize("t,dtype", [(1, "f32"), (5, "bf16"), (64, "f32")])
def test_mla_qkv_prep_twin(t, dtype):
    rng = np.random.default_rng(13)
    nh, nope, rot, lat, layers = 4, 32, 64, 512, 3
    dt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    q = jnp.asarray(rng.standard_normal((t, nh, nope + rot)), dt)
    kv = jnp.asarray(rng.standard_normal((t, lat + rot)) * 2, dt)
    w = jnp.asarray(1 + 0.1 * rng.standard_normal((layers, lat)), dt)
    cache = jrope.compute_cos_sin_cache(rot, 256, 10000.0)
    pos = rng.integers(0, 256, t).astype(np.int32)
    jout = jrope.mla_qkv_prep(jnp.asarray(pos), 1, q, kv, w, cache, nope_dim=nope, eps=1e-6)
    tout = rope.mla_qkv_prep(t_(pos), 1, t_(q), t_(kv), t_(w), t_(cache), nope_dim=nope, eps=1e-6)
    for o, r in zip(tout, jout):
        assert o.shape == r.shape and o.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
        # float32 math and one rounding on both sides: one output ulp at most
        close(o, r, 2.0 ** -8 if dtype == "bf16" else 1e-6)
    np.testing.assert_array_equal(tout[0].float().numpy(), np.asarray(jout[0], np.float32))  # a copy
    assert rope.mla_qkv_prep.launches == 0


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_store_cache_mla(dtype):
    """Rows into the flat view of a stacked pool at layer-offset slots:
    slot -1 and slots past the pool are dropped."""
    rng = np.random.default_rng(14)
    l, p, page = 2, 5, 16
    pool = np.zeros((l * p, page, 576), np.int8 if dtype == "int8" else np.float32)
    rows = (rng.integers(-127, 128, (6, 576)) if dtype == "int8" else rng.standard_normal((6, 576))).astype(pool.dtype)
    loc = np.array([3, -1, p * page + 7, 2 * p * page, 0, l * p * page - 1], np.int32)
    ref = jkv.store_cache_mla(jnp.asarray(rows), jnp.asarray(pool), jnp.asarray(loc))
    tp = t_(pool)
    out = kvcache.store_cache_mla(t_(rows), tp, t_(loc))
    assert out is tp  # in place
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
