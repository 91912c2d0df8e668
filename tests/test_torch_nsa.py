"""The port's NSA operators against the JAX package's on the same inputs
(numpy, from a seed): K15 ``fp8_paged_mqa_logits`` (its plain twin against
the Pallas kernel in interpret mode and against a float64 formula), the
ragged ``fp8_mqa_logits``, the three top-k functions, ``sparse_mla_decode``
and ``sparse_mla_prefill`` (on K13a's twin), the two fused indexer
preprocessors, ``hadamard_transform``, ``per_token_quant_fp8`` and
``apply_sinks``.

Tolerances. Float32 sums in another order: 1e-5 of the output's scale (the
Hadamard product: 2e-6). bf16 outputs: one bf16 ulp (2^-8 of the scale).
Sparse MLA with bf16 q: 2^-6 of the scale, as K13a's twin (the TPU kernel
rounds P to bf16 before P.V, mla.py:99-101); lse 1e-4 absolute. fp8 codes
downstream of the Hadamard rotation: within one code step (the matrix form
sums in another order than JAX's butterfly, so a value on a rounding tie may
take the neighbouring code); the quantizer alone: the same codes as JAX and
as an ``ml_dtypes`` oracle. Top-k: the same set of positions in each row as
JAX (the port breaks ties toward the lower position, as ``jax.lax.top_k``
does when k < T; the order within a row may differ).

fp8 inputs compared with the JAX kernels hold normal values only: JAX's
``_upcast`` flushes fp8 denormals to zero, where the port converts them
exactly (ROADMAP queue 3); ``test_k15_fp8_keys_convert_exactly`` checks every
code against ``ml_dtypes``."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops import hadamard as jhad
from sgl_kernel_tpu.ops import quant as jquant
from sgl_kernel_tpu.ops import rope as jrope
from sgl_kernel_tpu.ops.attention.merge_state import apply_sinks as japply_sinks
from sgl_kernel_tpu.ops.attention import nsa as jnsa
from sgl_kernel_tpu_torch import tensor_from_numpy
from sgl_kernel_tpu_torch.ops import hadamard, quant
from sgl_kernel_tpu_torch.ops.attention import nsa
from sgl_kernel_tpu_torch.ops.attention.merge_state import apply_sinks

torch.set_num_threads(1)

NP_FP8 = {"e4m3": ml_dtypes.float8_e4m3fn, "e5m2": ml_dtypes.float8_e5m2}
JNP = {"bf16": jnp.bfloat16, "f32": jnp.float32, "e4m3": jnp.float8_e4m3fn, "e5m2": jnp.float8_e5m2}


def t_(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def close(out, ref, rel):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    tol = rel * max(1.0, float(np.abs(ref[np.isfinite(ref)]).max(initial=0.0)))
    assert np.array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    assert np.abs(out[fin] - ref[fin]).max(initial=0.0) <= tol, (float(np.abs(out[fin] - ref[fin]).max()), tol)


def normal_values(rng, shape, lo=0.05, hi=4.0):
    """Random magnitudes in [lo, hi) with random signs: normal in e4m3 and e5m2."""
    return (rng.uniform(lo, hi, shape) * rng.choice([-1.0, 1.0], shape)).astype(np.float32)


def within_one_code(a, b):
    """fp8 arrays (ml_dtypes) equal or one code step apart (sign-magnitude)."""
    ua, ub = a.view(np.uint8).astype(np.int32), b.view(np.uint8).astype(np.int32)
    ma, mb = ua & 0x7F, ub & 0x7F
    same_sign = (ua >> 7) == (ub >> 7)
    return bool(np.all((same_sign & (np.abs(ma - mb) <= 1)) | ((ma <= 1) & (mb <= 1))))


def paged_keys(rng, lengths, page, d, kind, n_extra=3):
    b = len(lengths)
    n_blocks = max(1, -(-max(lengths) // page)) + 1  # a spare column: padded table entries
    n_pages = b * n_blocks + n_extra
    table = rng.permutation(n_pages)[: b * n_blocks].reshape(b, n_blocks).astype(np.int32)
    vals = normal_values(rng, (n_pages, page, d), 0.05, 2.0)
    keys = jnp.asarray(vals).astype(JNP[kind])
    return keys, table


@pytest.mark.parametrize("kind,scaled,h", [
    ("bf16", False, 4), ("e4m3", True, 4), ("e4m3", False, 5), ("e5m2", True, 12), ("e4m3", True, 64),
])
def test_k15_twin(kind, scaled, h):
    """The twin against the interpret-mode Pallas kernel and a float64
    formula: ragged lengths, a length 0, a length at a page edge, a table
    with padding entries, H not a multiple of 8, [B, H] and [H] weights."""
    rng = np.random.default_rng(1)
    page, d = 16, 128
    lengths = [37, 0, 16, 61]
    keys, table = paged_keys(rng, lengths, page, d, kind)
    b = len(lengths)
    q = jnp.asarray(rng.standard_normal((b, h, d)) * 0.2, jnp.bfloat16)
    w = rng.uniform(0.1, 1.0, (b, h)).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, keys.shape[:2]).astype(np.float32) if scaled else None
    lens = np.array(lengths, np.int32)
    for weights in (w, w[0]):  # [H] broadcast over the batch
        jout = jnsa.fp8_paged_mqa_logits(q, keys, jnp.asarray(weights), jnp.asarray(lens), jnp.asarray(table),
                                         None if scales is None else jnp.asarray(scales))
        tout = nsa.fp8_paged_mqa_logits(t_(q), t_(keys), t_(weights), t_(lens), t_(table),
                                        None if scales is None else t_(scales))
        assert tout.shape == (b, table.shape[1] * page) and tout.dtype == torch.float32
        close(tout, jout, 1e-5)
        # float64 formula: sum_h w relu(q . k) s over the gathered rows
        kf = np.asarray(keys.astype(jnp.float32), np.float64)[table].reshape(b, -1, d)
        sc = np.einsum("bhd,btd->bht", np.asarray(q.astype(jnp.float32), np.float64), kf)
        wb = np.broadcast_to(weights, (b, h))
        ref = np.einsum("bh,bht->bt", wb, np.maximum(sc, 0.0))
        if scales is not None:
            ref = ref * scales[table].reshape(b, -1)
        ref = np.where(np.arange(ref.shape[1])[None] < lens[:, None], ref, -np.inf)
        close(tout, ref, 1e-5)
    assert np.isneginf(tout[1].numpy()).all()
    assert nsa.fp8_paged_mqa_logits.launches == 0  # CPU tensors: the twin


@pytest.mark.parametrize("page", [1, 16, 64, 128])
@pytest.mark.parametrize("grid", [1, 2, 17, 132, 264])
def test_k15_work_units(page, grid):
    """K15's division of work (``work_units`` mirrors what the kernel
    computes on the device from the lengths): the blocks' shares tile all
    units in order and differ by at most one unit; every (sequence, 64-key
    unit) is covered exactly once, and a sequence's units cover its keys
    [0, min(length, capacity)) once (none at length 0: its row is all -inf,
    written by the kernel's tail pass)."""
    n_blocks = -(-130 // page)  # a table of 130 tokens or just over
    cap = n_blocks * page
    lengths = [0, 1, 63, 64, 65, cap, cap + 77]  # the last two: the table's capacity and beyond it
    units, blocks = nsa.work_units(lengths, n_blocks, page, grid)
    total = sum(cnt for _, cnt in units)
    sizes = [u1 - u0 for u0, u1 in blocks]
    assert len(blocks) == min(grid, total) and min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert blocks[0][0] == 0 and blocks[-1][1] == total
    assert all(blocks[c][1] == blocks[c + 1][0] for c in range(len(blocks) - 1))
    seen = []
    for (u0, u1) in blocks:
        for u in range(u0, u1):  # unit u -> (sequence, unit of the sequence), as the kernel walks them
            b = max(i for i in range(len(units)) if sum(c for _, c in units[:i]) <= u and units[i][1] > 0)
            seen.append((b, u - sum(c for _, c in units[:b])))
    assert len(seen) == len(set(seen)) == total
    for b, (n, cnt) in enumerate(units):
        assert n == max(0, min(lengths[b], cap)) and cnt == -(-n // 64)
        keys = [t for (bb, j) in seen if bb == b for t in range(j * 64, min(n, j * 64 + 64))]
        assert sorted(keys) == list(range(n))


@pytest.mark.parametrize("kind", ["e4m3", "e5m2"])
def test_k15_fp8_keys_convert_exactly(kind):
    """Every finite fp8 code, denormals included, scored by a one-hot q of
    +1 and of -1 (relu keeps one sign each): the logits are the codes'
    exact values (ml_dtypes), not JAX's flushed upcast."""
    codes = np.arange(256, dtype=np.uint8).view(NP_FP8[kind])
    vals = codes.astype(np.float64)
    keep = np.isfinite(vals)
    codes, vals = codes[keep], vals[keep]
    n = len(codes)
    page, d = 16, 128
    n_pages = -(-n // page)
    pool = np.zeros((n_pages * page, d), NP_FP8[kind])
    pool[:n, 5] = codes
    keys = t_(pool.reshape(n_pages, page, d))
    table = t_(np.arange(n_pages, dtype=np.int32)[None])
    for sign in (1.0, -1.0):
        q = torch.zeros(1, 1, d, dtype=torch.bfloat16)
        q[0, 0, 5] = sign
        out = nsa.fp8_paged_mqa_logits(q, keys, torch.ones(1), torch.tensor([n]), table)
        np.testing.assert_array_equal(out[0, :n].double().numpy(), np.maximum(sign * vals, 0.0))


@pytest.mark.parametrize("clean", [False, True])
def test_fp8_mqa_logits(clean):
    rng = np.random.default_rng(2)
    nq, nk, h, d = 5, 24, 3, 32
    q = jnp.asarray(normal_values(rng, (nq, h, d), 0.02, 1.0)).astype(jnp.float8_e4m3fn)
    k = jnp.asarray(normal_values(rng, (nk, d), 0.02, 1.0)).astype(jnp.float8_e4m3fn)
    ks_ = rng.uniform(0.5, 1.5, nk).astype(np.float32)
    w = rng.standard_normal((nq, h)).astype(np.float32)  # negative gates too
    ks, ke = np.array([0, 2, 0, 5, 7], np.int32), np.array([24, 10, 8, 24, 7], np.int32)  # an empty window
    jout = jnsa.fp8_mqa_logits(q, (k, jnp.asarray(ks_)), jnp.asarray(w), jnp.asarray(ks), jnp.asarray(ke),
                               clean_logits=clean)
    tout = nsa.fp8_mqa_logits(t_(q), (t_(k), t_(ks_)), t_(w), t_(ks), t_(ke), clean_logits=clean)
    close(tout, jout, 1e-5)
    if clean:
        assert np.isneginf(tout[4].numpy()).all()


def same_sets(out, ref):
    np.testing.assert_array_equal(np.sort(out.numpy(), axis=1), np.sort(np.asarray(ref), axis=1))


def tied_logits(rng, shape):
    """Logits on a coarse grid, so rows hold many ties, and some -inf."""
    x = np.round(rng.standard_normal(shape) * 2) / 2
    x[rng.random(shape) < 0.1] = -np.inf
    return x.astype(np.float32)


def test_fast_topk_and_transform():
    """Rows longer and shorter than k (short rows pad with -1), T < topk
    (k clamps to T, then pads), ties; the fused transform maps positions
    through the page table."""
    rng = np.random.default_rng(3)
    b, t, page = 4, 48, 8
    logits = tied_logits(rng, (b, t))
    lengths = np.array([48, 5, 0, 20], np.int32)
    for i, n in enumerate(lengths):
        logits[i, n:] = -np.inf
    table = rng.permutation(40)[: b * (t // page)].reshape(b, t // page).astype(np.int32)
    for topk in (8, 64):
        j = np.asarray(jnsa.fast_topk(jnp.asarray(logits), jnp.asarray(lengths), topk=topk))
        tt = nsa.fast_topk(t_(logits), t_(lengths), topk=topk)
        assert tt.dtype == torch.int32 and tt.shape == (b, topk)
        same_sets(tt, j)
        for row, n in zip(tt.numpy(), lengths):
            assert set(row[row >= 0]) <= set(range(n)) and (row >= 0).sum() == min(n, topk, t)
        j = np.asarray(jnsa.fast_topk_transform_fused(jnp.asarray(logits), jnp.asarray(lengths), jnp.asarray(table),
                                                      page, topk=topk))
        tt = nsa.fast_topk_transform_fused(t_(logits), t_(lengths), t_(table), page, topk=topk)
        same_sets(tt, j)


def test_fast_topk_transform_ragged():
    rng = np.random.default_rng(4)
    nq, nk, page = 4, 64, 16
    logits = tied_logits(rng, (nq, nk))
    ks, ke = np.array([0, 8, 0, 30], np.int32), np.array([10, 64, 1, 30], np.int32)  # an empty window
    table = rng.integers(0, 8, (nq, nk // page)).astype(np.int32)
    for topk in (8, 2048):
        j = np.asarray(jnsa.fast_topk_transform_ragged_fused(jnp.asarray(logits), jnp.asarray(ks), jnp.asarray(ke),
                                                             jnp.asarray(table), page, topk=topk))
        tt = nsa.fast_topk_transform_ragged_fused(t_(logits), t_(ks), t_(ke), t_(table), page, topk=topk)
        assert tt.shape == (nq, topk)
        same_sets(tt, j)


def sparse_inputs(rng, b, h, n_slots, kk, dtype):
    pool = np.asarray(rng.standard_normal((n_slots, 576)) * 0.3, np.float32)
    pool = jnp.asarray(pool).astype(JNP[dtype]) if dtype != "e4m3" else jnp.asarray(
        normal_values(rng, (n_slots, 576), 0.05, 1.0)).astype(jnp.float8_e4m3fn)
    qdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    qn = jnp.asarray(rng.standard_normal((b, h, 512)) * 0.3, qdt)
    qp = jnp.asarray(rng.standard_normal((b, h, 64)) * 0.3, qdt)
    slots = np.stack([rng.choice(n_slots, kk, replace=False) for _ in range(b)]).astype(np.int32)
    return pool, qn, qp, slots


@pytest.mark.parametrize("dtype", ["f32", "bf16", "e4m3"])
def test_sparse_mla_decode(dtype):
    """One pool; a row with -1 padding (lengths counted), an empty row; and
    ``sparse_mla_prefill`` (the same function over per-token index sets)."""
    rng = np.random.default_rng(5)
    b, h, n_slots, kk = 3, 4, 96, 16
    pool, qn, qp, slots = sparse_inputs(rng, b, h, n_slots, kk, dtype)
    slots[1, -5:] = -1
    slots[2, :] = -1
    scale = 0.06
    jo, jl = jnsa.sparse_mla_decode(qn, qp, pool, jnp.asarray(slots), sm_scale=scale, return_lse=True)
    to, tl = nsa.sparse_mla_decode(t_(qn), t_(qp), t_(pool), t_(slots), sm_scale=scale, return_lse=True)
    rel = 2e-5 if dtype == "f32" else 2.0 ** -6
    close(to, jo, rel)
    close(tl, jl, 1e-4)
    assert not to[2].any() and np.isneginf(tl[2].numpy()).all()
    close(nsa.sparse_mla_prefill(t_(qn), t_(qp), t_(pool), t_(slots), sm_scale=scale),
          jnsa.sparse_mla_prefill(qn, qp, pool, jnp.asarray(slots), sm_scale=scale), rel)


def test_sparse_mla_dual_pool_sinks_lse():
    """Two pools merged by lse with explicit topk lengths (the extra pool of
    row 1 empty), per-head sinks applied once after the merge, the
    lse with the sink's correction."""
    rng = np.random.default_rng(6)
    b, h, kk, kk2 = 2, 4, 32, 16
    pool, qn, qp, slots = sparse_inputs(rng, b, h, 128, kk, "f32")
    extra = jnp.asarray(rng.standard_normal((64, 576)) * 0.3, jnp.float32)
    eslots = np.stack([rng.choice(64, kk2, replace=False) for _ in range(b)]).astype(np.int32)
    tl, etl = np.array([kk, kk - 5], np.int32), np.array([kk2 - 3, 0], np.int32)
    slots[1, tl[1]:] = -1
    eslots[0, etl[0]:] = -1
    eslots[1, :] = -1
    sink = (rng.standard_normal(h) * 0.5).astype(np.float32)
    kw_j = dict(topk_length=jnp.asarray(tl), extra_pool_flat=extra, extra_indices=jnp.asarray(eslots),
                extra_topk_length=jnp.asarray(etl), attn_sink=jnp.asarray(sink), return_lse=True, page=16)
    kw_t = dict(topk_length=t_(tl), extra_pool_flat=t_(extra), extra_indices=t_(eslots), extra_topk_length=t_(etl),
                attn_sink=t_(sink), return_lse=True, page=16)
    jo, jl = jnsa.sparse_mla_decode(qn, qp, pool, jnp.asarray(slots), **kw_j)
    to, tlse = nsa.sparse_mla_decode(t_(qn), t_(qp), t_(pool), t_(slots), **kw_t)
    close(to, jo, 2e-5)
    close(tlse, jl, 1e-4)


def test_sparse_mla_dual_pool_both_empty():
    """A row with both pools empty gives zeros, with explicit and with
    counted lengths, in bf16."""
    rng = np.random.default_rng(7)
    b, h, n_slots, kk = 3, 4, 256, 8
    pool, qn, qp, idx = sparse_inputs(rng, b, h, n_slots, kk, "bf16")
    extra = jnp.asarray(rng.standard_normal((n_slots, 576)) * 0.1, jnp.bfloat16)
    eidx = rng.integers(0, n_slots, (b, kk)).astype(np.int32)
    tl, etl = np.array([kk, 0, kk], np.int32), np.array([kk, 0, 0], np.int32)
    jo = jnsa.sparse_mla_decode(qn, qp, pool, jnp.asarray(idx), topk_length=jnp.asarray(tl), extra_pool_flat=extra,
                                extra_indices=jnp.asarray(eidx), extra_topk_length=jnp.asarray(etl))
    to = nsa.sparse_mla_decode(t_(qn), t_(qp), t_(pool), t_(idx), topk_length=t_(tl), extra_pool_flat=t_(extra),
                               extra_indices=t_(eidx), extra_topk_length=t_(etl))
    close(to, jo, 2.0 ** -6)
    assert torch.isfinite(to.float()).all() and not to[1].any() and to[0].any() and to[2].any()
    idx[1], eidx[1] = -1, -1
    to2, tl2 = nsa.sparse_mla_decode(t_(qn), t_(qp), t_(pool), t_(idx), extra_pool_flat=t_(extra),
                                     extra_indices=t_(eidx), return_lse=True)
    jo2 = jnsa.sparse_mla_decode(qn, qp, pool, jnp.asarray(idx), extra_pool_flat=extra, extra_indices=jnp.asarray(eidx))
    close(to2, jo2, 2.0 ** -6)
    assert not to2[1].any() and np.isneginf(tl2[1].numpy()).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_indexer_preprocessors(dtype):
    """The k ingest (rmsnorm, RoPE, Hadamard, fp8, stored in place at
    slot_loc; -1 and slots past the pool dropped) and the q preprocessor."""
    rng = np.random.default_rng(8)
    t, h, d, n_slots = 6, 3, 128, 16
    dt = JNP[dtype]
    k = jnp.asarray(rng.standard_normal((t, d)), dt)
    w = jnp.asarray(rng.random(d) + 0.5, dt)
    pos = np.array([0, 2, 5, 9, 30, 31], np.int32)
    cache = jrope.compute_cos_sin_cache(d, 32)
    loc = np.array([1, -1, 4, 15, n_slots + 3, 0], np.int32)
    j8, js = jnsa.fused_k_indexer_norm_rope_quant_store(
        k, jnp.asarray(pos), cache, w, jnp.zeros((n_slots, d), jnp.float8_e4m3fn), jnp.zeros((n_slots,), jnp.float32),
        jnp.asarray(loc))
    t8, ts = torch.zeros((n_slots, d), dtype=torch.float8_e4m3fn), torch.zeros(n_slots)
    out8, outs = nsa.fused_k_indexer_norm_rope_quant_store(t_(k), t_(pos), t_(cache), t_(w), t8, ts, t_(loc))
    assert out8 is t8 and outs is ts  # in place
    assert within_one_code(out8.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn), np.asarray(j8))
    np.testing.assert_allclose(outs.numpy(), np.asarray(js), rtol=2e-3)
    assert not out8.view(torch.uint8)[[2, 3, 5, 6]].any()  # untouched rows
    q = jnp.asarray(rng.standard_normal((t, h, d)), dt)
    jq, jqs = jnsa.fused_q_indexer_rope_hadamard_quant(q, jnp.asarray(pos), cache)
    tq, tqs = nsa.fused_q_indexer_rope_hadamard_quant(t_(q), t_(pos), t_(cache))
    assert tq.dtype == torch.float8_e4m3fn and tqs.shape == (t, h, 1)
    assert within_one_code(tq.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn), np.asarray(jq))
    np.testing.assert_allclose(tqs.numpy(), np.asarray(jqs), rtol=2e-3)


@pytest.mark.parametrize("dtype,n", [("f32", 128), ("f32", 8), ("bf16", 128)])
def test_hadamard_transform(dtype, n):
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal((3, 5, n)), JNP[dtype])
    scale = 1.0 / n ** 0.5
    out = hadamard.hadamard_transform(t_(x), scale=scale)
    assert out.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    close(out, jhad.hadamard_transform(x, scale=scale), 2e-6 if dtype == "f32" else 2.0 ** -8)
    with pytest.raises(ValueError):
        hadamard.hadamard_transform(torch.zeros(2, 12))


@pytest.mark.parametrize("kind", ["e4m3", "e5m2"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_per_token_quant_fp8(kind, dtype):
    """The same codes and scales as JAX and as an ml_dtypes oracle of the
    same float32 arithmetic; an all-zero row takes the 1e-12 scale floor."""
    rng = np.random.default_rng(10)
    x = np.asarray(rng.standard_normal((4, 3, 64)) * rng.uniform(0.001, 100, (4, 3, 1)), np.float32)
    x[0, 0] = 0.0
    xj = jnp.asarray(x, JNP[dtype])
    jq, js = jquant.per_token_quant_fp8(xj, dtype=JNP[kind])
    tq, ts = quant.per_token_quant_fp8(t_(xj), dtype=getattr(torch, {"e4m3": "float8_e4m3fn", "e5m2": "float8_e5m2"}[kind]))
    assert ts.shape == (4, 3, 1) and ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    got = tq.view(torch.uint8).numpy().view(NP_FP8[kind])
    assert within_one_code(got, np.asarray(jq))
    xf = np.asarray(xj.astype(jnp.float32))
    fmax = float(ml_dtypes.finfo(NP_FP8[kind]).max)
    oracle = np.clip(xf / ts.numpy(), -fmax, fmax).astype(NP_FP8[kind])
    np.testing.assert_array_equal(got.view(np.uint8), oracle.view(np.uint8))
    assert float(ts[0, 0]) == np.float32(1e-12)


def test_apply_sinks():
    rng = np.random.default_rng(11)
    v = rng.standard_normal((5, 4, 32)).astype(np.float32)
    s = (rng.standard_normal((5, 4)) * 3).astype(np.float32)
    sinks = rng.standard_normal(4).astype(np.float32)
    close(apply_sinks(t_(v), t_(s), t_(sinks)), japply_sinks(v, s, sinks), 1e-6)
    vb = jnp.asarray(v, jnp.bfloat16)
    out = apply_sinks(t_(vb), t_(s), t_(sinks))
    assert out.dtype == torch.bfloat16
    close(out, japply_sinks(vb, s, sinks), 2.0 ** -8)


def test_interop_carries_nsa_tree_and_fp8_pools():
    """params_from_numpy carries the NSA layer tree (the indexer weights in
    the model dtype) and tensor_from_numpy the fp8 indexer pools through
    their uint8 view, byte for byte."""
    import jax

    from sgl_kernel_tpu.models import deepseek as jds
    from sgl_kernel_tpu_torch import params_from_numpy

    import dataclasses

    jcfg = dataclasses.replace(jds.DeepseekConfig.tiny(nsa=True, idx_dim=32, idx_heads=2), dtype=jnp.bfloat16)
    tree = jax.tree_util.tree_map(np.asarray, jds.init_weights(jcfg, jax.random.PRNGKey(1)))
    params = params_from_numpy(tree, "cpu")
    for name in ("wq_idx", "wk_idx", "idx_norm", "w_idx_gate"):
        got = params["layers"][name]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.uint16).numpy(), tree["layers"][name].view(np.uint16))
    rng = np.random.default_rng(12)
    k8 = jnp.asarray(normal_values(rng, (64, 32), 0.001, 300.0)).astype(jnp.float8_e4m3fn)
    pool = t_(k8)
    assert pool.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(pool.view(torch.uint8).numpy(), np.asarray(k8).view(np.uint8))
