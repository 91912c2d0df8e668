"""The port's vertical + slash sparse attention against the JAX package's on
the same inputs (numpy, from a seed): the vectorised schedule builders
against JAX's host loop (the four arrays equal, bit for bit, causal or not,
with a q / kv length shift, NS truncation and the mergehead form), K16's
twin (``sparse_attn_func`` on CPU tensors) against the Pallas kernel in
interpret mode, the varlen wrapper with GQA, the dense masked form and the
pattern estimator (its selections compared as sets).

Tolerances: the schedules are integers, compared exactly. On float32
inputs both attention paths compute in float32 (JAX keeps P in float32 when
the inputs are float32): outputs and finite lse within 1e-4 (absolute and
relative); -inf lse rows equal. On bf16 inputs JAX rounds P to bf16 before
P.V and the port does not: 2^-7 of the output's scale."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops.attention import sparse_vs as jvs
from sgl_kernel_tpu_torch import tensor_from_numpy
from sgl_kernel_tpu_torch.ops.attention import sparse_vs

torch.set_num_threads(1)


def t_(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def random_sets(rng, b, h, kv_lens, nv, ns, unique=True):
    v = np.stack([np.stack([np.sort(rng.choice(max(kl, 1), nv, replace=not unique)) for _ in range(h)])
                  for kl in kv_lens])
    s = np.stack([np.sort(rng.choice(max(kl, 1), (h, ns), replace=True), axis=-1)[..., ::-1] for kl in kv_lens])
    return v.astype(np.int32), np.ascontiguousarray(s).astype(np.int32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bm,bn", [(64, 64), (64, 128), (32, 64)])
@pytest.mark.parametrize("q_lens,kv_lens", [([300, 177], [300, 177]), ([100, 64], [260, 64]), ([1], [129])])
def test_convert_matches_jax_loop(causal, bm, bn, q_lens, kv_lens):
    """Random column and distance sets, few slots (NS 3: the kept-block cut
    bites), columns inside kept blocks, a q / kv length shift."""
    rng = np.random.default_rng(len(q_lens) * 7 + bm + bn + causal)
    b, h = len(q_lens), 3
    ctx = max(max(q_lens), max(kv_lens))
    for nv, ns in ((10, 3), (40, 12)):
        v_idx, s_idx = random_sets(rng, b, h, kv_lens, nv, ns, unique=nv < min(kv_lens))
        want = jvs.convert_vertical_slash_indexes(q_lens, kv_lens, v_idx, s_idx, ctx, bm, bn, causal)
        got = sparse_vs.convert_vertical_slash_indexes(q_lens, kv_lens, v_idx, s_idx, ctx, bm, bn, causal)
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_convert_edge_sets():
    """Negative column pads, out-of-range distances, an all-empty head,
    columns past kv_len: the same arrays as the loop."""
    q_lens = kv_lens = [128, 40]
    v_idx = np.array([[[5, -1, 70, 200], [0, 1, 2, 3]], [[39, 40, 41, -1], [-1, -1, -1, -1]]], np.int32)
    s_idx = np.array([[[0, 1 << 29], [127, 64]], [[3, 0], [1 << 29, 1 << 29]]], np.int32)
    for causal in (True, False):
        want = jvs.convert_vertical_slash_indexes(q_lens, kv_lens, v_idx, s_idx, 128, 64, 64, causal)
        got = sparse_vs.convert_vertical_slash_indexes(q_lens, kv_lens, v_idx, s_idx, 128, 64, 64, causal)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("causal", [True, False])
def test_convert_mergehead_matches_jax(causal):
    rng = np.random.default_rng(5)
    lens = [256, 190]
    v_idx, s_idx = random_sets(rng, 2, 4, lens, 16, 6)
    vc, sc = np.array([16, 3, 0, 9]), np.array([6, 1, 4, 0])
    args = (lens, lens, v_idx, s_idx, vc, sc, 256, 64, 64, causal)
    for g, w in zip(sparse_vs.convert_vertical_slash_indexes_mergehead(*args),
                    jvs.convert_vertical_slash_indexes_mergehead(*args)):
        np.testing.assert_array_equal(g, w)


def close(out, ref, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=rtol, atol=atol)


def close_lse(lse, ref):
    lse, ref = lse.numpy(), np.asarray(ref)
    assert lse.shape == ref.shape
    np.testing.assert_array_equal(np.isneginf(lse), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(lse[fin], ref[fin], rtol=1e-4, atol=1e-4)


def case(rng, b, s, h, d, nv, ns, bm, bn, causal=True, hk=None):
    hk = hk or h
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v_idx, s_idx = random_sets(rng, b, h, [s] * b, nv, ns)
    sched = jvs.convert_vertical_slash_indexes([s] * b, [s] * b, v_idx, s_idx, s, bm, bn, causal)
    return q, k, v, sched


@pytest.mark.parametrize("s,bn", [(256, 128), (200, 128), (256, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_sparse_attn_func_twin_matches_pallas(s, bn, causal):
    """K16's twin against the interpret-mode kernel on float32 inputs, with
    the lse; S=200 puts slash blocks past S (JAX pads k / v, the port
    masks)."""
    rng = np.random.default_rng(s + bn)
    q, k, v, sched = case(rng, 2, s, 2, 64, 12, 4, 64, bn, causal)
    kw = dict(block_size_M=64, block_size_N=bn, causal=causal, return_lse=True)
    ref, ref_lse = jvs.sparse_attn_func(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        *(jnp.asarray(x) for x in sched), **kw)
    out, lse = sparse_vs.sparse_attn_func(t_(q), t_(k), t_(v), *sched, **kw)
    assert out.shape == q.shape and out.dtype == torch.float32
    close(out, ref)
    close_lse(lse, ref_lse)


def test_sparse_attn_func_softcap_empty_rows_and_duplicates():
    """Soft cap 20 with the lse; a row block with no key (o 0, lse -inf); a
    block listed twice and a column inside a selected block (counted twice,
    as in JAX); kv_lens below S; head dim 128."""
    rng = np.random.default_rng(11)
    q, k, v, (bc, bo, cc, ci) = case(rng, 2, 256, 2, 128, 8, 3, 64, 64)
    bc, bo, cc, ci = (x.copy() for x in (bc, bo, cc, ci))
    bc[0, 1, 2] = cc[0, 1, 2] = 0
    bc[1, 0, 3], bo[1, 0, 3, :2] = 2, 128
    ci[1, 0, 3, 0], cc[1, 0, 3] = 150, max(1, cc[1, 0, 3])
    kv_lens = np.array([256, 170], np.int32)
    kw = dict(block_size_N=64, softcap=20.0, return_lse=True)
    ref, ref_lse = jvs.sparse_attn_func(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        *(jnp.asarray(x) for x in (bc, bo, cc, ci)), kv_lens=jnp.asarray(kv_lens),
                                        **kw)
    out, lse = sparse_vs.sparse_attn_func(t_(q), t_(k), t_(v), bc, bo, cc, ci, kv_lens=kv_lens, **kw)
    close(out, ref)
    close_lse(lse, ref_lse)
    assert not out[0, 128:192, 1].any() and torch.isneginf(lse[0, 1, 128:192]).all()


def test_sparse_attn_func_bf16():
    rng = np.random.default_rng(12)
    q, k, v, sched = case(rng, 1, 256, 2, 128, 16, 4, 64, 128)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = jvs.sparse_attn_func(qb, kb, vb, *(jnp.asarray(x) for x in sched))
    out = sparse_vs.sparse_attn_func(*(t_(np.asarray(x)) for x in (qb, kb, vb)), *sched)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    tol = 2.0 ** -7 * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(out.float().numpy() - ref).max()) <= tol


@pytest.mark.parametrize("causal", [True, False])
def test_sparse_attn_varlen_gqa_matches_jax(causal):
    """Ragged sequences, 4 query heads over 2 kv heads (the port indexes the
    kv head, JAX repeats it), bn 64, the lse [H, total_q]; non-causal with
    kv lengths unlike the q lengths."""
    rng = np.random.default_rng(13 + causal)
    h, hk, d = 4, 2, 64
    q_lens = [192, 100, 64]
    k_lens = q_lens if causal else [150, 230, 64]
    v_idx, s_idx = random_sets(rng, 3, h, k_lens, 10, 4)
    ctx = max(max(q_lens), max(k_lens))
    sched = jvs.convert_vertical_slash_indexes(q_lens, k_lens, v_idx, s_idx, ctx, 64, 64, causal)
    q = rng.standard_normal((sum(q_lens), h, d)).astype(np.float32)
    k = rng.standard_normal((sum(k_lens), hk, d)).astype(np.float32)
    v = rng.standard_normal((sum(k_lens), hk, d)).astype(np.float32)
    cu_q, cu_k = (np.concatenate([[0], np.cumsum(x)]) for x in (q_lens, k_lens))
    args = (cu_q, cu_k, max(q_lens), max(k_lens))
    kw = dict(causal=causal, return_softmax_lse=True)
    ref, ref_lse = jvs.sparse_attn_varlen_func(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               *(jnp.asarray(x) for x in sched), *args, **kw)
    out, lse = sparse_vs.sparse_attn_varlen_func(t_(q), t_(k), t_(v), *sched, *args, **kw)
    assert out.shape == (sum(q_lens), h, d) and lse.shape == (h, sum(q_lens))
    close(out, ref)
    close_lse(lse, ref_lse)


def test_dense_vertical_slash_matches_jax():
    rng = np.random.default_rng(14)
    b, s, h, d = 1, 96, 2, 64
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    vi = np.array([[3, 50, -1], [0, -1, -1]], np.int32)
    si = np.array([[0, 5], [1, -1]], np.int32)
    for causal in (True, False):
        ref = jvs.sparse_attention_vertical_slash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vi),
                                                  jnp.asarray(si), causal=causal)
        close(sparse_vs.sparse_attention_vertical_slash(t_(q), t_(k), t_(v), vi, si, causal=causal), ref)


def test_build_vertical_slash_indexes_as_sets():
    """The estimator's selections equal JAX's as sets, per head."""
    rng = np.random.default_rng(15)
    b, s, h, d = 1, 256, 3, 64
    q, k = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    jv, js = jvs.build_vertical_slash_indexes(jnp.asarray(q), jnp.asarray(k), num_vertical=24, num_slash=8)
    tv, ts = sparse_vs.build_vertical_slash_indexes(t_(q), t_(k), num_vertical=24, num_slash=8)
    assert tv.dtype == torch.int32 and tv.shape == (h, 24) and ts.shape == (h, 8)
    for hh in range(h):
        assert set(tv[hh].tolist()) == set(np.asarray(jv)[hh].tolist())
        assert set(ts[hh].tolist()) == set(np.asarray(js)[hh].tolist())


@pytest.mark.parametrize("batch,heads,kv_heads,row_blocks", [(1, 32, 8, 64), (2, 4, 4, 5), (3, 8, 2, 1), (2, 6, 1, 7)])
def test_k16_work_order(batch, heads, kv_heads, row_blocks):
    """K16's block order (the kernel derives it from the block index) against
    a brute-force order: every (sequence, head, row block) item once; the
    blocks of one (sequence, kv head) contiguous, in (sequence, kv head)
    order; within them row blocks from the last to the first, the kv head's
    query heads side by side for each."""
    order = sparse_vs.work_order(batch, heads, kv_heads, row_blocks)
    group = heads // kv_heads
    assert sorted(order) == [(b, h, r) for b in range(batch) for h in range(heads) for r in range(row_blocks)]
    brute = sorted(order, key=lambda it: (it[0], it[1] // group, -it[2], it[1] % group))
    assert order == brute
    span = group * row_blocks
    for i in range(0, len(order), span):
        assert len({(b, h // group) for b, h, _ in order[i: i + span]}) == 1
