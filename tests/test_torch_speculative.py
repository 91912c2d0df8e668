"""The speculative-decoding ops of the port against the JAX package:
``ops/speculative.py``'s four functions and ``kvcache.move_cache_rows_stacked``.

Inputs are seeded with numpy. The tree functions return integers and
masks, compared exactly: the golden trees of tests/test_speculative.py and
random trees (random parents, random candidate labels, sibling tokens that
repeat, target predictions that follow a child 60 % of the time), batch
rows of different shapes. The row move is a copy, so the pools must be
equal bit for bit, in place."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops import kvcache as jkv
from sgl_kernel_tpu.ops import speculative as jspec
from sgl_kernel_tpu_torch.ops import kvcache as tkv
from sgl_kernel_tpu_torch.ops import speculative as tspec

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def same(j_out, t_out):
    for a, b in zip(j_out, t_out):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def golden_tree():
    candidates = np.array([[0, 1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 12]], np.int32)
    retrive_index = np.array([[0, 1, 2, 3, 4, 5], [6, 7, 8, 9, 10, 11]], np.int32)
    retrive_next_token = np.array([[1, 2, -1, 4, 5, -1], [4, 2, 3, -1, 5, -1]], np.int32)
    retrive_next_sibling = np.array([[-1, 3, -1, -1, -1, -1], [-1, -1, -1, -1, 1, -1]], np.int32)
    logits = np.full((2, 6, 20), 1.0, np.float32)
    for b, n, tok in ((0, 0, 3), (0, 3, 4), (0, 4, 5), (1, 0, 11), (1, 4, 12)):
        logits[b, n, tok] = 10
    logits[logits.max(-1) < 10, 18] = 10
    return candidates, retrive_index, retrive_next_token, retrive_next_sibling, logits


def random_tree_inputs(rng, b, dt, extra=3, vocab=6):
    """parent_list [b, C], selected_index [b, dt-1], verified_seq_len [b]
    of random trees: candidate c's parent is -1 or an earlier candidate,
    candidates relabelled by a random permutation, the first dt-1 (a set
    closed under parents) selected in that order; and the max depth."""
    c = dt - 1 + extra
    pl = np.zeros((b, c), np.int32)
    sel = np.zeros((b, dt - 1), np.int32)
    depth = 1
    for r in range(b):
        par = [-1] + [int(rng.integers(-1, i)) for i in range(1, c)]
        d = [0] * c
        for i in range(c):
            d[i] = 0 if par[i] < 0 else d[par[i]] + 1
        depth = max(depth, max(d[: dt - 1]) + 1)
        perm = rng.permutation(c)
        for i in range(c):
            pl[r, perm[i]] = -1 if par[i] < 0 else perm[par[i]]
        sel[r] = perm[: dt - 1]
    cand = rng.integers(0, vocab, (b, dt)).astype(np.int32)
    return pl, sel, rng.integers(3, 40, b).astype(np.int32), depth, cand


def following_predictions(rng, cand, nxt, sib, vocab=6, p=0.6):
    """A target prediction per node: a random child's token with
    probability p, else a random token."""
    b, dt = cand.shape
    pred = rng.integers(0, vocab, (b, dt)).astype(np.int32)
    for r in range(b):
        for n in range(dt):
            kids, c = [], nxt[r, n]
            while c >= 0:
                kids.append(c)
                c = sib[r, c]
            if kids and rng.random() < p:
                pred[r, n] = cand[r, kids[int(rng.integers(len(kids)))]]
    return pred


def test_verify_tree_greedy_golden():
    cand, ridx, rnt, rns, logits = golden_tree()
    pred = logits.argmax(-1).astype(np.int32)
    out = tspec.verify_tree_greedy(t(cand), t(ridx), t(rnt), t(rns), t(pred), num_spec_step=4)
    assert out[0].tolist() == [3, -1, -1, 4, 5, 18, 11, -1, -1, -1, 12, 18]
    assert out[1].tolist() == [[0, 3, 4, 5], [6, 10, 11, -1]]
    assert out[2].tolist() == [3, 2]


@pytest.mark.parametrize("seed", range(6))
def test_build_tree_and_verify_random(seed):
    """build_tree_kernel_efficient and verify_tree_greedy on random trees,
    equal to JAX's as integers and masks, at num_spec_step from 1 to past
    the depth."""
    rng = np.random.default_rng(seed)
    dt = int(rng.integers(2, 10))
    pl, sel, seq, depth, cand = random_tree_inputs(rng, 5, dt)
    j_tree = jspec.build_tree_kernel_efficient(jnp.asarray(pl), jnp.asarray(sel), jnp.asarray(seq), depth=depth,
                                               draft_token_num=dt)
    t_tree = tspec.build_tree_kernel_efficient(t(pl), t(sel), t(seq), depth=depth, draft_token_num=dt)
    same(j_tree, t_tree)
    _, _, ridx, nxt, sib = (np.asarray(x) for x in j_tree)
    pred = following_predictions(rng, cand, nxt, sib)
    for steps in sorted({1, 2, depth + 1, depth + 2}):
        j = jspec.verify_tree_greedy(*(jnp.asarray(a) for a in (cand, ridx, nxt, sib, pred)), num_spec_step=steps)
        same(j, tspec.verify_tree_greedy(*(t(a) for a in (cand, ridx, nxt, sib, pred)), num_spec_step=steps))


def test_build_tree_hand_built():
    mask, pos, ridx, nxt, sib = tspec.build_tree_kernel_efficient(
        t([[-1, -1, 0, 1]]), t([[0, 1, 2, 3]]), t([10]), depth=2, draft_token_num=5)
    assert pos.tolist() == [[10, 11, 11, 12, 12]] and ridx.tolist() == [[0, 1, 2, 3, 4]]
    assert nxt.tolist() == [[1, 3, 4, -1, -1]] and sib.tolist() == [[-1, 2, -1, -1, -1]]
    assert mask[0, 3].tolist() == [True, True, False, True, False]


@pytest.mark.parametrize("ts,ta", [(1.0, 1.0), (0.0, 0.0), (0.3, 0.6)])
def test_tree_sampling_golden_thresholds(ts, ta):
    """The golden tree at temperature 0.01 with zero draft probabilities
    (thresholds 1 reduce to greedy, 0 accept the first child, in between
    the accumulated sibling mass decides), equal to JAX's."""
    cand, ridx, rnt, rns, logits = golden_tree()
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits) / 0.01, axis=-1))
    draft = np.zeros_like(probs)
    coins = np.zeros((2, 6), np.float32)
    args = (cand, ridx, rnt, rns, coins, probs, draft)
    kw = dict(num_spec_step=4, threshold_single=ts, threshold_acc=ta, deterministic=True)
    j = jspec.tree_speculative_sampling_target_only(*(jnp.asarray(a) for a in args), **kw)
    tt = tspec.tree_speculative_sampling_target_only(*(t(a) for a in args), **kw)
    same(j, tt)
    if ts == 1.0:
        assert tt[1].tolist() == [[0, 3, 4, 5], [6, 10, 11, -1]]
    if ts == 0.0:
        assert tt[1].tolist() == [[0, 1, 2, -1], [6, 10, 11, -1]]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("ts,ta", [(1.0, 1.0), (0.0, 0.0), (0.25, 0.5)])
def test_tree_sampling_random(seed, deterministic, ts, ta):
    """Random trees with peaked target and draft distributions over 6
    tokens and random coins: the accepted path, the predictions and the
    counts equal JAX's, with and without the rejection-sampling path (its
    residual renormalized after each rejection, its inverse-CDF draw)."""
    rng = np.random.default_rng(100 + seed)
    dt, vocab = int(rng.integers(3, 9)), 6
    pl, sel, seq, depth, cand = random_tree_inputs(rng, 4, dt, vocab=vocab)
    _, _, ridx, nxt, sib = (np.asarray(x) for x in jspec.build_tree_kernel_efficient(
        jnp.asarray(pl), jnp.asarray(sel), jnp.asarray(seq), depth=depth, draft_token_num=dt))
    tp = np.asarray(jax.nn.softmax(jnp.asarray(rng.standard_normal((4, dt, vocab)) * 2.0, jnp.float32), -1))
    dp = np.asarray(jax.nn.softmax(jnp.asarray(rng.standard_normal((4, dt, vocab)) * 2.0, jnp.float32), -1))
    coins = rng.random((4, dt)).astype(np.float32)
    args = (cand, ridx, nxt, sib, coins, tp, dp)
    kw = dict(num_spec_step=depth + 1, threshold_single=ts, threshold_acc=ta, deterministic=deterministic)
    j = jspec.tree_speculative_sampling_target_only(*(jnp.asarray(a) for a in args), **kw)
    same(j, tspec.tree_speculative_sampling_target_only(*(t(a) for a in args), **kw))


@pytest.mark.parametrize("seed", range(4))
def test_segment_packbits(seed):
    """Random ragged segments (one of them empty in some seeds), each
    starting at its own output byte; and the two-segment golden case."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0 if seed % 2 else 1, 20, int(rng.integers(1, 5)))
    in_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    out_ptr = np.concatenate([[0], np.cumsum((lens + 7) // 8)]).astype(np.int32)
    x = rng.integers(0, 2, int(in_ptr[-1])).astype(np.int32)
    size = int(out_ptr[-1])
    j = jspec.segment_packbits(jnp.asarray(x), jnp.asarray(in_ptr), jnp.asarray(out_ptr), out_size=size)
    got = tspec.segment_packbits(t(x), t(in_ptr), t(out_ptr), out_size=size)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(j), got.numpy())
    bits = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1, 1, 1, 0, 1], np.int32)
    got = tspec.segment_packbits(t(bits), t([0, 10, 13]), t([0, 2, 3]), out_size=3)
    assert got.tolist() == [sum(int(bits[i]) << i for i in range(8)), 3, 5]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_move_cache_rows_stacked(dtype):
    """Moves across every layer, equal to JAX's bit for bit: chains whose
    sources are other moves' destinations (every source read before any
    write), a move onto itself, and moves dropped for a negative or
    out-of-range src or dst. The pools are updated in place."""
    rng = np.random.default_rng(7)
    l, p, h, page, d = 3, 6, 2, 4, 8
    shape = (l, p, h, page, d)
    if dtype == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
    n = p * page
    src = np.array([3, 5, 9, 7, 10, -1, 4, 30, 12, 2, 0], np.int32)
    dst = np.array([5, 9, 3, 7, 21, 6, -2, 11, n, 13, 1], np.int32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else None
    jk, jv = (jnp.asarray(a) if jd is None else jnp.asarray(a, jd) for a in (k, v))
    jk, jv = jkv.move_cache_rows_stacked(jk, jv, jnp.asarray(src), jnp.asarray(dst))
    tk, tv = (t(a) if dtype != "bfloat16" else t(a).to(torch.bfloat16) for a in (k, v))
    ptrs = (tk.data_ptr(), tv.data_ptr())
    ok, ov = tkv.move_cache_rows_stacked(tk, tv, t(src), t(dst))
    assert ok is tk and ov is tv and (tk.data_ptr(), tv.data_ptr()) == ptrs
    for a, b in ((jk, tk), (jv, tv)):
        a = np.asarray(a.astype(jnp.float32) if dtype == "bfloat16" else a)
        np.testing.assert_array_equal(a, b.float().numpy() if dtype == "bfloat16" else b.numpy())
    # nothing kept: the pools are untouched
    before = tk.clone()
    tkv.move_cache_rows_stacked(tk, tv, t([-1, 2]), t([3, -1]))
    assert torch.equal(before, tk)
