"""DeepSeek KV compression in the port against the JAX package: the 13
functions of ops/compression.py, the compressed family of models/deepseek.py
(prefill_c, prefill_packed_c, decode_step_c) and the engine that serves it
with per-request state slots.

Inputs are seeded with numpy; the models are ``DeepseekConfig.tiny`` in
float32 (c4: ring 4 and 8 local tokens, so a 23-token prompt already wraps
its ring; c128: ring 2 and 128 local tokens, max_position 512) with the JAX
parameter tree carried across by ``params_from_numpy``.

Tolerances: the plans are integers and must be equal; the pooling runs in
float32 on both sides and sums in another order, so pooled rows within
1e-5 of their scale; the models' logits, latent, score and ring pools within
2e-4 of their scale (tests/test_torch_deepseek.py's float32 bound), and the
engines' greedy tokens identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.models import deepseek as jds
from sgl_kernel_tpu.ops import compression as jcomp
from sgl_kernel_tpu.serving.engine import Engine as JaxEngine
from sgl_kernel_tpu_torch import DeepseekConfig, Engine, params_from_numpy
from sgl_kernel_tpu_torch.models import deepseek as tds
from sgl_kernel_tpu_torch.ops import compression as tcomp
from sgl_kernel_tpu_torch.serving.engine import packed_layout

torch.set_num_threads(1)

RATIOS = {"c4": 4, "c128": 128}
POOL_TOL = 1e-5
MODEL_TOL = 2e-4


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    fin = np.isfinite(want)
    scale = max(1.0, float(np.abs(want[fin]).max())) if fin.any() else 1.0
    assert np.array_equal(np.isfinite(got), fin)
    err = float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0
    assert err <= tol * scale, (err, tol * scale)


def window(ratio):
    return 2 * ratio if ratio == 4 else ratio


# ---------------------------------------------------------------------------
# ops/compression.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(RATIOS))
def test_compress_window_and_sequence(mode):
    """compress_window over windows with -inf (padding) score rows,
    compress_sequence and flash_compress{4,128}_prefill over a sequence that
    ends mid-window."""
    r = RATIOS[mode]
    w, d = window(r), 32
    rng = np.random.default_rng(r)
    kv = rng.standard_normal((3, w, d)).astype(np.float32)
    sc = rng.standard_normal((3, w, d)).astype(np.float32)
    sc[0, : w // 2] = -np.inf
    ape = (0.1 * rng.standard_normal((w, d))).astype(np.float32)
    close(tcomp.compress_window(t(kv), t(sc), t(ape)), jcomp.compress_window(kv, sc, ape), POOL_TOL)
    n = 2 * r + 3
    kv, sc = rng.standard_normal((n, d)).astype(np.float32), rng.standard_normal((n, d)).astype(np.float32)
    want = jcomp.compress_sequence(kv, sc, ape, compress_ratio=r)
    close(tcomp.compress_sequence(t(kv), t(sc), t(ape), compress_ratio=r), want, POOL_TOL)
    named = tcomp.flash_compress4_prefill if r == 4 else tcomp.flash_compress128_prefill
    jnamed = jcomp.flash_compress4_prefill if r == 4 else jcomp.flash_compress128_prefill
    close(named(t(kv), t(sc), t(ape)), jnamed(kv, sc, ape), POOL_TOL)
    with pytest.raises(ValueError):
        tcomp.compress_sequence(t(kv), t(sc), t(ape[:-1]), compress_ratio=r)


@pytest.mark.parametrize("mode", list(RATIOS))
def test_plans_equal(mode):
    """plan_compress_decode and plan_compress_prefill bit for bit, at
    lengths 0 (a padding row), just under, at and past ratio multiples and
    past the ring (eviction), with the default and an explicit window."""
    r, ring = RATIOS[mode], 3
    lengths = np.array([0, 1, r - 1, r, r + 1, 2 * r, 3 * r, 4 * r, 5 * r + 2, 7 * r], np.int32)
    for win in (None, r + 2):
        got = tcomp.plan_compress_decode(t(lengths), compress_ratio=r, ring_size=ring, window=win)
        want = jcomp.plan_compress_decode(lengths, compress_ratio=r, ring_size=ring, window=win)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w))
        got = tcomp.plan_compress_prefill(t(lengths), compress_ratio=r, ring_size=ring, window=win)
        want = jcomp.plan_compress_prefill(lengths, compress_ratio=r, ring_size=ring, window=win)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", list(RATIOS))
def test_flash_compress_decode(mode):
    """A decode plan applied against paged pools: flash_compress_decode on
    an explicit plan and the named per-ratio entry on the lengths; rows
    with no event leave their ring rows as they were."""
    r, ring, page, d = RATIOS[mode], 4, 16, 24
    rng = np.random.default_rng(7 + r)
    lengths = np.array([r, 2 * r, r + 1, 0, 6 * r], np.int32)
    b = lengths.shape[0]
    maxp = -(-int(lengths.max()) // page)
    tables = rng.permutation(b * maxp + 1)[1:].reshape(b, maxp).astype(np.int32)
    n_pool = (b * maxp + 1) * page
    kv = rng.standard_normal((n_pool, d)).astype(np.float32)
    sc = rng.standard_normal((n_pool, d)).astype(np.float32)
    ape = (0.1 * rng.standard_normal((window(r), d))).astype(np.float32)
    comp = rng.standard_normal((b, ring, d)).astype(np.float32)
    src, dst, _ = jcomp.plan_compress_decode(lengths, compress_ratio=r, ring_size=ring)
    want = jcomp.flash_compress_decode(kv, sc, ape, comp, src, dst, tables, page_size=page)
    got = tcomp.flash_compress_decode(t(kv), t(sc), t(ape), t(comp.copy()), t(np.asarray(src)),
                                      t(np.asarray(dst)), t(tables), page_size=page)
    close(got, want, POOL_TOL)
    jnamed = jcomp.flash_compress4_decode if r == 4 else jcomp.flash_compress128_decode
    named = tcomp.flash_compress4_decode if r == 4 else tcomp.flash_compress128_decode
    jpool, jn = jnamed(kv, sc, ape, comp, lengths, tables, page_size=page, ring_size=ring)
    pool, n = named(t(kv), t(sc), t(ape), t(comp.copy()), t(lengths), t(tables), page_size=page, ring_size=ring)
    close(pool, jpool, POOL_TOL)
    assert np.array_equal(n.numpy(), np.asarray(jn))
    assert np.array_equal(pool[3].numpy(), comp[3])  # length 0: no event, the ring untouched


def test_c4_dual_channel():
    """c4_window_dual on windows with a -inf padded half and
    compress_sequence_c4_dual over a sequence that ends mid-window."""
    hd = 16
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((5, 8, 4 * hd)).astype(np.float32)
    rows[1, :4, 2 * hd:] = -np.inf
    ape = (0.1 * rng.standard_normal((8, hd))).astype(np.float32)
    close(tcomp.c4_window_dual(t(rows), t(ape)), jcomp.c4_window_dual(rows, ape), POOL_TOL)
    seq = rng.standard_normal((22, 4 * hd)).astype(np.float32)
    close(tcomp.compress_sequence_c4_dual(t(seq), t(ape)), jcomp.compress_sequence_c4_dual(seq, ape), POOL_TOL)
    with pytest.raises(ValueError):
        tcomp.c4_window_dual(t(rows[:, :7]), t(ape))


@pytest.mark.parametrize("mode", list(RATIOS))
def test_legacy_plans_equal(mode):
    """plan_compress_decode_legacy (three requests, and one of length 0)
    and plan_compress_prefill_legacy (three requests, one extending a cached
    prefix) with their page and loc rules, bit for bit."""
    r = RATIOS[mode]
    rids = np.array([5, 0, 2], np.int32)
    seqs = np.array([3 * r + 1, 2, r + 5], np.int32)
    exts = np.array([2 * r + 1, 2, r + 5], np.int32)
    got = tcomp.plan_compress_decode_legacy(t(rids), t(seqs), compress_ratio=r)
    assert np.array_equal(got.numpy(), np.asarray(jcomp.plan_compress_decode_legacy(rids, seqs, compress_ratio=r)))
    zero = tcomp.plan_compress_decode_legacy(t(rids[:1]), t(np.zeros(1, np.int32)), compress_ratio=r)
    assert np.array_equal(zero.numpy(),
                          np.asarray(jcomp.plan_compress_decode_legacy(rids[:1], np.zeros(1, np.int32), r)))
    q = int(exts.sum())
    for g, w in zip(tcomp.plan_compress_prefill_legacy(rids, t(seqs), exts, q, r, device="cpu"),
                    jcomp.plan_compress_prefill_legacy(rids, seqs, exts, q, r)):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w))
    for pos in (0, 3, 4, 9):
        assert tcomp._legacy_loc(7, pos, r) == int(jcomp._legacy_loc(7, pos, r))
    with pytest.raises(ValueError):
        tcomp.plan_compress_prefill_legacy(rids, seqs, exts, q - 1, r, device="cpu")


# ---------------------------------------------------------------------------
# models/deepseek.py: the compressed family
# ---------------------------------------------------------------------------

MODEL = {  # (config, page size, pages, prompts, decode steps)
    "c4": (dict(compress="c4", compress_ring=4, compress_local=8), 16, 12, (23, 10), 3),
    "c128": (dict(compress="c128", compress_ring=2), 64, 16, (382, 70), 3),
}


def configs(mode, **extra):
    kw, *_ = MODEL[mode]
    jcfg, tcfg = jds.DeepseekConfig.tiny(**kw, **extra), DeepseekConfig.tiny(**kw, **extra)
    if mode == "c128":  # room for 382 + 3 positions
        jcfg, tcfg = dataclasses.replace(jcfg, max_position=512), dataclasses.replace(tcfg, max_position=512)
    return jcfg, tcfg


class CompPair:
    """The JAX and the port compressed model side by side on one parameter
    tree, each with (latent, score, ring) pools of 4 state slots."""

    def __init__(self, mode):
        _, self.page, self.n_pages, self.lens, self.steps = MODEL[mode]
        self.jcfg, self.tcfg = configs(mode)
        self.jparams = jds.init_weights(self.jcfg, jax.random.PRNGKey(11))
        self.tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jparams), "cpu")
        self.jrope, self.trope = jds.build_rope_cache(self.jcfg), tds.build_rope_cache(self.tcfg, "cpu")
        self.fresh()

    def fresh(self):
        self.j = jds.make_compress_caches(self.jcfg, self.n_pages, self.page, max_slots=4)
        self.t = tds.make_compress_caches(self.tcfg, self.n_pages, self.page, max_slots=4, device="cpu")

    def run(self, name, *arrays, **kw):
        jl, *self.j = getattr(jds, name)(self.jparams, self.jcfg, *self.j, *map(jnp.asarray, arrays), self.jrope,
                                         **kw)
        tl, *self.t = getattr(tds, name)(self.tparams, self.tcfg, *self.t, *map(t, arrays), self.trope, **kw)
        return np.asarray(jl), tl.numpy()

    def check(self, jl, tl):
        close(torch.from_numpy(tl), jl, MODEL_TOL)
        for jp, tp in zip(self.j, self.t):  # latent, score and ring pools
            close(tp, np.asarray(jp), MODEL_TOL)


@pytest.fixture(scope="module", params=list(MODEL))
def comp_pair(request):
    return CompPair(request.param)


def test_weights_and_caches_match_jax_layout(comp_pair):
    """init_weights gives the JAX tree's comp_score / comp_ape (float32)
    shapes, under W4A16 too; params_from_numpy carries them across; the
    caches are (latent, score, ring) of JAX's shapes."""
    jcfg, tcfg = comp_pair.jcfg, comp_pair.tcfg
    for extra in (dict(), dict(quant="w4a16", group_size=32)):
        jc, tc = dataclasses.replace(jcfg, **extra), dataclasses.replace(tcfg, **extra)
        jl = jax.eval_shape(lambda k: jds.init_weights(jc, k), jax.random.PRNGKey(0))["layers"]
        tl = tds.init_weights(tc, 0, device="cpu")["layers"]
        assert set(jl) == set(tl)
        for name in ("comp_score", "comp_ape"):
            jleaves, tleaves = jax.tree_util.tree_leaves(jl[name]), jax.tree_util.tree_leaves(tl[name])
            assert [tuple(x.shape) for x in jleaves] == [tuple(x.shape) for x in tleaves], name
        assert tl["comp_ape"].dtype == torch.float32
    assert comp_pair.tparams["layers"]["comp_ape"].dtype == torch.float32
    assert [tuple(p.shape) for p in comp_pair.t] == [tuple(p.shape) for p in comp_pair.j]


def slot_rows(pages, page, n, start=0):
    return [pages[p // page] * page + p % page for p in range(start, start + n)]


def test_prefill_c_then_decode_step_c(comp_pair):
    """A padded prefill of two prompts into state slots 2 and 0 (c4: 23
    tokens wrap a ring of 4; c128: 382 tokens, two events), then decode
    steps over both and a padding row in the scratch slot 3 (length 0):
    c4 fires an event at length 24, c128 wraps its ring at 384. Logits and
    the three pools after every program."""
    p = comp_pair
    p.fresh()
    rng = np.random.default_rng(4)
    v, page, lens = p.tcfg.vocab_size, p.page, p.lens
    s = -(-max(lens) // 16) * 16
    per = -(-(max(lens) + p.steps) // page)
    pages = [list(range(1 + i * per, 1 + (i + 1) * per)) for i in range(2)]
    toks, pos, sl = np.zeros((2, s), np.int32), np.zeros((2, s), np.int32), np.full((2, s), -1, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n], pos[i, :n], sl[i, :n] = rng.integers(0, v, n), np.arange(n), slot_rows(pages[i], page, n)
    slots = np.array([2, 0], np.int32)
    jl, tl = p.run("prefill_c", toks, pos, np.array(lens, np.int32), sl, slots)
    p.check(jl, tl)
    nxt = list(jl.argmax(-1))
    maxp = per + 1
    tables = np.array([pg + [0] * (maxp - per) for pg in pages] + [[0] * maxp], np.int32)
    for step in range(p.steps):
        positions = [lens[0] + step, lens[1] + step, 0]
        lengths = np.array([positions[0] + 1, positions[1] + 1, 0], np.int32)
        sl = [slot_rows(pages[i], page, 1, positions[i])[0] for i in range(2)] + [-1]
        jl, tl = p.run("decode_step_c", np.array(nxt + [0], np.int32), np.array(positions, np.int32), tables,
                       lengths, np.array(sl, np.int32), np.array([2, 0, 3], np.int32))
        p.check(jl[:2], tl[:2])
        nxt = list(jl[:2].argmax(-1))
    ratio = RATIOS["c4" if p.tcfg.compress == "c4" else "c128"]
    assert any(n % ratio == 0 for n in range(lens[0] + 1, lens[0] + p.steps + 1))  # an event fired on the way


def test_prefill_packed_c(comp_pair):
    """The two prompts block-aligned packed into one launch, in state slots
    1 and 3: logits and pools equal to JAX's (the rings read from the packed
    layout)."""
    p = comp_pair
    p.fresh()
    rng = np.random.default_rng(5)
    lens, page = list(p.lens), p.page
    per = -(-max(lens) // page)
    pages = [list(range(1 + i * per, 1 + (i + 1) * per)) for i in range(2)]
    blk_seq, blk_q0, seq_meta, tok0, tp, max_kvb = packed_layout(lens, 3)
    toks, pos, sl = np.zeros(tp, np.int32), np.zeros(tp, np.int32), np.full(tp, -1, np.int32)
    for i, (n, t0) in enumerate(zip(lens, tok0)):
        toks[t0: t0 + n] = rng.integers(0, p.tcfg.vocab_size, n)
        pos[t0: t0 + n], sl[t0: t0 + n] = np.arange(n), slot_rows(pages[i], page, n)
    last = np.array([t0 + n - 1 for t0, n in zip(tok0, lens)] + [0], np.int32)
    jl, tl = p.run("prefill_packed_c", toks, pos, blk_seq, blk_q0, seq_meta, last, sl,
                   np.array([1, 3, 2], np.int32), max_kvb=max_kvb)
    p.check(jl[:2], tl[:2])


def test_compressed_family_refusals():
    """kv_scale is refused (the rings pool unscaled latents), as is a local
    window shorter than the ratio; a config names only c4 or c128."""
    _, tcfg = configs("c4")
    params = {"embed": torch.zeros(tcfg.vocab_size, tcfg.hidden_size), "layers": {}}
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="kv_scale"):
        tds.decode_step_c(params, dataclasses.replace(tcfg, kv_scale=0.5), *tds.make_compress_caches(
            tcfg, 2, 16, 2, device="cpu"), z, z, z[None], z, z, z, None)
    with pytest.raises(ValueError, match="compress_local"):
        tds._comp_local(dataclasses.replace(tcfg, compress_local=2))
    with pytest.raises(AssertionError):
        jds._comp_local(dataclasses.replace(configs("c4")[0], compress_local=2))
    with pytest.raises(ValueError):
        DeepseekConfig.tiny(compress="c8")


def test_no_event_decode_equals_plain_mla():
    """c128 with contexts under 128 and a local window over the whole
    context: the ring branch is empty and the local branch is full
    attention, so prefill_c and decode_step_c give the plain prefill's and
    decode_step's logits (tests/test_compression_serving.py:47, its
    tolerance 3e-4) and the same greedy tokens."""
    _, cfg = configs("c128")
    cfg = dataclasses.replace(cfg, compress_ring=4, compress_local=128)
    params = tds.init_weights(cfg, 0, device="cpu")
    page = 16
    kv, sc, comp = tds.make_compress_caches(cfg, 8, page, max_slots=4, device="cpu")
    kv2 = tds.make_cache(cfg, 8, page, device="cpu")
    rope = tds.build_rope_cache(cfg, "cpu")
    lens = [10, 7]
    toks, pos, sl = np.zeros((2, 32), np.int32), np.zeros((2, 32), np.int32), np.full((2, 32), -1, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = (np.arange(n) * 7 + i) % cfg.vocab_size
        pos[i, :n], sl[i, :n] = np.arange(n), i * 32 + np.arange(n)
    tables = t(np.array([[0, 1], [2, 3]], np.int32))
    slots = t(np.array([0, 1], np.int32))
    lc, kv, sc, comp = tds.prefill_c(params, cfg, kv, sc, comp, t(toks), t(pos), t(np.array(lens, np.int32)), t(sl),
                                     slots, rope)
    ld, kv2 = tds.prefill(params, cfg, kv2, t(toks), t(pos), t(np.array(lens, np.int32)), t(sl), rope)
    torch.testing.assert_close(lc, ld, rtol=3e-4, atol=3e-4)
    tok = lc.argmax(-1).int()
    assert torch.equal(tok, ld.argmax(-1).int())
    lengths = np.array(lens, np.int32)
    for _ in range(3):
        lengths = lengths + 1
        p_ = t(lengths - 1)
        s_ = t(np.array([tables[i, (lengths[i] - 1) // page] * page + (lengths[i] - 1) % page for i in range(2)],
                        np.int32))
        lc, kv, sc, comp = tds.decode_step_c(params, cfg, kv, sc, comp, tok, p_, tables, t(lengths), s_, slots, rope)
        ld, kv2 = tds.decode_step(params, cfg, kv2, tok, p_, tables, t(lengths), s_, rope)
        torch.testing.assert_close(lc, ld, rtol=3e-4, atol=3e-4)
        tok = lc.argmax(-1).int()
        assert torch.equal(tok, ld.argmax(-1).int())
    assert not comp.any()  # no event fired: the rings are untouched


# ---------------------------------------------------------------------------
# the engine: state slots, packed admission, bursts
# ---------------------------------------------------------------------------


def engine_pair(mode, **kw):
    jcfg, tcfg = configs(mode)
    jparams = jds.init_weights(jcfg, jax.random.PRNGKey(13))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return JaxEngine(jcfg, jparams, **kw), Engine(tcfg, tparams, device="cpu", **kw)


def serve(engines, prompts, new, slots_seen):
    """Add ``prompts`` to both engines and step them side by side, recording
    the state slot each request holds on each side."""
    for eng in engines:
        for prompt in prompts:
            eng.add_request(prompt, max_new_tokens=new)
    while any(e.waiting or e.prefilling or e.running for e in engines):
        for eng, seen in zip(engines, slots_seen):
            eng.step()
            for r in eng.running:
                assert seen.setdefault(r.rid, r.state_slot) == r.state_slot


def test_engine_matches_jax_over_three_waves():
    """Both engines on the tiny c4 model (max_batch 3, a pool of 7 pages of
    16): three waves of 5, 4 and 5 prompts of 14-40 tokens, 9 new tokens
    each, so admission waits for pages and slots churn within every wave.
    Greedy tokens, the state slot every request held, the free-slot lists
    after each wave, blocked admissions and the ring pools must agree; the
    prefix cache is off and chunking refused."""
    jeng, teng = engine_pair("c4", max_batch=3, page_size=16, num_pages=7)
    assert teng.native is None and teng.adapter.needs_state_slots and not teng.adapter.supports_extend
    assert [tuple(c.shape) for c in teng.caches] == [tuple(c.shape) for c in jeng.caches]
    assert teng.caches[2].shape[1] == 4  # max_batch + 1 slots: the last one is the scratch slot
    rng = np.random.default_rng(17)
    seen = ({}, {})
    for n_req in (5, 4, 5):
        prompts = [rng.integers(1, 128, int(n)).tolist() for n in rng.integers(14, 41, n_req)]
        serve((jeng, teng), prompts, 9, seen)
        assert teng._free_state_slots == jeng._free_state_slots
        assert sorted(teng._free_state_slots) == [0, 1, 2]
    assert seen[0] == seen[1] and len(seen[1]) == 14 and len(set(seen[1].values()) - {0, 1, 2}) == 0
    for rid, r in jeng.finished.items():
        assert teng.finished[rid].output == r.output, rid
        assert teng.finished[rid].state_slot == -1
    jc, tc = jeng.metrics.counters, teng.metrics.counters
    for key in ("tokens_prefilled", "tokens_decoded", "requests_finished", "admission_blocked"):
        assert tc.get(key) == jc.get(key), key
    assert tc["admission_blocked"] > 0 and tc.get("nonfinite_logits", 0) == 0
    close(teng.caches[2][:, :3], np.asarray(jeng.caches[2])[:, :3], MODEL_TOL)
    with pytest.raises(ValueError):
        Engine(teng.cfg, teng.params, device="cpu", max_batch=3, page_size=16, num_pages=7, prefill_chunk=16)


def test_engine_admission_waits_for_a_free_state_slot():
    """With every state slot held, admission blocks even with pages free;
    the slot a retired request frees goes to the next request."""
    _, tcfg = configs("c4")
    eng = Engine(tcfg, device="cpu", max_batch=2, page_size=16, num_pages=16)
    eng._free_state_slots = [1]  # slot 0 held elsewhere
    a = eng.add_request([1, 2, 3], max_new_tokens=3)
    b = eng.add_request([4, 5, 6], max_new_tokens=3)
    eng.step()
    assert [r.rid for r in eng.running] == [a] and eng.running[0].state_slot == 1
    assert eng.metrics.counters["admission_blocked"] >= 1 and eng.waiting[0].rid == b
    eng.run_until_done()
    assert eng._free_state_slots == [1] and len(eng.finished[b].output) == 3


def test_burst_across_events_matches_steps_and_jax():
    """decode_burst=4 against decode_burst=1 and the JAX engine's
    decode_burst=4 on the c4 model: two greedy requests of 12 tokens whose
    bursts cross ratio multiples (events fire inside a burst, at lengths the
    host never sees) and a padding row that fires its own events in the
    scratch slot. Identical tokens."""
    kw = dict(max_batch=3, page_size=16, num_pages=16, prefill_bucket=16)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 128, n).tolist() for n in (9, 18)]
    outs = []
    for burst in (1, 4):
        jeng, teng = engine_pair("c4", decode_burst=burst, **kw)
        for eng in ((teng, jeng) if burst == 4 else (teng,)):
            rids = [eng.add_request(p, max_new_tokens=12) for p in prompts]
            eng.run_until_done()
            outs.append([eng.finished[r].output for r in rids])
    assert outs[0] == outs[1] == outs[2]
    assert all(len(o) == 12 for o in outs[0])


def test_decode_graph_passes_state_slots():
    """The decode program's static inputs carry the state slots: the rows'
    own slots, the scratch slot max_batch on padding rows, filled by the same
    one copy as the rest; the CPU runner's logits equal a direct
    adapter.decode on those arrays bit for bit."""
    _, tcfg = configs("c4")
    eng = Engine(tcfg, device="cpu", max_batch=4, page_size=16, num_pages=16)
    for n in (5, 9):
        eng.add_request(list(range(1, n + 1)), max_new_tokens=6)
    eng.step()
    eng.step()
    reqs = [r for r in eng.running if not r.done]
    arrays = eng._decode_inputs(reqs, 0)
    assert list(arrays[5]) == [r.state_slot for r in reqs] + [4, 4]
    before = [c.clone() for c in eng.caches]
    ref, _ = eng.adapter.decode(eng.params, [c.clone() for c in before], *(t(arrays[i]) for i in (0, 1, 4, 2, 3)),
                                state_slots=t(arrays[5]))
    logits = eng._run_decode(reqs, 1, 0)
    # padding rows (length 0) attend to nothing in either branch: their
    # merged state is NaN, as in JAX, and the engine never reads them
    assert torch.equal(logits[: len(reqs)], ref[: len(reqs)]) and torch.isnan(logits[len(reqs):]).all()
    assert np.array_equal(eng._inputs.state_slots.numpy(), arrays[5])
