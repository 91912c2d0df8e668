"""Hybrid GDN (models/hybrid_gdn.py, HybridGdnAdapter, the engine over state
slots) in the port against the JAX package.

``HybridGdnConfig.tiny`` in float32 (4 layers: GDN, GQA, GDN, GQA), the JAX
parameter tree carried across by ``params_from_numpy``, inputs seeded with
numpy. Tolerances: the model programs' logits, KV pools and conv / SSM
states within 2e-4 of their scale (float32 on both sides, the chunked
delta rule's solve and the GEMMs summing in other orders, through four
layers); the engines' greedy tokens identical to a JAX oracle that runs the
JAX model functions on one request at a time (a whole-prompt prefill, then
decode steps), as tests/test_engine_families.py's does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.models import hybrid_gdn as jhg
from sgl_kernel_tpu_torch import Engine, HybridGdnConfig, params_from_numpy
from sgl_kernel_tpu_torch.models import hybrid_gdn as thg
from sgl_kernel_tpu_torch.serving.adapters import HybridGdnAdapter, adapter_for

torch.set_num_threads(1)

MODEL_TOL = 2e-4
PAGE, N_PAGES = 16, 32


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=MODEL_TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


class Pair:
    """The tiny hybrid model on both sides from one JAX tree."""

    def __init__(self):
        self.jcfg = jhg.HybridGdnConfig.tiny()
        self.tcfg = HybridGdnConfig.tiny()
        self.jparams = jhg.init_weights(self.jcfg, jax.random.PRNGKey(0))
        self.tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jparams), "cpu")
        self.jrope, self.trope = jhg.build_rope_cache(self.jcfg), thg.build_rope_cache(self.tcfg, "cpu")
        self._oracle = {}

    def fresh(self, n_seqs):
        j = (*jhg.make_caches(self.jcfg, N_PAGES, PAGE), *jhg.make_states(self.jcfg, n_seqs))
        tc = (*thg.make_caches(self.tcfg, N_PAGES, PAGE, device="cpu"),
              *thg.make_states(self.tcfg, n_seqs, device="cpu"))
        return list(j), list(tc)

    def run(self, name, j, tc, *arrays, **kw):
        out_j = getattr(jhg, name)(self.jparams, self.jcfg, *j, *map(jnp.asarray, arrays), self.jrope, **kw)
        out_t = getattr(thg, name)(self.tparams, self.tcfg, *tc, *map(t, arrays), self.trope, **kw)
        j[:] = out_j[1:]
        assert all(a is b for a, b in zip(out_t[1:], tc))  # every pool and state updated in place
        close(out_t[0], np.asarray(out_j[0]))
        for a, b in zip(tc, j):
            close(a, np.asarray(b))
        return np.asarray(out_j[0])

    def oracle(self, prompt, n_new):
        """The JAX model functions on one request: a whole-prompt prefill in
        pages 1.., then greedy decode steps."""
        key = (tuple(prompt), n_new)
        if key in self._oracle:
            return self._oracle[key]
        cfg, params, rope = self.jcfg, self.jparams, self.jrope
        kc, vc = jhg.make_caches(cfg, N_PAGES, PAGE)
        conv, ssm = jhg.make_states(cfg, 1)
        s = len(prompt)
        pad = max(16, 1 << (s - 1).bit_length())
        tok = np.zeros((1, pad), np.int32)
        tok[0, :s] = prompt
        pos = np.zeros((1, pad), np.int32)
        pos[0, :s] = np.arange(s)
        slots = np.full((1, pad), -1, np.int32)
        slots[0, :s] = PAGE + np.arange(s)
        logits, kc, vc, conv, ssm = jhg.prefill(params, cfg, kc, vc, conv, ssm, jnp.asarray(tok), jnp.asarray(pos),
                                                jnp.asarray([s], jnp.int32), jnp.asarray(slots), rope)
        out = [int(jnp.argmax(logits[0]))]
        table = np.arange(1, 1 + (s + n_new + PAGE) // PAGE, dtype=np.int32)[None]
        for i in range(n_new - 1):
            plen = s + i
            logits, kc, vc, conv, ssm = jhg.decode_step(
                params, cfg, kc, vc, conv, ssm, jnp.asarray([out[-1]], jnp.int32), jnp.asarray([plen], jnp.int32),
                jnp.asarray(table), jnp.asarray([plen + 1], jnp.int32), jnp.asarray([PAGE + plen], jnp.int32), rope)
            out.append(int(jnp.argmax(logits[0])))
        self._oracle[key] = out
        return out


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_weights_and_caches_match_jax_layout(pair):
    """init_weights gives the JAX tree's keys, shapes and dtypes (attention
    stacks over L // 2 layers, GDN stacks over ceil(L / 2), A_log and dt_bias
    float32); make_caches / make_states give JAX's pools; an odd layer count
    too. fused / quantized configs are refused."""
    for n_layers in (4, 5):
        jc, tc = dataclasses.replace(pair.jcfg, num_layers=n_layers), dataclasses.replace(pair.tcfg, num_layers=n_layers)
        jl = jax.eval_shape(lambda k: jhg.init_weights(jc, k), jax.random.PRNGKey(0))
        tl = thg.init_weights(tc, 0, device="cpu")
        jleaves = jax.tree_util.tree_leaves_with_path(jl)
        tflat = {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_leaves_with_path(tl)}
        assert {jax.tree_util.keystr(p) for p, _ in jleaves} == set(tflat)
        for p, x in jleaves:
            got = tflat[jax.tree_util.keystr(p)]
            assert tuple(got.shape) == x.shape and str(got.dtype).split(".")[-1] == str(x.dtype), p
        jp = (*jhg.make_caches(jc, 8, PAGE), *jhg.make_states(jc, 3))
        tp = (*thg.make_caches(tc, 8, PAGE, device="cpu"), *thg.make_states(tc, 3, device="cpu"))
        assert [tuple(x.shape) for x in tp] == [x.shape for x in jp]
    assert (pair.tcfg.qkvz_dim, pair.tcfg.ba_dim, pair.tcfg.conv_dim) == (
        pair.jcfg.qkvz_dim, pair.jcfg.ba_dim, pair.jcfg.conv_dim)
    for bad in (dict(fused=True), dict(quant="w4a16", group_size=32)):
        with pytest.raises(NotImplementedError):
            HybridGdnConfig.tiny(**bad)


def slots_of(pages, n, start=0):
    return [pages[p // PAGE] * PAGE + p % PAGE for p in range(start, start + n)]


def test_prefill_decode_and_extend(pair):
    """prefill of two ragged prompts (11 and 5 tokens) from zero states, two
    decode steps over both and a padding row (length 0, slot -1, its own
    state row), then on fresh pools the first prompt's 6 tokens by prefill
    and its next 14 by prefill_extend from the carried states: logits, KV
    pools and conv / SSM states equal to JAX's after every program."""
    rng = np.random.default_rng(7)
    v = pair.tcfg.vocab_size
    lens = [11, 5]
    pages = [[1, 2], [3, 4]]
    j, tc = pair.fresh(3)
    s = 16
    toks, pos, sl = np.zeros((3, s), np.int32), np.zeros((3, s), np.int32), np.full((3, s), -1, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n], pos[i, :n], sl[i, :n] = rng.integers(0, v, n), np.arange(n), slots_of(pages[i], n)
    logits = pair.run("prefill", j, tc, toks, pos, np.array(lens + [0], np.int32), sl)
    nxt = list(logits[:2].argmax(-1))
    tables = np.array(pages + [[0, 0]], np.int32)
    for step in range(2):
        positions = np.array([lens[0] + step, lens[1] + step, 0], np.int32)
        lengths = np.array([positions[0] + 1, positions[1] + 1, 0], np.int32)
        sl1 = np.array([slots_of(pages[0], 1, positions[0])[0], slots_of(pages[1], 1, positions[1])[0], -1], np.int32)
        logits = pair.run("decode_step", j, tc, np.array(nxt + [0], np.int32), positions, tables, lengths, sl1)
        nxt = list(logits[:2].argmax(-1))
    j, tc = pair.fresh(1)
    prompt = rng.integers(0, v, 20)
    tok, pos, sl = np.zeros((1, 16), np.int32), np.zeros((1, 16), np.int32), np.full((1, 16), -1, np.int32)
    tok[0, :6], pos[0, :6], sl[0, :6] = prompt[:6], np.arange(6), slots_of([1, 2], 6)
    pair.run("prefill", j, tc, tok, pos, np.array([6], np.int32), sl)
    tok, pos, sl = np.zeros((1, 16), np.int32), np.zeros((1, 16), np.int32), np.full((1, 16), -1, np.int32)
    tok[0, :14], pos[0, :14], sl[0, :14] = prompt[6:], np.arange(6, 20), slots_of([1, 2], 14, 6)
    pair.run("prefill_extend", j, tc, tok, pos, np.array([14], np.int32), np.array([20], np.int32),
             np.array([[1, 2]], np.int32), sl, prefix_max=16)


def test_adapter_flags_and_caches(pair):
    """adapter_for picks HybridGdnAdapter (before the Llama adapter, whose
    config HybridGdnConfig subclasses) with JAX's flags; its caches are
    (k, v, conv, ssm) with max_slots state rows."""
    ad = adapter_for(pair.tcfg, "cpu")
    assert type(ad) is HybridGdnAdapter
    assert (ad.name, ad.supports_spec, ad.supports_extend, ad.supports_prefix_reuse, ad.needs_state_slots,
            ad.prefill_packed) == ("hybrid_gdn", False, True, False, True, None)
    k, v, conv, ssm = ad.make_caches(8, PAGE, max_slots=5)
    assert k.shape[0] == 2 and conv.shape[:2] == (2, 5) and ssm.shape == (2, 5, 4, 16, 16)
    assert ssm.dtype == torch.float32 and conv.dtype == pair.tcfg.dtype


def engine(pair, **kw):
    kw = {"num_pages": N_PAGES, "page_size": PAGE, "prefill_bucket": 16, **kw}
    eng = Engine(pair.tcfg, pair.tparams, device="cpu", **kw)
    assert eng.native is None  # no prefix reuse for a recurrent state
    return eng


def test_engine_two_requests_recycle_a_slot(pair):
    """Two requests (7 and 11 tokens), the short one retiring first; then a
    third request takes the slot it freed, which holds its old state: every
    output equals the oracle's."""
    rng = np.random.default_rng(0)
    v = pair.tcfg.vocab_size
    p1, p2, p3 = (rng.integers(0, v, n).astype(np.int32).tolist() for n in (7, 11, 9))
    eng = engine(pair, max_batch=4)
    i1 = eng.add_request(p1, max_new_tokens=3)
    i2 = eng.add_request(p2, max_new_tokens=8)
    eng.run_until_done()
    slot1 = eng.finished[i1].state_slot
    assert eng.finished[i1].output == pair.oracle(p1, 3)
    assert eng.finished[i2].output == pair.oracle(p2, 8)
    assert sorted(eng._free_state_slots) == [0, 1, 2, 3] and slot1 == -1
    held = eng.caches[3][:, eng._free_state_slots[-1]].clone()
    assert held.abs().sum() > 0  # the slot the next request takes holds a retired request's state
    i3 = eng.add_request(p3, max_new_tokens=4)
    eng.run_until_done()
    assert eng.finished[i3].output == pair.oracle(p3, 4)
    assert eng.metrics.counters.get("nonfinite_logits", 0) == 0


def test_engine_chunked_prompts(pair):
    """A 40-token prompt chunked at 16 (a prefill, then two extends that
    carry the GDN states), then a 23-token one: outputs equal the oracle's
    whole-prompt prefill; the prefix cache stays off."""
    rng = np.random.default_rng(1)
    v = pair.tcfg.vocab_size
    eng = engine(pair, max_batch=2, prefill_chunk=16)
    calls = []
    for name in ("prefill", "prefill_extend"):
        fn = getattr(eng.adapter, name)
        setattr(eng.adapter, name, lambda *a, _n=name, _f=fn, **kw: (calls.append(_n), _f(*a, **kw))[1])
    for n, new in ((40, 5), (23, 4)):
        prompt = rng.integers(0, v, n).astype(np.int32).tolist()
        rid = eng.add_request(prompt, max_new_tokens=new)
        eng.run_until_done()
        assert eng.finished[rid].output == pair.oracle(prompt, new)
    assert calls == ["prefill", "prefill_extend", "prefill_extend", "prefill", "prefill_extend"]
    assert eng.metrics.counters.get("prefix_cache_hit_tokens", 0) == 0


def test_engine_decode_burst(pair):
    """decode_burst=3 over state slots (padding rows on the scratch slot):
    the tokens of plain decode, equal to the oracle's."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, pair.tcfg.vocab_size, n).astype(np.int32).tolist() for n in (9, 14)]
    eng = engine(pair, max_batch=3, decode_burst=3)
    rids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
    eng.run_until_done()
    for rid, p in zip(rids, prompts):
        assert eng.finished[rid].output == pair.oracle(p, 6)
    assert eng.metrics.counters["decode_graph_replays"] < eng.metrics.counters["tokens_decoded"]
