"""The port's DeepSeek model (MLA + MoE) against the JAX model on the same
parameters (a JAX tree carried over by ``interop.params_from_numpy``) and
the same inputs: a padded prefill, two decode steps (with a padding row), a
packed prefill of two prompts and an extend over a cached prefix, each
compared on logits and on the latent pool they leave.

Configurations: the tiny model in float32, with the direct and the
low-rank q projection; in W4A16 (every linear and both expert banks
K-paired int4, group 32); and W4A16 over an int8 latent pool (kv_scale
1/16, bench.py's setting).

Tolerances: float32 on both sides, the same bytes in, sums in another
order: logits within 2e-4 of their scale. The int8 pool: a latent that
lands on a rounding tie may take the neighbouring code on one side (one
code is 1/16), so logits within 2e-2 and pool codes within one.

NSA sparse decode (``nsa=True``, indexer 2 heads of 32, with the direct and
the q-LoRA q projection; float32 model): the four programs against JAX's
with the full top-k (every token kept) and with top-k 4 (the selection
drops tokens), logits within 2e-4 of their scale, the latent pool as above,
indexer codes within one fp8 step (the Hadamard rotation sums in another
order) and their scales within 1e-5; with the full top-k, NSA decode equals
dense decode within 2e-3 (tests/test_deepseek.py's bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.models import deepseek as jds
from sgl_kernel_tpu_torch import DeepseekConfig, params_from_numpy
from sgl_kernel_tpu_torch.models import deepseek as tds
from sgl_kernel_tpu_torch.serving.engine import packed_layout

torch.set_num_threads(1)

PAGE, PAGES = 16, 16

CONFIGS = {
    "f32": (dict(), dict(), 2e-4),
    # the low-rank q path (wq_a -> q_a_norm -> wq_b, the DeepSeek-V3 layout)
    "f32_q_lora": (dict(q_lora_rank=48), dict(q_lora_rank=48), 2e-4),
    "w4a16": (dict(quant="w4a16", group_size=32), dict(quant="w4a16", group_size=32), 2e-4),
    "w4a16_int8": (dict(quant="w4a16", group_size=32, kv_dtype=jnp.int8, kv_scale=1 / 16),
                   dict(quant="w4a16", group_size=32, kv_dtype=torch.int8, kv_scale=1 / 16), 2e-2),
}


def i32(a):
    return np.asarray(a, np.int32)


class Pair:
    """The JAX and the port model side by side on one parameter tree."""

    def __init__(self, name):
        jkw, tkw, self.tol = CONFIGS[name]
        self.jcfg = jds.DeepseekConfig.tiny(**jkw)
        self.tcfg = DeepseekConfig.tiny(**tkw)
        self.jparams = jds.init_weights(self.jcfg, jax.random.PRNGKey(7))
        self.tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jparams), "cpu")
        self.jrope = jds.build_rope_cache(self.jcfg)
        self.trope = tds.build_rope_cache(self.tcfg, "cpu")
        self.fresh()

    def fresh(self):
        self.jkv = jds.make_cache(self.jcfg, PAGES, PAGE)
        self.tkv = tds.make_cache(self.tcfg, PAGES, PAGE, device="cpu")

    def run(self, name, *arrays, **kw):
        jl, self.jkv = getattr(jds, name)(self.jparams, self.jcfg, self.jkv, *map(jnp.asarray, arrays), self.jrope,
                                          **kw)
        tl, self.tkv = getattr(tds, name)(self.tparams, self.tcfg, self.tkv,
                                          *(torch.from_numpy(np.asarray(a)) for a in arrays), self.trope, **kw)
        return np.asarray(jl), tl.numpy()

    def check(self, jl, tl):
        assert np.isfinite(tl).all()
        scale = max(1.0, float(np.abs(jl).max()))
        assert np.abs(tl - jl).max() <= self.tol * scale, (float(np.abs(tl - jl).max()), self.tol * scale)
        pj = np.asarray(self.jkv.astype(jnp.float32))
        pt = self.tkv.float().numpy()
        code = 1.0 if self.tcfg.kv_dtype == torch.int8 else self.tol * max(1.0, float(np.abs(pj).max()))
        assert np.abs(pt - pj).max() <= code


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return Pair(request.param)


def slots_of(pages, n, start=0):
    return [pages[p // PAGE] * PAGE + p % PAGE for p in range(start, start + n)]


def test_prefill_then_decode(pair):
    """A padded prefill of two prompts (11 and 7 tokens in a 16 bucket),
    then two decode steps over both and a padding row (length 0)."""
    rng = np.random.default_rng(0)
    pair.fresh()
    v = pair.tcfg.vocab_size
    lens, pages = [11, 7], [[1, 2], [3, 4]]
    toks = np.zeros((2, 16), np.int32)
    pos = np.zeros((2, 16), np.int32)
    sl = np.full((2, 16), -1, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, v, n)
        pos[i, :n] = np.arange(n)
        sl[i, :n] = slots_of(pages[i], n)
    jl, tl = pair.run("prefill", toks, pos, i32(lens), sl)
    pair.check(jl, tl)
    nxt = jl.argmax(-1)
    table = i32([pages[0] + [0, 0], pages[1] + [0, 0], [0] * 4])
    for step in range(2):
        positions = [lens[0] + step, lens[1] + step, 0]
        jl, tl = pair.run("decode_step", i32(list(nxt) + [0]), i32(positions), table,
                          i32([p + 1 for p in positions[:2]] + [0]),
                          i32([slots_of(pages[0], 1, positions[0])[0], slots_of(pages[1], 1, positions[1])[0], -1]))
        pair.check(jl[:2], tl[:2])
        nxt = jl[:2].argmax(-1)


def test_prefill_packed_then_extend(pair):
    """Two prompts (20 and 9 tokens) block-aligned packed into one launch
    (block 256: more than 64 tokens, so the rotary + rmsnorm route), then an
    extend of 5 tokens over the first prompt's 16 cached ones."""
    rng = np.random.default_rng(1)
    pair.fresh()
    v = pair.tcfg.vocab_size
    lens, pages = [20, 9], [[1, 2], [3]]
    prompts = [rng.integers(0, v, n) for n in lens]
    blk_seq, blk_q0, seq_meta, tok0, tp, max_kvb = packed_layout(lens, 3)
    toks, pos, sl = np.zeros(tp, np.int32), np.zeros(tp, np.int32), np.full(tp, -1, np.int32)
    for i, (p, t0) in enumerate(zip(prompts, tok0)):
        toks[t0: t0 + len(p)], pos[t0: t0 + len(p)] = p, np.arange(len(p))
        sl[t0: t0 + len(p)] = slots_of(pages[i], len(p))
    last = i32([t0 + n - 1 for t0, n in zip(tok0, lens)] + [0])
    jl, tl = run_packed(pair, toks, pos, blk_seq, blk_q0, seq_meta, last, sl, max_kvb)
    pair.check(jl[:2], tl[:2])
    # extend: 5 tokens at positions 16..20 over the 16 cached positions of prompt 0
    s, new = 8, rng.integers(0, v, 5)
    toks = np.zeros((1, s), np.int32)
    toks[0, :5] = new
    pos = np.zeros((1, s), np.int32)
    pos[0, :5] = np.arange(16, 21)
    sl = np.full((1, s), -1, np.int32)
    sl[0, :5] = slots_of(pages[0], 5, 16)
    jl, tl = pair.run("prefill_extend", toks, pos, i32([5]), i32([21]), i32([pages[0] + [0, 0]]), sl,
                      prefix_max=PAGE)
    pair.check(jl, tl)


def run_packed(pair, toks, pos, blk_seq, blk_q0, seq_meta, last, sl, max_kvb):
    args = (toks, pos, blk_seq, blk_q0, seq_meta, last, sl)
    jl, pair.jkv = jds.prefill_packed(pair.jparams, pair.jcfg, pair.jkv, None, None, *map(jnp.asarray, args),
                                      pair.jrope, max_kvb=max_kvb)
    tl, pair.tkv = tds.prefill_packed(pair.tparams, pair.tcfg, pair.tkv, None, None,
                                      *(torch.from_numpy(np.asarray(a)) for a in args), pair.trope, max_kvb=max_kvb)
    return np.asarray(jl), tl.numpy()


def test_unported_paths_raise():
    """An int8 latent without a scale raises; several logits per sequence
    (tests/test_torch_spec.py), NSA and KV compression are served (the
    compressed family: tests/test_torch_compression.py)."""
    tds.make_cache(DeepseekConfig.tiny(nsa=True), 4, 16, device="cpu")  # NSA is served
    ccfg = DeepseekConfig.tiny(compress="c4", compress_ring=8)
    kv, sc, comp = tds.make_compress_caches(ccfg, 4, 16, max_slots=3, device="cpu")
    assert kv.shape == sc.shape == (ccfg.num_layers, 4, 16, 576)
    assert comp.shape == (ccfg.num_layers, 3, 8, 576) and comp.dtype == sc.dtype == ccfg.dtype
    with pytest.raises(ValueError):
        DeepseekConfig.tiny(compress="c2")
    with pytest.raises(ValueError):
        tds.make_cache(DeepseekConfig.tiny(kv_dtype=torch.int8), 4, 16, device="cpu")


NSA_LAYOUTS = {"nsa": dict(), "nsa_q_lora": dict(q_lora_rank=32)}


class NsaPair:
    """The JAX and the port NSA model side by side on one parameter tree,
    with both indexer pools."""

    def __init__(self, layout, topk):
        kw = dict(nsa=True, idx_dim=32, idx_heads=2, index_topk=topk, **NSA_LAYOUTS[layout])
        self.jcfg, self.tcfg = jds.DeepseekConfig.tiny(**kw), DeepseekConfig.tiny(**kw)
        self.jparams = jds.init_weights(self.jcfg, jax.random.PRNGKey(5))
        self.tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jparams), "cpu")
        self.jrope = (jds.build_rope_cache(self.jcfg), jds.build_idx_rope_cache(self.jcfg))
        self.trope = (tds.build_rope_cache(self.tcfg, "cpu"), tds.build_idx_rope_cache(self.tcfg, "cpu"))
        self.fresh()

    def fresh(self):
        self.j = (jds.make_cache(self.jcfg, PAGES, PAGE), *jds.make_indexer_cache(self.jcfg, PAGES, PAGE))
        self.t = (tds.make_cache(self.tcfg, PAGES, PAGE, device="cpu"),
                  *tds.make_indexer_cache(self.tcfg, PAGES, PAGE, device="cpu"))

    def run(self, name, *arrays, **kw):
        jl, *self.j = getattr(jds, name)(self.jparams, self.jcfg, *self.j, *map(jnp.asarray, arrays), *self.jrope, **kw)
        tl, *self.t = getattr(tds, name)(self.tparams, self.tcfg, *self.t,
                                         *(torch.from_numpy(np.asarray(a)) for a in arrays), *self.trope, **kw)
        return np.asarray(jl), tl.numpy()

    def run_packed(self, *arrays, max_kvb):
        jl, *self.j = jds.prefill_packed(self.jparams, self.jcfg, *self.j, *map(jnp.asarray, arrays), self.jrope[0],
                                         max_kvb=max_kvb, with_indexer=True, idx_rope_cache=self.jrope[1])
        tl, *self.t = tds.prefill_packed(self.tparams, self.tcfg, *self.t,
                                         *(torch.from_numpy(np.asarray(a)) for a in arrays), self.trope[0],
                                         max_kvb=max_kvb, with_indexer=True, idx_rope_cache=self.trope[1])
        return np.asarray(jl), tl.numpy()

    def check(self, jl, tl):
        assert np.isfinite(tl).all()
        scale = max(1.0, float(np.abs(jl).max()))
        assert np.abs(tl - jl).max() <= 2e-4 * scale, (float(np.abs(tl - jl).max()), 2e-4 * scale)
        jkv, jk, js = (np.asarray(a.astype(jnp.float32)) if a.dtype != jnp.float8_e4m3fn else np.asarray(a)
                       for a in self.j)
        tkv, tk, ts = self.t
        assert np.abs(tkv.numpy() - jkv).max() <= 2e-4 * max(1.0, float(np.abs(jkv).max()))
        assert within_one_code(tk.view(torch.uint8).numpy(), jk.view(np.uint8))
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=0)


def within_one_code(a, b):
    """fp8 code bytes equal or one code step apart (sign-magnitude)."""
    a, b = a.astype(np.int32), b.astype(np.int32)
    same_sign = (a >> 7) == (b >> 7)
    return bool(np.all((same_sign & (np.abs((a & 0x7F) - (b & 0x7F)) <= 1)) | (((a & 0x7F) <= 1) & ((b & 0x7F) <= 1))))


@pytest.fixture(scope="module", params=[(layout, topk) for layout in NSA_LAYOUTS for topk in (2048, 4)],
                ids=lambda p: f"{p[0]}-topk{p[1]}")
def nsa_pair(request):
    return NsaPair(*request.param)


def test_nsa_prefill_then_decode(nsa_pair):
    """prefill_nsa of two prompts (13 and 7 tokens in a 16 bucket), then
    three decode_step_nsa steps over both and a padding row (length 0)."""
    pair = nsa_pair
    rng = np.random.default_rng(20)
    pair.fresh()
    lens, pages = [13, 7], [[1, 2], [3, 4]]
    toks, pos, sl = np.zeros((2, 16), np.int32), np.zeros((2, 16), np.int32), np.full((2, 16), -1, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, pair.tcfg.vocab_size, n)
        pos[i, :n] = np.arange(n)
        sl[i, :n] = slots_of(pages[i], n)
    jl, tl = pair.run("prefill_nsa", toks, pos, i32(lens), sl)
    pair.check(jl, tl)
    nxt = jl.argmax(-1)
    table = i32([pages[0] + [0, 0], pages[1] + [0, 0], [0] * 4])
    for step in range(3):
        positions = [lens[0] + step, lens[1] + step, 0]
        jl, tl = pair.run("decode_step_nsa", i32(list(nxt) + [0]), i32(positions), table,
                          i32([p + 1 for p in positions[:2]] + [0]),
                          i32([slots_of(pages[0], 1, positions[0])[0], slots_of(pages[1], 1, positions[1])[0], -1]))
        pair.check(jl[:2], tl[:2])
        nxt = jl[:2].argmax(-1)


def test_nsa_packed_then_extend(nsa_pair):
    """prefill_packed(with_indexer=True) of two prompts (20 and 9 tokens),
    prefill_extend_nsa of 5 tokens over the first one's 16 cached, then a
    decode_step_nsa over the 21 tokens."""
    pair = nsa_pair
    rng = np.random.default_rng(21)
    pair.fresh()
    lens, pages = [20, 9], [[1, 2], [3]]
    prompts = [rng.integers(0, pair.tcfg.vocab_size, n) for n in lens]
    blk_seq, blk_q0, seq_meta, tok0, tp, max_kvb = packed_layout(lens, 3)
    toks, pos, sl = np.zeros(tp, np.int32), np.zeros(tp, np.int32), np.full(tp, -1, np.int32)
    for i, (p, t0) in enumerate(zip(prompts, tok0)):
        toks[t0: t0 + len(p)], pos[t0: t0 + len(p)] = p, np.arange(len(p))
        sl[t0: t0 + len(p)] = slots_of(pages[i], len(p))
    last = i32([t0 + n - 1 for t0, n in zip(tok0, lens)] + [0])
    jl, tl = pair.run_packed(toks, pos, blk_seq, blk_q0, seq_meta, last, sl, max_kvb=max_kvb)
    pair.check(jl[:2], tl[:2])
    s, new = 8, rng.integers(0, pair.tcfg.vocab_size, 5)
    toks, pos, sl = np.zeros((1, s), np.int32), np.zeros((1, s), np.int32), np.full((1, s), -1, np.int32)
    toks[0, :5], pos[0, :5], sl[0, :5] = new, np.arange(16, 21), slots_of(pages[0], 5, 16)
    table = i32([pages[0] + [0, 0]])
    jl, tl = pair.run("prefill_extend_nsa", toks, pos, i32([5]), i32([21]), table, sl, prefix_max=PAGE)
    pair.check(jl, tl)
    jl, tl = pair.run("decode_step_nsa", i32([jl[0].argmax()]), i32([21]), table, i32([22]),
                      i32(slots_of(pages[0], 1, 21)))
    pair.check(jl, tl)


@pytest.mark.parametrize("topk", [2048, 4])
def test_nsa_decode_against_dense(topk):
    """The port alone: with every token selected NSA decode is dense decode
    (within 2e-3); with top-k 4 of 13 tokens it is finite and differs."""
    cfg = DeepseekConfig.tiny(nsa=True, idx_dim=32, idx_heads=2, index_topk=topk)
    jparams = jds.init_weights(jds.DeepseekConfig.tiny(nsa=True, idx_dim=32, idx_heads=2), jax.random.PRNGKey(6))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rope, irope = tds.build_rope_cache(cfg, "cpu"), tds.build_idx_rope_cache(cfg, "cpu")
    rng = np.random.default_rng(22)
    s = 12
    toks = rng.integers(0, cfg.vocab_size, s + 1).astype(np.int32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    tok, pos, sl = np.zeros((1, 16), np.int32), np.zeros((1, 16), np.int32), np.full((1, 16), -1, np.int32)
    tok[0, :s], pos[0, :s], sl[0, :s] = toks[:s], np.arange(s), PAGE + np.arange(s)
    kv_d = tds.make_cache(cfg, 8, PAGE, device="cpu")
    _, kv_d = tds.prefill(params, cfg, kv_d, t(tok), t(pos), t([s]), t(sl), rope)
    kv_n, ik, isc = tds.make_cache(cfg, 8, PAGE, device="cpu"), *tds.make_indexer_cache(cfg, 8, PAGE, device="cpu")
    _, kv_n, ik, isc = tds.prefill_nsa(params, cfg, kv_n, ik, isc, t(tok), t(pos), t([s]), t(sl), rope, irope)
    assert torch.equal(kv_d, kv_n)
    args = (t([toks[s]]), t([s]), t([[1, 2, 0, 0]]), t([s + 1]), t([PAGE + s]))
    dense, _ = tds.decode_step(params, cfg, kv_d, *args, rope)
    sparse, *_ = tds.decode_step_nsa(params, cfg, kv_n, ik, isc, *args, rope, irope)
    assert torch.isfinite(sparse).all()
    diff = float((sparse - dense).abs().max())
    if topk >= s + 1:
        assert diff <= 2e-3 * max(1.0, float(dense.abs().max())), diff
    else:
        assert diff > 1e-3, diff
