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
code is 1/16), so logits within 2e-2 and pool codes within one."""

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
    cfg = DeepseekConfig.tiny()
    for kw in (dict(nsa=True), dict(compress="c4")):
        with pytest.raises(NotImplementedError):
            tds.make_cache(DeepseekConfig.tiny(**kw), 4, 16, device="cpu")
    with pytest.raises(NotImplementedError):
        tds.prefill_extend({}, cfg, None, torch.zeros(1, 4, dtype=torch.int32), None, None, None, None, None, None,
                           prefix_max=16, num_logits=2)
    with pytest.raises(ValueError):
        tds.make_cache(DeepseekConfig.tiny(kv_dtype=torch.int8), 4, 16, device="cpu")
