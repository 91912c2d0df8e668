"""The port's Mixtral model against the JAX model on the same parameters (a
JAX tree carried over by ``interop.params_from_numpy``) and the same inputs:
a padded prefill, two decode steps (with a padding row), a packed prefill of
two prompts and an extend over a cached prefix, each compared on logits and
on the K/V pools they leave.

Configurations: the tiny model (4 experts, top-2) in float32, and in W4A16
(the attention linears, the lm_head and both expert banks K-paired int4,
group 32) with float32 activations; and the float32 model with nonzero
biases, the gpt-oss layout that reuses this skeleton (``o_bias``,
``router_bias``, ``moe_b1``, ``moe_b2``), through all four programs.

Tolerance: float32 on both sides and the same bytes in (the W4A16 codes
too); the JAX side runs its Pallas kernels in interpret mode and the port
its plain twins, which sum in another order: logits and pools within 2e-5
of their scale. The routing is compared first: the same experts for every
token (a near-tie between the 2nd and 3rd expert would flip on a 1e-7
difference; the seeds give none)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.models import mixtral as jmix
from sgl_kernel_tpu_torch import MixtralConfig, params_from_numpy
from sgl_kernel_tpu_torch.models import mixtral as tmix
from sgl_kernel_tpu_torch.serving.engine import packed_layout

torch.set_num_threads(1)

PAGE, PAGES = 16, 16
TOL = 2e-5
CONFIGS = {"f32": dict(), "w4a16": dict(quant="w4a16", group_size=32), "f32_biased": dict()}


def i32(a):
    return np.asarray(a, np.int32)


class Pair:
    """The JAX and the port model side by side on one parameter tree; each
    side's routing ids are recorded per call so the test can hold them
    equal."""

    def __init__(self, name):
        kw = CONFIGS[name]
        self.jcfg = jmix.MixtralConfig.tiny(**kw)
        self.tcfg = MixtralConfig.tiny(**kw)
        self.jparams = jmix.init_weights(self.jcfg, jax.random.PRNGKey(5))
        if name.endswith("biased"):
            add_biases(self.jparams, self.jcfg)
        self.tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jparams), "cpu")
        self.jrope = jmix.build_rope_cache(self.jcfg)
        self.trope = tmix.build_rope_cache(self.tcfg, "cpu")
        self.fresh()

    def fresh(self):
        self.jk, self.jv = jmix.make_caches(self.jcfg, PAGES, PAGE)
        self.tk, self.tv = tmix.make_caches(self.tcfg, PAGES, PAGE, device="cpu")

    def run(self, name, *arrays, **kw):
        jl, self.jk, self.jv = getattr(jmix, name)(self.jparams, self.jcfg, self.jk, self.jv,
                                                   *map(jnp.asarray, arrays), self.jrope, **kw)
        tl, self.tk, self.tv = getattr(tmix, name)(self.tparams, self.tcfg, self.tk, self.tv,
                                                   *(torch.from_numpy(np.asarray(a)) for a in arrays), self.trope,
                                                   **kw)
        return np.asarray(jl), tl.numpy()

    def check(self, jl, tl):
        assert np.isfinite(tl).all()
        for a, b in ((jl, tl), (np.asarray(self.jk), self.tk.numpy()), (np.asarray(self.jv), self.tv.numpy())):
            scale = max(1.0, float(np.abs(a).max()))
            assert np.abs(b - a).max() <= TOL * scale, (float(np.abs(b - a).max()), TOL * scale)


def add_biases(params, cfg):
    """Nonzero o, router and expert biases in the JAX tree's layout."""
    rng = np.random.default_rng(3)
    lw = params["layers"]
    l, h, e = cfg.num_layers, cfg.hidden_size, cfg.num_experts
    inter = lw["moe_w2"].shape[-2]
    lw["o_bias"] = jnp.asarray(rng.standard_normal((l, h)) * 0.1, cfg.dtype)
    lw["router_bias"] = jnp.asarray(rng.standard_normal((l, e)) * 0.5, jnp.float32)
    lw["moe_b1"] = jnp.asarray(rng.standard_normal((l, e, 2 * inter)) * 0.1, jnp.float32)
    lw["moe_b2"] = jnp.asarray(rng.standard_normal((l, e, h)) * 0.1, jnp.float32)


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
    toks, pos, sl = np.zeros((2, 16), np.int32), np.zeros((2, 16), np.int32), np.full((2, 16), -1, np.int32)
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
    """Two prompts (20 and 9 tokens) block-aligned packed into one launch,
    then an extend of 5 tokens over the first prompt's 16 cached ones."""
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
    jl, tl = pair.run("prefill_packed", toks, pos, blk_seq, blk_q0, seq_meta, last, sl, max_kvb=max_kvb)
    pair.check(jl[:2], tl[:2])
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


def test_routing_and_moe_mlp(pair):
    """One layer's router and routed MLP on the same hidden states: the
    same experts for every token, then the MLP output."""
    from sgl_kernel_tpu.ops import moe as jmoe
    from sgl_kernel_tpu_torch.ops import moe as tmoe

    rng = np.random.default_rng(2)
    h = rng.standard_normal((9, pair.tcfg.hidden_size)).astype(np.float32)
    jlw, tlw = pair.jparams["layers"], pair.tparams["layers"]
    logits = h @ np.asarray(jlw["router"][1], np.float32).T
    _, jids = jmoe.topk_softmax(jnp.asarray(logits), 2, renormalize=True)
    _, tids = tmoe.topk_softmax(torch.from_numpy(logits), 2, renormalize=True)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    ref = np.asarray(jmix._moe_mlp(jnp.asarray(h), jlw, 1, pair.jcfg))
    out = tmix._moe_mlp(torch.from_numpy(h), tlw, 1, pair.tcfg).numpy()
    assert np.abs(out - ref).max() <= TOL * max(1.0, float(np.abs(ref).max()))


def test_config_and_adapter():
    """mixtral_8x7b's widths; the fused layout and quantized KV pools are
    refused; mxfp4 banks are the MoE configs' (attention stays dense, the
    banks MXFP4 at groups of 32), refused by the dense Llama config;
    adapter_for picks the Mixtral adapter before the Llama one (a
    MixtralConfig is a LlamaConfig), whose model has no mixed step."""
    import sgl_kernel_tpu_torch as skt

    cfg = MixtralConfig.mixtral_8x7b(quant="w4a16")
    assert (cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.num_experts, cfg.top_k, cfg.rope_theta,
            cfg.vocab_size, cfg.fused) == (4096, 14336, 32, 8, 2, 1e6, 32000, False)
    for kw in (dict(fused=True), dict(kv_dtype=torch.int8, kv_scale=0.1)):
        with pytest.raises((ValueError, NotImplementedError)):
            MixtralConfig.tiny(**kw)
    with pytest.raises(NotImplementedError):
        skt.LlamaConfig.tiny(quant="mxfp4")
    mx = tmix.init_weights(MixtralConfig.tiny(quant="mxfp4"), 0, "cpu")["layers"]
    assert mx["q"].shape == (2, 128, 128) and mx["moe_w1"]["packed"].shape == (2, 4, 64, 128)
    assert mx["moe_w1"]["scales"].shape == (2, 4, 4, 128) and mx["moe_w1"]["scales"].dtype == torch.bfloat16
    assert tmix.moe_weights_for(mx, MixtralConfig.tiny(quant="mxfp4"))[-2:] == (32, "mxfp4")
    ad = skt.adapter_for(MixtralConfig.tiny(), "cpu")
    assert isinstance(ad, skt.MixtralAdapter) and ad._m is tmix and ad.supports_extend and ad.supports_spec
    assert not hasattr(ad._m, "mixed_step")
    params = ad.init_weights(torch.Generator().manual_seed(0))
    lw = params["layers"]
    assert lw["moe_w1"].shape == (2, 4, 128, 128) and lw["moe_w2"].shape == (2, 4, 64, 128)
    assert lw["router"].shape == (2, 4, 128) and "gate" not in lw and "down" not in lw
    qlw = tmix.init_weights(MixtralConfig.tiny(quant="w4a16", group_size=32), 0, "cpu")["layers"]
    assert qlw["moe_w1"]["packed"].shape == (2, 4, 64, 128) and qlw["moe_w1"]["scales"].shape == (2, 4, 4, 128)
    assert qlw["q"]["packed"].shape == (2, 64, 128)
