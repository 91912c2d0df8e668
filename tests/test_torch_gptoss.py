"""The port's gpt-oss model against the JAX model on the same parameters (a
JAX tree carried over by ``interop.params_from_numpy``) and the same inputs:
a padded prefill, two decode steps (with a padding row), a packed prefill of
two prompts and an extend over a cached prefix, each compared on logits and
on the K/V pools they leave; then the engine end to end against the JAX
engine, with a prefix hit and a chunked prompt.

Configurations: the tiny model (4 experts, top-2, window 16 on layer 0,
global layer 1) in float32 with q / k / v biases, nonzero sinks, o / router /
expert biases; and the same with ``quant="mxfp4"`` expert banks (E2M1 codes,
UE8M0 group-32 scales made by each side's ``per_token_group_quant_fp4``, held
equal byte for byte), float32 activations. Prompts of up to 29 tokens cross
the 16-token window, and the extend's two passes cut it at a prefix of 16.

Tolerance: float32 on both sides and the same bytes in; the JAX side runs
its Pallas kernels in interpret mode and the port its plain twins, which sum
in another order: logits and pools within 2e-5 of their scale. The routing
is the same on both sides (checked in test_torch_mixtral.py on the same
skeleton; a flip here would show as a logit far outside the tolerance)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.models import gptoss as jgpt
from sgl_kernel_tpu.serving.engine import Engine as JEngine
import sgl_kernel_tpu_torch as skt
from sgl_kernel_tpu_torch import GptOssConfig, params_from_numpy
from sgl_kernel_tpu_torch.models import gptoss as tgpt
from sgl_kernel_tpu_torch.serving.engine import packed_layout

torch.set_num_threads(1)

PAGE, PAGES = 16, 16
TOL = 2e-5
CONFIGS = {"f32": dict(qkv_bias=True), "mxfp4": dict(qkv_bias=True, quant="mxfp4")}


def i32(a):
    return np.asarray(a, np.int32)


def add_extras(params, cfg):
    """Nonzero sinks, q / k / v, o, router and expert biases in the JAX
    tree's layout (the JAX init leaves them zero or absent)."""
    rng = np.random.default_rng(3)
    lw = params["layers"]
    l, h, e, nq, nkv, d = cfg.num_layers, cfg.hidden_size, cfg.num_experts, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    inter = cfg.intermediate_size
    lw["sinks"] = jnp.asarray(rng.standard_normal((l, nq)) * 2.0, cfg.dtype)
    for name, n in (("q_bias", nq * d), ("k_bias", nkv * d), ("v_bias", nkv * d)):
        lw[name] = jnp.asarray(rng.standard_normal((l, n)) * 0.1, cfg.dtype)
    lw["o_bias"] = jnp.asarray(rng.standard_normal((l, h)) * 0.1, cfg.dtype)
    lw["router_bias"] = jnp.asarray(rng.standard_normal((l, e)) * 0.5, jnp.float32)
    lw["moe_b1"] = jnp.asarray(rng.standard_normal((l, e, 2 * inter)) * 0.1, jnp.float32)
    lw["moe_b2"] = jnp.asarray(rng.standard_normal((l, e, h)) * 0.1, jnp.float32)


def jax_params(name, cfg):
    params = jgpt.init_weights(cfg, jax.random.PRNGKey(5))
    add_extras(params, cfg)
    return params


class Pair:
    """The JAX and the port model side by side on one parameter tree."""

    def __init__(self, name):
        kw = CONFIGS[name]
        self.jcfg = jgpt.GptOssConfig.tiny(**kw)
        self.tcfg = GptOssConfig.tiny(**kw)
        self.jparams = jax_params(name, self.jcfg)
        self.tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jparams), "cpu")
        self.jrope = jgpt.build_rope_cache(self.jcfg)
        self.trope = tgpt.build_rope_cache(self.tcfg, "cpu")
        self.fresh()

    def fresh(self):
        self.jk, self.jv = jgpt.make_caches(self.jcfg, PAGES, PAGE)
        self.tk, self.tv = tgpt.make_caches(self.tcfg, PAGES, PAGE, device="cpu")

    def run(self, name, *arrays, **kw):
        jl, self.jk, self.jv = getattr(jgpt, name)(self.jparams, self.jcfg, self.jk, self.jv,
                                                   *map(jnp.asarray, arrays), self.jrope, **kw)
        tl, self.tk, self.tv = getattr(tgpt, name)(self.tparams, self.tcfg, self.tk, self.tv,
                                                   *(torch.from_numpy(np.asarray(a)) for a in arrays), self.trope,
                                                   **kw)
        return np.asarray(jl), tl.numpy()

    def check(self, jl, tl):
        assert np.isfinite(tl).all()
        for a, b in ((jl, tl), (np.asarray(self.jk), self.tk.numpy()), (np.asarray(self.jv), self.tv.numpy())):
            scale = max(1.0, float(np.abs(a).max()))
            assert np.abs(b - a).max() <= TOL * scale, (float(np.abs(b - a).max()), TOL * scale)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return Pair(request.param)


def slots_of(pages, n, start=0):
    return [pages[p // PAGE] * PAGE + p % PAGE for p in range(start, start + n)]


def test_banks_carry_over(pair):
    """The tree the port is handed: the mxfp4 banks as JAX made them (codes
    uint8 [L, E, K/2, N], bf16 power-of-two scales [L, E, K/32, N]), the
    sinks [L, Hq] and the biases; the port's own init makes the same banks
    from the same float weights (its ``per_token_group_quant_fp4`` and
    ``mxfp4_to_tpu_layout``)."""
    lw = pair.tparams["layers"]
    cfg = pair.tcfg
    assert lw["sinks"].shape == (cfg.num_layers, cfg.num_heads)
    assert lw["q_bias"].shape == (cfg.num_layers, cfg.num_heads * cfg.head_dim)
    w = tgpt.mixtral.moe_weights_for(lw, cfg)
    if cfg.quant != "mxfp4":
        assert w.fmt == "bf16"
        return
    assert (w.fmt, w.group_size) == ("mxfp4", 32)
    assert w.w1.dtype == torch.uint8 and w.w1_scales.dtype == torch.bfloat16
    assert tuple(w.w1.shape) == (2, 4, cfg.hidden_size // 2, 2 * cfg.intermediate_size)
    assert tuple(w.w2_scales.shape) == (2, 4, cfg.intermediate_size // 32, cfg.hidden_size)
    sc = w.w1_scales.float()
    assert torch.equal(torch.exp2(torch.log2(sc).round()), sc)
    # the port's quantizer on the JAX init's float banks gives the JAX bytes
    from sgl_kernel_tpu_torch.ops.gemm.w4a16 import mxfp4_to_tpu_layout
    from sgl_kernel_tpu_torch.ops.quant import per_token_group_quant_fp4

    jf = jgpt.init_weights(dataclasses.replace(pair.jcfg, quant=None), jax.random.PRNGKey(5))
    m = torch.from_numpy(np.array(jf["layers"]["moe_w1"][1, 2], np.float32))
    p, s = mxfp4_to_tpu_layout(*per_token_group_quant_fp4(m.t()))
    assert torch.equal(p, w.w1[1, 2]) and torch.equal(s, w.w1_scales[1, 2])


def test_prefill_then_decode(pair):
    """A padded prefill of two prompts (23 and 7 tokens in a 32 bucket),
    then two decode steps over both and a padding row (length 0)."""
    rng = np.random.default_rng(0)
    pair.fresh()
    v = pair.tcfg.vocab_size
    lens, pages = [23, 7], [[1, 2], [3, 4]]
    toks, pos, sl = np.zeros((2, 32), np.int32), np.zeros((2, 32), np.int32), np.full((2, 32), -1, np.int32)
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
    """Two prompts (29 and 9 tokens) block-aligned packed into one launch,
    then an extend of 5 tokens over the first prompt's 16 cached ones
    (layer 0's window reaches back into the prefix, so both passes count)."""
    rng = np.random.default_rng(1)
    pair.fresh()
    v = pair.tcfg.vocab_size
    lens, pages = [29, 9], [[1, 2], [3]]
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


@pytest.mark.parametrize("bucket", [16, 64])
def test_extend_wide_bucket(pair, bucket):
    """A 37-token prompt in chunks of 16, 16 and 5, each chunk padded to
    ``bucket`` rows, gives the logits of its one padded prefill: padding rows
    whose window holds no key (bucket 64) stay finite and touch no valid
    row (the port's empty rows: o = 0, a finite lse). The JAX model's full
    prefill is the reference."""
    rng = np.random.default_rng(7)
    p, pages = rng.integers(1, pair.tcfg.vocab_size, 37), [1, 2, 3]
    pair.fresh()
    toks, pos, sl = np.zeros((1, 48), np.int32), np.zeros((1, 48), np.int32), np.full((1, 48), -1, np.int32)
    toks[0, :37], pos[0, :37], sl[0, :37] = p, np.arange(37), slots_of(pages, 37)
    full, _ = pair.run("prefill", toks, pos, i32([37]), sl)
    pair.tk, pair.tv = tgpt.make_caches(pair.tcfg, PAGES, PAGE, device="cpu")
    for a, n in ((0, 16), (16, 16), (32, 5)):
        toks, pos, sl = np.zeros((1, bucket), np.int32), np.zeros((1, bucket), np.int32), np.full((1, bucket), -1,
                                                                                                     np.int32)
        toks[0, :n], pos[0, :n], sl[0, :n] = p[a:a + n], np.arange(a, a + n), slots_of(pages, n, a)
        args = [torch.from_numpy(x) for x in (toks, pos, i32([n]))]
        if a == 0:
            tl, pair.tk, pair.tv = tgpt.prefill(pair.tparams, pair.tcfg, pair.tk, pair.tv, *args,
                                                torch.from_numpy(sl), pair.trope)
        else:
            tl, pair.tk, pair.tv = tgpt.prefill_extend(pair.tparams, pair.tcfg, pair.tk, pair.tv, *args,
                                                       torch.from_numpy(i32([a + n])), torch.from_numpy(i32([pages + [0]])),
                                                       torch.from_numpy(sl), pair.trope, prefix_max=a)
    tl = tl.numpy()
    assert np.isfinite(tl).all()
    assert np.abs(tl - full).max() <= TOL * max(1.0, float(np.abs(full).max()))


def test_config_and_adapter():
    """gpt-oss's options; adapter_for picks the gpt-oss adapter before the
    Mixtral one; its init has zero sinks; the layers alternate window and
    global."""
    cfg = GptOssConfig.tiny(quant="mxfp4", qkv_bias=True)
    assert (cfg.sliding_window, cfg.swiglu_alpha, cfg.swiglu_limit) == (16, 1.702, 7.0)
    assert [tgpt.window_of(cfg, i) for i in range(4)] == [16, None, 16, None]
    ad = skt.adapter_for(cfg, "cpu")
    assert isinstance(ad, skt.GptOssAdapter) and ad._m is tgpt and ad.supports_extend
    assert not hasattr(ad._m, "mixed_step")
    lw = ad.init_weights(torch.Generator().manual_seed(0))["layers"]
    assert not lw["sinks"].any() and lw["sinks"].shape == (2, 4)
    assert lw["q"].dtype == torch.float32 and lw["moe_w1"]["packed"].dtype == torch.uint8
    with pytest.raises(NotImplementedError):
        skt.LlamaConfig.tiny(quant="mxfp4")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_against_jax(name):
    """Both default engines (prefix cache, packed admission, prefill_chunk=16;
    no mixed step, so chunks go by extend) on the tiny gpt-oss: wave A two
    fresh prompts (the 37-token one chunked), wave B one reusing 32 cached
    tokens of A's first prompt and a fresh 40-token prompt in chunks.
    Identical greedy tokens, hit tokens and page accounting.

    The bucket is the window (16): JAX's extend gives NaN logits once a
    padding row of the bucket sees no key of its window in either pass (its
    two -inf lses merge into NaN, ROADMAP queue 3), which a bucket of at most
    the window rules out; test_extend_wide_bucket holds the port there."""
    kw = CONFIGS[name]
    jcfg = jgpt.GptOssConfig.tiny(**kw)
    jparams = jax_params(name, jcfg)
    rng = np.random.default_rng(7)
    ekw = dict(max_batch=4, page_size=PAGE, num_pages=24, prefill_chunk=16, prefill_bucket=16)
    jeng = JEngine(jcfg, jparams, **ekw)
    teng = skt.Engine(GptOssConfig.tiny(**kw), params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
                      device="cpu", **ekw)
    assert type(jeng.adapter).__name__ == type(teng.adapter).__name__ == "GptOssAdapter"
    a = [rng.integers(1, jcfg.vocab_size, n).tolist() for n in (37, 11)]
    b = [a[0][:32] + rng.integers(1, jcfg.vocab_size, 6).tolist(), rng.integers(1, jcfg.vocab_size, 40).tolist()]
    for wave in (a, b):
        for eng in (jeng, teng):
            for p in wave:
                eng.add_request(p, max_new_tokens=4)
            eng.run_until_done()
    assert sorted(jeng.finished) == sorted(teng.finished) == list(range(4))
    for rid in jeng.finished:
        assert teng.finished[rid].output == jeng.finished[rid].output, rid
    jc, tc = jeng.metrics.counters, teng.metrics.counters
    for key in ("prefix_cache_hit_tokens", "tokens_prefilled", "tokens_decoded", "requests_finished"):
        assert tc.get(key) == jc.get(key), key
    assert tc["prefix_cache_hit_tokens"] == 32 and tc.get("nonfinite_logits", 0) == 0
