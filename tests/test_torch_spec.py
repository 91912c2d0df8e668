"""Speculative decoding in the port against the JAX package: the verify
programs (``prefill_extend(num_logits=...)`` of Llama, Mixtral and
DeepSeek, ``llama.prefill_tree``), the rounds of ``models/spec.py`` and the
engine with a draft.

Models are the tiny configurations with the JAX parameter tree carried
across by ``params_from_numpy``; inputs are seeded with numpy. The draft of
a Llama target is the target with every weight perturbed by 5 % noise, so
that rounds accept some drafts and reject others (both fix-ups run); the
Mixtral and DeepSeek targets take a random tiny Llama draft, as the JAX
package's tests do.

Tolerances: float32 on both sides, the same bytes in, sums in another
order: logits and pools within 2e-4 of their scale
(tests/test_torch_deepseek.py's float32 bound); over an int8 pool (kv_scale
1/16) a value on a rounding tie may take the neighbouring code, so logits
within 2e-2 and codes within one. Tokens, accepted counts and the engines'
spec counters are integers and must be equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.models import deepseek as jds
from sgl_kernel_tpu.models import llama as jllama
from sgl_kernel_tpu.models import mixtral as jmx
from sgl_kernel_tpu.models import spec as jspec
from sgl_kernel_tpu.ops.speculative import build_tree_kernel_efficient
from sgl_kernel_tpu.serving.engine import Engine as JaxEngine
from sgl_kernel_tpu_torch import DeepseekConfig, Engine, GptOssConfig, LlamaConfig, MixtralConfig, params_from_numpy
from sgl_kernel_tpu_torch.models import deepseek as tds
from sgl_kernel_tpu_torch.models import llama as tllama
from sgl_kernel_tpu_torch.models import mixtral as tmx
from sgl_kernel_tpu_torch.models import spec as tspec

torch.set_num_threads(1)

PAGE, PAGES = 16, 16
F32_TOL, INT8_TOL = 2e-4, 2e-2

# family -> (JAX module, port module, JAX config class, port config class)
FAMILIES = {"llama": (jllama, tllama, jllama.LlamaConfig, LlamaConfig),
            "mixtral": (jmx, tmx, jmx.MixtralConfig, MixtralConfig),
            "deepseek": (jds, tds, jds.DeepseekConfig, DeepseekConfig)}
W4 = dict(quant="w4a16", group_size=32)
CASES = {"llama-f32": ("llama", dict(fused=True)), "llama-w4a16": ("llama", dict(fused=True, **W4)),
         "llama-w4a16-int8kv": ("llama", dict(fused=True, kv_dtype="int8", kv_scale=1 / 16, **W4)),
         "mixtral-f32": ("mixtral", dict()), "mixtral-w4a16": ("mixtral", W4),
         "deepseek-f32": ("deepseek", dict()),
         "deepseek-w4a16-int8": ("deepseek", dict(kv_dtype="int8", kv_scale=1 / 16, **W4))}


def i32(a):
    return np.asarray(a, np.int32)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tiny_configs(family, **kw):
    jm, tm, jc, tc = FAMILIES[family]
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("kv_dtype") == "int8":
        jkw["kv_dtype"], tkw["kv_dtype"] = jnp.int8, torch.int8
    return jc.tiny(**jkw), tc.tiny(**tkw)


class Pair:
    """One family's JAX and port models side by side on one parameter tree,
    with their caches (a tuple: (k, v) or (latent,))."""

    def __init__(self, case, seed=3):
        self.family, kw = CASES[case]
        self.jm, self.tm = FAMILIES[self.family][:2]
        self.jcfg, self.tcfg = tiny_configs(self.family, **kw)
        self.jparams = self.jm.init_weights(self.jcfg, jax.random.PRNGKey(seed))
        self.tparams = params_from_numpy(to_numpy(self.jparams), "cpu")
        self.jrope, self.trope = self.jm.build_rope_cache(self.jcfg), self.tm.build_rope_cache(self.tcfg, "cpu")
        self.int8 = kw.get("kv_dtype") == "int8"
        self.tol = INT8_TOL if self.int8 else F32_TOL
        if self.family == "deepseek":
            self.jc = (self.jm.make_cache(self.jcfg, PAGES, PAGE),)
            self.tc = (self.tm.make_cache(self.tcfg, PAGES, PAGE, device="cpu"),)
        else:
            self.jc = tuple(self.jm.make_caches(self.jcfg, PAGES, PAGE))
            self.tc = tuple(self.tm.make_caches(self.tcfg, PAGES, PAGE, device="cpu"))

    def run(self, name, *arrays, **kw):
        fn_j, fn_t = getattr(self.jm, name), getattr(self.tm, name)
        jl, *jc = fn_j(self.jparams, self.jcfg, *self.jc, *(jnp.asarray(i32(a)) for a in arrays), self.jrope, **kw)
        tl, *tc = fn_t(self.tparams, self.tcfg, *self.tc, *(torch.from_numpy(i32(a)) for a in arrays), self.trope,
                       **kw)
        self.jc, self.tc = tuple(jc), tuple(tc)
        return np.asarray(jl), tl.numpy()

    def check(self, jl, tl):
        assert jl.shape == tl.shape and np.isfinite(tl).all()
        scale = max(1.0, float(np.abs(jl).max()))
        assert np.abs(tl - jl).max() <= self.tol * scale, (float(np.abs(tl - jl).max()), self.tol * scale)
        for jp, tp in zip(self.jc, self.tc):
            pj = np.asarray(jp.astype(jnp.float32))
            pt = tp.float().numpy()
            bound = 1.0 if self.int8 else self.tol * max(1.0, float(np.abs(pj).max()))
            assert np.abs(pt - pj).max() <= bound


def slots_of(pages, n, start=0):
    return [pages[p // PAGE] * PAGE + p % PAGE for p in range(start, start + n)]


def prefill_two(pair, lens=(11, 7), pages=((1, 2), (3, 4))):
    """A padded prefill of two prompts; returns the prompts' tokens."""
    rng = np.random.default_rng(0)
    v = pair.tcfg.vocab_size
    toks, pos, sl = np.zeros((2, 16)), np.zeros((2, 16)), np.full((2, 16), -1)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, v, n)
        pos[i, :n] = np.arange(n)
        sl[i, :n] = slots_of(pages[i], n)
    pair.check(*pair.run("prefill", toks, pos, i32(lens), sl))
    return toks


def table(pages):
    return np.array(list(pages) + [0] * (4 - len(pages)), np.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_extend_num_logits(case):
    """``prefill_extend(num_logits=5)`` over the two cached prompts: 5
    fresh tokens on the first (its last 5 positions), 3 on the second (q_len
    below n: the leading rows clip to row 0, as JAX's), in an 8-token
    bucket; logits [2, 5, V] and the pools against JAX's."""
    pair = Pair(case)
    prefill_two(pair)
    rng = np.random.default_rng(1)
    v = pair.tcfg.vocab_size
    q, pre, pages = (5, 3), (11, 7), ((1, 2), (3, 4))
    toks, pos, sl = np.zeros((2, 8)), np.zeros((2, 8)), np.full((2, 8), -1)
    for i in range(2):
        toks[i, :q[i]] = rng.integers(0, v, q[i])
        pos[i, :q[i]] = np.arange(pre[i], pre[i] + q[i])
        sl[i, :q[i]] = slots_of(pages[i], q[i], pre[i])
    jl, tl = pair.run("prefill_extend", toks, pos, i32(q), i32([pre[0] + q[0], pre[1] + q[1]]),
                      np.stack([table(p) for p in pages]), sl, prefix_max=PAGE, num_logits=5)
    assert tl.shape == (2, 5, v)
    pair.check(jl, tl)


@pytest.mark.parametrize("case", ["llama-f32", "llama-w4a16", "llama-w4a16-int8kv"])
def test_prefill_tree(case):
    """``llama.prefill_tree`` over a tree of dt = 7 nodes (gamma 3, top-2:
    a spine with one hedge leaf a level, build_tree_kernel_efficient's
    mask and positions) on each cached prompt, K/V at per-node slots:
    logits for every node and the pools against JAX's."""
    pair = Pair(case)
    prefill_two(pair)
    rng = np.random.default_rng(2)
    gamma, topk = 3, 2
    dt = 1 + gamma * topk
    lens, pages = np.array([12, 8], np.int32), ((1, 2), (3, 4))  # root at L-1, the prompts' last token
    lvl = np.repeat(np.arange(gamma), topk)
    parent = np.where(lvl == 0, -1, (lvl - 1) * topk).astype(np.int32)
    mask, positions, _, _, _ = build_tree_kernel_efficient(
        jnp.asarray(np.stack([parent] * 2)), jnp.asarray(np.stack([np.arange(gamma * topk)] * 2), jnp.int32),
        jnp.asarray(lens - 1), depth=gamma, draft_token_num=dt)
    toks = rng.integers(0, pair.tcfg.vocab_size, (2, dt))
    sl = np.stack([slots_of(pages[i], dt, int(lens[i]) - 1) for i in range(2)])
    tables = np.stack([table(p) for p in pages])
    jl, *jc = jllama.prefill_tree(
        pair.jparams, pair.jcfg, *pair.jc, jnp.asarray(toks, jnp.int32), positions, mask, jnp.asarray(lens - 1),
        jnp.asarray(tables), jnp.asarray(sl, jnp.int32), pair.jrope, prefix_max=PAGE)
    t = lambda a: torch.from_numpy(np.asarray(a))
    tl, *tc = tllama.prefill_tree(pair.tparams, pair.tcfg, *pair.tc, t(i32(toks)), t(positions), t(mask),
                                  t(lens - 1), t(tables), t(i32(sl)), pair.trope, prefix_max=PAGE)
    pair.jc, pair.tc = tuple(jc), tuple(tc)
    assert tl.shape == (2, dt, pair.tcfg.vocab_size)
    pair.check(np.asarray(jl), tl.numpy())


def noisy_copy(params, seed=11, scale=0.05):
    """The tree with every floating leaf perturbed by ``scale`` of its own
    spread (a draft that agrees with the target often, not always)."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.kind != "f":
            return a
        return (a + rng.standard_normal(a.shape).astype(a.dtype) * scale * (float(a.std()) or 1.0)).astype(a.dtype)
    return jax.tree_util.tree_map(leaf, to_numpy(params))


@pytest.fixture(scope="module")
def llama_pair():
    jcfg = jllama.LlamaConfig.tiny(fused=True)
    tcfg = LlamaConfig.tiny(fused=True)
    jp = jllama.init_weights(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, noisy_copy(jp)


def setup_caches(jm, tm, jcfg, tcfg, jparams, tparams, prompts, tables):
    """Both sides' pools after a padded prefill of ``prompts`` into
    ``tables``; returns (jc, tc, the first tokens)."""
    b, s = len(prompts), 32
    jk, jv = jm.make_caches(jcfg, 32, PAGE)
    tk, tv = tm.make_caches(tcfg, 32, PAGE, device="cpu")
    toks, pos, sl = np.zeros((b, s), np.int32), np.zeros((b, s), np.int32), np.full((b, s), -1, np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
        pos[i, :len(p)] = np.arange(len(p))
        sl[i, :len(p)] = [tables[i][q // PAGE] * PAGE + q % PAGE for q in range(len(p))]
    ql = i32([len(p) for p in prompts])
    jl, jk, jv = jm.prefill(jparams, jcfg, jk, jv, *map(jnp.asarray, (toks, pos, ql, sl)), jm.build_rope_cache(jcfg))
    _, tk, tv = tm.prefill(tparams, tcfg, tk, tv, *map(torch.from_numpy, (toks, pos, ql, sl)),
                           tm.build_rope_cache(tcfg, "cpu"))
    return (jk, jv), (tk, tv), np.asarray(jl).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("mode", ["chain", "tree", "chain-self"])
def test_spec_rounds_match_jax(llama_pair, mode):
    """Rounds of ``spec_decode_round`` (gamma 3) or ``spec_tree_round``
    (gamma 3, top-2) from the same state on both sides, six rounds, three
    rows (the last a padding row, ``valid`` False): each round's new_tokens
    and n_new equal JAX's, and the four pools stay within 2e-4 of JAX's;
    the noisy draft accepts some drafts and rejects others, and with draft
    = target (chain-self) rounds accept up to gamma."""
    jcfg, tcfg, jp, jd = llama_pair
    if mode == "chain-self":
        jd = to_numpy(jp)
    tp, td = params_from_numpy(to_numpy(jp), "cpu"), params_from_numpy(jd, "cpu")
    jd = jax.tree_util.tree_map(jnp.asarray, jd)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).tolist() for n in (9, 14, 1)]
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 0], [0, 0, 0, 0]], np.int32)
    (jk, jv), (tk, tv), first = setup_caches(jllama, tllama, jcfg, tcfg, jp, tp, prompts, tables)
    (jdk, jdv), (tdk, tdv), _ = setup_caches(jllama, tllama, jcfg, tcfg, jd, td, prompts, tables)
    jrope, trope = jllama.build_rope_cache(jcfg), tllama.build_rope_cache(tcfg, "cpu")
    last, lens = first.copy(), i32([len(p) + 1 for p in prompts])
    valid = np.array([True, True, False])
    lens[2], last[2] = 1, 0
    accepted = 0
    for _ in range(6):
        args_j = (jnp.asarray(last), jnp.asarray(lens), jnp.asarray(tables), jrope, jrope, jnp.asarray(valid))
        args_t = (torch.from_numpy(last), torch.from_numpy(lens), torch.from_numpy(tables), trope, trope,
                  torch.from_numpy(valid))
        if mode == "tree":
            kw = dict(cfg_t=jcfg, cfg_d=jcfg, gamma=3, topk=2, prefix_max=48)
            jn, jnn, jk, jv, jdk, jdv = jspec.spec_tree_round(jp, jd, jk, jv, jdk, jdv, *args_j, **kw)
            tn, tnn, tk, tv, tdk, tdv = tspec.spec_tree_round(tp, td, tk, tv, tdk, tdv, *args_t,
                                                              **{**kw, "cfg_t": tcfg, "cfg_d": tcfg})
        else:
            kw = dict(cfg_t=jcfg, cfg_d=jcfg, gamma=3, prefix_max=48)
            jn, jnn, (jk, jv), jdk, jdv = jspec.spec_decode_round(jp, jd, (jk, jv), jdk, jdv, *args_j, **kw)
            tn, tnn, (tk, tv), tdk, tdv = tspec.spec_decode_round(tp, td, (tk, tv), tdk, tdv, *args_t,
                                                                  **{**kw, "cfg_t": tcfg, "cfg_d": tcfg})
        jn, jnn = np.asarray(jn), np.asarray(jnn)
        np.testing.assert_array_equal(jn[:2], tn.numpy()[:2])
        np.testing.assert_array_equal(jnn[:2], tnn.numpy()[:2])
        accepted += int(jnn[:2].sum()) - 2
        for i in range(2):
            last[i] = jn[i, jnn[i] - 1]
            lens[i] += jnn[i]
    for a, b in ((jk, tk), (jv, tv), (jdk, tdk), (jdv, tdv)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=F32_TOL * max(1.0, float(np.abs(a).max())))
    assert 0 < accepted < 6 * 2 * 3 or mode == "chain-self"
    if mode == "chain-self":  # below 3 a round: a full acceptance leaves the draft a row it never wrote
        assert accepted >= 6 * 2


def run_engine(eng, prompts, max_new):
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    fin = eng.run_until_done()
    return [fin[r].output for r in rids]


def engine_pair(family, draft, kw, **cfg_kw):
    """The JAX and the port engines on one target tree and one draft tree,
    and a plain port engine on the target for the greedy reference."""
    jm = FAMILIES[family][0]
    jcfg, tcfg = tiny_configs(family, **cfg_kw)
    jp = jm.init_weights(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(to_numpy(jp), "cpu")
    jdcfg = dataclasses.replace(jllama.LlamaConfig.tiny(fused=True), vocab_size=jcfg.vocab_size,
                                max_position=jcfg.max_position)
    tdcfg = dataclasses.replace(LlamaConfig.tiny(fused=True), vocab_size=tcfg.vocab_size,
                                max_position=tcfg.max_position)
    if draft == "self":
        jdcfg, tdcfg, jd = jcfg, tcfg, to_numpy(jp)
    elif draft == "noisy":
        jd = noisy_copy(jp)
        jdcfg, tdcfg = jcfg, tcfg
    else:
        jd = to_numpy(jllama.init_weights(jdcfg, jax.random.PRNGKey(5)))
    td = params_from_numpy(jd, "cpu")
    jeng = JaxEngine(jcfg, jp, draft_cfg=jdcfg, draft_params=jax.tree_util.tree_map(jnp.asarray, jd), **kw)
    teng = Engine(tcfg, tp, draft_cfg=tdcfg, draft_params=td, device="cpu", **kw)
    plain_kw = {k: v for k, v in kw.items() if not k.startswith("spec_")}
    plain = Engine(tcfg, tp, device="cpu", **plain_kw)
    return jeng, teng, plain


SPEC_ENGINES = {
    # (family, draft, spec_gamma, spec_topk, engine options)
    "llama-chain": ("llama", "noisy", 3, 1, dict()),
    "llama-tree": ("llama", "noisy", 3, 2, dict()),
    "llama-self-cache": ("llama", "self", 4, 1, dict(max_batch=3, num_pages=48)),
    "mixtral-chain": ("mixtral", "random", 3, 1, dict()),
    "deepseek-chain": ("deepseek", "random", 3, 1, dict()),
}


@pytest.mark.parametrize("name", list(SPEC_ENGINES))
def test_spec_engine_matches_jax(name):
    """Engine(draft_cfg=...) against the JAX engine on the same weights,
    prefix cache on: two waves (the second's prompts share the first's
    first page, so admission extends over cached pages; ``llama-self-cache``
    runs six requests on three rows, so admission also waits for
    retirements), with a prompt chunked by ``prefill_chunk`` in the
    ``llama-chain`` case. The tokens equal JAX's and the plain greedy
    engine's, and ``spec_proposed`` / ``spec_accepted`` equal JAX's."""
    family, draft, gamma, topk, extra = SPEC_ENGINES[name]
    kw = {**dict(max_batch=4, num_pages=64, page_size=PAGE, prefill_bucket=16, spec_gamma=gamma, spec_topk=topk),
          **extra}
    if name == "llama-chain":
        kw["prefill_chunk"] = 16
    jeng, teng, plain = engine_pair(family, draft, kw)
    v = teng.cfg.vocab_size
    rng = np.random.default_rng(8)
    base = [rng.integers(1, v, n).tolist() for n in (20, 33, 9)]
    waves = [base, [base[0][:16] + rng.integers(1, v, 5).tolist(), base[1][:16] + rng.integers(1, v, 12).tolist()]]
    if name == "llama-self-cache":
        waves = [base + [base[i % 3][:16 + 4 * i] + rng.integers(1, v, 2).tolist() for i in range(3)]]
    for wave in waves:
        max_new = [6 + 3 * (i % 3) for i in range(len(wave))]
        want = run_engine(plain, wave, max_new)
        got_j = run_engine(jeng, wave, max_new)
        got_t = run_engine(teng, wave, max_new)
        assert got_t == got_j
        assert got_t == want
    for key in ("spec_proposed", "spec_accepted", "prefix_cache_hit_tokens"):
        assert teng.metrics.counters.get(key, 0) == jeng.metrics.counters.get(key, 0), key
    assert teng.metrics.counters["spec_proposed"] > 0 and not teng.metrics.counters.get("nonfinite_logits", 0)
    assert teng.metrics.counters.get("prefix_cache_hit_tokens", 0) > 0
    if draft != "random":
        assert teng.metrics.counters["spec_accepted"] > 0


def test_spec_engine_refusals():
    """A draft in front of a target without a verify program raises
    ValueError: gpt-oss (JAX's extend has no num_logits), DeepSeek with NSA
    decode or with KV compression; and a tree on a target without
    prefill_tree (Mixtral). The spec slack is reserved at admission."""
    dcfg = LlamaConfig.tiny()
    kw = dict(device="cpu", num_pages=32, page_size=16, enable_prefix_cache=False)
    for cfg in (GptOssConfig.tiny(quant="mxfp4", qkv_bias=True), DeepseekConfig.tiny(nsa=True, idx_dim=32),
                DeepseekConfig.tiny(compress="c4", compress_ring=8, compress_local=16)):
        with pytest.raises(ValueError, match="speculative"):
            Engine(cfg, draft_cfg=dataclasses.replace(dcfg, vocab_size=cfg.vocab_size), **kw)
    with pytest.raises(ValueError, match="prefill_tree"):
        Engine(MixtralConfig.tiny(), draft_cfg=dcfg, spec_topk=2, **kw)
    eng = Engine(LlamaConfig.tiny(), draft_cfg=dcfg, spec_gamma=4, spec_topk=2, **kw)
    eng.add_request(list(range(1, 9)), max_new_tokens=8)  # 8 + 8 + 8 slack rows: 2 pages
    eng._admit()
    assert len(eng.running[0].pages) == 2
