"""The engine end to end: the JAX Engine and the port's Engine(device="cpu")
serve the same greedy workload on the same weights and must emit identical
tokens for every request.

The plain path: six requests with prompts of 3 to 40 tokens on a max_batch
of 4, so the last two are admitted only after earlier ones retire. Both
sides get an adapter without packed prefill or extend, so both take one
padded prefill per prompt with the prefix cache off.

The default path (prefix cache, packed admission, extend on a cache hit,
chunked prefill fused with decode): three waves through both default
engines, and the cache accounting compared as well as the tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.models import llama as jllama
from sgl_kernel_tpu.serving.adapters import LlamaAdapter as JaxLlamaAdapter
from sgl_kernel_tpu.serving.engine import Engine as JaxEngine
from sgl_kernel_tpu_torch import Engine, LlamaConfig, launch_counts, params_from_numpy
from sgl_kernel_tpu_torch.serving.adapters import LlamaAdapter

torch.set_num_threads(1)


class PlainPrefillAdapter(JaxLlamaAdapter):
    prefill_packed = None
    supports_extend = False


class TorchPlainPrefillAdapter(LlamaAdapter):
    prefill_packed = None
    supports_extend = False


def test_engine_greedy_outputs_identical():
    jcfg = jllama.LlamaConfig.tiny(fused=True)
    jparams = jllama.init_weights(jcfg, jax.random.PRNGKey(11))
    rng = np.random.default_rng(5)
    lens = [3, 40, 17, 9, 28, 5]
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist() for n in lens]
    kw = dict(max_batch=4, page_size=16, num_pages=64)

    jeng = JaxEngine(jcfg, jparams, adapter=PlainPrefillAdapter(jcfg), **kw)
    tcfg = LlamaConfig.tiny(fused=True)
    teng = Engine(tcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
                  device="cpu", adapter=TorchPlainPrefillAdapter(tcfg, "cpu"), **kw)
    for p in prompts:
        jeng.add_request(p, max_new_tokens=8)
        teng.add_request(p, max_new_tokens=8)
    jfin = jeng.run_until_done()
    teng.step()
    assert len(teng.running) == 4 and len(teng.waiting) == 2  # batch full
    tfin = teng.run_until_done()

    assert sorted(jfin) == sorted(tfin) == list(range(len(prompts)))
    for rid in jfin:
        assert len(tfin[rid].output) == 8
        assert tfin[rid].output == jfin[rid].output, rid
    # every page came back
    assert teng.metrics.counters["requests_finished"] == len(prompts)
    assert len(teng.allocator.free) == 63
    assert teng.metrics.counters.get("nonfinite_logits", 0) == 0
    # on the CPU every wrapper takes its plain twin: no kernel launched
    assert all(n == 0 for n in launch_counts().values())


@pytest.mark.parametrize("kv", [None, "int8"])
def test_engine_w4a16_greedy_outputs_identical(kv):
    """The W4A16 model, with bf16-model-dtype pools or int8 pools at
    kv_scale 1/16 (bench.py's setting), served by both engines unchanged:
    the adapter builds the pools from the config."""
    kw_cfg = dict(quant="w4a16", group_size=32, fused=True)
    jkw, tkw = dict(kw_cfg), dict(kw_cfg)
    if kv:
        jkw.update(kv_dtype=jnp.int8, kv_scale=1 / 16)
        tkw.update(kv_dtype=torch.int8, kv_scale=1 / 16)
    jcfg = jllama.LlamaConfig.tiny(**jkw)
    jparams = jllama.init_weights(jcfg, jax.random.PRNGKey(13))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist() for n in (4, 33, 12)]
    kw = dict(max_batch=2, page_size=16, num_pages=32)
    jeng = JaxEngine(jcfg, jparams, adapter=PlainPrefillAdapter(jcfg), **kw)
    tcfg = LlamaConfig.tiny(**tkw)
    teng = Engine(tcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
                  device="cpu", adapter=TorchPlainPrefillAdapter(tcfg, "cpu"), **kw)
    assert teng.caches[0].dtype == (torch.int8 if kv else torch.float32)
    for p in prompts:
        jeng.add_request(p, max_new_tokens=6)
        teng.add_request(p, max_new_tokens=6)
    jfin, tfin = jeng.run_until_done(), teng.run_until_done()
    assert sorted(jfin) == sorted(tfin)
    for rid in jfin:
        assert tfin[rid].output == jfin[rid].output, rid


def test_default_engine_w4a16_dma_matches_jax():
    """The W4A16 model with gemm_impl="dma" (K10 for every GEMM of M <= 32
    rows, after a standalone rmsnorm; K1 above) through both default
    engines: prefix cache, packed admission, an extend on a hit and a
    chunked prompt in mixed steps. LlamaAdapter and Engine take the config
    unchanged; tokens and cache accounting must be identical."""
    kw_cfg = dict(quant="w4a16", group_size=32, fused=True, gemm_impl="dma")
    jcfg = jllama.LlamaConfig.tiny(**kw_cfg)
    jparams = jllama.init_weights(jcfg, jax.random.PRNGKey(17))
    rng = np.random.default_rng(8)
    kw = dict(max_batch=4, page_size=16, num_pages=64, prefill_chunk=32)
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = Engine(LlamaConfig.tiny(**kw_cfg), params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
                  device="cpu", **kw)
    a = [rng.integers(1, jcfg.vocab_size, n).tolist() for n in (20, 40, 9)]
    b = [a[1][:32] + rng.integers(1, jcfg.vocab_size, 10).tolist(), rng.integers(1, jcfg.vocab_size, 70).tolist()]
    for wave in (a, b):
        for eng in (jeng, teng):
            for p in wave:
                eng.add_request(p, max_new_tokens=6)
            eng.run_until_done()
    assert sorted(jeng.finished) == sorted(teng.finished) == list(range(5))
    for rid in jeng.finished:
        assert teng.finished[rid].output == jeng.finished[rid].output, rid
    jc, tc = jeng.metrics.counters, teng.metrics.counters
    for key in ("prefix_cache_hit_tokens", "mixed_steps", "tokens_prefilled", "tokens_decoded"):
        assert tc.get(key) == jc.get(key), key
    assert tc["prefix_cache_hit_tokens"] == 32 and tc["mixed_steps"] >= 1


@pytest.mark.parametrize("num_pages", [64, 10])
def test_default_engine_matches_jax(num_pages):
    """Both default engines (prefix cache on, packed admission, mixed steps)
    with prefill_chunk=32 on tiny: wave A is three fresh prompts (two packed
    into one launch, the 40-token one chunked); wave B reuses 32 and 16
    cached tokens of wave A's prompts (extend prefill) beside a fresh
    100-token prompt chunked in 32s, whose later chunks ride mixed steps
    beside wave B's decodes. With 10 pages admission blocks and evicts
    cached pages. Tokens, hit tokens, mixed steps, evictions and page
    accounting must be identical."""
    jcfg = jllama.LlamaConfig.tiny(fused=True)
    jparams = jllama.init_weights(jcfg, jax.random.PRNGKey(11))
    rng = np.random.default_rng(5)
    kw = dict(max_batch=4, page_size=16, num_pages=num_pages, prefill_chunk=32)
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = Engine(LlamaConfig.tiny(fused=True), params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
                  device="cpu", **kw)
    assert teng.native is not None and jeng.native is not None
    a = [rng.integers(1, jcfg.vocab_size, n).tolist() for n in (20, 40, 9)]
    b = [a[1][:32] + rng.integers(1, jcfg.vocab_size, 10).tolist(),
         a[0][:16] + rng.integers(1, jcfg.vocab_size, 5).tolist(),
         rng.integers(1, jcfg.vocab_size, 100).tolist()]
    for wave in (a, b):
        for eng in (jeng, teng):
            for p in wave:
                eng.add_request(p, max_new_tokens=6)
            eng.run_until_done()
    assert sorted(jeng.finished) == sorted(teng.finished) == list(range(6))
    for rid in jeng.finished:
        assert teng.finished[rid].output == jeng.finished[rid].output, rid
    jc, tc = jeng.metrics.counters, teng.metrics.counters
    for key in ("prefix_cache_hit_tokens", "mixed_steps", "tokens_prefilled", "tokens_decoded", "requests_finished",
                "pages_evicted", "admission_blocked"):
        assert tc.get(key) == jc.get(key), key
    assert (tc.get("pages_evicted", 0) > 0) == (num_pages == 10)
    assert tc["prefix_cache_hit_tokens"] == 48 and tc["mixed_steps"] >= 1
    assert teng.allocator.free == jeng.allocator.free
    assert teng.native.cached_pages == jeng.native.cached_pages
    # every page is free or cached: retire released exactly what the cache
    # did not adopt
    assert teng.allocator.free + teng.native.cached_pages == num_pages - 1
    assert tc.get("nonfinite_logits", 0) == 0


def deepseek_pair(**kw):
    from sgl_kernel_tpu.models import deepseek as jds
    from sgl_kernel_tpu_torch import DeepseekConfig

    jcfg = jds.DeepseekConfig.tiny(**kw)
    jparams = jds.init_weights(jcfg, jax.random.PRNGKey(3))
    return jcfg, jparams, DeepseekConfig.tiny(**kw), params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                                                       "cpu")


def test_deepseek_engine_matches_direct_stepping():
    """The DeepSeek engine's plain path (no prefix cache, one padded
    prefill a prompt) against stepping the port's model by hand: one
    prefill, then decode_step a token (tests/test_engine_deepseek.py)."""
    from sgl_kernel_tpu_torch.models import deepseek as tds

    _, _, cfg, params = deepseek_pair()
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, 9).tolist()
    page, n_new = 16, 6
    rope = tds.build_rope_cache(cfg, "cpu")
    kv = tds.make_cache(cfg, 16, page, device="cpu")
    s = len(prompt)
    tok, pos, sl = np.zeros((1, 16), np.int32), np.zeros((1, 16), np.int32), np.full((1, 16), -1, np.int32)
    tok[0, :s], pos[0, :s], sl[0, :s] = prompt, np.arange(s), page + np.arange(s)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    logits, kv = tds.prefill(params, cfg, kv, t(tok), t(pos), t([s]), t(sl), rope)
    ref = [int(logits[0].argmax())]
    table = t(np.arange(1, 1 + (s + n_new + page) // page)[None])
    for i in range(n_new - 1):
        n = s + i
        logits, kv = tds.decode_step(params, cfg, kv, t([ref[-1]]), t([n]), table, t([n + 1]), t([page + n]), rope)
        ref.append(int(logits[0].argmax()))
    eng = Engine(cfg, params, device="cpu", num_pages=16, page_size=page, enable_prefix_cache=False)
    rid = eng.add_request(prompt, max_new_tokens=n_new)
    assert eng.run_until_done()[rid].output == ref


def test_deepseek_default_engine_matches_jax():
    """Both default DeepSeek engines (prefix cache, packed admission,
    prefill_chunk=32; the model has no mixed step, so chunks go by extend)
    on the tiny W4A16 model: wave A is three fresh prompts (two packed, the
    40-token one chunked), wave B reuses cached pages of A's prompts beside
    a fresh 70-token prompt in chunks. Tokens, hit tokens and page
    accounting must be identical, with no mixed step."""
    jcfg, jparams, cfg, params = deepseek_pair(quant="w4a16", group_size=32)
    rng = np.random.default_rng(10)
    kw = dict(max_batch=4, page_size=16, num_pages=48, prefill_chunk=32)
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = Engine(cfg, params, device="cpu", **kw)
    assert teng.native is not None and type(teng.adapter).__name__ == "DeepseekAdapter"
    a = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (20, 40, 9)]
    b = [a[1][:32] + rng.integers(1, cfg.vocab_size, 10).tolist(),
         a[0][:16] + rng.integers(1, cfg.vocab_size, 5).tolist(),
         rng.integers(1, cfg.vocab_size, 70).tolist()]
    for wave in (a, b):
        for eng in (jeng, teng):
            for p in wave:
                eng.add_request(p, max_new_tokens=5)
            eng.run_until_done()
    assert sorted(jeng.finished) == sorted(teng.finished) == list(range(6))
    for rid in jeng.finished:
        assert teng.finished[rid].output == jeng.finished[rid].output, rid
    jc, tc = jeng.metrics.counters, teng.metrics.counters
    for key in ("prefix_cache_hit_tokens", "tokens_prefilled", "tokens_decoded", "requests_finished"):
        assert tc.get(key) == jc.get(key), key
    assert tc["prefix_cache_hit_tokens"] == 48 and tc.get("mixed_steps", 0) == 0
    assert teng.allocator.free + teng.native.cached_pages == 47
    assert tc.get("nonfinite_logits", 0) == 0


def test_deepseek_nsa_engine_matches_jax():
    """Both default engines on the tiny NSA model (float32, indexer 2 heads
    of 32, top-k 8, so every prompt past 8 tokens decodes over a sparse
    selection; cache tuple (latent, idx_k, idx_s)): the waves of the test
    above. Identical greedy tokens, hit tokens and page accounting."""
    jcfg, jparams, cfg, params = deepseek_pair(nsa=True, idx_dim=32, idx_heads=2, index_topk=8)
    rng = np.random.default_rng(13)
    kw = dict(max_batch=4, page_size=16, num_pages=48, prefill_chunk=32)
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = Engine(cfg, params, device="cpu", **kw)
    assert teng.adapter.use_nsa and len(teng.caches) == 3 and teng.caches[1].dtype == torch.float8_e4m3fn
    a = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (20, 40, 9)]
    b = [a[1][:32] + rng.integers(1, cfg.vocab_size, 10).tolist(),
         a[0][:16] + rng.integers(1, cfg.vocab_size, 5).tolist(),
         rng.integers(1, cfg.vocab_size, 70).tolist()]
    for wave in (a, b):
        for eng in (jeng, teng):
            for p in wave:
                eng.add_request(p, max_new_tokens=5)
            eng.run_until_done()
    assert sorted(jeng.finished) == sorted(teng.finished) == list(range(6))
    for rid in jeng.finished:
        assert teng.finished[rid].output == jeng.finished[rid].output, rid
    jc, tc = jeng.metrics.counters, teng.metrics.counters
    for key in ("prefix_cache_hit_tokens", "tokens_prefilled", "tokens_decoded", "requests_finished"):
        assert tc.get(key) == jc.get(key), key
    assert tc["prefix_cache_hit_tokens"] == 48 and tc.get("mixed_steps", 0) == 0
    assert teng.allocator.free + teng.native.cached_pages == 47
    assert tc.get("nonfinite_logits", 0) == 0


def test_mixtral_default_engine_matches_jax():
    """Both default engines on the tiny Mixtral (float32; prefix cache,
    packed admission, prefill_chunk=32; the model has no mixed step, so
    chunks go by extend): wave A three fresh prompts (two packed, the
    40-token one chunked), wave B reusing 32 and 16 cached tokens of A's
    prompts beside a fresh 70-token prompt in chunks. Identical greedy
    tokens, hit tokens and page accounting, no mixed step."""
    from sgl_kernel_tpu.models import mixtral as jmix
    from sgl_kernel_tpu_torch import MixtralConfig

    jcfg = jmix.MixtralConfig.tiny()
    jparams = jmix.init_weights(jcfg, jax.random.PRNGKey(17))
    rng = np.random.default_rng(12)
    kw = dict(max_batch=4, page_size=16, num_pages=48, prefill_chunk=32)
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = Engine(MixtralConfig.tiny(), params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
                  device="cpu", **kw)
    assert teng.native is not None and type(teng.adapter).__name__ == "MixtralAdapter"
    a = [rng.integers(1, jcfg.vocab_size, n).tolist() for n in (20, 40, 9)]
    b = [a[1][:32] + rng.integers(1, jcfg.vocab_size, 10).tolist(),
         a[0][:16] + rng.integers(1, jcfg.vocab_size, 5).tolist(),
         rng.integers(1, jcfg.vocab_size, 70).tolist()]
    for wave in (a, b):
        for eng in (jeng, teng):
            for p in wave:
                eng.add_request(p, max_new_tokens=5)
            eng.run_until_done()
    assert sorted(jeng.finished) == sorted(teng.finished) == list(range(6))
    for rid in jeng.finished:
        assert teng.finished[rid].output == jeng.finished[rid].output, rid
    jc, tc = jeng.metrics.counters, teng.metrics.counters
    for key in ("prefix_cache_hit_tokens", "tokens_prefilled", "tokens_decoded", "requests_finished"):
        assert tc.get(key) == jc.get(key), key
    assert tc["prefix_cache_hit_tokens"] == 48 and tc.get("mixed_steps", 0) == 0 == jc.get("mixed_steps", 0)
    assert teng.allocator.free + teng.native.cached_pages == 47
    assert tc.get("nonfinite_logits", 0) == 0


def burst_family(family):
    """(JAX config, JAX params, port config, port params) of a tiny model:
    the port's weights carried across from JAX's by ``params_from_numpy``."""
    if family == "deepseek":
        return deepseek_pair()
    if family == "mixtral":
        from sgl_kernel_tpu.models import mixtral as jmix
        from sgl_kernel_tpu_torch import MixtralConfig

        jcfg, tcfg = jmix.MixtralConfig.tiny(), MixtralConfig.tiny()
        jparams = jmix.init_weights(jcfg, jax.random.PRNGKey(17))
    else:
        jcfg, tcfg = jllama.LlamaConfig.tiny(), LlamaConfig.tiny()
        jparams = jllama.init_weights(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("family", ["llama", "deepseek", "mixtral"])
def test_decode_burst_matches_steps_and_jax(family):
    """decode_burst=4 against decode_burst=1 and the JAX engine's
    decode_burst=4 (tests/test_engine_stress.py:105-140): two greedy
    requests of 12 tokens, so bursts of 4, 4 and 3 after the prefill's
    token; then with request 0's sixth token as a stop token, hit in the
    middle of a burst (the tokens past it discarded). Greedy tokens must be
    identical: the port's burst feeds the argmax back on the device exactly
    as its single steps pick it."""
    jcfg, jparams, cfg, params = burst_family(family)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (9, 17)]
    kw = dict(num_pages=64, page_size=16, prefill_bucket=16, enable_prefix_cache=False, max_batch=4)

    def run(make, burst, stop=()):
        eng = make(burst)
        rids = [eng.add_request(p, max_new_tokens=12, stop_tokens=stop) for p in prompts]
        eng.run_until_done()
        return [eng.finished[r].output for r in rids], eng.metrics.counters

    port = lambda burst: Engine(cfg, params, device="cpu", decode_burst=burst, **kw)
    jax_eng = lambda burst: JaxEngine(jcfg, jparams, decode_burst=burst, **kw)
    base, counters = run(port, 1)
    burst, burst_counters = run(port, 4)
    assert burst == base == run(jax_eng, 4)[0]
    assert all(len(out) == 12 for out in base)
    assert burst_counters["tokens_decoded"] == counters["tokens_decoded"] == 22
    stop = base[0][5]
    stopped = run(port, 1, (stop,))[0]
    assert stopped[0][-1] == stop and len(stopped[0]) == base[0].index(stop) + 1 < 12
    assert run(port, 4, (stop,))[0] == stopped == run(jax_eng, 4, (stop,))[0]


def test_decode_burst_turns_mixed_steps_off():
    """The default Llama engine with prefill_chunk=32: a 100-token prompt's
    later chunks ride mixed steps beside the running decodes at
    decode_burst=1; under decode_burst=4 no mixed step runs (JAX
    engine.py:716) and the chunks go by extend, and the greedy tokens equal
    the JAX engine's at decode_burst=4."""
    jcfg = jllama.LlamaConfig.tiny(fused=True)
    jparams = jllama.init_weights(jcfg, jax.random.PRNGKey(11))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist() for n in (20, 9, 100)]
    kw = dict(max_batch=4, page_size=16, num_pages=64, prefill_chunk=32)
    engines = {"port 1": Engine(LlamaConfig.tiny(fused=True), params, device="cpu", **kw),
               "port 4": Engine(LlamaConfig.tiny(fused=True), params, device="cpu", decode_burst=4, **kw),
               "jax 4": JaxEngine(jcfg, jparams, decode_burst=4, **kw)}
    for eng in engines.values():
        for p in prompts[:2]:
            eng.add_request(p, max_new_tokens=10)
        eng.step()  # the two short prompts decode while the long one is chunked
        eng.add_request(prompts[2], max_new_tokens=10)
        eng.run_until_done()
    out = {k: [e.finished[r].output for r in range(3)] for k, e in engines.items()}
    assert out["port 4"] == out["jax 4"]
    mixed = {k: e.metrics.counters.get("mixed_steps", 0) for k, e in engines.items()}
    assert mixed["port 1"] >= 1 and mixed["port 4"] == 0 == mixed["jax 4"]
    assert engines["port 4"].metrics.counters["tokens_decoded"] == engines["jax 4"].metrics.counters["tokens_decoded"]


def counting(fn, kernel, route=None):
    """``fn`` counting a launch on ``kernel`` (and its ``route``) each call, as
    its wrapper does on the card."""
    def call(*args, **kw):
        kernel.launches += 1
        if route is not None:
            kernel.launches_by_route[route] += 1
        return fn(*args, **kw)
    return call


def test_decode_graph_cpu_runner_and_tally(monkeypatch):
    """The engine's decode program on the CPU: the static-buffer runner
    (DecodeInputs filled by one copy, DecodeGraph run eagerly) gives the
    logits of a direct adapter.decode on the same arrays, bit for bit (the
    same computation on the same values). With the wrappers of the W4A16
    decode (K1, K3, K5, K6) counting as they do on the card, the tally the
    runner records at its first call (where the card captures) equals the
    counters' movement over the direct call, under the names launch_counts()
    and route_launch_counts() use, and applying it (what a replay does)
    moves each counter by that much."""
    import sgl_kernel_tpu_torch as skt
    from sgl_kernel_tpu_torch.models import llama as tllama
    cfg = LlamaConfig.tiny(quant="w4a16", group_size=32, fused=True)
    eng = Engine(cfg, device="cpu", max_batch=4, page_size=16, num_pages=32, enable_prefix_cache=False)
    rng = np.random.default_rng(3)
    for n in (5, 23, 11):
        eng.add_request(rng.integers(1, cfg.vocab_size, n).tolist(), max_new_tokens=8)
    eng.step()
    eng.step()
    reqs = [r for r in eng.running if not r.done]
    assert len(reqs) == 3
    for name, route in (("w4a16_gemm", "decode"), ("rope_decode_fused_qkv", None),
                        ("paged_attention_decode_dma", None), ("store_cache_all_layers", None)):
        monkeypatch.setattr(tllama, name, counting(getattr(tllama, name), skt.KERNELS[name], route))
    skt.reset_launch_counts()
    tokens, positions, lengths, slot_loc, tables, _ = eng._decode_inputs(reqs, 0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    ref, _ = eng.adapter.decode(eng.params, eng.caches, t(tokens), t(positions), t(tables), t(lengths), t(slot_loc))
    direct = {**skt.launch_counts(), **skt.route_launch_counts()}
    direct = {k: n for k, n in direct.items() if n}
    # qkv, o, gate_up and down a layer, and the lm_head
    assert direct["w4a16_gemm"] == direct["w4a16_gemm_decode"] == 1 + 4 * cfg.num_layers
    assert direct["store_cache_all_layers"] == 1
    eng._graphs.clear()  # a new runner: its first call records the tally, as a capture does on the card
    logits = eng._run_decode(reqs, 1, 0)
    tally = eng._graphs[1].tally
    assert torch.equal(logits, ref)
    for got, want in zip(eng._inputs.args(), (tokens, positions, tables, lengths, slot_loc)):
        assert np.array_equal(got.numpy(), want)
    assert tally.counts() == direct
    skt.reset_launch_counts()
    tally.apply()
    tally.apply()
    now = {**skt.launch_counts(), **skt.route_launch_counts()}
    assert {k: n for k, n in now.items() if n} == {k: 2 * n for k, n in direct.items()}
    skt.reset_launch_counts()


def test_batched_sampling_keep_sets():
    """One step's sampled rows go through one sample_tokens call with
    per-row filters, the greedy rows through one argmax. Over 300 steps each
    sampled row's token lies in its own keep set, the single-row filter's
    nonzero probs at its temperature (membership is exact: no tolerance), a
    top_k=1 row always equals its argmax, a greedy row is its argmax, and
    the rows with a wider keep set draw more than one token."""
    from sgl_kernel_tpu_torch.ops import sampling
    from sgl_kernel_tpu_torch.serving.engine import Request

    eng = Engine(LlamaConfig.tiny(), device="cpu", max_batch=8, page_size=16, num_pages=16, enable_prefix_cache=False)
    logits = torch.from_numpy(np.random.default_rng(7).normal(size=(6, 64)) * 2.0).float()
    specs = [dict(), dict(temperature=0.8, top_k=5), dict(temperature=1.0, top_p=0.5),
             dict(temperature=0.7, min_p=0.2), dict(temperature=1.0, top_k=1), dict(temperature=1.3)]
    keep = []
    for row, spec in zip(logits, specs):
        probs = torch.softmax(row[None] / spec.get("temperature", 1.0), -1)
        if "top_k" in spec:
            probs = sampling.top_k_renorm_probs(probs, spec["top_k"])
        if "top_p" in spec:
            probs = sampling.top_p_renorm_probs(probs, spec["top_p"])
        if "min_p" in spec:
            probs = sampling.min_p_filter_probs(probs, spec["min_p"])
        keep.append(set(torch.nonzero(probs[0] > 0).flatten().tolist()))
    assert len(keep[1]) == 5 and 1 < len(keep[2]) < 64 and 1 < len(keep[3]) < 64 and len(keep[5]) == 64
    drawn = [set() for _ in specs]
    argmax = logits.argmax(-1).tolist()
    for _ in range(300):
        reqs = [Request(i, [1], max_new_tokens=10 ** 6, **spec) for i, spec in enumerate(specs)]
        eng._append_tokens(reqs, logits)
        for i, r in enumerate(reqs):
            drawn[i].add(r.output[0])
    assert drawn[0] == {argmax[0]} and drawn[4] == {argmax[4]}
    for i in (1, 2, 3, 5):
        assert drawn[i] <= keep[i] and len(drawn[i]) > 1, i
