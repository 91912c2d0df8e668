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
