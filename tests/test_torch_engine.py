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
