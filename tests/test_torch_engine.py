"""The slice end to end: the JAX Engine and the port's Engine(device="cpu")
serve the same greedy workload on the same weights and must emit identical
tokens for every request.

Six requests with prompts of 3 to 40 tokens on a max_batch of 4, so the
last two are admitted only after earlier ones retire. The JAX side gets an
adapter without packed prefill or extend, so both engines take the same
path: one padded prefill per prompt, the prefix cache off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.models import llama as jllama
from sgl_kernel_tpu.serving.adapters import LlamaAdapter as JaxLlamaAdapter
from sgl_kernel_tpu.serving.engine import Engine as JaxEngine
from sgl_kernel_tpu_torch import Engine, LlamaConfig, launch_counts, params_from_numpy

torch.set_num_threads(1)


class PlainPrefillAdapter(JaxLlamaAdapter):
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
    teng = Engine(LlamaConfig.tiny(fused=True),
                  params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
                  device="cpu", **kw)
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
    teng = Engine(LlamaConfig.tiny(**tkw), params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
                  device="cpu", **kw)
    assert teng.caches[0].dtype == (torch.int8 if kv else torch.float32)
    for p in prompts:
        jeng.add_request(p, max_new_tokens=6)
        teng.add_request(p, max_new_tokens=6)
    jfin, tfin = jeng.run_until_done(), teng.run_until_done()
    assert sorted(jfin) == sorted(tfin)
    for rid in jfin:
        assert tfin[rid].output == jfin[rid].output, rid
