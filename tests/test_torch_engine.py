"""The slice end to end: the JAX Engine and the port's Engine(device="cpu")
serve the same greedy workload on the same weights and must emit identical
tokens for every request.

Six requests with prompts of 3 to 40 tokens on a max_batch of 4, so the
last two are admitted only after earlier ones retire. The JAX side gets an
adapter without packed prefill or extend, so both engines take the same
path: one padded prefill per prompt, the prefix cache off."""

import jax
import numpy as np
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
