"""Parity of the port's Llama model functions (prefill, decode_step) and
sampling filters with the JAX package. The JAX weights are carried across by
``params_from_numpy``; the same prompt, slots and page tables drive both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.models import llama as jllama
from sgl_kernel_tpu.ops import sampling as jsamp
from sgl_kernel_tpu_torch import interop
from sgl_kernel_tpu_torch.models import llama as tllama
from sgl_kernel_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(1)

PAGE, N_PAGES, BUCKET = 16, 12, 32


def configs(dtype):
    if dtype == "f32":
        return jllama.LlamaConfig.tiny(fused=True), tllama.LlamaConfig.tiny(fused=True)
    # narrow bf16 variant: 3 layers, GQA group 4
    kw = dict(vocab_size=192, hidden_size=128, intermediate_size=192, num_layers=3,
              num_heads=8, num_kv_heads=2, head_dim=16, max_position=128, fused=True)
    return (jllama.LlamaConfig(dtype=jnp.bfloat16, **kw), tllama.LlamaConfig(dtype=torch.bfloat16, **kw))


def run_both(dtype, prompt_lens, n_decode):
    """Prefill each prompt (batch of one, bucket-padded, as the engine does),
    then decode all sequences together. Returns the per-call logits of both
    sides and the final pools."""
    jcfg, tcfg = configs(dtype)
    jparams = jllama.init_weights(jcfg, jax.random.PRNGKey(3))
    tparams = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jk, jv = jllama.make_caches(jcfg, N_PAGES, PAGE)
    tk, tv = tllama.make_caches(tcfg, N_PAGES, PAGE, device="cpu")
    jrope = jllama.build_rope_cache(jcfg)
    trope = tllama.build_rope_cache(tcfg, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist() for n in prompt_lens]
    need = [-(-(n + n_decode) // PAGE) for n in prompt_lens]
    pages, nxt = [], 1
    for n in need:
        pages.append(list(range(nxt, nxt + n)))
        nxt += n
    slot = lambda i, p: pages[i][p // PAGE] * PAGE + p % PAGE
    jl, tl = [], []
    for i, pr in enumerate(prompts):
        s = len(pr)
        tok = np.zeros((1, BUCKET), np.int32)
        tok[0, :s] = pr
        pos = np.zeros((1, BUCKET), np.int32)
        pos[0, :s] = np.arange(s)
        sl = np.full((1, BUCKET), -1, np.int32)
        sl[0, :s] = [slot(i, p) for p in range(s)]
        ql = np.array([s], np.int32)
        lj, jk, jv = jllama.prefill(jparams, jcfg, jk, jv, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(ql),
                                    jnp.asarray(sl), jrope)
        lt, tk, tv = tllama.prefill(tparams, tcfg, tk, tv, *(torch.from_numpy(a) for a in (tok, pos, ql, sl)), trope)
        jl.append(np.asarray(lj))
        tl.append(lt.numpy())
    seqs = [list(p) + [int(np.argmax(jl[i][0]))] for i, p in enumerate(prompts)]
    b = len(prompts) + 1  # one padding row, as the engine pads to max_batch
    for _ in range(n_decode):
        tokens = np.zeros(b, np.int32)
        positions = np.zeros(b, np.int32)
        lengths = np.zeros(b, np.int32)
        slot_loc = np.full(b, -1, np.int32)
        tables = np.zeros((b, 8), np.int32)
        for i, sq in enumerate(seqs):
            tokens[i], positions[i], lengths[i] = sq[-1], len(sq) - 1, len(sq)
            slot_loc[i] = slot(i, len(sq) - 1)
            tables[i, : len(pages[i])] = pages[i]
        args = (tokens, positions, tables, lengths, slot_loc)
        lj, jk, jv = jllama.decode_step(jparams, jcfg, jk, jv, *(jnp.asarray(a) for a in args), jrope)
        lt, tk, tv = tllama.decode_step(tparams, tcfg, tk, tv, *(torch.from_numpy(a) for a in args), trope)
        jl.append(np.asarray(lj)[: len(seqs)])
        tl.append(lt.numpy()[: len(seqs)])
        for i, sq in enumerate(seqs):
            sq.append(int(np.argmax(jl[-1][i])))
    return jl, tl, (jk, jv), (tk, tv)


def test_prefill_decode_f32():
    jl, tl, (jk, jv), (tk, tv) = run_both("f32", [5, 23], n_decode=4)
    # float32 end to end: the twins and the Pallas kernels differ only in
    # summation order (online vs dense softmax, tiled dots)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    np.testing.assert_allclose(np.asarray(jk), tk.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=1e-4, atol=1e-4)


def test_prefill_decode_bf16():
    jl, tl, _, _ = run_both("bf16", [9, 30], n_decode=3)
    # bf16 activations round at 2^-8 after every linear; the Pallas attention
    # also rounds its probabilities to bf16. Over 3 layers the logits (of
    # unit scale) drift by a few bf16 ulps.
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(a, b, rtol=0.05, atol=0.05)


def test_params_from_numpy_bf16_bytes():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)), jnp.bfloat16)
    t = interop.params_from_numpy({"a": {"b": np.asarray(x)}}, "cpu")["a"]["b"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), np.asarray(x).view(np.uint16))


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        tllama.LlamaConfig.tiny(quant="w4a16")
    cfg = tllama.LlamaConfig.tiny(fused=False)
    with pytest.raises(NotImplementedError):
        tllama.decode_layers({"input_norm": torch.ones(2, 128)}, cfg, None, None, torch.zeros(1, 128),
                             None, None, None, None, None)


@pytest.mark.parametrize("fn", ["top_k", "top_p", "min_p"])
def test_sampling_filters(rng, fn):
    probs = rng.dirichlet(np.full(64, 0.3), size=4).astype(np.float32)
    probs[1, :4] = probs[1, 4]  # ties at the boundary are kept on both sides
    # top_p stays below 1.0: a row's float32 total mass rounds to either side
    # of 1.0 depending on summation order, and p = 1.0 would test that rounding
    arg = {"top_k": np.array([5, 3, 0, 64], np.int32), "top_p": np.array([0.9, 0.5, 0.0, 0.97], np.float32),
           "min_p": np.array([0.1, 0.5, 0.0, 0.9], np.float32)}[fn]
    jf = {"top_k": jsamp.top_k_renorm_probs, "top_p": jsamp.top_p_renorm_probs, "min_p": jsamp.min_p_filter_probs}[fn]
    tf = {"top_k": tsamp.top_k_renorm_probs, "top_p": tsamp.top_p_renorm_probs, "min_p": tsamp.min_p_filter_probs}[fn]
    ref = np.asarray(jf(jnp.asarray(probs), jnp.asarray(arg)))
    out = tf(torch.from_numpy(probs), torch.from_numpy(arg)).numpy()
    np.testing.assert_array_equal(ref > 0, out > 0)  # the same keep sets
    np.testing.assert_allclose(ref, out, rtol=1e-6, atol=1e-7)


def test_sample_tokens_distribution():
    """Sampled ids: greedy agrees exactly; sampled draws stay inside the
    top-p set and follow its renormalized distribution."""
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0, -3.0]])
    assert int(tsamp.sample_tokens(logits, temperature_is_zero=True)[0]) == 0
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([tsamp.sample_tokens(logits, gen, temperature=0.8, top_p=[0.9])[0] for _ in range(2000)])
    probs = torch.softmax(logits / 0.8, -1)
    kept = tsamp.top_p_renorm_probs(probs, [0.9])[0]
    freq = torch.bincount(draws.long(), minlength=5).float() / len(draws)
    assert (freq[kept == 0] == 0).all()
    # 2000 draws: the standard error of a frequency is at most 0.011
    torch.testing.assert_close(freq, kept, atol=0.05, rtol=0)
