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


def configs(dtype, kv_dtype=None, **extra):
    """The JAX and port configs; ``kv_dtype`` by name ("int8",
    "float8_e4m3fn"), ``extra`` fields the same on both sides (``fused``
    defaults to True)."""
    if kv_dtype is not None:
        extra_j = dict(extra, kv_dtype=getattr(jnp, kv_dtype))
        extra_t = dict(extra, kv_dtype=getattr(torch, kv_dtype))
    else:
        extra_j, extra_t = dict(extra), dict(extra)
    fused = extra_j.pop("fused", True)
    extra_t = dict(extra_t)
    extra_t.pop("fused", None)
    if dtype == "f32":
        return jllama.LlamaConfig.tiny(fused=fused, **extra_j), tllama.LlamaConfig.tiny(fused=fused, **extra_t)
    # narrow bf16 variant: 3 layers, GQA group 4
    kw = dict(vocab_size=192, hidden_size=128, intermediate_size=192, num_layers=3,
              num_heads=8, num_kv_heads=2, head_dim=16, max_position=128, fused=fused)
    return (jllama.LlamaConfig(dtype=jnp.bfloat16, **kw, **extra_j),
            tllama.LlamaConfig(dtype=torch.bfloat16, **kw, **extra_t))


def qwen_extras(params, cfg):
    """Non-trivial Qwen-option weights in the JAX tree (its init leaves the
    q / k norms at one and the biases at zero); a no-op without the options."""
    rng = np.random.default_rng(11)
    lw = params["layers"]
    for name in ("q_norm", "k_norm", "q_bias", "k_bias", "v_bias"):
        if name in lw:
            base = 1.0 if name.endswith("norm") else 0.0
            lw[name] = jnp.asarray(base + 0.2 * rng.standard_normal(lw[name].shape), lw[name].dtype)


def run_both(dtype, prompt_lens, n_decode, **cfg_kw):
    """Prefill each prompt (batch of one, bucket-padded, as the engine does),
    then decode all sequences together. Returns the per-call logits of both
    sides and the final pools."""
    jcfg, tcfg = configs(dtype, **cfg_kw)
    jparams = jllama.init_weights(jcfg, jax.random.PRNGKey(3))
    qwen_extras(jparams, jcfg)
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
        tllama.LlamaConfig.tiny(quant="w8a8")
    with pytest.raises(NotImplementedError):  # mxfp4 is the MoE configs' expert format
        tllama.LlamaConfig.tiny(quant="mxfp4")
    # K10, the DMA decode GEMM, runs the decode bucket (M <= 32); prefill
    # rows take K1. Its decode step is held to JAX's gemm_impl="dma" below.
    dma = tllama.LlamaConfig.tiny(quant="w4a16", group_size=32, fused=True, gemm_impl="dma")
    assert tllama._w4_kernel_for(dma, 64) is tllama.w4a16_gemm
    assert tllama._w4_kernel_for(dma, 16) is tllama.w4a16_gemm_dma
    jl, tl, _, _ = run_both("f32", [5], n_decode=1, **W4, gemm_impl="dma")
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):  # int8 pools need a scale
        tllama.make_caches(tllama.LlamaConfig.tiny(kv_dtype=torch.int8), 4, 16, device="cpu")
    # the fused=False decode step runs since K4 was ported: held to JAX in
    # test_prefill_decode_unfused


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_decode_unfused(dtype):
    """The fused=False layout (the JAX LlamaConfig's default): K2, the
    separate q/k/v linears and K4's twin at decode. float32: the same ops in
    another summation order, 2e-5 of the logits' scale (1e-6 seen); bf16: a
    few bf16 ulps over 3 layers (~2^-7 of the scale seen), as
    test_prefill_decode_bf16."""
    jl, tl, (jk, jv), (tk, tv) = run_both(dtype, [5, 23], n_decode=3, fused=False)
    if dtype == "f32":
        for a, b in zip(jl, tl):
            assert np.abs(a - b).max() <= 2e-5 * max(1.0, float(np.abs(a).max()))
            np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
        assert np.abs(np.asarray(jk) - tk.numpy()).max() <= 2e-5 * max(1.0, float(np.abs(np.asarray(jk)).max()))
    else:
        for a, b in zip(jl, tl):
            np.testing.assert_allclose(a, b, rtol=0.05, atol=0.05)


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


W4 = dict(quant="w4a16", group_size=32)


def test_w4a16_prefill_decode_f32(gemm_impl="pipeline"):
    """W4A16 weights quantized by the JAX init, carried across: the packed
    codes are the same bytes, so only f32 summation order differs. With
    gemm_impl="dma" the decode GEMMs (and the prefill's lm_head rows) take
    K10 after a standalone rmsnorm on both sides."""
    jl, tl, (jk, jv), (tk, tv) = run_both("f32", [5, 23], n_decode=4, **W4, gemm_impl=gemm_impl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    np.testing.assert_allclose(np.asarray(jk), tk.numpy(), rtol=1e-4, atol=1e-4)


def test_w4a16_prefill_decode_bf16(gemm_impl="pipeline"):
    # as the bf16 model: bf16 rounding after every GEMM and the Pallas
    # attention's bf16 probabilities drift the logits by a few bf16 ulps
    jl, tl, _, _ = run_both("bf16", [9, 30], n_decode=3, **W4, gemm_impl=gemm_impl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(a, b, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("kv", [("int8", 1 / 16), ("float8_e4m3fn", 0.25)])
def test_quantized_kv_prefill_decode(kv):
    """W4A16 with int8 or fp8 e4m3 pools and a per-tensor scale: the stores
    quantize, K5 folds the scale back. In float32 the K/V rows of the two
    sides agree to ~1e-6 before the store, so a pool code differs (by one)
    only where a value sits on a rounding tie; the JAX upcast flushes
    e4m3 denormals (|code| < 2^-6, before the scale) to 0 where the port
    converts exactly, at most 2^-7 x 0.25 per pool element, which the
    logits see at ~1e-3."""
    kv_dtype, scale = kv
    jl, tl, (jk, jv), (tk, tv) = run_both("f32", [5, 23], n_decode=4, kv_dtype=kv_dtype, kv_scale=scale, **W4)
    assert tk.dtype == getattr(torch, kv_dtype)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    for jp, tp in ((jk, tk), (jv, tv)):
        # x / kv_scale lands within ~1e-6 of a rounding tie for a few
        # elements: those codes are neighbours (int8 and fp8 codes of one
        # sign are ordered like their values)
        diff = np.abs(np.asarray(jp).view(np.int8).astype(np.int32) - tp.view(torch.int8).numpy().astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("fused", [True, False])
def test_quantize_layers_bytes(fused):
    """_quantize_layers / _quantize_matrix on the JAX init's float weights
    give the JAX tree's bytes (the lm_head padded to 2048 rows)."""
    jcfg = jllama.LlamaConfig.tiny(fused=fused, **W4)
    tcfg = tllama.LlamaConfig.tiny(fused=fused, **W4)
    jfloat = jllama.init_weights(jllama.LlamaConfig.tiny(), jax.random.PRNGKey(2))
    jq = jllama._quantize_layers(dict(jfloat["layers"]), jcfg)
    tfloat = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jfloat), "cpu")
    tq = tllama._quantize_layers(tfloat["layers"], tcfg)
    assert sorted(jq) == sorted(tq)
    for name, leaf in jq.items():
        if isinstance(leaf, dict):
            for part in ("packed", "scales"):
                b = tq[name][part]
                np.testing.assert_array_equal(np.asarray(leaf[part]).view(np.uint8),
                                              b.contiguous().view(torch.uint8).numpy())
    jh = jllama._quantize_matrix(jfloat["lm_head"], jcfg)
    th = tllama._quantize_matrix(tfloat["lm_head"], tcfg)
    assert th["packed"].shape == (64, 2048)
    np.testing.assert_array_equal(np.asarray(jh["packed"]), th["packed"].numpy())
    np.testing.assert_array_equal(np.asarray(jh["scales"]).view(np.uint16),
                                  th["scales"].view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("kv_dtype,scale", [("int8", 1 / 16), ("float8_e4m3fn", 0.5), ("float8_e5m2", None)])
def test_kv_quant_dequant(rng, kv_dtype, scale):
    jcfg, tcfg = configs("bf16", kv_dtype=kv_dtype, kv_scale=scale)
    x = jnp.asarray(rng.standard_normal((6, 2, 16)) * 3, jnp.bfloat16)
    xq_j = jllama._kv_quant(jcfg, x)
    xq_t = tllama._kv_quant(tcfg, interop.tensor_from_numpy(np.asarray(x), "cpu"))
    if scale is not None:
        assert xq_t.dtype == getattr(torch, kv_dtype)
        np.testing.assert_array_equal(np.asarray(xq_j).view(np.uint8), xq_t.contiguous().view(torch.uint8).numpy())
        back_j = jllama._kv_deq(jcfg, xq_j, jnp.bfloat16)
        back_t = tllama._kv_deq(tcfg, xq_t, torch.bfloat16)
        np.testing.assert_array_equal(np.asarray(back_j).view(np.uint16), back_t.view(torch.int16).numpy().view(np.uint16))
    else:
        assert xq_t.dtype == torch.bfloat16  # no scale: the store casts
    assert tllama._kv_att_kwargs(tcfg) == ({} if scale is None else {"k_scale": scale, "v_scale": scale})


def test_w4a16_dma_prefill_decode_f32():
    test_w4a16_prefill_decode_f32(gemm_impl="dma")


def test_w4a16_dma_prefill_decode_bf16():
    test_w4a16_prefill_decode_bf16(gemm_impl="dma")


def run_admission_paths(dtype, **cfg_kw):
    """The engine's admission programs on both sides, in the order the
    engine uses them: ``prefill_packed`` of two fresh prompts (block 256,
    two padding blocks on the empty pseudo-sequence row), ``prefill_extend``
    of a 12-token chunk of the first over its 20 cached tokens, then
    ``mixed_step`` of the second's decode (plus a padding row) fused with a
    10-token chunk of the first. Returns the logits of each call and the
    final pools of both sides."""
    jcfg, tcfg = configs(dtype, **cfg_kw)
    jparams = jllama.init_weights(jcfg, jax.random.PRNGKey(4))
    qwen_extras(jparams, jcfg)
    tparams = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jk, jv = jllama.make_caches(jcfg, N_PAGES, PAGE)
    tk, tv = tllama.make_caches(tcfg, N_PAGES, PAGE, device="cpu")
    jrope, trope = jllama.build_rope_cache(jcfg), tllama.build_rope_cache(tcfg, device="cpu")
    rng = np.random.default_rng(9)
    a = rng.integers(0, jcfg.vocab_size, 42).tolist()
    b = rng.integers(0, jcfg.vocab_size, 9).tolist()
    pages = [[1, 2, 3], [4, 5]]
    slot = lambda i, p: pages[i][p // PAGE] * PAGE + p % PAGE
    table = lambda i: np.array(pages[i] + [0] * (8 - len(pages[i])), np.int32)
    jl, tl = [], []

    def call(name, *arrays, **kw):
        nonlocal jk, jv, tk, tv
        lj, *rest_j = getattr(jllama, name)(jparams, jcfg, jk, jv, *(jnp.asarray(x) for x in arrays), jrope, **kw)
        lt, *rest_t = getattr(tllama, name)(tparams, tcfg, tk, tv, *(torch.from_numpy(np.asarray(x)) for x in arrays),
                                            trope, **kw)
        *out_j, jk, jv = [lj, *rest_j]
        *out_t, tk, tv = [lt, *rest_t]
        jl.extend(np.asarray(x) for x in out_j)
        tl.extend(x.numpy() for x in out_t)

    # packed: a[:20] and b, 256-token blocks, 4 blocks (2 of padding)
    block, nb = 256, 4
    tokens = np.zeros(nb * block, np.int32)
    positions = np.zeros(nb * block, np.int32)
    slots = np.full(nb * block, -1, np.int32)
    for i, (pr, t0) in enumerate(((a[:20], 0), (b, block))):
        tokens[t0: t0 + len(pr)] = pr
        positions[t0: t0 + len(pr)] = np.arange(len(pr))
        slots[t0: t0 + len(pr)] = [slot(i, p) for p in range(len(pr))]
    blk_seq = np.array([0, 1, 2, 2], np.int32)
    blk_q0 = np.zeros(nb, np.int32)
    seq_meta = np.array([[20, 20, 0, 0, 0, 1], [9, 9, 0, 0, 1, 1], [0, 0, 0, 0, 0, 1]], np.int32)
    last_idx = np.array([19, block + 8, 0], np.int32)
    call("prefill_packed", tokens, positions, blk_seq, blk_q0, seq_meta, last_idx, slots, max_kvb=2)
    # extend: a[20:32] over the 20 cached tokens (prefix_max a page multiple)
    s = 16
    tok, pos, sl = np.zeros((1, s), np.int32), np.zeros((1, s), np.int32), np.full((1, s), -1, np.int32)
    tok[0, :12], pos[0, :12], sl[0, :12] = a[20:32], np.arange(20, 32), [slot(0, p) for p in range(20, 32)]
    call("prefill_extend", tok, pos, np.array([12], np.int32), np.array([32], np.int32), table(0)[None], sl,
         prefix_max=32)
    # mixed: b's first decode token (one padding row) and a[32:42]
    nxt = int(np.argmax(jl[0][1]))
    dec = [np.array([nxt, 0], np.int32), np.array([9, 0], np.int32), np.stack([table(1), table(1) * 0]),
           np.array([10, 1], np.int32), np.array([slot(1, 9), -1], np.int32)]
    pf_tok, pf_pos, pf_sl = np.zeros(s, np.int32), np.zeros(s, np.int32), np.full(s, -1, np.int32)
    pf_tok[:10], pf_pos[:10], pf_sl[:10] = a[32:42], np.arange(32, 42), [slot(0, p) for p in range(32, 42)]
    call("mixed_step", *dec, pf_tok, pf_pos, np.int32(10), np.int32(42), table(0), pf_sl, prefix_max=32)
    jl[2], tl[2] = jl[2][:1], tl[2][:1]  # the padding decode row's logits are not compared
    return jl, tl, (jk, jv), (tk, tv)


def test_admission_paths_f32():
    """float32 end to end: the twins and the Pallas kernels (K9 and the
    two-pass extend of K7) differ only in summation order."""
    jl, tl, (jk, jv), (tk, tv) = run_admission_paths("f32")
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    np.testing.assert_allclose(np.asarray(jk), tk.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=1e-4, atol=1e-4)


def test_admission_paths_bf16():
    # bf16 rounding after every linear and the Pallas attention's bf16
    # probabilities drift the logits by a few bf16 ulps over 3 layers
    jl, tl, _, _ = run_admission_paths("bf16")
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(a, b, rtol=0.05, atol=0.05)


def test_admission_paths_w4a16(gemm_impl="pipeline"):
    """W4A16 weights quantized by the JAX init, float32 activations: the
    packed codes are the same bytes, so only summation order differs. With
    gemm_impl="dma" the packed prefill's and the extend's lm_head rows and
    the mixed step's rows (M <= 32) take K10."""
    jl, tl, (jk, _), (tk, _) = run_admission_paths("f32", **W4, gemm_impl=gemm_impl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    np.testing.assert_allclose(np.asarray(jk), tk.numpy(), rtol=1e-4, atol=1e-4)


def test_admission_paths_int8_kv():
    """W4A16 over int8 pools at kv_scale 1/16: the extend passes read the
    gathered prefix through ``_kv_deq``. Codes may differ by one on a
    rounding tie (see test_quantized_kv_prefill_decode)."""
    jl, tl, (jk, jv), (tk, tv) = run_admission_paths("f32", kv_dtype="int8", kv_scale=1 / 16, **W4)
    assert tk.dtype == torch.int8
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    for jp, tp in ((jk, tk), (jv, tv)):
        diff = np.abs(np.asarray(jp).astype(np.int32) - tp.numpy().astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_extend_num_logits_raises():
    """Llama's extend takes num_logits (tests/test_torch_spec.py); gpt-oss's
    raises for more than one, as JAX's gpt-oss extend has no num_logits."""
    from sgl_kernel_tpu_torch import GptOssConfig
    from sgl_kernel_tpu_torch.models import gptoss

    cfg = GptOssConfig.tiny(quant="mxfp4", qkv_bias=True)
    with pytest.raises(NotImplementedError):
        gptoss.prefill_extend(None, cfg, None, None, torch.zeros((1, 4), dtype=torch.int32), None, None, None,
                              None, None, None, prefix_max=16, num_logits=2)


def test_dma_decode_takes_k10_with_standalone_norm(monkeypatch):
    """The decode step with gemm_impl="dma" follows JAX's routing
    (llama.py:181-205, :274-299): every GEMM of M <= 32 rows is K10, which
    has no norm prologue, so the norms run standalone (K2) before it, and
    the down GEMM takes the gate and up slices as K10's a2 instead of K1's
    fused_gate_up shortcut."""
    cfg = tllama.LlamaConfig.tiny(quant="w4a16", group_size=32, fused=True, gemm_impl="dma")
    calls = {"k1": [], "k10": [], "norm": 0}
    k1, k10, norm = tllama.w4a16_gemm, tllama.w4a16_gemm_dma, tllama.rmsnorm

    def rec(name, fn):
        def call(a, *args, **kw):
            calls[name].append((a.shape[0], kw.get("prologue"), kw.get("a2") is not None, "norm_weight" in kw))
            return fn(a, *args, **kw)
        return call

    def rec_norm(*args, **kw):
        calls["norm"] += 1
        return norm(*args, **kw)

    # _w4_kernel_for returns these module globals, so the routing sees the wrappers
    monkeypatch.setattr(tllama, "w4a16_gemm", rec("k1", k1))
    monkeypatch.setattr(tllama, "w4a16_gemm_dma", rec("k10", k10))
    monkeypatch.setattr(tllama, "rmsnorm", rec_norm)
    params = tllama.init_weights(cfg, 0, device="cpu")
    k, v = tllama.make_caches(cfg, 4, 16, device="cpu")
    b = 2
    logits, _, _ = tllama.decode_step(params, cfg, k, v, torch.tensor([3, 5], dtype=torch.int32),
                                      torch.tensor([0, 0], dtype=torch.int32), torch.zeros((b, 4), dtype=torch.int32),
                                      torch.ones(b, dtype=torch.int32), torch.tensor([0, 16], dtype=torch.int32),
                                      tllama.build_rope_cache(cfg, "cpu"))
    assert torch.isfinite(logits).all()
    assert calls["k1"] == []
    # per layer: qkv, o, gate_up, down (silu_mul with a2); then the lm_head
    assert len(calls["k10"]) == 4 * cfg.num_layers + 1
    assert all(not nw for *_, nw in calls["k10"])
    downs = [c for c in calls["k10"] if c[1] == "silu_mul"]
    assert len(downs) == cfg.num_layers and all(a2 for _, _, a2, _ in downs)
    # input norm, post norm per layer, and the final norm
    assert calls["norm"] == 2 * cfg.num_layers + 1


def test_admission_paths_w4a16_dma():
    test_admission_paths_w4a16(gemm_impl="dma")


QWEN = {"qwen3": dict(qk_norm=True), "qwen2": dict(qkv_bias=True, fused=False),
        "both_w4a16": dict(qk_norm=True, qkv_bias=True, quant="w4a16", group_size=32)}


@pytest.mark.parametrize("name", list(QWEN))
def test_qwen_prefill_decode(name):
    """The Qwen options (per-head q / k RMSNorm on K2, q / k / v biases, and
    both over W4A16 weights) through prefill and decode, with the norms and
    biases nonzero: float32 end to end, the same ops in another summation
    order, within 1e-4 as test_prefill_decode_f32; the same argmax."""
    jl, tl, (jk, jv), (tk, tv) = run_both("f32", [5, 23], n_decode=3, **QWEN[name])
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    np.testing.assert_allclose(np.asarray(jk), tk.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["qwen3", "qwen2"])
def test_qwen_admission_paths(name):
    """The Qwen options through the engine's other programs (packed prefill,
    extend over a cached prefix, a mixed step), float32, within 1e-4."""
    jl, tl, (jk, _), (tk, _) = run_admission_paths("f32", **QWEN[name])
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    np.testing.assert_allclose(np.asarray(jk), tk.numpy(), rtol=1e-4, atol=1e-4)


def test_qwen_config_and_fused_decode_off(monkeypatch):
    """qwen3_8b's widths and options; init adds the Qwen weights; with
    either option the fused layout's decode runs K2, the split q / k / v and
    K4, never K3 (llama.py:379 of the JAX package)."""
    cfg = tllama.LlamaConfig.qwen3_8b()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, cfg.rope_theta, cfg.qk_norm, cfg.qkv_bias) == (
        151936, 4096, 12288, 36, 32, 8, 128, 1e6, True, False)
    tiny = tllama.LlamaConfig.tiny(fused=True, qk_norm=True, qkv_bias=True)
    params = tllama.init_weights(tiny, 0, "cpu")
    lw = params["layers"]
    assert lw["q_norm"].shape == (2, 32) and lw["k_bias"].shape == (2, 64) and "qkv" in lw
    called = []
    monkeypatch.setattr(tllama, "rope_decode_fused_qkv", lambda *a, **k: called.append(1))
    k, v = tllama.make_caches(tiny, 4, PAGE, device="cpu")
    rope = tllama.build_rope_cache(tiny, device="cpu")
    i = lambda *x: torch.tensor(x, dtype=torch.int32)
    logits, _, _ = tllama.decode_step(params, tiny, k, v, i(3), i(0), i(1, 0).reshape(1, 2), i(1), i(16), rope)
    assert not called and torch.isfinite(logits).all()
