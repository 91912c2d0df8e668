"""Parity of the port's attention operators (K5 paged decode with its
options, splits and both pool layouts, K7 flash prefill, the base-2 state
merge) with the JAX package: the same
numpy-seeded bytes through the Pallas kernels in interpret mode and through
the port's plain PyTorch twins on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_tpu.ops.attention import flash_prefill as jflash
from sgl_kernel_tpu.ops.attention import merge_state as jmerge_state
from sgl_kernel_tpu.ops.attention import merge_states as jmerge_states
from sgl_kernel_tpu.ops.attention import paged_decode_dma as jdec
from sgl_kernel_tpu_torch.interop import tensor_from_numpy
from sgl_kernel_tpu_torch.ops import attention as tatt

torch.set_num_threads(1)

# float32 inputs: the Pallas kernels run an online softmax over tiles, the
# plain twins one dense softmax; the sums differ in order and in where the
# running max rescales, a few float32 ulp per term.
F32 = dict(rtol=2e-5, atol=2e-5)
# bf16 inputs: the Pallas kernels round the probabilities to bf16 before
# the P.V product (2^-8 relative), the twins keep them in float32.
BF16 = dict(rtol=2e-2, atol=2e-2)


def both(x, jdt):
    xj = jnp.asarray(x, jdt)
    return xj, tensor_from_numpy(np.asarray(xj), "cpu")


def close(a_jax, b_torch, **tol):
    np.testing.assert_allclose(np.asarray(a_jax, np.float32), b_torch.float().numpy(), **tol)


def paged_case(rng, b, hq, hkv, d, page, lengths, n_layers=2, jdt=jnp.float32):
    """Layer-stacked page-major pools with each sequence's pages scattered
    over the pool; lengths count the current token (which rides as the fresh
    row). A length of 0 is an engine padding row: zero table, no pool."""
    n_blocks = max(1, max(-(-max(lengths) // page), 1)) + 1
    n_pages = b * n_blocks + 1
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, n_blocks), np.int32)
    for i, n in enumerate(lengths):
        used = -(-n // page)
        table[i, :used] = perm[i * n_blocks: i * n_blocks + used]
    shape = (n_layers, n_pages, hkv, page, d)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            (shape, shape, (b, hq, d), (b, hkv, d), (b, hkv, d))]
    return table, [both(a, jdt) for a in arrs]


@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 2), (16, 8)])
@pytest.mark.parametrize("page", [16, 64])
def test_paged_decode_fresh(rng, hq, hkv, page):
    b, d = 4, 32
    lengths = [1, 37, 0, 2 * page + 5]  # ragged, one padding row of length 0
    table, [(kj, kt), (vj, vt), (qj, qt), (fkj, fkt), (fvj, fvt)] = paged_case(rng, b, hq, hkv, d, page, lengths)
    lens = np.array(lengths, np.int32)
    for layer in (0, 1):
        ref = jdec.paged_attention_decode_dma(qj, kj, vj, jnp.asarray(lens), jnp.asarray(table),
                                              layer_id=layer, fresh_k=fkj, fresh_v=fvj, chunk_pages=2)
        out = tatt.paged_attention_decode_dma(qt, kt, vt, torch.from_numpy(lens), torch.from_numpy(table),
                                              layer_id=layer, fresh_k=fkt, fresh_v=fvt)
        assert out.shape == qt.shape and out.dtype == qt.dtype
        close(ref, out, **F32)
    # the padding row attends only its fresh row: o is the fresh v of its group
    g = hq // hkv
    np.testing.assert_allclose(out[2].numpy(), fvt[2].repeat_interleave(g, dim=0).numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hq,hkv", [(8, 2), (8, 4)])
def test_paged_decode_bf16_no_fresh(rng, hq, hkv):
    b, d, page = 3, 64, 16
    lengths = [70, 1, 33]
    table, [(kj, kt), (vj, vt), (qj, qt), _, _] = paged_case(rng, b, hq, hkv, d, page, lengths, jdt=jnp.bfloat16)
    lens = np.array(lengths, np.int32)
    ref = jdec.paged_attention_decode_dma(qj, kj, vj, jnp.asarray(lens), jnp.asarray(table), layer_id=1)
    out = tatt.paged_attention_decode_dma(qt, kt, vt, torch.from_numpy(lens), torch.from_numpy(table), layer_id=1)
    close(ref, out, **BF16)


def test_paged_decode_options_lse(rng):
    """The plain twin covers the JAX contract beyond the kernel's: sinks,
    window, softcap and the base-2 lse."""
    b, hq, hkv, d, page = 2, 4, 2, 32, 16
    lengths = [40, 9]
    table, [(kj, kt), (vj, vt), (qj, qt), (fkj, fkt), (fvj, fvt)] = paged_case(rng, b, hq, hkv, d, page, lengths)
    lens = np.array(lengths, np.int32)
    sinks = rng.standard_normal(hq).astype(np.float32)
    kw = dict(sliding_window=16, logit_soft_cap=5.0, return_lse=True)
    ro, rl = jdec.paged_attention_decode_dma(qj, kj, vj, jnp.asarray(lens), jnp.asarray(table), jnp.asarray(sinks),
                                             fresh_k=fkj, fresh_v=fvj, chunk_pages=2, **kw)
    oo, ol = tatt.paged_attention_decode_dma(qt, kt, vt, torch.from_numpy(lens), torch.from_numpy(table),
                                             torch.from_numpy(sinks), fresh_k=fkt, fresh_v=fvt, **kw)
    close(ro, oo, **F32)
    close(rl, ol, **F32)


def head_major(x):
    """Page-major pools [L, P, Hkv, page, D] -> the same pools head-major
    [L, Hkv, P, page, D] (the JAX array and the CPU tensor)."""
    xj, xt = x
    return jnp.swapaxes(xj, 1, 2), xt.transpose(1, 2).contiguous()


@pytest.mark.parametrize("num_splits", [1, 2])
def test_paged_decode_contract_only_args(rng, num_splits):
    """chunk_pages, num_splits and layout: the JAX kernel's split-KV over
    one-page chunks is the twin's split (partials rounded to q's dtype,
    merged), and the head-major layout over the same pools gives JAX's
    head-major result."""
    b, hq, hkv, d, page = 2, 4, 2, 32, 16
    lengths = [70, 9]
    table, [k, v, (qj, qt), (fkj, fkt), (fvj, fvt)] = paged_case(rng, b, hq, hkv, d, page, lengths)
    lens = np.array(lengths, np.int32)
    kw = dict(chunk_pages=1, num_splits=num_splits)
    for layout, (kj, kt), (vj, vt) in (("page", k, v), ("head", head_major(k), head_major(v))):
        ref = jdec.paged_attention_decode_dma(qj, kj, vj, jnp.asarray(lens), jnp.asarray(table),
                                              fresh_k=fkj, fresh_v=fvj, layout=layout, **kw)
        out = tatt.paged_attention_decode_dma(qt, kt, vt, torch.from_numpy(lens), torch.from_numpy(table),
                                              fresh_k=fkt, fresh_v=fvt, layout=layout, **kw)
        close(ref, out, **F32)


@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("num_splits", [2, 3])
def test_paged_decode_splits(rng, num_splits, fresh, jdt):
    """Split-KV with one-page chunks, with the lse: each split's partial is
    rounded to q's dtype, the fresh row joins the last split, and
    merge_states combines them (paged_decode_dma.py:383-384, :488-). A
    sequence shorter than a split's start leaves that split empty."""
    b, hq, hkv, d, page = 3, 8, 2, 32, 16
    lengths = [70, 9, 41]
    table, [(kj, kt), (vj, vt), (qj, qt), (fkj, fkt), (fvj, fvt)] = paged_case(rng, b, hq, hkv, d, page, lengths,
                                                                               jdt=jdt)
    lens = np.array(lengths, np.int32)
    kw = dict(chunk_pages=1, num_splits=num_splits, return_lse=True, layer_id=1)
    fj = dict(fresh_k=fkj, fresh_v=fvj) if fresh else {}
    ft = dict(fresh_k=fkt, fresh_v=fvt) if fresh else {}
    ro, rl = jdec.paged_attention_decode_dma(qj, kj, vj, jnp.asarray(lens), jnp.asarray(table), **fj, **kw)
    oo, ol = tatt.paged_attention_decode_dma(qt, kt, vt, torch.from_numpy(lens), torch.from_numpy(table), **ft, **kw)
    assert oo.dtype == qt.dtype and ol.dtype == torch.float32
    close(ro, oo, **(F32 if jdt == jnp.float32 else BF16))
    close(rl, ol, **(F32 if jdt == jnp.float32 else BF16))


@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("layout", ["page", "head"])
def test_paged_decode_options_layouts(rng, layout, num_splits):
    """Sinks, window, softcap and the lse together, over both layouts and
    under a split: the sinks join the last split's denominator."""
    b, hq, hkv, d, page = 3, 8, 4, 32, 16
    lengths = [70, 9, 33]
    table, [k, v, (qj, qt), (fkj, fkt), (fvj, fvt)] = paged_case(rng, b, hq, hkv, d, page, lengths)
    if layout == "head":
        k, v = head_major(k), head_major(v)
    (kj, kt), (vj, vt) = k, v
    lens = np.array(lengths, np.int32)
    sinks = rng.standard_normal(hq).astype(np.float32)
    kw = dict(sliding_window=24, logit_soft_cap=5.0, return_lse=True, layout=layout, chunk_pages=1,
              num_splits=num_splits)
    ro, rl = jdec.paged_attention_decode_dma(qj, kj, vj, jnp.asarray(lens), jnp.asarray(table), jnp.asarray(sinks),
                                             fresh_k=fkj, fresh_v=fvj, **kw)
    oo, ol = tatt.paged_attention_decode_dma(qt, kt, vt, torch.from_numpy(lens), torch.from_numpy(table),
                                             torch.from_numpy(sinks), fresh_k=fkt, fresh_v=fvt, **kw)
    close(ro, oo, **F32)
    close(rl, ol, **F32)


def test_paged_decode_split_empty_row(rng):
    """A padding row (length 0) under a split: with no fresh row every
    split is empty and the port gives o = 0, lse = -inf (JAX's merge gives
    NaN there); with a fresh row it attends only that row, as unsplit."""
    b, hq, hkv, d, page = 2, 4, 2, 32, 16
    lengths = [70, 0]
    table, [(_, kt), (_, vt), (_, qt), (_, fkt), (_, fvt)] = paged_case(rng, b, hq, hkv, d, page, lengths)
    lens = torch.tensor(lengths, dtype=torch.int32)
    kw = dict(chunk_pages=1, num_splits=3, return_lse=True)
    o, lse = tatt.paged_attention_decode_dma(qt, kt, vt, lens, torch.from_numpy(table), **kw)
    assert torch.all(o[1] == 0) and torch.all(torch.isneginf(lse[1])) and torch.isfinite(o[0]).all()
    o, lse = tatt.paged_attention_decode_dma(qt, kt, vt, lens, torch.from_numpy(table), fresh_k=fkt, fresh_v=fvt,
                                             **kw)
    np.testing.assert_allclose(o[1].numpy(), fvt[1].repeat_interleave(hq // hkv, dim=0).numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.isfinite(lse[1]).all()


def test_choose_num_splits():
    """The split heuristic, copied: equal to JAX's over a grid."""
    for batch in (1, 2, 7, 16, 64, 132, 200):
        for ctx in (1, 64, 1000, 8192, 32768):
            for page in (16, 64):
                for cpp in (1, 4, 16):
                    for cores in (1, 2, 8, 132):
                        assert (tatt.choose_num_splits(batch, ctx, page, cpp, num_cores=cores)
                                == jdec.choose_num_splits(batch, ctx, page, cpp, num_cores=cores))


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 1), (4, 4)])
def test_flash_ragged_causal(rng, hq, hkv):
    b, s, d = 3, 40, 32
    q_lens = np.array([40, 17, 1], np.int32)
    (qj, qt), (kj, kt), (vj, vt) = [both(rng.standard_normal(sh).astype(np.float32), jnp.float32)
                                    for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))]
    ql = jnp.asarray(q_lens)
    ref = jflash.flash_attention(qj, kj, vj, ql, ql, causal=True, block_q=16, block_kv=128)
    out = tatt.flash_attention(qt, kt, vt, torch.from_numpy(q_lens), torch.from_numpy(q_lens), causal=True)
    assert out.shape == qt.shape
    for i, n in enumerate(q_lens):  # rows past q_len are padding
        close(ref[i, :n], out[i, :n], **F32)
    assert torch.isfinite(out).all()


def test_flash_bf16_extend_offsets(rng):
    """bf16, queries as the last q_len of kv_len (the extend default), plus
    explicit q_start/kv_start and the lse output."""
    b, sq, skv, hq, hkv, d = 2, 16, 48, 4, 2, 64
    (qj, qt), (kj, kt), (vj, vt) = [both(rng.standard_normal(sh).astype(np.float32), jnp.bfloat16)
                                    for sh in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    q_lens = np.array([16, 5], np.int32)
    kv_lens = np.array([48, 30], np.int32)
    ref = jflash.flash_attention(qj, kj, vj, jnp.asarray(q_lens), jnp.asarray(kv_lens), causal=True)
    out = tatt.flash_attention(qt, kt, vt, torch.from_numpy(q_lens), torch.from_numpy(kv_lens), causal=True)
    for i, n in enumerate(q_lens):
        close(ref[i, :n], out[i, :n], **BF16)
    qs, ks = np.array([3, 4], np.int32), np.array([0, 2], np.int32)  # every row sees a key
    ro, rl = jflash.flash_attention(qj, kj, vj, jnp.asarray(q_lens), jnp.asarray(kv_lens), None,
                                    jnp.asarray(qs), jnp.asarray(ks), causal=True, return_lse=True)
    oo, ol = tatt.flash_attention(qt, kt, vt, torch.from_numpy(q_lens), torch.from_numpy(kv_lens), None,
                                  torch.from_numpy(qs), torch.from_numpy(ks), causal=True, return_lse=True)
    for i, n in enumerate(q_lens):
        close(ro[i, :n], oo[i, :n], **BF16)
        close(rl[i, :, :n], ol[i, :, :n], **BF16)


FLASH_OPTIONS = {"sinks": dict(sinks=True), "window": dict(sliding_window=8), "softcap": dict(logit_soft_cap=5.0),
                 "all": dict(sinks=True, sliding_window=8, logit_soft_cap=5.0)}


@pytest.mark.parametrize("opt", list(FLASH_OPTIONS))
@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 1)])
def test_flash_options_offsets(rng, opt, hq, hkv):
    """K7's twin with gpt-oss's options (per-head sinks, a sliding window,
    a tanh soft cap), alone and together, at extend offsets (q_start /
    kv_start), GQA 2:1 and 8:1, with the lse, float32. Sequence 1's q sits at
    positions 32..47 over keys 0..47; sequence 2's at 50..54 over keys 0..29,
    so under the window of 8 its rows see no key: the port gives them o = 0
    and lse -1e30 * log2(e) (JAX's lse there is -inf or, with a sink, +inf;
    ROADMAP queue 3), and only rows that see a key are compared."""
    b, sq, skv, d = 2, 16, 48, 32
    kw = dict(FLASH_OPTIONS[opt])
    (qj, qt), (kj, kt), (vj, vt) = [both(rng.standard_normal(sh).astype(np.float32), jnp.float32)
                                    for sh in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    q_lens, kv_lens = np.array([16, 5], np.int32), np.array([48, 30], np.int32)
    qs, ks = np.array([32, 50], np.int32), np.array([0, 0], np.int32)
    sinks = (rng.standard_normal(hq) * 2).astype(np.float32) if kw.pop("sinks", False) else None
    ro, rl = jflash.flash_attention(qj, kj, vj, *map(jnp.asarray, (q_lens, kv_lens)),
                                    None if sinks is None else jnp.asarray(sinks), *map(jnp.asarray, (qs, ks)),
                                    causal=True, return_lse=True, **kw)
    oo, ol = tatt.flash_attention(qt, kt, vt, *map(torch.from_numpy, (q_lens, kv_lens)),
                                  None if sinks is None else torch.from_numpy(sinks), *map(torch.from_numpy, (qs, ks)),
                                  causal=True, return_lse=True, **kw)
    window = kw.get("sliding_window")
    for i in range(b):
        for r in range(q_lens[i]):
            qp = qs[i] + r
            kp = ks[i] + np.arange(kv_lens[i])
            seen = ((kp <= qp) & ((kp > qp - window) if window else True)).any()
            if seen:
                close(ro[i, r], oo[i, r], **F32)
                close(rl[i, :, r], ol[i, :, r], **F32)
            else:
                assert not oo[i, r].any() and torch.all(ol[i, :, r] == np.float32(-1e30 * tatt.flash_prefill.LOG2E))
    assert (window is not None) == (not oo[1, :5].any())


def test_merge_states(rng):
    t, h, d = 5, 4, 16
    va, vb = (rng.standard_normal((t, h, d)).astype(np.float32) for _ in range(2))
    sa, sb = (rng.standard_normal((t, h)).astype(np.float32) * 4 for _ in range(2))
    rv, rs = jmerge_state(*(jnp.asarray(x) for x in (va, sa, vb, sb)))
    ov, os_ = tatt.merge_state(*(torch.from_numpy(x) for x in (va, sa, vb, sb)))
    close(rv, ov, **F32)
    close(rs, os_, **F32)
    vs = np.stack([va, vb, va * 2])
    ss = np.stack([sa, sb, sb - 1])
    rv, rs = jmerge_states(jnp.asarray(vs), jnp.asarray(ss))
    ov, os_ = tatt.merge_states(torch.from_numpy(vs), torch.from_numpy(ss))
    close(rv, ov, **F32)
    close(rs, os_, **F32)


def quant_pools(rng, kind, shape):
    """K and V pools of 1-byte codes as (JAX array, tensor) pairs. fp8 codes
    keep |x| in [2^-6, 8) and avoid the encodings where the JAX upcast
    deliberately differs (denormals flush, NaN reads as +-480,
    paged_decode_dma.py:41-70)."""
    if kind == "int8":
        return [both(rng.integers(-127, 128, shape).astype(np.int8), jnp.int8) for _ in range(2)]
    codes = np.array([b for b in range(256) if 1 <= (b >> 3) & 0xF <= 9], np.uint8)
    out = []
    for _ in range(2):
        u8 = codes[rng.integers(0, len(codes), shape)]
        xj = jnp.asarray(u8).view(jnp.float8_e4m3fn)
        out.append((xj, tensor_from_numpy(np.asarray(xj), "cpu")))
    return out


@pytest.mark.parametrize("kind,scales", [("int8", (1 / 16, 1 / 16)), ("float8_e4m3fn", (0.5, 0.25))])
@pytest.mark.parametrize("qdt", ["f32", "bf16"])
def test_paged_decode_quantized_pools(rng, kind, scales, qdt):
    """int8 / fp8 pools with per-tensor k/v scales: q * k_scale and the
    fresh rows / scale round to q's dtype, the output is scaled again
    (paged_decode_dma.py:392-405, :498-499); f32 q holds the twin to the
    kernel tightly, bf16 q adds the Pallas kernel's bf16 probabilities."""
    b, hq, hkv, d, page = 4, 8, 2, 32, 16
    lengths = [1, 37, 0, 2 * page + 5]
    jdt = jnp.float32 if qdt == "f32" else jnp.bfloat16
    table, [_, _, (qj, qt), (fkj, fkt), (fvj, fvt)] = paged_case(rng, b, hq, hkv, d, page, lengths, jdt=jdt)
    n_pages = b * (table.shape[1]) + 1
    (kj, kt), (vj, vt) = quant_pools(rng, kind, (2, n_pages, hkv, page, d))
    ks, vs = scales
    lens = np.array(lengths, np.int32)
    ref = jdec.paged_attention_decode_dma(qj, kj, vj, jnp.asarray(lens), jnp.asarray(table), k_scale=ks,
                                          v_scale=vs, layer_id=1, fresh_k=fkj, fresh_v=fvj, chunk_pages=2)
    out = tatt.paged_attention_decode_dma(qt, kt, vt, torch.from_numpy(lens), torch.from_numpy(table), k_scale=ks,
                                          v_scale=vs, layer_id=1, fresh_k=fkt, fresh_v=fvt)
    assert out.dtype == qt.dtype
    close(ref, out, **(F32 if qdt == "f32" else BF16))


def fp8_table(kind):
    """The value of each of the 256 codes from the format's definition."""
    vals = []
    for b in range(256):
        sign = -1.0 if b & 0x80 else 1.0
        if kind == "e4m3":
            e, m = (b >> 3) & 0xF, b & 7
            v = np.nan if (e == 15 and m == 7) else (m / 8 * 2.0 ** -6 if e == 0 else (1 + m / 8) * 2.0 ** (e - 7))
        else:
            e, m = (b >> 2) & 0x1F, b & 3
            if e == 31:
                v = np.inf if m == 0 else np.nan
            else:
                v = m / 4 * 2.0 ** -14 if e == 0 else (1 + m / 4) * 2.0 ** (e - 15)
        vals.append(sign * v)
    return np.array(vals, np.float32)


@pytest.mark.parametrize("kind", ["e4m3", "e5m2"])
def test_fp8_codes_convert_exactly(kind):
    """The port reads fp8 pools by exact conversion, denormals and NaN
    included; interop carries the JAX (ml_dtypes) bytes unchanged. The JAX
    upcast differs on denormals and NaN codes by design, so parity inputs
    avoid those."""
    codes = np.arange(256, dtype=np.uint8)
    tdt, jdt = ((torch.float8_e4m3fn, jnp.float8_e4m3fn) if kind == "e4m3"
                else (torch.float8_e5m2, jnp.float8_e5m2))
    vals = torch.from_numpy(codes).view(tdt).float().numpy()
    np.testing.assert_array_equal(vals, fp8_table(kind))
    carried = tensor_from_numpy(np.asarray(jnp.asarray(codes).view(jdt)), "cpu")
    assert carried.dtype == tdt
    np.testing.assert_array_equal(carried.view(torch.uint8).numpy(), codes)


@pytest.mark.parametrize("grid", [1, 7, 132, 396, 528])
@pytest.mark.parametrize("case", [
    # lengths, table width, page, splits, window
    ([1 + (1055 * i) // 15 for i in range(16)], 128, 64, 1, None),  # the engine's ragged B=16
    ([32768], 512, 64, 16, None),                                       # B=1 x 32,768 split 16 ways
    ([0, 1, 63, 64, 65, 1056, 32768], 513, 64, 1, None),                # empty, page edges, long
    ([5, 300, 70, 1], 20, 16, 3, 100),                                  # 16-token pages, splits, window
    ([129, 2000], 16, 128, 2, None),                                    # pages of 128, capped by the table
])
def test_decode_work_units_cover_each_token_once(case, grid):
    """The card kernel's division of work (``work_units`` mirrors what the
    kernel computes on the device): the blocks' unit ranges tile all units
    in order; every (split, sequence, head) run's units cover its pool
    tokens [lo, hi) once, each unit inside one 64-token chunk; the blocks
    that share a run are the ones whose ranges meet it, and their partial
    slots never collide (a block's first shared run in slot 0, its last in
    slot 1)."""
    lengths, n_blocks, page, splits, window = case
    hkv = 2
    ns, st = tatt.paged_decode_dma.split_geometry(n_blocks, page, hkv, 1, splits)
    units, blocks, runs = tatt.paged_decode_dma.work_units(lengths, n_blocks, page, ns, st, hkv=hkv, grid=grid,
                                                           window=window)
    total = hkv * sum(u[3] for u in units)
    assert len(blocks) == min(grid, total)
    assert blocks[0][0] == 0 and blocks[-1][1] == total
    assert all(c0 < c1 for c0, c1 in blocks)  # no block without a unit: each one counts as a contributor
    assert all(blocks[c][1] == blocks[c + 1][0] for c in range(len(blocks) - 1))
    used = {}
    u = 0
    for i, (lo, hi, j0, n) in enumerate(units):
        s, b = divmod(i, len(lengths))
        n_tok = max(0, min(lengths[b] - 1, n_blocks * page))
        want = set(range(max(s * st if ns > 1 else 0, lengths[b] - window if window else 0),
                         min(n_tok, (s + 1) * st if ns > 1 else n_tok)))
        for h in range(hkv):
            covered = []
            for j in range(n):
                c0, c1 = (j0 + j) * 64, (j0 + j + 1) * 64
                covered += range(max(lo, c0), min(hi, c1))
            assert sorted(covered) == sorted(want)
            cf, cl, slots = runs[(i, h)]
            owners = [c for c in range(len(blocks)) if blocks[c][0] < u + n and blocks[c][1] > u]
            assert owners == list(range(cf, cl + 1))
            for c, slot in zip(range(cf, cl + 1), slots):
                assert (c, slot) not in used
                used[(c, slot)] = (i, h)
            u += n
    assert u == total
