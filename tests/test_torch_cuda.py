"""The port's hand-written kernels against their plain PyTorch twins on the
card, over the options and edge cases the serving path's shapes in
chip_smoke.py do not reach: the wgmma flash tile of K7 / K9 at the 64-row
and 64-key tile edges, at S = 4,096 and with NaN in every row it must not
read; K12's wgmma tile (bm 64 / 128) over expert runs of 1, 2 and 9 row
blocks, interleaved experts, model widths, the stacked bank's last layer
and expert, and NaN in the padding rows it must not read; K6's parallel
copy bit for bit against the in-order twin at 1, 16, 64 (over 8 slots) and
1,040 tokens; other head dims and GQA groups, page sizes,
padding rows, duplicate and dropped slots, extend offsets, non-causal
attention, the base-2 lse and rows that see no key, packed prefill at block
edges with padding blocks, widths that are not powers of two, quantized KV
pools, head-major pools (K8), split-KV, sinks, window, soft cap and the
lse of the decode, and every option, row count, group size and ragged width
of the W4A16 GEMMs (K1 and the decode-bucket K10); the NSA indexer (K15) over key types, scales, head counts and
lengths; the streaming MLA decode (K13b, on K13a's kernel: length-0 rows
with lse -inf over every pool type and width, lse on and off, splits) and
its dispatch; the blockwise-fp8
GEMMs (K17, K18: row tiles, split K, compact and prepared scales, every
e4m3 code), the QServe per-group GEMM (K19: groups, ragged M / N / K, scale
types; the int8 route bit for bit on QServe-made weights, the exact route
where W8 leaves int8 or K reaches 2^17, split plans, one launch a call and
graph replay), K7 / K9's launches counted by head dim, the vertical + slash sparse prefill (K16's wgmma tile: head dims,
bn, GQA 4:1, causal, soft cap, lse, empty rows, blocks past S, kv lengths,
a column inside a slash block, ids at and past kv_len, NaN past kv_len
unread, B = 2 through the varlen wrapper, one launch a call and two calls
bit-equal) and the
library GEMMs around them (int8 / fp8 scaled_mm, the per-channel QServe GEMM,
w4a8_grouped_mm on K11), and the engine's decode step as a CUDA graph
(replays bit-equal to eager steps on three engines, a burst graph's tokens,
the launch tally, a capture that cannot succeed raising).

Needs a CUDA device: every test here is marked ``cuda`` and skips without
one. On the card (tests/conftest.py imports JAX, which that machine need not
have, so it is skipped):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sgl_kernel_tpu_torch.ops import kvcache, norm, rope
from sgl_kernel_tpu_torch.ops import moe
from sgl_kernel_tpu_torch.ops.attention import (flash_packed, flash_prefill, nsa, paged_decode, paged_decode_dma,
                                               sparse_vs)
from sgl_kernel_tpu_torch.ops.gemm import blockwise_fp8, qserve, scaled_mm, w4a16, w4a16_dma
from sgl_kernel_tpu_torch.utils import row_tile, sm_count

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def assert_kernel_close(out, ref):
    # both sides compute in float32 and round once to the output type;
    # another summation order moves a bf16 output by at most an ulp or two
    # (2^-7 relative to the largest output); float32 outputs by ~1e-5
    tol = (2.0 ** -7 if out.dtype == torch.bfloat16 else 1e-5) * max(1.0, float(ref.float().abs().max()))
    err = float((out.float() - ref.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("shape", [(1, 4096), (7, 96), (3, 5, 256), (33, 1000)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gemma", [False, True])
def test_rmsnorm(gen, shape, dtype, gemma):
    x, w = randn(gen, *shape, dtype=dtype), randn(gen, shape[-1], dtype=dtype)
    before = norm.rmsnorm.launches
    out = norm.rmsnorm(x, w, 1e-5, gemma=gemma)
    assert norm.rmsnorm.launches == before + 1
    assert_kernel_close(out, norm.rmsnorm_ref(x, w, 1e-5, gemma=gemma))


@pytest.mark.parametrize("nq,nkv,d,rot", [(32, 8, 128, 128), (8, 2, 64, 32), (4, 4, 96, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_decode_fused_qkv(gen, nq, nkv, d, rot, dtype):
    b = 5
    cache = rope.compute_cos_sin_cache(rot, 512, 500000.0, device="cuda")
    pos = torch.randint(0, 512, (b,), generator=gen, device="cuda", dtype=torch.int32)
    qkv = randn(gen, b, (nq + 2 * nkv) * d, dtype=dtype)
    kw = dict(num_q=nq, num_kv=nkv, head_dim=d)
    out = rope.rope_decode_fused_qkv(pos, qkv, cache, **kw)
    ref = rope.rope_decode_fused_qkv_ref(pos, qkv, cache, **kw)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert_kernel_close(o, r)
    assert torch.equal(out[2], ref[2])  # v is a copy


@pytest.mark.parametrize("hq,hkv,d,rot", [(32, 8, 128, 128), (8, 2, 64, 32), (4, 4, 128, 64), (16, 2, 64, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_decode_fused(gen, hq, hkv, d, rot, dtype):
    """K4 on split q and k: head dims 64 and 128, rot below D (the tail
    passes through unchanged), a padding row at position 0."""
    b = 6
    cache = rope.compute_cos_sin_cache(rot, 8192, 1e6, device="cuda")
    pos = torch.randint(0, 8192, (b,), generator=gen, device="cuda", dtype=torch.int32)
    pos[-1] = 0
    q, k = randn(gen, b, hq, d, dtype=dtype), randn(gen, b, hkv, d, dtype=dtype)
    before = rope.rope_decode_fused.launches
    out = rope.rope_decode_fused(pos, q, k, cache)
    assert rope.rope_decode_fused.launches == before + 1
    ref = rope.rope_decode_fused_ref(pos, q, k, cache)
    for o, r, x in zip(out, ref, (q, k)):
        assert o.shape == x.shape and o.dtype == x.dtype
        assert_kernel_close(o, r)
        assert torch.equal(o[..., rot:], x[..., rot:])


def paged_case(gen, b, hq, hkv, d, page, lengths, n_layers):
    n_blocks = max(1, -(-max(lengths) // page)) + 1
    n_pages = b * n_blocks + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = torch.zeros((b, n_blocks), dtype=torch.int32, device="cuda")
    for i, n in enumerate(lengths):
        used = -(-n // page)
        table[i, :used] = perm[i * n_blocks: i * n_blocks + used]
    shape = (n_layers, n_pages, hkv, page, d)
    return (table, torch.tensor(lengths, dtype=torch.int32, device="cuda"), randn(gen, *shape),
            randn(gen, *shape), randn(gen, b, hq, d), randn(gen, b, hkv, d), randn(gen, b, hkv, d))


@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 4), (32, 8), (16, 2)])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("fresh", [True, False])
def test_paged_decode(gen, hq, hkv, d, page, fresh):
    lengths = [1, 0, 37, 3 * page + 5, 300]  # a length-0 engine padding row
    b = len(lengths)
    table, lens, kp, vp, q, fk, fv = paged_case(gen, b, hq, hkv, d, page, lengths, n_layers=3)
    kw = dict(layer_id=2, fresh_k=fk, fresh_v=fv) if fresh else dict(layer_id=2)
    out = paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, table, **kw)
    ref = paged_decode_dma.paged_attention_decode_ref(q, kp, vp, lens, table, **kw)
    assert torch.isfinite(out).all()
    assert_kernel_close(out, ref)
    if fresh:  # the padding row sees only its fresh row
        assert torch.equal(out[1], fv[1].repeat_interleave(hq // hkv, dim=0))
    else:
        assert not out[1].any()


def test_paged_decode_unstacked_pools_and_raises(gen):
    """Unstacked pools; the options (window, softcap, lse, splits) run the
    kernel; what it does not take raises."""
    table, lens, kp, vp, q, fk, fv = paged_case(gen, 2, 8, 2, 128, 64, [70, 5], n_layers=1)
    out = paged_decode_dma.paged_attention_decode_dma(q, kp[0], vp[0], lens, table, fresh_k=fk, fresh_v=fv)
    ref = paged_decode_dma.paged_attention_decode_ref(q, kp[0], vp[0], lens, table, fresh_k=fk, fresh_v=fv)
    assert_kernel_close(out, ref)
    for kw in (dict(sliding_window=8), dict(logit_soft_cap=5.0), dict(num_splits=2, chunk_pages=1)):
        out = paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, table, **kw)
        assert_kernel_close(out, paged_decode_dma.paged_attention_decode_ref(q, kp, vp, lens, table, **kw))
    o, lse = paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, table, return_lse=True)
    ro, rl = paged_decode_dma.paged_attention_decode_ref(q, kp, vp, lens, table, return_lse=True)
    assert_kernel_close(o, ro)
    assert_lse_close(lse, rl)
    with pytest.raises(NotImplementedError):  # float32 q
        paged_decode_dma.paged_attention_decode_dma(q.float(), kp, vp, lens, table)
    with pytest.raises(ValueError):  # head dim 96
        paged_decode_dma.paged_attention_decode_dma(q[..., :96].contiguous(), kp[..., :96].contiguous(),
                                                    vp[..., :96].contiguous(), lens, table)
    with pytest.raises(ValueError):
        paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, table, layout="ragged")


def assert_lse_close(lse, ref):
    """Base-2 lse: -inf where the twin has -inf, else within 1e-4 (float32
    sums in another order)."""
    inf = torch.isneginf(ref)
    assert torch.equal(torch.isneginf(lse), inf)
    assert float((lse[~inf] - ref[~inf]).abs().max().nan_to_num(0.0)) <= 1e-4


def head_major(pool):
    """[L, P, Hkv, page, D] -> the same pool head-major [L, Hkv, P, page, D]."""
    return pool.transpose(1, 2).contiguous()


@pytest.mark.parametrize("layout", ["page", "head"])
@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("splits", [2, 3, 0])
def test_paged_decode_splits(gen, layout, fresh, splits):
    """Split-KV on the card: each split a block, partials rounded to bf16
    and merged; length-0 rows (o = 0, lse -inf without a fresh row; only the
    fresh row with one) and a row shorter than a split. splits=0 takes
    choose_num_splits at the card's SM count (B=4, a 4,096-token row)."""
    hq, hkv, d, page = 32, 8, 128, 64
    lengths = [0, 4096, 70, 3]
    b = len(lengths)
    table, lens, kp, vp, q, fk, fv = paged_case(gen, b, hq, hkv, d, page, lengths, n_layers=2)
    if layout == "head":
        kp, vp = head_major(kp), head_major(vp)
    n = splits or paged_decode_dma.choose_num_splits(b, max(lengths), page, 1, num_cores=sm_count(0))
    assert n > 1
    kw = dict(layer_id=1, num_splits=n, chunk_pages=1, return_lse=True, layout=layout)
    if fresh:
        kw.update(fresh_k=fk, fresh_v=fv)
    o, lse = paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, table, **kw)
    ro, rl = paged_decode_dma.paged_attention_decode_ref(q, kp, vp, lens, table, **kw)
    assert torch.isfinite(o).all()
    assert_kernel_close(o, ro)
    assert_lse_close(lse, rl)
    if fresh:
        assert torch.equal(o[0], fv[0].repeat_interleave(hq // hkv, dim=0))
    else:
        assert not o[0].any() and torch.isneginf(lse[0]).all()


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("window", [16, 100000])
def test_paged_decode_sinks_window_softcap(gen, splits, window):
    """Sinks with the lse (the sink joins the last split), a window shorter
    and one longer than every context, the soft cap, GQA group 4."""
    hq, hkv, d, page = 16, 4, 128, 16
    lengths = [300, 1, 45]
    table, lens, kp, vp, q, fk, fv = paged_case(gen, 3, hq, hkv, d, page, lengths, n_layers=1)
    sinks = torch.randn(hq, generator=gen, device="cuda")
    kw = dict(sliding_window=window, logit_soft_cap=30.0, return_lse=True, num_splits=splits, chunk_pages=1,
              fresh_k=fk, fresh_v=fv)
    o, lse = paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, table, sinks, **kw)
    ro, rl = paged_decode_dma.paged_attention_decode_ref(q, kp, vp, lens, table, sinks, **kw)
    assert_kernel_close(o, ro)
    assert_lse_close(lse, rl)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (8, 8, 64), (16, 2, 256)])
def test_paged_attention_decode_head_major(gen, dtype, hq, hkv, d):
    """K8 against its twin over stacked head-major pools, with scales for
    fp8, and against K5 over the page-major transpose: one kernel, the same
    bits. Its launches count apart from K5's."""
    lengths = [1, 0, 37, 200]
    table, lens, kp, vp, q, fk, fv = paged_case(gen, 4, hq, hkv, d, 16, lengths, n_layers=3)
    kh, vh = head_major(kp).to(dtype), head_major(vp).to(dtype)
    kw = dict(layer_id=2, fresh_k=fk, fresh_v=fv, return_lse=True)
    if dtype != torch.bfloat16:
        kw.update(k_scale=0.5, v_scale=0.25)
    before5, before8 = paged_decode_dma.paged_attention_decode_dma.launches, paged_decode.paged_attention_decode.launches
    o, lse = paged_decode.paged_attention_decode(q, kh, vh, lens, table, **kw)
    assert paged_decode.paged_attention_decode.launches == before8 + 1
    ro, rl = paged_decode.paged_attention_decode_ref(q, kh, vh, lens, table, **kw)
    assert_kernel_close(o, ro)
    assert_lse_close(lse, rl)
    o5, l5 = paged_decode_dma.paged_attention_decode_dma(q, kh.transpose(1, 2).contiguous(),
                                                         vh.transpose(1, 2).contiguous(), lens, table, **kw)
    assert paged_decode_dma.paged_attention_decode_dma.launches == before5 + 1
    assert torch.equal(o, o5) and torch.equal(lse, l5)


def test_store_cache_head_major(gen):
    """The head-major store on the card equals it on the CPU (a copy)."""
    h, p, page, d = 8, 6, 16, 128
    kp, vp = randn(gen, 2, h, p, page, d), randn(gen, 2, h, p, page, d)
    k, v = randn(gen, 5, h, d), randn(gen, 5, h, d)
    loc = torch.tensor([3, -1, 40, p * page, 95], dtype=torch.int32, device="cuda")
    kc, vc = kp.cpu(), vp.cpu()
    kvcache.store_cache_head_major(k, v, kp[1], vp[1], loc)
    kvcache.store_cache_head_major(k.cpu(), v.cpu(), kc[1], vc[1], loc.cpu())
    assert torch.equal(kp.cpu(), kc) and torch.equal(vp.cpu(), vc)


@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.bfloat16, 32), (torch.float32, 64)])
def test_store_cache_all_layers(gen, page, dtype, d):
    l, p, h = 4, 6, 2
    kp, vp = randn(gen, l, p, h, page, d, dtype=dtype), randn(gen, l, p, h, page, d, dtype=dtype)
    kp2, vp2 = kp.clone(), vp.clone()
    # dropped (-1), out of range (P*page), a slot written twice (later wins)
    loc = torch.tensor([5, -1, p * page, 2 * page + 3, 5, p * page - 1], dtype=torch.int32, device="cuda")
    ka, va = randn(gen, l, 6, h, d, dtype=dtype), randn(gen, l, 6, h, d, dtype=dtype)
    kvcache.store_cache_all_layers(ka, va, kp, vp, loc)
    kvcache.store_cache_all_layers_ref(ka, va, kp2, vp2, loc)
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    assert torch.equal(kp[:, 0, :, 5], ka[:, 4])


@pytest.mark.parametrize("t,n_slots", [(1, 64), (16, 64), (64, 8), (1040, 700)])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.float32, 64), (torch.int8, 128)])
def test_store_cache_all_layers_parallel(gen, t, n_slots, dtype, d):
    """K6's parallel copy bit for bit equal to the in-order twin: one token;
    a decode step; 64 tokens over 8 slots (every slot written several
    times); a mixed step's 1,040 tokens with duplicates, -1 and
    out-of-range slots; bf16, float32 and 1-byte rows."""
    l, p, h, page = 4, 64, 2, 16
    def draw(*shape):
        if dtype == torch.int8:
            return torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        return randn(gen, *shape, dtype=dtype)
    kp, vp = draw(l, p, h, page, d), draw(l, p, h, page, d)
    kp2, vp2 = kp.clone(), vp.clone()
    loc = torch.randint(0, n_slots, (t,), generator=gen, device="cuda", dtype=torch.int32)
    drop = torch.rand(t, generator=gen, device="cuda")
    loc[drop < 0.05] = -1
    loc[(drop >= 0.05) & (drop < 0.08)] = p * page
    ka, va = draw(l, t, h, d), draw(l, t, h, d)
    kvcache.store_cache_all_layers(ka, va, kp, vp, loc)
    kvcache.store_cache_all_layers_ref(ka, va, kp2, vp2, loc)
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    # the last token holding a valid slot is the one that landed there
    lc = loc.tolist()
    last = max((i for i, s in enumerate(lc) if 0 <= s < p * page), default=None)
    if last is not None:
        s = lc[last]
        assert torch.equal(vp[:, s // page, :, s % page], va[:, last])


@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (4, 4, 64), (8, 1, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ragged(gen, hq, hkv, d, causal):
    b, s = 3, 200
    q, k, v = randn(gen, b, s, hq, d), randn(gen, b, s, hkv, d), randn(gen, b, s, hkv, d)
    ql = torch.tensor([200, 77, 1], dtype=torch.int32, device="cuda")
    out = flash_prefill.flash_attention(q, k, v, ql, ql, causal=causal)
    ref = flash_prefill.flash_attention_ref(q, k, v, ql, ql, causal=causal)
    assert torch.isfinite(out).all()
    for i, n in enumerate(ql.tolist()):
        assert_kernel_close(out[i, :n], ref[i, :n])


def test_flash_extend_offsets(gen):
    """Queries as the last q_len of kv_len (Sq != Skv), then explicit
    q_start / kv_start."""
    b, sq, skv, hq, hkv, d = 2, 70, 150, 8, 2, 128
    q, k, v = randn(gen, b, sq, hq, d), randn(gen, b, skv, hkv, d), randn(gen, b, skv, hkv, d)
    ql = torch.tensor([70, 33], dtype=torch.int32, device="cuda")
    kl = torch.tensor([150, 90], dtype=torch.int32, device="cuda")
    qs = torch.tensor([100, 57], dtype=torch.int32, device="cuda")
    ks = torch.tensor([0, 3], dtype=torch.int32, device="cuda")
    for extra in ((), (None, qs, ks)):
        out = flash_prefill.flash_attention(q, k, v, ql, kl, *extra, causal=True)
        ref = flash_prefill.flash_attention_ref(q, k, v, ql, kl, *extra, causal=True)
        for i, n in enumerate(ql.tolist()):
            assert_kernel_close(out[i, :n], ref[i, :n])


EMPTY_LSE = -1e30 * flash_prefill.LOG2E


def is_empty_lse(lse):
    """The lse of a row that sees no key, -1e30 * log2(e), to a float32 ulp
    (the product is rounded once in float32 on either side)."""
    return bool(torch.allclose(lse, torch.full_like(lse, EMPTY_LSE), rtol=1e-6, atol=0.0))


@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2)])
def test_flash_lse_and_keyless_rows(gen, hq, hkv):
    """K7's lse [B, Hq, Sq] against the twin: the prefix pass of an extend
    (every row sees all prefix keys), a sequence with an empty prefix (its
    rows see no key: o = 0 and lse -1e30 * log2(e)), and the fresh pass at
    global offsets."""
    b, sq, skv, d = 3, 130, 200, 128
    q, k, v = randn(gen, b, sq, hq, d), randn(gen, b, skv, hkv, d), randn(gen, b, skv, hkv, d)
    ql = torch.tensor([130, 65, 7], dtype=torch.int32, device="cuda")
    pre = torch.tensor([200, 0, 33], dtype=torch.int32, device="cuda")
    zero = torch.zeros_like(pre)
    for args in ((ql, pre, None, pre, zero), (ql, ql, None, pre, pre)):
        out, lse = flash_prefill.flash_attention(q, k, v, *args, causal=True, return_lse=True)
        ref, ref_lse = flash_prefill.flash_attention_ref(q, k, v, *args, causal=True, return_lse=True)
        assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32 and torch.isfinite(lse).all()
        for i, n in enumerate(ql.tolist()):
            assert_kernel_close(out[i, :n], ref[i, :n])
            assert_elementwise(lse[i, :, :n], ref_lse[i, :, :n])
    out, lse = flash_prefill.flash_attention(q, k, v, ql, pre, None, pre, zero, causal=True, return_lse=True)
    assert not out[1].any() and is_empty_lse(lse[1])


def packed_inputs(gen, lens, hq, hkv, d, n_pad_blocks=0, block=256):
    """Packed q/k/v of causal self-attention over ``lens`` and the engine's
    metadata: padding blocks on an empty pseudo-sequence row."""
    seq_meta, meta = flash_packed.make_seq_meta(lens, block=block)
    blk_seq, blk_q0 = meta["blk_seq"], meta["blk_q0"]
    if n_pad_blocks:
        seq_meta = np.concatenate([seq_meta, np.array([[0, 0, 0, 0, 0, 1]], np.int32)])
        blk_seq = np.concatenate([blk_seq, np.full(n_pad_blocks, len(lens), np.int32)])
        blk_q0 = np.concatenate([blk_q0, np.zeros(n_pad_blocks, np.int32)])
    tp = meta["total_q"] + n_pad_blocks * block
    ints = [torch.from_numpy(a).cuda() for a in (blk_seq, blk_q0, seq_meta)]
    return (randn(gen, tp, hq, d), randn(gen, tp, hkv, d), randn(gen, tp, hkv, d)), ints, meta


def check_packed(qkv, ints, meta, lens, max_kvb, hq, block=256):
    before = flash_packed.flash_attention_packed.launches
    out, lse = flash_packed.flash_attention_packed(*qkv, *ints, max_kvb=max_kvb, return_lse=True, block=block)
    assert flash_packed.flash_attention_packed.launches == before + 1
    ref, ref_lse = flash_packed.flash_attention_packed_ref(*qkv, *ints, max_kvb=max_kvb, return_lse=True,
                                                           block=block)
    assert lse.shape == (hq, qkv[0].shape[0]) and torch.isfinite(out).all() and torch.isfinite(lse).all()
    for t0, n in zip(meta["seq_tok0"].tolist(), lens):
        assert_elementwise(out[t0: t0 + n], ref[t0: t0 + n])
        assert_elementwise(lse[:, t0: t0 + n], ref_lse[:, t0: t0 + n])
    # rows that see no key (past q_len, padding blocks): zeros and the twin's lse
    seen = torch.zeros(qkv[0].shape[0], dtype=torch.bool, device="cuda")
    for t0, n in zip(meta["seq_tok0"].tolist(), lens):
        seen[t0: t0 + n] = True
    assert not out[~seen].any() and is_empty_lse(lse[:, ~seen])


@pytest.mark.parametrize("n", [1, 255, 256, 257])
@pytest.mark.parametrize("hq,hkv,d", [(8, 8, 128), (8, 2, 64), (32, 4, 128)])
def test_packed_single_sequence(gen, n, hq, hkv, d):
    """One sequence at the 256-token block edges, GQA groups 1, 4 and 8."""
    qkv, ints, meta = packed_inputs(gen, [n], hq, hkv, d)
    check_packed(qkv, ints, meta, [n], meta["max_kvb"], hq)


@pytest.mark.parametrize("d", [64, 128])
def test_packed_ragged_batch_padding_blocks(gen, d):
    """The engine's layout: a ragged batch, the block count padded to a
    power of two with blocks on the empty pseudo-sequence, and max_kvb a
    power of two above every sequence's kv block count."""
    lens = [16, 300, 1, 777, 256, 90]
    qkv, ints, meta = packed_inputs(gen, lens, 32, 8, d, n_pad_blocks=3)
    check_packed(qkv, ints, meta, lens, 8, 32)


def test_packed_extend_offsets_and_raises(gen):
    """Extend metadata (q the last q_len of kv_len, explicit kv_start),
    non-causal attention, and the options the kernel does not take."""
    q_lens, kv_lens = [40, 300], [500, 300]
    seq_meta, meta = flash_packed.make_seq_meta(q_lens, kv_lens, kv_start=[0, 7])
    ints = [torch.from_numpy(a).cuda() for a in (meta["blk_seq"], meta["blk_q0"], seq_meta)]
    q = randn(gen, meta["total_q"], 8, 128)
    k, v = randn(gen, meta["total_kv"], 2, 128), randn(gen, meta["total_kv"], 2, 128)
    for causal in (True, False):
        out = flash_packed.flash_attention_packed(q, k, v, *ints, max_kvb=meta["max_kvb"], causal=causal)
        ref = flash_packed.flash_attention_packed_ref(q, k, v, *ints, max_kvb=meta["max_kvb"], causal=causal)
        for t0, n in zip(meta["seq_tok0"].tolist(), q_lens):
            assert_elementwise(out[t0: t0 + n], ref[t0: t0 + n])
    for kw in (dict(sliding_window=64), dict(logit_soft_cap=5.0), dict(sinks=torch.zeros(8, device="cuda"))):
        with pytest.raises(NotImplementedError):
            flash_packed.flash_attention_packed(q, k, v, *ints, max_kvb=meta["max_kvb"], **kw)
        with pytest.raises(NotImplementedError):
            flash_prefill.flash_attention(q[None], k[None], v[None], **kw)


def check_flash(q, k, v, lens, causal):
    """K7 with lse against the twin on each sequence's valid rows; returns
    the kernel's (out, lse)."""
    ql, kl, qs, ks = lens
    before = flash_prefill.flash_attention.launches
    out, lse = flash_prefill.flash_attention(q, k, v, ql, kl, None, qs, ks, causal=causal, return_lse=True)
    assert flash_prefill.flash_attention.launches == before + 1
    ref, ref_lse = flash_prefill.flash_attention_ref(q, k, v, ql, kl, None, qs, ks, causal=causal, return_lse=True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    for i, n in enumerate(ql.tolist()):
        assert_elementwise(out[i, :n], ref[i, :n])
        assert_elementwise(lse[i, :, :n], ref_lse[i, :, :n])
    return out, lse


def int_lens(*rows):
    return [torch.tensor(r, dtype=torch.int32, device="cuda") for r in rows]


@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tile_lengths(gen, n, d, hq, hkv, causal):
    """The wgmma tile at the 64-row / 64-key tile edges: sequence 0 attends
    n queries over n keys, sequence 1 n queries as the last n of n + 70 keys
    (Sq != Skv), sequence 2 n queries over a 1-key prefix at explicit
    offsets; GQA groups 1, 4 and 8."""
    sq, skv = n + 3, n + 70
    q, k, v = randn(gen, 3, sq, hq, d), randn(gen, 3, skv, hkv, d), randn(gen, 3, skv, hkv, d)
    lens = int_lens([n, n, n], [n, n + 70, 1], [0, 70, 5], [0, 0, 5])
    check_flash(q, k, v, lens, causal)


@pytest.mark.parametrize("block", [64, 192, 256])
def test_packed_block_sizes(gen, block):
    """K9 at packed blocks of 1, 3 and 4 q tiles, 64 heads, a ragged batch
    and padding blocks."""
    lens = [block + 5, 3 * block, 17, 2 * block - 1]
    qkv, ints, meta = packed_inputs(gen, lens, 64, 8, 128, n_pad_blocks=2, block=block)
    check_packed(qkv, ints, meta, lens, meta["max_kvb"], 64, block=block)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tile_long(gen, d, causal):
    """S = 4,096 (64 key tiles through the two-stage ring) beside a
    sequence of 4,000 queries over 4,095 keys."""
    s = 4096
    q, k, v = randn(gen, 2, s, 8, d), randn(gen, 2, s, 2, d), randn(gen, 2, s, 2, d)
    check_flash(q, k, v, int_lens([s, 4000], [s, 4095], [0, 95], [0, 0]), causal)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_keys_past_kv_len_unread(gen, d, causal):
    """k / v rows at or past kv_len filled with NaN give the same output and
    lse, bit for bit, as those rows zeroed: the tile neither reads nor
    attends them (the extend's prefix pass, an edge tile, a 1-key prefix,
    an empty one)."""
    sq, skv = 100, 300
    q, k, v = randn(gen, 4, sq, 8, d), randn(gen, 4, skv, 2, d), randn(gen, 4, skv, 2, d)
    lens = int_lens([100, 100, 70, 33], [256, 130, 1, 0], [256, 130, 1, 0], [0, 0, 0, 0])
    filled = []
    for fill in (0.0, float("nan")):
        kf, vf = k.clone(), v.clone()
        for i, n in enumerate(lens[1].tolist()):
            kf[i, n:], vf[i, n:] = fill, fill
        filled.append((kf, vf))
    out0, lse0 = check_flash(q, *filled[0], lens, causal)
    # the twin's 0 * NaN would poison its own rows, so the NaN call is held
    # to the zero-filled one
    out1, lse1 = flash_prefill.flash_attention(q, *filled[1], *lens[:2], None, *lens[2:], causal=causal,
                                               return_lse=True)
    assert torch.equal(out0, out1) and torch.equal(lse0, lse1)
    assert not out1[3].any() and is_empty_lse(lse1[3])


@pytest.mark.parametrize("d", [64, 128])
def test_packed_padding_unread(gen, d):
    """K9 over the engine's layout with every padding row (past a
    sequence's length, in q, k and v) and every padding block filled with
    NaN: the output and lse equal, bit for bit, those with zeros there."""
    lens = [16, 300, 1, 777, 65]
    qkv, ints, meta = packed_inputs(gen, lens, 16, 4, d, n_pad_blocks=3)
    valid = torch.zeros(qkv[0].shape[0], dtype=torch.bool, device="cuda")
    for t0, n in zip(meta["seq_tok0"].tolist(), lens):
        valid[t0: t0 + n] = True
    runs = []
    for fill in (0.0, float("nan")):
        filled = [x.clone() for x in qkv]
        for x in filled:
            x[~valid] = fill
        before = flash_packed.flash_attention_packed.launches
        runs.append(flash_packed.flash_attention_packed(*filled, *ints, max_kvb=8, return_lse=True))
        assert flash_packed.flash_attention_packed.launches == before + 1
    (out0, lse0), (out1, lse1) = runs
    assert torch.equal(out0, out1) and torch.equal(lse0, lse1)
    check_packed(qkv, ints, meta, lens, 8, 16)


@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn, torch.float8_e5m2])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (8, 2, 64), (16, 8, 256)])
@pytest.mark.parametrize("fresh", [True, False])
def test_paged_decode_quantized_pools(gen, dtype, hq, hkv, d, fresh):
    """1-byte pools converted in registers, k/v scales folded into q and the
    output, the fresh rows divided by them."""
    lengths = [1, 0, 37, 133, 300]
    table, lens, kp, vp, q, fk, fv = paged_case(gen, len(lengths), hq, hkv, d, 64, lengths, n_layers=2)
    if dtype == torch.int8:
        kp = torch.randint(-127, 128, kp.shape, generator=gen, device="cuda", dtype=torch.int32).to(dtype)
        vp = torch.randint(-127, 128, vp.shape, generator=gen, device="cuda", dtype=torch.int32).to(dtype)
        ks = vs = 1 / 16
    else:
        kp, vp = (kp.float() * 4).to(dtype), (vp.float() * 4).to(dtype)
        ks, vs = 0.5, 0.25
    kw = dict(layer_id=1, k_scale=ks, v_scale=vs)
    if fresh:
        kw.update(fresh_k=fk, fresh_v=fv)
    out = paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, table, **kw)
    ref = paged_decode_dma.paged_attention_decode_ref(q, kp, vp, lens, table, **kw)
    assert torch.isfinite(out).all()
    assert_elementwise(out, ref)


def assert_elementwise(out, ref):
    """|out - ref| <= 2^-7 |ref| + 2^-12 max|ref row|: both sides compute in
    float32 and round once, so they may land one output ulp apart; the
    row term covers float32 sums taken in another order near zero."""
    o, r = out.float(), ref.float()
    tol = 2.0 ** -7 * r.abs() + 2.0 ** -12 * r.abs().amax(-1, keepdim=True)
    assert ((o - r).abs() <= tol).all(), float(((o - r).abs() / tol).max())


def w4_case(gen, m, n, k, gs, option=None, layers=3):
    """(a, w, scales, kwargs) of one W4A16 call."""
    bf = torch.bfloat16
    kw = dict(group_size=gs)
    stacked = option in ("layer_id", "norm_stacked", "fused_gate_up")
    if option in ("mxfp4", "mxfp4_zeros"):
        kw.update(fmt="mxfp4")
        w = torch.randint(0, 256, (k // 2, n), generator=gen, device="cuda", dtype=torch.int32).to(torch.uint8)
        s = torch.exp2(torch.randint(-8, -3, (k // gs, n), generator=gen, device="cuda").float()).to(bf)
        if option == "mxfp4_zeros":  # the contract applies z*s for either format
            kw["zeros"] = (s.float() * torch.randn(s.shape, generator=gen, device="cuda")).to(bf)
        return randn(gen, m, k), w, s, kw
    kk = k - 40 if option == "padded_k" else k
    qs = [w4a16.quantize_w4(torch.randn((n, kk), generator=gen, device="cuda") * 0.05 + 0.01, group_size=gs,
                            symmetric=option != "zeros") for _ in range(layers if stacked else 1)]
    w, s = (torch.stack([q[0] for q in qs]), torch.stack([q[1] for q in qs])) if stacked else qs[0][:2]
    a = randn(gen, m, kk)
    if option == "zeros":
        kw["zeros"] = qs[0][2]
    elif option == "bias":
        kw["bias"] = randn(gen, n, dtype=torch.float32)
    elif option == "a2_silu":
        kw.update(a2=randn(gen, m, k), prologue="silu_mul")
    elif option == "fused_gate_up":
        a = randn(gen, m, 2 * k)
        kw.update(prologue="silu_mul", fused_gate_up=True, layer_id=1, residual=randn(gen, m, n))
    elif option == "residual":
        kw["residual"] = randn(gen, m, n)
    elif option == "norm":
        a = randn(gen, m, k) * 3
        kw["norm_weight"] = randn(gen, k)
    elif option == "norm_stacked":
        kw.update(norm_weight=randn(gen, layers, k), layer_id=2)
    elif option == "layer_id":
        kw["layer_id"] = 2
    elif option == "f32_out":
        kw["out_dtype"] = torch.float32
    return a, w, s, kw


def check_w4(a, w, s, kw):
    before = w4a16.w4a16_gemm.launches
    out = w4a16.w4a16_gemm(a, w, s, **kw)
    assert w4a16.w4a16_gemm.launches == before + 1
    ref = w4a16.w4a16_gemm_ref(a, w, s, **kw)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.isfinite(out).all()
    assert_elementwise(out, ref)


@pytest.mark.parametrize("option", ["mxfp4", "mxfp4_zeros", "zeros", "bias", "a2_silu", "fused_gate_up",
                                    "residual", "norm", "norm_stacked", "layer_id", "padded_k", "f32_out"])
@pytest.mark.parametrize("m", [16, 100])
def test_w4a16_options(gen, option, m):
    """Every option of the contract, at a decode and a prefill row count."""
    check_w4(*w4_case(gen, m, 384, 512, 32 if option.startswith("mxfp4") else 64, option))


@pytest.mark.parametrize("m", [1, 16, 32, 33, 1000])
@pytest.mark.parametrize("gs", [32, 64, 128])
def test_w4a16_rows_and_groups(gen, m, gs):
    """Both decode tiles (M <= 16, <= 32), the prefill tile past 32 rows,
    ragged row tiles; each group size the kernel is built for."""
    check_w4(*w4_case(gen, m, 320, 1024, gs, "norm" if m <= 32 else "a2_silu"))


@pytest.mark.parametrize("n", [200, 1000, 4104])
@pytest.mark.parametrize("m", [5, 70])
def test_w4a16_ragged_columns(gen, n, m):
    """N not a multiple of the 128- or 64-column tile; N=200 and 1000 are
    not multiples of 16 either, so the weight and scale rows take the
    masked byte loads."""
    check_w4(*w4_case(gen, m, n, 256, 64, "zeros"))


def test_w4a16_split_k(gen):
    """Few column tiles: K splits across blocks in whole groups and a
    second pass sums the partials, adds bias and residual, and casts."""
    m, n, k, gs = 16, 256, 8192, 128
    tile, split, per = w4a16.plan(m, n, k, gs, sm_count(0))
    assert split > 1 and (split - 1) * per < k // gs
    a, w, s, kw = w4_case(gen, m, n, k, gs, "residual")
    kw["bias"] = randn(gen, n, dtype=torch.float32)
    check_w4(a, w, s, kw)


def test_w4a16_unsupported_raise(gen):
    a, w, s, kw = w4_case(gen, 8, 256, 512, 64)
    with pytest.raises(NotImplementedError):
        w4a16.w4a16_gemm(a.float(), w, s, **kw)
    with pytest.raises(NotImplementedError):
        w4a16.w4a16_gemm(a, w, s, out_dtype=torch.float16, **kw)
    with pytest.raises(NotImplementedError):
        w4a16.w4a16_gemm(a, w, s.float(), **kw)
    a, w, s, _ = w4_case(gen, 8, 256, 512, 256)
    with pytest.raises(NotImplementedError):
        w4a16.w4a16_gemm(a, w, s, group_size=256)


# K1 at M > 32 on the wgmma tile (csrc/w4a16_wgmma.cu): the row counts of
# the main path (extends and wave B, mixed steps near 1,040, ragged tiles)
WG_M = [33, 64, 200, 257, 1024, 1040]


def check_wgmma(a, w, s, kw):
    """One call on the wgmma tile (counted on its route), against the twin."""
    before = w4a16.w4a16_gemm.launches_by_route["wgmma"]
    check_w4(a, w, s, kw)
    assert w4a16.w4a16_gemm.launches_by_route["wgmma"] == before + 1


@pytest.mark.parametrize("option", [None, "norm", "a2_silu", "fused_gate_up", "residual", "bias", "zeros", "mxfp4",
                                    "mxfp4_zeros", "f32_out", "padded_k", "layer_id"])
@pytest.mark.parametrize("m", WG_M)
def test_w4a16_wgmma_options(gen, option, m):
    """Every option at each row count; N = 400 leaves the second column
    tile's second code box past N (its columns never stored)."""
    check_wgmma(*w4_case(gen, m, 400, 1024, 32 if option and option.startswith("mxfp4") else 64, option))


@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("m", WG_M)
def test_w4a16_wgmma_groups(gen, gs, m):
    """Each group size (a promotion every 2, 4 or 8 k16 steps)."""
    check_wgmma(*w4_case(gen, m, 768, 2048, gs, "residual"))


@pytest.mark.parametrize("m", [33, 64, 200])
def test_w4a16_wgmma_split_k(gen, m):
    """Few tiles: K splits over blocks in whole stages and the last block of
    a tile sums the partials in split order, adds bias and residual, casts;
    two calls give the same bits."""
    n, k, gs = 256, 8192, 128
    _, split, per = w4a16.wgmma_plan(m, n, k, sm_count(0))
    assert split > 1 and (split - 1) * per < k // 128 <= split * per
    a, w, s, kw = w4_case(gen, m, n, k, gs, "residual")
    kw["bias"] = randn(gen, n, dtype=torch.float32)
    check_wgmma(a, w, s, kw)
    assert torch.equal(w4a16.w4a16_gemm(a, w, s, **kw), w4a16.w4a16_gemm(a, w, s, **kw))


@pytest.mark.parametrize("option", [None, "norm", "zeros"])
def test_w4a16_wgmma_graph_replay(gen, option):
    """A captured call (split K, and the rows pass with a prologue or zeros)
    replayed as the activations change in place: each replay equals the
    eager call bit for bit and agrees with the twin."""
    a, w, s, kw = w4_case(gen, 200, 512, 4096, 128, option)
    assert w4a16.wgmma_plan(200, 512, 4096, sm_count(0))[1] > 1
    fn = lambda: w4a16.w4a16_gemm(a, w, s, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(3):
        a.copy_(randn(gen, *a.shape) * (3 if option == "norm" else 1))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fn())
        assert_elementwise(out, w4a16.w4a16_gemm_ref(a, w, s, **kw))


@pytest.mark.parametrize("option,rows_pass", [(None, False), ("norm", True), ("fused_gate_up", True),
                                              ("zeros", True)])
def test_w4a16_wgmma_one_launch(gen, option, rows_pass):
    """A call is the tile's one launch, behind the rows pass where a
    prologue or zeros need it (a torch.profiler trace of four calls, which
    may miss the first kernel)."""
    a, w, s, kw = w4_case(gen, 1024, 512, 1024, 128, option)
    fn = lambda: w4a16.w4a16_gemm(a, w, s, **kw)
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    tiles = sum("w4a16_wgmma_kernel" in n for n in names)
    rows = sum("w4a16_rows_kernel" in n for n in names)
    assert tiles >= 3 and tiles + rows == len(names), names
    assert (tiles - 1 <= rows <= tiles) if rows_pass else rows == 0, names


def check_w4_dma(a, w, s, kw):
    before = w4a16_dma.w4a16_gemm_dma.launches
    out = w4a16_dma.w4a16_gemm_dma(a, w, s, **kw)
    assert w4a16_dma.w4a16_gemm_dma.launches == before + 1
    ref = w4a16_dma.w4a16_gemm_dma_ref(a, w, s, **kw)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.isfinite(out).all()
    assert_elementwise(out, ref)


@pytest.mark.parametrize("option", ["mxfp4", "mxfp4_zeros", "zeros", "bias", "a2_silu", "residual", "layer_id",
                                    "f32_out"])
@pytest.mark.parametrize("m", [1, 17, 32])
def test_w4a16_dma_options(gen, option, m):
    """K10: every option of its contract at 1, 17 and 32 rows (both row
    tiles); the residual is its own tensor, aliasing nothing."""
    check_w4_dma(*w4_case(gen, m, 384, 512, 32 if option.startswith("mxfp4") else 64, option))


@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("fmt", ["int4", "mxfp4"])
@pytest.mark.parametrize("n,k", [(4144, 1152), (208, 4096), (256, 14336)])
def test_w4a16_dma_shapes(gen, gs, fmt, n, k):
    """N not a multiple of the 128-column tile (the last tile's copies are
    shorter), K not a multiple of the 256-row ring stage (a stage of fewer
    groups), a long K split across blocks and summed by the second pass;
    each group size, both formats."""
    a, w, s, kw = w4_case(gen, 16, n, k, gs, "mxfp4" if fmt == "mxfp4" else "residual")
    kw["bias"] = randn(gen, n, dtype=torch.float32)
    check_w4_dma(a, w, s, kw)


def test_w4a16_dma_gate_up_slices(gen):
    """The model's down GEMM: gate and up as column slices of one [M, 2I]
    tensor (row stride 2I), silu_mul, a residual; stacked weights."""
    m, i, n = 16, 1024, 512
    gu = randn(gen, m, 2 * i)
    a, w, s, kw = w4_case(gen, m, n, i, 128, "layer_id")
    kw.update(a2=gu[:, i:], prologue="silu_mul", residual=randn(gen, m, n))
    check_w4_dma(gu[:, :i], w, s, kw)


def test_w4a16_dma_unsupported_raise(gen):
    a, w, s, kw = w4_case(gen, 8, 256, 512, 64)
    with pytest.raises(NotImplementedError):
        w4a16_dma.w4a16_gemm_dma(a.float(), w, s, **kw)
    with pytest.raises(NotImplementedError):
        w4a16_dma.w4a16_gemm_dma(a, w, s, out_dtype=torch.float16, **kw)
    a2, w2, s2, kw2 = w4_case(gen, 8, 200, 512, 64)  # N % 16: the tile kernel takes it, no raise
    check_w4_dma(a2, w2, s2, kw2)
    a3, w3, s3, _ = w4_case(gen, 8, 256, 512, 256)
    with pytest.raises(NotImplementedError):
        w4a16_dma.w4a16_gemm_dma(a3, w3, s3, group_size=256)
    with pytest.raises(ValueError):  # the decode bucket only
        w4a16_dma.w4a16_gemm_dma(randn(gen, 33, 512), w, s, **kw)


@pytest.mark.parametrize("option", [None, "a2_silu", "zeros", "bias", "residual", "mxfp4", "mxfp4_zeros",
                                    "layer_id", "f32_out"])
@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("m", [1, 2, 7, 16, 17, 31, 32])
def test_w4a16_dma_stream_core(gen, m, gs, option):
    """K10 on the streaming core: every row count of the decode bucket (both
    row tiles, 16 and 32), each group size, every prologue and option; N of
    two 256-column tiles and a 16-column one, K of 640: two 256-deep k blocks and a half one."""
    check_w4_dma(*w4_case(gen, m, 528, 640, gs, option))


@pytest.mark.parametrize("n", [200, 1000])
def test_w4a16_dma_ragged_n_takes_tile(gen, n):
    """N % 16 != 0, and weights that are a strided view: TMA cannot map the
    rows, so the tile kernel of w4a16_gemm.cu computes K10's function (one launch, the same
    contract), with silu_mul and a residual."""
    m, k = 16, 512
    a, w, s, kw = w4_case(gen, m, n, k, 64, "residual")
    kw.update(a2=randn(gen, m, k), prologue="silu_mul")
    check_w4_dma(a, w, s, kw)
    wide, sw, _ = w4a16.quantize_w4(torch.randn((2 * n, k), generator=gen, device="cuda") * 0.05, group_size=64)
    kw["residual"] = randn(gen, m, n)
    check_w4_dma(a, wide[:, ::2], sw[:, ::2], kw)


@pytest.mark.parametrize("m", [1, 16, 32])
def test_w4a16_dma_repeat_and_graph(gen, m):
    """Shared tiles are summed in block order by the last block to arrive:
    two calls give the same bits, and a CUDA graph replay gives the eager
    call's bits (gate_up-like: 112 tiles x 16 k blocks over the grid)."""
    a, w, s, kw = w4_case(gen, m, 28672, 4096, 128, "residual")
    fn = lambda: w4a16_dma.w4a16_gemm_dma(a, w, s, **kw)
    first = fn()
    assert torch.equal(first, fn())
    assert_elementwise(first, w4a16_dma.w4a16_gemm_dma_ref(a, w, s, **kw))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)


# ---------------------------------------------------------------------------
# MoE paths: K11 grouped W4A16 GEMM, K12 grouped bf16 GEMM; DeepSeek's K13a
# MLA decode, K14 MLA qkv prep, K7 / K9 at head dim 576
# ---------------------------------------------------------------------------

from sgl_kernel_tpu_torch.ops import moe  # noqa: E402
from sgl_kernel_tpu_torch.ops.attention import mla  # noqa: E402


def grouped_inputs(gen, *, bm, blocks, k, n, gs, e=6, layers=2, fmt="int4", zeros=False):
    bf = torch.bfloat16
    if fmt == "mxfp4":
        w = torch.randint(0, 256, (layers, e, k // 2, n), generator=gen, device="cuda", dtype=torch.int32).to(torch.uint8)
        s = torch.exp2(torch.randint(-8, -3, (layers, e, k // gs, n), generator=gen, device="cuda").float()).to(bf)
    else:
        qs = [w4a16.quantize_w4(torch.randn((e * n, k), generator=gen, device="cuda") * 0.05 + 0.01, group_size=gs,
                                symmetric=not zeros) for _ in range(layers)]
        w = torch.stack([q[0].reshape(k // 2, e, n).permute(1, 0, 2) for q in qs]).contiguous()
        s = torch.stack([q[1].reshape(k // gs, e, n).permute(1, 0, 2) for q in qs]).contiguous()
    z = None
    if zeros:
        z = (s.float() * torch.randn(s.shape, generator=gen, device="cuda")).to(bf)
    x = randn(gen, blocks * bm, k)
    eids = torch.randint(0, e, (blocks,), generator=gen, device="cuda", dtype=torch.int32)
    return x, w, s, z, eids


@pytest.mark.parametrize("bm", [16, 32, 64, 128])
@pytest.mark.parametrize("valid", ["none", "one", "all"])
def test_grouped_w4a16_blocks(gen, bm, valid):
    """Each alignment block size; 0, 1 and every block valid (the count is
    read on the device; padding rows are undefined and not compared)."""
    blocks = 5
    x, w, s, _, eids = grouped_inputs(gen, bm=bm, blocks=blocks, k=512, n=384, gs=128)
    nv = {"none": 0, "one": 1, "all": blocks}[valid]
    eids[nv:] = eids[max(nv - 1, 0)]
    nvt = torch.tensor(nv, dtype=torch.int32, device="cuda")
    before = moe.w4a16_grouped_mm.launches
    out = moe.w4a16_grouped_mm(x, w, s, eids, None, 1, nvt, bm=bm)
    assert moe.w4a16_grouped_mm.launches == before + 1
    ref = moe.w4a16_grouped_mm_ref(x, w, s, eids, None, 1, nvt, bm=bm)
    assert_elementwise(out[: nv * bm], ref[: nv * bm])


@pytest.mark.parametrize("option", ["k1408", "zeros", "mxfp4", "f32_out", "unstacked", "padded_k"])
def test_grouped_w4a16_options(gen, option):
    """K of 11 groups (V2-Lite's moe_intermediate 1408), zeros, mxfp4, a
    float32 output, an unstacked bank, and activations below the packed K."""
    k = 1408 if option in ("k1408", "padded_k") else 512
    gs = 32 if option == "mxfp4" else 128
    x, w, s, z, eids = grouped_inputs(gen, bm=16, blocks=6, k=k, n=256, gs=gs, fmt="mxfp4" if option == "mxfp4" else "int4",
                                      zeros=option == "zeros")
    kw = dict(bm=16, group_size=gs, fmt="mxfp4" if option == "mxfp4" else "int4")
    if option == "f32_out":
        kw["out_dtype"] = torch.float32
    lid = None if option == "unstacked" else 0
    wl, sl, zl = (w[0], s[0], None if z is None else z[0]) if lid is None else (w, s, z)
    if option == "padded_k":
        x = x[:, :1400]
    nv = torch.tensor(5, dtype=torch.int32, device="cuda")
    out = moe.w4a16_grouped_mm(x, wl, sl, eids, zl, lid, nv, **kw)
    ref = moe.w4a16_grouped_mm_ref(x, wl, sl, eids, zl, lid, nv, **kw)
    assert out.dtype == ref.dtype
    assert_elementwise(out[: 5 * 16], ref[: 5 * 16])


DECODE_EIDS = [0, 0, 3, 3, 3, 5, 1]  # neighbouring blocks of one expert, and a lone one


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("case", ["int4", "zeros", "mxfp4", "mxfp4_zeros", "f32_out", "per_channel", "last_expert",
                                  "unstacked", "k1408"])
def test_grouped_wgmma(gen, bm, case):
    """K11 at bm 64 / 128 on the wgmma tile: 5 of 7 row blocks valid (NaN in
    the padding rows reaches no valid row), each scale form (groups of 128,
    mxfp4 at 32, zeros, per-channel), a float32 output, layer L-1 and
    expert E-1 of a stacked bank, an unstacked bank, K of 11 groups; two
    calls give the same bits."""
    blocks, layers, e, valid = len(DECODE_EIDS), 3, 6, 5
    fmt = "mxfp4" if case.startswith("mxfp4") else "int4"
    gs = 32 if fmt == "mxfp4" else 128
    x, w, s, z, _ = grouped_inputs(gen, bm=bm, blocks=blocks, k=1408 if case == "k1408" else 512, n=400, gs=gs, e=e,
                                   layers=layers, fmt=fmt, zeros=case in ("zeros", "mxfp4_zeros"))
    ids = [e - 1, e - 1, 2, e - 1, 0, 4, 4] if case == "last_expert" else DECODE_EIDS
    eids = torch.tensor(ids, dtype=torch.int32, device="cuda")
    x[valid * bm:] = float("nan")
    nvt = torch.tensor(valid, dtype=torch.int32, device="cuda")
    lid = layers - 1 if case == "last_expert" else 1
    kw = dict(bm=bm, group_size=gs, fmt=fmt, out_dtype=torch.float32 if case == "f32_out" else torch.bfloat16)
    args = (x, w, s, eids, z, lid, nvt)
    if case == "unstacked":
        args = (x, w[lid], s[lid], eids, None, None, nvt)
    elif case == "per_channel":
        args = (x, w[lid], s[lid][:, :1].contiguous(), eids, None, None, nvt)
        kw["per_channel"] = True
    fn = lambda: moe.w4a16_grouped_mm(*args, **kw)
    before = dict(moe.w4a16_grouped_mm.launches_by_route)
    out = fn()
    assert moe.w4a16_grouped_mm.launches_by_route["wgmma"] == before["wgmma"] + 1
    ref = moe.w4a16_grouped_mm_ref(*args, **kw)
    rows = valid * bm
    assert out.dtype == ref.dtype and torch.isfinite(out[:rows]).all()
    assert_elementwise(out[:rows], ref[:rows])
    assert torch.equal(fn()[:rows], out[:rows])


@pytest.mark.parametrize("bm", [64, 128])
def test_grouped_wgmma_graph_num_valid(gen, bm):
    """One CUDA graph of K11 on the wgmma tile replayed as num_valid_blocks
    changes in place: each replay equals the eager call at that count bit
    for bit and agrees with the twin."""
    blocks = len(DECODE_EIDS)
    x, w, s, _, _ = grouped_inputs(gen, bm=bm, blocks=blocks, k=1408, n=2048, gs=128, e=6)
    eids = torch.tensor(DECODE_EIDS, dtype=torch.int32, device="cuda")
    nvt = torch.tensor(blocks, dtype=torch.int32, device="cuda")
    fn = lambda: moe.w4a16_grouped_mm(x, w, s, eids, None, 1, nvt, bm=bm)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for nv in (5, 1, 7, 0, 3):
        nvt.fill_(nv)
        graph.replay()
        torch.cuda.synchronize()
        rows = nv * bm
        assert torch.equal(out[:rows], fn()[:rows])
        assert_elementwise(out[:rows], moe.w4a16_grouped_mm_ref(x, w, s, eids, None, 1, nvt, bm=bm)[:rows])


@pytest.mark.parametrize("bm", [16, 32])
@pytest.mark.parametrize("valid", [0, 1, 7])
@pytest.mark.parametrize("gs,fmt,zeros", [(32, "int4", False), (64, "int4", True), (128, "int4", False),
                                          (128, "int4", True), (32, "mxfp4", False), (64, "mxfp4", True)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layer", ["first", "last"])
def test_grouped_decode_core(gen, bm, valid, gs, fmt, zeros, out_dtype, layer):
    """K11 at bm 16 / 32 on the streaming core: 0, 1 and every block valid
    (the count read on the device), an expert repeated over neighbouring
    blocks, each group, int4 and mxfp4 with and without zeros, bf16 and
    float32 out, layer 0 and L-1 of a stacked bank; NaN in the rows of the
    padding blocks reaches no valid row; two calls give the same bits."""
    blocks, layers = len(DECODE_EIDS), 3
    x, w, s, z, _ = grouped_inputs(gen, bm=bm, blocks=blocks, k=640, n=528, gs=gs, e=6, layers=layers, fmt=fmt,
                                   zeros=zeros)
    eids = torch.tensor(DECODE_EIDS, dtype=torch.int32, device="cuda")
    x[valid * bm:] = float("nan")
    nvt = torch.tensor(valid, dtype=torch.int32, device="cuda")
    lid = 0 if layer == "first" else layers - 1
    kw = dict(bm=bm, group_size=gs, fmt=fmt, out_dtype=out_dtype)
    fn = lambda: moe.w4a16_grouped_mm(x, w, s, eids, z, lid, nvt, **kw)
    before = moe.w4a16_grouped_mm.launches
    out = fn()
    assert moe.w4a16_grouped_mm.launches == before + 1
    ref = moe.w4a16_grouped_mm_ref(x, w, s, eids, z, lid, nvt, **kw)
    assert out.dtype == out_dtype
    rows = valid * bm
    assert torch.isfinite(out[:rows]).all()
    assert_elementwise(out[:rows], ref[:rows])
    assert torch.equal(fn()[:rows], out[:rows])


@pytest.mark.parametrize("bm", [16, 32])
def test_grouped_decode_graph_num_valid(gen, bm):
    """One CUDA graph captured once and replayed as num_valid_blocks changes
    in the same tensor: each replay computes the blocks the count names and
    equals the eager call at that count bit for bit."""
    blocks = len(DECODE_EIDS)
    x, w, s, _, _ = grouped_inputs(gen, bm=bm, blocks=blocks, k=1408, n=2048, gs=128, e=6)
    eids = torch.tensor(DECODE_EIDS, dtype=torch.int32, device="cuda")
    nvt = torch.tensor(blocks, dtype=torch.int32, device="cuda")
    fn = lambda: moe.w4a16_grouped_mm(x, w, s, eids, None, 1, nvt, bm=bm)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for nv in (5, 1, 7, 0, 3):
        nvt.fill_(nv)
        graph.replay()
        torch.cuda.synchronize()
        rows = nv * bm
        eager = fn()
        assert torch.equal(out[:rows], eager[:rows])
        assert_elementwise(out[:rows], moe.w4a16_grouped_mm_ref(x, w, s, eids, None, 1, nvt, bm=bm)[:rows])


def test_grouped_decode_whole_tiles_graph(gen):
    """V2-Lite's down widths (K 1,408, N 2,048: 8 tiles of 6 k blocks a row
    block) at up to 66 valid row blocks: one captured graph replayed at 66,
    40, 20 and 9 valid blocks, where the device's rule switches between
    every tile whole (66, 40) and stream-K with shared tiles (20, 9); each
    replay equals the eager call bit for bit and agrees with the twin."""
    blocks = 66
    x, w, s, _, eids = grouped_inputs(gen, bm=16, blocks=blocks, k=1408, n=2048, gs=128, e=8)
    eids = torch.sort(eids).values
    nvt = torch.tensor(blocks, dtype=torch.int32, device="cuda")
    fn = lambda: moe.w4a16_grouped_mm(x, w, s, eids, None, 1, nvt, bm=16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for nv in (66, 40, 20, 9):
        nvt.fill_(nv)
        graph.replay()
        torch.cuda.synchronize()
        rows = nv * 16
        assert torch.equal(out[:rows], fn()[:rows])
        assert_elementwise(out[:rows], moe.w4a16_grouped_mm_ref(x, w, s, eids, None, 1, nvt, bm=16)[:rows])


def test_w4a16_dma_whole_tiles(gen):
    """K10 over 264 column tiles of 2 k blocks: every block takes whole
    tiles (no shared tile, no merge), with bias and residual; two calls
    give the same bits."""
    a, w, s, kw = w4_case(gen, 16, 264 * 256, 512, 128, "residual")
    kw["bias"] = randn(gen, 264 * 256, dtype=torch.float32)
    check_w4_dma(a, w, s, kw)
    assert torch.equal(w4a16_dma.w4a16_gemm_dma(a, w, s, **kw), w4a16_dma.w4a16_gemm_dma(a, w, s, **kw))


def test_grouped_decode_routes_by_shape(gen, monkeypatch):
    """bm 16 / 32 over a mappable bank run the streaming core; bm 64 / 128
    the wgmma tile, per-channel scales too; a bank TMA cannot map (N % 16 !=
    0) and per-channel scales at bm 16 (w4a8_grouped_mm's form) run the tile
    kernel; each launches K11 once and agrees with the twin."""
    from sgl_kernel_tpu_torch.ops.moe import grouped_gemm

    taken = []
    for name in ("_entry", "_decode_entry", "_wgmma_entry"):
        real = getattr(grouped_gemm, name)
        monkeypatch.setattr(grouped_gemm, name, lambda real=real, name=name: (
            lambda *a: taken.append(name) or real()(*a)))
    nvt = torch.tensor(4, dtype=torch.int32, device="cuda")
    for n, bm, per_channel, route in ((256, 16, False, "_decode_entry"), (256, 32, False, "_decode_entry"),
                                      (256, 64, False, "_wgmma_entry"), (256, 128, True, "_wgmma_entry"),
                                      (200, 64, False, "_entry"), (200, 16, False, "_entry"),
                                      (256, 16, True, "_entry")):
        x, w, s, _, eids = grouped_inputs(gen, bm=bm, blocks=4, k=512, n=n, gs=128, e=4)
        if per_channel:
            args, kw = (x, w[1], s[1][:, :1].contiguous(), eids, None, None, nvt), dict(bm=bm, per_channel=True)
        else:
            args, kw = (x, w, s, eids, None, 1, nvt), dict(bm=bm)
        before = moe.w4a16_grouped_mm.launches
        out = moe.w4a16_grouped_mm(*args, **kw)
        assert moe.w4a16_grouped_mm.launches == before + 1 and taken[-1] == route
        assert_elementwise(out, moe.w4a16_grouped_mm_ref(*args, **kw))


def bf16_grouped_inputs(gen, *, bm, blocks, k, n, e=5, layers=None):
    lead = (layers, e) if layers else (e,)
    w = randn(gen, *lead, k, n) * (1.0 / k ** 0.5)
    x = randn(gen, blocks * bm, k)
    eids = torch.randint(0, e, (blocks,), generator=gen, device="cuda", dtype=torch.int32)
    return x, w.to(torch.bfloat16), eids


@pytest.mark.parametrize("bm", [16, 32, 64, 128])
@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("valid", [0, 1, 3, 5])
def test_grouped_bf16_blocks(gen, bm, stacked, valid):
    """K12 at each alignment block size, stacked (layer 1 of 2) and
    unstacked banks, 0, 1, 3 and all of 5 blocks valid (the count read on
    the device; padding rows are undefined and not compared); a ragged K
    and N tail (K 200, N 136 against the 64- and 128-wide tiles)."""
    blocks = 5
    x, w, eids = bf16_grouped_inputs(gen, bm=bm, blocks=blocks, k=200, n=136, layers=2 if stacked else None)
    eids[valid:] = eids[max(valid - 1, 0)]
    lid = 1 if stacked else None
    nvt = torch.tensor(valid, dtype=torch.int32, device="cuda")
    before = moe.bf16_grouped_mm.launches
    out = moe.bf16_grouped_mm(x, w, eids, lid, nvt, bm=bm)
    assert moe.bf16_grouped_mm.launches == before + 1
    ref = moe.bf16_grouped_mm_ref(x, w, eids, lid, nvt, bm=bm)
    assert_elementwise(out[: valid * bm], ref[: valid * bm])


@pytest.mark.parametrize("bm", [16, 128])
def test_grouped_bf16_f32_out(gen, bm):
    x, w, eids = bf16_grouped_inputs(gen, bm=bm, blocks=4, k=256, n=192, layers=3)
    out = moe.bf16_grouped_mm(x, w, eids, 2, 3, bm=bm, out_dtype=torch.float32)
    ref = moe.bf16_grouped_mm_ref(x, w, eids, 2, 3, bm=bm, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    # float32 outputs: sums of the same bf16 products in another order
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    assert float((out[: 3 * bm] - ref[: 3 * bm]).abs().max()) <= tol


@pytest.mark.parametrize("model,k,n,e", [("deepseek_gate_up", 2048, 2816, 4), ("deepseek_down", 1408, 2048, 4),
                                         ("mixtral_gate_up", 4096, 28672, 2), ("mixtral_down", 14336, 4096, 2)])
def test_grouped_bf16_model_widths(gen, model, k, n, e):
    """K12 at DeepSeek-V2-Lite's and Mixtral-8x7B's expert widths with a few
    experts: three blocks of 16 rows, two of them one expert's run."""
    x, w, eids = bf16_grouped_inputs(gen, bm=16, blocks=4, k=k, n=n, e=e)
    eids[:] = torch.tensor([1, 1, 0, 0], dtype=torch.int32)
    out = moe.bf16_grouped_mm(x, w, eids, None, 3, bm=16)
    assert_elementwise(out[:48], moe.bf16_grouped_mm_ref(x, w, eids, None, 3, bm=16)[:48])


# expert runs of 1, 2 and 9 consecutive row blocks (a raster group is 8 row
# tiles, so the run of 9 spans two), and an expert that comes back after
# others (interleaved)
WG_RUNS = [(3, 1), (0, 2), (4, 9), (1, 1), (0, 1), (2, 3)]


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("valid", [0, 5, 17])
def test_grouped_bf16_wgmma_runs(gen, bm, valid):
    """K12's wgmma tile (bm 64 and 128) and its expert-aware raster: expert
    runs of 1, 2 and 9 blocks, interleaved experts, 0, some and all of the
    17 blocks valid; N 384 is three 128-wide column tiles."""
    eids = torch.tensor([e for e, n in WG_RUNS for _ in range(n)], dtype=torch.int32, device="cuda")
    x, w, _ = bf16_grouped_inputs(gen, bm=bm, blocks=eids.numel(), k=512, n=384)
    nvt = torch.tensor(valid, dtype=torch.int32, device="cuda")
    out = moe.bf16_grouped_mm(x, w, eids, None, nvt, bm=bm)
    assert_elementwise(out[: valid * bm], moe.bf16_grouped_mm_ref(x, w, eids, None, nvt, bm=bm)[: valid * bm])


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("model,k,n,e", [("deepseek_gate_up", 2048, 2816, 4), ("deepseek_down", 1408, 2048, 4),
                                         ("mixtral_gate_up", 4096, 28672, 2), ("mixtral_down", 14336, 4096, 2)])
def test_grouped_bf16_model_widths_wgmma(gen, bm, model, k, n, e):
    """The wgmma tile at DeepSeek-V2-Lite's and Mixtral-8x7B's expert widths:
    three valid blocks, two of them one expert's run, one padding block."""
    x, w, eids = bf16_grouped_inputs(gen, bm=bm, blocks=4, k=k, n=n, e=e)
    eids[:] = torch.tensor([1, 1, 0, 0], dtype=torch.int32)
    out = moe.bf16_grouped_mm(x, w, eids, None, 3, bm=bm)
    assert_elementwise(out[: 3 * bm], moe.bf16_grouped_mm_ref(x, w, eids, None, 3, bm=bm)[: 3 * bm])


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_grouped_bf16_stacked_last_expert(gen, bm, out_dtype):
    """The stacked bank's last layer and last expert (the pointer offsets at
    their largest), a K / N tail, bf16 and float32 output."""
    x, w, eids = bf16_grouped_inputs(gen, bm=bm, blocks=3, k=264, n=200, e=7, layers=3)
    eids[:] = torch.tensor([6, 6, 0], dtype=torch.int32)
    out = moe.bf16_grouped_mm(x, w, eids, 2, 3, bm=bm, out_dtype=out_dtype)
    ref = moe.bf16_grouped_mm_ref(x, w, eids, 2, 3, bm=bm, out_dtype=out_dtype)
    assert out.dtype == out_dtype
    if out_dtype == torch.float32:  # sums of the same bf16 products in another order
        assert float((out - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))
    else:
        assert_elementwise(out, ref)


@pytest.mark.parametrize("bm", [16, 32, 64, 128])
def test_grouped_bf16_padding_unread(gen, bm):
    """Rows past num_valid * bm are never read: filled with NaN, the valid
    rows come out bit for bit as with zeros there."""
    x, w, eids = bf16_grouped_inputs(gen, bm=bm, blocks=6, k=384, n=256)
    x[4 * bm:] = 0
    out = moe.bf16_grouped_mm(x, w, eids, None, 4, bm=bm)
    x[4 * bm:] = float("nan")
    out_nan = moe.bf16_grouped_mm(x, w, eids, None, 4, bm=bm)
    assert torch.equal(out[: 4 * bm], out_nan[: 4 * bm])
    assert_elementwise(out[: 4 * bm], moe.bf16_grouped_mm_ref(x, w, eids, None, 4, bm=bm)[: 4 * bm])


@pytest.mark.parametrize("t", [5, 70])
def test_fused_experts_unstacked_bf16(gen, t):
    """fused_experts on unstacked bf16 banks goes through K12 at any token
    count on the card (the CPU takes ragged_dot's form above 64 tokens):
    both against the CPU's result on the same inputs."""
    e, h, inter = 8, 256, 128
    w1 = (randn(gen, e, h, 2 * inter) * (1 / h ** 0.5)).to(torch.bfloat16)
    w2 = (randn(gen, e, inter, h) * (1 / inter ** 0.5)).to(torch.bfloat16)
    x = randn(gen, t, h)
    tw, tids = moe.topk_softmax(torch.randn((t, e), generator=gen, device="cuda"), 2, renormalize=True)
    mw = moe.MoeWeights(w1=w1, w2=w2, fmt="bf16")
    before = moe.bf16_grouped_mm.launches
    out = moe.fused_experts(x, mw, tw, tids)
    assert moe.bf16_grouped_mm.launches == before + 2
    ref = moe.fused_experts(x.cpu(), moe.MoeWeights(w1=w1.cpu(), w2=w2.cpu(), fmt="bf16"), tw.cpu(), tids.cpu())
    # the intermediate rounds to bf16 before the second GEMM on both sides;
    # one ulp there moves the output by about an ulp of its row
    o, r = out.float().cpu(), ref.float()
    tol = 2.0 ** -7 * r.abs() + 2.0 ** -7 * r.abs().amax(-1, keepdim=True)
    assert ((o - r).abs() <= tol).all(), float(((o - r).abs() / tol).max())


def test_grouped_unported_raise(gen):
    """K12 raises on what its kernel does not take: float32 inputs, N or K
    not a multiple of 8, an alignment block of 8; K11 on a block of 8."""
    eids = torch.zeros(2, dtype=torch.int32, device="cuda")
    x = randn(gen, 32, 64)
    for xx, w, kw in ((x.float(), randn(gen, 4, 64, 32, dtype=torch.float32), dict(bm=16)),
                      (x, randn(gen, 4, 64, 36), dict(bm=16)),
                      (randn(gen, 32, 60), randn(gen, 4, 60, 32), dict(bm=16)),
                      (x, randn(gen, 4, 64, 32), dict(bm=8))):
        ids = eids if kw["bm"] == 16 else torch.zeros(4, dtype=torch.int32, device="cuda")
        with pytest.raises(NotImplementedError):
            moe.bf16_grouped_mm(xx, w, ids, **kw)
    with pytest.raises(NotImplementedError):
        moe.bf16_grouped_mm(x, randn(gen, 4, 64, 32), eids, bm=16, out_dtype=torch.float16)
    x, w, s, _, eids = grouped_inputs(gen, bm=16, blocks=2, k=256, n=128, gs=128)
    with pytest.raises(NotImplementedError):
        moe.w4a16_grouped_mm(x, w, s, eids, layer_id=0, bm=8)


def mla_pool(gen, lengths, page, width, layers, dtype):
    n_blocks = max(1, -(-max(lengths) // page))
    n_pages = len(lengths) * n_blocks + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = torch.zeros((len(lengths), n_blocks + 1), dtype=torch.int32, device="cuda")
    for i, n in enumerate(lengths):
        used = -(-n // page)
        table[i, :used] = perm[i * n_blocks: i * n_blocks + used]
    shape = (layers, n_pages, page, width)
    if dtype == torch.int8:
        pool = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int32).to(dtype)
    else:
        pool = (torch.randn(shape, generator=gen, device="cuda") * (4 if dtype != torch.bfloat16 else 0.5)).to(dtype)
    if width == 640:
        pool[..., 576:] = 0
    return pool, table, torch.tensor(lengths, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float8_e4m3fn, torch.float8_e5m2])
@pytest.mark.parametrize("width", [576, 640])
@pytest.mark.parametrize("page", [16, 64])
def test_mla_decode(gen, dtype, width, page):
    """Length 1, a length-0 padding row, lengths at and past page edges;
    the four pool dtypes converted exactly; 576- and 640-wide rows; lse."""
    lengths = [1, 0, page, page + 1, 3 * page - 1, 300]
    h = 16
    pool, table, lens = mla_pool(gen, lengths, page, width, 3, dtype)
    qn, qp = randn(gen, len(lengths), h, 512), randn(gen, len(lengths), h, 64)
    scale = 0.01 if dtype == torch.int8 else 1 / 576 ** 0.5
    before = mla.mla_decode.launches
    out, lse = mla.mla_decode(qn, qp, pool, lens, table, 2, sm_scale=scale, return_lse=True)
    assert mla.mla_decode.launches == before + 1
    ref, ref_lse = mla.mla_decode_ref(qn, qp, pool, lens, table, 2, sm_scale=scale, return_lse=True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert_elementwise(out, ref)
    assert torch.allclose(lse, ref_lse, rtol=1e-5, atol=1e-4)
    assert not out[1].any() and is_empty_lse(lse[1])


@pytest.mark.parametrize("h", [2, 16, 40])
def test_mla_decode_heads_and_splits(gen, h):
    """Head counts below, at and above one 16-row tile; num_splits=2 (the
    pseudo-sequence form merged by lse); an unstacked pool."""
    lengths = [5, 200, 64]
    pool, table, lens = mla_pool(gen, lengths, 64, 576, 1, torch.bfloat16)
    qn, qp = randn(gen, 3, h, 512), randn(gen, 3, h, 64)
    out = mla.mla_decode(qn, qp, pool[0], lens, table)
    assert_elementwise(out, mla.mla_decode_ref(qn, qp, pool[0], lens, table))
    # the JAX split form rounds each pseudo-sequence's output to bf16 before
    # the merge, on either device: held to the same form on the CPU (the twin
    # per split). One split landing one bf16 ulp apart (2^-8 of the row's
    # scale) reaches the merged value whatever its size, so the row term is
    # 2^-7 here.
    out = mla.mla_decode(qn, qp, pool[0], lens, table, num_splits=2).float()
    ref = mla.mla_decode(*(t.cpu() for t in (qn, qp, pool[0], lens, table)), num_splits=2).cuda().float()
    tol = 2.0 ** -7 * ref.abs() + 2.0 ** -7 * ref.abs().amax(-1, keepdim=True)
    assert ((out - ref).abs() <= tol).all(), float(((out - ref).abs() / tol).max())
    # engine="dma" takes K13b on this bf16 pool: against its twin
    before = mla.mla_decode_dma.launches
    out = mla.mla_decode(qn, qp, pool, lens, table, 0, engine="dma")
    assert mla.mla_decode_dma.launches == before + 1
    assert_elementwise(out, mla.mla_decode_dma_ref(qn, qp, pool, lens, table, 0))
    with pytest.raises(NotImplementedError):
        mla.mla_decode(qn.float(), qp.float(), pool, lens, table, 0)


@pytest.mark.parametrize("t", [1, 7, 16, 64])
def test_mla_qkv_prep(gen, t):
    nh, nope, rot, lat = 16, 128, 64, 512
    q, kv = randn(gen, t, nh, nope + rot), randn(gen, t, lat + rot) * 2
    w = randn(gen, 27, lat)
    cache = rope.compute_cos_sin_cache(rot, 4096, 10000.0, device="cuda")
    pos = torch.randint(0, 4096, (t,), generator=gen, device="cuda", dtype=torch.int32)
    before = rope.mla_qkv_prep.launches
    out = rope.mla_qkv_prep(pos, 26, q, kv, w, cache, nope_dim=nope, eps=1e-6)
    assert rope.mla_qkv_prep.launches == before + 1
    ref = rope.mla_qkv_prep_ref(pos, 26, q, kv, w, cache, nope_dim=nope, eps=1e-6)
    assert torch.equal(out[0], ref[0])
    for o, r in zip(out[1:], ref[1:]):
        assert_elementwise(o, r)


def mla_qkv(gen, b, s, skv, h=16):
    q = randn(gen, b, s, h, 576)
    kv = randn(gen, b, skv, 576)
    v = torch.nn.functional.pad(kv[..., :512], (0, 64))
    return q, kv[:, :, None].contiguous(), v[:, :, None].contiguous()


def halves(q):
    """q's latent and rope columns as the MLA entries take them."""
    return q[..., :512].contiguous(), q[..., 512:].contiguous()


@pytest.mark.parametrize("n", [1, 255, 256, 257])
def test_flash_576_causal(gen, n):
    """K7 at head dim 576 (the MLA prefill: 16 heads over one latent head,
    V zero past 512) at lengths around the 256 bucket, with lse."""
    q, k, v = mla_qkv(gen, 2, 264, 264)
    ql = torch.tensor([n, max(1, n // 3)], dtype=torch.int32, device="cuda")
    out, lse = flash_prefill.flash_attention(q, k, v, ql, ql, causal=True, sm_scale=0.06, return_lse=True)
    ref, ref_lse = flash_prefill.flash_attention_ref(q, k, v, ql, ql, causal=True, sm_scale=0.06, return_lse=True)
    assert torch.isfinite(out).all()
    for i, m in enumerate(ql.tolist()):
        assert_elementwise(out[i, :m], ref[i, :m])
        assert_elementwise(lse[i, :, :m], ref_lse[i, :, :m])


def test_flash_576_extend_and_keyless_rows(gen):
    """The two extend passes at 576: fresh rows causal at global offsets,
    then a prefix pass in which one sequence has no prefix (its rows see no
    key: o = 0, lse -1e30 * log2(e)); GQA groups 16 and 4."""
    for h in (16, 4):
        q, k, v = mla_qkv(gen, 2, 70, 130, h)
        ql = torch.tensor([70, 33], dtype=torch.int32, device="cuda")
        pre = torch.tensor([130, 0], dtype=torch.int32, device="cuda")
        zero = torch.zeros_like(pre)
        for args in ((ql, ql, None, pre, pre), (ql, pre, None, pre, zero)):
            out, lse = flash_prefill.flash_attention(q, k[:, :70] if args[1] is ql else k,
                                                     v[:, :70] if args[1] is ql else v, *args, causal=True,
                                                     return_lse=True)
            ref, ref_lse = flash_prefill.flash_attention_ref(q, k[:, :70] if args[1] is ql else k,
                                                             v[:, :70] if args[1] is ql else v, *args, causal=True,
                                                             return_lse=True)
            for i, m in enumerate(ql.tolist()):
                if args[1] is pre and i == 1:
                    assert not out[1].any() and is_empty_lse(lse[1])
                    continue
                assert_elementwise(out[i, :m], ref[i, :m])
                assert_elementwise(lse[i, :, :m], ref_lse[i, :, :m])


@pytest.mark.parametrize("n", [1, 255, 256, 257])
def test_packed_576_group16(gen, n):
    """K9 at head dim 576 with GQA group 16 over one KV head, at the block
    edges, beside a second sequence and padding blocks."""
    lens = [n, 90]
    qkv, ints, meta = packed_inputs(gen, lens, 16, 1, 576, n_pad_blocks=1)
    q, k, _ = qkv
    v = torch.nn.functional.pad(k[..., :512], (0, 64)).contiguous()
    check_packed((q, k, v), ints, meta, lens, 4, 16)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 63, 64, 65, 255, 257])
@pytest.mark.parametrize("h", [16, 4])
def test_flash_576_tile_rows(gen, n, h):
    """K7's 576 tile at q lengths whose 64-row tiles (4 positions of 16
    heads, or 16 of 4) straddle positions and the causal diagonal: sequence
    0 attends n queries over n keys, sequence 1 n queries as the last n of
    n + 70 keys (kv_len off the multiples of 64), with lse. The MLA form (V
    = K's first 512 columns, 512 wide) against its twin; the public form
    with a padded V equal to it, bit for bit, in the first 512 columns and
    zero past them."""
    q, k, v = mla_qkv(gen, 2, n, n + 70, h)
    ql, kl, qs, ks = int_lens([n, n], [n, n + 70], [0, 70], [0, 0])
    fa = flash_prefill.flash_attention
    before = (fa.launches, fa.launches_576)
    out, lse = flash_prefill.flash_attention_mla(*halves(q), k, ql, kl, qs, ks, causal=True, sm_scale=0.06, return_lse=True)
    assert (fa.launches, fa.launches_576) == (before[0] + 1, before[1] + 1)
    assert out.shape == (2, n, h, 512) and lse.shape == (2, h, n)
    ref, ref_lse = flash_prefill.flash_attention_mla_ref(*halves(q), k, ql, kl, qs, ks, causal=True, sm_scale=0.06,
                                                         return_lse=True)
    assert_elementwise(out, ref)
    assert_elementwise(lse, ref_lse)
    pub, pub_lse = flash_prefill.flash_attention(q, k, v, ql, kl, None, qs, ks, causal=True, sm_scale=0.06,
                                                 return_lse=True)
    assert torch.equal(pub[..., :512], out) and not pub[..., 512:].any() and torch.equal(pub_lse, lse)


@pytest.mark.parametrize("h", [16, 4])
def test_flash_576_prefix_pass_keyless_and_unread(gen, h):
    """The prefix pass of an extend at 576 in the MLA form: every query row
    sees its sequence's whole prefix (130 keys, 1, none: o = 0 and lse
    -1e30 * log2(e), padding rows too), and key rows at or past kv_len
    filled with NaN give the same output and lse, bit for bit, as those rows
    zeroed: the tile neither reads nor attends them."""
    q, k, _ = mla_qkv(gen, 3, 70, 130, h)
    ql, pre, zero = int_lens([70, 33, 5], [130, 1, 0], [0, 0, 0])
    runs = []
    for fill in (0.0, float("nan")):
        kf = k.clone()
        for i, m in enumerate(pre.tolist()):
            kf[i, m:] = fill
        runs.append(flash_prefill.flash_attention_mla(*halves(q), kf, ql, pre, pre, zero, causal=True, return_lse=True))
        if not runs[1:]:
            ref, ref_lse = flash_prefill.flash_attention_mla_ref(*halves(q), kf, ql, pre, pre, zero, causal=True,
                                                                 return_lse=True)
    (out, lse), (out1, lse1) = runs
    assert torch.equal(out, out1) and torch.equal(lse, lse1)
    for i, m in enumerate(ql.tolist()[:2]):
        assert_elementwise(out[i, :m], ref[i, :m])
        assert_elementwise(lse[i, :, :m], ref_lse[i, :, :m])
    assert not out[2].any() and is_empty_lse(lse[2])


@pytest.mark.parametrize("sq,prefix", [(1024, 0), (1024, 5120)])
def test_flash_576_long(gen, sq, prefix):
    """K7's 576 tile at the main path's long shapes in the MLA form with
    lse: a 1,024-token causal prefill, and wave D's last prefix pass (1,024
    queries over 5,120 prefix keys, all visible: 80 key tiles through the
    ring)."""
    q, k, _ = mla_qkv(gen, 1, sq, prefix or sq)
    if prefix:
        lens = int_lens([sq], [prefix], [prefix], [0])
    else:
        lens = int_lens([sq], [sq], [0], [0])
    out, lse = flash_prefill.flash_attention_mla(*halves(q), k, *lens, causal=True, return_lse=True)
    ref, ref_lse = flash_prefill.flash_attention_mla_ref(*halves(q), k, *lens, causal=True, return_lse=True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert_elementwise(out, ref)
    assert_elementwise(lse, ref_lse)


@pytest.mark.parametrize("h", [16, 4])
def test_packed_576_mla_form_padding(gen, h):
    """K9's 576 tile in the MLA form over the engine's layout (a ragged
    batch, padding blocks on the empty pseudo-sequence) against its twin;
    the public form with a padded V equal to it, bit for bit, in the first
    512 columns; NaN in every padding row of q and k and in every padding
    block changes nothing, bit for bit; rows that see no key give zeros and
    the twin's lse."""
    lens = [16, 300, 1, 777, 65]
    (q, k, _), ints, meta = packed_inputs(gen, lens, h, 1, 576, n_pad_blocks=3)
    valid = torch.zeros(q.shape[0], dtype=torch.bool, device="cuda")
    for t0, n in zip(meta["seq_tok0"].tolist(), lens):
        valid[t0: t0 + n] = True
    runs = []
    for fill in (0.0, float("nan")):
        qf, kf = q.clone(), k.clone()
        qf[~valid], kf[~valid] = fill, fill
        before = flash_packed.flash_attention_packed.launches_576
        runs.append(flash_packed.flash_attention_packed_mla(*halves(qf), kf, *ints, max_kvb=8, return_lse=True))
        assert flash_packed.flash_attention_packed.launches_576 == before + 1
        if not runs[1:]:
            qz, kz = qf, kf
    (out, lse), (out1, lse1) = runs
    assert torch.equal(out, out1) and torch.equal(lse, lse1)
    ref, ref_lse = flash_packed.flash_attention_packed_mla_ref(*halves(qz), kz, *ints, max_kvb=8, return_lse=True)
    for t0, n in zip(meta["seq_tok0"].tolist(), lens):
        assert_elementwise(out[t0: t0 + n], ref[t0: t0 + n])
        assert_elementwise(lse[:, t0: t0 + n], ref_lse[:, t0: t0 + n])
    assert not out[~valid].any() and is_empty_lse(lse[:, ~valid])
    v = torch.nn.functional.pad(kz[..., :512], (0, 64)).contiguous()
    pub, pub_lse = flash_packed.flash_attention_packed(qz, kz, v, *ints, max_kvb=8, return_lse=True)
    assert torch.equal(pub[..., :512], out) and not pub[..., 512:].any() and torch.equal(pub_lse, lse)


def test_576_two_calls_and_graph_replay_bit_equal(gen):
    """K7 (an extend's fresh pass at global offsets) and K9 (a packed batch
    with a padding block) at 576 in the MLA form: a second call and a
    CUDA-graph replay of both give the same bits."""
    q, k, _ = mla_qkv(gen, 1, 300, 700)
    lens = int_lens([300], [700], [400], [0])
    (pq, pk, _), ints, _ = packed_inputs(gen, [90, 600, 17], 16, 1, 576, n_pad_blocks=1)
    calls = [lambda: flash_prefill.flash_attention_mla(*halves(q), k, *lens, causal=True, return_lse=True),
             lambda: flash_packed.flash_attention_packed_mla(*halves(pq), pk, *ints, max_kvb=4, return_lse=True)]
    first = [t for c in calls for t in c()]
    again = [t for c in calls for t in c()]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [t for c in calls for t in c()]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, captured))


def test_mla_decode_unsplit_grid(gen):
    """A batch of 140 sequences, more runs than the card has SMs: the grid is
    the card's own (sm_count blocks, whatever the batch), most runs are
    whole in one block and the rest are merged by the last block to arrive
    (work_units' division), all against the twin."""
    lengths = [1 + (37 * i) % 200 for i in range(140)]
    pool, table, lens = mla_pool(gen, lengths, 16, 576, 1, torch.bfloat16)
    _, blocks, runs = mla.work_units(lengths, table.shape[1], 16, 16, sm_count(0))
    assert len(blocks) == sm_count(0)
    assert any(cf == cl for cf, cl, _ in runs.values()) and any(cf != cl for cf, cl, _ in runs.values())
    qn, qp = randn(gen, 140, 16, 512), randn(gen, 140, 16, 64)
    out, lse = mla.mla_decode(qn, qp, pool[0], lens, table, return_lse=True)
    ref, ref_lse = mla.mla_decode_ref(qn, qp, pool[0], lens, table, return_lse=True)
    assert_elementwise(out, ref)
    assert torch.allclose(lse, ref_lse, rtol=1e-5, atol=1e-4)


def uncovered_rows(table, lengths, page, n_pages):
    """[n_pages * page] True at every pool row no sequence's length covers
    (the rest of each last page, the pages no table holds)."""
    keep = torch.zeros(n_pages * page, dtype=torch.bool, device="cuda")
    for i, n in enumerate(lengths):
        t = torch.arange(n, device="cuda")
        keep[table[i, t // page].long() * page + t % page] = True
    return ~keep


def with_nan(x, rows):
    """A copy of ``x`` with NaN bits (int8: 127) in every row (its leading
    dims flattened to rows' length) where ``rows`` is set."""
    view, nan = {1: (torch.uint8, 0x7F), 2: (torch.int16, 0x7FC0), 4: (torch.int32, 0x7FC00000)}[x.element_size()]
    y = x.clone()
    y.view(view).view(rows.shape[0], -1)[rows] = nan
    return y


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("page,width", [(1, 576), (1, 640), (16, 576), (64, 640), (128, 576)])
def test_mla_decode_nan_past_lengths(gen, dtype, page, width):
    """One-row pages (NSA's view of the pool), 640-wide rows and pages of 16,
    64 and 128: NaN in every row past the lengths, in the pages no table
    holds and in the pad lanes of a 640-wide pool changes nothing, bit for
    bit; against the twin on the clean pool."""
    lengths = [1, 0, 63, 64, 65, 300]
    pool, table, lens = mla_pool(gen, lengths, page, width, 2, dtype)
    qn, qp = randn(gen, len(lengths), 16, 512), randn(gen, len(lengths), 16, 64)
    kw = dict(sm_scale=0.01 if dtype == torch.int8 else 1 / 576 ** 0.5, return_lse=True)
    out, lse = mla.mla_decode(qn, qp, pool, lens, table, 1, **kw)
    ref, ref_lse = mla.mla_decode_ref(qn, qp, pool, lens, table, 1, **kw)
    assert_elementwise(out, ref)
    assert torch.allclose(lse, ref_lse, rtol=1e-5, atol=1e-4)
    dirty = pool.clone()
    dirty[1] = with_nan(pool[1], uncovered_rows(table, lengths, page, pool.shape[1]))
    if width == 640:
        dirty[..., 576:] = with_nan(dirty[..., 576:].contiguous(), torch.ones(1, dtype=torch.bool, device="cuda"))
    out2, lse2 = mla.mla_decode(qn, qp, dirty, lens, table, 1, **kw)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)


@pytest.mark.parametrize("h", [1, 16, 32, 128])
@pytest.mark.parametrize("page", [1, 64])
def test_mla_decode_heads_bit_equal(gen, h, page):
    """H of 1, 16, 32 and 128 (one to eight head groups; DeepSeek-V3 has
    128) over B=16 contexts 1..1,056 on pages of 64 and on one-row pages:
    against the twin, and two calls bit-equal."""
    lengths = [1 + (1055 * i) // 15 for i in range(16)]
    pool, table, lens = mla_pool(gen, lengths, page, 576, 1, torch.bfloat16)
    qn, qp = randn(gen, 16, h, 512), randn(gen, 16, h, 64)
    out, lse = mla.mla_decode(qn, qp, pool, lens, table, 0, return_lse=True)
    ref, ref_lse = mla.mla_decode_ref(qn, qp, pool, lens, table, 0, return_lse=True)
    assert_elementwise(out, ref)
    assert torch.allclose(lse, ref_lse, rtol=1e-5, atol=1e-4)
    out2, lse2 = mla.mla_decode(qn, qp, pool, lens, table, 0, return_lse=True)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)


def replay_as_lengths_change(fn, lens, new_lengths):
    """One CUDA graph of ``fn`` captured once, replayed after each list of
    ``new_lengths`` is written into ``lens`` in place; yields (replayed,
    eager) outputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for new in new_lengths:
        lens.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        yield out, fn()


def test_mla_decode_graph_lengths(gen):
    """A captured graph replayed as the lengths change in place (longer,
    shorter, zero, all one) equals the eager call at those lengths bit for
    bit: the division of work is made on the device at every launch."""
    lengths = [1 + (1055 * i) // 15 for i in range(16)]
    pool, table, lens = mla_pool(gen, lengths, 64, 576, 2, torch.int8)
    qn, qp = randn(gen, 16, 16, 512), randn(gen, 16, 16, 64)
    fn = lambda: mla.mla_decode(qn, qp, pool, lens, table, 1, sm_scale=0.01, return_lse=True)
    news = [[n + 1 for n in lengths], lengths[::-1], [0] * 8 + lengths[8:], [1] * 16]
    for (out, lse), (eager, eager_lse) in replay_as_lengths_change(fn, lens, news):
        assert torch.equal(out, eager) and torch.equal(lse, eager_lse)


def mqa_case(gen, lengths, page, h, key_dtype, spare_cols=2):
    """Keys of ``lengths`` paged into a pool through a permuted table with
    ``spare_cols`` padding columns (page 0), q [B, H, 128] and positive
    head gates."""
    b, d = len(lengths), 128
    used = [-(-n // page) for n in lengths]
    n_blocks = max(used) + spare_cols
    n_pages = sum(used) + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = torch.zeros((b, n_blocks), dtype=torch.int32, device="cuda")
    at = 0
    for i, n in enumerate(used):
        table[i, :n] = perm[at: at + n]
        at += n
    keys = (torch.randn((n_pages, page, d), generator=gen, device="cuda") * 2).to(key_dtype)
    q = randn(gen, b, h, d) * 0.3
    w = torch.rand((b, h), generator=gen, device="cuda") + 0.05
    scales = torch.rand((n_pages, page), generator=gen, device="cuda") + 0.5
    return q, keys, w, scales, torch.tensor(lengths, dtype=torch.int32, device="cuda"), table


def check_logits(out, ref):
    """-inf at the same places; the finite logits elementwise (a row is one
    sequence's logits)."""
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref)) and not torch.isnan(out).any()
    fin = torch.isfinite(ref)
    assert_elementwise(torch.where(fin, out, 0.0), torch.where(fin, ref, 0.0))


@pytest.mark.parametrize("key_dtype", [torch.float8_e4m3fn, torch.float8_e5m2, torch.bfloat16])
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("h", [4, 40, 64, 128])
def test_fp8_paged_mqa_logits(gen, key_dtype, scaled, h):
    """K15: lengths 0 and 1, at and past page and 64-key tile edges, one
    not a multiple of a block's span; padded table columns; the four head
    tilings (16, 32, 64, 128 rows)."""
    lengths = [0, 1, 64, 65, 1000, 333]
    q, keys, w, scales, lens, table = mqa_case(gen, lengths, 64, h, key_dtype)
    sc = scales if scaled else None
    before = nsa.fp8_paged_mqa_logits.launches
    out = nsa.fp8_paged_mqa_logits(q, keys, w, lens, table, sc)
    assert nsa.fp8_paged_mqa_logits.launches == before + 1
    assert out.shape == (len(lengths), table.shape[1] * 64) and out.dtype == torch.float32
    check_logits(out, nsa.fp8_paged_mqa_logits_ref(q, keys, w, lens, table, sc))
    assert torch.isneginf(out[0]).all() and torch.isfinite(out[1, :1]).all()


@pytest.mark.parametrize("page", [1, 16, 64])
def test_fp8_paged_mqa_logits_pages_weights_and_q(gen, page):
    """Page sizes below, at and past a tile; [H] weights broadcast; fp8 q
    (upcast exactly); a batch wide enough for the one-tile span; and the
    inputs the kernel does not take raise."""
    lengths = [1 + (97 * i) % 300 for i in range(40)]
    q, keys, w, scales, lens, table = mqa_case(gen, lengths, page, 64, torch.float8_e4m3fn)
    out = nsa.fp8_paged_mqa_logits(q, keys, w[0], lens, table, scales)
    check_logits(out, nsa.fp8_paged_mqa_logits_ref(q, keys, w[0], lens, table, scales))
    q8 = (q.float() * 8).to(torch.float8_e4m3fn)
    check_logits(nsa.fp8_paged_mqa_logits(q8, keys, w, lens, table, scales),
                 nsa.fp8_paged_mqa_logits_ref(q8, keys, w, lens, table, scales))
    with pytest.raises(NotImplementedError):
        nsa.fp8_paged_mqa_logits(q[..., :64].contiguous(), keys[..., :64].contiguous(), w, lens, table)
    with pytest.raises(NotImplementedError):
        nsa.fp8_paged_mqa_logits(q.float(), keys.float(), w, lens, table)
    with pytest.raises(NotImplementedError):
        qq = randn(gen, len(lengths), 129, 128)
        nsa.fp8_paged_mqa_logits(qq, keys, torch.ones(129, device="cuda"), lens, table)


@pytest.mark.parametrize("kind", ["e4m3", "e5m2"])
def test_fp8_paged_mqa_logits_converts_every_code(gen, kind):
    """Every finite fp8 code at one lane, a one-hot q of +1 and -1: the
    logits are the codes' exact values (denormals not flushed)."""
    dt = torch.float8_e4m3fn if kind == "e4m3" else torch.float8_e5m2
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(dt)
    vals = codes.float()
    codes, vals = codes[torch.isfinite(vals)], vals[torch.isfinite(vals)]
    n = codes.numel()
    pool = torch.zeros((-(-n // 16) * 16, 128), dtype=torch.uint8)
    pool[:n, 7] = codes.view(torch.uint8)
    keys = pool.view(dt).reshape(-1, 16, 128).cuda()
    table = torch.arange(keys.shape[0], dtype=torch.int32, device="cuda")[None]
    for sign in (1.0, -1.0):
        q = torch.zeros((1, 1, 128), dtype=torch.bfloat16, device="cuda")
        q[0, 0, 7] = sign
        out = nsa.fp8_paged_mqa_logits(q, keys, torch.ones(1, device="cuda"),
                                       torch.tensor([n], dtype=torch.int32, device="cuda"), table)
        assert torch.equal(out[0, :n].cpu(), torch.clamp_min(sign * vals, 0.0))


@pytest.mark.parametrize("h", [1, 16, 64, 65, 128])
@pytest.mark.parametrize("key_dtype,page", [(torch.float8_e4m3fn, 64), (torch.bfloat16, 64), (torch.float8_e5m2, 1)])
def test_fp8_paged_mqa_logits_heads_nan_bit_equal(gen, h, key_dtype, page):
    """H of 1, 16, 64, 65 and 128 (one or two 64-head tiles): against the
    twin, two calls bit-equal, and NaN in every key row and scale past the
    lengths (and in the padding page) changes nothing, bit for bit."""
    lengths = [0, 1, 64, 65, 1000, 333]
    q, keys, w, scales, lens, table = mqa_case(gen, lengths, page, h, key_dtype)
    out = nsa.fp8_paged_mqa_logits(q, keys, w, lens, table, scales)
    check_logits(out, nsa.fp8_paged_mqa_logits_ref(q, keys, w, lens, table, scales))
    assert torch.equal(nsa.fp8_paged_mqa_logits(q, keys, w, lens, table, scales), out)
    rows = uncovered_rows(table, lengths, page, keys.shape[0])
    out2 = nsa.fp8_paged_mqa_logits(q, with_nan(keys, rows), w, lens, table, with_nan(scales, rows))
    assert torch.equal(out2, out)


def test_fp8_paged_mqa_logits_graph_lengths(gen):
    """The engine's decode shape (64 heads, B=16, contexts 1..1,056, tables
    of 8,192 tokens): a captured graph replayed as the lengths change in
    place equals the eager call bit for bit, the -inf tail included."""
    lengths = [1 + (1055 * i) // 15 for i in range(16)]
    q, keys, w, scales, lens, table = mqa_case(gen, lengths, 64, 64, torch.float8_e4m3fn, spare_cols=100)
    fn = lambda: nsa.fp8_paged_mqa_logits(q, keys, w, lens, table, scales)
    news = [[n + 64 for n in lengths], lengths[::-1], [0] * 8 + lengths[8:], [1] * 16]
    for out, eager in replay_as_lengths_change(fn, lens, news):
        assert torch.equal(out, eager)


@pytest.mark.parametrize("dtype,width", [(torch.bfloat16, 576), (torch.bfloat16, 640), (torch.int8, 640),
                                         (torch.float8_e4m3fn, 640), (torch.float8_e5m2, 640)])
@pytest.mark.parametrize("page", [16, 64])
def test_mla_decode_dma(gen, dtype, width, page):
    """K13b (engine="dma") on the pools it takes: lengths 0, 1, at and
    past page and tile edges; lse (-inf for the length-0 row)."""
    lengths = [1, 0, page, page + 1, 3 * page - 1, 300]
    pool, table, lens = mla_pool(gen, lengths, page, width, 3, dtype)
    qn, qp = randn(gen, len(lengths), 16, 512), randn(gen, len(lengths), 16, 64)
    scale = 0.01 if dtype == torch.int8 else 1 / 576 ** 0.5
    before, before_a = mla.mla_decode_dma.launches, mla.mla_decode.launches
    out, lse = mla.mla_decode(qn, qp, pool, lens, table, 2, sm_scale=scale, return_lse=True, engine="dma")
    assert mla.mla_decode_dma.launches == before + 1 and mla.mla_decode.launches == before_a
    ref, ref_lse = mla.mla_decode_dma_ref(qn, qp, pool, lens, table, 2, sm_scale=scale, return_lse=True)
    valid = lens > 0
    assert torch.isfinite(out).all() and not out[1].any() and torch.isneginf(lse[1]).all()
    assert_elementwise(out, ref)
    assert torch.allclose(lse[valid], ref_lse[valid], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("h", [2, 16, 40])
def test_mla_decode_dma_dispatch_and_splits(gen, h):
    """A one-byte 576-wide pool takes K13a under engine="dma" (JAX's rule);
    num_splits=2 recurses through K13b, held to the same split form on the
    CPU; an unstacked pool; the head counts around one 16-row tile."""
    lengths = [5, 200, 64]
    qn, qp = randn(gen, 3, h, 512), randn(gen, 3, h, 64)
    pool8, table, lens = mla_pool(gen, lengths, 64, 576, 1, torch.float8_e4m3fn)
    before, before_a = mla.mla_decode_dma.launches, mla.mla_decode.launches
    out = mla.mla_decode(qn, qp, pool8[0], lens, table, engine="dma")
    assert mla.mla_decode_dma.launches == before and mla.mla_decode.launches == before_a + 1
    assert_elementwise(out, mla.mla_decode_ref(qn, qp, pool8[0], lens, table))
    pool, table, lens = mla_pool(gen, lengths, 64, 576, 1, torch.bfloat16)
    out = mla.mla_decode(qn, qp, pool[0], lens, table, engine="dma")
    assert mla.mla_decode_dma.launches == before + 1
    assert_elementwise(out, mla.mla_decode_dma_ref(qn, qp, pool[0], lens, table))
    out = mla.mla_decode(qn, qp, pool[0], lens, table, num_splits=2, engine="dma").float()
    ref = mla.mla_decode(*(t.cpu() for t in (qn, qp, pool[0], lens, table)), num_splits=2,
                         engine="dma").cuda().float()
    assert mla.mla_decode_dma.launches == before + 2
    tol = 2.0 ** -7 * ref.abs() + 2.0 ** -7 * ref.abs().amax(-1, keepdim=True)  # as the K13a split test
    assert ((out - ref).abs() <= tol).all(), float(((out - ref).abs() / tol).max())
    with pytest.raises(NotImplementedError):
        mla.mla_decode_dma(qn.float(), qp.float(), pool, lens, table, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float8_e4m3fn, torch.float8_e5m2])
@pytest.mark.parametrize("width", [576, 640])
@pytest.mark.parametrize("return_lse", [True, False])
def test_mla_decode_dma_empty_rows(gen, dtype, width, return_lse):
    """K13b on K13a's kernel (mla_decode_dma called directly, so 1-byte
    576-wide pools too): length-0 rows give o = 0 and lse -inf, the others
    match the twin; layer_id 1 of a stacked pool; lse on and off; K13b's
    launch count moves and K13a's does not."""
    lengths = [0, 5, 0, 130, 64]
    pool, table, lens = mla_pool(gen, lengths, 64, width, 2, dtype)
    qn, qp = randn(gen, len(lengths), 16, 512), randn(gen, len(lengths), 16, 64)
    kw = dict(sm_scale=0.01 if dtype == torch.int8 else 1 / 576 ** 0.5, return_lse=return_lse)
    before, before_a = mla.mla_decode_dma.launches, mla.mla_decode.launches
    res = mla.mla_decode_dma(qn, qp, pool, lens, table, 1, **kw)
    assert mla.mla_decode_dma.launches == before + 1 and mla.mla_decode.launches == before_a
    ref = mla.mla_decode_dma_ref(qn, qp, pool, lens, table, 1, **kw)
    out, r_out = (res[0], ref[0]) if return_lse else (res, ref)
    assert not out[0].any() and not out[2].any() and torch.isfinite(out).all()
    assert_elementwise(out, r_out)
    if return_lse:
        lse, r_lse = res[1], ref[1]
        valid = lens > 0
        assert torch.isneginf(lse[~valid]).all() and torch.isfinite(lse[valid]).all()
        assert torch.allclose(lse[valid], r_lse[valid], rtol=1e-5, atol=1e-4)


def test_mla_decode_dma_splits_empty_rows(gen):
    """num_splits=2 under engine="dma" on a bf16 pool: one K13b launch for
    the pseudo-sequences, none of K13a; length-0 rows stay o = 0, lse -inf;
    the rest against the same split form on the CPU."""
    lengths = [0, 200, 64, 0, 1]
    pool, table, lens = mla_pool(gen, lengths, 64, 576, 2, torch.bfloat16)
    qn, qp = randn(gen, len(lengths), 16, 512), randn(gen, len(lengths), 16, 64)
    before, before_a = mla.mla_decode_dma.launches, mla.mla_decode.launches
    out, lse = mla.mla_decode(qn, qp, pool, lens, table, 1, num_splits=2, engine="dma", return_lse=True)
    assert mla.mla_decode_dma.launches == before + 1 and mla.mla_decode.launches == before_a
    ref, ref_lse = mla.mla_decode(*(t.cpu() for t in (qn, qp, pool, lens, table)), 1, num_splits=2, engine="dma",
                                  return_lse=True)
    assert not out[0].any() and not out[3].any() and torch.isneginf(lse[[0, 3]]).all()
    o, r = out.float().cpu(), ref.float()
    tol = 2.0 ** -7 * r.abs() + 2.0 ** -7 * r.abs().amax(-1, keepdim=True)  # as the K13a split test
    assert ((o - r).abs() <= tol).all(), float(((o - r).abs() / tol).max())
    valid = lens.cpu() > 0
    assert torch.allclose(lse.cpu()[valid], ref_lse[valid], rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# Slice 8: K16-K19 and the library GEMMs around them
# ---------------------------------------------------------------------------


def assert_out_close(out, ref, rel=None):
    """One output rounding apart: 2^-7 (bf16) or 2^-10 (f16) of the row's
    largest |ref|, per element (``rel`` for float32 outputs)."""
    rel = rel if rel is not None else {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}[out.dtype]
    ref = ref.float()
    tol = rel * ref.abs().amax(-1, keepdim=True)
    err = (out.float() - ref).abs()
    assert (err <= tol).all(), float((err / tol).max())


FP8_MMA_REL = 2.0 ** -10  # float32 outputs of the e4m3 mma, of the row's largest |ref|


def fp8_case(gen, m, k, n, e=None):
    """Production-scaled blockwise operands: codes spread over e4m3's range,
    1x128 activation and 128x128 weight scales."""
    lead = () if e is None else (e,)
    a = (torch.randn((m, k), generator=gen, device="cuda") * 100).clamp(-448, 448).to(torch.float8_e4m3fn)
    b = (torch.randn((*lead, k, n), generator=gen, device="cuda") * 100).clamp(-448, 448).to(torch.float8_e4m3fn)
    sa = torch.rand((m, k // 128), generator=gen, device="cuda") * 1e-3 + 1e-4
    sb = torch.rand((*lead, k // 128, n // 128), generator=gen, device="cuda") * 1e-3 + 1e-4
    return a, b, sa, sb


@pytest.mark.parametrize("m", [1, 16, 17, 32, 33, 64, 100, 128, 256, 1024])
@pytest.mark.parametrize("k,n", [(128, 384), (256, 256), (1024, 384), (256, 512)])
@pytest.mark.parametrize("prepared", [False, True])
def test_fp8_blockwise_scaled_mm(gen, m, k, n, prepared):
    """K17 over its four row tiles (a partial last tile at 1, 17, 33 and
    100 rows), one group (K 128), N a multiple of 128 but not of the 256
    columns of the 16 / 32-row tiles (384), split K (few output tiles) and
    not, both scale forms, the three output types."""
    a, b, sa, sb = fp8_case(gen, m, k, n)
    sbx = blockwise_fp8.prepare_blockwise_scales(sb) if prepared else sb
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        before = blockwise_fp8.fp8_blockwise_scaled_mm.launches
        out = blockwise_fp8.fp8_blockwise_scaled_mm(a, b, sa, sbx, dt)
        assert blockwise_fp8.fp8_blockwise_scaled_mm.launches == before + 1 and out.dtype == dt
        ref = blockwise_fp8.fp8_blockwise_scaled_mm_ref(a, b, sa, sb, dt)
        # the fp8 mma's own sums of 128 products may carry fewer bits than float32
        assert_out_close(out, ref, FP8_MMA_REL if dt == torch.float32 else None)


def test_fp8_blockwise_split_k_and_raises(gen):
    """One output tile over K=4096 splits K 32 ways, summed in the same
    launch; a bf16 A raises on the card (the twin takes it)."""
    a, b, sa, sb = fp8_case(gen, 3, 4096, 128)
    out = blockwise_fp8.fp8_blockwise_scaled_mm(a, b, sa, sb, torch.float32)
    ref = blockwise_fp8.fp8_blockwise_scaled_mm_ref(a, b, sa, sb, torch.float32)
    assert_out_close(out, ref, FP8_MMA_REL)
    assert blockwise_fp8.split_plan(1, 32, sm_count())[0] == 32
    with pytest.raises(NotImplementedError):
        blockwise_fp8.fp8_blockwise_scaled_mm(a.to(torch.bfloat16), b, sa, sb)
    with pytest.raises(ValueError):
        blockwise_fp8.fp8_blockwise_scaled_mm(a, b, sa[:, :3], sb)


@pytest.mark.parametrize("rows", [2, 256])
def test_fp8_blockwise_every_code_exact(gen, rows):
    """Every finite e4m3 code, subnormals included, through the kernel times
    an identity B with unit scales, on the 16-row tile and the 128-row one:
    the float32 outputs are the codes' exact values."""
    codes = torch.arange(256, dtype=torch.int32, device="cuda").to(torch.uint8)
    codes[(codes == 0x7F) | (codes == 0xFF)] = 0  # the two NaN bytes
    a = codes.view(torch.float8_e4m3fn).reshape(2, 128).repeat(rows // 2, 1)
    b = torch.eye(128, device="cuda").to(torch.float8_e4m3fn)
    ones = torch.ones((rows, 1), device="cuda"), torch.ones((1, 1), device="cuda")
    out = blockwise_fp8.fp8_blockwise_scaled_mm(a, b, *ones, torch.float32)
    assert torch.equal(out, a.float())


@pytest.mark.parametrize("bm", [16, 32, 64, 128])
@pytest.mark.parametrize("prepared", [False, True])
def test_fp8_blockwise_scaled_grouped_mm(gen, bm, prepared):
    """K18: 7 row blocks over 4 experts (expert 1 unused, 2 used twice apart,
    the two trailing blocks pinned to the last valid expert as alignment
    pads them), every block computed, the three output types; bm 8 and a
    bf16 A raise on the card."""
    e, k, n = 4, 256, 384
    eids = torch.tensor([2, 0, 0, 3, 2, 2, 2], dtype=torch.int32, device="cuda")
    a, b, sa, sb = fp8_case(gen, 7 * bm, k, n, e)
    sbx = blockwise_fp8.prepare_blockwise_scales(sb) if prepared else sb
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        before = blockwise_fp8.fp8_blockwise_scaled_grouped_mm.launches
        out = blockwise_fp8.fp8_blockwise_scaled_grouped_mm(a, b, sa, sbx, eids, dt, bm=bm)
        assert blockwise_fp8.fp8_blockwise_scaled_grouped_mm.launches == before + 1 and out.dtype == dt
        ref = blockwise_fp8.fp8_blockwise_scaled_grouped_mm_ref(a, b, sa, sb, eids, dt, bm=bm)
        assert_out_close(out, ref, FP8_MMA_REL if dt == torch.float32 else None)
    with pytest.raises(NotImplementedError):
        blockwise_fp8.fp8_blockwise_scaled_grouped_mm(a, b, sa, sb, eids.repeat_interleave(bm // 8), bm=8)
    with pytest.raises(NotImplementedError):
        blockwise_fp8.fp8_blockwise_scaled_grouped_mm(a.to(torch.bfloat16), b, sa, sb, eids, bm=bm)


@pytest.mark.parametrize("bm", [16, 128])
def test_fp8_blockwise_grouped_ids_out_of_range(gen, bm):
    """An expert id below 0 reads expert 0 and one at or past E the last
    expert, bit for bit as the clamped ids do (never past the bank)."""
    e, k, n = 3, 256, 256
    a, b, sa, sb = fp8_case(gen, 4 * bm, k, n, e)
    wild = torch.tensor([-3, 1, 3, 9], dtype=torch.int32, device="cuda")
    out = blockwise_fp8.fp8_blockwise_scaled_grouped_mm(a, b, sa, sb, wild, torch.float32, bm=bm)
    near = wild.clamp(0, e - 1)
    assert torch.equal(out, blockwise_fp8.fp8_blockwise_scaled_grouped_mm(a, b, sa, sb, near, torch.float32, bm=bm))
    ref = blockwise_fp8.fp8_blockwise_scaled_grouped_mm_ref(a, b, sa, sb, near, torch.float32, bm=bm)
    assert_out_close(out, ref, FP8_MMA_REL)


def fp8_calls(gen, case):
    """(call, plain twin, (A, its scales)) of a K17 or K18 call: K17 at M=16
    over 4,096 x 1,024 (4 tiles, K split 32 ways) and at M=1,024 over 1,024 x
    2,048 (128 tiles, no split); K18 at bm 16 over 6 experts (24 tiles, K
    split 4 ways)."""
    if case == "k18":
        a, b, sa, sb = fp8_case(gen, 4 * 16, 1024, 1536, 6)
        eids = torch.tensor([5, 0, 2, 2], dtype=torch.int32, device="cuda")
        return (lambda: blockwise_fp8.fp8_blockwise_scaled_grouped_mm(a, b, sa, sb, eids, bm=16),
                lambda: blockwise_fp8.fp8_blockwise_scaled_grouped_mm_ref(a, b, sa, sb, eids, bm=16), (a, sa))
    m, k, n = (16, 4096, 1024) if case == "k17_split" else (1024, 1024, 2048)
    a, b, sa, sb = fp8_case(gen, m, k, n)
    return (lambda: blockwise_fp8.fp8_blockwise_scaled_mm(a, b, sa, sb),
            lambda: blockwise_fp8.fp8_blockwise_scaled_mm_ref(a, b, sa, sb), (a, sa))


@pytest.mark.parametrize("case", ["k17_split", "k17", "k18"])
def test_fp8_blockwise_one_launch_a_call(gen, case):
    """Each call is one device launch, split K included (a torch.profiler
    trace of four calls holds only the kernel; the trace may miss the first)."""
    fn, _, _ = fp8_calls(gen, case)
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(4):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) in (3, 4) and all("blockwise_fp8_kernel" in n for n in names), names


@pytest.mark.parametrize("case", ["k17_split", "k17", "k18"])
def test_fp8_blockwise_bit_equal_and_graph(gen, case):
    """Two calls give the same bits (split partials are summed in split
    order by the last block); a captured CUDA graph replays them, again
    after the inputs change in place (the kept counters are back at zero
    after every launch)."""
    fn, ref_fn, (a, sa) = fp8_calls(gen, case)
    first = fn()
    assert torch.equal(first, fn())
    assert_out_close(first, ref_fn())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    a2, _, sa2, _ = fp8_case(gen, *a.shape, 128)
    a.copy_(a2)
    sa.copy_(sa2)
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(out, first)
    assert torch.equal(out, fn())
    assert_out_close(out, ref_fn())


def test_empty_calls_launch_nothing(gen):
    """M = 0 (and an empty sparse batch) returns an empty output and leaves
    each wrapper's launch count as it was."""
    a, b, sa, sb = fp8_case(gen, 0, 256, 256)
    calls = [(blockwise_fp8.fp8_blockwise_scaled_mm, lambda: blockwise_fp8.fp8_blockwise_scaled_mm(a, b, sa, sb))]
    _, bg, _, sbg = fp8_case(gen, 1, 256, 256, 2)
    eids = torch.zeros(0, dtype=torch.int32, device="cuda")
    calls.append((blockwise_fp8.fp8_blockwise_scaled_grouped_mm,
                  lambda: blockwise_fp8.fp8_blockwise_scaled_grouped_mm(a, bg, sa, sbg, eids, bm=16)))
    qa, qw, qz, qs, qws, qas = qserve_case(gen, 1, 256, 512, 128)
    calls.append((qserve.qserve_w4a8_per_group_gemm,
                  lambda: qserve.qserve_w4a8_per_group_gemm(qa[:0], qw, qz, qs, qws, qas[:0])))
    q, k, v, sched = vs_case(gen, 1, 128, 4, 4, 128, 8, 2, 128, True)
    calls.append((sparse_vs.sparse_attn_func,
                  lambda: sparse_vs.sparse_attn_func(q[:0], k[:0], v[:0], *(x[:0] for x in sched))))
    for fn, call in calls:
        before = fn.launches
        out = call()
        assert out.numel() == 0 and fn.launches == before, fn.__name__


def qserve_case(gen, m, n, k, g, zs_int8=False):
    """The progressive-quant operands of a per-group QServe call."""
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int32).to(torch.int8)
    w = torch.randint(0, 16, (n, k), generator=gen, device="cuda", dtype=torch.int32).to(torch.uint8)
    s2 = torch.randint(1, 17, (n, k // g), generator=gen, device="cuda", dtype=torch.int32).to(torch.int8)
    z = torch.randint(0, 16, (n, k // g), generator=gen, device="cuda", dtype=torch.int32)
    zs2 = (z * s2.int()).clamp(-128, 127).to(torch.int8) if zs_int8 else (z * s2.int()).float()
    ws = (torch.rand(n, generator=gen, device="cuda") * 0.01 + 0.001).half()
    as_ = (torch.rand(m, generator=gen, device="cuda") * 0.01 + 0.001).half()
    return a, w, zs2, s2, ws, as_


@pytest.mark.parametrize("m", [1, 16, 33, 130])
@pytest.mark.parametrize("n,k,g", [(256, 512, 128), (200, 1376, 32), (128, 384, 64)])
@pytest.mark.parametrize("out_dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_qserve_w4a8_per_group(gen, m, n, k, g, out_dtype):
    """K19 over its row tiles, a ragged N and a K that is not a multiple of
    the 128-deep k-tile, groups 32/64/128, the three output types."""
    args = qserve_case(gen, m, n, k, g)
    before = qserve.qserve_w4a8_per_group_gemm.launches
    out = qserve.qserve_w4a8_per_group_gemm(*args, group_size=g, out_dtype=out_dtype)
    assert qserve.qserve_w4a8_per_group_gemm.launches == before + 1 and out.dtype == out_dtype
    ref = qserve.qserve_w4a8_per_group_gemm_ref(*args, group_size=g, out_dtype=out_dtype)
    assert_out_close(out, ref, 1e-5 if out_dtype == torch.float32 else None)


def test_qserve_w4a8_scale_types_and_raises(gen):
    """int8 zeros_x_s2 and float32 scales take the same path; a group of 16
    raises on the card; the per-channel GEMM's int8 product is exact at
    M 1 and 16 (torch._int_mm wants more than 16 rows: padded)."""
    a, w, zs2, s2, ws, as_ = qserve_case(gen, 16, 256, 512, 128, zs_int8=True)
    out = qserve.qserve_w4a8_per_group_gemm(a, w, zs2, s2.float(), ws.float(), as_, out_dtype=torch.float32)
    ref = qserve.qserve_w4a8_per_group_gemm_ref(a, w, zs2, s2, ws, as_, out_dtype=torch.float32)
    assert_out_close(out, ref, 1e-5)
    with pytest.raises(NotImplementedError):
        qserve.qserve_w4a8_per_group_gemm(a, w, zs2.repeat(1, 8), s2.repeat(1, 8), ws, as_, group_size=16)
    for m in (1, 16):
        sums = torch.randn(m, generator=gen, device="cuda")
        szeros = torch.randn(256, generator=gen, device="cuda")
        out = qserve.qserve_w4a8_per_chn_gemm(a[:m], w, ws, as_[:m], szeros, sums, out_dtype=torch.float32)
        cpu = qserve.qserve_w4a8_per_chn_gemm(*(t.cpu() for t in (a[:m], w, ws, as_[:m], szeros, sums)),
                                              out_dtype=torch.float32)
        assert torch.allclose(out.cpu(), cpu, rtol=1e-6, atol=1e-6)


def qserve_made(gen, m, n, k, g):
    """Operands quantized as QServe does (``qserve.qserve_quantize``: int8
    per channel, |q| <= 119, then 4-bit groups of g with an integer scale
    s2 and zero z); int8 activations and f16 per-token / per-channel
    scales. Every W8 is an int8."""
    codes, zs2, s2, chn = qserve.qserve_quantize(torch.randn((n, k), generator=gen, device="cuda") * 0.01, g)
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int32).to(torch.int8)
    as_ = (torch.rand(m, generator=gen, device="cuda") * 0.01 + 0.001).half()
    return a, codes, zs2, s2, chn.half(), as_


def qserve_exact_blocks():
    return qserve.exact_route_blocks(torch.device("cuda", torch.cuda.current_device()))


# K19's int8 route against its plain twin. The kernel sums the int8
# products exactly in int32; the twin sums the same integer products in
# float32, which is exact while its partial sums stay below 2^24 (here
# |sum| < 2^21, asserted), and both apply the scales with the same float32
# operations in the same order: the outputs are equal bit for bit.
QSERVE_INT8_CASES = [(g, k) for g in (128, 64, 32) for k in (512, 4096)] + [(32, 1376)]


@pytest.mark.parametrize("m", [1, 16, 17, 33, 130, 1024])
@pytest.mark.parametrize("g,k", QSERVE_INT8_CASES)
def test_qserve_int8_route(gen, m, g, k):
    """QServe-made operands at groups 128 / 64 / 32 and K 512 / 4,096 (1,376
    = 43 x 32 at group 32): every block takes the int8 route (the exact-route
    counter stays) and the f16 output equals the twin's bit for bit."""
    args = qserve_made(gen, m, 256, k, g)
    assert qserve.w8_int8_exact(*args[1:4], g)
    before = qserve_exact_blocks()
    out = qserve.qserve_w4a8_per_group_gemm(*args, group_size=g)
    ref = qserve.qserve_w4a8_per_group_gemm_ref(*args, group_size=g)
    w8 = qserve.dequant_w8(*args[1:4], g).float()
    assert float((args[0].float() @ w8.T).abs().max()) < 2 ** 21
    assert qserve_exact_blocks() == before
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dt", [torch.int8, torch.float16, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [16, 130])
def test_qserve_scale_dtypes(gen, dt, m):
    """s2 and zeros_x_s2 in each type the kernel reads (the per-token and
    per-channel scales too, f16 where the type is int8) hold the same
    integers: the int8 route, and bits equal to the twin's."""
    a, w, zs2, s2, ws, as_ = qserve_made(gen, m, 384, 1024, 128)
    sd = dt if dt != torch.int8 else torch.float16
    args = (a, w, zs2.to(dt), s2.to(dt), ws.to(sd), as_.to(sd))
    assert torch.equal(zs2.to(dt).float(), zs2)
    before = qserve_exact_blocks()
    out = qserve.qserve_w4a8_per_group_gemm(*args, out_dtype=torch.float32)
    assert qserve_exact_blocks() == before
    assert torch.equal(out, qserve.qserve_w4a8_per_group_gemm_ref(*args, out_dtype=torch.float32))


def qserve_off_int8(gen, case, m, n, k, g):
    """Operands whose W8 are not all int8: ``pm240``, codes and zeros drawn
    in 0..15 with s2 in 1..16 (W8 to +-240); ``fractional``, QServe-made
    with s2 + 0.25 as float32; ``mixed``, QServe-made but for one weight
    row's first group (s2 16, zero 0: W8 to 240), so only the blocks
    holding it leave the int8 route."""
    if case == "pm240":
        return qserve_case(gen, m, n, k, g)
    a, w, zs2, s2, ws, as_ = qserve_made(gen, m, n, k, g)
    if case == "fractional":
        return a, w, zs2, s2.float() + 0.25, ws, as_
    w[5, :g] = 15
    s2[5, 0], zs2[5, 0] = 16, 0.0
    return a, w, zs2, s2, ws, as_


@pytest.mark.parametrize("case", ["pm240", "fractional", "mixed"])
@pytest.mark.parametrize("m,n,k,g", [(16, 256, 4096, 128), (130, 200, 1376, 32), (1024, 2304, 256, 64)])
def test_qserve_exact_route(gen, case, m, n, k, g):
    """Blocks holding a W8 that is not an int8 take the exact route (the
    counter rises; with ``mixed`` not every block does) and still meet the
    float32 bound of test_qserve_w4a8_per_group, split K (the first two
    shapes, the int32 and float32 partials of one tile summed together
    under ``mixed``) or not (the third)."""
    args = qserve_off_int8(gen, case, m, n, k, g)
    assert not qserve.w8_int8_exact(*args[1:4], g)
    before = qserve_exact_blocks()
    out = qserve.qserve_w4a8_per_group_gemm(*args, group_size=g, out_dtype=torch.float32)
    taken = qserve_exact_blocks() - before
    blocks = -(-n // 128) * -(-m // row_tile(m))
    assert taken > 0 and (case != "mixed" or taken < blocks), taken
    assert_out_close(out, qserve.qserve_w4a8_per_group_gemm_ref(*args, group_size=g, out_dtype=torch.float32),
                     1e-5)


def test_qserve_exact_route_past_int32_k(gen):
    """K = 2^17: an int32 sum of K products could overflow, so every block
    takes the exact route even on int8-exact weights."""
    args = qserve_made(gen, 3, 128, 1 << 17, 128)
    before = qserve_exact_blocks()
    out = qserve.qserve_w4a8_per_group_gemm(*args, out_dtype=torch.float32)
    assert qserve_exact_blocks() > before
    assert_out_close(out, qserve.qserve_w4a8_per_group_gemm_ref(*args, out_dtype=torch.float32), 1e-5)


def qserve_calls(gen, case):
    """(call, operands) of a K19 call: M=16 over 1,024 x 4,096 (8 tiles, K
    split), M=1,024 over 2,304 x 512 (144 tiles, no split), and the exact
    route at M=16 with K split."""
    if case == "exact":
        args = qserve_case(gen, 16, 256, 512, 128)
    else:
        args = qserve_made(gen, *((16, 1024, 4096) if case == "split" else (1024, 2304, 512)), 128)
    return (lambda: qserve.qserve_w4a8_per_group_gemm(*args)), args


@pytest.mark.parametrize("case", ["split", "whole", "exact"])
def test_qserve_one_launch_a_call(gen, case):
    """Each call is one device launch, split K and the exact route included
    (a torch.profiler trace of four calls holds only the kernel; the trace
    may miss the first)."""
    fn, _ = qserve_calls(gen, case)
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(4):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) in (3, 4) and all("qserve_kernel" in n for n in names), names


@pytest.mark.parametrize("case", ["split", "whole"])
def test_qserve_bit_equal_and_graph(gen, case):
    """On the int8 route two calls give the same bits, and so do two split
    plans (the int32 partials sum exactly); a captured CUDA graph replays
    them, again after the inputs change in place (the kept counters are back
    at zero after every launch)."""
    fn, args = qserve_calls(gen, case)
    first = fn()
    assert torch.equal(first, fn())
    a, w = args[:2]
    n_k = -(-a.shape[1] // qserve.TILE_K)
    for per in (n_k, 1, -(-n_k // 3)):  # k-tiles a split
        out = torch.empty_like(first)
        qserve._launch(a, w, args[3], args[2], args[4], args[5], out, 128, (-(-n_k // per), per))
        assert torch.equal(out, first), per
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    a2, _, _, _, _, as2 = qserve_made(gen, a.shape[0], 128, a.shape[1], 128)
    a.copy_(a2)
    args[5].copy_(as2)
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(out, first)
    assert torch.equal(out, fn())
    assert torch.equal(out, qserve.qserve_w4a8_per_group_gemm_ref(*args))


def test_qserve_exact_counter_by_any_device_name(gen):
    """The exact-route counter the kernel adds to is the one a reader finds
    under any name of the card: "cuda", torch.device("cuda") without an
    index, or with it (chip_smoke.py reads it the first way)."""
    names = ("cuda", torch.device("cuda"), torch.device("cuda", torch.cuda.current_device()))
    args = qserve_case(gen, 16, 256, 512, 128)
    assert not qserve.w8_int8_exact(*args[1:4])
    before = [qserve.exact_route_blocks(d) for d in names]
    qserve.qserve_w4a8_per_group_gemm(*args)
    after = [qserve.exact_route_blocks(d) for d in names]
    assert len(set(before)) == 1 and len(set(after)) == 1 and after[0] > before[0], (before, after)


@pytest.mark.parametrize("rows", [16, 32, 64, 128])
def test_qserve_split_plan_tile_is_the_kernels(gen, rows):
    """The host's split plan counts the kernel's own tile: its weight rows,
    its stage depth and the blocks an SM holds at each row tile."""
    assert qserve.kernel_tile(rows) == (qserve.TILE_N, qserve.TILE_K, qserve.blocks_per_sm(rows))


def test_qserve_ordered_across_streams(gen):
    """The kept split-K state is one set a card, so calls must be ordered:
    every split call leaves its arrival counters and int32 sums at zero, and
    calls on two streams joined by events each give the twin's bits."""
    from sgl_kernel_tpu_torch.utils import kept_buffer

    fn, args = qserve_calls(gen, "split")
    ref = qserve.qserve_w4a8_per_group_gemm_ref(*args)
    tiles = -(-args[1].shape[0] // qserve.TILE_N)
    outs, side = [], torch.cuda.Stream()
    for stream in (side, torch.cuda.current_stream(), side):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            outs.append(fn())
        torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    dev = args[0].device
    assert int(kept_buffer("qserve_counters", dev, tiles, torch.int32)[:tiles].abs().sum()) == 0
    m, n = ref.shape
    assert int(kept_buffer("qserve_sums", dev, m * n, torch.int32)[:m * n].abs().sum()) == 0
    assert all(torch.equal(out, ref) for out in outs)


def test_flash_launches_by_head_dim(gen):
    """K7 and K9 count their launches at head dim 576 (the MLA tile) apart:
    ``launches_576`` rises only there, ``launches`` at every head dim."""
    q, k, v = mla_qkv(gen, 1, 64, 64)
    ql = torch.tensor([64], dtype=torch.int32, device="cuda")
    q1, k1, v1 = randn(gen, 1, 64, 4, 128), randn(gen, 1, 64, 4, 128), randn(gen, 1, 64, 4, 128)
    qkv, ints, meta = packed_inputs(gen, [40], 16, 1, 576)
    qkv = (qkv[0], qkv[1], torch.nn.functional.pad(qkv[1][..., :512], (0, 64)).contiguous())
    qkv1, ints1, _ = packed_inputs(gen, [40], 4, 4, 128)
    fa, fp = flash_prefill.flash_attention, flash_packed.flash_attention_packed
    before = (fa.launches, fa.launches_576, fp.launches, fp.launches_576)
    fa(q, k, v, ql, ql, causal=True)
    fa(q1, k1, v1, ql, ql, causal=True)
    fp(*qkv, *ints, max_kvb=1)
    fp(*qkv1, *ints1, max_kvb=1)
    fp(*qkv1, *ints1, max_kvb=1)
    assert (fa.launches, fa.launches_576, fp.launches, fp.launches_576) == (
        before[0] + 2, before[1] + 1, before[2] + 3, before[3] + 1)


def test_scaled_mm_library_paths(gen):
    """int8 (exact, M 1 / 16 / 40, K and N off the multiples of 8) and fp8
    (K off 16) scaled matmuls and bmm_fp8 on the card equal the CPU path."""
    for m, k, n in ((1, 60, 36), (16, 64, 32), (40, 256, 200)):
        a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int32).to(torch.int8)
        b = torch.randint(-128, 128, (k, n), generator=gen, device="cuda", dtype=torch.int32).to(torch.int8)
        assert torch.equal(scaled_mm.int_mm_exact(a, b).cpu(), scaled_mm.int_mm_exact(a.cpu(), b.cpu()))
        sa, sb = torch.rand(m, device="cuda"), torch.rand(n, device="cuda")
        out = scaled_mm.int8_scaled_mm(a, b, sa, sb, torch.float32)
        ref = scaled_mm.int8_scaled_mm(a.cpu(), b.cpu(), sa.cpu(), sb.cpu(), torch.float32)
        assert torch.allclose(out.cpu(), ref, rtol=1e-6)
    def fp8_close(out, ref):  # cuBLAS's fp8 sums may carry fewer bits than float32
        assert out.shape == ref.shape
        assert float((out.cpu() - ref).abs().max()) <= 2.0 ** -10 * float(ref.abs().max())

    a = torch.randn((5, 200), generator=gen, device="cuda").to(torch.float8_e4m3fn)
    b = torch.randn((200, 48), generator=gen, device="cuda").to(torch.float8_e4m3fn)
    sa = torch.rand(5, device="cuda")
    fp8_close(scaled_mm.fp8_scaled_mm(a, b, sa, 0.5, torch.float32),
              scaled_mm.fp8_scaled_mm(a.cpu(), b.cpu(), sa.cpu(), 0.5, torch.float32))
    ab = torch.randn((3, 8, 128), generator=gen, device="cuda").to(torch.float8_e4m3fn)
    bb = torch.randn((3, 128, 64), generator=gen, device="cuda").to(torch.float8_e4m3fn)
    fp8_close(scaled_mm.bmm_fp8(ab, bb, 0.5, 2.0, torch.float32),
              scaled_mm.bmm_fp8(ab.cpu(), bb.cpu(), 0.5, 2.0, torch.float32))


def test_w4a8_grouped_mm_on_k11(gen):
    """w4a8_grouped_mm on the card (K11 at bm 16, every block) equals its CPU
    path (K11's twin); bm 8 raises on the card."""
    e, k, n, bm = 3, 512, 256, 16
    eids = torch.tensor([0, 2, 2, 1], dtype=torch.int32, device="cuda")
    x = torch.randint(-100, 100, (4 * bm, k), generator=gen, device="cuda", dtype=torch.int32).to(torch.int8)
    xs = torch.rand(4 * bm, generator=gen, device="cuda") * 0.01
    w = torch.randint(0, 256, (e, k // 2, n), generator=gen, device="cuda", dtype=torch.int32).to(torch.uint8)
    s1 = torch.rand((e, n), generator=gen, device="cuda") * 0.02 + 0.01
    zs = torch.rand((e, n), generator=gen, device="cuda") * 0.1
    before = moe.w4a16_grouped_mm.launches
    out = moe.w4a8_grouped_mm(x, xs, w, s1, eids, zs, bm=bm, out_dtype=torch.float32)
    assert moe.w4a16_grouped_mm.launches == before + 1
    ref = moe.w4a8_grouped_mm(*(t.cpu() for t in (x, xs, w, s1, eids, zs)), bm=bm, out_dtype=torch.float32)
    assert torch.allclose(out.cpu(), ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    with pytest.raises(NotImplementedError):
        moe.w4a8_grouped_mm(x, xs, w, s1, eids.repeat_interleave(2), bm=8)


def vs_case(gen, b, s, h, hk, d, nv, ns, bn, causal, seed=0):
    """q / k / v and a schedule from convert_vertical_slash_indexes on sorted
    random columns and distances (distinct per head)."""
    rng = np.random.default_rng(seed)
    q, k, v = randn(gen, b, s, h, d), randn(gen, b, s, hk, d), randn(gen, b, s, hk, d)
    v_idx = np.sort(np.stack([[rng.choice(s, nv, replace=False) for _ in range(h)] for _ in range(b)]), -1)
    s_idx = np.sort(np.stack([[rng.choice(s, ns, replace=False) for _ in range(h)] for _ in range(b)]), -1)[..., ::-1]
    sched = sparse_vs.convert_vertical_slash_indexes([s] * b, [s] * b, v_idx, np.ascontiguousarray(s_idx), s, 64,
                                                     bn, causal)
    return q, k, v, [torch.from_numpy(x).cuda() for x in sched]


def assert_vs_close(res, ref):
    (out, lse), (ro, rl) = res, ref
    assert_elementwise(out, ro)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(rl))
    fin = torch.isfinite(rl)
    assert torch.allclose(lse[fin], rl[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("s,hk", [(256, 4), (200, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_sparse_attn_func(gen, d, bn, s, hk, causal):
    """K16 against its twin on the same schedule: head dims, bn 64 / 128,
    GQA, a length that is not a multiple of 64 or of bn (blocks past S),
    causal or not, with the lse."""
    q, k, v, sched = vs_case(gen, 2, s, 4, hk, d, 24, 6, bn, causal)
    kw = dict(block_size_N=bn, causal=causal, return_lse=True)
    before = sparse_vs.sparse_attn_func.launches
    res = sparse_vs.sparse_attn_func(q, k, v, *sched, **kw)
    assert sparse_vs.sparse_attn_func.launches == before + 1
    assert_vs_close(res, sparse_vs.sparse_attn_func_ref(q, k, v, *sched, **kw))


def test_sparse_attn_func_edges(gen):
    """Empty rows (o 0, lse -inf), duplicate keys (a column inside a selected
    block, a block listed twice), column padding past column_count, soft cap,
    kv lengths below S, and the raises (float32, head dim 96, bm 128)."""
    q, k, v, (bc, bo, cc, ci) = vs_case(gen, 2, 256, 4, 4, 128, 16, 4, 128, True, seed=1)
    bc[0, 0, 1] = 0
    cc[0, 0, 1] = 0  # row block 1 of (0, 0) sees nothing
    bc[1, 2, 3] = 2
    bo[1, 2, 3, :2] = 128  # one block twice
    ci[1, 2, 3, 0] = 130  # and a column inside it
    cc[1, 2, 3] = max(int(cc[1, 2, 3]), 1)
    ci[0, 1, :, 10:] = 7  # past column_count: never counted
    kw = dict(softcap=30.0, return_lse=True, kv_lens=torch.tensor([256, 150], dtype=torch.int32))
    res = sparse_vs.sparse_attn_func(q, k, v, bc, bo, cc, ci, **kw)
    ref = sparse_vs.sparse_attn_func_ref(q, k, v, bc, bo, cc, ci, **kw)
    assert_vs_close(res, ref)
    assert not res[0][0, 64:128, 0].any() and torch.isneginf(res[1][0, 0, 64:128]).all()
    for bad in (dict(q=q.float(), k=k.float(), v=v.float()), dict(q=q[..., :96], k=k[..., :96], v=v[..., :96])):
        args = {**dict(q=q, k=k, v=v), **bad}
        with pytest.raises(NotImplementedError):
            sparse_vs.sparse_attn_func(args["q"], args["k"], args["v"], bc, bo, cc, ci)
    with pytest.raises(NotImplementedError):
        sparse_vs.sparse_attn_func(q, k, v, bc[:, :, :2], bo[:, :, :2], cc[:, :, :2], ci[:, :, :2],
                                   block_size_M=128)


def test_sparse_attn_varlen_gqa(gen):
    """The varlen wrapper on the card (two sequences, 8 query heads over 2
    kv heads, bn 64, causal, lse) against its CPU path."""
    lens = [200, 96]
    cu = np.concatenate([[0], np.cumsum(lens)])
    t = int(cu[-1])
    q, k, v = randn(gen, t, 8, 128), randn(gen, t, 2, 128), randn(gen, t, 2, 128)
    rng = np.random.default_rng(3)
    v_idx = np.sort(rng.integers(0, 96, (2, 8, 8)), -1)
    s_idx = np.sort(rng.choice(96, (2, 8, 4)), -1)[..., ::-1]
    sched = sparse_vs.convert_vertical_slash_indexes(lens, lens, v_idx, np.ascontiguousarray(s_idx), 200, 64, 64)
    args = (*sched, cu, cu, 200, 200)
    kw = dict(causal=True, return_softmax_lse=True)
    out, lse = sparse_vs.sparse_attn_varlen_func(q, k, v, *args, **kw)
    ref, rlse = sparse_vs.sparse_attn_varlen_func(q.cpu(), k.cpu(), v.cpu(), *args, **kw)
    assert out.shape == (t, 8, 128) and lse.shape == (8, t)
    assert_vs_close((out.cpu(), lse.cpu()), (ref, rlse))


def sparse_call(q, k, v, sched, **kw):
    """One K16 call: exactly one launch, and a second call bit-equal."""
    before = sparse_vs.sparse_attn_func.launches
    res = sparse_vs.sparse_attn_func(q, k, v, *sched, **kw)
    assert sparse_vs.sparse_attn_func.launches == before + 1
    again = sparse_vs.sparse_attn_func(q, k, v, *sched, **kw)
    pairs = zip(res, again) if isinstance(res, tuple) else [(res, again)]
    assert all(torch.equal(a, b) for a, b in pairs)
    return res


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("causal", [True, False])
def test_sparse_attn_wgmma_gqa4_kv_lens(gen, d, bn, softcap, causal):
    """K16's wgmma tile: GQA 4:1 (8 heads over 2), S = 333 (not a multiple of
    64 or 128), kv lengths 333 and 250, soft cap or not, with the lse; one
    launch a call, two calls bit-equal."""
    q, k, v, sched = vs_case(gen, 2, 333, 8, 2, d, 40, 6, bn, causal, seed=5)
    kw = dict(block_size_N=bn, causal=causal, softcap=softcap, return_lse=True,
              kv_lens=torch.tensor([333, 250], dtype=torch.int32))
    res = sparse_call(q, k, v, sched, **kw)
    assert_vs_close(res, sparse_vs.sparse_attn_func_ref(q, k, v, *sched, **kw))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bn", [64, 128])
def test_sparse_attn_wgmma_edge_keys(gen, d, bn):
    """A row block whose every key lies past the diagonal (o 0, lse -inf); a
    column that also lies in one of the row block's slash blocks (it counts
    twice); column ids at and past kv_len and below 0; NaN in every k / v row
    at or past kv_len changes nothing, bit for bit (those rows are not read)."""
    q, k, v, (bc, bo, cc, ci) = vs_case(gen, 2, 256, 4, 4, d, 16, 4, bn, True, seed=7)
    kvl = torch.tensor([256, 150], dtype=torch.int32)
    # (0, 0) row block 2 (rows 128..191): columns past its last row only, no block
    bc[0, 0, 2] = 0
    cc[0, 0, 2] = 3
    ci[0, 0, 2, :3] = torch.tensor([192, 200, 255])
    # (1, 1) row block 1 (rows 64..127): one block at 0 and column 5 inside it
    bc[1, 1, 1] = 1
    bo[1, 1, 1, 0] = 0
    cc[1, 1, 1] = 2
    ci[1, 1, 1, :2] = torch.tensor([5, 70])
    # (1, 2) row block 3 (rows 192..255, kv_len 150): ids below, at and past kv_len, and -1
    cc[1, 2, 3] = 5
    ci[1, 2, 3, :5] = torch.tensor([149, 150, 200, -1, 3])
    kw = dict(block_size_N=bn, return_lse=True, kv_lens=kvl)
    out, lse = sparse_call(q, k, v, (bc, bo, cc, ci), **kw)
    assert_vs_close((out, lse), sparse_vs.sparse_attn_func_ref(q, k, v, bc, bo, cc, ci, **kw))
    assert not out[0, 128:192, 0].any() and torch.isneginf(lse[0, 0, 128:192]).all()
    past = torch.zeros(2, 256, dtype=torch.bool, device="cuda")
    past[1, 150:] = True
    k2, v2 = (with_nan(x.reshape(512, -1), past.reshape(-1)).reshape(x.shape) for x in (k, v))
    out2, lse2 = sparse_vs.sparse_attn_func(q, k2, v2, bc, bo, cc, ci, **kw)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_sparse_attn_varlen_b2_wgmma(gen, bn, softcap):
    """B = 2 through sparse_attn_varlen_func (prompts of 300 and 130 tokens,
    GQA 4:1, head dim 64, causal, lse, soft cap or not) against its CPU
    path, one K16 launch."""
    lens = [300, 130]
    cu = np.concatenate([[0], np.cumsum(lens)])
    t = int(cu[-1])
    q, k, v = randn(gen, t, 8, 64), randn(gen, t, 2, 64), randn(gen, t, 2, 64)
    rng = np.random.default_rng(11)
    v_idx = np.sort(rng.integers(0, 130, (2, 8, 24)), -1)
    s_idx = np.sort(rng.choice(130, (2, 8, 6)), -1)[..., ::-1]
    sched = sparse_vs.convert_vertical_slash_indexes(lens, lens, v_idx, np.ascontiguousarray(s_idx), 300, 64, bn)
    args = (*sched, cu, cu, 300, 300)
    kw = dict(causal=True, softcap=softcap, return_softmax_lse=True, block_size_N=bn)
    before = sparse_vs.sparse_attn_func.launches
    out, lse = sparse_vs.sparse_attn_varlen_func(q, k, v, *args, **kw)
    assert sparse_vs.sparse_attn_func.launches == before + 1
    ref, rlse = sparse_vs.sparse_attn_varlen_func(q.cpu(), k.cpu(), v.cpu(), *args, **kw)
    assert_vs_close((out.cpu(), lse.cpu()), (ref, rlse))


# ---- K5 / K8 on the split-over-SMs tile, K1's decode kernel ----

EDGE_LENGTHS = [0, 1, 63, 64, 65, 1056, 32768]  # empty, page edges, the main path's longest, a long context
QUANT = {torch.int8: (1 / 16, 1 / 16), torch.float8_e4m3fn: (0.5, 0.25), torch.float8_e5m2: (0.5, 2.0)}


def edge_pools(gen, hq, hkv, d, page, dtype, layout, n_layers=1):
    """One batch of EDGE_LENGTHS over pools of ``dtype`` (1-byte pools hold
    random codes of every magnitude), page-major or head-major."""
    table, lens, kp, vp, q, fk, fv = paged_case(gen, len(EDGE_LENGTHS), hq, hkv, d, page, EDGE_LENGTHS, n_layers)
    if dtype == torch.int8:
        kp, vp = ((x * 40).clamp(-127, 127).to(dtype) for x in (kp, vp))
    elif dtype != torch.bfloat16:
        kp, vp = ((x * 8).to(dtype) for x in (kp, vp))
    if layout == "head":
        kp, vp = head_major(kp), head_major(vp)
    return table, lens, kp, vp, q, fk, fv


def decode_call(q, kp, vp, lens, table, layout, **kw):
    if layout == "head_k8":
        return paged_decode.paged_attention_decode(q, kp, vp, lens, table, **kw)
    return paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, table, layout=layout, **kw)


def decode_ref(q, kp, vp, lens, table, layout, **kw):
    if layout == "head_k8":
        return paged_decode.paged_attention_decode_ref(q, kp, vp, lens, table, **kw)
    return paged_decode_dma.paged_attention_decode_ref(q, kp, vp, lens, table, layout=layout, **kw)


@pytest.mark.parametrize("layout", ["page", "head", "head_k8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float8_e4m3fn, torch.float8_e5m2])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_decode_edge_lengths(gen, group, d, dtype, layout):
    """Lengths 0, 1, 63, 64, 65, 1,056 and 32,768 in one batch, every GQA
    group, head dim, pool type and layout (K8 through its own entry), with
    the fresh row and the lse; two calls give the same bits."""
    hkv = 2
    table, lens, kp, vp, q, fk, fv = edge_pools(gen, hkv * group, hkv, d, 64, dtype,
                                                "page" if layout == "page" else "head")
    kw = dict(fresh_k=fk, fresh_v=fv, return_lse=True)
    if dtype != torch.bfloat16:
        kw.update(k_scale=QUANT[dtype][0], v_scale=QUANT[dtype][1])
    o, lse = decode_call(q, kp, vp, lens, table, layout, **kw)
    ro, rl = decode_ref(q, kp, vp, lens, table, layout, **kw)
    assert torch.isfinite(o).all()
    assert_kernel_close(o, ro)
    assert_lse_close(lse, rl)
    o2, lse2 = decode_call(q, kp, vp, lens, table, layout, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("page", [16, 64, 128])
@pytest.mark.parametrize("fresh", [True, False])
def test_decode_edge_lengths_pages(gen, page, fresh):
    """The edge batch at pages of 16 (a unit is four pages), 64 and 128
    (two units a page), with and without the fresh row."""
    table, lens, kp, vp, q, fk, fv = edge_pools(gen, 32, 8, 128, page, torch.bfloat16, "page", n_layers=2)
    kw = dict(layer_id=1, return_lse=True)
    if fresh:
        kw.update(fresh_k=fk, fresh_v=fv)
    o, lse = paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, table, **kw)
    ro, rl = paged_decode_dma.paged_attention_decode_ref(q, kp, vp, lens, table, **kw)
    assert_kernel_close(o, ro)
    assert_lse_close(lse, rl)
    if not fresh:
        assert not o[0].any() and torch.isneginf(lse[0]).all()


@pytest.mark.parametrize("splits", [1, 4, 16])
@pytest.mark.parametrize("window", [None, 100, 5000])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_decode_edge_lengths_options(gen, splits, window, cap):
    """Sinks, the window (shorter than some contexts, longer than others),
    the soft cap and the lse over the edge batch, unsplit and split (the
    caller's splits, merged by the wrapper)."""
    hq, hkv = 16, 4
    table, lens, kp, vp, q, fk, fv = edge_pools(gen, hq, hkv, 128, 64, torch.bfloat16, "page")
    sinks = torch.randn(hq, generator=gen, device="cuda")
    kw = dict(fresh_k=fk, fresh_v=fv, return_lse=True, num_splits=splits, chunk_pages=1, sliding_window=window,
              logit_soft_cap=cap)
    o, lse = paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, table, sinks, **kw)
    ro, rl = paged_decode_dma.paged_attention_decode_ref(q, kp, vp, lens, table, sinks, **kw)
    assert_kernel_close(o, ro)
    assert_lse_close(lse, rl)
    o2, lse2 = paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, table, sinks, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("layout", ["page", "head"])
@pytest.mark.parametrize("page", [16, 64])
def test_decode_nan_past_lengths_unread(gen, splits, dtype, layout, page):
    """NaN in every pool row past each length, in the pages the unused
    table columns point at and in the pool's padding page: o and the lse
    are the same bits as over the clean pools."""
    hq, hkv, d = 16, 4, 128
    table, lens, kp, vp, q, fk, fv = edge_pools(gen, hq, hkv, d, page, dtype, "page")
    n_blocks = table.shape[1]
    spare = kp.shape[1] - 1  # pages the batch does not use
    kw = dict(fresh_k=fk, fresh_v=fv, return_lse=True, num_splits=splits, chunk_pages=1)
    if dtype != torch.bfloat16:
        kw.update(k_scale=0.5, v_scale=0.25)
    clean = [x.clone() for x in (kp, vp)]
    nan = float("nan")
    dirty_table = table.clone()
    for x in (kp, vp):
        x[:, 0] = nan  # the padding page unused table columns hold
    for b, n in enumerate(EDGE_LENGTHS):
        pool_tok = max(0, n - 1)
        used = -(-pool_tok // page)
        if pool_tok % page:
            for x in (kp, vp):
                x[:, table[b, used - 1], :, pool_tok % page:] = nan
        dirty_table[b, used:] = torch.randint(0, spare + 1, (n_blocks - used,), generator=gen, device="cuda")
    if layout == "head":
        kp, vp = head_major(kp), head_major(vp)
        clean = [head_major(x) for x in clean]
    o, lse = paged_decode_dma.paged_attention_decode_dma(q, *clean, lens, table, layout=layout, **kw)
    # unused columns may now name any page, including ones another sequence uses (which are finite)
    for x in (kp, vp):
        (x[:, :, 0] if layout == "head" else x[:, 0]).fill_(nan)
    o2, lse2 = paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, dirty_table, layout=layout, **kw)
    assert torch.isfinite(o).all()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


W4_DECODE_OPTIONS = ["mxfp4", "mxfp4_zeros", "zeros", "bias", "a2_silu", "fused_gate_up", "residual", "norm",
                     "norm_stacked", "layer_id", "padded_k", "f32_out"]


@pytest.mark.parametrize("m", list(range(1, 33)))
@pytest.mark.parametrize("gs", [32, 64, 128])
def test_w4a16_decode_rows(gen, m, gs):
    """K1's decode kernel at every row count 1..32 (both activation tiles)
    and group size, with the norm prologue (the rows pass ahead of it)."""
    check_w4(*w4_case(gen, m, 384, 1024, gs, "norm"))


@pytest.mark.parametrize("option", W4_DECODE_OPTIONS)
@pytest.mark.parametrize("m", [1, 9, 32])
def test_w4a16_decode_options(gen, option, m):
    """Every prologue and option of the contract on the decode kernel."""
    check_w4(*w4_case(gen, m, 384, 512, 32 if option.startswith("mxfp4") else 64, option))


@pytest.mark.parametrize("n,k,gs,option", [
    (28672, 1280, 128, "residual"),  # 224 x 5 stages over 264 blocks: tiles shared by 1-2 blocks
    (28672, 1152, 128, "zeros"),     # the last k block half past K (TMA reads zeros)
    (256, 8192, 64, "norm"),         # 2 column tiles of 32 stages: 32 blocks a tile
    (4096, 14336, 128, "a2_silu"),   # the down GEMM's shape: 32 x 56 stages, 7 a block
    (384, 1024, 64, "bias"),         # fewer stages (12) than blocks: one stage a block
    (200, 512, 64, "zeros"),         # N % 16 != 0: w4a16_gemm.cu's decode tile takes it
    (1000, 1024, 32, "norm"),
])
def test_w4a16_decode_splits(gen, n, k, gs, option):
    """The decode kernel's stream-K division: tiles shared by several
    blocks (the last to arrive sums their partials), a last k block past K,
    whole tiles stored at once; ragged N."""
    check_w4(*w4_case(gen, 16, n, k, gs, option))


@pytest.mark.parametrize("option", ["norm", "residual"])
def test_w4a16_decode_repeatable_and_graph(gen, option):
    """Two calls, and a CUDA graph of the call replayed twice, give the
    same bits: the split counters are left at zero by every launch (a
    stale counter would sum a partial twice or skip the epilogue)."""
    a, w, s, kw = w4_case(gen, 16, 4096, 4096, 128, option)
    tile, blocks, per = w4a16.plan(16, 4096, 4096, 128, sm_count(0))
    assert 32 * 16 % blocks  # 512 stages over the blocks: some tiles are shared
    first = w4a16.w4a16_gemm(a, w, s, **kw)
    assert torch.equal(first, w4a16.w4a16_gemm(a, w, s, **kw))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        w4a16.w4a16_gemm(a, w, s, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = w4a16.w4a16_gemm(a, w, s, **kw)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)


def test_decode_repeatable_in_graph(gen):
    """K5 in a CUDA graph replayed twice: the same bits as the eager call
    (its merge counters are left at zero by every launch)."""
    table, lens, kp, vp, q, fk, fv = edge_pools(gen, 32, 8, 128, 64, torch.bfloat16, "page")
    kw = dict(fresh_k=fk, fresh_v=fv, return_lse=True)
    first = paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, table, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, table, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, table, **kw)
    for _ in range(2):
        out[0].zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], first[0]) and torch.equal(out[1], first[1])


# ---------------------------------------------------------------------------
# The decode step as a captured CUDA graph (serving/decode_graph.py): three
# engines at published widths cut to 2 layers, random weights from a seed.

def _graph_cfg(kind):
    import dataclasses

    from sgl_kernel_tpu_torch import DeepseekConfig, LlamaConfig, MixtralConfig

    if kind == "llama-w4a16":
        return dataclasses.replace(LlamaConfig.llama3_8b(quant="w4a16", fused=True), num_layers=2, max_position=2048)
    if kind == "mixtral-w4a16":
        return dataclasses.replace(MixtralConfig.mixtral_8x7b(quant="w4a16"), num_layers=2, max_position=2048)
    # DeepSeek-V2-Lite widths (layer 0 dense, layer 1 MoE, top-6 of 64), W4A16, int8 latent
    return DeepseekConfig(vocab_size=102400, hidden_size=2048, num_layers=2, num_heads=16, qk_nope_dim=128,
                          v_head_dim=128, num_experts=64, num_experts_per_tok=6, moe_intermediate=1408,
                          dense_intermediate=10944, num_dense_layers=1, routed_scaling_factor=1.0, max_position=2048,
                          dtype=torch.bfloat16, quant="w4a16", group_size=128, kv_dtype=torch.int8, kv_scale=1 / 16)


@pytest.fixture(scope="module")
def graph_engines():
    """Engine factory: ``make(kind, **kw)``, the weights of each kind drawn
    once and shared by its engines."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from sgl_kernel_tpu_torch import Engine

    params = {}

    def make(kind, **kw):
        eng = Engine(_graph_cfg(kind), params.get(kind), device="cuda", max_batch=16, page_size=64, num_pages=128,
                     seed=1, **kw)
        params[kind] = eng.params
        return eng

    yield make
    params.clear()
    torch.cuda.empty_cache()


def _admit(eng, n=16, new=24, seed=0):
    """``n`` random prompts of 20 + 32 i tokens admitted and prefilled, and two
    decode steps run (the graph captured, then replayed); returns the running
    requests."""
    g = torch.Generator().manual_seed(seed)
    for i in range(n):
        eng.add_request(torch.randint(1, eng.cfg.vocab_size, (20 + 32 * i,), generator=g).tolist(),
                        max_new_tokens=new)
    eng.step()
    eng.step()
    return [r for r in eng.running if not r.done]


GRAPH_KINDS = ("deepseek-w4a16-int8", "llama-w4a16", "mixtral-w4a16")


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_decode_graph_replay_matches_eager(graph_engines, kind):
    """Six decode steps, the static inputs refilled in place each step: the
    graph's logits equal the eager step's on the same inputs bit for bit
    (both write the same KV rows; every kernel of the step sums in a fixed
    order, the MoE combine too since it gathers each token's K slots), then
    the batch advances by the graph's greedy tokens."""
    eng = graph_engines(kind)
    reqs = _admit(eng)
    graph = eng._decode_graph(1)
    assert graph.graph is not None
    replays = graph.replays
    for _ in range(6):
        eng._inputs.fill(*eng._decode_inputs(reqs, 0))
        eager = graph(eager=True).clone()
        replay = graph().clone()
        assert torch.equal(replay, eager)
        eng._append_tokens(reqs, replay)
    assert graph.replays == replays + 6
    eng.run_until_done()


def test_decode_burst_graph_matches_steps(graph_engines):
    """decode_burst=4 on the W4A16 Llama engine (one graph of 4 greedy steps,
    the argmax fed back on the device) against decode_burst=1 on the same
    weights: identical tokens for 16 requests of 13 tokens (the prefill's,
    then three bursts), and the burst graph replayed three times."""
    outs = {}
    for burst in (1, 4):
        eng = graph_engines("llama-w4a16", decode_burst=burst, enable_prefix_cache=False)
        g = torch.Generator().manual_seed(5)
        rids = [eng.add_request(torch.randint(1, eng.cfg.vocab_size, (30 + 17 * i,), generator=g).tolist(),
                                max_new_tokens=13) for i in range(16)]
        eng.run_until_done()
        outs[burst] = [eng.finished[r].output for r in rids]
        if burst == 4:
            assert eng._graphs[4].replays == 3 and 1 not in eng._graphs
        assert eng.metrics.counters.get("nonfinite_logits", 0) == 0
    assert outs[4] == outs[1]


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_decode_graph_tally_matches_eager_counts(graph_engines, kind):
    """A replay adds to each wrapper's counters (launches, K7 / K9's 576
    count, K1 / K11's launches by kernel) what the captured step launched:
    the tally equals the counters' movement over one eager step, and one
    replay moves them by as much."""
    import sgl_kernel_tpu_torch as skt

    def counts():
        c = {**skt.launch_counts(), **skt.head_dim_launch_counts(), **skt.route_launch_counts()}
        return {k: n for k, n in c.items() if n}

    eng = graph_engines(kind)
    reqs = _admit(eng, n=4)
    graph = eng._decode_graph(1)
    eng._inputs.fill(*eng._decode_inputs(reqs, 0))
    skt.reset_launch_counts()
    graph(eager=True)
    eager = counts()
    skt.reset_launch_counts()
    graph()
    torch.cuda.synchronize()
    assert counts() == eager == graph.tally.counts()
    # every engine here decodes its linears on K1's decode kernel (M <= 32)
    assert eager["w4a16_gemm"] == eager["w4a16_gemm_decode"] > 0
    skt.reset_launch_counts()
    eng.run_until_done()


def test_decode_graph_capture_failure_raises(graph_engines):
    """An adapter whose decode reads a value back to the host cannot be
    captured: the first decode step raises, after the one eager warm-up
    call and the failed capture, and decodes nothing eagerly in its place."""
    from sgl_kernel_tpu_torch import Engine
    from sgl_kernel_tpu_torch.serving.adapters import LlamaAdapter

    base = graph_engines("llama-w4a16")
    calls = []

    class HostReadAdapter(LlamaAdapter):
        def decode(self, *args):
            logits, caches = super().decode(*args)
            calls.append(logits.sum().item())  # a host read: not allowed in a capture
            return logits, caches

    eng = Engine(base.cfg, base.params, device="cuda", adapter=HostReadAdapter(base.cfg, "cuda"), max_batch=16,
                 page_size=64, num_pages=64, enable_prefix_cache=False)
    eng.add_request(list(range(1, 40)), max_new_tokens=4)
    with pytest.raises(RuntimeError):
        eng.step()  # the prefill, then the first decode step: warm-up and capture
    torch.cuda.synchronize()
    assert len(calls) == 1  # the warm-up's; the capture raised at its host read
    assert [len(r.output) for r in eng.running] == [1]  # the prefill's token only
    assert eng._graphs[1].graph is None
