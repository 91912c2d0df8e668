"""The port's hand-written kernels against their plain PyTorch twins on the
card, over the options and edge cases the serving path's shapes in
chip_smoke.py do not reach: other head dims and GQA groups, page sizes,
padding rows, duplicate and dropped slots, extend offsets, non-causal
attention, the base-2 lse and rows that see no key, packed prefill at block
edges with padding blocks, widths that are not powers of two, quantized KV
pools, and every option, row count, group size and ragged width of the
W4A16 GEMM.

Needs a CUDA device: every test here is marked ``cuda`` and skips without
one. On the card (tests/conftest.py imports JAX, which that machine need not
have, so it is skipped):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sgl_kernel_tpu_torch.ops import kvcache, norm, rope
from sgl_kernel_tpu_torch.ops.attention import flash_packed, flash_prefill, paged_decode_dma
from sgl_kernel_tpu_torch.ops.gemm import w4a16

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
    table, lens, kp, vp, q, fk, fv = paged_case(gen, 2, 8, 2, 128, 64, [70, 5], n_layers=1)
    out = paged_decode_dma.paged_attention_decode_dma(q, kp[0], vp[0], lens, table, fresh_k=fk, fresh_v=fv)
    ref = paged_decode_dma.paged_attention_decode_ref(q, kp[0], vp[0], lens, table, fresh_k=fk, fresh_v=fv)
    assert_kernel_close(out, ref)
    for kw in (dict(sliding_window=8), dict(logit_soft_cap=5.0), dict(return_lse=True), dict(num_splits=2)):
        with pytest.raises(NotImplementedError):
            paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lens, table, **kw)


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


def check_packed(qkv, ints, meta, lens, max_kvb, hq):
    before = flash_packed.flash_attention_packed.launches
    out, lse = flash_packed.flash_attention_packed(*qkv, *ints, max_kvb=max_kvb, return_lse=True)
    assert flash_packed.flash_attention_packed.launches == before + 1
    ref, ref_lse = flash_packed.flash_attention_packed_ref(*qkv, *ints, max_kvb=max_kvb, return_lse=True)
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
    tile, split, per = w4a16.plan(m, n, k, gs, w4a16._sm_count(0))
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
