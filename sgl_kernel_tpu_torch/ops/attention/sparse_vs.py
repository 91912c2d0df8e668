"""MInference-style vertical + slash sparse attention.

The port of sgl_kernel_tpu/ops/attention/sparse_vs.py. Attention is kept to
a per-head set of *vertical* columns (always-attended keys) and *slash*
diagonals (fixed distances behind each query).

``sparse_attn_func`` is kernel K16, CUDA C++ in ``csrc/sparse_vs.cu`` (the
wgmma flash tile of ``csrc/flash_tile.cuh`` fed by a producer warp),
replacing the Pallas ``sparse_attn_func`` (sparse_vs.py:351, kernel
``_bs_kernel`` :240, pallas_call at :417); ``sparse_attn_func_ref`` is its
plain twin, which follows the same block schedule (not the dense mask);
``work_order`` is the order in which the kernel's blocks take the (sequence,
head, row block) items. Per
(sequence, head, row block of ``block_size_M`` queries) they attend, with one
online softmax, to (1) the exact vertical columns ``column_index[:cc]`` and
(2) every key of the ``block_count`` slash blocks of ``block_size_N`` keys
starting at ``block_offset``; keys at or past the sequence's kv length, and
with ``causal`` keys after the query, are masked. A key listed twice (a
column inside a selected block, or two equal offsets) counts twice, as in
JAX. Scores are q.k * sm_scale, then ``softcap * tanh(s / softcap)`` when
softcap > 0. The lse is natural-log (m + log l), [B, H, S]; a row that sees
no key gets o = 0 and lse -inf.

The schedule builders (``convert_vertical_slash_indexes`` and its mergehead
form) are host numpy in JAX, a loop over (sequence, head, row block); here
they are the same function vectorised over all three, with the same four
int32 arrays out, bit for bit. ``build_vertical_slash_indexes`` (the pattern
estimator), the dense ``sparse_attention_vertical_slash`` and the varlen
wrapper are plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from ... import _build
from ...utils import cdiv, round_up


def sparse_attention_vertical_slash(q, k, v, vertical_idx, slash_idx, *, sm_scale: Optional[float] = None,
                                    causal: bool = True):
    """Dense masked form: q/k/v [B, S, H, D]; vertical_idx [H, NV] column ids
    (-1 pads); slash_idx [H, NS] diagonal distances (0 = self; -1 pads).
    Position (i, j) is attended iff j is a vertical column or i - j a slash
    distance (and j <= i when causal). Float32 inside, out in q's dtype."""
    b, s, h, d = q.shape
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    rows = torch.arange(s, device=dev)[:, None]
    cols = torch.arange(s, device=dev)[None, :]
    vi = torch.as_tensor(vertical_idx, device=dev).long()
    si = torch.as_tensor(slash_idx, device=dev).long()
    vert = ((cols[None, None] == vi[:, :, None, None]) & (vi >= 0)[:, :, None, None]).any(1)  # [H, 1, S]
    diag = (((rows - cols)[None, None] == si[:, :, None, None]) & (si >= 0)[:, :, None, None]).any(1)  # [H, S, S]
    mask = vert | diag
    if causal:
        mask = mask & (cols <= rows)[None]
    qf, kf, vf = (x.transpose(1, 2).float() for x in (q, k, v))
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm
    scores = torch.where(mask[None], scores, float("-inf"))
    m = torch.clamp_min(scores.amax(-1, keepdim=True), -1e30)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf) / torch.clamp_min(l, 1e-38)
    return out.transpose(1, 2).to(q.dtype)


def convert_vertical_slash_indexes(q_seqlens, kv_seqlens, vertical_indexes, slash_indexes, context_size: int,
                                   block_size_M: int, block_size_N: int, causal: bool = True):
    """Per-head vertical / slash index sets -> the block-sparse schedule
    (sparse_vs.py:80-167). vertical_indexes [B, H, NV] ascending column ids;
    slash_indexes [B, H, NS] descending distances. Returns numpy int32
    (block_count [B, H, R], block_offset [B, H, R, NS], column_count [B, H, R],
    column_index [B, H, R, NV]), R = ceil(context_size / block_size_M).

    For row block r (end row e_r = (r + 1) * block_size_M) of a sequence
    with shift = kv_len - q_len, the visible bound is min(e_r + shift, kv_len)
    (kv_len when not causal). Slash s covers the key band [max(c - bM, 0), c)
    with c = min(shift + e_r - s, bound), c > 0; the selected blocks are the
    block_size_N-aligned blocks meeting any band, in ascending order, the
    last NS of them kept; the columns are the vertical ids inside the bound
    and outside every kept block, in input order."""
    qs = np.asarray(q_seqlens, np.int64)
    ks = np.asarray(kv_seqlens, np.int64)
    v_idx = np.asarray(vertical_indexes).astype(np.int64)
    s_idx = np.asarray(slash_indexes).astype(np.int64)
    b, h, nv = v_idx.shape
    ns = s_idx.shape[2]
    bm, bn = block_size_M, block_size_N
    r = cdiv(context_size, bm)
    shift = (ks - qs)[:, None, None]  # [B, 1, 1]
    end = (np.arange(r, dtype=np.int64) + 1) * bm  # [R]
    bound = np.minimum(end[None] + shift[:, 0], ks[:, None]) if causal else np.broadcast_to(ks[:, None], (b, r))
    bound = np.broadcast_to(bound[:, None, :], (b, h, r))  # [B, H, R]
    live = bound > 0

    # slash bands [lo, c) per (b, h, r, s); c <= 0 schedules nothing
    c = np.minimum(shift[..., None] + end[None, None, :, None] - s_idx[:, :, None, :], bound[..., None])
    ok = (c > 0) & live[..., None]
    lo = np.maximum(c - bm, 0)
    nblk = max(1, cdiv(int(ks.max(initial=0)), bn))
    first = np.where(ok, lo // bn, 0)
    last = np.where(ok, (c - 1) // bn + 1, 0)  # one past the band's last block
    diff = np.zeros((b, h, r, nblk + 1), np.int64)
    bi, hi_, ri, _ = np.nonzero(ok)
    np.add.at(diff, (bi, hi_, ri, first[ok]), 1)
    np.add.at(diff, (bi, hi_, ri, last[ok]), -1)
    covered = np.cumsum(diff, -1)[..., :nblk] > 0  # [B, H, R, nblk]
    # keep the last NS covered blocks (the nearest ones)
    from_end = np.cumsum(covered[..., ::-1], -1)[..., ::-1]
    kept = covered & (from_end <= ns)
    block_count = kept.sum(-1).astype(np.int32)
    block_offset = np.zeros((b, h, r, ns), np.int32)
    pos = np.cumsum(kept, -1) - 1
    bi, hi_, ri, ji = np.nonzero(kept)
    block_offset[bi, hi_, ri, pos[bi, hi_, ri, ji]] = (ji * bn).astype(np.int32)

    # vertical columns inside the bound and outside every kept block
    vcol = v_idx[:, :, None, :]  # [B, H, 1, NV]
    inside = (vcol >= 0) & (vcol < bound[..., None]) & live[..., None]
    blk = np.clip(vcol // bn, 0, nblk - 1)
    in_kept = np.take_along_axis(kept, np.broadcast_to(blk, (b, h, r, nv)), axis=-1)
    keep_col = inside & ~in_kept
    column_count = keep_col.sum(-1).astype(np.int32)
    column_index = np.zeros((b, h, r, nv), np.int32)
    pos = np.cumsum(keep_col, -1) - 1
    bi, hi_, ri, ci = np.nonzero(keep_col)
    column_index[bi, hi_, ri, pos[bi, hi_, ri, ci]] = v_idx[bi, hi_, ci].astype(np.int32)
    return block_count, block_offset, column_count, column_index


def convert_vertical_slash_indexes_mergehead(q_seqlens, kv_seqlens, vertical_indexes, slash_indexes,
                                             vertical_indices_count, slash_indices_count, context_size: int,
                                             block_size_M: int, block_size_N: int, causal: bool = True):
    """Per-head-truncated form (sparse_vs.py:170-195): head h uses only its
    first vertical_indices_count[h] / slash_indices_count[h] indices."""
    v_idx = np.array(vertical_indexes)
    s_idx = np.array(slash_indexes)
    vc = np.asarray(vertical_indices_count).astype(np.int64)
    sc = np.asarray(slash_indices_count).astype(np.int64)
    big = 1 << 30
    v_idx[:, np.arange(v_idx.shape[2])[None, :] >= vc[:, None]] = big  # past every bound: dropped
    s_idx[:, np.arange(s_idx.shape[2])[None, :] >= sc[:, None]] = big  # a distance past every column
    return convert_vertical_slash_indexes(q_seqlens, kv_seqlens, v_idx, s_idx, context_size, block_size_M,
                                          block_size_N, causal)


def build_vertical_slash_indexes(q, k, num_vertical: int, num_slash: int, last_q: int = 64, *,
                                 sm_scale: Optional[float] = None):
    """Estimate the index sets from the last ``last_q`` queries of sequence 0
    (sparse_vs.py:198-233): softmax of their causal scores, summed per
    column -> the top ``num_vertical`` columns; summed per diagonal
    distance -> the top ``num_slash`` distances. q/k [B, S, H, D]. Returns
    int32 (vertical [H, num_vertical], slash [H, num_slash]), each in
    descending mass, ties to the lower index."""
    b, s, h, d = q.shape
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    qt = q[0, -last_q:].transpose(0, 1).float()  # [H, lq, D]
    kt = k[0].transpose(0, 1).float()  # [H, S, D]
    scores = torch.einsum("hqd,hkd->hqk", qt, kt) * sm
    rows = s - last_q + torch.arange(last_q, device=dev)[:, None]
    cols = torch.arange(s, device=dev)[None, :]
    scores = torch.softmax(torch.where(cols <= rows, scores, float("-inf")), dim=-1)
    col_mass = scores.sum(1)  # [H, S]
    offs = torch.clamp(rows - cols, 0, s - 1).reshape(-1)
    diag_mass = torch.zeros((h, s), dtype=torch.float32, device=dev).index_add_(1, offs, scores.reshape(h, -1))
    return _topk_ids(col_mass, num_vertical), _topk_ids(diag_mass, num_slash)


def _topk_ids(x, n: int):
    """Indices of the n largest of each row, descending; ties to the lower index."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :n].to(torch.int32)


# ---------------------------------------------------------------------------
# The block-sparse kernel (K16) and its twin
# ---------------------------------------------------------------------------


def _schedule(t, device):
    return torch.as_tensor(t, device=device).to(torch.int32)


def _operands(q, k, v, block_count, block_offset, column_count, column_index, bm, kv_lens):
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or v.shape != k.shape or h % k.shape[2]:
        raise ValueError(f"sparse_attn_func: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    r = cdiv(s, bm)
    dev = q.device
    bc, bo, cc, ci = (_schedule(x, dev) for x in (block_count, block_offset, column_count, column_index))
    if bc.shape != (b, h, r) or cc.shape != (b, h, r) or bo.shape[:3] != (b, h, r) or ci.shape[:3] != (b, h, r):
        raise ValueError(f"sparse_attn_func: schedule arrays {tuple(bc.shape)} {tuple(bo.shape)} "
                         f"{tuple(cc.shape)} {tuple(ci.shape)} for [B, H, R]={(b, h, r)}")
    kvl = (torch.full((b,), s, dtype=torch.int32, device=dev) if kv_lens is None
           else _schedule(kv_lens, dev).reshape(b))
    return bc, bo, cc, ci, kvl


def sparse_attn_func_ref(q, k, v, block_count, block_offset, column_count, column_index, *, block_size_M: int = 64,
                         block_size_N: int = 128, causal: bool = True, sm_scale: Optional[float] = None,
                         softcap: float = 0.0, return_lse: bool = False, kv_lens=None):
    """Plain twin of ``sparse_attn_func``, on the same block schedule: per
    (sequence, head) the row blocks' key lists (the counted vertical columns,
    then each slash block's keys) are gathered and attended in float32 with
    one softmax. k / v may have fewer heads than q (head h reads kv head
    h // (H / Hkv))."""
    b, s, h, d = q.shape
    bm, bn = block_size_M, block_size_N
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    bc, bo, cc, ci, kvl = _operands(q, k, v, block_count, block_offset, column_count, column_index, bm, kv_lens)
    r, group, dev = cdiv(s, bm), h // k.shape[2], q.device
    nv, ns = ci.shape[-1], bo.shape[-1]
    # key ids per (b, h, r): nv column slots, then ns blocks of bn keys; -1 is no key
    slot = torch.arange(nv, device=dev)
    col_keys = torch.where(slot < cc[..., None], ci.long(), -1)
    blk_keys = bo.long()[..., None] + torch.arange(bn, device=dev)
    blk_keys = torch.where((torch.arange(ns, device=dev) < bc[..., None])[..., None], blk_keys, -1)
    keys = torch.cat([col_keys, blk_keys.reshape(b, h, r, ns * bn)], -1)  # [B, H, R, NK]
    rows = torch.arange(r * bm, device=dev).reshape(r, bm)
    out = torch.zeros((b, s, h, d), dtype=q.dtype, device=dev)
    lse = torch.full((b, h, s), float("-inf"), dtype=torch.float32, device=dev)
    for bb in range(b):
        kl = min(int(kvl[bb]), s)
        for hh in range(h):
            kk = keys[bb, hh]  # [R, NK]
            vis = (kk >= 0) & (kk < kl)
            if causal:
                vis = vis[:, None, :] & (kk[:, None, :] <= rows[:, :, None])  # [R, bm, NK]
            else:
                vis = vis[:, None, :].expand(r, bm, kk.shape[-1])
            safe = torch.where((kk >= 0) & (kk < s), kk, 0)
            kx = k[bb, :, hh // group].float()[safe]  # [R, NK, D]
            vx = v[bb, :, hh // group].float()[safe]
            qx = torch.nn.functional.pad(q[bb, :, hh].float(), (0, 0, 0, r * bm - s)).reshape(r, bm, d)
            sc = torch.einsum("rqd,rkd->rqk", qx, kx) * sm
            if softcap > 0.0:
                sc = softcap * torch.tanh(sc / softcap)
            sc = torch.where(vis, sc, float("-inf"))
            m = torch.clamp_min(sc.amax(-1, keepdim=True), -1e30)
            p = torch.exp(sc - m)
            l = p.sum(-1, keepdim=True)
            o = torch.einsum("rqk,rkd->rqd", p, vx)
            o = torch.where(l > 0, o / torch.clamp_min(l, 1e-38), 0.0).reshape(r * bm, d)[:s]
            out[bb, :, hh] = o.to(q.dtype)
            ls = torch.where(l[..., 0] > 0, m[..., 0] + torch.log(torch.clamp_min(l[..., 0], 1e-38)),
                             float("-inf"))
            lse[bb, hh] = ls.reshape(-1)[:s]
    return (out, lse) if return_lse else out


def work_order(batch: int, heads: int, kv_heads: int, row_blocks: int):
    """The (sequence, head, row block) item of each of the card kernel's
    blocks, in block order (the kernel derives it from its block index):
    sequences in turn, within each the kv heads in turn, within each the row
    blocks from the last (under causal masking the one with the most keys)
    to the first, and for each row block the kv head's query heads side by
    side. The blocks resident at a time then read one kv head's keys, and
    each kv head's light row blocks come last."""
    group = heads // kv_heads
    return [(b, hk * group + g, row_blocks - 1 - rr) for b in range(batch) for hk in range(kv_heads)
            for rr in range(row_blocks) for g in range(group)]


_ARGS = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 9 + (ctypes.c_float,) * 2 + (ctypes.c_void_p,)


@functools.cache
def _entry():
    return _build.bind("sparse_vs", "skt_sparse_attn", _ARGS)


def sparse_attn_func(q, k, v, block_count, block_offset, column_count, column_index, *, block_size_M: int = 64,
                     block_size_N: int = 128, causal: bool = True, sm_scale: Optional[float] = None,
                     softcap: float = 0.0, return_lse: bool = False, kv_lens=None):
    """Block-sparse attention over the vertical / slash schedule. q/k/v [B,
    S, H, D] (self-attention; k / v may have fewer heads, H a multiple);
    schedule arrays from ``convert_vertical_slash_indexes`` with R =
    ceil(S / block_size_M); kv_lens [B] optional (default S; at most S).
    Returns out [B, S, H, D] (+ lse [B, H, S] float32, natural log).

    CUDA tensors go through the K16 kernel (one launch), which takes bf16
    q/k/v (float16 and float32 raise), head dim 64 or 128, block_size_M 64
    and block_size_N 64 or 128; it reads the columns and blocks straight
    from k and v (no gathered copy) and never past a sequence's kv length."""
    if q.device.type != "cuda":
        return sparse_attn_func_ref(q, k, v, block_count, block_offset, column_count, column_index,
                                    block_size_M=block_size_M, block_size_N=block_size_N, causal=causal,
                                    sm_scale=sm_scale, softcap=softcap, return_lse=return_lse, kv_lens=kv_lens)
    b, s, h, d = q.shape
    bm, bn = block_size_M, block_size_N
    bc, bo, cc, ci, kvl = _operands(q, k, v, block_count, block_offset, column_count, column_index, bm, kv_lens)
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise NotImplementedError(f"sparse_attn_func: the CUDA kernel takes bf16 q/k/v, not {q.dtype}")
    if d not in (64, 128) or bm != 64 or bn not in (64, 128):
        raise NotImplementedError(f"sparse_attn_func: the CUDA kernel takes head dim 64/128, block_size_M 64 and "
                                  f"block_size_N 64/128, not {d} / {bm} / {bn}")
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    q, k, v, bc, bo, cc, ci, kvl = (x.contiguous() for x in (q, k, v, bc, bo, cc, ci, kvl))
    if any(x.data_ptr() % 16 for x in (q, k, v)):  # the kernel copies 16-byte pieces with cp.async
        q, k, v = q.clone(), k.clone(), v.clone()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    if b and s and h:
        _build.check(_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), bc.data_ptr(), bo.data_ptr(), cc.data_ptr(),
                              ci.data_ptr(), kvl.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
                              b, s, h, k.shape[2], d, bo.shape[-1], ci.shape[-1], bn, int(causal), sm,
                              float(softcap), _build.stream_ptr(q.device)), "sparse_attn_func")
        sparse_attn_func.launches += 1
    return (out, lse) if return_lse else out


sparse_attn_func.launches = 0


def sparse_attn_varlen_func(q, k, v, block_count, block_offset, column_count, column_index, cu_seqlens_q,
                            cu_seqlens_k, max_seqlen_q: int, max_seqlen_k: int, *,
                            softmax_scale: Optional[float] = None, causal: bool = False, softcap: float = 0.0,
                            return_softmax_lse: bool = False, block_size_M: int = 64, block_size_N: int = 64):
    """Variable-length vertical + slash sparse attention (sparse_vs.py:459-586).
    q [total_q, H, D]; k / v [total_k, Hk, D] (Hk divides H); schedule arrays
    [B, H, R(, NNZ)] with R >= ceil(max_seqlen_q / block_size_M), zero-padded
    here to the rectangle's row blocks; cu_seqlens host int arrays [B+1].
    The ragged rows are placed in a [B, S, ., D] rectangle (S =
    round_up(max(max_seqlen_q, max_seqlen_k), block_size_M)), attended by
    ``sparse_attn_func`` with each sequence's kv length (kv head h // (H / Hk),
    never a repeated copy), and gathered back. With ``causal`` each sequence
    needs q_len == kv_len. Returns out [total_q, H, D] (+ lse [H, total_q]
    float32 with ``return_softmax_lse``)."""
    cu_q = np.asarray(cu_seqlens_q, np.int64)
    cu_k = np.asarray(cu_seqlens_k, np.int64)
    q_lens = cu_q[1:] - cu_q[:-1]
    k_lens = cu_k[1:] - cu_k[:-1]
    if causal and not (q_lens == k_lens).all():
        raise ValueError(f"causal sparse_attn_varlen_func needs q_len == kv_len per sequence (got "
                         f"q={q_lens.tolist()}, k={k_lens.tolist()})")
    h = q.shape[1]
    if h % k.shape[1]:
        raise ValueError(f"sparse_attn_varlen_func: {h} query heads over {k.shape[1]} kv heads")
    s = round_up(max(int(max_seqlen_q), int(max_seqlen_k)), block_size_M)
    dev = q.device

    def to_rect(x, cu):
        # [total, Hx, D] -> [B, S, Hx, D]; padding rows read a zero row
        pos = cu[:-1, None] + np.arange(s)[None, :]
        pos = np.where(pos >= cu[1:, None], x.shape[0], pos)
        xz = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
        return xz[torch.as_tensor(pos, device=dev)]

    r_rect = s // block_size_M

    def pad_r(x):
        x = _schedule(x, dev)
        if x.shape[2] < r_rect:
            pad = torch.zeros((*x.shape[:2], r_rect - x.shape[2], *x.shape[3:]), dtype=x.dtype, device=dev)
            x = torch.cat([x, pad], 2)
        return x

    res = sparse_attn_func(to_rect(q, cu_q), to_rect(k, cu_k), to_rect(v, cu_k), pad_r(block_count),
                           pad_r(block_offset), pad_r(column_count), pad_r(column_index), block_size_M=block_size_M,
                           block_size_N=block_size_N, causal=causal, sm_scale=softmax_scale, softcap=softcap,
                           return_lse=return_softmax_lse, kv_lens=torch.as_tensor(k_lens, dtype=torch.int32))
    out_r = res[0] if return_softmax_lse else res
    flat_b = torch.as_tensor(np.repeat(np.arange(len(q_lens)), q_lens), device=dev)
    flat_t = torch.as_tensor(np.concatenate([np.arange(n) for n in q_lens]) if len(q_lens) else
                             np.zeros(0, np.int64), device=dev)
    out = out_r[flat_b, flat_t]
    if return_softmax_lse:
        return out, res[1][flat_b, :, flat_t].transpose(0, 1)
    return out
