"""Token-packed (block-aligned) flash-attention prefill.

Each sequence of a prefill batch starts at a multiple of ``block`` tokens,
so a packed q block belongs to exactly one sequence and a mixed batch pays
less than ``block`` tokens of padding per sequence instead of padding every
prompt to the longest. Per-block metadata maps blocks to sequences:
``blk_seq`` / ``blk_q0`` [NQB] and ``seq_meta`` [B, 6] rows (q_len, kv_len,
q_start, kv_start, kv_blk0, kv_blks).

``flash_attention_packed`` is kernel K9, CUDA C++ in ``csrc/flash_packed.cu``,
replacing the Pallas ``flash_attention_packed``
(sgl_kernel_tpu/ops/attention/flash_packed.py:195, pallas_call at :292).
``flash_attention_packed_ref`` is its plain PyTorch twin. Both cover the
whole JAX contract (causal with q_start / kv_start, window, softcap, sinks,
base-2 lse); at head dim 576 the kernel takes no option and raises on one.
``flash_attention_packed_mla`` is the same at head dim 576 with V the first
512 columns of K (DeepSeek's packed MLA prefill): no padded V is built and
the output is the 512 columns the model reads;
``flash_attention_packed_mla_ref`` is its twin. The host helpers
(``build_packed_metadata``, ``make_seq_meta``, ``pack_padded``,
``unpack_to_padded``) are numpy and give the JAX package's bytes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ... import _build
from ...utils import cdiv, round_up
from .flash_prefill import D_MLA, DV_MLA, LOG2E, OPTIONS, kernel_options


def build_packed_metadata(q_lens, kv_lens=None, *, block: int = 256):
    """Host-side packing plan (numpy). Returns a dict with
      blk_seq    [NQB] sequence id of each packed q block
      blk_q0     [NQB] in-sequence token index of the block's row 0
      seq_tok0   [B]   packed token offset of each sequence (q side)
      seq_kvblk0 [B]   first packed kv block of each sequence
      nkvb       [B]   kv blocks of each sequence
      total_q / total_kv  packed sizes (sums of block-rounded lens)
      max_kvb    max kv blocks over the sequences.
    kv defaults to the q packing (self-attention prefill)."""
    q_lens = np.asarray(q_lens, np.int32)
    kv_lens = q_lens if kv_lens is None else np.asarray(kv_lens, np.int32)
    nqb = np.maximum(cdiv(q_lens, block), 1)
    nkvb = np.maximum(cdiv(kv_lens, block), 1)
    qblk0 = np.concatenate([[0], np.cumsum(nqb)])[:-1].astype(np.int32)
    kvblk0 = np.concatenate([[0], np.cumsum(nkvb)])[:-1].astype(np.int32)
    blk_seq = np.repeat(np.arange(len(q_lens), dtype=np.int32), nqb)
    blk_q0 = (np.arange(len(blk_seq), dtype=np.int32) - qblk0[blk_seq]) * block
    return dict(
        blk_seq=blk_seq,
        blk_q0=blk_q0,
        seq_tok0=qblk0 * block,
        seq_kvblk0=kvblk0,
        nkvb=nkvb,
        total_q=int(nqb.sum()) * block,
        total_kv=int(nkvb.sum()) * block,
        max_kvb=int(nkvb.max()),
    )


def make_seq_meta(q_lens, kv_lens=None, q_start=None, kv_start=None, *, block: int = 256):
    """The [B, 6] seq_meta rows from host metadata (numpy); returns
    (seq_meta, build_packed_metadata's dict)."""
    meta = build_packed_metadata(q_lens, kv_lens, block=block)
    q_lens = np.asarray(q_lens, np.int32)
    kv_lens = q_lens if kv_lens is None else np.asarray(kv_lens, np.int32)
    q_start = (kv_lens - q_lens) if q_start is None else np.asarray(q_start, np.int32)
    kv_start = np.zeros_like(q_lens) if kv_start is None else np.asarray(kv_start, np.int32)
    return (
        np.stack([q_lens, kv_lens, q_start, kv_start, meta["seq_kvblk0"], meta["nkvb"]], axis=1),
        meta,
    )


def pack_padded(x: torch.Tensor, lens, *, block: int = 256):
    """[B, S, ...] padded batch -> block-aligned packed [TP, ...] (a test and
    convenience helper: the engine packs on the host). Returns (packed, meta)."""
    lens = np.asarray(lens, np.int32)
    meta = build_packed_metadata(lens, block=block)
    s = x.shape[1]
    rows = []
    for i in range(x.shape[0]):
        n = round_up(max(int(lens[i]), 1), block)
        seg = x[i, : min(n, s)]
        if n > s:
            seg = torch.cat([seg, seg.new_zeros((n - s,) + tuple(x.shape[2:]))])
        rows.append(seg)
    return torch.cat(rows), meta


def unpack_to_padded(xp: torch.Tensor, lens, s: int, *, block: int = 256):
    """Inverse of pack_padded onto a [B, S, ...] zero-padded batch."""
    lens = np.asarray(lens, np.int32)
    meta = build_packed_metadata(lens, block=block)
    outs = []
    for i, t0 in enumerate(meta["seq_tok0"].tolist()):
        n = round_up(max(int(lens[i]), 1), block)
        seg = xp[t0: t0 + min(n, s)]
        if n < s:
            seg = torch.cat([seg, seg.new_zeros((s - n,) + tuple(xp.shape[1:]))])
        outs.append(seg[:s])
    return torch.stack(outs)


def flash_attention_packed_ref(q, k, v, blk_seq, blk_q0, seq_meta, *, max_kvb: int, causal: bool = True,
                               sm_scale: Optional[float] = None, sliding_window: Optional[int] = None,
                               logit_soft_cap: Optional[float] = None, sinks=None, return_lse: bool = False,
                               block: int = 256):
    """Plain PyTorch twin of ``flash_attention_packed``: each q block against
    its sequence's keys, dense f32 scores. Rows past q_len see no key (o = 0,
    lse -1e30 * log2(e)); keys past min(kv_len, kv_blks, max_kvb blocks) are
    not seen. Sinks join the sum of a row that sees a key only."""
    tp, hq, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    if tp % block or blk_seq.shape[0] != tp // block:
        raise ValueError(f"flash_attention_packed: {blk_seq.shape[0]} q blocks for {tp} tokens of block {block}")
    out = q.new_empty(q.shape[:-1] + v.shape[-1:])
    lse = torch.empty((hq, tp), dtype=torch.float32, device=q.device)
    metas = seq_meta.to(torch.int64).tolist()
    snk = None if sinks is None else sinks.float().to(q.device)[:, None]
    rows = torch.arange(block, device=q.device)
    for nb, (seq, q0) in enumerate(zip(blk_seq.tolist(), blk_q0.tolist())):
        q_len, kv_len, q_start, kv_start, kv_blk0, kv_blks = metas[seq]
        n_kv = max(0, min(kv_len, kv_blks * block, max_kvb * block))
        k0 = kv_blk0 * block
        qb = q[nb * block: (nb + 1) * block].float()                       # [bq, Hq, D]
        kb = k[k0: k0 + n_kv].float().repeat_interleave(group, dim=1)      # [n, Hq, D]
        vb = v[k0: k0 + n_kv].float().repeat_interleave(group, dim=1)
        s = torch.einsum("ihd,jhd->hij", qb, kb) * scale
        if logit_soft_cap is not None:
            s = logit_soft_cap * torch.tanh(s / logit_soft_cap)
        r = rows + q0
        q_pos = (r + q_start)[:, None]
        kv_pos = torch.arange(n_kv, device=q.device)[None, :] + kv_start
        mask = (r < q_len)[:, None].expand(block, n_kv)
        if causal:
            mask = mask & (kv_pos <= q_pos)
        if sliding_window is not None:
            mask = mask & (kv_pos > q_pos - sliding_window)
        s = s.masked_fill(~mask[None], float("-inf"))
        m = (s.amax(dim=-1) if n_kv else s.new_full(s.shape[:2], float("-inf"))).clamp_min(-1e30)  # [H, bq]
        p = torch.exp(s - m[..., None])
        l = p.sum(dim=-1)
        if snk is not None:
            l = torch.where(l > 0, l + torch.exp(snk - m), l)
        o = torch.einsum("hij,jhd->ihd", p, vb)
        l_inv = torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
        out[nb * block: (nb + 1) * block] = (o * l_inv.t()[..., None]).to(q.dtype)
        lse[:, nb * block: (nb + 1) * block] = (m + torch.log(l.clamp_min(1e-38))) * LOG2E
    return (out, lse) if return_lse else out


_ARGS = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 7 + (ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float)
         + (ctypes.c_void_p,) * 2)


def flash_attention_packed(q, k, v, blk_seq, blk_q0, seq_meta, *, max_kvb: int, causal: bool = True,
                           sm_scale: Optional[float] = None, sliding_window: Optional[int] = None,
                           logit_soft_cap: Optional[float] = None, sinks=None, return_lse: bool = False,
                           block: int = 256):
    """Block-aligned packed flash attention. q [TPq, Hq, D], k/v [TPkv, Hkv, D]
    packed by ``build_packed_metadata`` / ``pack_padded``; blk_seq / blk_q0
    [NQB] and seq_meta [B, 6] int32; ``max_kvb`` caps the kv blocks a
    sequence may see (the TPU grid's kv extent). Returns out [TPq, Hq, D]
    (+ lse [Hq, TPq] float32 base 2 when return_lse). CUDA tensors go through
    the K9 kernel, which takes bf16, head_dim 64, 128 or 576 (576: the MLA
    prefill, with Hq / Hkv dividing 16 or a multiple of 16, and none of
    window, softcap and sinks) and a block that is a multiple of 64. Each
    launch counts in ``launches`` and under each option it takes in
    ``launches_by_option``."""
    if q.device.type != "cuda":
        return flash_attention_packed_ref(
            q, k, v, blk_seq, blk_q0, seq_meta, max_kvb=max_kvb, causal=causal, sm_scale=sm_scale,
            sliding_window=sliding_window, logit_soft_cap=logit_soft_cap, sinks=sinks,
            return_lse=return_lse, block=block)
    tp, hq, d = q.shape
    hkv = k.shape[1]
    if (hq % hkv or d not in (64, 128, 576) or k.shape != v.shape or k.shape[2] != d or block % 64
            or (d == 576 and 16 % (hq // hkv) and (hq // hkv) % 16)
            or tp % block or k.shape[0] % block or blk_seq.shape[0] != tp // block):
        raise ValueError(f"flash_attention_packed: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"blocks {tuple(blk_seq.shape)} of {block}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise NotImplementedError("flash_attention_packed: the CUDA kernel takes bf16")
    window, cap, sinks, used = kernel_options(d, hq, q.device, sinks, sliding_window, logit_soft_cap,
                                              "flash_attention_packed")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    ints = [t.to(device=q.device, dtype=torch.int32).contiguous() for t in (blk_seq, blk_q0, seq_meta)]
    out = torch.empty_like(q)
    lse = torch.empty((hq, tp), dtype=torch.float32, device=q.device) if return_lse else None
    scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    fn = _build.bind("flash_packed", "skt_flash_packed", _ARGS)
    _build.check(fn(q.data_ptr(), None, k.data_ptr(), v.data_ptr(), *(t.data_ptr() for t in ints), out.data_ptr(),
                    None if lse is None else lse.data_ptr(), tp // block, block, hq, hkv, d, int(max_kvb),
                    int(causal), scale, k.shape[0], window, cap, None if sinks is None else sinks.data_ptr(),
                    _build.stream_ptr(q.device)),
                 "flash_attention_packed")
    flash_attention_packed.launches += 1
    flash_attention_packed.launches_576 += d == 576  # the 576-wide tile (mla_flash_tile.cuh), counted apart
    for o in used:
        flash_attention_packed.launches_by_option[o] += 1
    return (out, lse) if return_lse else out


flash_attention_packed.launches = 0
flash_attention_packed.launches_576 = 0
# launches that took each option (a launch with two counts under both)
flash_attention_packed.launches_by_option = dict.fromkeys(OPTIONS, 0)


def flash_attention_packed_mla_ref(q_nope, q_pe, kv, blk_seq, blk_q0, seq_meta, *, max_kvb: int, causal: bool = True,
                                   sm_scale: Optional[float] = None, return_lse: bool = False, block: int = 256):
    """Plain twin of ``flash_attention_packed_mla``:
    ``flash_attention_packed_ref`` with q = [q_nope | q_pe] and V the first
    512 columns of ``kv``."""
    return flash_attention_packed_ref(torch.cat([q_nope, q_pe], dim=-1), kv, kv[..., :DV_MLA], blk_seq, blk_q0,
                                      seq_meta, max_kvb=max_kvb, causal=causal, sm_scale=sm_scale,
                                      return_lse=return_lse, block=block)


def flash_attention_packed_mla(q_nope, q_pe, kv, blk_seq, blk_q0, seq_meta, *, max_kvb: int, causal: bool = True,
                               sm_scale: Optional[float] = None, return_lse: bool = False, block: int = 256):
    """``flash_attention_packed(q, kv, v)`` with q = [q_nope | q_pe] and v
    the first 512 columns of kv zero-padded to 576, returning only the first
    512 output columns: q_nope [TPq, Hq, 512], q_pe [TPq, Hq, 64], kv [TPkv,
    Hkv, 576]; returns out [TPq, Hq, 512] (+ lse [Hq, TPq] base 2). CUDA
    tensors go through K9's 576 tile, which reads q's two parts where they
    lie and V from K's own boxes, counted on ``flash_attention_packed``."""
    if q_nope.device.type != "cuda":
        return flash_attention_packed_mla_ref(q_nope, q_pe, kv, blk_seq, blk_q0, seq_meta, max_kvb=max_kvb,
                                              causal=causal, sm_scale=sm_scale, return_lse=return_lse, block=block)
    tp, hq, dn = q_nope.shape
    hkv = kv.shape[1]
    if (dn != DV_MLA or tuple(q_pe.shape) != (tp, hq, D_MLA - DV_MLA) or kv.shape[2] != D_MLA or hq % hkv
            or (16 % (hq // hkv) and (hq // hkv) % 16) or block % 64 or tp % block or kv.shape[0] % block
            or blk_seq.shape[0] != tp // block):
        raise ValueError(f"flash_attention_packed_mla: unsupported shapes q_nope {tuple(q_nope.shape)} q_pe "
                         f"{tuple(q_pe.shape)} kv {tuple(kv.shape)} blocks {tuple(blk_seq.shape)} of {block}")
    if not (q_nope.dtype == q_pe.dtype == kv.dtype == torch.bfloat16):
        raise NotImplementedError("flash_attention_packed_mla: the CUDA kernel takes bf16")
    q_nope, q_pe, kv = q_nope.contiguous(), q_pe.contiguous(), kv.contiguous()
    ints = [t.to(device=q_nope.device, dtype=torch.int32).contiguous() for t in (blk_seq, blk_q0, seq_meta)]
    out = q_nope.new_empty((tp, hq, DV_MLA))
    lse = torch.empty((hq, tp), dtype=torch.float32, device=q_nope.device) if return_lse else None
    scale = sm_scale if sm_scale is not None else 1.0 / D_MLA ** 0.5
    fn = _build.bind("flash_packed", "skt_flash_packed", _ARGS)
    _build.check(fn(q_nope.data_ptr(), q_pe.data_ptr(), kv.data_ptr(), None, *(t.data_ptr() for t in ints),
                    out.data_ptr(), None if lse is None else lse.data_ptr(), tp // block, block, hq, hkv, D_MLA,
                    int(max_kvb), int(causal), scale, kv.shape[0], 0, 0.0, None, _build.stream_ptr(q_nope.device)),
                 "flash_attention_packed_mla")
    flash_attention_packed.launches += 1
    flash_attention_packed.launches_576 += 1
    return (out, lse) if return_lse else out
