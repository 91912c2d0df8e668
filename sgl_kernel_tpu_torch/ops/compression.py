"""DeepSeek KV compression ("flash compress"): the pooling math and the
ring-buffer plans, in plain PyTorch as the JAX package has them in plain
``jnp`` (sgl_kernel_tpu/ops/compression.py; no Pallas kernel there).

A window of W latent rows is pooled into one compressed token by a
per-channel softmax over learned score channels plus an additive positional
embedding:

    w   = softmax(scores[window] + ape, axis=window)
    out = sum(kv[window] * w, axis=window)

c4 pools overlapping windows of 8 (stride 4, the first window padded with
-inf scores); c128 pools plain windows of 128. The decode plan fires an
event when a sequence's length reaches a multiple of the ratio and names
the ring slot ``(n_events - 1) % ring_size`` the pooled token goes to; the
prefill plan names every window of the stored tokens whose token the ring
keeps. Plans are int32 tensors of the JAX shapes.

The JAX functions return new pools; ``flash_compress_decode`` and its two
named forms write the ring IN PLACE and return it. A dropped write (ring
slot -1) never waits for the host (``kvcache._put_rows``), so a decode that
pools on every step can be captured in a CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device
from .kvcache import _put_rows


def compress_window(kv, scores, ape):
    """kv / scores [..., W, D]; ape [W, D]. Returns [..., D] float32."""
    s = scores.float() + ape.float()
    w = torch.softmax(s, dim=-2)
    return (kv.float() * w).sum(dim=-2)


def _default_window(ratio: int, window=None) -> int:
    return window or (2 * ratio if ratio == 4 else ratio)


def compress_sequence(kv, scores, ape, compress_ratio: int = 4):
    """A whole sequence: kv / scores [T, D] -> [T // ratio, D] in kv's dtype.

    Ratio 4: overlapping windows of 8 (the event at position 4k+3 pools
    tokens [4k-4, 4k+4), the first window padded with zero rows of -inf
    score). Any other ratio: plain windows."""
    t, d = kv.shape
    r = compress_ratio
    n = t // r
    if r == 4:
        if ape.shape[0] != 2 * r:
            raise ValueError(f"c4 pools windows of {2 * r}: ape has {ape.shape[0]} rows")
        pad_kv = torch.cat([kv.new_zeros((r, d)), kv[: n * r]])
        pad_sc = torch.cat([torch.full((r, d), float("-inf"), device=kv.device), scores[: n * r].float()])
        idx = (torch.arange(n, device=kv.device)[:, None] * r + torch.arange(2 * r, device=kv.device)[None, :])
        win_kv, win_sc = pad_kv[idx], pad_sc[idx]
    else:
        if ape.shape[0] != r:
            raise ValueError(f"ratio {r} pools windows of {r}: ape has {ape.shape[0]} rows")
        win_kv = kv[: n * r].reshape(n, r, d)
        win_sc = scores[: n * r].reshape(n, r, d)
    return compress_window(win_kv, win_sc, ape).to(kv.dtype)


def plan_compress_decode(lengths, *, compress_ratio: int = 4, ring_size: int = 64, window=None):
    """The decode step's plan from the lengths after the step [B]: (src_pos
    [B, W] the window's token positions, -1 for padding and for rows with no
    event; dst_slot [B] the ring slot, -1 when no event fires; n_comp [B]
    the live compressed tokens after the event), int32. Length 0 (a padding
    row) fires no event."""
    r = compress_ratio
    w = _default_window(r, window)
    lengths = lengths.long()
    event = (lengths % r == 0) & (lengths > 0)
    n_events = lengths // r
    src = (lengths - w)[:, None] + torch.arange(w, device=lengths.device)[None, :]
    src = torch.where(event[:, None] & (src >= 0), src, -1)
    dst = torch.where(event, (n_events - 1) % ring_size, -1)
    return src.int(), dst.int(), torch.clamp(n_events, max=ring_size).int()


def _flat_rows(page_tables, pos, page_size: int):
    """Token positions [B, N] (>= 0) -> flat pool rows through the page
    tables [B, max_pages]; a page index past the table is clamped."""
    page = torch.clamp(pos // page_size, max=page_tables.shape[1] - 1)
    return page_tables.long().gather(1, page) * page_size + pos % page_size


def flash_compress_decode(kv_pool, score_pool, ape, comp_pool, src_pos, dst_slot, page_tables, *, page_size: int):
    """Apply a decode plan: kv_pool / score_pool flat token pools [P*page, D];
    comp_pool [B, ring, D]; src_pos [B, W] token positions read through
    page_tables [B, max_pages]; dst_slot [B] (-1: no event, no write). The
    pooled rows go into comp_pool in place. Returns comp_pool."""
    b = src_pos.shape[0]
    d = kv_pool.shape[-1]
    src = src_pos.to(kv_pool.device).long()
    valid = src >= 0
    flat = _flat_rows(page_tables.to(kv_pool.device), torch.where(valid, src, 0), page_size)
    sc = torch.where(valid[..., None], score_pool[flat].float(), float("-inf"))
    out = compress_window(kv_pool[flat], sc, ape)
    ring = comp_pool.shape[1]
    dst = dst_slot.to(kv_pool.device).long()
    rows = torch.where((dst >= 0) & (dst < ring), torch.arange(b, device=dst.device) * ring + dst, -1)
    _put_rows(comp_pool.view(-1, d), rows, out)
    return comp_pool


def flash_compress4_decode(kv_pool, score_pool, ape, comp_pool, lengths, page_tables, *, page_size: int,
                           ring_size: int = 64):
    """c4's decode step: the plan for ``lengths`` (an event at each multiple
    of 4, the last 8 tokens pooled), applied. ape [8, D]. Returns
    (comp_pool, n_comp)."""
    src, dst, n_comp = plan_compress_decode(lengths, compress_ratio=4, ring_size=ring_size)
    return flash_compress_decode(kv_pool, score_pool, ape, comp_pool, src, dst, page_tables,
                                 page_size=page_size), n_comp


def flash_compress128_decode(kv_pool, score_pool, ape, comp_pool, lengths, page_tables, *, page_size: int,
                             ring_size: int = 64):
    """c128's decode step: an event at each multiple of 128, the last 128
    tokens pooled (plain windows). ape [128, D]. Returns (comp_pool,
    n_comp)."""
    src, dst, n_comp = plan_compress_decode(lengths, compress_ratio=128, ring_size=ring_size)
    return flash_compress_decode(kv_pool, score_pool, ape, comp_pool, src, dst, page_tables,
                                 page_size=page_size), n_comp


def flash_compress4_prefill(kv, scores, ape):
    """c4 over a whole sequence (overlapping windows of 8, stride 4)."""
    return compress_sequence(kv, scores, ape, compress_ratio=4)


def flash_compress128_prefill(kv, scores, ape):
    """c128 over a whole sequence (plain windows of 128)."""
    return compress_sequence(kv, scores, ape, compress_ratio=128)


def c4_window_dual(rows, ape):
    """c4 pooling over dual-channel token rows [..., 8, 4*hd] laid out as
    [kv_overlap | kv_fresh | sc_overlap | sc_fresh]: the window's older half
    (rows 0-3) reads the overlap channels, the fresh half (rows 4-7) the
    fresh ones, so a token gives each of its two windows its own
    projection. ape [8, hd]; a padding row has -inf in its score channels.
    Returns [..., hd] float32."""
    hd = ape.shape[-1]
    if rows.shape[-2] != 8 or rows.shape[-1] != 4 * hd:
        raise ValueError(f"c4 dual rows must be [..., 8, {4 * hd}], got {tuple(rows.shape)}")
    kv = torch.cat([rows[..., :4, :hd], rows[..., 4:, hd: 2 * hd]], dim=-2)
    sc = torch.cat([rows[..., :4, 2 * hd: 3 * hd], rows[..., 4:, 3 * hd:]], dim=-2)
    return compress_window(kv, sc, ape)


def compress_sequence_c4_dual(rows, ape):
    """c4 over a whole sequence of dual-channel rows [T, 4*hd] ->
    [T // 4, hd] in the rows' dtype; the first window's missing overlap half
    is zero rows of -inf score."""
    t, elem = rows.shape
    hd = elem // 4
    n = t // 4
    neg = torch.zeros((4, elem), device=rows.device)
    neg[:, 2 * hd:] = float("-inf")
    pad = torch.cat([neg, rows[: n * 4].float()])
    idx = torch.arange(n, device=rows.device)[:, None] * 4 + torch.arange(8, device=rows.device)[None, :]
    return c4_window_dual(pad[idx], ape).to(rows.dtype)


def plan_compress_prefill(lengths, *, compress_ratio: int = 4, ring_size: int = 64, window=None):
    """The prefill plan: every window of the stored tokens that the ring
    keeps (the last ``ring_size`` events). Returns (src_pos [B, ring, W],
    dst_slot [B, ring] with -1 past a sequence's count, n_comp [B]), int32."""
    r = compress_ratio
    w = _default_window(r, window)
    lengths = lengths.long()
    dev = lengths.device
    n_events = lengths // r
    eid = torch.clamp(n_events - ring_size, min=0)[:, None] + torch.arange(ring_size, device=dev)[None, :]
    live = eid < n_events[:, None]
    src = ((eid + 1) * r)[:, :, None] - w + torch.arange(w, device=dev)[None, None, :]
    src = torch.where(live[:, :, None] & (src >= 0), src, -1)
    dst = torch.where(live, eid % ring_size, -1)
    return src.int(), dst.int(), torch.clamp(n_events, max=ring_size).int()


# The legacy plans (before the ring): fixed addressing per request. c4
# double-buffers two 4-token pages a request (page rid*2 + ((pos // 4) & 1));
# other ratios keep one page a request.


def _legacy_page(rid, position, compress_ratio: int):
    if compress_ratio == 4:
        return rid * 2 + ((position // 4) & 1)
    return rid


def _legacy_loc(rid, position, compress_ratio: int):
    return _legacy_page(rid, position, compress_ratio) * compress_ratio + position % compress_ratio


def plan_compress_decode_legacy(req_pool_indices, seq_lens, compress_ratio: int = 4):
    """The decode step's legacy plan: [seq_len, write_loc, read_page(pos0),
    read_page(pos1)] a request, int32 [B, 4]."""
    rid = req_pool_indices.int()
    seq = seq_lens.int().to(rid.device)
    pos1 = seq - 1
    pos0 = torch.clamp(pos1 - compress_ratio, min=0)
    return torch.stack([seq, _legacy_loc(rid, pos1, compress_ratio), _legacy_page(rid, pos0, compress_ratio),
                        _legacy_page(rid, pos1, compress_ratio)], dim=1)


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def plan_compress_prefill_legacy(req_pool_indices, seq_lens, extend_lens, num_q_tokens: int,
                                 compress_ratio: int = 4, *, device="cuda"):
    """The prefill legacy plan, built on the host as the reference builds it.
    Returns (plan_c [num_c, 4], plan_w [num_w, 2]) int32 on ``device``:
    plan_c a row per compress event (a token whose 1-based position is a
    ratio multiple): [position + 1, (buffer_len << 16) | ragged_id,
    legacy_page(pos0), legacy_page(pos1)], buffer_len the window tokens read
    from the state buffer; plan_w a row per token in the current window
    region: [ragged_id, legacy_loc(position)]."""
    dev = resolve_device(device)
    is_overlap = compress_ratio == 4
    window = compress_ratio * (2 if is_overlap else 1)
    rids, seqs, exts = (_host(a).astype(np.int64) for a in (req_pool_indices, seq_lens, extend_lens))
    c_rows, w_rows = [], []
    counter = 0
    for b, (sl, el) in enumerate(zip(seqs, exts)):
        prefix_len = int(sl - el)
        last_c_pos = (int(sl) // compress_ratio) * compress_ratio
        first_w_pos = last_c_pos - (compress_ratio if is_overlap else 0)
        rid = int(rids[b])
        for j in range(int(el)):
            position = prefix_len + j
            ragged_id = counter + j
            if (position + 1) % compress_ratio == 0:
                buffer_len = window - min(j + 1, window)
                pos0 = max(position - compress_ratio, 0)
                c_rows.append((position + 1, ((buffer_len & 0xFFFF) << 16) | (ragged_id & 0xFFFF),
                               _legacy_page(rid, pos0, compress_ratio), _legacy_page(rid, position, compress_ratio)))
            if position >= first_w_pos:
                w_rows.append((ragged_id & 0xFFFF, _legacy_loc(rid, position, compress_ratio)))
        counter += int(el)
    if counter > num_q_tokens:
        raise ValueError(f"the extends hold {counter} tokens, more than num_q_tokens={num_q_tokens}")
    plan_c = np.asarray(c_rows, np.int32).reshape(-1, 4)
    plan_w = np.asarray(w_rows, np.int32).reshape(-1, 2)
    return torch.from_numpy(plan_c).to(dev), torch.from_numpy(plan_w).to(dev)
