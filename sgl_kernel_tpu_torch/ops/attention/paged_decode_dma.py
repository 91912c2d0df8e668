"""Paged-KV decode attention.

``paged_attention_decode_dma`` is kernel K5, CUDA C++ in
``csrc/decode_attention.cu``, replacing the Pallas
``paged_attention_decode_dma``
(sgl_kernel_tpu/ops/attention/paged_decode_dma.py:306, pallas_call at
:461). ``paged_attention_decode_ref`` is its plain PyTorch twin. Both take
the JAX contract: page-major ``[L, P, Hkv, page, D]`` or head-major
``[L, Hkv, P, page, D]`` pools (``layout``), sinks, sliding window, soft
cap, per-tensor k/v scales, the base-2 lse and split-KV (``num_splits``
over chunks of ``chunk_pages`` pages, merged by ``merge_states``). The
kernel takes bf16 q and bf16, int8, fp8 e4m3 and e5m2 pools and raises on
the rest. The same kernel serves K8 (``paged_decode.py``) over head-major
pools. The name keeps the JAX module's: the kernel streams pages, but no
longer by manual DMA.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import _build
from ...utils import cdiv, kept_buffer, sm_count
from .merge_state import merge_states

LOG2E = 1.4426950408889634


def choose_num_splits(batch: int, max_context: int, page: int, chunk_pages: int,
                      num_cores: int = 1) -> int:
    """Split-KV factor (JAX paged_decode_dma.py:285-298): splits only pay
    when the batch leaves compute units idle, here the card's SMs (pass
    ``utils.sm_count()`` as ``num_cores``)."""
    if num_cores <= 1 or batch >= num_cores:
        return 1
    n_chunks = cdiv(max_context, page * chunk_pages)
    return max(1, min(num_cores // batch, n_chunks // 2))


def split_geometry(n_blocks: int, page: int, hkv: int, chunk_pages: int, num_splits: int):
    """(splits, pool tokens a split) as the JAX kernel cuts them
    (paged_decode_dma.py:354-384): chunks of ``cpp`` pages, capped so a
    chunk's K/V stays ~8K rows, the table padded to whole chunks, each
    split ``cdiv(n_chunks, splits)`` chunks."""
    n_blocks = max(n_blocks, 1)
    span_tokens = max(page, 1024 * 8 // max(hkv, 1))
    cpp = min(chunk_pages, n_blocks, max(1, span_tokens // page))
    n_chunks = cdiv(n_blocks, cpp)
    splits = max(1, min(num_splits, n_chunks))
    return splits, cdiv(n_chunks, splits) * cpp * page


UNIT_TOKENS = 64  # pool tokens of one unit of the card's kernel (csrc/decode_attention.cu, kTok)


def work_units(lengths, n_blocks: int, page: int, num_splits: int, split_tokens: int, *, hkv: int,
               grid: int, fresh: bool = True, window: Optional[int] = None):
    """The card kernel's division of work, in plain Python (the kernel
    computes it on the device from the lengths): item (split s, sequence b)
    covers pool tokens [lo, hi) in units of 64 aligned tokens (one empty
    unit when hi <= lo); unit u = Hkv * pre[i] + h * n_i + j over items i,
    heads h and units j; of the ``grid`` blocks the first g = min(grid, U)
    take [U c / g, U (c + 1) / g) each, the rest nothing. Returns (units,
    blocks, runs): units[i] = (lo, hi, j0, n); blocks[c] = (u0, u1);
    runs[(i, h)] = (first block, last block, [the partial slot of each
    contributing block]): a run one block holds whole needs no slot, else
    slot 0 where the run is the block's first and 1 where it is its last."""
    if num_splits <= 1:
        split_tokens = 1 << 30
    units, pre = [], [0]
    for s in range(num_splits):
        for length in lengths:
            n = max(0, min(length - 1 if fresh else length, n_blocks * page))
            lo = max(s * split_tokens, length - window if window is not None else 0)
            hi = min(n, (s + 1) * split_tokens)
            j0, cnt = (lo // UNIT_TOKENS, cdiv(hi, UNIT_TOKENS) - lo // UNIT_TOKENS) if hi > lo else (0, 1)
            units.append((lo, hi, j0, cnt))
            pre.append(pre[-1] + cnt)
    total = hkv * pre[-1]
    grid = min(grid, total)
    blocks = [(total * c // grid, total * (c + 1) // grid) for c in range(grid)]
    block_of = lambda u: ((u + 1) * grid + total - 1) // total - 1
    runs = {}
    for i, (_, _, _, cnt) in enumerate(units):
        for h in range(hkv):
            us = hkv * pre[i] + h * cnt
            cf, cl = block_of(us), block_of(us + cnt - 1)
            slots = [] if cf == cl else [1 if c == cf and blocks[c][0] < us else 0 for c in range(cf, cl + 1)]
            runs[(i, h)] = (cf, cl, slots)
    return units, blocks, runs


def _layer_view(pages, layer_id, layout):
    """One layer of a pool, page-major [P, Hkv, page, D] (a view)."""
    if pages.ndim == 4:
        pages = pages[None]
    p = pages[0 if layer_id is None else int(layer_id)]
    return p.transpose(0, 1) if layout == "head" else p


def paged_attention_decode_ref(q, k_pages, v_pages, lengths, page_table, sinks=None,
                               k_scale=None, v_scale=None, layer_id=None, fresh_k=None,
                               fresh_v=None, *, sm_scale: Optional[float] = None,
                               sliding_window: Optional[int] = None,
                               logit_soft_cap: Optional[float] = None,
                               return_lse: bool = False, chunk_pages: int = 16,
                               num_splits: int = 1, layout: str = "page"):
    """Plain PyTorch twin of ``paged_attention_decode_dma`` (gathers the
    pages the longest sequence uses, dense f32 scores). Pool values convert
    exactly to float32; the per-tensor scales round where the JAX function
    rounds (paged_decode_dma.py:392-405, :498-499): q * k_scale and
    fresh_k / k_scale, fresh_v / v_scale to the input dtypes, the output
    times v_scale again to q's dtype. With splits, each split's partial is
    normalized and rounded to q's dtype, the fresh row and the sinks join
    the last split, and ``merge_states`` combines them (:432, :488-);
    a row with no pool token and no fresh row gives o = 0, lse = -inf
    (JAX's merge gives NaN there). A sink joins the softmax as a logit with
    no value: the same as JAX's ``l + exp(sink - m)``, finite where m is."""
    if layout not in ("page", "head"):
        raise ValueError(f"paged_attention_decode: layout must be 'page' or 'head', got {layout!r}")
    b, hq, d = q.shape
    kp, vp = _layer_view(k_pages, layer_id, layout), _layer_view(v_pages, layer_id, layout)
    n_pages, hkv, page, _ = kp.shape
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    splits, split_tokens = split_geometry(page_table.shape[1], page, hkv, chunk_pages, num_splits)
    lengths = lengths.to(q.device).long()
    limit = lengths - 1 if fresh_k is not None else lengths
    nb = min(page_table.shape[1], max(1, cdiv(int(limit.max().clamp_min(0)), page)))
    pt = page_table[:, :nb].to(q.device).long().clamp(0, n_pages - 1)
    # [B, nb, Hkv, page, D] -> [B, Hkv, nb*page, D]
    kg = kp[pt].permute(0, 2, 1, 3, 4).reshape(b, hkv, nb * page, d).float()
    vg = vp[pt].permute(0, 2, 1, 3, 4).reshape(b, hkv, nb * page, d).float()
    qh = q.reshape(b, hkv, group, d).float()
    if k_scale is not None:
        # the scale folds into q; the unquantized fresh row is compensated
        qh = (qh * float(k_scale)).to(q.dtype).float()
        if fresh_k is not None:
            fresh_k = (fresh_k.float() / float(k_scale)).to(fresh_k.dtype)
    if v_scale is not None and fresh_v is not None:
        fresh_v = (fresh_v.float() / float(v_scale)).to(fresh_v.dtype)
    s = torch.einsum("bhgd,bhtd->bhgt", qh, kg) * scale
    pos = torch.arange(nb * page, device=q.device)
    mask = pos[None, :] < limit[:, None]
    if sliding_window is not None:
        mask = mask & (pos[None, :] > (lengths - 1 - sliding_window)[:, None])
    split_of = pos // split_tokens
    if fresh_k is not None:
        sf = torch.einsum("bhgd,bhd->bhg", qh, fresh_k.reshape(b, hkv, d).float()) * scale
        s = torch.cat([s, sf[..., None]], dim=-1)
        vg = torch.cat([vg, fresh_v.reshape(b, hkv, 1, d).float()], dim=2)
        mask = torch.cat([mask, torch.ones((b, 1), dtype=torch.bool, device=q.device)], dim=1)
        split_of = torch.cat([split_of, torch.full((1,), splits - 1, device=q.device)])
    if logit_soft_cap is not None:
        s = logit_soft_cap * torch.tanh(s / logit_soft_cap)
    sink = sinks.float().to(q.device).reshape(1, hkv, group, 1) if sinks is not None else None
    parts_o, parts_lse = [], []
    for i in range(splits):
        mi = mask & (split_of == i)[None, :]
        si = s.masked_fill(~mi[:, None, None, :], float("-inf"))
        m = si.amax(dim=-1, keepdim=True).clamp_min(-1e30)
        if sink is not None and i == splits - 1:
            m = torch.maximum(m, sink)
        p = torch.exp(si - m)
        l = p.sum(dim=-1, keepdim=True)
        if sink is not None and i == splits - 1:
            l = l + torch.exp(sink - m)
        o = torch.einsum("bhgt,bhtd->bhgd", p, vg)
        o = torch.where(l == 0, torch.zeros_like(o), o / l)
        lse = torch.where(l == 0, torch.full_like(l, float("-inf")), (m + torch.log(l)) * LOG2E)
        parts_o.append(o.reshape(b, hq, d).to(q.dtype))
        parts_lse.append(lse.reshape(b, hq))
    if splits == 1:
        out, lse = parts_o[0], parts_lse[0]
    else:
        out, lse = _merge_splits(torch.stack(parts_o), torch.stack(parts_lse), q.dtype)
    if v_scale is not None:
        out = (out.float() * float(v_scale)).to(q.dtype)
    return (out, lse) if return_lse else out


def _merge_splits(o_parts, lse_parts, dtype):
    """Split partials [S, B, Hq, D] / [S, B, Hq] -> (o in ``dtype``, lse),
    with o = 0 and lse = -inf where every split is empty."""
    o, lse = merge_states(o_parts.float(), lse_parts)
    empty = torch.isneginf(lse_parts.amax(dim=0))
    o = o.masked_fill(empty[..., None], 0.0)
    lse = lse.masked_fill(empty, float("-inf"))
    return o.to(dtype), lse


_ARGS = ((ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 7 + (ctypes.c_longlong,) * 4 + (ctypes.c_int,) * 4
         + (ctypes.c_float,) * 5 + (ctypes.c_int, ctypes.c_void_p))
# blocks an SM the kernel's partials workspace is sized for (the grid is
# at most this many blocks an SM)
_BLOCKS_PER_SM = 4
# pool dtypes of the kernel (csrc/decode_attention.cu)
_POOL_TYPES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}


def launch_decode(name, q, k_pages, v_pages, lengths, page_table, sinks, k_scale, v_scale, layer_id,
                  fresh_k, fresh_v, *, sm_scale, sliding_window, logit_soft_cap, return_lse, chunk_pages,
                  num_splits, layout):
    """Checks and one launch of the decode kernel on CUDA tensors (K5 and
    K8 both come here); the caller counts the launch."""
    if layout not in ("page", "head"):
        raise ValueError(f"{name}: layout must be 'page' or 'head', got {layout!r}")
    if k_pages.ndim == 4:
        k_pages, v_pages = k_pages[None], v_pages[None]
    b, hq, d = q.shape
    if layout == "head":
        _, hkv, n_pages, page, _ = k_pages.shape
        page_stride, head_stride = page * d, n_pages * page * d
    else:
        _, n_pages, hkv, page, _ = k_pages.shape
        page_stride, head_stride = hkv * page * d, page * d
    group = hq // hkv
    if hq % hkv or group not in (1, 2, 4, 8) or d not in (64, 128, 256) or k_pages.shape[-1] != d:
        raise ValueError(f"{name}: unsupported q {tuple(q.shape)} pools {tuple(k_pages.shape)}")
    if q.dtype != torch.bfloat16 or k_pages.dtype != v_pages.dtype or k_pages.dtype not in _POOL_TYPES:
        raise NotImplementedError(f"{name}: the CUDA kernel takes bf16 q and bf16, int8, float8_e4m3fn "
                                  "or float8_e5m2 pools")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()) or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: pools must be contiguous and of one shape")
    lid = 0 if layer_id is None else int(layer_id)
    if fresh_k is not None:
        fk = fresh_k.reshape(b, hkv, d).to(torch.bfloat16).contiguous()
        fv = fresh_v.reshape(b, hkv, d).to(torch.bfloat16).contiguous()
        fk_ptr, fv_ptr = fk.data_ptr(), fv.data_ptr()
    else:
        fk_ptr = fv_ptr = None
    sk = sinks.float().reshape(hq).contiguous() if sinks is not None else None
    q = q.contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    table = page_table.to(device=q.device, dtype=torch.int32)
    if table.shape[1] == 0:  # nothing in the pool yet: one padding column (JAX :345-350)
        table = torch.zeros((b, 1), dtype=torch.int32, device=q.device)
    table = table.contiguous()
    if page % 8 or (page % 64 and 64 % page):
        raise NotImplementedError(f"{name}: the CUDA kernel takes pages of a multiple of 8 tokens that divides 64 "
                                  f"or is a multiple of 64, not {page}")
    splits, split_tokens = split_geometry(table.shape[1], page, hkv, chunk_pages, num_splits)
    out = torch.empty((splits, b, hq, d), dtype=q.dtype, device=q.device)
    ws_blocks = _BLOCKS_PER_SM * sm_count(q.device.index or 0)
    ws = torch.empty((ws_blocks * 2 * (group * d + 2 * group),), dtype=torch.float32, device=q.device)
    counters = kept_buffer("paged_decode_counters", q.device, splits * b * hkv, torch.int32)
    lse = (torch.empty((splits, b, hq), dtype=torch.float32, device=q.device)
           if return_lse or splits > 1 else None)
    scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    vs = 1.0 if v_scale is None else float(v_scale)
    ptr = lambda t: t.data_ptr() if t is not None else None
    fn = _build.bind("decode_attention", "skt_paged_decode", _ARGS)
    _build.check(fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), fk_ptr, fv_ptr, ptr(sk),
                    lens.data_ptr(), table.data_ptr(), out.data_ptr(), ptr(lse), ws.data_ptr(),
                    counters.data_ptr(), b, hkv, page, table.shape[1], d, group, _POOL_TYPES[k_pages.dtype],
                    k_pages.numel() // d, k_pages[0].numel(), page_stride, head_stride, lid, splits,
                    split_tokens, -1 if sliding_window is None else int(sliding_window), scale,
                    0.0 if logit_soft_cap is None else float(logit_soft_cap),
                    1.0 if k_scale is None else float(k_scale), vs, vs if splits == 1 else 1.0, ws_blocks,
                    _build.stream_ptr(q.device)), name)
    if splits == 1:
        out, lse = out[0], (lse[0] if lse is not None else None)
    else:
        # the combine stays plain torch on the device, as JAX's XLA merge (:488-)
        out, lse = _merge_splits(out, lse, q.dtype)
        if v_scale is not None:
            out = (out.float() * vs).to(q.dtype)
    return (out, lse) if return_lse else out


def paged_attention_decode_dma(q, k_pages, v_pages, lengths, page_table, sinks=None,
                               k_scale=None, v_scale=None, layer_id=None, fresh_k=None,
                               fresh_v=None, *, sm_scale: Optional[float] = None,
                               sliding_window: Optional[int] = None,
                               logit_soft_cap: Optional[float] = None,
                               return_lse: bool = False, chunk_pages: int = 16,
                               num_splits: int = 1, layout: str = "page"):
    """One-token decode attention over paged pools. q [B, Hq, D]; pools
    [L, P, Hkv, page, D] (``layout="page"``) or [L, Hkv, P, page, D]
    (``layout="head"``), or either without L; lengths [B] include the
    current token; page_table [B, n_blocks]. With fresh_k/fresh_v
    [B, Hkv, D] the pool holds length-1 tokens and the fresh row is attended
    last. ``sinks`` [Hq] are natural-log logits in the denominator;
    ``sliding_window`` keeps pool positions > length-1-window;
    ``logit_soft_cap`` caps every score; ``k_scale``/``v_scale`` are
    per-tensor scales of quantized pools (floats); ``return_lse`` also
    returns the base-2 lse [B, Hq] (f32).

    ``num_splits`` splits the KV of each sequence into that many ranges of
    whole chunks of ``chunk_pages`` pages (fewer if the table has fewer
    chunks, as in JAX); the partials, rounded to q's dtype, are merged by
    ``merge_states`` (``choose_num_splits`` picks a factor). With
    ``num_splits=1`` ``chunk_pages`` has no effect: it sized the TPU
    kernel's DMA refills. The card's kernel spreads every sequence over
    the SMs whatever ``num_splits`` is, and merges those spans itself.
    CUDA tensors go through the K5 kernel, which takes bf16 q, pools of
    bf16, int8, fp8 e4m3 or e5m2, head_dim 64/128/256, group 1/2/4/8 and
    pages of a multiple of 8 tokens that divides 64 or is a multiple of 64."""
    if q.device.type != "cuda":
        return paged_attention_decode_ref(
            q, k_pages, v_pages, lengths, page_table, sinks, k_scale, v_scale, layer_id,
            fresh_k, fresh_v, sm_scale=sm_scale, sliding_window=sliding_window,
            logit_soft_cap=logit_soft_cap, return_lse=return_lse, chunk_pages=chunk_pages,
            num_splits=num_splits, layout=layout)
    out = launch_decode("paged_attention_decode_dma", q, k_pages, v_pages, lengths, page_table, sinks,
                        k_scale, v_scale, layer_id, fresh_k, fresh_v, sm_scale=sm_scale,
                        sliding_window=sliding_window, logit_soft_cap=logit_soft_cap,
                        return_lse=return_lse, chunk_pages=chunk_pages, num_splits=num_splits, layout=layout)
    paged_attention_decode_dma.launches += 1
    return out


paged_attention_decode_dma.launches = 0
