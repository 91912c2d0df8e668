"""Paged-KV decode attention.

``paged_attention_decode_dma`` is kernel K5, CUDA C++ in
``csrc/decode_attention.cu``, replacing the Pallas
``paged_attention_decode_dma``
(sgl_kernel_tpu/ops/attention/paged_decode_dma.py:306, pallas_call at
:461). ``paged_attention_decode_ref`` is its plain PyTorch twin and covers the
JAX contract over page-major pools (sinks, window, softcap, k/v scales,
lse); the kernel takes bf16, int8, fp8 e4m3 and e5m2 pools with per-tensor
k/v scales, the form the serving path uses, and raises on the rest. The name keeps the JAX module's: the kernel streams pages, but
no longer by manual DMA.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import _build
from ...utils import cdiv

LOG2E = 1.4426950408889634


def paged_attention_decode_ref(q, k_pages, v_pages, lengths, page_table, sinks=None,
                               k_scale=None, v_scale=None, layer_id=None, fresh_k=None,
                               fresh_v=None, *, sm_scale: Optional[float] = None,
                               sliding_window: Optional[int] = None,
                               logit_soft_cap: Optional[float] = None,
                               return_lse: bool = False):
    """Plain PyTorch twin of ``paged_attention_decode_dma`` (gathers the
    pages the longest sequence uses, dense f32 scores). Pool values convert
    exactly to float32; the per-tensor scales round where the JAX function
    rounds (paged_decode_dma.py:392-405, :498-499): q * k_scale and
    fresh_k / k_scale, fresh_v / v_scale to the input dtypes, the output
    times v_scale again to q's dtype."""
    b, hq, d = q.shape
    if k_pages.ndim == 4:
        k_pages, v_pages = k_pages[None], v_pages[None]
    lid = 0 if layer_id is None else int(layer_id)
    kp, vp = k_pages[lid], v_pages[lid]
    n_pages, hkv, page, _ = kp.shape
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
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
    if fresh_k is not None:
        sf = torch.einsum("bhgd,bhd->bhg", qh, fresh_k.reshape(b, hkv, d).float()) * scale
        s = torch.cat([s, sf[..., None]], dim=-1)
        vg = torch.cat([vg, fresh_v.reshape(b, hkv, 1, d).float()], dim=2)
        mask = torch.cat([mask, torch.ones((b, 1), dtype=torch.bool, device=q.device)], dim=1)
    if logit_soft_cap is not None:
        s = logit_soft_cap * torch.tanh(s / logit_soft_cap)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        l = l + torch.exp(sinks.float().to(q.device).reshape(1, hkv, group, 1) - m)
    o = torch.einsum("bhgt,bhtd->bhgd", p, vg)
    o = torch.where(l == 0, torch.zeros_like(o), o / l)
    out = o.reshape(b, hq, d).to(q.dtype)
    if v_scale is not None:
        out = (out.float() * float(v_scale)).to(q.dtype)
    if return_lse:
        lse = (m + torch.log(l.clamp_min(1e-38))) * LOG2E
        lse = torch.where(l == 0, torch.full_like(lse, float("-inf")), lse)
        return out, lse.reshape(b, hq)
    return out


_ARGS = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 9 + (ctypes.c_float,) * 3 + (ctypes.c_void_p,)
# pool dtypes of the kernel (csrc/decode_attention.cu)
_POOL_TYPES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}


def paged_attention_decode_dma(q, k_pages, v_pages, lengths, page_table, sinks=None,
                               k_scale=None, v_scale=None, layer_id=None, fresh_k=None,
                               fresh_v=None, *, sm_scale: Optional[float] = None,
                               sliding_window: Optional[int] = None,
                               logit_soft_cap: Optional[float] = None,
                               return_lse: bool = False, chunk_pages: int = 16,
                               num_splits: int = 1, layout: str = "page"):
    """One-token decode attention over paged pools. q [B, Hq, D]; pools
    [L, P, Hkv, page, D] (or [P, Hkv, page, D]); lengths [B] include the
    current token; page_table [B, n_blocks]. With fresh_k/fresh_v [B, Hkv, D]
    the pool holds length-1 tokens and the fresh row is attended last.
    ``k_scale``/``v_scale`` are per-tensor scales of quantized pools (floats).
    CUDA tensors go through the K5 kernel, which takes bf16 q, page-major
    pools of bf16, int8, fp8 e4m3 or e5m2, head_dim 64/128/256, group
    1/2/4/8, and no sinks, window, softcap or lse yet.

    ``chunk_pages``, ``num_splits`` and ``layout`` are contract-only: they
    keep the JAX signature. ``chunk_pages`` sized the TPU kernel's DMA
    refills and has no counterpart; split-KV (``num_splits > 1``) and the
    head-major ``layout="head"`` are not ported and raise."""
    if layout != "page":
        raise NotImplementedError("paged_attention_decode_dma: only the page-major layout is ported")
    if q.device.type != "cuda":
        return paged_attention_decode_ref(
            q, k_pages, v_pages, lengths, page_table, sinks, k_scale, v_scale, layer_id,
            fresh_k, fresh_v, sm_scale=sm_scale, sliding_window=sliding_window,
            logit_soft_cap=logit_soft_cap, return_lse=return_lse)
    if (sinks is not None or sliding_window is not None or logit_soft_cap is not None or return_lse
            or num_splits != 1):
        raise NotImplementedError(
            "paged_attention_decode_dma: the CUDA kernel takes no sinks, window, softcap, lse or "
            "splits yet")
    if k_pages.ndim == 4:
        k_pages, v_pages = k_pages[None], v_pages[None]
    b, hq, d = q.shape
    _, n_pages, hkv, page, _ = k_pages.shape
    group = hq // hkv
    if hq % hkv or group not in (1, 2, 4, 8) or d not in (64, 128, 256) or k_pages.shape[-1] != d:
        raise ValueError(f"paged_attention_decode_dma: unsupported q {tuple(q.shape)} pools {tuple(k_pages.shape)}")
    if q.dtype != torch.bfloat16 or k_pages.dtype != v_pages.dtype or k_pages.dtype not in _POOL_TYPES:
        raise NotImplementedError("paged_attention_decode_dma: the CUDA kernel takes bf16 q and "
                                  "bf16, int8, float8_e4m3fn or float8_e5m2 pools")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_attention_decode_dma: pools must be contiguous")
    lid = 0 if layer_id is None else int(layer_id)
    if fresh_k is not None:
        fk = fresh_k.reshape(b, hkv, d).to(torch.bfloat16).contiguous()
        fv = fresh_v.reshape(b, hkv, d).to(torch.bfloat16).contiguous()
        fk_ptr, fv_ptr = fk.data_ptr(), fv.data_ptr()
    else:
        fk_ptr = fv_ptr = None
    q = q.contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    fn = _build.bind("decode_attention", "skt_paged_decode", _ARGS)
    _build.check(fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), fk_ptr, fv_ptr,
                    lens.data_ptr(), table.data_ptr(), out.data_ptr(), b, n_pages, hkv, page,
                    table.shape[1], d, group, lid, _POOL_TYPES[k_pages.dtype], scale,
                    1.0 if k_scale is None else float(k_scale), 1.0 if v_scale is None else float(v_scale),
                    _build.stream_ptr(q.device)),
                 "paged_attention_decode_dma")
    paged_attention_decode_dma.launches += 1
    return out


paged_attention_decode_dma.launches = 0
