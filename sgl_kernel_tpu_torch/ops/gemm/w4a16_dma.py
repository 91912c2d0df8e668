"""W4A16 decode GEMM with streamed weights.

``w4a16_gemm_dma`` is kernel K10, CUDA C++ in ``csrc/w4a16_gemm_dma.cu``,
replacing the Pallas ``w4a16_gemm_dma``
(sgl_kernel_tpu/ops/gemm/w4a16_dma.py:170, pallas_call at :266): K1's
function (``w4a16.py``) for the decode bucket, M <= 32, with no norm
prologue and no fused gate/up. The TPU kernel streams the packed weights
through a manual double-buffered DMA with the K loop inside the kernel body;
the card's kernel is the W4A16 streaming core (``w4a16_stream.py``): a rows
pass for the silu_mul prologue, then a TMA ring of weight units shared out
equally over a grid sized from the SM count. Weights TMA cannot map (N % 16
!= 0, banks not dense and 16-byte aligned) take the tile kernel
(``csrc/w4a16_gemm.cu``). ``w4a16_gemm_dma_ref`` is its plain PyTorch twin:
the math and rounding points are K1's (w4a16_dma.py:12-16), so it is K1's
twin.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ... import _build
from ...utils import sm_count
from . import w4a16, w4a16_stream
from .w4a16 import _gemm_ref


def _operands(a, w, scales, zeros, bias, a2, residual, layer_id, *, group_size, fmt, prologue):
    """Check K10's JAX contract (w4a16_dma.py:219-245): K1's, for at most 32
    rows and a K that is the packed K. Returns (w, scales, zeros, bias) of
    the layer."""
    if a.shape[0] > 32:
        raise ValueError(f"w4a16_gemm_dma is the decode-bucket GEMM (M <= 32), got M={a.shape[0]}; use w4a16_gemm")
    if a2 is not None and a2.shape != a.shape:
        raise ValueError(f"w4a16_gemm_dma: a2 {tuple(a2.shape)} for a {tuple(a.shape)}")
    _, _, w, scales, zeros, bias, _, k, k_pad = w4a16._operands(
        a, w, scales, zeros, bias, a2, residual, layer_id, None, group_size=group_size, fmt=fmt, prologue=prologue,
        fused_gate_up=False, name="w4a16_gemm_dma")
    if k != k_pad:
        raise ValueError(f"w4a16_gemm_dma: activations of K={k} for packed K={k_pad}")
    return w, scales, zeros, bias


def w4a16_gemm_dma_ref(a, w, scales, zeros=None, bias=None, a2=None, residual=None, layer_id=None, *,
                       group_size: int = 128, fmt: str = "int4", out_dtype=None, bn: int = 2048,
                       bk: int = 1024, prologue: Optional[str] = None, unroll: bool = True, nbuf: int = 2,
                       gmode: str = "inner"):
    """Plain PyTorch twin of ``w4a16_gemm_dma``, with K1's rounding points."""
    w_, s_, z_, b_ = _operands(a, w, scales, zeros, bias, a2, residual, layer_id, group_size=group_size,
                               fmt=fmt, prologue=prologue)
    k = a.shape[1]
    return _gemm_ref(a, a2, w_, s_, z_, b_, residual, None, k, k, norm_eps=0.0, group_size=group_size,
                     fmt=fmt, out_dtype=out_dtype or a.dtype)


_ARGS = (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 12 + (ctypes.c_void_p,)


@functools.cache
def _entry():
    return _build.bind("w4a16_gemm_dma", "skt_w4a16_gemm_dma", _ARGS)


def plan(m: int, n: int, k: int, n_sm: int = 132):
    """(blocks, column tiles, k blocks) of a streaming-core launch: the grid
    from the SM count alone; the GEMM's units are the (tile, k block) pairs,
    an equal share a block (``w4a16_stream.work_units``)."""
    return w4a16_stream.grid(n_sm), w4a16_stream.tiles(n), w4a16_stream.k_blocks(k)


def w4a16_gemm_dma(a, w, scales, zeros=None, bias=None, a2=None, residual=None, layer_id=None, *,
                   group_size: int = 128, fmt: str = "int4", out_dtype=None, bn: int = 2048, bk: int = 1024,
                   prologue: Optional[str] = None, unroll: bool = True, nbuf: int = 2, gmode: str = "inner"):
    """Decode-bucket W4A16 GEMM (the JAX contract, w4a16_dma.py:170-214):
    ``a`` [M, K] with M <= 32; ``w`` packed uint8 [K//2, N] (or stacked
    [L, K//2, N] with ``layer_id``); ``scales`` [K//G, N]; optional ``zeros``
    (z*s), ``bias`` [N], ``a2`` with ``prologue="silu_mul"``, ``residual``
    [M, N] added in the epilogue. ``fmt`` "int4" or "mxfp4". Returns [M, N]
    in ``out_dtype`` (default a's dtype).

    CUDA tensors go through the K10 kernel, which takes bf16 activations,
    scales, zeros and residual, groups of 32, 64 or 128 and a bf16 or
    float32 output: the streaming core where TMA maps the bank, the tile
    kernel of ``csrc/w4a16_gemm.cu`` otherwise. ``bn``, ``bk``, ``nbuf``,
    ``unroll`` and ``gmode`` keep the
    JAX signature only (they chose the TPU kernel's tile, chunk, buffer
    count and decode schedule)."""
    out_dtype = out_dtype or a.dtype
    w_, s_, z_, b_ = _operands(a, w, scales, zeros, bias, a2, residual, layer_id, group_size=group_size,
                               fmt=fmt, prologue=prologue)
    if a.device.type != "cuda":
        return _gemm_ref(a, a2, w_, s_, z_, b_, residual, None, a.shape[1], a.shape[1], norm_eps=0.0,
                         group_size=group_size, fmt=fmt, out_dtype=out_dtype)
    bf = torch.bfloat16
    m, k = a.shape
    n = w_.shape[-1]
    if group_size not in (32, 64, 128):
        raise NotImplementedError(f"w4a16_gemm_dma: the CUDA kernel takes groups of 32, 64 or 128, not {group_size}")
    if out_dtype not in (bf, torch.float32):
        raise NotImplementedError(f"w4a16_gemm_dma: the CUDA kernel writes bf16 or float32, not {out_dtype}")
    if any(t is not None and t.dtype != bf for t in (a, a2, s_, z_, residual)):
        raise NotImplementedError("w4a16_gemm_dma: the CUDA kernel takes bf16 activations, scales, zeros and "
                                  "residual")
    if m == 0:
        return torch.empty((0, n), dtype=out_dtype, device=a.device)
    # rows of 16-byte loads: a unit stride, a row stride of 8 elements, an aligned base
    fit = lambda t: (t if t is None or (t.stride(1) == 1 and t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0)
                     else t.contiguous())
    a_, a2_ = fit(a), fit(a2)
    res = residual if residual is None or (residual.is_contiguous() and residual.data_ptr() % 16 == 0) \
        else residual.contiguous().clone()
    b_ = b_.float().contiguous() if b_ is not None else None
    if b_ is not None and b_.data_ptr() % 16:
        b_ = b_.clone()
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    # the bank as it lies: [L, K/2, N] with the layer a coordinate, or one [K/2, N]
    banks = (w, scales, zeros) if layer_id is not None else (w_, s_, z_)
    if not w4a16_stream.mappable(n, *banks):
        dense = lambda t: t if t is None or t.is_contiguous() else t.contiguous()
        w4a16._tile_launch(a_, a2_, None, dense(w_), dense(s_), dense(z_), b_, res, out, k, k,
                           group_size=group_size, fmt=fmt, norm_eps=0.0, vec_a=True,
                           vec_w=n % 16 == 0 and all(t is None or t.data_ptr() % 16 == 0 for t in (w_, s_, z_)),
                           name="w4a16_gemm_dma")
        w4a16_gemm_dma.launches += 1
        return out
    wb, sb, zb = banks
    layers, layer = (wb.shape[0], int(layer_id)) if layer_id is not None else (1, 0)
    blocks, tiles, _ = plan(m, n, k, sm_count(a.device.index or 0))
    mp = 16 if m <= 16 else 32
    act, asum, partial, counters = w4a16_stream.workspaces(a.device, m, k, group_size, mp, tiles, blocks)
    ptr = lambda t: t.data_ptr() if t is not None else None
    _build.check(_entry()(ptr(a_), ptr(a2_), ptr(wb), ptr(sb), ptr(zb), ptr(b_), ptr(res), ptr(out), ptr(act),
                          ptr(asum), ptr(partial), ptr(counters), m, n, k, a_.stride(0),
                          a2_.stride(0) if a2_ is not None else 0, layers, layer, group_size, blocks,
                          int(fmt == "mxfp4"), int(out_dtype == torch.float32), 1, _build.stream_ptr(a.device)),
                 "w4a16_gemm_dma")
    w4a16_gemm_dma.launches += 1
    return out


w4a16_gemm_dma.launches = 0
