"""W4A16 decode GEMM with streamed weights.

``w4a16_gemm_dma`` is kernel K10, CUDA C++ in ``csrc/w4a16_gemm_dma.cu``,
replacing the Pallas ``w4a16_gemm_dma``
(sgl_kernel_tpu/ops/gemm/w4a16_dma.py:170, pallas_call at :266): K1's
function (``w4a16.py``) for the decode bucket, M <= 32, with no norm
prologue and no fused gate/up. The TPU kernel streams the packed weights
through a manual double-buffered DMA with the K loop inside the kernel body;
the card's kernel streams them through a ring of TMA tensor copies that one
producer warp keeps ahead of the tensor-core warps. ``w4a16_gemm_dma_ref``
is its plain PyTorch twin: the math and rounding points are K1's
(w4a16_dma.py:12-16), so it is K1's twin.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ... import _build
from ...utils import cdiv, sm_count
from . import w4a16
from .w4a16 import _gemm_ref

# the kernel's shapes (csrc/w4a16_gemm_dma.cu): columns of a tile, K rows
# of a ring stage, stages, the budget of the staged activations and a
# block's shared memory
BLOCK_N, STAGE_K, STAGES = 128, 256, 4
ACT_BYTES, SMEM_LIMIT = 128 * 1024, 232448


def smem_bytes(rows: int, per: int, group_size: int, zeros: bool) -> int:
    """Dynamic shared memory of a block (the kernel's ``smem_bytes``): the
    ring (codes, scale and zero rows), the staged activations of ``per``
    groups, their per-group row sums (zeros), the barriers and the slack to
    align the ring."""
    stage = (STAGE_K // 2) * BLOCK_N + (STAGE_K // group_size) * BLOCK_N * 2 * (2 if zeros else 1)
    stage = -(-stage // 1024) * 1024  # stages on the 128-byte swizzle's 1024-byte period
    return (STAGES * stage + rows * (per * group_size + 8) * 2 + (rows * per * 4 if zeros else 0)
            + 2 * STAGES * 8 + 1024)


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


def plan(m: int, n: int, k: int, group_size: int, zeros: bool = False, n_sm: int = 132):
    """(split, groups_per_split, column workers) of a launch. A block stages
    its rows' activations over its K range once in shared memory, so K is
    split in whole groups until a range fits ``ACT_BYTES`` and the block's
    shared memory; when the column tiles cannot fill the SMs, K splits
    further (as K1's ``plan``). Each block walks several column tiles when
    there are more tiles than SMs."""
    rows = 16 if m <= 16 else 32
    n_groups = k // group_size
    max_groups = max(1, ACT_BYTES // (rows * 2 * group_size))
    while max_groups > 1 and smem_bytes(rows, max_groups, group_size, zeros) > SMEM_LIMIT:
        max_groups -= 1
    tiles = cdiv(n, BLOCK_N)
    split = cdiv(n_groups, max_groups)
    if tiles < n_sm:
        split = max(split, n_sm // tiles)
    split = min(split, n_groups)
    per = cdiv(n_groups, split)
    split = cdiv(n_groups, per)
    workers = min(tiles, max(1, n_sm // split))
    return split, per, workers


_ARGS = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 11 + (ctypes.c_void_p,)


@functools.cache
def _entry():
    return _build.bind("w4a16_gemm_dma", "skt_w4a16_gemm_dma", _ARGS)


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
    scales, zeros and residual, groups of 32, 64 or 128, N a multiple of 16
    (TMA's 16-byte row pitch) and a bf16 or float32 output. Its ring
    is four stages of 256 K rows, chosen for the card: ``bn``, ``bk``,
    ``nbuf``, ``unroll`` and ``gmode`` keep the JAX signature only (they
    chose the TPU kernel's tile, chunk, buffer count and decode schedule)."""
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
    if n % 16:
        raise NotImplementedError(f"w4a16_gemm_dma: the CUDA kernel's TMA copies need N % 16 == 0, got {n}")
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
    dense = lambda t: t if t is None or t.is_contiguous() else t.contiguous()
    a_, a2_ = fit(a), fit(a2)
    w_, s_, z_, res = dense(w_), dense(s_), dense(z_), dense(residual)
    if any(t is not None and t.data_ptr() % 16 for t in (w_, s_, z_)):
        raise ValueError("w4a16_gemm_dma: weights, scales and zeros must be 16-byte aligned for the TMA copies")
    b_ = b_.float().contiguous() if b_ is not None else None
    split, per, workers = plan(m, n, k, group_size, z_ is not None, sm_count(a.device.index or 0))
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    partial = torch.empty((split, m, n), dtype=torch.float32, device=a.device) if split > 1 else None
    ptr = lambda t: t.data_ptr() if t is not None else None
    _build.check(_entry()(ptr(a_), ptr(a2_), ptr(w_), ptr(s_), ptr(z_), ptr(b_), ptr(res), ptr(out), ptr(partial),
                          m, n, k, a_.stride(0), a2_.stride(0) if a2_ is not None else 0, group_size, split, per,
                          workers, int(fmt == "mxfp4"), int(out_dtype == torch.float32),
                          _build.stream_ptr(a.device)), "w4a16_gemm_dma")
    w4a16_gemm_dma.launches += 1
    return out


w4a16_gemm_dma.launches = 0
