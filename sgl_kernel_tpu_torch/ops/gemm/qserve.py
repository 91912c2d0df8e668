"""QServe W4A8 GEMMs (per-group and per-channel rescale epilogues).

``qserve_w4a8_per_group_gemm`` is kernel K19, CUDA C++ in
``csrc/qserve_gemm.cu``, replacing the Pallas ``qserve_w4a8_per_group_gemm``
(sgl_kernel_tpu/ops/gemm/qserve.py:61, kernel ``_per_group_kernel`` :34,
pallas_call at :102); ``qserve_w4a8_per_group_gemm_ref`` is its plain twin.
Progressive dequantization, with JAX's rounding points:

    W8[n, k] = bf16(code[n, k] * s2[n, g] - zs2[n, g])     (float32, then bf16)
    out = ascales[m] * wscales[n] * (A_q @ W8^T)           (float32 sums)

The weights are one uint4 code a byte, [N, K] (K contiguous), as the JAX
package stores ``jnp.uint4`` arrays; ``interop.tensor_from_numpy`` turns
such an array into uint8 codes.

The kernel multiplies on Hopper's int8 warpgroup MMA wherever W8 is an
integer in [-128, 127] (``w8_int8_exact``) made from integer scales (s2 in
[0, 128], zs2 in [-512, 512]; QServe's quantization gives both), summing
exactly in int32, and recomputes any other block with JAX's float32
arithmetic (its exact route, counted by ``exact_route_blocks``). K splits over blocks by ``split_plan`` (over the
SMs' block slots, ``blocks_per_sm``) in the same launch.

``qserve_quantize`` makes the operands as QServe does; every W8 of its
weights is an int8.

``qserve_w4a8_per_chn_gemm`` is plain in JAX (qserve.py:124-141) and plain
here: an exact int32 product (``int_mm_exact``) and a float32 epilogue.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import _build
from ...utils import OUT_KIND, cdiv, kept_buffer, row_tile, sm_count
from .blockwise_fp8 import split_plan
from .scaled_mm import int_mm_exact


def _check(a_q, w_q, zeros_x_s2, scales_i8, wscales, ascales, group_size: int):
    m, k = a_q.shape
    n = w_q.shape[0]
    name = "qserve_w4a8_per_group_gemm"
    if tuple(w_q.shape) != (n, k) or k % group_size:
        raise ValueError(f"{name}: A {tuple(a_q.shape)}, W {tuple(w_q.shape)}, group {group_size}")
    for t, nm in ((zeros_x_s2, "zeros_x_s2"), (scales_i8, "scales_i8")):
        if tuple(t.shape) != (n, k // group_size):
            raise ValueError(f"{name}: {nm} must be [N, K/G]={(n, k // group_size)}, got {tuple(t.shape)}")
    if wscales.numel() != n or ascales.numel() != m:
        raise ValueError(f"{name}: wscales [{wscales.numel()}] for N={n}, ascales [{ascales.numel()}] for M={m}")


def _epilogue(acc, ascales, wscales, out_dtype):
    return (acc * ascales.float().reshape(-1, 1) * wscales.float().reshape(1, -1)).to(out_dtype)


def dequant_w8(w_q, zeros_x_s2, scales_i8, group_size: int = 128):
    """The per-group dequantized weights W8 [N, K] in bf16: code * s2 - zs2
    in float32, rounded once (qserve.py:46-51)."""
    n, k = w_q.shape
    w = w_q.float().reshape(n, k // group_size, group_size)
    w = w * scales_i8.float()[..., None] - zeros_x_s2.float()[..., None]
    return w.reshape(n, k).to(torch.bfloat16)


def qserve_w4a8_per_group_gemm_ref(a_q, w_q, zeros_x_s2, scales_i8, wscales, ascales, *, group_size: int = 128,
                                   out_dtype=torch.float16, bm: int = 128, bn: int = 256, bk: int = 512):
    """Plain twin of ``qserve_w4a8_per_group_gemm``: W8 as JAX rounds it,
    then a float32 product (int8 activations are exact in float32)."""
    _check(a_q, w_q, zeros_x_s2, scales_i8, wscales, ascales, group_size)
    w8 = dequant_w8(w_q, zeros_x_s2, scales_i8, group_size)
    return _epilogue(a_q.float() @ w8.float().T, ascales, wscales, out_dtype)


def qserve_quantize(w, group_size: int = 128):
    """QServe's progressive quantization of a float weight [N, K]
    (tests/test_gemm.py:278-292): int8 per output channel (|q| <= 119),
    then 4-bit groups of ``group_size`` with an integer scale s2 and zero z.
    Returns (codes [N, K] uint8, zeros_x_s2 = z * s2 [N, K/G] float32, s2
    [N, K/G] int8, per-channel scales [N] float32), the operands of
    ``qserve_w4a8_per_group_gemm``. Every W8 of the result is an int8
    (``w8_int8_exact``)."""
    n, k = w.shape
    w = w.float()
    chn = w.abs().amax(-1, keepdim=True) / 119
    bi8 = torch.clamp(torch.round(w / chn), -119, 119).reshape(n, k // group_size, group_size)
    s2 = torch.clamp(torch.round((bi8.amax(-1) - bi8.amin(-1)) / 15), min=1.0)
    z2 = -torch.round(bi8.amin(-1) / s2)
    codes = torch.clamp(torch.round(bi8 / s2[..., None]) + z2[..., None], 0, 15)
    return codes.reshape(n, k).to(torch.uint8), z2 * s2, s2.to(torch.int8), chn[:, 0]


SCALE_KIND = {torch.int8: 0, torch.float16: 1, torch.bfloat16: 2, torch.float32: 3}  # csrc/qserve_gemm.cu
# The kernel's tile, for the split plan; card tests hold these against the
# kernel's own (``kernel_tile``).
TILE_N = 128  # weight rows of the kernel's tile
TILE_K = 256  # k of a stage; K splits over blocks in whole stages


def blocks_per_sm(block_rows: int) -> int:
    """Blocks of the kernel an SM holds: two at 16 activation rows, one at
    32 / 64 / 128 (shared memory and registers)."""
    return 2 if block_rows <= 16 else 1


def kernel_tile(block_rows: int):
    """(weight rows a block, k of a stage, blocks an SM) as the built
    kernel has them at ``block_rows`` (16, 32, 64 or 128)."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.bind("qserve_gemm", "skt_qserve_tile", (ctypes.c_int, ctypes.c_void_p))(block_rows, out),
                 "qserve kernel_tile")
    return tuple(out)


def w8_int8_exact(w_q, zeros_x_s2, scales_i8, group_size: int = 128) -> bool:
    """Whether every W8 of a weight, as JAX rounds it (``dequant_w8``), is an
    integer in [-128, 127]: then int8 x int8 products summed in int32 give
    JAX's function exactly. The K19 kernel takes its int8 route on such
    weights where their scales are integers, s2 in [0, 128] and zs2 in
    [-512, 512] (QServe's own quantization makes both so), and its exact
    route in any other block."""
    w8 = dequant_w8(w_q, zeros_x_s2, scales_i8, group_size).float()
    return bool(((w8 == w8.round()) & (w8 >= -128) & (w8 <= 127)).all())


_ARGS = (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 12 + (ctypes.c_void_p,)


@functools.cache
def _entry():
    return _build.bind("qserve_gemm", "skt_qserve_w4a8_per_group", _ARGS)


def exact_route_blocks(device="cuda") -> int:
    """Blocks of the K19 kernel that took the exact route on ``device``
    (``"cuda"`` is the current card), summed over every call so far (a kept
    counter; reading it syncs)."""
    return int(kept_buffer("qserve_exact_blocks", torch.device(device), 1, torch.int32)[0])


def _launch(a, w, s2, zs2, ws, as_, out, group_size: int, plan=None):
    """One launch of the kernel. A split K's sums, partials, arrival
    counters and routes live in kept buffers, one set a card, so a call
    allocates nothing but its output and can be captured in a CUDA graph;
    calls must be ordered (one stream, or streams joined by events).
    ``plan`` (split, k-tiles a split) replaces the split plan: only tests
    pass it, to hold two plans' outputs against each other."""
    m, k = a.shape
    n = w.shape[0]
    dev = a.device
    rows = row_tile(m)
    tiles = cdiv(n, TILE_N) * cdiv(m, rows)
    split, per = plan or split_plan(tiles, cdiv(k, TILE_K), sm_count(dev.index or 0) * blocks_per_sm(rows))
    part = sums = counters = routes = None
    if split > 1:
        part = kept_buffer("qserve_part", dev, split * m * n, torch.int32)
        sums = kept_buffer("qserve_sums", dev, m * n, torch.int32)
        counters = kept_buffer("qserve_counters", dev, tiles, torch.int32)
        routes = kept_buffer("qserve_routes", dev, tiles * split, torch.int32)
    exact = kept_buffer("qserve_exact_blocks", dev, 1, torch.int32)
    ptrs = [t.data_ptr() if t is not None else None
            for t in (a, w, s2, zs2, ws, as_, out, part, sums, counters, routes, exact)]
    kinds = [SCALE_KIND[t.dtype] for t in (s2, zs2, ws, as_)]
    _build.check(_entry()(*ptrs, m, n, k, group_size, *kinds, rows, OUT_KIND[out.dtype], split, per,
                          _build.stream_ptr(dev)), "qserve_w4a8_per_group_gemm")


def qserve_w4a8_per_group_gemm(a_q, w_q, zeros_x_s2, scales_i8, wscales, ascales, *, group_size: int = 128,
                               out_dtype=torch.float16, bm: int = 128, bn: int = 256, bk: int = 512):
    """A_q [M, K] int8; W_q [N, K] uint4 codes, one a byte (uint8);
    scales_i8 [N, K/G] group scales s2 (int8 or float); zeros_x_s2 [N, K/G]
    = zero * s2 (int8 or float); wscales [N] per-channel and ascales [M]
    per-token scales (f16 or float). Returns [M, N] in ``out_dtype``.

    CUDA tensors go through the K19 kernel, one launch a call, which takes
    groups of 32, 64 or 128, scales in int8, float16, bfloat16 or float32
    (read in their own type) and writes f16, bf16 or float32. ``bm``, ``bn``
    and ``bk`` are contract-only: they chose the TPU kernel's tiles."""
    if a_q.device.type != "cuda":
        return qserve_w4a8_per_group_gemm_ref(a_q, w_q, zeros_x_s2, scales_i8, wscales, ascales,
                                              group_size=group_size, out_dtype=out_dtype)
    _check(a_q, w_q, zeros_x_s2, scales_i8, wscales, ascales, group_size)
    name = "qserve_w4a8_per_group_gemm"
    if a_q.dtype != torch.int8 or w_q.dtype != torch.uint8:
        raise NotImplementedError(f"{name}: the CUDA kernel takes int8 A and uint8 codes, not {a_q.dtype} / "
                                  f"{w_q.dtype}")
    if group_size not in (32, 64, 128) or a_q.shape[1] % 16:
        raise NotImplementedError(f"{name}: the CUDA kernel takes groups of 32/64/128 and K a multiple of 16")
    if out_dtype not in OUT_KIND:
        raise NotImplementedError(f"{name}: the CUDA kernel writes f16, bf16 or float32, not {out_dtype}")
    scales = [t.to(a_q.device).contiguous() for t in (scales_i8, zeros_x_s2, wscales.reshape(-1), ascales.reshape(-1))]
    if any(t.dtype not in SCALE_KIND for t in scales):
        raise NotImplementedError(f"{name}: the CUDA kernel reads int8, f16, bf16 or float32 scales, not "
                                  f"{[t.dtype for t in scales]}")
    m, k = a_q.shape
    out = torch.empty((m, w_q.shape[0]), dtype=out_dtype, device=a_q.device)
    if m == 0:
        return out
    if k == 0:
        return out.zero_()
    a, w = a_q.contiguous(), w_q.contiguous()
    if a.data_ptr() % 16 or w.data_ptr() % 16:  # TMA reads from 16-byte aligned starts
        a, w = a.clone(), w.clone()
    _launch(a, w, *scales, out, group_size)
    qserve_w4a8_per_group_gemm.launches += 1
    return out


qserve_w4a8_per_group_gemm.launches = 0


def qserve_w4a8_per_chn_gemm(a_q, w_q, wscales, ascales, w_szeros, a_sums, *, out_dtype=torch.float16):
    """A_q [M, K] int8; W_q [N, K] uint4 codes (uint8); wscales [N] (s1);
    ascales [M] per-token; w_szeros [N] = zero * s1; a_sums [M] per-token
    sums of the float activations.

    out = ascales x wscales * (A_q @ W_q^T) - a_sums x w_szeros, the int8
    product exact in int32 (plain, as in JAX)."""
    acc = int_mm_exact(a_q, w_q.to(torch.int8).T).float()
    out = acc * ascales.float().reshape(-1, 1) * wscales.float().reshape(1, -1)
    out = out - a_sums.float().reshape(-1, 1) * w_szeros.float().reshape(1, -1)
    return out.to(out_dtype)
