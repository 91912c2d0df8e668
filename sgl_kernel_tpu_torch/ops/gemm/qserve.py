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

``qserve_w4a8_per_chn_gemm`` is plain in JAX (qserve.py:124-141) and plain
here: an exact int32 product (``int_mm_exact``) and a float32 epilogue.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import _build
from ...utils import OUT_KIND, cdiv, row_tile, sm_count, split_k_plan
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


_ARGS = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


@functools.cache
def _entry():
    return _build.bind("qserve_gemm", "skt_qserve_w4a8_per_group", _ARGS)


def qserve_w4a8_per_group_gemm(a_q, w_q, zeros_x_s2, scales_i8, wscales, ascales, *, group_size: int = 128,
                               out_dtype=torch.float16, bm: int = 128, bn: int = 256, bk: int = 512):
    """A_q [M, K] int8; W_q [N, K] uint4 codes, one a byte (uint8);
    scales_i8 [N, K/G] group scales s2 (int8 or float); zeros_x_s2 [N, K/G]
    = zero * s2 (int8 or float); wscales [N] per-channel and ascales [M]
    per-token scales (f16 or float). Returns [M, N] in ``out_dtype``.

    CUDA tensors go through the K19 kernel, which takes groups of 32, 64 or
    128, K a multiple of 16 and writes f16, bf16 or float32. ``bm``, ``bn``
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
    m, k = a_q.shape
    n = w_q.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=a_q.device)
    if m == 0:
        return out
    f32 = lambda t: t.to(device=a_q.device, dtype=torch.float32).contiguous()
    a = a_q.contiguous()
    w = w_q.contiguous()
    if a.data_ptr() % 16 or w.data_ptr() % 16:  # the kernel copies 16-byte pieces with cp.async
        a, w = a.clone(), w.clone()
    s2, zs2, ws, as_ = f32(scales_i8), f32(zeros_x_s2), f32(wscales.reshape(-1)), f32(ascales.reshape(-1))
    bm_ = row_tile(m)
    split, per = split_k_plan(cdiv(n, 128) * cdiv(m, bm_), cdiv(k, 128), sm_count(a.device.index or 0))
    partial = torch.empty((split, m, n), dtype=torch.float32, device=a.device) if split > 1 else None
    ptr = lambda t: t.data_ptr() if t is not None else None
    _build.check(_entry()(a.data_ptr(), w.data_ptr(), s2.data_ptr(), zs2.data_ptr(), as_.data_ptr(), ws.data_ptr(),
                          out.data_ptr(), ptr(partial), m, n, k, group_size, bm_, OUT_KIND[out_dtype], split, per,
                          _build.stream_ptr(a.device)), name)
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
