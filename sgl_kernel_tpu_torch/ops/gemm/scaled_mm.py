"""INT8 / FP8 scaled matmuls (per-tensor and per-token scales) and the two
DeepSeek-V3 projection GEMMs.

The port of sgl_kernel_tpu/ops/gemm/scaled_mm.py (:37-108). JAX computes
these products with XLA outside any kernel, so there is no TPU kernel to
port; the products here are library calls:

  int8   exact int32 products: ``torch._int_mm`` on the card (which wants
         more than 16 rows, K and N multiples of 8 and a column-major B:
         the operands are zero-padded to that, never computed in float);
         on the CPU a float64 product, exact for int8 (|sum| < 2^53)
  fp8    float32 products: ``torch._scaled_mm`` with unit scales on the card
         (K and N zero-padded to multiples of 16); on the CPU a float32
         product of the exactly upcast operands

Then the JAX epilogue, in float32: out = acc * scale_a[:, None] *
scale_b[None, :] (+ bias), rounded once to ``out_dtype``
(tests/test_int8_gemm.py:16-36 of the reference).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...utils import round_up


def _apply_scales(acc, scales_a, scales_b, bias, out_dtype):
    acc = acc.float()
    if scales_a is not None:
        sa = torch.as_tensor(scales_a, dtype=torch.float32, device=acc.device)
        acc = acc * (sa.reshape(-1, 1) if sa.dim() else sa)
    if scales_b is not None:
        sb = torch.as_tensor(scales_b, dtype=torch.float32, device=acc.device)
        acc = acc * (sb.reshape(1, -1) if sb.dim() else sb)
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(out_dtype)


def _pad2(x, rows: int, cols: int):
    """x [r, c] zero-padded to [rows, cols] (any dtype, fp8 included)."""
    if tuple(x.shape) == (rows, cols):
        return x
    out = torch.zeros((rows, cols), dtype=x.dtype, device=x.device)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def int_mm_exact(a, b):
    """int8 A [M, K] @ int8 B [K, N] -> exact int32 [M, N]."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda":
        return (a.double() @ b.double()).to(torch.int32)
    mp, kp, np_ = round_up(max(m, 17), 8), round_up(k, 8), round_up(n, 8)
    ap = _pad2(a, mp, kp).contiguous()
    bt = _pad2(b.t(), np_, kp).contiguous()  # [N, K] rows: B column-major
    return torch._int_mm(ap, bt.t())[:m, :n]


def fp8_mm_f32(a, b):
    """fp8 A [M, K] @ fp8 B [K, N] -> float32 [M, N], float32 accumulation."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda":
        return a.float() @ b.float()
    kp, np_ = round_up(k, 16), round_up(n, 16)
    ap = _pad2(a, m, kp).contiguous()
    bt = _pad2(b.t(), np_, kp).contiguous()
    one = torch.ones((), dtype=torch.float32, device=a.device)
    return torch._scaled_mm(ap, bt.t(), scale_a=one, scale_b=one, out_dtype=torch.float32)[:, :n]


def int8_scaled_mm(a, b, scales_a, scales_b, out_dtype=torch.bfloat16, bias=None):
    """int8 GEMM with a float32 scale epilogue: A [M, K] int8, B [K, N] int8,
    scales_a per-token [M] or scalar, scales_b per-channel [N] or scalar."""
    return _apply_scales(int_mm_exact(a, b), scales_a, scales_b, bias, out_dtype)


def fp8_scaled_mm(a, b, scales_a, scales_b, out_dtype=torch.bfloat16, bias=None):
    """fp8 GEMM with a float32 scale epilogue: A [M, K] fp8, B [K, N] fp8."""
    return _apply_scales(fp8_mm_f32(a, b), scales_a, scales_b, bias, out_dtype)


def bmm_fp8(a, b, scale_a, scale_b, out_dtype=torch.bfloat16):
    """Batched fp8 matmul with per-tensor scales: A [B, M, K] @ B [B, K, N]
    * scale_a * scale_b."""
    acc = torch.stack([fp8_mm_f32(a[i], b[i]) for i in range(a.shape[0])])
    f32 = dict(dtype=torch.float32, device=acc.device)
    return (acc * torch.as_tensor(scale_a, **f32) * torch.as_tensor(scale_b, **f32)).to(out_dtype)


def dsv3_router_gemm(hidden, router_weight, out_dtype=torch.float32):
    """DeepSeek-V3 router GEMM: [T, 7168] x [E, 7168]^T -> [T, E], float32
    products (router logits feed the expert top-k)."""
    return F.linear(hidden.float(), router_weight.float()).to(out_dtype)


def dsv3_fused_a_gemm(hidden, wa_t):
    """DeepSeek-V3 fused q_a / kv_a down-projection: [T, 7168] x [7168, 2112]
    (K-major) -> [T, 2112] in hidden's dtype, float32 products."""
    return (hidden.float() @ wa_t.float()).to(hidden.dtype)
