"""NVFP4 scaled GEMMs, plain PyTorch.

The port of sgl_kernel_tpu/ops/gemm/fp4.py (:34-118), which has no TPU
kernel: values are E2M1 codes in groups of 16 along K with an fp8 e4m3
scale per group and one float32 global scale per tensor, in the natural
layouts (packed codes ``[*, K//2]`` uint8, low nibble first; scales
``[*, K//16]`` float8_e4m3fn). The GEMMs dequantize to bf16 and multiply
with float32 accumulation; ``fp4_group_mm`` runs on ``ragged_grouped_mm``.
"""

from __future__ import annotations

import torch

from ..moe.grouped_gemm import ragged_grouped_mm
from ..quant.formats import e2m1_decode, e2m1_encode, pack_int4, unpack_int4

FP4_GROUP = 16
_F8_MAX = 448.0


def _quant_groups(x, global_scale):
    """x [..., K] -> (codes [..., K] uint8 0..15, scales [..., K//16] e4m3).
    Group scale = amax / 6 * global_scale, clipped to [2^-9, 448] (fp4.py:34-53)."""
    orig = x.shape
    k = orig[-1]
    if k % FP4_GROUP:
        raise ValueError(f"K={k} is not a multiple of {FP4_GROUP}")
    g = x.float().reshape(*orig[:-1], k // FP4_GROUP, FP4_GROUP)
    gs = torch.as_tensor(global_scale, dtype=torch.float32, device=x.device)
    scale = torch.clamp(g.abs().amax(-1) / 6.0 * gs, 2.0 ** -9, _F8_MAX)
    scale_f8 = scale.to(torch.float8_e4m3fn)
    inv = (gs / scale_f8.float())[..., None]
    return e2m1_encode(g * inv).reshape(orig), scale_f8


def scaled_fp4_quant(x, global_scale):
    """Quantize to NVFP4: (packed [..., K//2] uint8, scales [..., K//16]
    float8_e4m3fn)."""
    codes, scale_f8 = _quant_groups(x, global_scale)
    return pack_int4(codes), scale_f8


def _dequant(packed, scales, dtype):
    vals = e2m1_decode(unpack_int4(packed))
    k = vals.shape[-1]
    vals = vals.reshape(*vals.shape[:-1], k // FP4_GROUP, FP4_GROUP) * scales.float()[..., None]
    return vals.reshape(*vals.shape[:-2], k).to(dtype)


def fp4_scaled_mm(a_packed, b_packed, scales_a, scales_b, alpha, out_dtype=torch.bfloat16):
    """out = (deq(A) @ deq(B)^T) * alpha. A [M, K//2], B [N, K//2] packed;
    scales [M, K//16] / [N, K//16] e4m3; alpha = 1 / (gs_a * gs_b)."""
    af = _dequant(a_packed, scales_a, torch.bfloat16).float()
    bf = _dequant(b_packed, scales_b, torch.bfloat16).float()
    return ((af @ bf.T) * torch.as_tensor(alpha, dtype=torch.float32, device=af.device)).to(out_dtype)


def scaled_fp4_experts_quant(x, global_scales, expert_offsets):
    """Per-expert NVFP4 quantization of expert-sorted rows: x [M, K],
    global_scales [E], expert_offsets [E+1] row starts; each row takes its
    expert's global scale."""
    m = x.shape[0]
    e = global_scales.shape[0]
    rows = torch.arange(m, device=x.device)[:, None]
    eid = (rows >= expert_offsets.to(x.device)[None, 1:e]).sum(1)
    codes, scale_f8 = _quant_groups(x, global_scales.float()[eid][:, None])
    return pack_int4(codes), scale_f8


def fp4_group_mm(a_packed, b_packed, scales_a, scales_b, alphas, group_sizes, out_dtype=torch.bfloat16):
    """Grouped NVFP4 GEMM for MoE: a [M, K//2] rows sorted by expert, b [E,
    N, K//2], scales_a [M, K//16], scales_b [E, N, K//16], alphas [E],
    group_sizes [E]. Rows past the groups' total come out zero."""
    af = _dequant(a_packed, scales_a, torch.bfloat16).float()
    bf = _dequant(b_packed, scales_b, torch.bfloat16).float()  # [E, N, K]
    out = ragged_grouped_mm(af, bf.transpose(1, 2), group_sizes)  # float32 in, float32 out
    e = alphas.shape[0]
    rows = torch.arange(out.shape[0], device=out.device)[:, None]
    eid = (rows >= torch.cumsum(group_sizes.to(out.device), 0)[None, : e - 1]).sum(1)
    return (out * alphas.float().to(out.device)[eid][:, None]).to(out_dtype)
