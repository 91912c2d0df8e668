"""Quantization formats the port's weight layouts are built from, the
per-token fp8 quantizer of the NSA indexer and the MXFP4 group quantizer of
gpt-oss's expert banks."""

from __future__ import annotations

import torch

from .formats import AWQ_ORDER, awq_unpack_int32, e2m1_encode, pack_int4, ue8m0_encode_from_amax, unpack_int4


def per_token_quant_fp8(x, dtype=torch.float8_e4m3fn):
    """Dynamic per-token (last dim) fp8 quantization, as the JAX
    ``per_token_quant_fp8`` (sgl_kernel_tpu/ops/quant/__init__.py:67-78):
    scale = max(amax / fmax, 1e-12), q = clip(x / scale, +-fmax) cast to
    ``dtype`` (round to nearest even). Returns (q, scales x.shape[:-1] + (1,)
    float32). amax / fmax is taken as amax times the float32 reciprocal of
    fmax, the product XLA makes of a division by a constant, so the scales
    are JAX's to the bit."""
    fmax = float(torch.finfo(dtype).max)
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(-1, keepdim=True) * (1.0 / fmax), 1e-12)
    return torch.clamp(xf / scale, -fmax, fmax).to(dtype), scale


def per_token_group_quant_fp4(x, x_secondary=None, *, group_size: int = 32, eps: float = 1e-10,
                              fuse_silu_and_mul: bool = False):
    """MXFP4 per-token-group quantization (sgl_kernel_tpu/ops/quant/__init__.py:151):
    each group of 32 along the last dim gets a UE8M0 scale 2^e, e =
    floor(log2(max(absmax, eps))) - 2 clamped to +-127, and its values
    x / 2^e rounded to E2M1 codes, two a byte, low nibble first. With
    ``x_secondary`` quantizes silu(x) * x_secondary; with
    ``fuse_silu_and_mul`` silu of x's first half times its second. Returns
    (packed uint8 [..., K/2], scale bytes uint8 [..., K/32]), JAX's bytes.
    Plain PyTorch: no TPU kernel computes it."""
    if group_size != 32:
        raise ValueError(f"per_token_group_quant_fp4: MXFP4 groups are 32 wide, not {group_size}")
    xf = x.float()
    if x_secondary is not None:
        xf = xf * torch.sigmoid(xf) * x_secondary.float()
    elif fuse_silu_and_mul:
        k = xf.shape[-1] // 2
        xf = xf[..., :k] * torch.sigmoid(xf[..., :k]) * xf[..., k:]
    g = xf.reshape(*xf.shape[:-1], -1, group_size)
    amax = torch.clamp_min(g.abs().amax(-1), eps)
    sbyte, sval = ue8m0_encode_from_amax(amax)
    q = e2m1_encode(g / sval[..., None])
    return pack_int4(q.reshape(*xf.shape[:-1], -1)), sbyte
