"""Quantization formats the port's weight layouts are built from, and the
per-token fp8 quantizer of the NSA indexer."""

from __future__ import annotations

import torch

from .formats import AWQ_ORDER, awq_unpack_int32, pack_int4, unpack_int4


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
