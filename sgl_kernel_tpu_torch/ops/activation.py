"""Gated-MLP activations (plain PyTorch).

Each takes a [..., 2*d] gate|up-concatenated input and returns [..., d],
computing in float32 and rounding once to the input dtype, as the JAX
functions do (sgl_kernel_tpu/ops/activation.py). The JAX package leaves
these to XLA's fusion; there is no TPU kernel to port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu(x):
    return x * torch.sigmoid(x)


def _split(x):
    d = x.shape[-1] // 2
    return x[..., :d], x[..., d:]


def silu_and_mul(x):
    gate, up = _split(x)
    return (silu(gate.float()) * up.float()).to(x.dtype)


def gelu_and_mul(x):
    gate, up = _split(x)
    return (F.gelu(gate.float(), approximate="none") * up.float()).to(x.dtype)


def gelu_tanh_and_mul(x):
    gate, up = _split(x)
    return (F.gelu(gate.float(), approximate="tanh") * up.float()).to(x.dtype)


def silu_and_mul_clamp(x, limit: float = 7.0, alpha: float = 1.702):
    """Clamped gated silu: gate and up each clamped to [-limit, limit]."""
    gate, up = _split(x.float())
    return (silu(gate.clamp(-limit, limit)) * up.clamp(-limit, limit)).to(x.dtype)


def swiglu_alpha_limit(x, alpha: float = 1.702, limit: float = 7.0):
    """gpt-oss swiglu over interleaved gate/up pairs (gate = x[..., ::2],
    up = x[..., 1::2]): (gate * sigmoid(alpha gate)) * (up + 1), gate
    clipped above by limit, up to [-limit, limit]."""
    xf = x.float()
    gate = xf[..., 0::2].clamp(max=limit)
    up = xf[..., 1::2].clamp(-limit, limit)
    return ((gate * torch.sigmoid(alpha * gate)) * (up + 1.0)).to(x.dtype)


ACTIVATIONS = {
    "silu": silu_and_mul,
    "gelu": gelu_and_mul,
    "gelu_tanh": gelu_tanh_and_mul,
    "silu_clamp": silu_and_mul_clamp,
    "swiglu_gpt_oss": swiglu_alpha_limit,
}
