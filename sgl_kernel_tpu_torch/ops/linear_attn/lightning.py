"""MiniMax lightning-attention decode step
(sgl_kernel_tpu/ops/linear_attn/lightning.py:17-28): one token of linear
attention with a per-head exponential decay over a [dk, dv] state.

    state' = exp(-slope) * state + k^T v
    o      = q @ state'
"""

from __future__ import annotations

import torch


def lightning_attention_decode(q, k, v, past_kv, slope):
    """q / k [B, H, 1, dk]; v [B, H, 1, dv]; past_kv [B, H, dk, dv]; slope
    [H, 1, 1] decay rates. Returns (o [B, H, 1, dv] in v's dtype, new_kv in
    past_kv's dtype), computed in float32."""
    qf, kf, vf = q.float(), k.float(), v.float()
    decay = torch.exp(-slope.float()).reshape(1, -1, 1, 1)
    new_kv = past_kv.float() * decay + torch.einsum("bhik,bhiv->bhkv", kf, vf)
    o = torch.einsum("bhik,bhkv->bhiv", qf, new_kv)
    return o.to(v.dtype), new_kv.to(past_kv.dtype)
