"""Attention-state merge in base 2 (plain PyTorch).

Inputs are normalized partial attention outputs ``v`` with their base-2
log-sum-exp ``s``:

    m = max(s_a, s_b);  d = 2^(s_a - m) + 2^(s_b - m)
    v = (v_a 2^(s_a - m) + v_b 2^(s_b - m)) / d;  s = m + log2(d)
"""

from __future__ import annotations

import torch


def merge_state(v_a, s_a, v_b, s_b):
    """v_[ab]: [T, H, D]; s_[ab]: [T, H] base-2 LSE. Returns (v, s)."""
    sa, sb = s_a.float(), s_b.float()
    m = torch.maximum(sa, sb)
    wa = torch.exp2(sa - m)
    wb = torch.exp2(sb - m)
    d = wa + wb
    v = (v_a.float() * wa[..., None] + v_b.float() * wb[..., None]) / d[..., None]
    return v.to(v_a.dtype), m + torch.log2(d)


def merge_states(v_stack, s_stack):
    """Merge N partial states: v [N, T, H, D], s [N, T, H]."""
    s = s_stack.float()
    m = s.max(dim=0).values
    w = torch.exp2(s - m)
    d = w.sum(dim=0)
    v = (v_stack.float() * w[..., None]).sum(dim=0) / d[..., None]
    return v.to(v_stack.dtype), m + torch.log2(d)


LOG2E = 1.4426950408889634


def apply_sinks(v, s, sinks):
    """Attention sinks applied once to a merged, normalized state: v [T, H, D]
    times sum / (sum + exp(sink)), from its base-2 lse s [T, H] and the
    natural-log sink logits sinks [H]."""
    w = 1.0 / (1.0 + torch.exp2(sinks[None, :].float() * LOG2E - s.float()))
    return (v.float() * w[..., None]).to(v.dtype)
