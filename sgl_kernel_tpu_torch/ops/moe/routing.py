"""MoE routing: softmax top-k (Mixtral) and DeepSeek-V3-style biased top-k
(plain PyTorch).

The JAX functions (sgl_kernel_tpu/ops/moe/routing.py:49-56 and :113-158) are
jnp code around ``jax.lax.top_k``; there is no TPU kernel to port. Top-k here is a
stable descending sort, which keeps ``jax.lax.top_k``'s order and its tie
rule (of equal values, the lower expert index first); ``torch.topk`` makes
no such promise. Ids are int32. ``topk`` counts fused shared experts, whose
slots take the ids ``num_experts + i``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _score(x, scoring_func: str):
    xf = x.float()
    if scoring_func == "softmax":
        return torch.softmax(xf, dim=-1)
    if scoring_func == "sigmoid":
        return torch.sigmoid(xf)
    if scoring_func == "sqrtsoftplus":
        return torch.sqrt(F.softplus(xf))
    raise ValueError(f"unknown scoring_func {scoring_func}")


def _shared_cols(t, num_fused, num_experts, device):
    return (num_experts + torch.arange(num_fused, dtype=torch.int32, device=device)).expand(t, num_fused)


def _top_k_ids(x, k: int):
    """Indices of the k largest entries of each row, largest first, ties to
    the lower index (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def topk_softmax(gating_output, topk: int, renormalize: bool = False):
    """Softmax over experts in float32, then top-k; with ``renormalize``
    the k weights are divided by their sum (at least 1e-20). gating_output
    [T, E]. Returns (weights [T, topk] float32, ids [T, topk] int32)."""
    scores = _score(gating_output, "softmax")
    ids = _top_k_ids(scores, topk)
    w = torch.gather(scores, -1, ids)
    if renormalize:
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-20)
    return w, ids.to(torch.int32)


def biased_topk(gating_output, bias, topk: int, scoring_func: str = "sigmoid", renormalize: bool = False,
                routed_scaling_factor: float = 1.0, apply_routed_scaling_factor_on_output: bool = False,
                num_fused_shared_experts: int = 0):
    """Select experts by score + bias, weigh them by the unbiased score.
    gating_output [T, E]; bias [E]. Returns (weights [T, topk] float32,
    ids [T, topk] int32). The epilogue applies to every lane, shared slots
    included: shared weight routed_sum / rsf before the norm; with
    ``renormalize`` every weight is divided by the routed sum (1 when it is
    not positive); then times rsf with ``apply_routed_scaling_factor_on_output``."""
    t, e = gating_output.shape
    kr = topk - num_fused_shared_experts
    if kr <= 0:
        raise ValueError("topk must exceed num_fused_shared_experts (topk is inclusive)")
    rs = routed_scaling_factor if routed_scaling_factor else 1.0
    scores = _score(gating_output, scoring_func)
    ids = _top_k_ids(scores + bias.float()[None, :], kr)
    w = torch.gather(scores, -1, ids)
    ids = ids.to(torch.int32)
    row_sum = w.sum(-1, keepdim=True)
    if num_fused_shared_experts:
        shared_ids = _shared_cols(t, num_fused_shared_experts, e, ids.device)
        w = torch.cat([w, (row_sum / rs).expand(t, num_fused_shared_experts)], dim=-1)
        ids = torch.cat([ids, shared_ids], dim=-1)
    if renormalize:
        w = w / torch.where(row_sum > 0.0, row_sum, torch.ones_like(row_sum))
    if apply_routed_scaling_factor_on_output and routed_scaling_factor not in (0, 1.0):
        w = w * routed_scaling_factor
    return w, ids
