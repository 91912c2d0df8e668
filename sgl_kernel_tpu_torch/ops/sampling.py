"""Sampling: top-k / top-p / min-p filtering and sampling (plain PyTorch).

The filters keep the JAX package's exact keep sets: each finds the per-row
threshold by 31-step bisection on the float32 bit pattern (probs >= 0, so
the int32 order is the float order) and keeps ``probs >= threshold``, ties
included. Random draws come from an explicit ``torch.Generator``; they are
not the JAX package's bits for the same seed.
"""

from __future__ import annotations

from typing import Optional

import torch


def _renorm(filtered):
    return filtered / filtered.sum(-1, keepdim=True).clamp_min(1e-38)


def _bisect_threshold(probs, feasible):
    """Largest float32 threshold t (by bit pattern) with feasible(probs >= t)
    per row; feasible maps [T, V] bool to [T] bool and must be monotone."""
    tbits = torch.zeros(probs.shape[0], dtype=torch.int32, device=probs.device)
    for i in range(31):
        cand = tbits | (1 << (30 - i))
        ok = feasible(probs >= cand.view(torch.float32)[:, None])
        tbits = torch.where(ok, cand, tbits)
    return tbits.view(torch.float32)[:, None]


def _per_row(x, t, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device).broadcast_to((t,))


def top_k_renorm_probs(probs, top_k):
    """Keep the top_k largest probs per row (ties kept), renormalize;
    k <= 0 disables the filter."""
    t, v = probs.shape
    k = _per_row(top_k, t, torch.int32, probs.device)
    kc = torch.where(k <= 0, torch.full_like(k, v), k)
    thresh = _bisect_threshold(probs.float(), lambda mask: mask.sum(-1) >= kc)
    return _renorm(torch.where(probs >= thresh, probs, torch.zeros_like(probs)))


def top_p_renorm_probs(probs, top_p):
    """Nucleus filter: keep the smallest high-prob set with mass >= top_p
    (at least one token), renormalize."""
    t, v = probs.shape
    p = _per_row(top_p, t, torch.float32, probs.device)
    pf = probs.float()
    thresh = _bisect_threshold(
        pf, lambda mask: (torch.where(mask, pf, torch.zeros_like(pf)).sum(-1) >= p) & mask.any(-1))
    return _renorm(torch.where(probs >= thresh, probs, torch.zeros_like(probs)))


def min_p_filter_probs(probs, min_p):
    """Zero probs below min_p * max_prob per row, renormalize."""
    t, v = probs.shape
    mp = _per_row(min_p, t, torch.float32, probs.device)[:, None]
    thresh = mp * probs.amax(-1, keepdim=True)
    return _renorm(torch.where(probs >= thresh, probs, torch.zeros_like(probs)))


def sampling_from_probs(probs, generator: Optional[torch.Generator] = None):
    """Categorical sample per row by inverse CDF."""
    t, v = probs.shape
    norm = probs / probs.sum(-1, keepdim=True).clamp_min(1e-38)
    csum = torch.cumsum(norm, dim=-1)
    # scale u by the realized mass: a float32 cumsum can stop short of 1.0
    u = torch.rand((t, 1), generator=generator, device=probs.device) * csum[:, -1:]
    return (csum < u).sum(-1).clamp(0, v - 1).to(torch.int32)


def sample_tokens(logits, generator: Optional[torch.Generator] = None, temperature=1.0,
                  top_k=None, top_p=None, min_p=None, *, temperature_is_zero: bool = False):
    """temperature -> softmax -> top-k -> top-p -> min-p -> sample; greedy
    argmax when ``temperature_is_zero``."""
    if temperature_is_zero:
        return logits.argmax(-1).to(torch.int32)
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    if temp.ndim == 1:
        temp = temp[:, None]
    probs = torch.softmax(logits.float() / temp.clamp_min(1e-6), dim=-1)
    if top_k is not None:
        probs = top_k_renorm_probs(probs, top_k)
    if top_p is not None:
        probs = top_p_renorm_probs(probs, top_p)
    if min_p is not None:
        probs = min_p_filter_probs(probs, min_p)
    return sampling_from_probs(probs, generator)
