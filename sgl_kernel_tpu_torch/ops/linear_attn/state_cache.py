"""Per-request recurrent-state pools for conv / SSM layers
(sgl_kernel_tpu/ops/linear_attn/state_cache.py:17-38): a pool [R, ...]
holds one row a request slot; rows are written, gathered and copied by
slot. A negative slot is dropped (a write) or reads zeros (a gather); a slot
past the pool is dropped by a write and clamped by a gather, as JAX's
scatter and gather treat them. The JAX functions return new pools; these
update the pool IN PLACE and return it.

None waits for the host, so each may run inside a captured CUDA graph: a
dropped row is redirected to the call's last kept row with that row's value
(``ops/kvcache._put_rows``), never removed by a boolean index."""

from __future__ import annotations

import torch

from ..kvcache import _put_rows


def _rows(cache):
    """The pool as [R, row] rows (a view)."""
    return cache.view(cache.shape[0], -1)


def state_cache_update(cache, state_indices, new_states):
    """cache[state_indices[i]] = new_states[i] for slots in [0, R), in place;
    cache [R, ...]; state_indices [B]; new_states [B, ...]. A slot written
    twice has no defined winner, as in XLA's scatter. Returns the cache."""
    idx = state_indices.to(device=cache.device, dtype=torch.long).reshape(-1)
    idx = torch.where((idx >= 0) & (idx < cache.shape[0]), idx, -1)
    _put_rows(_rows(cache), idx, new_states.reshape(idx.shape[0], -1))
    return cache


def state_cache_gather(cache, state_indices):
    """The rows of ``state_indices`` [B]: [B, ...], zeros where a slot is
    negative."""
    idx = state_indices.to(device=cache.device, dtype=torch.long).reshape(-1)
    out = cache.index_select(0, idx.clamp(0, cache.shape[0] - 1))
    valid = (idx >= 0).reshape((-1,) + (1,) * (out.ndim - 1))
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=out.device))


def state_cache_gather_scatter(cache, src_indices, dst_indices):
    """cache[dst[i]] = cache[src[i]] (a speculative fork or accept), in
    place; a pair with a negative src or dst is dropped, as is a dst past the
    pool. Every source row is read before any is written. Returns the
    cache."""
    src = src_indices.to(device=cache.device, dtype=torch.long).reshape(-1)
    dst = dst_indices.to(device=cache.device, dtype=torch.long).reshape(-1)
    flat = _rows(cache)
    rows = flat.index_select(0, torch.where(src >= 0, src, 0).clamp_max(cache.shape[0] - 1))
    dst = torch.where((src >= 0) & (dst >= 0) & (dst < cache.shape[0]), dst, -1)
    _put_rows(flat, dst, rows)
    return cache
