"""MoE token routing data movement: sort by expert with block alignment
(plain PyTorch, on the tensors' device).

The JAX functions (sgl_kernel_tpu/ops/moe/align.py) are jnp code; there is
no TPU kernel to port. The layout, byte for byte:

  - (token, k) pairs are stably sorted by expert id;
  - each expert's segment is padded up to a multiple of ``block_size``, so
    every block of rows belongs to one expert;
  - ``block_expert_ids`` gives each block's expert; blocks past
    ``num_valid_blocks`` are pinned to the last valid block's expert;
  - the row capacity is the static worst case
    round_up(T*K + min(T*K, E) * (block - 1), block).

Everything stays on the device: ``num_valid_blocks`` is a 0-d int32 tensor
the grouped GEMM reads there, and no step here waits for the host (the
counts are a scatter-add, not ``bincount``, whose output size needs a sync).

The combine sums each token's K slots in k order by a gather through
``pair_slots`` (the slot of each (token, k) pair, a field JAX's alignment
does not have), not by a scatter-add: float atomics add in an order that
changes from run to run, and a decode step replayed from a CUDA graph must
give the eager step's bits. JAX scatter-adds in slot order, so the two sums
may differ in the last float32 bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...utils import round_up


def pick_block_size(num_tokens: int, topk: int, num_experts: int, lo: int = 16, hi: int = 128) -> int:
    """Alignment block size from the mean rows per expert, t*topk/E: the
    next power of two, clamped to [lo, hi] (align.py:29-47)."""
    rows = max(1, (num_tokens * topk) // max(1, num_experts))
    bs = 1 << (rows - 1).bit_length()
    return max(lo, min(hi, bs))


def align_capacity(num_pairs: int, num_experts: int, block_size: int) -> int:
    return round_up(num_pairs + min(num_pairs, num_experts) * (block_size - 1), block_size)


class MoeAlignment(NamedTuple):
    sorted_pair_ids: torch.Tensor   # [cap] flat (token*K + k) pair index, sentinel T*K
    block_expert_ids: torch.Tensor  # [cap // block] expert id per block (trailing blocks pinned)
    token_ids: torch.Tensor         # [cap] source token of each slot (sentinel T)
    pair_weight: torch.Tensor       # [cap] routing weight of each slot (0 for pads)
    num_valid_blocks: torch.Tensor  # [] int32
    group_sizes: torch.Tensor       # [E] unpadded per-expert counts
    padded_group_sizes: torch.Tensor  # [E] per-expert counts padded to block_size
    pair_slots: torch.Tensor        # [T*K] the slot of each (token, k) pair (the inverse of sorted_pair_ids)


def moe_align_block_size(topk_ids, topk_weights, num_experts: int, block_size: int) -> MoeAlignment:
    t, k = topk_ids.shape
    n = t * k
    dev = topk_ids.device
    cap = align_capacity(n, num_experts, block_size)
    flat = topk_ids.reshape(-1).long()
    wflat = topk_weights.reshape(-1).float()
    order = torch.argsort(flat, stable=True)
    sorted_experts = flat[order]
    counts = torch.zeros(num_experts, dtype=torch.long, device=dev).scatter_add_(0, flat, torch.ones_like(flat))
    padded = (counts + block_size - 1) // block_size * block_size
    ends = torch.cumsum(padded, 0)
    starts = ends - padded
    run_start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - run_start[sorted_experts]
    dest = starts[sorted_experts] + rank
    sorted_pair_ids = torch.full((cap,), n, dtype=torch.long, device=dev).scatter_(0, dest, order)
    token_ids = torch.where(sorted_pair_ids < n, sorted_pair_ids // k, torch.full_like(sorted_pair_ids, t))
    pair_weight = torch.zeros(cap, dtype=torch.float32, device=dev).scatter_(0, dest, wflat[order])
    nb = cap // block_size
    blk = torch.arange(nb, device=dev)
    block_expert = torch.searchsorted(ends // block_size, blk, right=True).clamp(0, num_experts - 1)
    num_valid = padded.sum() // block_size
    valid = blk < num_valid
    last_valid_expert = torch.where(valid, block_expert, torch.zeros_like(block_expert)).max()
    block_expert = torch.where(valid, block_expert, last_valid_expert)
    i32 = torch.int32
    pair_slots = torch.empty_like(dest).scatter_(0, order, dest)
    return MoeAlignment(sorted_pair_ids.to(i32), block_expert.to(i32), token_ids.to(i32), pair_weight,
                        num_valid.to(i32), counts.to(i32), padded.to(i32), pair_slots.to(i32))


def scatter_tokens_to_experts(hidden, alignment: MoeAlignment):
    """Gather tokens into expert-sorted, block-aligned order: [cap, H]. Pad
    slots read an extra zero row (row T)."""
    h = torch.cat([hidden, hidden.new_zeros((1, hidden.shape[1]))], dim=0)
    return h[alignment.token_ids.long()]


def apply_shuffle_mul_sum(expert_out, alignment: MoeAlignment, num_tokens: int):
    """Combine: out[t] = sum over the token's K slots, in k order, of weight *
    expert_out[slot], in float32, rounded once to expert_out's dtype. Pad
    slots and the undefined rows of padding blocks are never read."""
    slots = alignment.pair_slots.long().reshape(num_tokens, -1 if num_tokens else 0)  # [T, K]
    contrib = expert_out[slots].float() * alignment.pair_weight[slots][..., None]
    return contrib.sum(1).to(expert_out.dtype)
