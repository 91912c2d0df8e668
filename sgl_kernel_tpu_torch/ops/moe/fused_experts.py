"""fused_experts: one MoE layer forward.

    route -> align / sort by expert -> grouped GEMM1 -> activation
          -> grouped GEMM2 -> weighted combine

The port of sgl_kernel_tpu/ops/moe/fused_experts.py. Its branches
(fused_experts.py:116-158):

  - layer-stacked bf16 banks (DeepSeek, Mixtral; ``layer_id`` given): the
    grouped bf16 GEMM ``bf16_grouped_mm`` (K12), the layer picked by offset;
  - unstacked bf16 banks: on the card K12 over the alignment's blocks at any
    token count, so the host never reads a group size; on the CPU the JAX
    choice, the grouped GEMM's twin at up to 64 tokens and
    ``ragged_grouped_mm`` (``jax.lax.ragged_dot``) over the padded group
    sizes above. The two agree on valid rows, and the combine drops pad rows;
  - int4 / mxfp4 banks, stacked or not: ``w4a16_grouped_mm`` (K11).

The JAX grouped branch also checks that the TPU kernel's tiles fit VMEM
(``bf16_group_tiles_fit``); that rule has no meaning here. The alignment and
the combine are plain PyTorch on the device; the activation between the
GEMMs is ``ops/activation.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..activation import ACTIVATIONS
from .align import apply_shuffle_mul_sum, moe_align_block_size, pick_block_size, scatter_tokens_to_experts
from .grouped_gemm import bf16_grouped_mm, ragged_grouped_mm, w4a16_grouped_mm


class MoeWeights(NamedTuple):
    """Expert weights of one MoE layer (or of every layer, stacked).

    w1: [E, H, 2I] (gate|up on the output dim) bf16, or packed int4 /
        mxfp4 [E, H//2, 2I]; w2: [E, I, H], or packed [E, I//2, H]; a
        leading layer dim when stacked. Quant metadata as in
        ops/gemm/w4a16.py; biases [E, 2I] / [E, H] (or [L, E, ...])."""

    w1: torch.Tensor
    w2: torch.Tensor
    w1_scales: Optional[torch.Tensor] = None
    w2_scales: Optional[torch.Tensor] = None
    w1_zeros: Optional[torch.Tensor] = None
    w2_zeros: Optional[torch.Tensor] = None
    b1: Optional[torch.Tensor] = None
    b2: Optional[torch.Tensor] = None
    group_size: int = 128
    fmt: str = "bf16"  # bf16 | int4 | mxfp4


def fused_experts(hidden, weights: MoeWeights, topk_weights, topk_ids, layer_id=None, *, activation: str = "silu",
                  block_size: Optional[int] = None, gemm1_alpha: float = 1.702, gemm1_limit: float = 7.0):
    """MoE layer forward. hidden [T, H]; topk_weights / topk_ids [T, K].
    ``layer_id`` selects one layer of stacked banks ([L, E, ...]) without a
    copy. ``block_size`` is the alignment block (default
    ``pick_block_size`` on the mean rows per expert)."""
    t = hidden.shape[0]
    stacked = layer_id is not None
    w1, w2 = weights.w1, weights.w2
    e = w1.shape[1] if stacked else w1.shape[0]
    if block_size is None:
        block_size = pick_block_size(t, topk_ids.shape[1], w1.shape[-3])
    act_fn = ACTIVATIONS[activation]

    align = moe_align_block_size(topk_ids, topk_weights, e, block_size)
    x = scatter_tokens_to_experts(hidden, align)  # [cap, H]

    def bias(y, b):
        """A per-expert bias on every row of its blocks (pad rows too; the
        combine drops them)."""
        if b is None:
            return y
        bl = b[int(layer_id)] if (stacked and b.ndim == 3) else b
        return y + bl[align.block_expert_ids.long().repeat_interleave(block_size)].to(y.dtype)

    def act(inter):
        inter = bias(inter, weights.b1)
        if activation == "silu_clamp":
            return act_fn(inter, gemm1_limit)
        if activation == "swiglu_gpt_oss":
            return act_fn(inter, gemm1_alpha, gemm1_limit)
        return act_fn(inter)

    if weights.fmt == "bf16" and (stacked or t <= 64 or hidden.device.type == "cuda"):
        inter = bf16_grouped_mm(x, w1, align.block_expert_ids, layer_id, align.num_valid_blocks, bm=block_size)
        a = act(inter)
        out_sorted = bf16_grouped_mm(a.to(hidden.dtype), w2, align.block_expert_ids, layer_id,
                                     align.num_valid_blocks, bm=block_size)
    elif weights.fmt == "bf16":
        # rows grouped by the padded per-expert sizes: pad rows multiply real
        # weights and the combine drops them
        inter = ragged_grouped_mm(x, w1, align.padded_group_sizes)
        a = act(inter)
        out_sorted = ragged_grouped_mm(a, w2, align.padded_group_sizes)
    else:
        kw = dict(group_size=weights.group_size, fmt=weights.fmt, bm=block_size)
        inter = w4a16_grouped_mm(x, w1, weights.w1_scales, align.block_expert_ids, weights.w1_zeros, layer_id,
                                 align.num_valid_blocks, **kw)
        a = act(inter)
        out_sorted = w4a16_grouped_mm(a, w2, weights.w2_scales, align.block_expert_ids, weights.w2_zeros,
                                      layer_id, align.num_valid_blocks, **kw)
    out_sorted = bias(out_sorted, weights.b2)
    return apply_shuffle_mul_sum(out_sorted, align, t)
