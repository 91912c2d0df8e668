"""MoE stack: routing, alignment, grouped GEMMs (K11, K12, and the W4A8 form on
K11), fused_experts."""

from .align import (  # noqa: F401
    MoeAlignment,
    apply_shuffle_mul_sum,
    moe_align_block_size,
    pick_block_size,
    scatter_tokens_to_experts,
)
from .fused_experts import MoeWeights, fused_experts  # noqa: F401
from .grouped_gemm import (  # noqa: F401
    bf16_grouped_mm,
    bf16_grouped_mm_ref,
    ragged_grouped_mm,
    w4a16_grouped_mm,
    w4a16_grouped_mm_ref,
    w4a8_grouped_mm,
)
from .routing import biased_topk, topk_softmax  # noqa: F401
