"""Attention operators: flash prefill (K7), packed flash prefill (K9), paged
decode over page-major (K5) and head-major (K8) pools, MLA decode (K13a, and
K13b for engine="dma") and prefill, state merge, the NSA indexer (K15), its
top-k and sparse MLA, and vertical + slash sparse prefill (K16) with its
schedule builders."""

from .flash_packed import (
    build_packed_metadata,
    flash_attention_packed,
    flash_attention_packed_ref,
    make_seq_meta,
    pack_padded,
    unpack_to_padded,
)
from .flash_prefill import flash_attention, flash_attention_ref
from .merge_state import apply_sinks, merge_state, merge_states
from .mla import (D_CKV, D_CKV_PAD, D_LATENT, D_ROPE, mla_decode, mla_decode_dma, mla_decode_dma_ref, mla_decode_ref,
                  mla_prefill)
from .nsa import (
    fast_topk,
    fast_topk_transform_fused,
    fast_topk_transform_ragged_fused,
    fp8_mqa_logits,
    fp8_paged_mqa_logits,
    fp8_paged_mqa_logits_ref,
    fused_k_indexer_norm_rope_quant_store,
    fused_q_indexer_rope_hadamard_quant,
    sparse_mla_decode,
    sparse_mla_prefill,
)
from .paged_decode import paged_attention_decode
from .paged_decode_dma import choose_num_splits, paged_attention_decode_dma, paged_attention_decode_ref
from .sparse_vs import (
    build_vertical_slash_indexes,
    convert_vertical_slash_indexes,
    convert_vertical_slash_indexes_mergehead,
    sparse_attention_vertical_slash,
    sparse_attn_func,
    sparse_attn_func_ref,
    sparse_attn_varlen_func,
)
