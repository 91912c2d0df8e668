"""Attention operators: flash prefill (K7), packed flash prefill (K9), paged
decode (K5), MLA decode (K13a) and prefill, state merge."""

from .flash_packed import (
    build_packed_metadata,
    flash_attention_packed,
    flash_attention_packed_ref,
    make_seq_meta,
    pack_padded,
    unpack_to_padded,
)
from .flash_prefill import flash_attention, flash_attention_ref
from .merge_state import merge_state, merge_states
from .mla import D_CKV, D_CKV_PAD, D_LATENT, D_ROPE, mla_decode, mla_decode_ref, mla_prefill
from .paged_decode_dma import paged_attention_decode_dma, paged_attention_decode_ref
