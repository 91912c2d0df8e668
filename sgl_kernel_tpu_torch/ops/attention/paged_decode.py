"""Paged-KV decode attention over head-major pools.

``paged_attention_decode`` is kernel K8, replacing the Pallas
``paged_attention_decode`` (sgl_kernel_tpu/ops/attention/paged_decode.py:158,
pallas_call at :278): the public decode over pools ``[Hkv, P, page, D]`` or
layer-stacked ``[L, Hkv, P, page, D]``, as ``store_cache_head_major``
(ops/kvcache.py) fills them. It computes K5's function over the other
layout, so on the card it launches K5's kernel (``csrc/decode_attention.cu``)
with head-major strides, and counts its launches apart from K5's.
``paged_attention_decode_ref`` is its plain PyTorch twin.
"""

from __future__ import annotations

from typing import Optional

from .paged_decode_dma import launch_decode
from .paged_decode_dma import paged_attention_decode_ref as _k5_ref


def paged_attention_decode_ref(q, k_pages, v_pages, lengths, page_table, sinks=None,
                               k_scale=None, v_scale=None, layer_id=None, fresh_k=None,
                               fresh_v=None, *, sm_scale: Optional[float] = None,
                               sliding_window: Optional[int] = None,
                               logit_soft_cap: Optional[float] = None,
                               return_lse: bool = False, pages_per_step: int = 4):
    """Plain PyTorch twin of ``paged_attention_decode``: K5's twin over the
    head-major layout. A row with no pool token and no fresh row has lse
    -inf (JAX's K8 leaves m + log(1e-38), about -1.4e30, there)."""
    return _k5_ref(q, k_pages, v_pages, lengths, page_table, sinks, k_scale, v_scale, layer_id,
                   fresh_k, fresh_v, sm_scale=sm_scale, sliding_window=sliding_window,
                   logit_soft_cap=logit_soft_cap, return_lse=return_lse, layout="head")


def paged_attention_decode(q, k_pages, v_pages, lengths, page_table, sinks=None,
                           k_scale=None, v_scale=None, layer_id=None, fresh_k=None,
                           fresh_v=None, *, sm_scale: Optional[float] = None,
                           sliding_window: Optional[int] = None,
                           logit_soft_cap: Optional[float] = None,
                           return_lse: bool = False, pages_per_step: int = 4):
    """Decode attention over a head-major paged KV cache (the JAX contract,
    paged_decode.py:158-199). q [B, Hq, D]; k_pages/v_pages [Hkv, P, page, D]
    or [L, Hkv, P, page, D] with ``layer_id``; lengths [B] count the current
    token; page_table [B, max_pages]. ``sinks`` [Hq], ``sliding_window``,
    ``logit_soft_cap``, ``k_scale``/``v_scale`` (per-tensor floats of fp8 or
    int8 pools) and fresh_k/fresh_v [B, Hkv, D] as in
    ``paged_attention_decode_dma``. Returns out [B, Hq, D] (and the base-2
    lse [B, Hq] with ``return_lse``).

    ``pages_per_step`` keeps the JAX signature only: it sized the TPU
    kernel's grid step, and the card's kernel cuts the pages into units of
    64 tokens spread over the SMs. CUDA tensors go through the K5/K8 kernel,
    which takes bf16 q, pools of bf16, int8, fp8 e4m3 or e5m2, head_dim
    64/128/256, group 1/2/4/8 and pages of a multiple of 8 tokens that
    divides 64 or is a multiple of 64."""
    if q.device.type != "cuda":
        return paged_attention_decode_ref(
            q, k_pages, v_pages, lengths, page_table, sinks, k_scale, v_scale, layer_id, fresh_k,
            fresh_v, sm_scale=sm_scale, sliding_window=sliding_window, logit_soft_cap=logit_soft_cap,
            return_lse=return_lse)
    out = launch_decode("paged_attention_decode", q, k_pages, v_pages, lengths, page_table, sinks, k_scale,
                        v_scale, layer_id, fresh_k, fresh_v, sm_scale=sm_scale, sliding_window=sliding_window,
                        logit_soft_cap=logit_soft_cap, return_lse=return_lse, chunk_pages=16, num_splits=1,
                        layout="head")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0
