"""sgl_kernel_tpu_torch: the PyTorch / CUDA (Hopper) port of sgl_kernel_tpu.

Plain tensor code is PyTorch; each Pallas kernel of the JAX package on the
ported path is a hand-written Hopper kernel behind a function of the same
name and contract: CUDA C++ under ``csrc/`` (built with nvcc on first use,
bound with ctypes) or Triton. A CUDA tensor goes through the kernel, a CPU
tensor through the kernel's plain PyTorch twin. Entry points run on the card
unless the caller passes ``device="cpu"``.

Kernels ported so far (each wrapper counts its launches in ``.launches``):
  K1 w4a16_gemm, K5 paged_attention_decode_dma, K6 store_cache_all_layers,
  K8 paged_attention_decode (K5's kernel over head-major pools), K10
  w4a16_gemm_dma (``LlamaConfig(gemm_impl="dma")`` decode),
  K7 flash_attention (head dim 64, 128, 256 and 576) and K9
  flash_attention_packed (64, 128 and 576), K11 w4a16_grouped_mm, K12
  bf16_grouped_mm, K13a mla_decode, K13b mla_decode_dma
  (``mla_decode(engine="dma")``), K15 fp8_paged_mqa_logits (CUDA C++); K2
  rmsnorm, K3 rope_decode_fused_qkv, K4 rope_decode_fused, K14 mla_qkv_prep
  (Triton); K16 sparse_attn_func (vertical + slash sparse
  prefill), K17 fp8_blockwise_scaled_mm, K18 fp8_blockwise_scaled_grouped_mm
  and K19 qserve_w4a8_per_group_gemm (CUDA C++), with the op surface around
  them (the schedule builders, the INT8 / FP8 / NVFP4 GEMMs, the per-channel
  QServe GEMM and w4a8_grouped_mm on K11). Models: Llama (``LlamaConfig``,
  with the Qwen options ``qkv_bias`` / ``qk_norm`` and ``qwen3_8b()``), Mixtral
  (``MixtralConfig``, module ``models.mixtral``), gpt-oss (``GptOssConfig``,
  module ``models.gptoss``: sinks, alternating windows, MXFP4 experts) and DeepSeek MLA + MoE
  (``DeepseekConfig``, module ``models.deepseek``), with NSA sparse decode
  (``nsa=True``) and KV compression (``compress="c4"`` / ``"c128"``, module
  ``ops.compression``; each request's ring in an engine state slot) and
  hybrid GDN (``HybridGdnConfig``, module ``models.hybrid_gdn``: Gated
  DeltaNet layers, ``ops.linear_attn``, alternating with GQA layers; each
  request's conv and SSM state in an engine state slot).
  Speculative decoding (``models.spec``: chain and tree rounds, a Llama
  draft; ``ops.speculative``) is served by ``Engine(draft_cfg=...)``. The
  serving engine's radix prefix cache is host C++
  (``csrc/serving_native.cpp``, bound by ``serving/native.py``).
"""

from .interop import params_from_numpy, tensor_from_numpy
from .models.deepseek import DeepseekConfig
from .models.gptoss import GptOssConfig
from .models.hybrid_gdn import HybridGdnConfig
from .models.mixtral import MixtralConfig
from .models.llama import (
    LlamaConfig,
    build_rope_cache,
    decode_step,
    init_weights,
    make_caches,
    mixed_step,
    prefill,
    prefill_extend,
    prefill_packed,
    prefill_tree,
)
from .ops.attention import (
    apply_sinks,
    build_packed_metadata,
    build_vertical_slash_indexes,
    choose_num_splits,
    convert_vertical_slash_indexes,
    convert_vertical_slash_indexes_mergehead,
    fast_topk,
    fast_topk_transform_fused,
    fast_topk_transform_ragged_fused,
    flash_attention,
    flash_attention_packed,
    fp8_mqa_logits,
    fp8_paged_mqa_logits,
    fused_k_indexer_norm_rope_quant_store,
    fused_q_indexer_rope_hadamard_quant,
    make_seq_meta,
    merge_state,
    merge_states,
    mla_decode,
    mla_decode_dma,
    mla_prefill,
    paged_attention_decode,
    paged_attention_decode_dma,
    sparse_attention_vertical_slash,
    sparse_attn_func,
    sparse_attn_varlen_func,
    sparse_mla_decode,
    sparse_mla_prefill,
)
from .ops.gemm import (
    awq_to_tpu_layout,
    bmm_fp8,
    dequant_w4,
    dsv3_fused_a_gemm,
    dsv3_router_gemm,
    fp4_group_mm,
    fp4_scaled_mm,
    fp8_blockwise_scaled_grouped_mm,
    fp8_blockwise_scaled_mm,
    fp8_scaled_mm,
    gptq_to_tpu_layout,
    int8_scaled_mm,
    prepare_blockwise_scales,
    qserve_w4a8_per_chn_gemm,
    qserve_w4a8_per_group_gemm,
    quantize_w4,
    scaled_fp4_experts_quant,
    scaled_fp4_quant,
    w4a16_gemm,
    w4a16_gemm_dma,
)
from .ops.hadamard import hadamard_transform
from .ops.kvcache import (
    move_cache_rows_stacked,
    store_cache_all_layers,
    store_cache_head_major,
    store_cache_mla,
    store_cache_stacked,
)
from .ops.moe import (
    MoeWeights,
    bf16_grouped_mm,
    biased_topk,
    fused_experts,
    moe_align_block_size,
    ragged_grouped_mm,
    topk_softmax,
    w4a16_grouped_mm,
    w4a8_grouped_mm,
)
from .ops.norm import fused_add_rmsnorm, gemma_fused_add_rmsnorm, gemma_rmsnorm, l2norm, rmsnorm
from .ops.quant import per_token_group_quant_fp4, per_token_quant_fp8
from .ops.rope import (
    compute_cos_sin_cache,
    fused_qk_norm_rope,
    mla_qkv_prep,
    rope_decode_fused,
    rope_decode_fused_qkv,
    rotary_embedding,
)
from .ops.sampling import (
    min_p_filter_probs,
    sample_tokens,
    sampling_from_probs,
    top_k_renorm_probs,
    top_p_renorm_probs,
)
from .ops.speculative import (
    build_tree_kernel_efficient,
    segment_packbits,
    tree_speculative_sampling_target_only,
    verify_tree_greedy,
)
from .serving.adapters import (
    DeepseekAdapter,
    GptOssAdapter,
    HybridGdnAdapter,
    LlamaAdapter,
    MixtralAdapter,
    adapter_for,
)
from .serving.engine import Engine, PageAllocator, Request
from .utils import cdiv, next_power_of_2, resolve_device, round_up

# the kernel wrappers whose ``launches`` counters show a run went through them
KERNELS = {
    "w4a16_gemm": w4a16_gemm,
    "rmsnorm": rmsnorm,
    "rope_decode_fused_qkv": rope_decode_fused_qkv,
    "rope_decode_fused": rope_decode_fused,
    "paged_attention_decode_dma": paged_attention_decode_dma,
    "paged_attention_decode": paged_attention_decode,
    "store_cache_all_layers": store_cache_all_layers,
    "flash_attention": flash_attention,
    "flash_attention_packed": flash_attention_packed,
    "w4a16_grouped_mm": w4a16_grouped_mm,
    "bf16_grouped_mm": bf16_grouped_mm,
    "mla_decode": mla_decode,
    "mla_decode_dma": mla_decode_dma,
    "mla_qkv_prep": mla_qkv_prep,
    "fp8_paged_mqa_logits": fp8_paged_mqa_logits,
    "w4a16_gemm_dma": w4a16_gemm_dma,
    "sparse_attn_func": sparse_attn_func,
    "fp8_blockwise_scaled_mm": fp8_blockwise_scaled_mm,
    "fp8_blockwise_scaled_grouped_mm": fp8_blockwise_scaled_grouped_mm,
    "qserve_w4a8_per_group_gemm": qserve_w4a8_per_group_gemm,
}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in (flash_attention, flash_attention_packed):
        fn.launches_576 = 0
        fn.launches_by_option = dict.fromkeys(fn.launches_by_option, 0)
    flash_attention.launches_256 = 0
    for fn in (w4a16_gemm, w4a16_grouped_mm):
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def head_dim_launch_counts():
    """K7 / K9 launches at head dim 576 (``mla_flash_tile.cuh``) and K7's at
    256 (``flash_tile.cuh``'s 256-wide instance, hybrid GDN's attention),
    counted apart from their launches at 64 / 128, which are the rest of
    ``launch_counts()``'s."""
    return {"flash_attention_576": flash_attention.launches_576,
            "flash_attention_packed_576": flash_attention_packed.launches_576,
            "flash_attention_256": flash_attention.launches_256}


def option_launch_counts():
    """K7's and K9's launches that took each option (sinks, sliding
    window, soft cap; gpt-oss's prefill), a launch with two counted under
    both: ``flash_attention_sinks`` and the like."""
    return {f"{name}_{opt}": n for name, fn in (("flash_attention", flash_attention),
                                                ("flash_attention_packed", flash_attention_packed))
            for opt, n in fn.launches_by_option.items()}


def route_launch_counts():
    """K1's and K11's launches by kernel: K1 on the decode kernel, the wgmma
    tile and the mma.sync tile (``w4a16.route``); K11 on the streaming
    core, the wgmma tile and the mma.sync tile (``grouped_gemm.grouped_route``).
    Their sums are ``launch_counts()``'s."""
    return {f"{name}_{way}": n for name, fn in (("w4a16_gemm", w4a16_gemm), ("w4a16_grouped_mm", w4a16_grouped_mm))
            for way, n in fn.launches_by_route.items()}
