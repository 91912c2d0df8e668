"""GEMMs of the port: the W4A16 dequant-fused GEMM (K1), its decode-bucket
form with streamed weights (K10), and their layouts; the blockwise-fp8 GEMMs
(K17, K18), the QServe W4A8 GEMMs (K19 and the per-channel form), the INT8 /
FP8 scaled matmuls and the NVFP4 GEMMs."""

from .blockwise_fp8 import (
    fp8_blockwise_scaled_grouped_mm,
    fp8_blockwise_scaled_grouped_mm_ref,
    fp8_blockwise_scaled_mm,
    fp8_blockwise_scaled_mm_ref,
    prepare_blockwise_scales,
)
from .fp4 import fp4_group_mm, fp4_scaled_mm, scaled_fp4_experts_quant, scaled_fp4_quant
from .qserve import qserve_w4a8_per_chn_gemm, qserve_w4a8_per_group_gemm, qserve_w4a8_per_group_gemm_ref
from .scaled_mm import bmm_fp8, dsv3_fused_a_gemm, dsv3_router_gemm, fp8_scaled_mm, int8_scaled_mm
from .w4a16 import (
    awq_to_tpu_layout,
    dequant_w4,
    gptq_to_tpu_layout,
    mxfp4_to_tpu_layout,
    pack_w4_tpu,
    quantize_w4,
    unpack_w4_tpu,
    w4a16_gemm,
    w4a16_gemm_ref,
)
from .w4a16_dma import w4a16_gemm_dma, w4a16_gemm_dma_ref
