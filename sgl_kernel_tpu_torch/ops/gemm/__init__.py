"""GEMMs of the port: the W4A16 dequant-fused GEMM (K1), its decode-bucket
form with streamed weights (K10), and their layouts."""

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
