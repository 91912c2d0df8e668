"""Linear attention family: the Mamba causal conv1d, the GDN gated delta
rule, the MiniMax lightning decode and the per-request state pools
(``sgl_kernel_tpu/ops/linear_attn/``). The JAX package writes them in plain
``jnp`` with no Pallas kernel; here they are plain PyTorch, on either
device."""

from .causal_conv1d import causal_conv1d_fwd, causal_conv1d_update  # noqa: F401
from .gdn import (  # noqa: F401
    chunk_gated_delta_rule,
    gated_delta_rule_scan,
    gated_delta_rule_update,
    gdn_attention_decode,
    gdn_attention_prefill,
    unzip_qkvz_ba,
)
from .lightning import lightning_attention_decode  # noqa: F401
from .state_cache import (  # noqa: F401
    state_cache_gather,
    state_cache_gather_scatter,
    state_cache_update,
)
