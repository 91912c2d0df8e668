"""Llama-family model (bf16 or float32 weights) on the port's operators.

Decoder-only transformer: RMSNorm, RoPE, GQA attention over a paged KV
cache, SwiGLU MLP. Parameters are a nested dict of layer-stacked tensors
whose keys are the JAX package's pytree paths (``embed``, ``final_norm``,
``lm_head``, ``layers.qkv``, ``layers.gate_up``, ...), so a JAX parameter
tree converts by a copy (``interop.params_from_numpy``).

Entry points: ``prefill`` (flash attention over a padded prompt batch, KV
stored per layer, last-token logits) and ``decode_step`` (one token per
sequence against the paged cache). Both update the KV pools IN PLACE,
where the JAX versions donate them, and return them.

Kernels on the path: rmsnorm (K2), rope_decode_fused_qkv (K3), paged decode
attention (K5), the all-layers KV store (K6), flash prefill (K7). The large
linears are plain ``torch.matmul``, as the JAX model leaves them to XLA.
Not in this slice: ``quant="w4a16"`` and the ``fused=False`` decode step
(its split-q/k RoPE kernel is another kernel); both raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from ..ops.attention import flash_attention, paged_attention_decode_dma
from ..ops.kvcache import store_cache_all_layers, store_cache_stacked
from ..ops.norm import rmsnorm
from ..ops.rope import compute_cos_sin_cache, rope_decode_fused_qkv, rotary_embedding
from ..utils import resolve_device

# Products accumulate in float32 as the JAX model's
# preferred_element_type=float32 does: no TF32 for float32 weights and no
# reduced-precision split-K reductions for bf16 ones.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    max_position: int = 8192
    dtype: torch.dtype = torch.bfloat16
    quant: Optional[str] = None
    # q/k/v and gate/up as single fused projections (the serving layout)
    fused: bool = False

    def __post_init__(self):
        if self.quant is not None:
            raise NotImplementedError(f"quant={self.quant!r}: the W4A16 path is not ported yet")

    @staticmethod
    def llama3_8b(**kw):
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128, **kw
        )

    @staticmethod
    def tiny(**kw):
        kw.setdefault("dtype", torch.float32)
        return LlamaConfig(
            vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            max_position=256, **kw
        )


def init_weights(cfg: LlamaConfig, generator: Union[torch.Generator, int] = 0,
                 device="cuda") -> Dict[str, Any]:
    """Random layer-stacked weights. ``generator`` is a torch.Generator on
    ``device`` or an int seed. Each layer's matrix is drawn in float32 and
    cast on its own, so the float32 temporaries stay one layer large."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    h, d = cfg.hidden_size, cfg.head_dim
    nq, nkv, n_layers = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers

    def w(shape, scale=None):
        scale = scale if scale is not None else 1.0 / shape[-1] ** 0.5
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        for i in range(shape[0] if len(shape) == 3 else 1):
            dst = out[i] if len(shape) == 3 else out
            dst.copy_(torch.randn(dst.shape, generator=generator, device=dev) * scale)
        return out

    layers = {
        "input_norm": torch.ones((n_layers, h), dtype=cfg.dtype, device=dev),
        "post_norm": torch.ones((n_layers, h), dtype=cfg.dtype, device=dev),
    }
    if cfg.fused:
        layers["qkv"] = w((n_layers, (nq + 2 * nkv) * d, h), 1.0 / h ** 0.5)
    else:
        layers["q"] = w((n_layers, nq * d, h))
        layers["k"] = w((n_layers, nkv * d, h))
        layers["v"] = w((n_layers, nkv * d, h))
    layers["o"] = w((n_layers, h, nq * d))
    if cfg.fused:
        layers["gate_up"] = w((n_layers, 2 * cfg.intermediate_size, h), 1.0 / h ** 0.5)
    else:
        layers["gate"] = w((n_layers, cfg.intermediate_size, h))
        layers["up"] = w((n_layers, cfg.intermediate_size, h))
    layers["down"] = w((n_layers, h, cfg.intermediate_size))
    return {
        "embed": w((cfg.vocab_size, h), 0.02),
        "final_norm": torch.ones((h,), dtype=cfg.dtype, device=dev),
        "lm_head": w((cfg.vocab_size, h)),
        "layers": layers,
    }


def _linear(x, w, cfg: LlamaConfig, residual=None, layer_id=None, norm=None, bias=None):
    """x @ w.T (w is [N, K], or the layer-stacked [L, N, K] with
    ``layer_id``), rounded to the model dtype; ``norm`` is an rmsnorm weight
    applied to x first; ``residual`` and ``bias`` are added after."""
    if norm is not None:
        x = rmsnorm(x, norm[layer_id] if layer_id is not None else norm, cfg.rms_eps)
    wl = w[layer_id] if layer_id is not None else w
    out = torch.matmul(x, wl.t()).to(cfg.dtype)
    if residual is not None:
        out = out + residual
    if bias is not None:
        out = out + (bias[layer_id] if layer_id is not None and bias.ndim == 2 else bias).to(out.dtype)
    return out


def make_caches(cfg: LlamaConfig, num_pages: int, page_size: int, kv_dtype=None, device="cuda"):
    """Layer-stacked page-major K and V pools [L, P, Hkv, page, D]."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, page_size, cfg.head_dim)
    dt = kv_dtype or cfg.dtype
    return torch.zeros(shape, dtype=dt, device=dev), torch.zeros(shape, dtype=dt, device=dev)


def build_rope_cache(cfg: LlamaConfig, device="cuda"):
    return compute_cos_sin_cache(cfg.head_dim, cfg.max_position, cfg.rope_theta,
                                 device=resolve_device(device))


def _qkv(h, weights, cfg, n_tokens, layer_id=None):
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.fused:
        qkv = _linear(h, weights["qkv"], cfg, layer_id=layer_id)
        q = qkv[:, : nq * d].reshape(n_tokens, nq, d)
        k = qkv[:, nq * d: (nq + nkv) * d].reshape(n_tokens, nkv, d)
        v = qkv[:, (nq + nkv) * d:].reshape(n_tokens, nkv, d)
    else:
        q = _linear(h, weights["q"], cfg, layer_id=layer_id).reshape(n_tokens, nq, d)
        k = _linear(h, weights["k"], cfg, layer_id=layer_id).reshape(n_tokens, nkv, d)
        v = _linear(h, weights["v"], cfg, layer_id=layer_id).reshape(n_tokens, nkv, d)
    return q, k, v


def _mlp(h2, weights, cfg, residual=None, layer_id=None, norm=None):
    """SwiGLU MLP; with ``norm`` h2 is the raw residual stream and the
    post-norm is applied first."""
    if cfg.fused:
        gu = _linear(h2, weights["gate_up"], cfg, layer_id=layer_id, norm=norm)
        inter = gu.shape[-1] // 2
        gate, up = gu[:, :inter], gu[:, inter:]
    else:
        if norm is not None:
            h2 = rmsnorm(h2, norm[layer_id] if layer_id is not None else norm, cfg.rms_eps)
        gate = _linear(h2, weights["gate"], cfg, layer_id=layer_id)
        up = _linear(h2, weights["up"], cfg, layer_id=layer_id)
    g = gate.float()
    act = (g * torch.sigmoid(g) * up.float()).to(cfg.dtype)
    w = weights["down"][layer_id] if layer_id is not None else weights["down"]
    out = torch.matmul(act, w.t()).to(cfg.dtype)
    return out + residual if residual is not None else out


def decode_step(params, cfg: LlamaConfig, k_cache, v_cache, tokens, positions, page_tables,
                lengths, slot_loc, rope_cache):
    """One decode step. tokens/positions/lengths/slot_loc [B]; page_tables
    [B, max_pages]. Returns (logits [B, V] float32, k_cache, v_cache); the
    pools are updated in place."""
    x = params["embed"][tokens.long()].to(cfg.dtype)
    x, k_cache, v_cache = decode_layers(
        params["layers"], cfg, k_cache, v_cache, x, positions, page_tables,
        lengths, slot_loc, rope_cache)
    logits = _linear(x, params["lm_head"], cfg, norm=params["final_norm"]).float()[:, : cfg.vocab_size]
    return logits, k_cache, v_cache


def decode_layers(lw, cfg: LlamaConfig, k_cache, v_cache, x, positions, page_tables, lengths,
                  slot_loc, rope_cache):
    """The decoder layers on hidden states x [B, H]. Every layer's attention
    reads pools that do not hold the current token yet (it rides as the
    fresh row); all layers' K/V are stored once after the loop, so the
    current token is never counted twice."""
    if not cfg.fused:
        raise NotImplementedError("decode with fused=False needs the split-q/k RoPE kernel, not ported yet")
    b = x.shape[0]
    n_stack = lw["input_norm"].shape[0]
    k_all, v_all = [], []
    for lidx in range(n_stack):
        qkv = _linear(x, lw["qkv"], cfg, layer_id=lidx, norm=lw["input_norm"])
        q, k, v = rope_decode_fused_qkv(positions, qkv, rope_cache, num_q=cfg.num_heads,
                                        num_kv=cfg.num_kv_heads, head_dim=cfg.head_dim)
        attn = paged_attention_decode_dma(q, k_cache, v_cache, lengths, page_tables,
                                          layer_id=lidx, fresh_k=k, fresh_v=v)
        x = _linear(attn.reshape(b, -1), lw["o"], cfg, residual=x, layer_id=lidx)
        x = _mlp(x, lw, cfg, residual=x, layer_id=lidx, norm=lw["post_norm"])
        k_all.append(k)
        v_all.append(v)
    store_cache_all_layers(torch.stack(k_all), torch.stack(v_all), k_cache, v_cache, slot_loc)
    return x, k_cache, v_cache


def prefill(params, cfg: LlamaConfig, k_cache, v_cache, tokens, positions, q_lens, slot_loc,
            rope_cache):
    """Prefill a padded batch. tokens/positions [B, S]; q_lens [B];
    slot_loc [B, S] flat cache slots (-1 past q_len). Returns (last-token
    logits [B, V] float32, k_cache, v_cache); the pools are updated in
    place."""
    b, s = tokens.shape
    x = params["embed"][tokens.reshape(-1).long()].to(cfg.dtype)
    x, k_cache, v_cache = prefill_layers(params["layers"], cfg, k_cache, v_cache, x, positions,
                                         q_lens, slot_loc, rope_cache)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps).reshape(b, s, -1)
    last = (q_lens.long().to(x.device) - 1).clamp(0, s - 1)
    x_last = x[torch.arange(b, device=x.device), last]
    logits = _linear(x_last, params["lm_head"], cfg).float()[:, : cfg.vocab_size]
    return logits, k_cache, v_cache


def prefill_layers(lw, cfg: LlamaConfig, k_cache, v_cache, x, positions, q_lens, slot_loc,
                   rope_cache):
    """The decoder layers in prefill mode on x [B*S, H]: causal flash
    attention over the fresh batch and a KV store per layer."""
    b, s = positions.shape
    n_stack = lw["input_norm"].shape[0]
    for lidx in range(n_stack):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q, k, v = _qkv(h, lw, cfg, b * s, layer_id=lidx)
        q, k = rotary_embedding(positions.reshape(-1), q, k, cfg.head_dim, rope_cache)
        store_cache_stacked(k, v, k_cache, v_cache, slot_loc.reshape(-1), lidx)
        attn = flash_attention(
            q.reshape(b, s, cfg.num_heads, cfg.head_dim),
            k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim),
            q_lens, q_lens, causal=True,
        ).reshape(b * s, -1)
        x = _linear(attn, lw["o"], cfg, residual=x, layer_id=lidx)
        h2 = rmsnorm(x, lw["post_norm"][lidx], cfg.rms_eps)
        x = _mlp(h2, lw, cfg, residual=x, layer_id=lidx)
    return x, k_cache, v_cache
