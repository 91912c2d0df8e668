"""Mixtral-family model: the Llama decoder with a routed MoE MLP, on the
port's operators.

The port of sgl_kernel_tpu/models/mixtral.py. Every Llama building block is
reused (models/llama.py: the separate q/k/v linears, paged GQA attention,
layer-stacked weights picked by ``layer_id``); the SwiGLU MLP becomes
softmax top-k routing (``topk_softmax``) into ``fused_experts`` over the
layer-stacked expert banks, whose layer the grouped GEMM picks by offset.
Parameters are the JAX pytree's paths (``layers.router``, ``layers.moe_w1``
[L, E, H, 2I], ``layers.moe_w2`` [L, E, I, H], ...), so a JAX tree converts by
a copy (``interop.params_from_numpy``). With ``quant="w4a16"`` the attention
linears are quantized per layer (``{"packed", "scales"}`` [L, K/2, N]), the
lm_head's N padded to a multiple of 2048, and each expert's W.T quantized
into the stacked [L, E, K/2, N] banks.

Entry points, each updating the KV pools IN PLACE where JAX donates them:
``decode_step``, ``prefill`` (a padded batch), ``prefill_packed`` (several
prompts block-aligned into one launch) and ``prefill_extend`` (a suffix over
a cached prefix: two flash passes merged by lse; ``num_logits=n`` gives each
sequence's last n positions, [B, n, V], the speculative chain verify's form). The
JAX model has no mixed step, so neither has this one: the engine advances
chunked prompts by extend.

Kernels on the path: K2 rmsnorm, K1 (every W4A16 linear), K4
rope_decode_fused (decode), K5 paged decode attention with the fresh token,
K6 the all-layers KV store after the decode layers, K7 flash prefill (and
the extend passes), K9 packed prefill, and the routed experts' grouped GEMM:
K12 (bf16 banks) or K11 (int4 or mxfp4 banks). ``quant="mxfp4"`` is the
gpt-oss checkpoint format: each expert's W.T goes to E2M1 codes with UE8M0
group-32 scales (``per_token_group_quant_fp4``, then ``mxfp4_to_tpu_layout``:
[L, E, K/2, N] codes, [L, E, K/32, N] bf16 scales), while the attention
linears and the lm_head stay bf16 and run on cuBLAS, as the JAX model runs
them on ``jnp.dot`` outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

import torch

from ..ops.attention import flash_attention, flash_attention_packed, paged_attention_decode_dma
from ..ops.gemm.w4a16 import mxfp4_to_tpu_layout, quantize_w4
from ..ops.kvcache import store_cache_all_layers, store_cache_stacked
from ..ops.moe import MoeWeights, fused_experts, topk_softmax
from ..ops.norm import rmsnorm
from ..ops.quant import per_token_group_quant_fp4
from ..ops.rope import rope_decode_fused, rotary_embedding
from ..utils import resolve_device
from . import llama


@dataclasses.dataclass(frozen=True)
class MixtralConfig(llama.LlamaConfig):
    num_experts: int = 8
    top_k: int = 2

    _QUANTS = (None, "w4a16", "mxfp4")

    def __post_init__(self):
        super().__post_init__()
        if self.fused:
            raise ValueError("Mixtral paths emit separate q/k/v: fused=True is not a Mixtral layout")
        if self.kv_scale is not None:
            # the JAX model's programs store K/V unscaled and pass no scale to
            # the attention
            raise NotImplementedError("MixtralConfig(kv_scale=...): quantized KV pools are not served")

    @staticmethod
    def mixtral_8x7b(**kw):
        return MixtralConfig(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=1e6, num_experts=8, top_k=2, **kw
        )

    @staticmethod
    def tiny(**kw):
        kw.setdefault("dtype", torch.float32)
        return MixtralConfig(
            vocab_size=256, hidden_size=128, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            max_position=256, num_experts=4, top_k=2, **kw
        )


def init_weights(cfg: MixtralConfig, generator: Union[torch.Generator, int] = 0, device="cuda") -> Dict[str, Any]:
    """Random layer-stacked weights in the JAX recipe's shapes and scales:
    Llama's attention, norms, embedding and lm_head, a router [L, E, H] and
    expert banks [L, E, H, 2I] and [L, E, I, H], each N(0, 1/fan_in).
    ``generator`` is a torch.Generator on ``device`` or an int seed. Each
    expert's matrix is drawn in float32, cast and (W4A16) quantized on its
    own, so the float32 temporaries stay one expert large (a float32 draw of
    Mixtral-8x7B's whole gate_up bank would be 120 GB). ``quant="mxfp4"``
    quantizes the expert banks alone (mixtral.py:89-107 of the JAX package)."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    dense_cfg = dataclasses.replace(cfg, quant=None) if cfg.quant == "mxfp4" else cfg
    params = llama.init_weights(dense_cfg, generator, dev, mlp=False)
    lw = params["layers"]
    n_layers, h, inter, e = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.num_experts

    def draw(shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    lw["router"] = torch.empty((n_layers, e, h), dtype=cfg.dtype, device=dev)
    for i in range(n_layers):
        lw["router"][i] = draw((e, h), 1.0 / h ** 0.5).to(cfg.dtype)

    def bank(k, n):
        """[L, E, K, N] (x @ W), or packed [L, E, K/2, N] and scales
        [L, E, K/G, N]: each expert's W.T quantized alone (the JAX qexp)."""
        if cfg.quant is None:
            out = torch.empty((n_layers, e, k, n), dtype=cfg.dtype, device=dev)
            for i in range(n_layers):
                for j in range(e):
                    out[i, j] = draw((k, n), 1.0 / k ** 0.5).to(cfg.dtype)
            return out
        packed = scales = None
        for i in range(n_layers):
            for j in range(e):
                wt = draw((k, n), 1.0 / k ** 0.5).to(cfg.dtype).t()
                if cfg.quant == "mxfp4":
                    p, s = mxfp4_to_tpu_layout(*per_token_group_quant_fp4(wt.float()))
                else:
                    p, s, _ = quantize_w4(wt, group_size=cfg.group_size)
                if packed is None:
                    packed = p.new_empty((n_layers, e, *p.shape))
                    scales = s.new_empty((n_layers, e, *s.shape))
                packed[i, j], scales[i, j] = p, s
        return {"packed": packed, "scales": scales}

    lw["moe_w1"] = bank(h, 2 * inter)
    lw["moe_w2"] = bank(inter, h)
    return params


make_caches = llama.make_caches
build_rope_cache = llama.build_rope_cache


def moe_weights_for(lw, cfg: MixtralConfig) -> MoeWeights:
    """MoeWeights over the stacked expert banks: int4 (``cfg.group_size``)
    or, under ``quant="mxfp4"``, mxfp4 (groups of 32) when they are quantized
    trees, bf16 otherwise (expert biases where the tree has them;
    mixtral.py:113-121)."""
    w1, w2 = lw["moe_w1"], lw["moe_w2"]
    b1, b2 = lw.get("moe_b1"), lw.get("moe_b2")
    if isinstance(w1, dict):
        mx = cfg.quant == "mxfp4"
        return MoeWeights(w1=w1["packed"], w2=w2["packed"], w1_scales=w1["scales"], w2_scales=w2["scales"],
                          b1=b1, b2=b2, fmt="mxfp4" if mx else "int4", group_size=32 if mx else cfg.group_size)
    return MoeWeights(w1=w1, w2=w2, b1=b1, b2=b2, fmt="bf16")


def _moe_mlp(h2, lw, lidx: int, cfg: MixtralConfig):
    """Router logits in float32, softmax top-k renormalized, then the routed
    experts of the stacked banks at layer ``lidx`` (no copy of a bank)."""
    logits = torch.matmul(h2.float(), lw["router"][lidx].float().t())
    if "router_bias" in lw:
        logits = logits + lw["router_bias"][lidx].float()
    tw, tids = topk_softmax(logits, cfg.top_k, renormalize=True)
    return fused_experts(h2, moe_weights_for(lw, cfg), tw, tids, layer_id=lidx).to(cfg.dtype)


def _block_tail(x, attn, lw, lidx: int, cfg: MixtralConfig):
    """o projection with the residual (and ``o_bias`` where the tree has one),
    then the post-norm and the MoE MLP."""
    x = llama._linear(attn, lw["o"], cfg, residual=x, layer_id=lidx, bias=lw.get("o_bias"))
    return x + _moe_mlp(rmsnorm(x, lw["post_norm"][lidx], cfg.rms_eps), lw, lidx, cfg)


def _logits(x, params, cfg: MixtralConfig):
    return llama._linear(x, params["lm_head"], cfg).float()[:, : cfg.vocab_size]


def decode_step(params, cfg: MixtralConfig, k_cache, v_cache, tokens, positions, page_tables, lengths, slot_loc,
                rope_cache):
    """One decode step. tokens/positions/lengths/slot_loc [B]; page_tables
    [B, max_pages]. Each layer attends over pools that do not hold the
    current token yet (it rides as the fresh row); all layers' K/V are
    stored once after the loop. Returns (logits [B, V] float32, k_cache,
    v_cache); the pools are updated in place."""
    b = tokens.shape[0]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    lw = params["layers"]
    k_all, v_all = [], []
    for lidx in range(cfg.num_layers):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q, k, v = llama._qkv(h, lw, cfg, b, layer_id=lidx)
        q, k = rope_decode_fused(positions, q, k, rope_cache)
        attn = paged_attention_decode_dma(q, k_cache, v_cache, lengths, page_tables, layer_id=lidx, fresh_k=k,
                                          fresh_v=v)
        x = _block_tail(x, attn.reshape(b, -1), lw, lidx, cfg)
        k_all.append(k)
        v_all.append(v)
    store_cache_all_layers(torch.stack(k_all), torch.stack(v_all), k_cache, v_cache, slot_loc)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    return _logits(x, params, cfg), k_cache, v_cache


def prefill(params, cfg: MixtralConfig, k_cache, v_cache, tokens, positions, q_lens, slot_loc, rope_cache):
    """Prefill a padded batch. tokens/positions [B, S]; q_lens [B]; slot_loc
    [B, S] (-1 past q_len). Returns (last-token logits [B, V] float32,
    k_cache, v_cache); the pools are updated in place."""
    b, s = tokens.shape
    x = params["embed"][tokens.reshape(-1).long()].to(cfg.dtype)
    lw = params["layers"]
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for lidx in range(cfg.num_layers):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q, k, v = llama._qkv(h, lw, cfg, b * s, layer_id=lidx)
        q, k = rotary_embedding(positions.reshape(-1), q, k, d, rope_cache)
        store_cache_stacked(k, v, k_cache, v_cache, slot_loc.reshape(-1), lidx)
        attn = flash_attention(q.reshape(b, s, nq, d), k.reshape(b, s, nkv, d), v.reshape(b, s, nkv, d), q_lens,
                               q_lens, causal=True).reshape(b * s, -1)
        x = _block_tail(x, attn, lw, lidx, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps).reshape(b, s, -1)
    last = (q_lens.long().to(x.device) - 1).clamp(0, s - 1)
    return _logits(x[torch.arange(b, device=x.device), last], params, cfg), k_cache, v_cache


def prefill_extend(params, cfg: MixtralConfig, k_cache, v_cache, tokens, positions, q_lens, kv_lens, page_tables,
                   slot_loc, rope_cache, *, prefix_max: int, num_logits: int = 1):
    """Extend (chunked) prefill of a suffix over a prefix already in the
    paged cache (llama.prefill_extend's two flash passes merged by lse, with
    the MoE MLP). Returns (logits [B, V] float32 of each suffix's last
    token, k_cache, v_cache); with ``num_logits`` n > 1 (the speculative
    verify) [B, n, V], of each sequence's last n positions."""
    b, s = tokens.shape
    dev = k_cache.device
    x = params["embed"][tokens.reshape(-1).long()].to(cfg.dtype)
    lw = params["layers"]
    q_lens = q_lens.to(dev, torch.int32)
    prefix_lens = kv_lens.to(dev, torch.int32) - q_lens
    page_sz = k_cache.shape[-2]
    pre_slots = llama._prefix_slots(page_tables.to(dev), prefix_max, page_sz)
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for lidx in range(cfg.num_layers):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q, k, v = llama._qkv(h, lw, cfg, b * s, layer_id=lidx)
        q, k = rotary_embedding(positions.reshape(-1), q, k, d, rope_cache)
        store_cache_stacked(k, v, k_cache, v_cache, slot_loc.reshape(-1), lidx)
        qb = q.reshape(b, s, nq, d)
        kpre = llama._gather_prefix(k_cache, lidx, pre_slots, page_sz).to(qb.dtype)
        vpre = llama._gather_prefix(v_cache, lidx, pre_slots, page_sz).to(qb.dtype)
        attn = llama._extend_attention(cfg, qb, k.reshape(b, s, nkv, d), v.reshape(b, s, nkv, d), q_lens,
                                       prefix_lens, kpre, vpre)
        x = _block_tail(x, attn, lw, lidx, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps).reshape(b, s, -1)
    logits = _logits(llama.logit_rows(x, q_lens, num_logits), params, cfg)
    return llama._logits_shape(logits, b, num_logits), k_cache, v_cache


def prefill_packed(params, cfg: MixtralConfig, k_cache, v_cache, tokens, positions, blk_seq, blk_q0, seq_meta,
                   last_idx, slot_loc, rope_cache, *, max_kvb: int):
    """Token-packed multi-prompt prefill (llama.prefill_packed with the MoE
    MLP): tokens/positions/slot_loc [TP] packed; blk_seq/blk_q0 [NQB];
    seq_meta [B, 6]; last_idx [B]. Returns (logits [B, V] float32, k_cache,
    v_cache); the pools are updated in place."""
    tp = tokens.shape[0]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    lw = params["layers"]
    for lidx in range(cfg.num_layers):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q, k, v = llama._qkv(h, lw, cfg, tp, layer_id=lidx)
        q, k = rotary_embedding(positions, q, k, cfg.head_dim, rope_cache)
        store_cache_stacked(k, v, k_cache, v_cache, slot_loc, lidx)
        attn = flash_attention_packed(q, k, v, blk_seq, blk_q0, seq_meta, max_kvb=max_kvb,
                                      causal=True).reshape(tp, -1)
        x = _block_tail(x, attn, lw, lidx, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    return _logits(x[last_idx.long().to(x.device)], params, cfg), k_cache, v_cache
