"""gpt-oss model family on the port's operators: the Mixtral skeleton with
attention sinks, a sliding window on alternate layers and the clamped-swiglu
MoE.

The port of sgl_kernel_tpu/models/gptoss.py. Even layers attend within a
window of ``sliding_window`` tokens (gpt-oss's 128-token local layers), odd
layers globally; each layer's window is chosen in Python, so every layer's
kernels see a static window (JAX picks between two scan bodies with
``lax.cond``). Per-head sink logits (``layers.sinks`` [L, Hq], natural log)
join each softmax's denominator once. The routed experts run
``fused_experts(activation="swiglu_gpt_oss")`` over the interleaved gate /
up columns of ``moe_w1``, with bf16 banks (K12) or, under
``quant="mxfp4"``, the checkpoint's MXFP4 banks (K11, groups of 32); the
attention linears and the lm_head stay bf16. The parameter tree is
Mixtral's (``o_bias``, ``router_bias``, ``moe_b1``, ``moe_b2`` where the tree
has them) plus ``sinks``, and with ``qkv_bias=True`` the q / k / v biases.

Entry points, each updating the KV pools IN PLACE where JAX donates them:
``decode_step`` (K5 with the sinks and the layer's window), ``prefill`` and
``prefill_packed`` (K7 / K9 with the sinks and the window in one launch a
layer) and ``prefill_extend``, whose two flash passes (the suffix over
itself, over the cached prefix) run with the window and without the sinks;
their states merge by lse (``merge_state``) and ``apply_sinks`` adds the
sink once after (gptoss.py:158-233). ``num_logits=1`` only.

Kernels on the path: K2 rmsnorm, K4 rope_decode_fused, K5, K6 the
all-layers store after the decode layers, K7, K9 and K11 (mxfp4) or K12
(bf16) in the MoE.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from ..ops.attention import (apply_sinks, flash_attention, flash_attention_packed, merge_state,
                             paged_attention_decode_dma)
from ..ops.kvcache import store_cache_all_layers, store_cache_stacked
from ..ops.moe import fused_experts, topk_softmax
from ..ops.norm import rmsnorm
from ..ops.rope import rope_decode_fused, rotary_embedding
from . import llama, mixtral


@dataclasses.dataclass(frozen=True)
class GptOssConfig(mixtral.MixtralConfig):
    sliding_window: int = 128
    # even layers use the sliding window, odd layers are global
    swiglu_alpha: float = 1.702
    swiglu_limit: float = 7.0

    @staticmethod
    def tiny(**kw):
        kw.setdefault("dtype", torch.float32)
        return GptOssConfig(
            vocab_size=256, hidden_size=128, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            max_position=256, num_experts=4, top_k=2, sliding_window=16, **kw
        )


def window_of(cfg: GptOssConfig, lidx: int) -> Optional[int]:
    """The sliding window of layer ``lidx``: even layers local, odd global."""
    return cfg.sliding_window if lidx % 2 == 0 else None


def init_weights(cfg: GptOssConfig, generator: Union[torch.Generator, int] = 0, device="cuda") -> Dict[str, Any]:
    """Mixtral's random weights (``mixtral.init_weights``) plus zero sinks
    [L, Hq] in the model dtype, as the JAX init (gptoss.py:48-51)."""
    params = mixtral.init_weights(cfg, generator, device)
    lw = params["layers"]
    lw["sinks"] = torch.zeros((cfg.num_layers, cfg.num_heads), dtype=cfg.dtype, device=lw["input_norm"].device)
    return params


make_caches = llama.make_caches
build_rope_cache = llama.build_rope_cache


def _moe(h2, lw, lidx: int, cfg: GptOssConfig):
    """Router logits in float32 (plus ``router_bias``), softmax top-k
    renormalized, then the routed experts with gpt-oss's clamped swiglu."""
    logits = torch.matmul(h2.float(), lw["router"][lidx].float().t())
    if "router_bias" in lw:
        logits = logits + lw["router_bias"][lidx].float()
    tw, tids = topk_softmax(logits, cfg.top_k, renormalize=True)
    return fused_experts(h2, mixtral.moe_weights_for(lw, cfg), tw, tids, layer_id=lidx,
                         activation="swiglu_gpt_oss", gemm1_alpha=cfg.swiglu_alpha,
                         gemm1_limit=cfg.swiglu_limit).to(cfg.dtype)


def _block_tail(x, attn, lw, lidx: int, cfg: GptOssConfig):
    x = llama._linear(attn, lw["o"], cfg, residual=x, layer_id=lidx, bias=lw.get("o_bias"))
    return x + _moe(rmsnorm(x, lw["post_norm"][lidx], cfg.rms_eps), lw, lidx, cfg)


def decode_step(params, cfg: GptOssConfig, k_cache, v_cache, tokens, positions, page_tables, lengths, slot_loc,
                rope_cache):
    """One decode step. tokens/positions/lengths/slot_loc [B]; page_tables
    [B, max_pages]. Each layer attends over pools without the current token
    (it rides as the fresh row) with its sinks and window; all layers' K/V
    are stored once after the loop. Returns (logits [B, V] float32, k_cache,
    v_cache); the pools are updated in place."""
    b = tokens.shape[0]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    lw = params["layers"]
    k_all, v_all = [], []
    for lidx in range(cfg.num_layers):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q, k, v = llama._qkv(h, lw, cfg, b, layer_id=lidx)
        q, k = rope_decode_fused(positions, q, k, rope_cache)
        attn = paged_attention_decode_dma(q, k_cache, v_cache, lengths, page_tables, lw["sinks"][lidx],
                                          layer_id=lidx, fresh_k=k, fresh_v=v,
                                          sliding_window=window_of(cfg, lidx))
        x = _block_tail(x, attn.reshape(b, -1), lw, lidx, cfg)
        k_all.append(k)
        v_all.append(v)
    store_cache_all_layers(torch.stack(k_all), torch.stack(v_all), k_cache, v_cache, slot_loc)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    return mixtral._logits(x, params, cfg), k_cache, v_cache


def prefill(params, cfg: GptOssConfig, k_cache, v_cache, tokens, positions, q_lens, slot_loc, rope_cache):
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
                               q_lens, lw["sinks"][lidx], causal=True,
                               sliding_window=window_of(cfg, lidx)).reshape(b * s, -1)
        x = _block_tail(x, attn, lw, lidx, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps).reshape(b, s, -1)
    last = (q_lens.long().to(x.device) - 1).clamp(0, s - 1)
    return mixtral._logits(x[torch.arange(b, device=x.device), last], params, cfg), k_cache, v_cache


def _extend_attention(cfg: GptOssConfig, lidx: int, q, k, v, q_lens, prefix_lens, kpre, vpre, sinks):
    """A suffix over its fresh rows and its cached prefix: both flash passes
    windowed and sink-free, merged by lse, the sinks applied once after.
    Returns [B*S, Hq*D] in the model dtype."""
    b, s = q.shape[:2]
    win = window_of(cfg, lidx)
    o1, l1 = flash_attention(q, k, v, q_lens, q_lens, q_start=prefix_lens, kv_start=prefix_lens, causal=True,
                             sliding_window=win, return_lse=True)
    o2, l2 = flash_attention(q, kpre, vpre, q_lens, prefix_lens, q_start=prefix_lens,
                             kv_start=torch.zeros_like(prefix_lens), causal=True, sliding_window=win, return_lse=True)
    hq, d = cfg.num_heads, cfg.head_dim
    om, lm = merge_state(o1.reshape(b * s, hq, d), l1.transpose(1, 2).reshape(b * s, hq),
                         o2.reshape(b * s, hq, d), l2.transpose(1, 2).reshape(b * s, hq))
    return apply_sinks(om, lm, sinks).reshape(b * s, -1).to(cfg.dtype)


def prefill_extend(params, cfg: GptOssConfig, k_cache, v_cache, tokens, positions, q_lens, kv_lens, page_tables,
                   slot_loc, rope_cache, *, prefix_max: int, num_logits: int = 1):
    """Extend (chunked) prefill of a suffix over a prefix already in the
    paged cache: the suffix's K/V stored, ``prefix_max`` cached positions
    gathered, then ``_extend_attention``. Returns (logits [B, V] float32 of
    each suffix's last token, k_cache, v_cache). ``num_logits`` must be 1:
    JAX's gpt-oss extend has no several-logit form (gptoss.py:155-158), so
    gpt-oss takes no draft (``GptOssAdapter.supports_spec`` is False)."""
    if num_logits != 1:
        raise NotImplementedError("gpt-oss prefill_extend gives one logit per sequence (JAX's has no num_logits)")
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
        attn = _extend_attention(cfg, lidx, qb, k.reshape(b, s, nkv, d), v.reshape(b, s, nkv, d), q_lens,
                                 prefix_lens, kpre, vpre, lw["sinks"][lidx])
        x = _block_tail(x, attn, lw, lidx, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps).reshape(b, s, -1)
    last = (q_lens.long() - 1).clamp(0, s - 1)
    return mixtral._logits(x[torch.arange(b, device=dev), last], params, cfg), k_cache, v_cache


def prefill_packed(params, cfg: GptOssConfig, k_cache, v_cache, tokens, positions, blk_seq, blk_q0, seq_meta,
                   last_idx, slot_loc, rope_cache, *, max_kvb: int):
    """Token-packed multi-prompt prefill: K9 takes the sinks and the window
    in its one launch a layer, no merge. tokens/positions/slot_loc [TP];
    blk_seq/blk_q0 [NQB]; seq_meta [B, 6]; last_idx [B]. Returns (logits
    [B, V] float32, k_cache, v_cache); the pools are updated in place."""
    tp = tokens.shape[0]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    lw = params["layers"]
    for lidx in range(cfg.num_layers):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q, k, v = llama._qkv(h, lw, cfg, tp, layer_id=lidx)
        q, k = rotary_embedding(positions, q, k, cfg.head_dim, rope_cache)
        store_cache_stacked(k, v, k_cache, v_cache, slot_loc, lidx)
        attn = flash_attention_packed(q, k, v, blk_seq, blk_q0, seq_meta, max_kvb=max_kvb, causal=True,
                                      sinks=lw["sinks"][lidx], sliding_window=window_of(cfg, lidx)).reshape(tp, -1)
        x = _block_tail(x, attn, lw, lidx, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    return mixtral._logits(x[last_idx.long().to(x.device)], params, cfg), k_cache, v_cache
