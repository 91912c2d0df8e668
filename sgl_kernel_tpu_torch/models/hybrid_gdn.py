"""Hybrid GDN model (Qwen3-Next style): Gated DeltaNet linear-attention
layers alternating with paged GQA layers (sgl_kernel_tpu/models/hybrid_gdn.py).

Even layers run GDN (ops/linear_attn/gdn.py) over per-sequence conv and SSM
states, which need no KV pages; odd layers are the Llama GQA block over the
paged KV pools. Each family's weights are stacked on their own and indexed
by ``lidx // 2``: the attention stacks hold L // 2 layers, the GDN stacks
ceil(L / 2). Parameters keep the JAX tree's keys (the Llama keys plus
``gdn_norm``, ``gdn_qkvz``, ``gdn_ba``, ``gdn_conv_w``, ``gdn_conv_b``,
``gdn_a_log``, ``gdn_dt_bias``, ``gdn_out``), so a JAX tree converts by
``interop.params_from_numpy``. Like the JAX family it takes bf16 / float32
weights with separate q / k / v and gate / up projections (``fused=False``,
no ``quant``).

Entry points: ``prefill`` (a padded prompt batch from given states),
``prefill_extend`` (a chunk continuing the recurrence from the carried
states; its GQA layers run K7's two passes with lse and ``merge_state``)
and ``decode_step``. Each takes the states as batch rows (the adapter
gathers and scatters them by state slot), updates them and the KV pools IN
PLACE, where JAX donates them, and returns them.

Kernels on the path: rmsnorm (K2: the GDN and Llama norms), flash prefill
(K7 at the attention layers' head dim, 256 at Qwen3-Next's widths), and at
decode rope_decode_fused (K4), paged decode attention (K5, the step's fresh
rows passed in) and the all-layers KV store (K6, once after the loop, as
``llama.decode_layers`` does; JAX stores each layer with
``store_cache_stacked``, which gives the same pools since the attention reads
the fresh rows). The GDN ops are plain PyTorch, as they are plain ``jnp``
in JAX, and the linears plain ``torch.matmul``. The decode reads nothing
back to the host, so the engine captures it in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

import torch

from ..ops.attention import flash_attention, paged_attention_decode_dma
from ..ops.kvcache import store_cache_all_layers, store_cache_stacked
from ..ops.linear_attn import gdn_attention_decode, gdn_attention_prefill
from ..ops.norm import rmsnorm
from ..ops.rope import rope_decode_fused, rotary_embedding
from ..utils import resolve_device
from . import llama


@dataclasses.dataclass(frozen=True)
class HybridGdnConfig(llama.LlamaConfig):
    num_k_heads: int = 4
    num_v_heads: int = 8
    head_k_dim: int = 64
    head_v_dim: int = 64
    conv_width: int = 4

    def __post_init__(self):
        super().__post_init__()
        if self.fused or self.quant is not None:
            # the JAX init slices the separate q / k / v / gate / up stacks
            # (hybrid_gdn.py:67-70), which a fused or quantized tree lacks
            raise NotImplementedError("HybridGdnConfig takes fused=False and no quant, as the JAX family")
        if self.num_v_heads % self.num_k_heads:
            raise ValueError(f"HybridGdnConfig: {self.num_v_heads} v-heads over {self.num_k_heads} k-heads")

    @property
    def qkvz_dim(self):
        g = self.num_v_heads // self.num_k_heads
        return self.num_k_heads * (2 * self.head_k_dim + 2 * g * self.head_v_dim)

    @property
    def ba_dim(self):
        return self.num_k_heads * 2 * (self.num_v_heads // self.num_k_heads)

    @property
    def conv_dim(self):
        return 2 * self.num_k_heads * self.head_k_dim + self.num_v_heads * self.head_v_dim

    @staticmethod
    def tiny(**kw):
        kw.setdefault("dtype", torch.float32)
        return HybridGdnConfig(
            vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=4, num_heads=4, num_kv_heads=2, head_dim=32,
            max_position=256, num_k_heads=2, num_v_heads=4, head_k_dim=16, head_v_dim=16, **kw
        )


def _n_gdn(cfg) -> int:
    return (cfg.num_layers + 1) // 2


def init_weights(cfg: HybridGdnConfig, generator: Union[torch.Generator, int] = 0, device="cuda") -> Dict[str, Any]:
    """Random weights: the Llama tree with its attention stacks over the L //
    2 odd layers, and the GDN stacks over the ceil(L / 2) even layers (the JAX
    init's shapes and scales: projections N(0, 1 / hidden), conv weights
    N(0, 0.09), A_log and dt_bias N(0, 0.01) in float32, zero conv bias)."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    base = llama.init_weights(dataclasses.replace(cfg, num_layers=cfg.num_layers // 2), generator, dev)
    lw = base["layers"]
    lg, h = _n_gdn(cfg), cfg.hidden_size
    s = 1.0 / h ** 0.5

    def draw(shape, scale, dtype=cfg.dtype):
        out = torch.empty((lg, *shape), dtype=dtype, device=dev)
        for i in range(lg):  # one float32 layer at a time
            out[i] = (torch.randn(shape, generator=generator, device=dev) * scale).to(dtype)
        return out

    lw["gdn_norm"] = torch.ones((lg, h), dtype=cfg.dtype, device=dev)
    lw["gdn_qkvz"] = draw((cfg.qkvz_dim, h), s)
    lw["gdn_ba"] = draw((cfg.ba_dim, h), s)
    lw["gdn_conv_w"] = draw((cfg.conv_dim, cfg.conv_width), 0.3)
    lw["gdn_conv_b"] = torch.zeros((lg, cfg.conv_dim), dtype=cfg.dtype, device=dev)
    lw["gdn_a_log"] = draw((cfg.num_v_heads,), 0.1, torch.float32)
    lw["gdn_dt_bias"] = draw((cfg.num_v_heads,), 0.1, torch.float32)
    lw["gdn_out"] = draw((h, cfg.num_v_heads * cfg.head_v_dim), s)
    return base


def make_states(cfg: HybridGdnConfig, max_seqs: int, device="cuda"):
    """Per-sequence GDN state pools, zero: conv [Lg, S, W-1, conv_dim] in
    the model dtype, ssm [Lg, S, Hv, dv, dk] float32."""
    dev = resolve_device(device)
    lg = _n_gdn(cfg)
    conv = torch.zeros((lg, max_seqs, cfg.conv_width - 1, cfg.conv_dim), dtype=cfg.dtype, device=dev)
    ssm = torch.zeros((lg, max_seqs, cfg.num_v_heads, cfg.head_v_dim, cfg.head_k_dim), dtype=torch.float32,
                      device=dev)
    return conv, ssm


def make_caches(cfg: HybridGdnConfig, num_pages: int, page_size: int, kv_dtype=None, device="cuda"):
    """KV pools for the L // 2 attention layers only."""
    half = dataclasses.replace(cfg, num_layers=max(cfg.num_layers // 2, 1))
    return llama.make_caches(half, num_pages, page_size, kv_dtype, device=device)


build_rope_cache = llama.build_rope_cache


def _gdn_kw(cfg):
    return dict(num_k_heads=cfg.num_k_heads, num_v_heads=cfg.num_v_heads, head_k_dim=cfg.head_k_dim,
                head_v_dim=cfg.head_v_dim)


def _gdn_layer(x, lw, cfg, half: int, conv_state, ssm_state, seq_lens=None, lead=None):
    """One GDN layer on the residual stream x [T, H] (T = B, or B * S with
    ``lead`` = (B, S) and the prompt lengths ``seq_lens``): norm, the fused
    projections, the GDN op, the z-gated output projection added to x. The
    layer's state rows ``conv_state[half]`` / ``ssm_state[half]`` are updated
    in place."""
    h = rmsnorm(x, lw["gdn_norm"][half], cfg.rms_eps)
    qkvz = llama._linear(h, lw["gdn_qkvz"], cfg, layer_id=half)
    ba = llama._linear(h, lw["gdn_ba"], cfg, layer_id=half)
    args = (lw["gdn_conv_w"][half], lw["gdn_conv_b"][half], lw["gdn_a_log"][half], lw["gdn_dt_bias"][half],
            conv_state[half], ssm_state[half])
    if lead is None:
        o, z, cs, ss = gdn_attention_decode(qkvz, ba, *args, **_gdn_kw(cfg))
    else:
        o, z, cs, ss = gdn_attention_prefill(qkvz.reshape(*lead, -1), ba.reshape(*lead, -1), *args, seq_lens,
                                             **_gdn_kw(cfg))
    conv_state[half].copy_(cs)
    ssm_state[half].copy_(ss)
    zf = z.float()
    gated = (o.float() * zf * torch.sigmoid(zf)).reshape(x.shape[0], -1)
    return x + llama._linear(gated.to(cfg.dtype), lw["gdn_out"], cfg, layer_id=half)


def _mlp_block(x, attn, lw, cfg, half: int):
    """The attention layer's tail: o projection with the residual, post-norm
    and the SwiGLU MLP with the residual."""
    x = llama._linear(attn, lw["o"], cfg, residual=x, layer_id=half)
    h2 = rmsnorm(x, lw["post_norm"][half], cfg.rms_eps)
    return llama._mlp(h2, lw, cfg, residual=x, layer_id=half)


def decode_step(params, cfg: HybridGdnConfig, k_cache, v_cache, conv_state, ssm_state, tokens, positions,
                page_tables, lengths, slot_loc, rope_cache):
    """One decode step. tokens / positions / lengths / slot_loc [B];
    page_tables [B, max_pages]; conv_state [Lg, B, W-1, conv_dim] and
    ssm_state [Lg, B, Hv, dv, dk] are the batch rows' states. Returns (logits
    [B, V] float32, k_cache, v_cache, conv_state, ssm_state); all four are
    updated in place. Every attention layer reads pools that do not hold the
    current token yet (it rides as K5's fresh row); the layers' K/V are
    stored once after the loop (K6)."""
    b = tokens.shape[0]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    lw = params["layers"]
    k_all, v_all = [], []
    for lidx in range(cfg.num_layers):
        half = lidx // 2
        if lidx % 2 == 0:
            x = _gdn_layer(x, lw, cfg, half, conv_state, ssm_state)
            continue
        h = rmsnorm(x, lw["input_norm"][half], cfg.rms_eps)
        q, k, v = llama._qkv(h, lw, cfg, b, layer_id=half)
        q, k = rope_decode_fused(positions, q, k, rope_cache)
        attn = paged_attention_decode_dma(q, k_cache, v_cache, lengths, page_tables, layer_id=half,
                                          fresh_k=k, fresh_v=v, **llama._kv_att_kwargs(cfg))
        x = _mlp_block(x, attn.reshape(b, -1), lw, cfg, half)
        k_all.append(k)
        v_all.append(v)
    if k_all:
        store_cache_all_layers(llama._kv_quant(cfg, torch.stack(k_all)), llama._kv_quant(cfg, torch.stack(v_all)),
                               k_cache, v_cache, slot_loc)
    logits = llama._linear(x, params["lm_head"], cfg, norm=params["final_norm"]).float()[:, : cfg.vocab_size]
    return logits, k_cache, v_cache, conv_state, ssm_state


def _prefill_core(params, cfg, k_cache, v_cache, conv_state, ssm_state, tokens, positions, q_lens, slot_loc,
                  rope_cache, attention):
    """The layers of prefill and prefill_extend over a padded batch; the
    attention layers' attention is ``attention(q, k, v, half)`` on [B, S,
    heads, D] rows, after their K/V are stored. Returns the last token's
    logits."""
    b, s = tokens.shape
    dev = k_cache.device
    q_lens = q_lens.to(dev, torch.int32)
    x = params["embed"][tokens.reshape(-1).long()].to(cfg.dtype)
    lw = params["layers"]
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for lidx in range(cfg.num_layers):
        half = lidx // 2
        if lidx % 2 == 0:
            x = _gdn_layer(x, lw, cfg, half, conv_state, ssm_state, q_lens, (b, s))
            continue
        h = rmsnorm(x, lw["input_norm"][half], cfg.rms_eps)
        q, k, v = llama._qkv(h, lw, cfg, b * s, layer_id=half)
        q, k = rotary_embedding(positions.reshape(-1), q, k, d, rope_cache)
        store_cache_stacked(llama._kv_quant(cfg, k), llama._kv_quant(cfg, v), k_cache, v_cache,
                            slot_loc.reshape(-1), half)
        attn = attention(q.reshape(b, s, nq, d), k.reshape(b, s, nkv, d), v.reshape(b, s, nkv, d), half)
        x = _mlp_block(x, attn, lw, cfg, half)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps).reshape(b, s, -1)
    return llama._linear(llama.logit_rows(x, q_lens), params["lm_head"], cfg).float()[:, : cfg.vocab_size]


def prefill(params, cfg: HybridGdnConfig, k_cache, v_cache, conv_state, ssm_state, tokens, positions, q_lens,
            slot_loc, rope_cache):
    """Prefill a padded batch from the given states (the adapter passes
    zeros: a prompt starts its recurrence empty). tokens / positions /
    slot_loc [B, S]; q_lens [B]; conv_state / ssm_state the rows' states
    [Lg, B, ...]. Returns (last-token logits [B, V] float32, k_cache,
    v_cache, conv_state, ssm_state); all updated in place."""
    def attention(q, k, v, half):
        b, s = q.shape[:2]
        return flash_attention(q, k, v, q_lens, q_lens, causal=True).reshape(b * s, -1)

    logits = _prefill_core(params, cfg, k_cache, v_cache, conv_state, ssm_state, tokens, positions, q_lens,
                           slot_loc, rope_cache, attention)
    return logits, k_cache, v_cache, conv_state, ssm_state


def prefill_extend(params, cfg: HybridGdnConfig, k_cache, v_cache, conv_state, ssm_state, tokens, positions,
                   q_lens, kv_lens, page_tables, slot_loc, rope_cache, *, prefix_max: int):
    """A chunk of sequences whose earlier chunks ran through this model: the
    GDN layers continue the recurrence from the carried states (so the
    states must be the ones this sequence's previous chunk left; no prefix
    of another request can stand in, and the adapter says
    ``supports_prefix_reuse = False``), the GQA layers attend the fresh chunk
    causally at its global offsets and the cached prefix (``prefix_max``
    gathered positions, a page multiple), joined by ``merge_state``.
    tokens / positions / slot_loc [B, S]; q_lens [B] chunk lengths; kv_lens
    [B] total lengths; page_tables [B, P]. Returns (logits [B, V] float32,
    k_cache, v_cache, conv_state, ssm_state); all updated in place."""
    dev = k_cache.device
    q_lens32 = q_lens.to(dev, torch.int32)
    prefix_lens = kv_lens.to(dev, torch.int32) - q_lens32
    page_sz = k_cache.shape[-2]
    pre_slots = llama._prefix_slots(page_tables.to(dev), prefix_max, page_sz)

    def attention(q, k, v, half):
        kpre = llama._kv_deq(cfg, llama._gather_prefix(k_cache, half, pre_slots, page_sz), q.dtype)
        vpre = llama._kv_deq(cfg, llama._gather_prefix(v_cache, half, pre_slots, page_sz), q.dtype)
        return llama._extend_attention(cfg, q, k, v, q_lens32, prefix_lens, kpre, vpre)

    logits = _prefill_core(params, cfg, k_cache, v_cache, conv_state, ssm_state, tokens, positions, q_lens,
                           slot_loc, rope_cache, attention)
    return logits, k_cache, v_cache, conv_state, ssm_state
