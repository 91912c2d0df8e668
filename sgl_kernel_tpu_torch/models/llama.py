"""Llama-family model (bf16/float32 or W4A16 int4 weights) on the port's operators.

Decoder-only transformer: RMSNorm, RoPE, GQA attention over a paged KV
cache, SwiGLU MLP. Parameters are a nested dict of layer-stacked tensors
whose keys are the JAX package's pytree paths (``embed``, ``final_norm``,
``lm_head``, ``layers.qkv``, ``layers.gate_up``, ...), so a JAX parameter
tree converts by a copy (``interop.params_from_numpy``). With
``quant="w4a16"`` every linear is a ``{"packed", "scales"}`` dict in the
layout of ops/gemm/w4a16.py and runs the W4A16 GEMM (K1); the lm_head's N
is padded to a multiple of 2048 and its logits sliced back.

Entry points: ``prefill`` (flash attention over a padded prompt batch, KV
stored per layer, last-token logits), ``prefill_packed`` (several fresh
prompts block-aligned packed into one launch), ``prefill_extend`` (a suffix
over a prefix already in the paged cache: two flash passes joined by
``merge_state``; with ``num_logits`` the speculative verify's logits of a
sequence's last positions), ``prefill_tree`` (the speculative tree's verify:
a tree-masked fresh pass merged with the prefix), ``decode_step`` (one token
per sequence against the paged cache) and ``mixed_step`` (a decode batch and
one prefill chunk as one token stream). The Qwen options: ``qkv_bias``
adds ``layers.q_bias`` / ``k_bias`` / ``v_bias`` to the projections,
``qk_norm`` (Qwen3, ``qwen3_8b()``) a per-head RMSNorm (``layers.q_norm`` /
``k_norm`` [L, D], K2 over [T, H, D] rows) on q and k before RoPE; either keeps the fused decode (K3) off. All update the
KV pools IN PLACE, where the JAX versions donate them, and return them. KV
pools may be int8 or fp8 with a per-tensor ``kv_scale``: stores quantize
(``_kv_quant``) and decode attention folds the scale back in.

Kernels on the path: W4A16 GEMM (K1, with the decode norms in its
prologue; with ``gemm_impl="dma"`` the decode-bucket GEMMs, M <= 32, take
K10 instead, after a standalone rmsnorm), rmsnorm (K2), rope_decode_fused_qkv (K3; the ``fused=False``
decode step takes K2, the separate q/k/v linears and rope_decode_fused, K4),
paged decode attention (K5), the all-layers KV store (K6), flash prefill
(K7, with its base-2 lse on the extend passes and the tree's non-causal
prefix pass), packed flash prefill (K9).
The bf16 linears are plain ``torch.matmul``, as the JAX model leaves them to
XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from ..ops.attention import flash_attention, flash_attention_packed, merge_state, paged_attention_decode_dma
from ..ops.gemm.w4a16 import quantize_w4, w4a16_gemm
from ..ops.gemm.w4a16_dma import w4a16_gemm_dma
from ..ops.kvcache import store_cache_all_layers, store_cache_stacked
from ..ops.norm import rmsnorm
from ..ops.rope import compute_cos_sin_cache, rope_decode_fused, rope_decode_fused_qkv, rotary_embedding
from ..utils import resolve_device, round_up

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
    quant: Optional[str] = None  # None | "w4a16" ("mxfp4": the MoE configs' expert banks)
    group_size: int = 128
    # q/k/v and gate/up as single fused projections (the serving layout)
    fused: bool = False
    # W4A16 decode GEMM (M <= 32): "pipeline" (K1) or "dma" (K10, streamed
    # weights); prefill always takes K1
    gemm_impl: str = "pipeline"
    # KV pool dtype: None (the model dtype), torch.int8, torch.float8_e4m3fn
    # or torch.float8_e5m2
    kv_dtype: Optional[torch.dtype] = None
    # symmetric per-tensor KV scale: stores write round(x / kv_scale) (int8)
    # or (x / kv_scale) cast (fp8), decode attention folds it back in;
    # required for int8 pools
    kv_scale: Optional[float] = None
    # Qwen-family options: per-head RMSNorm on q / k before RoPE (Qwen3),
    # biases on the q / k / v projections (Qwen2, gpt-oss)
    qk_norm: bool = False
    qkv_bias: bool = False

    # the quant values the config takes; the MoE configs add "mxfp4" (their
    # expert banks), as only the JAX package's MoE models quantize so
    _QUANTS = (None, "w4a16")

    def __post_init__(self):
        if self.quant not in self._QUANTS:
            raise NotImplementedError(f"{type(self).__name__}(quant={self.quant!r}): takes {self._QUANTS}")
        if self.gemm_impl not in ("pipeline", "dma"):
            raise ValueError(f"gemm_impl must be 'pipeline' or 'dma', got {self.gemm_impl!r}")
        if self.kv_dtype not in (None, torch.bfloat16, torch.float32, torch.int8, torch.float8_e4m3fn,
                                 torch.float8_e5m2):
            raise ValueError(f"unsupported kv_dtype {self.kv_dtype}")

    @staticmethod
    def llama3_8b(**kw):
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128, **kw
        )

    @staticmethod
    def qwen3_8b(**kw):
        return LlamaConfig(
            vocab_size=151936, hidden_size=4096, intermediate_size=12288,
            num_layers=36, num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=1e6, qk_norm=True, **kw
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
                 device="cuda", *, mlp: bool = True) -> Dict[str, Any]:
    """Random layer-stacked weights. ``generator`` is a torch.Generator on
    ``device`` or an int seed. Each layer's matrix is drawn in float32, cast
    to the model dtype and (with ``quant="w4a16"``) quantized on its own, so
    the float32 temporaries stay one matrix large. ``mlp=False`` draws no
    dense MLP (a model whose MLP is routed experts, models/mixtral.py)."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    h, d = cfg.hidden_size, cfg.head_dim
    nq, nkv, n_layers = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers

    def draw(n, k, scale):
        return (torch.randn((n, k), generator=generator, device=dev) * scale).to(cfg.dtype)

    def linear(n, k):
        mats = (draw(n, k, 1.0 / k ** 0.5) for _ in range(n_layers))
        if cfg.quant is not None:
            return _quantize_stack(mats, n_layers, cfg)
        out = torch.empty((n_layers, n, k), dtype=cfg.dtype, device=dev)
        for i, m in enumerate(mats):
            out[i] = m
        return out

    layers = {
        "input_norm": torch.ones((n_layers, h), dtype=cfg.dtype, device=dev),
        "post_norm": torch.ones((n_layers, h), dtype=cfg.dtype, device=dev),
    }
    if cfg.fused:
        layers["qkv"] = linear((nq + 2 * nkv) * d, h)
    else:
        layers["q"] = linear(nq * d, h)
        layers["k"] = linear(nkv * d, h)
        layers["v"] = linear(nkv * d, h)
    layers["o"] = linear(h, nq * d)
    if mlp and cfg.fused:
        layers["gate_up"] = linear(2 * cfg.intermediate_size, h)
    elif mlp:
        layers["gate"] = linear(cfg.intermediate_size, h)
        layers["up"] = linear(cfg.intermediate_size, h)
    if mlp:
        layers["down"] = linear(h, cfg.intermediate_size)
    if cfg.qk_norm:
        layers["q_norm"] = torch.ones((n_layers, d), dtype=cfg.dtype, device=dev)
        layers["k_norm"] = torch.ones((n_layers, d), dtype=cfg.dtype, device=dev)
    if cfg.qkv_bias:
        for name, heads in (("q_bias", nq), ("k_bias", nkv), ("v_bias", nkv)):
            layers[name] = torch.zeros((n_layers, heads * d), dtype=cfg.dtype, device=dev)
    embed = draw(cfg.vocab_size, h, 0.02)
    lm_head = draw(cfg.vocab_size, h, 1.0 / h ** 0.5)
    return {
        "embed": embed,
        "final_norm": torch.ones((h,), dtype=cfg.dtype, device=dev),
        "lm_head": _quantize_matrix(lm_head, cfg) if cfg.quant is not None else lm_head,
        "layers": layers,
    }


def _quantize_stack(mats, n_layers: int, cfg: LlamaConfig):
    """Layer matrices [N, K], quantized one at a time into the stacked
    {"packed": [L, K/2, N], "scales": [L, K/G, N]}."""
    packed = scales = None
    for i, m in enumerate(mats):
        p, s, _ = quantize_w4(m, group_size=cfg.group_size)
        if packed is None:
            packed = p.new_empty((n_layers, *p.shape))
            scales = s.new_empty((n_layers, *s.shape))
        packed[i], scales[i] = p, s
    return {"packed": packed, "scales": scales}


def _quantize_matrix(wm, cfg: LlamaConfig):
    """One [N, K] matrix (the lm_head) with N padded to a multiple of 2048
    (llama.py:150-158); the extra logits are sliced off after the GEMM."""
    n = wm.shape[0]
    wm = torch.nn.functional.pad(wm, (0, 0, 0, round_up(n, 2048) - n))
    packed, scales, _ = quantize_w4(wm, group_size=cfg.group_size)
    return {"packed": packed, "scales": scales}


def _quantize_layers(layers, cfg: LlamaConfig):
    """A float stacked layer tree with separate q/k/v/gate/up (the JAX
    init's) -> the W4A16 tree; with ``cfg.fused`` q/k/v and gate/up are
    concatenated first (llama.py:161-178)."""
    out = dict(layers)

    def qz(wm):
        return _quantize_stack(iter(wm), wm.shape[0], cfg)

    names = ("o", "down")
    if cfg.fused:
        out["qkv"] = qz(torch.cat([out.pop("q"), out.pop("k"), out.pop("v")], dim=1))
        out["gate_up"] = qz(torch.cat([out.pop("gate"), out.pop("up")], dim=1))
    else:
        names = ("q", "k", "v", "o", "gate", "up", "down")
    for name in names:
        out[name] = qz(layers[name])
    return out


def _w4_kernel_for(cfg: LlamaConfig, m: int):
    """The W4A16 GEMM for M rows: K10 for the decode bucket (M <= 32) with
    ``gemm_impl="dma"``, else K1 (llama.py:181-186)."""
    if cfg.gemm_impl == "dma" and m <= 32:
        return w4a16_gemm_dma
    return w4a16_gemm


def _linear(x, w, cfg: LlamaConfig, residual=None, layer_id=None, norm=None, bias=None):
    """x @ w.T (w is [N, K], or the layer-stacked [L, N, K] with
    ``layer_id``), rounded to the model dtype; ``norm`` is an rmsnorm weight
    applied to x first; ``residual`` and ``bias`` are added after. A
    quantized ``w`` ({"packed", "scales"}) runs the W4A16 GEMM, with the
    norm in K1's prologue and the residual added before its one rounding;
    every other path (K10, which has no norm prologue, and the bf16 matmul)
    applies the standalone rmsnorm first (llama.py:201-205)."""
    kern = _w4_kernel_for(cfg, x.shape[0]) if isinstance(w, dict) else None
    if norm is not None and kern is not w4a16_gemm:
        x = rmsnorm(x, norm[layer_id] if layer_id is not None else norm, cfg.rms_eps)
        norm = None
    if isinstance(w, dict):
        kw = {} if norm is None else {"norm_weight": norm, "norm_eps": cfg.rms_eps}
        out = kern(x, w["packed"], w["scales"], residual=residual, layer_id=layer_id,
                   group_size=cfg.group_size, out_dtype=cfg.dtype, **kw)
    else:
        wl = w[layer_id] if layer_id is not None else w
        out = torch.matmul(x, wl.t()).to(cfg.dtype)
        if residual is not None:
            out = out + residual
    if bias is not None:
        out = out + (bias[layer_id] if layer_id is not None and bias.ndim == 2 else bias).to(out.dtype)
    return out


def make_caches(cfg: LlamaConfig, num_pages: int, page_size: int, kv_dtype=None, device="cuda"):
    """Layer-stacked page-major K and V pools [L, P, Hkv, page, D], of
    ``kv_dtype``, else the config's ``kv_dtype``, else the model dtype."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, page_size, cfg.head_dim)
    dt = kv_dtype or cfg.kv_dtype or cfg.dtype
    if dt == torch.int8 and cfg.kv_scale is None:
        # without a scale the store's cast would truncate K/V to {-1, 0, 1}
        raise ValueError("int8 KV pools require cfg.kv_scale")
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
    if cfg.qkv_bias:
        def bias(name, heads):
            b = weights[name]
            return (b[layer_id] if layer_id is not None else b).reshape(1, heads, d)
        q, k, v = q + bias("q_bias", nq), k + bias("k_bias", nkv), v + bias("v_bias", nkv)
    if cfg.qk_norm:  # per-head RMSNorm (K2 over [T, H, D] rows)
        pick = lambda w: w[layer_id] if layer_id is not None else w
        q = rmsnorm(q, pick(weights["q_norm"]), cfg.rms_eps)
        k = rmsnorm(k, pick(weights["k_norm"]), cfg.rms_eps)
    return q, k, v


def _mlp(h2, weights, cfg, residual=None, layer_id=None, norm=None):
    """SwiGLU MLP; with ``norm`` h2 is the raw residual stream and the
    post-norm is applied first (in the gate_up GEMM's prologue when it is
    quantized and fused)."""
    w = weights["down"]
    if cfg.fused:
        gu = _linear(h2, weights["gate_up"], cfg, layer_id=layer_id, norm=norm)
        # the fused gate_up output feeds K1's silu prologue directly when
        # K1 is the down GEMM for these rows and the down proj's packed K is
        # the true intermediate size (a zero-padded K cannot pad the
        # interleaved [M, 2I] array); K10 takes the gate and up slices
        # (llama.py:274-299)
        if (isinstance(w, dict) and _w4_kernel_for(cfg, gu.shape[0]) is w4a16_gemm
                and gu.shape[-1] // 2 == w["packed"].shape[-2] * 2):
            return w4a16_gemm(gu, w["packed"], w["scales"], residual=residual, layer_id=layer_id,
                              prologue="silu_mul", fused_gate_up=True, group_size=cfg.group_size,
                              out_dtype=cfg.dtype)
        inter = gu.shape[-1] // 2
        gate, up = gu[:, :inter], gu[:, inter:]
    else:
        if norm is not None:
            h2 = rmsnorm(h2, norm[layer_id] if layer_id is not None else norm, cfg.rms_eps)
        gate = _linear(h2, weights["gate"], cfg, layer_id=layer_id)
        up = _linear(h2, weights["up"], cfg, layer_id=layer_id)
    if isinstance(w, dict):
        # silu-mul prologue and residual epilogue in the down GEMM
        return _w4_kernel_for(cfg, gate.shape[0])(
            gate, w["packed"], w["scales"], a2=up, residual=residual, layer_id=layer_id,
            prologue="silu_mul", group_size=cfg.group_size, out_dtype=cfg.dtype)
    g = gate.float()
    act = (g * torch.sigmoid(g) * up.float()).to(cfg.dtype)
    wl = w[layer_id] if layer_id is not None else w
    out = torch.matmul(act, wl.t()).to(cfg.dtype)
    return out + residual if residual is not None else out


def _kv_quant(cfg: LlamaConfig, x):
    """Fresh K/V -> the pool's representation before a store: int8 rounds
    x / kv_scale half to even and clips to +-127; fp8 divides and casts.
    Without a scale, the store's own cast applies (llama.py:312-322)."""
    if cfg.kv_scale is None:
        return x
    y = x.float() * (1.0 / cfg.kv_scale)
    if cfg.kv_dtype == torch.int8:
        return torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return y.to(cfg.kv_dtype or cfg.dtype)


def _kv_att_kwargs(cfg: LlamaConfig):
    """k_scale / v_scale for decode attention: it folds k_scale into q and
    v_scale into the output, nothing per KV element."""
    if cfg.kv_scale is None:
        return {}
    return {"k_scale": cfg.kv_scale, "v_scale": cfg.kv_scale}


def _kv_deq(cfg: LlamaConfig, x, dtype):
    """A gathered KV prefix back in the compute dtype (llama.py:334-337)."""
    x = x.to(dtype)
    return x if cfg.kv_scale is None else x * torch.tensor(cfg.kv_scale, dtype=dtype)


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
    b = x.shape[0]
    n_stack = lw["input_norm"].shape[0]
    k_all, v_all = [], []
    for lidx in range(n_stack):
        if cfg.fused and not cfg.qkv_bias and not cfg.qk_norm:
            # input_norm in the qkv GEMM's prologue, then split + rope (K3)
            qkv = _linear(x, lw["qkv"], cfg, layer_id=lidx, norm=lw["input_norm"])
            q, k, v = rope_decode_fused_qkv(positions, qkv, rope_cache, num_q=cfg.num_heads,
                                            num_kv=cfg.num_kv_heads, head_dim=cfg.head_dim)
        else:
            h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
            q, k, v = _qkv(h, lw, cfg, b, layer_id=lidx)
            q, k = rope_decode_fused(positions, q, k, rope_cache)
        attn = paged_attention_decode_dma(q, k_cache, v_cache, lengths, page_tables,
                                          layer_id=lidx, fresh_k=k, fresh_v=v, **_kv_att_kwargs(cfg))
        x = _linear(attn.reshape(b, -1), lw["o"], cfg, residual=x, layer_id=lidx)
        x = _mlp(x, lw, cfg, residual=x, layer_id=lidx, norm=lw["post_norm"])
        k_all.append(k)
        v_all.append(v)
    store_cache_all_layers(_kv_quant(cfg, torch.stack(k_all)), _kv_quant(cfg, torch.stack(v_all)),
                           k_cache, v_cache, slot_loc)
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
        store_cache_stacked(_kv_quant(cfg, k), _kv_quant(cfg, v), k_cache, v_cache, slot_loc.reshape(-1), lidx)
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


def prefill_packed(params, cfg: LlamaConfig, k_cache, v_cache, tokens, positions, blk_seq, blk_q0, seq_meta,
                   last_idx, slot_loc, rope_cache, *, max_kvb: int):
    """Token-packed multi-prompt prefill: prompts block-aligned packed into
    one launch (ops/attention/flash_packed.py). tokens/positions/slot_loc
    [TP] packed; blk_seq/blk_q0 [NQB]; seq_meta [B, 6] (make_seq_meta);
    last_idx [B] packed index of each prompt's final token. Returns (logits
    [B, V] float32, k_cache, v_cache); the pools are updated in place."""
    tp = tokens.shape[0]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    lw = params["layers"]
    for lidx in range(cfg.num_layers):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q, k, v = _qkv(h, lw, cfg, tp, layer_id=lidx)
        q, k = rotary_embedding(positions, q, k, cfg.head_dim, rope_cache)
        store_cache_stacked(_kv_quant(cfg, k), _kv_quant(cfg, v), k_cache, v_cache, slot_loc, lidx)
        attn = flash_attention_packed(q, k, v, blk_seq, blk_q0, seq_meta, max_kvb=max_kvb,
                                      causal=True).reshape(tp, -1)
        x = _linear(attn, lw["o"], cfg, residual=x, layer_id=lidx)
        h2 = rmsnorm(x, lw["post_norm"][lidx], cfg.rms_eps)
        x = _mlp(h2, lw, cfg, residual=x, layer_id=lidx)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    logits = _linear(x[last_idx.long().to(x.device)], params["lm_head"], cfg).float()[:, : cfg.vocab_size]
    return logits, k_cache, v_cache


def _prefix_slots(page_tables, prefix_max: int, page_size: int):
    """Flat slots of the first ``prefix_max`` cached positions of each
    sequence: page_tables [B, P] -> [B, prefix_max]."""
    pos = torch.arange(prefix_max, device=page_tables.device)
    return page_tables.long()[:, pos // page_size] * page_size + (pos % page_size)[None, :]


def _gather_prefix(pool, lidx: int, pre_slots, page_size: int):
    """Layer ``lidx`` of a page-major pool [L, P, H, page, D] at flat slots
    [B, n] -> [B, n, H, D] (a plain index gather, as XLA's in JAX)."""
    return pool[lidx][pre_slots // page_size, :, pre_slots % page_size]


def _extend_attention(cfg: LlamaConfig, q, k, v, q_lens, prefix_lens, kpre, vpre):
    """Attention of a suffix over its fresh rows and a cached prefix:
    merge_state(flash(q, fresh kv, causal at global offsets), flash(q,
    prefix kv, masked by the prefix length)). q [B, S, Hq, D]; k/v [B, S,
    Hkv, D]; kpre/vpre [B, prefix_max, Hkv, D] in the compute dtype. Returns
    [B*S, Hq*D] in the model dtype."""
    b, s = q.shape[:2]
    o1, l1 = flash_attention(q, k, v, q_lens, q_lens, q_start=prefix_lens, kv_start=prefix_lens,
                             causal=True, return_lse=True)
    o2, l2 = flash_attention(q, kpre, vpre, q_lens, prefix_lens, q_start=prefix_lens,
                             kv_start=torch.zeros_like(prefix_lens), causal=True, return_lse=True)
    hq, d = cfg.num_heads, cfg.head_dim
    om, _ = merge_state(o1.reshape(b * s, hq, d), l1.transpose(1, 2).reshape(b * s, hq),
                        o2.reshape(b * s, hq, d), l2.transpose(1, 2).reshape(b * s, hq))
    return om.reshape(b * s, -1).to(cfg.dtype)


def prefill_extend(params, cfg: LlamaConfig, k_cache, v_cache, tokens, positions, q_lens, kv_lens, page_tables,
                   slot_loc, rope_cache, *, prefix_max: int, num_logits: int = 1):
    """Extend (chunked) prefill: the q tokens are the suffix of sequences
    whose prefix KV already lives in the paged cache (a radix-cache hit or
    an earlier chunk). tokens/positions/slot_loc [B, S] (padded); q_lens [B]
    suffix lengths; kv_lens [B] total lengths; page_tables [B, P];
    ``prefix_max`` a page multiple >= every prefix length. Each layer stores
    the suffix's K/V first, then gathers ``prefix_max`` cached positions (the
    mask by prefix length hides the fresh rows among them). Returns (logits
    [B, V] float32 of each suffix's last token, k_cache, v_cache); the pools
    are updated in place. With ``num_logits`` n > 1 (the speculative verify)
    the logits are [B, n, V], of each sequence's last n positions
    (``logit_rows``)."""
    b, s = tokens.shape
    dev = k_cache.device
    x = params["embed"][tokens.reshape(-1).long()].to(cfg.dtype)
    lw = params["layers"]
    q_lens = q_lens.to(dev, torch.int32)
    prefix_lens = kv_lens.to(dev, torch.int32) - q_lens
    page_sz = k_cache.shape[-2]
    pre_slots = _prefix_slots(page_tables.to(dev), prefix_max, page_sz)
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for lidx in range(cfg.num_layers):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q, k, v = _qkv(h, lw, cfg, b * s, layer_id=lidx)
        q, k = rotary_embedding(positions.reshape(-1), q, k, cfg.head_dim, rope_cache)
        store_cache_stacked(_kv_quant(cfg, k), _kv_quant(cfg, v), k_cache, v_cache, slot_loc.reshape(-1), lidx)
        qb = q.reshape(b, s, nq, d)
        kpre = _kv_deq(cfg, _gather_prefix(k_cache, lidx, pre_slots, page_sz), qb.dtype)
        vpre = _kv_deq(cfg, _gather_prefix(v_cache, lidx, pre_slots, page_sz), qb.dtype)
        attn = _extend_attention(cfg, qb, k.reshape(b, s, nkv, d), v.reshape(b, s, nkv, d), q_lens,
                                 prefix_lens, kpre, vpre)
        x = x + _linear(attn, lw["o"], cfg, layer_id=lidx)
        h2 = rmsnorm(x, lw["post_norm"][lidx], cfg.rms_eps)
        x = x + _mlp(h2, lw, cfg, layer_id=lidx)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps).reshape(b, s, -1)
    logits = _linear(logit_rows(x, q_lens, num_logits), params["lm_head"], cfg).float()[:, : cfg.vocab_size]
    return _logits_shape(logits, b, num_logits), k_cache, v_cache


def logit_rows(x, q_lens, num_logits: int = 1):
    """The hidden rows an extend takes logits of: x [B, S, H] -> [B * n, H],
    each sequence's last ``num_logits`` positions (q_len - n .. q_len - 1,
    clipped to [0, S), as JAX clips them: a suffix shorter than n repeats
    its row 0 in the leading rows, which the caller masks)."""
    b, s = x.shape[:2]
    ar = torch.arange(num_logits, device=x.device)
    idx = (q_lens.long().to(x.device)[:, None] - num_logits + ar[None, :]).clamp(0, s - 1)
    return x[torch.arange(b, device=x.device)[:, None], idx].reshape(b * num_logits, -1)


def _logits_shape(logits, b: int, num_logits: int):
    """[B, V] for one logit a sequence, else [B, n, V]."""
    return logits if num_logits == 1 else logits.reshape(b, num_logits, -1)


def prefill_tree(params, cfg: LlamaConfig, k_cache, v_cache, tokens, positions, tree_mask, prefix_lens,
                 page_tables, slot_loc, rope_cache, *, prefix_max: int):
    """Tree-masked verify forward (the speculative tree round): the dt fresh
    tokens of each sequence form a draft tree, node i attending its
    ancestors-or-self (``tree_mask`` [B, dt, dt], build_tree_kernel_efficient)
    and the whole cached prefix. tokens / positions / slot_loc [B, dt]
    (slot_loc per NODE: siblings share a position but need their own rows);
    prefix_lens [B]. Per layer: a dense float32 tree-masked pass over the
    fresh nodes with its base-2 lse (plain torch, as ``jnp`` in JAX), the
    prefix pass on K7 with ``causal=False`` over the gathered ``prefix_max``
    positions, and merge_state (llama.py:721-800). Returns (logits [B, dt, V]
    float32 for every node, k_cache, v_cache); the pools are updated in
    place."""
    b, dt = tokens.shape
    dev = k_cache.device
    x = params["embed"][tokens.reshape(-1).long()].to(cfg.dtype)
    lw = params["layers"]
    prefix_lens = prefix_lens.to(dev, torch.int32)
    tree_mask = tree_mask.to(dev)
    page_sz = k_cache.shape[-2]
    pre_slots = _prefix_slots(page_tables.to(dev), prefix_max, page_sz)
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale_log2 = (1.0 / d ** 0.5) * 1.4426950408889634
    q_lens = torch.full((b,), dt, dtype=torch.int32, device=dev)
    for lidx in range(cfg.num_layers):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q, k, v = _qkv(h, lw, cfg, b * dt, layer_id=lidx)
        q, k = rotary_embedding(positions.reshape(-1), q, k, d, rope_cache)
        store_cache_stacked(_kv_quant(cfg, k), _kv_quant(cfg, v), k_cache, v_cache, slot_loc.reshape(-1), lidx)
        qb = q.reshape(b, dt, nq, d)
        # pass 1: dense tree-masked attention over the fresh nodes
        kr = k.reshape(b, dt, nkv, d).repeat_interleave(nq // nkv, dim=2).float()
        vr = v.reshape(b, dt, nkv, d).repeat_interleave(nq // nkv, dim=2).float()
        s2 = torch.einsum("bihd,bjhd->bhij", qb.float(), kr) * scale_log2
        s2 = s2.masked_fill(~tree_mask[:, None], float("-inf"))
        m = s2.amax(-1)  # [B, H, dt]: a node always sees itself
        p = torch.exp2(s2 - m[..., None])
        l1 = p.sum(-1)
        o1 = torch.einsum("bhij,bjhd->bihd", p, vr) / l1.transpose(1, 2)[..., None]
        lse1 = (m + torch.log2(l1)).transpose(1, 2)  # [B, dt, H]
        # pass 2: the cached prefix, visible to every node
        kpre = _kv_deq(cfg, _gather_prefix(k_cache, lidx, pre_slots, page_sz), qb.dtype)
        vpre = _kv_deq(cfg, _gather_prefix(v_cache, lidx, pre_slots, page_sz), qb.dtype)
        o2, l2 = flash_attention(qb, kpre, vpre, q_lens, prefix_lens, causal=False, return_lse=True)
        om, _ = merge_state(o1.reshape(b * dt, nq, d), lse1.reshape(b * dt, nq),
                            o2.reshape(b * dt, nq, d).float(), l2.transpose(1, 2).reshape(b * dt, nq))
        x = x + _linear(om.reshape(b * dt, -1).to(cfg.dtype), lw["o"], cfg, layer_id=lidx)
        h2 = rmsnorm(x, lw["post_norm"][lidx], cfg.rms_eps)
        x = x + _mlp(h2, lw, cfg, layer_id=lidx)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    logits = _linear(x, params["lm_head"], cfg).float()[:, : cfg.vocab_size]
    return logits.reshape(b, dt, -1), k_cache, v_cache


def mixed_step(params, cfg: LlamaConfig, k_cache, v_cache, dec_tokens, dec_positions, dec_tables, dec_lengths,
               dec_slots, pf_tokens, pf_positions, pf_q_len, pf_kv_len, pf_table, pf_slots, rope_cache, *,
               prefix_max: int):
    """One step serving a decode batch and one prefill chunk: the Bd decode
    rows and the S chunk tokens run as one token stream through every GEMM
    (the weights are read once for both), and split for attention: K5 with
    the fresh rows for the decode rows, the two-pass extend for the chunk,
    whose own K/V it attends in-tensor. All layers' K/V of the Bd + S tokens
    are stored once after the loop (K6; slot -1 rows are dropped), so the
    chunk's prefix gather reads pools that do not hold the chunk yet.

    dec_*: [Bd] / dec_tables [Bd, P], a padded decode batch. pf_*: one
    chunked-prefill request: tokens/positions/slots [S] (padded), q_len and
    kv_len scalars (ints or one-element tensors), table [P2]. Returns
    (dec_logits [Bd, V], pf_logits [V], k_cache, v_cache); the pools are
    updated in place."""
    dev = k_cache.device
    bd, s = dec_tokens.shape[0], pf_tokens.shape[0]
    t = bd + s
    tokens = torch.cat([dec_tokens, pf_tokens]).to(dev)
    positions = torch.cat([dec_positions, pf_positions]).to(dev)
    slots = torch.cat([dec_slots, pf_slots]).to(dev)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    lw = params["layers"]
    pf_q = torch.as_tensor(pf_q_len, dtype=torch.int32, device=dev).reshape(1)
    prefix_len = torch.as_tensor(pf_kv_len, dtype=torch.int32, device=dev).reshape(1) - pf_q
    page_sz = k_cache.shape[-2]
    pre_slots = _prefix_slots(pf_table.to(dev)[None], prefix_max, page_sz)
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k_all, v_all = [], []
    for lidx in range(cfg.num_layers):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q, k, v = _qkv(h, lw, cfg, t, layer_id=lidx)
        q, k = rotary_embedding(positions, q, k, cfg.head_dim, rope_cache)
        attn_d = paged_attention_decode_dma(q[:bd], k_cache, v_cache, dec_lengths, dec_tables, layer_id=lidx,
                                            fresh_k=k[:bd], fresh_v=v[:bd], **_kv_att_kwargs(cfg))
        qb = q[bd:].reshape(1, s, nq, d)
        kpre = _kv_deq(cfg, _gather_prefix(k_cache, lidx, pre_slots, page_sz), qb.dtype)
        vpre = _kv_deq(cfg, _gather_prefix(v_cache, lidx, pre_slots, page_sz), qb.dtype)
        om = _extend_attention(cfg, qb, k[bd:].reshape(1, s, nkv, d), v[bd:].reshape(1, s, nkv, d), pf_q,
                               prefix_len, kpre, vpre)
        attn = torch.cat([attn_d.reshape(bd, -1), om])
        x = _linear(attn, lw["o"], cfg, residual=x, layer_id=lidx)
        h2 = rmsnorm(x, lw["post_norm"][lidx], cfg.rms_eps)
        x = _mlp(h2, lw, cfg, residual=x, layer_id=lidx)
        k_all.append(k)
        v_all.append(v)
    store_cache_all_layers(_kv_quant(cfg, torch.stack(k_all)), _kv_quant(cfg, torch.stack(v_all)),
                           k_cache, v_cache, slots)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    # lm_head only on the rows that need logits: the decode batch and the
    # chunk's last fresh token
    last_pf = bd + (pf_q.long() - 1).clamp(0, s - 1)
    sel = torch.cat([torch.arange(bd, device=dev), last_pf])
    logits = _linear(x[sel], params["lm_head"], cfg).float()[:, : cfg.vocab_size]
    return logits[:bd], logits[bd], k_cache, v_cache
