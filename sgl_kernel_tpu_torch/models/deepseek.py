"""DeepSeek-V3-style model (MLA attention + biased-top-k MoE) on the port's
operators.

The port of sgl_kernel_tpu/models/deepseek.py with the weight-absorption
formulation of MLA:

  q_nope' = q_nope @ W_UK   (per head, into the 512-wide latent)
  scores  = q_nope' . kv_c + q_pe . k_pe        (one 576-wide row a token)
  out_h   = attn_latent @ W_UV                  (per head)

The KV cache holds only the 576-wide latent row of each token, in one pool
[L, P, page, 576]; with ``kv_scale`` it is int8 or fp8, the scale folded into
the logit scale and one output multiply. Layers below ``num_dense_layers``
run a dense SwiGLU MLP, the others biased top-k routing into
``fused_experts`` plus one shared expert. Parameters are a nested dict of
layer-stacked tensors keyed by the JAX pytree's paths, so a JAX tree
converts by a copy (``interop.params_from_numpy``); with ``quant="w4a16"``
every linear and both expert banks are K-paired int4, while ``w_uk`` /
``w_uv`` stay in the model dtype and absorb in a float32 ``einsum`` outside
any kernel.

Entry points, each updating the pool IN PLACE where JAX donates it:
``decode_step``, ``prefill`` (a padded batch), ``prefill_packed`` (several
prompts block-aligned into one launch) and ``prefill_extend`` (a suffix over
latents already cached: two flash passes merged by lse). ``jax.lax.scan``
over layers is a Python loop; ``lax.cond`` on the dense layers an ``if``.

NSA sparse decode (``nsa=True``): each layer also holds an indexer
(``wq_idx``, ``wk_idx``, ``idx_norm``, ``w_idx_gate``, in the model dtype
under W4A16 as in JAX) and two flat pools, fp8 keys [L*P*page, idx_dim] and
their float32 scales (``make_indexer_cache``). ``decode_step_nsa`` stores
the fresh latent row and indexer key, scores every cached token with K15,
keeps the best ``index_topk`` and attends only to those latent rows
(``sparse_mla_decode`` on K13a). The prefill programs stay dense and store
each token's indexer key too: ``prefill_nsa``, ``prefill_extend_nsa`` and
``prefill_packed(with_indexer=True)`` are the dense programs with an
``indexer`` argument.

Kernels on the path: K1 (every W4A16 linear; with ``quant=None`` the
linears are plain ``torch.matmul``), K2 (the norms), K14 (decode qkv prep,
up to 64 tokens), K13a (decode attention, dense or over the selected rows),
K15 (the NSA indexer), the routed experts' grouped GEMM (K11 on int4 banks,
K12 on the bf16 banks of ``quant=None``), K7 (prefill and the extend passes
at head dim 576) and K9 (packed prefill at 576). Not ported, and raising:
several logits per sequence (speculative verify).

KV compression (``compress="c4"`` or ``"c128"``, ops/compression.py): each
layer also projects a 576-wide score row a token (``comp_score``, W4A16
under ``quant``) and holds a positional embedding over the pooled window
(``comp_ape``, float32). ``make_compress_caches`` gives the latent pool, a
score pool of its shape and a ring pool [L, slots, compress_ring, 576] whose
slot a request holds for its life (the engine's state slots). The prefill
programs ``prefill_c`` and ``prefill_packed_c`` attend exactly (K7 / K9 at
576), store the latent and score rows and build each request's ring from
the stored windows; ``decode_step_c`` stores the fresh rows, pools the
window of every row whose length reaches a ratio multiple into its ring
slot, and attends over the last ``compress_local`` tokens and the live ring
tokens in plain float32, merged by lse. The pooling and this attention are
plain PyTorch, as the JAX model has them in plain ``jnp``. The decode pools
on every step (writes of rows with no event dropped on the device), where
JAX skips the pooling by ``lax.cond`` on steps with no event: a captured
graph cannot branch on device data.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from ..ops.attention import merge_state
from ..ops.attention.merge_state import LOG2E
from ..ops.attention.flash_packed import flash_attention_packed_mla
from ..ops.attention.mla import D_CKV, D_LATENT, D_ROPE, mla_decode, mla_prefill
from ..ops.attention.nsa import (
    fast_topk_transform_fused,
    fp8_paged_mqa_logits,
    fused_k_indexer_norm_rope_quant_store,
    fused_q_indexer_rope_hadamard_quant,
    sparse_mla_decode,
)
from ..ops.compression import _flat_rows, compress_window, plan_compress_decode, plan_compress_prefill
from ..ops.gemm.w4a16 import quantize_w4, w4a16_gemm
from ..ops.kvcache import _put_rows, store_cache_mla
from ..ops.moe import MoeWeights, biased_topk, fused_experts, pick_block_size
from ..ops.norm import rmsnorm
from ..ops.rope import compute_cos_sin_cache, mla_qkv_prep, rotary_embedding
from ..utils import resolve_device, round_up
from . import llama

# Products accumulate in float32 as the JAX model's
# preferred_element_type=float32 does: no TF32 for float32 weights and no
# reduced-precision split-K reductions for bf16 ones.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


@dataclasses.dataclass(frozen=True)
class DeepseekConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    num_layers: int = 4
    num_heads: int = 16
    qk_nope_dim: int = 128  # per-head nope dim (projected into the latent by W_UK)
    v_head_dim: int = 128
    # q low-rank path (wq_a -> q_a_norm -> wq_b); None: the direct wq
    q_lora_rank: Optional[int] = None
    num_experts: int = 16
    num_experts_per_tok: int = 4
    moe_intermediate: int = 512
    dense_intermediate: int = 4096
    num_dense_layers: int = 1
    routed_scaling_factor: float = 2.5
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    max_position: int = 4096
    dtype: torch.dtype = torch.bfloat16
    # NSA sparse decode: an fp8 indexer scores the cached tokens and decode
    # attends to the best index_topk (idx_dim a power of two)
    nsa: bool = False
    index_topk: int = 2048
    idx_heads: int = 4
    idx_dim: int = 128
    # None | "w4a16": every linear and both expert banks K-paired int4
    quant: Optional[str] = None
    group_size: int = 128
    # symmetric per-tensor latent scale: stores write round(kv / kv_scale)
    # (int8) or (kv / kv_scale) cast (fp8); required for int8 pools
    kv_scale: Any = None
    # latent pool dtype: None (the model dtype), torch.int8,
    # torch.float8_e4m3fn or torch.float8_e5m2
    kv_dtype: Any = None
    # DSv4 KV compression: None | "c4" (ratio 4, overlapping windows of 8) |
    # "c128" (plain windows of 128); decode attends over the last
    # compress_local tokens (None: max(64, ratio)) and the compress_ring
    # latest pooled tokens
    compress: Optional[str] = None
    compress_ring: int = 64
    compress_local: Optional[int] = None

    def __post_init__(self):
        if self.quant not in (None, "w4a16"):
            raise NotImplementedError(f"quant={self.quant!r}: only 'w4a16' is ported")
        if self.compress not in (None, "c4", "c128"):
            raise ValueError(f"compress={self.compress!r}: 'c4' or 'c128'")
        if self.kv_dtype not in (None, torch.bfloat16, torch.float32, torch.int8, torch.float8_e4m3fn,
                                 torch.float8_e5m2):
            raise ValueError(f"unsupported kv_dtype {self.kv_dtype}")

    @staticmethod
    def tiny(**kw):
        kw.setdefault("dtype", torch.float32)
        return DeepseekConfig(
            vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            qk_nope_dim=32, v_head_dim=32, num_experts=4, num_experts_per_tok=2,
            moe_intermediate=64, dense_intermediate=128, num_dense_layers=1,
            max_position=128, **kw,
        )


def init_weights(cfg: DeepseekConfig, generator: Union[torch.Generator, int] = 0, device="cuda") -> Dict[str, Any]:
    """Random layer-stacked weights in the JAX recipe's shapes and scales
    (each matrix N(0, 1/fan_in) but the router's, the embedding's and the
    compression's score projection and window embedding 0.02; norms one;
    router bias zero). ``generator`` is a torch.Generator on
    ``device`` or an int seed. A quantized linear is drawn, cast and
    quantized one layer at a time and an expert bank one layer's bank at a
    time, so the float32 temporaries stay one layer large (the whole float32
    bank of a V2-Lite ``moe_w1`` would be 37.8 GB)."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    h, nh, dn, dv = cfg.hidden_size, cfg.num_heads, cfg.qk_nope_dim, cfg.v_head_dim
    n_layers, e, inter = cfg.num_layers, cfg.num_experts, cfg.moe_intermediate
    quant = cfg.quant is not None

    def draw(shape, scale=None):
        scale = scale if scale is not None else 1.0 / shape[-1] ** 0.5
        return (torch.randn(shape, generator=generator, device=dev) * scale).to(cfg.dtype)

    def stack(per_layer):
        out = None
        for i in range(n_layers):
            m = per_layer()
            if out is None:
                out = m.new_empty((n_layers, *m.shape))
            out[i] = m
        return out

    def linear(n, k, scale=None):
        """[L, N, K], or its W4A16 tree when the config quantizes."""
        if not quant:
            return stack(lambda: draw((n, k), scale))
        packed = scales = None
        for i in range(n_layers):
            p, s, _ = quantize_w4(draw((n, k), scale), group_size=cfg.group_size)
            if packed is None:
                packed, scales = p.new_empty((n_layers, *p.shape)), s.new_empty((n_layers, *s.shape))
            packed[i], scales[i] = p, s
        return {"packed": packed, "scales": scales}

    def bank(k, n):
        """Expert banks [L, E, K, N] (x @ W), or stacked packed
        [L, E, K/2, N] and scales [L, E, K/G, N]: one layer's E matrices
        quantized together along N (quantize_w4 treats columns alone)."""
        if not quant:
            return stack(lambda: draw((e, k, n)))
        packed = scales = None
        for i in range(n_layers):
            w_t = draw((e, k, n)).transpose(1, 2).reshape(e * n, k)  # [E*N, K]: each expert's W.T
            p, s, _ = quantize_w4(w_t, group_size=cfg.group_size)
            del w_t
            p = p.reshape(p.shape[0], e, n).permute(1, 0, 2)
            s = s.reshape(s.shape[0], e, n).permute(1, 0, 2)
            if packed is None:
                packed, scales = p.new_empty((n_layers, *p.shape)), s.new_empty((n_layers, *s.shape))
            packed[i], scales[i] = p, s
        return {"packed": packed, "scales": scales}

    layers = {
        "input_norm": torch.ones((n_layers, h), dtype=cfg.dtype, device=dev),
        "post_norm": torch.ones((n_layers, h), dtype=cfg.dtype, device=dev),
        "kv_norm": torch.ones((n_layers, D_LATENT), dtype=cfg.dtype, device=dev),
        "wkv_a": linear(D_LATENT + D_ROPE, h),
        "w_uk": stack(lambda: draw((nh, dn, D_LATENT))),
        "w_uv": stack(lambda: draw((nh, D_LATENT, dv))),
        "wo": linear(h, nh * dv),
        "gate": linear(cfg.dense_intermediate, h),
        "up": linear(cfg.dense_intermediate, h),
        "down": linear(h, cfg.dense_intermediate),
        "router": stack(lambda: draw((e, h), 0.02)),
        "router_bias": torch.zeros((n_layers, e), dtype=torch.float32, device=dev),
        "moe_w1": bank(h, 2 * inter),
        "moe_w2": bank(inter, h),
        "shared_gate": linear(inter, h),
        "shared_up": linear(inter, h),
        "shared_down": linear(h, inter),
    }
    if cfg.q_lora_rank:
        r = cfg.q_lora_rank
        layers["wq_a"] = linear(r, h)
        layers["q_a_norm"] = torch.ones((n_layers, r), dtype=cfg.dtype, device=dev)
        layers["wq_b"] = linear(nh * (dn + D_ROPE), r)
    else:
        layers["wq"] = linear(nh * (dn + D_ROPE), h)
    if cfg.nsa:
        # never quantized (JAX leaves them out of W4A16); with q-LoRA the
        # indexer q projects from the q latent c_q, else from the hidden state
        layers["wq_idx"] = stack(lambda: draw((cfg.idx_heads * cfg.idx_dim, cfg.q_lora_rank or h)))
        layers["wk_idx"] = stack(lambda: draw((cfg.idx_dim, h)))
        layers["idx_norm"] = torch.ones((n_layers, cfg.idx_dim), dtype=cfg.dtype, device=dev)
        layers["w_idx_gate"] = stack(lambda: draw((cfg.idx_heads, h), 0.02))
    if cfg.compress:
        # a score row a token as wide as the latent row, and the window's
        # positional embedding (drawn in the model dtype, kept in float32)
        layers["comp_score"] = linear(D_CKV, h, 0.02)
        layers["comp_ape"] = stack(lambda: draw((_comp_window(cfg), D_CKV), 0.02).float())
    lm_head = draw((cfg.vocab_size, h))
    if quant:
        # N padded to a multiple of 2048 (the JAX llama._quantize_matrix)
        n = lm_head.shape[0]
        lm_head = torch.nn.functional.pad(lm_head, (0, 0, 0, round_up(n, 2048) - n))
        packed, scales, _ = quantize_w4(lm_head, group_size=cfg.group_size)
        lm_head = {"packed": packed, "scales": scales}
    return {
        "embed": draw((cfg.vocab_size, h), 0.02),
        "final_norm": torch.ones((h,), dtype=cfg.dtype, device=dev),
        "lm_head": lm_head,
        "layers": layers,
    }


def make_cache(cfg: DeepseekConfig, num_pages: int, page_size: int, kv_dtype=None, device="cuda"):
    """The latent pool [L, P, page, 576] of ``kv_dtype``, else the config's,
    else the model dtype."""
    dt = kv_dtype or cfg.kv_dtype or cfg.dtype
    if dt == torch.int8 and cfg.kv_scale is None:
        # without a scale the store's cast would truncate the latent to {-1, 0, 1}
        raise ValueError("int8 latent pools require cfg.kv_scale")
    return torch.zeros((cfg.num_layers, num_pages, page_size, D_CKV), dtype=dt, device=resolve_device(device))


def build_rope_cache(cfg: DeepseekConfig, device="cuda"):
    return compute_cos_sin_cache(D_ROPE, cfg.max_position, cfg.rope_theta, device=resolve_device(device))


def make_indexer_cache(cfg: DeepseekConfig, num_pages: int, page_size: int, device="cuda"):
    """The NSA indexer pools, flat and layer-stacked: fp8 e4m3 keys
    [L*P*page, idx_dim] and their float32 scales [L*P*page]."""
    dev = resolve_device(device)
    s = cfg.num_layers * num_pages * page_size
    return (torch.zeros((s, cfg.idx_dim), dtype=torch.float8_e4m3fn, device=dev),
            torch.zeros((s,), dtype=torch.float32, device=dev))


def build_idx_rope_cache(cfg: DeepseekConfig, device="cuda"):
    return compute_cos_sin_cache(cfg.idx_dim, cfg.max_position, cfg.rope_theta, device=resolve_device(device))


def _lin(x, w, cfg: DeepseekConfig, lidx=None):
    """x @ w.T in float32, rounded to the model dtype; a W4A16 tree runs K1
    with the layer picked by ``lidx`` (no copy of the stack)."""
    if isinstance(w, dict):
        return w4a16_gemm(x, w["packed"], w["scales"], layer_id=lidx, group_size=cfg.group_size,
                          out_dtype=cfg.dtype)
    wl = w[lidx] if lidx is not None else w
    return torch.matmul(x, wl.t()).to(cfg.dtype)


def _silu_mlp(x, gate_w, up_w, down_w, cfg: DeepseekConfig, lidx=None):
    """down(silu(gate x) * up x): the activation in float32, rounded to the
    model dtype (in K1's silu prologue when the down projection is
    quantized, which rounds at the same point)."""
    g = _lin(x, gate_w, cfg, lidx)
    u = _lin(x, up_w, cfg, lidx)
    if isinstance(down_w, dict):
        return w4a16_gemm(g, down_w["packed"], down_w["scales"], a2=u, layer_id=lidx, prologue="silu_mul",
                          group_size=cfg.group_size, out_dtype=cfg.dtype)
    gf = g.float()
    return _lin((gf * torch.sigmoid(gf) * u.float()).to(cfg.dtype), down_w, cfg, lidx)


def _moe_block(x, weights, lidx: int, cfg: DeepseekConfig):
    logits = torch.matmul(x.float(), weights["router"][lidx].float().t())
    tw, tids = biased_topk(logits, weights["router_bias"][lidx], cfg.num_experts_per_tok, renormalize=True,
                           routed_scaling_factor=cfg.routed_scaling_factor,
                           apply_routed_scaling_factor_on_output=True)
    w1, w2 = weights["moe_w1"], weights["moe_w2"]
    bs = pick_block_size(x.shape[0], tids.shape[1], cfg.num_experts)
    if isinstance(w1, dict):
        mw = MoeWeights(w1=w1["packed"], w2=w2["packed"], w1_scales=w1["scales"], w2_scales=w2["scales"],
                        fmt="int4", group_size=cfg.group_size)
    else:
        mw = MoeWeights(w1=w1, w2=w2, fmt="bf16")
    routed = fused_experts(x, mw, tw, tids, layer_id=lidx, block_size=bs)
    shared = _silu_mlp(x, weights["shared_gate"], weights["shared_up"], weights["shared_down"], cfg, lidx)
    return routed + shared


def _mlp(h2, lw, lidx: int, cfg: DeepseekConfig):
    if lidx < cfg.num_dense_layers:
        return _silu_mlp(h2, lw["gate"], lw["up"], lw["down"], cfg, lidx)
    return _moe_block(h2, lw, lidx, cfg)


def _q_proj(x, weights, lidx: int, cfg: DeepseekConfig):
    """q projection: direct (wq) or low-rank (wq_a -> q_a_norm -> wq_b).
    Returns (q [T, nh*(dn+64)], c_q or None)."""
    if cfg.q_lora_rank:
        c_q = rmsnorm(_lin(x, weights["wq_a"], cfg, lidx), weights["q_a_norm"][lidx], cfg.rms_eps)
        return _lin(c_q, weights["wq_b"], cfg, lidx), c_q
    return _lin(x, weights["wq"], cfg, lidx), None


def _mla_qkv_full(x, weights, lidx: int, cfg: DeepseekConfig, n_tokens: int, positions, rope_cache):
    """Project to (q_nope_latent [T, H, 512], q_pe [T, H, 64], kv_row
    [T, 576], c_q or None): up to 64 tokens through K14, more through
    rotary_embedding and K2."""
    nh, dn = cfg.num_heads, cfg.qk_nope_dim
    q, c_q = _q_proj(x, weights, lidx, cfg)
    q = q.reshape(n_tokens, nh, dn + D_ROPE)
    kv = _lin(x, weights["wkv_a"], cfg, lidx)
    if n_tokens <= 64:
        q_nope, q_pe, kv_row = mla_qkv_prep(positions, lidx, q, kv, weights["kv_norm"], rope_cache,
                                            nope_dim=dn, eps=cfg.rms_eps)
    else:
        q_nope = q[..., :dn]
        q_pe, _ = rotary_embedding(positions, q[..., dn:], None, D_ROPE, rope_cache)
        kv_c = rmsnorm(kv[:, :D_LATENT].contiguous(), weights["kv_norm"][lidx], cfg.rms_eps)
        k_pe, _ = rotary_embedding(positions, kv[:, None, D_LATENT:], None, D_ROPE, rope_cache)
        kv_row = torch.cat([kv_c, k_pe[:, 0]], dim=-1)
    # absorb W_UK: [T, H, dn] x [H, dn, 512] -> [T, H, 512]
    q_lat = torch.einsum("thd,hdl->thl", q_nope.float(), weights["w_uk"][lidx].float()).to(cfg.dtype)
    return q_lat, q_pe, kv_row, c_q


def _mla_qkv(x, weights, lidx, cfg, n_tokens, positions, rope_cache):
    return _mla_qkv_full(x, weights, lidx, cfg, n_tokens, positions, rope_cache)[:3]


def _mla_out(attn_lat, weights, lidx: int, cfg: DeepseekConfig, n_tokens: int):
    """attn_lat [T, H, 512] -> hidden: W_UV absorption in float32, then wo."""
    o = torch.einsum("thl,hlv->thv", attn_lat.float(), weights["w_uv"][lidx].float())
    return _lin(o.reshape(n_tokens, -1).to(cfg.dtype), weights["wo"], cfg, lidx)


def _sm_scale(cfg: DeepseekConfig):
    return 1.0 / (cfg.qk_nope_dim + D_ROPE) ** 0.5


def _lat_quant(cfg: DeepseekConfig, kv_row):
    """A fresh latent row -> the pool's representation: int8 rounds
    kv / kv_scale half to even and clips to +-127, fp8 divides and casts."""
    if cfg.kv_scale is None:
        return kv_row
    y = kv_row.float() * (1.0 / cfg.kv_scale)
    if cfg.kv_dtype == torch.int8:
        return torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return y.to(cfg.kv_dtype)


def _lat_sm(cfg: DeepseekConfig):
    """sm_scale of pool reads: the pool holds kv / s, so logits take a factor s."""
    return _sm_scale(cfg) * (cfg.kv_scale if cfg.kv_scale is not None else 1.0)


def _scale_in(dtype, scale: float) -> float:
    """``scale`` rounded to ``dtype`` on the host, as JAX's
    jnp.asarray(scale, dtype): a Python number multiplies on the device
    without a host-to-device copy (which would wait for the queue)."""
    return float(torch.tensor(scale, dtype=dtype))


def _lat_rescale(cfg: DeepseekConfig, attn):
    """Output fold of pool reads: the attended latents are p @ (kv / s)."""
    if cfg.kv_scale is None:
        return attn
    return attn * _scale_in(attn.dtype, cfg.kv_scale)


def _lat_deq(cfg: DeepseekConfig, rows, dtype):
    """Gathered pool rows back in the compute dtype."""
    rows = rows.to(dtype)
    return rows if cfg.kv_scale is None else rows * _scale_in(dtype, cfg.kv_scale)


def _store_rows(pool, rows, slot_loc, lidx: int):
    """Layer ``lidx``'s rows into a stacked [L, P, page, D] pool's flat view
    at layer-offset slots (slot -1 dropped), cast to the pool's dtype, in
    place."""
    l, n_pages, page, d = pool.shape
    sl = slot_loc.reshape(-1).to(pool.device).long()
    off = torch.where(sl >= 0, lidx * n_pages * page + sl, torch.full_like(sl, -1))
    store_cache_mla(rows, pool.view(l * n_pages, page, d), off)


def _store(cfg: DeepseekConfig, kv_cache, kv_row, slot_loc, lidx: int):
    """Layer ``lidx``'s latent rows, in the pool's representation, into the
    latent pool (``_store_rows``)."""
    _store_rows(kv_cache, _lat_quant(cfg, kv_row), slot_loc, lidx)


def _logits(x_last, params, cfg: DeepseekConfig):
    return _lin(x_last, params["lm_head"], cfg).float()[:, : cfg.vocab_size]


def _indexer_ingest(h, lw, lidx: int, cfg: DeepseekConfig, positions, slot_loc, indexer, pool_tokens: int):
    """The indexer key of each token (K2, RoPE, Hadamard, fp8) into layer
    ``lidx``'s slots of the flat indexer pools, in place; slot -1 dropped.
    ``indexer`` is (idx_k, idx_s, idx_rope_cache)."""
    idx_k, idx_s, idx_rope = indexer
    sl = slot_loc.reshape(-1).to(idx_k.device).long()
    off = torch.where(sl >= 0, lidx * pool_tokens + sl, torch.full_like(sl, -1))
    fused_k_indexer_norm_rope_quant_store(_lin(h, lw["wk_idx"], cfg, lidx), positions.reshape(-1), idx_rope,
                                          lw["idx_norm"][lidx], idx_k, idx_s, off, eps=cfg.rms_eps)


def _indexer_select(h, h_q, lw, lidx: int, cfg: DeepseekConfig, positions, lengths, page_tables, indexer,
                    num_pages: int, page_size: int):
    """Score every cached token with the indexer (K15) and return the flat,
    layer-local latent slots of the best ``index_topk`` [B, index_topk]
    (-1 padded). ``h_q`` is the indexer q's input: c_q under q-LoRA, else the
    hidden state; the head gates always read the hidden state. The dtypes
    are JAX's: q rounded to the model dtype, dequantized in bf16, the gates a
    sigmoid of a float32 product."""
    idx_k, idx_s, idx_rope = indexer
    b = h.shape[0]
    q_i = _lin(h_q, lw["wq_idx"], cfg, lidx).reshape(b, cfg.idx_heads, cfg.idx_dim)
    q8, qs = fused_q_indexer_rope_hadamard_quant(q_i, positions, idx_rope)
    q_deq = q8.to(torch.bfloat16) * qs.to(torch.bfloat16)
    gate = torch.sigmoid(torch.matmul(h.float(), lw["w_idx_gate"][lidx].float().t()))  # [B, Hi]
    # the whole stacked pool, layer-offset page ids: no per-layer copy
    kv_pages = idx_k.view(cfg.num_layers * num_pages, page_size, cfg.idx_dim)
    kv_scales = idx_s.view(cfg.num_layers * num_pages, page_size)
    tables = page_tables.to(h.device)
    logits = fp8_paged_mqa_logits(q_deq, kv_pages, gate, lengths, tables + lidx * num_pages, kv_scales)
    return fast_topk_transform_fused(logits, lengths, tables, page_size, topk=cfg.index_topk)


def decode_step(params, cfg: DeepseekConfig, kv_cache, tokens, positions, page_tables, lengths, slot_loc,
                rope_cache, *, indexer=None):
    """One decode step. tokens/positions/lengths/slot_loc [B]; page_tables
    [B, max_pages]; kv_cache [L, P, page, 576]. Each layer stores the fresh
    latent row, then attends over the pool (K13a). With ``indexer`` =
    (idx_k, idx_s, idx_rope_cache) each layer also stores the fresh indexer
    key, then selects and attends only to the best ``index_topk`` rows
    (``decode_step_nsa``). Returns (logits [B, V] float32, kv_cache)."""
    b = tokens.shape[0]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    lw = params["layers"]
    n_layers, n_pages, page, d = kv_cache.shape
    pool_tokens = n_pages * page
    for lidx in range(cfg.num_layers):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q_lat, q_pe, kv_row, c_q = _mla_qkv_full(h, lw, lidx, cfg, b, positions, rope_cache)
        _store(cfg, kv_cache, kv_row, slot_loc, lidx)
        if indexer is None:
            attn = mla_decode(q_lat, q_pe, kv_cache, lengths, page_tables, layer_id=lidx, sm_scale=_lat_sm(cfg))
        else:
            # the fresh token's key goes in before the selection
            _indexer_ingest(h, lw, lidx, cfg, positions, slot_loc, indexer, pool_tokens)
            slots = _indexer_select(h, c_q if c_q is not None else h, lw, lidx, cfg, positions, lengths,
                                    page_tables, indexer, n_pages, page)
            slots = torch.where(slots >= 0, lidx * pool_tokens + slots, -1)
            attn = sparse_mla_decode(q_lat, q_pe, kv_cache.view(n_layers * pool_tokens, d), slots,
                                     sm_scale=_lat_sm(cfg))
        x = x + _mla_out(_lat_rescale(cfg, attn), lw, lidx, cfg, b)
        x = x + _mlp(rmsnorm(x, lw["post_norm"][lidx], cfg.rms_eps), lw, lidx, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    return _logits(x, params, cfg), kv_cache


def decode_step_nsa(params, cfg: DeepseekConfig, kv_cache, idx_k, idx_s, tokens, positions, page_tables, lengths,
                    slot_loc, rope_cache, idx_rope_cache):
    """NSA decode step: ``decode_step`` over the selected rows; idx_k /
    idx_s [L*P*page, ...] from ``make_indexer_cache``. Returns (logits,
    kv_cache, idx_k, idx_s), every pool updated in place."""
    logits, kv_cache = decode_step(params, cfg, kv_cache, tokens, positions, page_tables, lengths, slot_loc,
                                   rope_cache, indexer=(idx_k, idx_s, idx_rope_cache))
    return logits, kv_cache, idx_k, idx_s


def prefill(params, cfg: DeepseekConfig, kv_cache, tokens, positions, q_lens, slot_loc, rope_cache, *,
            indexer=None, score_cache=None):
    """Prefill a padded batch [B, S]: causal MLA (K7 at 576) over the fresh
    latent rows, stored per layer; with ``indexer`` = (idx_k, idx_s,
    idx_rope_cache) each token's indexer key is stored too, with
    ``score_cache`` (KV compression) its score row. Returns (last-token
    logits [B, V] float32, kv_cache)."""
    b, s = tokens.shape
    x = params["embed"][tokens.reshape(-1).long()].to(cfg.dtype)
    lw = params["layers"]
    nh = cfg.num_heads
    pool_tokens = kv_cache.shape[1] * kv_cache.shape[2]
    for lidx in range(cfg.num_layers):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q_lat, q_pe, kv_row = _mla_qkv(h, lw, lidx, cfg, b * s, positions.reshape(-1), rope_cache)
        _store(cfg, kv_cache, kv_row, slot_loc, lidx)
        if indexer is not None:
            _indexer_ingest(h, lw, lidx, cfg, positions, slot_loc, indexer, pool_tokens)
        if score_cache is not None:
            _store_rows(score_cache, _lin(h, lw["comp_score"], cfg, lidx), slot_loc, lidx)
        attn = mla_prefill(q_lat.reshape(b, s, nh, D_LATENT), q_pe.reshape(b, s, nh, D_ROPE),
                           kv_row.reshape(b, s, D_CKV), q_lens, q_lens, sm_scale=_sm_scale(cfg))
        x = x + _mla_out(attn.reshape(b * s, nh, D_LATENT), lw, lidx, cfg, b * s)
        x = x + _mlp(rmsnorm(x, lw["post_norm"][lidx], cfg.rms_eps), lw, lidx, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps).reshape(b, s, -1)
    last = (q_lens.to(x.device).long() - 1).clamp(0, s - 1)
    return _logits(x[torch.arange(b, device=x.device), last], params, cfg), kv_cache


def prefill_nsa(params, cfg: DeepseekConfig, kv_cache, idx_k, idx_s, tokens, positions, q_lens, slot_loc,
                rope_cache, idx_rope_cache):
    """Dense prefill that also stores the indexer keys, so that later
    ``decode_step_nsa`` steps can score the whole history. Returns (logits,
    kv_cache, idx_k, idx_s)."""
    logits, kv_cache = prefill(params, cfg, kv_cache, tokens, positions, q_lens, slot_loc, rope_cache,
                               indexer=(idx_k, idx_s, idx_rope_cache))
    return logits, kv_cache, idx_k, idx_s


def _mla_attend_packed(q_lat, q_pe, kv_row, blk_seq, blk_q0, seq_meta, cfg: DeepseekConfig, tp: int, max_kvb: int):
    """Packed MLA self-attention: one MQA head over the block-aligned packed
    latent rows (K9 at 576), q's two parts read where they lie and the
    latent's first 512 columns doubling as V (JAX concatenates q and
    zero-pads V to 576; the values are the same)."""
    return flash_attention_packed_mla(q_lat.reshape(tp, cfg.num_heads, D_LATENT),
                                      q_pe.reshape(tp, cfg.num_heads, D_ROPE),
                                      kv_row.reshape(tp, 1, D_CKV).to(q_lat.dtype), blk_seq, blk_q0, seq_meta,
                                      max_kvb=max_kvb, causal=True, sm_scale=_sm_scale(cfg))


def prefill_packed(params, cfg: DeepseekConfig, kv_cache, idx_k, idx_s, tokens, positions, blk_seq, blk_q0,
                   seq_meta, last_idx, slot_loc, rope_cache, *, max_kvb: int, with_indexer: bool = False,
                   idx_rope_cache=None, score_cache=None):
    """Token-packed multi-prompt MLA prefill: tokens/positions/slot_loc [TP]
    packed; blk_seq/blk_q0 [NQB]; seq_meta [B, 6]; last_idx [B]. With
    ``with_indexer`` each token's NSA indexer key goes into ``idx_k`` /
    ``idx_s`` too (rope at ``idx_rope_cache``), with ``score_cache`` (KV
    compression) its score row. Returns (logits [B, V] float32, kv_cache),
    and idx_k, idx_s after them with the indexer."""
    tp = tokens.shape[0]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    lw = params["layers"]
    pool_tokens = kv_cache.shape[1] * kv_cache.shape[2]
    for lidx in range(cfg.num_layers):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q_lat, q_pe, kv_row = _mla_qkv(h, lw, lidx, cfg, tp, positions, rope_cache)
        _store(cfg, kv_cache, kv_row, slot_loc, lidx)
        if with_indexer:
            _indexer_ingest(h, lw, lidx, cfg, positions, slot_loc, (idx_k, idx_s, idx_rope_cache), pool_tokens)
        if score_cache is not None:
            _store_rows(score_cache, _lin(h, lw["comp_score"], cfg, lidx), slot_loc, lidx)
        attn = _mla_attend_packed(q_lat, q_pe, kv_row, blk_seq, blk_q0, seq_meta, cfg, tp, max_kvb)
        x = x + _mla_out(attn.reshape(tp, cfg.num_heads, D_LATENT), lw, lidx, cfg, tp)
        x = x + _mlp(rmsnorm(x, lw["post_norm"][lidx], cfg.rms_eps), lw, lidx, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    logits = _logits(x[last_idx.long().to(x.device)], params, cfg)
    return (logits, kv_cache, idx_k, idx_s) if with_indexer else (logits, kv_cache)


def prefill_extend(params, cfg: DeepseekConfig, kv_cache, tokens, positions, q_lens, kv_lens, page_tables, slot_loc,
                   rope_cache, *, prefix_max: int, num_logits: int = 1, indexer=None):
    """Extend (chunked) MLA prefill: the q tokens are the suffix of sequences
    whose prefix latents already live in the pool (a radix-cache hit or an
    earlier chunk). tokens/positions/slot_loc [B, S]; q_lens [B] suffix
    lengths; kv_lens [B] totals; page_tables [B, P]; ``prefix_max`` a page
    multiple >= every prefix. Per layer: pass 1 attends causally over the
    fresh latents at global offsets, pass 2 fully over the gathered prefix
    (masked by its length), and merge_state joins them by the base-2 lse.
    With ``indexer`` = (idx_k, idx_s, idx_rope_cache) the chunk's indexer
    keys are stored too. Returns (logits [B, V] float32 of each suffix's
    last token, kv_cache); with ``num_logits`` n > 1 (the speculative chain
    verify) [B, n, V], of each sequence's last n positions."""
    b, s = tokens.shape
    dev = kv_cache.device
    nh = cfg.num_heads
    x = params["embed"][tokens.reshape(-1).long()].to(cfg.dtype)
    lw = params["layers"]
    q_lens = q_lens.to(dev, torch.int32)
    prefix_lens = kv_lens.to(dev, torch.int32) - q_lens
    page = kv_cache.shape[-2]
    pool_tokens = kv_cache.shape[1] * page
    pos = torch.arange(prefix_max, device=dev)
    pre_slots = page_tables.to(dev).long()[:, pos // page] * page + (pos % page)[None, :]  # [B, prefix_max]
    zero = torch.zeros_like(prefix_lens)
    for lidx in range(cfg.num_layers):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q_lat, q_pe, kv_row = _mla_qkv(h, lw, lidx, cfg, b * s, positions.reshape(-1), rope_cache)
        _store(cfg, kv_cache, kv_row, slot_loc, lidx)
        if indexer is not None:
            _indexer_ingest(h, lw, lidx, cfg, positions, slot_loc, indexer, pool_tokens)
        qn = q_lat.reshape(b, s, nh, D_LATENT)
        qp = q_pe.reshape(b, s, nh, D_ROPE)
        o1, l1 = mla_prefill(qn, qp, kv_row.reshape(b, s, D_CKV), q_lens, q_lens, q_start=prefix_lens,
                             kv_start=prefix_lens, sm_scale=_sm_scale(cfg), return_lse=True)
        kv_pre = kv_cache[lidx][pre_slots // page, pre_slots % page]  # [B, prefix_max, 576]
        o2, l2 = mla_prefill(qn, qp, _lat_deq(cfg, kv_pre, qn.dtype), q_lens, prefix_lens, q_start=prefix_lens,
                             kv_start=zero, sm_scale=_sm_scale(cfg), return_lse=True)
        om, _ = merge_state(o1.reshape(b * s, nh, D_LATENT), l1.transpose(1, 2).reshape(b * s, nh),
                            o2.reshape(b * s, nh, D_LATENT), l2.transpose(1, 2).reshape(b * s, nh))
        x = x + _mla_out(om, lw, lidx, cfg, b * s)
        x = x + _mlp(rmsnorm(x, lw["post_norm"][lidx], cfg.rms_eps), lw, lidx, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps).reshape(b, s, -1)
    logits = _logits(llama.logit_rows(x, q_lens, num_logits), params, cfg)
    return llama._logits_shape(logits, b, num_logits), kv_cache


def prefill_extend_nsa(params, cfg: DeepseekConfig, kv_cache, idx_k, idx_s, tokens, positions, q_lens, kv_lens,
                       page_tables, slot_loc, rope_cache, idx_rope_cache, *, prefix_max: int):
    """The dense extend that also stores the chunk's indexer keys (an
    indexer key depends on its token only). Returns (logits, kv_cache,
    idx_k, idx_s)."""
    logits, kv_cache = prefill_extend(params, cfg, kv_cache, tokens, positions, q_lens, kv_lens, page_tables,
                                      slot_loc, rope_cache, prefix_max=prefix_max,
                                      indexer=(idx_k, idx_s, idx_rope_cache))
    return logits, kv_cache, idx_k, idx_s


# ---------------------------------------------------------------------------
# KV compression: exact prefill that builds each request's ring of pooled
# latent rows, and a decode over the ring and the last compress_local tokens
# ---------------------------------------------------------------------------


def _comp_ratio(cfg: DeepseekConfig) -> int:
    return 4 if cfg.compress == "c4" else 128


def _comp_window(cfg: DeepseekConfig) -> int:
    r = _comp_ratio(cfg)
    return 2 * r if r == 4 else r


def _comp_local(cfg: DeepseekConfig) -> int:
    r = _comp_ratio(cfg)
    local = cfg.compress_local if cfg.compress_local is not None else max(64, r)
    if local < r:
        # tokens older than the local window but not yet pooled would be
        # attended by neither branch
        raise ValueError(f"compress_local={local} < ratio {r}")
    return local


def _check_unscaled(cfg: DeepseekConfig):
    if cfg.kv_scale is not None:
        raise ValueError("kv_scale applies to the dense and NSA latent pools; the compressed family's rings "
                         "pool unscaled latents")


def make_compress_caches(cfg: DeepseekConfig, num_pages: int, page_size: int, max_slots: int = 16, device="cuda"):
    """(latent pool, score pool [L, P, page, 576] in the model dtype, ring
    pool [L, max_slots, compress_ring, 576] in the model dtype)."""
    dev = resolve_device(device)
    kv = make_cache(cfg, num_pages, page_size, device=dev)
    sc = torch.zeros((cfg.num_layers, num_pages, page_size, D_CKV), dtype=cfg.dtype, device=dev)
    comp = torch.zeros((cfg.num_layers, max_slots, cfg.compress_ring, D_CKV), dtype=cfg.dtype, device=dev)
    return kv, sc, comp


def _dense_mla_attend(q_lat, q_pe, rows, mask, scale):
    """Masked MLA attention in float32 over gathered latent rows: q_lat [B, H,
    512], q_pe [B, H, 64], rows [B, K, 576], mask [B, K]. Returns (o [B, H,
    512], lse [B, H] base 2); a row with nothing unmasked gives (0, -inf)."""
    q = torch.cat([q_lat, q_pe], dim=-1).float()
    r = rows.float()
    s2 = torch.einsum("bhd,bkd->bhk", q, r) * (scale * LOG2E)
    s2 = torch.where(mask[:, None, :], s2, float("-inf"))
    m = s2.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask[:, None, :], torch.exp2(s2 - m_safe[..., None]), 0.0)
    total = p.sum(dim=-1)
    o = torch.einsum("bhk,bkd->bhd", p, r[..., :D_LATENT]) / torch.clamp(total, min=1e-30)[..., None]
    lse = torch.where(total > 0, m_safe + torch.log2(torch.clamp(total, min=1e-30)), float("-inf"))
    return o, lse


def decode_step_c(params, cfg: DeepseekConfig, kv_cache, score_cache, comp_cache, tokens, positions, page_tables,
                  lengths, slot_loc, state_slots, rope_cache):
    """Compressed-KV decode step. kv_cache / score_cache [L, P, page, 576];
    comp_cache [L, S, ring, 576], a request's rows at its ``state_slots``
    [B]; ``lengths`` [B] count the fresh token. Each layer stores the fresh
    latent and score rows, pools the last window of every row whose length
    is a ratio multiple into ring slot (n_events - 1) % ring (the other
    rows' writes dropped on the device), then attends over the last
    ``compress_local`` tokens and the live ring tokens and merges the two by
    lse. Returns (logits [B, V] float32, kv_cache, score_cache, comp_cache),
    the pools updated in place."""
    _check_unscaled(cfg)
    b = tokens.shape[0]
    ring, local = cfg.compress_ring, _comp_local(cfg)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    lw = params["layers"]
    n_layers, n_pages, page, d = kv_cache.shape
    dev = kv_cache.device
    pool_tokens, ring_rows = n_pages * page, comp_cache.shape[1] * ring
    lengths, tables = lengths.to(dev).long(), page_tables.to(dev)
    slots = state_slots.to(dev).long()
    src, dst, n_comp = plan_compress_decode(lengths, compress_ratio=_comp_ratio(cfg), ring_size=ring)
    src, dst = src.long(), dst.long()
    src_valid = src >= 0
    src_rows = _flat_rows(tables, torch.where(src_valid, src, 0), page)  # [B, W], layer offset added below
    loc_pos = lengths[:, None] - local + torch.arange(local, device=dev)[None, :]
    loc_valid = loc_pos >= 0
    loc_rows = _flat_rows(tables, torch.where(loc_valid, loc_pos, 0), page)  # [B, local]
    dst_rows = torch.where(dst >= 0, slots * ring + dst, -1)
    live_rows = slots[:, None] * ring + torch.arange(ring, device=dev)[None, :]  # [B, ring]
    live = torch.arange(ring, device=dev)[None, :] < n_comp[:, None]
    kv_flat, sc_flat = kv_cache.view(-1, d), score_cache.view(-1, d)
    comp_flat = comp_cache.view(-1, d)
    for lidx in range(cfg.num_layers):
        h = rmsnorm(x, lw["input_norm"][lidx], cfg.rms_eps)
        q_lat, q_pe, kv_row = _mla_qkv(h, lw, lidx, cfg, b, positions, rope_cache)
        _store(cfg, kv_cache, kv_row, slot_loc, lidx)
        _store_rows(score_cache, _lin(h, lw["comp_score"], cfg, lidx), slot_loc, lidx)
        base, cbase = lidx * pool_tokens, lidx * ring_rows
        win_sc = torch.where(src_valid[..., None], sc_flat[base + src_rows].float(), float("-inf"))
        pooled = compress_window(kv_flat[base + src_rows], win_sc, lw["comp_ape"][lidx])
        _put_rows(comp_flat, torch.where(dst_rows >= 0, cbase + dst_rows, -1), pooled)
        o_loc, lse_loc = _dense_mla_attend(q_lat, q_pe, kv_flat[base + loc_rows], loc_valid, _sm_scale(cfg))
        o_c, lse_c = _dense_mla_attend(q_lat, q_pe, comp_flat[cbase + live_rows], live, _sm_scale(cfg))
        attn, _ = merge_state(o_loc, lse_loc, o_c, lse_c)
        x = x + _mla_out(attn.to(cfg.dtype), lw, lidx, cfg, b)
        x = x + _mlp(rmsnorm(x, lw["post_norm"][lidx], cfg.rms_eps), lw, lidx, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    return _logits(x, params, cfg), kv_cache, score_cache, comp_cache


# elements of one gather of window rows in the ring build (64 MB in float32):
# the build takes a layer's events in chunks of at most this many rows x 576
_RING_BUILD_ELEMS = 1 << 24


def _build_rings(params, cfg: DeepseekConfig, kv_cache, score_cache, comp_cache, slot_of, valid, dst, state_slots):
    """Pool every window the prefill plan names into each request's ring, in
    place: slot_of [B, n, W] the windows' flat pool slots, valid [B, n, W],
    dst [B, n] ring slots (-1: no window), state_slots [B]. A layer at a
    time, its events in chunks, so the gathered windows stay small (all
    layers and events at once would be ~4 GB at c128 with 16 requests)."""
    n_layers, n_pages, page, d = kv_cache.shape
    ring = cfg.compress_ring
    b, n, w = slot_of.shape
    slot_of = torch.where(valid, slot_of, 0)
    dst = dst.long()
    rows = torch.where(dst >= 0, state_slots.to(dst.device).long()[:, None] * ring + dst, -1)  # [B, n]
    kv_flat = kv_cache.view(n_layers, n_pages * page, d)
    sc_flat = score_cache.view(n_layers, n_pages * page, d)
    comp_flat = comp_cache.view(-1, d)
    step = max(1, _RING_BUILD_ELEMS // (b * w * d))
    for lidx in range(n_layers):
        ape, cbase = params["layers"]["comp_ape"][lidx], lidx * comp_cache.shape[1] * ring
        for e0 in range(0, n, step):
            idx = slot_of[:, e0: e0 + step]
            sc = torch.where(valid[:, e0: e0 + step, :, None], sc_flat[lidx][idx].float(), float("-inf"))
            pooled = compress_window(kv_flat[lidx][idx], sc, ape)
            r = rows[:, e0: e0 + step].reshape(-1)
            _put_rows(comp_flat, torch.where(r >= 0, cbase + r, -1), pooled.reshape(-1, d))


def prefill_c(params, cfg: DeepseekConfig, kv_cache, score_cache, comp_cache, tokens, positions, q_lens, slot_loc,
              state_slots, rope_cache):
    """Compressed-family prefill of a padded batch [B, S]: exact causal MLA
    (K7 at 576; compression bounds only the decode's reads), the latent and
    score rows stored, then each request's ring built from its stored
    windows (``plan_compress_prefill``) at its ``state_slots`` [B]. Returns
    (last-token logits [B, V] float32, kv_cache, score_cache, comp_cache)."""
    _check_unscaled(cfg)
    logits, kv_cache = prefill(params, cfg, kv_cache, tokens, positions, q_lens, slot_loc, rope_cache,
                               score_cache=score_cache)
    dev = kv_cache.device
    src, dst, _ = plan_compress_prefill(q_lens.to(dev), compress_ratio=_comp_ratio(cfg), ring_size=cfg.compress_ring)
    src = src.long()
    valid = src >= 0
    slot_of = slot_loc.to(dev).long().gather(1, torch.where(valid, src, 0).reshape(src.shape[0], -1))
    _build_rings(params, cfg, kv_cache, score_cache, comp_cache, slot_of.reshape(src.shape), valid, dst, state_slots)
    return logits, kv_cache, score_cache, comp_cache


def prefill_packed_c(params, cfg: DeepseekConfig, kv_cache, score_cache, comp_cache, tokens, positions, blk_seq,
                     blk_q0, seq_meta, last_idx, slot_loc, state_slots, rope_cache, *, max_kvb: int):
    """Compressed-family packed prefill: ``prefill_packed``'s exact MLA over
    several block-aligned prompts (K9 at 576) with the score rows stored,
    then each sequence's ring built from the packed layout (sequence i's
    tokens start at packed index seq_meta[i, 4] * block, as the engine lays
    the blocks out). Returns (logits [B, V] float32, kv_cache, score_cache,
    comp_cache)."""
    _check_unscaled(cfg)
    logits, kv_cache = prefill_packed(params, cfg, kv_cache, None, None, tokens, positions, blk_seq, blk_q0, seq_meta,
                                      last_idx, slot_loc, rope_cache, max_kvb=max_kvb, score_cache=score_cache)
    dev = kv_cache.device
    seq_meta = seq_meta.to(dev).long()
    seq_q0 = seq_meta[:, 4] * (tokens.shape[0] // blk_seq.shape[0])  # each sequence's first packed token
    src, dst, _ = plan_compress_prefill(seq_meta[:, 0], compress_ratio=_comp_ratio(cfg), ring_size=cfg.compress_ring)
    src = src.long()
    valid = src >= 0
    slot_of = slot_loc.to(dev).long()[seq_q0[:, None, None] + torch.where(valid, src, 0)]
    _build_rings(params, cfg, kv_cache, score_cache, comp_cache, slot_of, valid, dst, state_slots)
    return logits, kv_cache, score_cache, comp_cache
