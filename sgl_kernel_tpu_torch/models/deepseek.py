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
KV compression (``compress``) and several logits per sequence (speculative
verify).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from ..ops.attention import merge_state
from ..ops.attention.flash_packed import flash_attention_packed_mla
from ..ops.attention.mla import D_CKV, D_LATENT, D_ROPE, mla_decode, mla_prefill
from ..ops.attention.nsa import (
    fast_topk_transform_fused,
    fp8_paged_mqa_logits,
    fused_k_indexer_norm_rope_quant_store,
    fused_q_indexer_rope_hadamard_quant,
    sparse_mla_decode,
)
from ..ops.gemm.w4a16 import quantize_w4, w4a16_gemm
from ..ops.kvcache import store_cache_mla
from ..ops.moe import MoeWeights, biased_topk, fused_experts, pick_block_size
from ..ops.norm import rmsnorm
from ..ops.rope import compute_cos_sin_cache, mla_qkv_prep, rotary_embedding
from ..utils import resolve_device, round_up

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
    # DSv4 KV compression (not ported: raises)
    compress: Optional[str] = None
    compress_ring: int = 64
    compress_local: Optional[int] = None

    def __post_init__(self):
        if self.quant not in (None, "w4a16"):
            raise NotImplementedError(f"quant={self.quant!r}: only 'w4a16' is ported")
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


def _served(cfg: DeepseekConfig):
    """Raise for the configurations whose paths are not ported."""
    if cfg.compress:
        raise NotImplementedError(f"DeepseekConfig(compress={cfg.compress!r}): KV compression is not ported yet")


def init_weights(cfg: DeepseekConfig, generator: Union[torch.Generator, int] = 0, device="cuda") -> Dict[str, Any]:
    """Random layer-stacked weights in the JAX recipe's shapes and scales
    (each matrix N(0, 1/fan_in) but the router's and the embedding's 0.02;
    norms one; router bias zero). ``generator`` is a torch.Generator on
    ``device`` or an int seed. A quantized linear is drawn, cast and
    quantized one layer at a time and an expert bank one layer's bank at a
    time, so the float32 temporaries stay one layer large (the whole float32
    bank of a V2-Lite ``moe_w1`` would be 37.8 GB)."""
    _served(cfg)
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

    def linear(n, k):
        """[L, N, K], or its W4A16 tree when the config quantizes."""
        if not quant:
            return stack(lambda: draw((n, k)))
        packed = scales = None
        for i in range(n_layers):
            p, s, _ = quantize_w4(draw((n, k)), group_size=cfg.group_size)
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
    _served(cfg)
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
    _served(cfg)
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


def _store(cfg: DeepseekConfig, kv_cache, kv_row, slot_loc, lidx: int):
    """Layer ``lidx``'s latent rows into the stacked pool's flat view at
    layer-offset slots (slot -1 dropped), in place."""
    l, n_pages, page, d = kv_cache.shape
    sl = slot_loc.reshape(-1).to(kv_cache.device).long()
    off = torch.where(sl >= 0, lidx * n_pages * page + sl, torch.full_like(sl, -1))
    store_cache_mla(_lat_quant(cfg, kv_row), kv_cache.view(l * n_pages, page, d), off)


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
    _served(cfg)
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
            indexer=None):
    """Prefill a padded batch [B, S]: causal MLA (K7 at 576) over the fresh
    latent rows, stored per layer; with ``indexer`` = (idx_k, idx_s,
    idx_rope_cache) each token's indexer key is stored too. Returns
    (last-token logits [B, V] float32, kv_cache)."""
    _served(cfg)
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
                   idx_rope_cache=None):
    """Token-packed multi-prompt MLA prefill: tokens/positions/slot_loc [TP]
    packed; blk_seq/blk_q0 [NQB]; seq_meta [B, 6]; last_idx [B]. With
    ``with_indexer`` each token's NSA indexer key goes into ``idx_k`` /
    ``idx_s`` too (rope at ``idx_rope_cache``). Returns (logits [B, V]
    float32, kv_cache), and idx_k, idx_s after them with the indexer."""
    _served(cfg)
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
    last token, kv_cache). Only ``num_logits=1`` is ported (several logits
    per sequence serve the speculative verify)."""
    _served(cfg)
    if num_logits != 1:
        raise NotImplementedError("prefill_extend(num_logits>1): speculative verify is not ported yet")
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
    last = (q_lens.long() - 1).clamp(0, s - 1)
    return _logits(x[torch.arange(b, device=dev), last], params, cfg), kv_cache


def prefill_extend_nsa(params, cfg: DeepseekConfig, kv_cache, idx_k, idx_s, tokens, positions, q_lens, kv_lens,
                       page_tables, slot_loc, rope_cache, idx_rope_cache, *, prefix_max: int):
    """The dense extend that also stores the chunk's indexer keys (an
    indexer key depends on its token only). Returns (logits, kv_cache,
    idx_k, idx_s)."""
    logits, kv_cache = prefill_extend(params, cfg, kv_cache, tokens, positions, q_lens, kv_lens, page_tables,
                                      slot_loc, rope_cache, prefix_max=prefix_max,
                                      indexer=(idx_k, idx_s, idx_rope_cache))
    return logits, kv_cache, idx_k, idx_s
