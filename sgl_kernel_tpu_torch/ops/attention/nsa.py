"""NSA sparse attention: the fp8 indexer, its top-k and sparse MLA.

The port of sgl_kernel_tpu/ops/attention/nsa.py. A decode step scores every
cached token with the indexer (``fp8_paged_mqa_logits``), keeps the best
``topk`` (``fast_topk_transform_fused``, as flat latent-pool slots) and
attends only to those latent rows (``sparse_mla_decode``).

``fp8_paged_mqa_logits`` is kernel K15, CUDA C++ in ``csrc/mqa_logits.cu``,
replacing the Pallas ``fp8_paged_mqa_logits`` (nsa.py:141, pallas_call at
:222); ``fp8_paged_mqa_logits_ref`` is its plain twin. fp8 values convert
exactly (the twin to bf16, the kernel to fp16 with q as fp16, which holds
every bf16 q of magnitude 2^-14 to 65,504), denormals included, where the
JAX ``_upcast`` (paged_decode_dma.py:41-70) flushes them to zero. The
kernel divides its work on the device from the lengths; ``work_units`` is
that division in plain Python.

``sparse_mla_decode`` needs no kernel of its own and no copy of the selected
rows: the flat latent pool is viewed as pages of one row, [S, 1, 576], so
the selected slots are a page table that K13a (``mla_decode``) walks row by
row, with the selection counts as lengths. Empty selections follow the JAX
rules (o = 0, lse = -inf; zeros when both pools of a row are empty).

The top-k functions sort stably (descending), so ties break toward the lower
position, as ``jax.lax.top_k`` does. The rest is plain PyTorch: the ragged
``fp8_mqa_logits`` and the two fused indexer preprocessors (rmsnorm, neox
RoPE, the Hadamard rotation, per-token fp8 quantization).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import _build
from ..hadamard import hadamard_transform
from ..kvcache import store_cache_mla
from ..norm import rmsnorm
from ..quant import per_token_quant_fp8
from ..rope import rotary_embedding
from .merge_state import LOG2E, apply_sinks, merge_state
from .mla import D_CKV, mla_decode

FAST_TOPK_K = 2048  # the reference contract's fixed k

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _compute_dtype(q, kv_pages):
    """The JAX compute dtype: float32 when q and the keys are both float32,
    else bf16 (fp8 operands upcast)."""
    return torch.float32 if q.dtype == torch.float32 and kv_pages.dtype == torch.float32 else torch.bfloat16


def fp8_paged_mqa_logits_ref(q, kv_pages, weights, lengths, page_table, kv_scales=None):
    """Plain twin of ``fp8_paged_mqa_logits``: gathers every page of the
    table, scores in float32 from operands in the compute dtype."""
    b, h, d = q.shape
    n_pages, page, _ = kv_pages.shape
    n_tok = page_table.shape[1] * page
    if weights.dim() == 1:
        weights = weights[None].expand(b, h)
    cd = _compute_dtype(q, kv_pages)
    pt = page_table.to(q.device).long().clamp(0, n_pages - 1)
    keys = kv_pages[pt].reshape(b, n_tok, d).to(cd).float()
    sc = torch.einsum("bhd,btd->bht", q.to(cd).float(), keys)
    logits = torch.einsum("bh,bht->bt", weights.float(), torch.relu(sc))
    if kv_scales is not None:
        logits = logits * kv_scales.float()[pt].reshape(b, n_tok)
    pos = torch.arange(n_tok, device=q.device)[None, :]
    return torch.where(pos < lengths.to(q.device)[:, None], logits, float("-inf"))


_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
_KEY_TYPES = {torch.bfloat16: 0, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}
UNIT_KEYS = 64  # keys of one unit of the card's kernel (csrc/mqa_logits.cu, kTok)
_MAX_BATCH = 4096  # sequences a launch takes (the kernel keeps their prefix in shared memory)


def work_units(lengths, n_blocks: int, page: int, grid: int):
    """The card kernel's division of work, in plain Python (the kernel
    computes it on the device from the lengths): sequence b holds n_b =
    min(max(length, 0), n_blocks * page) keys in ceil(n_b / 64) units of 64
    (none when n_b = 0); unit u = pre[b] + j; of the ``grid`` blocks the
    first g = min(grid, U) take [U c / g, U (c + 1) / g) each, the rest
    nothing. Returns (units, blocks): units[b] = (n_b, n_units); blocks[c] =
    (u0, u1)."""
    units = [(n, -(-n // UNIT_KEYS)) for n in (max(0, min(int(x), n_blocks * page)) for x in lengths)]
    total = sum(cnt for _, cnt in units)
    grid = min(grid, total)
    return units, [(total * c // grid, total * (c + 1) // grid) for c in range(grid)]


def fp8_paged_mqa_logits(q, kv_pages, weights, lengths, page_table, kv_scales=None, *, chunk_pages: int = 16):
    """Indexer scores logits[b, t] = sum_h w[b, h] relu(q[b, h] . k[t]) s[t].

    q [B, H, D] (bf16, fp8 upcast, or float32 with float32 keys); kv_pages
    [P, page, D] fp8 e4m3 / e5m2 or bf16; weights [B, H] or [H]; kv_scales
    optional [P, page] float32; lengths [B]; page_table [B, n_blocks].
    Returns [B, n_blocks * page] float32, -inf at t >= lengths[b].

    CUDA tensors go through K15, which takes D = 128, H <= 128, bf16 or fp8
    q and fp8 or bf16 keys. ``chunk_pages`` sizes the TPU kernel's DMA window
    and has no meaning here."""
    b, h, d = q.shape
    if weights.dim() == 1:
        weights = weights[None].expand(b, h)
    if q.device.type != "cuda":
        return fp8_paged_mqa_logits_ref(q, kv_pages, weights, lengths, page_table, kv_scales)
    if d != 128 or h > 128 or kv_pages.dtype not in _KEY_TYPES or q.dtype not in (torch.bfloat16, *_FP8):
        raise NotImplementedError("fp8_paged_mqa_logits: the CUDA kernel takes D = 128, H <= 128, bf16 or fp8 q "
                                  "and bf16, float8_e4m3fn or float8_e5m2 keys")
    if not kv_pages.is_contiguous():
        raise ValueError("fp8_paged_mqa_logits: the key pages must be contiguous")
    n_pages, page, _ = kv_pages.shape
    dev = q.device
    qb = q.to(torch.bfloat16).contiguous()
    w = weights.to(device=dev, dtype=torch.float32).contiguous()
    scales = None if kv_scales is None else kv_scales.to(device=dev, dtype=torch.float32).contiguous()
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    table = page_table.to(device=dev, dtype=torch.int32).contiguous()
    n_blocks = table.shape[1]
    out = torch.empty((b, n_blocks * page), dtype=torch.float32, device=dev)
    fn = _build.bind("mqa_logits", "skt_fp8_paged_mqa_logits", _ARGS)
    for s0 in range(0, b, _MAX_BATCH):  # one launch for every decode batch
        n = min(b, s0 + _MAX_BATCH) - s0
        _build.check(fn(qb[s0:].data_ptr(), kv_pages.data_ptr(), w[s0:].data_ptr(),
                        None if scales is None else scales.data_ptr(), lens[s0:].data_ptr(), table[s0:].data_ptr(),
                        out[s0:].data_ptr(), n, h, n_pages, page, n_blocks, _KEY_TYPES[kv_pages.dtype],
                        _build.stream_ptr(dev)), "fp8_paged_mqa_logits")
        fp8_paged_mqa_logits.launches += 1
    return out


fp8_paged_mqa_logits.launches = 0


def fp8_mqa_logits(q_fp8, kv_fp8, weights, ks, ke, clean_logits: bool = False):
    """Ragged indexer scores: q_fp8 [Nq, H, D]; kv_fp8 = (k [Nk, D], k_scale
    [Nk]); weights [Nq, H]; key j visible to query i for ks[i] <= j < ke[i].
    score[i, j] = sum_h relu(q_i,h . k_j) w[i, h] k_scale[j], in float32 from
    bf16 operands; invisible scores are -inf with ``clean_logits``, else 0."""
    k_fp8, k_scale = kv_fp8
    nq, h, d = q_fp8.shape
    dots = torch.matmul(q_fp8.to(torch.bfloat16).float().reshape(nq * h, d), k_fp8.to(torch.bfloat16).float().t())
    score = (torch.relu(dots.reshape(nq, h, -1)) * weights[..., None].float()).sum(1) * k_scale[None, :].float()
    j = torch.arange(k_fp8.shape[0], device=score.device)[None, :]
    mask = (j >= ks.to(score.device)[:, None]) & (j < ke.to(score.device)[:, None])
    return torch.where(mask, score, float("-inf") if clean_logits else 0.0)


def _top(logits, k):
    """The k largest of each row, ties toward the lower position (the order
    of jax.lax.top_k). Returns (values, indices)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _pad_to(idx, topk):
    if idx.shape[1] < topk:
        idx = torch.nn.functional.pad(idx, (0, topk - idx.shape[1]), value=-1)
    return idx


def fast_topk(logits, lengths, topk: int = FAST_TOPK_K):
    """Top-``topk`` token positions of each row [B, T]; row b keeps its first
    min(lengths[b], topk) picks, the rest (and the padding past T) is -1.
    Returns int32 [B, topk]."""
    k = min(topk, logits.shape[1])
    _, idx = _top(logits, k)
    rank = torch.arange(k, device=logits.device)[None, :]
    valid = rank < torch.clamp_max(lengths.to(logits.device), k)[:, None]
    return _pad_to(torch.where(valid, idx, -1), topk).to(torch.int32)


def fast_topk_transform_fused(logits, lengths, src_page_table, page_size: int, topk: int = FAST_TOPK_K):
    """``fast_topk`` mapped through the page table to flat slots
    page * page_size + offset (-1 kept). Returns int32 [B, topk]."""
    idx = fast_topk(logits, lengths, topk).long()
    safe = idx.clamp_min(0)
    pages = src_page_table.to(idx.device).long().gather(1, safe // page_size)
    return torch.where(idx >= 0, pages * page_size + safe % page_size, -1).to(torch.int32)


def fast_topk_transform_ragged_fused(logits, ks, ke, src_page_table, page_size: int, topk: int = FAST_TOPK_K):
    """The ragged form: query i sees keys ks[i] <= j < ke[i]; invisible keys
    are never picked, a row with fewer visible keys than ``topk`` pads with
    -1. Returns int32 flat slots [Nq, topk]."""
    nq, nk = logits.shape
    j = torch.arange(nk, device=logits.device)[None, :]
    masked = torch.where((j >= ks.to(j.device)[:, None]) & (j < ke.to(j.device)[:, None]), logits, float("-inf"))
    vals, idx = _top(masked, min(topk, nk))
    pages = src_page_table.to(idx.device).long().gather(1, idx // page_size)
    out = torch.where(vals > float("-inf"), pages * page_size + idx % page_size, -1)
    return _pad_to(out, topk).to(torch.int32)


def sparse_mla_decode(q_nope, q_pe, kv_pool_flat, slot_indices, *, sm_scale: Optional[float] = None,
                      topk_length=None, extra_pool_flat=None, extra_indices=None, extra_topk_length=None,
                      attn_sink=None, return_lse: bool = False, page: int = 1024):
    """MLA decode over selected latent rows. q_nope [B, H, 512]; q_pe
    [B, H, 64]; kv_pool_flat [S, 576] (or 640); slot_indices [B, K] flat
    slots, valid entries first, -1 padding; ``topk_length`` [B] valid
    counts (default: counted from the -1s). A second pool
    (``extra_pool_flat`` / ``extra_indices`` / ``extra_topk_length``) merges
    by lse; ``attn_sink`` [H] (natural-log logits) applies once after the
    merge. Returns [B, H, 512] in q's dtype (+ base-2 lse [B, H]).

    Each pool runs K13a over the pool viewed as one-row pages, the slots as
    the page table, so no row is copied; the kernel divides its work by the
    selection counts (on the device), not by the table's width. ``page``
    sizes the TPU's gathered pseudo-pool and has no meaning here."""
    scale = sm_scale if sm_scale is not None else 1.0 / D_CKV ** 0.5
    dev = q_nope.device

    def counts(idx, tl):
        return (idx >= 0).sum(1) if tl is None else tl

    def one_pool(pool, idx, tl):
        tl = counts(idx, tl).to(device=dev, dtype=torch.int32)
        rows = pool.reshape(-1, 1, pool.shape[-1])
        o, lse = mla_decode(q_nope, q_pe, rows, tl.clamp_min(1), idx.to(dev).clamp_min(0), sm_scale=scale,
                            return_lse=True)
        empty = tl == 0  # an empty selection contributes nothing to the merge
        return (torch.where(empty[:, None, None], 0.0, o.float()),
                torch.where(empty[:, None], float("-inf"), lse))

    o, lse = one_pool(kv_pool_flat, slot_indices, topk_length)
    if extra_pool_flat is not None:
        o2, lse2 = one_pool(extra_pool_flat, extra_indices, extra_topk_length)
        o, lse = merge_state(o, lse, o2, lse2)
        # both pools empty: the merge of two -inf lses is NaN; the contract is zeros
        both = (counts(slot_indices, topk_length).to(dev) == 0) & (counts(extra_indices, extra_topk_length).to(dev) == 0)
        o = torch.where(both[:, None, None], 0.0, o)
        lse = torch.where(both[:, None], float("-inf"), lse)
    if attn_sink is not None:
        o = apply_sinks(o, lse, attn_sink)
        if return_lse:
            lse = lse + torch.log1p(torch.exp2(attn_sink[None, :].float() * LOG2E - lse)) * LOG2E
    o = o.to(q_nope.dtype)
    return (o, lse) if return_lse else o


def sparse_mla_prefill(q_nope, q_pe, kv_pool_flat, slot_indices, *, sm_scale: Optional[float] = None):
    """Per-token index sets: q_nope [T, H, 512], q_pe [T, H, 64],
    slot_indices [T, K]; the decode function over T query rows."""
    return sparse_mla_decode(q_nope, q_pe, kv_pool_flat, slot_indices, sm_scale=sm_scale)


def fused_k_indexer_norm_rope_quant_store(k, positions, cos_sin_cache, norm_weight, idx_cache, idx_scale_cache,
                                          slot_loc, *, eps: float = 1e-6):
    """The indexer key of each token: rmsnorm, neox RoPE, the Hadamard
    rotation (1/sqrt(D)), per-token fp8 e4m3, then stored at ``slot_loc``
    (-1 and slots past the pool dropped) IN PLACE into idx_cache [S, D] and
    idx_scale_cache [S] (JAX donates them). k [T, D]. Returns the two pools."""
    t, d = k.shape
    kn = rmsnorm(k, norm_weight, eps)
    k_rot, _ = rotary_embedding(positions, kn[:, None, :], None, d, cos_sin_cache)
    k8, scale = per_token_quant_fp8(hadamard_transform(k_rot[:, 0], scale=1.0 / d ** 0.5))
    store_cache_mla(k8, idx_cache.view(-1, 1, d), slot_loc)
    store_cache_mla(scale.reshape(t, 1), idx_scale_cache.view(-1, 1, 1), slot_loc)
    return idx_cache, idx_scale_cache


def fused_q_indexer_rope_hadamard_quant(q, positions, cos_sin_cache):
    """The indexer query: neox RoPE, the Hadamard rotation (1/sqrt(D)), then
    per-token fp8 e4m3. q [T, H, D]; returns (q_fp8, scales [T, H, 1])."""
    d = q.shape[-1]
    q_rot, _ = rotary_embedding(positions, q, None, d, cos_sin_cache)
    return per_token_quant_fp8(hadamard_transform(q_rot, scale=1.0 / d ** 0.5))
