"""DeepSeek MLA (multi-head latent attention).

The shape contract (mla.py:1-19 of the JAX package): D_latent 512 (kv_c,
which doubles as V), D_rope 64, D_ckv 576; q = [q_nope (in latent space) |
q_pe] per head; a cache row is [kv_c | k_pe]; pools [L, P, page, 576], or
640 wide with 64 zero lanes.

``mla_decode`` is kernel K13a, CUDA C++ in ``csrc/mla_decode.cu``,
replacing the Pallas ``mla_decode`` (sgl_kernel_tpu/ops/attention/mla.py:375,
pallas_call at :474); ``mla_decode_ref`` is its plain twin. The kernel
divides its work on the device from the lengths (one launch a call; a run
several blocks share is merged by the last of them); ``work_units`` is that
division in plain Python. ``num_splits``
is the JAX formulation (mla.py:403-426): each (sequence, split) becomes a
pseudo-sequence over its share of the pages, and ``merge_states`` joins the
partial outputs by their base-2 lse.

``engine="dma"`` takes K13b, ``mla_decode_dma`` (replacing the Pallas
``_mla_decode_dma``, mla.py:287, pallas_call at :321), by JAX's rule
(mla.py:451): for pools of 2 bytes or more and for 640-wide pools; a
one-byte 576-wide pool takes K13a. K13b computes K13a's function and
launches K13a's kernel (``csrc/mla_decode.cu``) with one flag set: a
length-0 row's lse is -inf, as on the TPU (K13a: -1e30 * log2(e)). Its
launches count on ``mla_decode_dma``, not on ``mla_decode``.
``mla_decode_dma_ref`` is its twin.

``mla_prefill`` is the flash prefill (K7) over the latent as one MQA head
(mla.py:520-557), through ``flash_attention_mla``: q's two parts are read
where they lie and V is the latent's first 512 columns, read from K's own
tile, where JAX concatenates q, zero-pads V to 576 lanes and slices the
output back; the values are the same.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ... import _build
from ...utils import kept_buffer, sm_count
from .flash_prefill import LOG2E, flash_attention_mla
from .merge_state import merge_states

D_LATENT = 512
D_ROPE = 64
D_CKV = 576
D_CKV_PAD = 640


def _check(q_nope, q_pe, kv_cache):
    if kv_cache.shape[-1] not in (D_CKV, D_CKV_PAD) or q_nope.shape[-1] != D_LATENT or q_pe.shape[-1] != D_ROPE:
        raise ValueError(f"mla_decode: q_nope {tuple(q_nope.shape)} q_pe {tuple(q_pe.shape)} "
                         f"pool {tuple(kv_cache.shape)}")


def mla_decode_ref(q_nope, q_pe, kv_cache, lengths, page_table, layer_id=None, *,
                   sm_scale: Optional[float] = None, return_lse: bool = False):
    """Plain twin of ``mla_decode`` (one split): gathers the pages the
    longest sequence uses, dense float32 scores and softmax; pool values
    convert exactly to float32. A sequence of length 0 gives o = 0 and lse
    (-1e30 + ln 1e-38) * log2(e), as the TPU kernel's clamps give."""
    _check(q_nope, q_pe, kv_cache)
    b, h, _ = q_nope.shape
    pool = kv_cache if layer_id is None else kv_cache[int(layer_id)]
    n_pages, page = pool.shape[0], pool.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / D_CKV ** 0.5
    lengths = lengths.to(q_nope.device).long()
    nb = max(1, min(page_table.shape[1], -(-int(lengths.max().clamp_min(0)) // page)))
    pt = page_table[:, :nb].to(q_nope.device).long().clamp(0, n_pages - 1)
    rows = pool[pt][..., :D_CKV].reshape(b, nb * page, D_CKV).float()  # [B, T, 576]
    q = torch.cat([q_nope, q_pe], dim=-1).float()
    s = torch.einsum("bhd,btd->bht", q, rows) * scale
    mask = torch.arange(nb * page, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~mask[:, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bht,btd->bhd", p, rows[..., :D_LATENT])
    out = torch.where(l == 0, torch.zeros_like(o), o / l).to(q_nope.dtype)
    if return_lse:
        return out, ((m + torch.log(l.clamp_min(1e-38))) * LOG2E)[..., 0]
    return out


_ARGS = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 8 + (ctypes.c_float,) + (ctypes.c_int,) * 2 + (ctypes.c_void_p,)
# pool dtypes of the kernel (csrc/mla_decode.cu)
_POOL_TYPES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}
UNIT_TOKENS = 64  # pool tokens of one unit of the card's kernel (csrc/mla_decode.cu, kTok)
HEAD_GROUP = 16  # query heads of a unit: the rows of one m16 MMA tile
MIN_SHARE = 2  # units a block of the card's kernel takes at least (csrc/mla_decode.cu, kMinShare)
_PART = HEAD_GROUP * D_LATENT + HEAD_GROUP  # floats of a block's partial (o, lse)
_BLOCKS_PER_SM = 1  # the kernel's shared memory holds one block an SM
_MAX_BATCH = 2048  # sequences a launch takes (the kernel keeps their prefix in shared memory)


def work_units(lengths, n_blocks: int, page: int, heads: int, grid: int):
    """The card kernel's division of work, in plain Python (the kernel
    computes it on the device from the lengths): sequence b holds n_b =
    min(max(length, 0), n_blocks * page) pool tokens in ceil(n_b / 64) units
    of 64 aligned tokens (one empty unit when n_b = 0), for each of
    G = ceil(heads / 16) head groups; unit u = G * pre[b] + h * n_units + j
    over sequences b, groups h and units j; of the ``grid`` blocks the first
    g = min(grid, ceil(U / 2)) take [U c / g, U (c + 1) / g) each (at least
    two units when there are two), the rest nothing.
    Returns (units, blocks, runs): units[b] = (n_b, n_units); blocks[c] =
    (u0, u1); runs[(b, h)] = (first block, last block, [the partial slot of
    each contributing block]): a run one block holds whole needs no slot,
    else slot 0 where the run is the block's first and 1 where it is its
    last."""
    groups = -(-heads // HEAD_GROUP)
    units, pre = [], [0]
    for length in lengths:
        n = max(0, min(int(length), n_blocks * page))
        cnt = -(-n // UNIT_TOKENS) if n > 0 else 1
        units.append((n, cnt))
        pre.append(pre[-1] + cnt)
    total = groups * pre[-1]
    grid = min(grid, -(-total // MIN_SHARE))
    blocks = [(total * c // grid, total * (c + 1) // grid) for c in range(grid)]
    block_of = lambda u: ((u + 1) * grid + total - 1) // total - 1
    runs = {}
    for b, (_, cnt) in enumerate(units):
        for h in range(groups):
            us = groups * pre[b] + h * cnt
            cf, cl = block_of(us), block_of(us + cnt - 1)
            slots = [] if cf == cl else [1 if c == cf and blocks[c][0] < us else 0 for c in range(cf, cl + 1)]
            runs[(b, h)] = (cf, cl, slots)
    return units, blocks, runs


def _decode_kernel(q_nope, q_pe, kv_cache, lengths, page_table, layer_id, sm_scale, return_lse, wrapper):
    """K13a's kernel, for ``wrapper`` (``mla_decode``, or K13b's
    ``mla_decode_dma``, whose length-0 rows get lse -inf), counted on it."""
    b, h, _ = q_nope.shape
    name = wrapper.__name__
    if q_nope.dtype != torch.bfloat16 or q_pe.dtype != torch.bfloat16 or kv_cache.dtype not in _POOL_TYPES:
        raise NotImplementedError(f"{name}: the CUDA kernel takes bf16 q and bf16, int8, float8_e4m3fn or "
                                  "float8_e5m2 pools")
    if not kv_cache.is_contiguous():
        raise ValueError(f"{name}: the pool must be contiguous")
    pool = kv_cache if layer_id is not None else kv_cache[None]
    lid = 0 if layer_id is None else int(layer_id)
    _, n_pages, page, width = pool.shape
    dev = q_nope.device
    q = torch.cat([q_nope, q_pe], dim=-1).contiguous()
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    table = page_table.to(device=dev, dtype=torch.int32)
    if table.shape[1] == 0:  # nothing in the pool: one padding column, no token reads it
        table = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    table = table.contiguous()
    out = torch.empty((b, h, D_LATENT), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h), dtype=torch.float32, device=dev) if return_lse else None
    ws_blocks = _BLOCKS_PER_SM * sm_count(dev.index or 0)
    ws = kept_buffer("mla_decode_ws", dev, ws_blocks * 2 * _PART, torch.float32)
    counters = kept_buffer("mla_decode_counters", dev, min(b, _MAX_BATCH) * -(-h // HEAD_GROUP), torch.int32)
    fn = _build.bind("mla_decode", "skt_mla_decode", _ARGS)
    for s0 in range(0, b, _MAX_BATCH):  # one launch for every decode batch; a long prefill's rows in chunks
        n = min(b, s0 + _MAX_BATCH) - s0
        _build.check(fn(q[s0:].data_ptr(), pool.data_ptr(), lens[s0:].data_ptr(), table[s0:].data_ptr(),
                        out[s0:].data_ptr(), None if lse is None else lse[s0:].data_ptr(), ws.data_ptr(),
                        counters.data_ptr(), n, h, n_pages, page, width, table.shape[1], lid,
                        _POOL_TYPES[kv_cache.dtype], sm_scale, int(wrapper is mla_decode_dma), ws_blocks,
                        _build.stream_ptr(dev)), name)
        wrapper.launches += 1
    return (out, lse) if return_lse else out


def mla_decode_dma_ref(q_nope, q_pe, kv_cache, lengths, page_table, layer_id=None, *,
                       sm_scale: Optional[float] = None, return_lse: bool = False):
    """Plain twin of ``mla_decode_dma``: ``mla_decode_ref``'s function, with
    lse -inf for a sequence of length 0."""
    out, lse = mla_decode_ref(q_nope, q_pe, kv_cache, lengths, page_table, layer_id, sm_scale=sm_scale,
                              return_lse=True)
    if not return_lse:
        return out
    return out, torch.where(lengths.to(lse.device)[:, None] > 0, lse, float("-inf"))


def mla_decode_dma(q_nope, q_pe, kv_cache, lengths, page_table, layer_id=None, *, sm_scale: Optional[float] = None,
                   return_lse: bool = False):
    """K13b, the streaming MLA decode (``mla_decode(engine="dma")``): the
    arguments and result of ``mla_decode``, a length-0 row's lse -inf. CUDA
    tensors take bf16 q and bf16 or one-byte (int8, fp8 e4m3, e5m2) pools,
    through K13a's kernel; CPU tensors the twin."""
    _check(q_nope, q_pe, kv_cache)
    scale = sm_scale if sm_scale is not None else 1.0 / D_CKV ** 0.5
    if q_nope.device.type != "cuda":
        return mla_decode_dma_ref(q_nope, q_pe, kv_cache, lengths, page_table, layer_id, sm_scale=scale,
                                  return_lse=return_lse)
    return _decode_kernel(q_nope, q_pe, kv_cache, lengths, page_table, layer_id, scale, return_lse, mla_decode_dma)


mla_decode_dma.launches = 0


def mla_decode(q_nope, q_pe, kv_cache, lengths, page_table, layer_id=None, *, sm_scale: Optional[float] = None,
               return_lse: bool = False, num_splits: int = 1, engine: str = "blockspec"):
    """MLA paged decode. q_nope [B, H, 512] (already in latent space); q_pe
    [B, H, 64]; kv_cache [P, page, 576 | 640], or the stacked
    [L, P, page, ...] with ``layer_id``; lengths [B] (the current token
    included); page_table [B, max_pages]. Returns out [B, H, 512] (+ lse
    [B, H] float32 base 2 with ``return_lse``).

    CUDA tensors go through K13a, which takes bf16 q and bf16, int8, fp8
    e4m3 or e5m2 pools (a quantized pool's scale folds into ``sm_scale``,
    by the caller); ``engine="dma"`` through K13b (``mla_decode_dma``) for
    pools of 2 bytes or more and 640-wide pools, else K13a."""
    if engine not in ("blockspec", "dma"):
        raise ValueError(f"mla_decode: unknown engine {engine!r}")
    _check(q_nope, q_pe, kv_cache)
    scale = sm_scale if sm_scale is not None else 1.0 / D_CKV ** 0.5
    if num_splits > 1:
        b, h, _ = q_nope.shape
        s = num_splits
        nb = page_table.shape[1]
        bps = -(-nb // s)  # pages per split
        page_table = F.pad(page_table, (0, bps * s - nb)).reshape(b * s, bps)
        page = kv_cache.shape[-2]
        local = lengths.to(q_nope.device, torch.int32)[:, None] - torch.arange(
            s, dtype=torch.int32, device=q_nope.device)[None, :] * (bps * page)
        len_s = local.clamp(0, bps * page).reshape(b * s)
        o, lse = mla_decode(q_nope.repeat_interleave(s, 0), q_pe.repeat_interleave(s, 0), kv_cache, len_s,
                            page_table, layer_id, sm_scale=scale, return_lse=True, engine=engine)
        om, lm = merge_states(o.reshape(b, s, h, D_LATENT).transpose(0, 1), lse.reshape(b, s, h).transpose(0, 1))
        if engine == "dma":
            # a length-0 row merges s lses of -inf: NaN in JAX; o = 0, lse -inf, as unsplit
            empty = lengths.to(om.device)[:, None] <= 0
            om, lm = om.masked_fill(empty[..., None], 0.0), lm.masked_fill(empty, float("-inf"))
        return (om, lm) if return_lse else om
    if engine == "dma" and (kv_cache.element_size() >= 2 or kv_cache.shape[-1] == D_CKV_PAD):
        return mla_decode_dma(q_nope, q_pe, kv_cache, lengths, page_table, layer_id, sm_scale=scale,
                              return_lse=return_lse)
    if q_nope.device.type != "cuda":
        return mla_decode_ref(q_nope, q_pe, kv_cache, lengths, page_table, layer_id, sm_scale=scale,
                              return_lse=return_lse)
    return _decode_kernel(q_nope, q_pe, kv_cache, lengths, page_table, layer_id, scale, return_lse, mla_decode)


mla_decode.launches = 0


def mla_prefill(q_nope, q_pe, kv, q_lens=None, kv_lens=None, *, sm_scale: Optional[float] = None,
                causal: bool = True, q_start=None, kv_start=None, return_lse: bool = False):
    """MLA ragged prefill. q_nope [B, S, H, 512], q_pe [B, S, H, 64], kv
    [B, Skv, 576] (latent rows before the cache). Returns [B, S, H, 512], or
    (out, lse [B, H, S] base 2) with ``return_lse``; ``q_start`` /
    ``kv_start`` offset the causal mask as in ``flash_attention``."""
    scale = sm_scale if sm_scale is not None else 1.0 / D_CKV ** 0.5
    return flash_attention_mla(q_nope, q_pe, kv[:, :, None, :].to(q_nope.dtype), q_lens, kv_lens, q_start, kv_start,
                               causal=causal, sm_scale=scale, return_lse=return_lse)
