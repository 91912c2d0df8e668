"""Grouped (per-expert) GEMMs over expert-sorted, block-aligned rows.

``w4a16_grouped_mm`` is kernel K11, replacing the Pallas
``w4a16_grouped_mm`` (sgl_kernel_tpu/ops/moe/grouped_gemm.py:259,
pallas_call at :419): at bm 16 / 32 (decode) the W4A16 streaming core
(``csrc/w4a16_grouped_decode.cu``, ``ops/gemm/w4a16_stream.py``), its units
counted on the device from ``num_valid_blocks``; at bm 64 / 128 K1's wgmma
tile (``csrc/w4a16_wgmma.cu``), per-channel scales included; for
per-channel scales at bm 16 / 32 and banks TMA cannot map, CUDA C++ in
``csrc/grouped_gemm.cu`` on the mma.sync tile (``grouped_route`` names
the choice). ``w4a16_grouped_mm_ref`` is its
plain twin: K1's twin (ops/gemm/w4a16.py) per valid row block, so the two
differ only by summation order.

``bf16_grouped_mm`` is kernel K12, CUDA C++ in ``csrc/bf16_grouped_gemm.cu``,
replacing the Pallas ``bf16_grouped_mm`` (grouped_gemm.py:107, pallas_call
at :175); ``bf16_grouped_mm_ref`` is its plain twin. ``ragged_grouped_mm``
is ``jax.lax.ragged_dot`` (grouped_gemm.py:30-33, XLA, no TPU kernel) as
plain PyTorch: the CPU path of the unstacked bf16 MoE and a reference.

Row block i of ``x_sorted`` (``bm`` rows, the alignment block of
ops/moe/align.py) takes expert ``block_expert_ids[i]``; blocks at or past
``num_valid_blocks`` are padding and their output rows are undefined
(grouped_gemm.py:279-282): compare valid rows only. Stacked [L, E, ...]
banks take ``layer_id``; the layer is a view, never a copy of the bank.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ... import _build
from ..gemm import w4a16_stream
from ..gemm.w4a16 import GROUPS_PER_KTILE, _gemm_ref
from ...utils import round_up, sm_count


def _valid_blocks(num_valid_blocks, n_blocks: int) -> int:
    """The valid block count as a host int (the plain twins only)."""
    if num_valid_blocks is None:
        return n_blocks
    return min(n_blocks, int(num_valid_blocks))


def _layer(t, layer_id):
    return t if t is None or layer_id is None else t[int(layer_id)]


def _grouped_operands(x_sorted, w, scales, zeros, layer_id, *, group_size, bm, per_channel):
    """Check the contract (grouped_gemm.py:306-356) and select the layer.
    Returns (w, scales, zeros, k, k_pad) with [E, ...] weight operands;
    ``per_channel`` [E, 1, N] scales and zeros are expanded to every group."""
    cap, k = x_sorted.shape
    stacked = layer_id is not None
    if w.ndim != (4 if stacked else 3) or w.dtype != torch.uint8:
        raise ValueError(f"w4a16_grouped_mm: w {tuple(w.shape)} {w.dtype} (stacked={stacked})")
    if cap % bm:
        raise ValueError(f"w4a16_grouped_mm: {cap} rows are not a multiple of bm={bm}")
    k_pad = w.shape[-2] * 2
    if k_pad != k and not k < k_pad <= round_up(k, GROUPS_PER_KTILE * group_size):
        raise ValueError(f"w4a16_grouped_mm: activations of K={k} for packed K={k_pad}")
    if k_pad % group_size:
        raise ValueError(f"w4a16_grouped_mm: K={k_pad} is not a multiple of group {group_size}")
    w, scales, zeros = _layer(w, layer_id), _layer(scales, layer_id), _layer(zeros, layer_id)
    e, n = w.shape[0], w.shape[-1]
    if per_channel:
        if scales.shape != (e, 1, n) or (zeros is not None and zeros.shape != (e, 1, n)):
            raise ValueError(f"w4a16_grouped_mm: per_channel scales {tuple(scales.shape)} for {(e, 1, n)}")
        scales = scales.expand(e, k_pad // group_size, n)
        zeros = None if zeros is None else zeros.expand(e, k_pad // group_size, n)
    if tuple(scales.shape) != (e, k_pad // group_size, n):
        raise ValueError(f"w4a16_grouped_mm: scales {tuple(scales.shape)} for K={k_pad}, group {group_size}")
    if zeros is not None and zeros.shape != scales.shape:
        raise ValueError(f"w4a16_grouped_mm: zeros {tuple(zeros.shape)} vs scales {tuple(scales.shape)}")
    return w, scales, zeros, k, k_pad


def w4a16_grouped_mm_ref(x_sorted, w, scales, block_expert_ids, zeros=None, layer_id=None,
                         num_valid_blocks=None, *, group_size: int = 128, fmt: str = "int4", bm: int = 128,
                         bn: Optional[int] = None, bk: Optional[int] = None, out_dtype=None,
                         per_channel: bool = False, gmode: Optional[str] = None):
    """Plain twin of ``w4a16_grouped_mm``: K1's twin on each run of valid
    row blocks of one expert; rows of padding blocks come out zero."""
    w, scales, zeros, k, k_pad = _grouped_operands(x_sorted, w, scales, zeros, layer_id, group_size=group_size,
                                                   bm=bm, per_channel=per_channel)
    cap = x_sorted.shape[0]
    out_dtype = out_dtype or x_sorted.dtype
    out = torch.zeros((cap, w.shape[-1]), dtype=out_dtype, device=x_sorted.device)
    nv = _valid_blocks(num_valid_blocks, cap // bm)
    eids = block_expert_ids.tolist()[:nv]
    i = 0
    while i < nv:
        j = i
        while j < nv and eids[j] == eids[i]:
            j += 1
        e, rows = eids[i], slice(i * bm, j * bm)
        out[rows] = _gemm_ref(x_sorted[rows], None, w[e], scales[e], None if zeros is None else zeros[e], None,
                              None, None, k, k_pad, norm_eps=0.0, group_size=group_size, fmt=fmt,
                              out_dtype=out_dtype)
        i = j
    return out


# row tiles of the kernel (csrc/w4a16_tile.cuh): 0 = 16 x 128, 1 = 32 x 128,
# 2 = 64 x 64
def _tile(bm: int) -> int:
    return 0 if bm == 16 else (1 if bm == 32 else 2)


def grouped_route(bm: int, n: int, k_pad: int, per_channel: bool, *banks) -> str:
    """The kernel a K11 call takes: ``"stream"`` (bm 16 / 32, group scales,
    a bank TMA maps: ``w4a16_stream.mappable``), ``"wgmma"`` (bm 64 / 128 on
    the wgmma tile, whose maps need N a multiple of 16, 16-byte aligned codes,
    8-byte aligned scale and zero rows and K in 128-deep stages, the last of
    which may be half deep: K a multiple of 64, as gpt-oss's 2,880) or
    ``"tile"`` (the mma.sync tile, ``csrc/grouped_gemm.cu``: the rest)."""
    if bm in (16, 32):
        return "stream" if not per_channel and w4a16_stream.mappable(n, *banks) else "tile"
    w, scales, zeros = banks
    ok = (n % 16 == 0 and k_pad % 64 == 0 and w.data_ptr() % 16 == 0
          and all(t is None or t.data_ptr() % 8 == 0 for t in (scales, zeros)))
    return "wgmma" if ok else "tile"


_ARGS = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 8 + (ctypes.c_longlong,) * 2 + (ctypes.c_int,) * 4
         + (ctypes.c_void_p,))


_DEC_ARGS = (ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 14 + (ctypes.c_void_p,)


@functools.cache
def _entry():
    return _build.bind("grouped_gemm", "skt_w4a16_grouped_mm", _ARGS)


@functools.cache
def _decode_entry():
    return _build.bind("w4a16_grouped_decode", "skt_w4a16_grouped_decode", _DEC_ARGS)


_WG_ARGS = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 8 + (ctypes.c_longlong,) * 2 + (ctypes.c_int,) * 3
            + (ctypes.c_void_p,))


@functools.cache
def _wgmma_entry():
    return _build.bind("w4a16_wgmma", "skt_w4a16_wgmma_grouped", _WG_ARGS)


def w4a16_grouped_mm(x_sorted, w, scales, block_expert_ids, zeros=None, layer_id=None, num_valid_blocks=None, *,
                     group_size: int = 128, fmt: str = "int4", bm: int = 128, bn: Optional[int] = None,
                     bk: Optional[int] = None, out_dtype=None, per_channel: bool = False,
                     gmode: Optional[str] = None):
    """Block-aligned grouped W4A16 GEMM. x_sorted [cap, K] (cap a multiple of
    ``bm``); w [E, K/2, N] packed uint8, or the stacked [L, E, K/2, N] with
    ``layer_id``; scales [E, K/G, N] (per_channel: [E, 1, N] for every
    group); zeros optional (z*s); block_expert_ids [cap // bm] int32;
    num_valid_blocks a 0-d int32 tensor (or int), default every block.
    Returns [cap, N] in ``out_dtype`` (default x's dtype); rows of blocks at
    or past num_valid_blocks are undefined.

    CUDA tensors go through the K11 kernel, which takes bf16 activations,
    scales and zeros, groups of 32, 64 or 128, bm of 16, 32, 64 or 128 and
    a bf16 or float32 output; it reads num_valid_blocks on the device. bm
    16 / 32 take the streaming core where TMA maps the bank (N % 16 == 0,
    dense, 16-byte aligned) and the scales are per group; the rest the
    tile kernel of ``csrc/grouped_gemm.cu``. ``bn``, ``bk`` and ``gmode``
    are contract-only: they chose the TPU kernel's tiles and per-group
    decode schedule."""
    if fmt not in ("int4", "mxfp4"):
        raise ValueError(f"w4a16_grouped_mm: fmt must be 'int4' or 'mxfp4', got {fmt!r}")
    if x_sorted.device.type != "cuda":
        return w4a16_grouped_mm_ref(x_sorted, w, scales, block_expert_ids, zeros, layer_id, num_valid_blocks,
                                    group_size=group_size, fmt=fmt, bm=bm, out_dtype=out_dtype,
                                    per_channel=per_channel)
    w_, s_, z_, k, k_pad = _grouped_operands(x_sorted, w, scales, zeros, layer_id, group_size=group_size, bm=bm,
                                             per_channel=per_channel)
    bf = torch.bfloat16
    out_dtype = out_dtype or x_sorted.dtype
    if group_size not in (32, 64, 128) or bm not in (16, 32, 64, 128):
        raise NotImplementedError(f"w4a16_grouped_mm: the CUDA kernel takes groups of 32/64/128 and bm "
                                  f"16/32/64/128, not {group_size} / {bm}")
    if out_dtype not in (bf, torch.float32) or any(t is not None and t.dtype != bf for t in (x_sorted, s_, z_)):
        raise NotImplementedError("w4a16_grouped_mm: the CUDA kernel takes bf16 activations, scales and zeros "
                                  "and writes bf16 or float32")
    cap, n = x_sorted.shape[0], w_.shape[-1]
    out = torch.empty((cap, n), dtype=out_dtype, device=x_sorted.device)
    if cap == 0:
        return out
    x = x_sorted if x_sorted.stride(1) == 1 else x_sorted.contiguous()
    eids = block_expert_ids.to(device=x.device, dtype=torch.int32).contiguous()
    if eids.shape[0] != cap // bm:
        raise ValueError(f"w4a16_grouped_mm: {eids.shape[0]} block expert ids for {cap // bm} blocks")
    nv = num_valid_blocks if num_valid_blocks is not None else cap // bm
    nv = torch.as_tensor(nv, dtype=torch.int32, device=x.device).reshape(())
    ptr = lambda t: t.data_ptr() if t is not None else None
    vec_a = x.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0
    banks = (w, scales, zeros)  # as they lie: [L, E, ...] with the layer a coordinate, or [E, ...]
    way = grouped_route(bm, n, k_pad, per_channel, *((w_, s_, z_) if bm in (64, 128) else banks))
    w4a16_grouped_mm.launches_by_route[way] += 1
    if way == "wgmma":
        # the layer's [E, K/2, N] codes (a view); scales and zeros by their
        # strides, per-channel ones with a group stride of 0
        wl = w_ if w_.is_contiguous() else w_.contiguous()
        if s_.stride(2) != 1 or s_.stride(0) % 4 or s_.stride(1) % 4 or (
                z_ is not None and z_.stride() != s_.stride()):
            s_, z_ = s_.contiguous(), None if z_ is None else z_.contiguous()
        act = None
        if x.data_ptr() % 16 or x.stride(0) % 8:  # rows TMA cannot map: the rows pass copies them
            act = torch.empty((cap, k_pad), dtype=bf, device=x.device)
        asum = None if z_ is None else torch.empty(((k_pad // group_size) * cap,), dtype=torch.float32,
                                                    device=x.device)
        _build.check(_wgmma_entry()(
            ptr(x), ptr(wl), ptr(s_), ptr(z_), ptr(eids), ptr(nv), ptr(act), ptr(asum), ptr(out), cap, n, k_pad, k,
            x.stride(0), group_size, bm, wl.shape[0], s_.stride(0), s_.stride(1), int(fmt == "mxfp4"),
            int(out_dtype == torch.float32), int(vec_a), _build.stream_ptr(x.device)), "w4a16_grouped_mm")
        w4a16_grouped_mm.launches += 1
        return out
    if way == "stream":
        layers, experts, layer = (w.shape[0], w.shape[1], int(layer_id)) if layer_id is not None else (1, w.shape[0], 0)
        n_sm = sm_count(x.device.index or 0)
        blocks = w4a16_stream.grid(n_sm)
        act, asum, partial, counters = w4a16_stream.workspaces(x.device, cap, k_pad, group_size, bm,
                                                               (cap // bm) * w4a16_stream.tiles(n), blocks)
        _build.check(_decode_entry()(ptr(x), ptr(w), ptr(scales), ptr(zeros), ptr(eids), ptr(nv), ptr(out),
                                     ptr(act), ptr(asum), ptr(partial), ptr(counters), cap, n, k_pad, k, x.stride(0),
                                     layers, experts, layer, group_size, bm, blocks, int(fmt == "mxfp4"),
                                     int(out_dtype == torch.float32), int(vec_a), _build.stream_ptr(x.device)),
                     "w4a16_grouped_mm")
        w4a16_grouped_mm.launches += 1
        return out
    w_, s_ = w_.contiguous(), s_.contiguous()
    z_ = None if z_ is None else z_.contiguous()
    vec_w = n % 16 == 0 and all(t is None or t.data_ptr() % 16 == 0 for t in (w_, s_, z_))
    _build.check(_entry()(ptr(x), ptr(w_), ptr(s_), ptr(z_), ptr(eids), ptr(nv), ptr(out), cap, n, k_pad, k,
                          x.stride(0), group_size, _tile(bm), bm, w_[0].numel(), s_[0].numel(),
                          int(fmt == "mxfp4"), int(out_dtype == torch.float32), int(vec_a), int(vec_w),
                          _build.stream_ptr(x.device)), "w4a16_grouped_mm")
    w4a16_grouped_mm.launches += 1
    return out


w4a16_grouped_mm.launches = 0
# launches by kernel (``grouped_route``): the streaming core, the wgmma tile, the mma.sync tile
w4a16_grouped_mm.launches_by_route = {"stream": 0, "wgmma": 0, "tile": 0}


def ragged_grouped_mm(x_sorted, weights, group_sizes):
    """bf16 grouped GEMM over rows sorted by expert (``jax.lax.ragged_dot``):
    x_sorted [M, K], weights [E, K, N], group_sizes [E]; the first
    group_sizes[0] rows take expert 0, the next group_sizes[1] expert 1, and
    so on; rows past the total come out zero. Float32 products rounded once
    to x's dtype. Plain PyTorch with host reads of the sizes."""
    out = torch.zeros((x_sorted.shape[0], weights.shape[-1]), dtype=x_sorted.dtype, device=x_sorted.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            out[start: start + n] = (x_sorted[start: start + n].float() @ weights[e].float()).to(out.dtype)
        start += n
    return out


def _bf16_operands(x_sorted, w, layer_id, bm):
    cap, k = x_sorted.shape
    wl = _layer(w, layer_id)
    if w.ndim != (3 if layer_id is None else 4) or wl.shape[1] != k or cap % bm:
        raise ValueError(f"bf16_grouped_mm: x {tuple(x_sorted.shape)} w {tuple(w.shape)} bm {bm} "
                         f"(stacked={layer_id is not None})")
    return wl


def bf16_grouped_mm_ref(x_sorted, w, block_expert_ids, layer_id=None, num_valid_blocks=None, *, bm: int = 128,
                        bn: Optional[int] = None, bk: Optional[int] = None, out_dtype=None):
    """Plain twin of ``bf16_grouped_mm``: each run of valid row blocks of one
    expert times its [K, N] weight, float32 accumulation, one rounding; rows
    of padding blocks come out zero."""
    wl = _bf16_operands(x_sorted, w, layer_id, bm)
    out_dtype = out_dtype or x_sorted.dtype
    out = torch.zeros((x_sorted.shape[0], wl.shape[-1]), dtype=out_dtype, device=x_sorted.device)
    nv = _valid_blocks(num_valid_blocks, x_sorted.shape[0] // bm)
    eids = block_expert_ids.tolist()[:nv]
    i = 0
    while i < nv:
        j = i
        while j < nv and eids[j] == eids[i]:
            j += 1
        rows = slice(i * bm, j * bm)
        out[rows] = (x_sorted[rows].float() @ wl[eids[i]].float()).to(out_dtype)
        i = j
    return out


_BF16_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                             ctypes.c_void_p)


@functools.cache
def _bf16_entry():
    return _build.bind("bf16_grouped_gemm", "skt_bf16_grouped_mm", _BF16_ARGS)


def bf16_grouped_mm(x_sorted, w, block_expert_ids, layer_id=None, num_valid_blocks=None, *, bm: int = 128,
                    bn: Optional[int] = None, bk: Optional[int] = None, out_dtype=None):
    """Block-aligned grouped bf16 GEMM. x_sorted [cap, K] (cap a multiple of
    ``bm``); w [E, K, N], or the stacked [L, E, K, N] with ``layer_id``;
    block_expert_ids [cap // bm] int32; num_valid_blocks a 0-d int32 tensor
    (or int), default every block. Returns [cap, N] in ``out_dtype``
    (default x's dtype); rows of blocks at or past num_valid_blocks are
    undefined.

    CUDA tensors go through the K12 kernel, which takes bf16 x and w, K and
    N multiples of 8, bm of 16, 32, 64 or 128 and a bf16 or float32 output;
    it reads num_valid_blocks on the device. ``bn`` and ``bk`` are
    contract-only: they chose the TPU kernel's VMEM tiles."""
    if x_sorted.device.type != "cuda":
        return bf16_grouped_mm_ref(x_sorted, w, block_expert_ids, layer_id, num_valid_blocks, bm=bm,
                                   out_dtype=out_dtype)
    wl = _bf16_operands(x_sorted, w, layer_id, bm)
    bf = torch.bfloat16
    out_dtype = out_dtype or x_sorted.dtype
    cap, k = x_sorted.shape
    n = wl.shape[-1]
    if bm not in (16, 32, 64, 128):
        raise NotImplementedError(f"bf16_grouped_mm: the CUDA kernel takes bm 16/32/64/128, not {bm}")
    if x_sorted.dtype != bf or wl.dtype != bf or out_dtype not in (bf, torch.float32):
        raise NotImplementedError("bf16_grouped_mm: the CUDA kernel takes bf16 x and w and writes bf16 or float32")
    if k % 8 or n % 8:
        raise NotImplementedError(f"bf16_grouped_mm: the CUDA kernel takes K and N multiples of 8, not {k} / {n}")
    out = torch.empty((cap, n), dtype=out_dtype, device=x_sorted.device)
    if cap == 0:
        return out
    x = x_sorted.contiguous()
    if x.data_ptr() % 16:  # the kernel copies 16-byte rows with cp.async
        x = x.clone()
    wl = wl.contiguous()
    if wl.data_ptr() % 16:
        raise ValueError("bf16_grouped_mm: the weight bank must start at a 16-byte boundary")
    eids = block_expert_ids.to(device=x.device, dtype=torch.int32).contiguous()
    if eids.shape[0] != cap // bm:
        raise ValueError(f"bf16_grouped_mm: {eids.shape[0]} block expert ids for {cap // bm} blocks")
    nv = num_valid_blocks if num_valid_blocks is not None else cap // bm
    nv = torch.as_tensor(nv, dtype=torch.int32, device=x.device).reshape(())
    _build.check(_bf16_entry()(x.data_ptr(), wl.data_ptr(), eids.data_ptr(), nv.data_ptr(), out.data_ptr(), cap, n,
                               k, x.stride(0), bm, wl[0].numel(), wl.shape[0], int(out_dtype == torch.float32),
                               _build.stream_ptr(x.device)), "bf16_grouped_mm")
    bf16_grouped_mm.launches += 1
    return out


bf16_grouped_mm.launches = 0


def w4a8_grouped_mm(x_q, x_scales, w, w_scales, block_expert_ids, w_szeros=None, x_sums=None, *, bm: int = 128,
                    bn: Optional[int] = None, bk: Optional[int] = None, out_dtype=torch.bfloat16):
    """Block-aligned grouped W4A8 GEMM for MoE (grouped_gemm.py:479-527): int8
    activations against int4 expert weights, per-channel weight scales,
    per-token activation scales, optional zeros by the rank-1 sum
    correction. x_q [cap, K] int8 (expert-sorted, block-aligned); x_scales
    [cap]; w [E, K//2, N] packed int4 (``pack_w4_tpu``); w_scales [E, N];
    w_szeros [E, N] = zero * s1 or None. ``x_sums`` is accepted and unused,
    as in JAX (the zero term sums x_q itself). Returns [cap, N] in
    ``out_dtype``.

    As in JAX, not a kernel of its own: K11 (``w4a16_grouped_mm``, every row
    block) takes the int8 codes as bf16 (exact) against unit per-channel
    scales, so its float32 sums are the exact integer products; the
    per-channel scales, the zero term and the token scales follow in float32:
    out = (acc * s1 - sum_k(x) * zs) * x_scale, the JAX sum up to the order
    of its float32 additions. The K11 kernel on the card takes bm of 16 to
    128 (the twin any bm) and K a multiple of 32; ``bn`` and ``bk`` are
    contract-only."""
    cap, k = x_q.shape
    e, n = w.shape[0], w.shape[2]
    group = next((g for g in (128, 64, 32) if k % g == 0), k)
    ones = torch.ones((e, 1, n), dtype=torch.bfloat16, device=x_q.device)
    acc = w4a16_grouped_mm(x_q.to(torch.bfloat16), w, ones, block_expert_ids, group_size=group, bm=bm,
                           out_dtype=torch.float32, per_channel=True)
    eids = block_expert_ids.to(device=x_q.device, dtype=torch.long)
    out = acc.view(cap // bm, bm, n) * w_scales.float()[eids][:, None, :]
    if w_szeros is not None:
        asum = x_q.float().sum(-1).view(cap // bm, bm, 1)
        out = out - asum * w_szeros.float()[eids][:, None, :]
    return (out.view(cap, n) * x_scales.float()[:, None]).to(out_dtype)
