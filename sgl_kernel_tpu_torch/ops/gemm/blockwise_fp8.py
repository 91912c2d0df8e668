"""FP8 blockwise-scaled GEMMs (DeepSeek-style 1x128 / 128x128 scale blocks).

``fp8_blockwise_scaled_mm`` is kernel K17 and ``fp8_blockwise_scaled_grouped_mm``
kernel K18, one CUDA C++ source, ``csrc/blockwise_fp8.cu``, replacing the
Pallas ``fp8_blockwise_scaled_mm`` (sgl_kernel_tpu/ops/gemm/blockwise_fp8.py:268,
pallas_call at :310) and ``fp8_blockwise_scaled_grouped_mm`` (:362,
pallas_call at :403). ``*_ref`` are their plain twins. The function:

    out[m, n] = sum_g sa[m, g] * sb[g, n // 128] * (A[m, g-th 128] @ B[g-th 128, n])

The kernel multiplies the e4m3 operands natively on Hopper's warpgroup
MMA (wgmma e4m3, float32 accumulation), computing the tile transposed (the
weights as wgmma's M, from registers; the activation rows as its N), one
128-deep scale group at a time, and promotes each k32 step's partial into
a float32 accumulator with the group's two scales (DeepSeek's promotion,
every 32 k rather than 128: on the card a longer partial loses bits).
Blocks follow ``work_order``'s raster, and K splits over blocks by
``split_plan`` in the same launch. It converts every e4m3 code exactly,
subnormals included; JAX flushes subnormals, reads the NaN bytes as
+-480 and rounds a * sa to bf16 before its dot (blockwise_fp8.py:46-52,
:189): on normal codes the two differ by that bf16 rounding only.

``prepare_blockwise_scales`` returns JAX's bytes: the scale rows expanded to
[.., K/128, N] with the TPU's 2^120 decode rebias folded in. Both functions
take the compact or the prepared form; a prepared row is read times 2^-120
(exact).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ... import _build
from ...utils import OUT_KIND, cdiv, kept_buffer, row_tile, sm_count

BLOCK = 128
REBIAS = 2.0 ** 120  # the TPU's e4m3 -> bf16 exponent rebias, carried by prepared scales
RASTER_ROWS = 8  # row tiles a raster group walks down each column tile (csrc/blockwise_fp8.cu)

def prepare_blockwise_scales(scales_b, *, rebias: bool = True):
    """[.., K/128, N/128] float32 -> [.., K/128, N] float32 scale rows, each
    repeated over its 128 columns, times 2^120 when ``rebias``."""
    out = torch.repeat_interleave(scales_b.float(), BLOCK, dim=-1)
    return out * REBIAS if rebias else out


def _scales_b(scales_b, lead, k: int, n: int, name: str):
    """(scales as float32, columns per entry, multiplier): the compact
    [.., K/128, N/128] form (128, 1) or the prepared [.., K/128, N] (1, 2^-120)."""
    if tuple(scales_b.shape) == (*lead, k // BLOCK, n // BLOCK):
        return scales_b.float(), BLOCK, 1.0
    if tuple(scales_b.shape) == (*lead, k // BLOCK, n):
        return scales_b.float(), 1, 1.0 / REBIAS
    raise ValueError(f"{name}: scales_b must be compact {(*lead, k // BLOCK, n // BLOCK)} or prepared "
                     f"{(*lead, k // BLOCK, n)}, got {tuple(scales_b.shape)}")


def _check(a, k: int, n: int, scales_a, name: str):
    m = a.shape[0]
    if k % BLOCK or n % BLOCK:
        raise ValueError(f"{name}: K={k} and N={n} must be multiples of {BLOCK}")
    if tuple(scales_a.shape) != (m, k // BLOCK):
        raise ValueError(f"{name}: scales_a must be [M, K/128]={(m, k // BLOCK)}, got {tuple(scales_a.shape)}")


def _blockwise_ref(a, b, sa, sb, div: int, mul: float):
    """Plain float32 sum over the 128-deep groups of A [M, K] and B [K, N]:
    each group's product times sa[:, g] and its row of B scales."""
    m, k = a.shape
    n = b.shape[1]
    af, bf = a.float(), b.float()
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for g in range(k // BLOCK):
        ks = slice(g * BLOCK, (g + 1) * BLOCK)
        row = sb[g] if div == 1 else torch.repeat_interleave(sb[g], BLOCK)
        acc = acc + (af[:, ks] @ bf[ks]) * (sa[:, g: g + 1] * (row * mul)[None, :])
    return acc


def fp8_blockwise_scaled_mm_ref(a, b, scales_a, scales_b, out_dtype=torch.bfloat16, *, bm: Optional[int] = None,
                                bn: Optional[int] = None, bk: Optional[int] = None, decode: Optional[str] = None,
                                gmode: Optional[str] = None):
    """Plain twin of ``fp8_blockwise_scaled_mm``: exact operands (fp8 or any
    float A), float32 products and promotion, one rounding to ``out_dtype``."""
    k, n = b.shape
    _check(a, k, n, scales_a, "fp8_blockwise_scaled_mm")
    sb, div, mul = _scales_b(scales_b, (), k, n, "fp8_blockwise_scaled_mm")
    return _blockwise_ref(a, b, scales_a.float(), sb, div, mul).to(out_dtype)


def fp8_blockwise_scaled_grouped_mm_ref(a, b, scales_a, scales_b, expert_ids, out_dtype=torch.bfloat16, *,
                                        bm: int = 128, bn: Optional[int] = None, bk: Optional[int] = None,
                                        decode: str = "pair", gmode: str = "inner"):
    """Plain twin of ``fp8_blockwise_scaled_grouped_mm``: each run of row
    blocks of one expert through the plain blockwise product."""
    e, k, n = b.shape
    eids = _grouped_check(a, b, scales_a, expert_ids, bm)
    sb, div, mul = _scales_b(scales_b, (e,), k, n, "fp8_blockwise_scaled_grouped_mm")
    sa = scales_a.float()
    out = torch.empty((a.shape[0], n), dtype=out_dtype, device=a.device)
    i, ids = 0, eids.tolist()
    while i < len(ids):
        j = i
        while j < len(ids) and ids[j] == ids[i]:
            j += 1
        rows = slice(i * bm, j * bm)
        out[rows] = _blockwise_ref(a[rows], b[ids[i]], sa[rows], sb[ids[i]], div, mul).to(out_dtype)
        i = j
    return out


def _grouped_check(a, b, scales_a, expert_ids, bm: int):
    m, k = a.shape
    e, kb, n = b.shape
    name = "fp8_blockwise_scaled_grouped_mm"
    if kb != k or m % bm:
        raise ValueError(f"{name}: A {tuple(a.shape)}, B {tuple(b.shape)}, bm {bm}")
    _check(a, k, n, scales_a, name)
    if tuple(expert_ids.shape) != (m // bm,):
        raise ValueError(f"{name}: expert_ids is one id per row block, [M/bm]={(m // bm,)}, got "
                         f"{tuple(expert_ids.shape)}")
    return expert_ids


def tile_cols(block_rows: int) -> int:
    """Columns of the kernel's tile for a row tile: 256 (four consumer
    warpgroups) at 16 / 32 rows, 128 (two) at 64 / 128."""
    return 256 if block_rows <= 32 else 128


def work_order(m_tiles: int, n_tiles: int):
    """The kernel's raster: the (row tile, column tile) of each block index.
    Groups of RASTER_ROWS row tiles walk down each column tile in turn, so
    the row tiles of one expert (consecutive in the sorted rows) read each
    slice of its bank at about the same time."""
    order = []
    for first in range(0, m_tiles, RASTER_ROWS):
        rows = min(RASTER_ROWS, m_tiles - first)
        order += [(first + i % rows, i // rows) for i in range(rows * n_tiles)]
    return order


def split_plan(tiles: int, n_groups: int, n_sm: int):
    """(split, groups_per_split): with fewer tiles than SMs, K splits over
    blocks in whole 128-deep groups so the blocks fill the SMs once (a block
    an SM: its ring takes most of the shared memory); every split non-empty."""
    if tiles >= n_sm:
        return 1, n_groups
    per = cdiv(n_groups, max(1, min(n_groups, n_sm // tiles)))
    return cdiv(n_groups, per), per


_ARGS = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 4 + (ctypes.c_longlong,) + (ctypes.c_int,) * 2
         + (ctypes.c_float,) + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))


@functools.cache
def _entry():
    return _build.bind("blockwise_fp8", "skt_fp8_blockwise_mm", _ARGS)


def _launch(a, b, sa, sb, div, mul, eids, out_dtype, block_rows: int):
    """One launch of the kernel over A [M, K] and B [K, N] (or the bank [E,
    K, N] with ``eids``, one expert a row block of ``block_rows``); a split
    K's partials and arrival counters live in kept buffers, so a call
    allocates nothing but its output and can be captured in a CUDA graph."""
    m, k = a.shape
    n = b.shape[-1]
    dev = a.device
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    a = a.contiguous()
    b, sa, sb = b.contiguous(), sa.float().contiguous(), sb.contiguous()
    tiles = cdiv(n, tile_cols(block_rows)) * cdiv(m, block_rows)
    split, per = split_plan(tiles, k // BLOCK, sm_count(dev.index or 0))
    ws = counters = None
    if split > 1:
        ws = kept_buffer("fp8_blockwise_ws", dev, split * m * n, torch.float32)
        counters = kept_buffer("fp8_blockwise_counters", dev, tiles, torch.int32)
    ptr = lambda t: t.data_ptr() if t is not None else None
    grouped = eids is not None
    _build.check(_entry()(ptr(a), ptr(b), ptr(sa), ptr(sb), ptr(eids), ptr(out), ptr(ws), ptr(counters), m, n, k,
                          a.stride(0), sb[0].numel() if grouped else 0, sb.shape[-1], div, mul, block_rows,
                          b.shape[0] if grouped else 1, OUT_KIND[out_dtype], split, per, _build.stream_ptr(dev)),
                 "fp8_blockwise_scaled_mm")
    return out


def _card_check(a, b, out_dtype, name: str):
    if a.dtype != torch.float8_e4m3fn or b.dtype != torch.float8_e4m3fn:
        raise NotImplementedError(f"{name}: the CUDA kernel takes float8_e4m3fn A and B, not {a.dtype} / {b.dtype}")
    if out_dtype not in OUT_KIND:
        raise NotImplementedError(f"{name}: the CUDA kernel writes bf16, float16 or float32, not {out_dtype}")


def fp8_blockwise_scaled_mm(a, b, scales_a, scales_b, out_dtype=torch.bfloat16, *, bm: Optional[int] = None,
                            bn: Optional[int] = None, bk: Optional[int] = None, decode: Optional[str] = None,
                            gmode: Optional[str] = None):
    """A [M, K] fp8, B [K, N] fp8, scales_a [M, K/128] float32, scales_b
    [K/128, N/128] float32 or prepared [K/128, N] (``prepare_blockwise_scales``).
    Returns [M, N] in ``out_dtype``.

    CUDA tensors go through the K17 kernel, which takes float8_e4m3fn A and
    B (K and N multiples of 128) and writes bf16, float16 or float32; the
    plain twin also takes a float A. ``bm``, ``bn``, ``bk``, ``decode`` and
    ``gmode`` are contract-only: they chose the TPU kernel's tiles, its
    bit-level fp8 decode and its per-group schedule."""
    if a.device.type != "cuda":
        return fp8_blockwise_scaled_mm_ref(a, b, scales_a, scales_b, out_dtype)
    k, n = b.shape
    _check(a, k, n, scales_a, "fp8_blockwise_scaled_mm")
    sb, div, mul = _scales_b(scales_b, (), k, n, "fp8_blockwise_scaled_mm")
    _card_check(a, b, out_dtype, "fp8_blockwise_scaled_mm")
    if a.shape[0] == 0:
        return torch.empty((0, n), dtype=out_dtype, device=a.device)
    out = _launch(a, b, scales_a, sb, div, mul, None, out_dtype, row_tile(a.shape[0]))
    fp8_blockwise_scaled_mm.launches += 1
    return out


fp8_blockwise_scaled_mm.launches = 0


def fp8_blockwise_scaled_grouped_mm(a, b, scales_a, scales_b, expert_ids, out_dtype=torch.bfloat16, *,
                                    bm: int = 128, bn: Optional[int] = None, bk: Optional[int] = None,
                                    decode: str = "pair", gmode: str = "inner"):
    """Grouped blockwise-fp8 GEMM for MoE. a [M, K] fp8, rows sorted by
    expert and padded so each ``bm``-row block belongs to one expert (the
    ops/moe/align.py layout); b [E, K, N] fp8; scales_a [M, K/128];
    scales_b [E, K/128, N/128] (or prepared [E, K/128, N]); expert_ids
    [M/bm] int32, the expert of each row block. Every row block is computed
    (there is no valid-block count). Returns [M, N] in ``out_dtype``.

    CUDA tensors go through the K18 kernel (K17's tile with the expert read
    per row block, the tile's rows being the alignment block), which takes float8_e4m3fn A and B and bm of 16, 32, 64
    or 128. ``bn``, ``bk``, ``decode`` and ``gmode`` are contract-only."""
    if a.device.type != "cuda":
        return fp8_blockwise_scaled_grouped_mm_ref(a, b, scales_a, scales_b, expert_ids, out_dtype, bm=bm)
    e, k, n = b.shape
    _grouped_check(a, b, scales_a, expert_ids, bm)
    sb, div, mul = _scales_b(scales_b, (e,), k, n, "fp8_blockwise_scaled_grouped_mm")
    _card_check(a, b, out_dtype, "fp8_blockwise_scaled_grouped_mm")
    if bm not in (16, 32, 64, 128):
        raise NotImplementedError(f"fp8_blockwise_scaled_grouped_mm: the CUDA kernel takes bm 16/32/64/128, not {bm}")
    if a.shape[0] == 0:
        return torch.empty((0, n), dtype=out_dtype, device=a.device)
    eids = expert_ids.to(device=a.device, dtype=torch.int32).contiguous()
    out = _launch(a, b, scales_a, sb, div, mul, eids, out_dtype, bm)
    fp8_blockwise_scaled_grouped_mm.launches += 1
    return out


fp8_blockwise_scaled_grouped_mm.launches = 0
