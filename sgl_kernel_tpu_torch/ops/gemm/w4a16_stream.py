"""The W4A16 weight-streaming core of K10 and K11 at decode: its launch
geometry, its division of the work, and its workspaces.

The core (``csrc/w4a16_stream.cuh``) runs a rows pass and a GEMM whose work
is units of (row block, column tile of ``BLOCK_N``, k block of ``STAGE_K``):
K11 (``moe.w4a16_grouped_mm`` at bm 16 / 32) counts ``num_valid`` row blocks
on the device, K10 (``w4a16_gemm_dma``) one. The grid is ``BLOCKS_PER_SM``
blocks an SM whatever the shape; ``work_units`` is the kernel's division in
plain Python (``Share`` in the header), which the CPU tests hold to its
invariant: every unit taken once, each block an equal share.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ...utils import cdiv, kept_buffer

# the kernel's StreamCfg (csrc/w4a16_stream.cuh): 256 columns a tile (two
# 128-byte TMA boxes side by side), 256 k a stage, one block an SM, the units
# in ORDER_AUTO (every tile whole where that balances as well as stream-K,
# else each block's share contiguous and tile-major). The k-synchronous
# order is the one tools/w4a16_stream_probe.py also measures.
BLOCK_N, STAGE_K, BLOCKS_PER_SM = 256, 256, 1
ORDER_TILE, ORDER_KSYNC, ORDER_AUTO = 0, 1, 2


def grid(n_sm: int) -> int:
    """Blocks of a launch: from the SM count alone."""
    return BLOCKS_PER_SM * n_sm


def work_units(n_rb: int, tiles: int, n_kb: int, blocks: int, order: int = ORDER_AUTO) -> List[List[Tuple[int, int]]]:
    """Each block's units, (tile, k block) in the order it takes them; tile
    is row block * ``tiles`` + column tile; the kernel's ``Share``.
    ``ORDER_TILE``: block b takes units [W b / NB, W (b + 1) / NB) of the
    tile-major list, NB = min(blocks, W). ``ORDER_KSYNC`` first hands out
    whole tiles in rounds (block b takes tile r * blocks + b), then splits
    the last partial round's units as ``ORDER_TILE``. ``ORDER_AUTO`` hands
    out every tile whole (blocks b < tiles % blocks one round more) when the
    longest block then takes no more than half a tile's units beyond
    stream-K's, else splits as ``ORDER_TILE``."""
    tt = n_rb * tiles
    rounds, tail0, whole = 0, 0, False
    if order == ORDER_KSYNC:
        rounds = tt // blocks
        tail0 = rounds * blocks
    elif order == ORDER_AUTO and tt > 0 and cdiv(tt, blocks) * n_kb <= cdiv(tt * n_kb, blocks) + n_kb // 2:
        rounds, tail0, whole = tt // blocks, tt, True
    wt = (tt - tail0) * n_kb
    nbt = min(blocks, wt)
    out = []
    for b in range(blocks):
        r_b = rounds + (1 if whole and b < tt % blocks else 0)
        items = [(r * blocks + b, kb) for r in range(r_b) for kb in range(n_kb)]
        if b < nbt:
            items += [(tail0 + v // n_kb, v % n_kb) for v in range(wt * b // nbt, wt * (b + 1) // nbt)]
        out.append(items)
    return out


def workspaces(device, rows: int, k_pad: int, group_size: int, mp: int, counters: int, blocks: int):
    """(act, asum, partial, counters): the rows pass's bf16 rows [rows, K]
    and group sums [K / G][ld], the blocks' float32 partials of shared tiles
    and the tiles' arrival counters, each kept across calls (a captured
    graph keeps pointing at them; the counters stay zero between calls)."""
    ld = max(32, rows)
    act = kept_buffer("w4a16_stream_act", device, rows * k_pad, torch.bfloat16)
    asum = kept_buffer("w4a16_stream_asum", device, (k_pad // group_size) * ld, torch.float32)
    partial = kept_buffer("w4a16_stream_partial", device, blocks * 2 * mp * BLOCK_N, torch.float32)
    count = kept_buffer("w4a16_stream_counters", device, counters, torch.int32)
    return act, asum, partial, count


def tiles(n: int) -> int:
    return cdiv(n, BLOCK_N)


def k_blocks(k_pad: int) -> int:
    return cdiv(k_pad, STAGE_K)


def mappable(n: int, *tensors) -> bool:
    """Whether TMA maps the weight rows: N a multiple of 16 and every bank
    dense and 16-byte aligned (else the tile kernel takes the call)."""
    return n % 16 == 0 and all(t is None or (t.is_contiguous() and t.data_ptr() % 16 == 0) for t in tensors)
