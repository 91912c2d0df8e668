"""Where the 576 flash tile's time goes (K7 / K9 at head dim 576,
csrc/mla_flash_tile.cuh): a block's fixed cost against its cost a key tile.

Times, with CUDA graphs, ``flash_attention_mla`` on DeepSeek-V2-Lite's
prefill widths (16 heads over one latent head, 576 wide) for a prefix pass
of Q queries over P prefix keys, all visible, so every block of 64 (position,
head) rows visits P / 64 key tiles: Q = 1,056 (264 blocks, two a SM) over P =
64 .. 4,096, and Q = 528 (132 blocks, one a SM). A straight line through
ms against tiles a block gives the cost of a tile (its slope) and of a
block's start and end (its intercept over the blocks an SM runs).

    python tools/mla_flash_probe.py [--out rows.json]

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from sgl_kernel_tpu_torch.ops.attention import flash_prefill

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261018)
    nh, sm = 16, 1.0 / 192 ** 0.5

    def randn(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.3).to(torch.bfloat16)

    def graph_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 5 / reps

    res = {"rows": []}
    for q_len in (1056, 528):
        blocks = q_len * nh // 64
        qn, qp = randn(1, q_len, nh, 512), randn(1, q_len, nh, 64)
        for pre in (64, 128, 256, 512, 1024, 2048, 4096):
            kv = randn(1, pre, 1, 576)
            ql = torch.tensor([q_len], dtype=torch.int32, device=dev)
            pl = torch.tensor([pre], dtype=torch.int32, device=dev)
            zero = torch.zeros_like(pl)
            ms = graph_ms(lambda: flash_prefill.flash_attention_mla(qn, qp, kv, ql, pl, pl, zero, sm_scale=sm,
                                                                    return_lse=True))
            res["rows"].append(dict(q=q_len, blocks=blocks, prefix=pre, tiles=pre // 64, ms=ms,
                                    tflops=2 * nh * (576 + 512) * q_len * pre / ms / 1e9))
    for q_len in (1056, 528):
        pts = [(r["tiles"], r["ms"]) for r in res["rows"] if r["q"] == q_len]
        n = len(pts)
        mx, my = sum(p[0] for p in pts) / n, sum(p[1] for p in pts) / n
        slope = sum((x - mx) * (y - my) for x, y in pts) / sum((x - mx) ** 2 for x, _ in pts)
        waves = -(-q_len * nh // 64 // 132)
        res[f"q{q_len}"] = dict(ms_per_tile_a_block=slope, us_per_tile=1e3 * slope / waves,
                                us_per_block_fixed=1e3 * (my - slope * mx) / waves, waves=waves)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
