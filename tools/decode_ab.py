"""Device time of the decode kernels K5 and K1 for the port found at ROOT.

Times, with CUDA graphs (chip_smoke.py's method: the calls captured and
replayed, so the host launch path is not measured), K5 at B=16 over
contexts 1..1,056 (32-layer pools, 128-column tables, fresh rows), at
B=16 x 8,192 and at B=1 x 32,768 (16 splits and unsplit), and K1 at the
five W4A16 Llama-3-8B decode GEMMs (M=16, group 128: qkv and gate_up with
the norm, o with a residual, down on the gate / up halves with silu and a
residual, lm_head with the norm). Inputs come from a fixed seed, so two
trees see the same data. To compare two trees on one card, run them in
turns in one call (old, new, new, old):

    python tools/decode_ab.py OLD_TREE; python tools/decode_ab.py .

Prints the card's name and power limit, then one JSON line of ms.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def main(root: Path) -> None:
    sys.path.insert(0, str(root))
    import torch

    import sgl_kernel_tpu_torch as skt
    from sgl_kernel_tpu_torch import _build
    from sgl_kernel_tpu_torch.ops.attention import paged_decode_dma as pd
    from sgl_kernel_tpu_torch.ops.gemm import w4a16

    assert Path(skt.__file__).resolve().parent.parent == root.resolve(), skt.__file__
    _build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261017)
    bf = torch.bfloat16

    def graph_ms(fn, reps=20):
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

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    res = {"root": str(root)}
    for name, lengths, cols, layers, splits in (
            ("k5_ragged", [1 + (1055 * i) // 15 for i in range(16)], 128, 32, 1),
            ("k5_ctx8192", [8192] * 16, 128, 1, 1), ("k5_32k_split16", [32768], 512, 1, 16),
            ("k5_32k_unsplit", [32768], 512, 1, 1)):
        used = [-(-(n - 1) // 64) for n in lengths]
        table = torch.zeros((len(lengths), cols), dtype=torch.int32, device=dev)
        perm = torch.randperm(sum(used), generator=gen, device=dev).to(torch.int32) + 1
        at = 0
        for i, n in enumerate(used):
            table[i, :n] = perm[at: at + n]
            at += n
        kp, vp = randn(layers, sum(used) + 1, 8, 64, 128), randn(layers, sum(used) + 1, 8, 64, 128)
        b = len(lengths)
        q, fk, fv = randn(b, 32, 128), randn(b, 8, 128), randn(b, 8, 128)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = dict(layer_id=layers - 1, fresh_k=fk, fresh_v=fv, num_splits=splits, chunk_pages=16)
        res[name] = graph_ms(lambda: pd.paged_attention_decode_dma(q, kp, vp, lens, table, **kw))
        del kp, vp
        torch.cuda.empty_cache()
    for name, n, k, opt in (("k1_qkv", 6144, 4096, "norm"), ("k1_o", 4096, 4096, "residual"),
                            ("k1_gate_up", 28672, 4096, "norm"), ("k1_down", 4096, 14336, "fused"),
                            ("k1_lm_head", 129024, 4096, "norm")):
        w, s, _ = w4a16.quantize_w4(torch.randn((n, k), generator=gen, device=dev) * 0.02, group_size=128)
        a = randn(16, 2 * k if opt == "fused" else k)
        kw = dict(group_size=128)
        if opt == "norm":
            kw["norm_weight"] = randn(k)
        elif opt == "residual":
            kw["residual"] = randn(16, n)
        else:
            kw.update(prologue="silu_mul", fused_gate_up=True, residual=randn(16, n))
        res[name] = graph_ms(lambda: w4a16.w4a16_gemm(a, w, s, **kw))
        del w, s, a
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main(Path(sys.argv[1]) if len(sys.argv) > 1 else Path("."))
