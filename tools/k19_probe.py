"""Split K19's time into its stream and its consumers' work on the card.

    python3 tools/k19_probe.py [--out k19_probe.json]

Builds four versions of ``sgl_kernel_tpu_torch/csrc/qserve_gemm.cu`` with
nvcc for sm_90a into ``sgl_kernel_tpu_torch/_build/`` (the source edited as
text, nothing else changed) and times each through
``qserve_w4a8_per_group_gemm`` at the K19 rows of ``tools/decode_ab.py``
(Llama-3-8B's qkv, o, gate_up and down on QServe-made weights, group 128,
M=16 and 1,024), CUDA-graph device ms, the four in turns, twice:
- ``kernel``: the source as it is;
- ``no_mma``: the consumers make every W8 fragment (the group scales
  included) but fold it into one register instead of multiplying it;
- ``stream``: the consumers also skip the dequantization, folding the raw
  code words (the producer's ring, the scales' reads and the epilogue stay);
- ``compute``: the producer issues no copy (each stage keeps whatever it
  held; the barriers complete as before) and every block stays on the
  int8 route, so the consumers' work runs alone.
If the kernel's time is near the larger of ``stream`` and ``compute``,
they overlap; near their sum, they do not.
Outputs of the edited versions are meaningless and are not checked. Prints
the card's name and power limit, then one JSON line, also written to
``--out``. Measurement only: no model and no test runs it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MMA = ("      issue<BM>(acc, fr[h], a_s + h * C::A_BOX);",
       "      acc[0] ^= fr[h][0][0] ^ fr[h][1][1] ^ fr[h][2][2] ^ fr[h][3][3] ^ a_s;")
# (old, new) text edits of csrc/qserve_gemm.cu a version makes; each old must occur
EDITS = {
    "kernel": [],
    "no_mma": [MMA],
    "stream": [MMA] + [(f"        f[{i}] = w8x4_fast(x{i}, cs[{i % 2}], cz[{i % 2}], bad);",
                        f"        f[{i}] = x{i};") for i in range(4)],
    "compute": [("        skt::mbar_expect_tx(&full[s], hi ? C::STAGE : C::STAGE / 2);",
                 "        skt::mbar_expect_tx(&full[s], 0);"),
                ("        skt::tma_load_2d(wst, &kp.tm_w, k, n0, &full[s]);\n"
                 "        skt::tma_load_2d(ast, &kp.tm_a, k, m0, &full[s]);", ""),
                ("          skt::tma_load_2d(wst + kWBox, &kp.tm_w, k + kBox, n0, &full[s]);\n"
                 "          skt::tma_load_2d(ast + C::A_BOX, &kp.tm_a, k + kBox, m0, &full[s]);", ""),
                # stale codes make any W8: keep every block on the int8 route
                ("  const bool exact = p.force_exact || skt::named_sync_or(1, kCThreads, (bad & 0xFF00FF00u) != 0u);",
                 "  const bool exact = p.force_exact;")],
}
GEMMS = (("qkv", 6144, 4096), ("o", 4096, 4096), ("gate_up", 28672, 4096), ("down", 4096, 14336))


def build(_build, src_text):
    """Compile each version into _build/ side by side; returns {version: entry point}."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, edits in EDITS.items():
        text = src_text
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"k19_probe: {name}: csrc/qserve_gemm.cu no longer holds {old.strip()[:60]!r}")
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"k19_probe_{name}.cu"
        cu.write_text(text)
        lib = _build.BUILD_DIR / f"k19_probe_{name}.{os.getpid()}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(cu)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        fns[name] = ctypes.CDLL(str(lib)).skt_qserve_w4a8_per_group
    return fns


def main(out_path):
    import torch

    from sgl_kernel_tpu_torch import _build
    from sgl_kernel_tpu_torch.ops.gemm import qserve

    fns = build(_build, (_build.CSRC / "qserve_gemm.cu").read_text())
    for fn in fns.values():
        fn.argtypes = qserve._ARGS
        fn.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261018)

    def graph_ms(call, reps=20):
        call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                call()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 5 / reps

    def qserve_weights(n, k, g=128):
        codes, zs2, s2, chn = qserve.qserve_quantize(torch.randn((n, k), generator=gen, device=dev) * 0.01, g)
        return codes, zs2, s2, chn.half()

    res = {"card": smi.stdout.strip()}
    for label, n, k in GEMMS:
        w = qserve_weights(n, k)
        for m in (16, 1024):
            a = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
            as_ = (torch.rand(m, generator=gen, device=dev) * 0.01 + 1e-3).half()
            for turn in range(2):
                for name, fn in fns.items():
                    qserve._entry = lambda fn=fn: fn
                    res.setdefault(f"{label}_m{m}_{name}", []).append(
                        graph_ms(lambda: qserve.qserve_w4a8_per_group_gemm(a, *w, as_)))
        del w
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    if out_path:
        Path(out_path).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="a JSON file for the rows")
    main(ap.parse_args().out)
