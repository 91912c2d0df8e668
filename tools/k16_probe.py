"""Split K16's time into its stream and its compute on the card.

    python3 tools/k16_probe.py [--out k16_probe.json]

Builds three versions of ``sgl_kernel_tpu_torch/csrc/sparse_vs.cu`` with
nvcc for sm_90a into ``sgl_kernel_tpu_torch/_build/`` (the source edited as
text, nothing else changed) and times each at K16's rows of
``tools/decode_ab.py`` (32 heads of 128, causal, bm 64, bn 128; S=4,096 with
NV 256 / NS 8 and S=32,768 with NV 1,000 / NS 64), CUDA-event ms over
back-to-back calls, the three in turns, twice:
- ``kernel``: the source as it is;
- ``stream``: the consumers wait for each stage and release it, computing
  nothing (the producer's ring alone: headers, cp.async gathers, TMA boxes);
- ``compute``: the producer issues no copy (each stage keeps whatever it
  held; the barriers complete as before), so the consumers' tile runs on
  stale data (the tile alone).
If the kernel's time is near the larger of the other two, stream and
compute overlap; near their sum, they do not. Outputs of the edited
versions are meaningless and are not checked. Prints the card's name and
power limit, then one JSON line, also written to ``--out``. Measurement
only: no model and no test runs it.
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

# (old, new) text edits of csrc/sparse_vs.cu a version makes; each old must occur
EDITS = {
    "kernel": [],
    "stream": [
        ("    if constexpr (L::kQRegs) skt::flash_scores<D>(sc, qf, skt::smem_u32(kt));\n"
         "    else skt::flash_scores<D>(sc, skt::smem_u32(sq), skt::smem_u32(kt));",
         "    for (int x = 0; x < 32; ++x) sc[x] = 0.f;"),
        ("    skt::flash_softmax_pv<D>(acc, sc, skt::smem_u32(kt + L::kTile));",
         "    if (e < 0) skt::flash_softmax_pv<D>(acc, sc, skt::smem_u32(kt + L::kTile));"),
    ],
    "compute": [
        ("        skt::cp_async16(kt + d, kb + off, ok);\n        skt::cp_async16(kt + L::kTile + d, vb + off, ok);", ""),
        ("        skt::mbar_expect_tx(&full[s], 2 * L::kTile);", "        skt::mbar_expect_tx(&full[s], 0);"),
        ("          skt::tma_load_2d(kt + x * SUB, &ka.tk, hk * D + 64 * x, row, &full[s]);\n"
         "          skt::tma_load_2d(kt + L::kTile + x * SUB, &ka.tv, hk * D + 64 * x, row, &full[s]);", ""),
    ],
}
ROWS = (("4k", 4096, 256, 8), ("32k", 32768, 1000, 64))


def build(_build, src_text):
    """Compile each version into _build/ side by side; returns {version: entry point}."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, edits in EDITS.items():
        text = src_text
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"k16_probe: {name}: csrc/sparse_vs.cu no longer holds {old.strip()[:60]!r}")
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"k16_probe_{name}.cu"
        cu.write_text(text)
        lib = _build.BUILD_DIR / f"k16_probe_{name}.{os.getpid()}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(cu)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        fn = ctypes.CDLL(str(lib)).skt_sparse_attn
        fns[name] = fn
    return fns


def main(out_path):
    import numpy as np
    import torch

    from sgl_kernel_tpu_torch import _build
    from sgl_kernel_tpu_torch.ops.attention import sparse_vs

    fns = build(_build, (_build.CSRC / "sparse_vs.cu").read_text())
    for fn in fns.values():
        fn.argtypes = sparse_vs._ARGS
        fn.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261018)
    rng = np.random.default_rng(20261018)

    def event_ms(call, iters):
        call()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            call()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    res = {"card": smi.stdout.strip()}
    for label, s, nv, ns in ROWS:
        q, k, v = (torch.randn((1, s, 32, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
        vert = np.sort(np.stack([rng.choice(s, nv, replace=False) for _ in range(32)]), -1)[None]
        slash = np.ascontiguousarray(
            np.sort(np.stack([rng.choice(s, ns, replace=False) for _ in range(32)]), -1)[None, :, ::-1])
        sched = [torch.from_numpy(x).to(dev).contiguous()
                 for x in sparse_vs.convert_vertical_slash_indexes([s], [s], vert, slash, s, 64, 128)]
        kv_lens = torch.full((1,), s, dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        for turn in range(2):
            for name, fn in fns.items():
                def call(fn=fn, name=name):
                    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *(x.data_ptr() for x in sched),
                                    kv_lens.data_ptr(), out.data_ptr(), None, 1, s, 32, 32, 128,
                                    sched[1].shape[-1], sched[3].shape[-1], 128, 1, 128 ** -0.5, 0.0, stream), name)
                res.setdefault(f"{label}_{name}", []).append(event_ms(call, 3 if s > 8192 else 20))
        del q, k, v, sched, out
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    if out_path:
        Path(out_path).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="a JSON file for the rows")
    main(ap.parse_args().out)
