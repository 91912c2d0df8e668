"""Measure the W4A16 weight stream's ceiling on the card.

    python3 tools/w4a16_stream_probe.py [--reps 3] [--out w4a16_stream_probe.json]

Builds ``tools/w4a16_stream_probe.cu`` (the port's streaming core,
``sgl_kernel_tpu_torch/csrc/w4a16_stream.cuh``, at many stream shapes) with
nvcc for sm_90a into ``sgl_kernel_tpu_torch/_build/`` and reports TB/s of
int4 codes, on banks of more than 1 GB that each launch reads cold (L2 holds
50 MB), at Mixtral-8x7B's expert widths: gate_up (K 4,096 -> N 28,672) as
[3, 8, 2,048, 28,672] and down (K 14,336 -> N 4,096) as [5, 8, 7,168, 4,096].

(a) a plain read of a 1.4 GB buffer, 16 bytes a thread: the card's
    reachable read rate;
(b) the core's TMA ring with consumers that only release each stage: box
    (one 128-byte-swizzled box of 128 columns, one unswizzled 256-byte box,
    two 128-byte boxes side by side), stages 2-8, 1 or 2 blocks an SM, unit
    order tile-major or k-synchronous; codes alone, and a few shapes with
    every box of a stage (activations, scales, group sums);
(c) a few shapes with the real consumers (int4 decode to registers,
    mma.sync with the codes as A) at 16 and 32 activation rows (M = 1 runs
    the 16-row instruction stream).

Prints one line a measurement and the card's name and power limit, and
writes every row to the JSON file ``--out`` names. Measurement only: no
model and no test runs it.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from sgl_kernel_tpu_torch import _build  # noqa: E402

SRC = Path(__file__).resolve().parent / "w4a16_stream_probe.cu"
BOX_NAMES = {0: "128B swizzled, 128 cols", 1: "256B unswizzled, 256 cols", 2: "2 x 128B swizzled, 256 cols"}
MODE_NAMES = {0: "real consumers", 1: "empty, codes only", 2: "empty, every box"}
BANKS = {"gate_up": (3, 8, 4096, 28672), "down": (5, 8, 14336, 4096)}  # L, E, K, N


def build() -> ctypes.CDLL:
    h = hashlib.sha256(SRC.read_bytes())
    for dep in sorted(_build.CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    out = _build.BUILD_DIR / f"w4a16_stream_probe-{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC), "-o", str(out), str(SRC)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        for line in (res.stdout + res.stderr).splitlines():
            if any(w in line for w in ("Compiling entry", "spill", "registers")) or "error" in line.lower():
                print(f"[build] {line.strip()}", flush=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    lib.probe_read.argtypes = (p, ctypes.c_longlong, p, ctypes.c_int, ctypes.c_int, p)
    lib.probe_stream.argtypes = (ctypes.c_int,) + (p,) * 9 + (ctypes.c_int,) * 6 + (p, p)
    lib.probe_shape.argtypes = (ctypes.c_int, p)
    return lib


def timed(torch, fn, reps):
    fn()  # warm-up (and the first launch's attribute set-up)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="w4a16_stream_probe.json", help="where the rows go, as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the probe runs on the card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card, flush=True)
    lib = build()
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream
    rows = []

    def report(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    # (a) plain read
    gen = torch.Generator(device=dev).manual_seed(7)
    buf = torch.randint(0, 256, (1408 * 2 ** 20,), generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)
    sink = torch.zeros(4, dtype=torch.int32, device=dev)
    for per_sm, threads in ((2, 512), (4, 512), (8, 256), (16, 256)):
        fn = lambda: _build.check(lib.probe_read(buf.data_ptr(), buf.numel(), sink.data_ptr(), per_sm * n_sm,
                                                 threads, stream()), "probe_read")
        ms = timed(torch, fn, args.reps)
        report(dict(part="a", what="plain read, 16 B a thread", blocks=per_sm * n_sm, threads=threads,
                    bytes=buf.numel(), ms=ms, tbps=buf.numel() / ms / 1e9))
    del buf

    shape = (ctypes.c_int * 6)()
    blocks_out = ctypes.c_int()
    for bank, (n_l, n_e, k, n) in BANKS.items():
        experts = n_l * n_e
        w = torch.randint(0, 256, (experts, k // 2, n), generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)
        scales = (0.01 * torch.rand((experts, k // 128, n), generator=gen, device=dev)).to(torch.bfloat16)
        act = (torch.randn((experts * 32, k), generator=gen, device=dev)).to(torch.bfloat16)
        asum = torch.randn((k // 128, experts * 32), generator=gen, device=dev)
        eids = torch.arange(experts, dtype=torch.int32, device=dev)
        nv = torch.tensor(experts, dtype=torch.int32, device=dev)
        out = torch.empty((experts * 32, n), dtype=torch.bfloat16, device=dev)
        partial = torch.empty(8 * 2 ** 20, dtype=torch.float32, device=dev)
        counters = torch.zeros(16384, dtype=torch.int32, device=dev)
        code_bytes = w.numel()
        print(f"[bank] {bank}: [{n_l}, {n_e}, {k // 2}, {n}] = {code_bytes / 1e9:.3f} GB of codes", flush=True)
        for sid in range(lib.probe_count()):
            lib.probe_shape(sid, ctypes.cast(shape, ctypes.c_void_p))
            mp, box, ks, stages, minb, mode = list(shape)
            for per_sm in (1, 2):
                for order in (0, 1):
                    if mode == 0 and per_sm != minb:
                        continue
                    fn = lambda: _build.check(lib.probe_stream(
                        sid, w.data_ptr(), scales.data_ptr(), act.data_ptr(), asum.data_ptr(), eids.data_ptr(),
                        nv.data_ptr(), out.data_ptr(), partial.data_ptr(), counters.data_ptr(), experts, k, n,
                        per_sm, n_sm, order, ctypes.byref(blocks_out), stream()), f"probe_stream {sid}")
                    try:
                        ms = timed(torch, fn, args.reps)
                    except RuntimeError as e:  # a shape that does not fit reports it and the rest go on
                        report(dict(part="b" if mode else "c", bank=bank, shape=sid, error=str(e)))
                        continue
                    report(dict(part="b" if mode else "c", bank=bank, shape=sid, mp=mp,
                                box=BOX_NAMES[box], k_stage=ks, stages=stages, blocks_per_sm=blocks_out.value,
                                asked_per_sm=per_sm, order="k-sync" if order else "tile-major",
                                consumers=MODE_NAMES[mode], ms=ms, tbps=code_bytes / ms / 1e9))
        del w, scales, act, asum, out, partial
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
