"""The int8 warpgroup MMA's rate on the card, alone.

    python3 tools/wgmma_probe.py [--out wgmma_probe.json]

Builds ``tools/wgmma_probe.cu`` with nvcc for sm_90a into
``sgl_kernel_tpu_torch/_build/`` and times its kernel, one block an SM,
each warpgroup issuing rounds of four chained k32 wgmmas
(m64nNk32.s32.s8.s8) as ``csrc/qserve_gemm.cu`` issues a box: A from
registers (``rs``) or from shared memory (``ss``), N 128 or 256 (the
activation rows as wgmma's N), one or two warpgroups a block, the operands
zeros or the bytes of a hash (``zero`` / ``hash``). CUDA-event
ms over the launch, and TOP/s against the int8 peak of 1,979 (the H100
SXM data sheet). Then the bf16 register-A loop of
``csrc/w4a16_wgmma.cu`` (two m64n64k16 wgmmas a k16 step, two warpgroups a
block): fragments held, decoded from int4 codes of a swizzled stage each
step, and decoded with a promotion every 8 steps (a group of 128); TFLOP/s
against the bf16 peak of 989. Prints the card's name and power limit, then one JSON
line, also written to ``--out``. Measurement only: no model and no test
runs it.
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

ITERS = 4096  # rounds of four wgmmas a warpgroup (of 8 k16 steps in the bf16 loop)
INT8_OPS = 1979e12
BF16_FLOPS = 989e12


def main(out_path):
    import torch

    from sgl_kernel_tpu_torch import _build
    from sgl_kernel_tpu_torch.utils import sm_count

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / f"wgmma_probe.{os.getpid()}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
           str(ROOT / "tools" / "wgmma_probe.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).skt_wgmma_probe
    fn.argtypes = (ctypes.c_int,) * 6 + (ctypes.c_void_p, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    blocks = sm_count(0)
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {"card": smi.stdout.strip(), "blocks": blocks, "iters": ITERS}
    for mode, mname in ((0, "rs"), (1, "ss")):
        for n, nwg, rnd in ((128, 1, 0), (128, 2, 0), (256, 2, 0), (128, 2, 1), (256, 2, 1)):
            def call():
                _build.check(fn(mode, n, nwg, rnd, blocks, ITERS, out.data_ptr(), stream), "wgmma_probe")
            call()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(3):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 3
            ops = blocks * nwg * ITERS * 4 * 2 * 64 * n * 32
            res[f"{mname}_n{n}_wg{nwg}_{'hash' if rnd else 'zero'}"] = {
                "ms": ms, "tops": ops / ms / 1e9, "share_of_peak": ops / ms / 1e-3 / INT8_OPS}
    bf = ctypes.CDLL(str(lib)).skt_wgmma_probe_bf16
    bf.argtypes = (ctypes.c_int,) * 3 + (ctypes.c_void_p, ctypes.c_void_p)
    bf.restype = ctypes.c_int
    for mode, mname in ((0, "held"), (1, "decode"), (2, "decode_promote")):
        def call():
            _build.check(bf(mode, blocks, ITERS, out.data_ptr(), stream), "wgmma_probe_bf16")
        call()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(3):
            call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 3
        ops = blocks * 2 * ITERS * 8 * 2 * 2 * 64 * 64 * 16  # two warpgroups, 8 steps of two m64n64k16
        res[f"bf16_rs_n64x2_{mname}"] = {"ms": ms, "tflops": ops / ms / 1e9,
                                         "share_of_peak": ops / ms / 1e-3 / BF16_FLOPS}
    print(json.dumps(res), flush=True)
    if out_path:
        Path(out_path).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="a JSON file for the rows")
    main(ap.parse_args().out)
