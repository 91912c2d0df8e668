"""NSA wave D's prefill on trees of the port in turns, on one card.

Wave D of ``chip_smoke.py``'s NSA engine (DeepSeek-V2-Lite widths, W4A16,
int8 latent, the indexer at DeepSeek-V3.2-Exp's widths, 27 layers, random
weights from the seed): 4 fresh prompts of 6,144 tokens in 1,024-token
chunks (one prefill and five extends each, whose attention runs K7 at head
dim 576), then 32 decode tokens each. Each ROOT runs in a process of its
own with that tree's package and ``chip_smoke.py`` (the same prompts from
the same seed), after building its kernels; prints one JSON line a run:
prefill tok/s, prefill s, decode ms a step and K7's launches at 576. Host
clocks move between calls, so compare trees within one call, in turns:

    python tools/nsa_wave_d_ab.py _trees/parent . . _trees/parent

``--profile ROOT`` then serves one more 6,144-token prompt on that tree and
traces its six chunk steps with torch.profiler: wall s, device-busy s, and
device ms by kernel group (chip_smoke.PREFILL_GROUPS) and of the top
kernels.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


def one(root: Path, profile: bool = False) -> None:
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    import sgl_kernel_tpu_torch as skt
    from sgl_kernel_tpu_torch import _build
    from sgl_kernel_tpu_torch.serving import native

    assert Path(skt.__file__).resolve().parent.parent == root.resolve(), skt.__file__
    assert Path(cs.__file__).resolve().parent == root.resolve(), cs.__file__
    t0 = time.perf_counter()
    cs.phase_build(_build, native)
    build_s = time.perf_counter() - t0
    cfg = cs.nsa_cfg(torch, skt, kv_dtype=torch.int8, kv_scale=1 / 16)
    eng = skt.Engine(cfg, None, device="cuda", max_batch=16, page_size=64, num_pages=1664, seed=cs.SEED,
                     prefill_chunk=1024)
    for n in (16, 40):  # warm-up, as chip_smoke.phase_serve
        eng.add_request(list(range(1, n + 1)), max_new_tokens=2)
    eng.run_until_done()
    eng.finished.clear()
    stats = cs.instrument(eng)
    gen = torch.Generator().manual_seed(cs.SEED + 4)
    prompts = [cs.random_prompt(torch, gen, cfg.vocab_size, cs.NSA_PROMPT) for _ in range(4)]
    d, _ = cs.run_wave(torch, skt, eng, stats, "deepseek-nsa", "D", prompts, hits=0)
    print(json.dumps(dict(root=str(root), build_s=build_s, prefill_tok_s=d["prefill_tok_s"],
                          prefill_s=d["prefill_s"], prefill_tokens=d["prefill_tokens"],
                          decode_ms_step=d["decode_ms_step"], program_calls=d["program_calls"],
                          flash_attention_576=d["launches"].get("flash_attention_576"))), flush=True)
    if not profile:
        return
    eng.add_request(cs.random_prompt(torch, gen, cfg.vocab_size, cs.NSA_PROMPT), max_new_tokens=2)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps = 0
        while eng.waiting or eng.prefilling:
            eng.step()
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run_until_done()
    spans, per_kernel, n_kernel, busy_us = cs.device_spans(torch, prof)
    print(json.dumps(dict(
        root=str(root), profile_steps=steps, wall_s=wall, device_busy_s=busy_us / 1e6, launches=len(spans),
        group_ms={g: sum(v for k, v in per_kernel.items() if any(f in k for f in frags)) / 1e3
                  for g, frags in cs.PREFILL_GROUPS.items()},
        top_ms={k[:80]: v / 1e3 for k, v in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]})), flush=True)


def main() -> None:
    if sys.argv[1] in ("--one", "--profile"):
        one(Path(sys.argv[2]), profile=sys.argv[1] == "--profile")
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for root in sys.argv[1:]:
        out = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True, text=True)
        lines = [l for l in out.stdout.splitlines() if l.startswith('{"root"')]
        print(lines[-1] if lines and out.returncode == 0 else f"{root}: rc {out.returncode}\n{out.stderr[-3000:]}",
              flush=True)


if __name__ == "__main__":
    main()
