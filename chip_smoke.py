#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. build   compile every kernel source of sgl_kernel_tpu_torch/csrc with
             nvcc (one process per source, all at once) and the host C++
             serving runtime (serving_native.cpp) with c++ beside them;
             print the build time and the card's name and power limit.
  2. kernels each hand-written kernel against its plain PyTorch version on
             the card at the serving path's shapes: max error against a
             stated tolerance, kernel / plain / library times (CUDA events)
             and the least time the card could take (bytes over 3.35 TB/s
             or operations over the peak rate of their type). The W4A16
             GEMM (K1) at the five decode GEMMs of a Llama-3-8B step, two
             prefill ones, an mxfp4 and a zeros+bias case; decode attention
             (K5) on int8 and fp8 e4m3 pools too; packed prefill (K9) at the
             packed shape of phase 4's 16 prompts, with lse; K7's two
             extend passes with lse (512 tokens over a 512-token prefix,
             and wave C's 1,024 over 3,072). K7 / K9 rows add CUDA-graph
             device ms and TFLOP/s beside SDPA's; K2 its and F.rms_norm's
             device ms.
  3. parity  Llama-3-8B widths cut to 2 layers, weights from one CPU seed,
             bf16 and W4A16: the same prefill and 4 decode steps, then a
             packed prefill, an extend and a mixed step, on the card and
             on the CPU; greedy tokens and logits agree.
  4. serve   Engine(LlamaConfig.llama3_8b(fused=True)) with random weights
             and the default arguments (prefix cache, packed admission,
             mixed steps) plus prefill_chunk=1024, in three waves: (A) 16
             fresh prompts of 16..1024 tokens, 32 new tokens, two sampled,
             one packed launch; (B) 12 prompts that each begin with the
             first 512 tokens of one of A's 8 prompts of 553 tokens or
             more, then a fresh suffix of 64..512 tokens: every one hits 8
             cached pages; (C) with B, a fresh 4,096-token prompt prefilled
             in 1,024-token chunks, the first on its own, the rest in mixed
             steps beside B's decodes. B's prompts again through an engine
             with the prefix cache off: first-token logits agree. Then the
             same on the W4A16 engine (quant="w4a16"), then waves A and B
             of 4 requests on the W4A16 engine with int8 KV pools
             (kv_scale 1/16). Each wave's kernels each launch at least once
             (counts set to 0 just before it), K1 in prefill, decode and
             mixed steps, K5 on the int8 pool.
  5. profile the bf16 and the W4A16 engine: 16 prompts admitted again, 4
             decode steps traced with torch.profiler eagerly and 4 as graph
             replays; step time, device-busy share, kernel and host
             launches, device time per kernel name.
Then the same phases for the DeepSeek path (DeepSeek-V2-Lite widths, W4A16,
int8 latent pool): (2) the grouped W4A16 GEMM (K11) at the B=16 decode's
gate_up and down and at a 1,024-token prefill, MLA decode (K13a) at B=16
over contexts 1..1056 on bf16, int8 and e4m3 pools (and the slice 13 rows
below), the MLA qkv prep (K14)
at 16 tokens, and K7 / K9 at head dim 576 in the MLA form the model calls
(the extend passes, wave D's last prefix pass of 1,024 queries over 5,120
keys, wave A's packing); (3) card against CPU at V2-Lite widths cut to 2 layers (layer 0
dense, layer 1 MoE), bf16 and int8 latent: prefill, 4 decode steps,
prefill_packed, prefill_extend, with the card's routing replaced by the
CPU's where they differ (each flip counted); (4) the engine at full depth
(27 layers) in waves A, B (exactly 6,144 hit tokens, warm against cold)
and C (the 4,096-token prompt in chunks, by extend: no mixed step), each
wave's kernels launching; (5) its profile of 4 decode steps.
Then the Mixtral path and the bf16 DeepSeek engine: (2) the split-q/k decode
RoPE (K4) at Mixtral-8x7B's B=16 decode, the grouped bf16 GEMM (K12) at
DeepSeek-V2-Lite's B=16 decode (gate_up and down, 64 experts, stacked),
Mixtral's B=16 decode (8 experts, unstacked) and a 1,024-token Mixtral
prefill at bm 128, each with torch._grouped_mm as the library yardstick
where this torch has it; (3) card against CPU at 2 layers: Llama-3-8B bf16
with fused=False (prefill and decode, through K4), DeepSeek-V2-Lite with bf16
weights, and Mixtral-8x7B bf16 and W4A16 (prefill, 2 decode steps, packed,
extend; routing replayed as for DeepSeek); (4) Engine(MixtralConfig.
mixtral_8x7b(quant="w4a16")) at full depth (32 layers) and the bf16
DeepSeek-V2-Lite engine at full depth, each in waves A, B+C (C's prompt in
one prefill and three extends) and the cold check, then the bf16
Mixtral-8x7B engine cut to 8 of 32 layers (93.4 GB of bf16 weights do not
fit in 80 GB) in waves A and B of 4; (5) the two full-depth engines'
decode profiles. Then the NSA path (DeepSeek-V2-Lite widths, W4A16, int8
latent, the indexer at DeepSeek-V3.2-Exp's widths: 64 heads of 128, top-k
2,048): (2) the indexer's scores (K15) at the engine's decode (B=16,
lengths 1..1,056), at B=16 x 8,192 and B=1 x 32,768 tokens (fp8 keys with
scales) and on bf16 keys, and mla_decode(engine="dma") (K13b) at K13a's
shapes on bf16 576, bf16 640 and fp8 640 pools; (3) card against CPU at 2
layers with contexts of ~3,000 tokens: prefill_nsa, prefill_packed with the
indexer, prefill_extend_nsa and 4 decode_step_nsa steps, routing replayed,
selection flips counted per layer (the CPU's selection replayed on the card
if the logits miss the gate); (4) the NSA engine at full depth in waves A,
B+C, the cold check, and wave D (4 fresh prompts of 6,144 tokens in
1,024-token chunks, 32 decode tokens each over a sparse selection), and
K13b's path, its op entry point over a 27-layer bf16 pool (no model calls
it); (5) its decode profile at 16 rows of 6,144 tokens. Then slice 7, the
decode variants: (2) K10 (w4a16_gemm_dma) at the W4A16 Llama-3-8B decode
GEMMs (M=16; gate_up also at M=1 and 32) beside K1 and
torch._weight_int4pack_mm, K8 (paged_attention_decode) over head-major
pools (bf16, e4m3 with scales), and K5 with layout="head", with the lse,
split at choose_num_splits (B=16 and B=1 x 32,768) and with sinks, window
128 and softcap 30; (3) card against CPU for gemm_impl="dma" at 2 layers
(prefill, 4 decode steps); (4) the W4A16 engine with gemm_impl="dma" at 32
layers on the W4A16 phase's weights, waves A and B+C and the cold check
(K10 in every decode step, K1 at prefill and mixed steps), and K8's path,
its op entry points over 32 head-major layers (store_cache_head_major,
then paged_attention_decode, 8 steps), each output equal to K5's over the
page-major transpose; (5) the dma engine's decode profile, K10's device
ms a step against the pipeline engine's K1. Then slice 8, the last four
kernels: (2) K17 (fp8_blockwise_scaled_mm) at DeepSeek-V3's dense fp8 GEMMs
(shared-expert gate_up and down, o_proj; M=16 and 1,024; compact and
prepared scales), K18 (fp8_blockwise_scaled_grouped_mm) over DeepSeek-V3's
256 routed e4m3 experts at a B=16 decode and a 1,024-token prefill, K19
(qserve_w4a8_per_group_gemm) at Llama-3-8B's four GEMMs (M=16 and 1,024)
and K16 (sparse_attn_func) at Llama-3-8B's attention widths at S=4,096 and
32,768 (and softcap 30 with the lse), each beside its library yardstick
(torch._scaled_mm, torch._scaled_grouped_mm, torch._int_mm, SDPA); (4) their
op paths, no model calling them: sparse_attn_varlen_func on two prompts of
16,384 and 8,192 tokens from build_vertical_slash_indexes' estimate, a
DeepSeek-V3 fp8 MoE layer's GEMMs (K17, K18) over 4 layers, a W4A8
Llama-3-8B decode through 8 layers' linear layers (K19 and the per-channel
GEMM) and w4a8_grouped_mm on K11 at DeepSeek-V3's routed widths. Slice 12
(K10 and K11 at decode on one W4A16 streaming core): K11 also at
Mixtral-8x7B's B=16 decode (top-2 of 8 experts, bm 16: gate_up and down);
cold device ms beside the warm ones for K11's decode rows, K10's five M=16
rows (K1 on the same cold bank in turns) and K1's five decode rows, each
call cycling the layers of a stacked bank of >= 150 MB (three times L2);
two calls bit-equal for K11 decode and K10. Slice 13 (K13a and K15
redesigned for Hopper decode): K13a also at NSA's sparse shape (B=16 x
2,048 rows of a flat pool viewed as one-row pages, int8 and bf16) and at
B=16 x 8,192 (bf16, dense pages); cold device ms beside the warm ones for
every K13a and K15 row (calls cycling the layers of a >= 150 MB stacked
pool, or the parts of a flat one); two calls bit-equal for every K13a and
K15 row; the launch floor (one empty kernel, torch.cuda._sleep(0), a
CUDA-graph node); the DeepSeek and NSA profiles' K13a and K15 device ms and
launches a step. Slice 14 (K16 on the wgmma flash tile with a producer
warp; K13b on K13a's kernel): K16's rows give TFLOP/s on the schedule's
visible pairs beside SDPA's on the dense causal pairs, and the varlen path
K16's device ms (CUDA events around its call in one more run); K13b's
rows give K13a's CUDA-graph ms on the same shape and pool beside their
own. Slice 16 (K19 on an int8 wgmma tile): K19's rows give CUDA-graph ms
at M=16 and 1,024 beside the event ms, their TOP/s and GB/s, and the route
its blocks took; QServe-made weights must keep every block of the eight
rows and of the op path's 32 calls on the int8 route (the kernel's
exact-route counter unmoved). The kernels line splits K7's and K9's
launches by head dim (576 apart from 64 / 128). Slice 17 (K1 past 32 rows
and K11 at bm 64 / 128 on one W4A16 wgmma tile): K1 also at wave A's packed
gate_up (M=16,384); every K1 row past 32 rows must run the wgmma tile (its
route counter) and gives cuBLAS's bf16 product on the dequantized weight
beside tinygemm; K11 at DeepSeek's wave A (gate_up and down, 16,384 rows,
bm 128) and Mixtral's (gate_up) beside K12's device ms on the same shape
and torch._grouped_mm on the dequantized bank; every wave of phase 4 must
run no K1 or K11 call on the mma.sync tile and some on the wgmma tile
(launches by kernel, ``skt.route_launch_counts()``); a torch.profiler
capture of wave A's packed prefill step on the Llama, DeepSeek and
Mixtral W4A16 engines gives device ms by kernel group ([profile-prefill]
lines). The kernels line gives K1's and K11's sources and launches by
kernel. Slice 18 (K7 and K9 at head dim 576 on one wgmma tile of 64
(position, head) rows): phase 2's 576 rows drive the MLA form (V read from
K's own boxes, q's two parts where they lie, 512-wide output) and give
CUDA-graph ms and TFLOP/s; the extend row also holds the public form with a
padded V to its twin; the prefill profiles give the 576 tile's device ms as
a group of its own; every DeepSeek and NSA wave that prefills must launch
K7 or K9 at 576 (wave A the packed K9, waves B+C and D K7); the kernels
line gives K7's and K9's 576 rows beside their 64 / 128 ones. Slice 19
(each engine's decode step as one captured CUDA graph, and decode_burst):
phase 4's decode steps are graph replays (the graph captured at the
engine's warm-up; a wave fails on any eager decode call or no replay), K1
and K10 counted by regime around the engine's decode step, the replays'
launches through the graph's tally, which must hold every kernel of the
decode step; phase 5 traces 4 steps eager (``eng._eager_decode``) and 4
graphed on the same batch, for every engine of phase 4 (the int8-KV and
8-layer Mixtral engines added), with host launches a step, the replay's
device ms by CUDA events, and one step's graphed logits against eager ones
on the same inputs within the element-wise gate (``graph_vs_eager``); the
burst phase (``phase_burst``) runs 16 greedy requests through the Llama
W4A16 and DeepSeek W4A16 + int8 engines at decode_burst=8 and 1 on the same
weights: ms per token, and identical tokens but for near ties within the
gate. Each phase prints its time ([time] lines).

Prints a JSON line of per-kernel numbers, then, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a CUDA device or without the
package beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA data sheet)
BF16_FLOPS = 989e12         # dense bf16 tensor-core peak
FP8_FLOPS = 1979e12         # dense fp8 tensor-core peak (H100 SXM data sheet)
INT8_OPS = 1979e12          # dense int8 tensor-core peak (H100 SXM data sheet)
F32_FLOPS = 67e12           # float32 outside the tensor cores
SEED = 20261016
DEVICE = "cuda"


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def bound_ms(n_bytes, n_ops, peak):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, reps=20):
    """Device time of one call: ``reps`` calls captured in a CUDA graph and
    replayed, so no host launch path sits between them (back-to-back
    launches timed with events measure the host when a kernel is shorter
    than its launch path)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(torch, graph.replay, iters=5, warmup=1) / reps


def launch_floor_ms(torch):
    """The device time of one empty kernel (torch.cuda._sleep(0)) as a
    CUDA-graph node: the least any kernel of a captured step costs."""
    return graph_ms(torch, lambda: torch.cuda._sleep(0), reps=100)


COLD_BYTES = 150e6  # a stacked bank three times the 50 MB L2: a call cycling its layers finds them cold


def cold_graph_ms(torch, fn, layers, reps=24):
    """Device time of one call with its weights cold: ``reps`` calls
    captured in a CUDA graph and replayed, call i on layer i % ``layers``
    of a stacked bank of at least COLD_BYTES (``fn(layer_id)``), so each
    call's weights left L2 since their last use, as in a model's step."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for lid in range(layers):
            fn(lid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i % layers)
    return time_ms(torch, graph.replay, iters=5, warmup=1) / reps


def cold_bank(torch, gen, lead, k, n, g, dev):
    """Random int4 codes [L, *lead, K/2, N] and bf16 scales [L, *lead, K/G,
    N] of ``L`` layers, the fewest whose codes reach COLD_BYTES (timing
    only: the checks run on quantized weights)."""
    per = k // 2 * n
    for e in lead:
        per *= e
    layers = max(2, -(-int(COLD_BYTES) // per))
    w = torch.randint(0, 256, (layers, *lead, k // 2, n), generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)
    scales = (0.005 + 0.01 * torch.rand((layers, *lead, k // g, n), generator=gen, device=dev)).to(torch.bfloat16)
    return w, scales, layers


def free_memory(torch):
    """Free a dropped engine's weights and pools now: its instrumented
    methods (``instrument``) hold it in a reference cycle."""
    gc.collect()
    torch.cuda.empty_cache()


def max_err(torch, a, b):
    return float((a.float() - b.float()).abs().max())


WORST = {"ratio": 0.0, "name": None}  # the worst err/tol of every check() gate in the run


def check(name, pairs):
    """Element-wise: |out - ref| <= 2^-7 |ref| + 2^-12 max|ref row|.
    Kernel and plain version both compute in float32 and round once to
    bf16, so they may land one bf16 ulp apart (at most 2^-7 of the value);
    the second term covers float32 sums taken in another order near zero
    (~2^-20 of the row's scale), far below bf16 resolution. A row is the
    last dim (one head or one hidden vector)."""
    err, ratio = 0.0, 0.0
    for out, ref in pairs:
        o, r = out.float(), ref.float()
        tol = 2.0 ** -7 * r.abs() + 2.0 ** -12 * r.abs().amax(-1, keepdim=True)
        diff = (o - r).abs()
        err = max(err, float(diff.max()))
        ratio = max(ratio, float((diff / tol).nan_to_num(0.0, posinf=float("inf")).max()))
    log(f"[kernel] {name}: max_abs_err={err:.6g} worst err/tol={ratio:.4g}")
    if ratio > WORST["ratio"]:
        WORST.update(ratio=ratio, name=name)
    if not ratio <= 1.0:
        fail(f"{name} disagrees with its plain version: err/tol {ratio} > 1")
    return err


def check_repeat(name, fn, first):
    """The bit-equality gate of the kernels that merge partials across
    blocks (K1's split-K, K5's spans): a second call gives the same bits."""
    again = fn()
    pairs = list(zip(first, again)) if isinstance(first, tuple) else [(first, again)]
    if not all(a.shape == b.shape and a.equal(b) for a, b in pairs):
        fail(f"{name}: two calls differ")
    log(f"[kernel] {name}: two calls bit-equal")


def check_lse(name, lse, ref):
    """K16's natural-log lse, which both sides compute in float32: the same
    -inf rows, and |lse - ref| <= 1e-5 |ref| + 1e-4 on the finite ones."""
    if not bool((lse.isneginf() == ref.isneginf()).all()):
        fail(f"{name}: the lse's -inf rows differ from the plain version's")
    fin = ref.isfinite()
    diff = (lse[fin] - ref[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ratio = float((diff / (1e-5 * ref[fin].abs() + 1e-4)).max()) if diff.numel() else 0.0
    log(f"[kernel] {name} lse: max_abs_err={err:.6g} worst err/tol={ratio:.4g}")
    if not ratio <= 1.0:
        fail(f"{name}: the lse disagrees with its plain version: err/tol {ratio} > 1")
    return err


def phase_build(skt_build, native):
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # the host C++ build beside nvcc's
        host = pool.submit(native.build)
        logs = skt_build.build_all()
        lib = host.result()
    build_s = time.perf_counter() - t0
    log(f"[build] {len(skt_build.sources())} sources and {lib.name} in {build_s:.2f} s (compiled: {sorted(logs)})")
    for stem, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower() or "Performance Loss" in line:
                log(f"[build] {stem}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    log(card)
    return build_s, card


def phase_kernels(torch, skt):
    """Each kernel against its plain version at the serving path's shapes."""
    from sgl_kernel_tpu_torch.ops import kvcache, norm, rope
    from sgl_kernel_tpu_torch.ops.attention import flash_prefill, paged_decode_dma

    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    cfg = skt.LlamaConfig.llama3_8b(fused=True)
    h, d, nq, nkv, n_layers = cfg.hidden_size, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    rows = {}

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # K2 rmsnorm at the decode [16, 4096] and prefill [1024, 4096] shapes
    w = randn(h)
    for r in (16, 1024):
        x = randn(r, h)
        out, ref = norm.rmsnorm(x, w, cfg.rms_eps), norm.rmsnorm_ref(x, w, cfg.rms_eps)
        err = check(f"rmsnorm[{r},{h}]", [(out, ref)])
        bms, bby = bound_ms(2 * r * h * 2 + h * 2, 4 * r * h, F32_FLOPS)
        fn, lib = (lambda: norm.rmsnorm(x, w, cfg.rms_eps)), (lambda: F.rms_norm(x, (h,), w, cfg.rms_eps))
        # event ms of a Triton launch read its host launcher; graph ms the device
        rows[f"rmsnorm_{r}"] = dict(
            max_abs_err=err, ms=time_ms(torch, fn),
            plain_ms=time_ms(torch, lambda: norm.rmsnorm_ref(x, w, cfg.rms_eps)),
            library_ms=time_ms(torch, lib), bound_ms=bms, bound_by=bby,
            graph_ms=graph_ms(torch, fn), library_graph_ms=graph_ms(torch, lib))

    # K3 rope_decode_fused_qkv at B=16
    b = 16
    cache = skt.build_rope_cache(cfg, device=dev)
    pos = torch.randint(0, cfg.max_position, (b,), generator=gen, device=dev, dtype=torch.int32)
    qkv = randn(b, (nq + 2 * nkv) * d)
    kw = dict(num_q=nq, num_kv=nkv, head_dim=d)
    out = rope.rope_decode_fused_qkv(pos, qkv, cache, **kw)
    ref = rope.rope_decode_fused_qkv_ref(pos, qkv, cache, **kw)
    err = check("rope_decode_fused_qkv[16]", list(zip(out, ref)))
    bms, bby = bound_ms(2 * b * (nq + 2 * nkv) * d * 2 + b * d * 4 + b * 4, 6 * b * (nq + nkv) * d, F32_FLOPS)
    k3 = lambda: rope.rope_decode_fused_qkv(pos, qkv, cache, **kw)
    rows["rope_decode_fused_qkv"] = dict(
        max_abs_err=err, ms=time_ms(torch, k3), graph_ms=graph_ms(torch, k3),
        plain_ms=time_ms(torch, lambda: rope.rope_decode_fused_qkv_ref(pos, qkv, cache, **kw)),
        library_ms=None, bound_ms=bms, bound_by=bby)
    log(f"[kernel] rope_decode_fused_qkv [16]: ms={rows['rope_decode_fused_qkv']['ms']:.4f} "
        f"graph_ms={rows['rope_decode_fused_qkv']['graph_ms']:.4f} bound_ms={bms:.4f}")

    # K5 decode attention: B=16, ragged contexts 1..1056 (lengths count the
    # current token, which rides as the fresh row), page 64, 32-layer pools,
    # the engine's 128-entry page tables
    page = 64
    lengths_l = [1 + (1055 * i) // (b - 1) for i in range(b)]
    n_used = [-(-(n - 1) // page) for n in lengths_l]
    n_pages = sum(n_used) + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    table = torch.zeros((b, cfg.max_position // page), dtype=torch.int32, device=dev)
    at = 0
    for i, n in enumerate(n_used):
        table[i, :n] = perm[at: at + n]
        at += n
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    pool_shape = (n_layers, n_pages, nkv, page, d)
    kp, vp = randn(*pool_shape), randn(*pool_shape)
    q, fk, fv = randn(b, nq, d), randn(b, nkv, d), randn(b, nkv, d)
    layer = n_layers - 1
    dkw = dict(layer_id=layer, fresh_k=fk, fresh_v=fv)
    out = paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lengths, table, **dkw)
    ref = paged_decode_dma.paged_attention_decode_ref(q, kp, vp, lengths, table, **dkw)
    err = check("paged_attention_decode_dma[16, ctx 1..1056]", [(out, ref)])
    k5 = lambda: paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lengths, table, **dkw)
    check_repeat("paged_attention_decode_dma[16, ctx 1..1056]", k5, out)
    pool_tokens = sum(n - 1 for n in lengths_l)
    n_bytes = 2 * pool_tokens * nkv * d * 2 + (2 * b * nq * d + 2 * b * nkv * d) * 2 + sum(n_used) * 4 + b * 4
    bms, bby = bound_ms(n_bytes, 4 * sum(lengths_l) * nq * d, BF16_FLOPS)
    rows["paged_attention_decode_dma"] = report_row(torch, "paged_attention_decode_dma[16, ctx 1..1056]", dict(
        max_abs_err=err, ms=time_ms(torch, k5),
        plain_ms=time_ms(torch, lambda: paged_decode_dma.paged_attention_decode_ref(q, kp, vp, lengths, table, **dkw)),
        library_ms=None, bound_ms=bms, bound_by=bby), k5)
    # the same attention over 1-byte pools with per-tensor scales (int8 at
    # the engine's kv_scale 1/16, fp8 e4m3 at 0.5): a 1-byte row halves
    # the pool bytes
    for kind, kv_dt, scale in (("int8", torch.int8, 1 / 16), ("e4m3", torch.float8_e4m3fn, 0.5)):
        if kv_dt == torch.int8:
            kq, vq = (torch.randint(-127, 128, pool_shape, generator=gen, device=dev, dtype=torch.int32).to(kv_dt)
                      for _ in range(2))
        else:
            kq, vq = ((torch.randn(pool_shape, generator=gen, device=dev) * 4).to(kv_dt) for _ in range(2))
        qkw = dict(dkw, k_scale=scale, v_scale=scale)
        out = paged_decode_dma.paged_attention_decode_dma(q, kq, vq, lengths, table, **qkw)
        ref = paged_decode_dma.paged_attention_decode_ref(q, kq, vq, lengths, table, **qkw)
        err = check(f"paged_attention_decode_dma {kind} pools", [(out, ref)])
        k5q = lambda: paged_decode_dma.paged_attention_decode_dma(q, kq, vq, lengths, table, **qkw)
        check_repeat(f"paged_attention_decode_dma {kind} pools", k5q, out)
        q_bytes = 2 * pool_tokens * nkv * d + (2 * b * nq * d + 2 * b * nkv * d) * 2 + sum(n_used) * 4 + b * 4
        bms, bby = bound_ms(q_bytes, 4 * sum(lengths_l) * nq * d, BF16_FLOPS)
        rows[f"paged_attention_decode_dma_{kind}"] = report_row(torch, f"paged_attention_decode_dma {kind}", dict(
            max_abs_err=err, ms=time_ms(torch, k5q),
            plain_ms=time_ms(torch, lambda: paged_decode_dma.paged_attention_decode_ref(q, kq, vq, lengths, table,
                                                                                        **qkw)),
            library_ms=None, bound_ms=bms, bound_by=bby), k5q)
        del kq, vq
    del kp, vp

    # K6 all-layers KV store: B=16 tokens of 32 layers into 1024-page pools,
    # one padding row (slot -1)
    pool_shape = (n_layers, 1024, nkv, page, d)
    kp, vp = randn(*pool_shape), randn(*pool_shape)
    kp2, vp2 = kp.clone(), vp.clone()
    slots = torch.randperm(1024 * page, generator=gen, device=dev)[:b].to(torch.int32)
    slots[-1] = -1
    ka, va = randn(n_layers, b, nkv, d), randn(n_layers, b, nkv, d)
    kvcache.store_cache_all_layers(ka, va, kp, vp, slots)
    kvcache.store_cache_all_layers_ref(ka, va, kp2, vp2, slots)
    err = max(max_err(torch, kp, kp2), max_err(torch, vp, vp2))
    log(f"[kernel] store_cache_all_layers[32, 16]: max_abs_err={err:.6g} (a copy: must be exact)")
    if err != 0.0:
        fail(f"store_cache_all_layers disagrees with its plain version: {err}")
    del kp2, vp2
    # only the valid tokens' K/V rows are read and written; the dropped
    # token's slot (-1) is read, its rows are not
    valid = b - 1
    n_bytes = 2 * 2 * n_layers * valid * nkv * d * 2 + b * 4
    bms, bby = bound_ms(n_bytes, 0, BF16_FLOPS)
    # yardstick: one index_copy_ per pool over precomputed row ids
    rows_ids = (kvcache._page_major_slots(slots[:valid], 1024, nkv, page)[None]
                + (torch.arange(n_layers, device=dev) * 1024 * nkv * page)[:, None, None]).reshape(-1)
    flat_k, flat_v = kp.view(-1, d), vp.view(-1, d)
    ka_v, va_v = ka[:, :valid].reshape(-1, d), va[:, :valid].reshape(-1, d)
    fn = lambda: kvcache.store_cache_all_layers(ka, va, kp, vp, slots)
    lib = lambda: (flat_k.index_copy_(0, rows_ids, ka_v), flat_v.index_copy_(0, rows_ids, va_v))
    rows["store_cache_all_layers"] = dict(
        max_abs_err=err, ms=time_ms(torch, fn),
        plain_ms=time_ms(torch, lambda: kvcache.store_cache_all_layers_ref(ka, va, kp, vp, slots)),
        library_ms=time_ms(torch, lib), bound_ms=bms, bound_by=bby, graph_ms=graph_ms(torch, fn),
        library_graph_ms=graph_ms(torch, lib))
    # K6 at a Llama mixed step's T = 1,040 (16 decode rows and a 1,024-token
    # chunk) into the same pools: distinct slots but a repeated one and two
    # dropped (-1), as a step's padding rows are
    t_mix = b + 1024
    slots = torch.randperm(1024 * page, generator=gen, device=dev)[:t_mix].to(torch.int32)
    slots[7] = slots[900]
    slots[-2:] = -1
    ka, va = randn(n_layers, t_mix, nkv, d), randn(n_layers, t_mix, nkv, d)
    kp2, vp2 = kp.clone(), vp.clone()
    kvcache.store_cache_all_layers(ka, va, kp, vp, slots)
    kvcache.store_cache_all_layers_ref(ka, va, kp2, vp2, slots)
    err = max(max_err(torch, kp, kp2), max_err(torch, vp, vp2))
    same = torch.equal(kp, kp2) and torch.equal(vp, vp2)
    log(f"[kernel] store_cache_all_layers[{n_layers}, {t_mix}]: max_abs_err={err:.6g} bit-equal={same} (must be)")
    if not same:
        fail(f"store_cache_all_layers at T = {t_mix} differs from its plain version: {err}")
    del kp2, vp2
    keep = torch.ones(t_mix, dtype=torch.bool, device=dev)
    keep[7] = False  # token 7's rows lose to token 900's (one slot)
    keep[-2:] = False
    valid = int(keep.sum())
    n_bytes = 2 * 2 * n_layers * valid * nkv * d * 2 + t_mix * 4
    bms, bby = bound_ms(n_bytes, 0, BF16_FLOPS)
    rows_ids = (kvcache._page_major_slots(slots[keep], 1024, nkv, page)[None]
                + (torch.arange(n_layers, device=dev) * 1024 * nkv * page)[:, None, None]).reshape(-1)
    ka_v, va_v = ka[:, keep].reshape(-1, d), va[:, keep].reshape(-1, d)
    fn = lambda: kvcache.store_cache_all_layers(ka, va, kp, vp, slots)
    lib = lambda: (flat_k.index_copy_(0, rows_ids, ka_v), flat_v.index_copy_(0, rows_ids, va_v))
    rows["store_cache_all_layers_mixed"] = dict(
        max_abs_err=err, ms=time_ms(torch, fn),
        plain_ms=time_ms(torch, lambda: kvcache.store_cache_all_layers_ref(ka, va, kp, vp, slots), iters=3),
        library_ms=time_ms(torch, lib), bound_ms=bms, bound_by=bby, graph_ms=graph_ms(torch, fn),
        library_graph_ms=graph_ms(torch, lib))
    del kp, vp, flat_k, flat_v, ka, va, ka_v, va_v

    # K7 flash prefill: one prompt of 1000 tokens in its 1024 bucket, causal
    s, q_len = 1024, 1000
    q, k, v = randn(1, s, nq, d), randn(1, s, nkv, d), randn(1, s, nkv, d)
    ql = torch.tensor([q_len], dtype=torch.int32, device=dev)
    out = flash_prefill.flash_attention(q, k, v, ql, ql, causal=True)
    ref = flash_prefill.flash_attention_ref(q, k, v, ql, ql, causal=True)
    err = check("flash_attention[1024, causal]", [(out[:, :q_len], ref[:, :q_len])])
    if not torch.isfinite(out).all():
        fail("flash_attention: non-finite padding rows")
    # reads: the q_len valid rows of q, k and v; writes: all s output rows
    # (padding rows too, which must come out finite)
    n_bytes = (q_len * (nq + 2 * nkv) * d + s * nq * d) * 2
    bms, bby = bound_ms(n_bytes, 4 * d * nq * q_len * (q_len + 1) // 2, BF16_FLOPS)
    qt, kt, vt = (x[:, :q_len].transpose(1, 2).contiguous() for x in (q, k, v))
    fn = functools.partial(flash_prefill.flash_attention, q, k, v, ql, ql, causal=True)
    lib = functools.partial(F.scaled_dot_product_attention, qt, kt, vt, is_causal=True, enable_gqa=True)
    rows["flash_attention"] = device_rate(torch, dict(
        max_abs_err=err, ms=time_ms(torch, fn),
        plain_ms=time_ms(torch, lambda: flash_prefill.flash_attention_ref(q, k, v, ql, ql, causal=True), iters=5),
        library_ms=time_ms(torch, lib), bound_ms=bms, bound_by=bby), fn, 4 * d * nq * q_len * (q_len + 1) // 2, lib)
    rows.update(packed_and_extend_rows(torch, skt, gen, randn, cfg))
    for name, r in rows.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        dev_t = "".join(f" {key}={r[key]:.4f}" for key in ("graph_ms", "library_graph_ms", "tflops", "library_tflops")
                        if r.get(key) is not None)
        log(f"[kernel] {name}: ms={r['ms']:.4f}{dev_t} plain_ms={r['plain_ms']:.4f} library_ms={lib} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
    return rows


def device_rate(torch, row, fn, n_ops, lib=None):
    """Add the CUDA-graph device ms of ``fn`` and the TFLOP/s it achieves on
    the ``n_ops`` the work needs; with ``lib`` (the library yardstick) its
    graph ms and TFLOP/s too, or the reason it could not be captured."""
    row["graph_ms"] = graph_ms(torch, fn)
    row["tflops"] = n_ops / row["graph_ms"] / 1e9
    if lib is not None:
        try:
            row["library_graph_ms"] = graph_ms(torch, lib)
            row["library_tflops"] = n_ops / row["library_graph_ms"] / 1e9
        except Exception as e:  # the yardstick is not capturable in this torch
            torch.cuda.synchronize()
            row["library_graph_ms"] = None
            row["library_graph_note"] = f"not captured: {type(e).__name__}: {str(e).splitlines()[0][:100]}"
    return row


def serve_lens(n_req):
    """Wave A's prompt lengths: n_req evenly from 16 to 1024 tokens."""
    return [16 + (1008 * i) // (n_req - 1) for i in range(n_req)]


def packed_library(torch, F, q, k, v, lens, tok0, ref, scale=None):
    """One SDPA call over jagged nested tensors (causal) computing K9's
    function on the same valid rows, as the library yardstick: with
    ``enable_gqa``, or, where this PyTorch refuses GQA over jagged tensors,
    on K/V whose heads are repeated to the query's beforehand (outside the
    timed call). Returns (fn, note): fn None when both are refused or the
    result disagrees with the plain version by more than 2^-6 of its scale."""
    dev = q.device
    idx = torch.cat([torch.arange(t0, t0 + n, device=dev) for t0, n in zip(tok0, lens)])
    offsets = torch.tensor([0] + list(itertools.accumulate(lens)), device=dev)
    group = q.shape[1] // k.shape[1]
    notes = []
    for gqa in (True, False):
        kv = [x[idx] if gqa else x[idx].repeat_interleave(group, dim=1) for x in (k, v)]
        njt = [torch.nested.nested_tensor_from_jagged(x, offsets).transpose(1, 2) for x in [q[idx]] + kv]

        def fn(njt=njt, gqa=gqa):
            return F.scaled_dot_product_attention(*njt, is_causal=True, scale=scale, enable_gqa=gqa)

        try:
            out = fn().transpose(1, 2).values()
        except Exception as e:  # this PyTorch refuses this form over jagged tensors
            notes.append(f"enable_gqa={gqa} refused: {type(e).__name__}: {str(e).splitlines()[0][:120]}")
            continue
        err = float((out.float() - ref[idx].float()).abs().max())
        if err > 2.0 ** -6 * float(ref.float().abs().max()):
            return None, "; ".join(notes + [f"enable_gqa={gqa} disagrees with the plain version by {err:.4g}"])
        return fn, "; ".join(notes + [f"enable_gqa={gqa}: max_abs_err {err:.4g}"])
    return None, "SDPA over jagged nested tensors: " + "; ".join(notes)


def packed_and_extend_rows(torch, skt, gen, randn, cfg):
    """K9 at the packed shape of phase 4's wave A (16 prompts of 16..1024
    tokens, block 256, 64 blocks of which 24 pad), with lse; K7's two
    extend passes with lse, 512 fresh tokens over a 512-token prefix and
    wave C's 1,024-token chunk over a 3,072-token prefix."""
    from sgl_kernel_tpu_torch.ops.attention import flash_packed, flash_prefill, merge_state
    from sgl_kernel_tpu_torch.serving.engine import packed_layout

    F = torch.nn.functional
    dev = torch.device(DEVICE)
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rows = {}
    lens = serve_lens(16)
    blk_seq, blk_q0, seq_meta, tok0, tp, max_kvb = packed_layout(lens, 17)
    ints = [torch.from_numpy(a).to(dev) for a in (blk_seq, blk_q0, seq_meta)]
    q, k, v = randn(tp, nq, d), randn(tp, nkv, d), randn(tp, nkv, d)
    kw = dict(max_kvb=max_kvb, causal=True, return_lse=True)
    out, lse = flash_packed.flash_attention_packed(q, k, v, *ints, **kw)
    ref, ref_lse = flash_packed.flash_attention_packed_ref(q, k, v, *ints, **kw)
    pairs = []
    for t0, n in zip(tok0, lens):
        pairs += [(out[t0: t0 + n], ref[t0: t0 + n]), (lse[:, t0: t0 + n], ref_lse[:, t0: t0 + n])]
    err = check(f"flash_attention_packed[{tp} tokens, 16 prompts, lse]", pairs)
    if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
        fail("flash_attention_packed: non-finite rows")
    n_tok = sum(lens)
    # reads: the valid rows of q, k and v; writes: every packed output row
    # and lse entry (padding rows too)
    n_bytes = n_tok * (nq + 2 * nkv) * d * 2 + tp * nq * d * 2 + nq * tp * 4
    n_ops = 4 * nq * d * sum(n * (n + 1) // 2 for n in lens)
    bms, bby = bound_ms(n_bytes, n_ops, BF16_FLOPS)
    lib_fn, lib_note = packed_library(torch, F, q, k, v, lens, tok0, ref)
    fn = functools.partial(flash_packed.flash_attention_packed, q, k, v, *ints, **kw)
    rows["flash_attention_packed"] = device_rate(torch, dict(
        max_abs_err=err, ms=time_ms(torch, fn),
        plain_ms=time_ms(torch, lambda: flash_packed.flash_attention_packed_ref(q, k, v, *ints, **kw), iters=3),
        library_ms=None if lib_fn is None else time_ms(torch, lib_fn), bound_ms=bms, bound_by=bby,
        library_note=lib_note), fn, n_ops)
    log(f"[kernel] flash_attention_packed library: {lib_note}")
    del q, k, v, out, ref, lse, ref_lse
    rows["flash_attention_lse"] = extend_row(torch, gen, randn, cfg, 512, 512)
    rows["flash_attention_extend_c"] = extend_row(torch, gen, randn, cfg, 1024, 3072)
    return rows


def extend_row(torch, gen, randn, cfg, s, pre):
    """K7's two extend passes (llama._extend_attention) with lse, s fresh
    tokens over a pre-token prefix: the fresh rows causal at global offsets,
    then the prefix fully visible; the yardstick is one SDPA over prefix +
    fresh keys with the extend mask (the merged output; SDPA returns no
    lse)."""
    from sgl_kernel_tpu_torch.ops.attention import flash_prefill, merge_state

    F = torch.nn.functional
    dev = torch.device(DEVICE)
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k1, v1 = randn(1, s, nq, d), randn(1, s, nkv, d), randn(1, s, nkv, d)
    k2, v2 = randn(1, pre, nkv, d), randn(1, pre, nkv, d)
    ql = torch.tensor([s], dtype=torch.int32, device=dev)
    pl_ = torch.tensor([pre], dtype=torch.int32, device=dev)
    zero = torch.zeros_like(pl_)

    def passes(fn):
        return (fn(q, k1, v1, ql, ql, None, pl_, pl_, causal=True, return_lse=True)
                + fn(q, k2, v2, ql, pl_, None, pl_, zero, causal=True, return_lse=True))

    got, want = passes(flash_prefill.flash_attention), passes(flash_prefill.flash_attention_ref)
    err = check(f"flash_attention lse, extend {s} over {pre}", list(zip(got, want)))
    del want
    n_bytes = (s * nq * d + 2 * (s + pre) * nkv * d) * 2 + 2 * (s * nq * d * 2 + nq * s * 4)
    n_ops = 4 * nq * d * (s * (s + 1) // 2 + s * pre)
    bms, bby = bound_ms(n_bytes, n_ops, BF16_FLOPS)
    qt = q.transpose(1, 2)
    kt, vt = (torch.cat([a, b], 1).transpose(1, 2) for a, b in ((k2, k1), (v2, v1)))
    mask = torch.arange(pre + s, device=dev)[None, :] <= (pre + torch.arange(s, device=dev))[:, None]
    o1, l1, o2, l2 = got
    merged, _ = merge_state(o1[0], l1[0].t(), o2[0], l2[0].t())
    lib = functools.partial(F.scaled_dot_product_attention, qt, kt, vt, attn_mask=mask, enable_gqa=True)
    lib_err = float((lib().transpose(1, 2)[0].float() - merged.float()).abs().max())
    log(f"[kernel] flash_attention lse {s} over {pre} library (SDPA with the extend mask vs merged passes): "
        f"max_abs_err {lib_err:.4g}")
    fn = functools.partial(passes, flash_prefill.flash_attention)
    return device_rate(torch, dict(
        max_abs_err=err, ms=time_ms(torch, fn),
        plain_ms=time_ms(torch, lambda: passes(flash_prefill.flash_attention_ref), iters=3 if pre > 512 else 5),
        library_ms=time_ms(torch, lib), bound_ms=bms, bound_by=bby), fn, n_ops, lib)

def int4pack_yardstick(torch, w, scales, group):
    """torch._weight_int4pack_mm (tinygemm) over the same int4 weights: the
    library's timing yardstick, which the port never calls. Our nibble c
    in [-8, 7] becomes q = c + 8 (= nibble ^ 8) with zero 0, since tinygemm
    computes (q - 8) * s + z. Returns (fn, None), or (None, reason)."""
    from sgl_kernel_tpu_torch.ops.gemm.w4a16 import unpack_w4_tpu

    if not (hasattr(torch, "_weight_int4pack_mm") and hasattr(torch, "_convert_weight_to_int4pack")):
        return None, "this torch has no _weight_int4pack_mm"
    q = (unpack_w4_tpu(w) ^ 8).t().contiguous()  # [N, K] in 0..15
    try:  # [N, K/2] bytes, the even k in the high nibble
        packed = torch._convert_weight_to_int4pack(((q[:, ::2] << 4) | q[:, 1::2]).contiguous(), 8)
    except RuntimeError as e:
        return None, f"_convert_weight_to_int4pack refused the weights: {str(e).splitlines()[0]}"
    sz = torch.stack([scales.to(torch.bfloat16), torch.zeros_like(scales, dtype=torch.bfloat16)], -1).contiguous()
    return (lambda a: torch._weight_int4pack_mm(a, packed, group, sz)), None


def int4pack_ms(torch, a0, w, scales, group):
    """(event ms, CUDA-graph ms, note) of the library yardstick on the bare
    GEMM a0 @ W, or (None, None, reason). The library call is held to the
    plain version without prologue or epilogue; tinygemm rounds each
    dequantized weight to bf16, 2^-9 relative, so 2^-6 of the output's
    scale."""
    from sgl_kernel_tpu_torch.ops.gemm import w4a16

    fn, note = int4pack_yardstick(torch, w, scales, group)
    if fn is None:
        return None, None, note
    bare = w4a16.w4a16_gemm_ref(a0, w, scales, group_size=group).float()
    lib_err = float((fn(a0).float() - bare).abs().max())
    if lib_err > 2.0 ** -6 * float(bare.abs().max()):
        return None, None, f"_weight_int4pack_mm disagrees with the plain GEMM by {lib_err:.4g}"
    call = lambda: fn(a0)
    return time_ms(torch, call), graph_ms(torch, call), f"max_abs_err {lib_err:.4g}"


def kernels_per_call(torch, fn, calls=4):
    """K1's kernels in one decode call, from a torch.profiler trace of
    ``calls`` calls: its rows pass, then the decode GEMM, which programmatic
    dependent launch lets start before the rows pass ends (``overlap_us`` >
    0: the GEMM began that long before the rows pass finished; the profiler
    serialises kernels, so a trace may show none). The trace may miss its
    first kernel, so it is read from the first rows pass on. Fails on any
    other sequence."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evts = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    names = [e.name for e in evts]
    first = next((i for i, n in enumerate(names) if "act_rows_kernel" in n), len(names))
    seq = evts[first:]
    pairs = len(seq) // 2
    ok = (len(seq) % 2 == 0 and pairs >= calls - 1
          and all("act_rows_kernel" in seq[2 * i].name and "w4a16_decode_kernel" in seq[2 * i + 1].name
                  for i in range(pairs)))
    if not ok:
        fail(f"w4a16_gemm: each decode call must be the rows pass and the decode kernel, got {names}")
    res = dict(kernels_per_call=2, calls_traced=pairs,
               overlap_us=max(seq[2 * i].time_range.end - seq[2 * i + 1].time_range.start for i in range(pairs)))
    log(f"[kernel] w4a16_gemm kernels a decode call: {json.dumps(res)}")
    return res


def inner_call_ms(torch, module, attr, fn):
    """(device ms, calls) of the calls that one call of ``fn`` makes to
    ``module.attr`` (a kernel's wrapper), CUDA events recorded on the stream
    around each: the kernel's device time inside a path whose other work
    (gathers, copies) runs on the same stream."""
    real, spans = getattr(module, attr), []

    def timed(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kw)
        end.record()
        spans.append((start, end))
        return out

    timed.launches = real.launches  # the wrapper counts on its module-level name, now this one
    setattr(module, attr, timed)
    try:
        fn()
    finally:
        setattr(module, attr, real)
        real.launches = timed.launches
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in spans), len(spans)


def phase_w4a16(torch, skt):
    """K1 against its plain version at the W4A16 Llama-3-8B GEMMs: the five
    decode GEMMs of a step (M=16) with the prologue and epilogue each has on
    the path, two prefill GEMMs (M=1024) and wave A's packed gate_up (M =
    16,384), an mxfp4 and a zeros+bias case. Rows past 32 must run the wgmma
    tile (its route counter) and give cuBLAS's bf16 product on the
    dequantized weight beside tinygemm as a second yardstick."""
    from sgl_kernel_tpu_torch.ops.gemm import w4a16

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    bf = torch.bfloat16
    g = 128
    rows = {}
    cases = [("qkv", 16, 6144, 4096, "norm"), ("o", 16, 4096, 4096, "residual"),
             ("gate_up", 16, 28672, 4096, "norm"), ("down", 16, 4096, 14336, "fused"),
             ("lm_head", 16, 129024, 4096, "norm"), ("gate_up_prefill", 1024, 28672, 4096, None),
             ("down_prefill", 1024, 4096, 14336, "fused"), ("gate_up_wave_a", 16384, 28672, 4096, None),
             ("mxfp4", 16, 4096, 4096, "mxfp4"),
             ("zeros_bias", 16, 4096, 4096, "zeros_bias")]
    for name, m, n, k, opt in cases:
        kw = dict(group_size=g)
        if opt == "mxfp4":
            kw.update(fmt="mxfp4", group_size=32)
            w = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)
            scales = torch.exp2(torch.randint(-8, -3, (k // 32, n), generator=gen, device=dev).float()).to(bf)
        else:
            wf = torch.randn((n, k), generator=gen, device=dev) * 0.02 + (0.005 if opt == "zeros_bias" else 0.0)
            w, scales, zeros = w4a16.quantize_w4(wf, group_size=g, symmetric=opt != "zeros_bias")
            del wf
            if opt == "zeros_bias":
                kw.update(zeros=zeros, bias=torch.randn(n, generator=gen, device=dev))
        a = torch.randn((m, 2 * k if opt == "fused" else k), generator=gen, device=dev).to(bf)
        if opt == "norm":
            kw["norm_weight"] = (1 + 0.1 * torch.randn(k, generator=gen, device=dev)).to(bf)
        elif opt == "residual":
            kw["residual"] = torch.randn((m, n), generator=gen, device=dev).to(bf)
        elif opt == "fused":
            kw.update(prologue="silu_mul", fused_gate_up=True, residual=torch.randn((m, n), generator=gen,
                                                                                    device=dev).to(bf))
        wgmma_before = w4a16.w4a16_gemm.launches_by_route["wgmma"]
        out = w4a16.w4a16_gemm(a, w, scales, **kw)
        if m > 32 and w4a16.w4a16_gemm.launches_by_route["wgmma"] != wgmma_before + 1:
            fail(f"w4a16_gemm {name}: M={m} did not run the wgmma tile ({w4a16.w4a16_gemm.launches_by_route})")
        ref = w4a16.w4a16_gemm_ref(a, w, scales, **kw)
        err = check(f"w4a16_gemm {name} [{m}, {n}, {k}]", [(out, ref)])
        check_repeat(f"w4a16_gemm {name}", lambda: w4a16.w4a16_gemm(a, w, scales, **kw), out)
        per_call = kernels_per_call(torch, lambda: w4a16.w4a16_gemm(a, w, scales, **kw)) if m <= 32 else None
        del out, ref
        # bytes the call must move: codes, scales (and zeros), activations,
        # norm weight, residual, bias, the bf16 output
        n_bytes = (w.numel() + 2 * scales.numel() * (2 if "zeros" in kw else 1) + 2 * a.numel()
                   + (2 * k if opt == "norm" else 0) + (2 * m * n if "residual" in kw else 0)
                   + (4 * n if "bias" in kw else 0) + 2 * m * n)
        bms, bby = bound_ms(n_bytes, 2 * m * n * k, BF16_FLOPS)
        lib_ms, lib_graph, lib_note = None, None, "no library call for this format"
        if kw.get("fmt", "int4") == "int4" and "zeros" not in kw:
            lib_ms, lib_graph, lib_note = int4pack_ms(torch, a[:, :k].contiguous(), w, scales, g)
        rows[f"w4a16_gemm_{name}"] = dict(
            max_abs_err=err, ms=time_ms(torch, lambda: w4a16.w4a16_gemm(a, w, scales, **kw)),
            plain_ms=time_ms(torch, lambda: w4a16.w4a16_gemm_ref(a, w, scales, **kw), iters=5),
            library_ms=lib_ms, bound_ms=bms, bound_by=bby,
            graph_ms=graph_ms(torch, lambda: w4a16.w4a16_gemm(a, w, scales, **kw)), library_graph_ms=lib_graph,
            kernels_per_call=per_call)
        r = rows[f"w4a16_gemm_{name}"]
        if m > 32:  # cuBLAS's bf16 product on the dequantized weight, a yardstick the port never calls
            wd = w4a16.dequant_w4(w, scales, group_size=g).t().contiguous()
            a0 = a[:, :k].contiguous()
            r["cublas_bf16_graph_ms"] = graph_ms(torch, lambda: torch.matmul(a0, wd))
            r["tflops"] = 2 * m * n * k / r["graph_ms"] / 1e9
            r["cublas_bf16_tflops"] = 2 * m * n * k / r["cublas_bf16_graph_ms"] / 1e9
            log(f"[kernel] w4a16_gemm {name}: {r['tflops']:.1f} TFLOP/s on its graph ms, cuBLAS bf16 on the "
                f"dequantized weight {r['cublas_bf16_graph_ms']:.4f} ms ({r['cublas_bf16_tflops']:.1f} TFLOP/s)")
            del wd, a0
        if m == 16 and name in ("qkv", "o", "gate_up", "down", "lm_head"):  # the step's GEMMs with cold weights
            wc, sc_, layers = cold_bank(torch, gen, (), k, n, g, dev)
            r["cold_graph_ms"] = cold_graph_ms(torch, lambda lid: w4a16.w4a16_gemm(a, wc, sc_, layer_id=lid, **kw),
                                               layers)
            r["cold_layers"] = layers
            del wc, sc_
        lib = "null" if lib_ms is None else f"{lib_ms:.4f} [{lib_graph:.4f}]"
        cold = f" cold_graph_ms={r['cold_graph_ms']:.4f}" if "cold_graph_ms" in r else ""
        log(f"[kernel] w4a16_gemm {name} [{m}, {n}, {k}]: ms={r['ms']:.4f} graph_ms={r['graph_ms']:.4f}{cold} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={lib} ({lib_note}) bound_ms={bms:.4f} ({bby})")
        del a, w, scales, kw
        torch.cuda.empty_cache()
    return rows


PARITY_PROGRAMS = ("prefill", "decode", "packed", "extend", "mixed")


def phase_parity(torch, skt, cfg, label, programs=PARITY_PROGRAMS, n_decode=4):
    """Full width, 2 layers: the card against the CPU on the same weights
    (drawn on the card, copied to the CPU). ``programs``: the prefill of two
    prompts and ``n_decode`` decode steps, then on fresh pools a packed
    prefill, an extend and a mixed step (those named). A Mixtral config runs
    models/mixtral.py with its routing recorded on the CPU and replayed on
    the card (flips counted); a Llama config models/llama.py."""
    from sgl_kernel_tpu_torch.models import llama, mixtral
    from sgl_kernel_tpu_torch.serving.engine import packed_layout

    m = mixtral if isinstance(cfg, skt.MixtralConfig) else llama
    cfg = dataclasses.replace(cfg, num_layers=2)
    t0 = time.perf_counter()
    params_gpu = m.init_weights(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    to_cpu = lambda v: {k: to_cpu(x) for k, x in v.items()} if isinstance(v, dict) else v.cpu()
    params_cpu = to_cpu(params_gpu)
    page, n_pages, bucket = 64, 8, 64
    sides = {}
    for dev in ("cpu", DEVICE):
        caches = m.make_caches(cfg, n_pages, page, device=dev)
        sides[dev] = dict(params=params_cpu if dev == "cpu" else params_gpu, k=caches[0], v=caches[1],
                          rope=m.build_rope_cache(cfg, device=dev))
    rng = torch.Generator().manual_seed(SEED + 1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in (40, 23)]
    pages = [[1, 2], [3, 4]]
    slot = lambda i, p: pages[i][p // page] * page + p % page
    replay = RoutingReplay(mixtral, "topk_softmax") if m is mixtral else None

    def run(dev, name, *arrays, n_out=1, **kw):
        sd = sides[dev]
        if replay is not None:
            replay.mode = "record" if dev == "cpu" else "replay"
        ts = [torch.tensor(a, dtype=torch.int32, device=dev) for a in arrays]
        *logits, sd["k"], sd["v"] = getattr(m, name)(sd["params"], cfg, sd["k"], sd["v"], *ts, sd["rope"], **kw)
        logits = [x.float().cpu() for x in logits]
        return logits[0] if n_out == 1 else logits

    # bf16 activations at full width (bf16 or W4A16 weights): the two
    # devices round each linear's output (4096..28672-long dot products) in
    # another order, one bf16 ulp (2^-8) per element, and the error grows
    # through 2 layers and the final norm.
    tol = 0.25
    worst, near_ties, steps = 0.0, 0, 0

    def compare(lc, lg, what):
        nonlocal worst, near_ties, steps
        if not torch.isfinite(lg).all():
            fail(f"parity {label} {what}: non-finite logits on the card")
        err = float((lc - lg).abs().max())
        worst = max(worst, err)
        if err > tol:
            fail(f"parity {label} {what}: logits differ by {err} > {tol}")
        for row_c, row_g in zip(lc, lg):
            tc, tg = int(row_c.argmax()), int(row_g.argmax())
            steps += 1
            if tc != tg:
                # a flip is a near-tie only if the CPU's own margin is within tol
                if float(row_c[tc] - row_c[tg]) > tol:
                    fail(f"parity {label} {what}: greedy token {tg} on the card, {tc} on the CPU")
                near_ties += 1
        return lc.argmax(-1).tolist()

    try:
        seqs = []
        for i, pr in enumerate(prompts):
            n = len(pr)
            tok = [pr + [0] * (bucket - n)]
            pos = [list(range(n)) + [0] * (bucket - n)]
            sl = [[slot(i, p) for p in range(n)] + [-1] * (bucket - n)]
            out = {dev: run(dev, "prefill", tok, pos, [n], sl) for dev in ("cpu", DEVICE)}
            seqs.append(pr + compare(out["cpu"], out[DEVICE], f"prefill {i}"))
        for step in range(n_decode if "decode" in programs else 0):
            b = 4  # two sequences and two padding rows
            tokens = [s[-1] for s in seqs] + [0, 0]
            positions = [len(s) - 1 for s in seqs] + [0, 0]
            lengths = [len(s) for s in seqs] + [0, 0]
            slots = [slot(i, len(s) - 1) for i, s in enumerate(seqs)] + [-1, -1]
            tables = [p + [0] * (8 - len(p)) for p in pages] + [[0] * 8] * (b - 2)
            out = {dev: run(dev, "decode_step", tokens, positions, tables, lengths, slots) for dev in ("cpu", DEVICE)}
            nxt = compare(out["cpu"][:2], out[DEVICE][:2], f"decode {step}")
            for s, t in zip(seqs, nxt):
                s.append(t)
        # the admission programs on fresh pools: a packed prefill of both
        # prompts (block 256), an extend of 23 tokens of the first over its 40
        # cached ones, then the second's decode (with a padding row) fused with
        # a 20-token chunk of the first in one mixed step
        for dev in ("cpu", DEVICE):
            sides[dev]["k"], sides[dev]["v"] = m.make_caches(cfg, n_pages, page, device=dev)
        ext = torch.randint(0, cfg.vocab_size, (43,), generator=rng).tolist()
        lens = [len(p) for p in prompts]
        first = None
        if "packed" in programs:
            blk_seq, blk_q0, seq_meta, tok0, tp, max_kvb = packed_layout(lens, 3)
            tokens, positions, slots = [0] * tp, [0] * tp, [-1] * tp
            for i, (pr, t) in enumerate(zip(prompts, tok0)):
                tokens[t: t + len(pr)], positions[t: t + len(pr)] = pr, list(range(len(pr)))
                slots[t: t + len(pr)] = [slot(i, p) for p in range(len(pr))]
            last = [t + n - 1 for t, n in zip(tok0, lens)] + [0]
            out = {dev: run(dev, "prefill_packed", tokens, positions, blk_seq, blk_q0, seq_meta, last, slots,
                            max_kvb=max_kvb) for dev in ("cpu", DEVICE)}
            first = compare(out["cpu"][:2], out[DEVICE][:2], "prefill_packed")
        n0, s = lens[0], 32
        pad = lambda xs, fill: xs + [fill] * (s - len(xs))
        tab = lambda i: pages[i] + [0] * (8 - len(pages[i]))
        if "extend" in programs:
            out = {dev: run(dev, "prefill_extend", [pad(ext[:23], 0)], [pad(list(range(n0, n0 + 23)), 0)], [23],
                            [n0 + 23], [tab(0)], [pad([slot(0, p) for p in range(n0, n0 + 23)], -1)],
                            prefix_max=page)
                   for dev in ("cpu", DEVICE)}
            compare(out["cpu"], out[DEVICE], "prefill_extend")
        if "mixed" in programs:
            n1, p0 = lens[1], n0 + 23
            dec = ([first[1], 0], [n1, 0], [tab(1), [0] * 8], [n1 + 1, 1], [slot(1, n1), -1])
            out = {dev: run(dev, "mixed_step", *dec, pad(ext[23:43], 0), pad(list(range(p0, p0 + 20)), 0), 20,
                            p0 + 20, tab(0), pad([slot(0, p) for p in range(p0, p0 + 20)], -1), prefix_max=page,
                            n_out=2)
                   for dev in ("cpu", DEVICE)}
            compare(torch.cat([out["cpu"][0][:1], out["cpu"][1][None]]),
                    torch.cat([out[DEVICE][0][:1], out[DEVICE][1][None]]), "mixed_step")
    finally:
        if replay is not None:
            replay.restore()
    res = dict(max_logit_diff=worst, near_ties=near_ties, steps=steps)
    flips = ""
    if replay is not None:
        res.update(routing_flips=replay.flips, routed_tokens=replay.tokens)
        flips = f", routing flips replayed={replay.flips}/{replay.tokens} routed tokens"
    log(f"[parity] {label} 2-layer {type(cfg).__name__} {cfg.hidden_size}-wide, card vs CPU "
        f"({', '.join(programs)}): max |logit diff|={worst:.4g} (tol {tol}), "
        f"greedy near-ties={near_ties}/{steps}{flips}, {time.perf_counter() - t0:.1f} s")
    del params_gpu, sides
    free_memory(torch)
    return res


PREFIX = 512       # wave B's shared prefix: 8 pages of 64
NEW_TOKENS = 32
# the kernels each engine's waves must launch
LLAMA_BF16 = ("rmsnorm", "rope_decode_fused_qkv", "paged_attention_decode_dma", "store_cache_all_layers",
              "flash_attention", "flash_attention_packed")
LLAMA_W4 = LLAMA_BF16 + ("w4a16_gemm",)
LLAMA_W4_DMA = LLAMA_W4 + ("w4a16_gemm_dma",)
MIXTRAL_BF16 = ("rmsnorm", "rope_decode_fused", "paged_attention_decode_dma", "store_cache_all_layers",
                "flash_attention", "flash_attention_packed", "bf16_grouped_mm")
MIXTRAL_W4 = MIXTRAL_BF16[:-1] + ("w4a16_gemm", "w4a16_grouped_mm")
DEEPSEEK_BF16 = ("rmsnorm", "flash_attention", "flash_attention_packed", "bf16_grouped_mm", "mla_decode",
                 "mla_qkv_prep")
DEEPSEEK_W4 = DEEPSEEK_BF16[:3] + ("w4a16_gemm", "w4a16_grouped_mm", "mla_decode", "mla_qkv_prep")


def random_prompt(torch, gen, vocab, n):
    return torch.randint(1, vocab, (n,), generator=gen).tolist()


def instrument(eng):
    """Wrap one engine's programs to count K1 and K10 launches by regime
    (prefill programs, decode step, mixed step), the calls of each prefill program
    and the prompt tokens that mixed steps carry, and to keep each
    request's first-token logits while ``stats["capture"]`` is set. The
    decode regime is counted around the engine's decode step, so a graph
    replay's launches come in through its tally (a replay does not call the
    wrappers); ``eager_decode`` counts the adapter's decode calls, which on
    the card run only to warm up and capture a graph (or under the A/B
    switch ``eng._eager_decode``). Returns the stats dict."""
    import sgl_kernel_tpu_torch as skt

    gemm, gemm_dma = skt.KERNELS["w4a16_gemm"], skt.KERNELS["w4a16_gemm_dma"]
    stats = dict(by_regime={"prefill": 0, "decode": 0, "mixed": 0}, dma_by_regime={"prefill": 0, "decode": 0, "mixed": 0},
                 calls={}, mixed_tokens=0, first={}, capture=False, eager_decode=0)

    def counted(fn, regime, name=None):
        def call(*args, **kw):
            before, before_dma = gemm.launches, gemm_dma.launches
            out = fn(*args, **kw)
            stats["by_regime"][regime] += gemm.launches - before
            stats["dma_by_regime"][regime] += gemm_dma.launches - before_dma
            if name is not None:
                stats["calls"][name] = stats["calls"].get(name, 0) + 1
            return out
        return call

    for name in ("prefill", "prefill_packed", "prefill_extend"):
        setattr(eng.adapter, name, counted(getattr(eng.adapter, name), "prefill", name))
    eng._decode_batch = counted(eng._decode_batch, "decode")
    decode = eng.adapter.decode

    def eager_decode(*args):
        stats["eager_decode"] += 1
        return decode(*args)

    eng.adapter.decode = eager_decode
    try_mixed = counted(eng._try_mixed_step, "mixed")

    def mixed():
        pos = {r.rid: r.prefill_pos for r in eng.prefilling}
        pf = try_mixed()
        if pf is not None:
            stats["mixed_tokens"] += pf.prefill_pos - pos[pf.rid]
        return pf

    append = eng._append_tokens

    def capture(reqs, logits):
        if stats["capture"]:
            for i, r in enumerate(reqs):
                if not r.output:
                    stats["first"][r.rid] = logits[i].float().cpu()
        return append(reqs, logits)

    eng._try_mixed_step, eng._append_tokens = mixed, capture
    return stats


def run_wave(torch, skt, eng, stats, label, wave, prompts, sampled=(), expect=(), hits=None, min_mixed=0):
    """Serve ``prompts`` to completion: counts set to 0 just before and read
    just after; every kernel in ``expect`` must have launched. Returns the
    wave's numbers and request ids."""
    from sgl_kernel_tpu_torch.utils.metrics import Metrics

    eng.metrics = Metrics()
    stats["mixed_tokens"] = 0
    stats["calls"] = {}
    stats["eager_decode"] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    skt.reset_launch_counts()
    rids = [eng.add_request(p, max_new_tokens=NEW_TOKENS,
                            **(dict(temperature=0.8, top_p=0.9) if i in sampled else {}))
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    fin = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**skt.launch_counts(), **skt.head_dim_launch_counts(), **skt.route_launch_counts()}
    for rid in rids:
        out = fin[rid].output if rid in fin else None
        if out is None or len(out) != NEW_TOKENS or not all(0 <= t < eng.cfg.vocab_size for t in out):
            fail(f"serve {label} wave {wave}: request {rid} produced {out}")
    snap = eng.metrics.snapshot()
    if snap.get("nonfinite_logits", 0):
        fail(f"serve {label} wave {wave}: {snap['nonfinite_logits']} rows of non-finite logits")
    missing = [k for k in expect if counts[k] <= 0]
    if missing:
        fail(f"serve {label} wave {wave}: kernels never launched: {missing} ({counts})")
    hit = snap.get("prefix_cache_hit_tokens", 0)
    if hits is not None and hit != hits:
        fail(f"serve {label} wave {wave}: {hit} prefix-cache hit tokens, expected {hits}")
    n_mixed = snap.get("mixed_steps", 0)
    if n_mixed < min_mixed:
        fail(f"serve {label} wave {wave}: {n_mixed} mixed steps, expected >= {min_mixed}")
    replays = snap.get("decode_graph_replays", 0)
    if stats["eager_decode"] or replays <= 0:
        fail(f"serve {label} wave {wave}: {stats['eager_decode']} eager decode calls, {replays} graph replays")
    plain_tokens = snap["tokens_prefilled"] - stats["mixed_tokens"]
    res = dict(
        wave=wave, requests=len(rids), prompt_tokens=sum(len(p) for p in prompts),
        prefill_tokens=snap["tokens_prefilled"], prefill_tok_s=plain_tokens / snap["prefill_total_s"],
        prefill_s=snap["prefill_total_s"], decode_ms_step=snap.get("decode_mean_ms"),
        decode_steps=snap.get("decode_count", 0), decode_graph_replays=replays, mixed_steps=n_mixed,
        mixed_ms=snap.get("mixed_mean_ms"),
        mixed_prefill_tokens=stats["mixed_tokens"], prefix_cache_hit_tokens=hit, program_calls=dict(stats["calls"]),
        wall_s=wall, peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    log(f"[serve] {label} wave {wave}: " + json.dumps(res))
    return res, rids


def check_576(label, wave, res, name):
    """A DeepSeek or NSA wave's prefill attention ran the 576 tile of K7 or
    K9 (``name``: flash_attention_576 or flash_attention_packed_576)."""
    if res["launches"].get(name, 0) <= 0:
        fail(f"serve {label} wave {wave}: {name} launched {res['launches'].get(name)} times")


def phase_serve(torch, skt, cfg, label, kernels, n_a=16, n_b=12, wave_c=True, params=None, cold=True, mixed=True,
                num_pages=1024, after=None):
    """One main path: the default Engine serving ``cfg`` (Llama-3-8B,
    Mixtral-8x7B or DeepSeek-V2-Lite widths) in waves A, B (+ C). Each of
    ``kernels`` must launch in each wave that runs it, K1 in every regime
    the waves run; wave B hits exactly PREFIX tokens a prompt. Without
    ``mixed`` (a model with no mixed step) wave C's 4,096-token prompt must
    go in four chunks, one plain prefill and three extends (beside wave B's
    extends): zero mixed steps. ``after(eng, stats, res)`` runs further
    waves on the same engine after the cold check."""
    t0 = time.perf_counter()
    eng = skt.Engine(cfg, params, device=DEVICE, max_batch=16, page_size=64, num_pages=num_pages, seed=SEED,
                     prefill_chunk=1024)
    if eng.native is None:
        fail(f"serve {label}: the default engine has no prefix cache")
    torch.cuda.synchronize()
    log(f"[serve] {label}: engine up in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, KV pools {eng.caches[0].dtype}")
    # warm-up: two short prompts (one packed launch; no full page is cached)
    for n in (16, 40):
        eng.add_request(list(range(1, n + 1)), max_new_tokens=2)
    eng.run_until_done()
    eng.finished.clear()
    stats = instrument(eng)
    routing = None
    if cold and isinstance(cfg, skt.MixtralConfig):
        from sgl_kernel_tpu_torch.models import mixtral

        routing = TokenRouting(mixtral, "topk_softmax")
        routing.watch(eng)
        routing.mode = "record"

    gen = torch.Generator().manual_seed(SEED + 2)
    lens = serve_lens(n_a)
    prompts_a = [random_prompt(torch, gen, cfg.vocab_size, n) for n in lens]
    a, _ = run_wave(torch, skt, eng, stats, label, "A", prompts_a, sampled={3, 11},
                    expect=[k for k in kernels if k != "flash_attention"], hits=0)
    # wave B: each prompt the first PREFIX tokens of one of A's prompts of
    # 553 tokens or more (in turn), then a fresh suffix of 64..512 tokens
    donors = [p for p in prompts_a if len(p) >= 553]
    prompts_b = [donors[i % len(donors)][:PREFIX]
                 + random_prompt(torch, gen, cfg.vocab_size, 64 + (448 * i) // max(n_b - 1, 1)) for i in range(n_b)]
    prompts_c = [random_prompt(torch, gen, cfg.vocab_size, 4096)] if wave_c else []
    stats["capture"] = True
    bc, rids = run_wave(torch, skt, eng, stats, label, "B+C" if wave_c else "B", prompts_b + prompts_c,
                        expect=[k for k in kernels if k != "flash_attention_packed"], hits=n_b * PREFIX,
                        min_mixed=1 if wave_c and mixed else 0)
    stats["capture"] = False
    if not mixed and bc["mixed_steps"]:
        fail(f"serve {label}: {bc['mixed_steps']} mixed steps on a model without one")
    if not mixed and wave_c and bc["program_calls"] != {"prefill": 1, "prefill_extend": n_b + 3}:
        fail(f"serve {label}: wave C's prompt in chunks by {bc['program_calls']}, expected one prefill and "
             f"{n_b} + 3 extends")
    want = {"prefill", "decode"} | ({"mixed"} if wave_c and mixed else set())
    if "w4a16_gemm_dma" in kernels:
        # gemm_impl="dma": K10 takes every GEMM of M <= 32 rows (all of a
        # decode step's), K1 the prefill programs' and mixed steps' layers
        if (stats["dma_by_regime"]["decode"] <= 0 or stats["by_regime"]["decode"] != 0
                or not all(stats["by_regime"][r] > 0 for r in want - {"decode"})):
            fail(f"serve {label}: K1 launches by regime {stats['by_regime']}, K10 {stats['dma_by_regime']}")
    elif "w4a16_gemm" in kernels and not all(stats["by_regime"][r] > 0 for r in want):
        fail(f"serve {label}: K1 launches by regime {stats['by_regime']}")
    # the decode graph's tally (what one replay launches) holds every kernel
    # of the decode step: all of the engine's but the prefill attention, K1
    # under gemm_impl="dma" (K10 takes every decode GEMM) and K2 in the fused
    # W4A16 Llama (its norms ride in K1's prologue at decode)
    tally = eng._graphs[1].tally.counts()
    norm_in_k1 = getattr(cfg, "fused", False) and cfg.quant == "w4a16" and cfg.gemm_impl == "pipeline"
    step_kernels = [k for k in kernels if k not in ("flash_attention", "flash_attention_packed")
                    and not (k == "w4a16_gemm" and "w4a16_gemm_dma" in kernels)
                    and not (k == "rmsnorm" and norm_in_k1)]
    if any(tally.get(k, 0) <= 0 for k in step_kernels):
        fail(f"serve {label}: the decode graph launches {tally}, missing some of {step_kernels}")
    if isinstance(cfg, skt.DeepseekConfig):  # the MLA prefill runs K7 / K9's 576 tile
        check_576(label, "A", a, "flash_attention_packed_576")
        check_576(label, "B+C" if wave_c else "B", bc, "flash_attention_576")
    res = dict(engine=label, waves=[a, bc], decode_graph_tally=tally, w4a16_by_regime=dict(stats["by_regime"]),
               w4a16_dma_by_regime=dict(stats["dma_by_regime"]),
               launches={k: a["launches"][k] + bc["launches"][k] for k in a["launches"]})
    # every K1 call past 32 rows and every K11 call at bm 64 / 128 runs the
    # wgmma tile: the main path's weights all map, so the mma.sync tile never runs
    for name in ("w4a16_gemm", "w4a16_grouped_mm"):
        if name in kernels and (res["launches"][f"{name}_tile"] or not res["launches"][f"{name}_wgmma"]):
            fail(f"serve {label}: {name} launches by kernel "
                 f"{ {k: v for k, v in res['launches'].items() if k.startswith(name + '_')} }")
    if cold:
        if routing is not None:
            routing.mode = None
        try:
            res["cold_b"] = cold_compare(torch, skt, cfg, label, eng, prompts_b, rids[:n_b], stats["first"], routing)
        finally:
            if routing is not None:
                routing.restore()
    if after is not None:
        after(eng, stats, res)
    return res, eng, lens


def cold_compare(torch, skt, cfg, label, eng, prompts, warm_rids, warm_first, routing=None):
    """Wave B's prompts through an engine without the prefix cache (one
    packed launch), on the same weights: first-token logits within 0.25 of
    the warm engine's (its extends over cached pages); identical greedy
    tokens are counted. With ``routing`` (a TokenRouting that recorded the
    warm engine's prefill programs) the cold engine's prefill takes the warm
    engine's routing, its flips counted."""
    cold = skt.Engine(cfg, eng.params, device=DEVICE, max_batch=16, page_size=64, num_pages=256, seed=SEED,
                      prefill_chunk=1024, enable_prefix_cache=False)
    if routing is not None:
        routing.watch(cold)
        routing.mode = "replay"
    stats = instrument(cold)
    stats["capture"] = True
    first = stats["first"]
    rids = [cold.add_request(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    fin = cold.run_until_done()
    worst, same_tokens, same_requests = 0.0, 0, 0
    for wr, cr in zip(warm_rids, rids):
        worst = max(worst, float((warm_first[wr] - first[cr]).abs().max()))
        w_out, c_out = eng.finished[wr].output, fin[cr].output
        n = next((i for i, (x, y) in enumerate(zip(w_out, c_out)) if x != y), len(w_out))
        same_tokens += n
        same_requests += n == len(w_out)
    if routing is not None:
        routing.mode = None
    res = dict(max_first_logit_diff=worst, identical_greedy_prefix_tokens=same_tokens,
               tokens=NEW_TOKENS * len(prompts), identical_requests=same_requests, requests=len(prompts))
    if routing is not None:
        res.update(routing_flips_replayed=routing.flips, routed_rows_replayed=routing.replayed)
    log(f"[serve] {label} wave B warm vs cold (prefix cache off): " + json.dumps(res))
    if not worst <= 0.25:
        fail(f"serve {label}: warm and cold first-token logits differ by {worst} > 0.25")
    del cold
    free_memory(torch)
    return res


# device time a step of the W4A16 GEMMs, by kernel-name fragment: K1's
# decode kernel, the wgmma tile of K1 (M > 32) and K11 (bm 64 / 128), the
# mma.sync tile (weights the others cannot map), the streaming core
GEMM_GROUPS = {"K1 decode": ("w4a16_decode_kernel", "act_rows_kernel"),
               "K1 / K11 wgmma tile": ("w4a16_wgmma_kernel", "w4a16_rows_kernel"),
               "K1 / K11 mma.sync tile": ("w4a16_kernel<", "split_reduce_kernel", "row_prologue_kernel"),
               "K10 / K11 streaming core": ("w4s::stream_kernel", "w4s::rows_kernel"),
               "K5 paged_attention_decode_dma": ("::decode_kernel<",)}
# a packed prefill's device time: the GEMMs, attention, the MoE's bf16 GEMM
PREFILL_GROUPS = {**GEMM_GROUPS, "K7 / K9 flash 64/128": ("flash_kernel<", "packed_kernel<"),
                  "K7 / K9 flash 576": ("flash576_kernel", "packed576_kernel"),
                  "K12 bf16_grouped_mm": ("bf16_grouped",)}
# the DeepSeek decode attention: K13a and the NSA indexer's K15
MLA_GROUPS = {"K13a mla_decode": ("mla_decode_kernel",), "K15 fp8_paged_mqa_logits": ("mqa_logits_kernel",)}


def device_spans(torch, prof):
    """A torch.profiler trace's device kernels (the CPU-side op rows carry
    their kernels' time again): their (start, end) spans, µs and launches
    by kernel name, and the µs the device was busy (the union of the spans;
    kernels of one stream do not overlap)."""
    spans, per_kernel, n_kernel = [], {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        per_kernel[evt.name] = per_kernel.get(evt.name, 0.0) + (end - start)
        n_kernel[evt.name] = n_kernel.get(evt.name, 0) + 1
    busy_us, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, last))
        last = max(last, end)
    return spans, per_kernel, n_kernel, busy_us


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch")


def host_launches(torch, prof):
    """The host's launch calls in a torch.profiler trace: kernel launches
    (``cudaLaunchKernel*`` and ``cuLaunchKernel*``, Triton's included) and
    graph launches."""
    return sum(1 for evt in prof.events()
               if evt.device_type == torch.autograd.DeviceType.CPU and evt.name.startswith(LAUNCH_CALLS))


def phase_profile(torch, eng, lens, label, top=12, groups=None):
    """Where a decode step's time goes, eager against graphed: the serving
    engine of phase 4, 16 prompts of ``lens`` admitted again (prompts past
    the engine's chunk are prefilled a chunk a step, all 16 side by side),
    then decode-only scheduler steps run eagerly (``eng._eager_decode``),
    and as many again as graph replays: in each mode one step untimed, 4
    timed by the host clock (``step_ms``), 4 traced with torch.profiler.
    The profiler's device tracing adds time to every kernel, which a replay
    (kernels back to back) feels and an eager step (kernels behind the
    host) hides, so the step time comes from the untraced steps and the
    trace gives the rest: device-busy time, the union of the kernel
    intervals (kernels of one stream do not overlap), and its share of the
    traced steps' wall time; device kernels and host launch calls a step
    (one cudaGraphLaunch a replayed step). ``groups`` {label: name
    fragments} adds the device ms and the launches a step of the kernels
    whose names hold one of the fragments. Then the replay's device time by
    CUDA events over back-to-back replays, the host's time in one replay
    call (cudaGraphLaunch), and ``graph_vs_eager`` on the batch."""
    steps = 4
    gen = torch.Generator().manual_seed(SEED + 3)
    for n in lens:
        eng.add_request(torch.randint(1, eng.cfg.vocab_size, (n,), generator=gen).tolist(),
                        max_new_tokens=4 * steps + 14)
    eng.step()  # admission (one packed prefill, or the first chunks) and the first decode step
    while eng.waiting or eng.prefilling:
        eng.step()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    res = dict(engine=label, batch=len(lens), steps=steps)
    for mode in ("eager", "graph"):
        eng._eager_decode = mode == "eager"
        eng.step()  # one decode-only step in this mode, untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / steps
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans, per_kernel, n_kernel, busy_us = device_spans(torch, prof)
        top_k = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
        row = dict(step_ms=step_ms, traced_step_ms=1e3 * wall / steps,
                   device_busy_ms_per_step=busy_us / 1e3 / steps if spans else None,
                   device_busy_share=busy_us / 1e6 / wall if spans else None,
                   kernel_launches_per_step=len(spans) / steps,
                   host_launches_per_step=host_launches(torch, prof) / steps,
                   kernels_ms_per_step={k[:80]: v / 1e3 / steps for k, v in top_k})
        if groups:
            row["group_ms_per_step"] = {g: sum(v for k, v in per_kernel.items() if any(f in k for f in frags))
                                        / 1e3 / steps for g, frags in groups.items()}
            row["group_launches_per_step"] = {g: sum(v for k, v in n_kernel.items() if any(f in k for f in frags))
                                              / steps for g, frags in groups.items()}
        res[mode] = row
    eng._eager_decode = False
    if not res["graph"]["kernel_launches_per_step"]:
        log(f"[profile] {label}: the trace shows no device kernel under graph replay")
    replay = eng._graphs[1].graph.replay
    res["graph"]["replay_device_ms"] = time_ms(torch, replay, iters=10, warmup=1)
    t0 = time.perf_counter()  # the host's side of a replay: the cudaGraphLaunch call alone
    for _ in range(5):
        replay()
    res["graph"]["replay_launch_host_ms"] = 1e3 * (time.perf_counter() - t0) / 5
    torch.cuda.synchronize()
    res["logits_vs_eager"] = graph_vs_eager(torch, eng, label)
    eng.run_until_done()
    log("[profile] " + json.dumps(res))
    return res


def top_two_gap(rows):
    """Each row's top-two logit gap, and ``check``'s element-wise gate at its
    top logit: how far apart two logits may lie and still be a near tie."""
    top = rows.topk(2, dim=-1).values
    return top[:, 0] - top[:, 1], 2.0 ** -7 * top[:, 0].abs() + 2.0 ** -12 * rows.abs().amax(-1)


def graph_vs_eager(torch, eng, label):
    """One decode step of the running batch on the same static inputs, eager
    and replayed (both write the same KV rows): the logits within ``check``'s
    element-wise gate (every kernel of a step sums in a fixed order, so they
    are expected bit-equal, which is reported), and the greedy tokens
    identical but where the eager logits' top two are within that gate of
    each other (a near tie that sums in another order could flip), each
    such row printed."""
    reqs = [r for r in eng.running if not r.done]
    eng._inputs.fill(*eng._decode_inputs(reqs, 0))
    graph = eng._graphs[1]
    eager = graph(eager=True)[: len(reqs)].float()
    replay = graph()[: len(reqs)].float()
    bit_equal = bool(torch.equal(replay, eager))
    err = check(f"decode graph vs eager {label}", [(replay, eager)])
    gaps, gates = top_two_gap(eager)
    flips = (replay.argmax(-1) != eager.argmax(-1)).nonzero().flatten().tolist()
    for i in flips:
        gap, gate = float(gaps[i]), float(gates[i])
        log(f"[profile] {label}: graph and eager pick different tokens in row {i}, top-two gap {gap:.6g} "
            f"(gate {gate:.6g})")
        if gap > gate:
            fail(f"decode graph vs eager {label}: row {i} flips a top-two gap of {gap} > {gate}")
    return dict(rows=len(reqs), max_abs_err=err, bit_equal=bit_equal, token_flips=len(flips))


BURST = 8


def phase_burst(torch, skt, cfg, label, params, n=16):
    """decode_burst: ``n`` greedy requests of 4 * BURST + 1 tokens (the
    prefill's, then four bursts of BURST) through an engine with
    decode_burst=BURST and one with decode_burst=1, on the same weights
    (prefix cache off, so both prefill alike), each after a warm-up request
    that captures its graph. Reports decode ms per token of every row (the
    decode timer over the 32 tokens), the graph replays and, beside them,
    one step's device time (CUDA events over back-to-back replays of the
    single-step graph at the run's last inputs). The tokens must
    be equal; where they differ, the first divergence is printed with the
    step-by-step engine's top-two logit gap at that token, which must lie
    within the element-wise gate (a near tie that sums in another order
    could flip)."""
    from sgl_kernel_tpu_torch.utils.metrics import Metrics

    gen = torch.Generator().manual_seed(SEED + 11)
    prompts = [random_prompt(torch, gen, cfg.vocab_size, 64 + 48 * i) for i in range(n)]
    new = 4 * BURST + 1
    res, outs, first_rid, steps = {"engine": label}, {}, {}, []
    for burst in (1, BURST):
        eng = skt.Engine(cfg, params, device=DEVICE, max_batch=16, page_size=64, num_pages=256, seed=SEED,
                         prefill_chunk=1024, decode_burst=burst, enable_prefix_cache=False)
        eng.add_request(list(range(1, 17)), max_new_tokens=burst + 1)
        eng.run_until_done()
        eng.finished.clear()
        if burst == 1:  # each pick's top-two gap and its gate, kept on the device until the run ends
            append = eng._append_tokens

            def record(reqs, logits, append=append):
                steps.append(([(r.rid, len(r.output)) for r in reqs],
                              torch.stack(top_two_gap(logits[: len(reqs)].float()))))
                return append(reqs, logits)

            eng._append_tokens = record
        eng.metrics = Metrics()
        rids = [eng.add_request(p, max_new_tokens=new) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin = eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = eng.metrics.snapshot()
        outs[burst], first_rid[burst] = [fin[r].output for r in rids], rids[0]
        if any(len(o) != new for o in outs[burst]) or snap.get("nonfinite_logits", 0):
            fail(f"burst {label} decode_burst={burst}: outputs of {[len(o) for o in outs[burst]]} tokens, "
                 f"{snap.get('nonfinite_logits', 0)} non-finite rows")
        res[f"burst_{burst}"] = dict(
            decode_ms_per_token=1e3 * snap["decode_total_s"] / (new - 1), decode_s=snap["decode_total_s"],
            decode_programs=snap["decode_count"], graph_replays=snap.get("decode_graph_replays", 0),
            tokens_decoded=snap["tokens_decoded"], wall_s=wall)
        if burst == 1:  # the device time of one step at the run's last inputs, replays back to back
            res["burst_1"]["step_device_ms"] = time_ms(torch, eng._graphs[1].graph.replay, iters=5, warmup=1)
        del eng
        free_memory(torch)
    gaps = {}
    for keys, vals in steps:
        for (rid, at), (gap, gate) in zip(keys, vals.t().tolist()):
            gaps[(rid, at)] = (gap, gate)
    diverged = []
    for i, (a, b) in enumerate(zip(outs[1], outs[BURST])):
        at = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if at is None:
            continue
        gap, gate = gaps[(first_rid[1] + i, at)]
        log(f"[burst] {label}: request {i} first differs at token {at} ({a[at]} against {b[at]}), step-by-step "
            f"top-two gap {gap:.6g} (gate {gate:.6g})")
        diverged.append(dict(request=i, token=at, gap=gap, gate=gate))
        if gap > gate:
            fail(f"burst {label}: request {i}'s tokens differ at {at}, top-two gap {gap} > gate {gate}")
    res.update(identical_requests=n - len(diverged), diverged=diverged,
               speedup=res["burst_1"]["decode_ms_per_token"] / res[f"burst_{BURST}"]["decode_ms_per_token"])
    log("[burst] " + json.dumps(res))
    return res


def phase_prefill_profile(torch, eng, lens, label, top=12, groups=PREFILL_GROUPS):
    """Where wave A's prefill time goes: 16 fresh prompts of wave A's
    ``lens`` admitted on the idle engine, its next scheduler step (the one
    packed prefill launch, then the first decode step of those rows) traced
    with torch.profiler; device ms and launches by kernel group, the top
    kernels, the device-busy share of the step's wall time."""
    gen = torch.Generator().manual_seed(SEED + 7)
    for n in lens:
        eng.add_request(torch.randint(1, eng.cfg.vocab_size, (n,), generator=gen).tolist(), max_new_tokens=2)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run_until_done()
    spans, per_kernel, n_kernel, busy_us = device_spans(torch, prof)
    res = dict(engine=label, prompts=len(lens), tokens=sum(lens), step_ms=1e3 * wall, device_busy_ms=busy_us / 1e3,
               device_busy_share=busy_us / 1e6 / wall, kernel_launches=len(spans),
               group_ms={g: sum(v for k, v in per_kernel.items() if any(f in k for f in frags)) / 1e3
                         for g, frags in groups.items()},
               group_launches={g: sum(v for k, v in n_kernel.items() if any(f in k for f in frags))
                               for g, frags in groups.items()},
               kernels_ms={k[:80]: v / 1e3 for k, v in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]})
    log("[profile-prefill] " + json.dumps(res))
    return res


def v2_lite_cfg(torch, skt, **kw):
    """DeepSeek-V2-Lite widths (deepseek-ai/DeepSeek-V2-Lite config.json) in
    the JAX package's DSv3-style architecture, as
    benchmark/bench_deepseek_e2e.py's v2_lite_cfg: 27 layers, hidden 2048, 16
    heads (nope 128, v 128, latent 512, rope 64), 64 experts top-6 of 1,408,
    one dense layer of 10,944, vocab 102,400; W4A16 with groups of 128 unless
    ``quant`` says otherwise (None: bf16 weights, the config's default).
    max_position 8192 so that wave C's 4,096-token prompt and its outputs fit."""
    kw.setdefault("quant", "w4a16")
    return skt.DeepseekConfig(
        vocab_size=102400, hidden_size=2048, num_layers=27, num_heads=16, qk_nope_dim=128, v_head_dim=128,
        num_experts=64, num_experts_per_tok=6, moe_intermediate=1408, dense_intermediate=10944,
        num_dense_layers=1, routed_scaling_factor=1.0, max_position=8192, dtype=torch.bfloat16, group_size=128,
        **kw)


def linear_bytes(cfg):
    """Bytes of one [N, K] linear of ``cfg``: bf16, or W4A16 packed codes
    and bf16 group scales (K padded to a multiple of 8 groups when it is not
    a group multiple)."""
    g = cfg.group_size

    def lin(n, k):
        if cfg.quant is None:
            return 2 * n * k
        k = -(-k // (8 * g)) * (8 * g) if k % g else k
        return k // 2 * n + 2 * (k // g) * n
    return lin


def experts_hit(e, k, batch):
    """Expected experts that ``batch`` tokens of top-k hit under uniform
    routing: E (1 - (1 - k/E)^batch)."""
    return e * (1 - (1 - k / e) ** batch)


def deepseek_step_bytes(cfg, batch=16, ctx=1024):
    """The bytes one decode step of ``cfg`` (bf16 or W4A16) must read, from
    the shapes ``models/deepseek.init_weights`` gives: every layer's
    attention linears, w_uk / w_uv (bf16), layer 0's dense MLP, each MoE
    layer's shared expert, router and the routed experts that ``batch``
    tokens of top-k hit (``experts_hit``), the lm_head; and, apart, the
    latent pool rows of ``batch`` sequences of ``ctx`` tokens. Returns
    (weight bytes, pool bytes, experts hit)."""
    h, nh = cfg.hidden_size, cfg.num_heads
    lin = linear_bytes(cfg)

    attn = (lin(nh * (cfg.qk_nope_dim + 64), h) + lin(576, h) + lin(h, nh * cfg.v_head_dim)
            + 2 * 2 * nh * cfg.qk_nope_dim * 512)
    dense = 2 * lin(cfg.dense_intermediate, h) + lin(h, cfg.dense_intermediate)
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    hit = experts_hit(e, k, batch)
    moe = (2 * lin(cfg.moe_intermediate, h) + lin(h, cfg.moe_intermediate) + 2 * e * h
           + hit * (lin(2 * cfg.moe_intermediate, h) + lin(h, cfg.moe_intermediate)))
    n_moe = cfg.num_layers - cfg.num_dense_layers
    vocab = cfg.vocab_size if cfg.quant is None else -(-cfg.vocab_size // 2048) * 2048
    weights = cfg.num_layers * attn + cfg.num_dense_layers * dense + n_moe * moe + lin(vocab, h)
    if cfg.nsa:  # the indexer's projections stay in the model dtype
        weights += cfg.num_layers * 2 * (cfg.idx_heads * cfg.idx_dim * (cfg.q_lora_rank or h)
                                         + cfg.idx_dim * h + cfg.idx_heads * h)
    pool_bytes = batch * ctx * 576 * cfg.num_layers * (cfg.kv_dtype.itemsize if cfg.kv_dtype is not None else 2)
    return weights, pool_bytes, hit


def mixtral_step_bytes(cfg, batch=16, ctx=1024):
    """The bytes one Mixtral decode step of ``cfg`` must read, from the
    shapes ``models/mixtral.init_weights`` gives: every layer's q, k, v, o
    and router, the expert banks that ``batch`` tokens of top-k hit
    (``experts_hit``), the lm_head (N padded to 2048 in W4A16); and, apart,
    the bf16 K and V rows of ``batch`` sequences of ``ctx`` tokens. Returns
    (weight bytes, pool bytes, experts hit)."""
    h, d, inter = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    lin = linear_bytes(cfg)
    hit = experts_hit(cfg.num_experts, cfg.top_k, batch)
    layer = (lin(cfg.num_heads * d, h) + 2 * lin(cfg.num_kv_heads * d, h) + lin(h, cfg.num_heads * d)
             + 2 * cfg.num_experts * h + hit * (lin(2 * inter, h) + lin(h, inter)))
    vocab = cfg.vocab_size if cfg.quant is None else -(-cfg.vocab_size // 2048) * 2048
    pool_bytes = batch * ctx * 2 * cfg.num_kv_heads * d * 2 * cfg.num_layers
    return cfg.num_layers * layer + lin(vocab, h), pool_bytes, hit


def report_row(torch, name, row, dev_fn=None, work=None):
    """Log one kernel's row; with ``dev_fn`` (a call of the kernel) add its
    CUDA-graph device time as ``graph_ms``; with ``work`` (the operations
    and bytes the call needs) the TFLOP/s and GB/s it achieves on its device
    time (graph ms where taken, else event ms) and the library's TFLOP/s.
    Returns the row."""
    lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    if dev_fn is not None:
        row["graph_ms"] = graph_ms(torch, dev_fn)
    if work is not None:
        n_ops, n_bytes = work
        t = row.get("graph_ms") or row["ms"]
        row.update(tflops=n_ops / t / 1e9, gbs=n_bytes / t / 1e6)
        if row["library_ms"] is not None:
            row["library_tflops"] = n_ops / row["library_ms"] / 1e9
    extra = "".join(f" {key}={row[key]:.4f}" for key in ("graph_ms", "cold_ms", "public_ms", "library_graph_ms", "tflops",
                                                          "gbs", "library_tflops", "k13a_graph_ms")
                    if row.get(key) is not None)
    log(f"[kernel] {name}: ms={row['ms']:.4f}{extra} plain_ms={row['plain_ms']:.4f} library_ms={lib} "
        f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) {row.get('library_note', '')}")
    return row


def grouped_w4_row(torch, moe, name, a, w, sc, al, bm, pairs, g, decode):
    """K11 (w4a16_grouped_mm) on layer 1 of the stacked bank ``w`` against
    its plain version, over the valid rows of the alignment ``al``; at
    decode also two calls bit-equal and the cold device time, the calls
    cycling the bank's layers (K11 reads only the experts its rows hit)."""
    nv = int(al.num_valid_blocks)
    hit = int((al.group_sizes > 0).sum())
    kw = dict(bm=bm)
    args = (a, w, sc, al.block_expert_ids, None, 1, al.num_valid_blocks)
    fn = lambda: moe.w4a16_grouped_mm(*args, **kw)
    wgmma_before = moe.w4a16_grouped_mm.launches_by_route["wgmma"]
    out = fn()
    if bm >= 64 and moe.w4a16_grouped_mm.launches_by_route["wgmma"] != wgmma_before + 1:
        fail(f"{name}: bm {bm} did not run the wgmma tile ({moe.w4a16_grouped_mm.launches_by_route})")
    ref = moe.w4a16_grouped_mm_ref(*args, **kw)
    err = check(f"{name} [cap {a.shape[0]}, bm {bm}, {nv} valid blocks, {hit} experts]",
                [(out[: nv * bm], ref[: nv * bm])])
    k, n = a.shape[1], w.shape[-1]
    n_bytes = hit * (k // 2 * n + 2 * (k // g) * n) + pairs * (k + n) * 2 + 4 * (al.block_expert_ids.numel() + 1)
    bms, bby = bound_ms(n_bytes, 2 * pairs * k * n, BF16_FLOPS)
    row = dict(max_abs_err=err, ms=time_ms(torch, fn),
               plain_ms=time_ms(torch, lambda: moe.w4a16_grouped_mm_ref(*args, **kw), iters=2, warmup=1),
               library_ms=None, library_note="no PyTorch call computes a grouped int4 GEMM",
               bound_ms=bms, bound_by=bby, valid_blocks=nv, experts_hit=hit)
    if decode:
        check_repeat(name, lambda: moe.w4a16_grouped_mm(*args, **kw)[: nv * bm], out[: nv * bm])
        row["cold_graph_ms"] = cold_graph_ms(torch, lambda lid: moe.w4a16_grouped_mm(
            a, w, sc, al.block_expert_ids, None, lid, al.num_valid_blocks, **kw), w.shape[0])
    row = report_row(torch, name.replace(" ", "_"), row, fn if decode else None)
    if decode:
        log(f"[kernel] {name}: cold {row['cold_graph_ms']:.4f} ms, warm {row['graph_ms']:.4f}, bound {bms:.4f} "
            f"({100 * bms / row['cold_graph_ms']:.1f} % cold)")
    return row


def phase_mixtral_w4_kernels(torch, skt):
    """K11 at Mixtral-8x7B's W4A16 decode (16 tokens, top-2 of 8 experts, bm
    16, group 128): gate_up [K 4,096 -> N 28,672] and down [14,336 -> 4,096]
    on two stacked layers of random codes (0.94 and 0.47 GB), warm and cold."""
    from sgl_kernel_tpu_torch.ops import moe
    from sgl_kernel_tpu_torch.ops.activation import silu_and_mul

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    bf = torch.bfloat16
    cfg = skt.MixtralConfig.mixtral_8x7b(quant="w4a16")
    h, e, k_top, inter, g, t, bm = cfg.hidden_size, cfg.num_experts, cfg.top_k, \
        cfg.intermediate_size, 128, 16, 16

    def bank(k, n):
        w = torch.randint(0, 256, (2, e, k // 2, n), generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)
        return w, (0.002 + 0.004 * torch.rand((2, e, k // g, n), generator=gen, device=dev)).to(bf)

    tw, tids = moe.topk_softmax(torch.randn((t, e), generator=gen, device=dev), k_top, renormalize=True)
    al = moe.moe_align_block_size(tids, tw, e, bm)
    x = moe.scatter_tokens_to_experts(torch.randn((t, h), generator=gen, device=dev).to(bf), al)
    rows = {}
    w1, s1 = bank(h, 2 * inter)
    rows["w4a16_grouped_mm_mixtral_decode_gate_up"] = grouped_w4_row(
        torch, moe, "w4a16_grouped_mm mixtral decode gate_up", x, w1, s1, al, bm, t * k_top, g, True)
    a2 = silu_and_mul(moe.w4a16_grouped_mm(x, w1, s1, al.block_expert_ids, None, 1, al.num_valid_blocks, bm=bm))
    del w1, s1
    w2, s2 = bank(inter, h)
    rows["w4a16_grouped_mm_mixtral_decode_down"] = grouped_w4_row(
        torch, moe, "w4a16_grouped_mm mixtral decode down", a2, w2, s2, al, bm, t * k_top, g, True)
    del w2, s2
    return rows


def phase_deepseek_kernels(torch, skt):
    """K11, K13a, K14 and K7 / K9 at 576 against their plain versions at the
    V2-Lite path's shapes."""
    from sgl_kernel_tpu_torch.ops import moe, rope
    from sgl_kernel_tpu_torch.ops.activation import silu_and_mul
    from sgl_kernel_tpu_torch.ops.attention import flash_packed, flash_prefill, mla
    from sgl_kernel_tpu_torch.serving.engine import packed_layout

    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    bf = torch.bfloat16
    cfg = v2_lite_cfg(torch, skt)
    h, e, k_top, inter, g = cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_intermediate, 128
    rows = {}

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def bank(k, n):  # two stacked layers of random codes and scales; layer 1 is used
        w = torch.randint(0, 256, (2, e, k // 2, n), generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)
        return w, (0.005 + 0.015 * torch.rand((2, e, k // g, n), generator=gen, device=dev)).to(bf)

    def report(name, row, dev_fn=None, work=None):
        rows[name] = report_row(torch, name, row, dev_fn, work)

    # K11: tokens routed by biased top-k on random logits, aligned, through
    # gate_up [K 2048 -> N 2816] and down [1408 -> 2048]
    w1, s1 = bank(h, 2 * inter)
    w2, s2 = bank(inter, h)
    for t, label in ((16, "decode"), (1024, "prefill")):
        bm = moe.pick_block_size(t, k_top, e)
        tw, tids = moe.biased_topk(torch.randn((t, e), generator=gen, device=dev), torch.zeros(e, device=dev), k_top,
                                   renormalize=True, apply_routed_scaling_factor_on_output=True)
        al = moe.moe_align_block_size(tids, tw, e, bm)
        x = moe.scatter_tokens_to_experts(randn(t, h), al)
        steps = [("gate_up", x, w1, s1)]
        if label == "decode":
            steps.append(("down", silu_and_mul(moe.w4a16_grouped_mm(x, w1, s1, al.block_expert_ids, None, 1,
                                                                    al.num_valid_blocks, bm=bm)), w2, s2))
        for name, a, w, sc in steps:
            rows[f"w4a16_grouped_mm_{label}_{name}"] = grouped_w4_row(
                torch, moe, f"w4a16_grouped_mm {label} {name}", a, w, sc, al, bm, t * k_top, g, label == "decode")
    del w1, s1, w2, s2

    # K13a: B=16, contexts 1..1056 (the current token included), page 64,
    # 128-entry page tables, bf16 / int8 / e4m3 pools stacked to at least
    # COLD_BYTES: the warm rows read layer 1, the cold rows cycle the layers
    b, page, nh = 16, 64, cfg.num_heads
    lengths_l = [1 + (1055 * i) // (b - 1) for i in range(b)]
    n_used = [-(-n // page) for n in lengths_l]
    n_pages = sum(n_used) + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    table = torch.zeros((b, cfg.max_position // page), dtype=torch.int32, device=dev)
    at = 0
    for i, n in enumerate(n_used):
        table[i, :n] = perm[at: at + n]
        at += n
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    qn, qp = randn(b, nh, 512, scale=0.3), randn(b, nh, 64, scale=0.3)
    sm = 1.0 / (cfg.qk_nope_dim + 64) ** 0.5

    def latent_pool(shape, dt):
        if dt == torch.int8:
            return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int32).to(dt)
        return randn(*shape, dtype=dt, scale=1.0 if dt == bf else 2.0)

    def mla_row(name, fn, ref_fn, n_rows, elem, n_table, cold):
        """K13a against its plain version, two calls bit-equal, and its row:
        each selected pool row read once, q, o, lse and the table entries
        used; ``cold`` the cold device ms."""
        out, lse = fn()
        ref, ref_lse = ref_fn()
        err = check(name, [(out, ref), (lse, ref_lse)])
        check_repeat(name, fn, (out, lse))
        n_bytes = n_rows * 576 * elem + b * nh * (576 + 512) * 2 + b * nh * 4 + n_table * 4
        bms, bby = bound_ms(n_bytes, 2 * nh * (576 + 512) * n_rows, BF16_FLOPS)
        return dict(max_abs_err=err, ms=time_ms(torch, fn), plain_ms=time_ms(torch, ref_fn, iters=5, warmup=1),
                    library_ms=None, library_note="no PyTorch call attends over a paged pool", bound_ms=bms,
                    bound_by=bby, cold_ms=cold)

    for kind, dt, scale in (("bf16", bf, None), ("int8", torch.int8, 1 / 16), ("e4m3", torch.float8_e4m3fn, 0.5)):
        layers = max(2, -(-int(COLD_BYTES) // (n_pages * page * 576 * dt.itemsize)))
        pool = latent_pool((layers, n_pages, page, 576), dt)
        kw = dict(sm_scale=sm * (scale or 1.0), return_lse=True)
        fn = lambda: mla.mla_decode(qn, qp, pool, lengths, table, 1, **kw)
        cold = cold_graph_ms(torch, lambda lid: mla.mla_decode(qn, qp, pool, lengths, table, lid, **kw), layers,
                             reps=max(24, layers))
        report("mla_decode" + ("" if kind == "bf16" else f"_{kind}"), mla_row(
            f"mla_decode {kind} pool [16, ctx 1..1056]", fn,
            lambda: mla.mla_decode_ref(qn, qp, pool, lengths, table, 1, **kw), sum(lengths_l), dt.itemsize,
            sum(n_used), cold), fn)
        del pool
    # NSA's sparse shape (sparse_mla_decode's call): each sequence attends
    # 2,048 rows selected from a flat latent pool viewed as one-row pages,
    # int8 (the NSA engine's latent) and bf16; the cold rows select from the
    # other parts of a pool of at least COLD_BYTES
    sel = b * 2048
    lens_sel = torch.full((b,), 2048, dtype=torch.int32, device=dev)
    for kind, dt, scale in (("int8", torch.int8, 1 / 16), ("bf16", bf, None)):
        layers = max(2, -(-int(COLD_BYTES) // (sel * 576 * dt.itemsize)))
        rows_pool = latent_pool((layers * sel, 1, 576), dt)
        tables = [(torch.randperm(sel, generator=gen, device=dev).to(torch.int32) + i * sel).reshape(b, 2048)
                  for i in range(layers)]
        kw = dict(sm_scale=sm * (scale or 1.0), return_lse=True)
        fn = lambda: mla.mla_decode(qn, qp, rows_pool, lens_sel, tables[0], **kw)
        cold = cold_graph_ms(torch, lambda i: mla.mla_decode(qn, qp, rows_pool, lens_sel, tables[i], **kw), layers,
                             reps=max(24, layers))
        report(f"mla_decode_nsa_{kind}", mla_row(
            f"mla_decode NSA {kind} [16 x 2,048 one-row pages]", fn,
            lambda: mla.mla_decode_ref(qn, qp, rows_pool, lens_sel, tables[0], **kw), sel, dt.itemsize, sel, cold),
            fn)
        del rows_pool, tables
    # B=16 x 8,192 on dense bf16 pages of 64: 151 MB a call, three L2s, so
    # every call is cold
    table8, used8 = paged_table(torch, gen, [8192] * b, page, 8192 // page)
    pool8 = latent_pool((1, used8 + 1, page, 576), bf)
    lens8 = torch.full((b,), 8192, dtype=torch.int32, device=dev)
    kw = dict(sm_scale=sm, return_lse=True)
    fn = lambda: mla.mla_decode(qn, qp, pool8, lens8, table8, 0, **kw)
    row = mla_row("mla_decode bf16 pool [16 x 8,192]", fn,
                  lambda: mla.mla_decode_ref(qn, qp, pool8, lens8, table8, 0, **kw), b * 8192, 2, used8, None)
    report("mla_decode_ctx8192", row, fn)
    row["cold_ms"] = row["graph_ms"]
    del pool8

    # K14: 16 decode tokens, layer 26 of the stacked norm weight
    t, dn = 16, cfg.qk_nope_dim
    q = randn(t, nh, dn + 64)
    kv = randn(t, 576, scale=2.0)
    w = (1 + 0.1 * torch.randn((cfg.num_layers, 512), generator=gen, device=dev)).to(bf)
    cache = rope.compute_cos_sin_cache(64, cfg.max_position, cfg.rope_theta, device=dev)
    pos = torch.randint(0, 4096, (t,), generator=gen, device=dev, dtype=torch.int32)
    kw = dict(nope_dim=dn, eps=cfg.rms_eps)
    fn = lambda: rope.mla_qkv_prep(pos, 26, q, kv, w, cache, **kw)
    err = check("mla_qkv_prep [16 tokens]", list(zip(fn(), rope.mla_qkv_prep_ref(pos, 26, q, kv, w, cache, **kw))))
    n_bytes = 2 * 2 * t * (nh * (dn + 64) + 576) + 512 * 2 + t * 64 * 4 + t * 4
    bms, bby = bound_ms(n_bytes, t * (nh * 64 * 3 + 512 * 4 + 64 * 3), F32_FLOPS)
    report("mla_qkv_prep", dict(max_abs_err=err, ms=time_ms(torch, fn),
                                plain_ms=time_ms(torch, lambda: rope.mla_qkv_prep_ref(pos, 26, q, kv, w, cache, **kw)),
                                library_ms=None, library_note="no single PyTorch call", bound_ms=bms, bound_by=bby), fn)

    # K7 at 576 through the MLA form the model calls (q's latent and rope
    # columns apart, V = the latent's first 512 columns, 512 wide): the two
    # extend passes of prefill_extend, 512 fresh latent rows over a 512-row
    # prefix, with lse; the public form with a padded V held to its own twin.
    # The MLA form's work is 2 x 16 x (576 + 512) a visible pair: S over 576
    # columns, P V over the 512 of V
    s = pre = 512
    q = randn(1, s, nh, 576, scale=0.3)
    qn, qp = q[..., :512].contiguous(), q[..., 512:].contiguous()
    k1, k2 = randn(1, s, 1, 576), randn(1, pre, 1, 576)
    v1, v2 = (F.pad(x[..., :512], (0, 64)) for x in (k1, k2))
    ql = torch.tensor([s], dtype=torch.int32, device=dev)
    pl_ = torch.tensor([pre], dtype=torch.int32, device=dev)
    zero = torch.zeros_like(pl_)

    def passes(fn):
        return (fn(qn, qp, k1, ql, ql, pl_, pl_, causal=True, sm_scale=sm, return_lse=True)
                + fn(qn, qp, k2, ql, pl_, pl_, zero, causal=True, sm_scale=sm, return_lse=True))

    def public(fn):
        return (fn(q, k1, v1, ql, ql, None, pl_, pl_, causal=True, sm_scale=sm, return_lse=True)
                + fn(q, k2, v2, ql, pl_, None, pl_, zero, causal=True, sm_scale=sm, return_lse=True))

    err = check("flash_attention_mla 576 lse, extend 512 over 512",
                list(zip(passes(flash_prefill.flash_attention_mla), passes(flash_prefill.flash_attention_mla_ref))))
    check("flash_attention 576 public form (padded V), extend 512 over 512",
          list(zip(public(flash_prefill.flash_attention), public(flash_prefill.flash_attention_ref))))
    pairs_ext = s * (s + 1) // 2 + s * pre
    n_bytes = (s * nh * 576 + (s + pre) * 576) * 2 + 2 * (s * nh * 512 * 2 + nh * s * 4)
    bms, bby = bound_ms(n_bytes, 2 * nh * (576 + 512) * pairs_ext, BF16_FLOPS)
    qt = q.transpose(1, 2)
    kt, vt = (torch.cat([a, c], 1).transpose(1, 2) for a, c in ((k2, k1), (v2, v1)))
    mask = torch.arange(pre + s, device=dev)[None, :] <= (pre + torch.arange(s, device=dev))[:, None]
    lib_fn = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=sm, enable_gqa=True)
    fn = lambda: passes(flash_prefill.flash_attention_mla)
    report("flash_attention_576_lse", dict(
        max_abs_err=err, ms=time_ms(torch, fn), public_ms=time_ms(torch, lambda: public(flash_prefill.flash_attention)),
        plain_ms=time_ms(torch, lambda: passes(flash_prefill.flash_attention_mla_ref), iters=3),
        library_ms=time_ms(torch, lib_fn), library_note="SDPA with the extend mask: the merged output, no lse",
        bound_ms=bms, bound_by=bby), fn, (2 * nh * (576 + 512) * pairs_ext, n_bytes))

    # K7 at 576: wave D's last prefix pass, 1,024 queries over 5,120 prefix
    # keys, all visible, with lse (the MLA form)
    s, pre = 1024, 5120
    qn, qp, kv = randn(1, s, nh, 512, scale=0.3), randn(1, s, nh, 64, scale=0.3), randn(1, pre, 1, 576)
    ql = torch.tensor([s], dtype=torch.int32, device=dev)
    pl_ = torch.tensor([pre], dtype=torch.int32, device=dev)
    kw = dict(causal=True, sm_scale=sm, return_lse=True)
    fn = lambda: flash_prefill.flash_attention_mla(qn, qp, kv, ql, pl_, pl_, zero, **kw)
    out, lse = fn()
    ref, ref_lse = flash_prefill.flash_attention_mla_ref(qn, qp, kv, ql, pl_, pl_, zero, **kw)
    err = check("flash_attention_mla 576 lse, prefix pass 1,024 over 5,120", [(out, ref), (lse, ref_lse)])
    del ref, ref_lse
    n_bytes = (s * nh * 576 + pre * 576) * 2 + s * nh * 512 * 2 + nh * s * 4
    bms, bby = bound_ms(n_bytes, 2 * nh * (576 + 512) * s * pre, BF16_FLOPS)
    qt = torch.cat([qn, qp], -1).transpose(1, 2)
    kt, vt = kv.transpose(1, 2), F.pad(kv[..., :512], (0, 64)).transpose(1, 2)
    lib_fn = lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=sm, enable_gqa=True)
    report("flash_attention_576_prefix5120", dict(
        max_abs_err=err, ms=time_ms(torch, fn, iters=10),
        plain_ms=time_ms(torch, lambda: flash_prefill.flash_attention_mla_ref(qn, qp, kv, ql, pl_, pl_, zero, **kw),
                         iters=2, warmup=1),
        library_ms=time_ms(torch, lib_fn, iters=5), library_note="SDPA over the 5,120 keys, V padded to 576, no lse",
        bound_ms=bms, bound_by=bby), fn, (2 * nh * (576 + 512) * s * pre, n_bytes))
    del qn, qp, kv, qt, kt, vt, out, lse

    # K9 at 576 through the MLA form: wave A's packing (16 prompts of
    # 16..1024 tokens, block 256); the public form with a padded V held to
    # its own twin
    lens = serve_lens(16)
    blk_seq, blk_q0, seq_meta, tok0, tp, max_kvb = packed_layout(lens, 17)
    ints = [torch.from_numpy(a).to(dev) for a in (blk_seq, blk_q0, seq_meta)]
    q, k = randn(tp, nh, 576, scale=0.3), randn(tp, 1, 576)
    qn, qp = q[..., :512].contiguous(), q[..., 512:].contiguous()
    kw = dict(max_kvb=max_kvb, causal=True, sm_scale=sm, return_lse=True)
    fn = lambda: flash_packed.flash_attention_packed_mla(qn, qp, k, *ints, **kw)
    out, lse = fn()
    ref, ref_lse = flash_packed.flash_attention_packed_mla_ref(qn, qp, k, *ints, **kw)
    pairs = []
    for t0, n in zip(tok0, lens):
        pairs += [(out[t0: t0 + n], ref[t0: t0 + n]), (lse[:, t0: t0 + n], ref_lse[:, t0: t0 + n])]
    err = check(f"flash_attention_packed_mla 576 [{tp} tokens, 16 prompts, lse]", pairs)
    v = F.pad(k[..., :512], (0, 64))
    public_fn = lambda: flash_packed.flash_attention_packed(q, k, v, *ints, **kw)
    out_p, lse_p = public_fn()
    ref_p, ref_lse_p = flash_packed.flash_attention_packed_ref(q, k, v, *ints, **kw)
    pairs = []
    for t0, n in zip(tok0, lens):
        pairs += [(out_p[t0: t0 + n], ref_p[t0: t0 + n]), (lse_p[:, t0: t0 + n], ref_lse_p[:, t0: t0 + n])]
    check(f"flash_attention_packed 576 public form (padded V) [{tp} tokens, 16 prompts, lse]", pairs)
    del out_p, lse_p, ref_p, ref_lse_p, pairs
    n_tok = sum(lens)
    pairs_a = sum(n * (n + 1) // 2 for n in lens)
    n_bytes = n_tok * (nh + 1) * 576 * 2 + tp * nh * 512 * 2 + nh * tp * 4
    bms, bby = bound_ms(n_bytes, 2 * nh * (576 + 512) * pairs_a, BF16_FLOPS)
    lib_fn, lib_note = packed_library(torch, F, q, k, v, lens, tok0, F.pad(ref, (0, 64)), scale=sm)
    log(f"[kernel] flash_attention_packed 576 library: {lib_note}")
    report("flash_attention_packed_576", dict(
        max_abs_err=err, ms=time_ms(torch, fn), public_ms=time_ms(torch, public_fn),
        plain_ms=time_ms(torch, lambda: flash_packed.flash_attention_packed_mla_ref(qn, qp, k, *ints, **kw), iters=2,
                         warmup=1),
        library_ms=None if lib_fn is None else time_ms(torch, lib_fn), library_note=lib_note,
        bound_ms=bms, bound_by=bby), fn, (2 * nh * (576 + 512) * pairs_a, n_bytes))
    return rows


def grouped_mm_yardstick(torch, x, w, al, nv_rows, ref):
    """torch._grouped_mm over the padded group offsets, computing K12's
    function on the same valid rows: the library's timing yardstick, which
    the port never calls. Tried on the bank as it lies ([E, K, N], N
    contiguous), then on a column-major copy made outside the timed call.
    Returns (fn, note): fn None when this torch has no such call, refuses
    both layouts, or disagrees with the plain version by more than 2^-6 of
    its scale."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "this torch has no torch._grouped_mm"
    offs = torch.cumsum(al.padded_group_sizes, 0).to(torch.int32)
    notes = []
    for layout in ("row-major", "column-major"):
        wl = w if layout == "row-major" else w.transpose(-2, -1).contiguous().transpose(-2, -1)

        def fn(wl=wl):
            return torch._grouped_mm(x, wl, offs=offs, out_dtype=torch.bfloat16)

        try:
            out = fn()[:nv_rows]
        except Exception as e:  # this torch refuses this layout or shape
            notes.append(f"{layout} refused: {type(e).__name__}: {str(e).splitlines()[0][:120]}")
            continue
        err = float((out.float() - ref[:nv_rows].float()).abs().max())
        if err > 2.0 ** -6 * float(ref[:nv_rows].float().abs().max()):
            return None, "; ".join(notes + [f"{layout} disagrees with the plain version by {err:.4g}"])
        return fn, "; ".join(notes + [f"{layout}: max_abs_err {err:.4g}"])
    return None, "torch._grouped_mm: " + "; ".join(notes)


def phase_moe_bf16_kernels(torch, skt):
    """K4 rope_decode_fused at Mixtral-8x7B's decode shape and K12
    bf16_grouped_mm at the bf16 MoE paths' shapes, against their plain
    versions: DeepSeek-V2-Lite's B=16 decode (64 experts, top-6, stacked
    banks, layer 1 of 2) and wave A's 16,384-row packed prefill at bm 128,
    Mixtral-8x7B's B=16 decode (8 experts, top-2, an unstacked bank), a
    1,024-token Mixtral prefill and Mixtral's wave A (16,384 rows) at bm 128.
    Each K12 row has CUDA-graph ms and TFLOP/s beside torch._grouped_mm's
    from the same call; at the two wave A shapes K11 (the W4A16 engines'
    grouped GEMM, on the wgmma tile) runs beside it on int4 codes of the
    same bank shape."""
    from sgl_kernel_tpu_torch.ops import moe, rope
    from sgl_kernel_tpu_torch.ops.activation import silu_and_mul
    from sgl_kernel_tpu_torch.ops.gemm import w4a16

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    bf = torch.bfloat16
    mcfg = skt.MixtralConfig.mixtral_8x7b()
    rows = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def report(name, row, dev_fn=None, work=None):
        rows[name] = report_row(torch, name, row, dev_fn, work)

    # K4 at B=16, 32 q and 8 kv heads of 128, positions across the 8,192 cache
    b, nq, nkv, d = 16, mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim
    cache = skt.build_rope_cache(mcfg, device=dev)
    pos = torch.randint(0, mcfg.max_position, (b,), generator=gen, device=dev, dtype=torch.int32)
    q, k = randn(b, nq, d), randn(b, nkv, d)
    fn = lambda: rope.rope_decode_fused(pos, q, k, cache)
    err = check("rope_decode_fused[16, 32+8 heads of 128]", list(zip(fn(), rope.rope_decode_fused_ref(pos, q, k,
                                                                                                     cache))))
    bms, bby = bound_ms(2 * b * (nq + nkv) * d * 2 + b * d * 4 + b * 4, 6 * b * (nq + nkv) * d, F32_FLOPS)
    report("rope_decode_fused", dict(
        max_abs_err=err, ms=time_ms(torch, fn), plain_ms=time_ms(torch, lambda: rope.rope_decode_fused_ref(
            pos, q, k, cache)), library_ms=None, library_note="no single PyTorch call", bound_ms=bms, bound_by=bby),
        fn)

    def w4_beside(label, name, a, kk, n, e, al, bm, pairs, k12):
        """K11 on random int4 codes and group-128 scales of the bf16 bank's
        shape (layer 1 of two stacked), on the same rows and alignment,
        beside K12's device ms on that shape (``k12``) and torch._grouped_mm
        on the dequantized layer (a yardstick the port never calls)."""
        w = torch.randint(0, 256, (2, e, kk // 2, n), generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)
        sc = (0.002 + 0.004 * torch.rand((2, e, kk // 128, n), generator=gen, device=dev)).to(bf)
        tag = f"w4a16_grouped_mm {label} {name}"
        row = grouped_w4_row(torch, moe, tag, a, w, sc, al, bm, pairs, 128, False)
        args = (a, w, sc, al.block_expert_ids, None, 1, al.num_valid_blocks)
        ref = moe.w4a16_grouped_mm_ref(*args, bm=bm)
        wd = torch.stack([w4a16.dequant_w4(w[1, i], sc[1, i]).t().contiguous() for i in range(e)])
        lib_fn, lib_note = grouped_mm_yardstick(torch, a, wd, al, row["valid_blocks"] * bm, ref)
        del ref
        row = device_rate(torch, row, lambda: moe.w4a16_grouped_mm(*args, bm=bm), 2 * pairs * kk * n, lib_fn)
        row.update(k12_graph_ms=k12["graph_ms"], k12_tflops=k12["tflops"],
                   library_note=f"torch._grouped_mm on the dequantized bf16 layer: {lib_note}")
        lib = "null" if row.get("library_graph_ms") is None else f"{row['library_graph_ms']:.4f}"
        log(f"[kernel] {tag}: graph_ms={row['graph_ms']:.4f} ({row['tflops']:.1f} TFLOP/s) against K12 bf16 on the "
            f"same shape {k12['graph_ms']:.4f} ({k12['tflops']:.1f}); torch._grouped_mm dequantized {lib} "
            f"({lib_note}); bound {row['bound_ms']:.4f}")
        rows[f"w4a16_grouped_mm_{label}_{name}"] = row
        del w, sc, wd

    def grouped(label, t, e, k_top, w1, w2, lid, routing, down=True, w4=False):
        """One routed call: tokens through routing, the alignment, then
        gate_up (and down on silu_and_mul of gate_up's output); with ``w4``
        K11 beside each K12 row (``w4_beside``)."""
        bm = moe.pick_block_size(t, k_top, e)
        tw, tids = routing(torch.randn((t, e), generator=gen, device=dev))
        al = moe.moe_align_block_size(tids, tw, e, bm)
        nv, hit = int(al.num_valid_blocks), int((al.group_sizes > 0).sum())
        x = moe.scatter_tokens_to_experts(randn(t, w1.shape[-2]), al)
        steps = [("gate_up", x, w1)]
        if down:
            steps.append(("down", silu_and_mul(moe.bf16_grouped_mm(x, w1, al.block_expert_ids, lid,
                                                                   al.num_valid_blocks, bm=bm)), w2))
        for name, a, w in steps:
            args = (a, w, al.block_expert_ids, lid, al.num_valid_blocks)
            out, ref = moe.bf16_grouped_mm(*args, bm=bm), moe.bf16_grouped_mm_ref(*args, bm=bm)
            kk, n = a.shape[1], w.shape[-1]
            err = check(f"bf16_grouped_mm {label} {name} [cap {a.shape[0]}, K {kk}, N {n}, bm {bm}, {nv} valid "
                        f"blocks, {hit} of {e} experts, {'stacked' if lid is not None else 'unstacked'}]",
                        [(out[: nv * bm], ref[: nv * bm])])
            pairs = t * k_top
            # the hit experts' banks once, the routed rows in and out
            n_bytes = hit * kk * n * 2 + pairs * (kk + n) * 2 + 4 * (al.block_expert_ids.numel() + 1)
            bms, bby = bound_ms(n_bytes, 2 * pairs * kk * n, BF16_FLOPS)
            wl = w[lid] if lid is not None else w
            lib_fn, lib_note = grouped_mm_yardstick(torch, a, wl, al, nv * bm, ref)
            del out, ref
            call = lambda: moe.bf16_grouped_mm(*args, bm=bm)
            # device ms and TFLOP/s of the kernel and of torch._grouped_mm
            # from CUDA graphs, beside the event ms of one call each
            row = device_rate(torch, dict(
                max_abs_err=err, ms=time_ms(torch, call),
                plain_ms=time_ms(torch, lambda: moe.bf16_grouped_mm_ref(*args, bm=bm), iters=3, warmup=1),
                library_ms=None if lib_fn is None else time_ms(torch, lib_fn), library_note=lib_note,
                bound_ms=bms, bound_by=bby, valid_blocks=nv, experts_hit=hit, bm=bm), call, 2 * pairs * kk * n, lib_fn)
            report(f"bf16_grouped_mm_{label}_{name}", row)
            if w4:
                w4_beside(label, name, a, kk, n, e, al, bm, pairs, row)

    dcfg = v2_lite_cfg(torch, skt, quant=None)
    e, h, inter = dcfg.num_experts, dcfg.hidden_size, dcfg.moe_intermediate
    w1 = randn(2, e, h, 2 * inter, scale=h ** -0.5)
    w2 = randn(2, e, inter, h, scale=inter ** -0.5)
    biased = lambda lg: moe.biased_topk(lg, torch.zeros(e, device=dev), dcfg.num_experts_per_tok, renormalize=True,
                                        apply_routed_scaling_factor_on_output=True)
    grouped("deepseek_decode", 16, e, dcfg.num_experts_per_tok, w1, w2, 1, biased)
    # wave A's packed launch: 16,384 rows, top-6 of 64, bm 128 (the
    # wgmma tile), gate_up then down on its silu_and_mul
    grouped("deepseek_wave_a", 16384, e, dcfg.num_experts_per_tok, w1, w2, 1, biased, w4=True)
    del w1, w2
    torch.cuda.empty_cache()
    e, h, inter = mcfg.num_experts, mcfg.hidden_size, mcfg.intermediate_size
    w1 = randn(e, h, 2 * inter, scale=h ** -0.5)
    w2 = randn(e, inter, h, scale=inter ** -0.5)
    softmax = lambda lg: moe.topk_softmax(lg, mcfg.top_k, renormalize=True)
    grouped("mixtral_decode", 16, e, mcfg.top_k, w1, w2, None, softmax)
    grouped("mixtral_prefill", 1024, e, mcfg.top_k, w1, w2, None, softmax, down=False)
    # Mixtral's wave A: 16,384 packed rows, top-2 of 8 at bm 128, gate_up;
    # K11 beside it on int4 codes of the same bank shape
    grouped("mixtral_wave_a", 16384, e, mcfg.top_k, w1, w2, None, softmax, down=False, w4=True)
    del w1, w2
    torch.cuda.empty_cache()
    return rows


class RoutingReplay:
    """Routing of an MoE model recorded on the CPU and replayed on the card:
    the card computes its own top-k, counts the tokens whose expert set
    differs from the CPU's (a flip between near-tied experts, from bf16
    sums in another order), and continues with the CPU's choice, so the
    rest of the comparison holds both sides to the same routing. ``attr``
    is the module's routing function (DeepSeek's biased_topk, Mixtral's
    topk_softmax)."""

    def __init__(self, module, attr="biased_topk"):
        self.module, self.attr, self.orig = module, attr, getattr(module, attr)
        self.calls, self.mode, self.at, self.flips, self.tokens = [], "record", 0, 0, 0
        setattr(module, attr, self)

    def __call__(self, *args, **kw):
        w, ids = self.orig(*args, **kw)
        if self.mode == "record":
            self.calls.append((w.cpu(), ids.cpu()))
            return w, ids
        rw, rids = self.calls[self.at]
        self.at += 1
        same = (ids.sort(-1).values.cpu() == rids.sort(-1).values).all(-1)
        self.flips += int((~same).sum())
        self.tokens += int(same.numel())
        return rw.to(w.device), rids.to(ids.device)

    def restore(self):
        setattr(self.module, self.attr, self.orig)


def prefix_keys(prompt, start, end):
    """A key for each prompt position in [start, end): a hash of the
    prompt's tokens up to and including it (the same token in the same
    prompt prefix has the same key in any program)."""
    h, keys = 0, []
    for p, t in enumerate(prompt[:end]):
        h = hash((h, t))
        if p >= start:
            keys.append(h)
    return keys


class TokenRouting:
    """Routing of one engine's prefill programs recorded per (layer, prompt
    prefix) and replayed in another engine's, for the warm-against-cold
    check of a top-2 MoE: the two engines prefill a token by different
    programs (extend over cached pages, or one packed launch), whose bf16
    attention sums differ by an ulp, and a flip between the 2nd and 3rd
    expert compounds over 32 layers. The cold engine computes its own top-k,
    counts the rows whose expert set differs from the warm engine's, and
    continues with the warm engine's choice. ``watch`` keys the rows of an
    engine's prefill calls; decode steps pass through."""

    def __init__(self, module, attr):
        self.module, self.attr, self.orig = module, attr, getattr(module, attr)
        self.mode, self.keys, self.layer = None, None, 0
        self.calls, self.table = [], None  # recorded (layer, keys, w, ids); replay index
        self.flips = self.replayed = 0
        setattr(module, attr, self)

    def restore(self):
        setattr(self.module, self.attr, self.orig)

    def watch(self, eng):
        from sgl_kernel_tpu_torch.serving.engine import packed_layout

        def keyed(fn, keys_of):
            def call(*args):
                self.keys, self.layer = keys_of(*args), 0
                try:
                    return fn(*args)
                finally:
                    self.keys = None
            return call

        def packed_keys(reqs):
            if len(reqs) == 1:  # the engine prefills a lone prompt through _prefill_range
                return None
            tok0, tp = packed_layout([len(r.prompt) for r in reqs], eng.max_batch + 1, eng._PACK_BLOCK)[3:5]
            keys = [None] * tp
            for r, t0 in zip(reqs, tok0):
                keys[t0: t0 + len(r.prompt)] = prefix_keys(r.prompt, 0, len(r.prompt))
            return keys

        eng._prefill_range = keyed(eng._prefill_range, lambda req, pre, end: prefix_keys(req.prompt, pre, end))
        eng._prefill_packed_batch = keyed(eng._prefill_packed_batch, packed_keys)

    def __call__(self, *args, **kw):
        w, ids = self.orig(*args, **kw)
        if self.mode is None or self.keys is None:
            return w, ids
        layer, keys = self.layer, self.keys
        self.layer += 1
        if self.mode == "record":  # kept on the device: no host wait inside the timed waves
            self.calls.append((layer, keys, w, ids))
            return w, ids
        if self.table is None:
            self.table = {}
            for c, (lay, ks, rw, ri) in enumerate(self.calls):
                self.calls[c] = (lay, ks, rw.cpu(), ri.cpu())
                self.table.update({(lay, k): (c, r) for r, k in enumerate(ks) if k is not None})
        by_call = {}
        for r, k in enumerate(keys[: w.shape[0]]):
            hit = self.table.get((layer, k)) if k is not None else None
            if hit is not None:
                rows, src = by_call.setdefault(hit[0], ([], []))
                rows.append(r)
                src.append(hit[1])
        if not by_call:
            return w, ids
        import torch

        w, ids = w.clone(), ids.clone()
        for c, (rows, src) in by_call.items():
            rw, ri = self.calls[c][2][src], self.calls[c][3][src]
            mine = ids[rows].cpu()
            self.flips += int((mine.sort(-1).values != ri.sort(-1).values).any(-1).sum())
            self.replayed += len(rows)
            at = torch.tensor(rows, device=w.device)
            w[at], ids[at] = rw.to(w.device), ri.to(ids.device)
        return w, ids


def phase_parity_deepseek(torch, skt, cfg, label):
    """V2-Lite widths cut to 2 layers (layer 0 dense, layer 1 MoE): the card
    against the CPU on the same weights (drawn on the card, copied to the
    CPU): prefill, 4 decode steps, prefill_packed and prefill_extend."""
    from sgl_kernel_tpu_torch.models import deepseek as ds
    from sgl_kernel_tpu_torch.serving.engine import packed_layout

    cfg = dataclasses.replace(cfg, num_layers=2)
    t0 = time.perf_counter()
    params_gpu = ds.init_weights(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    to_cpu = lambda v: {k: to_cpu(x) for k, x in v.items()} if isinstance(v, dict) else v.cpu()
    params_cpu = to_cpu(params_gpu)
    page, n_pages, bucket = 64, 8, 64
    sides = {dev: dict(params=params_cpu if dev == "cpu" else params_gpu,
                       kv=ds.make_cache(cfg, n_pages, page, device=dev), rope=ds.build_rope_cache(cfg, device=dev))
             for dev in ("cpu", DEVICE)}
    rng = torch.Generator().manual_seed(SEED + 1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in (40, 23)]
    pages = [[1, 2], [3, 4]]
    slot = lambda i, p: pages[i][p // page] * page + p % page
    replay = RoutingReplay(ds)

    def run(name, *arrays, **kw):
        out = {}
        for dev in ("cpu", DEVICE):
            replay.mode, sd = ("record", sides["cpu"]) if dev == "cpu" else ("replay", sides[DEVICE])
            ts = [None if a is None else torch.tensor(a, dtype=torch.int32, device=dev) for a in arrays]
            logits, sd["kv"] = getattr(ds, name)(sd["params"], cfg, sd["kv"], *ts, sd["rope"], **kw)
            out[dev] = logits.float().cpu()
        return out["cpu"], out[DEVICE]

    tol = 0.25  # as the Llama parity: bf16 activations rounded in another order through 2 layers
    worst, near_ties, steps = 0.0, 0, 0

    def compare(lc, lg, what):
        nonlocal worst, near_ties, steps
        if not torch.isfinite(lg).all():
            fail(f"parity {label} {what}: non-finite logits on the card")
        err = float((lc - lg).abs().max())
        worst = max(worst, err)
        if err > tol:
            fail(f"parity {label} {what}: logits differ by {err} > {tol}")
        for row_c, row_g in zip(lc, lg):
            tc, tg = int(row_c.argmax()), int(row_g.argmax())
            steps += 1
            if tc != tg:
                if float(row_c[tc] - row_c[tg]) > tol:
                    fail(f"parity {label} {what}: greedy token {tg} on the card, {tc} on the CPU")
                near_ties += 1
        return lc.argmax(-1).tolist()

    try:
        seqs = []
        for i, pr in enumerate(prompts):
            n = len(pr)
            tok = [pr + [0] * (bucket - n)]
            pos = [list(range(n)) + [0] * (bucket - n)]
            sl = [[slot(i, p) for p in range(n)] + [-1] * (bucket - n)]
            seqs.append(pr + compare(*run("prefill", tok, pos, [n], sl), f"prefill {i}"))
        for step in range(4):
            tokens = [sq[-1] for sq in seqs] + [0, 0]
            positions = [len(sq) - 1 for sq in seqs] + [0, 0]
            lengths = [len(sq) for sq in seqs] + [0, 0]
            slots = [slot(i, len(sq) - 1) for i, sq in enumerate(seqs)] + [-1, -1]
            tables = [p + [0] * (8 - len(p)) for p in pages] + [[0] * 8] * 2
            lc, lg = run("decode_step", tokens, positions, tables, lengths, slots)
            for sq, t in zip(seqs, compare(lc[:2], lg[:2], f"decode {step}")):
                sq.append(t)
        for dev in ("cpu", DEVICE):
            sides[dev]["kv"] = ds.make_cache(cfg, n_pages, page, device=dev)
        lens = [len(p) for p in prompts]
        blk_seq, blk_q0, seq_meta, tok0, tp, max_kvb = packed_layout(lens, 3)
        tokens, positions, slots = [0] * tp, [0] * tp, [-1] * tp
        for i, (pr, t) in enumerate(zip(prompts, tok0)):
            tokens[t: t + len(pr)], positions[t: t + len(pr)] = pr, list(range(len(pr)))
            slots[t: t + len(pr)] = [slot(i, p) for p in range(len(pr))]
        last = [t + n - 1 for t, n in zip(tok0, lens)] + [0]
        lc, lg = run("prefill_packed", None, None, tokens, positions, blk_seq, blk_q0, seq_meta, last, slots,
                     max_kvb=max_kvb)
        compare(lc[:2], lg[:2], "prefill_packed")
        ext = torch.randint(0, cfg.vocab_size, (23,), generator=rng).tolist()
        n0, s = lens[0], 32
        pad = lambda xs, fill: xs + [fill] * (s - len(xs))
        lc, lg = run("prefill_extend", [pad(ext, 0)], [pad(list(range(n0, n0 + 23)), 0)], [23], [n0 + 23],
                     [pages[0] + [0] * 6], [pad([slot(0, p) for p in range(n0, n0 + 23)], -1)], prefix_max=page)
        compare(lc, lg, "prefill_extend")
    finally:
        replay.restore()
    res = dict(max_logit_diff=worst, near_ties=near_ties, steps=steps, routing_flips=replay.flips,
               routed_tokens=replay.tokens)
    log(f"[parity] deepseek {label} 2-layer V2-Lite widths, card vs CPU (prefill, 4 decode steps, prefill_packed, "
        f"prefill_extend): max |logit diff|={worst:.4g} (tol {tol}), greedy near-ties={near_ties}/{steps}, "
        f"routing flips replayed={replay.flips}/{replay.tokens} routed tokens, {time.perf_counter() - t0:.1f} s")
    del params_gpu, sides
    free_memory(torch)
    return res


DEEPSEEK_NSA = DEEPSEEK_W4 + ("fp8_paged_mqa_logits",)
NSA_PROMPT = 6144  # wave D's prompt length: every decode row keeps 2,048 of 6,145 or more tokens


def nsa_cfg(torch, skt, **kw):
    """DeepSeek-V2-Lite widths with the NSA indexer at the widths of
    deepseek-ai/DeepSeek-V3.2-Exp's config.json (index_n_heads 64,
    index_head_dim 128, index_topk 2048), the one public model with one;
    W4A16 and the int8 latent of the DeepSeek engine above."""
    return v2_lite_cfg(torch, skt, nsa=True, idx_heads=64, idx_dim=128, index_topk=2048, **kw)


def check_logits(name, out, ref):
    """``check`` on logits with -inf past each length: the -inf positions
    must match exactly, the finite ones elementwise."""
    if not bool((out.isneginf() == ref.isneginf()).all()) or bool(out.isnan().any()):
        fail(f"{name}: the -inf (past the length) positions differ from the plain version's")
    fin = ref.isfinite()
    return check(name, [(out.where(fin, 0.0), ref.where(fin, 0.0))])


def paged_table(torch, gen, lengths, page, n_cols):
    """A page table of ``n_cols`` columns holding each length's pages, from
    a permutation of pages 1.. (page 0 pads). Returns (table, pages used)."""
    used = [-(-n // page) for n in lengths]
    perm = torch.randperm(sum(used), generator=gen, device=DEVICE) + 1
    table = torch.zeros((len(lengths), n_cols), dtype=torch.int32, device=DEVICE)
    at = 0
    for i, n in enumerate(used):
        table[i, :n] = perm[at: at + n]
        at += n
    return table, sum(used)


def phase_nsa_kernels(torch, skt):
    """K15 fp8_paged_mqa_logits at the NSA indexer's widths (64 heads of 128,
    fp8 e4m3 keys with float32 scales, page 64): the engine's decode (B=16,
    lengths 1..1,056, 128-page tables), B=16 at 8,192 tokens and B=1 at
    32,768 (benchmark/bench_misc_ops.py's long shape), and one call on bf16
    keys without scales; K13b (mla_decode(engine="dma")) at K13a's shapes
    on a bf16 pool, a 640-wide bf16 pool and a 640-wide fp8 pool, with lse.
    Each against its plain version."""
    from sgl_kernel_tpu_torch.ops.attention import mla, nsa

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf = torch.bfloat16
    cfg = nsa_cfg(torch, skt)
    h, d, page, b = cfg.idx_heads, cfg.idx_dim, 64, 16
    rows = {}

    def report(name, row, dev_fn=None, work=None):
        rows[name] = report_row(torch, name, row, dev_fn, work)

    decode_lens = [1 + (1055 * i) // (b - 1) for i in range(b)]
    for label, lengths_l, n_cols, key_dt in (("decode", decode_lens, cfg.max_position // page, torch.float8_e4m3fn),
                                             ("decode_bf16", decode_lens, cfg.max_position // page, bf),
                                             ("ctx8192", [8192] * b, 8192 // page, torch.float8_e4m3fn),
                                             ("ctx32768", [32768], 32768 // page, torch.float8_e4m3fn)):
        # keys and scales stacked over layers to at least COLD_BYTES, as the
        # engine's indexer pool is (layer-offset page ids): the warm rows read
        # layer 0, the cold rows cycle the layers
        table, n_used = paged_table(torch, gen, lengths_l, page, n_cols)
        bb, n_pages = len(lengths_l), n_used + 1
        per_layer = n_used * page * (d * key_dt.itemsize + (4 if key_dt != bf else 0))
        layers = max(2, -(-int(COLD_BYTES) // per_layer))
        keys = (torch.randn((layers * n_pages, page, d), generator=gen, device=dev) * 2).to(key_dt)
        scales = (None if key_dt == bf else
                  torch.rand((layers * n_pages, page), generator=gen, device=dev) * 0.01 + 1e-3)
        q = (torch.randn((bb, h, d), generator=gen, device=dev) * 0.5).to(bf)
        w = torch.sigmoid(torch.randn((bb, h), generator=gen, device=dev))  # the engine's head gates
        lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
        tables = [table + i * n_pages for i in range(layers)]
        fn = lambda: nsa.fp8_paged_mqa_logits(q, keys, w, lengths, table, scales)
        ref_fn = lambda: nsa.fp8_paged_mqa_logits_ref(q, keys, w, lengths, table, scales)
        name = (f"fp8_paged_mqa_logits {label} [B {bb}, {h} heads of {d}, {keys.dtype}, "
                f"{'scaled' if scales is not None else 'no scales'}]")
        out = fn()
        err = check_logits(name, out, ref_fn())
        check_repeat(name, fn, out)
        n_tok = sum(lengths_l)
        # each cached key (and its scale) read once, q, the gates and the used
        # table entries once; every logit written once, -inf past the length too
        n_bytes = (n_tok * (d * keys.element_size() + (4 if scales is not None else 0)) + bb * h * (d * 2 + 4)
                   + n_used * 4 + bb * 4 + bb * n_cols * page * 4)
        bms, bby = bound_ms(n_bytes, 2 * h * d * n_tok, BF16_FLOPS)
        cold = cold_graph_ms(torch, lambda i: nsa.fp8_paged_mqa_logits(q, keys, w, lengths, tables[i], scales), layers,
                             reps=max(24, layers))
        report(f"fp8_paged_mqa_logits_{label}", dict(
            max_abs_err=err, ms=time_ms(torch, fn), plain_ms=time_ms(torch, ref_fn, iters=3, warmup=1),
            library_ms=None, library_note="no PyTorch call computes a paged, relu-weighted head reduction",
            bound_ms=bms, bound_by=bby, cold_ms=cold), fn)
        del keys, scales, tables

    # K13b at K13a's shapes: B=16, contexts 1..1056, 16 heads, page 64,
    # 128-entry tables, a two-layer pool (layer 1)
    nh = cfg.num_heads
    table, n_used = paged_table(torch, gen, decode_lens, page, cfg.max_position // page)
    lengths = torch.tensor(decode_lens, dtype=torch.int32, device=dev)
    qn = (torch.randn((b, nh, 512), generator=gen, device=dev) * 0.3).to(bf)
    qp = (torch.randn((b, nh, 64), generator=gen, device=dev) * 0.3).to(bf)
    sm = 1.0 / (cfg.qk_nope_dim + 64) ** 0.5
    for kind, dt, width, scale in (("bf16", bf, 576, 1.0), ("bf16_640", bf, 640, 1.0),
                                   ("e4m3_640", torch.float8_e4m3fn, 640, 0.5)):
        pool = (torch.randn((2, n_used + 1, page, width), generator=gen, device=dev) * (1.0 if dt == bf else 2.0))
        pool[..., 576:] = 0
        pool = pool.to(dt)
        kw = dict(sm_scale=sm * scale, return_lse=True)
        fn = lambda: mla.mla_decode(qn, qp, pool, lengths, table, 1, engine="dma", **kw)
        ref_fn = lambda: mla.mla_decode_dma_ref(qn, qp, pool, lengths, table, 1, **kw)
        before = mla.mla_decode_dma.launches
        out, lse = fn()
        if mla.mla_decode_dma.launches != before + 1:
            fail(f"mla_decode(engine='dma') on a {kind} pool did not launch K13b")
        ref, ref_lse = ref_fn()
        err = check(f"mla_decode_dma {kind} pool [16, ctx 1..1056]", [(out, ref), (lse, ref_lse)])
        n_bytes = (sum(decode_lens) * 576 * pool.element_size() + b * nh * (576 + 512) * 2 + b * nh * 4
                   + n_used * 4 + b * 4)
        bms, bby = bound_ms(n_bytes, 2 * nh * (576 + 512) * sum(decode_lens), BF16_FLOPS)
        k13a_fn = lambda: mla.mla_decode(qn, qp, pool, lengths, table, 1, **kw)
        report(f"mla_decode_dma_{kind}", dict(
            max_abs_err=err, ms=time_ms(torch, fn), plain_ms=time_ms(torch, ref_fn), library_ms=None,
            library_note="no PyTorch call attends over a paged pool", bound_ms=bms, bound_by=bby,
            k13a_graph_ms=graph_ms(torch, k13a_fn)), fn)
        del pool
    return rows


class SelectionReplay(RoutingReplay):
    """The NSA selections (``fast_topk_transform_fused``'s slots) of the CPU
    recorded and compared with the card's: the card's scores differ from the
    CPU's in the last bits, so the 2,048th place may flip. ``compare`` counts,
    per layer, the slots the card selects that the CPU does not, and keeps
    the card's selection; ``replay`` counts the same and continues with the
    CPU's."""

    def __init__(self, module, n_layers, attr="fast_topk_transform_fused"):
        super().__init__(module, attr)
        self.n_layers, self.flips, self.slots = n_layers, [0] * n_layers, [0] * n_layers

    def __call__(self, *args, **kw):
        out = self.orig(*args, **kw)
        if self.mode == "record":
            self.calls.append(out.cpu())
            return out
        ref = self.calls[self.at]
        layer = self.at % self.n_layers
        self.at += 1
        for mine, theirs in zip(out.cpu().tolist(), ref.tolist()):
            keep = set(theirs) - {-1}
            self.flips[layer] += len((set(mine) - {-1}) - keep)
            self.slots[layer] += len(keep)
        return ref.to(out.device) if self.mode == "replay" else out


def phase_parity_nsa(torch, skt, cfg, label):
    """V2-Lite widths with the NSA indexer, cut to 2 layers (layer 0 dense,
    layer 1 MoE): the card against the CPU on the same weights. Sequence 0
    by prefill_nsa (1,024 tokens) and two prefill_extend_nsa chunks (3,000
    tokens), sequence 1 by prefill_packed(with_indexer=True) (1,024) and two
    extends (2,900), then 4 decode_step_nsa steps over both (contexts above
    index_topk: the selection drops tokens), the routing of the CPU replayed
    on the card as for DeepSeek. Selection flips are counted per layer; if
    the decode logits miss the 0.25 gate the decode steps run again on the
    card with the CPU's selection replayed, and both runs are reported."""
    from sgl_kernel_tpu_torch.models import deepseek as ds
    from sgl_kernel_tpu_torch.serving.engine import packed_layout

    cfg = dataclasses.replace(cfg, num_layers=2)
    t0 = time.perf_counter()
    params_gpu = ds.init_weights(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    to_cpu = lambda v: {k: to_cpu(x) for k, x in v.items()} if isinstance(v, dict) else v.cpu()
    params_cpu = to_cpu(params_gpu)
    page, chunk, per_seq = 64, 1024, 48  # 48 pages = 3,072 tokens a sequence
    lens = [3000, 2900]
    n_pages = len(lens) * per_seq + 1
    pages = [list(range(1 + i * per_seq, 1 + (i + 1) * per_seq)) for i in range(len(lens))]
    slot = lambda i, p: pages[i][p // page] * page + p % page
    sides = {}
    for dev in ("cpu", DEVICE):
        ik, isc = ds.make_indexer_cache(cfg, n_pages, page, device=dev)
        sides[dev] = dict(params=params_cpu if dev == "cpu" else params_gpu, kv=ds.make_cache(cfg, n_pages, page,
                                                                                              device=dev),
                          ik=ik, isc=isc, rope=ds.build_rope_cache(cfg, device=dev),
                          irope=ds.build_idx_rope_cache(cfg, device=dev))
    rng = torch.Generator().manual_seed(SEED + 8)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in lens]
    routing = RoutingReplay(ds)
    sel = SelectionReplay(ds, cfg.num_layers)

    def run(dev, name, *arrays, **kw):
        sd = sides[dev]
        routing.mode = "record" if dev == "cpu" else "replay"
        sel.mode = "record" if dev == "cpu" else sel_mode
        ts = [torch.tensor(a, dtype=torch.int32, device=dev) for a in arrays]
        pools = (sd["kv"], sd["ik"], sd["isc"])
        if name == "prefill_packed":
            out = ds.prefill_packed(sd["params"], cfg, *pools, *ts, sd["rope"], with_indexer=True,
                                    idx_rope_cache=sd["irope"], **kw)
        else:
            out = getattr(ds, name)(sd["params"], cfg, *pools, *ts, sd["rope"], sd["irope"], **kw)
        logits, sd["kv"], sd["ik"], sd["isc"] = out
        return logits.float().cpu()

    tol = 0.25  # as the other parity checks
    worst = {"prefill": 0.0}
    greedy_ties = 0

    def err_of(lc, lg, what):
        nonlocal greedy_ties
        if not torch.isfinite(lg).all():
            fail(f"parity nsa {label} {what}: non-finite logits on the card")
        for row_c, row_g in zip(lc, lg):
            tc, tg = int(row_c.argmax()), int(row_g.argmax())
            if tc != tg:
                if float(row_c[tc] - row_c[tg]) > tol:
                    fail(f"parity nsa {label} {what}: greedy token {tg} on the card, {tc} on the CPU")
                greedy_ties += 1
        return float((lc - lg).abs().max())

    sel_mode = "compare"
    try:
        first = []
        for i, pr in enumerate(prompts):
            n0 = chunk
            if i == 0:
                tok, pos = [pr[:n0]], [list(range(n0))]
                sl = [[slot(0, p) for p in range(n0)]]
                out = {dev: run(dev, "prefill_nsa", tok, pos, [n0], sl) for dev in ("cpu", DEVICE)}
            else:
                blk_seq, blk_q0, seq_meta, tok0, tp, max_kvb = packed_layout([n0], 2)
                tokens, positions, slots = [0] * tp, [0] * tp, [-1] * tp
                tokens[:n0], positions[:n0], slots[:n0] = pr[:n0], list(range(n0)), [slot(1, p) for p in range(n0)]
                out = {dev: run(dev, "prefill_packed", tokens, positions, blk_seq, blk_q0, seq_meta, [n0 - 1, 0],
                                slots, max_kvb=max_kvb) for dev in ("cpu", DEVICE)}
            worst["prefill"] = max(worst["prefill"], err_of(out["cpu"][:1], out[DEVICE][:1], f"prefill {i}"))
            table = [pages[i]]
            for pre in range(n0, len(pr), chunk):
                end = min(pre + chunk, len(pr))
                pad = lambda xs, fill: [xs + [fill] * (chunk - len(xs))]
                out = {dev: run(dev, "prefill_extend_nsa", pad(pr[pre:end], 0), pad(list(range(pre, end)), 0),
                                [end - pre], [end], table, pad([slot(i, p) for p in range(pre, end)], -1),
                                prefix_max=pre) for dev in ("cpu", DEVICE)}
                worst["prefill"] = max(worst["prefill"], err_of(out["cpu"], out[DEVICE], f"extend {i} to {end}"))
            first.append(int(out["cpu"][0].argmax()))
        if worst["prefill"] > tol:
            fail(f"parity nsa {label}: prefill logits differ by {worst['prefill']} > {tol}")
        # decode: the CPU's 4 steps first (recording routing and selections),
        # then the card's on the CPU's greedy tokens
        seqs = [pr + [t] for pr, t in zip(prompts, first)]
        steps, cpu_logits = [], []
        for step in range(4):
            b = 4  # two sequences and two padding rows
            args = ([s[-1] for s in seqs] + [0, 0], [len(s) - 1 for s in seqs] + [0, 0],
                    [pages[0], pages[1]] + [[0] * per_seq] * (b - 2), [len(s) for s in seqs] + [0, 0],
                    [slot(i, len(s) - 1) for i, s in enumerate(seqs)] + [-1, -1])
            steps.append(args)
            lc = run("cpu", "decode_step_nsa", *args)[:2]
            cpu_logits.append(lc)
            for s, t in zip(seqs, lc.argmax(-1).tolist()):
                s.append(t)
        saved = {k: sides[DEVICE][k].clone() for k in ("kv", "ik", "isc")}
        at0, sel_at0 = routing.at, sel.at
        runs = {}
        for sel_mode in ("compare", "replay"):
            sel.flips, sel.slots = [0] * cfg.num_layers, [0] * cfg.num_layers
            routing.at, sel.at = at0, sel_at0
            sides[DEVICE].update({k: v.clone() for k, v in saved.items()})
            errs = [err_of(lc, run(DEVICE, "decode_step_nsa", *args)[:2], f"decode {i} ({sel_mode})")
                    for i, (lc, args) in enumerate(zip(cpu_logits, steps))]
            runs[sel_mode] = dict(max_logit_diff=max(errs), selection_flips_by_layer=list(sel.flips),
                                  selected_slots_by_layer=list(sel.slots))
            log(f"[parity] nsa {label} decode ({sel_mode} the CPU's selection): max |logit diff|={max(errs):.4g}, "
                f"selection flips by layer {sel.flips} of {sel.slots} selected slots")
            if max(errs) <= tol:
                break
        if runs[sel_mode]["max_logit_diff"] > tol:
            fail(f"parity nsa {label}: decode logits differ by {runs[sel_mode]['max_logit_diff']} > {tol} "
                 f"with the CPU's selection replayed")
    finally:
        routing.restore()
        sel.restore()
    res = dict(max_prefill_logit_diff=worst["prefill"], decode=runs, greedy_near_ties=greedy_ties,
               routing_flips=routing.flips, routed_tokens=routing.tokens, contexts=[len(s) for s in seqs])
    log(f"[parity] nsa {label} 2-layer V2-Lite widths, card vs CPU (prefill_nsa, prefill_packed with the "
        f"indexer, prefill_extend_nsa, 4 decode_step_nsa steps at contexts {res['contexts']}): max |prefill logit "
        f"diff|={worst['prefill']:.4g} (tol {tol}), routing flips replayed={routing.flips}/{routing.tokens}, "
        f"greedy near-ties={greedy_ties}, {time.perf_counter() - t0:.1f} s")
    del params_gpu, sides, saved
    free_memory(torch)
    return res


class SparseRows:
    """Counts, at each decode step's first layer, the rows that select fewer
    slots than their length, into a counter on the device (read after the
    wave): an in-place add, so a decode graph captured with the hook in
    place adds on every replay."""

    def __init__(self, torch, module, n_layers, device, attr="fast_topk_transform_fused"):
        self.module, self.attr, self.orig, self.n_layers = module, attr, getattr(module, attr), n_layers
        self.calls, self.total = 0, torch.zeros((), dtype=torch.int64, device=device)
        setattr(module, attr, self)

    def restore(self):
        setattr(self.module, self.attr, self.orig)

    def __call__(self, logits, lengths, *args, **kw):
        out = self.orig(logits, lengths, *args, **kw)
        if self.calls % self.n_layers == 0:
            self.total += ((out >= 0).sum(1) < lengths.to(out.device)).sum()
        self.calls += 1
        return out

    def count(self):
        return int(self.total)


def recapture(eng):
    """Capture the engine's decode graph again, so that a hook installed
    since is in the replayed step: over padding rows only (length 0, slot
    -1), so the warm-up stores nothing."""
    eng._inputs.fill(*eng._decode_inputs([], 0))
    eng._graphs.pop(1, None)
    eng._decode_graph(1)()


def wave_d(torch, skt, eng, stats, res, label):
    """Wave D of the NSA engine: 4 fresh prompts of NSA_PROMPT tokens in
    1,024-token chunks (one plain prefill and five extends each), then 32
    decode tokens each, every decode row over a sparse selection. K15
    launches (only decode steps score), and at least one decode row selects
    fewer slots than its length (counted by a hook captured into the decode
    graph for the wave)."""
    from sgl_kernel_tpu_torch.models import deepseek as ds

    gen = torch.Generator().manual_seed(SEED + 4)
    prompts = [random_prompt(torch, gen, eng.cfg.vocab_size, NSA_PROMPT) for _ in range(4)]
    sparse = SparseRows(torch, ds, eng.cfg.num_layers, eng.device)
    try:
        recapture(eng)
        d, _ = run_wave(torch, skt, eng, stats, label, "D", prompts,
                        expect=[k for k in DEEPSEEK_NSA if k != "flash_attention_packed"], hits=0)
    finally:
        sparse.restore()
    recapture(eng)  # the step without the hook again
    check_576(label, "D", d, "flash_attention_576")
    n_chunks = -(-NSA_PROMPT // 1024)
    if d["program_calls"] != {"prefill": len(prompts), "prefill_extend": len(prompts) * (n_chunks - 1)}:
        fail(f"serve {label} wave D: prompts in chunks by {d['program_calls']}")
    d["sparse_decode_rows"] = sparse.count()
    log(f"[serve] {label} wave D: {d['sparse_decode_rows']} decode rows (first layer) selected fewer slots than "
        f"their length; decode {d['decode_ms_step']:.2f} ms/step against wave A's "
        f"{res['waves'][0]['decode_ms_step']:.2f}")
    if d["sparse_decode_rows"] <= 0:
        fail(f"serve {label} wave D: no decode row selected fewer slots than its length")
    res["waves"].append(d)
    for k in res["launches"]:
        res["launches"][k] += d["launches"][k]


def path_mla_decode_dma(torch, skt):
    """K13b's path: no model calls mla_decode(engine="dma"), in the JAX
    package either; its one entry point is the op. Driven as a user calls
    it, over the 27 layers of a full-depth bf16 V2-Lite latent pool at the
    DeepSeek decode shape (B=16, 16 heads, contexts 1..1,056, page 64),
    counts set to 0 just before and read just after: K13b launches once a
    layer and K13a never."""
    from sgl_kernel_tpu_torch.ops.attention import mla

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    cfg = v2_lite_cfg(torch, skt)
    b, page, nh = 16, 64, cfg.num_heads
    lengths_l = [1 + (1055 * i) // (b - 1) for i in range(b)]
    table, n_used = paged_table(torch, gen, lengths_l, page, cfg.max_position // page)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    pool = torch.randn((cfg.num_layers, n_used + 1, page, 576), generator=gen, device=dev).to(torch.bfloat16)
    q_lat = (torch.randn((cfg.num_layers, b, nh, 512), generator=gen, device=dev) * 0.3).to(torch.bfloat16)
    q_pe = (torch.randn((cfg.num_layers, b, nh, 64), generator=gen, device=dev) * 0.3).to(torch.bfloat16)
    sm = 1.0 / (cfg.qk_nope_dim + 64) ** 0.5
    torch.cuda.synchronize()
    skt.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [mla.mla_decode(q_lat[lidx], q_pe[lidx], pool, lengths, table, lidx, sm_scale=sm, engine="dma")
            for lidx in range(cfg.num_layers)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = skt.launch_counts()
    if counts["mla_decode_dma"] != cfg.num_layers or counts["mla_decode"] != 0:
        fail(f"mla_decode(engine='dma') path: launches {counts}")
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        fail("mla_decode(engine='dma') path: non-finite output")
    res = dict(layers=cfg.num_layers, batch=b, wall_ms=1e3 * wall, launches=counts)
    log("[path] mla_decode(engine='dma') over 27 layers: " + json.dumps(res))
    del pool
    return res


def phase_decode_variants(torch, skt):
    """Slice 7's kernels against their plain versions. K10 (w4a16_gemm_dma)
    at the W4A16 Llama-3-8B decode GEMMs (M=16, group 128: qkv, o with its
    residual, gate_up, down on the gate / up slices of one [M, 2I] tensor
    with silu_mul and a residual, the padded lm_head; gate_up also at M=1
    and M=32), with K1's CUDA-graph time on the same call and
    torch._weight_int4pack_mm beside each. The decode kernel at K5's shape
    (B=16, 32 q / 8 kv heads of 128, page 64, contexts 1..1,056, 32-layer
    pools, layer 31): K8 (paged_attention_decode) over head-major pools in
    bf16 and in e4m3 with scales; K5 with layout="head" on the same pools;
    K5 with return_lse; K5 split at choose_num_splits(B, ctx, 64, 16,
    sm_count()) at B=16 and at B=1 x 32,768, beside the unsplit time; K5
    with sinks, window 128 and softcap 30."""
    from sgl_kernel_tpu_torch.ops.attention import paged_decode, paged_decode_dma
    from sgl_kernel_tpu_torch.ops.gemm import w4a16, w4a16_dma
    from sgl_kernel_tpu_torch.utils import sm_count

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    bf = torch.bfloat16
    n_sm = sm_count(0)
    rows = {}

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def report(name, row, dev_fn=None, work=None):
        rows[name] = report_row(torch, name, row, dev_fn, work)

    cfg = skt.LlamaConfig.llama3_8b(fused=True)
    h, inter, nq, nkv, d = cfg.hidden_size, cfg.intermediate_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g, vocab = cfg.group_size, -(-cfg.vocab_size // 2048) * 2048  # the lm_head's N padded as the model pads it
    for name, m, n, k, opt in (("qkv", 16, (nq + 2 * nkv) * d, h, None), ("o", 16, h, nq * d, "residual"),
                               ("gate_up", 16, 2 * inter, h, None), ("down", 16, h, inter, "silu_mul"),
                               ("lm_head", 16, vocab, h, None), ("gate_up_m1", 1, 2 * inter, h, None),
                               ("gate_up_m32", 32, 2 * inter, h, None)):
        w, scales, _ = w4a16.quantize_w4(torch.randn((n, k), generator=gen, device=dev) * 0.02, group_size=g)
        kw = dict(group_size=g)
        if opt == "silu_mul":
            gu = randn(m, 2 * k)
            a = gu[:, :k]
            kw.update(a2=gu[:, k:], prologue="silu_mul")
        else:
            a = randn(m, k)
        if opt is not None:
            kw["residual"] = randn(m, n)
        fn = lambda: w4a16_dma.w4a16_gemm_dma(a, w, scales, **kw)
        ref_fn = lambda: w4a16_dma.w4a16_gemm_dma_ref(a, w, scales, **kw)
        before = w4a16_dma.w4a16_gemm_dma.launches
        out = fn()
        if w4a16_dma.w4a16_gemm_dma.launches != before + 1:
            fail(f"w4a16_gemm_dma {name} did not launch K10")
        err = check(f"w4a16_gemm_dma {name} [{m}, {n}, {k}]", [(out, ref_fn())])
        # codes, scales, activations (a and a2), residual, the bf16 output
        n_bytes = (w.numel() + 2 * scales.numel() + 2 * m * k * (2 if "a2" in kw else 1)
                   + (2 * m * n if "residual" in kw else 0) + 2 * m * n)
        bms, bby = bound_ms(n_bytes, 2 * m * n * k, BF16_FLOPS)
        check_repeat(f"w4a16_gemm_dma {name}", fn, out)
        lib_ms, lib_graph, lib_note = int4pack_ms(torch, a.contiguous(), w, scales, g)
        blocks, tiles, n_kb = w4a16_dma.plan(m, n, k, n_sm)
        row = dict(max_abs_err=err, ms=time_ms(torch, fn), plain_ms=time_ms(torch, ref_fn, iters=3, warmup=1),
                   library_ms=lib_ms, library_graph_ms=lib_graph, bound_ms=bms, bound_by=bby,
                   library_note=f"(_weight_int4pack_mm, bare GEMM: {lib_note})",
                   k1_graph_ms=graph_ms(torch, lambda: w4a16.w4a16_gemm(a, w, scales, **kw)),
                   plan=dict(blocks=blocks, tiles=tiles, k_blocks=n_kb))
        if m == 16:  # K10 and K1 on one bank of cold weights, in turns
            wc, sc_, layers = cold_bank(torch, gen, (), k, n, g, dev)
            k10_cold = lambda lid: w4a16_dma.w4a16_gemm_dma(a, wc, sc_, layer_id=lid, **kw)
            k1_cold = lambda lid: w4a16.w4a16_gemm(a, wc, sc_, layer_id=lid, **kw)
            times = [cold_graph_ms(torch, f, layers) for f in (k10_cold, k1_cold, k1_cold, k10_cold)]
            row.update(cold_graph_ms=min(times[0], times[3]), k1_cold_graph_ms=min(times[1], times[2]),
                       cold_layers=layers)
            del wc, sc_
        report(f"w4a16_gemm_dma_{name}", row, fn)
        cold = (f"; cold {row['cold_graph_ms']:.4f} ms against K1's {row['k1_cold_graph_ms']:.4f}"
                if "cold_graph_ms" in row else "")
        log(f"[kernel] w4a16_gemm_dma {name}: {100 * bms / row['graph_ms']:.1f} % of HBM on the device, "
            f"K1 {100 * bms / row['k1_graph_ms']:.1f} % ({row['k1_graph_ms']:.4f} ms){cold}; plan {row['plan']}")
        del w, scales, a, kw, out
        torch.cuda.empty_cache()

    # the decode kernel at K5's shape (phase 2's K5 rows): the pool holds
    # length-1 tokens, the current token rides as the fresh row
    n_layers = cfg.num_layers
    b, page, layer = 16, 64, n_layers - 1
    lengths_l = [1 + (1055 * i) // (b - 1) for i in range(b)]
    table, n_used = paged_table(torch, gen, [n - 1 for n in lengths_l], page, cfg.max_position // page)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    shape = (n_layers, n_used + 1, nkv, page, d)
    kp, vp = randn(*shape), randn(*shape)
    kh, vh = kp.transpose(1, 2).contiguous(), vp.transpose(1, 2).contiguous()
    q, fk, fv = randn(b, nq, d), randn(b, nkv, d), randn(b, nkv, d)
    dkw = dict(layer_id=layer, fresh_k=fk, fresh_v=fv)
    pool_tokens = sum(n - 1 for n in lengths_l)
    small = (2 * b * nq * d + 2 * b * nkv * d) * 2 + n_used * 4 + b * 4  # q, out, fresh rows, table, lengths

    def attn_row(name, fn, ref_fn, n_bytes, n_tok, what):
        before = {f: f.launches for f in (paged_decode.paged_attention_decode,
                                           paged_decode_dma.paged_attention_decode_dma)}
        out = fn()
        if sum(f.launches - n0 for f, n0 in before.items()) != 1:
            fail(f"{name}: not one launch of the decode kernel")
        ref = ref_fn()
        pairs = list(zip(out, ref)) if isinstance(out, tuple) else [(out, ref)]
        err = check(f"{name} [{what}]", pairs)
        check_repeat(name, fn, out)
        bms, bby = bound_ms(n_bytes, 4 * n_tok * nq * d, BF16_FLOPS)
        row = dict(max_abs_err=err, ms=time_ms(torch, fn), plain_ms=time_ms(torch, ref_fn, iters=5),
                   library_ms=None, library_note="(no PyTorch call attends over a paged pool)", bound_ms=bms,
                   bound_by=bby)
        report(name, row, fn)
        return row

    bf_bytes = 2 * pool_tokens * nkv * d * 2 + small
    what = "B=16, ctx 1..1056, 32 layers"
    attn_row("paged_attention_decode", lambda: paged_decode.paged_attention_decode(q, kh, vh, lengths, table, **dkw),
             lambda: paged_decode.paged_attention_decode_ref(q, kh, vh, lengths, table, **dkw), bf_bytes,
             sum(lengths_l), what + ", head-major bf16")
    k8, v8 = (randn(*kh.shape, dtype=torch.float8_e4m3fn, scale=4.0) for _ in range(2))
    fkw = dict(dkw, k_scale=0.5, v_scale=0.5)
    attn_row("paged_attention_decode_e4m3",
             lambda: paged_decode.paged_attention_decode(q, k8, v8, lengths, table, **fkw),
             lambda: paged_decode.paged_attention_decode_ref(q, k8, v8, lengths, table, **fkw),
             2 * pool_tokens * nkv * d + small, sum(lengths_l), what + ", head-major e4m3, scales 0.5")
    del k8, v8
    attn_row("paged_attention_decode_dma_head",
             lambda: paged_decode_dma.paged_attention_decode_dma(q, kh, vh, lengths, table, layout="head", **dkw),
             lambda: paged_decode_dma.paged_attention_decode_ref(q, kh, vh, lengths, table, layout="head", **dkw),
             bf_bytes, sum(lengths_l), what + ', layout="head"')
    del kh, vh
    lkw = dict(dkw, return_lse=True)
    attn_row("paged_attention_decode_dma_lse",
             lambda: paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lengths, table, **lkw),
             lambda: paged_decode_dma.paged_attention_decode_ref(q, kp, vp, lengths, table, **lkw),
             bf_bytes + b * nq * 4, sum(lengths_l), what + ", return_lse")
    ns = paged_decode_dma.choose_num_splits(b, max(lengths_l), page, 16, num_cores=n_sm)
    skw = dict(dkw, num_splits=ns, chunk_pages=16)
    row = attn_row("paged_attention_decode_dma_split16",
                   lambda: paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lengths, table, **skw),
                   lambda: paged_decode_dma.paged_attention_decode_ref(q, kp, vp, lengths, table, **skw),
                   bf_bytes, sum(lengths_l), what + f", num_splits={ns}")
    row.update(num_splits=ns, unsplit_graph_ms=graph_ms(
        torch, lambda: paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lengths, table, **dkw)))
    # sinks, window 128, softcap 30: only the last 128 positions attend
    sinks = torch.randn(nq, generator=gen, device=dev)
    okw = dict(dkw, sliding_window=128, logit_soft_cap=30.0)
    win_tokens = sum(min(n - 1, 127) for n in lengths_l)
    attn_row("paged_attention_decode_dma_options",
             lambda: paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lengths, table, sinks, **okw),
             lambda: paged_decode_dma.paged_attention_decode_ref(q, kp, vp, lengths, table, sinks, **okw),
             2 * win_tokens * nkv * d * 2 + small + nq * 4, win_tokens + b, what + ", sinks, window 128, softcap 30")
    del kp, vp
    # B=16 x 8,192, one layer: the long-context decode users see (537 MB of K/V)
    long_b = [8192] * b
    table, n_used = paged_table(torch, gen, [n - 1 for n in long_b], page, 8192 // page)
    lengths = torch.tensor(long_b, dtype=torch.int32, device=dev)
    kp, vp = randn(1, n_used + 1, nkv, page, d), randn(1, n_used + 1, nkv, page, d)
    lkw = dict(fresh_k=fk, fresh_v=fv)
    n_tok = sum(n - 1 for n in long_b)
    attn_row("paged_attention_decode_dma_ctx8192",
             lambda: paged_decode_dma.paged_attention_decode_dma(q, kp, vp, lengths, table, **lkw),
             lambda: paged_decode_dma.paged_attention_decode_ref(q, kp, vp, lengths, table, **lkw),
             2 * n_tok * nkv * d * 2 + (2 * b * nq * d + 2 * b * nkv * d) * 2 + n_used * 4 + b * 4, sum(long_b),
             "B=16 x 8,192")
    del kp, vp
    # B=1 x 32,768 tokens, one layer: the split's case
    long_len = [32768]
    table, n_used = paged_table(torch, gen, [long_len[0] - 1], page, long_len[0] // page)
    lengths = torch.tensor(long_len, dtype=torch.int32, device=dev)
    kp, vp = randn(1, n_used + 1, nkv, page, d), randn(1, n_used + 1, nkv, page, d)
    q1, fk1, fv1 = q[:1].contiguous(), fk[:1].contiguous(), fv[:1].contiguous()
    ns = paged_decode_dma.choose_num_splits(1, long_len[0], page, 16, num_cores=n_sm)
    lkw = dict(fresh_k=fk1, fresh_v=fv1, num_splits=ns, chunk_pages=16)
    n_bytes = 2 * (long_len[0] - 1) * nkv * d * 2 + (2 * nq * d + 2 * nkv * d) * 2 + n_used * 4 + 4
    row = attn_row("paged_attention_decode_dma_split_32k",
                   lambda: paged_decode_dma.paged_attention_decode_dma(q1, kp, vp, lengths, table, **lkw),
                   lambda: paged_decode_dma.paged_attention_decode_ref(q1, kp, vp, lengths, table, **lkw),
                   n_bytes, long_len[0], f"B=1 x 32,768, num_splits={ns}")
    unsplit = lambda: paged_decode_dma.paged_attention_decode_dma(q1, kp, vp, lengths, table, fresh_k=fk1,
                                                                  fresh_v=fv1)
    check("paged_attention_decode_dma unsplit [B=1 x 32,768]",
          [(unsplit(), paged_decode_dma.paged_attention_decode_ref(q1, kp, vp, lengths, table, fresh_k=fk1,
                                                                   fresh_v=fv1))])
    row.update(num_splits=ns, unsplit_ms=time_ms(torch, unsplit), unsplit_graph_ms=graph_ms(torch, unsplit))
    log(f"[kernel] paged_attention_decode_dma B=1 x 32,768: {ns} splits {row['graph_ms']:.4f} ms against "
        f"{row['unsplit_graph_ms']:.4f} unsplit (CUDA graph)")
    del kp, vp
    return rows


def path_head_major_decode(torch, skt, steps=8):
    """K8's path: no model calls paged_attention_decode, in the JAX package
    either; its entry points are the ops. Driven as a user calls them: 32
    layers of head-major pools at Llama-3-8B widths (8 kv heads of 128,
    page 64), B=16 at contexts 1..1,056, ``steps`` decode steps; each layer
    stores the step's K/V with store_cache_head_major, then attends with
    paged_attention_decode (K8, layer_id). Counts set to 0 just before and
    read just after: K8 launches once a layer and step. Gate: each output
    equals K5's over the page-major transpose of the same layer's pools
    (one kernel, other strides: bit for bit)."""
    from sgl_kernel_tpu_torch.ops import kvcache
    from sgl_kernel_tpu_torch.ops.attention import paged_decode, paged_decode_dma

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    cfg = skt.LlamaConfig.llama3_8b(fused=True)
    nq, nkv, d, n_layers = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    b, page = 16, 64
    lengths_l = [1 + (1055 * i) // (b - 1) for i in range(b)]
    table, n_used = paged_table(torch, gen, [n + steps for n in lengths_l], page, cfg.max_position // page)
    shape = (n_layers, nkv, n_used + 1, page, d)
    kh = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vh = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    lengths0 = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    worst, outs = 0.0, 0
    torch.cuda.synchronize()
    skt.reset_launch_counts()
    t0 = time.perf_counter()
    for step in range(steps):
        lengths = lengths0 + step
        pos = (lengths - 1).long()
        slots = table[rows, pos // page].long() * page + pos % page
        for lidx in range(n_layers):
            q = torch.randn((b, nq, d), generator=gen, device=dev).to(torch.bfloat16)
            k = torch.randn((b, nkv, d), generator=gen, device=dev).to(torch.bfloat16)
            v = torch.randn((b, nkv, d), generator=gen, device=dev).to(torch.bfloat16)
            kvcache.store_cache_head_major(k, v, kh[lidx], vh[lidx], slots)
            out = paged_decode.paged_attention_decode(q, kh, vh, lengths, table, layer_id=lidx)
            n8 = paged_decode.paged_attention_decode.launches
            ref = paged_decode_dma.paged_attention_decode_dma(
                q, kh[lidx].transpose(0, 1).contiguous(), vh[lidx].transpose(0, 1).contiguous(), lengths, table)
            if paged_decode.paged_attention_decode.launches != n8 or not bool(torch.isfinite(out).all()):
                fail("paged_attention_decode path: K8 launched by the gate, or a non-finite output")
            worst = max(worst, float((out.float() - ref.float()).abs().max()))
            outs += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = skt.launch_counts()
    # K5's launches are the gate's, not the path's
    if counts["paged_attention_decode"] != steps * n_layers or counts["paged_attention_decode_dma"] != outs:
        fail(f"paged_attention_decode path: launches {counts}")
    if worst != 0.0:
        fail(f"paged_attention_decode path: K8 differs from K5 over the page-major transpose by {worst}")
    res = dict(layers=n_layers, batch=b, steps=steps, outputs=outs, max_diff_vs_k5_page_major=worst,
               wall_ms=1e3 * wall, launches={"paged_attention_decode": counts["paged_attention_decode"]})
    log("[path] paged_attention_decode over 32 head-major layers: " + json.dumps(res))
    del kh, vh
    free_memory(torch)
    return res


# ---------------------------------------------------------------------------
# Slice 8: K16-K19 and their op paths
# ---------------------------------------------------------------------------

# DeepSeek-V3's widths (hidden 7168, moe_intermediate 2048, 256 routed
# experts, top-8, one shared expert, 128 heads x 128 v_head_dim)
V3 = dict(hidden=7168, inter=2048, experts=256, topk=8, o_in=128 * 128)
# K16's cases: (label, S, NV, NS); Llama-3-8B's 32 heads of 128
VS_CASES = (("4k", 4096, 256, 8), ("32k", 32768, 1000, 64))
VS_VARLEN = (16384, 8192)  # the varlen path's two sequences
QSERVE_M = (16, 1024)


def once_ms(torch, fn):
    """(result, ms) of one call timed with CUDA events: the plain versions
    too slow to repeat (float32 products at prefill widths)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def e4m3_codes(torch, gen, *shape):
    """Uniform random e4m3 bytes, the two NaN codes (0x7f, 0xff) left out:
    values over e4m3's whole range, subnormals included."""
    u = torch.randint(0, 254, shape, generator=gen, device=DEVICE, dtype=torch.uint8)
    u.add_((u >= 0x7F).to(torch.uint8))
    return u.view(torch.float8_e4m3fn)


def fp8_library(torch, a, b):
    """torch._scaled_mm on the same e4m3 operands, B column-major (copied
    outside the timed call): with 1x128 / 128x128 block scales where this
    torch takes them on the card, else row-wise scales, the fp8 tensor-core
    yardstick at the same shape. Returns (fn, note)."""
    m, k = a.shape
    n = b.shape[1]
    bt = b.t().contiguous().t()
    dev = a.device
    notes = []
    for form, sa, sb in (("1x128 / 128x128 block scales", torch.ones((m, k // 128), device=dev),
                          torch.ones((k // 128, n // 128), device=dev)),
                         ("row-wise scales", torch.ones((m, 1), device=dev), torch.ones((1, n), device=dev))):
        fn = functools.partial(torch._scaled_mm, a, bt, scale_a=sa, scale_b=sb, out_dtype=torch.bfloat16)
        try:
            fn()
        except Exception as e:  # this torch refuses this scaling on the card
            notes.append(f"{form} refused: {str(e).splitlines()[0][:100]}")
            continue
        return fn, "; ".join(notes + [f"torch._scaled_mm with {form}"])
    return None, "; ".join(notes)


def phase_slice8_kernels(torch, skt):
    """Slice 8's kernels against their plain versions. K17 at DeepSeek-V3's
    dense fp8 GEMMs (shared-expert gate_up [M, 4096, 7168] and down [M, 7168,
    2048], o_proj [M, 7168, 16384]) at M=16 and 1,024, gate_up M=16 also on
    prepared scales; K18 over DeepSeek-V3's routed banks (256 experts, gate_up
    [256, 7168, 4096] and down [256, 2048, 7168] e4m3, 11.3 GB) at a B=16
    decode (top-8, bm 16) and a 1,024-token prefill (bm 128), gate_up and
    down each, rows aligned by moe_align_block_size (K17's and K18's rows
    with the TFLOP/s and GB/s of their device time and the library's
    TFLOP/s); K19 at Llama-3-8B's
    GEMMs (qkv, o, gate_up, down; group 128) at M=16 and 1,024 on the
    progressive-quant operands of tests/test_gemm.py:278-292; K16 at
    Llama-3-8B's attention widths (32 heads of 128, bf16, causal, bm 64, bn
    128) at S=4,096 (NV 256, NS 8) and S=32,768 (NV 1,000, NS 64), schedules
    from convert_vertical_slash_indexes on sorted random columns and
    distances, and at 4,096 with softcap 30 and the lse. Library yardsticks:
    torch._scaled_mm (K17), torch._scaled_grouped_mm (K18), torch._int_mm on
    the dequantized int8 weights (K19), SDPA causal over the same dense
    q / k / v (K16)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    rows = {}

    def report(name, row, dev_fn=None, work=None):
        rows[name] = report_row(torch, name, row, dev_fn, work)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 1e-2 + 1e-3

    for part in (kernels_k17, kernels_k18, kernels_k19, kernels_k16):
        part(torch, skt, gen, scales, report)
        free_memory(torch)
    return rows


def kernels_k17(torch, skt, gen, scales, report):
    from sgl_kernel_tpu_torch.ops.gemm import blockwise_fp8 as bw

    for m in (16, 1024):
        for label, n, k in (("gate_up", 2 * V3["inter"], V3["hidden"]), ("down", V3["hidden"], V3["inter"]),
                            ("o_proj", V3["hidden"], V3["o_in"])):
            a, b = e4m3_codes(torch, gen, m, k), e4m3_codes(torch, gen, k, n)
            sa, sb = scales(m, k // 128), scales(k // 128, n // 128)
            forms = [("", sb)]
            if (m, label) == (16, "gate_up"):
                forms.append(("_prepared", bw.prepare_blockwise_scales(sb)))
            lib_fn, lib_note = fp8_library(torch, a, b)
            for suffix, sbx in forms:
                fn = functools.partial(bw.fp8_blockwise_scaled_mm, a, b, sa, sbx)
                ref, plain = once_ms(torch, functools.partial(bw.fp8_blockwise_scaled_mm_ref, a, b, sa, sbx))
                err = check(f"fp8_blockwise_scaled_mm {label} [{m}, {n}, {k}]{suffix}", [(fn(), ref)])
                del ref
                n_bytes = m * k + k * n + 4 * (sa.numel() + sbx.numel()) + 2 * m * n
                bms, bby = bound_ms(n_bytes, 2 * m * n * k, FP8_FLOPS)
                report(f"fp8_blockwise_scaled_mm_{label}_m{m}{suffix}", dict(
                    max_abs_err=err, ms=time_ms(torch, fn), plain_ms=plain,
                    library_ms=None if lib_fn is None else time_ms(torch, lib_fn), library_note=lib_note,
                    bound_ms=bms, bound_by=bby), fn if m == 16 else None, (2 * m * n * k, n_bytes))
            del a, b, lib_fn


def kernels_k18(torch, skt, gen, scales, report):
    from sgl_kernel_tpu_torch.ops import moe
    from sgl_kernel_tpu_torch.ops.gemm import blockwise_fp8 as bw

    dev = torch.device(DEVICE)
    bf, f8 = torch.bfloat16, torch.float8_e4m3fn
    e, topk, h, inter = V3["experts"], V3["topk"], V3["hidden"], V3["inter"]
    w13, s13 = e4m3_codes(torch, gen, e, h, 2 * inter), scales(e, h // 128, 2 * inter // 128)
    w2, s2 = e4m3_codes(torch, gen, e, inter, h), scales(e, inter // 128, h // 128)
    col_major = {}  # the yardstick's column-major copy of each bank, made once
    for t, bm, label in ((16, 16, "decode"), (1024, 128, "prefill")):
        tw, tids = moe.topk_softmax(torch.randn((t, e), generator=gen, device=dev), topk)
        al = moe.moe_align_block_size(tids, tw, e, bm)
        cap, eids = al.token_ids.shape[0], al.block_expert_ids
        hit = int(torch.unique(eids).numel())
        x = moe.scatter_tokens_to_experts(e4m3_codes(torch, gen, t, h).view(torch.uint8), al).view(f8)
        xs = moe.scatter_tokens_to_experts(scales(t, h // 128), al)
        steps = [("gate_up", x, xs, w13, s13),
                 ("down", e4m3_codes(torch, gen, cap, inter), scales(cap, inter // 128), w2, s2)]
        for name, a, sa, w, sw in steps:
            k, n = a.shape[1], w.shape[-1]
            fn = functools.partial(bw.fp8_blockwise_scaled_grouped_mm, a, w, sa, sw, eids, bm=bm)
            ref, plain = once_ms(torch, functools.partial(bw.fp8_blockwise_scaled_grouped_mm_ref, a, w, sa, sw, eids,
                                                          bm=bm))
            err = check(f"fp8_blockwise_scaled_grouped_mm {label} {name} [cap {cap}, bm {bm}, {hit} experts]",
                        [(fn(), ref)])
            del ref
            lib_fn, lib_note = None, "this torch has no torch._scaled_grouped_mm"
            if hasattr(torch, "_scaled_grouped_mm"):
                if name not in col_major:
                    col_major[name] = w.transpose(-2, -1).contiguous().transpose(-2, -1)
                offs = torch.cumsum(al.padded_group_sizes, 0).to(torch.int32)
                lib_fn = functools.partial(torch._scaled_grouped_mm, a, col_major[name], torch.ones(cap, device=dev),
                                           torch.ones((e, n), device=dev), offs=offs, out_dtype=bf)
                try:
                    lib_fn()
                    lib_note = "torch._scaled_grouped_mm, row-wise scales, the valid rows"
                except Exception as ex:  # this torch refuses the call on the card
                    lib_fn, lib_note = None, f"torch._scaled_grouped_mm refused: {str(ex).splitlines()[0][:100]}"
            n_bytes = hit * (k * n + 4 * sw[0].numel()) + cap * (k + 4 * (k // 128) + 2 * n) + 4 * eids.numel()
            bms, bby = bound_ms(n_bytes, 2 * cap * n * k, FP8_FLOPS)
            report(f"fp8_blockwise_scaled_grouped_mm_{label}_{name}", dict(
                max_abs_err=err, ms=time_ms(torch, fn, iters=5 if label == "prefill" else 20), plain_ms=plain,
                library_ms=None if lib_fn is None else time_ms(torch, lib_fn, iters=5), library_note=lib_note,
                bound_ms=bms, bound_by=bby, experts_hit=hit, rows=cap), fn if label == "decode" else None,
                (2 * cap * n * k, n_bytes))


def kernels_k19(torch, skt, gen, scales, report):
    from sgl_kernel_tpu_torch.ops.gemm import qserve

    F = torch.nn.functional
    dev = torch.device(DEVICE)
    cfg = skt.LlamaConfig.llama3_8b()
    hd, g = cfg.hidden_size, 128
    gemms = (("qkv", (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim, hd), ("o", hd, cfg.num_heads * cfg.head_dim),
             ("gate_up", 2 * cfg.intermediate_size, hd), ("down", hd, cfg.intermediate_size))
    for label, n, k in gemms:
        codes, zs2, s2i, ws, w8 = qserve_weights(torch, gen, n, k, g)
        if not qserve.w8_int8_exact(codes, zs2, s2i, g):
            fail(f"qserve {label}: QServe-made W8 outside int8")
        w8_t = w8.t()
        for m in QSERVE_M:
            aq = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
            as_ = (torch.rand(m, generator=gen, device=dev) * 0.01 + 1e-3).half()
            args = (aq, codes, zs2, s2i, ws, as_)
            fn = functools.partial(qserve.qserve_w4a8_per_group_gemm, *args)
            ref, plain = once_ms(torch, functools.partial(qserve.qserve_w4a8_per_group_gemm_ref, *args))
            before = qserve.exact_route_blocks(aq.device)
            err = check(f"qserve_w4a8_per_group_gemm {label} [{m}, {n}, {k}]", [(fn(), ref)])
            exact = qserve.exact_route_blocks(aq.device) - before
            if exact:
                fail(f"qserve_w4a8_per_group_gemm {label} [{m}, {n}, {k}]: {exact} blocks took the exact route "
                     "on QServe-made weights")
            del ref
            a_lib = F.pad(aq, (0, 0, 0, max(0, 17 - m)))  # torch._int_mm wants more than 16 rows
            lib_fn = functools.partial(torch._int_mm, a_lib, w8_t)
            n_bytes = m * k + n * k + n * (k // g) * (1 + 4) + 2 * (m + n) + 2 * m * n
            bms, bby = bound_ms(n_bytes, 2 * m * n * k, INT8_OPS)
            report(f"qserve_w4a8_per_group_gemm_{label}_m{m}", dict(
                max_abs_err=err, ms=time_ms(torch, fn), plain_ms=plain, library_ms=time_ms(torch, lib_fn),
                library_note=f"torch._int_mm on the int8 W8 (A padded to {a_lib.shape[0]} rows)", bound_ms=bms,
                bound_by=bby, exact_route_blocks=exact, w8_route="exact" if exact else "int8"), fn,
                (2 * m * n * k, n_bytes))
        del codes, w8, w8_t


def kernels_k16(torch, skt, gen, scales, report):
    import numpy as np

    from sgl_kernel_tpu_torch.ops.attention import sparse_vs

    F = torch.nn.functional
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    cfg = skt.LlamaConfig.llama3_8b()
    nh, d = cfg.num_heads, cfg.head_dim
    rng = np.random.default_rng(SEED)
    for label, s, nv, ns in VS_CASES:
        q, k, v = (torch.randn((1, s, nh, d), generator=gen, device=dev).to(bf) for _ in range(3))
        vert = np.sort(np.stack([rng.choice(s, nv, replace=False) for _ in range(nh)]), -1)[None]
        slash = np.sort(np.stack([rng.choice(s, ns, replace=False) for _ in range(nh)]), -1)[None, :, ::-1]
        slash = np.ascontiguousarray(slash)
        t0 = time.perf_counter()
        sched = sparse_vs.convert_vertical_slash_indexes([s], [s], vert, slash, s, 64, 128)
        conv_s = time.perf_counter() - t0
        pairs = vs_pairs(sched, s, 64, 128)
        sched_t = [torch.from_numpy(x).to(dev) for x in sched]
        variants = [("", {})] + ([("_softcap_lse", dict(softcap=30.0, return_lse=True))] if label == "4k" else [])
        for suffix, kw in variants:
            fn = functools.partial(sparse_vs.sparse_attn_func, q, k, v, *sched_t, **kw)
            ref, plain = once_ms(torch, functools.partial(sparse_vs.sparse_attn_func_ref, q, k, v, *sched_t, **kw))
            out = fn()
            name = f"sparse_attn_func S={s} NV={nv} NS={ns}{suffix} [{nh} heads of {d}]"
            if kw.get("return_lse"):
                err = max(check(name, [(out[0], ref[0])]), check_lse(name, out[1], ref[1]))
            else:
                err = check(name, [(out, ref)])
            del ref, out
            n_bytes = 2 * s * nh * d * 2 * 2 + sum(x.nbytes for x in sched) + (4 * nh * s if kw else 0)
            bms, bby = bound_ms(n_bytes, 4 * d * pairs, BF16_FLOPS)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_fn = functools.partial(F.scaled_dot_product_attention, qt, kt, vt, is_causal=True)
            ms, lib_ms = time_ms(torch, fn, iters=5), time_ms(torch, lib_fn, iters=5)
            dense = nh * s * (s + 1) // 2
            report(f"sparse_attn_func_{label}{suffix}", dict(
                max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib_ms,
                library_note="SDPA causal over the same dense q / k / v: the attention it thins", bound_ms=bms,
                bound_by=bby, schedule_s=conv_s, visible_pairs=pairs, dense_pairs=dense,
                tflops=4 * d * pairs / ms / 1e9, library_tflops=4 * d * dense / lib_ms / 1e9))
        del q, k, v, sched_t


def qserve_weights(torch, gen, n, k, g):
    """One random [N, K] weight quantized as QServe does
    (``qserve.qserve_quantize``: int8 per channel, |q| <= 119, then 4-bit
    groups of ``g`` with an integer scale s2 and zero z). Returns (codes
    uint8, zeros_x_s2 float32, s2 int8, per-channel scales f16, the int8 W8
    = code * s2 - zs2)."""
    from sgl_kernel_tpu_torch.ops.gemm import qserve

    codes, zs2, s2, chn = qserve.qserve_quantize(torch.randn((n, k), generator=gen, device=DEVICE) * 0.01, g)
    w8 = qserve.dequant_w8(codes, zs2, s2, g).to(torch.int8)
    return codes, zs2, s2, chn.half(), w8


def vs_pairs(sched, s, bm, bn):
    """(query, key) pairs K16's schedule asks for, counted per row: each
    counted column c visible to the rows r >= c of its row block, each slash
    block's keys k < S visible to the rows r >= k (causal). Duplicates count,
    as the kernel computes them."""
    import numpy as np

    bc, bo, cc, ci = sched
    _, _, r, nv = ci.shape
    row0 = (np.arange(r) * bm)[None, None, :, None]
    row_end = np.minimum(row0 + bm, s)
    live = np.arange(nv)[None, None, None, :] < cc[..., None]
    cols = np.where(live, np.maximum(0, row_end - np.maximum(ci, row0)), 0).sum()
    ns = bo.shape[-1]
    slot = np.arange(ns)[None, None, None, :] < bc[..., None]
    blocks = 0
    for i in range(bm):  # row row0 + i sees keys o .. min(o + bn, S, row + 1) - 1
        row = row0 + i
        seen = np.clip(np.minimum(np.minimum(bo + bn, s), row + 1) - bo, 0, bn)
        blocks += np.where(slot & (row < s), seen, 0).sum()
    return int(cols + blocks)


def path_sparse_attn_varlen(torch, skt):
    """K16's path: no model calls it, in the JAX package either; its entry
    points are the ops. Driven as a user calls them: two prompts of 16,384
    and 8,192 tokens at Llama-3-8B's widths (32 query heads over 8 kv heads
    of 128), the index sets estimated by build_vertical_slash_indexes from
    each prompt's last 64 queries (NV 1,000, NS 64), the schedule from
    convert_vertical_slash_indexes (bm 64, bn 64), then
    sparse_attn_varlen_func (causal). Counts set to 0 just before and read
    just after: K16 launches once. Gate: the second prompt's rows, and the
    first 4,096 of the first prompt's, against the plain version on their own
    schedule."""
    import numpy as np

    from sgl_kernel_tpu_torch.ops.attention import sparse_vs

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    cfg = skt.LlamaConfig.llama3_8b()
    nh, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lens = list(VS_VARLEN)
    nv, ns = min(1000, min(lens)), min(64, min(lens))
    total = sum(lens)
    q = torch.randn((total, nh, d), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((total, nkv, d), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((total, nkv, d), generator=gen, device=dev).to(torch.bfloat16)
    cu = np.concatenate([[0], np.cumsum(lens)])
    torch.cuda.synchronize()
    skt.reset_launch_counts()
    t0 = time.perf_counter()
    verts, slashes = [], []
    for i in range(len(lens)):  # the estimator scores each prompt's last 64 queries (kv heads repeated)
        qs, ks = q[cu[i]: cu[i + 1]][None], k[cu[i]: cu[i + 1]][None].repeat_interleave(nh // nkv, dim=2)
        vi, si = sparse_vs.build_vertical_slash_indexes(qs, ks, nv, ns)
        verts.append(torch.sort(vi, -1).values.cpu().numpy())
        slashes.append(torch.sort(si, -1, descending=True).values.cpu().numpy())
    vert, slash = np.stack(verts), np.stack(slashes)
    sched = sparse_vs.convert_vertical_slash_indexes(lens, lens, vert, slash, max(lens), 64, 64)
    out, lse = sparse_vs.sparse_attn_varlen_func(q, k, v, *sched, cu, cu, max(lens), max(lens), causal=True,
                                                 return_softmax_lse=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = skt.launch_counts()
    if counts["sparse_attn_func"] != 1 or out.shape != (total, nh, d) or lse.shape != (nh, total):
        fail(f"sparse_attn_varlen_func path: launches {counts}, out {tuple(out.shape)}, lse {tuple(lse.shape)}")
    if not bool(torch.isfinite(out.float()).all()):
        fail("sparse_attn_varlen_func path: non-finite output")
    # the gate: prompt 2 whole, and prompt 1's first 4,096 rows (causal: they
    # see only its first 4,096 keys), each through the plain version on its
    # rows of the schedule
    err = 0.0
    for i, n in ((1, lens[1]), (0, min(lens[0], 4096))):
        rows = -(-n // 64)
        one = [torch.from_numpy(np.ascontiguousarray(x[i: i + 1, :, :rows])).to(dev) for x in sched]
        sl = slice(int(cu[i]), int(cu[i]) + n)
        ref, ref_lse = sparse_vs.sparse_attn_func_ref(q[sl][None], k[sl][None], v[sl][None], *one,
                                                      block_size_N=64, return_lse=True)
        name = f"sparse_attn_varlen_func path, prompt {i + 1} rows 0..{n} against the plain version"
        err = max(err, check(name, [(out[sl], ref[0])]), check_lse(name, lse[:, sl], ref_lse[0]))
        del ref, ref_lse
    # K16's device ms in the path: one more call (after the counts were read)
    # with events around its sparse_attn_func call
    k16_ms, k16_n = inner_call_ms(torch, sparse_vs, "sparse_attn_func", lambda: sparse_vs.sparse_attn_varlen_func(
        q, k, v, *sched, cu, cu, max(lens), max(lens), causal=True, return_softmax_lse=True))
    if k16_n != 1:
        fail(f"sparse_attn_varlen_func path: {k16_n} calls of sparse_attn_func, not 1")
    res = dict(prompts=lens, heads=[nh, nkv], nv=nv, ns=ns, max_abs_err=err, wall_ms=1e3 * wall,
               k16_device_ms=k16_ms, blocks=int(sched[0].sum()), columns=int(sched[2].sum()),
               launches={"sparse_attn_func": counts["sparse_attn_func"]})
    log("[path] sparse_attn_varlen_func: " + json.dumps(res))
    del q, k, v, out
    free_memory(torch)
    return res


def per_block_fp8(torch, x):
    """bf16 rows [T, K] -> (e4m3 [T, K], scales [T, K/128]): DeepSeek-V3's
    1x128 activation quantization (amax / 448 a block)."""
    t, k = x.shape
    xb = x.float().reshape(t, k // 128, 128)
    s = torch.clamp_min(xb.abs().amax(-1) / 448.0, 1e-12)
    return (xb / s[..., None]).clamp(-448, 448).reshape(t, k).to(torch.float8_e4m3fn), s


def path_blockwise_fp8(torch, skt, layers=4):
    """K17's and K18's path: no model calls them, in the JAX package either;
    their entry points are the ops. Driven as a user calls them, a
    DeepSeek-V3 fp8 MoE layer's GEMMs at a B=16 decode, ``layers`` times
    over one set of weights: o_proj [16384 -> 7168] (K17), the shared
    expert's gate_up and down (K17), the routed experts' gate_up and down
    over 256 experts, top-8, bm 16 (K18), activations quantized 1x128
    between them. Counts set to 0 just before and read just after: K17
    three and K18 two launches a layer. Gate: the first layer's routed
    output against the plain versions."""
    from sgl_kernel_tpu_torch.ops import moe
    from sgl_kernel_tpu_torch.ops.activation import silu_and_mul
    from sgl_kernel_tpu_torch.ops.gemm import blockwise_fp8 as bw

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    e, topk, h, inter, o_in = V3["experts"], V3["topk"], V3["hidden"], V3["inter"], V3["o_in"]
    t, bm = 16, 16

    def scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 2e-3 + 1e-4

    w_o, s_o = e4m3_codes(torch, gen, o_in, h), scales(o_in // 128, h // 128)
    w_sgu, s_sgu = e4m3_codes(torch, gen, h, 2 * inter), scales(h // 128, 2 * inter // 128)
    w_sd, s_sd = e4m3_codes(torch, gen, inter, h), scales(inter // 128, h // 128)
    w13, s13 = e4m3_codes(torch, gen, e, h, 2 * inter), scales(e, h // 128, 2 * inter // 128)
    w2, s2 = e4m3_codes(torch, gen, e, inter, h), scales(e, inter // 128, h // 128)
    attn = torch.randn((layers, t, o_in), generator=gen, device=dev).to(torch.bfloat16)
    logits = torch.randn((layers, t, e), generator=gen, device=dev)
    torch.cuda.synchronize()
    skt.reset_launch_counts()
    t0 = time.perf_counter()
    outs, first = [], None
    for lidx in range(layers):
        a, sa = per_block_fp8(torch, attn[lidx])
        hidden = bw.fp8_blockwise_scaled_mm(a, w_o, sa, s_o)
        x, sx = per_block_fp8(torch, hidden)
        shared = silu_and_mul(bw.fp8_blockwise_scaled_mm(x, w_sgu, sx, s_sgu))
        ys, sys_ = per_block_fp8(torch, shared)
        shared = bw.fp8_blockwise_scaled_mm(ys, w_sd, sys_, s_sd)
        tw, tids = moe.topk_softmax(logits[lidx], topk, renormalize=True)
        al = moe.moe_align_block_size(tids, tw, e, bm)
        xr = moe.scatter_tokens_to_experts(x.view(torch.uint8), al).view(torch.float8_e4m3fn)
        sr = moe.scatter_tokens_to_experts(sx, al)
        gu = bw.fp8_blockwise_scaled_grouped_mm(xr, w13, sr, s13, al.block_expert_ids, bm=bm)
        y, sy = per_block_fp8(torch, silu_and_mul(gu))
        down = bw.fp8_blockwise_scaled_grouped_mm(y, w2, sy, s2, al.block_expert_ids, bm=bm)
        outs.append(moe.apply_shuffle_mul_sum(down, al, t) + shared)
        if lidx == 0:
            first = (xr, sr, y, sy, al.block_expert_ids, gu, down)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = skt.launch_counts()
    if counts["fp8_blockwise_scaled_mm"] != 3 * layers or counts["fp8_blockwise_scaled_grouped_mm"] != 2 * layers:
        fail(f"blockwise fp8 path: launches {counts}")
    if not all(bool(torch.isfinite(o.float()).all()) for o in outs):
        fail("blockwise fp8 path: non-finite output")
    xr, sr, y, sy, eids, gu, down = first
    err = check("blockwise fp8 path, layer 0's routed gate_up and down against the plain version",
                [(gu, bw.fp8_blockwise_scaled_grouped_mm_ref(xr, w13, sr, s13, eids, bm=bm)),
                 (down, bw.fp8_blockwise_scaled_grouped_mm_ref(y, w2, sy, s2, eids, bm=bm))])
    res = dict(layers=layers, batch=t, max_abs_err=err, wall_ms=1e3 * wall,
               launches={n: counts[n] for n in ("fp8_blockwise_scaled_mm", "fp8_blockwise_scaled_grouped_mm")})
    log("[path] blockwise fp8 DeepSeek-V3 MoE layer: " + json.dumps(res))
    del w_o, w_sgu, w_sd, w13, w2, first
    free_memory(torch)
    return res


def quant_rows_int8(torch, x):
    """Per-token int8: (A_q [M, K], scales [M] f16, per-token sums of x)."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(-1) / 127.0, 1e-8)
    return torch.clamp(torch.round(xf / s[:, None]), -128, 127).to(torch.int8), s.half(), xf.sum(-1)


def path_qserve(torch, skt, layers=8):
    """K19's path: no model calls the QServe GEMMs, in the JAX package either;
    their entry points are the ops. Driven as a user calls them, a W4A8
    Llama-3-8B decode (M=16) through ``layers`` layers' linear layers on
    their own weights (qkv, o, gate_up, down: per-group, group 128;
    activations quantized per token between them), and the per-channel
    GEMM (qserve_w4a8_per_chn_gemm) on each layer's gate_up codes. Counts
    set to 0 just before and read just after: K19 four launches a layer.
    Gate: layer 0's gate_up against the plain version."""
    from sgl_kernel_tpu_torch.ops.activation import silu_and_mul
    from sgl_kernel_tpu_torch.ops.gemm import qserve

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    cfg = skt.LlamaConfig.llama3_8b()
    hd, g, m = cfg.hidden_size, 128, 16
    dims = dict(qkv=((cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim, hd), o=(hd, cfg.num_heads * cfg.head_dim),
                gate_up=(2 * cfg.intermediate_size, hd), down=(hd, cfg.intermediate_size))
    weights = [{name: qserve_weights(torch, gen, n, k, g)[:4] for name, (n, k) in dims.items()}
               for _ in range(layers)]
    x = torch.randn((m, hd), generator=gen, device=dev).to(torch.bfloat16)
    exact0 = qserve.exact_route_blocks(x.device)
    torch.cuda.synchronize()
    skt.reset_launch_counts()
    t0 = time.perf_counter()
    gate = None
    for lidx, lw in enumerate(weights):
        def linear(name, inp):
            aq, asc, _ = quant_rows_int8(torch, inp)
            return qserve.qserve_w4a8_per_group_gemm(aq, *lw[name], asc, out_dtype=torch.bfloat16), aq, asc

        qkv, _, _ = linear("qkv", x)
        attn = qkv[:, : cfg.num_heads * cfg.head_dim]  # attention itself is not this path's
        o, _, _ = linear("o", attn)
        hid = x + o
        gu, aq, asc = linear("gate_up", hid)
        codes, zs2, s2, ws = lw["gate_up"]
        per_chn = qserve.qserve_w4a8_per_chn_gemm(aq, codes, ws, asc, ws.float() * 8.0, quant_rows_int8(torch, hid)[2],
                                                  out_dtype=torch.bfloat16)
        down, _, _ = linear("down", silu_and_mul(gu))
        x = hid + down
        if lidx == 0:
            gate = (aq, asc, gu, per_chn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = skt.launch_counts()
    if counts["qserve_w4a8_per_group_gemm"] != 4 * layers:
        fail(f"qserve path: launches {counts}")
    exact = qserve.exact_route_blocks(x.device) - exact0
    if exact:
        fail(f"qserve path: {exact} blocks took the exact route on QServe-made weights")
    if not bool(torch.isfinite(x.float()).all()) or not bool(torch.isfinite(gate[3].float()).all()):
        fail("qserve path: non-finite output")
    aq, asc, gu, _ = gate
    err = check("qserve path, layer 0's gate_up against the plain version",
                [(gu, qserve.qserve_w4a8_per_group_gemm_ref(aq, *weights[0]["gate_up"], asc,
                                                            out_dtype=torch.bfloat16))])
    res = dict(layers=layers, batch=m, max_abs_err=err, wall_ms=1e3 * wall, exact_route_blocks=exact,
               launches={"qserve_w4a8_per_group_gemm": counts["qserve_w4a8_per_group_gemm"]})
    log("[path] QServe W4A8 Llama-3-8B layers: " + json.dumps(res))
    del weights
    free_memory(torch)
    return res


def path_w4a8_grouped(torch, skt, layers=4):
    """w4a8_grouped_mm's path (K11 underneath; no model calls it, in JAX
    either): DeepSeek-V3's routed gate_up widths (256 experts, packed int4
    [256, 3584, 4096], per-channel scales and zeros), a B=16 decode, top-8,
    bm 16, ``layers`` times over one bank. Counts set to 0 just before and
    read just after: K11 once a layer. Gate: the first 4 valid blocks'
    rows against the dequantized weights in float32."""
    from sgl_kernel_tpu_torch.ops import moe
    from sgl_kernel_tpu_torch.ops.gemm.w4a16 import unpack_w4_tpu

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    e, topk, k, n, t, bm = V3["experts"], V3["topk"], V3["hidden"], 2 * V3["inter"], 16, 16
    w = torch.randint(0, 256, (e, k // 2, n), generator=gen, device=dev, dtype=torch.uint8)
    s1 = torch.rand((e, n), generator=gen, device=dev) * 0.02 + 0.01
    zs = torch.rand((e, n), generator=gen, device=dev) * 0.05
    torch.cuda.synchronize()
    skt.reset_launch_counts()
    t0 = time.perf_counter()
    outs = []
    for _ in range(layers):
        tw, tids = moe.topk_softmax(torch.randn((t, e), generator=gen, device=dev), topk, renormalize=True)
        al = moe.moe_align_block_size(tids, tw, e, bm)
        xq, xs, _ = quant_rows_int8(torch, torch.randn((t, k), generator=gen, device=dev))
        x = moe.scatter_tokens_to_experts(xq, al)
        x_scales = moe.scatter_tokens_to_experts(xs.float()[:, None], al)[:, 0]
        out = moe.w4a8_grouped_mm(x, x_scales, w, s1, al.block_expert_ids, zs, bm=bm, out_dtype=torch.float32)
        outs.append((out, x, x_scales, al))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = skt.launch_counts()
    if counts["w4a16_grouped_mm"] != layers:
        fail(f"w4a8_grouped_mm path: launches {counts}")
    out, x, x_scales, al = outs[0]
    if not bool(torch.isfinite(out).all()):
        fail("w4a8_grouped_mm path: non-finite output")
    pairs = []
    for blk in range(4):
        ex = int(al.block_expert_ids[blk])
        rows = slice(blk * bm, (blk + 1) * bm)
        codes = unpack_w4_tpu(w[ex]).float()  # [K, N] nibbles, two's complement
        codes = torch.where(codes > 7, codes - 16, codes)
        xf = x[rows].float()
        ref = ((xf @ codes) * s1[ex] - xf.sum(-1, keepdim=True) * zs[ex]) * x_scales[rows, None]
        pairs.append((out[rows], ref))
    err = check("w4a8_grouped_mm path, 4 valid blocks against the dequantized weights", pairs)
    res = dict(layers=layers, batch=t, max_abs_err=err, wall_ms=1e3 * wall,
               launches={"w4a16_grouped_mm": counts["w4a16_grouped_mm"]})
    log("[path] w4a8_grouped_mm on K11: " + json.dumps(res))
    del w, outs
    free_memory(torch)
    return res


def main():
    import faulthandler

    faulthandler.enable()  # a crash in native code prints the Python stack
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on the card")
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    try:
        import sgl_kernel_tpu_torch as skt
        from sgl_kernel_tpu_torch import _build
    except ImportError as e:
        fail(f"the sgl_kernel_tpu_torch package is not beside this script: {e}")
    if Path(skt.__file__).resolve().parent.parent != here:
        fail(f"sgl_kernel_tpu_torch imported from {skt.__file__}, not from {here}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")

    from sgl_kernel_tpu_torch.serving import native

    times = {}

    @contextlib.contextmanager
    def phase(name):
        t0 = time.perf_counter()
        yield
        times[name] = time.perf_counter() - t0
        log(f"[time] {name}: {times[name]:.1f} s")

    with phase("1 build"):
        _, card = phase_build(_build, native)
    with phase("2 kernels"):
        rows = phase_kernels(torch, skt)
        torch.cuda.empty_cache()
        rows.update(phase_w4a16(torch, skt))
        torch.cuda.empty_cache()
        rows.update(phase_deepseek_kernels(torch, skt))
        torch.cuda.empty_cache()
        rows.update(phase_mixtral_w4_kernels(torch, skt))
        torch.cuda.empty_cache()
        rows.update(phase_moe_bf16_kernels(torch, skt))
        torch.cuda.empty_cache()
        rows.update(phase_nsa_kernels(torch, skt))
        torch.cuda.empty_cache()
        rows.update(phase_decode_variants(torch, skt))
        free_memory(torch)
        rows.update(phase_slice8_kernels(torch, skt))
        floor = launch_floor_ms(torch)
        log(f"[kernel] launch floor (an empty kernel's CUDA-graph node): {floor:.4f} ms")
    bf16_cfg = skt.LlamaConfig.llama3_8b(fused=True)
    w4_cfg = skt.LlamaConfig.llama3_8b(quant="w4a16", fused=True)
    dma_cfg = dataclasses.replace(w4_cfg, gemm_impl="dma")
    with phase("3 parity llama"):
        parity = {label: phase_parity(torch, skt, c, label) for label, c in (("bf16", bf16_cfg), ("w4a16", w4_cfg))}
        # the fused=False layout (K2, separate q/k/v linears, K4) at decode
        parity["bf16-unfused"] = phase_parity(torch, skt, skt.LlamaConfig.llama3_8b(), "bf16-unfused",
                                              programs=("prefill", "decode"))
        # gemm_impl="dma": K10 at every GEMM of M <= 32 rows
        parity["w4a16-dma"] = phase_parity(torch, skt, dma_cfg, "w4a16-dma", programs=("prefill", "decode"))
    serve = {}
    with phase("4-5 serve llama bf16"):
        serve["bf16"], eng, lens = phase_serve(torch, skt, bf16_cfg, "bf16", LLAMA_BF16)
        profile = {"bf16": phase_profile(torch, eng, lens, "bf16", groups=GEMM_GROUPS)}
        del eng
        free_memory(torch)
    with phase("4-5 serve llama w4a16"):
        serve["w4a16"], eng, lens = phase_serve(torch, skt, w4_cfg, "w4a16", LLAMA_W4)
        profile["w4a16 prefill"] = phase_prefill_profile(torch, eng, lens, "w4a16")
        profile["w4a16"] = phase_profile(torch, eng, lens, "w4a16", groups=GEMM_GROUPS)
        params = eng.params
        del eng
        free_memory(torch)
    with phase("4 serve llama w4a16-int8kv"):
        # the same W4A16 weights over int8 KV pools (bench.py:121's kv_scale)
        int8_cfg = dataclasses.replace(w4_cfg, kv_dtype=torch.int8, kv_scale=1 / 16)
        serve["w4a16-int8kv"], eng, _ = phase_serve(torch, skt, int8_cfg, "w4a16-int8kv", LLAMA_W4, n_a=4, n_b=4,
                                                       wave_c=False, params=params, cold=False)
        if eng.caches[0].dtype != torch.int8:
            fail(f"serve w4a16-int8kv: pools are {eng.caches[0].dtype}")
        profile["w4a16-int8kv"] = phase_profile(torch, eng, serve_lens(16), "w4a16-int8kv", groups=GEMM_GROUPS)
        del eng
        free_memory(torch)
    with phase("4-5 serve llama w4a16-dma"):
        # the same W4A16 weights with gemm_impl="dma": K10 decodes
        serve["w4a16-dma"], eng, lens = phase_serve(torch, skt, dma_cfg, "w4a16-dma", LLAMA_W4_DMA, params=params)
        profile["w4a16-dma"] = phase_profile(torch, eng, lens, "w4a16-dma", groups=GEMM_GROUPS)
        for wave, (dw, pw) in enumerate(zip(serve["w4a16-dma"]["waves"], serve["w4a16"]["waves"])):
            log(f"[serve] decode ms/step wave {'A' if wave == 0 else 'B+C'}: w4a16-dma {dw['decode_ms_step']:.2f} "
                f"against w4a16 (pipeline) {pw['decode_ms_step']:.2f}")
        dma, pipe = profile["w4a16-dma"], profile["w4a16"]
        log(f"[profile] decode step: w4a16-dma {dma['graph']['step_ms']:.2f} ms graphed, {dma['eager']['step_ms']:.2f} "
            f"eager, {dma['eager']['kernel_launches_per_step']:.0f} launches, GEMMs {dma['eager']['group_ms_per_step']} "
            f"against w4a16 {pipe['graph']['step_ms']:.2f} ms graphed, {pipe['eager']['step_ms']:.2f} eager, "
            f"{pipe['eager']['kernel_launches_per_step']:.0f} launches, {pipe['eager']['group_ms_per_step']}")
        del eng
        free_memory(torch)
    with phase("burst llama w4a16"):
        burst = {"w4a16": phase_burst(torch, skt, w4_cfg, "w4a16", params)}
        del params
        free_memory(torch)

    # the DeepSeek path: V2-Lite widths, W4A16, int8 latent (bench.py's
    # DeepSeek headline configuration), at full depth; then bf16 weights
    ds_cfg = v2_lite_cfg(torch, skt, kv_dtype=torch.int8, kv_scale=1 / 16)
    ds_bf16_cfg = v2_lite_cfg(torch, skt, quant=None)
    mx_w4_cfg = skt.MixtralConfig.mixtral_8x7b(quant="w4a16")
    mx_bf16_cfg = skt.MixtralConfig.mixtral_8x7b()
    for label, c, fn in (("deepseek W4A16 + int8 latent", ds_cfg, deepseek_step_bytes),
                         ("deepseek bf16", ds_bf16_cfg, deepseek_step_bytes),
                         ("mixtral-8x7b W4A16", mx_w4_cfg, mixtral_step_bytes)):
        w_bytes, pool_bytes, hit = fn(c)
        log(f"[bound] {label} decode step, B=16: {w_bytes / 1e9:.4f} GB of weights ({hit:.2f} experts hit per MoE "
            f"layer) -> {1e3 * w_bytes / HBM_BYTES_PER_S:.4f} ms at 3.35 TB/s; KV rows at a 1,024-token context "
            f"{pool_bytes / 1e9:.4f} GB more")
    with phase("3 parity deepseek"):
        parity.update({f"deepseek-{lab}": phase_parity_deepseek(torch, skt, c, lab)
                       for lab, c in (("bf16-latent", v2_lite_cfg(torch, skt)), ("int8-latent", ds_cfg),
                                      ("bf16", ds_bf16_cfg))})
    with phase("4-5 serve deepseek w4a16-int8"):
        serve["deepseek-w4a16-int8"], eng, lens = phase_serve(torch, skt, ds_cfg, "deepseek-w4a16-int8", DEEPSEEK_W4,
                                                              mixed=False)
        if eng.caches[0].dtype != torch.int8:
            fail(f"serve deepseek: the latent pool is {eng.caches[0].dtype}")
        profile["deepseek-w4a16-int8 prefill"] = phase_prefill_profile(torch, eng, lens, "deepseek-w4a16-int8")
        profile["deepseek-w4a16-int8"] = phase_profile(torch, eng, lens, "deepseek-w4a16-int8",
                                                       groups={**GEMM_GROUPS, **MLA_GROUPS})
        params = eng.params
        del eng
        free_memory(torch)
    with phase("burst deepseek w4a16-int8"):
        burst["deepseek-w4a16-int8"] = phase_burst(torch, skt, ds_cfg, "deepseek-w4a16-int8", params)
        del params
        free_memory(torch)

    # the Mixtral path (K4, K11 and K12 at Mixtral-8x7B's widths) and the
    # bf16 DeepSeek-V2-Lite engine (K12 stacked)
    with phase("3 parity mixtral"):
        parity.update({f"mixtral-{lab}": phase_parity(torch, skt, c, f"mixtral-{lab}",
                                                      programs=("prefill", "decode", "packed", "extend"), n_decode=2)
                       for lab, c in (("bf16", mx_bf16_cfg), ("w4a16", mx_w4_cfg))})
    with phase("4-5 serve mixtral w4a16"):
        serve["mixtral-w4a16"], eng, lens = phase_serve(torch, skt, mx_w4_cfg, "mixtral-w4a16", MIXTRAL_W4,
                                                        mixed=False)
        profile["mixtral-w4a16 prefill"] = phase_prefill_profile(torch, eng, lens, "mixtral-w4a16")
        profile["mixtral-w4a16"] = phase_profile(torch, eng, lens, "mixtral-w4a16", groups=GEMM_GROUPS)
        del eng
        free_memory(torch)
    with phase("4-5 serve deepseek bf16"):
        serve["deepseek-bf16"], eng, lens = phase_serve(torch, skt, ds_bf16_cfg, "deepseek-bf16", DEEPSEEK_BF16,
                                                        mixed=False)
        profile["deepseek-bf16"] = phase_profile(torch, eng, lens, "deepseek-bf16", groups=MLA_GROUPS)
        del eng
        free_memory(torch)
    # the NSA path: V2-Lite widths, W4A16, int8 latent, the indexer at
    # DeepSeek-V3.2-Exp's widths; then K13b's path (its op entry point)
    ds_nsa_cfg = nsa_cfg(torch, skt, kv_dtype=torch.int8, kv_scale=1 / 16)
    w_bytes, _, hit = deepseek_step_bytes(ds_nsa_cfg)
    log(f"[bound] deepseek NSA W4A16 + int8 latent decode step, B=16: {w_bytes / 1e9:.4f} GB of weights "
        f"({hit:.2f} experts hit per MoE layer) -> {1e3 * w_bytes / HBM_BYTES_PER_S:.4f} ms at 3.35 TB/s")
    with phase("3 parity deepseek nsa"):
        parity["deepseek-nsa"] = phase_parity_nsa(torch, skt, ds_nsa_cfg, "w4a16-int8")
    with phase("4-5 serve deepseek nsa"):
        # 1,664 pages: the profile's 16 prompts of NSA_PROMPT tokens need 1,552
        serve["deepseek-nsa"], eng, _ = phase_serve(
            torch, skt, ds_nsa_cfg, "deepseek-nsa", DEEPSEEK_NSA, mixed=False, num_pages=1664,
            after=lambda eng, stats, res: wave_d(torch, skt, eng, stats, res, "deepseek-nsa"))
        profile["deepseek-nsa"] = phase_profile(torch, eng, [NSA_PROMPT] * 16, "deepseek-nsa", top=24,
                                                groups={**GEMM_GROUPS, **MLA_GROUPS})
        del eng
        free_memory(torch)
    for eng_label in ("deepseek-w4a16-int8", "deepseek-bf16", "deepseek-nsa"):
        pr = profile[eng_label]["eager"]
        log(f"[profile] {eng_label} decode step: K13a / K15 device ms {json.dumps(pr['group_ms_per_step'])}, "
            f"launches {json.dumps(pr['group_launches_per_step'])}")
    with phase("4 path mla_decode dma"):
        paths = {"mla_decode_dma": path_mla_decode_dma(torch, skt)}
    with phase("4 path paged_attention_decode head-major"):
        paths["paged_attention_decode"] = path_head_major_decode(torch, skt)
    with phase("4 serve mixtral bf16 8 layers"):
        # 8 of 32 layers: the full bf16 model (93.4 GB) does not fit in 80 GB
        serve["mixtral-bf16-8l"], eng, _ = phase_serve(
            torch, skt, dataclasses.replace(mx_bf16_cfg, num_layers=8), "mixtral-bf16-8l", MIXTRAL_BF16, n_a=4,
            n_b=4, wave_c=False, cold=False, mixed=False)
        profile["mixtral-bf16-8l"] = phase_profile(torch, eng, serve_lens(16), "mixtral-bf16-8l")
        del eng
        free_memory(torch)
    # slice 8's paths: the ops a user calls (no model calls them, in JAX either)
    with phase("4 path sparse_attn_varlen_func"):
        paths["sparse_attn_varlen_func"] = path_sparse_attn_varlen(torch, skt)
    with phase("4 path blockwise fp8"):
        paths["fp8_blockwise"] = path_blockwise_fp8(torch, skt)
    with phase("4 path qserve"):
        paths["qserve"] = path_qserve(torch, skt)
    with phase("4 path w4a8_grouped_mm"):
        paths["w4a8_grouped_mm"] = path_w4a8_grouped(torch, skt)

    meta = {
        "w4a16_gemm": ("cuda", "sgl_kernel_tpu_torch/csrc/w4a16_decode.cu", "sgl_kernel_tpu/ops/gemm/w4a16.py:301",
                       "w4a16_gemm_gate_up"),
        "rmsnorm": ("triton", "sgl_kernel_tpu_torch/ops/norm.py", "sgl_kernel_tpu/ops/norm.py:40", "rmsnorm_16"),
        "rope_decode_fused_qkv": ("triton", "sgl_kernel_tpu_torch/ops/rope.py", "sgl_kernel_tpu/ops/rope.py:228",
                                  "rope_decode_fused_qkv"),
        "rope_decode_fused": ("triton", "sgl_kernel_tpu_torch/ops/rope.py", "sgl_kernel_tpu/ops/rope.py:360",
                              "rope_decode_fused"),
        "paged_attention_decode_dma": ("cuda", "sgl_kernel_tpu_torch/csrc/decode_attention.cu",
                                       "sgl_kernel_tpu/ops/attention/paged_decode_dma.py:306",
                                       "paged_attention_decode_dma"),
        "store_cache_all_layers": ("cuda", "sgl_kernel_tpu_torch/csrc/store_cache.cu",
                                   "sgl_kernel_tpu/ops/kvcache.py:193", "store_cache_all_layers"),
        "flash_attention": ("cuda", "sgl_kernel_tpu_torch/csrc/flash_prefill.cu",
                            "sgl_kernel_tpu/ops/attention/flash_prefill.py:165", "flash_attention"),
        "flash_attention_packed": ("cuda", "sgl_kernel_tpu_torch/csrc/flash_packed.cu",
                                   "sgl_kernel_tpu/ops/attention/flash_packed.py:195", "flash_attention_packed"),
        "w4a16_grouped_mm": ("cuda", "sgl_kernel_tpu_torch/csrc/w4a16_grouped_decode.cu",
                             "sgl_kernel_tpu/ops/moe/grouped_gemm.py:259", "w4a16_grouped_mm_decode_gate_up"),
        "bf16_grouped_mm": ("cuda", "sgl_kernel_tpu_torch/csrc/bf16_grouped_gemm.cu",
                            "sgl_kernel_tpu/ops/moe/grouped_gemm.py:107", "bf16_grouped_mm_deepseek_decode_gate_up"),
        "mla_decode": ("cuda", "sgl_kernel_tpu_torch/csrc/mla_decode.cu", "sgl_kernel_tpu/ops/attention/mla.py:375",
                       "mla_decode_int8"),
        "mla_qkv_prep": ("triton", "sgl_kernel_tpu_torch/ops/rope.py", "sgl_kernel_tpu/ops/rope.py:295",
                         "mla_qkv_prep"),
        "mla_decode_dma": ("cuda", "sgl_kernel_tpu_torch/csrc/mla_decode.cu",
                           "sgl_kernel_tpu/ops/attention/mla.py:287", "mla_decode_dma_bf16"),
        "fp8_paged_mqa_logits": ("cuda", "sgl_kernel_tpu_torch/csrc/mqa_logits.cu",
                                 "sgl_kernel_tpu/ops/attention/nsa.py:141", "fp8_paged_mqa_logits_decode"),
        "w4a16_gemm_dma": ("cuda", "sgl_kernel_tpu_torch/csrc/w4a16_gemm_dma.cu",
                           "sgl_kernel_tpu/ops/gemm/w4a16_dma.py:170", "w4a16_gemm_dma_gate_up"),
        "paged_attention_decode": ("cuda", "sgl_kernel_tpu_torch/csrc/decode_attention.cu",
                                   "sgl_kernel_tpu/ops/attention/paged_decode.py:158", "paged_attention_decode"),
        "sparse_attn_func": ("cuda", "sgl_kernel_tpu_torch/csrc/sparse_vs.cu",
                             "sgl_kernel_tpu/ops/attention/sparse_vs.py:351", "sparse_attn_func_32k"),
        "fp8_blockwise_scaled_mm": ("cuda", "sgl_kernel_tpu_torch/csrc/blockwise_fp8.cu",
                                    "sgl_kernel_tpu/ops/gemm/blockwise_fp8.py:268",
                                    "fp8_blockwise_scaled_mm_gate_up_m16"),
        "fp8_blockwise_scaled_grouped_mm": ("cuda", "sgl_kernel_tpu_torch/csrc/blockwise_fp8.cu",
                                            "sgl_kernel_tpu/ops/gemm/blockwise_fp8.py:362",
                                            "fp8_blockwise_scaled_grouped_mm_decode_gate_up"),
        "qserve_w4a8_per_group_gemm": ("cuda", "sgl_kernel_tpu_torch/csrc/qserve_gemm.cu",
                                       "sgl_kernel_tpu/ops/gemm/qserve.py:61", "qserve_w4a8_per_group_gemm_gate_up_m16"),
    }
    kernels = []
    # launches: the main paths' waves in phase 4, counted from 0 before each
    # wave, summed over every engine, and the op paths (K13b, K8, K16-K19, K11
    # under w4a8_grouped_mm)
    # K1 and K11 each run three kernels by shape: decode, the wgmma tile, the mma.sync tile
    sources = {"w4a16_gemm": ["sgl_kernel_tpu_torch/csrc/w4a16_decode.cu", "sgl_kernel_tpu_torch/csrc/w4a16_wgmma.cu",
                              "sgl_kernel_tpu_torch/csrc/w4a16_gemm.cu"],
               "w4a16_grouped_mm": ["sgl_kernel_tpu_torch/csrc/w4a16_grouped_decode.cu",
                                    "sgl_kernel_tpu_torch/csrc/w4a16_wgmma.cu",
                                    "sgl_kernel_tpu_torch/csrc/grouped_gemm.cu"]}
    for name, (route, src, repl, row) in meta.items():
        r = rows[row]
        kernels.append(dict(name=name, route=route, source=src, replaces=repl,
                            launches=sum(res["launches"].get(name, 0) for res in (*serve.values(), *paths.values())),
                            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"]))
        if name in ("flash_attention", "flash_attention_packed"):  # K7 / K9 at head dim 576 apart
            at576 = sum(res["launches"].get(f"{name}_576", 0) for res in (*serve.values(), *paths.values()))
            kernels[-1]["launches_by_head_dim"] = {"64/128": kernels[-1]["launches"] - at576, "576": at576}
            r576 = rows["flash_attention_576_lse" if name == "flash_attention" else "flash_attention_packed_576"]
            kernels[-1]["head_dim_576"] = {key: r576.get(key) for key in (
                "max_abs_err", "ms", "graph_ms", "tflops", "public_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if name in sources:  # launches by kernel, and the prefill row's numbers beside the decode row's
            kernels[-1]["sources"] = sources[name]
            kernels[-1]["launches_by_kernel"] = {
                way: sum(res["launches"].get(f"{name}_{way}", 0) for res in (*serve.values(), *paths.values()))
                for way in (("decode", "wgmma", "tile") if name == "w4a16_gemm" else ("stream", "wgmma", "tile"))}
            pre = rows["w4a16_gemm_gate_up_prefill" if name == "w4a16_gemm" else "w4a16_grouped_mm_prefill_gate_up"]
            kernels[-1]["wgmma_tile"] = {key: pre.get(key) for key in ("max_abs_err", "ms", "graph_ms", "plain_ms",
                                                                       "bound_ms", "bound_by", "library_ms")}
        if kernels[-1]["launches"] <= 0:
            fail(f"{name}: no launch in the served waves")
    log("[kernel] rmsnorm at [1024, 4096]: " + json.dumps(rows["rmsnorm_1024"]))
    for name in ("rmsnorm_16", "rope_decode_fused_qkv", "flash_attention", "flash_attention_packed", "flash_attention_extend_c",
                 "paged_attention_decode_dma_int8", "paged_attention_decode_dma_e4m3", "flash_attention_lse",
                 "w4a16_grouped_mm_decode_gate_up", "w4a16_grouped_mm_decode_down",
                 "w4a16_grouped_mm_mixtral_decode_gate_up", "w4a16_grouped_mm_mixtral_decode_down",
                 "w4a16_grouped_mm_prefill_gate_up", "w4a16_grouped_mm_deepseek_wave_a_gate_up",
                 "w4a16_grouped_mm_deepseek_wave_a_down", "w4a16_grouped_mm_mixtral_wave_a_gate_up",
                 "bf16_grouped_mm_mixtral_wave_a_gate_up", "w4a16_gemm_gate_up_prefill", "w4a16_gemm_down_prefill",
                 "w4a16_gemm_gate_up_wave_a", "w4a16_gemm_dma_gate_up", "w4a16_gemm_gate_up", "mla_decode", "mla_decode_e4m3",
                 "mla_decode_int8", "mla_decode_nsa_int8", "mla_decode_nsa_bf16", "mla_decode_ctx8192",
                 "fp8_paged_mqa_logits_decode",
                 "flash_attention_576_lse", "flash_attention_576_prefix5120", "flash_attention_packed_576",
                 "bf16_grouped_mm_deepseek_decode_down",
                 "bf16_grouped_mm_mixtral_decode_gate_up", "bf16_grouped_mm_mixtral_decode_down",
                 "bf16_grouped_mm_mixtral_prefill_gate_up", "bf16_grouped_mm_deepseek_decode_gate_up",
                 "bf16_grouped_mm_deepseek_wave_a_gate_up", "bf16_grouped_mm_deepseek_wave_a_down",
                 "store_cache_all_layers", "store_cache_all_layers_mixed", "w4a16_gemm_qkv", "w4a16_gemm_o",
                 "w4a16_gemm_down", "fp8_paged_mqa_logits_decode_bf16",
                 "fp8_paged_mqa_logits_ctx8192", "fp8_paged_mqa_logits_ctx32768", "mla_decode_dma_bf16_640",
                 "mla_decode_dma_e4m3_640", "w4a16_gemm_dma_qkv", "w4a16_gemm_dma_o", "w4a16_gemm_dma_down",
                 "w4a16_gemm_dma_lm_head", "w4a16_gemm_dma_gate_up_m1", "w4a16_gemm_dma_gate_up_m32",
                 "paged_attention_decode_e4m3", "paged_attention_decode_dma_head", "paged_attention_decode_dma_lse",
                 "paged_attention_decode_dma_split16", "paged_attention_decode_dma_split_32k",
                 "paged_attention_decode_dma_ctx8192", "paged_attention_decode_dma", "w4a16_gemm_lm_head",
                 "paged_attention_decode_dma_options", *sorted(n for n in rows if n.startswith(
                     ("fp8_blockwise", "qserve", "sparse_attn")))):
        log(f"[kernel] {name}: " + json.dumps(rows[name]))
    for eng_label, pr in profile.items():  # the decode A/B of every profiled engine, one line each
        if "graph" in pr:
            log(f"[decode-ab] {eng_label}: " + json.dumps({mode: {k: pr[mode].get(k) for k in (
                "step_ms", "traced_step_ms", "device_busy_ms_per_step", "device_busy_share", "kernel_launches_per_step",
                "host_launches_per_step", "replay_device_ms", "replay_launch_host_ms")} for mode in ("eager", "graph")}
                | {"logits_vs_eager": pr["logits_vs_eager"]}))
    log(json.dumps({"card": card, "parity": parity, "serve": serve, "profile": profile, "burst": burst,
                    "paths": paths, "launch_floor_ms": floor, "phase_s": times}))
    log(f"[kernel] worst err/tol over every gate: {WORST['ratio']:.4g} ({WORST['name']})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
