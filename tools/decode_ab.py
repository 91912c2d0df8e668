"""Device time of the decode kernels K5, K1, K13a, K13b and K15, of one
prefill kernel, K16, of the GEMMs K17, K18 and K19, and of K1 and K11 at
prefill rows, for the port found at ROOT.

Times, with CUDA graphs (chip_smoke.py's method: the calls captured and
replayed, so the host launch path is not measured):
- k5: K5 at B=16 over contexts 1..1,056 (32-layer pools, 128-column tables,
  fresh rows), at B=16 x 8,192 and at B=1 x 32,768 (16 splits and unsplit);
- k1: K1 at the five W4A16 Llama-3-8B decode GEMMs (M=16, group 128: qkv
  and gate_up with the norm, o with a residual, down on the gate / up halves
  with silu and a residual, lm_head with the norm);
- k13a: K13a at DeepSeek-V2-Lite's decode (16 heads, B=16, contexts
  1..1,056, page 64, 128-column tables; bf16, int8 and e4m3 pools), at
  NSA's sparse shape (B=16 x 2,048 rows selected from the pool viewed as
  one-row pages; int8 and bf16) and at B=16 x 8,192 (bf16, dense pages);
- k15: K15 at the NSA indexer's decode (64 heads of 128, B=16, contexts
  1..1,056, 8,192-token tables, e4m3 keys with scales; and bf16 keys), at
  B=16 x 8,192 and at B=1 x 32,768;
- k13b: K13b (``mla_decode(engine="dma")``) at K13a's decode shape (16
  heads, B=16, contexts 1..1,056, page 64, 128-column tables, layer 1 of a
  two-layer pool, lse) on a bf16 pool, a 640-wide bf16 pool and a 640-wide
  e4m3 pool, each beside K13a's own call on the same pool (``_k13a`` rows);
- k16: K16 (``sparse_attn_func``, the vertical + slash sparse prefill) at
  Llama-3-8B's attention widths (32 heads of 128, causal, bm 64, bn 128) at
  S=4,096 (NV 256, NS 8; plain and with soft cap 30 + lse) and S=32,768 (NV
  1,000, NS 64), schedules from convert_vertical_slash_indexes on sorted
  random columns and distances, each beside dense causal SDPA on the same
  q / k / v (``_sdpa`` rows, CUDA-event ms);
- k17: K17 (``fp8_blockwise_scaled_mm``) at DeepSeek-V3's dense fp8 GEMMs
  (shared-expert gate_up [M, 7168 -> 4096], down [M, 2048 -> 7168], o_proj
  [M, 16384 -> 7168]; compact 128x128 scales) at M=16 (CUDA-graph ms) and
  M=1,024 (CUDA-event ms, each beside row-wise ``torch._scaled_mm`` on the
  same operands, ``_scaled_mm`` rows);
- k18: K18 (``fp8_blockwise_scaled_grouped_mm``) over DeepSeek-V3's routed
  banks (256 experts, gate_up [256, 7168, 4096], down [256, 2048, 7168]) at
  a B=16 decode (top-8, bm 16; CUDA-graph ms) and a 1,024-token prefill
  (bm 128; CUDA-event ms beside row-wise ``torch._scaled_grouped_mm`` on the
  valid rows, ``_scaled_grouped_mm`` rows), rows aligned by
  moe_align_block_size;
- k19: K19 (``qserve_w4a8_per_group_gemm``) at Llama-3-8B's four GEMMs (qkv
  [M, 4096 -> 6144], o [M, 4096 -> 4096], gate_up [M, 4096 -> 28672], down
  [M, 14336 -> 4096]; group 128) on QServe-made weights (int8 channels,
  then 4-bit groups: tests/test_gemm.py:278-292) at M=16 (CUDA-graph ms)
  and M=1,024 (CUDA-event ms), each beside ``torch._int_mm`` on the int8 W8
  (A padded to 17 rows at M=16; ``_int_mm`` rows);
- k1p: K1 at prefill rows (group 128): Llama-3-8B's qkv (norm), o
  (residual), gate_up (norm) and down (silu on the gate / up halves,
  residual) at M = 64, 200 and 1,040 (extends, wave B, mixed steps), gate_up
  (bare) and down at M = 1,024, and wave A's packed gate_up at M = 16,384;
  each beside cuBLAS's bf16 product on the dequantized weight (``_cublas``
  rows, a yardstick no tree calls); CUDA-graph ms (event ms at 16,384);
- k11p: K11 at prefill row blocks, gate_up on int4 codes and group-128
  scales with rows routed and aligned as the model does: DeepSeek-V2-Lite
  (64 experts, top-6, 2,048 -> 2,816; and down, 1,408 -> 2,048) at 1,024
  tokens (bm 64 and 128) and at wave A's 16,384 (bm 128), Mixtral-8x7B (8
  experts, top-2, 4,096 -> 28,672) at 1,024 (bm 64 and 128) and 16,384
  (bm 128); each beside K12 (``bf16_grouped_mm``) on a bf16 bank of the
  same shape (``_k12`` rows); CUDA-graph ms;
- k11g: K11 at gpt-oss-20b's expert widths (32 experts, top-4, K = 2,880:
  gate_up 2,880 -> 5,760 and down 2,880 -> 2,880) by code format and
  group: MXFP4 at groups of 32 (the model's), int4 at 32 and at 64, each at
  a B=16 decode (bm 16, the streaming core; cold: the calls cycle two
  stacked layers) and a 1,024-token prefill (bm 128, the wgmma tile),
  beside the bank's bytes over 3.35 TB/s (``_bound`` rows); CUDA-graph ms;
- k79m: K7 and K9 at head dim 576, DeepSeek-V2-Lite's MLA prefill (16
  heads over one latent head, sm_scale 1/sqrt(192)), each through the
  function the model calls (``mla.mla_prefill``, ``deepseek._mla_attend_packed``:
  on a tree without the MLA form they pad V to 576 and slice the output)
  and through the public ``flash_attention`` / ``flash_attention_packed``
  with a padded V (``_public`` rows): a causal 1,024-token prefill, the
  extend pair 512 over 512 with lse, wave D's last prefix pass (1,024
  queries over 5,120 prefix keys, all visible, lse) and wave A's packing
  (16 prompts of 16..1,024 tokens, block 256); CUDA-graph ms, event ms
  (``_event`` rows) beside the longer ones, the bound (``_bound``: max of
  the MLA form's operations, 2 x 16 x (576 + 512) a visible pair, over the
  bf16 peak and bytes over 3.35 TB/s; TFLOP/s at the same count), and SDPA as the yardstick (``_sdpa``: padded V, the
  extend mask, jagged nested tensors for the packing);
- floor: one empty kernel (``torch.cuda._sleep(0)``) a graph node, the
  least a kernel of the decode step costs on the device.
K13a and K15 rows are timed warm (the same inputs call after call) and cold
(``_cold`` rows: the calls cycle the layers of a stacked pool, or the rows
selected from it, of at least 150 MB, three times the L2, so each call
reads its rows from device memory as a model's step does). Inputs come
from a fixed seed, so two trees see the same data. To compare two trees on
one card, run them in turns in one call (old, new, new, old):

    python tools/decode_ab.py OLD_TREE k13a,k15,floor; python tools/decode_ab.py . k13a,k15,floor

The second argument picks the groups (all of them by default).
Only the sources the groups use are compiled. Prints the card's name and
power limit, then one JSON line of ms.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

GROUPS = ("k5", "k1", "k13a", "k13b", "k15", "k16", "k17", "k18", "k19", "k1p", "k11p", "k11g", "k79m", "floor")
# the sources a group may launch (those a tree lacks are skipped: K13b had a
# source of its own before it moved onto K13a's kernel)
SOURCES = {"k5": ("decode_attention",), "k1": ("w4a16_decode", "w4a16_gemm"), "k13a": ("mla_decode",),
           "k13b": ("mla_decode", "mla_decode_dma"), "k15": ("mqa_logits",), "k16": ("sparse_vs",),
           "k17": ("blockwise_fp8",), "k18": ("blockwise_fp8",), "k19": ("qserve_gemm",),
           "k1p": ("w4a16_wgmma", "w4a16_gemm"), "k11p": ("w4a16_wgmma", "grouped_gemm", "bf16_grouped_gemm"),
           "k11g": ("w4a16_grouped_decode", "w4a16_wgmma"), "k79m": ("flash_prefill", "flash_packed"), "floor": ()}
COLD_BYTES = 150e6  # three times the 50 MB L2


def build(_build, stems):
    """Compile the named sources of the tree (those not built yet), side by side."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for stem in dict.fromkeys(stems):
        if not (_build.CSRC / f"{stem}.cu").exists():
            continue
        out = _build._lib_path(_build.CSRC / f"{stem}.cu")
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            jobs.append((out, tmp, _build._start(_build.CSRC / f"{stem}.cu", tmp)))
    for out, tmp, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{text}")
        os.replace(tmp, out)


def main(root: Path, groups) -> None:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import sgl_kernel_tpu_torch as skt
    from sgl_kernel_tpu_torch import _build
    from sgl_kernel_tpu_torch.ops import moe
    from sgl_kernel_tpu_torch.ops.attention import mla, nsa, sparse_vs
    from sgl_kernel_tpu_torch.ops.attention import paged_decode_dma as pd
    from sgl_kernel_tpu_torch.ops.gemm import blockwise_fp8 as bw
    from sgl_kernel_tpu_torch.ops.gemm import w4a16

    assert Path(skt.__file__).resolve().parent.parent == root.resolve(), skt.__file__
    build(_build, [s for g in groups for s in SOURCES[g]])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261017)
    bf = torch.bfloat16

    def replay_ms(graph, reps):
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 5 / reps

    def graph_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        return replay_ms(graph, reps)

    def event_ms(fn, iters):
        """CUDA-event ms a call over back-to-back calls (a call that cannot be
        captured, or one far longer than its launch path)."""
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def cold_ms(fn, layers):
        """fn(i) reads layer i's rows; a graph of max(24, layers) calls, call i
        on layer i % layers, so no call finds its rows in L2."""
        reps = max(24, layers)
        for i in range(layers):
            fn(i)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(reps):
                fn(i % layers)
        return replay_ms(graph, reps)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def paged(lengths, page, cols):
        """A table of ``cols`` columns holding each length's pages from a
        permutation of pages 1..; returns (table, pages used)."""
        used = [-(-n // page) for n in lengths]
        table = torch.zeros((len(lengths), cols), dtype=torch.int32, device=dev)
        perm = torch.randperm(sum(used), generator=gen, device=dev).to(torch.int32) + 1
        at = 0
        for i, n in enumerate(used):
            table[i, :n] = perm[at: at + n]
            at += n
        return table, sum(used)

    ragged = [1 + (1055 * i) // 15 for i in range(16)]
    res = {"root": str(root)}
    if "k5" in groups:
        for name, lengths, cols, layers, splits in (
                ("k5_ragged", ragged, 128, 32, 1), ("k5_ctx8192", [8192] * 16, 128, 1, 1),
                ("k5_32k_split16", [32768], 512, 1, 16), ("k5_32k_unsplit", [32768], 512, 1, 1)):
            table, n_used = paged([n - 1 for n in lengths], 64, cols)
            kp, vp = randn(layers, n_used + 1, 8, 64, 128), randn(layers, n_used + 1, 8, 64, 128)
            b = len(lengths)
            q, fk, fv = randn(b, 32, 128), randn(b, 8, 128), randn(b, 8, 128)
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            kw = dict(layer_id=layers - 1, fresh_k=fk, fresh_v=fv, num_splits=splits, chunk_pages=16)
            res[name] = graph_ms(lambda: pd.paged_attention_decode_dma(q, kp, vp, lens, table, **kw))
            del kp, vp
            torch.cuda.empty_cache()
    if "k1" in groups:
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
    if "k13a" in groups:
        sm = 1.0 / 192 ** 0.5  # V2-Lite's qk_nope 128 + rope 64
        qn, qp = randn(16, 16, 512, scale=0.3), randn(16, 16, 64, scale=0.3)

        def pool_of(shape, dt):
            if dt == torch.int8:
                return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int32).to(dt)
            return randn(*shape, scale=1.0 if dt == bf else 2.0).to(dt)

        table, n_used = paged(ragged, 64, 128)
        lens = torch.tensor(ragged, dtype=torch.int32, device=dev)
        for kind, dt in (("bf16", bf), ("int8", torch.int8), ("e4m3", torch.float8_e4m3fn)):
            layers = max(2, -(-int(COLD_BYTES) // (n_used * 64 * 576 * dt.itemsize)))
            pool = pool_of((layers, n_used + 1, 64, 576), dt)
            kw = dict(sm_scale=sm, return_lse=True)
            res[f"k13a_{kind}"] = graph_ms(lambda: mla.mla_decode(qn, qp, pool, lens, table, 1, **kw))
            res[f"k13a_{kind}_cold"] = cold_ms(lambda i: mla.mla_decode(qn, qp, pool, lens, table, i, **kw), layers)
            del pool
            torch.cuda.empty_cache()
        # NSA: each sequence's 2,048 selected rows of a flat pool of one-row
        # pages; the cold rows select from another part of a pool of >= 150 MB
        sel = 16 * 2048
        lens = torch.full((16,), 2048, dtype=torch.int32, device=dev)
        for kind, dt in (("int8", torch.int8), ("bf16", bf)):
            layers = max(2, -(-int(COLD_BYTES) // (sel * 576 * dt.itemsize)))
            rows = pool_of((layers * sel, 1, 576), dt)
            tables = [(torch.randperm(sel, generator=gen, device=dev).to(torch.int32) + i * sel).reshape(16, 2048)
                      for i in range(layers)]
            kw = dict(sm_scale=sm, return_lse=True)
            res[f"k13a_nsa_{kind}"] = graph_ms(lambda: mla.mla_decode(qn, qp, rows, lens, tables[0], **kw))
            res[f"k13a_nsa_{kind}_cold"] = cold_ms(lambda i: mla.mla_decode(qn, qp, rows, lens, tables[i], **kw),
                                                   layers)
            del rows, tables
            torch.cuda.empty_cache()
        # B=16 x 8,192, bf16, dense pages of 64: 151 MB a call, three L2s
        table, n_used = paged([8192] * 16, 64, 128)
        pool = pool_of((1, n_used + 1, 64, 576), bf)
        lens = torch.full((16,), 8192, dtype=torch.int32, device=dev)
        res["k13a_ctx8192_bf16"] = graph_ms(lambda: mla.mla_decode(qn, qp, pool, lens, table, 0, sm_scale=sm))
        del pool
        torch.cuda.empty_cache()
    if "k13b" in groups:
        sm = 1.0 / 192 ** 0.5
        qn, qp = randn(16, 16, 512, scale=0.3), randn(16, 16, 64, scale=0.3)
        table, n_used = paged(ragged, 64, 128)
        lens = torch.tensor(ragged, dtype=torch.int32, device=dev)
        for kind, dt, width, scale in (("bf16", bf, 576, 1.0), ("bf16_640", bf, 640, 1.0),
                                       ("e4m3_640", torch.float8_e4m3fn, 640, 0.5)):
            pool = torch.randn((2, n_used + 1, 64, width), generator=gen, device=dev) * (1.0 if dt == bf else 2.0)
            pool[..., 576:] = 0
            pool = pool.to(dt)
            kw = dict(sm_scale=sm * scale, return_lse=True)
            res[f"k13b_{kind}"] = graph_ms(lambda: mla.mla_decode(qn, qp, pool, lens, table, 1, engine="dma", **kw))
            res[f"k13b_{kind}_k13a"] = graph_ms(lambda: mla.mla_decode(qn, qp, pool, lens, table, 1, **kw))
            del pool
            torch.cuda.empty_cache()
    if "k16" in groups:
        rng = np.random.default_rng(20261017)
        for name, s, nv, ns, kw in (("k16_4k", 4096, 256, 8, {}),
                                    ("k16_4k_softcap_lse", 4096, 256, 8, dict(softcap=30.0, return_lse=True)),
                                    ("k16_32k", 32768, 1000, 64, {})):
            q, k, v = (randn(1, s, 32, 128) for _ in range(3))
            vert = np.sort(np.stack([rng.choice(s, nv, replace=False) for _ in range(32)]), -1)[None]
            slash = np.ascontiguousarray(
                np.sort(np.stack([rng.choice(s, ns, replace=False) for _ in range(32)]), -1)[None, :, ::-1])
            sched = [torch.from_numpy(x).to(dev) for x in
                     sparse_vs.convert_vertical_slash_indexes([s], [s], vert, slash, s, 64, 128)]
            iters = 5 if s > 8192 else 20
            res[name] = graph_ms(lambda: sparse_vs.sparse_attn_func(q, k, v, *sched, **kw), reps=iters)
            if not kw:
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                res[f"{name}_sdpa"] = event_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True), iters)
            del q, k, v, sched
            torch.cuda.empty_cache()
    if "k15" in groups:
        for name, lengths, cols, kdt in (("k15_decode", ragged, 128, torch.float8_e4m3fn),
                                         ("k15_decode_bf16", ragged, 128, bf),
                                         ("k15_ctx8192", [8192] * 16, 128, torch.float8_e4m3fn),
                                         ("k15_32k", [32768], 512, torch.float8_e4m3fn)):
            table, n_used = paged(lengths, 64, cols)
            per = n_used * 64 * (128 * kdt.itemsize + (4 if kdt != bf else 0))
            layers = max(2, -(-int(COLD_BYTES) // per))
            n_pages = n_used + 1
            keys = (torch.randn((layers * n_pages, 64, 128), generator=gen, device=dev) * 2).to(kdt)
            scales = (None if kdt == bf else
                      torch.rand((layers * n_pages, 64), generator=gen, device=dev) * 0.01 + 1e-3)
            b = len(lengths)
            q = randn(b, 64, 128, scale=0.5)
            w = torch.sigmoid(torch.randn((b, 64), generator=gen, device=dev))
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            tables = [table + i * n_pages for i in range(layers)]
            res[name] = graph_ms(lambda: nsa.fp8_paged_mqa_logits(q, keys, w, lens, tables[0], scales))
            res[f"{name}_cold"] = cold_ms(lambda i: nsa.fp8_paged_mqa_logits(q, keys, w, lens, tables[i], scales),
                                          layers)
            del keys, scales, tables
            torch.cuda.empty_cache()
    def e4m3(*shape):
        """Uniform random e4m3 bytes but the two NaN codes."""
        u = torch.randint(0, 254, shape, generator=gen, device=dev, dtype=torch.uint8)
        u.add_((u >= 0x7F).to(torch.uint8))
        return u.view(torch.float8_e4m3fn)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 1e-2 + 1e-3

    if "k17" in groups:
        for label, n, k in (("gate_up", 4096, 7168), ("down", 7168, 2048), ("o_proj", 7168, 16384)):
            b, sb = e4m3(k, n), scales(k // 128, n // 128)
            bt = b.t().contiguous().t()  # the library's column-major B, made outside the timed calls
            for m in (16, 1024):
                a, sa = e4m3(m, k), scales(m, k // 128)
                fn = lambda: bw.fp8_blockwise_scaled_mm(a, b, sa, sb)
                if m == 16:
                    res[f"k17_{label}_m16"] = graph_ms(fn)
                    continue
                res[f"k17_{label}_m1024"] = event_ms(fn, 20)
                ones_a, ones_b = torch.ones((m, 1), device=dev), torch.ones((1, n), device=dev)
                res[f"k17_{label}_m1024_scaled_mm"] = event_ms(
                    lambda: torch._scaled_mm(a, bt, scale_a=ones_a, scale_b=ones_b, out_dtype=bf), 20)
            del b, bt
            torch.cuda.empty_cache()
    if "k18" in groups:
        e, h, inter = 256, 7168, 2048
        banks = {"gate_up": (e4m3(e, h, 2 * inter), scales(e, h // 128, 2 * inter // 128)),
                 "down": (e4m3(e, inter, h), scales(e, inter // 128, h // 128))}
        for t, bm, label in ((16, 16, "decode"), (1024, 128, "prefill")):
            tw, tids = moe.topk_softmax(torch.randn((t, e), generator=gen, device=dev), 8)
            al = moe.moe_align_block_size(tids, tw, e, bm)
            cap, eids = al.token_ids.shape[0], al.block_expert_ids
            offs = torch.cumsum(al.padded_group_sizes, 0).to(torch.int32)
            for name, (w, sw) in banks.items():
                k, n = w.shape[1], w.shape[2]
                a, sa = e4m3(cap, k), scales(cap, k // 128)
                fn = lambda: bw.fp8_blockwise_scaled_grouped_mm(a, w, sa, sw, eids, bm=bm)
                if label == "decode":
                    res[f"k18_decode_{name}"] = graph_ms(fn)
                    continue
                res[f"k18_prefill_{name}"] = event_ms(fn, 5)
                if hasattr(torch, "_scaled_grouped_mm"):
                    wt = w.transpose(-2, -1).contiguous().transpose(-2, -1)
                    ones_a, ones_b = torch.ones(cap, device=dev), torch.ones((e, n), device=dev)
                    res[f"k18_prefill_{name}_scaled_grouped_mm"] = event_ms(
                        lambda: torch._scaled_grouped_mm(a, wt, ones_a, ones_b, offs=offs, out_dtype=bf), 5)
                    del wt
                torch.cuda.empty_cache()
            res[f"k18_{label}_rows"], res[f"k18_{label}_experts_hit"] = cap, int(torch.unique(eids).numel())
        del banks
        torch.cuda.empty_cache()
    if "k19" in groups:
        from sgl_kernel_tpu_torch.ops.gemm import qserve

        def qserve_weights(n, k, g):
            """codes, zeros_x_s2, s2 (int8), per-channel scales and the int8 W8
            of a random weight quantized as QServe does."""
            b = torch.randn((n, k), generator=gen, device=dev) * 0.01
            chn = b.abs().amax(-1, keepdim=True) / 119
            bi8 = torch.clamp(torch.round(b / chn), -119, 119).reshape(n, k // g, g)
            del b
            s2 = torch.clamp(torch.round((bi8.amax(-1) - bi8.amin(-1)) / 15), min=1.0)
            z2 = -torch.round(bi8.amin(-1) / s2)
            codes = torch.clamp(torch.round(bi8 / s2[..., None]) + z2[..., None], 0, 15)
            w8 = ((codes - z2[..., None]) * s2[..., None]).reshape(n, k).to(torch.int8)
            return codes.reshape(n, k).to(torch.uint8), z2 * s2, s2.to(torch.int8), chn[:, 0].half(), w8

        for label, n, k in (("qkv", 6144, 4096), ("o", 4096, 4096), ("gate_up", 28672, 4096), ("down", 4096, 14336)):
            codes, zs2, s2, ws, w8 = qserve_weights(n, k, 128)
            w8_t = w8.t()
            for m in (16, 1024):
                aq = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
                as_ = (torch.rand(m, generator=gen, device=dev) * 0.01 + 1e-3).half()
                a_lib = torch.nn.functional.pad(aq, (0, 0, 0, max(0, 17 - m)))
                fn = lambda: qserve.qserve_w4a8_per_group_gemm(aq, codes, zs2, s2, ws, as_)
                lib = lambda: torch._int_mm(a_lib, w8_t)
                time_fn = graph_ms if m == 16 else (lambda f: event_ms(f, 20))
                res[f"k19_{label}_m{m}"] = time_fn(fn)
                res[f"k19_{label}_m{m}_int_mm"] = time_fn(lib)
            del codes, w8, w8_t
            torch.cuda.empty_cache()
    if "k1p" in groups:
        cases = [(f"k1p_{name}_m{m}", m, n, k, opt) for m in (64, 200, 1040)
                 for name, n, k, opt in (("qkv", 6144, 4096, "norm"), ("o", 4096, 4096, "residual"),
                                         ("gate_up", 28672, 4096, "norm"), ("down", 4096, 14336, "fused"))]
        cases += [("k1p_gate_up_m1024", 1024, 28672, 4096, None), ("k1p_down_m1024", 1024, 4096, 14336, "fused"),
                  ("k1p_gate_up_m16384", 16384, 28672, 4096, None)]
        weights = {}
        for name, m, n, k, opt in cases:
            if (n, k) not in weights:
                weights.clear()
                torch.cuda.empty_cache()
                w, s, _ = w4a16.quantize_w4(torch.randn((n, k), generator=gen, device=dev) * 0.02, group_size=128)
                weights[(n, k)] = (w, s, w4a16.dequant_w4(w, s, group_size=128).t().contiguous())
            w, s, wd = weights[(n, k)]
            a = randn(m, 2 * k if opt == "fused" else k)
            kw = dict(group_size=128)
            if opt == "norm":
                kw["norm_weight"] = randn(k)
            elif opt == "residual":
                kw["residual"] = randn(m, n)
            elif opt == "fused":
                kw.update(prologue="silu_mul", fused_gate_up=True, residual=randn(m, n))
            time_fn = graph_ms if m <= 1040 else (lambda f: event_ms(f, 10))
            res[name] = time_fn(lambda: w4a16.w4a16_gemm(a, w, s, **kw))
            a0 = a[:, :k].contiguous()
            res[f"{name}_cublas"] = time_fn(lambda: torch.matmul(a0, wd))
            del a, a0
        weights.clear()
        torch.cuda.empty_cache()
    if "k11p" in groups:
        for label, e, k_top, h, inter, shapes in (
                ("v2lite", 64, 6, 2048, 1408, ((1024, 64), (1024, 128), (16384, 128))),
                ("mixtral", 8, 2, 4096, 14336, ((1024, 64), (1024, 128), (16384, 128)))):
            steps = [("gate_up", h, 2 * inter)] + ([("down", inter, h)] if label == "v2lite" else [])
            banks = {}
            for name, kk, n in steps:
                w = torch.randint(0, 256, (1, e, kk // 2, n), generator=gen, device=dev, dtype=torch.int32)
                sc = (0.002 + 0.004 * torch.rand((1, e, kk // 128, n), generator=gen, device=dev)).to(bf)
                banks[name] = (w.to(torch.uint8), sc, randn(e, kk, n, scale=kk ** -0.5))
                del w
            for t, bm in shapes:
                logits = torch.randn((t, e), generator=gen, device=dev)
                if label == "v2lite":
                    tw, tids = moe.biased_topk(logits, torch.zeros(e, device=dev), k_top, renormalize=True,
                                               apply_routed_scaling_factor_on_output=True)
                else:
                    tw, tids = moe.topk_softmax(logits, k_top, renormalize=True)
                al = moe.moe_align_block_size(tids, tw, e, bm)
                for name, kk, n in steps:
                    w, sc, wb = banks[name]
                    x = moe.scatter_tokens_to_experts(randn(t, kk), al)
                    args = (al.block_expert_ids, None, 0, al.num_valid_blocks)
                    tag = f"k11p_{label}_{name}_t{t}_bm{bm}"
                    res[tag] = graph_ms(lambda: moe.w4a16_grouped_mm(x, w, sc, *args, bm=bm), reps=5 if t > 1024 else 20)
                    res[f"{tag}_k12"] = graph_ms(lambda: moe.bf16_grouped_mm(x, wb, al.block_expert_ids, None,
                                                                             al.num_valid_blocks, bm=bm),
                                                 reps=5 if t > 1024 else 20)
                    del x
            banks.clear()
            torch.cuda.empty_cache()
    if "k11g" in groups:
        e, k_top, h = 32, 4, 2880
        for fmt, g in (("mxfp4", 32), ("int4", 32), ("int4", 64)):
            banks = {}
            for name, kk, n in (("gate_up", h, 2 * h), ("down", h, h)):
                w = torch.randint(0, 256, (2, e, kk // 2, n), generator=gen, device=dev, dtype=torch.int32)
                sc = torch.exp2(torch.randint(-9, -6, (2, e, kk // g, n), generator=gen, device=dev).float()).to(bf)
                banks[name] = (w.to(torch.uint8), sc, kk, n)
                del w
            for t, bm in ((16, 16), (1024, 128)):
                tw, tids = moe.topk_softmax(torch.randn((t, e), generator=gen, device=dev), k_top, renormalize=True)
                al = moe.moe_align_block_size(tids, tw, e, bm)
                hit = int((al.group_sizes > 0).sum())
                for name, (w, sc, kk, n) in banks.items():
                    x = moe.scatter_tokens_to_experts(randn(t, kk), al)
                    kw = dict(bm=bm, group_size=g, fmt=fmt)
                    args = (al.block_expert_ids, None)
                    tag = f"k11g_{fmt}_g{g}_{name}_t{t}"
                    res[tag] = graph_ms(lambda: moe.w4a16_grouped_mm(x, w, sc, *args, 1, al.num_valid_blocks, **kw))
                    res[f"{tag}_bound"] = 1e3 * hit * (kk // 2 * n + 2 * (kk // g) * n) / 3.35e12
                    if t == 16:
                        res[f"{tag}_cold"] = cold_ms(lambda lid: moe.w4a16_grouped_mm(
                            x, w, sc, *args, lid, al.num_valid_blocks, **kw), 2)
                    del x
            banks.clear()
            torch.cuda.empty_cache()
    if "k79m" in groups:
        k79m(torch, res, randn, graph_ms, event_ms, dev)
    if "floor" in groups:
        res["floor_empty_kernel"] = graph_ms(lambda: torch.cuda._sleep(0), reps=100)
    print(json.dumps(res), flush=True)


def k79m(torch, res, randn, graph_ms, event_ms, dev):
    """The k79m group (module docstring)."""
    from types import SimpleNamespace

    from sgl_kernel_tpu_torch.models import deepseek
    from sgl_kernel_tpu_torch.ops.attention import flash_packed, flash_prefill, mla
    from sgl_kernel_tpu_torch.serving.engine import packed_layout

    F = torch.nn.functional
    nh, sm = 16, 1.0 / 192 ** 0.5
    flops = lambda pairs: 2 * nh * (576 + 512) * pairs  # S over 576 columns, P V over 512

    def bound(n_bytes, pairs):
        return 1e3 * max(n_bytes / 3.35e12, flops(pairs) / 989e12)

    def i32(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def rows(name, path, public, sdpa, pairs, n_bytes, event_iters=0):
        res[name] = graph_ms(path, reps=5 if event_iters else 20)
        res[f"{name}_tflops"] = flops(pairs) / res[name] / 1e9
        res[f"{name}_public"] = graph_ms(public, reps=5 if event_iters else 20)
        if event_iters:
            res[f"{name}_event"] = event_ms(path, event_iters)
        try:  # the yardstick, where this torch computes it
            res[f"{name}_sdpa"] = event_ms(sdpa, 5) if event_iters else graph_ms(sdpa)
        except Exception as e:
            torch.cuda.synchronize()
            res[f"{name}_sdpa"] = f"{type(e).__name__}: {str(e).splitlines()[0][:100]}"
        res[f"{name}_bound"] = bound(n_bytes, pairs)

    def pad(kv):
        return F.pad(kv[..., :512], (0, 64))

    # 1,024-token causal prefill
    s = 1024
    qn, qp, kv = randn(1, s, nh, 512, scale=0.3), randn(1, s, nh, 64, scale=0.3), randn(1, s, 576)
    q, k4 = torch.cat([qn, qp], -1), kv[:, :, None]
    v4 = pad(k4)
    ql = i32(s)
    qt, kt, vt = q.transpose(1, 2), k4.transpose(1, 2), v4.transpose(1, 2)
    rows("k79m_causal1024", lambda: mla.mla_prefill(qn, qp, kv, ql, ql, sm_scale=sm),
         lambda: flash_prefill.flash_attention(q, k4, v4, ql, ql, causal=True, sm_scale=sm),
         lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=sm, enable_gqa=True),
         s * (s + 1) // 2, (s * nh * 576 + s * 576) * 2 + s * nh * 512 * 2)
    # the extend pair: 512 fresh rows over a 512-row prefix, with lse
    s = pre = 512
    qn, qp = randn(1, s, nh, 512, scale=0.3), randn(1, s, nh, 64, scale=0.3)
    kv1, kv2 = randn(1, s, 576), randn(1, pre, 576)
    q = torch.cat([qn, qp], -1)
    k1, k2 = kv1[:, :, None], kv2[:, :, None]
    v1, v2 = pad(k1), pad(k2)
    ql, pl_, zero = i32(s), i32(pre), i32(0)
    kw = dict(sm_scale=sm, return_lse=True)
    qt = q.transpose(1, 2)
    kt, vt = torch.cat([k2, k1], 1).transpose(1, 2), torch.cat([v2, v1], 1).transpose(1, 2)
    mask = torch.arange(pre + s, device=dev)[None, :] <= (pre + torch.arange(s, device=dev))[:, None]
    rows("k79m_extend512",
         lambda: (mla.mla_prefill(qn, qp, kv1, ql, ql, q_start=pl_, kv_start=pl_, **kw),
                  mla.mla_prefill(qn, qp, kv2, ql, pl_, q_start=pl_, kv_start=zero, **kw)),
         lambda: (flash_prefill.flash_attention(q, k1, v1, ql, ql, None, pl_, pl_, causal=True, **kw),
                  flash_prefill.flash_attention(q, k2, v2, ql, pl_, None, pl_, zero, causal=True, **kw)),
         lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=sm, enable_gqa=True),
         s * (s + 1) // 2 + s * pre, (s * nh * 576 + (s + pre) * 576) * 2 + 2 * (s * nh * 512 * 2 + nh * s * 4))
    # wave D's last prefix pass: 1,024 queries over 5,120 prefix keys, all visible
    s, pre = 1024, 5120
    qn, qp, kv = randn(1, s, nh, 512, scale=0.3), randn(1, s, nh, 64, scale=0.3), randn(1, pre, 576)
    q, k4 = torch.cat([qn, qp], -1), kv[:, :, None]
    v4 = pad(k4)
    ql, pl_ = i32(s), i32(pre)
    qt, kt, vt = q.transpose(1, 2), k4.transpose(1, 2), v4.transpose(1, 2)
    rows("k79m_prefix5120", lambda: mla.mla_prefill(qn, qp, kv, ql, pl_, q_start=pl_, kv_start=zero, **kw),
         lambda: flash_prefill.flash_attention(q, k4, v4, ql, pl_, None, pl_, zero, causal=True, **kw),
         lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=sm, enable_gqa=True),
         s * pre, (s * nh * 576 + pre * 576) * 2 + s * nh * 512 * 2 + nh * s * 4, event_iters=10)
    # wave A's packing through K9
    lens = [16 + (1008 * i) // 15 for i in range(16)]
    blk_seq, blk_q0, seq_meta, tok0, tp, max_kvb = packed_layout(lens, 17)
    ints = [torch.from_numpy(a).to(dev) for a in (blk_seq, blk_q0, seq_meta)]
    q_lat, q_pe, kv_row = randn(tp, nh, 512, scale=0.3), randn(tp, nh, 64, scale=0.3), randn(tp, 576)
    cfg = SimpleNamespace(num_heads=nh, qk_nope_dim=128)
    q, k3 = torch.cat([q_lat, q_pe], -1), kv_row[:, None]
    v3 = pad(k3)
    idx = torch.cat([torch.arange(t0, t0 + n, device=dev) for t0, n in zip(tok0, lens)])
    offsets = torch.tensor([0] + [sum(lens[:i + 1]) for i in range(len(lens))], device=dev)
    njt = [torch.nested.nested_tensor_from_jagged(x[idx], offsets).transpose(1, 2)
           for x in (q, k3.expand(-1, nh, -1), v3.expand(-1, nh, -1))]
    n_tok = sum(lens)
    rows("k79m_packed_wave_a",
         lambda: deepseek._mla_attend_packed(q_lat, q_pe, kv_row, *ints, cfg, tp, max_kvb),
         lambda: flash_packed.flash_attention_packed(q, k3, v3, *ints, max_kvb=max_kvb, causal=True, sm_scale=sm),
         lambda: F.scaled_dot_product_attention(*njt, is_causal=True, scale=sm),
         sum(n * (n + 1) // 2 for n in lens), n_tok * (nh + 1) * 576 * 2 + tp * nh * 512 * 2, event_iters=10)
    torch.cuda.empty_cache()


if __name__ == "__main__":
    main(Path(sys.argv[1]) if len(sys.argv) > 1 else Path("."),
         sys.argv[2].split(",") if len(sys.argv) > 2 else GROUPS)
