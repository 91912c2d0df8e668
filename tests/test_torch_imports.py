"""The port stands alone: importing it loads neither JAX nor the JAX
package, no module of it imports them, and its entry points refuse to run
on a machine without a card unless the CPU is asked for."""

import importlib
import inspect
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sgl_kernel_tpu_torch as skt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def test_import_loads_no_jax():
    code = ("import sys, sgl_kernel_tpu_torch\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'ml_dtypes', 'sgl_kernel_tpu.'))"
            " or m == 'sgl_kernel_tpu']\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_module_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|ml_dtypes|sgl_kernel_tpu)([. ]|$)", re.M)
    files = sorted((ROOT / "sgl_kernel_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}: {m.group(0)}" for f in files for m in pat.finditer(f.read_text())]
    assert not hits, hits


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = skt.LlamaConfig.tiny(fused=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        skt.Engine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        skt.init_weights(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        skt.make_caches(cfg, 4, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        skt.Engine(skt.DeepseekConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        skt.Engine(skt.MixtralConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        skt.Engine(skt.DeepseekConfig.tiny(nsa=True, idx_dim=32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        skt.Engine(skt.GptOssConfig.tiny(quant="mxfp4", qkv_bias=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        skt.Engine(skt.DeepseekConfig.tiny(compress="c4"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        skt.Engine(skt.HybridGdnConfig.tiny())


def test_device_parameters_default_to_the_card():
    """Every public function of the port (and public method or constructor
    of its classes) that takes a ``device`` with a default defaults to
    "cuda": the CPU runs only when the caller names it."""
    found, bad = [], []
    for info in pkgutil.walk_packages(skt.__path__, "sgl_kernel_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
                continue
            fns = [(name, obj)] if inspect.isfunction(obj) else []
            if inspect.isclass(obj):
                fns += [(f"{name}.{k}", getattr(v, "__func__", v)) for k, v in vars(obj).items()
                        if (k == "__init__" or not k.startswith("_"))
                        and (inspect.isfunction(v) or isinstance(v, (classmethod, staticmethod)))]
            for label, fn in fns:
                p = inspect.signature(fn).parameters.get("device")
                if p is not None and p.default is not inspect.Parameter.empty:
                    found.append(label)
                    if p.default != "cuda":
                        bad.append(f"{info.name}.{label}: device={p.default!r}")
    assert not bad, bad
    assert "compute_cos_sin_cache" in found and "Engine.__init__" in found


def test_unserved_engine_arguments_raise():
    cfg = skt.LlamaConfig.tiny(fused=True)
    with pytest.raises(NotImplementedError):
        skt.Engine(cfg, device="cpu", num_pages=8, page_size=16, mesh=object())
    # a draft is served (tests/test_torch_spec.py), but not in front of gpt-oss, whose JAX extend has no num_logits
    with pytest.raises(ValueError):
        skt.Engine(skt.GptOssConfig.tiny(quant="mxfp4", qkv_bias=True), device="cpu", num_pages=8, page_size=16,
                   draft_cfg=cfg)
    # decode bursts are served (tests/test_torch_engine.py); a burst is at least one step
    assert skt.Engine(cfg, device="cpu", num_pages=8, page_size=16, decode_burst=4).decode_burst == 4
    with pytest.raises(ValueError):
        skt.Engine(cfg, device="cpu", num_pages=8, page_size=16, decode_burst=0)
    eng = skt.Engine(cfg, device="cpu", num_pages=8, page_size=16, prefill_chunk=32)
    assert eng.native is not None and eng.allocator.free == 7  # the prefix cache is on by default
    with pytest.raises(NotImplementedError):
        eng.add_request([1, 2], grammar=[0])

    class NoExtend(skt.LlamaAdapter):
        supports_extend = False

    # without an extend program the cache is off and chunking is refused
    eng = skt.Engine(cfg, device="cpu", num_pages=8, page_size=16, adapter=NoExtend(cfg, "cpu"))
    assert eng.native is None and len(eng.allocator.free) == 7
    with pytest.raises(ValueError):
        skt.Engine(cfg, device="cpu", num_pages=8, page_size=16, adapter=NoExtend(cfg, "cpu"), prefill_chunk=32)


def test_kernel_wrappers_count_launches():
    assert set(skt.launch_counts()) == {"w4a16_gemm", "rmsnorm", "rope_decode_fused_qkv", "rope_decode_fused",
                                        "paged_attention_decode_dma", "store_cache_all_layers", "flash_attention",
                                        "flash_attention_packed", "w4a16_grouped_mm", "bf16_grouped_mm",
                                        "mla_decode", "mla_decode_dma", "mla_qkv_prep", "fp8_paged_mqa_logits",
                                        "w4a16_gemm_dma", "paged_attention_decode", "sparse_attn_func",
                                        "fp8_blockwise_scaled_mm", "fp8_blockwise_scaled_grouped_mm",
                                        "qserve_w4a8_per_group_gemm"}
    skt.reset_launch_counts()
    x = torch.randn(3, 64)
    skt.rmsnorm(x, torch.ones(64))  # CPU tensor: the plain twin, no launch
    assert all(n == 0 for n in skt.launch_counts().values())


def test_option_launch_counters_and_adapters():
    """K7 / K9 count their launches by option (gpt-oss's sinks, window and
    soft cap) beside their plain ones, reset with the rest and moved by a
    decode graph's tally; adapter_for names an adapter for every served
    config type, the most specific first."""
    assert set(skt.option_launch_counts()) == {f"{k}_{o}" for k in ("flash_attention", "flash_attention_packed")
                                               for o in ("sinks", "window", "softcap")}
    skt.flash_attention.launches_by_option["window"] = 3
    skt.reset_launch_counts()
    assert not any(skt.option_launch_counts().values())
    from sgl_kernel_tpu_torch.serving import decode_graph

    counters = {(name, attr, key) for (name, attr, key), _ in decode_graph._counters()}
    assert ("flash_attention_packed", "launches_by_option", "sinks") in counters
    kinds = {type(skt.adapter_for(cfg, "cpu")).__name__ for cfg in (
        skt.LlamaConfig.tiny(), skt.LlamaConfig.tiny(qk_norm=True), skt.MixtralConfig.tiny(),
        skt.GptOssConfig.tiny(), skt.DeepseekConfig.tiny(), skt.HybridGdnConfig.tiny())}
    assert kinds == {"LlamaAdapter", "MixtralAdapter", "GptOssAdapter", "DeepseekAdapter", "HybridGdnAdapter"}


def test_kernel_sources_and_entry_points():
    """Every CUDA source is found by _build.sources(), exports the C entry point
    its wrapper binds, and returns cudaGetLastError(); library names follow
    the source bytes."""
    from sgl_kernel_tpu_torch import _build

    stems = {p.stem for p in _build.sources()}
    assert stems == {"decode_attention", "flash_packed", "flash_prefill", "store_cache", "w4a16_gemm",
                     "grouped_gemm", "bf16_grouped_gemm", "mla_decode", "mqa_logits",
                     "w4a16_gemm_dma", "blockwise_fp8", "qserve_gemm", "sparse_vs", "w4a16_decode",
                     "w4a16_grouped_decode", "w4a16_wgmma"}
    entry = {"decode_attention": "skt_paged_decode", "flash_packed": "skt_flash_packed",
             "flash_prefill": "skt_flash_prefill", "store_cache": "skt_store_cache_all_layers",
             "w4a16_gemm": "skt_w4a16_gemm", "grouped_gemm": "skt_w4a16_grouped_mm",
             "bf16_grouped_gemm": "skt_bf16_grouped_mm", "mla_decode": "skt_mla_decode",
             "mqa_logits": "skt_fp8_paged_mqa_logits",
             "w4a16_gemm_dma": "skt_w4a16_gemm_dma", "blockwise_fp8": "skt_fp8_blockwise_mm",
             "qserve_gemm": "skt_qserve_w4a8_per_group", "sparse_vs": "skt_sparse_attn",
             "w4a16_decode": "skt_w4a16_decode", "w4a16_grouped_decode": "skt_w4a16_grouped_decode",
             "w4a16_wgmma": "skt_w4a16_wgmma"}
    for src in _build.sources():
        text = src.read_text()
        assert f'extern "C" int {entry[src.stem]}(' in text
        assert "cudaGetLastError()" in text
        assert "sgl_kernel_tpu/ops/" in text  # the note naming the TPU kernel it replaces
        lib = _build._lib_path(src)
        assert lib.parent == _build.BUILD_DIR and lib.name.startswith(src.stem + "-")
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_deepseek_adapter_serves_the_plain_mode_only():
    """adapter_for picks the DeepSeek adapter by config type and the decode
    mode the config names: the plain mode over one latent pool, NSA over
    (latent, fp8 indexer keys, their float32 scales), compression over
    (latent, scores, rings of max_slots state slots) with state slots and no
    extend program; NSA and compression together raise."""
    cfg = skt.DeepseekConfig.tiny()
    ad = skt.adapter_for(cfg, "cpu")
    assert isinstance(ad, skt.DeepseekAdapter) and ad.supports_extend and not hasattr(ad._m, "mixed_step")
    assert ad.supports_spec  # a draft in front of the plain mode only
    (pool,) = ad.make_caches(4, 16)
    assert pool.shape == (cfg.num_layers, 4, 16, 576)
    ncfg = skt.DeepseekConfig.tiny(nsa=True, idx_dim=32)
    ad = skt.adapter_for(ncfg, "cpu")
    assert ad.use_nsa and not ad.supports_spec and ad.idx_rope_cache.shape == (ncfg.max_position, 32)
    pool, idx_k, idx_s = ad.make_caches(4, 16)
    assert idx_k.shape == (ncfg.num_layers * 4 * 16, 32) and idx_k.dtype == torch.float8_e4m3fn
    assert idx_s.shape == (ncfg.num_layers * 4 * 16,) and idx_s.dtype == torch.float32
    assert not ad.needs_state_slots
    ccfg = skt.DeepseekConfig.tiny(compress="c128", compress_ring=4)
    ad = skt.adapter_for(ccfg, "cpu")
    assert ad.use_compress and ad.needs_state_slots and not ad.supports_extend and not ad.supports_spec
    pool, scores, rings = ad.make_caches(4, 16, max_slots=5)
    assert pool.shape == scores.shape == (ccfg.num_layers, 4, 16, 576)
    assert rings.shape == (ccfg.num_layers, 5, 4, 576)
    with pytest.raises(ValueError):
        skt.adapter_for(skt.DeepseekConfig.tiny(compress="c4", nsa=True), "cpu")
    with pytest.raises(ValueError):
        skt.DeepseekAdapter(cfg, "cpu", use_compress=True)  # the config names no ratio


def test_slice8_exports_and_cpu_dispatch():
    """The names the JAX package exports from sparse_vs, gemm and
    moe.w4a8_grouped_mm are here; K16-K19's wrappers take their twins on CPU
    tensors without counting a launch."""
    names = ("build_vertical_slash_indexes", "convert_vertical_slash_indexes",
             "convert_vertical_slash_indexes_mergehead", "sparse_attention_vertical_slash", "sparse_attn_func",
             "sparse_attn_varlen_func", "awq_to_tpu_layout", "bmm_fp8", "fp4_group_mm", "fp4_scaled_mm",
             "fp8_blockwise_scaled_grouped_mm", "fp8_blockwise_scaled_mm", "prepare_blockwise_scales",
             "gptq_to_tpu_layout", "scaled_fp4_experts_quant", "scaled_fp4_quant", "fp8_scaled_mm", "int8_scaled_mm",
             "qserve_w4a8_per_chn_gemm", "qserve_w4a8_per_group_gemm", "quantize_w4", "w4a16_gemm",
             "w4a8_grouped_mm", "dsv3_router_gemm", "dsv3_fused_a_gemm")
    assert not [n for n in names if not callable(getattr(skt, n, None))]
    skt.reset_launch_counts()
    f8 = torch.float8_e4m3fn
    a, b = torch.ones(2, 128).to(f8), torch.ones(128, 128).to(f8)
    skt.fp8_blockwise_scaled_mm(a, b, torch.ones(2, 1), torch.ones(1, 1))
    skt.fp8_blockwise_scaled_grouped_mm(torch.ones(16, 128).to(f8), b[None], torch.ones(16, 1), torch.ones(1, 1, 1),
                                        torch.zeros(1, dtype=torch.int32), bm=16)
    skt.qserve_w4a8_per_group_gemm(torch.ones(2, 128, dtype=torch.int8), torch.ones(8, 128, dtype=torch.uint8),
                                   torch.zeros(8, 1), torch.ones(8, 1, dtype=torch.int8), torch.ones(8), torch.ones(2))
    q = torch.randn(1, 64, 2, 64)
    z = torch.zeros(1, 2, 1, dtype=torch.int32)
    skt.sparse_attn_func(q, q, q, z, torch.zeros(1, 2, 1, 1, dtype=torch.int32), z,
                         torch.zeros(1, 2, 1, 1, dtype=torch.int32))
    assert all(n == 0 for n in skt.launch_counts().values())


def test_head_dim_launch_counts():
    """K7 and K9 count their launches at head dim 576, and K7 at 256, apart
    from the rest; reset_launch_counts zeroes them, and CPU tensors (the
    plain twins) launch nothing."""
    skt.reset_launch_counts()
    for d, hkv in ((576, 1), (256, 2)):
        q, kv = torch.randn(1, 4, 16, d), torch.randn(1, 4, hkv, d)
        out = skt.flash_attention(q, kv, kv)
        assert out.shape == q.shape
    assert skt.head_dim_launch_counts() == {"flash_attention_576": 0, "flash_attention_packed_576": 0,
                                            "flash_attention_256": 0}
    skt.flash_attention.launches_576 = skt.flash_attention_packed.launches_576 = 3
    skt.flash_attention.launches_256 = 2
    skt.reset_launch_counts()
    assert set(skt.head_dim_launch_counts().values()) == {0}


def test_kept_buffer_keys_the_device_it_means():
    """Every spelling of one device finds the same kept buffer (a kernel
    writes the buffer of its tensors' device, and readers such as
    ``qserve.exact_route_blocks("cpu")`` name it as they like); a larger
    request makes a larger buffer, other kinds get their own."""
    from sgl_kernel_tpu_torch.ops.gemm import qserve
    from sgl_kernel_tpu_torch.utils import kept_buffer

    buf = kept_buffer("test_kept", "cpu", 8, torch.int32)
    assert buf is kept_buffer("test_kept", torch.device("cpu"), 8, torch.int32)
    assert buf.numel() >= 8 and int(buf.abs().sum()) == 0
    assert kept_buffer("test_kept_other", "cpu", 8, torch.int32) is not buf
    assert kept_buffer("test_kept", "cpu", buf.numel() + 1, torch.int32).numel() > buf.numel()
    counter = kept_buffer("qserve_exact_blocks", torch.device("cpu"), 1, torch.int32)
    counter[0] += 3
    try:
        assert qserve.exact_route_blocks("cpu") == int(counter[0])
    finally:
        counter[0] -= 3


def test_hybrid_gdn_modules_stand_alone():
    """The hybrid GDN slice's modules (ops/linear_attn, models/hybrid_gdn)
    import in a fresh interpreter without loading JAX or the JAX package,
    import neither in their source, and default every entry point's device
    to the card."""
    mods = ["sgl_kernel_tpu_torch.ops.linear_attn", "sgl_kernel_tpu_torch.models.hybrid_gdn"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'sgl_kernel_tpu.'))"
            " or m == 'sgl_kernel_tpu']\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    files = sorted((ROOT / "sgl_kernel_tpu_torch" / "ops" / "linear_attn").glob("*.py"))
    files.append(ROOT / "sgl_kernel_tpu_torch" / "models" / "hybrid_gdn.py")
    assert len(files) == 6
    pat = re.compile(r"^\s*(import|from)\s+(jax|sgl_kernel_tpu)([. ]|$)", re.M)
    assert not [f for f in files if pat.search(f.read_text())]
    from sgl_kernel_tpu_torch.models import hybrid_gdn
    from sgl_kernel_tpu_torch.serving.adapters import HybridGdnAdapter

    for fn in (hybrid_gdn.init_weights, hybrid_gdn.make_states, hybrid_gdn.make_caches,
               hybrid_gdn.build_rope_cache, HybridGdnAdapter.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
