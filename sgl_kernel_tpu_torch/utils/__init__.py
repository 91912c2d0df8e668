"""Shared helpers: alignment arithmetic, device selection and the launch
planning shared by the split-K GEMM kernels.

The port's entry points run on the card unless the caller asks for the
CPU; ``resolve_device`` is the one place that decision is made.
"""

from __future__ import annotations

import functools

import torch


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


def next_power_of_2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of every
    entry point) raises when no card is present; the CPU is used only when
    the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sgl_kernel_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_kept = {}


def kept_buffer(kind: str, device, n: int, dtype) -> torch.Tensor:
    """A device buffer a kernel keeps across calls, one per (kind, device),
    at least ``n`` long and zero when first made: split counters that every
    launch leaves at zero, and workspaces each call rewrites before it reads
    them. Made once, so a captured CUDA graph keeps pointing at it and a TMA
    map of it is encoded once; a larger request makes a new buffer and keeps
    the old one alive for graphs captured on it.

    ``device`` may be a name or a device without an index (``"cuda"``): it
    is keyed as the device it means, so every spelling of one card finds the
    same buffer. One buffer serves every stream of its device: calls of a
    kernel that keeps one must be ordered (one stream, or streams joined by
    events), never in flight together."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    have = _kept.get((kind, device))
    if have is None or have[-1].numel() < n:
        _kept[(kind, device)] = (have or []) + [torch.zeros(max(n, 4096), dtype=dtype, device=device)]
    return _kept[(kind, device)][-1]


@functools.cache
def sm_count(index: int = 0) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (launch planning)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# output element kinds of the split-K GEMM kernels (csrc/gemm_out.cuh)
OUT_KIND = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def row_tile(m: int) -> int:
    """Rows of a split-K GEMM block for M rows: 16, 32, 64 or 128."""
    return 16 if m <= 16 else (32 if m <= 32 else (64 if m <= 64 else 128))
