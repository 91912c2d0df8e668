"""Build and bind the hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled on first
use into its own shared library with ``nvcc`` for ``sm_90a`` (Hopper),
then bound with ``ctypes``: a few seconds a source, against minutes for a
build that includes PyTorch's headers. Libraries go to ``_build/`` inside
the package (listed in ``.gitignore``), named by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one is reused.
``build_all`` starts one ``nvcc`` per source, all at once.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; ``check`` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _start(src: Path, tmp: Path) -> subprocess.Popen:
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-o", str(tmp), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_all() -> Dict[str, str]:
    """Compile every source not yet built, one ``nvcc`` each, in parallel.
    Returns {source stem: compiler output} for the sources it compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sources():
        out = _lib_path(src)
        if not out.exists():
            # compile to a private name, then rename: a concurrent build
            # never loads a half-written library
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            jobs[src] = (out, tmp, _start(src, tmp))
    logs = {}
    failed = []
    for src, (out, tmp, proc) in jobs.items():
        text, _ = proc.communicate()
        logs[src.stem] = text
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


@functools.cache
def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed."""
    src = CSRC / f"{stem}.cu"
    out = _lib_path(src)
    if not out.exists():
        build_all()
    return ctypes.CDLL(str(out))


@functools.cache
def bind(stem: str, name: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """C entry point ``name`` of ``csrc/<stem>.cu`` with its argument types
    set (``c_void_p`` for every pointer and the stream)."""
    fn = getattr(library(stem), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
