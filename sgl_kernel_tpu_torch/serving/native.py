"""ctypes binding of the native serving runtime (csrc/serving_native.cpp):
a paged-KV page allocator with a radix prefix cache.

The source is the port's own copy, host C++ without CUDA. It is compiled on
first use with ``c++ -O2 -std=c++17 -shared -fPIC`` into ``_build/`` (listed
in ``.gitignore``), named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one is reused. There is no Python
fallback: ``build`` raises when the library cannot be compiled or loaded,
and the engine's prefix cache needs it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .._build import BUILD_DIR, CSRC

SOURCE = CSRC / "serving_native.cpp"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"serving_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    out = _lib_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("serving_native: no C++ compiler (c++ or g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"serving_native: {cxx} failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    sigs = {
        "sn_create": (i64, [i32, i32]),
        "sn_destroy": (None, [i64]),
        "sn_free_count": (i32, [i64]),
        "sn_alloc": (i32, [i64, i32, i32p]),
        "sn_release": (None, [i64, i32, i32p]),
        "sn_assemble_tables": (None, [i32, i32, i32p, i32p, i32p]),
        "sn_radix_match": (i32, [i64, i32p, i32, i32p, i32]),
        "sn_radix_insert": (i32, [i64, i32p, i32, i32p, i32]),
        "sn_radix_match_lock": (i32, [i64, i32p, i32, i32p, i32, ctypes.POINTER(i64)]),
        "sn_radix_unlock": (i32, [i64, i64]),
        "sn_radix_evict": (i32, [i64, i32]),
        "sn_radix_cached_pages": (i64, [i64]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _as_i32(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr, dtype=np.int32))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeAllocator:
    """Native paged-KV allocator with a radix prefix cache: the free-list
    semantics of ``engine.PageAllocator`` (page 0 reserved as the pad page)
    plus longest-prefix reuse of whole KV pages, all bookkeeping in C++.
    ``free`` is the number of free pages (an int, not a list)."""

    def __init__(self, num_pages: int, page_size: int):
        self._lib = _load()
        self._h = self._lib.sn_create(num_pages, page_size)
        self.num_pages = num_pages
        self.page_size = page_size

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.sn_destroy(self._h)

    @property
    def free(self) -> int:
        return int(self._lib.sn_free_count(self._h))

    def alloc(self, n: int) -> Optional[List[int]]:
        out = np.empty(n, np.int32)
        r = self._lib.sn_alloc(self._h, n, _ptr(out))
        return out.tolist() if r == n else None

    def release(self, pages: List[int]):
        arr = _as_i32(pages)
        self._lib.sn_release(self._h, len(pages), _ptr(arr))

    def assemble_tables(self, page_lists: List[List[int]], max_pages: int) -> np.ndarray:
        """[batch, max_pages] int32 page tables, zero-padded."""
        batch = len(page_lists)
        flat = _as_i32([p for lst in page_lists for p in lst])
        counts = _as_i32([len(lst) for lst in page_lists])
        out = np.zeros((batch, max_pages), np.int32)
        self._lib.sn_assemble_tables(batch, max_pages, _ptr(flat), _ptr(counts), _ptr(out))
        return out

    # ---- radix prefix cache ------------------------------------------
    def match_prefix(self, tokens: List[int]) -> Tuple[int, List[int]]:
        """Longest cached page-aligned prefix: (matched tokens, its pages)."""
        toks = _as_i32(tokens)
        out = np.empty(max(1, len(tokens) // self.page_size + 1), np.int32)
        n = self._lib.sn_radix_match(self._h, _ptr(toks), len(tokens), _ptr(out), len(out))
        return int(n), out[: n // self.page_size].tolist()

    def match_prefix_locked(self, tokens: List[int]) -> Tuple[int, List[int], int]:
        """match_prefix that also pins the matched path against eviction.
        Returns (matched tokens, pages, lock_id); ``unlock(lock_id)``
        releases exactly that pin, even after later edge splits."""
        toks = _as_i32(tokens)
        out = np.empty(max(1, len(tokens) // self.page_size + 1), np.int32)
        lock_id = ctypes.c_int64(0)
        n = self._lib.sn_radix_match_lock(self._h, _ptr(toks), len(tokens), _ptr(out), len(out),
                                          ctypes.byref(lock_id))
        return int(n), out[: n // self.page_size].tolist(), int(lock_id.value)

    def unlock(self, lock_id: int):
        self._lib.sn_radix_unlock(self._h, lock_id)

    def insert_prefix(self, tokens: List[int], pages: List[int]) -> int:
        """Insert a page-aligned token prefix with its pages; the cache owns
        the pages it adopts. Returns the number of newly adopted pages (the
        tail of ``pages``)."""
        toks = _as_i32(tokens)
        pg = _as_i32(pages)
        return int(self._lib.sn_radix_insert(self._h, _ptr(toks), len(tokens), _ptr(pg), len(pages)))

    def evict(self, want_pages: int) -> int:
        """Free least-recently-used unpinned cached pages until ``want_pages``
        are back on the free list; returns the number freed."""
        return int(self._lib.sn_radix_evict(self._h, want_pages))

    @property
    def cached_pages(self) -> int:
        return int(self._lib.sn_radix_cached_pages(self._h))
