"""The port's native serving runtime (its own copy of serving_native.cpp,
built into sgl_kernel_tpu_torch/_build/) against the JAX package's: the
same script of allocations, prefix inserts, matches, pins, edge splits,
evictions and table assembly must give identical results at every step."""

import numpy as np

from sgl_kernel_tpu.serving import native as jnative
from sgl_kernel_tpu_torch import _build
from sgl_kernel_tpu_torch.serving import native as tnative

PAGE = 4


def script(alloc_cls, rng):
    """Every call's result, in order."""
    a = alloc_cls(40, PAGE)
    log = [a.free]
    pa = a.alloc(6)
    toks_a = rng.integers(1, 50, 6 * PAGE).tolist()
    log += [pa, a.free, a.insert_prefix(toks_a, pa), a.cached_pages]
    # a second sequence sharing 2 pages then diverging: the insert splits
    # the edge and adopts only the new tail
    toks_b = toks_a[: 2 * PAGE] + rng.integers(50, 99, 3 * PAGE).tolist()
    pb = a.alloc(5)
    log += [pb, a.insert_prefix(toks_b, pa[:2] + pb[2:]), a.cached_pages]
    # matches: full, partial inside an edge (page-aligned), none
    log += [a.match_prefix(toks_a), a.match_prefix(toks_a[:9]), a.match_prefix(toks_b[:-1]),
            a.match_prefix([99, 98, 97, 96, 95])]
    m1 = a.match_prefix_locked(toks_a[: 5 * PAGE])
    m2 = a.match_prefix_locked(toks_b)
    log += [m1[:2], m2[:2]]
    # pinned paths survive eviction; what is unpinned goes LRU first
    log += [a.evict(3), a.free, a.cached_pages]
    a.unlock(m1[2])
    log += [a.evict(2), a.free, a.cached_pages]
    # a split while pinned keeps the pin exact: insert a third branch
    toks_c = toks_b[: 1 * PAGE] + rng.integers(1, 50, 2 * PAGE).tolist()
    pc = a.alloc(3)
    log += [pc, a.insert_prefix(toks_c, pb[:1] + pc[1:]), a.cached_pages]
    a.unlock(m2[2])
    log += [a.evict(100), a.free, a.cached_pages, a.match_prefix(toks_a)]
    a.release(pc[:1])
    log += [a.free, a.alloc(100), a.alloc(3)]
    log.append(a.assemble_tables([[3, 1, 2], [], [7] * 9], 6).tolist())
    return log


def test_native_allocator_matches_jax():
    jlog = script(jnative.NativeAllocator, np.random.default_rng(1))
    tlog = script(tnative.NativeAllocator, np.random.default_rng(1))
    assert len(jlog) == len(tlog)
    for i, (j, t) in enumerate(zip(jlog, tlog)):
        assert j == t, (i, j, t)


def test_native_library_is_the_ports_own():
    """Built from the port's source into its build directory, never the JAX
    package's csrc/libserving_native.so."""
    path = tnative.build()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("serving_native-")
    assert tnative.SOURCE.parent == _build.CSRC
    assert "libserving_native" not in str(path)
    a = tnative.NativeAllocator(8, 16)
    assert a.free == 7 and a.alloc(8) is None and a.alloc(7) == [1, 2, 3, 4, 5, 6, 7] and a.free == 0
