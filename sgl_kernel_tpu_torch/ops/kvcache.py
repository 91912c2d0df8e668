"""Paged KV-cache stores.

Pools are page-major and layer-stacked, [L, P, Hkv, page, D]; a flat slot is
``page_id * page_size + offset`` and a slot < 0 (or past the pool) is
dropped. The JAX functions return new pools; these update the pools IN
PLACE (where the JAX model donates them) and return them.

``store_cache_all_layers`` is kernel K6, CUDA C++ in
``csrc/store_cache.cu``, replacing the Pallas ``store_cache_all_layers``
(sgl_kernel_tpu/ops/kvcache.py:193, pallas_call at :209);
``store_cache_all_layers_ref`` is its plain twin. The other stores are plain
PyTorch ``index_put_``, as the JAX package leaves them to XLA's scatter, and
none of them waits for the host (a dropped row is redirected, never removed
by a boolean index), so each may run inside a captured CUDA graph;
``store_cache_stacked`` (the prefill programs' per-layer store) keeps the last
of several writes to one slot:
``store_cache_head_major`` fills the head-major pools [H, P, page, D] of
``paged_attention_decode`` (K8), and ``move_cache_rows_stacked`` moves token
rows between slots across all layers (the speculative tree's fix-up).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build


def _page_major_slots(loc, p, h, page):
    """loc [T] flat slots -> flat [T, H] row ids in the [P*H*page] page-major
    view; loc < 0 maps to P*H*page (out of range, dropped)."""
    loc = loc.long()
    pid = torch.where(loc >= 0, loc // page, torch.full_like(loc, p))
    off = torch.where(loc >= 0, loc % page, torch.zeros_like(loc))
    heads = torch.arange(h, device=loc.device) * page
    return (pid * (h * page) + off)[:, None] + heads[None, :]


def _drop_scatter(flat, rows, vals):
    """flat[rows] = vals for rows in range; later rows win (in order). No
    wait for the host: a stable sort of the rows and a neighbour compare
    keep each row's last write, and ``_put_rows`` redirects every other
    (dropped or overwritten) one."""
    rows = rows.reshape(-1).long()
    n = rows.shape[0]
    if n == 0:
        return flat
    rows = torch.where((rows >= 0) & (rows < flat.shape[0]), rows, -1)
    srt, order = torch.sort(rows, stable=True)
    last = torch.cat([srt[:-1] != srt[1:], torch.ones(1, dtype=torch.bool, device=rows.device)])
    _put_rows(flat, torch.where(last & (srt >= 0), srt, -1), vals.reshape(n, -1).index_select(0, order))
    return flat


def store_cache_stacked(k, v, k_pool, v_pool, loc, layer_id):
    """Store k/v [T, H, D] into layer ``layer_id`` of the stacked pools at
    flat slots ``loc`` [T], in place. Returns (k_pool, v_pool)."""
    l, p, h, page, d = k_pool.shape
    slot = _page_major_slots(loc, p, h, page)
    slot = torch.where(slot < p * h * page, slot, torch.full_like(slot, -1))
    base = int(layer_id) * (p * h * page)
    rows = torch.where(slot >= 0, slot + base, torch.full_like(slot, -1))
    _drop_scatter(k_pool.view(l * p * h * page, d), rows, k)
    _drop_scatter(v_pool.view(l * p * h * page, d), rows, v)
    return k_pool, v_pool


def store_cache_mla(kv, pool, loc):
    """MLA single pool: latent rows kv [T, D] into pool [P, page, D] at flat
    slots ``loc`` [T], in place, cast to the pool's dtype; slots < 0 or past
    the pool are dropped (kvcache.py:242-248, where JAX scatters with plain
    jnp). A stacked [L, P, page, D] pool passed as its [L*P, page, D] view
    takes layer-offset slots. Returns the pool.

    The drop never waits for the host (a decode step stores every layer): a
    dropped row is redirected to the call's last kept row with that row's
    value (or, when nothing is kept, rewrites row 0 with itself), so one
    ``index_put_`` serves. A slot written twice by kept rows has no defined
    winner, as in XLA's scatter; the serving path never writes one twice."""
    p, page, d = pool.shape
    rows = loc.to(device=pool.device, dtype=torch.long).reshape(-1)
    rows = torch.where((rows >= 0) & (rows < p * page), rows, -1)
    _put_rows(pool.view(p * page, d), rows, kv.reshape(rows.shape[0], d))
    return pool


def _put_rows(flat, rows, vals):
    """flat[rows] = vals, in place, for rows >= 0, with no wait for the
    host: a dropped row (-1) is redirected to the call's last kept row with
    that row's value (or, when nothing is kept, rewrites row 0 with
    itself), so one ``index_put_`` serves."""
    if rows.numel() == 0:
        return
    # the rows move as integers of the pool's width (fp8 has no where/index_put)
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[flat.element_size()]
    vals = vals.to(flat.dtype).view(bits)
    flat = flat.view(bits)
    keep = rows >= 0
    # one-element index_select, not t[0-d tensor], which reads the index on the host
    last = torch.where(keep, torch.arange(rows.shape[0], device=rows.device), -1).max().clamp_min(0).reshape(1)
    any_kept = keep.any()
    fb_row = torch.where(any_kept, rows.index_select(0, last), 0)
    fb_val = torch.where(any_kept, vals.index_select(0, last), flat.index_select(0, fb_row))
    flat.index_put_((torch.where(keep, rows, fb_row),), torch.where(keep[:, None], vals, fb_val))


def store_cache_head_major(k, v, k_pool, v_pool, loc):
    """Head-major store (kvcache.py:71-81, a plain XLA scatter in JAX): k/v
    [T, H, D] into pools [H, P, page, D] (the layout of
    ``paged_attention_decode``, K8) at flat slots ``loc`` [T], in place, cast
    to the pools' dtype; slots < 0 or past the pool are dropped. A layer of
    a stacked [L, H, P, page, D] pool is passed as ``pool[layer]``. A slot
    written twice has no defined winner, as in XLA's scatter. Returns
    (k_pool, v_pool)."""
    h, p, page, d = k_pool.shape
    loc = loc.to(device=k_pool.device, dtype=torch.long).reshape(-1)
    heads = (torch.arange(h, device=k_pool.device) * (p * page))[None, :]
    rows = torch.where(((loc >= 0) & (loc < p * page))[:, None], loc[:, None] + heads, -1).reshape(-1)
    _put_rows(k_pool.view(h * p * page, d), rows, k.reshape(-1, d))
    _put_rows(v_pool.view(h * p * page, d), rows, v.reshape(-1, d))
    return k_pool, v_pool


def move_cache_rows_stacked(k_pool, v_pool, src_loc, dst_loc):
    """Copy token rows from flat slots ``src_loc`` to ``dst_loc`` [T] across
    every layer of the stacked page-major pools [L, P, H, page, D], in place
    (kvcache.py:98-119, a plain gather and scatter in JAX): the speculative
    tree's fix-up, which moves accepted nodes' rows to their position slots.
    A move whose src or dst is negative or past the pool is dropped. Every
    source row is read before any is written, so src and dst may overlap.
    Returns (k_pool, v_pool)."""
    l, p, h, page, d = k_pool.shape
    dev = k_pool.device
    src = src_loc.to(device=dev, dtype=torch.long).reshape(-1)
    dst = dst_loc.to(device=dev, dtype=torch.long).reshape(-1)
    ok = (src >= 0) & (src < p * page) & (dst >= 0) & (dst < p * page)
    lids = (torch.arange(l, device=dev) * (p * h * page))[:, None, None]
    rows_src = lids + _page_major_slots(src.clamp(0, p * page - 1), p, h, page)[None]  # [L, T, H]
    rows_dst = torch.where(ok[None, :, None], lids + _page_major_slots(dst.clamp_min(0), p, h, page)[None], -1)
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[k_pool.element_size()]
    for pool in (k_pool, v_pool):  # rows move as integers of the pool's width (fp8 has no gather)
        flat = pool.view(l * p * h * page, d).view(bits)
        _put_rows(flat, rows_dst.reshape(-1), flat[rows_src.reshape(-1)])
    return k_pool, v_pool


def store_cache_all_layers_ref(k_all, v_all, k_pool, v_pool, loc):
    """Plain PyTorch twin of ``store_cache_all_layers``."""
    l, p, h, page, d = k_pool.shape
    t = loc.shape[0]
    slot = _page_major_slots(loc, p, h, page)  # [T, H]
    in_range = ((loc >= 0) & (loc < p * page)).to(slot.device)
    layer_base = (torch.arange(l, device=slot.device) * (p * h * page))[:, None, None]
    rows = torch.where(in_range[None, :, None], layer_base + slot[None], torch.full_like(slot[None], -1))
    _drop_scatter(k_pool.view(l * p * h * page, d), rows, k_all.reshape(l, t, h, d))
    _drop_scatter(v_pool.view(l * p * h * page, d), rows, v_all.reshape(l, t, h, d))
    return k_pool, v_pool


_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


def store_cache_all_layers(k_all, v_all, k_pool, v_pool, loc):
    """Store one decode step's K/V for every layer, k_all/v_all
    [L, T, H, D], into the pools [L, P, H, page, D] at flat slots ``loc``
    [T], in place; tokens apply in order. CUDA tensors go through the K6
    kernel. Returns (k_pool, v_pool)."""
    if k_pool.device.type != "cuda":
        return store_cache_all_layers_ref(k_all, v_all, k_pool, v_pool, loc)
    l, p, h, page, d = k_pool.shape
    t = loc.shape[0]
    if k_all.shape != (l, t, h, d) or v_all.shape != (l, t, h, d):
        raise ValueError(f"store_cache_all_layers: k_all {tuple(k_all.shape)} for pools {tuple(k_pool.shape)} and {t} slots")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()) or v_pool.dtype != k_pool.dtype:
        raise ValueError("store_cache_all_layers: pools must be contiguous and of one dtype")
    row_bytes = d * k_pool.element_size()
    if row_bytes % 16:
        raise NotImplementedError(f"store_cache_all_layers: the CUDA kernel copies 16-byte lanes; a row is {row_bytes} B")
    ka = k_all.to(k_pool.dtype).contiguous()
    va = v_all.to(v_pool.dtype).contiguous()
    loc32 = loc.to(device=k_pool.device, dtype=torch.int32).contiguous()
    fn = _build.bind("store_cache", "skt_store_cache_all_layers", _ARGS)
    _build.check(fn(ka.data_ptr(), va.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    loc32.data_ptr(), l, t, h, p, page, row_bytes,
                    _build.stream_ptr(k_pool.device)), "store_cache_all_layers")
    store_cache_all_layers.launches += 1
    return k_pool, v_pool


store_cache_all_layers.launches = 0
