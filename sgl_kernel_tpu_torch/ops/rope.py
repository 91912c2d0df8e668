"""Rotary position embedding.

``compute_cos_sin_cache`` builds the [max_pos, rot] = [cos | sin] float32
cache of the JAX package; ``rotary_embedding`` (prefill) is plain PyTorch,
and ``fused_qk_norm_rope`` (Qwen3's per-head q / k norm, then RoPE, over
packed qkv) is K2 and ``rotary_embedding``.
``rope_decode_fused_qkv`` is kernel K3, a Triton kernel that replaces the
Pallas ``rope_decode_fused_qkv`` (sgl_kernel_tpu/ops/rope.py:228,
pallas_call at :243); ``rope_decode_fused_qkv_ref`` is its plain twin.

Kernel note (K3). Bound: bytes: one read of the unsplit qkv row and of the
cache row at each position, one write of q, k and v; a few flops a byte.
Design: one Triton program per (token, head) over the [q | k | v] heads of
the fused GEMM output. q and k heads rotate the neox halves of their first
``rot`` dims (the partner half comes from a second, shifted load of the
same row), dims at or past ``rot`` pass through, v heads are copied. The
TPU kernel's three BlockSpecs over one array become three output pointers.

``rope_decode_fused`` is kernel K4, a Triton kernel that replaces the Pallas
``rope_decode_fused`` (sgl_kernel_tpu/ops/rope.py:360, pallas_call at :369);
``rope_decode_fused_ref`` is its plain twin. It serves the decode steps
whose q, k and v come from separate GEMMs (Mixtral, the ``fused=False``
Llama).

Kernel note (K4). Bound: bytes: one read of q [B, Hq, D] and k [B, Hkv, D]
and of the cache row at each position, one write of both; a few flops a
byte. Design: K3's, one Triton program per (token, head) over the q heads
then the k heads, the partner half by a second, shifted load of the same
row; dims at or past ``rot`` pass through. The TPU kernel's scalar-prefetched
cache row becomes a gather at ``positions[b]`` inside the program.

``mla_qkv_prep`` is kernel K14, a Triton kernel that replaces the Pallas
``mla_qkv_prep`` (sgl_kernel_tpu/ops/rope.py:295, pallas_call at :312);
``mla_qkv_prep_ref`` is its plain twin.

Kernel note (K14). Bound: bytes: one read of the decode tokens' q rows
[T, nh, nope + rot] and wkv_a rows [T, lat + rot], of the layer's norm
weight and the cache rows at their positions; one write of q_nope, q_pe and
the cache row [T, lat + rot]. Design: one Triton program per (token, head)
copies the head's nope part and ropes its pe part (the partner half by a
second, shifted load), and one more program per token takes the latent's
mean square in one in-register reduction, scales it by the layer's weight
(the stacked [L, lat] weight indexed by ``layer_id`` without a copy) and
ropes k_pe into the 576-wide row. The JAX rounding points are kept: float32
math, one cast to q's / kv's dtype.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..utils import next_power_of_2, resolve_device


def compute_cos_sin_cache(
    rotary_dim: int,
    max_position: int,
    base: float = 10000.0,
    *,
    scaling_factor: float = 1.0,
    low_freq_factor: Optional[float] = None,
    high_freq_factor: Optional[float] = None,
    original_max_position: Optional[int] = None,
    attention_factor: float = 1.0,
    dtype=torch.float32,
    device="cuda",
):
    """[max_position, rotary_dim] cache = [cos | sin], computed in float32
    (llama3 frequency scaling when low/high_freq_factor are set), on
    ``device``: the card unless the caller names the CPU."""
    device = resolve_device(device)
    inv_freq = 1.0 / (base ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32) / rotary_dim))
    if low_freq_factor is not None:
        if high_freq_factor is None or original_max_position is None:
            raise ValueError("llama3 scaling needs both freq factors and original_max_position")
        omax = float(original_max_position)
        low_wl = omax / low_freq_factor
        high_wl = omax / high_freq_factor
        wavelen = 2.0 * torch.pi / inv_freq
        smooth = (omax / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
        inv_freq = torch.where(
            wavelen < high_wl,
            inv_freq,
            torch.where(wavelen > low_wl, inv_freq / scaling_factor,
                        (1 - smooth) * inv_freq / scaling_factor + smooth * inv_freq),
        )
    elif scaling_factor != 1.0:
        inv_freq = inv_freq / scaling_factor
    t = torch.arange(max_position, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    cache = torch.cat([torch.cos(freqs) * attention_factor, torch.sin(freqs) * attention_factor], dim=-1)
    return cache.to(dtype=dtype, device=device)


def _rotate_neox(x, cos, sin):
    """Neox rotate-half of the first 2*cos.shape[-1] dims of x [..., D] in
    float32; the rest passes through. cos/sin broadcast against x."""
    rot = 2 * cos.shape[-1]
    half = rot // 2
    xf = x[..., :rot].float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, x[..., rot:]], dim=-1) if x.shape[-1] > rot else out


def rotary_embedding(positions, query, key, head_size: int, cos_sin_cache, is_neox: bool = True):
    """Neox RoPE on query/key at ``positions`` [T]; query [T, Hq*head_size]
    or [T, Hq, head_size], key likewise. Returns (query, key) in their
    input shapes."""
    if not is_neox:
        raise NotImplementedError("rotary_embedding: only the neox layout is ported")
    rot = cos_sin_cache.shape[-1]
    cs = cos_sin_cache[positions.long()].float()
    cos = cs[:, None, : rot // 2]
    sin = cs[:, None, rot // 2:]

    def apply(x):
        if x is None:
            return None
        xh = x.reshape(x.shape[0], -1, head_size)
        return _rotate_neox(xh, cos, sin).reshape(x.shape)

    return apply(query), apply(key)


def fused_qk_norm_rope(qkv, num_heads_q: int, num_heads_k: int, num_heads_v: int, head_dim: int, q_weight, k_weight,
                       positions, cos_sin_cache, *, eps: float = 1e-6, is_neox: bool = True):
    """Per-head RMSNorm on q and k, then RoPE, over packed qkv [T, (Hq + Hk
    + Hv) * D] (sgl_kernel_tpu/ops/rope.py:168-194, the functional form of an
    in-place fused op). Returns the new qkv. No kernel of its own: the norm
    is K2 over [T, H, D] rows, the rotation ``rotary_embedding``."""
    from .norm import rmsnorm

    t = qkv.shape[0]
    nq, nk = num_heads_q * head_dim, num_heads_k * head_dim
    q, k, v = qkv[:, :nq], qkv[:, nq:nq + nk], qkv[:, nq + nk:]
    if v.shape[-1] != num_heads_v * head_dim:
        raise ValueError(f"fused_qk_norm_rope: qkv {tuple(qkv.shape)} for {num_heads_q}+{num_heads_k}+"
                         f"{num_heads_v} heads of {head_dim}")
    q = rmsnorm(q.reshape(t, num_heads_q, head_dim), q_weight, eps).reshape(t, -1)
    k = rmsnorm(k.reshape(t, num_heads_k, head_dim), k_weight, eps).reshape(t, -1)
    q, k = rotary_embedding(positions, q, k, head_dim, cos_sin_cache, is_neox)
    return torch.cat([q, k, v], dim=-1)


def rope_decode_fused_qkv_ref(positions, qkv, cos_sin_cache, *, num_q: int, num_kv: int, head_dim: int):
    """Plain PyTorch twin of ``rope_decode_fused_qkv``."""
    b = qkv.shape[0]
    qkv3 = qkv.reshape(b, num_q + 2 * num_kv, head_dim)
    rot = cos_sin_cache.shape[-1]
    cs = cos_sin_cache[positions.long()].float()
    cos = cs[:, None, : rot // 2]
    sin = cs[:, None, rot // 2:]
    q = _rotate_neox(qkv3[:, :num_q], cos, sin)
    k = _rotate_neox(qkv3[:, num_q:num_q + num_kv], cos, sin)
    v = qkv3[:, num_q + num_kv:].clone()
    return q, k, v


@functools.cache
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def rope_qkv_kernel(pos_ptr, qkv_ptr, cache_ptr, q_ptr, k_ptr, v_ptr,
                        NQ: tl.constexpr, NKV: tl.constexpr, D: tl.constexpr,
                        ROT: tl.constexpr, BLOCK: tl.constexpr):
        b = tl.program_id(0).to(tl.int64)
        hd = tl.program_id(1)
        HALF: tl.constexpr = ROT // 2
        cols = tl.arange(0, BLOCK)
        inrow = cols < D
        row = qkv_ptr + (b * (NQ + 2 * NKV) + hd) * D
        x = tl.load(row + cols, mask=inrow, other=0.0)
        if hd < NQ + NKV:
            pos = tl.load(pos_ptr + b).to(tl.int64)
            rotm = cols < ROT
            first = cols < HALF
            fi = tl.where(first, cols, cols - HALF)
            partner = tl.where(first, cols + HALF, cols - HALF)
            xp = tl.load(row + partner, mask=rotm, other=0.0).to(tl.float32)
            cos = tl.load(cache_ptr + pos * ROT + fi, mask=rotm, other=0.0)
            sin = tl.load(cache_ptr + pos * ROT + HALF + fi, mask=rotm, other=0.0)
            xf = x.to(tl.float32)
            y = tl.where(first, xf * cos - xp * sin, xf * cos + xp * sin)
            y = tl.where(rotm, y.to(x.dtype), x)
            if hd < NQ:
                tl.store(q_ptr + (b * NQ + hd) * D + cols, y, mask=inrow)
            else:
                tl.store(k_ptr + (b * NKV + hd - NQ) * D + cols, y, mask=inrow)
        else:
            tl.store(v_ptr + (b * NKV + hd - NQ - NKV) * D + cols, x, mask=inrow)

    return rope_qkv_kernel


def rope_decode_fused_qkv(positions, qkv, cos_sin_cache, *, num_q: int, num_kv: int, head_dim: int):
    """Split the unsplit fused-qkv GEMM output [B, (num_q + 2*num_kv) * D]
    and apply neox RoPE to q and k at ``positions`` [B] (cache row
    positions[b]). Returns (q [B, Hq, D] roped, k [B, Hkv, D] roped,
    v [B, Hkv, D]). CUDA tensors go through the Triton kernel."""
    b = qkv.shape[0]
    if qkv.shape[1] != (num_q + 2 * num_kv) * head_dim:
        raise ValueError(f"rope_decode_fused_qkv: qkv {tuple(qkv.shape)} for {num_q}+2x{num_kv} heads of {head_dim}")
    rot = cos_sin_cache.shape[-1]
    if rot > head_dim or rot % 2:
        raise ValueError(f"rope_decode_fused_qkv: cache width {rot} for head_dim {head_dim}")
    if qkv.device.type != "cuda":
        return rope_decode_fused_qkv_ref(positions, qkv, cos_sin_cache,
                                         num_q=num_q, num_kv=num_kv, head_dim=head_dim)
    if not qkv.is_contiguous() or cos_sin_cache.dtype != torch.float32:
        raise ValueError("rope_decode_fused_qkv: qkv must be contiguous and the cache float32")
    q = torch.empty((b, num_q, head_dim), dtype=qkv.dtype, device=qkv.device)
    k = torch.empty((b, num_kv, head_dim), dtype=qkv.dtype, device=qkv.device)
    v = torch.empty((b, num_kv, head_dim), dtype=qkv.dtype, device=qkv.device)
    if b:
        _triton_kernel()[(b, num_q + 2 * num_kv)](
            positions.to(torch.int32).contiguous(), qkv, cos_sin_cache.contiguous(), q, k, v,
            NQ=num_q, NKV=num_kv, D=head_dim, ROT=rot, BLOCK=next_power_of_2(head_dim),
            num_warps=1)
        rope_decode_fused_qkv.launches += 1
    return q, k, v


rope_decode_fused_qkv.launches = 0


def rope_decode_fused_ref(positions, q, k, cos_sin_cache):
    """Plain PyTorch twin of ``rope_decode_fused``."""
    rot = cos_sin_cache.shape[-1]
    cs = cos_sin_cache[positions.long()].float()
    cos, sin = cs[:, None, : rot // 2], cs[:, None, rot // 2:]
    return _rotate_neox(q, cos, sin), _rotate_neox(k, cos, sin)


@functools.cache
def _rope_decode_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def rope_decode_kernel(pos_ptr, q_ptr, k_ptr, cache_ptr, qo_ptr, ko_ptr,
                           NQ: tl.constexpr, NKV: tl.constexpr, D: tl.constexpr,
                           ROT: tl.constexpr, BLOCK: tl.constexpr):
        b = tl.program_id(0).to(tl.int64)
        hd = tl.program_id(1)
        HALF: tl.constexpr = ROT // 2
        cols = tl.arange(0, BLOCK)
        inrow = cols < D
        if hd < NQ:
            src = q_ptr + (b * NQ + hd) * D
            dst = qo_ptr + (b * NQ + hd) * D
        else:
            src = k_ptr + (b * NKV + hd - NQ) * D
            dst = ko_ptr + (b * NKV + hd - NQ) * D
        x = tl.load(src + cols, mask=inrow, other=0.0)
        pos = tl.load(pos_ptr + b).to(tl.int64)
        rotm = cols < ROT
        first = cols < HALF
        fi = tl.where(first, cols, cols - HALF)
        partner = tl.where(first, cols + HALF, cols - HALF)
        xp = tl.load(src + partner, mask=rotm, other=0.0).to(tl.float32)
        cos = tl.load(cache_ptr + pos * ROT + fi, mask=rotm, other=0.0)
        sin = tl.load(cache_ptr + pos * ROT + HALF + fi, mask=rotm, other=0.0)
        xf = x.to(tl.float32)
        y = tl.where(first, xf * cos - xp * sin, xf * cos + xp * sin)
        tl.store(dst + cols, tl.where(rotm, y.to(x.dtype), x), mask=inrow)

    return rope_decode_kernel


def rope_decode_fused(positions, q, k, cos_sin_cache):
    """Neox RoPE at decode on split q [B, Hq, D] and k [B, Hkv, D] at
    ``positions`` [B] (cache row positions[b]): the first ``rot`` dims
    rotate in float32 and round once to the input dtype, the rest pass
    through. Returns (q, k) roped, new tensors. CUDA tensors go through the
    Triton kernel (K4)."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    rot = cos_sin_cache.shape[-1]
    if k.shape[0] != b or k.shape[2] != d or rot > d or rot % 2:
        raise ValueError(f"rope_decode_fused: q {tuple(q.shape)} k {tuple(k.shape)} cache width {rot}")
    if q.device.type != "cuda":
        return rope_decode_fused_ref(positions, q, k, cos_sin_cache)
    if cos_sin_cache.dtype != torch.float32 or q.dtype != k.dtype:
        raise ValueError("rope_decode_fused: q and k of one dtype and a float32 cache")
    q, k = q.contiguous(), k.contiguous()
    qo, ko = torch.empty_like(q), torch.empty_like(k)
    if b:
        _rope_decode_kernel()[(b, hq + hkv)](
            positions.to(torch.int32).contiguous(), q, k, cos_sin_cache.contiguous(), qo, ko,
            NQ=hq, NKV=hkv, D=d, ROT=rot, BLOCK=next_power_of_2(d), num_warps=1)
        rope_decode_fused.launches += 1
    return qo, ko


rope_decode_fused.launches = 0


def mla_qkv_prep_ref(positions, layer_id, q, kv, kv_norm_w, cos_sin_cache, *, nope_dim: int, eps: float = 1e-6):
    """Plain PyTorch twin of ``mla_qkv_prep``."""
    rot = cos_sin_cache.shape[-1]
    lat = kv.shape[-1] - rot
    cs = cos_sin_cache[positions.long()].float()
    cos, sin = cs[:, None, : rot // 2], cs[:, None, rot // 2:]
    q_nope = q[..., :nope_dim].clone()
    q_pe = _rotate_neox(q[..., nope_dim:], cos, sin)
    x = kv[:, :lat].float()
    ms = (x * x).mean(-1, keepdim=True)
    latn = (x * torch.rsqrt(ms + eps)) * kv_norm_w[int(layer_id)].float()[None, :]
    k_pe = _rotate_neox(kv[:, None, lat:], cos, sin)[:, 0]
    return q_nope, q_pe, torch.cat([latn.to(kv.dtype), k_pe], dim=-1)


@functools.cache
def _mla_prep_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def mla_prep_kernel(pos_ptr, q_ptr, kv_ptr, w_ptr, cache_ptr, qn_ptr, qpe_ptr, row_ptr, eps,
                        NH: tl.constexpr, NOPE: tl.constexpr, ROT: tl.constexpr, LAT: tl.constexpr,
                        BNOPE: tl.constexpr, BLAT: tl.constexpr):
        t = tl.program_id(0).to(tl.int64)
        h = tl.program_id(1)
        HALF: tl.constexpr = ROT // 2
        pos = tl.load(pos_ptr + t).to(tl.int64)
        rc = tl.arange(0, ROT)
        first = rc < HALF
        fi = tl.where(first, rc, rc - HALF)
        partner = tl.where(first, rc + HALF, rc - HALF)
        cos = tl.load(cache_ptr + pos * ROT + fi)
        sin = tl.load(cache_ptr + pos * ROT + HALF + fi)
        if h < NH:
            src = q_ptr + (t * NH + h) * (NOPE + ROT)
            nc = tl.arange(0, BNOPE)
            nm = nc < NOPE
            tl.store(qn_ptr + (t * NH + h) * NOPE + nc, tl.load(src + nc, mask=nm), mask=nm)
            pe = tl.load(src + NOPE + rc)
            pe_p = tl.load(src + NOPE + partner).to(tl.float32)
            pe_f = pe.to(tl.float32)
            pe_r = tl.where(first, pe_f * cos - pe_p * sin, pe_f * cos + pe_p * sin)
            tl.store(qpe_ptr + (t * NH + h) * ROT + rc, pe_r.to(pe.dtype))
        else:
            row = kv_ptr + t * (LAT + ROT)
            lc = tl.arange(0, BLAT)
            lm = lc < LAT
            lat = tl.load(row + lc, mask=lm, other=0.0)
            lat_f = lat.to(tl.float32)
            ms = tl.sum(lat_f * lat_f, axis=0) / LAT
            w = tl.load(w_ptr + lc, mask=lm, other=0.0).to(tl.float32)
            lat_n = (lat_f * (1.0 / tl.sqrt(ms + eps))) * w
            tl.store(row_ptr + t * (LAT + ROT) + lc, lat_n.to(lat.dtype), mask=lm)
            kp = tl.load(row + LAT + rc)
            kp_p = tl.load(row + LAT + partner).to(tl.float32)
            kp_f = kp.to(tl.float32)
            kp_r = tl.where(first, kp_f * cos - kp_p * sin, kp_f * cos + kp_p * sin)
            tl.store(row_ptr + t * (LAT + ROT) + LAT + rc, kp_r.to(kp.dtype))

    return mla_prep_kernel


def mla_qkv_prep(positions, layer_id, q, kv, kv_norm_w, cos_sin_cache, *, nope_dim: int, eps: float = 1e-6):
    """Fused MLA decode qkv prep. q [T, nh, nope + rot]; kv [T, lat + rot]
    (the wkv_a output); kv_norm_w [L, lat] (row ``layer_id``);
    cos_sin_cache [max_pos, rot] float32. Returns (q_nope [T, nh, nope],
    q_pe [T, nh, rot] roped, kv_row [T, lat + rot]: the latent rmsnormed,
    k_pe roped). CUDA tensors go through the Triton kernel (K14), which
    takes a power-of-two ``rot``."""
    t, nh, dq = q.shape
    rot = cos_sin_cache.shape[-1]
    lat = kv.shape[-1] - rot
    if dq != nope_dim + rot or kv.shape[0] != t or kv_norm_w.shape[-1] != lat:
        raise ValueError(f"mla_qkv_prep: q {tuple(q.shape)} kv {tuple(kv.shape)} for nope {nope_dim}, rot {rot}")
    if q.device.type != "cuda":
        return mla_qkv_prep_ref(positions, layer_id, q, kv, kv_norm_w, cos_sin_cache, nope_dim=nope_dim, eps=eps)
    if rot & (rot - 1) or not (q.is_contiguous() and kv.is_contiguous()) or cos_sin_cache.dtype != torch.float32:
        raise ValueError("mla_qkv_prep: the kernel takes contiguous q and kv, a power-of-two rot and a float32 cache")
    w = kv_norm_w[int(layer_id)]
    q_nope = torch.empty((t, nh, nope_dim), dtype=q.dtype, device=q.device)
    q_pe = torch.empty((t, nh, rot), dtype=q.dtype, device=q.device)
    row = torch.empty((t, lat + rot), dtype=kv.dtype, device=kv.device)
    if t:
        _mla_prep_kernel()[(t, nh + 1)](
            positions.to(torch.int32).contiguous(), q, kv, w.contiguous(), cos_sin_cache.contiguous(), q_nope,
            q_pe, row, float(eps), NH=nh, NOPE=nope_dim, ROT=rot, LAT=lat, BNOPE=next_power_of_2(nope_dim),
            BLAT=next_power_of_2(lat), num_warps=4)
        mla_qkv_prep.launches += 1
    return q_nope, q_pe, row


mla_qkv_prep.launches = 0
