"""W4A16 GEMM (int4 / MXFP4 weights, 16-bit activations) and its layouts.

``w4a16_gemm`` is kernel K1, CUDA C++ replacing the Pallas ``w4a16_gemm``
(sgl_kernel_tpu/ops/gemm/w4a16.py:301, pallas_call at :539 and :551):
decode rows (M <= 32) on ``csrc/w4a16_decode.cu``, prefill rows (M > 32) on
the wgmma tile of ``csrc/w4a16_wgmma.cu``, and weights TMA cannot map (N %
16 != 0, unaligned, or a packed K that is not a multiple of 128) on the
mma.sync tile of ``csrc/w4a16_gemm.cu``; ``route`` names the choice.
``w4a16_gemm_ref`` is its plain PyTorch twin
(dequantize, then one f32 product per scale group, chunked over N so a
lm_head-sized call stays a few hundred MB on the CPU).

Layouts (the JAX package's, byte for byte):
  packed  uint8 [K//2, N]: byte (r, n) = code(2r, n) | code(2r+1, n) << 4,
          two's-complement int4 or an e2m1 bit pattern (mxfp4)
  scales  bf16 [K//G, N]
  zeros   bf16 [K//G, N], the z*s pre-product (asymmetric int4)
  stacked [L, ...] of each, one layer picked by ``layer_id``
The host-side converters (quantize_w4, dequant_w4, the AWQ / GPTQ / MXFP4
layout converters) are plain PyTorch and run on any device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ... import _build
from ...utils import cdiv, kept_buffer, round_up, sm_count
from ..quant.formats import awq_unpack_int32, unpack_int4

GROUPS_PER_KTILE = 8  # quantize_w4 pads a ragged K to a multiple of 8 groups

# e2m1 values of the 16 codes (sign in bit 3)
_E2M1 = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)

# columns per chunk of the plain twin's dequantized weights
_REF_COLS = 8192


def _m_bucket(m: int) -> int:
    """0 = decode (M <= 32), 1 = small prefill (M <= 256), 2 = large prefill."""
    return 0 if m <= 32 else (1 if m <= 256 else 2)


# ---------------------------------------------------------------------------
# Weight preparation
# ---------------------------------------------------------------------------


def pack_w4_tpu(codes: torch.Tensor) -> torch.Tensor:
    """Logical 4-bit codes [K, N] (0..15; signed int4 as two's complement)
    -> the K-paired uint8 layout [K//2, N]."""
    c = codes.to(torch.uint8)
    return ((c[0::2] & 0xF) | ((c[1::2] & 0xF) << 4)).contiguous()


def unpack_w4_tpu(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_w4_tpu -> uint8 codes [K, N] (0..15)."""
    k2, n = packed.shape
    return torch.stack([packed & 0xF, packed >> 4], dim=1).reshape(2 * k2, n)


def quantize_w4(w: torch.Tensor, *, group_size: int = 128, symmetric: bool = True):
    """Quantize a float weight [N, K] into the kernel's layouts: (packed uint8
    [K//2, N], scales bf16 [K//G, N], zeros_x_scales bf16 [K//G, N] or None).
    The scale is rounded to bf16 before the codes are fitted against it,
    and codes round half to even, as in the JAX function (w4a16.py:643-660).
    A K that is not a group multiple is zero-padded to a multiple of 8
    groups."""
    n, k = w.shape
    wf = w.float()
    if k % group_size:
        kp = round_up(k, GROUPS_PER_KTILE * group_size)
        wf = F.pad(wf, (0, kp - k))
        k = kp
    wf = wf.reshape(n, k // group_size, group_size)
    if symmetric:
        amax = torch.clamp_min(wf.abs().amax(-1, keepdim=True), 1e-10)
        scale = (amax / 7.0).to(torch.bfloat16).float()
        codes = torch.clamp(torch.round(wf / scale), -8, 7).to(torch.int32)
        codes = torch.where(codes < 0, codes + 16, codes).to(torch.uint8).reshape(n, k)
        return pack_w4_tpu(codes.T), scale[..., 0].T.to(torch.bfloat16).contiguous(), None
    wmin = wf.amin(-1, keepdim=True)
    wmax = wf.amax(-1, keepdim=True)
    scale = torch.clamp_min((wmax - wmin) / 15.0, 1e-10).to(torch.bfloat16).float()
    zero = torch.round(-wmin / scale)
    codes = torch.clamp(torch.round(wf / scale) + zero, 0, 15).to(torch.int32).reshape(n, k)
    # the kernel decodes signed nibbles: (c_u - z) s = ((c_u - 8) - (z - 8)) s
    codes_signed = ((codes - 8) & 0xF).to(torch.uint8)
    s_t = scale[..., 0].T.to(torch.bfloat16).contiguous()
    z_t = ((zero[..., 0] - 8.0) * scale[..., 0]).T.to(torch.bfloat16).contiguous()
    return pack_w4_tpu(codes_signed.T), s_t, z_t


def awq_to_tpu_layout(qweight, scales, qzeros, *, group_size: int = 128):
    """AWQ checkpoint (qweight [K, N//8] int32, scales [K//G, N], qzeros
    [K//G, N//8] int32) -> (packed uint8 [K//2, N], scales bf16, zeros_x_scales
    bf16)."""
    codes_kn = awq_unpack_int32(qweight).to(torch.int32)
    zeros_gn = awq_unpack_int32(qzeros).float()
    packed = pack_w4_tpu(((codes_kn - 8) & 0xF).to(torch.uint8))
    s = scales.float()
    return packed, s.to(torch.bfloat16), ((zeros_gn - 8.0) * s).to(torch.bfloat16)


def gptq_to_tpu_layout(qweight, qzeros, scales, g_idx=None, *, group_size: int = 128):
    """GPTQ checkpoint (qweight [K//8, N] int32 with 8 codes along K a word,
    qzeros [K//G, N//8] int32 storing zero - 1, scales [K//G, N]) -> (packed
    uint8 [K//2, N], scales bf16, zeros_x_scales bf16, perm int32 [K] or
    None). With ``g_idx`` (desc_act) the weight rows are de-permuted so the
    groups are contiguous; the caller gathers the activations a[:, perm]."""
    kdiv8, n = qweight.shape
    k = kdiv8 * 8
    shifts = torch.arange(8, device=qweight.device, dtype=torch.int64) * 4
    qw = qweight.to(torch.int64) & 0xFFFFFFFF
    qz = qzeros.to(torch.int64) & 0xFFFFFFFF
    codes_kn = ((qw[:, None, :] >> shifts[None, :, None]) & 0xF).reshape(k, n)
    zeros_gn = ((qz[:, :, None] >> shifts[None, None, :]) & 0xF).reshape(-1, n).float() + 1.0
    s = scales.float()
    perm = None
    if g_idx is not None:
        perm = torch.argsort(g_idx.to(torch.int32), stable=True).to(torch.int32)
        codes_kn = codes_kn[perm.long()]
    packed = pack_w4_tpu(((codes_kn - 8) & 0xF).to(torch.uint8))
    return packed, s.to(torch.bfloat16), ((zeros_gn - 8.0) * s).to(torch.bfloat16), perm


def mxfp4_to_tpu_layout(q_packed, scale_bytes):
    """MXFP4 bytes [N, K//2] (adjacent-pair nibbles) + UE8M0 scales
    [N, K//32] -> (packed uint8 [K//2, N], scales bf16 [K//32, N]); the
    power-of-two scales are exact in bf16."""
    codes = unpack_int4(q_packed)
    scales = torch.exp2(scale_bytes.float() - 127.0).T.to(torch.bfloat16)
    return pack_w4_tpu(codes.T), scales


def _codes_f32(packed: torch.Tensor, fmt: str) -> torch.Tensor:
    """Packed [K//2, n] -> unscaled code values [K, n] in float32."""
    codes = unpack_w4_tpu(packed)
    if fmt == "mxfp4":
        return torch.tensor(_E2M1, device=packed.device)[codes.int()]
    return ((codes << 4).view(torch.int8) >> 4).float()  # sign-extend the nibble


def dequant_w4(w, scales, zeros=None, *, group_size: int = 128, fmt: str = "int4", dtype=torch.bfloat16):
    """Plain dequantization of the kernel layout -> [N, K] ``dtype``."""
    codes = _codes_f32(w, fmt).T
    n, k = codes.shape
    s = scales.float().T.reshape(n, k // group_size, 1)
    wf = codes.reshape(n, k // group_size, group_size) * s
    if zeros is not None and fmt != "mxfp4":
        wf = wf - zeros.float().T.reshape(n, k // group_size, 1)
    return wf.reshape(n, k).to(dtype)


# ---------------------------------------------------------------------------
# The GEMM
# ---------------------------------------------------------------------------


def _operands(a, w, scales, zeros, bias, a2, residual, layer_id, norm_weight, *, group_size,
              fmt, prologue, fused_gate_up, name="w4a16_gemm"):
    """Check the JAX contract (w4a16.py:355-411) and select the layer
    (``name`` heads the errors).
    Returns (a, a2, w, scales, zeros, bias, norm_weight, k, k_pad), where
    for ``fused_gate_up`` a and a2 are the gate and up halves (views)."""
    if fmt not in ("int4", "mxfp4"):
        raise ValueError(f"{name}: fmt must be 'int4' or 'mxfp4', got {fmt!r}")
    if prologue not in (None, "silu_mul"):
        raise ValueError(f"{name}: unknown prologue {prologue!r}")
    m, k = a.shape
    if fused_gate_up:
        if a2 is not None or prologue != "silu_mul" or k % 2:
            raise ValueError(f"{name}: fused_gate_up takes one [M, 2K] a and prologue='silu_mul'")
        k //= 2
        a, a2 = a[:, :k], a[:, k:]
    elif (a2 is not None) != (prologue == "silu_mul"):
        raise ValueError(f"{name}: prologue='silu_mul' requires a2 (or fused_gate_up)")
    if norm_weight is not None and (prologue is not None or a2 is not None):
        raise ValueError(f"{name}: norm_weight is its own prologue")
    stacked = layer_id is not None
    k_pad = w.shape[-2] * 2
    if (fused_gate_up or norm_weight is not None) and k_pad != k:
        raise ValueError(f"{name}: fused_gate_up and norm_weight need a group-multiple K ({k} vs {k_pad})")
    if k_pad != k and not k < k_pad <= round_up(k, GROUPS_PER_KTILE * group_size):
        raise ValueError(f"{name}: activations of K={k} for packed K={k_pad}")
    n = w.shape[-1]
    want_w = ((w.shape[0],) if stacked else ()) + (k_pad // 2, n)
    want_s = want_w[:-2] + (k_pad // group_size, n)
    if tuple(w.shape) != want_w or w.dtype != torch.uint8 or tuple(scales.shape) != want_s:
        raise ValueError(f"{name}: w {tuple(w.shape)} {w.dtype}, scales {tuple(scales.shape)} "
                         f"for K={k_pad}, group {group_size}")
    if zeros is not None and zeros.shape != scales.shape:
        raise ValueError(f"{name}: zeros {tuple(zeros.shape)} vs scales {tuple(scales.shape)}")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"{name}: residual {tuple(residual.shape)} for out {(m, n)}")
    if stacked:
        lid = int(layer_id)
        w, scales = w[lid], scales[lid]
        zeros = zeros[lid] if zeros is not None else None
        if bias is not None and bias.ndim == 2:
            bias = bias[lid]
        if norm_weight is not None and norm_weight.ndim == 2:
            norm_weight = norm_weight[lid]
    if norm_weight is not None and norm_weight.reshape(-1).shape[0] != k:
        raise ValueError(f"{name}: norm_weight {tuple(norm_weight.shape)} for K={k}")
    return a, a2, w, scales, zeros, bias, norm_weight, k, k_pad


def _gemm_ref(a, a2, w, scales, zeros, bias, residual, norm_weight, k, k_pad, *, norm_eps,
              group_size, fmt, out_dtype):
    m, n, g = a.shape[0], w.shape[-1], group_size
    if norm_weight is not None:
        x = a.float()
        r = torch.rsqrt((x * x).mean(-1, keepdim=True) + norm_eps)
        ap = (x * norm_weight.reshape(-1).float() * r).to(a.dtype)
    elif a2 is not None:
        x = a.float()
        ap = (x * torch.sigmoid(x) * a2.float()).to(a.dtype)
    else:
        ap = a
    af = F.pad(ap.float(), (0, k_pad - k))  # the zero-padded tail meets zero codes
    n_groups = k_pad // g
    asum = af.reshape(m, n_groups, g).sum(-1) if zeros is not None else None
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    for n0 in range(0, n, _REF_COLS):
        n1 = min(n, n0 + _REF_COLS)
        codes = _codes_f32(w[:, n0:n1], fmt)
        s = scales[:, n0:n1].float()
        z = zeros[:, n0:n1].float() if zeros is not None else None
        acc = torch.zeros((m, n1 - n0), dtype=torch.float32, device=a.device)
        for gi in range(n_groups):
            part = af[:, gi * g:(gi + 1) * g] @ codes[gi * g:(gi + 1) * g]
            acc = acc + part * s[gi]
            if z is not None:
                acc = acc - asum[:, gi:gi + 1] * z[gi]
        out[:, n0:n1] = acc
    if bias is not None:
        out = out + bias.float()
    if residual is not None:
        out = out + residual.float()
    return out.to(out_dtype or a.dtype)


def w4a16_gemm_ref(a, w, scales, zeros=None, bias=None, a2=None, residual=None, layer_id=None,
                   norm_weight=None, *, norm_eps: float = 1e-5, group_size: int = 128,
                   fmt: str = "int4", out_dtype=None, bm: Optional[int] = None, bn: int = 2048,
                   bk: Optional[int] = None, prologue: Optional[str] = None,
                   gmode: Optional[str] = None, fused_gate_up: bool = False):
    """Plain PyTorch twin of ``w4a16_gemm``, with its rounding points."""
    a_, a2_, w_, s_, z_, b_, nw_, k, k_pad = _operands(
        a, w, scales, zeros, bias, a2, residual, layer_id, norm_weight, group_size=group_size,
        fmt=fmt, prologue=prologue, fused_gate_up=fused_gate_up)
    return _gemm_ref(a_, a2_, w_, s_, z_, b_, residual, nw_, k, k_pad, norm_eps=norm_eps,
                     group_size=group_size, fmt=fmt, out_dtype=out_dtype or a.dtype)


# kernel tiles (csrc/w4a16_gemm.cu): (rows, columns) of a block
_TILES = {0: (16, 128), 1: (32, 128), 2: (64, 64)}
# the decode kernel (csrc/w4a16_decode.cu): columns of a tile, k of a stage
_DEC_BN, _DEC_KB = 128, 256


def _tile_plan(m: int, n: int, k_pad: int, group_size: int, n_sm: int):
    """(tile, split, groups_per_split) of a ``w4a16_gemm.cu`` launch: the
    prefill tile, or a decode tile for weights TMA cannot map. When the
    output tiles cannot give each SM two blocks, K splits across blocks in
    whole scale groups (the TPU walks K inside one grid step, w4a16.py:445)."""
    tile = (0 if m <= 16 else 1) if _m_bucket(m) == 0 else 2
    bm, bn = _TILES[tile]
    tiles = cdiv(m, bm) * cdiv(n, bn)
    n_groups = k_pad // group_size
    split = min(n_groups, cdiv(2 * n_sm, tiles)) if tiles < 2 * n_sm else 1
    per = cdiv(n_groups, split)
    return tile, cdiv(n_groups, per), per


def plan(m: int, n: int, k_pad: int, group_size: int, n_sm: int = 132):
    """(tile, split, per) of a launch. Prefill rows (M > 32) take the
    64 x 64 tile of ``_tile_plan`` (split and per: K's splits and groups a
    split). Decode rows take the decode kernel (tile 0: M <= 16, tile 1:
    M <= 32), whose work is the (128-column tile, 256-deep k block) stages;
    split is its blocks (two an SM, at most one a stage) and per the most
    stages a block takes, each block an equal share (stream-K)."""
    if _m_bucket(m) != 0:
        return _tile_plan(m, n, k_pad, group_size, n_sm)
    stages = cdiv(n, _DEC_BN) * cdiv(k_pad, _DEC_KB)
    blocks = min(2 * n_sm, stages)
    return (0 if m <= 16 else 1), blocks, cdiv(stages, blocks)


# the wgmma tile (csrc/w4a16_wgmma.cu): k of a stage; a block is 64 rows by
# 256 columns or 128 rows by 128 columns
_WG_BK = 128


def _wg_cols(bm: int) -> int:
    return 128 * (128 // bm)


def route(m: int, k_pad: int, vec_w: bool) -> str:
    """The kernel a call of ``m`` rows takes. ``vec_w``: TMA maps the
    weights (N a multiple of 16; codes, scales and zeros start 16-byte
    aligned). ``"decode"``: M <= 32 on ``csrc/w4a16_decode.cu``;
    ``"wgmma"``: M > 32 on ``csrc/w4a16_wgmma.cu``, whose stages also need K
    in whole 128-deep stages; ``"tile"``: the rest, on the mma.sync tile of
    ``csrc/w4a16_gemm.cu``."""
    if _m_bucket(m) == 0:
        return "decode" if vec_w else "tile"
    return "wgmma" if vec_w and k_pad % _WG_BK == 0 else "tile"


def wgmma_plan(m: int, n: int, k_pad: int, n_sm: int = 132):
    """(rows a block, split, stages a split) of a wgmma-tile launch: 64-row
    blocks of 256 columns up to 64 rows, else 128-row blocks of 128 columns
    (a decoded code feeds twice the products). Where the tiles cannot give
    every SM a block, K splits over blocks in whole 128-deep stages, at
    least 4 a split and no more splits than keep every block in one wave;
    every split non-empty."""
    bm = 64 if m <= 64 else 128
    tiles = cdiv(m, bm) * cdiv(n, _wg_cols(bm))
    stages = k_pad // _WG_BK
    split = 1
    if tiles < n_sm:
        split = max(1, min(n_sm // tiles, stages // 4))
    per = cdiv(stages, split)
    return bm, cdiv(stages, per), per


_ARGS = (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 15 + (ctypes.c_float, ctypes.c_void_p)
_WG_ARGS = (ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 14 + (ctypes.c_float, ctypes.c_void_p)
_DEC_ARGS = (ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 12 + (ctypes.c_float, ctypes.c_void_p)


@functools.cache
def _entry():
    return _build.bind("w4a16_gemm", "skt_w4a16_gemm", _ARGS)


@functools.cache
def _decode_entry():
    return _build.bind("w4a16_decode", "skt_w4a16_decode", _DEC_ARGS)


@functools.cache
def _wgmma_entry():
    return _build.bind("w4a16_wgmma", "skt_w4a16_wgmma", _WG_ARGS)


def w4a16_gemm(a, w, scales, zeros=None, bias=None, a2=None, residual=None, layer_id=None,
               norm_weight=None, *, norm_eps: float = 1e-5, group_size: int = 128,
               fmt: str = "int4", out_dtype=None, bm: Optional[int] = None, bn: int = 2048,
               bk: Optional[int] = None, prologue: Optional[str] = None,
               gmode: Optional[str] = None, fused_gate_up: bool = False):
    """A[M, K] @ dequant(W)^T with 4-bit weights (the JAX contract,
    w4a16.py:301-354): ``a`` [M, K] (or [M, 2K] with ``fused_gate_up``:
    gate columns then up columns, prologue silu(gate) * up); ``w`` packed
    uint8 [K//2, N]; ``scales`` [K//G, N]; optional ``zeros`` (z*s), ``bias``
    [N], ``a2`` with ``prologue="silu_mul"``, ``residual`` [M, N] added in the
    epilogue, ``norm_weight`` [K] (the fused rmsnorm prologue); with
    ``layer_id`` every weight operand carries a leading layer dim. Returns
    [M, N] in ``out_dtype`` (default a's dtype).

    CUDA tensors go through the K1 kernel, which takes bf16 activations,
    scales, zeros, residual and norm weight, groups of 32, 64 or 128, and a
    bf16 or float32 output. ``bm``, ``bn``, ``bk`` and ``gmode`` are
    contract-only: they chose the TPU kernel's tiles and its per-group
    decode schedule, which have no counterpart in this kernel."""
    out_dtype = out_dtype or a.dtype
    a_, a2_, w_, s_, z_, b_, nw_, k, k_pad = _operands(
        a, w, scales, zeros, bias, a2, residual, layer_id, norm_weight, group_size=group_size,
        fmt=fmt, prologue=prologue, fused_gate_up=fused_gate_up)
    if a.device.type != "cuda":
        return _gemm_ref(a_, a2_, w_, s_, z_, b_, residual, nw_, k, k_pad, norm_eps=norm_eps,
                         group_size=group_size, fmt=fmt, out_dtype=out_dtype)
    bf = torch.bfloat16
    if group_size not in (32, 64, 128):
        raise NotImplementedError(f"w4a16_gemm: the CUDA kernel takes groups of 32, 64 or 128, not {group_size}")
    if out_dtype not in (bf, torch.float32):
        raise NotImplementedError(f"w4a16_gemm: the CUDA kernel writes bf16 or float32, not {out_dtype}")
    if any(t is not None and t.dtype != bf for t in (a, a2_, s_, z_, residual, nw_)):
        raise NotImplementedError("w4a16_gemm: the CUDA kernel takes bf16 activations, scales, zeros, "
                                  "residual and norm weight")
    m, n = a_.shape[0], w_.shape[-1]
    if m == 0:
        return torch.empty((0, n), dtype=out_dtype, device=a.device)
    dense = lambda t: t if t is None or t.is_contiguous() else t.contiguous()
    if a_.stride(1) != 1:
        a_ = a_.contiguous()
    if a2_ is not None and a2_.stride(1) != 1:
        a2_ = a2_.contiguous()
    w_, s_, z_, res = dense(w_), dense(s_), dense(z_), dense(residual)
    b_ = b_.float().contiguous() if b_ is not None else None
    nw_ = dense(nw_.reshape(-1)) if nw_ is not None else None
    n_sm = sm_count(a.device.index or 0)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    prologue_id = 1 if nw_ is not None else (2 if a2_ is not None else 0)
    lda, lda2 = a_.stride(0), (a2_.stride(0) if a2_ is not None else 0)
    ptr = lambda t: t.data_ptr() if t is not None else None
    aligned = lambda *ts: all(t is None or t.data_ptr() % 16 == 0 for t in ts)
    vec_a = aligned(a_, a2_, nw_) and lda % 8 == 0 and lda2 % 8 == 0
    vec_w = n % 16 == 0 and aligned(w_, s_, z_)
    way = route(m, k_pad, vec_w)
    w4a16_gemm.launches_by_route[way] += 1
    if way != "tile" and not aligned(b_, res):  # their epilogues read 4 columns at once
        b_, res = (t.clone() if t is not None else None for t in (b_, res))
    if way == "wgmma":
        _wgmma_launch(a_, a2_, nw_, w_, s_, z_, b_, res, out, k_pad, k, group_size=group_size, fmt=fmt,
                      norm_eps=norm_eps, vec_a=vec_a)
        w4a16_gemm.launches += 1
        return out
    if way == "decode":  # the decode kernel: TMA maps the weight, scale and zero rows
        tile, blocks, _ = plan(m, n, k_pad, group_size, n_sm)
        mp = 16 if m <= 16 else 32
        partial = torch.empty((blocks * 2 * mp * _DEC_BN,), dtype=torch.float32, device=a.device)
        act = kept_buffer("w4a16_act", a.device, m * k_pad, bf)
        asum = kept_buffer("w4a16_asum", a.device, (k_pad // group_size) * 32, torch.float32)
        counters = kept_buffer("w4a16_counters", a.device, cdiv(n, _DEC_BN), torch.int32)
        _build.check(_decode_entry()(
            ptr(a_), ptr(a2_), ptr(nw_), ptr(act), ptr(asum), ptr(w_), ptr(s_), ptr(z_), ptr(b_), ptr(res),
            ptr(out), ptr(partial), ptr(counters), m, n, k_pad, k, lda, lda2, group_size, blocks, prologue_id,
            int(fmt == "mxfp4"), int(out_dtype == torch.float32), int(vec_a), norm_eps,
            _build.stream_ptr(a.device)), "w4a16_gemm")
        w4a16_gemm.launches += 1
        return out
    _tile_launch(a_, a2_, nw_, w_, s_, z_, b_, res, out, k_pad, k, group_size=group_size, fmt=fmt,
                 norm_eps=norm_eps, vec_a=vec_a, vec_w=vec_w, name="w4a16_gemm")
    w4a16_gemm.launches += 1
    return out


def _wgmma_launch(a_, a2_, nw_, w_, s_, z_, b_, res, out, k_pad, k, *, group_size, fmt, norm_eps, vec_a):
    """One call of the wgmma tile (``csrc/w4a16_wgmma.cu``) on checked,
    dense operands: the rows pass first where a prologue, rows TMA cannot
    map or zeros need it, then the tile, K split by ``wgmma_plan``."""
    m, n = a_.shape[0], w_.shape[-1]
    dev = a_.device
    bm, split, per = wgmma_plan(m, n, k_pad, sm_count(dev.index or 0))
    prologue_id = 1 if nw_ is not None else (2 if a2_ is not None else 0)
    act = None
    if prologue_id or a_.data_ptr() % 16 or a_.stride(0) % 8:  # the tile reads the rows pass's rows
        act = torch.empty((m, k_pad), dtype=torch.bfloat16, device=dev)
    asum = None
    if z_ is not None:  # each group's activation sums, [K/G][M rounded up to 128]
        asum = torch.empty(((k_pad // group_size) * round_up(m, 128),), dtype=torch.float32, device=dev)
    ws = counters = None
    if split > 1:
        ws = torch.empty((split * m * n,), dtype=torch.float32, device=dev)
        counters = kept_buffer("w4a16_wgmma_counters", dev, cdiv(m, bm) * cdiv(n, _wg_cols(bm)), torch.int32)
    ptr = lambda t: t.data_ptr() if t is not None else None
    _build.check(_wgmma_entry()(
        ptr(a_), ptr(a2_), ptr(nw_), ptr(act), ptr(asum), ptr(w_), ptr(s_), ptr(z_), ptr(b_), ptr(res), ptr(out),
        ptr(ws), ptr(counters), m, n, k_pad, k, a_.stride(0), a2_.stride(0) if a2_ is not None else 0, group_size, bm,
        prologue_id, int(fmt == "mxfp4"), int(out.dtype == torch.float32), int(vec_a), split, per, norm_eps,
        _build.stream_ptr(dev)), "w4a16_gemm")


def _tile_launch(a_, a2_, nw_, w_, s_, z_, b_, res, out, k_pad, k, *, group_size, fmt, norm_eps, vec_a, vec_w,
                 name):
    """One launch of the tile kernel (``csrc/w4a16_gemm.cu``) on checked, dense
    operands: the prefill tile, or a decode tile for weights TMA cannot map
    (K1 and K10)."""
    m, n = a_.shape[0], w_.shape[-1]
    tile, split, per = _tile_plan(m, n, k_pad, group_size, sm_count(a_.device.index or 0))
    # one float32 workspace: the split-K partials, then the norm's row factors
    ws = None
    if split > 1 or nw_ is not None:
        ws = torch.empty(((split if split > 1 else 0) * m * n + m,), dtype=torch.float32, device=a_.device)
    partial = ws if split > 1 else None
    rms = ws[ws.shape[0] - m:] if nw_ is not None else None
    prologue_id = 1 if nw_ is not None else (2 if a2_ is not None else 0)
    # the prefill tile reads the prologue's rows from a first pass
    act_ws = torch.empty((m, k), dtype=torch.bfloat16, device=a_.device) if prologue_id and tile == 2 else None
    ptr = lambda t: t.data_ptr() if t is not None else None
    _build.check(_entry()(ptr(a_), ptr(a2_), ptr(nw_), ptr(rms), ptr(act_ws), ptr(w_), ptr(s_), ptr(z_), ptr(b_),
                          ptr(res), ptr(out), ptr(partial), m, n, k_pad, k, a_.stride(0),
                          a2_.stride(0) if a2_ is not None else 0, group_size, tile, split, per, prologue_id,
                          int(fmt == "mxfp4"), int(out.dtype == torch.float32), int(vec_a), int(vec_w), norm_eps,
                          _build.stream_ptr(a_.device)), name)


w4a16_gemm.launches = 0
# launches by kernel (``route``): the decode kernel, the wgmma tile, the mma.sync tile
w4a16_gemm.launches_by_route = {"decode": 0, "wgmma": 0, "tile": 0}
