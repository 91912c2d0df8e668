"""Flash-attention prefill.

``flash_attention`` is kernel K7, CUDA C++ in ``csrc/flash_prefill.cu``,
replacing the Pallas ``flash_attention``
(sgl_kernel_tpu/ops/attention/flash_prefill.py:165, pallas_call at :260).
``flash_attention_ref`` is its plain PyTorch twin. Both cover the whole JAX
contract: causal or full attention with q / kv offsets, a sliding window, a
tanh soft cap, per-head sinks and the base-2 lse (gpt-oss's prefill takes
the sinks and the window); at head dims 256 (hybrid GDN's attention) and
576 the kernel takes no option and raises on one. A row that sees no key gets o = 0 and lse -1e30 * log2(e),
sinks or not (JAX's finalize gives +inf there once a sink joins an empty
sum).

``flash_attention_mla`` is the same function at head dim 576 with V the
first 512 columns of K (DeepSeek's MLA prefill, mla.py:520-557 of the JAX
package, whose V is K's latent zero-padded to 576): it launches K7's
kernel with no V operand, so no padded V is built, and writes the 512
columns the model reads. ``flash_attention_mla_ref`` is its twin.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ... import _build

LOG2E = 1.4426950408889634


def _lens(q, k, q_lens, kv_lens, q_start, kv_start):
    b, sq = q.shape[:2]
    skv = k.shape[1]
    dev = q.device
    q_lens = torch.full((b,), sq, dtype=torch.int32, device=dev) if q_lens is None else q_lens.to(dev, torch.int32)
    kv_lens = torch.full((b,), skv, dtype=torch.int32, device=dev) if kv_lens is None else kv_lens.to(dev, torch.int32)
    q_start = kv_lens - q_lens if q_start is None else q_start.to(dev, torch.int32)
    kv_start = torch.zeros((b,), dtype=torch.int32, device=dev) if kv_start is None else kv_start.to(dev, torch.int32)
    return q_lens, kv_lens, q_start, kv_start


def flash_attention_ref(q, k, v, q_lens=None, kv_lens=None, sinks=None, q_start=None,
                        kv_start=None, *, causal: bool = True, sm_scale: Optional[float] = None,
                        sliding_window: Optional[int] = None, logit_soft_cap: Optional[float] = None,
                        return_lse: bool = False):
    """Plain PyTorch twin of ``flash_attention`` (dense f32 scores)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    q_lens, kv_lens, q_start, kv_start = _lens(q, k, q_lens, kv_lens, q_start, kv_start)
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bihd,bjhd->bhij", q.float(), kf) * scale
    if logit_soft_cap is not None:
        s = logit_soft_cap * torch.tanh(s / logit_soft_cap)
    rows = torch.arange(sq, device=q.device)
    cols = torch.arange(skv, device=q.device)
    q_pos = rows[None, :] + q_start[:, None]          # [B, Sq]
    kv_pos = cols[None, :] + kv_start[:, None]        # [B, Skv]
    mask = (cols[None, :] < kv_lens[:, None])[:, None, :]  # [B, 1, Skv]
    if causal:
        mask = mask & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if sliding_window is not None:
        mask = mask & (kv_pos[:, None, :] > q_pos[:, :, None] - sliding_window)
    s = s.masked_fill(~mask[:, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if sinks is not None:  # the sink joins the sum of a row that sees a key
        l = torch.where(l > 0, l + torch.exp(sinks.float().to(q.device)[None, :, None, None] - m), l)
    o = torch.einsum("bhij,bjhd->bihd", p, vf)
    l_inv = torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
    out = (o * l_inv.permute(0, 2, 1, 3)).to(q.dtype)
    if return_lse:
        lse = ((m + torch.log(l.clamp_min(1e-38))) * LOG2E)[..., 0]
        return out, lse
    return out


_ARGS = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 7 + (ctypes.c_float, ctypes.c_int, ctypes.c_float)
         + (ctypes.c_void_p,) * 2)

OPTIONS = ("sinks", "window", "softcap")


def kernel_options(d: int, hq: int, device, sinks, sliding_window, logit_soft_cap, name: str):
    """The options as the kernels take them: (window, softcap, sinks
    tensor) with 0 / 0.0 / None for an option not given; raises where the
    kernel takes none (head dim 576) or the value is out of its range.
    Shared by K7 and K9."""
    used = [o for o, x in zip(OPTIONS, (sinks, sliding_window, logit_soft_cap)) if x is not None]
    if used and d in (D_MLA, 256):
        raise NotImplementedError(f"{name}: the head-dim {d} tile takes no {', '.join(used)}")
    if sliding_window is not None and int(sliding_window) < 1:
        raise ValueError(f"{name}: sliding_window must be >= 1, got {sliding_window}")
    if logit_soft_cap is not None and not float(logit_soft_cap) > 0:
        raise ValueError(f"{name}: logit_soft_cap must be > 0, got {logit_soft_cap}")
    if sinks is not None:
        sinks = sinks.to(device=device, dtype=torch.float32).contiguous()
        if sinks.shape != (hq,):
            raise ValueError(f"{name}: sinks {tuple(sinks.shape)} for {hq} heads")
    return (0 if sliding_window is None else int(sliding_window),
            0.0 if logit_soft_cap is None else float(logit_soft_cap), sinks, used)


def flash_attention(q, k, v, q_lens=None, kv_lens=None, sinks=None, q_start=None,
                    kv_start=None, *, causal: bool = True, sm_scale: Optional[float] = None,
                    sliding_window: Optional[int] = None, logit_soft_cap: Optional[float] = None,
                    return_lse: bool = False):
    """Batched ragged flash attention. q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D];
    q_lens/kv_lens [B]; q_start/kv_start [B] global positions of q row 0 /
    kv row 0 (defaults kv_len - q_len and 0). Returns out [B, Sq, Hq, D]
    (+ lse [B, Hq, Sq] float32 base 2 when return_lse; a row that sees no
    key has o = 0 and lse -1e30 * log2(e)). sinks [Hq] natural-log logits;
    a key is inside ``sliding_window`` when its position > the query's -
    window. CUDA tensors go through the K7 kernel, which takes bf16, head_dim
    64, 128, 256 or 576 (256 and 576 with none of sinks, window and softcap;
    576: the MLA prefill's tile, with Hq / Hkv dividing 16 or a multiple of
    16). Each launch counts in ``launches``, at 256 and 576 also in
    ``launches_256`` / ``launches_576``, and under each option it takes in
    ``launches_by_option``."""
    if q.device.type != "cuda":
        return flash_attention_ref(
            q, k, v, q_lens, kv_lens, sinks, q_start, kv_start, causal=causal,
            sm_scale=sm_scale, sliding_window=sliding_window,
            logit_soft_cap=logit_soft_cap, return_lse=return_lse)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if (hq % hkv or d not in (64, 128, 256, 576) or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or (d == 576 and 16 % (hq // hkv) and (hq // hkv) % 16)):
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise NotImplementedError("flash_attention: the CUDA kernel takes bf16")
    window, cap, sinks, used = kernel_options(d, hq, q.device, sinks, sliding_window, logit_soft_cap,
                                              "flash_attention")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = torch.stack(_lens(q, k, q_lens, kv_lens, q_start, kv_start), dim=1).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse else None
    scale = sm_scale if sm_scale is not None else 1.0 / d ** 0.5
    fn = _build.bind("flash_prefill", "skt_flash_prefill", _ARGS)
    _build.check(fn(q.data_ptr(), None, k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(), b, sq, skv, hq, hkv, d, int(causal), scale, window,
                    cap, None if sinks is None else sinks.data_ptr(), _build.stream_ptr(q.device)),
                 "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_576 += d == 576  # the 576-wide tile (mla_flash_tile.cuh), counted apart
    flash_attention.launches_256 += d == 256  # the 256-wide instance of flash_tile.cuh, counted apart
    for o in used:
        flash_attention.launches_by_option[o] += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.launches_576 = 0
flash_attention.launches_256 = 0
# launches that took each option (a launch with two counts under both)
flash_attention.launches_by_option = dict.fromkeys(OPTIONS, 0)

D_MLA, DV_MLA = 576, 512  # MLA's q / k width and its V (the latent) width


def flash_attention_mla_ref(q_nope, q_pe, kv, q_lens=None, kv_lens=None, q_start=None, kv_start=None, *,
                            causal: bool = True, sm_scale: Optional[float] = None, return_lse: bool = False):
    """Plain twin of ``flash_attention_mla``: ``flash_attention_ref`` with q
    = [q_nope | q_pe] and V the first 512 columns of ``kv``."""
    return flash_attention_ref(torch.cat([q_nope, q_pe], dim=-1), kv, kv[..., :DV_MLA], q_lens, kv_lens, None,
                               q_start, kv_start, causal=causal, sm_scale=sm_scale, return_lse=return_lse)


def flash_attention_mla(q_nope, q_pe, kv, q_lens=None, kv_lens=None, q_start=None, kv_start=None, *,
                        causal: bool = True, sm_scale: Optional[float] = None, return_lse: bool = False):
    """``flash_attention(q, kv, v)`` with q = [q_nope | q_pe] and v the first
    512 columns of kv zero-padded to 576, returning only the first 512 output
    columns (the rest are zero): q_nope [B, Sq, Hq, 512], q_pe [B, Sq, Hq,
    64], kv [B, Skv, Hkv, 576]; returns out [B, Sq, Hq, 512] (+ lse [B, Hq,
    Sq] base 2). CUDA tensors go through K7's 576 tile, which reads q's two
    parts where they lie and V from K's own boxes, counted on
    ``flash_attention``."""
    if q_nope.device.type != "cuda":
        return flash_attention_mla_ref(q_nope, q_pe, kv, q_lens, kv_lens, q_start, kv_start, causal=causal,
                                       sm_scale=sm_scale, return_lse=return_lse)
    b, sq, hq, dn = q_nope.shape
    skv, hkv = kv.shape[1], kv.shape[2]
    if (dn != DV_MLA or tuple(q_pe.shape) != (b, sq, hq, D_MLA - DV_MLA) or kv.shape[0] != b
            or kv.shape[3] != D_MLA or hq % hkv or (16 % (hq // hkv) and (hq // hkv) % 16)):
        raise ValueError(f"flash_attention_mla: unsupported shapes q_nope {tuple(q_nope.shape)} q_pe "
                         f"{tuple(q_pe.shape)} kv {tuple(kv.shape)}")
    if not (q_nope.dtype == q_pe.dtype == kv.dtype == torch.bfloat16):
        raise NotImplementedError("flash_attention_mla: the CUDA kernel takes bf16")
    q_nope, q_pe, kv = q_nope.contiguous(), q_pe.contiguous(), kv.contiguous()
    lens = torch.stack(_lens(q_nope, kv, q_lens, kv_lens, q_start, kv_start), dim=1).contiguous()
    out = q_nope.new_empty((b, sq, hq, DV_MLA))
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q_nope.device) if return_lse else None
    scale = sm_scale if sm_scale is not None else 1.0 / D_MLA ** 0.5
    fn = _build.bind("flash_prefill", "skt_flash_prefill", _ARGS)
    _build.check(fn(q_nope.data_ptr(), q_pe.data_ptr(), kv.data_ptr(), None, lens.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(), b, sq, skv, hq, hkv, D_MLA, int(causal), scale, 0,
                    0.0, None, _build.stream_ptr(q_nope.device)),
                 "flash_attention_mla")
    flash_attention.launches += 1
    flash_attention.launches_576 += 1
    return (out, lse) if return_lse else out
