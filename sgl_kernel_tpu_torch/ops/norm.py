"""RMSNorm family.

``rmsnorm`` is kernel K2, a Triton kernel that replaces the Pallas
``rmsnorm`` (sgl_kernel_tpu/ops/norm.py:40, pallas_call at :62). Its plain
PyTorch twin ``rmsnorm_ref`` runs for CPU tensors; ``fused_add_rmsnorm``
and the gemma variants go through ``rmsnorm``. ``l2norm`` (GDN's q / k
norm, norm.py:97-100 of the JAX package, plain ``jnp`` there) is plain
PyTorch on either device.
Statistics are taken in float32 whatever the input type, then cast back.

Kernel note (K2). Bound: bytes: one read of x, one write of the output,
about 1 flop per byte. Design: one Triton program per row, the whole row
in one block (4096 wide on the main path), so the mean of squares is one
in-register reduction and x is read once. The TPU kernel's 8-row tiling,
its ``d % 128`` condition and its VMEM row budget are TPU rules; any width
runs here.
"""

from __future__ import annotations

import functools

import torch

from ..utils import next_power_of_2


def rmsnorm_ref(x, weight, eps: float = 1e-6, *, gemma: bool = False):
    """Plain PyTorch: x / sqrt(mean(x^2) + eps) * w   (gemma: * (w + 1))."""
    xf = x.float()
    wf = weight.float()
    if gemma:
        wf = wf + 1.0
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * wf).to(x.dtype)


@functools.cache
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, w_ptr, o_ptr, d, eps, GEMMA: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        x = tl.load(x_ptr + row * d + cols, mask=mask, other=0.0).to(tl.float32)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        if GEMMA:
            w = w + 1.0
        var = tl.sum(x * x, axis=0) / d
        y = x / tl.sqrt(var + eps) * w
        tl.store(o_ptr + row * d + cols, y.to(o_ptr.dtype.element_ty), mask=mask)

    return rmsnorm_kernel


def rmsnorm(x, weight, eps: float = 1e-6, *, gemma: bool = False):
    """out = x / sqrt(mean(x^2) + eps) * w over the last dim (gemma: w + 1).
    A CUDA tensor goes through the Triton kernel; a CPU tensor through
    ``rmsnorm_ref``."""
    if x.device.type != "cuda":
        return rmsnorm_ref(x, weight, eps, gemma=gemma)
    d = x.shape[-1]
    if weight.shape != (d,) or weight.device != x.device:
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} on {weight.device} for x {tuple(x.shape)} on {x.device}")
    x2 = x.reshape(-1, d)
    if not x2.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous in its last dims")
    out = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows:
        block = next_power_of_2(d)
        _triton_kernel()[(rows,)](
            x2, weight.contiguous(), out, d, float(eps), GEMMA=gemma, BLOCK=block,
            num_warps=min(16, max(1, block // 256)))
        rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0


def fused_add_rmsnorm(x, residual, weight, eps: float = 1e-6, *, gemma: bool = False):
    """residual' = x + residual;  out = rmsnorm(residual') * w.
    Returns (out, residual')."""
    res = (x.float() + residual.float()).to(x.dtype)
    return rmsnorm(res, weight, eps, gemma=gemma), res


gemma_rmsnorm = functools.partial(rmsnorm, gemma=True)
gemma_fused_add_rmsnorm = functools.partial(fused_add_rmsnorm, gemma=True)


def l2norm(x, eps: float = 1e-6):
    """x / sqrt(sum(x^2) + eps) over the last dim, in float32, cast back to
    x's dtype (the GDN q / k norm)."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().sum(-1, keepdim=True) + eps)).to(x.dtype)
