"""E2M1 (fp4) codes, 4-bit nibble packing and the AWQ int32 packing order.

Plain PyTorch copies of the parts of sgl_kernel_tpu/ops/quant/formats.py
(:37-68, :101-135) that the W4A16 layout converters and the NVFP4 GEMMs
need; same bytes out.
"""

from __future__ import annotations

import torch

# logical[k] = nibble[AWQ_ORDER[k]] within one int32 word
AWQ_ORDER = (0, 4, 1, 5, 2, 6, 3, 7)

# value of each 3-bit e2m1 magnitude code (the sign is bit 3)
E2M1_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
E2M1_MAX = 6.0


def e2m1_encode(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest E2M1 code (uint8 0..15, sign in bit 3), ties to
    even: a magnitude counts the decision boundaries it passes, "<=" at an
    even target and "<" at an odd one (formats.py:37-57)."""
    a = x.abs()
    code = ((a > 0.25).to(torch.uint8) + (a >= 0.75).to(torch.uint8) + (a > 1.25).to(torch.uint8)
            + (a >= 1.75).to(torch.uint8) + (a > 2.5).to(torch.uint8) + (a >= 3.5).to(torch.uint8)
            + (a > 5.0).to(torch.uint8))
    return ((x < 0.0).to(torch.uint8) << 3) | code


E2M1_EMAX = 2  # the largest E2M1 exponent: 6 = 1.5 x 2^2

_INV_LN2 = 1.4426950408889634


def ue8m0_encode_from_amax(amax: torch.Tensor, emax: int = E2M1_EMAX):
    """OCP MX shared scale of a group from its float32 absmax:
    e = clamp(floor(log2(amax)) - emax, -127, 127); returns (byte e + 127
    uint8, value 2^e float32) (formats.py:70-77). log2 is taken as ln times
    the float32 1 / ln 2, the product XLA makes of it, so the exponent is
    JAX's where a value sits an ulp from a power of two."""
    log2 = torch.log(amax.float()) * torch.tensor(_INV_LN2, dtype=torch.float32)
    e = torch.clamp(torch.floor(log2) - float(emax), -127, 127).to(torch.int32)
    return (e + 127).to(torch.uint8), torch.exp2(e.float())


def e2m1_decode(code: torch.Tensor) -> torch.Tensor:
    """E2M1 codes (the low 4 bits) -> float32 values."""
    c = code.to(torch.int64) & 0xF
    mag = torch.tensor(E2M1_VALUES, dtype=torch.float32, device=code.device)[c & 0x7]
    return torch.where((c >> 3) != 0, -mag, mag)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack uint4 codes [..., K] -> bytes [..., K//2], low nibble first."""
    lo = codes[..., 0::2].to(torch.uint8) & 0xF
    hi = codes[..., 1::2].to(torch.uint8) & 0xF
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Unpack bytes [..., K//2] -> uint8 codes [..., K], low nibble first."""
    packed = packed.to(torch.uint8)
    return torch.stack([packed & 0xF, packed >> 4], dim=-1).reshape(*packed.shape[:-1], -1)


def _nibbles(q: torch.Tensor) -> torch.Tensor:
    """int32 words [...] -> their 8 nibbles [..., 8], nibble 0 lowest (the
    words are read as unsigned, through int64)."""
    q = q.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(8, device=q.device, dtype=torch.int64) * 4
    return (q[..., None] >> shifts) & 0xF


def awq_unpack_int32(q: torch.Tensor) -> torch.Tensor:
    """Unpack AWQ int32 [..., C//8] -> uint8 codes [..., C] in logical order."""
    logical = _nibbles(q)[..., list(AWQ_ORDER)]
    return logical.reshape(*q.shape[:-1], -1).to(torch.uint8)
