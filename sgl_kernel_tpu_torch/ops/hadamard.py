"""Walsh-Hadamard transform (plain PyTorch).

The JAX package's ``hadamard_transform`` (sgl_kernel_tpu/ops/hadamard.py)
runs log2(n) butterfly passes; here it is one float32 product with the
n x n Sylvester matrix, H[i, j] = (-1)^popcount(i & j), which is the same
linear map in the same (natural) order: one launch where the butterfly
takes seven passes of several ops each, and the NSA indexer calls it twice
a layer. The sums run in another order, so a later fp8 code may differ by
one step at a rounding tie.
"""

from __future__ import annotations

import functools

import torch


@functools.cache
def _sylvester(n: int, device: torch.device) -> torch.Tensor:
    h = torch.ones((1, 1), dtype=torch.float32)
    while h.shape[0] < n:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return h.to(device)


def hadamard_transform(x, scale: float = 1.0):
    """Walsh-Hadamard transform along the last dim (a power of two), times
    ``scale``, in float32, rounded once to x's dtype."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"hadamard_transform: the last dim must be a power of two, got {n}")
    y = torch.matmul(x.float(), _sylvester(n, x.device))  # the matrix is symmetric
    return (y * scale).to(x.dtype)
