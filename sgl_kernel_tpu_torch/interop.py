"""Carry a parameter tree given as numpy arrays into the port.

The JAX package's parameter pytree, with every leaf turned into a numpy
array by the caller (``np.asarray`` on the JAX side), becomes the port's
nested dict of tensors by a copy. bfloat16 arrays move through a uint16
view, so no bfloat16-aware numpy extension is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import resolve_device


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(resolve_device(device))


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays -> the same nesting of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
