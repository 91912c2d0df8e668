"""Carry a parameter tree given as numpy arrays into the port.

The JAX package's parameter pytree, with every leaf turned into a numpy
array by the caller (``np.asarray`` on the JAX side), becomes the port's
nested dict of tensors by a copy. bfloat16 and fp8 (e4m3fn, e5m2) arrays
move through a same-width unsigned integer view, matched by the dtype's
name, so no extension of numpy's types is needed here. 4-bit integer arrays
(``uint4`` / ``int4``, one value a byte) become one code a byte: uint8 codes
0..15 and int8 values -8..7.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import resolve_device


# dtypes numpy knows only through an extension: name -> (view, torch dtype)
_VIEWED = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


# 4-bit integers, one a byte: name -> the byte type holding the same values
_NIBBLE = {"uint4": np.uint8, "int4": np.int8}


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name in _NIBBLE:
        arr = arr.astype(_NIBBLE[arr.dtype.name])
    if arr.dtype.name in _VIEWED:
        view, dtype = _VIEWED[arr.dtype.name]
        t = torch.from_numpy(arr.view(view)).view(dtype)
    else:
        t = torch.from_numpy(arr)
    return t.to(resolve_device(device))


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays -> the same nesting of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
