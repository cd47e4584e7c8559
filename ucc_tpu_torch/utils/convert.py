"""Buffers across the package boundary: numpy arrays <-> torch tensors.

A collective library carries no weights; the state that crosses between
the JAX package and this one is the buffers. Both directions go through
numpy, and bfloat16 goes through a uint16 view: JAX's bfloat16 is
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` cannot take, and numpy
has no bfloat16 of its own.
"""
from __future__ import annotations

import numpy as np
import torch


def _is_bf16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16" and dtype.itemsize == 2


def from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """A tensor on *device* holding a copy of *arr* (bfloat16 included)."""
    arr = np.ascontiguousarray(arr)
    if _is_bf16(arr.dtype):
        bits = torch.from_numpy(arr.view(np.uint16).astype(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of *t*. bfloat16 comes back as ``ml_dtypes.bfloat16``,
    which must then be importable (it ships with JAX)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy().copy()
