"""Host memory component: numpy arrays, buffer-protocol objects and CPU
tensors (UCC's mc/cpu: malloc-backed alloc + host memcpy/memset)."""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..constants import MemoryType
from .base import MemAttr, MemoryComponent


def _as_u8(buf: Any) -> np.ndarray:
    """View a CPU tensor, ndarray or buffer-protocol object as flat uint8."""
    if isinstance(buf, torch.Tensor):
        if buf.numel() == 0:
            # an empty tensor may carry stride 0 (torch.from_numpy of an
            # empty array), which a dtype view refuses
            return np.zeros(0, dtype=np.uint8)
        return buf.reshape(-1).view(torch.uint8).numpy()
    if isinstance(buf, np.ndarray):
        return buf.reshape(-1).view(np.uint8)
    return np.frombuffer(buf, dtype=np.uint8)


class McCpu(MemoryComponent):
    NAME = "cpu"
    MEM_TYPE = MemoryType.HOST

    def mem_query(self, obj: Any) -> Optional[MemAttr]:
        if isinstance(obj, torch.Tensor) and obj.device.type == "cpu":
            return MemAttr(MemoryType.HOST, base=obj,
                           size=obj.numel() * obj.element_size())
        if isinstance(obj, (np.ndarray, bytes, bytearray, memoryview)):
            nb = obj.nbytes if isinstance(obj, np.ndarray) else len(obj)
            return MemAttr(MemoryType.HOST, base=obj, size=nb)
        return None

    def alloc(self, size_bytes: int) -> np.ndarray:
        return np.empty(size_bytes, dtype=np.uint8)

    def memcpy(self, dst: Any, src: Any, size_bytes: int) -> None:
        _as_u8(dst)[:size_bytes] = _as_u8(src)[:size_bytes]

    def memset(self, buf: Any, value: int, size_bytes: int) -> None:
        _as_u8(buf)[:size_bytes] = value
