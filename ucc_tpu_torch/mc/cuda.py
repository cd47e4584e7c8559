"""CUDA memory component — GPU-resident torch tensors (UCC's mc/cuda).

Allocation goes through PyTorch's caching allocator (``torch.empty`` on a
CUDA device), so freed blocks are reused without cudaMalloc round trips,
the role UCC's mpool-backed cudaMalloc cache plays. Copies and fills run
on the current stream of the buffer's device. Tensors are mutable: copies
land in the destination itself.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..constants import MemoryType
from .base import MemAttr, MemoryComponent


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


class McCuda(MemoryComponent):
    NAME = "cuda"
    MEM_TYPE = MemoryType.CUDA

    def mem_query(self, obj: Any) -> Optional[MemAttr]:
        if isinstance(obj, torch.Tensor) and obj.device.type == "cuda":
            return MemAttr(MemoryType.CUDA, base=obj,
                           size=obj.numel() * obj.element_size())
        return None

    def alloc(self, size_bytes: int, device) -> torch.Tensor:
        """Uninitialized bytes on *device*, like cudaMalloc."""
        return torch.empty(size_bytes, dtype=torch.uint8,
                           device=torch.device(device))

    def memcpy(self, dst: torch.Tensor, src: Any,
               size_bytes: int) -> None:
        if not isinstance(src, torch.Tensor):
            src = torch.as_tensor(src)
        _bytes(dst)[:size_bytes].copy_(_bytes(src)[:size_bytes])

    def memset(self, buf: torch.Tensor, value: int, size_bytes: int) -> None:
        _bytes(buf)[:size_bytes].fill_(value & 0xFF)
