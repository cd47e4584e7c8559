"""Memory components (MC).

UCC dispatches by memory type through an MC ops vtable {mem_query,
alloc, free, memcpy, memset}; MC is how ``collective_init`` auto-detects a
buffer's memory type. Here MemoryType.HOST is numpy or a CPU tensor
(mc/cpu) and MemoryType.CUDA a torch.Tensor on a GPU (mc/cuda). A tensor
is told apart by its ``.device``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..constants import MemoryType
from ..status import Status, UccError


@dataclass
class MemAttr:
    """ucc_mem_attr_t: memory type + base/size when resolvable."""

    mem_type: MemoryType
    base: Any = None
    size: int = 0


class MemoryComponent:
    NAME = "base"
    MEM_TYPE = MemoryType.UNKNOWN

    def mem_query(self, obj: Any) -> Optional[MemAttr]:
        """Return MemAttr if *obj* belongs to this component, else None."""
        raise NotImplementedError

    def alloc(self, size_bytes: int) -> Any:
        raise NotImplementedError

    def free(self, buf: Any) -> None:
        pass

    def memcpy(self, dst: Any, src: Any, size_bytes: int) -> None:
        raise NotImplementedError

    def memset(self, buf: Any, value: int, size_bytes: int) -> None:
        raise NotImplementedError


_components: Dict[MemoryType, MemoryComponent] = {}


def register_mc(mc: MemoryComponent) -> MemoryComponent:
    _components[mc.MEM_TYPE] = mc
    return mc


def get_mc(mem_type: MemoryType) -> MemoryComponent:
    _ensure_defaults()
    if mem_type not in _components:
        raise UccError(Status.ERR_NOT_FOUND,
                       f"no memory component for {mem_type.name}")
    return _components[mem_type]


def detect_mem_type(obj: Any) -> MemoryType:
    """Memtype auto-detection: a tensor by its device (cuda -> CUDA, cpu ->
    HOST); numpy / buffer-protocol objects -> HOST."""
    if obj is None:
        return MemoryType.HOST
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            return MemoryType.CUDA
        if obj.device.type == "cpu":
            return MemoryType.HOST
        return MemoryType.UNKNOWN
    if isinstance(obj, (np.ndarray, bytes, bytearray, memoryview)):
        return MemoryType.HOST
    if hasattr(obj, "__array_interface__") or hasattr(obj, "__buffer__"):
        return MemoryType.HOST
    return MemoryType.UNKNOWN


def _ensure_defaults() -> None:
    if MemoryType.HOST not in _components:
        from .cpu import McCpu
        register_mc(McCpu())
    if MemoryType.CUDA not in _components:
        from .cuda import McCuda
        register_mc(McCuda())
