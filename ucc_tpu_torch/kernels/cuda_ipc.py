"""CUDA IPC of device buffers between the processes of one host: the
Python face of ``csrc/cuda_ipc.cu``, which the device TLs' teams that span
processes reach their peers' buffers through (``tl/device_sync.py``).

A buffer travels as a descriptor, ``("cuda", handle, offset, nbytes,
pid)``: the 64-byte IPC handle of the cudaMalloc allocation that holds it
(PyTorch's caching allocator hands out pieces of larger allocations), the
buffer's byte offset in that allocation, its bytes, and the exporting
process. ``open_buffer`` maps the allocation once per process and gives
the buffer back as a uint8 tensor (``__cuda_array_interface__``), which the
caller views as its dtype.

An allocation may be opened only once per process, and a process cannot
open its own handles. So opened bases live in one process-wide table keyed
by (exporting pid, handle bytes), never by a pointer (a peer that frees a
buffer may get its address back for another allocation, under another
handle), with a count of the teams that hold each; ``release`` closes a
base when its last team lets go (at team destroy).

``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` makes allocations
that have no IPC handle: ``check_allocator`` refuses it up front, and an
export that fails raises ERR_NO_RESOURCE. Nothing is ever staged through
the host instead.

Nothing here is built or loaded at import: the first export or open
builds the source (kernels/build.py).
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Tuple

import torch

from ..status import Status, UccError
from . import build

SOURCE = "cuda_ipc.cu"
#: CUDA_IPC_HANDLE_SIZE
HANDLE_BYTES = 64

_lib = None
_lib_lock = threading.Lock()
#: (pid, handle) -> [opened base pointer, device index, teams holding it]
_OPENED: Dict[Tuple[int, bytes], list] = {}
_OPENED_LOCK = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load(SOURCE)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.ucc_cuda_ipc_range.argtypes = [
                ci, vp, ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_size_t)]
            lib.ucc_cuda_ipc_get.argtypes = [ci, vp, vp]
            lib.ucc_cuda_ipc_open.argtypes = [ci, vp, ctypes.POINTER(vp)]
            lib.ucc_cuda_ipc_close.argtypes = [ci, vp]
            for fn in (lib.ucc_cuda_ipc_range, lib.ucc_cuda_ipc_get,
                       lib.ucc_cuda_ipc_open, lib.ucc_cuda_ipc_close,
                       lib.ucc_cuda_ipc_handle_size):
                fn.restype = ci
            lib.ucc_cuda_ipc_error_string.argtypes = [ci]
            lib.ucc_cuda_ipc_error_string.restype = ctypes.c_char_p
            if lib.ucc_cuda_ipc_handle_size() != HANDLE_BYTES:
                raise UccError(Status.ERR_NO_RESOURCE,
                               "cuda_ipc.cu: unexpected IPC handle size")
            _lib = lib
        return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _load().ucc_cuda_ipc_error_string(rc).decode()
        raise UccError(Status.ERR_NO_RESOURCE,
                       f"{what} failed: CUDA error {rc} ({msg})")


def check_allocator() -> None:
    """ERR_NOT_SUPPORTED when PyTorch's allocator is set to expandable
    segments, whose allocations CUDA IPC cannot export."""
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")
    for item in conf.replace(";", ",").split(","):
        key, _, val = item.partition(":")
        if key.strip() == "expandable_segments" and \
                val.strip().lower() in ("true", "1", "yes", "y"):
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "device teams across processes reach peer "
                           "buffers through CUDA IPC, which cannot export "
                           "the allocations of PYTORCH_CUDA_ALLOC_CONF="
                           "expandable_segments:True; unset it")


def export(t: torch.Tensor) -> tuple:
    """The descriptor of CUDA tensor *t*'s bytes (it must be contiguous)."""
    lib = _load()
    dev = t.device.index
    ptr = t.data_ptr()
    base, size = ctypes.c_void_p(), ctypes.c_size_t()
    _check(lib.ucc_cuda_ipc_range(dev, ctypes.c_void_p(ptr),
                                  ctypes.byref(base), ctypes.byref(size)),
           "cuMemGetAddressRange")
    handle = ctypes.create_string_buffer(HANDLE_BYTES)
    _check(lib.ucc_cuda_ipc_get(dev, base, handle),
           "cudaIpcGetMemHandle (an allocation of expandable segments?)")
    nbytes = t.numel() * t.element_size()
    return ("cuda", handle.raw, ptr - base.value, nbytes, os.getpid())


class _Mapped:
    """A device range as __cuda_array_interface__ bytes."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 3, "strides": None}


def open_buffer(desc: tuple, device: torch.device, held: set) -> tuple:
    """(uint8 tensor on *device* over a peer's buffer, whether this call
    opened its allocation). *held* is the calling team's set of opened
    keys: a key it does not hold yet adds the team to the base's holders."""
    _, handle, offset, nbytes, pid = desc
    key = (int(pid), bytes(handle))
    opened = False
    with _OPENED_LOCK:
        ent = _OPENED.get(key)
        if ent is None:
            lib = _load()
            ptr = ctypes.c_void_p()
            hbuf = ctypes.create_string_buffer(bytes(handle), HANDLE_BYTES)
            _check(lib.ucc_cuda_ipc_open(device.index, hbuf,
                                         ctypes.byref(ptr)),
                   f"cudaIpcOpenMemHandle of process {pid}'s buffer")
            ent = _OPENED[key] = [ptr.value, device.index, 0]
            opened = True
        if key not in held:
            held.add(key)
            ent[2] += 1
        base = ent[0]
    if nbytes == 0:
        return torch.empty(0, dtype=torch.uint8, device=device), opened
    return torch.as_tensor(_Mapped(base + int(offset), int(nbytes)),
                           device=device), opened


def release(held: set) -> None:
    """Let go of the team's opened bases; close those no team holds."""
    with _OPENED_LOCK:
        for key in held:
            ent = _OPENED.get(key)
            if ent is None:
                continue
            ent[2] -= 1
            if ent[2] <= 0:
                del _OPENED[key]
                torch.cuda.synchronize(ent[1])
                _check(_load().ucc_cuda_ipc_close(
                    ent[1], ctypes.c_void_p(ent[0])),
                    "cudaIpcCloseMemHandle")
        held.clear()
