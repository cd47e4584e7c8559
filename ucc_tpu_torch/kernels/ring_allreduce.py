"""Ring allreduce over the n ranks of one device: the CUDA kernels of
``csrc/ring_allreduce.cu``, their wrappers, and their plain PyTorch
versions.

Two kernels, one step schedule (see the note at the top of the source):

- ``ring_allreduce_pass`` replaces ``ucc_tpu/tl/ring_dma.py:_ring_kernel``
  in allreduce mode: one ring over the whole vector, padded to a multiple
  of n, ``blk = ceil(count / n)``.
- ``ring_allreduce_chunked`` replaces ``_hbm_allreduce_kernel``: the same
  ring once per chunk of ``csize = pass_elems(n)`` elements.

A wrapper takes one src and one dst tensor per rank (``src is dst`` runs
in place) and writes the result into the dst tensors. On CPU tensors it
runs the plain version; on CUDA tensors it launches the kernel or raises.
It returns a :class:`RingLaunch` whose ``done()``/``wait()`` raise if the
kernel reported a fault. Each wrapper counts its kernel launches in its
``launches`` attribute, a plain int.

The plain versions ``ring_allreduce_pass_ref`` /
``ring_allreduce_chunked_ref`` run the same steps over the same geometry
with PyTorch ops, so their results are bitwise those of the kernels and
of the JAX package's Pallas kernels in interpret mode. The chunked one
takes the chunk size as a parameter, so a test can use the JAX package's.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..constants import ReductionOp
from ..status import Status, UccError
from . import build

SOURCE = "ring_allreduce.cu"

#: per-rank elements one pass covers; counts above pass_elems(n) run the
#: chunked kernel. 1 Mi elements (4 MiB f32 per rank) keeps a chunk's
#: comm slots (2 x csize elements over all ranks, 8 MiB f32) resident in
#: the H100's 50 MB L2, so the neighbour exchange stays on chip, and keeps
#: the slot memory a fixed size whatever the count.
CHUNK_ELEMS = 1 << 20

#: threads per CTA
THREADS = 512

OPS = (ReductionOp.SUM, ReductionOp.AVG, ReductionOp.MAX, ReductionOp.MIN,
       ReductionOp.PROD)

#: torch dtype -> dtype code of the CUDA source
_DTYPE_CODES: Dict[torch.dtype, int] = {
    torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
    torch.int32: 3, torch.int64: 4,
}
SUPPORTED_DTYPES = tuple(_DTYPE_CODES)


def pass_elems(n: int) -> int:
    """Per-rank elements one pass covers (n-divisible), as
    ``_vmem_pass_elems`` is for the TPU kernels."""
    return max(n, (CHUNK_ELEMS // n) * n)


def pass_geometry(count: int, n: int) -> Tuple[int, int]:
    """(blk, n_chunks) of the pass kernel: one chunk, count padded to a
    multiple of n."""
    return -(-max(count, 1) // n), 1


def chunked_geometry(count: int, n: int,
                     csize: Optional[int] = None) -> Tuple[int, int]:
    """(blk, n_chunks) of the chunked kernel: count padded to a multiple
    of csize (default ``pass_elems(n)``), blk = csize / n."""
    csize = pass_elems(n) if csize is None else int(csize)
    if csize < n or csize % n:
        raise ValueError(f"chunk size {csize} is not a positive multiple "
                         f"of n={n}")
    return csize // n, -(-max(count, 1) // csize)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _accum(op: ReductionOp):
    return {ReductionOp.SUM: torch.add, ReductionOp.AVG: torch.add,
            ReductionOp.MAX: torch.maximum, ReductionOp.MIN: torch.minimum,
            ReductionOp.PROD: torch.mul}[op]


def _divide(x: torch.Tensor, n: int) -> torch.Tensor:
    """AVG's final division: in float32 for integer and 16-bit types,
    rounded (floats) or truncated (integers) back, as ``(x / n)`` then a
    cast does. The divisor is a tensor, so every device divides (PyTorch
    may turn division by a CPU scalar into a reciprocal multiply)."""
    f = x if x.dtype in (torch.float32, torch.float64) else x.float()
    return (f / torch.full_like(f, n)).to(x.dtype)


def ring_allreduce_ref(srcs: Sequence[torch.Tensor], op: ReductionOp,
                       blk: int, n_chunks: int) -> List[torch.Tensor]:
    """The ring step schedule over ranks and steps, for every chunk at
    once (chunks are independent): n-1 reduce-scatter steps, then n-1
    allgather steps, ``work[recv] = acc(work[recv], incoming)``."""
    n = len(srcs)
    count = srcs[0].numel()
    acc = _accum(op)
    work = torch.zeros((n, n_chunks, n, blk), dtype=srcs[0].dtype,
                       device=srcs[0].device)
    flat = work.view(n, -1)
    for r in range(n):
        flat[r, :count] = srcs[r].reshape(-1)
    for s in range(n - 1):
        # rank r-1 sends block r-1-s, which rank r folds into the same block
        sent = [work[r, :, (r - s) % n] for r in range(n)]
        for r in range(n):
            i = (r - s - 1) % n
            work[r, :, i] = acc(work[r, :, i], sent[(r - 1) % n])
    for s in range(n - 1):
        sent = [work[r, :, (r + 1 - s) % n] for r in range(n)]
        for r in range(n):
            work[r, :, (r - s) % n] = sent[(r - 1) % n]
    if op == ReductionOp.AVG:
        work = _divide(work, n)
        flat = work.view(n, -1)
    return [flat[r, :count] for r in range(n)]


def ring_allreduce_pass_ref(srcs: Sequence[torch.Tensor],
                            op: ReductionOp) -> List[torch.Tensor]:
    """Plain version of ``ring_allreduce_pass``."""
    blk, n_chunks = pass_geometry(srcs[0].numel(), len(srcs))
    return ring_allreduce_ref(srcs, op, blk, n_chunks)


def ring_allreduce_chunked_ref(srcs: Sequence[torch.Tensor],
                               op: ReductionOp,
                               csize: Optional[int] = None
                               ) -> List[torch.Tensor]:
    """Plain version of ``ring_allreduce_chunked`` (chunk size *csize*,
    default ``pass_elems(n)``)."""
    blk, n_chunks = chunked_geometry(srcs[0].numel(), len(srcs), csize)
    return ring_allreduce_ref(srcs, op, blk, n_chunks)


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

class RingWorkspace:
    """Comm slots, step flags and the error word of ring launches on one
    device, grown on demand and reused. Launches sharing a workspace must
    be ordered on one stream. The error word is sticky: once a launch has
    faulted, every later launch on the workspace reports it too."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._comm: Optional[torch.Tensor] = None
        self._flags: Optional[torch.Tensor] = None
        self.err: Optional[torch.Tensor] = None

    def get(self, comm_bytes: int, n_flags: int):
        if self._comm is None or self._comm.numel() < comm_bytes:
            self._comm = torch.empty(comm_bytes, dtype=torch.uint8,
                                     device=self.device)
        if self._flags is None or self._flags.numel() < n_flags:
            self._flags = torch.empty(n_flags, dtype=torch.int32,
                                      device=self.device)
        if self.err is None:
            self.err = torch.zeros(1, dtype=torch.int32, device=self.device)
        return self._comm, self._flags[:n_flags], self.err


class RingLaunch:
    """Completion handle of one wrapper call. On CUDA it holds the event
    recorded after the kernel and a pinned copy of the error word."""

    def __init__(self, stream=None, err: Optional[torch.Tensor] = None,
                 keep: tuple = ()):
        self._event = None
        self._err_host = None
        self._keep = keep          # buffers the kernel uses until done
        self.error = 0
        if err is not None:
            self._err_host = torch.empty(1, dtype=torch.int32,
                                         pin_memory=True)
            with torch.cuda.stream(stream):
                self._err_host.copy_(err, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(stream)

    def done(self) -> bool:
        """True once the launch has finished; raises UccError if the
        kernel reported a fault."""
        if self._event is not None:
            if not self._event.query():
                return False
            self._event = None
            self._keep = ()
            self.error = int(self._err_host[0])
        if self.error:
            raise UccError(Status.ERR_TIMED_OUT,
                           f"ring allreduce kernel: a spin-wait ran out "
                           f"(error word {self.error}); a peer CTA never "
                           "signalled")
        return True

    def wait(self) -> None:
        """Block until the launch has finished; raise on a kernel fault."""
        if self._event is not None:
            self._event.synchronize()
        self.done()


_lib = None
_max_ctas: Dict[tuple, int] = {}


def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        lib.ucc_ring_allreduce.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.ucc_ring_allreduce.restype = ctypes.c_int
        lib.ucc_ring_allreduce_max_ctas.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.ucc_ring_allreduce_max_ctas.restype = ctypes.c_int
        lib.ucc_ring_allreduce_error_string.argtypes = [ctypes.c_int]
        lib.ucc_ring_allreduce_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _cuda_check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.ucc_ring_allreduce_error_string(rc).decode()
        raise UccError(Status.ERR_NO_RESOURCE,
                       f"{what} failed: CUDA error {rc} ({msg})")


def _lanes(lib, chunked: int, code: int, n: int, blk: int,
           device: torch.device) -> int:
    """CTAs per rank: enough for one element per thread, no more than the
    card can hold resident for all n ranks (the spins need every CTA
    resident)."""
    key = (device.index, chunked, code)
    cap = _max_ctas.get(key)
    if cap is None:
        out = ctypes.c_int(0)
        _cuda_check(lib, lib.ucc_ring_allreduce_max_ctas(
            chunked, code, THREADS, ctypes.byref(out)), "occupancy query")
        cap = _max_ctas[key] = out.value
    if cap < n:
        raise UccError(Status.ERR_NO_RESOURCE,
                       f"a ring of {n} ranks needs {n} co-resident CTAs; "
                       f"this card holds {cap}")
    return max(1, min(cap // n, -(-blk // THREADS)))


def make_ptr_table(srcs: Sequence[torch.Tensor],
                   dsts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernel's device array of n src then n dst pointers."""
    ptrs = [t.data_ptr() for t in srcs] + [t.data_ptr() for t in dsts]
    return torch.tensor(ptrs, dtype=torch.int64, device=srcs[0].device)


def _check(srcs, dsts, op) -> Tuple[int, int]:
    n = len(srcs)
    if n < 1 or len(dsts) != n:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"need one src and one dst per rank (got {n} srcs, "
                       f"{len(dsts)} dsts)")
    if op not in OPS:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"ring allreduce does not implement op {op}")
    first = srcs[0]
    count = first.numel()
    for t in (*srcs, *dsts):
        if not isinstance(t, torch.Tensor):
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"ring allreduce buffers must be tensors, got "
                           f"{type(t).__name__}")
        if t.device != first.device or t.dtype != first.dtype or \
                t.numel() != count or not t.is_contiguous():
            raise UccError(Status.ERR_INVALID_PARAM,
                           "ring allreduce buffers must be contiguous and "
                           "agree in device, dtype and count")
    if first.dtype not in _DTYPE_CODES:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"ring allreduce does not implement {first.dtype}")
    return n, count


def _run(chunked: int, srcs, dsts, op, blk: int, n_chunks: int, stream,
         workspace: Optional[RingWorkspace],
         ptr_table: Optional[torch.Tensor]) -> RingLaunch:
    n, count = len(srcs), srcs[0].numel()
    device = srcs[0].device
    lib = _library()
    code = _DTYPE_CODES[srcs[0].dtype]
    if stream is None:
        stream = torch.cuda.current_stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        lanes = _lanes(lib, chunked, code, n, blk, device)
        ws = workspace if workspace is not None else RingWorkspace(device)
        comm, flags, err = ws.get(n * 2 * blk * srcs[0].element_size(),
                                  n * lanes * 2)
        if ptr_table is None:
            ptr_table = make_ptr_table(srcs, dsts)
        flags.zero_()
        _cuda_check(lib, lib.ucc_ring_allreduce(
            chunked, code, ptr_table.data_ptr(), comm.data_ptr(),
            flags.data_ptr(), err.data_ptr(), count, blk, n_chunks, n,
            int(op), lanes, THREADS, stream.cuda_stream),
            "ring allreduce launch")
    return RingLaunch(stream, err, keep=(ws, ptr_table))


def _dispatch(chunked: int, srcs, dsts, op, geometry, ref, stream,
              workspace, ptr_table) -> Optional[RingLaunch]:
    """None when the buffers lie on the CPU and the plain version already
    wrote them; otherwise the kernel's launch handle."""
    n, count = _check(srcs, dsts, op)
    device = srcs[0].device
    if device.type == "cpu":
        for d, out in zip(dsts, ref(srcs, op)):
            d.copy_(out)
        return None
    if device.type != "cuda":
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"ring allreduce runs on cuda or cpu tensors, not "
                       f"{device.type}")
    if count == 0:
        return None
    blk, n_chunks = geometry(count, n)
    return _run(chunked, srcs, dsts, op, blk, n_chunks, stream, workspace,
                ptr_table)


def ring_allreduce_pass(srcs: Sequence[torch.Tensor],
                        dsts: Sequence[torch.Tensor], op: ReductionOp, *,
                        stream=None, workspace: Optional[RingWorkspace] = None,
                        ptr_table: Optional[torch.Tensor] = None
                        ) -> RingLaunch:
    """One-pass ring allreduce of ``srcs`` into ``dsts`` (one per rank)."""
    h = _dispatch(0, srcs, dsts, op, pass_geometry, ring_allreduce_pass_ref,
                  stream, workspace, ptr_table)
    if h is None:
        return RingLaunch()
    ring_allreduce_pass.launches += 1
    return h


def ring_allreduce_chunked(srcs: Sequence[torch.Tensor],
                           dsts: Sequence[torch.Tensor], op: ReductionOp, *,
                           stream=None,
                           workspace: Optional[RingWorkspace] = None,
                           ptr_table: Optional[torch.Tensor] = None
                           ) -> RingLaunch:
    """Chunked ring allreduce of ``srcs`` into ``dsts`` (one per rank)."""
    h = _dispatch(1, srcs, dsts, op, chunked_geometry,
                  ring_allreduce_chunked_ref, stream, workspace, ptr_table)
    if h is None:
        return RingLaunch()
    ring_allreduce_chunked.launches += 1
    return h


ring_allreduce_pass.launches = 0
ring_allreduce_chunked.launches = 0
