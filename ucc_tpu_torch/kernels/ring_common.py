"""Launch plumbing shared by the ring kernels (``kernels/ring_allreduce.py``,
``kernels/ring_rs_ag.py``, ``kernels/ring_bcast_a2a.py``,
``kernels/gen_device.py``): the dtypes and ops they take, the elementwise
fold of their plain versions, the reused workspace, the completion handle,
the device pointer table, the buffer checks and the launch itself.

Every ring source under ``csrc/`` exports the same plain C interface, named
by its prefix P: ``P(kernel, dtype, ptrs, comm, flags, err, a, b, n_chunks,
n, op, root, lanes, threads, lo, hi, stream)`` launches kernel number
*kernel* of the source, where ``a``, ``b`` and ``n_chunks`` are the
kernel's geometry, ``root`` the rank a rooted collective starts from (0 for
the others) and ``[lo, hi)`` the part of the kernel's walk the launch does;
``P_max_ctas`` is the occupancy query and ``P_error_string`` names a CUDA
error.

The walk of a direct source is a line of elements that its kernel already
cuts into 16-byte vectors: the allreduce's and the bcast's ``count``
elements, the reduce_scatter's ``n·blk`` output elements (rank r's element
i at ``r·blk + i``), the allgather's ``n·count`` copied elements (src b's
element e at ``b·count + e``) and the alltoall's ``n(n+1)/2·blk`` unit
elements (unit u's element e at ``u·blk + e``). A team in one process
launches the whole walk; a team that spans P processes (tl/device_sync)
launches part p of P in process p (``part=(p, P)``, cut by
``part_bounds`` at multiples of the vector width), over the pointer table
of all n ranks. Every element's result depends on its index alone, so the
union of the parts is bitwise the whole launch. The plain versions take
the same part: they write only its elements (``write_part``).

Two kinds of source stand behind the interface:

- a direct source (``ring_allreduce.cu``, ``reduce_scatter.cu``,
  ``allgather.cu``, ``alltoall.cu``, ``bcast.cu``) runs no ring: one pass
  folds each element from the n srcs in the ring's order, bitwise the
  ring's result (the allgather, the alltoall and the bcast only copy: the
  allgather each src into its block of every dst, the alltoall each
  element by the thread that owns it, the bcast from the root's src
  alone). Its kernel spins on nothing, ignores ``comm``, ``flags`` and
  ``err`` (and the copies' ``op``), and runs an ordinary launch
  (:class:`DirectSource`);
- a cooperative source (:class:`RingSource`) runs a cooperative launch on
  a ``(lanes, n)`` grid whose CTAs spin on flags in the workspace, with an
  error word: only ``gen_device.cu``'s layer kernel (its own C signature,
  ``kernels/gen_device._GenSource``) is one.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..constants import ReductionOp
from ..status import Status, UccError
from . import build

#: threads per CTA
THREADS = 512

OPS = (ReductionOp.SUM, ReductionOp.AVG, ReductionOp.MAX, ReductionOp.MIN,
       ReductionOp.PROD)

#: torch dtype -> dtype code of the CUDA sources (csrc/ring_common.cuh):
#: every type of csrc/ec_reduce.cu but uint16, uint32 and uint64, for which
#: torch has no add, maximum or minimum on the CPU, where the plain versions
#: run
DTYPE_CODES: Dict[torch.dtype, int] = {
    torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
    torch.int32: 3, torch.int64: 4, torch.int8: 5, torch.uint8: 6,
    torch.int16: 7, torch.float64: 8,
}
SUPPORTED_DTYPES = tuple(DTYPE_CODES)


# ---------------------------------------------------------------------------
# arithmetic of the plain versions
# ---------------------------------------------------------------------------

def accumulate(op: ReductionOp):
    """The fold ``acc(local, incoming)`` of a ring step."""
    return {ReductionOp.SUM: torch.add, ReductionOp.AVG: torch.add,
            ReductionOp.MAX: torch.maximum, ReductionOp.MIN: torch.minimum,
            ReductionOp.PROD: torch.mul}[op]


def divide(x: torch.Tensor, n: int) -> torch.Tensor:
    """AVG's final division: in float32 for integer and 16-bit types,
    rounded (floats) or truncated (integers) back, as ``(x / n)`` then a
    cast does. The divisor is a tensor, so every device divides (PyTorch
    may turn division by a CPU scalar into a reciprocal multiply)."""
    f = x if x.dtype in (torch.float32, torch.float64) else x.float()
    return (f / torch.full_like(f, n)).to(x.dtype)


# ---------------------------------------------------------------------------
# workspace, completion, pointer table
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
    recorded after the work on *stream* and, for a kernel with an error
    word *err*, a pinned copy of that word."""

    def __init__(self, stream=None, err: Optional[torch.Tensor] = None,
                 keep: tuple = (), what: str = "ring"):
        self._event = None
        self._err_host = None
        self._keep = keep          # buffers the kernel uses until done
        self.what = what           # the collective, for error texts
        self.error = 0
        if err is not None:
            self._err_host = torch.empty(1, dtype=torch.int32,
                                         pin_memory=True)
            with torch.cuda.stream(stream):
                self._err_host.copy_(err, non_blocking=True)
        if stream is not None:
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
            if self._err_host is not None:
                self.error = int(self._err_host[0])
        if self.error:
            raise UccError(Status.ERR_TIMED_OUT,
                           f"{self.what} kernel: a spin-wait ran out "
                           f"(error word {self.error}); a peer CTA never "
                           "signalled")
        return True

    def wait(self) -> None:
        """Block until the launch has finished; raise on a kernel fault."""
        if self._event is not None:
            self._event.synchronize()
        self.done()


def make_ptr_table(srcs: Sequence[torch.Tensor],
                   dsts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernel's device array of n src then n dst pointers."""
    ptrs = [t.data_ptr() for t in srcs] + [t.data_ptr() for t in dsts]
    return torch.tensor(ptrs, dtype=torch.int64, device=srcs[0].device)


# ---------------------------------------------------------------------------
# checks and launch
# ---------------------------------------------------------------------------

def check_buffers(what: str, srcs, dsts, op, ops,
                  dst_count: Callable[[int, int], int]) -> Tuple[int, int]:
    """(n, src count) of a wrapper call, after checking one src and one dst
    per rank, the op (``ops`` None: the collective takes no op), and that
    every buffer is a contiguous tensor of one device and dtype, srcs of
    one count and dsts of ``dst_count(count, n)``."""
    n = len(srcs)
    if n < 1 or len(dsts) != n:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"{what}: need one src and one dst per rank (got {n} "
                       f"srcs, {len(dsts)} dsts)")
    if ops is not None and op not in ops:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"{what} does not implement op {op}")
    for t in (*srcs, *dsts):
        if not isinstance(t, torch.Tensor):
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"{what} buffers must be tensors, got "
                           f"{type(t).__name__}")
    first = srcs[0]
    count = first.numel()
    want = dst_count(count, n)
    for t, c in [(t, count) for t in srcs] + [(t, want) for t in dsts]:
        if t.device != first.device or t.dtype != first.dtype or \
                t.numel() != c or not t.is_contiguous():
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"{what} buffers must be contiguous and agree in "
                           f"device and dtype, with {count} elements per src "
                           f"and {want} per dst")
    if first.dtype not in DTYPE_CODES:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"{what} does not implement {first.dtype}")
    return n, count


#: (a, b, n_chunks, span, slot_elems, flag_words) of a launch: the kernel's
#: geometry, the elements one grid walks, and the comm slot elements per
#: rank and flag words per (rank, lane) it asks of the workspace (0 for
#: every direct source)
Plan = Tuple[int, int, int, int, int, int]


class RingSource:
    """One CUDA source of ring kernels, built and loaded at first use: its
    library, occupancy query and error names. ``ARGTYPES`` is the
    signature of its launch function (the common interface above; a source
    with another one subclasses); :class:`DirectSource` launches it, and
    ``kernels/gen_device.py`` launches its own."""

    ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_void_p]

    def __init__(self, source: str, prefix: str):
        self.source = source
        self.prefix = prefix
        self._lib = None
        self._max_ctas: Dict[tuple, int] = {}

    def lib(self):
        if self._lib is None:
            lib = build.load(self.source)
            launch = getattr(lib, self.prefix)
            launch.argtypes = self.ARGTYPES
            launch.restype = ctypes.c_int
            query = getattr(lib, self.prefix + "_max_ctas")
            query.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int)]
            query.restype = ctypes.c_int
            names = getattr(lib, self.prefix + "_error_string")
            names.argtypes = [ctypes.c_int]
            names.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = getattr(self.lib(), self.prefix + "_error_string")(rc)
            raise UccError(Status.ERR_NO_RESOURCE,
                           f"{what} failed: CUDA error {rc} ({msg.decode()})")

    def max_ctas(self, kernel: int, code: int, device: torch.device,
                 threads: int = THREADS) -> int:
        """CTAs of *threads* threads that the card holds resident at once
        for the kernel of this dtype (each compiled kernel has its own
        register count); queried once and kept."""
        key = (device.index, self.source, kernel, code, threads)
        cap = self._max_ctas.get(key)
        if cap is None:
            out = ctypes.c_int(0)
            self.check(getattr(self.lib(), self.prefix + "_max_ctas")(
                kernel, code, threads, ctypes.byref(out)),
                f"{self.source} occupancy query")
            cap = self._max_ctas[key] = out.value
        return cap

    def lanes(self, kernel: int, code: int, n: int, span: int,
              device: torch.device) -> int:
        """CTAs per rank: enough for one element per thread of a chunk, no
        more than the card can hold resident for all n ranks (the spins
        need every CTA resident)."""
        cap = self.max_ctas(kernel, code, device)
        if cap < n:
            raise UccError(Status.ERR_NO_RESOURCE,
                           f"a ring of {n} ranks needs {n} co-resident CTAs; "
                           f"this card holds {cap}")
        return max(1, min(cap // n, -(-span // THREADS)))


#: threads per CTA of a direct source's kernel (THREADS in
#: csrc/direct_fold.cuh)
DIRECT_THREADS = 256
#: bytes of one vector access of a direct source's kernel
VECTOR_BYTES = 16


def launch_ctas(count: int, elem_size: int, cap: int) -> int:
    """CTAs of one grid over *count* elements: one thread per 16-byte
    vector, so a small count still spreads over the SMs, and no more than
    *cap* (the CTAs the card holds at once, from the occupancy query); the
    kernel walks the rest grid-stride."""
    vectors = -(-count * elem_size // VECTOR_BYTES)
    return max(1, min(cap, -(-vectors // DIRECT_THREADS)))


class DirectSource(RingSource):
    """A source whose one kernel reads the ranks' buffers directly and
    takes no comm slots, flag words or error word. A launch asks the
    workspace for nothing, zeroes nothing and copies no error word back,
    and it needs no co-resident CTAs: nothing spins.

    The plan's ``span`` is the elements one grid walks. Without
    *per_rank* the kernel runs one 1-D grid of ``launch_ctas(span, ...)``
    CTAs (the allreduce and the bcast, span = count; the allgather, span =
    n·count; the alltoall, span = the elements of its n(n+1)/2 units);
    with it, one row of CTAs per rank
    (the reduce_scatter, span = blk), the n rows sharing the card's CTAs.
    The C function is passed the CTAs of one row, and op 0 when the
    collective takes none."""

    def __init__(self, source: str, prefix: str, per_rank: bool = False):
        super().__init__(source, prefix)
        self.per_rank = per_rank

    def row_ctas(self, span: int, elem_size: int, cap: int, n: int) -> int:
        """CTAs of one row of a launch of n ranks, for a card that holds
        *cap* CTAs at once."""
        return launch_ctas(span, elem_size,
                           max(1, cap // n) if self.per_rank else cap)

    def launch(self, what: str, kernel: int, srcs, dsts, op, root: int,
               plan: Plan, stream, workspace: Optional[RingWorkspace],
               ptr_table: Optional[torch.Tensor],
               bounds: Optional[Tuple[int, int]] = None) -> RingLaunch:
        """*bounds*: the part [lo, hi) of the walk to launch (None: all of
        it, ``plan``'s span times n rows for a per-rank source)."""
        a, b, n_chunks, span = plan[:4]
        n = len(srcs)
        rows = n if self.per_rank else 1
        lo, hi = (0, span * rows) if bounds is None else bounds
        if self.per_rank:
            rows = (hi - 1) // span - lo // span + 1
            span = min(span, hi - lo)
        else:
            span = hi - lo
        device = srcs[0].device
        code = DTYPE_CODES[srcs[0].dtype]
        if stream is None:
            stream = torch.cuda.current_stream(device)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            ctas = self.row_ctas(
                span, srcs[0].element_size(),
                self.max_ctas(kernel, code, device, DIRECT_THREADS), rows)
            if ptr_table is None:
                ptr_table = make_ptr_table(srcs, dsts)
            self.check(getattr(self.lib(), self.prefix)(
                kernel, code, ptr_table.data_ptr(), None, None, None, a, b,
                n_chunks, n, 0 if op is None else int(op), root, ctas,
                DIRECT_THREADS, lo, hi,
                stream.cuda_stream),
                f"{what} launch")
        return RingLaunch(stream, keep=(ptr_table,), what=what)


def part_bounds(walk: int, part: Tuple[int, int],
                elem_size: int) -> Tuple[int, int]:
    """[lo, hi) of part p of P (``part = (p, P)``) of a walk of *walk*
    elements: near-equal parts, cut at multiples of the 16-byte vector's
    elements so that every part keeps the vector path; a walk too short
    for P parts leaves the last ones empty."""
    p, nparts = part
    if not 0 <= p < nparts:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"part {p} of {nparts} does not exist")
    w = max(1, VECTOR_BYTES // elem_size)

    def cut(i):
        return min(walk, -(-walk * i // (nparts * w)) * w)
    return cut(p), cut(p + 1)


def write_part(dsts, outs, pieces) -> None:
    """Copy the part's elements of the plain version's results *outs* into
    *dsts*: ``pieces`` lists (rank, dst start, dst stop) of the part."""
    for r, a, b in pieces:
        dsts[r][a:b].copy_(outs[r][a:b])


def dispatch(source: DirectSource, kernel: int, what: str, srcs, dsts, op, *,
             ops, dst_count: Callable[[int, int], int],
             ref: Callable[[], List[torch.Tensor]],
             plan: Callable[[int, int], Plan], stream, workspace,
             ptr_table, root: int = 0,
             part: Optional[Tuple[int, int]] = None,
             walk: Optional[Callable[[int, int], int]] = None,
             pieces: Optional[Callable] = None) -> Optional[RingLaunch]:
    """One wrapper call: None when the buffers lie on the CPU and the plain
    version ``ref()`` already wrote them (its whole result is computed
    before any dst is written, so in place is safe), or when there is
    nothing to move; otherwise the kernel's launch handle.

    *part* ``(p, P)`` launches part p of P of the walk (``walk(count, n)``
    elements), and on the CPU writes only the part's elements of the plain
    version's result (``pieces(count, n, lo, hi)``); an empty part moves
    nothing."""
    n, count = check_buffers(what, srcs, dsts, op, ops, dst_count)
    device = srcs[0].device
    bounds = None
    if part is not None and part[1] > 1:
        bounds = part_bounds(walk(count, n), part, srcs[0].element_size())
    if device.type == "cpu":
        if bounds is None:
            for d, out in zip(dsts, ref()):
                d.copy_(out)
        elif bounds[0] < bounds[1]:
            write_part(dsts, ref(), pieces(count, n, *bounds))
        return None
    if device.type != "cuda":
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"{what} runs on cuda or cpu tensors, not "
                       f"{device.type}")
    if count == 0 or (bounds is not None and bounds[0] >= bounds[1]):
        return None
    return source.launch(what, kernel, srcs, dsts, op, root, plan(count, n),
                         stream, workspace, ptr_table, bounds)
