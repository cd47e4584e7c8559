"""Generated device collectives: the CUDA kernel of ``csrc/gen_device.cu``
that runs a lowered DSL program over the n ranks of one device, its two
wrappers, its plain PyTorch version and the layer plan they share.

It replaces ``ucc_tpu/dsl/lower_device.py:_build_pallas_device_program``,
the Pallas kernel that runs a verified collective program as one launch.
``dsl/lower_device.py`` lowers a program into a :class:`GenPlan` (the
tables below); the kernel computes what the Pallas kernel computes for the
same tables, through one of two entry points:

- ``gen_device_ring``: a pure shift-by-one ring (``gen_ring``). Step t of
  rank r sends ``blk`` elements from offset ``tab[2t][r]`` to its right
  neighbour, which folds them with ``op`` (REDUCE) or overwrites (RECV) at
  ``tab[2t+1][r]``.
- ``gen_device_gen``: every other program, as a list of instructions, each
  one phase over all ranks. An exact layer: receiver q folds the run of its
  sender p (``src`` row) into its own. A wire layer (an edge tagged int8 or
  fp8) takes two: the sender quantizes its run per ``qblock`` (scale =
  amax · float32(1/QMAX), or 1 for a zero block; q = the value divided by
  the scale, rounded to int8
  (half to even, clipped to +-127) or to fp8-e4m3 (clipped to +-448)),
  writes the payload and the float32 scales into the receiver's single-use
  arena slot and its own decoded copy back into its run; then the receiver
  adds ``q * scale`` in float32. A copy moves one chunk within each rank.

AVG is SUM, then one multiply by ``dtype(1/n)``, as the JAX package's
kernel has it (integer AVG is refused by the task, where that factor is 0).

A wrapper takes one src and one dst tensor per rank (``src is dst`` runs in
place) and the plan, and writes the result into the dsts. On CPU tensors it
runs the plain version; on CUDA tensors it launches the kernel or raises.
``gen_device_ring.launches`` and ``gen_device_gen.launches`` count the
kernel's launches. The plain version ``gen_device_ref`` runs the same plan
step by step with PyTorch ops (unfused, in the kernel's rounding), so the
two agree bitwise; ``gen_device_torch_ops`` is the same code on any device,
the ``xla`` backend of ``UCC_GEN_DEVICE_BACKEND``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..constants import ReductionOp
from ..status import Status, UccError
from .ring_common import (DTYPE_CODES, OPS, THREADS, RingLaunch, RingSource,
                          RingWorkspace, accumulate, check_buffers,
                          make_ptr_table)

SOURCE = "gen_device.cu"

#: kernel numbers of the source
K_RING = 0
K_GEN = 1

#: instruction kinds of GenPlan.prog (csrc/gen_device.cu)
I_EXACT = 0
I_WSEND = 1
I_WRECV = 2
I_COPY = 3
#: words per instruction: kind, layer or copy index, length, reduce,
#: payload byte offset, scale byte offset, padded length, unused
INSTR_WORDS = 8
#: table rows per layer: send offset, has_send, recv offset, has_recv,
#: destination, source
TAB_ROWS = 6

QMODES = {"": 0, "int8": 1, "fp8": 2}
QMAX = {"int8": 127.0, "fp8": 448.0}


class _GenSource(RingSource):
    """gen_device.cu: the ring sources' occupancy query and error names,
    with a launch function of its own signature."""

    ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]


_SOURCE = _GenSource(SOURCE, "ucc_gen_device")


@dataclass
class GenPlan:
    """The tables of one lowered program at one count, in team ranks.

    ``ring``: ``tab`` is (2·steps, n) int32 of send and receive element
    offsets, ``prog`` (steps,) int64 of reduce flags, ``blk`` the step's
    elements. Otherwise ``tab`` is (6·layers, n) int32 (``TAB_ROWS``),
    ``ctab`` (3·copies, n) int32 of copy source offset, destination offset
    and flag, and ``prog`` (instructions, 8) int64. ``arena`` is the wire
    arena of one rank in bytes, ``span`` the longest run (what the lanes
    of a rank split)."""

    n: int
    count: int
    ring: bool
    tab: np.ndarray
    prog: np.ndarray
    ctab: np.ndarray
    blk: int = 0
    span: int = 0
    arena: int = 0
    qmode: str = ""
    qblock: int = 256
    #: the collective reduces (ALLREDUCE): AVG scales at the end
    reducing: bool = True
    _dev: Dict[torch.device, tuple] = field(default_factory=dict,
                                            repr=False)

    def device_tables(self, device: torch.device):
        """(tab, prog, ctab) on *device*, copied there once."""
        tabs = self._dev.get(device)
        if tabs is None:
            tabs = self._dev[device] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (self.tab, self.prog, self.ctab))
        return tabs


def avg_factor(dtype: torch.dtype, n: int) -> torch.Tensor:
    """AVG's factor, ``dtype(1/n)``, as the JAX package's kernel scales."""
    return torch.tensor(1.0 / n, dtype=torch.float64).to(dtype)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def quantize(x: torch.Tensor, qmode: str, qblock: int):
    """(payload, scales, decoded) of a float32 run, padded with zeros to
    whole blocks: the kernel's arithmetic, unfused."""
    L = x.numel()
    wl = -(-L // qblock) * qblock
    x2 = torch.nn.functional.pad(x, (0, wl - L)).view(-1, qblock)
    amax = x2.abs().amax(1)
    # amax times float32(1/QMAX): the JAX package's kernel divides by the
    # constant, and its compiler turns that into this multiply
    # (tensor divisors: PyTorch may turn division by a CPU scalar into a
    # reciprocal multiply)
    inv = torch.ones_like(amax[:1]) / torch.full_like(amax[:1], QMAX[qmode])
    scale = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
    scaled = x2 / scale[:, None]
    if qmode == "int8":
        q = scaled.round().clamp(-127.0, 127.0).to(torch.int8)
    else:
        q = scaled.clamp(-448.0, 448.0).to(torch.float8_e4m3fn)
    deq = (q.float() * scale[:, None]).reshape(-1)[:L]
    return q.reshape(-1), scale, deq


def dequantize(q: torch.Tensor, scale: torch.Tensor, L: int,
               qblock: int) -> torch.Tensor:
    return (q.float().view(-1, qblock) * scale[:, None]).reshape(-1)[:L]


def _run_plan(work: List[torch.Tensor], plan: GenPlan,
              op: Optional[ReductionOp]) -> None:
    """Run *plan* over the ranks' flat *work* tensors, in place, phase by
    phase as the kernel does (every send of a phase is read before any
    receive of it is written)."""
    n = plan.n
    acc = accumulate(op if op in OPS else ReductionOp.SUM)
    if plan.ring:
        blk = plan.blk
        for t, reduce in enumerate(plan.prog.tolist()):
            so, ro = plan.tab[2 * t], plan.tab[2 * t + 1]
            sent = [work[r][so[r]:so[r] + blk].clone() for r in range(n)]
            for r in range(n):
                inc = sent[(r - 1) % n]
                cur = work[r][ro[r]:ro[r] + blk]
                cur.copy_(acc(cur, inc) if reduce else inc)
    else:
        payload = {}
        for kind, li, L, reduce, _, _, _, _ in plan.prog.tolist():
            if kind == I_COPY:
                so, do, has = plan.ctab[3 * li:3 * li + 3]
                for r in range(n):
                    if has[r]:
                        work[r][do[r]:do[r] + L] = \
                            work[r][so[r]:so[r] + L].clone()
                continue
            so, hs, ro, hr, _, src = plan.tab[TAB_ROWS * li:
                                              TAB_ROWS * (li + 1)]
            if kind == I_WSEND:
                for p in range(n):
                    if hs[p]:
                        run = work[p][so[p]:so[p] + L]
                        q, scale, deq = quantize(run.float(), plan.qmode,
                                                 plan.qblock)
                        run.copy_(deq.to(run.dtype))
                        payload[(li, p)] = (q, scale)
                continue
            if kind == I_EXACT:
                sent = {p: work[p][so[p]:so[p] + L].clone()
                        for p in range(n) if hs[p]}
            for q in range(n):
                if not hr[q]:
                    continue
                cur = work[q][ro[q]:ro[q] + L]
                if kind == I_EXACT:
                    inc = sent[src[q]]
                    cur.copy_(acc(cur, inc) if reduce else inc)
                else:
                    inc = dequantize(*payload.pop((li, int(src[q]))), L,
                                     plan.qblock)
                    cur.copy_((cur.float() + inc if reduce else inc)
                              .to(cur.dtype))
    if plan.reducing and op == ReductionOp.AVG:
        f = avg_factor(work[0].dtype, n).to(work[0].device)
        for w in work:
            w.mul_(f)


def gen_device_ref(srcs: Sequence[torch.Tensor], plan: GenPlan,
                   op: Optional[ReductionOp]) -> List[torch.Tensor]:
    """Plain version of both entry points: each rank's result."""
    work = [s.reshape(-1).clone() for s in srcs]
    _run_plan(work, plan, op)
    return work


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(what, srcs, dsts, op, plan: GenPlan):
    n, count = check_buffers(what, srcs, dsts, op if plan.reducing else None,
                             OPS if plan.reducing else None,
                             lambda c, n: c)
    if n != plan.n or count != plan.count:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"{what}: the plan is for {plan.n} ranks of "
                       f"{plan.count} elements, got {n} of {count}")
    if plan.qmode and srcs[0].dtype != torch.float32:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"{what}: wire layers take float32, not "
                       f"{srcs[0].dtype}")
    if count >= 1 << 31:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"{what}: the tables hold 32-bit offsets; {count} "
                       "elements per rank is too many")
    return n, count


def _dispatch(kernel: int, what: str, srcs, dsts, op, plan: GenPlan, stream,
              workspace, ptr_table) -> Optional[RingLaunch]:
    """None when the buffers lie on the CPU and the plain version already
    wrote them; otherwise the kernel's launch handle."""
    n, count = _check(what, srcs, dsts, op, plan)
    device = srcs[0].device
    if device.type == "cpu":
        for d, out in zip(dsts, gen_device_ref(srcs, plan, op)):
            d.copy_(out)
        return None
    if device.type != "cuda":
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"{what} runs on cuda or cpu tensors, not "
                       f"{device.type}")
    dtype = srcs[0].dtype
    code = DTYPE_CODES[dtype]
    avg = int(plan.reducing and op == ReductionOp.AVG)
    alpha = float(avg_factor(dtype, n)) if avg else 0.0
    if stream is None:
        stream = torch.cuda.current_stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        lanes = _SOURCE.lanes(kernel, code, n, plan.span, device)
        ws = workspace if workspace is not None else RingWorkspace(device)
        if plan.ring:
            comm_bytes = n * 2 * plan.blk * srcs[0].element_size()
            n_flags = n * lanes * 2
        else:
            comm_bytes, n_flags = n * plan.arena, 1
        comm, flags, err = ws.get(max(comm_bytes, 16), n_flags)
        tab, prog, ctab = plan.device_tables(device)
        if ptr_table is None:
            ptr_table = make_ptr_table(srcs, dsts)
        flags.zero_()
        _SOURCE.check(_SOURCE.lib().ucc_gen_device(
            kernel, code, ptr_table.data_ptr(), comm.data_ptr(),
            flags.data_ptr(), err.data_ptr(), tab.data_ptr(),
            prog.data_ptr(), ctab.data_ptr(), count, plan.blk, plan.arena,
            len(prog), n, 0 if op is None else int(op), avg, alpha,
            QMODES[plan.qmode], plan.qblock, lanes, THREADS,
            stream.cuda_stream), f"{what} launch")
    return RingLaunch(stream, err, keep=(ws, ptr_table, tab, prog, ctab),
                      what=what)


def gen_device_ring(srcs: Sequence[torch.Tensor],
                    dsts: Sequence[torch.Tensor], op: Optional[ReductionOp],
                    *, plan: GenPlan, root: int = 0, stream=None,
                    workspace: Optional[RingWorkspace] = None,
                    ptr_table: Optional[torch.Tensor] = None) -> RingLaunch:
    """The ring entry point: a shift-by-one ring *plan* over ``srcs``
    into ``dsts``; ``root`` is in the plan's tables already."""
    if not plan.ring:
        raise UccError(Status.ERR_INVALID_PARAM,
                       "gen_device_ring takes a ring plan")
    h = _dispatch(K_RING, "generated ring", srcs, dsts, op, plan, stream,
                  workspace, ptr_table)
    if h is None:
        return RingLaunch()
    gen_device_ring.launches += 1
    return h


def gen_device_gen(srcs: Sequence[torch.Tensor],
                   dsts: Sequence[torch.Tensor], op: Optional[ReductionOp],
                   *, plan: GenPlan, root: int = 0, stream=None,
                   workspace: Optional[RingWorkspace] = None,
                   ptr_table: Optional[torch.Tensor] = None) -> RingLaunch:
    """The general entry point: the layers and copies of *plan* over
    ``srcs`` into ``dsts``; ``root`` is in the plan's tables already."""
    if plan.ring:
        raise UccError(Status.ERR_INVALID_PARAM,
                       "gen_device_gen takes a layer plan")
    h = _dispatch(K_GEN, "generated collective", srcs, dsts, op, plan,
                  stream, workspace, ptr_table)
    if h is None:
        return RingLaunch()
    gen_device_gen.launches += 1
    return h


def gen_device_torch_ops(srcs: Sequence[torch.Tensor],
                         dsts: Sequence[torch.Tensor],
                         op: Optional[ReductionOp], *, plan: GenPlan,
                         root: int = 0, stream=None, workspace=None,
                         ptr_table=None) -> RingLaunch:
    """The plan as PyTorch ops on the ranks' own device, on *stream*: the
    ``xla`` backend, which UCC_GEN_DEVICE_BACKEND=xla asks for."""
    _check("generated collective (torch ops)", srcs, dsts, op, plan)
    device = srcs[0].device
    if device.type != "cuda":
        for d, out in zip(dsts, gen_device_ref(srcs, plan, op)):
            d.copy_(out)
        return RingLaunch()
    with torch.cuda.device(device), torch.cuda.stream(stream):
        for s, d in zip(srcs, dsts):
            if d.data_ptr() != s.data_ptr():
                d.copy_(s)
        _run_plan([d.reshape(-1) for d in dsts], plan, op)
    return RingLaunch(stream, keep=(srcs, dsts), what="torch ops")


gen_device_ring.launches = 0
gen_device_gen.launches = 0
