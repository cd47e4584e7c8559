"""Generated device collectives: the CUDA kernels that run a lowered DSL
program over the n ranks of one device (``csrc/gen_fold.cu`` for exact
plans, ``csrc/gen_device.cu`` for plans with wire layers), their two
wrappers, their plain PyTorch versions and the plans they share.

They replace ``ucc_tpu/dsl/lower_device.py:_build_pallas_device_program``,
the Pallas kernel that runs a verified collective program as one launch.
``dsl/lower_device.py`` lowers a program into a :class:`GenPlan` (the
tables below), of one of two shapes:

- a ring plan, for a pure shift-by-one ring (``gen_ring``), taken by
  ``gen_device_ring``: step t of rank r sends ``blk`` elements from offset
  ``tab[2t][r]`` to its right neighbour, which folds them with ``op``
  (REDUCE) or overwrites (RECV) at ``tab[2t+1][r]``;
- a layer plan, for every other program, taken by ``gen_device_gen``: a
  list of instructions, each one phase over all ranks. An exact layer:
  receiver q folds the run of its sender p (``src`` row) into its own. A
  wire layer (an edge tagged int8 or fp8) takes two: the sender quantizes
  its run per ``qblock`` (scale = amax · float32(1/QMAX), or 1 for a zero
  block; q = the value divided by the scale, rounded to int8 (half to
  even, clipped to +-127) or to fp8-e4m3 (clipped to +-448)), writes the
  payload and the float32 scales into the receiver's single-use arena slot
  and its own decoded copy back into its run; then the receiver adds
  ``q * scale`` in float32. A copy moves one chunk within each rank.

Three routes run them on the card, chosen on the host from the plan
alone. :func:`fold_plan` runs a plan's steps on symbolic units
(:func:`fold_exprs`). When every unit of an exact plan ends, on every
rank, as one expression over that same unit of the srcs (every
registered program does), the plan is a :class:`FoldPlan`, one short
program per unit, and ``csrc/gen_fold.cu`` evaluates it in one flag-free
pass, an ordinary launch with no workspace. A wire plan's units end as
expressions with one more operation, QDQ (a wire send: quantize per
qblock group, decode), and its ranks need not agree (each gather layer
re-quantizes); when its qblock groups lie inside units and each rank's
expression is a top of one program per unit, its fold plan adds STORE
steps, and ``csrc/gen_device.cu``'s wire fold evaluates it in one
flag-free pass, one warp per qblock group. The other wire plans keep the
cooperative layer kernel of ``csrc/gen_device.cu``, layer by layer behind
grid-wide barriers, with its workspace and error word.

AVG is SUM, then one multiply by ``dtype(1/n)``, as the JAX package's
kernel has it (integer AVG is refused by the task, where that factor is 0).

A wrapper takes one src and one dst tensor per rank (``src is dst`` runs in
place) and the plan, and writes the result into the dsts. On CPU tensors it
runs the plain version; on CUDA tensors it launches a kernel or raises.
``launches`` counts a wrapper's launches on either route,
``fold_launches`` those on the fold route. The plain version
``gen_device_ref`` runs the plan step by step with PyTorch ops (unfused,
in the kernels' rounding), so the kernels agree with it bitwise;
``gen_device_fold_ref`` evaluates the fold plan in the fold kernels'
order, bitwise ``gen_device_ref`` (the tests hold it so; nothing on the
CUDA path calls it). ``gen_device_torch_ops`` is ``gen_device_ref``'s code
on any device, the ``xla`` backend of ``UCC_GEN_DEVICE_BACKEND``.

On a team whose ranks span the processes of one host (tl/device_sync),
process p of P calls a wrapper with ``part=(p, P)`` over every rank's
buffers (:func:`part_walk`): the fold route folds a range of elements, the
wire fold a range of whole qblock groups, and both write every rank's dst
there, so the union of the parts is bitwise the single launch; the layer
kernel, a cooperative launch with a grid barrier, runs whole in process 0
and not at all in the others. On the CPU a part writes only its elements
of the plain version's result.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..constants import ReductionOp
from ..status import Status, UccError
from .ring_common import (DIRECT_THREADS, DTYPE_CODES, OPS, THREADS,
                          RingLaunch, RingSource, RingWorkspace, accumulate,
                          check_buffers, launch_ctas, make_ptr_table,
                          part_bounds, write_part)

SOURCE = "gen_device.cu"
FOLD_SOURCE = "gen_fold.cu"
#: gen_fold.cu's part instances, a library of their own
FOLD_PART_SOURCE = "gen_fold_part.cu"

#: kernel numbers of gen_device.cu: the layer kernel, then the wire
#: fold's instances from WIRE_KERNELS on (:func:`wire_kernel`)
K_GEN = 0
WIRE_KERNELS = 1

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
    with a launch function of its own signature for the layer kernel and
    one for the wire fold (``ucc_gen_wire_fold``: kernel, pointer table,
    units, code, count, unit, qblock, n, op, avg, alpha, CTAs, threads,
    first and end group, stream)."""

    ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    WIRE_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_double, ctypes.c_int, ctypes.c_int,
                     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]

    def lib(self):
        if self._lib is None:
            wire = super().lib().ucc_gen_wire_fold
            wire.argtypes = self.WIRE_ARGTYPES
            wire.restype = ctypes.c_int
        return self._lib


class _FoldSource(RingSource):
    """gen_fold.cu (the whole walk) or gen_fold_part.cu (its part
    instances): the occupancy query and error names of the ring sources,
    with a launch function of its own signature (dtype, pointer table,
    units, code, count, unit, n, op, alpha, CTAs, threads, first and end
    element, stream)."""

    ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_void_p]


_SOURCE = _GenSource(SOURCE, "ucc_gen_device")
_FOLD = _FoldSource(FOLD_SOURCE, "ucc_gen_fold")
_FOLD_PART = _FoldSource(FOLD_PART_SOURCE, "ucc_gen_fold")


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
    #: (fold_plan's result,) once computed
    _fold: Optional[tuple] = field(default=None, repr=False)

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
# fold plans: an exact program as one expression per unit
# ---------------------------------------------------------------------------

#: step kinds of a fold program (csrc/gen_fold.cu). A leaf step takes the
#: next leaf x (rank q's src at the element): LOAD pushes x; FOLD_L makes
#: the top acc(x, top), FOLD_R acc(top, x). COMB pops the value below the
#: top and makes the top acc(below, top), COMB_SWAP acc(top, below).
S_LOAD, S_FOLD_L, S_FOLD_R, S_COMB, S_COMB_SWAP = range(5)
#: step kinds that only wire programs have (csrc/gen_device.cu's wire
#: fold): QDQ quantizes the top per qblock group and decodes it; WADD pops
#: the value below the top and makes the top below + top in float32 (a
#: wire receive that reduces, the receiver first), WADD_SWAP top + below;
#: STORE writes the top into the next store rank's dst
S_QDQ, S_WADD, S_WADD_SWAP, S_STORE = range(5, 9)
#: values a fold program may hold at once (csrc/gen_fold.cu: STACK)
FOLD_STACK = 5
#: words of a program before its leaf ranks: steps, leaves, and the rank
#: of its only leaf (-1 when it has more); a wire program's third word is
#: its number of stores, whose ranks follow the leaf ranks
FOLD_HEADER = 3
#: the widest qblock of a wire fold plan: one warp's group, at most 8
#: float32 values a lane (csrc/gen_device.cu: WIRE_MAX_QBLOCK)
WIRE_MAX_QBLOCK = 256
#: threads of a wire fold CTA (csrc/gen_device.cu: WIRE_THREADS)
WIRE_THREADS = 128


@dataclass
class FoldPlan:
    """A plan as one program per unit of ``unit`` elements.

    Exact plans (``qmode`` empty): element i of unit j ends, on every rank,
    as the fold program ``code[units[j]:]`` over element j·unit + i of the
    leaves' srcs (each leaf a rank's src at the same element). A program
    is ``FOLD_HEADER`` words, its leaf ranks in the order its steps take
    them, then its step kinds; units with one expression share one
    program.

    Wire plans (``qmode`` int8 or fp8): the ranks' expressions of a unit
    are the tops of one program at its STORE steps. A program is
    ``FOLD_HEADER`` words (steps, leaves, stores), its leaf ranks, its
    store ranks in the order its STORE steps take them, then its step
    kinds; QDQ runs per group of ``qblock`` elements counted from the
    unit's start, the last one partial. ``depth`` is the most values the
    programs hold at once."""

    unit: int
    depth: int
    units: np.ndarray
    code: np.ndarray
    qmode: str = ""
    qblock: int = 0
    _dev: Dict[torch.device, tuple] = field(default_factory=dict,
                                            repr=False)

    def device_tables(self, device: torch.device):
        """(units, code) on *device*, copied there once."""
        tabs = self._dev.get(device)
        if tabs is None:
            tabs = self._dev[device] = tuple(
                torch.from_numpy(a).to(device)
                for a in (self.units, self.code))
        return tabs

    def program(self, j: int):
        """(leaf ranks, step kinds) of unit j's program."""
        off = int(self.units[j])
        steps, leaves, third = self.code[off:off + FOLD_HEADER].tolist()
        first = off + FOLD_HEADER + leaves + (third if self.qmode else 0)
        return (self.code[off + FOLD_HEADER:
                          off + FOLD_HEADER + leaves].tolist(),
                self.code[first:first + steps].tolist())

    def stores(self, j: int) -> List[int]:
        """The ranks whose dsts unit j's wire program stores into, in the
        order of its STORE steps."""
        off = int(self.units[j])
        _, leaves, stores = self.code[off:off + FOLD_HEADER].tolist()
        first = off + FOLD_HEADER + leaves
        return self.code[first:first + stores].tolist()


def fold_unit(plan: GenPlan) -> int:
    """The largest run of elements that every step of *plan* moves whole:
    the gcd of the count, the block and every offset and length of its
    tables."""
    vals = [plan.count]
    if plan.ring:
        vals += [plan.blk, *plan.tab.ravel().tolist()]
    else:
        rows = plan.tab.reshape(-1, TAB_ROWS, plan.n) \
            if len(plan.tab) % TAB_ROWS == 0 else plan.tab[:0]
        vals += plan.prog[:, 2].tolist() + rows[:, 0].ravel().tolist() + \
            rows[:, 2].ravel().tolist() + plan.ctab[0::3].ravel().tolist() + \
            plan.ctab[1::3].ravel().tolist()
    return math.gcd(*(int(v) for v in vals))


def has_wire(plan: GenPlan) -> bool:
    """Whether *plan* has a wire layer (an int8 or fp8 edge)."""
    return not plan.ring and \
        bool(np.isin(plan.prog[:, 0], (I_WSEND, I_WRECV)).any())


def fold_exprs(plan: GenPlan):
    """*plan* run on symbolic units, phase by phase as ``_run_plan`` runs
    it (every send of a phase is read before any receive of it is
    written). Returns (unit, nodes, final): ``nodes[e]`` is ``(0, q, j)``
    for unit j of rank q's src, ``(1, cur, inc)`` for ``acc(cur, inc)``,
    ``(2, x)`` for x quantized per qblock group and decoded (a wire send:
    the groups counted from the unit's start) and ``(3, cur, inc)`` for
    ``cur + inc`` in float32 (a wire receive that reduces), hash-consed,
    and ``final[r][j]`` the expression unit j of rank r ends as. None when
    a wire run is longer than a unit and the unit is no multiple of
    qblock: its groups then straddle units."""
    unit = fold_unit(plan)
    if has_wire(plan):
        wire = np.isin(plan.prog[:, 0], (I_WSEND, I_WRECV))
        if unit % plan.qblock and (plan.prog[wire, 2] != unit).any():
            return None
    n, m = plan.n, plan.count // unit
    nodes: List[tuple] = []
    ids: Dict[tuple, int] = {}

    def intern(key):
        e = ids.get(key)
        if e is None:
            e = ids[key] = len(nodes)
            nodes.append(key)
        return e

    def land(w, at, inc, reduce, how=1):
        w[at:at + len(inc)] = [intern((how, c, i)) if reduce else i
                               for c, i in zip(w[at:at + len(inc)], inc)]

    work = [[intern((0, r, j)) for j in range(m)] for r in range(n)]
    if plan.ring:
        b = plan.blk // unit
        for t, reduce in enumerate(plan.prog.tolist()):
            so, ro = plan.tab[2 * t] // unit, plan.tab[2 * t + 1] // unit
            sent = [work[r][so[r]:so[r] + b] for r in range(n)]
            for r in range(n):
                land(work[r], ro[r], sent[(r - 1) % n], reduce)
        return unit, nodes, work
    payload = {}
    for kind, li, L, reduce, _, _, _, _ in plan.prog.tolist():
        b = L // unit
        if kind == I_COPY:
            so, do, has = plan.ctab[3 * li:3 * li + 3]
            for r in range(n):
                if has[r]:
                    s, d = so[r] // unit, do[r] // unit
                    work[r][d:d + b] = work[r][s:s + b]
            continue
        so, hs, ro, hr, _, src = plan.tab[TAB_ROWS * li:TAB_ROWS * (li + 1)]
        if kind == I_WSEND:
            # the sender's run becomes its decoded copy, which is also what
            # the receiver gets
            for p in range(n):
                if hs[p]:
                    s = so[p] // unit
                    work[p][s:s + b] = payload[(li, p)] = [
                        intern((2, e)) for e in work[p][s:s + b]]
            continue
        if kind == I_WRECV:
            for q in range(n):
                if hr[q]:
                    land(work[q], ro[q] // unit,
                         payload.pop((li, int(src[q]))), reduce, how=3)
            continue
        sent = {p: work[p][so[p] // unit:so[p] // unit + b]
                for p in range(n) if hs[p]}
        for q in range(n):
            if hr[q]:
                land(work[q], ro[q] // unit, sent[src[q]], reduce)
    return unit, nodes, work


def fold_plan(plan: GenPlan) -> Optional[FoldPlan]:
    """*plan*'s fold plan, derived once and kept on the plan; None when
    the plan keeps the layer kernel: a leaf of unit j is another unit of
    its src, or a program needs more than ``FOLD_STACK`` values at once;
    for an exact plan, a unit ends as different expressions on different
    ranks; for a wire plan, its qblock groups straddle units (a wire run
    longer than a unit that is no multiple of qblock), its qblock exceeds
    ``WIRE_MAX_QBLOCK``, some rank's expression of a unit is no top of
    that unit's program, or a store would come before a leaf's load (in
    place, the load would read the stored value)."""
    if plan._fold is None:
        plan._fold = (_make_fold_plan(plan),)
    return plan._fold[0]


#: steps that take the next leaf
_LEAF_STEPS = (S_LOAD, S_FOLD_L, S_FOLD_R)


def _make_fold_plan(plan: GenPlan) -> Optional[FoldPlan]:
    wire = has_wire(plan)
    if wire and (plan.qmode not in QMAX or plan.qblock > WIRE_MAX_QBLOCK):
        return None
    run = fold_exprs(plan)
    if run is None:
        return None
    unit, nodes, final = run
    need: Dict[int, int] = {}

    def values(e):
        """Values held at once while e is evaluated (Sethi-Ullman, a leaf
        operand of acc folded straight into the other side's value, QDQ in
        place on the top)."""
        if e not in need:
            node = nodes[e]
            if node[0] == 0:
                need[e] = 1
            elif node[0] == 2:
                need[e] = values(node[1])
            else:
                _, a, b = node
                if node[0] == 1 and nodes[b][0] == 0:
                    need[e] = values(a)
                elif node[0] == 1 and nodes[a][0] == 0:
                    need[e] = values(b)
                else:
                    va, vb = values(a), values(b)
                    need[e] = va + 1 if va == vb else max(va, vb)
        return need[e]

    def emit(e, j, leaves, kinds, tops):
        """Steps of e in Sethi-Ullman order, and after each the node on
        the top; False when a leaf is not unit j."""
        node = nodes[e]
        if node[0] == 0:
            leaves.append(node[1])
            kinds.append(S_LOAD)
            tops.append(e)
            return node[2] == j
        if node[0] == 2:
            ok = emit(node[1], j, leaves, kinds, tops)
            kinds.append(S_QDQ)
            tops.append(e)
            return ok
        _, a, b = node
        if node[0] == 1 and nodes[b][0] == 0:
            ok = emit(a, j, leaves, kinds, tops)
            leaves.append(nodes[b][1])
            kinds.append(S_FOLD_R)
            tops.append(e)
            return ok and nodes[b][2] == j
        if node[0] == 1 and nodes[a][0] == 0:
            ok = emit(b, j, leaves, kinds, tops)
            leaves.append(nodes[a][1])
            kinds.append(S_FOLD_L)
            tops.append(e)
            return ok and nodes[a][2] == j
        comb, swap = (S_COMB, S_COMB_SWAP) if node[0] == 1 \
            else (S_WADD, S_WADD_SWAP)
        first, second, kind = (a, b, comb) if values(a) >= values(b) \
            else (b, a, swap)
        ok = emit(first, j, leaves, kinds, tops) and \
            emit(second, j, leaves, kinds, tops)
        kinds.append(kind)
        tops.append(e)
        return ok

    size: Dict[int, int] = {}

    def nodes_in(e):
        """Nodes of e's tree (a shared node counted at each use)."""
        if e not in size:
            size[e] = 1 + sum(nodes_in(c) for c in nodes[e][1:]
                              if nodes[e][0] != 0)
        return size[e]

    def wire_program(j):
        """(leaf ranks, store ranks, step kinds) of unit j: the deepest
        expression whose program has every rank's expression on its top
        at some step, a STORE after that step per rank; None if there is
        none, or a store would come before a leaf step."""
        ends = [final[r][j] for r in range(n)]
        for e in sorted(set(ends), key=lambda x: (-nodes_in(x), x)):
            leaves: List[int] = []
            kinds: List[int] = []
            tops: List[int] = []
            if not emit(e, j, leaves, kinds, tops):
                return None
            at = {}
            for i, t in enumerate(tops):
                at.setdefault(t, i)
            if all(x in at for x in ends):
                break
        else:
            return None
        stores: List[int] = []
        steps: List[int] = []
        for i, kind in enumerate(kinds):
            steps.append(kind)
            for r in range(n):
                if at[ends[r]] == i:
                    stores.append(r)
                    steps.append(S_STORE)
        last_leaf = max(i for i, k in enumerate(steps) if k in _LEAF_STEPS)
        if steps.index(S_STORE) < last_leaf:
            return None
        return leaves, stores, steps, values(e)

    n = plan.n
    code: List[int] = []
    offsets: Dict[tuple, int] = {}
    units, depth = [], 1
    for j, e in enumerate(final[0]):
        if wire:
            got = wire_program(j)
            if got is None:
                return None
            leaves, stores, kinds, need_j = got
            key = (tuple(leaves), tuple(stores), tuple(kinds))
            words = [len(kinds), len(leaves), len(stores), *leaves, *stores,
                     *kinds]
        else:
            if any(final[r][j] != e for r in range(1, n)):
                return None
            leaves, kinds = [], []
            if not emit(e, j, leaves, kinds, []):
                return None
            need_j = values(e)
            key = (tuple(leaves), tuple(kinds))
            words = [len(kinds), len(leaves),
                     leaves[0] if len(leaves) == 1 else -1, *leaves, *kinds]
        depth = max(depth, need_j)
        if key not in offsets:
            offsets[key] = len(code)
            code += words
        units.append(offsets[key])
    if depth > FOLD_STACK:
        return None
    if wire:
        # the wire fold fetches each step kind one step ahead: a padding
        # word keeps the last program's fetch inside the array
        code.append(0)
    return FoldPlan(unit, depth, np.array(units, np.int32),
                    np.array(code, np.int32),
                    plan.qmode if wire else "", plan.qblock if wire else 0)


def gen_device_fold_ref(srcs: Sequence[torch.Tensor], plan: GenPlan,
                        op: Optional[ReductionOp]) -> List[torch.Tensor]:
    """Plain version of both fold kernels: each unit's program evaluated
    with PyTorch ops, step by step in the kernel's order (QDQ with
    ``quantize``'s arithmetic over the unit, whose groups start at its
    first element), AVG's multiply on what is stored; every rank's result.
    Bitwise ``gen_device_ref`` on every plan that has a fold plan."""
    fp = fold_plan(plan)
    if fp is None:
        raise UccError(Status.ERR_INVALID_PARAM,
                       "gen_device_fold_ref: the plan has no fold plan")
    acc = accumulate(op if op in OPS else ReductionOp.SUM)
    flat = [s.reshape(-1) for s in srcs]
    out = [torch.empty_like(f) for f in flat]
    u = fp.unit
    avg = plan.reducing and op == ReductionOp.AVG

    def scaled(val):
        return val * avg_factor(val.dtype, plan.n).to(val.device) \
            if avg else val

    for j in range(len(fp.units)):
        leaves, kinds = fp.program(j)
        xs = iter(f[j * u:(j + 1) * u] for f in (flat[q] for q in leaves))
        stores = iter(fp.stores(j)) if fp.qmode else None
        stack: List[torch.Tensor] = []
        for kind in kinds:
            if kind == S_LOAD:
                stack.append(next(xs))
            elif kind == S_FOLD_L:
                stack[-1] = acc(next(xs), stack[-1])
            elif kind == S_FOLD_R:
                stack[-1] = acc(stack[-1], next(xs))
            elif kind == S_QDQ:
                # groups counted from the unit's start, the last one
                # padded with zeros, as a wire send of a run of one unit
                stack[-1] = quantize(stack[-1], fp.qmode, fp.qblock)[2]
            elif kind == S_STORE:
                out[next(stores)][j * u:(j + 1) * u] = scaled(stack[-1])
            else:
                top = stack.pop()
                f = acc if kind in (S_COMB, S_COMB_SWAP) else torch.add
                stack[-1] = f(stack[-1], top) \
                    if kind in (S_COMB, S_WADD) else f(top, stack[-1])
        if not fp.qmode:
            (val,) = stack
            val = scaled(val)
            for o in out:
                o[j * u:(j + 1) * u] = val
    return out


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


def _avg(plan: GenPlan, op, dtype):
    """(avg flag, alpha) of a launch: AVG of a reducing plan multiplies by
    ``dtype(1/n)`` at the end."""
    avg = int(plan.reducing and op == ReductionOp.AVG)
    return avg, float(avg_factor(dtype, plan.n)) if avg else 0.0


def part_walk(plan: GenPlan, part, elem_size: int):
    """Part p of P (``part = (p, P)``) of one launch of *plan*, as process
    p of a team across P processes launches it: ``(lo, hi, elo, ehi)``,
    the part [lo, hi) of the walk of the route that ``fold_plan`` chooses
    and the elements [elo, ehi) of every rank's dst it writes.

    - Fold route (gen_fold.cu): the walk is the count's elements, cut at
      multiples of the 16-byte vector (``ring_common.part_bounds``).
    - Wire fold (gen_device.cu): the walk is the qblock groups of every
      unit, in element order; a part is a range of whole groups, since a
      group's scale is taken over the whole group.
    - Layer kernel: a cooperative launch whose grid barrier and wire arena
      live in the launching process's workspace, so it cannot be cut
      across processes: part 0 is the whole walk over every rank's
      buffers, the other parts are empty.

    The same in every process, since ``fold_plan`` is; a part may be
    empty (lo == hi) when the walk is shorter than P."""
    count = plan.count
    lo, hi = part_bounds(count, part, elem_size)   # checks (p, P)
    fp = fold_plan(plan)
    if fp is None:
        whole = (0, count) if part[0] == 0 else (0, 0)
        return whole + whole
    if not fp.qmode:
        return lo, hi, lo, hi
    p, nparts = part
    groups = -(-fp.unit // fp.qblock)
    total = count // fp.unit * groups

    def cut(i):
        return -(-total * i // nparts)

    def start(g):
        return g // groups * fp.unit + g % groups * fp.qblock
    glo, ghi = cut(p), cut(p + 1)
    return glo, ghi, start(glo), start(ghi)


def _launch_fold(what, srcs, dsts, op, plan: GenPlan, fp: FoldPlan, stream,
                 ptr_table, lo: int, hi: int) -> RingLaunch:
    """An ordinary launch of csrc/gen_fold.cu over elements [lo, hi) (the
    whole walk's library, or gen_fold_part.cu's for a part): no
    workspace, flags or error word, a 1-D grid from the occupancy
    query."""
    device = srcs[0].device
    dtype = srcs[0].dtype
    code = DTYPE_CODES[dtype]
    _, alpha = _avg(plan, op, dtype)
    src = _FOLD if (lo, hi) == (0, plan.count) else _FOLD_PART
    with torch.cuda.device(device), torch.cuda.stream(stream):
        units, prog = fp.device_tables(device)
        if ptr_table is None:
            ptr_table = make_ptr_table(srcs, dsts)
        ctas = launch_ctas(hi - lo, srcs[0].element_size(),
                           src.max_ctas(0, code, device, DIRECT_THREADS))
        src.check(src.lib().ucc_gen_fold(
            code, ptr_table.data_ptr(), units.data_ptr(), prog.data_ptr(),
            plan.count, fp.unit, plan.n,
            int(op) if plan.reducing else int(ReductionOp.SUM), alpha, ctas,
            DIRECT_THREADS, lo, hi, stream.cuda_stream),
            f"{what} launch")
    return RingLaunch(stream, keep=(ptr_table, units, prog), what=what)


def wire_kernel(qmode: str, qblock: int) -> int:
    """gen_device.cu's number of the wire fold instance for *qmode* and
    *qblock*: its values a lane are the fewest of 1, 2, 4 and 8 that cover
    a group of qblock elements with a warp."""
    vals = next(v for v in (1, 2, 4, 8) if 32 * v >= qblock)
    return WIRE_KERNELS + 4 * (QMODES[qmode] - 1) + vals.bit_length() - 1


def _launch_wire_fold(what, srcs, dsts, op, plan: GenPlan, fp: FoldPlan,
                      stream, ptr_table, glo: int, ghi: int) -> RingLaunch:
    """An ordinary launch of gen_device.cu's wire fold over groups [glo,
    ghi) of every unit's qblock groups: no workspace, arena, flags or
    error word, one warp per group, a 1-D grid from the occupancy
    query."""
    device = srcs[0].device
    kernel = wire_kernel(fp.qmode, fp.qblock)
    avg, alpha = _avg(plan, op, torch.float32)
    warps = WIRE_THREADS // 32
    with torch.cuda.device(device), torch.cuda.stream(stream):
        units, prog = fp.device_tables(device)
        if ptr_table is None:
            ptr_table = make_ptr_table(srcs, dsts)
        ctas = max(1, min(-(-(ghi - glo) // warps), _SOURCE.max_ctas(
            kernel, DTYPE_CODES[torch.float32], device, WIRE_THREADS)))
        _SOURCE.check(_SOURCE.lib().ucc_gen_wire_fold(
            kernel, ptr_table.data_ptr(), units.data_ptr(), prog.data_ptr(),
            plan.count, fp.unit, fp.qblock, plan.n,
            int(op) if plan.reducing else int(ReductionOp.SUM), avg, alpha,
            ctas, WIRE_THREADS, glo, ghi, stream.cuda_stream),
            f"{what} launch")
    return RingLaunch(stream, keep=(ptr_table, units, prog), what=what)


def _launch_layers(what, srcs, dsts, op, plan: GenPlan, stream, workspace,
                   ptr_table) -> RingLaunch:
    """A cooperative launch of csrc/gen_device.cu's layer kernel on a
    (lanes, n) grid, with its workspace (the wire arena, the barrier
    counter) and error word."""
    n = plan.n
    device = srcs[0].device
    dtype = srcs[0].dtype
    code = DTYPE_CODES[dtype]
    avg, alpha = _avg(plan, op, dtype)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        lanes = _SOURCE.lanes(K_GEN, code, n, plan.span, device)
        ws = workspace if workspace is not None else RingWorkspace(device)
        comm, flags, err = ws.get(max(n * plan.arena, 16), 1)
        tab, prog, ctab = plan.device_tables(device)
        if ptr_table is None:
            ptr_table = make_ptr_table(srcs, dsts)
        flags.zero_()
        _SOURCE.check(_SOURCE.lib().ucc_gen_device(
            K_GEN, code, ptr_table.data_ptr(), comm.data_ptr(),
            flags.data_ptr(), err.data_ptr(), tab.data_ptr(),
            prog.data_ptr(), ctab.data_ptr(), plan.count, plan.arena,
            len(prog), n, 0 if op is None else int(op), avg, alpha,
            QMODES[plan.qmode], plan.qblock, lanes, THREADS,
            stream.cuda_stream), f"{what} launch")
    return RingLaunch(stream, err, keep=(ws, ptr_table, tab, prog, ctab),
                      what=what)


def _dispatch(wrapper, what: str, srcs, dsts, op, plan: GenPlan, stream,
              workspace, ptr_table, part=None) -> RingLaunch:
    """One wrapper call. CPU buffers: the plain version writes them.
    CUDA buffers: when the plan has a fold plan, the fold kernel
    (gen_fold.cu) for an exact plan or the wire fold (gen_device.cu) for a
    wire plan, else the layer kernel; every launch counted in
    ``wrapper.launches``, the two fold routes also in
    ``wrapper.fold_launches``. A failed launch raises; nothing retries on
    another route. *part* ``(p, P)`` launches part p of P of the walk
    (:func:`part_walk`), and on the CPU writes only the part's elements of
    the plain version's result; an empty part launches nothing."""
    _check(what, srcs, dsts, op, plan)
    device = srcs[0].device
    walk = None
    if part is not None and part[1] > 1:
        walk = part_walk(plan, part, srcs[0].element_size())
    if device.type == "cpu":
        if walk is None:
            for d, out in zip(dsts, gen_device_ref(srcs, plan, op)):
                d.copy_(out)
        elif walk[2] < walk[3]:
            write_part(dsts, gen_device_ref(srcs, plan, op),
                       [(r, walk[2], walk[3]) for r in range(plan.n)])
        return RingLaunch()
    if device.type != "cuda":
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"{what} runs on cuda or cpu tensors, not "
                       f"{device.type}")
    lo, hi, _, _ = walk or part_walk(plan, (0, 1), srcs[0].element_size())
    if lo >= hi:
        return RingLaunch()
    if stream is None:
        stream = torch.cuda.current_stream(device)
    fp = fold_plan(plan)
    if fp is not None:
        launch = _launch_wire_fold if fp.qmode else _launch_fold
        h = launch(what, srcs, dsts, op, plan, fp, stream, ptr_table, lo, hi)
        wrapper.fold_launches += 1
    elif plan.ring:
        # device_plan lowers such a ring as layers; only a hand-made plan
        # gets here
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"{what}: a ring plan that is not one expression "
                       "per unit has no kernel")
    else:
        h = _launch_layers(what, srcs, dsts, op, plan, stream, workspace,
                           ptr_table)
    wrapper.launches += 1
    return h


def gen_device_ring(srcs: Sequence[torch.Tensor],
                    dsts: Sequence[torch.Tensor], op: Optional[ReductionOp],
                    *, plan: GenPlan, root: int = 0, stream=None,
                    workspace: Optional[RingWorkspace] = None,
                    ptr_table: Optional[torch.Tensor] = None,
                    part=None) -> RingLaunch:
    """The ring entry point: a shift-by-one ring *plan* over ``srcs``
    into ``dsts`` (the fold kernel); ``root`` is in the plan's tables
    already and ``workspace`` is accepted and left untouched. *part*
    ``(p, P)``: part p of P of the walk (:func:`part_walk`)."""
    if not plan.ring:
        raise UccError(Status.ERR_INVALID_PARAM,
                       "gen_device_ring takes a ring plan")
    return _dispatch(gen_device_ring, "generated ring", srcs, dsts, op, plan,
                     stream, workspace, ptr_table, part)


def gen_device_gen(srcs: Sequence[torch.Tensor],
                   dsts: Sequence[torch.Tensor], op: Optional[ReductionOp],
                   *, plan: GenPlan, root: int = 0, stream=None,
                   workspace: Optional[RingWorkspace] = None,
                   ptr_table: Optional[torch.Tensor] = None,
                   part=None) -> RingLaunch:
    """The general entry point: the layers and copies of *plan* over
    ``srcs`` into ``dsts`` (the fold kernel on an exact plan, the wire fold
    or else the layer kernel on one with wire layers); ``root`` is in the
    plan's tables already. *part* ``(p, P)``: part p of P of the walk
    (:func:`part_walk`; on the layer kernel, the whole walk in part 0)."""
    if plan.ring:
        raise UccError(Status.ERR_INVALID_PARAM,
                       "gen_device_gen takes a layer plan")
    return _dispatch(gen_device_gen, "generated collective", srcs, dsts, op,
                     plan, stream, workspace, ptr_table, part)


def gen_device_torch_ops(srcs: Sequence[torch.Tensor],
                         dsts: Sequence[Optional[torch.Tensor]],
                         op: Optional[ReductionOp], *, plan: GenPlan,
                         root: int = 0, stream=None, workspace=None,
                         ptr_table=None, part=None) -> RingLaunch:
    """The plan as PyTorch ops on the ranks' own device, on *stream*: the
    ``xla`` backend, which UCC_GEN_DEVICE_BACKEND=xla asks for. On a team
    across processes (*part* given) a dst is None where another process
    holds the rank: the plan runs over copies of every rank's src and
    writes the dsts given, the whole of each (the reference's replicated
    program)."""
    given = [d for d in dsts if d is not None]
    _check("generated collective (torch ops)", srcs,
           [s if d is None else d for s, d in zip(srcs, dsts)], op, plan)
    device = srcs[0].device
    if device.type != "cuda":
        for d, out in zip(dsts, gen_device_ref(srcs, plan, op)):
            if d is not None:
                d.copy_(out)
        return RingLaunch()
    with torch.cuda.device(device), torch.cuda.stream(stream):
        if len(given) < len(dsts):
            work = [s.reshape(-1).clone() for s in srcs]
            _run_plan(work, plan, op)
            for d, w in zip(dsts, work):
                if d is not None:
                    d.copy_(w)
        else:
            work = dsts
            for s, d in zip(srcs, dsts):
                if d.data_ptr() != s.data_ptr():
                    d.copy_(s)
            _run_plan([d.reshape(-1) for d in dsts], plan, op)
    return RingLaunch(stream, keep=(srcs, dsts, work), what="torch ops")


gen_device_ring.launches = 0
gen_device_ring.fold_launches = 0
gen_device_gen.launches = 0
gen_device_gen.fold_launches = 0
