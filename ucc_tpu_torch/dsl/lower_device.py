"""Device-side compiler backend: lower verified DSL programs to generated
device collectives (the port of ``ucc_tpu/dsl/lower_device.py``).

**Layer plan** (:func:`plan_rounds`, the reference's code): each IR round's
matched send->recv/reduce edges are grouped into contiguous-chunk *runs*
and scheduled into *layers*; per layer every rank sends at most one run
and receives at most one, all runs of one (length, kind, wire). The
layering is receiver-driven, so every element accumulates in the host
interpreter's order. Programs whose matches cross rounds, or that send and
receive one chunk in one round, refuse to lower (``Inapplicable``).
Layer wires come from the EDGES, as in the reference: a program whose
precision is set on the program (``gen_qint8_direct``) lowers exact.

**Backends.** :func:`device_plan` turns the layer plan into the tables of
``kernels/gen_device.py``: a ring plan for a pure shift-by-one ring
(``gen_device_ring``), a layer plan for every other program
(``gen_device_gen``). On a CUDA team (``auto`` and ``pallas``) every exact
plan, which is every registered program, takes the flag-free fold kernel
(``csrc/gen_fold.cu``: one pass that evaluates each unit's expression,
``gen_device.fold_plan``); only plans with wire layers run the
cooperative layer kernel (``csrc/gen_device.cu``), layer by layer.
``xla`` runs the same tables as PyTorch ops (``gen_device_torch_ops``).
On a ``cpu`` team the wrappers run their plain version. The reference's
VMEM bound (``pallas_fits``) has no counterpart: the arenas live in device
memory.

:func:`registered_device_programs` lists the programs that tl/torch_ops
registers as candidates named ``gen_dev_*`` (``UCC_GEN_DEVICE=y``; off
keeps the candidate lists unchanged), and :func:`device_eligibility` is
their tasks' init-time check. This module imports nothing of ``tl/``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import quant
from ..constants import CollType, ReductionOp
from ..kernels import gen_device as kgd
from ..kernels.ring_common import SUPPORTED_DTYPES
from ..status import Status, UccError
from ..utils.log import get_logger
from . import families as fam
from .ir import OpKind, Program

logger = get_logger("dsl_device")

#: AlgSpec id base for generated-device candidates
GEN_DEV_ALG_ID_BASE = 200

#: per-rank program streams are unrolled into the plan tables, so bound
#: the team size well below the host registry's 128 cap
MAX_DEVICE_RANKS = 32

#: device families + default parameter grids (UCC_GEN_DEVICE_FAMILIES
#: restricts/extends within the lowerable set). allgather and
#: reduce_scatter programs stay host-side.
DEVICE_GRIDS: Dict[str, List[int]] = {
    "ring": [1, 2, 4],
    "rhd": [2, 0],             # 0 = radix n (the direct exchange)
    "bc_kn": [2, 0],           # 0 = radix n (linear fan-out)
    "bc_chain": [2],
    "qdirect": [0],            # parameterized by UCC_QUANT
}

_REDUCING = (CollType.ALLREDUCE,)

#: ops the lowered accumulate supports (AVG = SUM + end scale, sound
#: because the verifier proves every chunk ends as the full reduction)
_DEVICE_OPS = frozenset((ReductionOp.SUM, ReductionOp.AVG,
                         ReductionOp.PROD, ReductionOp.MAX,
                         ReductionOp.MIN))


# ---------------------------------------------------------------------------
# round/layer planning (the reference's, unchanged)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Edge:
    p: int                     #: sender (team rank)
    q: int                     #: receiver (team rank)
    chunk: int
    kind: OpKind               #: RECV or REDUCE
    wire: str


@dataclass
class _Run:
    """A contiguous chunk range moving p -> q with one kind/wire."""

    p: int
    q: int
    chunk0: int
    length: int
    kind: OpKind
    wire: str


@dataclass
class _Layer:
    """One schedulable step: <=1 outgoing and <=1 incoming run per
    rank, all runs homogeneous in (length, kind, wire)."""

    runs: List[_Run]
    length: int
    kind: OpKind
    wire: str
    # per-team-rank tables (filled by plan_rounds)
    send_chunk0: np.ndarray = field(default=None)  # type: ignore[assignment]
    has_send: np.ndarray = field(default=None)     # type: ignore[assignment]
    recv_chunk0: np.ndarray = field(default=None)  # type: ignore[assignment]
    has_recv: np.ndarray = field(default=None)     # type: ignore[assignment]
    perm: List[Tuple[int, int]] = field(default_factory=list)
    #: full permutation (partial perm completed with leftover pairs) —
    #: the symmetric step's destination per rank
    dst_full: np.ndarray = field(default=None)     # type: ignore[assignment]


@dataclass
class _CopyLayer:
    src_chunk: np.ndarray
    dst_chunk: np.ndarray
    has: np.ndarray


@dataclass
class _RoundPlan:
    layers: List[_Layer]
    copies: List[_CopyLayer]


def _round_edges(prog: Program, root: int, n: int) -> List[List[_Edge]]:
    """Matched edges per round, in TEAM-rank space (bcast root
    rotation applied). Raises :class:`~.families.Inapplicable` for
    programs whose matches cross rounds — the synchronous layer model
    has no rendezvous to carry them."""
    def team_rank(pr: int) -> int:
        return (pr + root) % n if root else pr

    out: List[List[_Edge]] = []
    for k in range(prog.n_rounds):
        recvs: Dict[Tuple[int, int, int], Tuple[int, Any]] = {}
        for q in range(prog.nranks):
            for op in prog.ranks[q].rounds[k]:
                if op.kind in (OpKind.RECV, OpKind.REDUCE):
                    key = (op.peer, q, op.slot)
                    if key in recvs:
                        raise fam.Inapplicable(
                            f"duplicate recv match key {key} in round {k}")
                    recvs[key] = (q, op)
        edges: List[_Edge] = []
        for p in range(prog.nranks):
            for op in prog.ranks[p].rounds[k]:
                if op.kind != OpKind.SEND:
                    continue
                m = recvs.pop((p, op.peer, op.slot), None)
                if m is None:
                    raise fam.Inapplicable(
                        f"send on rank {p} round {k} matches across "
                        "rounds (device lowering is round-synchronous)")
                q, rop = m
                edges.append(_Edge(team_rank(p), team_rank(q), rop.chunk,
                                   rop.kind, rop.wire or op.wire))
        if recvs:
            raise fam.Inapplicable(
                f"recv without an in-round send in round {k}")
        out.append(edges)
    return out


def _receiver_runs(prog: Program, root: int, n: int,
                   edges: List[_Edge], k: int) -> Dict[int, List[_Run]]:
    """Per-receiver runs in the receiver's OP-STREAM order — the order
    the host interpreter applies its landings, which the layer schedule
    must preserve for bitwise agreement. Runs are built from the
    receiver's own ops (a rank can receive the SAME chunk from several
    peers in one round — the direct exchange's reduce round — so edges
    must not be keyed by (receiver, chunk) alone); *edges* already
    validated 1:1 matching, and matched sides agree on chunk and wire
    (the verifier's cross-wire agreement rule)."""
    wire_of = {(e.p, e.q, e.chunk): e.wire for e in edges}
    runs: Dict[int, List[_Run]] = {}
    for pr in range(prog.nranks):
        q = (pr + root) % n if root else pr
        lst: List[_Run] = []
        for op in prog.ranks[pr].rounds[k]:
            if op.kind not in (OpKind.RECV, OpKind.REDUCE):
                continue
            p = (op.peer + root) % n if root else op.peer
            wire = wire_of.get((p, q, op.chunk), op.wire)
            last = lst[-1] if lst else None
            if last is not None and last.p == p \
                    and last.kind == op.kind and last.wire == wire \
                    and last.chunk0 + last.length == op.chunk:
                last.length += 1
            else:
                lst.append(_Run(p, q, op.chunk, 1, op.kind, wire))
        if lst:
            runs[q] = lst
    return runs


def _complete_perm(perm: List[Tuple[int, int]], n: int) -> np.ndarray:
    """Complete a partial permutation to a full one (leftover senders
    paired with leftover receivers in sorted order) — the symmetric
    step of the JAX package's kernel needs every rank to send and receive
    exactly once."""
    dst = np.full(n, -1, np.int32)
    taken = set()
    for p, q in perm:
        dst[p] = q
        taken.add(q)
    free_dst = [q for q in range(n) if q not in taken]
    for p in range(n):
        if dst[p] < 0:
            dst[p] = free_dst.pop(0)
    return dst


def plan_rounds(prog: Program, n: int, root: int = 0) -> List[_RoundPlan]:
    """The backend-shared lowering plan. Raises
    :class:`~.families.Inapplicable` when *prog* cannot lower (the
    registration precheck turns that into a skipped candidate)."""
    if prog.nranks != n:
        raise fam.Inapplicable(
            f"program is {prog.nranks}-rank (team has {n})")
    all_edges = _round_edges(prog, root, n)
    plans: List[_RoundPlan] = []
    for k, edges in enumerate(all_edges):
        sent: Dict[int, set] = {}
        rcvd: Dict[int, set] = {}
        wire_by: Dict[Tuple[int, int], str] = {}
        for e in edges:
            rcvd.setdefault(e.q, set()).add(e.chunk)
            w = wire_by.setdefault((e.p, e.chunk), e.wire)
            if w != e.wire:
                raise fam.Inapplicable(
                    f"chunk {e.chunk} sent with mixed wire modes in "
                    f"round {k}")
        # senders recorded from the edges' p side
        for e in edges:
            sent.setdefault(e.p, set()).add(e.chunk)
        for r in set(sent) & set(rcvd):
            if sent[r] & rcvd[r]:
                raise fam.Inapplicable(
                    f"rank {r} sends and receives chunk "
                    f"{min(sent[r] & rcvd[r])} in round {k} (pre-round "
                    "send capture would need staging)")
        queues = _receiver_runs(prog, root, n, edges, k)
        layers: List[_Layer] = []
        while any(queues.values()):
            senders: set = set()
            sig: Optional[Tuple[int, OpKind, str]] = None
            picked: List[_Run] = []
            for q in sorted(queues):
                lst = queues[q]
                if not lst:
                    continue
                r = lst[0]
                s = (r.length, r.kind, r.wire)
                if r.p in senders or (sig is not None and s != sig):
                    continue
                sig = s
                senders.add(r.p)
                picked.append(lst.pop(0))
            assert picked, "layer scheduling stalled"
            layers.append(_Layer(picked, sig[0], sig[1], sig[2]))
        # tables
        for lay in layers:
            lay.send_chunk0 = np.zeros(n, np.int32)
            lay.has_send = np.zeros(n, np.int32)
            lay.recv_chunk0 = np.zeros(n, np.int32)
            lay.has_recv = np.zeros(n, np.int32)
            lay.perm = []
            for r in lay.runs:
                lay.send_chunk0[r.p] = r.chunk0
                lay.has_send[r.p] = 1
                lay.recv_chunk0[r.q] = r.chunk0
                lay.has_recv[r.q] = 1
                lay.perm.append((r.p, r.q))
            lay.dst_full = _complete_perm(lay.perm, n)
        # local copies, layered so each rank applies <=1 per layer
        copies: List[_CopyLayer] = []
        per_rank: Dict[int, List[Any]] = {}
        for pr in range(prog.nranks):
            tr = (pr + root) % n if root else pr
            ops = [op for op in prog.ranks[pr].rounds[k]
                   if op.kind == OpKind.COPY]
            if ops:
                per_rank[tr] = ops
        depth = max((len(v) for v in per_rank.values()), default=0)
        for j in range(depth):
            src = np.zeros(n, np.int32)
            dst = np.zeros(n, np.int32)
            has = np.zeros(n, np.int32)
            for tr, ops in per_rank.items():
                if j < len(ops):
                    src[tr] = ops[j].src_chunk
                    dst[tr] = ops[j].chunk
                    has[tr] = 1
            copies.append(_CopyLayer(src, dst, has))
        plans.append(_RoundPlan(layers, copies))
    return plans


def ring_schedule(plans: List[_RoundPlan], n: int
                  ) -> Optional[List[Tuple[int, int, OpKind]]]:
    """Detect the pure shift-by-one ring shape: every round is ONE
    layer whose runs are exactly {p -> (p+1) % n} with one uniform
    block length and no copies. Returns per-round
    (block_len, kind) schedule info as a list of
    (length, kind), with the tables read from the single layer, or
    None. Ring programs get a ring plan (``gen_device_ring``)."""
    if n < 2:
        return None
    out = []
    for rp in plans:
        if len(rp.layers) != 1 or rp.copies:
            return None
        lay = rp.layers[0]
        if len(lay.runs) != n:
            return None
        for r in lay.runs:
            if r.q != (r.p + 1) % n or r.wire:
                return None
        out.append((lay.length, lay.kind))
    if not out:
        return None
    m = out[0][0]
    if any(length != m for length, _ in out):
        return None
    return out


def pallas_arena(plans: List[_RoundPlan], ce: int,
                  qblock: int) -> Tuple[int, int, int, int]:
    """(exact slot elems, wire byte elems, scale elems, n_layers) of
    the single-use comm arenas (send + recv banks each)."""
    ex = wb = sc = nl = 0
    for rp in plans:
        for lay in rp.layers:
            nl += 1
            L = lay.length * ce
            if lay.wire:
                wl = -(-L // qblock) * qblock
                wb += wl
                sc += wl // qblock
            else:
                ex += L
    return ex, wb, sc, nl


# ---------------------------------------------------------------------------
# the kernel's tables
# ---------------------------------------------------------------------------

def device_plan(prog: Program, n: int, count: int, root: int = 0,
                qblock: int = 256, qmode: str = "") -> kgd.GenPlan:
    """The tables of ``kernels/gen_device.py`` for *prog* at *count*
    elements per rank (a multiple of ``prog.nchunks``). A ring program
    whose blocks all start at a multiple of the block length, and whose
    plan has a fold plan, gets a ring plan; everything else a layer
    plan."""
    plans = plan_rounds(prog, n, root)
    ce = count // prog.nchunks
    reducing = prog.coll in _REDUCING
    ring = ring_schedule(plans, n)
    if ring is not None:
        blk = ring[0][0] * ce
        tab = np.zeros((2 * len(ring), n), np.int32)
        for t, rp in enumerate(plans):
            lay = rp.layers[0]
            tab[2 * t] = lay.send_chunk0 * ce
            tab[2 * t + 1] = lay.recv_chunk0 * ce
        if blk and count % blk == 0 and not (tab % blk).any():
            steps = np.array([kind == OpKind.REDUCE for _, kind in ring],
                             np.int64)
            plan = kgd.GenPlan(n, count, True, tab, steps,
                               np.zeros((1, n), np.int32), blk=blk,
                               span=blk, qmode=qmode, qblock=qblock,
                               reducing=reducing)
            if kgd.fold_plan(plan) is not None:
                return plan
    rows, ins, crows = [], [], []
    wb = sum(-(-lay.length * ce // qblock) * qblock
             for rp in plans for lay in rp.layers if lay.wire)
    scale_base = -(-wb // 16) * 16
    qoff = soff = span = 0
    for rp in plans:
        for lay in rp.layers:
            li = len(rows) // kgd.TAB_ROWS
            L = lay.length * ce
            span = max(span, L)
            src = np.zeros(n, np.int32)
            for run in lay.runs:
                src[run.q] = run.p
            rows += [lay.send_chunk0 * ce, lay.has_send,
                     lay.recv_chunk0 * ce, lay.has_recv,
                     lay.dst_full.astype(np.int32), src]
            reduce = int(lay.kind == OpKind.REDUCE)
            if lay.wire:
                wl = -(-L // qblock) * qblock
                sbyte = scale_base + 4 * soff
                ins.append([kgd.I_WSEND, li, L, reduce, qoff, sbyte, wl, 0])
                ins.append([kgd.I_WRECV, li, L, reduce, qoff, sbyte, wl, 0])
                qoff += wl
                soff += wl // qblock
            else:
                ins.append([kgd.I_EXACT, li, L, reduce, 0, 0, 0, 0])
        for cp in rp.copies:
            ci = len(crows) // 3
            crows += [cp.src_chunk * ce, cp.dst_chunk * ce, cp.has]
            ins.append([kgd.I_COPY, ci, ce, 0, 0, 0, 0, 0])
            span = max(span, ce)
    tab = np.stack(rows).astype(np.int32) if rows else \
        np.zeros((1, n), np.int32)
    ctab = np.stack(crows).astype(np.int32) if crows else \
        np.zeros((1, n), np.int32)
    prog_tab = np.array(ins, np.int64).reshape(-1, kgd.INSTR_WORDS)
    arena = scale_base + 4 * soff if wb else 0
    return kgd.GenPlan(n, count, False, tab, prog_tab, ctab, span=span,
                       arena=arena, qmode=qmode, qblock=qblock,
                       reducing=reducing)


def build_device_program(prog: Program, n: int, count: int, root: int,
                         backend: str, qblock: int, qmode: str):
    """The launch callable of tl/device's kernel contract, bound to the
    plan of *prog* at *count*: the ring or the general entry point, or, for
    the ``xla`` backend, the plan as PyTorch ops. The task resolved
    *backend* at init, so a failure here is a launch failure."""
    plan = device_plan(prog, n, count, root, qblock, qmode)
    if backend == "xla":
        fn = kgd.gen_device_torch_ops
    else:
        fn = kgd.gen_device_ring if plan.ring else kgd.gen_device_gen
    return functools.partial(fn, plan=plan)


# ---------------------------------------------------------------------------
# registration and eligibility
# ---------------------------------------------------------------------------

def dev_alg_name(prog: Program) -> str:
    """``gen_ring_c2`` -> ``gen_dev_ring_c2`` (the device candidates'
    score-map/TUNE/provenance name)."""
    base = prog.name
    if base.startswith("gen_"):
        base = base[len("gen_"):]
    return f"gen_dev_{base}"


def gen_device_enabled(team) -> bool:
    from .registry import _cfg_str
    return _cfg_str(team, "gen_device", "UCC_GEN_DEVICE") in \
        ("y", "yes", "on", "1", "true", "t")


def device_backend(team) -> str:
    """UCC_GEN_DEVICE_BACKEND: auto or pallas (the CUDA kernel on a CUDA
    team), or xla (the plan as PyTorch ops)."""
    from .registry import _cfg_str
    raw = _cfg_str(team, "gen_device_backend",
                   "UCC_GEN_DEVICE_BACKEND", "auto")
    return raw if raw in ("auto", "xla", "pallas") else "auto"


def parse_device_families(spec: str) -> Dict[str, List[int]]:
    """UCC_GEN_DEVICE_FAMILIES (same grammar as UCC_GEN_FAMILIES),
    restricted to the device-lowerable set; empty = DEVICE_GRIDS."""
    from .registry import parse_families
    if not (spec or "").strip():
        return {k: list(v) for k, v in DEVICE_GRIDS.items()}
    out = {}
    for famname, params in parse_families(spec).items():
        if famname not in DEVICE_GRIDS:
            raise ValueError(
                f"family '{famname}' has no device lowering (device "
                f"set: {', '.join(sorted(DEVICE_GRIDS))})")
        out[famname] = params
    return out


def _lowerable(family: str, params: List[int], n: int,
               wire: str) -> List[Program]:
    """The verified, device-lowerable programs of one family's grid."""
    from .registry import build_program
    out = []
    for param in params:
        p = build_program(family, param, n, wire=wire)
        if p is None:
            continue
        try:
            plan_rounds(p, n)
        except fam.Inapplicable as e:
            logger.debug("dsl_device: %s does not lower: %s", p.name, e)
            continue
        out.append(p)
    return out


def device_programs(n: int, quant_mode: str = "",
                    spec: str = "") -> List[Program]:
    """Every verified AND device-lowerable built-in program at team size
    *n*."""
    out: List[Program] = []
    seen: set = set()
    for family, params in parse_device_families(spec).items():
        if family == "qdirect":
            if not quant_mode:
                continue
            params = [0]
        for p in _lowerable(family, params, n,
                            quant_mode if family == "qdirect" else ""):
            if p.name not in seen:
                seen.add(p.name)
                out.append(p)
    return out


def device_eligibility(program: Program, team, coll: CollType,
                       op: ReductionOp, dtype: torch.dtype, count: int):
    """Whether *program* takes this collective, deterministic on every rank
    and before the tag is taken: raises ERR_NOT_SUPPORTED (selection then
    walks on to the ``xla`` program), else returns the wire precision's
    QuantParams (None for an exact program). Its inputs are the program,
    the team's size, the lib's config and the collective's arguments, so
    every process of a team that spans processes decides alike, as
    ``device_plan`` then builds the same tables and route in each."""
    if coll != program.coll:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"program {program.name} serves {program.coll!r}")
    if team.size != program.nranks:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"program {program.name} compiled for "
                       f"{program.nranks} ranks (team has {team.size})")
    if count < program.nchunks or count % program.nchunks:
        # device chunks are equal slices
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"count {count} not divisible by "
                       f"{program.nchunks} device chunks")
    if coll in _REDUCING and op not in _DEVICE_OPS:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"device lowering supports "
                       f"{sorted(o.name for o in _DEVICE_OPS)} "
                       f"(got {op.name})")
    if dtype not in SUPPORTED_DTYPES:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"device lowering does not implement {dtype}")
    if coll in _REDUCING and op == ReductionOp.AVG and \
            not dtype.is_floating_point:
        # the reference scales by dtype(1/n), which is 0 for an integer
        # type: refused, the xla program divides instead
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       "device lowering of AVG takes floating types")
    qmode = program.wire or program.edge_wire_mode
    if not qmode:
        return None
    qp = quant.params_for(team, coll)
    if qp is None or qp.mode != qmode:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"wire precision {qmode} not enabled (UCC_QUANT)")
    if dtype != torch.float32:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       "quantized device programs need a float32 payload")
    if op not in (ReductionOp.SUM, ReductionOp.AVG):
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       "quantized device programs support SUM/AVG")
    if qp.stochastic:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       "UCC_QUANT_STOCHASTIC has no device codec")
    if not quant.admits(qp, coll, team.size, "direct"):
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"quantized {qp.mode} predicted error exceeds "
                       f"error budget {qp.budget:.4f}")
    return qp


def registered_device_programs(team) -> List[Program]:
    """The programs a device team registers as ``gen_dev_*`` candidates:
    [] when UCC_GEN_DEVICE is off, the team is a singleton, or too
    large; otherwise every verified, lowerable program of the
    UCC_GEN_DEVICE_FAMILIES grid (qdirect under UCC_QUANT)."""
    if not gen_device_enabled(team):
        return []
    n = int(getattr(team, "size", 0) or 0)
    if n < 2:
        return []
    if n > MAX_DEVICE_RANKS:
        logger.warning("dsl_device: UCC_GEN_DEVICE skipped: team size "
                       "%d above the %d-rank device-lowering cap", n,
                       MAX_DEVICE_RANKS)
        return []
    from .registry import _cfg_str
    spec = _cfg_str(team, "gen_device_families",
                    "UCC_GEN_DEVICE_FAMILIES")
    try:
        fams = parse_device_families(spec)
    except ValueError as e:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"bad UCC_GEN_DEVICE_FAMILIES: {e}")
    out: List[Program] = []
    seen: set = set()
    for family, params in fams.items():
        coll = fam.FAMILY_COLL.get(family, CollType.ALLREDUCE)
        wire = ""
        if family == "qdirect":
            wire = quant.coll_mode(team, coll) or ""
            if not wire:
                continue
            params = [0]
        for p in _lowerable(family, params, n, wire):
            if p.name not in seen:
                seen.add(p.name)
                out.append(p)
    if out:
        logger.info("dsl_device: %d generated-device candidates (backend "
                    "%s) for team size %d: %s", len(out),
                    device_backend(team), n,
                    ", ".join(dev_alg_name(p) for p in out))
    return out
