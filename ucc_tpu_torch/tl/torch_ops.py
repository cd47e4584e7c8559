"""TL/TORCH_OPS — the default device TL (the counterpart of the JAX
package's tl/xla): every collective type, as PyTorch library ops over the
buffers of every rank of an in-process team.

Where tl/xla runs one ``lax`` program over the mesh, this TL runs library
ops over the ranks' tensors on the team's stream, after waiting for each
rank's inputs (the rendezvous and launch plumbing is tl/device), and
writes each result into the caller's tensor. Algorithms, with the
reference's ids, names and scores, so TUNE strings and score rows carry
over with only the TL name mapped:

- ``xla`` (id 0, score 40; every collective type): the meaning of the
  reference's ``ops``:
  - ALLREDUCE and REDUCE: one reduction over the stacked ranks, every op
    with the meaning of ``ops.allreduce`` (SUM; AVG of floating types;
    MAX, MIN; PROD, of float16 and bfloat16 in float32 rounded once;
    LAND, LOR and LXOR as 0/1 in the dtype; BAND, BOR and BXOR on integer
    types; MINLOC and MAXLOC on interleaved (value, index) pairs, an even
    count, ties to the lowest index). REDUCE writes the root's dst only.
  - REDUCE_SCATTER: that reduction, rank r taking block r; a total that n
    does not divide splits near-equally (the first ``total % n`` blocks
    one element longer, utils/mathutils); REDUCE_SCATTERV: rank r takes
    ``counts[r]`` elements at ``displacements[r]`` of the reduced vector.
    Out of place the block lands at the start of dst; in place dst holds
    the whole vector and the block lands where it lies in it.
  - BCAST: the root's buffer plus zero into every rank, as the reference's
    masked psum (a -0.0 at the root arrives as +0.0 everywhere).
  - ALLGATHER, GATHER (the root's dst only): the ranks' srcs back to back;
    ALLGATHERV, GATHERV: rank r's ``counts[r]`` elements at
    ``displacements[r]`` of dst (``default_displs`` when there are none;
    the counts are needed on every rank), gaps left as they are.
  - ALLTOALL: block p of rank r's src into block r of rank p's dst; a
    count that n does not divide is split, as the reference pads it, into
    blocks of ``ceil(count / n)``, the last one short. ALLTOALLV: rank r's
    block for p (``src.counts[p]`` at ``src.displacements[p]``) into rank
    p's block from r; a receive block longer than the block sent is filled
    with zeros, as the reference's exchange pads it.
  - SCATTER: block r of the root's src into rank r's dst (a total that n
    does not divide is ERR_NOT_SUPPORTED); SCATTERV: ``counts[r]``
    elements at ``displacements[r]`` of the root's src.
  - BARRIER, FANIN, FANOUT: no buffers; they complete when the team's
    stream has passed every rank's post.
- ``ring`` (id 1, score 39; ALLREDUCE): SUM and AVG in the fold order of
  the reference's ``ops.allreduce_ring``: the vector padded to a multiple
  of n, block j summed from rank j+1 round to rank j, AVG that sum times
  1/n (as XLA computes the reference's division); other ops as ``xla``.
- ``short`` (id 2, score 45 below ``SHORT_MSG_MAX`` bytes; ALLREDUCE,
  REDUCE, BCAST, ALLGATHER, ALLTOALL, BARRIER, FANIN, FANOUT): the
  reference's latency algorithm, run on the team's stream: a left fold in
  rank order in the buffers' dtype (SUM, PROD, MAX, MIN, BAND, BOR, BXOR;
  AVG as the sum times 1/n, of float16, float32 and float64), BCAST as the
  root's bits, ALLGATHER, ALLTOALL and the buffer-less three as ``xla``'s;
  the other ops and AVG of other types take ``xla``'s program.
  ``UCC_TL_TORCH_OPS_SHORT_MSG_MAX`` sets the threshold: ``auto`` is
  131072 bytes on a ``cpu`` team and 4096 on a ``cuda`` one, 0 disables.
- ``qint8`` / ``qfp8`` (ALLREDUCE id 3, ALLGATHER id 1, score 38, behind
  ``UCC_QUANT``; tl/xla's ids and score): the block-scaled quantized
  programs of ``quant/torch_ops.py`` (SUM and AVG of float32 and
  bfloat16; the vector zero-padded to a multiple of ``UCC_QUANT_BLOCK``).
  Init refuses, NOT_SUPPORTED and in tl/xla's order, a lib whose
  precision is another, a payload of another type, another op, and a
  team size whose predicted error the budget does not admit. The launch
  reads the block size from the task: there is no compiled program to
  key on it, where tl/xla keys its program cache on ``qblock``.
- ``gen_dev_*`` (ids 200+, score 2, behind ``UCC_GEN_DEVICE=y``): verified
  DSL programs lowered by ``dsl/lower_device`` and run by the kernels of
  ``kernels/gen_device.py`` (exact plans and wire plans with a fold plan
  by the flag-free fold kernels, the other wire plans by the layer
  kernel).

Every type of ``kernels/ring_common.DTYPE_CODES`` moves; the reductions
keep ``validate``'s op/dtype rules: tl/xla's AVG of an integer type
returns floats, which the caller's integer dst cannot hold, so that one
falls to tl/ring_cuda's truncated mean; a bitwise op on a floating type
and a loc op on an odd count fail at run time in the reference and are
refused here at init. The v-collectives' counts (ALLTOALLV: both sides;
SCATTERV: the root's src; ALLGATHERV, GATHERV: dst's, on every rank) are
required, and ALLTOALLV and REDUCE_SCATTERV are not taken in place.

A team whose ranks span processes of one host (tl/device,
tl/device_sync) runs the reference's replicated program: each process
computes its own ranks' dsts with the same library ops over all n srcs (its
own and its peers', mapped through CUDA IPC; an src that lies in one of the
process's dsts is read from a copy, since peers read it while the process
writes; the quantized programs run so as well, each process computing the
same bits), and the candidate lists are the reference's for a team that is
not all local: no ``short``, no SCATTERV, ALLTOALLV served (the counts
travel in the round's descriptors), ``ring`` one point below ``xla``.
``gen_dev_*`` run there too: each process launches its part of the
generated kernel's walk over every rank's buffers, as tl/ring_cuda's
direct kernels do (the layer kernel, whole, in process 0 alone), and the
``xla`` backend runs the plan in every process as the library ops above.

Score 40, as tl/xla's, above tl/ring_cuda's 20: collectives on CUDA
memory select this TL unless a TUNE string says otherwise, e.g.
``UCC_TL_TORCH_OPS_TUNE=allreduce:@ring:inf`` or
``UCC_TL_RING_CUDA_TUNE=allreduce:@ring_cuda:inf``. Its device is the one
every device TL reads (tl/device's ``DEVICE_CONFIG``,
``UCC_TL_RING_CUDA_DEVICE``): ``cuda`` raises at context creation without
a GPU, ``cpu`` runs everything on the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .. import quant
from ..api.types import BufferInfoV
from ..constants import CollType, MemoryType, ReductionOp, coll_type_str
from ..core.components import BaseLib, TransportLayer, register_tl
from ..dsl import lower_device as ld
from ..dsl.ir import Program
from ..kernels import ring_common as kc
from ..kernels.ring_common import RingLaunch
from ..quant.torch_ops import quant_allgather, quant_allreduce
from ..score.score import CollScore
from ..status import Status, UccError
from ..utils.config import (ConfigField, ConfigTable, parse_memunits,
                            parse_string, register_table)
from ..utils.mathutils import block_count, block_offset, default_displs
from .base import AlgSpec, build_scores
from .device import (DEVICE_CONFIG, DeviceCollTask, TlDeviceContext,
                     TlDeviceTeam)

TL_TORCH_OPS_CONFIG = register_table(ConfigTable(
    prefix="TL_TORCH_OPS_", name="tl/torch_ops", fields=[
        ConfigField("SHORT_MSG_MAX", "auto", "message bytes below which "
                    "the 'short' algorithm is selected: 'auto' = 128K on a "
                    "cpu team, 4K on a cuda one; 0 disables",
                    parse_string),
    ]))

#: tl/xla's collective types
_COLLS = (CollType.ALLREDUCE, CollType.REDUCE, CollType.BCAST,
          CollType.BARRIER, CollType.FANIN, CollType.FANOUT,
          CollType.ALLGATHER, CollType.ALLGATHERV, CollType.GATHER,
          CollType.GATHERV, CollType.ALLTOALL, CollType.ALLTOALLV,
          CollType.REDUCE_SCATTER, CollType.REDUCE_SCATTERV,
          CollType.SCATTER, CollType.SCATTERV)
#: the collectives ``short`` registers for
_SHORT_COLLS = (CollType.ALLREDUCE, CollType.REDUCE, CollType.BCAST,
                CollType.ALLGATHER, CollType.ALLTOALL, CollType.BARRIER,
                CollType.FANIN, CollType.FANOUT)
_REDUCING = (CollType.ALLREDUCE, CollType.REDUCE, CollType.REDUCE_SCATTER,
             CollType.REDUCE_SCATTERV)
_NO_BUFFERS = (CollType.BARRIER, CollType.FANIN, CollType.FANOUT)
#: collectives whose dst (ALLTOALLV, SCATTERV: src) is a BufferInfoV
_V_DST = (CollType.ALLGATHERV, CollType.GATHERV, CollType.REDUCE_SCATTERV,
          CollType.ALLTOALLV)
_V_SRC = (CollType.ALLTOALLV, CollType.SCATTERV)


#: BAND, BOR, BXOR: a left fold over ranks 0..n-1, on integer types
_BITWISE = {ReductionOp.BAND: torch.bitwise_and,
            ReductionOp.BOR: torch.bitwise_or,
            ReductionOp.BXOR: torch.bitwise_xor}
#: interleaved (value, index) pairs
_LOC = (ReductionOp.MINLOC, ReductionOp.MAXLOC)
#: ``short``'s folds (the reference's ``_SHORT_UFUNC``)
_SHORT_FOLD = {ReductionOp.SUM: torch.add, ReductionOp.PROD: torch.mul,
               ReductionOp.MAX: torch.maximum,
               ReductionOp.MIN: torch.minimum, **_BITWISE}
_HALF = (torch.float16, torch.bfloat16)
#: the quantized variants' names
_QUANT_ALGS = ("qint8", "qfp8")
_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


# ---------------------------------------------------------------------------
# the library-op programs (plain functions of the ranks' tensors)
# ---------------------------------------------------------------------------

def _loc(stack: torch.Tensor, op: ReductionOp) -> torch.Tensor:
    """MINLOC / MAXLOC over the ranks of (value, index) pairs, even
    elements the values and odd ones the indices: the value of the first
    rank whose value is least (most), a NaN before any number, as the
    reference's argmin (argmax); its index the lowest index among the
    ranks whose value equals it (none for a NaN: then the dtype's infinity
    or largest integer, as the reference's)."""
    vals, idxs = stack[:, 0::2], stack[:, 1::2]
    sel = vals[0]
    for v in vals[1:]:
        better = v < sel if op == ReductionOp.MINLOC else v > sel
        if stack.dtype.is_floating_point:
            better |= v.isnan() & ~sel.isnan()
        sel = torch.where(better, v, sel)
    big = float("inf") if stack.dtype.is_floating_point else \
        torch.iinfo(stack.dtype).max
    out = torch.empty_like(stack[0])
    out[0::2] = sel
    out[1::2] = torch.where(vals == sel, idxs,
                            torch.full_like(idxs, big)).amin(0)
    return out


def allreduce_ops(srcs, op: ReductionOp) -> torch.Tensor:
    """One reduction over the stacked ranks, in the buffers' dtype
    (integers wrap; the product of float16 and bfloat16 in float32, as the
    reference's, rounded once), with the meaning of the reference's
    ``ops.allreduce`` for every op."""
    stack = torch.stack([s.reshape(-1) for s in srcs])
    if op in (ReductionOp.SUM, ReductionOp.AVG):
        out = stack.sum(0)
        if op == ReductionOp.AVG:              # floating types only
            out = kc.divide(out, len(srcs))
    elif op == ReductionOp.MAX:
        out = stack.amax(0)
    elif op == ReductionOp.MIN:
        out = stack.amin(0)
    elif op == ReductionOp.PROD:
        out = stack.prod(0, dtype=torch.float32) \
            if stack.dtype in _HALF else stack.prod(0)
    elif op == ReductionOp.LAND:
        out = (stack != 0).all(0)
    elif op == ReductionOp.LOR:
        out = (stack != 0).any(0)
    elif op == ReductionOp.LXOR:
        out = (stack != 0).sum(0) % 2
    elif op in _BITWISE:                       # integer types only
        out = stack[0]
        for x in stack[1:]:
            out = _BITWISE[op](out, x)
    else:                                      # MINLOC, MAXLOC; even count
        out = _loc(stack, op)
    return out.to(stack.dtype)


def allreduce_ring_ops(srcs, op: ReductionOp) -> torch.Tensor:
    """``ring``: SUM and AVG in the reference's ring order (the vector
    padded to a multiple of n; block j is rank j+1's, plus rank j+2's, ...,
    plus rank j's; AVG is that times 1/n); other ops as
    ``allreduce_ops``."""
    if op not in (ReductionOp.SUM, ReductionOp.AVG):
        return allreduce_ops(srcs, op)
    n, count = len(srcs), srcs[0].numel()
    padded = max(count, 1)
    padded += (-padded) % n
    blk = padded // n
    stack = srcs[0].new_zeros(n, padded)
    stack[:, :count] = torch.stack([s.reshape(-1) for s in srcs])
    # steps[k - 1, j] is block j of rank (j + k) % n, k = 1..n
    j = torch.arange(n, device=stack.device)
    k = torch.arange(1, n + 1, device=stack.device)[:, None]
    steps = stack.view(n, n, blk)[(j + k) % n, j]
    acc = steps[0].clone()
    for step in steps[1:]:
        acc += step
    if op == ReductionOp.AVG:
        # XLA compiles the reference's division by n into a product with
        # its reciprocal
        acc *= 1.0 / n
    return acc.reshape(-1)[:count]


def short_fold_ops(srcs, op: ReductionOp) -> Optional[torch.Tensor]:
    """``short``'s reduction: a left fold over ranks 0..n-1 in the buffers'
    dtype, each step rounded (the reference's numpy ufuncs); AVG is the sum
    times 1/n (in float16 for float16, as numpy scales a float16 array),
    on float16, float32 and float64 only (numpy's float kinds: the
    reference's bfloat16 is not one). None where the reference takes its
    program: the ops it has no fold for, and those AVGs."""
    avg = op == ReductionOp.AVG
    fold = _SHORT_FOLD.get(ReductionOp.SUM if avg else op)
    if fold is None or (avg and srcs[0].dtype not in _NUMPY_FLOATS):
        return None
    acc = srcs[0].reshape(-1).clone()
    for s in srcs[1:]:
        fold(acc, s.reshape(-1), out=acc)
    if avg:
        scale = 1.0 / len(srcs)
        acc.mul_(torch.tensor(scale, dtype=acc.dtype)
                 if acc.dtype == torch.float16 else scale)
    return acc


def bcast_ops(srcs, root: int) -> torch.Tensor:
    """The root's buffer plus zero: the masked psum's result."""
    src = srcs[root].reshape(-1)
    return src + 0 if src.dtype.is_floating_point else src


def alltoall_ops(srcs, dsts) -> torch.Tensor:
    """Block p of rank r's src into block r of rank p's dst, blocks of
    ``ceil(count / n)`` (the last one short when n does not divide the
    count). The srcs are stacked first, so a dst may be its src. Returns
    the stack."""
    n, count = len(srcs), srcs[0].numel()
    blk = -(-count // n)
    if blk * n == count:
        stack = torch.stack([s.reshape(-1) for s in srcs])
    else:
        stack = srcs[0].new_zeros(n, blk * n)
        stack[:, :count] = torch.stack([s.reshape(-1) for s in srcs])
    cube = stack.view(n, n, blk)
    whole, rest = divmod(count, blk) if blk else (0, 0)
    for p, d in enumerate(dsts):
        if d is None:
            continue
        d[:whole * blk].view(whole, blk).copy_(cube[:whole, p])
        if rest:
            d[whole * blk:].copy_(cube[whole, p, :rest])
    return stack


def gatherv_ops(srcs, dsts, layouts) -> tuple:
    """Rank r's first ``counts[r]`` elements at ``displs[r]`` of every dst
    that has a layout ``(counts, displs)`` (``layouts[p]`` None: rank p
    receives nothing); gaps are left as they are. Dense layouts receive one
    concatenation, made before any dst is written, so a src may lie in a
    dst. Returns the concatenations."""
    packed: Dict[tuple, torch.Tensor] = {}
    for lay in layouts:
        if lay is not None and list(lay[1]) == default_displs(lay[0]) and \
                tuple(lay[0]) not in packed:
            packed[tuple(lay[0])] = torch.cat(
                [s[:c] for s, c in zip(srcs, lay[0])])
    for p, (d, lay) in enumerate(zip(dsts, layouts)):
        if lay is None or d is None:
            continue
        counts, displs = lay
        if tuple(counts) in packed and list(displs) == \
                default_displs(counts):
            d[:sum(counts)].copy_(packed[tuple(counts)])
            continue
        for r, (c, off) in enumerate(zip(counts, displs)):
            if r != p or d[off:off + c].data_ptr() != srcs[r].data_ptr():
                d[off:off + c].copy_(srcs[r][:c])
    return tuple(packed.values())


def alltoallv_ops(srcs, dsts, layouts) -> None:
    """``layouts[r] = (scounts, sdispls, dcounts, ddispls)`` of rank r:
    rank r's ``scounts[p]`` elements at ``sdispls[p]`` into rank p's block
    from r (``dcounts[r]`` at ``ddispls[r]`` of its dst); the part of a
    receive block beyond the block sent is zero."""
    for p, d in enumerate(dsts):
        if d is None:
            continue
        _, _, dc, dd = layouts[p]
        for r, s in enumerate(srcs):
            sc, sd, _, _ = layouts[r]
            m = min(sc[p], dc[r])
            d[dd[r]:dd[r] + m].copy_(s[sd[p]:sd[p] + m])
            if dc[r] > m:
                d[dd[r] + m:dd[r] + dc[r]].zero_()


# ---------------------------------------------------------------------------
# programs: (proto task, srcs, dsts, every rank's task) -> tensors to keep
# alive until the launch completes; None from a ``short`` program means
# "take xla's"
# ---------------------------------------------------------------------------

def _to_all(dsts, out) -> tuple:
    """*out* into every rank's dst (a rooted collective's non-roots have
    none)."""
    for d in dsts:
        if d is not None:
            d.copy_(out)
    return (out,)


def _xla_allreduce(t, srcs, dsts, tasks):
    return _to_all(dsts, allreduce_ops(srcs, t.op))


def _xla_reduce_scatter(t, srcs, dsts, tasks):
    full = allreduce_ops(srcs, t.op)
    for d, task in zip(dsts, tasks):
        if d is not None:
            off, cnt = task.block
            d.copy_(full[off:off + cnt])
    return (full,)


def _xla_bcast(t, srcs, dsts, tasks):
    return _to_all(dsts, bcast_ops(srcs, t.root))


def _xla_allgather(t, srcs, dsts, tasks):
    return _to_all(dsts, torch.cat([s.reshape(-1) for s in srcs]))


def _xla_gatherv(t, srcs, dsts, tasks):
    return gatherv_ops(srcs, dsts, [task.layout for task in tasks])


def _xla_alltoall(t, srcs, dsts, tasks):
    return (alltoall_ops(srcs, dsts),)


def _xla_alltoallv(t, srcs, dsts, tasks):
    alltoallv_ops(srcs, dsts, [task.layout for task in tasks])
    return ()


def _xla_scatter(t, srcs, dsts, tasks):
    src = srcs[t.root]
    counts, displs = tasks[t.root].layout
    for d, c, off in zip(dsts, counts, displs):
        if d is not None:
            d[:c].copy_(src[off:off + c])
    return ()


def _nothing(t, srcs, dsts, tasks):
    return ()


_XLA = {
    CollType.ALLREDUCE: _xla_allreduce, CollType.REDUCE: _xla_allreduce,
    CollType.REDUCE_SCATTER: _xla_reduce_scatter,
    CollType.REDUCE_SCATTERV: _xla_reduce_scatter,
    CollType.BCAST: _xla_bcast, CollType.ALLGATHER: _xla_allgather,
    CollType.GATHER: _xla_allgather, CollType.ALLGATHERV: _xla_gatherv,
    CollType.GATHERV: _xla_gatherv, CollType.ALLTOALL: _xla_alltoall,
    CollType.ALLTOALLV: _xla_alltoallv, CollType.SCATTER: _xla_scatter,
    CollType.SCATTERV: _xla_scatter, CollType.BARRIER: _nothing,
    CollType.FANIN: _nothing, CollType.FANOUT: _nothing,
}


def _ring_allreduce(t, srcs, dsts, tasks):
    return _to_all(dsts, allreduce_ring_ops(srcs, t.op))


def _short_reduce(t, srcs, dsts, tasks):
    out = short_fold_ops(srcs, t.op)
    return None if out is None else _to_all(dsts, out)


def _short_bcast(t, srcs, dsts, tasks):
    src = srcs[t.root]
    for d in dsts:
        if d.data_ptr() != src.data_ptr():
            d.copy_(src)
    return ()


def _quant_allreduce(t, srcs, dsts, tasks):
    return _to_all(dsts, quant_allreduce(srcs, t.op, t.alg[1:], t.qblock))


def _quant_allgather(t, srcs, dsts, tasks):
    return _to_all(dsts, quant_allgather(srcs, t.alg[1:], t.qblock,
                                         srcs[0].numel()))


_QUANT = {CollType.ALLREDUCE: _quant_allreduce,
          CollType.ALLGATHER: _quant_allgather}

_PROGRAMS = {
    "xla": _XLA,
    "ring": {CollType.ALLREDUCE: _ring_allreduce},
    # short's allgather and alltoall are xla's, and its barriers complete
    # when the stream passes them, as xla's
    "short": {CollType.ALLREDUCE: _short_reduce,
              CollType.REDUCE: _short_reduce, CollType.BCAST: _short_bcast},
    "qint8": _QUANT,
    "qfp8": _QUANT,
}


# ---------------------------------------------------------------------------
# task
# ---------------------------------------------------------------------------

def _span(counts, displs) -> int:
    return max((d + c for c, d in zip(counts, displs)), default=0)


def _vlayout(bi) -> tuple:
    counts = [int(c) for c in bi.counts]
    displs = [int(d) for d in bi.displacements] \
        if bi.displacements is not None else default_displs(counts)
    return counts, displs


class TorchOpsCollTask(DeviceCollTask):
    """Rendezvous of tl/device; the launched program is PyTorch library
    ops (``xla``, ``ring``, ``short``) or, in the subclass below, a
    generated program. Each rank's buffers are views ``(BufferInfo, start,
    count)`` of its src and dst (None where the rank has none), and
    ``block`` (the reduce_scatters) or ``layout`` (the v-collectives and,
    at the root, scatter) say where the parts of the result lie."""

    #: a process computes its own ranks' dsts only (the replicated
    #: program of the reference), reading its peers' srcs
    PEERS_WRITE = False

    def __init__(self, init_args, team, alg: str = "xla"):
        self.alg = alg
        self.block = self.layout = None
        #: scale-block size of a quantized variant (0: exact)
        self.qblock = 0
        super().__init__(init_args, team)

    def peers_read_src(self, tr: int, local) -> bool:
        """Every process computes its own ranks' dsts from the srcs that
        feed them: the root's src alone for the bcast and scatters, every
        src in the root's process alone for the reduce and gathers."""
        if self.coll in (CollType.BCAST, CollType.SCATTER,
                         CollType.SCATTERV):
            return tr == self.root
        if self.coll in (CollType.REDUCE, CollType.GATHER,
                         CollType.GATHERV):
            return self.root not in local
        return True

    def check_buffer_infos(self) -> None:
        args = self.args
        if self.coll in _NO_BUFFERS:
            return
        if args.src is None and args.dst is None:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"{coll_type_str(self.coll)} needs a buffer")
        for bi, v_ok in ((args.src, self.coll in _V_SRC),
                         (args.dst, self.coll in _V_DST)):
            if isinstance(bi, BufferInfoV) and not v_ok:
                raise UccError(Status.ERR_NOT_SUPPORTED,
                               f"tl/torch_ops {coll_type_str(self.coll)} "
                               "takes no BufferInfoV there")

    def validate(self) -> None:
        if self.alg in _QUANT_ALGS:
            self.validate_quant()
        if self.coll not in _COLLS:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/torch_ops does not implement {self.coll}")
        if self.coll in _NO_BUFFERS:
            return
        if self.dtype not in kc.SUPPORTED_DTYPES:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/torch_ops does not implement {self.dtype}")
        if self.coll not in _REDUCING:
            return
        if self.op not in ReductionOp:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/torch_ops does not implement op {self.op}")
        floating = self.dtype.is_floating_point
        if self.op == ReductionOp.AVG and not floating:
            # tl/xla's pmean of an integer type is a float array, which an
            # integer dst cannot hold: tl/ring_cuda's truncated mean serves
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "tl/torch_ops takes AVG of floating types only")
        if self.op in _BITWISE and floating:
            # the reference's jnp.bitwise_* raise on floats at run time
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/torch_ops takes {self.op.name} of integer "
                           "types only")

    def validate_quant(self) -> None:
        """The quantized variants' eligibility, in tl/xla's order: the
        lib's precision must be this variant's, the payload a float type
        of the codecs, the allreduce op SUM or AVG, and the error budget
        must admit the precision; each refusal is NOT_SUPPORTED, so the
        fallback walk lands on the exact program."""
        qp = quant.params_for(self.tl_team, self.coll)
        if qp is None or f"q{qp.mode}" != self.alg:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "quantized torch_ops variant disabled "
                           "(UCC_QUANT)")
        bi = self.args.src if self.args.src is not None else self.args.dst
        if bi.datatype not in quant.QUANT_DTS:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "quantized torch_ops variant needs a float "
                           "payload")
        if self.coll == CollType.ALLREDUCE and \
                self.op not in (ReductionOp.SUM, ReductionOp.AVG):
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "quantized torch_ops allreduce supports SUM/AVG")
        if not quant.admits(qp, self.coll, self.tl_team.size, "direct"):
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "error budget rejects quantized torch_ops "
                           "variant")
        self.qblock = qp.block

    # -- buffers -----------------------------------------------------------
    def _v(self, bi, side: str) -> tuple:
        if not isinstance(bi, BufferInfoV) or bi.counts is None:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/torch_ops {coll_type_str(self.coll)} "
                           f"requires the counts of its {side} BufferInfoV")
        counts, displs = _vlayout(bi)
        if len(counts) != self.tl_team.size or len(displs) != len(counts):
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"{side} counts/displacements need one entry per "
                           f"rank of {self.tl_team.size}")
        return counts, displs

    def _need(self, bi, what: str):
        if bi is None:
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"{coll_type_str(self.coll)} needs a {what} "
                           "buffer")
        return bi

    def _equal(self, given, want) -> None:
        if given != want:
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"{coll_type_str(self.coll)} of "
                           f"{self.tl_team.size} ranks takes src/dst counts "
                           f"{want}, got {given}")

    def _buffer_counts(self):
        """Sets ``self._src_view`` and ``self._dst_view`` (``(bi, start,
        count)`` or None), ``block`` or ``layout``, and returns the two
        counts."""
        a, coll = self.args, self.coll
        n, me = self.tl_team.size, self.tl_team.rank
        src, dst, own = a.src, a.dst, self._contrib_src
        s_view = d_view = None
        reduced = 0
        if coll in _NO_BUFFERS:
            pass
        elif coll in (CollType.ALLREDUCE, CollType.REDUCE):
            bi = src if own else self._need(dst, "dst")
            c = reduced = int(bi.count)
            s_view = (bi, 0, c)
            if coll == CollType.ALLREDUCE or me == self.root:
                d_view = (self._need(dst, "dst"), 0, c)
        elif coll == CollType.BCAST:
            bi = src if src is not None else dst
            c = int(bi.count)
            s_view = (bi, 0, c)
            d_view = (dst if dst is not None else src, 0, c)
        elif coll in (CollType.ALLGATHER, CollType.GATHER):
            receives = coll == CollType.ALLGATHER or me == self.root
            if own:
                c = int(src.count)
                s_view = (src, 0, c)
                if receives:
                    self._equal((c, int(self._need(dst, "dst").count)),
                                (c, n * c))
            else:
                total = int(self._need(dst, "dst").count)
                if total % n:
                    raise UccError(Status.ERR_NOT_SUPPORTED,
                                   f"in-place {coll_type_str(coll)} needs a "
                                   f"dst count ({total}) that {n} divides")
                c = total // n
                s_view = (dst, me * c, c)
            if receives:
                d_view = (dst, 0, n * c)
        elif coll in (CollType.ALLGATHERV, CollType.GATHERV):
            counts, displs = self._v(self._need(dst, "dst"), "dst")
            c = counts[me]
            s_view = (src, 0, c) if own else (dst, displs[me], c)
            if own and int(src.count) < c:
                self._equal((int(src.count),), (c,))
            if coll == CollType.ALLGATHERV or me == self.root:
                d_view = (dst, 0, _span(counts, displs))
                self.layout = (counts, displs)
        elif coll == CollType.REDUCE_SCATTER:
            total = reduced = int(src.count if own else
                                  self._need(dst, "dst").count)
            off, cnt = block_offset(total, n, me), block_count(total, n, me)
            self.block = (off, cnt)
            if own:
                self._equal((total, int(self._need(dst, "dst").count)),
                            (total, cnt))
                s_view, d_view = (src, 0, total), (dst, 0, cnt)
            else:
                s_view, d_view = (dst, 0, total), (dst, off, cnt)
        elif coll == CollType.REDUCE_SCATTERV:
            if not own:
                raise UccError(Status.ERR_NOT_SUPPORTED,
                               "tl/torch_ops takes no in-place "
                               "reduce_scatterv")
            counts, displs = self._v(self._need(dst, "dst"), "dst")
            off, cnt = displs[me], counts[me]
            total = reduced = int(src.count)
            if total < off + cnt:
                self._equal((total,), (off + cnt,))
            self.block = (off, cnt)
            s_view, d_view = (src, 0, total), (dst, 0, cnt)
        elif coll == CollType.ALLTOALL:
            total = int(self._need(dst, "dst").count)
            if own:
                self._equal((int(src.count), total), (total, total))
            s_view, d_view = (src if own else dst, 0, total), (dst, 0, total)
        elif coll == CollType.ALLTOALLV:
            if not own:
                raise UccError(Status.ERR_NOT_SUPPORTED,
                               "tl/torch_ops takes no in-place alltoallv")
            sc, sd = self._v(src, "src")
            dc, dd = self._v(self._need(dst, "dst"), "dst")
            self.layout = (sc, sd, dc, dd)
            s_view, d_view = (src, 0, _span(sc, sd)), (dst, 0, _span(dc, dd))
        elif coll == CollType.SCATTER:
            if me == self.root:
                total = int(self._need(src, "src").count)
                if total % n:
                    # the reference's rule: uneven blocks belong to scatterv
                    raise UccError(Status.ERR_NOT_SUPPORTED,
                                   f"tl/torch_ops scatter requires count % "
                                   f"team_size == 0 (count {total}, team "
                                   f"size {n})")
                c = total // n
                s_view = (src, 0, total)
                self.layout = ([c] * n, [r * c for r in range(n)])
                if own:
                    self._equal((total, int(self._need(dst, "dst").count)),
                                (total, c))
                    d_view = (dst, 0, c)
            else:
                d_view = (self._need(dst, "dst"), 0, int(dst.count))
        else:                                   # SCATTERV
            if me == self.root:
                counts, displs = self._v(src, "src")
                self.layout = (counts, displs)
                s_view = (src, 0, _span(counts, displs))
                if own:
                    d_view = (self._need(dst, "dst"), 0, counts[me])
            else:
                d_view = (self._need(dst, "dst"), 0, int(dst.count))
        if self.op in _LOC and coll in _REDUCING and reduced % 2:
            # an odd count has one value more than indices: the
            # reference's g[..., 0::2] and g[..., 1::2] do not pair up
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/torch_ops takes {self.op.name} of an even "
                           f"count of (value, index) pairs, not {reduced}")
        self._src_view, self._dst_view = s_view, d_view
        return (s_view[2] if s_view else 0, d_view[2] if d_view else 0)

    def _view(self, view) -> Optional[torch.Tensor]:
        if view is None:
            return None
        bi, start, count = view
        return self._flat(bi, start + count)[start:]

    def local_buffers(self):
        return self._view(self._src_view), self._view(self._dst_view)

    # -- launch ------------------------------------------------------------
    def launch(self, shared, srcs, dsts, tasks, part=None):
        """The program over every rank's buffers; on a spanning team
        (*part* given) over every rank's srcs and this process's dsts, the
        others None."""
        programs = _PROGRAMS[self.alg]
        xla = _XLA[self.coll]
        program = programs.get(self.coll, xla)

        def run():
            keep = program(self, srcs, dsts, tasks)
            return xla(self, srcs, dsts, tasks) if keep is None else keep

        if shared.stream is None:
            run()
            return RingLaunch()
        with torch.cuda.device(shared.device), \
                torch.cuda.stream(shared.stream):
            keep = run()
        return RingLaunch(shared.stream, keep=keep, what="torch ops")


class GenDeviceCollTask(TorchOpsCollTask):
    """One rank's view of a lowered device collective: the launched
    program is generated from the verified IR (dsl/lower_device).

    On a team whose ranks span processes the kernel backend launches this
    process's part of the walk over every rank's buffers
    (``kernels/gen_device.part_walk``), so it writes its peers' dsts
    (``PEERS_WRITE``); the ``xla`` backend runs the whole plan in every
    process over every rank's srcs and writes its own ranks' dsts, as
    ``TorchOpsCollTask`` does."""

    def __init__(self, init_args, team, program: Program, backend: str):
        self.prog = program
        self._backend = backend
        self.PEERS_WRITE = backend != "xla"
        self.qp = None
        self._qmode = program.wire or program.edge_wire_mode
        super().__init__(init_args, team, alg=ld.dev_alg_name(program))

    def peers_read_src(self, tr: int, local) -> bool:
        """The kernels' parts read of each src only the elements they write
        in every dst (a fold plan's unit j is an expression over unit j of
        the srcs, the layer kernel runs in one process), so no src is
        read from a copy; the ``xla`` backend's processes read every src
        that feeds their own dsts, as ``TorchOpsCollTask``'s do."""
        if self.PEERS_WRITE:
            return False
        return super().peers_read_src(tr, local)

    def launch(self, shared, srcs, dsts, tasks, part=None):
        if self.PEERS_WRITE:
            return DeviceCollTask.launch(self, shared, srcs, dsts, tasks,
                                         part)
        # the plan as torch ops takes no pointer table
        return self.build_program(shared)(
            srcs, dsts, self.op, root=self.root, stream=shared.stream,
            part=part)

    def validate(self) -> None:
        # the same in every process of a spanning team, before the tag
        bi = self.args.src if self.args.src is not None else self.args.dst
        self.qp = ld.device_eligibility(self.prog, self.tl_team, self.coll,
                                        self.op, self.dtype, int(bi.count))

    def build_program(self, shared):
        qblock = self.qp.block if self.qp is not None else 256
        key = ("gen_dev", self.prog.name, self.prog.param_str,
               self._backend, self.coll, self.op, self.dtype,
               self.src_count, self.root, qblock)
        program = shared.programs.get(key)
        if program is None:
            program = shared.programs[key] = ld.build_device_program(
                self.prog, len(shared.devices), self.src_count,
                self.root, self._backend, qblock, self._qmode)
        return program


class TlTorchOpsTeam(TlDeviceTeam):
    NAME = "torch_ops"
    TL_CLS: Any = None

    def alg_table(self) -> Dict[CollType, List[AlgSpec]]:
        def spec(i, name, select=None, precision=""):
            def init(ia, team):
                return TorchOpsCollTask(ia, self, name)
            return AlgSpec(i, name, init, default_select=select,
                           precision=precision)

        score = TlTorchOps.DEFAULT_SCORE
        # a team that spans processes has the reference's lists for a team
        # that is not all local: no short, no scatterv (its explicit
        # placement needs every rank's device in the process); alltoallv
        # stays, its counts travel with the round's descriptors
        local = not self.spanning
        table = {coll: [spec(0, "xla")] for coll in _COLLS
                 if local or coll != CollType.SCATTERV}
        # one point below xla, so that the tie-break by name cannot make
        # it the default
        table[CollType.ALLREDUCE].append(
            spec(1, "ring", select=f"0-inf:{score - 1}"))
        # quantized variants (quant/torch_ops), one point below the ring
        # and two below xla, as in tl/xla: a TUNE string or the tuner
        # promotes them; absent with UCC_QUANT off
        q_ar = quant.coll_mode(self, CollType.ALLREDUCE)
        if q_ar:
            table[CollType.ALLREDUCE].append(
                spec(3, f"q{q_ar}", select=f"0-inf:{score - 2}",
                     precision=q_ar))
        q_ag = quant.coll_mode(self, CollType.ALLGATHER)
        if q_ag:
            table[CollType.ALLGATHER].append(
                spec(1, f"q{q_ag}", select=f"0-inf:{score - 2}",
                     precision=q_ag))
        # generated-device candidates, behind UCC_GEN_DEVICE: off keeps
        # the lists unchanged
        backend = ld.device_backend(self)
        gen_ids: Dict[CollType, int] = {}
        for p in ld.registered_device_programs(self):
            def gen_init(ia, team, _p=p):
                return GenDeviceCollTask(ia, self, _p, backend)
            i = gen_ids[p.coll] = gen_ids.get(p.coll, -1) + 1
            table[p.coll].append(AlgSpec(
                ld.GEN_DEV_ALG_ID_BASE + i, ld.dev_alg_name(p), gen_init,
                # low default score: TUNE-addressable, never the default
                default_select="0-inf:2",
                precision=p.wire or p.edge_wire_mode,
                origin="generated-device", gen=p.param_str))
        thr = self.short_msg_max()
        if thr > 0 and local:
            for coll in _SHORT_COLLS:
                table[coll].append(spec(2, "short",
                                        select=f"0-{thr}:{score + 5}"))
        return table

    def short_msg_max(self) -> int:
        """``SHORT_MSG_MAX`` in bytes: 'auto' is 128K on a cpu team and 4K
        on a cuda one (the reference's per-platform default); a value that
        does not parse disables ``short``."""
        cfg = getattr(self.comp_context.comp_lib, "config", None)
        raw = (getattr(cfg, "short_msg_max", "auto") or "auto").strip()
        if raw.lower() == "auto":
            return 131072 if self.shared.device.type == "cpu" else 4096
        try:
            return int(parse_memunits(raw))
        except ValueError:
            return 0

    def get_scores(self) -> CollScore:
        return build_scores(self, TlTorchOps.DEFAULT_SCORE, self.alg_table(),
                            TlTorchOps.SUPPORTED_MEM_TYPES,
                            tune_env="UCC_TL_TORCH_OPS_TUNE")


@register_tl
class TlTorchOps(TransportLayer):
    """Library ops over the ranks of one device, and the generated device
    collectives."""

    NAME = "torch_ops"
    DEFAULT_SCORE = 40
    SUPPORTED_COLLS = (CollType.ALLREDUCE | CollType.REDUCE | CollType.BCAST
                       | CollType.BARRIER | CollType.FANIN | CollType.FANOUT
                       | CollType.ALLGATHER | CollType.ALLGATHERV
                       | CollType.GATHER | CollType.GATHERV
                       | CollType.ALLTOALL | CollType.ALLTOALLV
                       | CollType.REDUCE_SCATTER
                       | CollType.REDUCE_SCATTERV | CollType.SCATTER
                       | CollType.SCATTERV)
    SUPPORTED_MEM_TYPES = (MemoryType.CUDA,)
    SERVICE_CAPABLE = False
    LIB_CONFIG = TL_TORCH_OPS_CONFIG
    CONTEXT_CONFIG = DEVICE_CONFIG
    lib_cls = BaseLib
    context_cls = TlDeviceContext
    team_cls = TlTorchOpsTeam


TlTorchOpsTeam.TL_CLS = TlTorchOps
