"""cl/hier N-level algorithms: collectives composed from per-level
phases over the topology tree (``TeamTopo.hier_tree``). Every phase is a
sub-collective on one tree-level unit, selected by that unit's own score
map, and the phases are assembled into one Schedule. Where the 2-level
algorithms name NODE and NODE_LEADERS, these walk a chain of any depth
(rank -> node -> pod -> ...):

  - allreduce ``nrab``: reduce up the leader chain (levels 0..L-2),
    allreduce at the top unit, bcast back down (the RAB recursion).
  - bcast/reduce ``nstep``: the 2step generalization: rooted phases
    ascend root's subtree path, then fan out or hand off down the tree.
  - barrier ``nlvl``: fanin up, barrier at the top, fanout down.
  - allgather(v) ``nlvl``: gatherv up (subtree regions stay contiguous
    in tree order), allgatherv at the top, bcast of the full buffer
    down, unpack to the user layout.

Every unit's sub-collectives are initialized in the same order on all of
its members, and each rank's own phases chain sequentially, so the
composition needs no synchronization beyond the sub-collectives. On
3+-level layouts (pods detected) they are the hier default; on 2-level
ones they are score-1 candidates that TUNE strings can pick.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ...api.types import BufferInfo, BufferInfoV, CollArgs
from ...constants import (CollArgsFlags, CollType, EventType, MemoryType,
                          ReductionOp, dt_size)
from ...ec.cpu import storage_dtype
from ...schedule.schedule import Schedule
from ...status import Status, UccError
from ...utils.log import get_logger
from .algs import _buf, _dst_view, _ScaleTask, _UnpackTask

logger = get_logger("cl_hier")


class _Chain:
    """Sequential task chain inside one Schedule (each rank's phases run
    strictly in order; cross-rank sync rides the sub-collectives)."""

    def __init__(self, hier_team, args):
        self.sched = Schedule(team=hier_team, args=args)
        self.prev = None

    def add(self, task, stage: str):
        task.obs_stage = stage
        self.sched.add_task(task)
        if self.prev is None:
            self.sched.add_dep_on_schedule_start(task)
        else:
            task.subscribe_dep(self.prev, EventType.EVENT_COMPLETED)
        self.prev = task
        return task


def _op_pair(args):
    op = args.op if args.op is not None else ReductionOp.SUM
    inner = ReductionOp.SUM if op == ReductionOp.AVG else op
    return op, inner


# ---------------------------------------------------------------------------
# allreduce: N-level RAB
# ---------------------------------------------------------------------------

def allreduce_nlvl_init(init_args, ht):
    """reduce(level 0) -> reduce(level 1) -> ... -> allreduce(top)
    [-> AVG scale] -> bcast back down every level."""
    args = init_args.args
    tree = ht.tree
    L = tree.n_levels
    op, inner = _op_pair(args)
    count = int(args.dst.count)
    dt = args.dst.datatype
    msg = count * dt_size(dt)
    team_size = ht.core_team.size
    ch = _Chain(ht, args)

    # up: reduce to the unit leader while this rank stays on the chain
    for l in range(L - 1):
        if not tree.is_member(l):
            break
        unit = ht.level_unit(l)
        lead = unit.sbgp.group_rank == 0
        inplace_here = l > 0 or args.is_inplace
        red = CollArgs(
            coll_type=CollType.REDUCE, root=0,
            src=args.dst if inplace_here else args.src,
            dst=args.dst if lead else None, op=inner,
            flags=CollArgsFlags.IN_PLACE if inplace_here
            else CollArgsFlags(0))
        ch.add(unit.coll_init(red, MemoryType.HOST, msg),
               f"nrab.reduce_l{l}")

    # top: allreduce among the pod leaders (or node leaders at depth 2)
    if tree.is_member(L - 1):
        unit = ht.level_unit(L - 1)
        ar = CollArgs(coll_type=CollType.ALLREDUCE, dst=args.dst,
                      op=inner, flags=CollArgsFlags.IN_PLACE)
        ar.src = args.dst
        ch.add(unit.coll_init(ar, MemoryType.HOST, msg),
               "nrab.top_allreduce")
        if op == ReductionOp.AVG:
            ch.add(_ScaleTask(lambda a=args, d=dt: _dst_view(a, d),
                              1.0 / team_size, dt), "nrab.scale")

    # down: bcast within every unit this rank serves, top-1 .. 0
    for l in range(L - 2, -1, -1):
        if not tree.is_member(l):
            continue
        unit = ht.level_unit(l)
        bc = CollArgs(coll_type=CollType.BCAST, root=0, src=args.dst)
        ch.add(unit.coll_init(bc, MemoryType.HOST, msg),
               f"nrab.bcast_l{l}")
    return ch.sched


# ---------------------------------------------------------------------------
# bcast: N-level 2step generalization
# ---------------------------------------------------------------------------

def bcast_nlvl_init(init_args, ht):
    """Ascend root's subtree path (each unit bcasts from root's
    representative), cross the top, then fan out rooted at the unit
    leaders in every subtree that didn't contain root."""
    args = init_args.args
    tree = ht.tree
    L = tree.n_levels
    root = int(args.root)
    msg = init_args.msgsize
    ch = _Chain(ht, args)

    for l in range(L - 1):
        if not tree.is_member(l):
            break
        if tree.group_index(l) != tree.group_index(l, root):
            continue
        unit = ht.level_unit(l)
        bc = CollArgs(coll_type=CollType.BCAST,
                      root=tree.rep_group_rank(l, root), src=args.src)
        ch.add(unit.coll_init(bc, MemoryType.HOST, msg),
               f"nstep.up_bcast_l{l}")

    if tree.is_member(L - 1):
        unit = ht.level_unit(L - 1)
        bc = CollArgs(coll_type=CollType.BCAST,
                      root=tree.rep_group_rank(L - 1, root), src=args.src)
        ch.add(unit.coll_init(bc, MemoryType.HOST, msg),
               "nstep.top_bcast")

    for l in range(L - 2, -1, -1):
        if not tree.is_member(l):
            continue
        if tree.group_index(l) == tree.group_index(l, root):
            continue
        unit = ht.level_unit(l)
        bc = CollArgs(coll_type=CollType.BCAST, root=0, src=args.src)
        ch.add(unit.coll_init(bc, MemoryType.HOST, msg),
               f"nstep.down_bcast_l{l}")
    return ch.sched


# ---------------------------------------------------------------------------
# reduce: N-level 2step generalization
# ---------------------------------------------------------------------------

def reduce_nlvl_init(init_args, ht):
    """Reduce up the leader chain to the global leader (partials in
    scratch; root's partial rides its dst), then hand the result down
    root's subtree path via unit bcasts. AVG scales at root."""
    args = init_args.args
    tree = ht.tree
    L = tree.n_levels
    root = int(args.root)
    me = ht.core_team.rank
    op, inner = _op_pair(args)
    src_bi0 = args.src if args.src is not None else args.dst
    dt = src_bi0.datatype
    nd = storage_dtype(dt)
    count = int(src_bi0.count)
    msg = count * nd.itemsize
    is_root = me == root
    global_leader = tree.level(L - 1).groups[0][0]
    ch = _Chain(ht, args)

    scratch: Optional[np.ndarray] = None

    def scratch_buf() -> np.ndarray:
        nonlocal scratch
        if scratch is None:
            scratch = np.zeros(count, dtype=nd)
        return scratch

    hold = None   # where my partial lives after the last up phase
    for l in range(L):
        if not tree.is_member(l):
            break
        unit = ht.level_unit(l)
        lead = unit.sbgp.group_rank == 0
        if l == 0:
            src_bi = args.dst if (args.is_inplace and is_root) \
                else args.src
            dst_bi = (args.dst if is_root
                      else _buf(scratch_buf(), dt)) if lead else None
            flags = CollArgsFlags.IN_PLACE \
                if (lead and is_root and args.is_inplace) \
                else CollArgsFlags(0)
        else:
            src_bi = args.dst if hold == "dst" else _buf(scratch, dt)
            dst_bi = src_bi if lead else None
            flags = CollArgsFlags.IN_PLACE if lead else CollArgsFlags(0)
        red = CollArgs(coll_type=CollType.REDUCE, root=0, src=src_bi,
                       dst=dst_bi, op=inner, flags=flags)
        ch.add(unit.coll_init(red, MemoryType.HOST, msg),
               f"nstep.reduce_l{l}")
        if not lead:
            break
        hold = "dst" if is_root else "scratch"

    if root != global_leader:
        # handoff down root's path: each unit along it bcasts from its
        # leader (who received one level up) until root has the result
        for l in range(L - 1, -1, -1):
            if not tree.is_member(l):
                continue
            if tree.group_index(l) != tree.group_index(l, root):
                continue
            if l < L - 1 and tree.is_member(l + 1, root):
                continue   # root already received at a higher level
            unit = ht.level_unit(l)
            if is_root:
                buf = args.dst
            elif scratch is not None:
                buf = _buf(scratch, dt)
            else:
                buf = _buf(np.zeros(count, dtype=nd), dt)
            bc = CollArgs(coll_type=CollType.BCAST, root=0, src=buf)
            ch.add(unit.coll_init(bc, MemoryType.HOST, msg),
                   f"nstep.handoff_l{l}")

    if op == ReductionOp.AVG and is_root:
        ch.add(_ScaleTask(lambda a=args, d=dt: _dst_view(a, d),
                          1.0 / ht.core_team.size, dt), "nstep.scale")
    return ch.sched


# ---------------------------------------------------------------------------
# barrier
# ---------------------------------------------------------------------------

def barrier_nlvl_init(init_args, ht):
    """fanin every level up, barrier at the top, fanout back down."""
    tree = ht.tree
    L = tree.n_levels
    ch = _Chain(ht, init_args.args)
    for l in range(L - 1):
        if not tree.is_member(l):
            break
        ch.add(ht.level_unit(l).coll_init(
            CollArgs(coll_type=CollType.FANIN, root=0),
            MemoryType.HOST, 0), f"nlvl.fanin_l{l}")
    if tree.is_member(L - 1):
        ch.add(ht.level_unit(L - 1).coll_init(
            CollArgs(coll_type=CollType.BARRIER),
            MemoryType.HOST, 0), "nlvl.top_barrier")
    for l in range(L - 2, -1, -1):
        if not tree.is_member(l):
            continue
        ch.add(ht.level_unit(l).coll_init(
            CollArgs(coll_type=CollType.FANOUT, root=0),
            MemoryType.HOST, 0), f"nlvl.fanout_l{l}")
    return ch.sched


# ---------------------------------------------------------------------------
# allgather(v)
# ---------------------------------------------------------------------------

def _subtree_totals(tree, counts, level):
    """{member m of a level-`level` unit: total count of m's subtree} —
    the ranks whose level-`level` representative is m. Level 0's subtree
    of m is {m} itself."""
    totals = {}
    for r in range(len(counts)):
        m = tree.rep(level, r)
        totals[m] = totals.get(m, 0) + counts[r]
    return totals


def allgatherv_nlvl_init(init_args, ht):
    """gatherv up each level (subtree regions contiguous in tree order),
    allgatherv at the top, bcast the full grouped buffer down, unpack to
    the user's displacement layout."""
    from ...tl.base import binfo_typed

    args = init_args.args
    tree = ht.tree
    L = tree.n_levels
    N = ht.core_team.size
    me = ht.core_team.rank
    dstv = args.dst
    counts = [int(c) for c in dstv.counts]
    displs = [int(d) for d in dstv.displacements] \
        if dstv.displacements is not None else \
        list(np.cumsum([0] + counts[:-1]))
    total = sum(counts)
    dst_span = max((displs[r] + counts[r] for r in range(len(counts))),
                   default=0)
    dt = dstv.datatype
    nd = storage_dtype(dt)
    msg = total * nd.itemsize

    # grouped layout: ranks in tree order, so every subtree's region is
    # contiguous and child regions appear in ascending-leader order —
    # exactly the member order of each unit's gatherv
    g_off = {}
    off = 0
    for r in tree.tree_order:
        g_off[r] = off
        off += counts[r]
    scratch = np.zeros(total, dtype=nd)
    # per-level subtree totals (T[l][m] = bytes member m brings into its
    # level-l unit's gatherv)
    T = [_subtree_totals(tree, counts, l) for l in range(L)]

    ch = _Chain(ht, args)
    src_bi = args.src if not args.is_inplace else BufferInfo(
        binfo_typed(dstv, counts[me], displs[me]), counts[me], dt)

    for l in range(L - 1):
        if not tree.is_member(l):
            break
        unit = ht.level_unit(l)
        group = tree.group(l)
        lead = unit.sbgp.group_rank == 0
        my_total = T[l][me]
        if l == 0:
            stage_src = src_bi
        else:
            stage_src = BufferInfo(
                scratch[g_off[me]:g_off[me] + my_total], my_total, dt)
        if unit.sbgp.size == 1:
            # single-member unit: no peers; only the leaf copy-in moves
            # data (higher levels already hold their region in place)
            if l == 0:
                region = scratch[g_off[me]:g_off[me] + counts[me]]

                def copy_in(region=region, bi=src_bi, c=counts[me]):
                    region[:] = binfo_typed(bi)[:c]

                ch.add(_UnpackTask(copy_in), "nlvl.copy_in")
            continue
        gdst = None
        if lead:
            base = g_off[group[0]]
            region = scratch[base:base + sum(T[l][m] for m in group)]
            gdst = BufferInfoV(region, [T[l][m] for m in group], None, dt)
        g = CollArgs(coll_type=CollType.GATHERV, root=0, src=stage_src,
                     dst=gdst)
        ch.add(unit.coll_init(g, MemoryType.HOST, msg),
               f"nlvl.gatherv_l{l}")

    if tree.is_member(L - 1):
        unit = ht.level_unit(L - 1)
        group = tree.group(L - 1)
        my_total = T[L - 1][me]
        a = CollArgs(
            coll_type=CollType.ALLGATHERV,
            src=BufferInfo(scratch[g_off[me]:g_off[me] + my_total],
                           my_total, dt),
            dst=BufferInfoV(scratch, [T[L - 1][m] for m in group], None,
                            dt))
        ch.add(unit.coll_init(a, MemoryType.HOST, msg),
               "nlvl.top_allgatherv")

    for l in range(L - 2, -1, -1):
        if not tree.is_member(l):
            continue
        unit = ht.level_unit(l)
        if unit.sbgp.size == 1:
            continue
        bc = CollArgs(coll_type=CollType.BCAST, root=0,
                      src=BufferInfo(scratch, total, dt))
        ch.add(unit.coll_init(bc, MemoryType.HOST, msg),
               f"nlvl.down_bcast_l{l}")

    def unpack():
        dst_flat = binfo_typed(dstv, dst_span)
        for r in range(N):
            dst_flat[displs[r]:displs[r] + counts[r]] = \
                scratch[g_off[r]:g_off[r] + counts[r]]

    ch.add(_UnpackTask(unpack), "nlvl.unpack")
    return ch.sched


def allgather_nlvl_init(init_args, ht):
    """ALLGATHER as the v-variant with uniform counts (the same duality
    the 2-level pipeline uses; the user's dst is written in place)."""
    import dataclasses

    args = init_args.args
    n = ht.core_team.size
    total = int(args.dst.count)
    if total % n != 0:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       "nlvl allgather needs count divisible by team size")
    blk = total // n
    dstv = BufferInfoV(args.dst.buffer, [blk] * n, None,
                       args.dst.datatype, mem_type=args.dst.mem_type)
    vargs = dataclasses.replace(args, dst=dstv)
    return allgatherv_nlvl_init(
        dataclasses.replace(init_args, args=vargs), ht)
