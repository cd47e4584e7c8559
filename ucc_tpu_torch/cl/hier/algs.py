"""cl/hier algorithms: hierarchical schedules of sub-collectives.

The semantics of UCC's cl/hier algorithms:

  - allreduce **RAB** (Reduce + Allreduce + Bcast): reduce to the node
    leader, allreduce across the leaders, bcast back down the node;
    optionally pipelined through the fragmentation engine, so that the
    leaders' transfer of fragment k overlaps the node work of k+1.
  - allreduce **split_rail**: reduce_scatter inside the node, a per-rail
    allreduce across nodes (every local rank drives its own NET rail at
    once), allgather inside the node.
  - bcast/reduce **2step**, barrier fanin(node) -> barrier(leaders) ->
    fanout(node), allgather(v) with an unpack step, and alltoall(v) with
    node aggregation.

All compose through the Schedule / PipelinedSchedule engine; the
sub-collective tasks come from each unit's own score map, so TUNE strings
apply per hierarchy level. Host scratch holds bfloat16 as its uint16 bit
pattern (``ec/cpu.storage_dtype``), as the host TLs do.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ...api.types import BufferInfo, CollArgs
from ...constants import (CollArgsFlags, CollType, DataType, EventType,
                          MemoryType, ReductionOp, dt_size)
from ...ec.cpu import bf16_to_f32, f32_to_bf16, storage_dtype
from ...schedule.pipelined import (PipelinedSchedule, PipelineOrder,
                                   parse_pipeline_params)
from ...schedule.schedule import Schedule
from ...schedule.task import CollTask
from ...score.score import CollScore
from ...status import Status, UccError
from ...topo.sbgp import SbgpType
from ...utils import profiling
from ...utils.log import get_logger
from ...utils.mathutils import block_count, block_offset

logger = get_logger("cl_hier")

HIER_SCORE = 55     # above the TLs' scores, so hier wins on multi-node teams


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _buf(arr: np.ndarray, dt, mem=MemoryType.HOST) -> BufferInfo:
    return BufferInfo(arr, arr.size, dt, mem_type=mem)


def scale_array(v: np.ndarray, alpha: float, dt) -> np.ndarray:
    """*v* times *alpha*, cast back to *v*'s dtype (integers truncate, as
    an out-of-place multiply and cast does); bfloat16 bit patterns are
    multiplied as float32 and rounded to nearest even."""
    if dt == DataType.BFLOAT16:
        return f32_to_bf16(bf16_to_f32(v) * np.float32(alpha))
    return (v * alpha).astype(v.dtype)


def divide_array(v: np.ndarray, n: int, dt) -> np.ndarray:
    """*v* divided by *n*, cast back to *v*'s dtype (bfloat16 as float32
    rounded to nearest even)."""
    if dt == DataType.BFLOAT16:
        return f32_to_bf16(bf16_to_f32(v) / np.float32(n))
    return (v / n).astype(v.dtype)


class _ScaleTask(CollTask):
    """Multiply a buffer view by alpha (AVG post-scale at the leader)."""

    def __init__(self, view_fn, alpha: float, dt):
        super().__init__()
        self.view_fn = view_fn
        self.alpha = alpha
        self.dt = dt

    def post_fn(self) -> Status:
        try:
            v = self.view_fn()
            v[:] = scale_array(v, self.alpha, self.dt)
        except Exception:  # noqa: BLE001 - fail the task, not the caller's
            logger.exception("hier scale step failed")   # progress loop
            self.status = Status.ERR_NO_MESSAGE
            return Status.ERR_NO_MESSAGE
        self.status = Status.OK
        return Status.OK


def _dst_view(args: CollArgs, dt):
    from ...tl.base import binfo_typed
    return binfo_typed(args.dst)


# ---------------------------------------------------------------------------
# allreduce RAB
# ---------------------------------------------------------------------------

def allreduce_rab_build(hier_team, init_args) -> CollTask:
    """RAB with optional pipelining over fragments."""
    args = init_args.args
    cfg = hier_team.comp_context.config
    pp = None
    if cfg is not None:
        try:
            pp = parse_pipeline_params(cfg.get("ALLREDUCE_RAB_PIPELINE"))
        except KeyError:
            pp = None
    count = int(args.dst.count)
    dt = args.dst.datatype
    esz = dt_size(dt)
    n_frags, pdepth = (1, 1) if pp is None else pp.nfrags_pdepth(count * esz)

    if n_frags <= 1:
        sched = Schedule(team=hier_team, args=args)
        _rab_fill_frag(hier_team, sched, args, dt, 0, count)
        return sched

    from ...tl.base import binfo_typed
    full_dst = binfo_typed(args.dst)
    full_src = full_dst if args.is_inplace else binfo_typed(args.src)

    def frag_init(sched_p, idx):
        frag = Schedule(team=hier_team)
        _rab_fill_frag(hier_team, frag, _frag_args(args, full_src, full_dst,
                                                   dt, 0, count, n_frags, 0),
                       dt, 0, count // n_frags or 1)
        return frag

    def frag_setup(sched_p, frag, frag_num):
        fa = _frag_args(args, full_src, full_dst, dt, 0, count, n_frags,
                        frag_num)
        _rab_retarget_frag(hier_team, frag, fa, dt)
        return Status.OK

    return PipelinedSchedule(team=hier_team, args=args, frag_init=frag_init,
                             frag_setup=frag_setup, n_frags=pdepth,
                             n_frags_total=n_frags,
                             order=pp.order if pp else PipelineOrder.SEQUENTIAL)


def _frag_args(args, full_src, full_dst, dt, base, count, n_frags, frag_num):
    off = block_offset(count, n_frags, frag_num)
    cnt = block_count(count, n_frags, frag_num)
    fa = CollArgs(coll_type=CollType.ALLREDUCE,
                  src=_buf(full_src[off:off + cnt], dt),
                  dst=_buf(full_dst[off:off + cnt], dt),
                  op=args.op, flags=args.flags & ~CollArgsFlags.PERSISTENT)
    if args.is_inplace:
        fa.src = fa.dst
    return fa


def _rab_fill_frag(hier_team, sched: Schedule, args: CollArgs, dt,
                   base: int, count: int) -> None:
    """Build the reduce -> (leaders allreduce [-> scale]) -> bcast chain for
    one fragment's args."""
    node = hier_team.sbgp(SbgpType.NODE)
    leaders = hier_team.sbgp(SbgpType.NODE_LEADERS)
    op = args.op if args.op is not None else ReductionOp.SUM
    inner_op = ReductionOp.SUM if op == ReductionOp.AVG else op
    team_size = hier_team.core_team.size
    msg = int(args.dst.count) * dt_size(dt)

    is_leader = node.sbgp.group_rank == 0

    red_args = CollArgs(coll_type=CollType.REDUCE, root=0,
                        src=args.dst if args.is_inplace else args.src,
                        dst=args.dst if is_leader else None,
                        op=inner_op,
                        flags=CollArgsFlags.IN_PLACE if args.is_inplace
                        else CollArgsFlags(0))
    t_red = node.coll_init(red_args, MemoryType.HOST, msg)
    t_red.obs_stage = "rab.node_reduce"
    sched.add_task(t_red)
    sched.add_dep_on_schedule_start(t_red)
    prev = t_red

    if is_leader and leaders is not None and leaders.sbgp.is_member:
        ar_args = CollArgs(coll_type=CollType.ALLREDUCE,
                           dst=args.dst, op=inner_op,
                           flags=CollArgsFlags.IN_PLACE)
        ar_args.src = args.dst
        t_ar = leaders.coll_init(ar_args, MemoryType.HOST, msg)
        t_ar.obs_stage = "rab.leaders_allreduce"
        sched.add_task(t_ar)
        t_ar.subscribe_dep(prev, EventType.EVENT_COMPLETED)
        prev = t_ar
        if op == ReductionOp.AVG:
            # capture the allreduce task's args: frag retargeting mutates
            # them in place, so the scale always hits the live fragment
            t_scale = _ScaleTask(lambda a=ar_args, d=dt: _dst_view(a, d),
                                 1.0 / team_size, dt)
            t_scale.obs_stage = "rab.scale"
            sched.add_task(t_scale)
            t_scale.subscribe_dep(prev, EventType.EVENT_COMPLETED)
            prev = t_scale

    bc_args = CollArgs(coll_type=CollType.BCAST, root=0, src=args.dst)
    t_bc = node.coll_init(bc_args, MemoryType.HOST, msg)
    t_bc.obs_stage = "rab.node_bcast"
    sched.add_task(t_bc)
    t_bc.subscribe_dep(prev, EventType.EVENT_COMPLETED)


def _rab_retarget_frag(hier_team, frag: Schedule, fa: CollArgs, dt) -> None:
    """Rebind the fragment tasks' buffer views (frag_setup)."""
    for t in frag.tasks:
        targs = t.args
        if targs is None:
            continue
        if targs.coll_type == CollType.REDUCE:
            targs.src = fa.src if not fa.is_inplace else fa.dst
            if targs.dst is not None:
                targs.dst = fa.dst
            _retarget_task_counts(t, targs)
        elif targs.coll_type == CollType.ALLREDUCE:
            targs.src = fa.dst
            targs.dst = fa.dst
            _retarget_task_counts(t, targs)
        elif targs.coll_type == CollType.BCAST:
            targs.src = fa.dst
            _retarget_task_counts(t, targs)


def _retarget_task_counts(task, targs) -> None:
    retarget = getattr(task, "retarget", None)
    if retarget is not None:     # a device task re-reads its buffers
        retarget()
        return
    bi = targs.dst if targs.dst is not None else targs.src
    if hasattr(task, "count") and bi is not None:
        task.count = int(bi.count)


# ---------------------------------------------------------------------------
# allreduce split_rail
# ---------------------------------------------------------------------------

class SplitRailAllreduce(CollTask):
    """reduce_scatter(NODE) -> allreduce(NET rail) -> allgather(NODE).
    Driven as a chain of three sub-tasks built lazily (block sizes depend
    on the node size)."""

    obs_stage = ""

    def __init__(self, hier_team, init_args):
        super().__init__(team=hier_team, args=init_args.args)
        self.hier_team = hier_team
        self.init_args = init_args
        self._stage = 0
        self._sub: Optional[CollTask] = None
        self._work: Optional[np.ndarray] = None

    def post_fn(self) -> Status:
        from ...tl.base import binfo_typed
        args = self.args
        node = self.hier_team.sbgp(SbgpType.NODE)
        self._node_n = node.sbgp.size
        self._me = node.sbgp.group_rank
        self._count = int(args.dst.count)
        self._dt = args.dst.datatype
        dst = binfo_typed(args.dst)
        if not args.is_inplace:
            dst[:] = binfo_typed(args.src)[:self._count]
        self._dst = dst
        self._stage = 0
        self._sub = None
        self._advance()
        return Status.OK

    def progress_fn(self) -> None:
        self._advance()

    # each stage posts one sub-collective on a unit team
    def _advance(self) -> None:
        if self._sub is not None:
            if not self._sub.is_completed():
                return
            if profiling.ENABLED and self.obs_stage:
                profiling.span_end(f"hier_{self.obs_stage}", self.seq_num,
                                   status=self._sub.super_status.name)
            if self._sub.super_status.is_error:
                self.status = self._sub.super_status
                return
            self._sub = None
            self._stage += 1
        node = self.hier_team.sbgp(SbgpType.NODE)
        net = self.hier_team.sbgp(SbgpType.NET)
        op = self.args.op if self.args.op is not None else ReductionOp.SUM
        inner = ReductionOp.SUM if op == ReductionOp.AVG else op
        n, me = self._node_n, self._me
        blk_off = block_offset(self._count, n, me)
        blk_cnt = block_count(self._count, n, me)
        esz = dt_size(self._dt)
        if self._stage == 0:
            rs_args = CollArgs(
                coll_type=CollType.REDUCE_SCATTER, op=inner,
                dst=_buf(self._dst, self._dt),
                flags=CollArgsFlags.IN_PLACE)
            rs_args.src = rs_args.dst
            self._sub = node.coll_init(rs_args, MemoryType.HOST,
                                       self._count * esz)
            self._post_sub("split_rail.node_reduce_scatter")
        elif self._stage == 1:
            my_block = self._dst[blk_off:blk_off + blk_cnt]
            ar_args = CollArgs(coll_type=CollType.ALLREDUCE, op=inner,
                               dst=_buf(my_block, self._dt),
                               flags=CollArgsFlags.IN_PLACE)
            ar_args.src = ar_args.dst
            self._sub = net.coll_init(ar_args, MemoryType.HOST,
                                      blk_cnt * esz)
            self._post_sub("split_rail.rail_allreduce")
        elif self._stage == 2:
            if op == ReductionOp.AVG:
                my_block = self._dst[blk_off:blk_off + blk_cnt]
                my_block[:] = divide_array(
                    my_block, self.hier_team.core_team.size, self._dt)
            ag_args = CollArgs(
                coll_type=CollType.ALLGATHER,
                dst=_buf(self._dst, self._dt),
                flags=CollArgsFlags.IN_PLACE)
            ag_args.src = _buf(self._dst[blk_off:blk_off + blk_cnt],
                               self._dt)
            self._sub = node.coll_init(ag_args, MemoryType.HOST,
                                       self._count * esz)
            self._post_sub("split_rail.node_allgather")
        else:
            self.status = Status.OK

    def _post_sub(self, stage: str) -> None:
        self.obs_stage = stage
        self._sub.obs_stage = stage
        if profiling.ENABLED:
            profiling.span_begin(f"hier_{stage}", self.seq_num)
        self._sub.progress_queue = self.progress_queue
        self._sub.post()


def split_rail_build(hier_team, init_args) -> CollTask:
    node = hier_team.sbgp(SbgpType.NODE)
    net = hier_team.sbgp(SbgpType.NET)
    if node is None or net is None:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       "split_rail requires NODE and NET units (equal ppn)")
    args = init_args.args
    count = int(args.dst.count)
    # in-place reduce_scatter with near-equal splits requires count >= ppn
    if count < node.sbgp.size:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       "split_rail needs count >= node size")

    # optional fragmentation pipeline (UCC pipelines per algorithm): the
    # rail transfer of fragment k overlaps the node reduce_scatter /
    # allgather of fragment k+1
    cfg = hier_team.comp_context.config
    pp = None
    if cfg is not None:
        try:
            pp = parse_pipeline_params(cfg.get("ALLREDUCE_SPLIT_RAIL_PIPELINE"))
        except KeyError:
            pp = None
    dt = args.dst.datatype
    esz = dt_size(dt)
    n_frags, pdepth = (1, 1) if pp is None else pp.nfrags_pdepth(count * esz)
    # align fragments: every fragment equal AND divisible by node size, so
    # the sub-collective algorithms selected at frag build keep a stable
    # geometry across retargets (a near-equal 31/32 split would invalidate
    # e.g. knomial reduce_scatter's divisibility choice mid-pipeline)
    ppn = node.sbgp.size
    while n_frags > 1 and (count % n_frags or
                           (count // n_frags) % max(1, ppn)):
        n_frags -= 1
    frag_cnt = count // n_frags if n_frags else count
    if n_frags <= 1 or frag_cnt < node.sbgp.size:
        return SplitRailAllreduce(hier_team, init_args)

    from ...tl.base import binfo_typed
    full_dst = binfo_typed(args.dst)
    full_src = full_dst if args.is_inplace else binfo_typed(args.src)

    def frag_init(sched_p, idx):
        frag = Schedule(team=hier_team)
        fa = _frag_args(args, full_src, full_dst, dt, 0, count, n_frags, 0)
        _split_rail_fill_frag(hier_team, frag, fa, dt)
        return frag

    def frag_setup(sched_p, frag, frag_num):
        fa = _frag_args(args, full_src, full_dst, dt, 0, count, n_frags,
                        frag_num)
        _split_rail_retarget_frag(hier_team, frag, fa, dt)
        return Status.OK

    return PipelinedSchedule(team=hier_team, args=args, frag_init=frag_init,
                             frag_setup=frag_setup, n_frags=pdepth,
                             n_frags_total=n_frags,
                             order=pp.order if pp else
                             PipelineOrder.SEQUENTIAL)


def _split_rail_geometry(hier_team, fa, dt):
    """Fragment-local views: (work = full frag dst, my node block)."""
    from ...tl.base import binfo_typed
    node = hier_team.sbgp(SbgpType.NODE)
    n, me = node.sbgp.size, node.sbgp.group_rank
    cnt = int(fa.dst.count)
    work = binfo_typed(fa.dst)
    off = block_offset(cnt, n, me)
    blk = block_count(cnt, n, me)
    return work, work[off:off + blk]


def _split_rail_fill_frag(hier_team, sched: Schedule, fa: CollArgs,
                          dt) -> None:
    """Static per-fragment schedule: [copy] -> node reduce_scatter ->
    rail allreduce [-> AVG scale] -> node allgather. Every sub-collective
    is coll_init'd HERE (deterministic tag order across ranks — lazy
    stage-transition inits would race under ordered/parallel pipelining),
    and SEQUENTIAL cross-fragment deps overlap adjacent stages: fragment
    k's rail transfer runs while k+1 does its node reduce_scatter."""
    from ...tl.base import binfo_typed
    node = hier_team.sbgp(SbgpType.NODE)
    net = hier_team.sbgp(SbgpType.NET)
    op = fa.op if fa.op is not None else ReductionOp.SUM
    inner = ReductionOp.SUM if op == ReductionOp.AVG else op
    team_size = hier_team.core_team.size
    work, my_blk = _split_rail_geometry(hier_team, fa, dt)
    cnt = int(fa.dst.count)
    esz = dt_size(dt)
    # live views, mutated by retarget; closures/args read through this
    live = {"fa": fa, "work": work, "blk": my_blk}
    sched._sr_live = live

    def copy_in():
        f = live["fa"]
        if not f.is_inplace:
            live["work"][:] = binfo_typed(f.src)[:live["work"].size]

    t0 = _UnpackTask(copy_in)
    t0.obs_stage = "split_rail.copy_in"
    sched.add_task(t0)
    sched.add_dep_on_schedule_start(t0)

    rs_args = CollArgs(coll_type=CollType.REDUCE_SCATTER, op=inner,
                       dst=_buf(work, dt), flags=CollArgsFlags.IN_PLACE)
    rs_args.src = rs_args.dst
    t1 = node.coll_init(rs_args, MemoryType.HOST, cnt * esz)
    t1.obs_stage = "split_rail.node_reduce_scatter"
    sched.add_task(t1)
    t1.subscribe_dep(t0, EventType.EVENT_COMPLETED)

    ar_args = CollArgs(coll_type=CollType.ALLREDUCE, op=inner,
                       dst=_buf(my_blk, dt), flags=CollArgsFlags.IN_PLACE)
    ar_args.src = ar_args.dst
    t2 = net.coll_init(ar_args, MemoryType.HOST, my_blk.size * esz)
    t2.obs_stage = "split_rail.rail_allreduce"
    sched.add_task(t2)
    t2.subscribe_dep(t1, EventType.EVENT_COMPLETED)
    prev = t2

    if op == ReductionOp.AVG:
        t_s = _ScaleTask(lambda: live["blk"], 1.0 / team_size, dt)
        t_s.obs_stage = "split_rail.scale"
        sched.add_task(t_s)
        t_s.subscribe_dep(prev, EventType.EVENT_COMPLETED)
        prev = t_s

    ag_args = CollArgs(coll_type=CollType.ALLGATHER,
                       dst=_buf(work, dt), flags=CollArgsFlags.IN_PLACE)
    ag_args.src = _buf(my_blk, dt)
    t3 = node.coll_init(ag_args, MemoryType.HOST, cnt * esz)
    t3.obs_stage = "split_rail.node_allgather"
    sched.add_task(t3)
    t3.subscribe_dep(prev, EventType.EVENT_COMPLETED)
    sched._sr_colls = (rs_args, ar_args, ag_args)


def _split_rail_retarget_frag(hier_team, frag: Schedule, fa: CollArgs,
                              dt) -> None:
    """Rebind the fragment's buffer views to the new fragment range."""
    work, my_blk = _split_rail_geometry(hier_team, fa, dt)
    live = frag._sr_live
    live["fa"] = fa
    live["work"] = work
    live["blk"] = my_blk
    rs_args, ar_args, ag_args = frag._sr_colls
    rs_args.dst = _buf(work, dt)
    rs_args.src = rs_args.dst
    ar_args.dst = _buf(my_blk, dt)
    ar_args.src = ar_args.dst
    ag_args.dst = _buf(work, dt)
    ag_args.src = _buf(my_blk, dt)
    for t in frag.tasks:
        targs = getattr(t, "args", None)
        if targs is not None:
            _retarget_task_counts(t, targs)


def allreduce_rab_init(init_args, team) -> CollTask:
    return allreduce_rab_build(team, init_args)


def split_rail_init(init_args, team) -> CollTask:
    return split_rail_build(team, init_args)


# ---------------------------------------------------------------------------
# bcast / reduce 2step, barrier
# ---------------------------------------------------------------------------

def bcast_2step_init(init_args, hier_team) -> CollTask:
    """root's node bcast -> leaders bcast -> other nodes' bcast."""
    args = init_args.args
    node = hier_team.sbgp(SbgpType.NODE)
    leaders = hier_team.sbgp(SbgpType.NODE_LEADERS)
    root = int(args.root)
    topo = hier_team.core_team.topo
    msg = init_args.msgsize
    sched = Schedule(team=hier_team, args=args)

    my_node_ranks = [node.sbgp.map.eval(i) for i in range(node.sbgp.size)]
    root_in_my_node = root in my_node_ranks
    prev = None
    if root_in_my_node:
        b1 = CollArgs(coll_type=CollType.BCAST,
                      root=my_node_ranks.index(root), src=args.src)
        t1 = node.coll_init(b1, MemoryType.HOST, msg)
        t1.obs_stage = "2step.root_node_bcast"
        sched.add_task(t1)
        sched.add_dep_on_schedule_start(t1)
        prev = t1
    if leaders is not None and leaders.sbgp.is_member:
        # leaders bcast rooted at root's node-leader
        root_leader_idx = _leader_index_of(hier_team, root)
        b2 = CollArgs(coll_type=CollType.BCAST, root=root_leader_idx,
                      src=args.src)
        t2 = leaders.coll_init(b2, MemoryType.HOST, msg)
        t2.obs_stage = "2step.leaders_bcast"
        sched.add_task(t2)
        if prev is not None:
            t2.subscribe_dep(prev, EventType.EVENT_COMPLETED)
        else:
            sched.add_dep_on_schedule_start(t2)
        prev = t2
    if not root_in_my_node:
        b3 = CollArgs(coll_type=CollType.BCAST, root=0, src=args.src)
        t3 = node.coll_init(b3, MemoryType.HOST, msg)
        t3.obs_stage = "2step.node_bcast"
        sched.add_task(t3)
        if prev is not None:
            t3.subscribe_dep(prev, EventType.EVENT_COMPLETED)
        else:
            sched.add_dep_on_schedule_start(t3)
    return sched


def _leader_index_of(hier_team, team_rank: int) -> int:
    """Index within NODE_LEADERS of the leader of team_rank's node."""
    topo = hier_team.core_team.topo
    leaders_sbgp = topo.get_sbgp(SbgpType.NODE_LEADERS)
    lead_ranks = [leaders_sbgp.map.eval(i)
                  for i in range(leaders_sbgp.size)]
    target = topo._proc(team_rank).host_hash
    for i, lr in enumerate(lead_ranks):
        if topo._proc(lr).host_hash == target:
            return i
    raise UccError(Status.ERR_NOT_FOUND, "no leader for rank's node")


def reduce_2step_init(init_args, hier_team) -> CollTask:
    """node reduce (to leader) -> leaders reduce (to root's leader) ->
    handoff to root via a node bcast when root is not its node's leader.
    AVG runs SUM internally with a post-scale at root."""
    args = init_args.args
    node = hier_team.sbgp(SbgpType.NODE)
    leaders = hier_team.sbgp(SbgpType.NODE_LEADERS)
    root = int(args.root)
    team_rank = hier_team.core_team.rank
    msg = init_args.msgsize
    op = args.op if args.op is not None else ReductionOp.SUM
    inner = ReductionOp.SUM if op == ReductionOp.AVG else op
    sched = Schedule(team=hier_team, args=args)
    my_node_ranks = [node.sbgp.map.eval(i) for i in range(node.sbgp.size)]
    root_in_my_node = root in my_node_ranks
    is_leader = node.sbgp.group_rank == 0
    is_root = team_rank == root
    root_is_leader_of_its_node = _root_is_leader(hier_team, root)
    dt = (args.src or args.dst).datatype
    nd = storage_dtype(dt)
    count = int((args.src or args.dst).count)
    # the node representative accumulates in scratch (or straight into dst
    # when the root itself is the representative)
    use_dst_directly = is_root and is_leader
    scratch = None
    if is_leader and not use_dst_directly:
        scratch = np.zeros(count, dtype=nd)

    # stage 1: intra-node reduce to the leader
    r1 = CollArgs(coll_type=CollType.REDUCE, root=0,
                  src=args.dst if args.is_inplace else args.src,
                  dst=(args.dst if use_dst_directly
                       else (_buf(scratch, dt) if is_leader else None)),
                  op=inner,
                  flags=CollArgsFlags.IN_PLACE if (args.is_inplace and
                                                   use_dst_directly)
                  else CollArgsFlags(0))
    t1 = node.coll_init(r1, MemoryType.HOST, msg)
    t1.obs_stage = "2step.node_reduce"
    sched.add_task(t1)
    sched.add_dep_on_schedule_start(t1)
    prev = t1

    # stage 2: leaders reduce to root's leader
    if leaders is not None and leaders.sbgp.is_member:
        root_leader_idx = _leader_index_of(hier_team, root)
        at_final = leaders.sbgp.group_rank == root_leader_idx
        r2 = CollArgs(coll_type=CollType.REDUCE, root=root_leader_idx,
                      src=(args.dst if use_dst_directly else
                           _buf(scratch, dt)),
                      dst=(args.dst if (at_final and use_dst_directly) else
                           (_buf(scratch, dt) if at_final else None)),
                      op=inner,
                      flags=CollArgsFlags.IN_PLACE if at_final else
                      CollArgsFlags(0))
        t2 = leaders.coll_init(r2, MemoryType.HOST, msg)
        t2.obs_stage = "2step.leaders_reduce"
        sched.add_task(t2)
        t2.subscribe_dep(prev, EventType.EVENT_COMPLETED)
        prev = t2

    # stage 3: leader -> root handoff within root's node (node bcast)
    if root_in_my_node and not root_is_leader_of_its_node:
        hand_buf = args.dst if is_root else \
            (_buf(scratch, dt) if scratch is not None
             else _buf(np.zeros(count, dtype=nd), dt))
        b = CollArgs(coll_type=CollType.BCAST, root=0, src=hand_buf)
        t3 = node.coll_init(b, MemoryType.HOST, msg)
        t3.obs_stage = "2step.leader_root_handoff"
        sched.add_task(t3)
        t3.subscribe_dep(prev, EventType.EVENT_COMPLETED)
        prev = t3

    if op == ReductionOp.AVG and is_root:
        t4 = _ScaleTask(lambda a=args, d=dt: _dst_view(a, d),
                        1.0 / hier_team.core_team.size, dt)
        sched.add_task(t4)
        t4.subscribe_dep(prev, EventType.EVENT_COMPLETED)
    return sched


def _root_is_leader(hier_team, root: int) -> bool:
    topo = hier_team.core_team.topo
    nl = topo.get_sbgp(SbgpType.NODE_LEADERS)
    return any(nl.map.eval(i) == root for i in range(nl.size))


def barrier_init(init_args, hier_team) -> CollTask:
    """fanin(node) -> barrier(leaders) -> fanout(node)."""
    node = hier_team.sbgp(SbgpType.NODE)
    leaders = hier_team.sbgp(SbgpType.NODE_LEADERS)
    sched = Schedule(team=hier_team, args=init_args.args)
    t1 = node.coll_init(CollArgs(coll_type=CollType.FANIN, root=0),
                        MemoryType.HOST, 0)
    t1.obs_stage = "barrier.node_fanin"
    sched.add_task(t1)
    sched.add_dep_on_schedule_start(t1)
    prev = t1
    if leaders is not None and leaders.sbgp.is_member:
        t2 = leaders.coll_init(CollArgs(coll_type=CollType.BARRIER),
                               MemoryType.HOST, 0)
        t2.obs_stage = "barrier.leaders_barrier"
        sched.add_task(t2)
        t2.subscribe_dep(prev, EventType.EVENT_COMPLETED)
        prev = t2
    t3 = node.coll_init(CollArgs(coll_type=CollType.FANOUT, root=0),
                        MemoryType.HOST, 0)
    t3.obs_stage = "barrier.node_fanout"
    sched.add_task(t3)
    t3.subscribe_dep(prev, EventType.EVENT_COMPLETED)
    return sched


def _nodes_by_leader(topo, team_size: int):
    """(node_leader_ranks, by_node): nodes in NODE_LEADERS order, members
    in ascending team-rank order — the grouped layout every hierarchical
    data movement in this module agrees on."""
    nl = topo.get_sbgp(SbgpType.NODE_LEADERS)
    node_leader_ranks = [nl.map.eval(i) for i in range(nl.size)]
    by_node = []
    for lr in node_leader_ranks:
        hh = topo._proc(lr).host_hash
        by_node.append([r for r in range(team_size)
                        if topo._proc(r).host_hash == hh])
    return node_leader_ranks, by_node


class _UnpackTask(CollTask):
    """Run a host step (pack, unpack, a copy to or from the device) as a
    schedule task; the allgatherv unpack step reorders the node-grouped
    gather result into the user's dst layout. A failing step fails THIS
    task (peers see the error through the schedule), not whichever rank's
    progress loop ran it."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def post_fn(self) -> Status:
        try:
            self.fn()
        except UccError as e:
            logger.exception("hier host step failed")
            self.status = e.status
            return e.status
        except Exception:  # noqa: BLE001 - fail the task, not the caller's
            logger.exception("hier host step failed")
            self.status = Status.ERR_NO_MESSAGE
            return Status.ERR_NO_MESSAGE
        self.status = Status.OK
        return Status.OK


def allgatherv_hier_init(init_args, hier_team) -> CollTask:
    """node gatherv -> leaders allgatherv -> node bcast -> unpack."""
    from ...api.types import BufferInfo, BufferInfoV
    from ...tl.base import binfo_typed

    args = init_args.args
    node = hier_team.sbgp(SbgpType.NODE)
    leaders = hier_team.sbgp(SbgpType.NODE_LEADERS)
    topo = hier_team.core_team.topo
    team_size = hier_team.core_team.size
    dstv = args.dst
    counts = [int(c) for c in dstv.counts]
    displs = [int(d) for d in dstv.displacements] \
        if dstv.displacements is not None else \
        list(np.cumsum([0] + counts[:-1]))
    total = sum(counts)
    # user dst may have GAPS between blocks (MPI-legal displacements):
    # the view must span the furthest block end, not just sum(counts)
    dst_span = max((displs[r] + counts[r] for r in range(len(counts))),
                   default=0)
    dt = dstv.datatype
    nd = storage_dtype(dt)
    msg = total * nd.itemsize

    # grouped order: nodes in NODE_LEADERS order, members in NODE order
    node_leader_ranks, by_node = _nodes_by_leader(topo, team_size)
    grouped_order = [r for grp in by_node for r in grp]
    g_off = {}
    off = 0
    for r in grouped_order:
        g_off[r] = off
        off += counts[r]

    scratch = np.zeros(total, dtype=nd)
    my_node_ranks = [node.sbgp.map.eval(i) for i in range(node.sbgp.size)]
    node_counts = [counts[r] for r in my_node_ranks]
    node_total = sum(node_counts)
    is_leader = node.sbgp.group_rank == 0
    # my node's region within the grouped layout
    node_base = g_off[my_node_ranks[0]]

    sched = Schedule(team=hier_team, args=args)

    # stage 1: gatherv within the node into the node's grouped region
    node_region = scratch[node_base:node_base + node_total]
    my_rank = hier_team.core_team.rank
    src_bi = args.src if not args.is_inplace else BufferInfo(
        binfo_typed(dstv, counts[my_rank], displs[my_rank]),
        counts[my_rank], dt)
    g1 = CollArgs(coll_type=CollType.GATHERV, root=0, src=src_bi,
                  dst=BufferInfoV(node_region, node_counts, None, dt)
                  if is_leader else None)
    t1 = node.coll_init(g1, MemoryType.HOST, msg)
    sched.add_task(t1)
    sched.add_dep_on_schedule_start(t1)
    prev = t1

    # stage 2: leaders allgatherv of whole-node regions
    if leaders is not None and leaders.sbgp.is_member:
        per_node_counts = [sum(counts[r] for r in grp) for grp in by_node]
        a2 = CollArgs(
            coll_type=CollType.ALLGATHERV,
            src=BufferInfo(node_region, node_total, dt),
            dst=BufferInfoV(scratch, per_node_counts, None, dt))
        t2 = leaders.coll_init(a2, MemoryType.HOST, msg)
        sched.add_task(t2)
        t2.subscribe_dep(prev, EventType.EVENT_COMPLETED)
        prev = t2

    # stage 3: node bcast of the full grouped buffer
    b3 = CollArgs(coll_type=CollType.BCAST, root=0,
                  src=BufferInfo(scratch, total, dt))
    t3 = node.coll_init(b3, MemoryType.HOST, msg)
    sched.add_task(t3)
    t3.subscribe_dep(prev, EventType.EVENT_COMPLETED)

    # stage 4: unpack grouped order -> user dst layout
    def unpack():
        dst_flat = binfo_typed(dstv, dst_span)
        for r in range(team_size):
            dst_flat[displs[r]:displs[r] + counts[r]] = \
                scratch[g_off[r]:g_off[r] + counts[r]]
    t4 = _UnpackTask(unpack)
    sched.add_task(t4)
    t4.subscribe_dep(t3, EventType.EVENT_COMPLETED)
    return sched


def alltoall_hier_init(init_args, hier_team) -> CollTask:
    """Node-aggregated alltoall for small messages (UCC_CL_HIER_A2AV_NODE_THRESH):
    members funnel their whole
    send buffers to the node leader, leaders exchange per-node aggregates
    (one big message per node pair instead of p*p small ones between nodes),
    then leaders scatter and members unpack. All sizes are static for the
    equal-block alltoall, so the whole pipeline is one schedule.
    """
    from ...api.types import BufferInfo, BufferInfoV
    from ...tl.base import binfo_typed

    args = init_args.args
    node = hier_team.sbgp(SbgpType.NODE)
    leaders = hier_team.sbgp(SbgpType.NODE_LEADERS)
    topo = hier_team.core_team.topo
    N = hier_team.core_team.size
    total = int(args.dst.count)
    if total % N != 0:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       "alltoall needs count divisible by team size")
    blk = total // N
    dt = args.dst.datatype
    nd = storage_dtype(dt)
    msg = total * nd.itemsize

    node_leader_ranks, by_node = _nodes_by_leader(topo, N)
    my_node_ranks = [node.sbgp.map.eval(i) for i in range(node.sbgp.size)]
    p_me = len(my_node_ranks)
    is_leader = node.sbgp.group_rank == 0

    sched = Schedule(team=hier_team, args=args)
    if args.is_inplace:
        # snapshot the buffer at POST time (a schedule-start task), not at
        # init: persistent re-posts must read fresh data
        src_flat = np.zeros(total, dtype=nd)

        def snapshot():
            src_flat[:] = binfo_typed(args.dst, total)

        t_snap = _UnpackTask(snapshot)
        sched.add_task(t_snap)
        sched.add_dep_on_schedule_start(t_snap)
    else:
        src_flat = binfo_typed(args.src, total)

    # stage 1: node gatherv of members' full send buffers -> leader
    G = np.zeros(p_me * total, dtype=nd) if is_leader else None
    g1 = CollArgs(coll_type=CollType.GATHERV, root=0,
                  src=BufferInfo(src_flat, total, dt),
                  dst=BufferInfoV(G, [total] * p_me, None, dt)
                  if is_leader else None)
    t1 = node.coll_init(g1, MemoryType.HOST, msg)
    sched.add_task(t1)
    if args.is_inplace:
        t1.subscribe_dep(t_snap, EventType.EVENT_COMPLETED)
    else:
        sched.add_dep_on_schedule_start(t1)
    prev = t1

    # leader-side stages
    R_member = np.zeros(total, dtype=nd)      # my eventual recv (grouped)
    if is_leader and leaders is not None and leaders.sbgp.is_member:
        scounts = [len(grp) * p_me * blk for grp in by_node]
        rcounts = [p_me * len(grp) * blk for grp in by_node]
        A_out = np.zeros(sum(scounts), dtype=nd)
        A_in = np.zeros(sum(rcounts), dtype=nd)
        M = np.zeros(p_me * total, dtype=nd)   # per-member scatter payloads

        # index maps precomputed ONCE at init: per-post pack/repack are a
        # single fancy-index numpy op each, not O(nodes*ppn*ppn) python
        # loops
        pack_starts = np.array(
            [s * total + t_rank * blk
             for grp in by_node for t_rank in grp for s in range(p_me)],
            dtype=np.intp)
        pack_idx = (pack_starts[:, None] + np.arange(blk)).ravel()
        # repack: M[t*total + g_off_S + s*blk + j] =
        #         A_in[node_off_S + t*p_S*blk + s*blk + j]
        m_starts, a_starts = [], []
        node_off = g_off = 0
        for grp in by_node:
            p_S = len(grp)
            for t in range(p_me):
                m_starts.append(t * total + g_off)
                a_starts.append(node_off + t * p_S * blk)
            node_off += p_me * p_S * blk
            g_off += p_S * blk
        m_idx = np.concatenate(
            [ms + np.arange(len(by_node[i // p_me]) * blk)
             for i, ms in enumerate(m_starts)]) if m_starts else \
            np.empty(0, np.intp)
        a_idx = np.concatenate(
            [as_ + np.arange(len(by_node[i // p_me]) * blk)
             for i, as_ in enumerate(a_starts)]) if a_starts else \
            np.empty(0, np.intp)

        def pack():
            A_out[:] = G[pack_idx]

        t_pack = _UnpackTask(pack)
        sched.add_task(t_pack)
        t_pack.subscribe_dep(prev, EventType.EVENT_COMPLETED)

        a2 = CollArgs(coll_type=CollType.ALLTOALLV,
                      src=BufferInfoV(A_out, scounts, None, dt),
                      dst=BufferInfoV(A_in, rcounts, None, dt))
        t_a2 = leaders.coll_init(a2, MemoryType.HOST, msg)
        sched.add_task(t_a2)
        t_a2.subscribe_dep(t_pack, EventType.EVENT_COMPLETED)

        def repack():
            M[m_idx] = A_in[a_idx]

        t_rep = _UnpackTask(repack)
        sched.add_task(t_rep)
        t_rep.subscribe_dep(t_a2, EventType.EVENT_COMPLETED)
        prev = t_rep

        s3_src = BufferInfoV(M, [total] * p_me, None, dt)
    else:
        s3_src = None

    # stage 3: node scatterv of per-member grouped payloads
    s3 = CollArgs(coll_type=CollType.SCATTERV, root=0, src=s3_src,
                  dst=BufferInfo(R_member, total, dt))
    t3 = node.coll_init(s3, MemoryType.HOST, msg)
    sched.add_task(t3)
    t3.subscribe_dep(prev, EventType.EVENT_COMPLETED)

    # stage 4: grouped (node, member) order -> dst by src team rank
    # (index map precomputed; per-post unpack is one fancy-index op)
    grouped_order = [r for grp in by_node for r in grp]
    unp_starts = np.array([r * blk for r in grouped_order], dtype=np.intp)
    unp_idx = (unp_starts[:, None] + np.arange(blk)).ravel()

    def unpack():
        dst_flat = binfo_typed(args.dst, total)
        dst_flat[unp_idx] = R_member

    t4 = _UnpackTask(unpack)
    sched.add_task(t4)
    t4.subscribe_dep(t3, EventType.EVENT_COMPLETED)
    return sched


class AlltoallvHierNodeAgg(CollTask):
    """Node-aggregated alltoallv: per-pair counts are first allgathered
    over the FULL unit (UCC's counts exchange), after which every aggregation
    stage's geometry is locally computable:

      1. members pack their send blocks (dst-rank order) and gatherv them
         to the node leader;
      2. the leader packs per-node aggregates (one fancy-index op) and
         the leaders run ONE alltoallv — one big message per node pair
         instead of ppn*ppn small ones;
      3. the leader repacks per-member payloads, scattervs them, and
         members unpack into dst by displacement.

    Later stages' counts depend on stage-0 results, so this is a lazy
    stage machine (the SplitRailAllreduce pattern), not a static DAG.
    """

    obs_stage = ""

    def __init__(self, hier_team, init_args):
        super().__init__(team=hier_team, args=init_args.args)
        from ...api.types import BufferInfoV
        args = init_args.args
        if not isinstance(args.src, BufferInfoV) or args.src.counts is None \
                or not isinstance(args.dst, BufferInfoV) or \
                args.dst.counts is None:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "hier a2av requires src and dst counts")
        if args.is_inplace:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "hier a2av: in-place not supported")
        if hier_team.sbgp(SbgpType.FULL) is None:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "hier a2av needs the FULL unit for the counts "
                           "exchange")
        self.hier_team = hier_team
        self.init_args = init_args
        self._stage = 0
        self._sub: Optional[CollTask] = None

    def post_fn(self) -> Status:
        ht = self.hier_team
        args = self.args
        self.N = ht.core_team.size
        self.me = ht.core_team.rank
        node = ht.sbgp(SbgpType.NODE)
        self.node = node
        self.leaders = ht.sbgp(SbgpType.NODE_LEADERS)
        self.full = ht.sbgp(SbgpType.FULL)
        self.is_leader = node.sbgp.group_rank == 0
        topo = ht.core_team.topo
        self.node_leader_ranks, self.by_node = _nodes_by_leader(topo, self.N)
        self.my_node_ranks = [node.sbgp.map.eval(i)
                              for i in range(node.sbgp.size)]
        self.nd = storage_dtype(args.dst.datatype)
        self.dt = args.dst.datatype
        self.scounts = np.array([int(c) for c in args.src.counts],
                                dtype=np.int64)
        self._stage = 0
        self._sub = None
        self._advance()
        return Status.OK

    def progress_fn(self) -> None:
        self._advance()

    def _post_sub(self, stage: str) -> None:
        self.obs_stage = stage
        self._sub.obs_stage = stage
        if profiling.ENABLED:
            profiling.span_begin(f"hier_{stage}", self.seq_num)
        self._sub.progress_queue = self.progress_queue
        self._sub.post()

    def _advance(self) -> None:   # noqa: PLR0915 - staged protocol
        from ...api.types import BufferInfoV
        from ...tl.base import binfo_typed, binfo_v_block
        if self._sub is not None:
            if not self._sub.is_completed():
                return
            if profiling.ENABLED and self.obs_stage:
                profiling.span_end(f"hier_{self.obs_stage}", self.seq_num,
                                   status=self._sub.super_status.name)
            if self._sub.super_status.is_error:
                self.status = self._sub.super_status
                return
            self._sub = None
            self._stage += 1
        args = self.args
        N, me = self.N, self.me
        nd = self.nd
        p_me = len(self.my_node_ranks)
        msg = int(np.sum(self.scounts)) * nd.itemsize

        if self._stage == 0:
            # counts exchange over the FULL unit
            self.m_flat = np.zeros(N * N, dtype=np.int64)
            a = CollArgs(coll_type=CollType.ALLGATHER,
                         src=_buf(self.scounts, DataType.INT64),
                         dst=_buf(self.m_flat, DataType.INT64))
            self._sub = self.full.coll_init(a, MemoryType.HOST, N * 8)
            self._post_sub("a2av_agg.counts_allgather")
            return

        m = self.m_flat.reshape(N, N)
        if self._stage == 1:
            # member pack (dst-rank order) + node gatherv to the leader
            packed = np.empty(int(np.sum(self.scounts)), dtype=nd)
            off = 0
            for p in range(N):
                c = int(self.scounts[p])
                packed[off:off + c] = binfo_v_block(args.src, p)
                off += c
            member_totals = [int(np.sum(m[s])) for s in self.my_node_ranks]
            if self.is_leader:
                self.G = np.empty(int(np.sum(member_totals)), dtype=nd)
                gdst = BufferInfoV(self.G, member_totals, None, self.dt)
            else:
                self.G = None
                gdst = None
            g = CollArgs(coll_type=CollType.GATHERV, root=0,
                         src=_buf(packed, self.dt), dst=gdst)
            self._sub = self.node.coll_init(g, MemoryType.HOST, msg)
            self._post_sub("a2av_agg.node_gatherv")
            return

        if self._stage == 2:
            if self.is_leader and self.leaders is not None and \
                    self.leaders.sbgp.is_member:
                # leader pack: for dst node D: for t in D: for s in my
                # node members (grouped order): block s->t. G layout is
                # member-major (member s's packed row, dst-rank order).
                g_off = {}
                off = 0
                for s in self.my_node_ranks:
                    g_off[s] = off
                    off += int(np.sum(m[s]))
                row_displ = np.zeros((N, N), dtype=np.int64)
                row_displ[:, 1:] = np.cumsum(m, axis=1)[:, :-1]
                starts, lens = [], []
                for grp in self.by_node:
                    for t in grp:
                        for s in self.my_node_ranks:
                            starts.append(g_off[s] + int(row_displ[s, t]))
                            lens.append(int(m[s, t]))
                idx = np.concatenate(
                    [st + np.arange(ln) for st, ln in zip(starts, lens)
                     if ln]) if any(lens) else np.empty(0, np.intp)
                self.A_out = self.G[idx] if idx.size else np.empty(0, nd)
                scounts_l = [int(sum(m[s, t] for s in self.my_node_ranks
                                     for t in grp))
                             for grp in self.by_node]
                rcounts_l = [int(sum(m[s, t] for s in grp
                                     for t in self.my_node_ranks))
                             for grp in self.by_node]
                self.A_in = np.empty(int(np.sum(rcounts_l)), dtype=nd)
                a2 = CollArgs(
                    coll_type=CollType.ALLTOALLV,
                    src=BufferInfoV(self.A_out, scounts_l, None, self.dt),
                    dst=BufferInfoV(self.A_in, rcounts_l, None, self.dt))
                self._sub = self.leaders.coll_init(a2, MemoryType.HOST,
                                                   msg)
                self._post_sub("a2av_agg.leaders_alltoallv")
                return                          # completion -> stage 3
            self._stage = 3                     # non-leader: skip a2av

        if self._stage == 3:
            if self.is_leader:
                # repack: A_in per src node S: for t in my node: for s in
                # S: block s->t  ->  M per member t: grouped src order
                member_rtotals = [int(sum(m[s, t] for s in range(N)))
                                  for t in self.my_node_ranks]
                m_off = {}
                off = 0
                for i, t in enumerate(self.my_node_ranks):
                    m_off[t] = off
                    off += member_rtotals[i]
                self.M = np.empty(off, dtype=nd)
                t_cursor = dict(m_off)
                a_cursor = 0
                m_starts, a_starts, lens = [], [], []
                for grp in self.by_node:
                    for t in self.my_node_ranks:
                        for s in grp:
                            ln = int(m[s, t])
                            m_starts.append(t_cursor[t])
                            a_starts.append(a_cursor)
                            lens.append(ln)
                            t_cursor[t] += ln
                            a_cursor += ln
                mi = np.concatenate([st + np.arange(ln) for st, ln in
                                     zip(m_starts, lens) if ln]) \
                    if any(lens) else np.empty(0, np.intp)
                ai = np.concatenate([st + np.arange(ln) for st, ln in
                                     zip(a_starts, lens) if ln]) \
                    if any(lens) else np.empty(0, np.intp)
                if mi.size:
                    self.M[mi] = self.A_in[ai]
                src = BufferInfoV(self.M, member_rtotals, None, self.dt)
            else:
                src = None
            my_rtotal = int(sum(m[s, me] for s in range(N)))
            self.R = np.empty(my_rtotal, dtype=nd)
            s3 = CollArgs(coll_type=CollType.SCATTERV, root=0, src=src,
                          dst=_buf(self.R, self.dt))
            self._sub = self.node.coll_init(s3, MemoryType.HOST,
                                            my_rtotal * nd.itemsize)
            self._post_sub("a2av_agg.node_scatterv")
            return                              # completion -> stage 4

        if self._stage == 4:
            # unpack R (grouped src order) -> dst at displacements
            dstv = args.dst
            rcounts = [int(c) for c in dstv.counts]
            displs = [int(d) for d in dstv.displacements] \
                if dstv.displacements is not None else \
                list(np.cumsum([0] + rcounts[:-1]))
            span = max((displs[p] + rcounts[p] for p in range(N)),
                       default=0)
            dst_flat = binfo_typed(dstv, span)
            off = 0
            for s in (x for grp in self.by_node for x in grp):
                c = rcounts[s]
                dst_flat[displs[s]:displs[s] + c] = self.R[off:off + c]
                off += c
            self.status = Status.OK
            return
        self.status = Status.OK


def alltoallv_hier_init(init_args, hier_team) -> CollTask:
    return AlltoallvHierNodeAgg(hier_team, init_args)


def allgather_hier_init(init_args, hier_team) -> CollTask:
    """ALLGATHER as the v-variant with uniform counts (the hier
    gatherv -> leaders allgatherv -> bcast -> unpack pipeline serves both;
    it writes the user's dst in place)."""
    import dataclasses

    from ...api.types import BufferInfoV
    args = init_args.args
    n = hier_team.core_team.size
    total = int(args.dst.count)
    if total % n != 0:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       "hier allgather needs count divisible by team size")
    blk = total // n
    dstv = BufferInfoV(args.dst.buffer, [blk] * n, None, args.dst.datatype,
                       mem_type=args.dst.mem_type)
    vargs = dataclasses.replace(args, dst=dstv)
    return allgatherv_hier_init(
        dataclasses.replace(init_args, args=vargs), hier_team)


# ---------------------------------------------------------------------------
# scores
# ---------------------------------------------------------------------------

def build_hier_scores(hier_team) -> CollScore:
    import os

    from ...utils.config import SIZE_INF
    from .cuda import (allreduce_rab_tpu_init, allreduce_split_rail_tpu_init,
                       staged_init)
    s = CollScore()
    mem = MemoryType.HOST
    by_name = {}    # (coll, name) -> init fn, for the TUNE resolver

    def add(coll, score, init, name):
        fn = lambda ia, t, f=init: f(ia, hier_team)   # noqa: E731
        by_name[(coll, name)] = fn
        s.add_range(coll, mem, 0, SIZE_INF, score, fn, hier_team, name)

    def add_cuda(coll, score, init, name, staged=True):
        """CUDA-memory row: on-device node stages where the algorithm has
        them, else the generic device-to-host staging wrapper
        (``cuda.staged_init``). The names are the JAX package's, so TUNE
        strings and ``print_info`` rows carry over."""
        if staged:
            fn = lambda ia, t, f=init: staged_init(ia, hier_team, f)  # noqa: E731
        else:
            fn = lambda ia, t, f=init: f(ia, hier_team)               # noqa: E731
        by_name[(coll, name)] = fn
        s.add_range(coll, MemoryType.CUDA, 0, SIZE_INF, score, fn,
                    hier_team, name)

    add(CollType.ALLREDUCE, HIER_SCORE, allreduce_rab_init, "rab")
    if hier_team.sbgp(SbgpType.NET) is not None:
        add(CollType.ALLREDUCE, HIER_SCORE - 1, split_rail_init,
            "split_rail")
    add(CollType.BCAST, HIER_SCORE, bcast_2step_init, "2step")
    add(CollType.ALLGATHERV, HIER_SCORE, allgatherv_hier_init, "unpack")
    # node aggregation pays off for small messages between nodes; gated by
    # the A2AV_NODE_THRESH knob
    thresh = 1024
    cfg = hier_team.comp_context.config
    if cfg is not None:
        try:
            from ...utils.config import parse_memunits
            thresh = parse_memunits(cfg.get("A2AV_NODE_THRESH"))
        except (KeyError, ValueError):
            pass
    a2a_fn = lambda ia, t: alltoall_hier_init(ia, hier_team)    # noqa: E731
    a2av_fn = lambda ia, t: alltoallv_hier_init(ia, hier_team)  # noqa: E731
    by_name[(CollType.ALLTOALL, "node_agg")] = a2a_fn
    by_name[(CollType.ALLTOALLV, "node_agg")] = a2av_fn
    s.add_range(CollType.ALLTOALL, mem, 0, thresh, HIER_SCORE, a2a_fn,
                hier_team, "node_agg")
    s.add_range(CollType.ALLTOALLV, mem, 0, thresh, HIER_SCORE, a2av_fn,
                hier_team, "node_agg")
    add(CollType.REDUCE, HIER_SCORE, reduce_2step_init, "2step")
    add(CollType.BARRIER, HIER_SCORE, barrier_init, "knomial_hier")

    # N-level tree composition: on 3+-level layouts (pods detected) the
    # tree algorithms are the hier default (the flat leaders unit would
    # send every pod's traffic across pods directly). On 2-level layouts
    # they register at score 1, reachable through TUNE strings without
    # changing the default.
    tree = getattr(hier_team, "tree", None)
    if tree is not None and tree.n_levels >= 2:
        from .nlevel import (allgather_nlvl_init, allgatherv_nlvl_init,
                             allreduce_nlvl_init, barrier_nlvl_init,
                             bcast_nlvl_init, reduce_nlvl_init)
        nscore = HIER_SCORE + 1 if tree.n_levels >= 3 else 1
        add(CollType.ALLREDUCE, nscore, allreduce_nlvl_init, "nrab")
        add(CollType.BCAST, nscore, bcast_nlvl_init, "nstep")
        add(CollType.REDUCE, nscore, reduce_nlvl_init, "nstep")
        add(CollType.BARRIER, nscore, barrier_nlvl_init, "nlvl")
        add(CollType.ALLGATHERV, nscore, allgatherv_nlvl_init, "nlvl")
        add(CollType.ALLGATHER, nscore, allgather_nlvl_init, "nlvl")

    # CUDA-memory rows. allreduce runs its node stages on the device
    # through the NODE unit's device TL team (rab_tpu); the others stage
    # through host memory at the hierarchy boundary (UCC's cl_hier covers
    # CUDA memory through the memory-capable TLs of each unit).
    add_cuda(CollType.ALLREDUCE, HIER_SCORE, allreduce_rab_tpu_init,
             "rab_tpu", staged=False)
    if hier_team.sbgp(SbgpType.NET) is not None:
        # split_rail with on-device node stages: every rail moves
        # count/ppn elements between nodes; one score below rab_tpu like
        # the host pair, TUNE-selectable
        add_cuda(CollType.ALLREDUCE, HIER_SCORE - 1,
                 allreduce_split_rail_tpu_init, "split_rail_tpu",
                 staged=False)
    add_cuda(CollType.BCAST, HIER_SCORE, bcast_2step_init, "2step_staged")
    add_cuda(CollType.REDUCE, HIER_SCORE, reduce_2step_init, "2step_staged")
    add_cuda(CollType.ALLGATHERV, HIER_SCORE, allgatherv_hier_init,
             "unpack_staged")
    add_cuda(CollType.ALLGATHER, HIER_SCORE, allgather_hier_init,
             "unpack_staged")
    add_cuda(CollType.ALLTOALL, HIER_SCORE, alltoall_hier_init,
             "node_agg_staged")
    add_cuda(CollType.ALLTOALLV, HIER_SCORE, alltoallv_hier_init,
             "node_agg_staged")
    add_cuda(CollType.BARRIER, HIER_SCORE, barrier_init, "knomial_hier",
             staged=False)

    tune = os.environ.get("UCC_CL_HIER_TUNE", "")
    if tune:
        def resolver(coll, alg):
            return by_name.get((coll, alg))
        st = s.update_from_str(tune, resolver, hier_team)
        if st.is_error:
            raise UccError(st, "bad tune string in UCC_CL_HIER_TUNE")
    return s
