"""cl/hier on CUDA memory (UCC's cl/hier over its units' CUDA-capable TLs).

Two ways, as in the JAX package's ``cl/hier/tpu.py``, whose row names this
module keeps (``rab_tpu``, ``split_rail_tpu``, ``2step_staged``,
``unpack_staged``, ``node_agg_staged``, ``knomial_hier``) so that TUNE
strings and ``print_info`` rows carry over:

1. **On-device node stages** (``rab_tpu``, ``split_rail_tpu``): when the
   NODE unit has a tl/torch_ops team, the intra-node reduce (or
   reduce_scatter) and bcast (or allgather) run on the device through the
   unit's device TLs (torch_ops, or ring_cuda's kernels where TUNE pins
   them); only the inter-node allreduce goes through host memory, over the
   leaders' (or rails') host TLs. Device-to-host and host-to-device copies
   happen once per direction, on the already reduced vector (or block).
2. **Staged wrapper** (``staged_init``): every other hier collective
   copies its CUDA buffers to host scratch at post time, runs the host
   schedule of ``algs.py`` and copies the result back. It is also the
   path when the NODE unit has no torch_ops team.

Results land IN PLACE in the caller's tensors (the JAX package rebinds
``dst.buffer`` to a new immutable array instead). A copy from the device
reads a node stage's result only after that stage's task completed, which
is after its CUDA event: the copy never races the launch. Host scratch
that persistent rounds reuse is allocated once, pinned on a CUDA device.
AVG divides on the leader's host scratch, as the JAX package does, so the
bits match it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...api.types import BufferInfo, BufferInfoV, CollArgs
from ...constants import (CollArgsFlags, CollType, EventType, MemoryType,
                          ReductionOp, dt_size, dt_torch)
from ...ec.cpu import storage_dtype
from ...schedule.schedule import Schedule
from ...schedule.task import CollTask
from ...status import Status, UccError
from ...topo.sbgp import SbgpType
from ...utils.log import get_logger
from ...utils.mathutils import block_count, block_offset
from .nlevel import _op_pair
from .algs import _retarget_task_counts, _UnpackTask, divide_array

logger = get_logger("cl_hier")


# ---------------------------------------------------------------------------
# staging primitives
# ---------------------------------------------------------------------------

def _rank_device(hier_team, args: CollArgs) -> torch.device:
    """The device results land on: the buffer's own device when there is
    one, else the device TL context's device."""
    for bi in (args.dst, args.src):
        if bi is not None and isinstance(bi.buffer, torch.Tensor) and \
                bi.mem_type == MemoryType.CUDA:
            return bi.buffer.device
    tls = hier_team.core_team.context.tl_contexts
    for name in ("torch_ops", "ring_cuda"):
        h = tls.get(name)
        if h is not None:
            return h.obj.device
    raise UccError(Status.ERR_NO_RESOURCE,
                   "cl/hier: no device for a CUDA-memory collective")


def _host_tensor(arr: np.ndarray, td: torch.dtype) -> torch.Tensor:
    """A tensor over numpy array *arr*'s memory, typed *td* (bfloat16 over
    its uint16 bit patterns)."""
    return torch.from_numpy(arr.reshape(-1).view(np.uint8)).view(td)


def _scratch(count: int, dt, device: torch.device) -> np.ndarray:
    """Host scratch of *count* elements (storage dtype): pinned memory
    when the device is a GPU, so the copies run at the link's rate."""
    nd = storage_dtype(dt)
    if device.type != "cuda":
        return np.zeros(count, dtype=nd)
    raw = torch.zeros(count * nd.itemsize, dtype=torch.uint8,
                      pin_memory=True)
    return raw.numpy().view(nd)


def _d2h(src: torch.Tensor, arr: np.ndarray, dt) -> None:
    """Copy the first ``arr.size`` elements of device tensor *src* into
    host array *arr*."""
    n = arr.size
    _host_tensor(arr, dt_torch(dt)).copy_(src.reshape(-1)[:n])


def _h2d(arr: np.ndarray, dst: torch.Tensor, dt) -> None:
    """Copy host array *arr* into the first ``arr.size`` elements of
    device tensor *dst*."""
    n = arr.size
    dst.reshape(-1)[:n].copy_(_host_tensor(arr, dt_torch(dt)))


def _span(bi) -> int:
    if isinstance(bi, BufferInfoV):
        counts = [int(c) for c in bi.counts]
        if bi.displacements is not None:
            displs = [int(d) for d in bi.displacements]
            return max((d + c for d, c in zip(displs, counts)), default=0)
        return sum(counts)
    return int(bi.count)


def _blocks(bi) -> Optional[list]:
    """(offset, count) of every block of a BufferInfoV; None for a
    BufferInfo (one block of ``count``)."""
    if not isinstance(bi, BufferInfoV):
        return None
    counts = [int(c) for c in bi.counts]
    displs = [int(d) for d in bi.displacements] \
        if bi.displacements is not None else \
        [int(x) for x in np.cumsum([0] + counts[:-1])]
    return list(zip(displs, counts))


def _shadow(bi):
    """Host-scratch mirror of a (device-memory) buffer info."""
    if bi is None:
        return None
    arr = np.zeros(_span(bi), dtype=storage_dtype(bi.datatype))
    if isinstance(bi, BufferInfoV):
        return BufferInfoV(arr, list(bi.counts),
                           list(bi.displacements)
                           if bi.displacements is not None else None,
                           bi.datatype, mem_type=MemoryType.HOST)
    return BufferInfo(arr, int(bi.count), bi.datatype,
                      mem_type=MemoryType.HOST)


def _stage_down(bi, shadow) -> None:
    """A device buffer's span into its host shadow."""
    if bi is None or shadow is None or bi.buffer is None:
        return
    if isinstance(bi.buffer, torch.Tensor):
        _d2h(bi.buffer, shadow.buffer, bi.datatype)
    else:
        from ...tl.base import binfo_typed
        shadow.buffer[:] = binfo_typed(bi, shadow.buffer.size)


def _stage_up(shadow, bi) -> None:
    """A host shadow into its device buffer: a BufferInfoV's blocks only
    (the gaps between them stay as the caller left them), a BufferInfo's
    ``count`` elements."""
    arr = shadow.buffer
    blocks = _blocks(bi) or [(0, int(bi.count))]
    if isinstance(bi.buffer, torch.Tensor):
        flat = bi.buffer.reshape(-1)
        for off, c in blocks:
            if c:
                _h2d(arr[off:off + c], flat[off:off + c], bi.datatype)
    else:
        from ...tl.base import binfo_typed
        out = binfo_typed(bi, arr.size)
        for off, c in blocks:
            out[off:off + c] = arr[off:off + c]


def _chain(sched: Schedule, prev: Optional[CollTask], task: CollTask,
           stage: str) -> CollTask:
    """Add *task* to *sched* after *prev* (or at the schedule's start)."""
    task.obs_stage = stage
    sched.add_task(task)
    if prev is None:
        sched.add_dep_on_schedule_start(task)
    else:
        task.subscribe_dep(prev, EventType.EVENT_COMPLETED)
    return task


# ---------------------------------------------------------------------------
# generic staged wrapper
# ---------------------------------------------------------------------------

def staged_init(init_args, hier_team, host_init_fn) -> CollTask:
    """Device -> host scratch, the host hierarchy schedule, host scratch
    -> device (in place)."""
    args = init_args.args
    coll = args.coll_type
    if coll in (CollType.BARRIER, CollType.FANIN, CollType.FANOUT):
        return host_init_fn(init_args, hier_team)

    if coll == CollType.ALLREDUCE:
        # the RAB pipeline knob applies to the staged path too: fragment
        # k's host leg overlaps fragment k+1's copies
        pp3 = _rab_pipeline_params(hier_team, args)
        if pp3 is not None:
            n_frags, pdepth, order = pp3
            return _staged_allreduce_pipelined(
                init_args, hier_team, n_frags, pdepth, order)

    s_src = _shadow(args.src) if not args.is_inplace else None
    s_dst = _shadow(args.dst)
    shadow_args = dataclasses.replace(
        args, src=(s_dst if args.is_inplace else s_src), dst=s_dst)
    inner_ia = dataclasses.replace(init_args, args=shadow_args,
                                   mem_type=MemoryType.HOST)
    inner = host_init_fn(inner_ia, hier_team)
    me = hier_team.core_team.rank

    def stage_in():
        if args.is_inplace:
            _stage_down(args.dst, s_dst)
        else:
            _stage_down(args.src, s_src)

    def stage_out():
        # bcast delivers via src (dst is None by UCC convention); the
        # root's src already holds the data
        out_bi = args.dst if args.dst is not None else args.src
        out_sh = s_dst if args.dst is not None else s_src
        if out_bi is None or out_sh is None:
            return
        if coll in (CollType.REDUCE, CollType.GATHER, CollType.GATHERV) \
                and me != int(args.root):
            return
        if coll == CollType.BCAST and me == int(args.root):
            return
        _stage_up(out_sh, out_bi)

    sched = Schedule(team=hier_team, args=args)
    t_in = _chain(sched, None, _UnpackTask(stage_in), "staged.d2h")
    _chain(sched, t_in, inner, "staged.host")
    _chain(sched, inner, _UnpackTask(stage_out), "staged.h2d")
    return sched


def _leaders_allreduce_trio(sched, prev, unit, ar_dst, inner_op, stage_in,
                            finish, stage: str):
    """The device -> host, host in-place allreduce on *unit*, finish()
    trio of the on-device paths (the RAB leaders' stage, split_rail's
    rail stage, the pipelined RAB's fragments). ``ar_dst`` is the
    HOST-memory BufferInfo the allreduce runs in place on; ``stage_in()``
    fills it from the device, ``finish()`` lands the result on the
    device. Returns (t_ar, t_finish), so that a pipeline can retarget
    t_ar per fragment."""
    t_d2h = _chain(sched, prev, _UnpackTask(stage_in), f"{stage}.d2h")
    ar_args = CollArgs(coll_type=CollType.ALLREDUCE, op=inner_op,
                       dst=ar_dst, flags=CollArgsFlags.IN_PLACE)
    ar_args.src = ar_args.dst
    t_ar = unit.coll_init(ar_args, MemoryType.HOST,
                          int(ar_dst.count) * dt_size(ar_dst.datatype))
    _chain(sched, t_d2h, t_ar, f"{stage}.allreduce")
    t_fin = _chain(sched, t_ar, _UnpackTask(finish), f"{stage}.h2d")
    return t_ar, t_fin


# ---------------------------------------------------------------------------
# allreduce RAB with on-device node stages
# ---------------------------------------------------------------------------

def _node_has_torch_ops(hier_team) -> bool:
    node = hier_team.sbgp(SbgpType.NODE)
    return node is not None and any(
        getattr(t, "NAME", "") == "torch_ops" for t in node.tl_teams)


def _cuda(t: torch.Tensor, count: int, dt) -> BufferInfo:
    return BufferInfo(t, count, dt, mem_type=MemoryType.CUDA)


def allreduce_rab_tpu_init(init_args, hier_team) -> CollTask:
    """RAB over CUDA buffers: node reduce (device TLs) -> leader's copy
    to host -> leaders' host allreduce -> leader's copy to the device ->
    node bcast (device TLs) into every rank's dst. Falls back to the
    staged wrapper when the NODE unit has no torch_ops team.

    Honors ``UCC_CL_HIER_ALLREDUCE_RAB_PIPELINE``: above its threshold the
    vector goes through a PipelinedSchedule in fragments, so that fragment
    k's leaders' allreduce overlaps fragment k+1's node reduce and copy.
    """
    from .algs import allreduce_rab_init

    if not _node_has_torch_ops(hier_team):
        return staged_init(init_args, hier_team, allreduce_rab_init)
    pp3 = _rab_pipeline_params(hier_team, init_args.args)
    if pp3 is not None:
        n_frags, pdepth, order = pp3
        return _rab_tpu_pipelined(init_args, hier_team, n_frags, pdepth,
                                  order)
    return _rab_tpu_single(init_args, hier_team)


def _rab_tpu_single(init_args, hier_team) -> CollTask:
    args = init_args.args
    node = hier_team.sbgp(SbgpType.NODE)
    leaders = hier_team.sbgp(SbgpType.NODE_LEADERS)
    count = int(args.dst.count)
    dt = args.dst.datatype
    msg = count * dt_size(dt)
    op, inner_op = _op_pair(args)
    team_size = hier_team.core_team.size
    is_leader = node.sbgp.group_rank == 0
    dev = _rank_device(hier_team, args)
    sched = Schedule(team=hier_team, args=args)

    # stage 1: node reduce on the device into the leader's red_dst
    red_dst = _cuda(torch.empty(count, dtype=dt_torch(dt), device=dev),
                    count, dt) if is_leader else None
    red_args = CollArgs(coll_type=CollType.REDUCE, root=0,
                        src=args.dst if args.is_inplace else args.src,
                        dst=red_dst, op=inner_op)
    prev = _chain(sched, None,
                  node.coll_init(red_args, MemoryType.CUDA, msg),
                  "rab_tpu.node_reduce")

    # stages 2-4 (leader only): to host, leaders' allreduce, to device
    if is_leader and leaders is not None and leaders.sbgp.is_member:
        scratch = _scratch(count, dt, dev)
        ar_dst = BufferInfo(scratch, count, dt, mem_type=MemoryType.HOST)

        def h2d():
            if op == ReductionOp.AVG:
                scratch[:] = divide_array(scratch, team_size, dt)
            _h2d(scratch, red_dst.buffer, dt)

        _, prev = _leaders_allreduce_trio(
            sched, prev, leaders, ar_dst, inner_op,
            lambda: _d2h(red_dst.buffer, scratch, dt), h2d,
            "rab_tpu.leaders")
    elif is_leader and op == ReductionOp.AVG:
        # a node without peers to reduce with: the reduced vector is final
        scratch = _scratch(count, dt, dev)

        def scale():
            _d2h(red_dst.buffer, scratch, dt)
            scratch[:] = divide_array(scratch, team_size, dt)
            _h2d(scratch, red_dst.buffer, dt)

        prev = _chain(sched, prev, _UnpackTask(scale), "rab_tpu.scale")

    # stage 5: node bcast on the device from the leader's red_dst into
    # every rank's dst
    if is_leader:
        bc_args = CollArgs(coll_type=CollType.BCAST, root=0, src=red_dst,
                           dst=args.dst)
    else:
        bc_args = CollArgs(coll_type=CollType.BCAST, root=0, src=args.dst)
    _chain(sched, prev, node.coll_init(bc_args, MemoryType.CUDA, msg),
           "rab_tpu.node_bcast")
    return sched


# ---------------------------------------------------------------------------
# allreduce split_rail with on-device node stages
# ---------------------------------------------------------------------------

def allreduce_split_rail_tpu_init(init_args, hier_team) -> CollTask:
    """split_rail over CUDA buffers: node reduce_scatter (device TLs) ->
    my block to host -> per-rail NET allreduce of that block -> back to
    the device -> node allgather (device TLs) into every rank's dst. Every
    rank is its rail's member, so each copies count/ppn elements each way
    and every rail runs at once.

    Geometries with ``count % ppn != 0`` would need an allgatherv on the
    device; they take the host split_rail under the staged wrapper."""
    from .algs import split_rail_init

    args = init_args.args
    node = hier_team.sbgp(SbgpType.NODE)
    net = hier_team.sbgp(SbgpType.NET)
    if node is None or net is None:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       "split_rail requires NODE and NET units (equal ppn)")
    count = int(args.dst.count)
    ppn = node.sbgp.size
    if not _node_has_torch_ops(hier_team) or count < ppn or count % ppn:
        return staged_init(init_args, hier_team, split_rail_init)
    return _split_rail_tpu_single(init_args, hier_team)


def _split_rail_tpu_single(init_args, hier_team) -> CollTask:
    args = init_args.args
    node = hier_team.sbgp(SbgpType.NODE)
    net = hier_team.sbgp(SbgpType.NET)
    count = int(args.dst.count)
    dt = args.dst.datatype
    esz = dt_size(dt)
    blk = count // node.sbgp.size
    op, inner_op = _op_pair(args)
    team_size = hier_team.core_team.size
    dev = _rank_device(hier_team, args)
    sched = Schedule(team=hier_team, args=args)

    # stage 1: node reduce_scatter on the device: my reduced block
    blk_bi = _cuda(torch.empty(blk, dtype=dt_torch(dt), device=dev), blk, dt)
    rs_args = CollArgs(coll_type=CollType.REDUCE_SCATTER, op=inner_op,
                       src=args.dst if args.is_inplace else args.src,
                       dst=blk_bi)
    prev = _chain(sched, None,
                  node.coll_init(rs_args, MemoryType.CUDA, count * esz),
                  "split_rail_tpu.node_reduce_scatter")

    # stages 2-4: my block to host, the rail allreduce, back to the device
    scratch = _scratch(blk, dt, dev)

    def h2d():
        if op == ReductionOp.AVG:
            scratch[:] = divide_array(scratch, team_size, dt)
        _h2d(scratch, blk_bi.buffer, dt)

    stage_in = lambda: _d2h(blk_bi.buffer, scratch, dt)  # noqa: E731
    if net.sbgp.size > 1:
        ar_dst = BufferInfo(scratch, blk, dt, mem_type=MemoryType.HOST)
        _, prev = _leaders_allreduce_trio(
            sched, prev, net, ar_dst, inner_op, stage_in, h2d,
            "split_rail_tpu.rail")
    elif op == ReductionOp.AVG:
        # a rail of one: the reduced block is final
        def scale():
            stage_in()
            h2d()
        prev = _chain(sched, prev, _UnpackTask(scale), "split_rail_tpu.scale")

    # stage 5: node allgather on the device into every rank's dst
    ag_args = CollArgs(coll_type=CollType.ALLGATHER, src=blk_bi,
                       dst=args.dst)
    _chain(sched, prev, node.coll_init(ag_args, MemoryType.CUDA,
                                       count * esz),
           "split_rail_tpu.node_allgather")
    return sched


# ---------------------------------------------------------------------------
# pipelined RAB over CUDA buffers: the node reduce -> to host -> leaders'
# allreduce -> to device -> node bcast chain in fragments, each written
# into its slice of dst
# ---------------------------------------------------------------------------

def _rab_tpu_pipelined(init_args, hier_team, n_frags: int, pdepth: int,
                       order) -> CollTask:
    """Fragmented RAB over device buffers. Each window fragment runs the
    five-stage chain on its slice and its node bcast writes that slice of
    every rank's dst; with SEQUENTIAL/ORDERED cross-fragment deps,
    fragment k's leaders' allreduce overlaps fragment k+1's node reduce
    and copy. A fragment's task list has the same length and order in
    every fragment (the pipeline pairs cross-fragment deps by index); it
    differs between leader and member ranks, as the host RAB's does."""
    from ...schedule.pipelined import PipelinedSchedule

    args = init_args.args
    node = hier_team.sbgp(SbgpType.NODE)
    leaders = hier_team.sbgp(SbgpType.NODE_LEADERS)
    count = int(args.dst.count)
    dt = args.dst.datatype
    esz = dt_size(dt)
    op, inner_op = _op_pair(args)
    team_size = hier_team.core_team.size
    is_leader = node.sbgp.group_rank == 0
    dev = _rank_device(hier_team, args)
    # the leader's device result and host scratch, one slice a fragment
    red_full = torch.empty(count, dtype=dt_torch(dt), device=dev) \
        if is_leader else None
    scratch = _scratch(count, dt, dev) if is_leader else None

    def live(bi) -> torch.Tensor:
        # read at post/setup time: a persistent caller may rebind its
        # buffers between rounds
        return bi.buffer.reshape(-1)

    def src_bi():
        return args.dst if args.is_inplace else args.src

    def geometry(frag_num: int):
        return (block_offset(count, n_frags, frag_num),
                block_count(count, n_frags, frag_num))

    def frag_init(sched_p, idx):
        off, cnt = geometry(idx)
        frag = Schedule(team=hier_team)
        red_src = _cuda(live(src_bi())[off:off + cnt], cnt, dt)
        out = _cuda(live(args.dst)[off:off + cnt], cnt, dt)
        red_dst = _cuda(red_full[off:off + cnt], cnt, dt) \
            if is_leader else None
        st = {"red_src": red_src, "out": out, "red_dst": red_dst,
              "off": off, "cnt": cnt}
        frag._rab_tpu = st
        red_args = CollArgs(coll_type=CollType.REDUCE, root=0,
                            src=red_src, dst=red_dst, op=inner_op)
        st["t_red"] = prev = _chain(
            frag, None, node.coll_init(red_args, MemoryType.CUDA,
                                       cnt * esz), "rab_tpu.node_reduce")

        if is_leader and leaders is not None and leaders.sbgp.is_member:
            ar_dst = BufferInfo(scratch[off:off + cnt], cnt, dt,
                                mem_type=MemoryType.HOST)
            st["ar_dst"] = ar_dst

            def d2h(s=st):
                _d2h(s["red_dst"].buffer, s["ar_dst"].buffer, dt)

            def h2d(s=st):
                view = s["ar_dst"].buffer
                if op == ReductionOp.AVG:
                    view[:] = divide_array(view, team_size, dt)
                _h2d(view, s["red_dst"].buffer, dt)

            st["t_ar"], prev = _leaders_allreduce_trio(
                frag, prev, leaders, ar_dst, inner_op, d2h, h2d,
                "rab_tpu.leaders")
        elif is_leader and op == ReductionOp.AVG:
            def scale(s=st):
                view = scratch[s["off"]:s["off"] + s["cnt"]]
                _d2h(s["red_dst"].buffer, view, dt)
                view[:] = divide_array(view, team_size, dt)
                _h2d(view, s["red_dst"].buffer, dt)
            prev = _chain(frag, prev, _UnpackTask(scale), "rab_tpu.scale")

        if is_leader:
            bc_args = CollArgs(coll_type=CollType.BCAST, root=0,
                               src=red_dst, dst=out)
        else:
            bc_args = CollArgs(coll_type=CollType.BCAST, root=0, src=out)
        st["t_bc"] = _chain(frag, prev,
                            node.coll_init(bc_args, MemoryType.CUDA,
                                           cnt * esz), "rab_tpu.node_bcast")
        return frag

    def frag_setup(sched_p, frag, frag_num):
        st = frag._rab_tpu
        off, cnt = geometry(frag_num)
        st.update(off=off, cnt=cnt)
        for key, base in (("red_src", live(src_bi())),
                          ("out", live(args.dst)),
                          ("red_dst", red_full)):
            bi = st[key]
            if bi is not None:
                bi.buffer = base[off:off + cnt]
                bi.count = cnt
        _retarget_task_counts(st["t_red"], st["t_red"].args)
        _retarget_task_counts(st["t_bc"], st["t_bc"].args)
        if "ar_dst" in st:
            st["ar_dst"].buffer = scratch[off:off + cnt]
            st["ar_dst"].count = cnt
            _retarget_task_counts(st["t_ar"], st["t_ar"].args)
        return Status.OK

    return PipelinedSchedule(team=hier_team, args=args, frag_init=frag_init,
                             frag_setup=frag_setup, n_frags=pdepth,
                             n_frags_total=n_frags, order=order)


def _rab_pipeline_params(hier_team, args):
    """The RAB pipeline knob for the CUDA paths: (n_frags, pdepth, order)
    when pipelining applies, else None. Malformed values raise, as on the
    host RAB."""
    cfg = hier_team.comp_context.config
    if cfg is None:
        return None
    try:
        from ...schedule.pipelined import parse_pipeline_params
        pp = parse_pipeline_params(cfg.get("ALLREDUCE_RAB_PIPELINE"))
    except KeyError:
        return None
    cnt = int(args.dst.count)
    n_frags, pdepth = pp.nfrags_pdepth(cnt * dt_size(args.dst.datatype))
    if n_frags <= 1:
        return None
    return n_frags, pdepth, pp.order


def _staged_allreduce_pipelined(init_args, hier_team, n_frags: int,
                                pdepth: int, order) -> CollTask:
    """The staged allreduce in fragments: per fragment, its slice to host,
    the host RAB chain on the slice, the slice back into dst; fragment k's
    host leg overlaps fragment k+1's copies. The inner chain is built
    unfragmented per slice (``_rab_fill_frag``): the outer pipeline
    already fragments. pdepth bounds the window, as on the host RAB."""
    from ...schedule.pipelined import PipelinedSchedule
    from .algs import _rab_fill_frag, _rab_retarget_frag

    args = init_args.args
    count = int(args.dst.count)
    dt = args.dst.datatype
    op = args.op if args.op is not None else ReductionOp.SUM
    scratch = _scratch(count, dt, _rank_device(hier_team, args))

    def src_bi():
        return args.dst if args.is_inplace else args.src

    def geometry(frag_num: int):
        return (block_offset(count, n_frags, frag_num),
                block_count(count, n_frags, frag_num))

    def frag_init(sched_p, idx):
        off, cnt = geometry(idx)
        frag = Schedule(team=hier_team)
        st = {"off": off, "cnt": cnt}
        frag._staged = st

        def d2h(s=st):
            src = src_bi().buffer.reshape(-1)
            _d2h(src[s["off"]:s["off"] + s["cnt"]],
                 scratch[s["off"]:s["off"] + s["cnt"]], dt)

        t_in = _chain(frag, None, _UnpackTask(d2h), "staged.d2h")
        sh = BufferInfo(scratch[off:off + cnt], cnt, dt,
                        mem_type=MemoryType.HOST)
        fa = CollArgs(coll_type=CollType.ALLREDUCE, dst=sh, op=op,
                      flags=CollArgsFlags.IN_PLACE)
        fa.src = fa.dst
        st["fa"] = fa
        # the rab chain goes straight into the fragment schedule (the
        # pipeline resets one level of tasks on window reuse); its first
        # task also waits for the copy in
        pre = len(frag.tasks)
        _rab_fill_frag(hier_team, frag, fa, dt, 0, cnt)
        frag.tasks[pre].subscribe_dep(t_in, EventType.EVENT_COMPLETED)
        last_rab = frag.tasks[-1]

        def h2d(s=st):
            dst = args.dst.buffer.reshape(-1)
            _h2d(scratch[s["off"]:s["off"] + s["cnt"]],
                 dst[s["off"]:s["off"] + s["cnt"]], dt)

        _chain(frag, last_rab, _UnpackTask(h2d), "staged.h2d")
        return frag

    def frag_setup(sched_p, frag, frag_num):
        st = frag._staged
        off, cnt = geometry(frag_num)
        st.update(off=off, cnt=cnt)
        fa = st["fa"]
        fa.dst.buffer = scratch[off:off + cnt]
        fa.dst.count = cnt
        _rab_retarget_frag(hier_team, frag, fa, dt)
        return Status.OK

    return PipelinedSchedule(team=hier_team, args=args, frag_init=frag_init,
                             frag_setup=frag_setup, n_frags=pdepth,
                             n_frags_total=n_frags, order=order)
