"""Ring algorithms — bandwidth-optimal host collectives.

Ports the semantics of the reference's ring family
(UCC's src/components/tl/ucp/allgather/allgather_ring.c,
reduce_scatter/reduce_scatter_ring.c, allgatherv/allgatherv_ring.c,
reduce_scatterv/reduce_scatterv_ring.c and the generic ring helper
coll_patterns/ring.h:14-21). Ring allreduce = reduce-scatter ring +
allgather ring (the tl_ucp allreduce ring schedule, allreduce_ring).

Block layout uses the standard near-equal split (ucc_buffer_block_count/
offset, ucc_coll_utils.h:301,387) so any count works with any team size.

Buffer conventions (matching UCC coll args):
  - allgather: src.count = per-rank, dst.count = total
  - reduce_scatter: src.count = total, dst.count = per-rank block
    (in-place: dst holds the full vector; result lands in rank's block)
  - allreduce: src/dst.count = total
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ...api.types import BufferInfoV
from ...constants import ReductionOp
from ...ec.cpu import reduce_arrays, storage_dtype
from ...utils.mathutils import block_count, block_offset
from ..base import binfo_typed, binfo_v_block
from .task import HostCollTask


class _TopoOrderedRingTask(HostCollTask):
    """Ring base that remaps ranks through FULL_HOST_ORDERED on
    multi-node teams (block ownership follows GROUP rank, which the
    buffer conventions of allreduce rings tolerate because every rank
    ends with the full vector; plain allgather/reduce_scatter keep team
    ranks since their output placement is rank-addressed)."""

    def __init__(self, init_args, team, subset=None):
        if subset is None and hasattr(team, "topo_ordered_subset"):
            subset = team.topo_ordered_subset()
        super().__init__(init_args, team, subset)


class AllgatherRing(HostCollTask):
    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        total = int(args.dst.count)
        dst = binfo_typed(args.dst, total)
        if not args.is_inplace:
            blk = _blk_view(dst, total, size, me)
            blk[:] = binfo_typed(args.src, blk.size)
        if size == 1:
            return
        right = (me + 1) % size
        left = (me - 1) % size
        for step in range(size - 1):
            sb = (me - step) % size
            rb = (me - step - 1) % size
            yield from self.sendrecv(right, _blk_view(dst, total, size, sb),
                                     left, _blk_view(dst, total, size, rb),
                                     slot=60 + step)


class AllgathervRing(HostCollTask):
    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        dstv: BufferInfoV = args.dst
        if not args.is_inplace:
            own = binfo_v_block(dstv, me)
            own[:] = binfo_typed(args.src, own.size)
        if size == 1:
            return
        right = (me + 1) % size
        left = (me - 1) % size
        for step in range(size - 1):
            sb = (me - step) % size
            rb = (me - step - 1) % size
            yield from self.sendrecv(right, binfo_v_block(dstv, sb),
                                     left, binfo_v_block(dstv, rb),
                                     slot=62 + step)


class ReduceScatterRing(HostCollTask):
    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        op = args.op if args.op is not None else ReductionOp.SUM
        red_op = ReductionOp.SUM if op == ReductionOp.AVG else op
        dt = (args.src or args.dst).datatype
        nd = storage_dtype(dt)
        if args.is_inplace:
            total = int(args.dst.count)
            work = self.scratch("work", total, nd)
            work[:] = binfo_typed(args.dst, total)
            out_block = _blk_view(binfo_typed(args.dst, total), total, size, me)
        else:
            total = int(args.src.count)
            work = self.scratch("work", total, nd)
            work[:] = binfo_typed(args.src, total)
            out_block = binfo_typed(args.dst, block_count(total, size, me))
        if size == 1:
            res = work
            if op == ReductionOp.AVG:
                res = reduce_arrays([work], ReductionOp.SUM, dt, alpha=1.0)
            out_block[:] = res[:out_block.size]
            return
        right = (me + 1) % size
        left = (me - 1) % size
        max_blk = max(block_count(total, size, b) for b in range(size))
        recv_buf = self.scratch("recv", max_blk, nd)
        for step in range(size - 1):
            sb = (me - 1 - step) % size
            rb = (me - 2 - step) % size
            sview = _blk_view(work, total, size, sb)
            rview = recv_buf[:block_count(total, size, rb)]
            yield from self.sendrecv(right, sview, left, rview,
                                     slot=64 + step)
            acc = _blk_view(work, total, size, rb)
            reduce_arrays([acc, rview], red_op, dt, out=acc)
        mine = _blk_view(work, total, size, me)
        if op == ReductionOp.AVG:
            mine = reduce_arrays([mine], ReductionOp.SUM, dt, alpha=1.0 / size)
        out_block[:] = mine


class ReduceScattervRing(HostCollTask):
    """reduce_scatterv ring (reduce_scatterv_ring.c): per-rank counts."""

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        op = args.op if args.op is not None else ReductionOp.SUM
        red_op = ReductionOp.SUM if op == ReductionOp.AVG else op
        dstv = args.dst
        counts = [int(c) for c in dstv.counts]
        # displacements describe each block's position within the source
        # vector; default to packed cumsum
        if dstv.displacements is not None:
            displs = [int(d) for d in dstv.displacements]
        else:
            displs = list(np.cumsum([0] + counts[:-1]))
        total = max(d + c for d, c in zip(displs, counts)) if counts else 0
        dt = (args.src or dstv).datatype
        nd = storage_dtype(dt)
        work = self.scratch("work", max(1, total), nd)[:total]
        if args.is_inplace:
            work[:] = binfo_typed(dstv, total)
            out_block = binfo_typed(dstv, counts[me], displs[me])
        else:
            work[:] = binfo_typed(args.src, total)
            # non-inplace: dst holds only my block
            out_block = binfo_typed(dstv, counts[me], 0)

        def blk(arr, b):
            return arr[displs[b]:displs[b] + counts[b]]

        if size == 1:
            res = work
            if op == ReductionOp.AVG:
                res = reduce_arrays([work], ReductionOp.SUM, dt, alpha=1.0)
            out_block[:] = res[:out_block.size]
            return
        right = (me + 1) % size
        left = (me - 1) % size
        recv_buf = self.scratch("recv", max(counts) if counts else 1, nd)
        for step in range(size - 1):
            sb = (me - 1 - step) % size
            rb = (me - 2 - step) % size
            rview = recv_buf[:counts[rb]]
            yield from self.sendrecv(right, blk(work, sb), left, rview,
                                     slot=66 + step)
            acc = blk(work, rb)
            reduce_arrays([acc, rview], red_op, dt, out=acc)
        mine = blk(work, me)
        if op == ReductionOp.AVG:
            mine = reduce_arrays([mine], ReductionOp.SUM, dt, alpha=1.0 / size)
        out_block[:] = mine


def allreduce_ring_init(init_args, team):
    """Ring allreduce — as a native execution plan when UCC_GEN_NATIVE
    resolves on: the inner loop below is exactly the verified
    ``gen_ring(chunks=1)`` program, so it lowers to a packed op table
    retired inside the native core (one ffi crossing per collective,
    C-side reductions). Falls back to the classic generator whenever the
    plan path does not resolve (knob off, native core absent, Python-
    matched peers, unsupported dtype/op, tiny counts); under
    UCC_GEN_NATIVE=y a plan that cannot be built raises ERR_NO_RESOURCE
    instead (dsl/plan.py)."""
    subset = team.topo_ordered_subset() \
        if hasattr(team, "topo_ordered_subset") else None
    from ...dsl.plan import handwritten_plan_task, native_mode
    try:
        task = handwritten_plan_task(init_args, team, "ring",
                                     subset=subset)
    except Exception:  # noqa: BLE001 - under auto the plan bridge must
        # never cost the classic path its correctness
        if native_mode(team) == "y":
            raise
        task = None
    return task if task is not None else AllreduceRing(init_args, team)


class AllreduceRing(_TopoOrderedRingTask):
    """Bandwidth allreduce: reduce-scatter ring then allgather ring inline
    (the reference builds this as a schedule; one generator is equivalent
    and cheaper host-side). Runs host-ordered on multi-node teams."""

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        op = args.op if args.op is not None else ReductionOp.SUM
        red_op = ReductionOp.SUM if op == ReductionOp.AVG else op
        total = int(args.dst.count)
        dst = binfo_typed(args.dst, total)
        if not args.is_inplace:
            dst[:] = binfo_typed(args.src, total)
        dt = args.dst.datatype
        nd = storage_dtype(dt)
        if size == 1:
            if op == ReductionOp.AVG:
                dst[:] = reduce_arrays([dst], ReductionOp.SUM, dt, alpha=1.0)
            return
        right = (me + 1) % size
        left = (me - 1) % size
        max_blk = max(block_count(total, size, b) for b in range(size))
        recv_buf = self.scratch("recv", max_blk, nd)
        # phase 1: reduce-scatter
        for step in range(size - 1):
            sb = (me - 1 - step) % size
            rb = (me - 2 - step) % size
            rview = recv_buf[:block_count(total, size, rb)]
            yield from self.sendrecv(right, _blk_view(dst, total, size, sb),
                                     left, rview, slot=70 + step)
            acc = _blk_view(dst, total, size, rb)
            reduce_arrays([acc, rview], red_op, dt, out=acc)
        if op == ReductionOp.AVG:
            mine = _blk_view(dst, total, size, me)
            mine[:] = reduce_arrays([mine], ReductionOp.SUM, dt,
                                    alpha=1.0 / size)
        # phase 2: allgather of reduced blocks
        for step in range(size - 1):
            sb = (me - step) % size
            rb = (me - step - 1) % size
            yield from self.sendrecv(right, _blk_view(dst, total, size, sb),
                                     left, _blk_view(dst, total, size, rb),
                                     slot=70 + size + step)


def _blk_view(arr: np.ndarray, total: int, size: int, block: int) -> np.ndarray:
    off = block_offset(total, size, block)
    cnt = block_count(total, size, block)
    return arr[off:off + cnt]


class ReduceScatterRingBidirectional(HostCollTask):
    """Bidirectional reduce_scatter ring (the tl_ucp.h:82 bidirectional
    ring): each rank-block is split in two sub-vectors; the first halves
    reduce around a CLOCKWISE ring while the second halves reduce
    COUNTER-CLOCKWISE, both directions of every full-duplex link busy each
    step — halving the number of serial steps vs the one-way ring."""

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        op = args.op if args.op is not None else ReductionOp.SUM
        red_op = ReductionOp.SUM if op == ReductionOp.AVG else op
        dt = (args.src or args.dst).datatype
        nd = storage_dtype(dt)
        if args.is_inplace:
            total = int(args.dst.count)
            work = self.scratch("work", total, nd)
            work[:] = binfo_typed(args.dst, total)
            out_block = _blk_view(binfo_typed(args.dst, total), total, size,
                                  me)
        else:
            total = int(args.src.count)
            work = self.scratch("work", total, nd)
            work[:] = binfo_typed(args.src, total)
            out_block = binfo_typed(args.dst, block_count(total, size, me))
        if size == 1:
            res = work
            if op == ReductionOp.AVG:
                res = reduce_arrays([work], ReductionOp.SUM, dt, alpha=1.0)
            out_block[:] = res[:out_block.size]
            return

        # sub-block b of rank-block r: A = first half (cw ring),
        # B = second half (ccw ring); A_r + B_r tile total-block r exactly
        def sub(block, half):
            v = _blk_view(work, total, size, block)
            mid = v.size // 2
            return v[:mid] if half == 0 else v[mid:]

        right = (me + 1) % size
        left = (me - 1) % size
        max_half = max(block_count(total, size, b) for b in range(size))
        buf_a = self.scratch("buf_a", max_half, nd)
        buf_b = self.scratch("buf_b", max_half, nd)
        for step in range(size - 1):
            # cw: block indices walk down (classic ring)
            sa = (me - 1 - step) % size
            ra = (me - 2 - step) % size
            # ccw: mirror image — indices walk up
            sb = (me + 1 + step) % size
            rb = (me + 2 + step) % size
            va = buf_a[:sub(ra, 0).size]
            vb = buf_b[:sub(rb, 1).size]
            reqs = [
                self.send_nb(right, sub(sa, 0), slot=200 + step),
                self.recv_nb(left, va, slot=200 + step),
                self.send_nb(left, sub(sb, 1), slot=230 + step),
                self.recv_nb(right, vb, slot=230 + step),
            ]
            yield from self.wait(*reqs)
            acc_a = sub(ra, 0)
            reduce_arrays([acc_a, va], red_op, dt, out=acc_a)
            acc_b = sub(rb, 1)
            reduce_arrays([acc_b, vb], red_op, dt, out=acc_b)
        mine = _blk_view(work, total, size, me)
        if op == ReductionOp.AVG:
            mine = reduce_arrays([mine], ReductionOp.SUM, dt,
                                 alpha=1.0 / size)
        out_block[:] = mine
