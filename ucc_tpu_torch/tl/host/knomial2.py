"""Second wave of knomial-family algorithms.

  - BcastSagKnomial: scatter-allgather bcast (bcast/bcast_sag_knomial.c
    semantics): root scatters blocks down a binomial tree, then a ring
    allgather rebuilds the full buffer everywhere. O(2·count·(n-1)/n)
    bytes per link — the bandwidth bcast for large messages.
  - ReduceScatterKnomial: recursive vector halving
    (reduce_scatter_knomial.c). Supported when the team size is a power of
    two and the count divides evenly (the halving segments then coincide
    with the standard block split); anything else raises NOT_SUPPORTED and
    the score-map fallback picks the ring (ucc_coll_score_map.c:136).
  - GatherKnomial / ScatterKnomial: binomial trees moving contiguous
    vrank-ranges of blocks (gather/gather_knomial.c, scatter semantics) —
    O(log N) steps vs linear's O(N) at the root.
"""
from __future__ import annotations

from typing import List

from ...constants import ReductionOp
from ...ec.cpu import reduce_arrays, storage_dtype
from ...status import Status, UccError
from ...utils.mathutils import block_count, block_offset, is_pow2
from ..base import binfo_typed
from .task import HostCollTask


class BcastSagKnomial(HostCollTask):
    def __init__(self, init_args, team, subset=None):
        super().__init__(init_args, team, subset)
        # geometry checks happen at INIT so the score-map fallback chain
        # can pick another algorithm (ucc_coll_score_map.c:136)
        if int(init_args.args.src.count) < self.gsize and self.gsize > 1:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "sag bcast needs count >= team size")

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        count = int(args.src.count)
        root = int(args.root)
        buf = binfo_typed(args.src, count)
        if size == 1:
            return
        v = (me - root) % size

        def blk(i):   # vrank-indexed near-equal blocks of the user buffer
            off = block_offset(count, size, i)
            return buf[off:off + block_count(count, size, i)]

        # phase 1: binomial scatter over vranks. Node v owns range
        # [v, reach); at each step the top half splits off to a child.
        reach = size if v == 0 else 0
        if v != 0:
            span = _binomial_span(v, size)
            reach = v + span
            parent = _binomial_parent(v)
            # receive my whole range from parent in one message
            nbytes_range = sum(block_count(count, size, i)
                               for i in range(v, reach))
            rng = self.scratch("rng", nbytes_range, buf.dtype)
            yield from self.wait(self.recv_nb((parent + root) % size, rng,
                                              slot=160))
            off = 0
            for i in range(v, reach):
                c = block_count(count, size, i)
                blk(i)[:] = rng[off:off + c]
                off += c
        # forward: split my range down: children are v + span/2 style —
        # iterate descending powers covering (v, reach)
        span = reach - v
        step = 1
        while step < span:
            step *= 2
        step //= 2
        while step >= 1:
            child = v + step
            if child < reach:
                crange = (child, min(child + step, reach))
                parts = [blk(i) for i in range(*crange)]
                payload = self.pack("fwd", parts, buf.dtype) \
                    if len(parts) > 1 else parts[0]
                yield from self.wait(self.send_nb((child + root) % size,
                                                  payload, slot=160))
                reach = child
            step //= 2
        # phase 2: ring allgather of the (vrank-indexed) blocks
        right = (me + 1) % size
        left = (me - 1) % size
        for s in range(size - 1):
            sb = (v - s) % size
            rb = (v - s - 1) % size
            yield from self.sendrecv(right, blk(sb), left, blk(rb),
                                     slot=161 + s)


class ReduceScatterKnomial(HostCollTask):
    def __init__(self, init_args, team, subset=None):
        super().__init__(init_args, team, subset)
        args = init_args.args
        total = int(args.src.count) if not args.is_inplace else \
            int(args.dst.count)
        if not is_pow2(self.gsize) or total % max(1, self.gsize) != 0:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "rs knomial needs pow2 team and divisible count")
        self.total = total

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        op = args.op if args.op is not None else ReductionOp.SUM
        red_op = ReductionOp.SUM if op == ReductionOp.AVG else op
        dt = (args.src or args.dst).datatype
        nd = storage_dtype(dt)
        total = self.total
        work = self.scratch("work", total, nd)
        if args.is_inplace:
            work[:] = binfo_typed(args.dst, total)
            out = binfo_typed(args.dst, total)[me * (total // size):
                                               (me + 1) * (total // size)]
        else:
            work[:] = binfo_typed(args.src, total)
            out = binfo_typed(args.dst, total // size)
        if size == 1:
            res = work
            if op == ReductionOp.AVG:
                res = reduce_arrays([work], ReductionOp.SUM, dt, alpha=1.0)
            out[:] = res[:out.size]
            return
        lo, hi = 0, total
        dist = size // 2
        scratch = self.scratch("halving", total // 2, nd)
        rnd = 0
        while dist >= 1:
            partner = me ^ dist
            mid = lo + (hi - lo) // 2
            keep, give = ((lo, mid), (mid, hi)) if me & dist == 0 else \
                ((mid, hi), (lo, mid))
            rview = scratch[:keep[1] - keep[0]]
            yield from self.sendrecv(partner, work[give[0]:give[1]],
                                     partner, rview, slot=170 + rnd)
            seg = work[keep[0]:keep[1]]
            reduce_arrays([seg, rview], red_op, dt, out=seg)
            lo, hi = keep
            dist //= 2
            rnd += 1
        # pow2 + divisible: the final segment IS block `me`
        res = work[lo:hi]
        if op == ReductionOp.AVG:
            res = reduce_arrays([res], ReductionOp.SUM, dt, alpha=1.0 / size)
        out[:] = res


def _binomial_span(v: int, size: int) -> int:
    """Subtree span of vrank v in the binomial tree rooted at 0."""
    if v == 0:
        return size
    span = 1
    while v % (span * 2) == 0 and v + span < size:
        span *= 2
    return min(span, size - v)


def _binomial_parent(v: int) -> int:
    """Parent of v: clear the lowest set bit."""
    return v & (v - 1)


class GatherKnomial(HostCollTask):
    """Binomial gather: vrank v accumulates blocks [v, v+span) and sends
    the contiguous aggregate up; root unpacks into rank positions."""

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        root = int(args.root)
        per = int(args.src.count) if args.src is not None else \
            int(args.dst.count) // size
        nd = storage_dtype((args.src or args.dst).datatype)
        v = (me - root) % size
        span = _binomial_span(v, size)
        agg = self.scratch("agg", span * per, nd)
        if args.src is not None and args.src.buffer is not None:
            agg[:per] = binfo_typed(args.src, per)
        elif v == 0 and args.is_inplace:
            agg[:per] = binfo_typed(args.dst)[me * per:(me + 1) * per]
        # collect children: v+1, v+2, v+4 ... within span
        step = 1
        reqs = []
        while step < span:
            child = v + step
            cspan = min(_binomial_span(child, size), span - step)
            reqs.append(self.recv_nb((child + root) % size,
                                     agg[step * per:(step + cspan) * per],
                                     slot=180))
            step *= 2
        yield from self.wait(*reqs)
        if v == 0:
            dst = binfo_typed(args.dst, per * size)
            for i in range(size):
                r = (i + root) % size
                dst[r * per:(r + 1) * per] = agg[i * per:(i + 1) * per]
        else:
            parent = _binomial_parent(v)
            yield from self.wait(self.send_nb((parent + root) % size, agg,
                                              slot=180))


class ScatterKnomial(HostCollTask):
    """Binomial scatter: reverse of GatherKnomial."""

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        root = int(args.root)
        per = int(args.dst.count) if args.dst is not None and \
            args.dst.buffer is not None else int(args.src.count) // size
        nd = storage_dtype((args.src or args.dst).datatype)
        v = (me - root) % size
        span = _binomial_span(v, size)
        agg = self.scratch("agg", span * per, nd)
        if v == 0:
            src = binfo_typed(args.src, per * size)
            for i in range(size):
                r = (i + root) % size
                agg[i * per:(i + 1) * per] = src[r * per:(r + 1) * per]
        else:
            parent = _binomial_parent(v)
            yield from self.wait(self.recv_nb((parent + root) % size, agg,
                                              slot=181))
        # forward subtree ranges: largest child first
        step = 1
        while step * 2 < span:
            step *= 2
        while step >= 1:
            child = v + step
            if child < v + span:
                cspan = min(_binomial_span(child, size), span - step)
                yield from self.wait(self.send_nb(
                    (child + root) % size,
                    agg[step * per:(step + cspan) * per], slot=181))
            step //= 2
        if args.dst is not None and args.dst.buffer is not None:
            if not (v == 0 and args.is_inplace):
                binfo_typed(args.dst, per)[:] = agg[:per]