"""Recursive k-nomial algorithms for host transports.

Ports the *semantics* of the reference's knomial pattern family
(UCC's src/components/tl/ucp/coll_patterns/recursive_knomial.h:30-58
and its users allreduce_knomial.c, bcast/bcast_knomial.c, reduce_knomial.c,
barrier.c, fanin/fanout) into generator tasks:

  - allreduce: extra/proxy fold for non-power-of-radix sizes, then radix-r
    group exchange rounds (latency-optimal for small messages)
  - bcast / reduce / fanin / fanout: k-ary tree walk (any team size)
  - barrier: radix-r dissemination (Bruck) — no root, O(log_r N) rounds
  - gather(v) / scatter(v): linear root algorithms (tl_ucp gatherv/scatterv
    are linear too, gatherv.c/scatterv.c)

The executor-buffer cap bounds the radix: at most EXECUTOR_NUM_BUFS-1 peer
buffers join one reduce (allreduce_knomial.c:208-209).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ...api.types import BufferInfoV
from ...constants import ReductionOp, dt_size
from ...ec.base import EXECUTOR_NUM_BUFS
from ...ec.cpu import reduce_arrays, storage_dtype
from ...status import Status, UccError
from ..base import binfo_typed, binfo_v_block
from .task import HostCollTask

_TOKEN = np.zeros(1, dtype=np.uint8)


def knomial_height(size: int, radix: int) -> int:
    """ceil(log_radix(size)) — number of tree levels."""
    k = 0
    cap = 1
    while cap < size:
        cap *= radix
        k += 1
    return k


def largest_pow(size: int, radix: int) -> int:
    full = 1
    while full * radix <= size:
        full *= radix
    return full


def clamp_radix(radix: int, size: int) -> int:
    return max(2, min(radix, size, EXECUTOR_NUM_BUFS - 1))


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------

class AllreduceKnomial(HostCollTask):
    """Latency-optimal allreduce (allreduce_knomial.c:221 init, :21
    progress). Phases EXTRA -> LOOP -> PROXY."""

    def __init__(self, init_args, team, subset=None, radix: Optional[int] = None):
        super().__init__(init_args, team, subset)
        args = init_args.args
        self.count = int(args.dst.count)
        self.dt = args.dst.datatype
        self.op = args.op if args.op is not None else ReductionOp.SUM
        self.radix = clamp_radix(
            radix or team.cfg_radix("allreduce_kn_radix", init_args.msgsize),
            self.gsize)

    def run(self):
        args = self.args
        nd = storage_dtype(self.dt)
        dst = binfo_typed(args.dst, self.count)
        if not args.is_inplace:
            src = binfo_typed(args.src, self.count)
            dst[:] = src
        r = self.radix
        size, me = self.gsize, self.grank
        if size == 1:
            if self.op == ReductionOp.AVG:
                dst[:] = reduce_arrays([dst], ReductionOp.AVG, self.dt,
                                       alpha=1.0)
            return
        full = largest_pow(size, r)

        # EXTRA: ranks >= full fold into proxy (me % full). With radix > 2,
        # n_extra can exceed full (e.g. size 11 radix 4 -> full 4, extras 7),
        # so a proxy may serve several extras — the reference distributes
        # extras across full subtrees the same way
        # (coll_patterns/recursive_knomial.h:98-105,172-179).
        if me >= full:
            proxy = me % full
            gen = me // full   # disambiguates multiple extras per proxy
            yield from self.wait(self.send_nb(proxy, dst, slot=1000 + gen))
            rreq = self.recv_nb(proxy, dst, slot=2000 + gen)
            yield from self.wait(rreq)
            return
        my_extras = list(range(me + full, size, full))
        if my_extras:
            extra_buf = self.scratch("extra", (len(my_extras), self.count),
                                     nd)
            reqs = [self.recv_nb(x, extra_buf[i], slot=1000 + x // full)
                    for i, x in enumerate(my_extras)]
            yield from self.wait(*reqs)
            reduce_arrays([dst] + [extra_buf[i] for i in
                                   range(len(my_extras))],
                          self.op_no_avg(), self.dt, out=dst)

        # LOOP: radix-r exchange over the full-tree ranks
        n_rounds = int(round(math.log(full, r)))
        scratch = self.scratch("loop", (r - 1, self.count), nd)
        dist = 1
        for rnd in range(n_rounds):
            span = dist * r
            base = me - (me % span)
            offset = (me - base) % dist
            pos = (me - base) // dist
            peers = [base + offset + j * dist for j in range(r) if j != pos]
            reqs = []
            for i, p in enumerate(peers):
                reqs.append(self.recv_nb(p, scratch[i], slot=2 + rnd))
                reqs.append(self.send_nb(p, dst, slot=2 + rnd))
            yield from self.wait(*reqs)
            reduce_arrays([dst] + [scratch[i] for i in range(r - 1)],
                          self.op_no_avg(), self.dt, out=dst)
            dist *= r

        if self.op == ReductionOp.AVG:
            dst[:] = reduce_arrays([dst], ReductionOp.SUM, self.dt,
                                   alpha=1.0 / size)

        # PROXY: results back to extras
        if my_extras:
            yield from self.wait(*[self.send_nb(x, dst, slot=2000 + x // full)
                                   for x in my_extras])

    def op_no_avg(self) -> ReductionOp:
        return ReductionOp.SUM if self.op == ReductionOp.AVG else self.op


# ---------------------------------------------------------------------------
# bcast / reduce trees
# ---------------------------------------------------------------------------

def _tree_level(v: int, radix: int) -> int:
    """Largest f with v % radix**f == 0 (v != 0)."""
    f = 0
    while v % (radix ** (f + 1)) == 0:
        f += 1
    return f


class BcastKnomial(HostCollTask):
    """K-ary tree bcast (bcast/bcast_knomial.c)."""

    def __init__(self, init_args, team, subset=None, radix=None):
        super().__init__(init_args, team, subset)
        args = init_args.args
        self.count = int(args.src.count)
        self.dt = args.src.datatype
        self.root = int(args.root)
        self.radix = max(2, min(
            radix or team.cfg_radix("bcast_kn_radix", init_args.msgsize),
            self.gsize))

    def run(self):
        buf = binfo_typed(self.args.src, self.count)
        yield from knomial_bcast_steps(self, buf, self.root, self.radix)


def knomial_bcast_steps(task: HostCollTask, buf: np.ndarray, root: int,
                        radix: int, slot_base: int = 10):
    size, me = task.gsize, task.grank
    if size == 1:
        return
    v = (me - root) % size
    k = knomial_height(size, radix)
    f = _tree_level(v, radix) if v != 0 else k
    for i in range(k - 1, -1, -1):
        dist = radix ** i
        if v != 0 and i == f:
            j = (v // dist) % radix
            parent = v - j * dist
            rreq = task.recv_nb((parent + root) % size, buf, slot=slot_base + i)
            yield from task.wait(rreq)
        elif i < f:
            reqs = []
            for j in range(1, radix):
                child = v + j * dist
                if child < size:
                    reqs.append(task.send_nb((child + root) % size, buf,
                                             slot=slot_base + i))
            if reqs:
                yield from task.wait(*reqs)


class ReduceKnomial(HostCollTask):
    """K-ary tree reduce (reduce/reduce_knomial.c). Root lands result in
    dst; non-roots reduce into scratch."""

    def __init__(self, init_args, team, subset=None, radix=None):
        super().__init__(init_args, team, subset)
        args = init_args.args
        bi = args.src if args.src is not None else args.dst
        self.count = int(bi.count)
        self.dt = bi.datatype
        self.op = args.op if args.op is not None else ReductionOp.SUM
        self.root = int(args.root)
        self.radix = max(2, min(
            radix or team.cfg_radix("reduce_kn_radix", init_args.msgsize),
            self.gsize, EXECUTOR_NUM_BUFS - 1))

    def run(self):
        args = self.args
        nd = storage_dtype(self.dt)
        size, me = self.gsize, self.grank
        is_root = me == self.root
        if is_root:
            acc = binfo_typed(args.dst, self.count)
            if not args.is_inplace:
                acc[:] = binfo_typed(args.src, self.count)
        else:
            acc = self.scratch("acc", self.count, nd)
            acc[:] = binfo_typed(args.src, self.count)
        if size == 1:
            if self.op == ReductionOp.AVG:
                acc[:] = reduce_arrays([acc], ReductionOp.SUM, self.dt,
                                       alpha=1.0)
            return
        op = ReductionOp.SUM if self.op == ReductionOp.AVG else self.op
        v = (me - self.root) % size
        k = knomial_height(size, self.radix)
        r = self.radix
        recv_buf = self.scratch("recv", (r - 1, self.count), nd)
        for i in range(k):
            dist = r ** i
            if v % (dist * r) == 0:
                # post all child receives of this level concurrently
                # (per-peer scratch rows, like AllreduceKnomial's LOOP)
                children = [v + j * dist for j in range(1, r)
                            if v + j * dist < size]
                if children:
                    reqs = [self.recv_nb((c + self.root) % size, recv_buf[n],
                                         slot=20 + i)
                            for n, c in enumerate(children)]
                    yield from self.wait(*reqs)
                    reduce_arrays(
                        [acc] + [recv_buf[n] for n in range(len(children))],
                        op, self.dt, out=acc)
            elif v % dist == 0:
                parent = v - ((v // dist) % r) * dist
                yield from self.wait(
                    self.send_nb((parent + self.root) % size, acc, slot=20 + i))
                return
        if is_root and self.op == ReductionOp.AVG:
            acc[:] = reduce_arrays([acc], ReductionOp.SUM, self.dt,
                                   alpha=1.0 / size)


# ---------------------------------------------------------------------------
# barrier / fanin / fanout
# ---------------------------------------------------------------------------

class BarrierKnomial(HostCollTask):
    """Radix-r dissemination barrier (tl_ucp barrier.c knomial flavor)."""

    def __init__(self, init_args, team, subset=None, radix=None):
        super().__init__(init_args, team, subset)
        self.radix = max(2, min(radix or team.cfg_radix("barrier_kn_radix", 0),
                                self.gsize))

    def run(self):
        size, me, r = self.gsize, self.grank, self.radix
        if size == 1:
            return
        tok = _TOKEN
        sink = self.scratch("sink", 1, np.uint8)
        dist = 1
        rnd = 0
        while dist < size:
            reqs = []
            for j in range(1, r):
                if j * dist >= size:
                    break
                to = (me + j * dist) % size
                frm = (me - j * dist) % size
                reqs.append(self.send_nb(to, tok, slot=30 + rnd * r + j))
                reqs.append(self.recv_nb(frm, sink, slot=30 + rnd * r + j))
            yield from self.wait(*reqs)
            dist *= r
            rnd += 1


class FaninKnomial(ReduceKnomial):
    """Sync-to-root without data (fanin.c): reduce tree on tokens."""

    def __init__(self, init_args, team, subset=None, radix=None):
        HostCollTask.__init__(self, init_args, team, subset)
        self.root = int(init_args.args.root) if init_args.args else 0
        self.radix = max(2, min(radix or 4, self.gsize))

    def run(self):
        size, me, r = self.gsize, self.grank, self.radix
        if size == 1:
            return
        v = (me - self.root) % size
        k = knomial_height(size, r)
        sink = self.scratch("sink", 1, np.uint8)
        for i in range(k):
            dist = r ** i
            if v % (dist * r) == 0:
                for j in range(1, r):
                    child = v + j * dist
                    if child < size:
                        yield from self.wait(
                            self.recv_nb((child + self.root) % size, sink,
                                         slot=40 + i))
            elif v % dist == 0:
                parent = v - ((v // dist) % r) * dist
                yield from self.wait(
                    self.send_nb((parent + self.root) % size, _TOKEN,
                                 slot=40 + i))
                return


class FanoutKnomial(HostCollTask):
    """Root-to-all sync without data (fanout.c)."""

    def __init__(self, init_args, team, subset=None, radix=None):
        super().__init__(init_args, team, subset)
        self.root = int(init_args.args.root) if init_args.args else 0
        self.radix = max(2, min(radix or 4, self.gsize))

    def run(self):
        tok = _TOKEN.copy()
        yield from knomial_bcast_steps(self, tok, self.root, self.radix)


# ---------------------------------------------------------------------------
# linear rooted colls
# ---------------------------------------------------------------------------

def _linear_num_posts(team, knob: str, size: int) -> int:
    """GATHERV/SCATTERV_LINEAR_NUM_POSTS (tl_ucp.c:202-221): bound on
    the root's in-flight requests; 0/auto/oversize = all at once."""
    from .alltoall import resolve_num_posts
    return resolve_num_posts(team, knob, size, lambda: size, size)


class GatherLinear(HostCollTask):
    """Linear gather(v) (tl_ucp gatherv linear, gatherv.c), root-side
    in-flight recvs bounded by GATHERV_LINEAR_NUM_POSTS."""

    def run(self):
        args = self.args
        size, me, root = self.gsize, self.grank, int(args.root)
        is_v = isinstance(args.dst, BufferInfoV) or isinstance(args.src, BufferInfoV)
        if me != root:
            src = binfo_typed(args.src)
            yield from self.wait(self.send_nb(root, src, slot=50))
            return
        # root; gather: src.count = per-rank, dst.count = total
        nreqs = _linear_num_posts(self.tl_team,
                                  "gatherv_linear_num_posts", size)
        reqs = []
        for peer in range(size):
            block = binfo_v_block(args.dst, peer) if is_v else \
                _block(args.dst, peer, size)
            if peer == root:
                if not args.is_inplace:
                    block[:] = binfo_typed(args.src, count=block.size)
            else:
                reqs.append(self.recv_nb(peer, block, slot=50))
                # SLIDING window (tl_ucp num-posts semantics): keep
                # nreqs in flight continuously; drain only completions
                reqs = yield from self._throttle(reqs, nreqs)
        yield from self.wait(*reqs)


class ScatterLinear(HostCollTask):
    """Linear scatter(v) (tl_ucp scatterv linear, scatterv.c)."""

    def run(self):
        args = self.args
        size, me, root = self.gsize, self.grank, int(args.root)
        is_v = isinstance(args.src, BufferInfoV)
        if me != root:
            dst = binfo_typed(args.dst)
            yield from self.wait(self.recv_nb(root, dst, slot=51))
            return
        # scatter: src.count = total, dst.count = per-rank
        nreqs = _linear_num_posts(self.tl_team,
                                  "scatterv_linear_num_posts", size)
        reqs = []
        for peer in range(size):
            block = binfo_v_block(args.src, peer) if is_v else \
                _block(args.src, peer, size)
            if peer == root:
                if not args.is_inplace and args.dst is not None and \
                        args.dst.buffer is not None:
                    binfo_typed(args.dst, count=block.size)[:] = block
            else:
                reqs.append(self.send_nb(peer, block, slot=51))
                reqs = yield from self._throttle(reqs, nreqs)
        yield from self.wait(*reqs)


def _block(bi, peer: int, size: int) -> np.ndarray:
    """Rank-peer's equal block of a contiguous total-count buffer
    (gather dst / scatter src: count = total elements)."""
    per_rank = int(bi.count) // size
    return binfo_typed(bi, per_rank, per_rank * peer)
