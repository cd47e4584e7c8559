"""Alltoall(v) algorithms.

Ports semantics of UCC's src/components/tl/ucp/alltoall/
(alltoall_pairwise.c, alltoall_bruck.c) and alltoallv/alltoallv_pairwise.c.

  - pairwise: N-1 balanced exchange steps (step s: send to r+s, recv from
    r-s) with a bounded in-flight window (tl_ucp pairwise num_posts knob)
  - linear: post everything at once (best for tiny teams)
  - bruck: log2(N) rounds for small messages — each round ships all blocks
    whose destination's bit `k` is set, then a local inverse rotation
  - alltoallv pairwise: vector counts/displacements

Buffer convention: src.count = dst.count = total elements (N blocks of
count/N each), matching UCC alltoall args.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ...api.types import BufferInfoV
from ...constants import dt_size
from ...ec.cpu import storage_dtype
from ..base import binfo_typed, binfo_v_block
from .task import HostCollTask


#: reference auto-posts thresholds (alltoall_pairwise.c:15-16): big
#: messages on big teams serialize (1 post) to avoid flooding; otherwise
#: everything goes in flight (linear regime)
_MSG_MEDIUM = 66000
_NP_THRESH = 32


def resolve_num_posts(team, knob: str, size: int, auto,
                      missing_default: int) -> int:
    """Shared NUM_POSTS knob resolution (every reference get_num_posts
    flavor agrees on the clamp shell): explicit 1..size-1 passes
    through; 0 / 'inf' / oversize mean everything in flight; 'auto'
    defers to the per-collective ``auto()`` rule;
    ``missing_default`` applies when the config table lacks the knob."""
    cfg = team.comp_context.config
    from ...utils.config import SIZE_AUTO, UINT_MAX
    raw = None
    if cfg is not None:
        try:
            raw = int(cfg.get(knob))
        except KeyError:
            raw = None
    if raw is None:
        return missing_default
    if raw == SIZE_AUTO:
        return max(1, min(int(auto()), max(1, size)))
    if raw == UINT_MAX or raw == 0 or raw >= size:
        return max(1, size)
    return int(raw)


def _pairwise_num_posts(team, knob: str, data_size: int, tsize: int,
                        window_default: int) -> int:
    """ALLTOALL(V)_PAIRWISE_NUM_POSTS auto rules, matching the reference:

    - alltoall (alltoall_pairwise.c:30-51): serialize (1) only for BIG
      messages (>64KB) on BIG teams (>32); else all in flight;
    - alltoallv (alltoallv_pairwise.c:30-46, ``data_size`` is None):
      team-size-ONLY — v-counts are peer-dependent so no single message
      size exists; >32 ranks always serialize to avoid flooding."""

    def auto():
        if data_size is None:        # alltoallv: team-size-only rule
            return 1 if tsize > _NP_THRESH else tsize
        return 1 if (data_size > _MSG_MEDIUM and tsize > _NP_THRESH) \
            else tsize

    return resolve_num_posts(team, knob, tsize, auto, window_default)


class AlltoallPairwise(HostCollTask):
    WINDOW = 4   # historical default when the knob is unavailable
    USES_NUM_POSTS_KNOB = True

    def __init__(self, init_args, team, subset=None):
        super().__init__(init_args, team, subset)
        if self.gsize and int(init_args.args.dst.count) % self.gsize != 0:
            from ...status import Status, UccError
            raise UccError(Status.ERR_INVALID_PARAM,
                           "alltoall needs count divisible by team size")
        if self.USES_NUM_POSTS_KNOB:
            self.window = _pairwise_num_posts(
                team, "alltoall_pairwise_num_posts",
                int(init_args.msgsize), self.gsize, self.WINDOW)
        else:
            self.window = self.WINDOW

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        total = int(args.dst.count)
        blk = total // size
        src = binfo_typed(args.src if not args.is_inplace else args.dst, total)
        if args.is_inplace:
            staged = self.scratch("staged", total, src.dtype)
            staged[:] = src
            src = staged
        dst = binfo_typed(args.dst, total)
        dst[me * blk:(me + 1) * blk] = src[me * blk:(me + 1) * blk]
        reqs: List = []
        for step in range(1, size):
            to = (me + step) % size
            frm = (me - step) % size
            reqs.append(self.send_nb(to, src[to * blk:(to + 1) * blk],
                                     slot=80 + step))
            reqs.append(self.recv_nb(frm, dst[frm * blk:(frm + 1) * blk],
                                     slot=80 + step))
            # SLIDING window (reference keeps nreqs continuously
            # posted): drain completions only, never the whole batch
            reqs = yield from self._throttle(reqs, 2 * self.window)
        if reqs:
            yield from self.wait(*reqs)


class AlltoallLinear(AlltoallPairwise):
    WINDOW = 1 << 30  # post everything, single wait
    USES_NUM_POSTS_KNOB = False


class AlltoallBruck(HostCollTask):
    """Bruck alltoall (coll_patterns/bruck_alltoall.h): O(log N) rounds of
    aggregated blocks — latency-optimal for small messages."""

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        total = int(args.dst.count)
        blk = total // size
        nd = storage_dtype(args.dst.datatype)
        src = binfo_typed(args.src if not args.is_inplace else args.dst, total)
        dst = binfo_typed(args.dst, total)
        # phase 0: local rotation - work[i] = block for rank (me + i) % size
        work = self.scratch("work", total, nd)
        for i in range(size):
            peer = (me + i) % size
            work[i * blk:(i + 1) * blk] = src[peer * blk:(peer + 1) * blk]
        # phase 1: log2 rounds
        k = 1
        rnd = 0
        tmp = self.scratch("tmp", total, nd)
        while k < size:
            # blocks whose bit-k is set travel this round (any team size,
            # ceil(log2 N) rounds). Invariant: work[i] at rank r holds data
            # destined to r+i having already traveled (i mod k); sending
            # slot i to r+k and receiving into the same slot preserves it.
            idxs = [i for i in range(size) if (i // k) % 2 == 1]
            send_to = (me + k) % size
            recv_from = (me - k) % size
            sbuf = self.pack("sbuf",
                             [work[i * blk:(i + 1) * blk] for i in idxs],
                             nd)
            rbuf = tmp[:sbuf.size]
            yield from self.sendrecv(send_to, sbuf, recv_from, rbuf,
                                     slot=84 + rnd)
            for n, i in enumerate(idxs):
                work[i * blk:(i + 1) * blk] = rbuf[n * blk:(n + 1) * blk]
            k *= 2
            rnd += 1
        # phase 2: work[i] is from rank (me - i); unrotate
        for i in range(size):
            p = (me - i) % size
            dst[p * blk:(p + 1) * blk] = work[i * blk:(i + 1) * blk]


class AlltoallvPairwise(HostCollTask):
    WINDOW = 4

    def __init__(self, init_args, team, subset=None):
        super().__init__(init_args, team, subset)
        self.window = _pairwise_num_posts(
            team, "alltoallv_pairwise_num_posts",
            None, self.gsize, self.WINDOW)

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        srcv: BufferInfoV = args.src
        dstv: BufferInfoV = args.dst
        if args.is_inplace:
            # in-place alltoallv: stage through a leased copy of dst
            view = binfo_typed(dstv)
            staged = self.scratch("staged", view.size, view.dtype)
            staged[:] = view

            def sblock(p):
                c = int(dstv.counts[p])
                d = int(dstv.displacements[p]) if dstv.displacements is not None \
                    else sum(int(x) for x in dstv.counts[:p])
                return staged[d:d + c]
        else:
            def sblock(p):
                return binfo_v_block(srcv, p)
        own_dst = binfo_v_block(dstv, me)
        own_src = sblock(me)
        own_dst[:min(own_dst.size, own_src.size)] = \
            own_src[:min(own_dst.size, own_src.size)]
        reqs: List = []
        for step in range(1, size):
            to = (me + step) % size
            frm = (me - step) % size
            reqs.append(self.send_nb(to, sblock(to), slot=88 + step))
            reqs.append(self.recv_nb(frm, binfo_v_block(dstv, frm),
                                     slot=88 + step))
            reqs = yield from self._throttle(reqs, 2 * self.window)
        if reqs:
            yield from self.wait(*reqs)


class AlltoallvHybrid(HostCollTask):
    """Hybrid alltoallv (alltoallv_hybrid.c): per-pair routing split by a
    size threshold. LARGE pairs exchange directly (pairwise, one message,
    bandwidth-bound); SMALL pairs travel Bruck-style — log2(n) forwarding
    rounds where rank me ships every pending small payload whose remaining
    route has bit k set to (me + 2^k), aggregating many tiny messages into
    one per round (latency-bound regime). This is the DCN-friendly shape:
    few large flows plus O(log n) aggregated small flows instead of n*n
    tiny ones.

    Each forwarding round sends a metadata vector (int64 triples
    (origin, dest, count)) and one concatenated payload; receivers land
    finished payloads in dst and keep forwarding the rest.
    """

    #: fallback per-pair element threshold when the byte knob is absent
    SMALL_THRESH = 256

    def __init__(self, init_args, team, subset=None,
                 thresh: int = None):
        super().__init__(init_args, team, subset)
        if self.args.is_inplace:
            from ...status import Status, UccError
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "hybrid alltoallv: in-place not supported "
                           "(pairwise serves it)")
        if thresh is not None:
            self.thresh = thresh
        else:
            # reference ALLTOALLV_HYBRID_CHUNK_BYTE_LIMIT (tl_ucp.c:100,
            # default 12k): per-pair BYTE bound under which messages
            # aggregate through the forwarding phase
            from ...utils.config import SIZE_AUTO, SIZE_INF, UINT_MAX
            cfg = team.comp_context.config
            esz = dt_size(init_args.args.dst.datatype)
            try:
                limit = int(cfg.get("alltoallv_hybrid_chunk_byte_limit")) \
                    if cfg is not None else None
            except KeyError:
                limit = None
            if limit in (SIZE_AUTO, SIZE_INF, UINT_MAX):
                limit = 12 << 10      # sentinel -> reference default 12k
            self.thresh = max(1, limit // esz) if limit is not None \
                else self.SMALL_THRESH
        # phase-1 in-flight bound (reference
        # ALLTOALLV_HYBRID_PAIRWISE_NUM_POSTS, tl_ucp.c:89, default 3)
        self.p1_window = resolve_num_posts(
            team, "alltoallv_hybrid_pairwise_num_posts", self.gsize,
            lambda: 3, 3)

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        srcv: BufferInfoV = args.src
        dstv: BufferInfoV = args.dst
        nd = storage_dtype(dstv.datatype)
        scounts = [int(c) for c in srcv.counts]
        rcounts = [int(c) for c in dstv.counts]

        # own block
        own = binfo_v_block(srcv, me)
        binfo_v_block(dstv, me)[:own.size] = own

        # phase 1: direct pairwise for LARGE pairs (both ends derive the
        # routing from their own counts — sender checks scount, receiver
        # rcount; the threshold rule makes them agree)
        # per-DIRECTION bounds like the reference (send_posted and
        # recv_posted each capped at num_posts): hybrid's posts are
        # conditional per pair, so a shared list would let a one-sided
        # traffic pattern run 2x the configured window
        s_reqs: List = []
        r_reqs: List = []
        for step in range(1, size):
            to = (me + step) % size
            frm = (me - step) % size
            if scounts[to] > self.thresh:
                s_reqs.append(self.send_nb(to, binfo_v_block(srcv, to),
                                           slot=240))
            if rcounts[frm] > self.thresh:
                r_reqs.append(self.recv_nb(frm, binfo_v_block(dstv, frm),
                                           slot=240))
            s_reqs = yield from self._throttle(s_reqs, self.p1_window)
            r_reqs = yield from self._throttle(r_reqs, self.p1_window)
        yield from self.wait(*(s_reqs + r_reqs))

        # phase 2: Bruck forwarding of SMALL pairs
        pending: List = []          # (origin, dest, np payload)
        for p in range(size):
            if p != me and 0 < scounts[p] <= self.thresh:
                pending.append((me, p, np.ascontiguousarray(
                    binfo_v_block(srcv, p))))
        n_rounds = max(1, (size - 1).bit_length())
        for k in range(n_rounds):
            hop = 1 << k
            to = (me + hop) % size
            frm = (me - hop) % size
            ship = [t for t in pending
                    if (((t[1] - me) % size) >> k) & 1]
            pending = [t for t in pending
                       if not (((t[1] - me) % size) >> k) & 1]
            meta = self.scratch("meta", 1 + 3 * len(ship), np.int64)
            meta[0] = len(ship)
            for i, (orig, dest, data) in enumerate(ship):
                meta[1 + 3 * i:4 + 3 * i] = (orig, dest, data.size)
            payload = self.pack("payload", [d for _, _, d in ship], nd)
            # metadata first (bounded recv + nbytes), then exact payload
            meta_recv = self.scratch("meta_recv", 1 + 3 * size * size,
                                     np.int64)
            sreq_m = self.send_nb(to, meta, slot=241 + 2 * k)
            rreq_m = self.recv_nb(frm, meta_recv, slot=241 + 2 * k)
            sreq_p = self.send_nb(to, payload, slot=242 + 2 * k)
            yield from self.wait(sreq_m, rreq_m)
            m = int(meta_recv[0])
            in_total = int(sum(meta_recv[3 + 3 * i] for i in range(m)))
            payload_in = self.scratch("payload_in", max(1, in_total),
                                      nd)[:in_total]
            rreq_p = self.recv_nb(frm, payload_in, slot=242 + 2 * k)
            yield from self.wait(sreq_p, rreq_p)
            off = 0
            for i in range(m):
                orig, dest, cnt = (int(meta_recv[1 + 3 * i]),
                                   int(meta_recv[2 + 3 * i]),
                                   int(meta_recv[3 + 3 * i]))
                data = payload_in[off:off + cnt]
                off += cnt
                if dest == me:
                    binfo_v_block(dstv, orig)[:cnt] = data
                else:
                    pending.append((orig, dest, data.copy()))
        assert not pending, "hybrid a2av: undelivered payloads"
