"""Additional allgather algorithms.

Ports the semantics of UCC's src/components/tl/ucp/allgather/
(alg list tl_ucp_coll.c:207-233): Bruck (log-round, latency-optimal for
small messages), neighbor-exchange (even team sizes; halves the rounds of
ring for medium messages), and linear (everyone-to-everyone, tiny teams).
Ring lives in ring.py.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np

from ...ec.cpu import storage_dtype
from ...status import Status, UccError
from ..base import binfo_typed
from .knomial import largest_pow
from .task import HostCollTask


def _require_divisible(init_args, gsize: int) -> None:
    """These algorithms address equal blocks; near-equal splits are the
    ring's job — reject at INIT so the fallback chain reaches it."""
    if gsize > 0 and int(init_args.args.dst.count) % gsize != 0:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       "needs dst.count divisible by team size")


class AllgatherBruck(HostCollTask):
    """Bruck allgather: work starts with my block at slot 0; round k ships
    the first min(k, n-k) accumulated blocks to (me-k); final rotation
    unspins the slots (allgather_bruck.c)."""

    def __init__(self, init_args, team, subset=None):
        super().__init__(init_args, team, subset)
        _require_divisible(init_args, self.gsize)

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        total = int(args.dst.count)
        blk = total // size
        nd = storage_dtype(args.dst.datatype)
        dst = binfo_typed(args.dst, total)
        work = self.scratch("work", total, nd)
        if args.is_inplace:
            work[0:blk] = dst[me * blk:(me + 1) * blk]
        else:
            work[0:blk] = binfo_typed(args.src, blk)
        if size == 1:
            dst[:blk] = work[:blk]
            return
        k = 1
        rnd = 0
        while k < size:
            nblocks = min(k, size - k)
            to = (me - k) % size
            frm = (me + k) % size
            yield from self.sendrecv(
                to, work[:nblocks * blk],
                frm, work[k * blk:(k + nblocks) * blk], slot=110 + rnd)
            k *= 2
            rnd += 1
        # unrotate: work[i] holds block of rank (me + i) % n
        for i in range(size):
            p = (me + i) % size
            dst[p * blk:(p + 1) * blk] = work[i * blk:(i + 1) * blk]


class AllgatherNeighbor(HostCollTask):
    """Neighbor-exchange allgather (allgather_neighbor.c): even team sizes
    only — odd sizes return NOT_SUPPORTED and the score-map fallback picks
    the next algorithm (ucc_coll_score_map.c:136 behavior)."""

    def __init__(self, init_args, team, subset=None):
        super().__init__(init_args, team, subset)
        if self.gsize % 2 != 0 and self.gsize > 1:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "neighbor-exchange needs an even team size")
        _require_divisible(init_args, self.gsize)

    @staticmethod
    @functools.lru_cache(maxsize=64)
    def _schedule(size: int):
        """Deterministic per-rank (partner, blocks_sent) schedule. Both ends
        of every exchange derive the block ids by running this same
        simulation, so no metadata travels with the payloads. Pure function
        of team size -> cached (O(size^2) to build)."""
        def neighbor(rank, i):
            first = rank + 1 if rank % 2 == 0 else rank - 1
            second = rank - 1 if rank % 2 == 0 else rank + 1
            if i == 0:
                return first % size
            return (second if i % 2 == 1 else first) % size

        n_rounds = size // 2
        sent = [[None] * n_rounds for _ in range(size)]
        recv = [[None] * n_rounds for _ in range(size)]
        for r in range(size):
            sent[r][0] = [r]
        for r in range(size):
            recv[r][0] = sent[neighbor(r, 0)][0]
        for i in range(1, n_rounds):
            for r in range(size):
                sent[r][i] = ([r] + recv[r][0]) if i == 1 else recv[r][i - 1]
            for r in range(size):
                recv[r][i] = sent[neighbor(r, i)][i]
        return neighbor, sent, recv

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        total = int(args.dst.count)
        blk = total // size
        dst = binfo_typed(args.dst, total)

        def bview(b):
            return dst[(b % size) * blk:((b % size) + 1) * blk]

        if not args.is_inplace:
            bview(me)[:] = binfo_typed(args.src, blk)
        if size == 1:
            return
        neighbor, sent, recv = self._schedule(size)
        # every round moves at most 2 blocks per direction; one leased
        # buffer pair serves all rounds
        rbuf_all = self.scratch("rbuf", 2 * blk, dst.dtype)
        for i in range(size // 2):
            peer = neighbor(me, i)
            sblocks = sent[me][i]
            rblocks = recv[me][i]
            sbuf = self.pack("sbuf", [bview(b) for b in sblocks],
                             dst.dtype) if len(sblocks) > 1 else \
                bview(sblocks[0])
            rbuf = rbuf_all[:len(rblocks) * blk]
            yield from self.sendrecv(peer, sbuf, peer, rbuf, slot=120 + i)
            for n_, b in enumerate(rblocks):
                bview(b)[:] = rbuf[n_ * blk:(n_ + 1) * blk]


class AllgatherLinear(HostCollTask):
    """Everyone sends to everyone (allgather_linear.c) — lowest latency for
    very small teams/messages at O(n^2) messages."""

    def __init__(self, init_args, team, subset=None):
        super().__init__(init_args, team, subset)
        _require_divisible(init_args, self.gsize)

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        total = int(args.dst.count)
        blk = total // size
        dst = binfo_typed(args.dst, total)
        own = dst[me * blk:(me + 1) * blk]
        if not args.is_inplace:
            own[:] = binfo_typed(args.src, blk)
        reqs: List = []
        for p in range(size):
            if p == me:
                continue
            reqs.append(self.send_nb(p, own, slot=130))
            reqs.append(self.recv_nb(p, dst[p * blk:(p + 1) * blk],
                                     slot=130))
        yield from self.wait(*reqs)


class AllgatherLinearBatched(HostCollTask):
    """Linear allgather with BOUNDED in-flight requests
    (allgather_linear.c ucc_tl_ucp_allgather_linear_batched_init): the
    one-shot linear alg posts 2*(n-1) requests at once, which floods the
    transport at scale; this variant keeps at most ``nreqs`` sends and
    ``nreqs`` recvs outstanding (knob ``ALLGATHER_BATCHED_NUM_POSTS``,
    auto = n-1 i.e. one-shot; reference get_num_reqs clamps the same
    way). Sends walk clockwise from rank+1, recvs counter-clockwise from
    rank-1 — opposite directions so bounded windows cannot deadlock
    (the reference's 'avoid deadlock' pairing)."""

    def __init__(self, init_args, team, subset=None,
                 nreqs: Optional[int] = None):
        super().__init__(init_args, team, subset)
        _require_divisible(init_args, self.gsize)
        if nreqs is None:
            cfg = team.comp_context.config
            from ...utils.config import SIZE_AUTO, UINT_MAX
            raw = SIZE_AUTO
            if cfg is not None:
                try:
                    raw = int(cfg.get("allgather_batched_num_posts"))
                except KeyError:
                    pass
            max_req = max(1, self.gsize - 1)
            # reference get_num_reqs: auto OR 0 OR > n-1 all mean
            # one-shot (n-1 in flight); only 1..n-1 narrow the window
            nreqs = max_req if raw in (SIZE_AUTO, UINT_MAX, 0) \
                else min(int(raw), max_req)
        self.nreqs = max(1, int(nreqs))

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        total = int(args.dst.count)
        blk = total // size
        dst = binfo_typed(args.dst, total)
        own = dst[me * blk:(me + 1) * blk]
        if not args.is_inplace:
            own[:] = binfo_typed(args.src, blk)
        n_peers = size - 1
        sends: List = []
        recvs: List = []
        s_posted = r_posted = 0
        while (s_posted < n_peers or r_posted < n_peers or
               sends or recvs):
            while s_posted < n_peers and len(sends) < self.nreqs:
                peer = (me + 1 + s_posted) % size
                sends.append(self.send_nb(peer, own, slot=131))
                s_posted += 1
            while r_posted < n_peers and len(recvs) < self.nreqs:
                peer = (size + me - 1 - r_posted) % size
                recvs.append(self.recv_nb(
                    peer, dst[peer * blk:(peer + 1) * blk], slot=131))
                r_posted += 1
            # same contract as HostCollTask.wait() for BOTH directions: a
            # completed-with-error send (e.g. a socket peer reset) must
            # fail the collective, not vanish from the window — and it
            # bumps the tl/host coll_errors metric on the way out
            sends = self._drain_window(sends)
            recvs = self._drain_window(recvs)
            if sends or recvs or s_posted < n_peers or r_posted < n_peers:
                yield


class AllgatherSparbit(HostCollTask):
    """Sparbit allgather (allgather_sparbit.c, OMPI-derived): ceil(log2 n)
    rounds with HALVING distances; at round i each rank ships all blocks
    it has accumulated so far (minus an exclusion correction that makes
    non-power-of-two sizes exact) to (me + distance). Latency-optimal like
    Bruck but needs no final rotation — blocks land in place."""

    def __init__(self, init_args, team, subset=None):
        super().__init__(init_args, team, subset)
        _require_divisible(init_args, self.gsize)

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        total = int(args.dst.count)
        blk = total // size
        dst = binfo_typed(args.dst, total)
        if not args.is_inplace:
            dst[me * blk:(me + 1) * blk] = binfo_typed(args.src, blk)
        if size == 1:
            return
        tsize_log = (size - 1).bit_length()
        last_ignore = (size & -size).bit_length() - 1   # ctz
        ignore_steps = (~(size >> last_ignore) | 1) << last_ignore
        data_expected = 1
        for i in range(tsize_log):
            distance = (1 << (tsize_log - 1)) >> i
            sendto = (me + distance) % size
            recvfrom = (me - distance) % size
            exclusion = int((distance & ignore_steps) == distance)
            reqs = []
            for tc in range(data_expected - exclusion):
                sb = (me - 2 * tc * distance) % size
                rb = (me - (2 * tc + 1) * distance) % size
                reqs.append(self.send_nb(
                    sendto, dst[sb * blk:(sb + 1) * blk], slot=140 + i))
                reqs.append(self.recv_nb(
                    recvfrom, dst[rb * blk:(rb + 1) * blk], slot=140 + i))
            yield from self.wait(*reqs)
            data_expected = (data_expected << 1) - exclusion


class _KnomialAllgatherBase(HostCollTask):
    """Radix-k recursive-multiplying allgather over per-vrank segments —
    one core for both the equal-block and the v variant
    (allgather_knomial.c's GET_LOCAL_COUNT duality). Non-power-of-radix
    sizes fold extra ranks onto proxies (knomial EXTRA/PROXY pattern);
    a proxy's vrank segment carries both blocks, contiguous in a scratch
    laid out by vrank, so every round moves contiguous ranges."""

    RADIX = 2

    def _counts(self) -> List[int]:
        raise NotImplementedError

    def _finish(self, scratch, v_offsets, vrank_of_team) -> None:
        raise NotImplementedError

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        counts = self._counts()
        nd = storage_dtype(args.dst.datatype)
        radix = self.RADIX
        full = largest_pow(size, radix)
        if size - full > full:       # fold needs n_extra <= full
            radix = 2
            full = largest_pow(size, 2)
        n_extra = size - full

        my_cnt = counts[me]
        my_src = self.scratch("my_src", my_cnt, nd)
        if args.is_inplace:
            from ..base import binfo_v_block
            if hasattr(args.dst, "counts"):
                my_src[:] = binfo_v_block(args.dst, me)
            else:
                blk = int(args.dst.count) // size
                my_src[:] = binfo_typed(args.dst)[me * blk:(me + 1) * blk]
        else:
            my_src[:] = binfo_typed(args.src, my_cnt)

        if size == 1:
            self._finish(my_src, [0, my_cnt], [0])
            return

        # vrank space: full ranks keep their id; extra e folds onto
        # proxy e - full, whose vrank segment is [proxy blk][extra blk]
        is_extra = me >= full
        proxy = me - full if is_extra else None
        v_counts = [counts[v] + (counts[full + v] if v < n_extra else 0)
                    for v in range(full)]
        v_offsets = list(np.cumsum([0] + v_counts))
        total_v = v_offsets[-1]
        scratch = self.scratch("vspace", total_v, nd)

        if is_extra:
            yield from self.wait(self.send_nb(proxy, my_src, slot=150))
            yield from self.wait(self.recv_nb(proxy, scratch, slot=151))
            self._finish(scratch, v_offsets, list(range(full)))
            return

        seg_lo = v_offsets[me]
        scratch[seg_lo:seg_lo + my_cnt] = my_src
        if me < n_extra:
            ex = self.scratch("extra", counts[full + me], nd)
            yield from self.wait(self.recv_nb(full + me, ex, slot=150))
            scratch[seg_lo + my_cnt:seg_lo + v_counts[me]] = ex

        d = 1
        rnd = 0
        while d < full:
            digit = (me // d) % radix
            base = me - (me % (d * radix))
            own_lo = base + digit * d
            reqs = []
            for j in range(radix):
                if j == digit:
                    continue
                peer = base + j * d + (me % d)
                p_lo = base + j * d
                reqs.append(self.send_nb(
                    peer, scratch[v_offsets[own_lo]:
                                  v_offsets[min(own_lo + d, full)]],
                    slot=152 + rnd))
                reqs.append(self.recv_nb(
                    peer, scratch[v_offsets[p_lo]:
                                  v_offsets[min(p_lo + d, full)]],
                    slot=152 + rnd))
            yield from self.wait(*reqs)
            d *= radix
            rnd += 1

        if me < n_extra:
            yield from self.wait(self.send_nb(full + me, scratch, slot=151))
        self._finish(scratch, v_offsets, list(range(full)))


class AllgatherKnomial(_KnomialAllgatherBase):
    """Equal-block radix-k allgather (allgather_knomial.c)."""

    def __init__(self, init_args, team, subset=None, radix: int = 4):
        super().__init__(init_args, team, subset)
        _require_divisible(init_args, self.gsize)
        self.RADIX = max(2, radix)

    def _counts(self) -> List[int]:
        blk = int(self.args.dst.count) // self.gsize
        return [blk] * self.gsize

    def _finish(self, scratch, v_offsets, vranks) -> None:
        args = self.args
        size = self.gsize
        blk = int(args.dst.count) // size
        dst = binfo_typed(args.dst, int(args.dst.count))
        full = len(vranks)
        for v in range(full):
            seg = scratch[v_offsets[v]:v_offsets[v + 1]]
            dst[v * blk:(v + 1) * blk] = seg[:blk]
            if seg.size > blk:                      # proxy carried extra
                e = full + v
                dst[e * blk:(e + 1) * blk] = seg[blk:]


class AllgathervKnomial(_KnomialAllgatherBase):
    """Per-rank-count radix-k allgatherv (allgather_knomial.c with
    KN_PATTERN_ALLGATHERV counts; tl_ucp_coll.c:207-233)."""

    def __init__(self, init_args, team, subset=None, radix: int = 4):
        super().__init__(init_args, team, subset)
        if self.args.dst.counts is None:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "allgatherv requires dst counts")
        self.RADIX = max(2, radix)

    def _counts(self) -> List[int]:
        return [int(c) for c in self.args.dst.counts]

    def _finish(self, scratch, v_offsets, vranks) -> None:
        from ..base import binfo_v_block
        args = self.args
        size = self.gsize
        counts = self._counts()
        full = len(vranks)
        for v in range(full):
            seg = scratch[v_offsets[v]:v_offsets[v + 1]]
            binfo_v_block(args.dst, v)[:] = seg[:counts[v]]
            if seg.size > counts[v]:
                binfo_v_block(args.dst, full + v)[:] = seg[counts[v]:]
