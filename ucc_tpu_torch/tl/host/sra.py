"""SRA allreduce / SRG reduce — scatter-reduce + (all)gather, radix r.

Ports the semantics of the reference's SRA-knomial allreduce
(UCC's src/components/tl/ucp/coll_patterns/sra_knomial.h and
allreduce/allreduce_sra_knomial.c) and SRG-knomial reduce
(reduce/reduce_srg_knomial.c): reduce-scatter by recursive vector
splitting at radix r, then allgather (SRA) or gather-to-root (SRG) by
replaying the splits in reverse, with the extra/proxy fold for
non-power-of-radix team sizes. O(log_r N) rounds moving ~(N-1)/N of the
vector each direction — bandwidth-optimal at every radix; higher radix
trades per-round fan-out ((r-1) concurrent messages) for fewer rounds.

Radix comes from the per-mrange config knobs ``ALLREDUCE_SRA_RADIX`` /
``REDUCE_SRG_RADIX`` (reference: UCC_TL_UCP_ALLREDUCE_SRA_KN_RADIX,
tl_ucp.h mrange knobs) or an explicit constructor arg; default 2, the
canonical halving instance.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ...constants import ReductionOp
from ...ec.cpu import reduce_arrays, storage_dtype
from .knomial import clamp_radix, largest_pow
from .task import HostCollTask


#: SRG phase-2 slots. The scatter-reduce phase uses 172+rnd per round, so
#: any fixed slot under 172+log_r(full) can collide with a deep tree —
#: the old gather slot 190 aliased round 18's messages (190 = 172+18),
#: mismatching buffers on teams deep enough to reach it. Phase-2 slots
#: live at a base no round counter can reach.
_SRG_GATHER_SLOT = 300
_SRG_FORWARD_SLOT = 301


def _part(lo: int, hi: int, r: int, t: int) -> Tuple[int, int]:
    """Balanced sub-segment t of [lo, hi) split r ways (pure — every
    group member computes identical bounds)."""
    n = hi - lo
    return lo + (t * n) // r, lo + ((t + 1) * n) // r


def _owned_segment(rank: int, count: int, full: int, r: int) -> Tuple[int, int]:
    """Replay the radix-r splits: the (lo, hi) segment ``rank`` owns
    after the reduce-scatter phase."""
    lo, hi = 0, count
    dist = full // r
    while dist >= 1:
        lo, hi = _part(lo, hi, r, (rank // dist) % r)
        dist //= r
    return lo, hi


class _SraBase(HostCollTask):
    """Shared radix-r scatter-reduce phase + extra/proxy fold.

    Extra ranks (>= full = r^k) fold into proxy ``me % full`` before the
    loop and are unfolded after, the same multi-extra-per-proxy
    distribution the knomial patterns use
    (coll_patterns/recursive_knomial.h:98-105,172-179).
    """

    def _fold_extras(self, work, op, slot_base: int):
        """Proxy side: receive + reduce every extra's vector."""
        size, me = self.gsize, self.grank
        full = self.full
        nd = work.dtype
        n_extra = max(0, (size - 1 - me) // full)
        if not n_extra:
            return
        bufs = self.scratch("fold", (n_extra, self.count), nd)
        gen = 1
        pending = []
        while gen * full + me < size:
            buf = bufs[gen - 1]
            pending.append((buf, self.recv_nb(gen * full + me, buf,
                                              slot=slot_base + gen)))
            gen += 1
        if pending:
            yield from self.wait(*[rq for _, rq in pending])
            reduce_arrays([work] + [b for b, _ in pending], op, self.dt,
                          out=work)

    def _scatter_reduce(self, work, op, slot_base: int):
        """Radix-r recursive vector splitting; returns my (lo, hi)."""
        me, r, full = self.grank, self.radix, self.full
        lo, hi = 0, self.count
        # round-0 pieces are the largest: (r-1) peer copies of my part
        max_piece = (self.count + r - 1) // r + 1
        scratch = self.scratch("sr", (r - 1, max_piece), work.dtype)
        dist = full // r
        rnd = 0
        while dist >= 1:
            d = (me // dist) % r
            base = me - d * dist
            keep = _part(lo, hi, r, d)
            reqs, pieces = [], []
            for t in range(r):
                if t == d:
                    continue
                peer = base + t * dist
                give = _part(lo, hi, r, t)
                reqs.append(self.send_nb(peer, work[give[0]:give[1]],
                                         slot=slot_base + rnd))
                piece = scratch[len(pieces), :keep[1] - keep[0]]
                pieces.append(piece)
                reqs.append(self.recv_nb(peer, piece,
                                         slot=slot_base + rnd))
            yield from self.wait(*reqs)
            seg = work[keep[0]:keep[1]]
            if keep[1] > keep[0]:
                reduce_arrays([seg] + pieces, op, self.dt, out=seg)
            lo, hi = keep
            dist //= r
            rnd += 1
        self._seg = (lo, hi)


class AllreduceSraKnomial(_SraBase):
    def __init__(self, init_args, team, subset=None,
                 radix: Optional[int] = None):
        super().__init__(init_args, team, subset)
        args = init_args.args
        self.count = int(args.dst.count)
        self.dt = args.dst.datatype
        self.op = args.op if args.op is not None else ReductionOp.SUM
        self.radix = clamp_radix(
            radix or team.cfg_radix("allreduce_sra_radix",
                                    init_args.msgsize, default=2),
            self.gsize)
        self.full = largest_pow(self.gsize, self.radix)

    def run(self):
        args = self.args
        from ..base import binfo_typed
        dst = binfo_typed(args.dst, self.count)
        if not args.is_inplace:
            dst[:] = binfo_typed(args.src, self.count)
        op = ReductionOp.SUM if self.op == ReductionOp.AVG else self.op
        size, me = self.gsize, self.grank
        if size == 1:
            if self.op == ReductionOp.AVG:
                dst[:] = reduce_arrays([dst], ReductionOp.SUM, self.dt,
                                       alpha=1.0)
            return
        r, full = self.radix, self.full

        # EXTRA fold: hand the vector to the proxy, get the result back
        if me >= full:
            proxy = me % full
            gen = me // full
            yield from self.wait(self.send_nb(proxy, dst, slot=1000 + gen))
            yield from self.wait(self.recv_nb(proxy, dst, slot=2000 + gen))
            return
        yield from self._fold_extras(dst, op, slot_base=1000)

        # reduce-scatter: radix-r recursive vector splitting
        yield from self._scatter_reduce(dst, op, slot_base=2)
        lo, hi = self._seg

        if self.op == ReductionOp.AVG and hi > lo:
            dst[lo:hi] = reduce_arrays([dst[lo:hi]], ReductionOp.SUM,
                                       self.dt, alpha=1.0 / size)

        # allgather: replay the splits in reverse — at each level every
        # group member broadcasts its (now fully reduced+gathered deeper
        # levels) part to the r-1 peers and receives theirs
        segs: List[Tuple[int, int, int]] = []   # (dist, lo, hi) pre-split
        lo2, hi2 = 0, self.count
        dist = full // r
        while dist >= 1:
            segs.append((dist, lo2, hi2))
            lo2, hi2 = _part(lo2, hi2, r, (me // dist) % r)
            dist //= r
        for rnd, (dist, slo, shi) in enumerate(reversed(segs)):
            d = (me // dist) % r
            base = me - d * dist
            mine = _part(slo, shi, r, d)
            reqs = []
            for t in range(r):
                if t == d:
                    continue
                peer = base + t * dist
                theirs = _part(slo, shi, r, t)
                if mine[1] > mine[0]:
                    reqs.append(self.send_nb(peer, dst[mine[0]:mine[1]],
                                             slot=100 + rnd))
                if theirs[1] > theirs[0]:
                    reqs.append(self.recv_nb(peer, dst[theirs[0]:theirs[1]],
                                             slot=100 + rnd))
            yield from self.wait(*reqs)

        # PROXY unfold: send the full result to every folded extra
        gen = 1
        reqs = []
        while gen * full + me < size:
            reqs.append(self.send_nb(gen * full + me, dst,
                                     slot=2000 + gen))
            gen += 1
        if reqs:
            yield from self.wait(*reqs)


class ReduceSrgKnomial(_SraBase):
    """SRG reduce (reduce_srg_knomial.c): Scatter-Reduce + Gather — the
    bandwidth-optimal rooted reduce for large vectors. Phase 1 is the
    radix-r reduce-scatter SRA uses; phase 2 gathers the reduced segments
    to the root instead of allgathering. AVG runs SUM with each owner
    scaling its segment before the gather."""

    def __init__(self, init_args, team, subset=None,
                 radix: Optional[int] = None):
        super().__init__(init_args, team, subset)
        args = init_args.args
        src_bi = args.dst if args.is_inplace or args.src is None else args.src
        self.count = int(src_bi.count)
        self.dt = src_bi.datatype
        self.op = args.op if args.op is not None else ReductionOp.SUM
        self.root = int(args.root)
        self.radix = clamp_radix(
            radix or team.cfg_radix("reduce_srg_radix",
                                    init_args.msgsize, default=2),
            self.gsize)
        self.full = largest_pow(self.gsize, self.radix)

    def run(self):
        from ..base import binfo_typed
        args = self.args
        size, me = self.gsize, self.grank
        nd = storage_dtype(self.dt)
        op = ReductionOp.SUM if self.op == ReductionOp.AVG else self.op
        is_root = me == self.root

        # workspace: root reduces straight into dst; others into scratch
        if is_root and args.dst is not None and args.dst.buffer is not None \
                and not args.is_inplace:
            work = binfo_typed(args.dst, self.count)
            work[:] = binfo_typed(args.src, self.count)
        elif is_root and args.is_inplace:
            work = binfo_typed(args.dst, self.count)
        else:
            work = self.scratch("work", self.count, nd)
            src_bi = args.dst if args.is_inplace else args.src
            work[:] = binfo_typed(src_bi, self.count)

        if size == 1:
            if self.op == ReductionOp.AVG:
                work[:] = reduce_arrays([work], ReductionOp.SUM, self.dt,
                                        alpha=1.0)
            return

        r, full = self.radix, self.full

        # EXTRA fold: extras hand their vector to the proxy; an extra
        # ROOT receives the final result back
        if me >= full:
            proxy = me % full
            gen = me // full
            yield from self.wait(self.send_nb(proxy, work, slot=170 * 100 + gen))
            if is_root:
                yield from self.wait(self.recv_nb(proxy, work,
                                                  slot=_SRG_FORWARD_SLOT))
            return
        yield from self._fold_extras(work, op, slot_base=170 * 100)

        # phase 1: radix-r reduce-scatter
        yield from self._scatter_reduce(work, op, slot_base=172)
        lo, hi = self._seg

        if self.op == ReductionOp.AVG and hi > lo:
            work[lo:hi] = reduce_arrays([work[lo:hi]], ReductionOp.SUM,
                                        self.dt, alpha=1.0 / size)

        # phase 2: gather segments to the root (root's proxy when the
        # root is an extra rank)
        sink = self.root % full
        if me == sink:
            reqs = []
            for p in range(full):
                if p == sink:
                    continue
                plo, phi = _owned_segment(p, self.count, full, r)
                if phi > plo:
                    reqs.append(self.recv_nb(p, work[plo:phi],
                                             slot=_SRG_GATHER_SLOT))
            yield from self.wait(*reqs)
            if self.root >= full:           # forward to the extra root
                yield from self.wait(self.send_nb(self.root, work,
                                                  slot=_SRG_FORWARD_SLOT))
        elif hi > lo:
            yield from self.wait(self.send_nb(sink, work[lo:hi],
                                              slot=_SRG_GATHER_SLOT))


def _pipelined_init(init_args, team, knob: str, make_task, count: int,
                    esz: int, frag_args):
    """Shared fragmentation-pipeline wiring for the SRA/SRG inits: parse
    the knob's pipeline DSL, gate on nfrags_pdepth, and build a
    PipelinedSchedule whose window entries wrap ``make_task`` over
    ``frag_args(frag_num, n_frags)`` slices; retargeting rebinds the task's
    buffer views in place (the allreduce_sra_knomial.c frag_setup
    role). Returns ``make_task(init_args)`` unfragmented when the knob
    is off or the message is below threshold."""
    from ...schedule.pipelined import (PipelinedSchedule, PipelineOrder,
                                       parse_pipeline_params)
    from ...schedule.schedule import Schedule
    from ...status import Status as _S

    cfg = team.comp_context.config
    pp = None
    if cfg is not None:
        try:
            pp = parse_pipeline_params(cfg.get(knob))
        except KeyError:
            pp = None
    n_frags = pdepth = 1
    if pp is not None:
        n_frags, pdepth = pp.nfrags_pdepth(count * esz)
    if n_frags <= 1 or count < n_frags:
        return make_task(init_args)

    ia_cls = type(init_args)

    def frag_init(sched_p, idx):
        frag = Schedule(team=team)
        fa = frag_args(idx, n_frags)
        n = int((fa.dst or fa.src).count)
        fia = ia_cls(args=fa, team=init_args.team,
                     mem_type=init_args.mem_type, msgsize=n * esz)
        t = make_task(fia)
        frag.add_task(t)
        frag.add_dep_on_schedule_start(t)
        return frag

    def frag_setup(sched_p, frag, frag_num):
        fa = frag_args(frag_num, n_frags)
        for t in frag.tasks:
            t.args.src = fa.src
            t.args.dst = fa.dst
            t.count = int((fa.dst or fa.src).count)
        return _S.OK

    return PipelinedSchedule(
        team=team, args=init_args.args, frag_init=frag_init,
        frag_setup=frag_setup, n_frags=pdepth, n_frags_total=n_frags,
        order=pp.order if pp else PipelineOrder.SEQUENTIAL)


def sra_pipelined_init(init_args, team, radix=None):
    """SRA allreduce with optional fragmentation pipelining — the
    ALLREDUCE_SRA_KN_PIPELINE role (allreduce_sra_knomial.c:58-171 +
    get_pipeline_params): above the spec's threshold the vector splits
    into fragments driven through the PipelinedSchedule engine, so
    fragment k+1's reduce-scatter overlaps fragment k's allgather.
    Knob ``ALLREDUCE_SRA_PIPELINE`` uses the standard pipeline DSL
    (thresh=64K:fragsize=1M:nfrags=4:pdepth=2:ordered); default off."""
    from ...api.types import BufferInfo, CollArgs
    from ...constants import CollArgsFlags, CollType
    from ...utils.mathutils import block_count, block_offset
    from ..base import binfo_typed

    args = init_args.args
    count = int(args.dst.count)
    dt = args.dst.datatype
    esz = storage_dtype(dt).itemsize
    full_dst = binfo_typed(args.dst, count)
    full_src = full_dst if args.is_inplace else binfo_typed(args.src, count)

    def frag_args(frag_num, n_frags):
        off = block_offset(count, n_frags, frag_num)
        cnt = block_count(count, n_frags, frag_num)
        return CollArgs(
            coll_type=CollType.ALLREDUCE,
            src=BufferInfo(full_src[off:off + cnt], cnt, dt),
            dst=BufferInfo(full_dst[off:off + cnt], cnt, dt),
            op=args.op,
            flags=args.flags & ~(CollArgsFlags.PERSISTENT
                                 | CollArgsFlags.IN_PLACE))

    def make_task(ia):
        # native-plan bridge: the scatter-reduce/allgather loops below
        # are exactly the verified gen_sra(radix) program (radix-r core
        # plus the extra/proxy fold), so when UCC_GEN_NATIVE resolves on
        # the collective retires inside the native core as a packed plan.
        # The radix is resolved as the classic task resolves it, so the
        # selection (ALLREDUCE_SRA_RADIX) is unchanged
        from ...dsl.plan import handwritten_plan_task, native_mode
        try:
            r = clamp_radix(
                radix or team.cfg_radix("allreduce_sra_radix",
                                        ia.msgsize, default=2),
                max(2, int(getattr(team, "size", 2))))
            t = handwritten_plan_task(ia, team, "sra", radix=r)
        except Exception:  # noqa: BLE001 - under auto the bridge must
            # never cost the classic path its correctness; under y a
            # plan that cannot be built is the collective's failure
            if native_mode(team) == "y":
                raise
            t = None
        return t if t is not None \
            else AllreduceSraKnomial(ia, team, radix=radix)

    return _pipelined_init(
        init_args, team, "allreduce_sra_pipeline", make_task,
        count, esz, frag_args)


def srg_pipelined_init(init_args, team, radix=None):
    """SRG reduce with optional fragmentation pipelining — the
    REDUCE_SRG_KN_PIPELINE role (reduce_srg_knomial.c pipeline wiring,
    same engine as SRA). Knob ``REDUCE_SRG_PIPELINE``; default off."""
    from ...api.types import BufferInfo, CollArgs
    from ...constants import CollArgsFlags, CollType
    from ...utils.mathutils import block_count, block_offset
    from ..base import binfo_typed

    args = init_args.args
    src_bi = args.dst if args.is_inplace or args.src is None else args.src
    count = int(src_bi.count)
    dt = src_bi.datatype
    esz = storage_dtype(dt).itemsize
    is_root = team.rank == int(args.root)
    full_src = binfo_typed(src_bi, count)
    full_dst = binfo_typed(args.dst, count) \
        if is_root and args.dst is not None and args.dst.buffer is not None \
        else None

    def frag_args(frag_num, n_frags):
        off = block_offset(count, n_frags, frag_num)
        cnt = block_count(count, n_frags, frag_num)
        return CollArgs(
            coll_type=CollType.REDUCE, root=args.root,
            src=BufferInfo(full_src[off:off + cnt], cnt, dt),
            dst=BufferInfo(full_dst[off:off + cnt], cnt, dt)
            if full_dst is not None else None,
            op=args.op,
            flags=args.flags & ~(CollArgsFlags.PERSISTENT
                                 | CollArgsFlags.IN_PLACE))

    return _pipelined_init(
        init_args, team, "reduce_srg_pipeline",
        lambda ia: ReduceSrgKnomial(ia, team, radix=radix),
        count, esz, frag_args)
