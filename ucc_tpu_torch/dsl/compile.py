"""Program compiler — lowers verified programs to host-TL tasks (the
port of ``ucc_tpu/dsl/compile.py``).

A :class:`GeneratedCollTask` interprets one rank's instruction stream of
a verified :class:`~.ir.Program` on the existing host-TL machinery:

- chunk buffers are views of the user dst vector (the standard
  near-equal block split) — no staging copies for exact programs;
- temporaries (reduce landing zones, quantized wire buffers) are
  mc-pool ``scratch()`` leases keyed by round position, so the steady
  state of a persistent generated collective is zero-alloc exactly like
  the hand-written algorithms;
- accumulation runs through ``reduce_arrays(out=)``;
- wire ops post through the task's ``send_nb``/``recv_nb`` (the cached
  ctx-rank fast path, fault injection, cancellation and the flight
  recorder apply unchanged);
- programs tagged with a wire precision insert the block codec
  (``quant/codec.py``) at every send edge: the chunk is block-scale encoded into a leased wire
  buffer, sent, and the sender's own copy is re-decoded from that wire
  so every rank ends with bit-identical dequantized values (the
  cross-rank agreement rule the hand-written quantized variants follow).

The pipelined family wraps per-fragment ``GeneratedCollTask``s in the
:class:`~..schedule.pipelined.PipelinedSchedule` (fragment k+1's
reduce-scatter overlaps fragment k's allgather).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .. import quant
from ..constants import CollArgsFlags, CollType, DataType, ReductionOp
from ..ec.cpu import bf16_to_f32, f32_to_bf16, reduce_arrays, storage_dtype
from ..status import Status, UccError
from ..tl.base import binfo_typed
from ..tl.host.task import HostCollTask
from ..utils.mathutils import block_count, block_offset
from .ir import PUT_KINDS, OpKind, Program

_F32 = np.dtype(np.float32)
_DT_F32 = DataType.FLOAT32

#: reduction operators the generated executor supports: associative +
#: commutative ops reduce_arrays(out=) accumulates in place (AVG runs
#: SUM and scales the fully-reduced vector once at the end — sound
#: because the verifier proves every chunk ends as the full reduction)
_EXACT_OPS = frozenset((ReductionOp.SUM, ReductionOp.AVG, ReductionOp.PROD,
                        ReductionOp.MAX, ReductionOp.MIN))


class GeneratedCollTask(HostCollTask):
    """Interpreter for one rank of a verified collective program."""

    def __init__(self, init_args, team, program: Program, subset=None,
                 tag=None):
        # ``tag``: explicit wire tag override (the coalescer's fused
        # batches allocate from their own deterministic tag range so a
        # rank-local flush point cannot skew the organic per-team
        # counter); None = the normal next_coll_tag() allocation
        super().__init__(init_args, team, subset, tag=tag)
        args = init_args.args
        if args.coll_type != program.coll:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"program {program.name} serves "
                           f"{program.coll!r}")
        if self.gsize != program.nranks:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"program {program.name} compiled for "
                           f"{program.nranks} ranks (team has "
                           f"{self.gsize})")
        self.prog = program
        self.coll = program.coll
        # buffer contract per collective (the tl/host conventions,
        # ring.py header): the program's "vector" is the full logical
        # vector of the collective — allreduce/allgather dst, the
        # reduce_scatter INPUT, the bcast payload buffer
        if self.coll == CollType.ALLGATHER:
            self.count = int(args.dst.count)
            self.dt = args.dst.datatype
        elif self.coll == CollType.REDUCE_SCATTER:
            bi = args.dst if args.is_inplace else args.src
            self.count = int(bi.count)
            self.dt = bi.datatype
        elif self.coll == CollType.BCAST:
            self.count = int(args.src.count)
            self.dt = args.src.datatype
        else:
            self.count = int(args.dst.count)
            self.dt = args.dst.datatype
        # bcast programs are generated for root 0; other roots run the
        # SAME program with every rank rotated by the root (my stream is
        # rank (me - root) % n's; peers translate back at post time)
        self.root = int(args.root or 0) if self.coll == CollType.BCAST \
            else 0
        self._prog_rank = (self.grank - self.root) % self.gsize
        reducing = self.coll not in (CollType.ALLGATHER, CollType.BCAST)
        op = args.op if (reducing and args.op is not None) \
            else ReductionOp.SUM
        if reducing and op not in _EXACT_OPS:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"generated programs support "
                           f"{sorted(o.name for o in _EXACT_OPS)} "
                           f"(got {op.name})")
        self.op = op
        if self.count < program.nchunks:
            # zero-element chunks would post zero-byte wire traffic for
            # no benefit; the fallback walk lands on an exact algorithm
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"count {self.count} below program chunk "
                           f"count {program.nchunks}")
        if self.coll in (CollType.ALLGATHER, CollType.REDUCE_SCATTER) \
                and program.nchunks != self.gsize \
                and self.count % program.nchunks != 0:
            # the UCC near-equal split front-loads the remainder, so an
            # m-chunked block [b*m, (b+1)*m) only equals the collective's
            # per-rank block when chunks divide evenly — near-equal
            # totals are the 1-chunk variants' job (the tl/host
            # _require_divisible precedent)
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"count {self.count} not divisible by "
                           f"{program.nchunks} chunks")
        if not args.is_inplace:
            # block-addressed collectives: the per-rank buffer must be
            # exactly my near-equal block of the full vector
            my_blk = block_count(self.count, self.gsize, self._prog_rank)
            if self.coll == CollType.ALLGATHER and \
                    int(args.src.count) != my_blk:
                raise UccError(Status.ERR_NOT_SUPPORTED,
                               f"src.count {args.src.count} != my "
                               f"allgather block {my_blk}")
            if self.coll == CollType.REDUCE_SCATTER and \
                    int(args.dst.count) < my_blk:
                raise UccError(Status.ERR_NOT_SUPPORTED,
                               f"dst.count {args.dst.count} below my "
                               f"reduce_scatter block {my_blk}")
        self.qp = None
        self._edge_wire = program.edge_wire_mode
        wire_mode = program.wire or self._edge_wire
        if wire_mode:
            qp = quant.params_for(team, program.coll)
            if qp is None or qp.mode != wire_mode:
                raise UccError(Status.ERR_NOT_SUPPORTED,
                               f"wire precision {wire_mode} not "
                               f"enabled (UCC_QUANT)")
            if self._edge_wire:
                # per-edge codec interleaves with exact accumulation:
                # f32 payloads only (no staging-dtype conversions)
                if storage_dtype(self.dt) != _F32:
                    raise UccError(Status.ERR_NOT_SUPPORTED,
                                   "per-edge quantized programs need a "
                                   f"float32 payload (got {self.dt})")
            elif self.dt not in quant.QUANT_DTS:
                raise UccError(Status.ERR_NOT_SUPPORTED,
                               f"quantized wire needs a float payload "
                               f"(got {self.dt})")
            if op not in (ReductionOp.SUM, ReductionOp.AVG):
                raise UccError(Status.ERR_NOT_SUPPORTED,
                               "quantized generated programs support "
                               f"SUM/AVG (got {op.name})")
            # one quantization per phase (send edges only): the direct
            # error model, gated by the same user budget as the
            # hand-written variants
            if not quant.admits(qp, program.coll, self.gsize, "direct"):
                raise UccError(
                    Status.ERR_NOT_SUPPORTED,
                    f"quantized {qp.mode} predicted error exceeds "
                    f"error budget {qp.budget:.4f}")
            self.qp = qp
        # pooled tier (one-sided window puts): programs with PUT /
        # PUT_RED edges retire those edges through the process-shared
        # arena — resolved and window-allocated once at init so a full
        # window table degrades to a clean NOT_SUPPORTED fallback
        # instead of failing mid-collective
        self._pool_rounds = None
        if program.uses_windows:
            self._pool_setup(team, program)
        # my instruction stream, split per round into wire/local phases
        # once at init (posts interpret the precompiled lists)
        self._rounds: List[Tuple[list, list, list]] = []
        max_reduces = max_sends = max_recvs = 0
        max_wire_sends = max_wire_recvs = 0
        for ops in program.ranks[self._prog_rank].rounds:
            wire_sends = [op for op in ops if op.kind == OpKind.SEND]
            wire_recvs = [op for op in ops
                          if op.kind in (OpKind.RECV, OpKind.REDUCE)]
            local = [op for op in ops if op.kind == OpKind.COPY]
            self._rounds.append((wire_sends, wire_recvs, local))
            max_sends = max(max_sends, len(wire_sends))
            max_recvs = max(max_recvs, len(wire_recvs))
            max_reduces = max(max_reduces, sum(
                1 for op in wire_recvs if op.kind == OpKind.REDUCE))
            max_wire_sends = max(max_wire_sends, sum(
                1 for op in wire_sends if op.wire))
            max_wire_recvs = max(max_wire_recvs, sum(
                1 for op in wire_recvs if op.wire))
        self._max_sends = max_sends
        self._max_recvs = max_recvs
        self._max_reduces = max_reduces
        self._max_wire_sends = max_wire_sends
        self._max_wire_recvs = max_wire_recvs
        # native execution plan: when UCC_GEN_NATIVE resolves on
        # for this (team, program, dtype, op), the whole round schedule
        # retires inside the native core — one ffi crossing per post, C-side
        # reductions, a mapped completion word — and run() dispatches to
        # _run_plan instead of the interpreter. None = interpret.
        self._plan = None
        self._plan_active = False
        self._plan_harvested = True
        if self.coll != CollType.ALLREDUCE or self._edge_wire or \
                self.root or program.uses_windows:
            # plans lower the allreduce contract (dst-vector chunk
            # offsets, SUM-tree reductions, AVG end scale); the new
            # collectives, per-edge-quantized programs, rotated bcast
            # roots and window (pooled) programs interpret
            return
        from . import plan as _plan_mod
        try:
            self._plan = _plan_mod.acquire(self, team, program)
        except Exception as e:  # noqa: BLE001 - under auto, plan mode
            # must never turn an eligible collective into a failure: the
            # interpreter is always correct. Under y the plan is required
            # and its failure is the collective's (UCC_NATIVE=y's rule)
            if _plan_mod.native_mode(team) == "y":
                if isinstance(e, UccError) and \
                        e.status == Status.ERR_NO_RESOURCE:
                    raise
                raise UccError(Status.ERR_NO_RESOURCE,
                               f"UCC_GEN_NATIVE=y but the plan of "
                               f"{program.name} could not be built: "
                               f"{e}") from e
            from ..utils.log import get_logger
            get_logger("dsl").exception(
                "native plan acquisition failed; interpreting %s",
                program.name)
            self._plan = None

    # ------------------------------------------------------------------
    def _chunk_bounds(self) -> List[Tuple[int, int]]:
        nch = self.prog.nchunks
        return [(block_offset(self.count, nch, c),
                 block_count(self.count, nch, c)) for c in range(nch)]

    # ------------------------------------------------------------------
    # pooled tier: one-sided put+flag windows in the process-shared arena
    #
    # Window identity is writer-side — ("pool", team_key, epoch, slot,
    # writer ctx rank, payload bytes) — so a fan-out put (one chunk to
    # many peers this round) shares ONE window every target reads. Cell
    # layout: [flag 8B][acks: nranks x 8B][payload], header rounded to
    # 64 so payload views stay element-aligned. The writer waits for
    # every target's ack to reach the PREVIOUS sequence (SPSC reuse
    # guard), copies the chunk, then releases flag = seq; each reader
    # spins its flag to seq, consumes straight out of the mapped window
    # (reduce directly from the view — the zero-copy half of the tier)
    # and acks. seq is the per-team lockstep coll tag + 1 (nonzero,
    # monotonic), so epochs/windows never see an ABA value; rank-local
    # write ordering between overlapping collectives on the same window
    # comes from a per-team claims ticket (claim BEFORE the first yield).
    # A cancel mid-publish can strand a claimed-but-never-released seq;
    # that is the team-failure path — recovery shrinks, the epoch bump
    # re-keys every window fresh.
    def _pool_setup(self, team, program: Program) -> None:
        if program.wire or self._edge_wire:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "window programs are exact (no wire codec)")
        arena = getattr(team.transport, "arena", None)
        if arena is None:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "pooled program needs a shared-memory arena "
                           "(ipc TL)")
        self._pool_arena = arena
        n = program.nranks
        # header: flag + per-program-rank ack word, 64-aligned payload
        self._pool_hdr = -(-(8 + 8 * n) // 64) * 64
        out_rounds: List[list] = []
        in_rounds: List[list] = []
        for k in range(len(program.ranks[self._prog_rank].rounds)):
            groups: dict = {}
            for op in program.ranks[self._prog_rank].rounds[k]:
                if op.kind in PUT_KINDS:
                    g = groups.setdefault(op.slot, (op.chunk, op.kind, []))
                    g[2].append(op.peer)
            out_rounds.append([(slot,) + groups[slot]
                               for slot in sorted(groups)])
            inc = []
            for p in range(n):
                if p == self._prog_rank:
                    continue
                for op in program.ranks[p].rounds[k]:
                    if op.kind in PUT_KINDS and op.peer == self._prog_rank:
                        inc.append((p, op.slot, op.chunk, op.kind))
            # overwrites apply before reductions (the verifier's order),
            # then deterministic (source, slot) for reproducible sums
            inc.sort(key=lambda t: (t[3] == OpKind.PUT_RED, t[0], t[1]))
            in_rounds.append(inc)
        self._pool_out = out_rounds
        self._pool_in = in_rounds
        self._pool_resolve()

    def _pool_resolve(self) -> None:
        """(Re)resolve every window this task touches for the CURRENT
        count — payload bytes are part of the window identity, so a
        retargeted count maps to its own windows. Raises NOT_SUPPORTED
        (→ fallback walk / tuner unsupported record) when the arena's
        window table or heap is exhausted."""
        arena = self._pool_arena
        esz = storage_dtype(self.dt).itemsize
        bounds = self._chunk_bounds()
        hdr = self._pool_hdr
        tk = self.tl_team.team_key
        ep = self.tl_team.team_epoch

        def win(src_prog_rank: int, slot: int, chunk: int):
            nb = bounds[chunk][1] * esz
            src_ctx = self._ctx_of(self._peer(src_prog_rank))
            woff = arena.window(("pool", tk, ep, slot, src_ctx, nb),
                                hdr + nb)
            if not woff:
                raise UccError(Status.ERR_NOT_SUPPORTED,
                               "arena window table/heap exhausted")
            return woff, nb

        rounds = []
        for groups, inc in zip(self._pool_out, self._pool_in):
            o = []
            for slot, chunk, kind, targets in groups:
                woff, nb = win(self._prog_rank, slot, chunk)
                o.append((woff, chunk, kind, targets, nb))
            i = []
            for p, slot, chunk, kind in inc:
                woff, nb = win(p, slot, chunk)
                i.append((woff, chunk, kind, nb))
            rounds.append((o, i))
        self._pool_rounds = rounds
        self._pool_count = self.count

    def _pool_publish(self, out, vec, bounds, seq, claims):
        """Writer half: claim each window's ticket, wait out the previous
        occupant's acks, copy my chunk in, release the flag."""
        arena = self._pool_arena
        hdr = self._pool_hdr
        tr = self.tl_team.transport
        for woff, chunk, kind, targets, nb in out:
            prev = claims.get(woff)
            if prev is None:
                prev = arena.load_acquire(woff)
            claims[woff] = seq         # ticket taken before any yield
            for t in targets:
                aoff = woff + 8 + 8 * t
                while arena.load_acquire(aoff) != prev:
                    yield
            off, cnt = bounds[chunk]
            arena.view(woff + hdr, nb)[:] = \
                vec[off:off + cnt].view(np.uint8)
            self.data_committed = True
            arena.store_release(woff, seq)
            tr.n_pooled = getattr(tr, "n_pooled", 0) + 1

    def _pool_consume(self, inc, vec, bounds, seq, nd, red_op):
        """Reader half: spin each incoming window's flag to this post's
        seq, apply the payload straight from the mapped view (overwrite
        or reduce — no staging copy), then ack."""
        arena = self._pool_arena
        hdr = self._pool_hdr
        my_ack = 8 + 8 * self._prog_rank
        for woff, chunk, kind, nb in inc:
            while arena.load_acquire(woff) != seq:
                yield
            off, cnt = bounds[chunk]
            pay = arena.view(woff + hdr, nb).view(nd)
            if kind == OpKind.PUT:
                vec[off:off + cnt] = pay
            else:
                acc = vec[off:off + cnt]
                reduce_arrays([acc, pay], red_op, self.dt, out=acc)
            arena.store_release(woff + my_ack, seq)

    def run(self):
        if self._plan is not None:
            yield from self._run_plan()
            return
        if self.qp is not None and self.prog.wire:
            # whole-program wire (qdirect); per-edge wire (hier DCN
            # edges) runs through the interpreter's edge codec path
            yield from self._run_wire()
            return
        yield from self._run_interp()

    # ------------------------------------------------------------------
    def _run_plan(self):
        """Native-plan execution: one ffi posts the plan; this generator
        then only polls the mapped completion word (a memory load per
        progress pass) and services assist rounds."""
        from . import plan as _plan_mod
        args = self.args
        plan = self._plan
        if plan is not None and plan.count != self.count:
            # pipelined-fragment retarget (frag_setup rebinds count):
            # plans are count-exact — offsets are baked — so NEVER run a
            # stale-geometry plan; swap through the count-keyed cache
            _plan_mod.release(self.tl_team, plan, True)
            plan = self._plan = _plan_mod.acquire(self, self.tl_team,
                                                  self.prog)
            if plan is None:
                yield from self._run_fallback()
                return
        dst = binfo_typed(args.dst, self.count)
        if not args.is_inplace:
            dst[:] = binfo_typed(args.src, self.count)
        self._plan_harvested = False
        self.data_committed = True
        rc = plan.post(dst, self.tag)
        if rc != 0:
            # plan unusable this post (unexpected overlap / dead core):
            # fall back to the interpreter — same program, same result
            self._plan_harvested = True
            yield from self._run_fallback()
            return
        self._plan_active = True
        while True:
            st, payload = plan.poll()
            if st == _plan_mod.ST_RUNNING:
                yield
            elif st == _plan_mod.ST_ASSIST:
                plan.run_assist(payload)
            else:
                break
        self._plan_active = False
        self._plan_harvest(plan)
        if st == _plan_mod.ST_DONE:
            if self.op == ReductionOp.AVG:
                # identical arithmetic to the interpreter's end scale so
                # plan and interpreted paths stay bitwise-identical
                if self.qp is not None:
                    np.multiply(dst, 1.0 / self.gsize, out=dst)
                else:
                    dst[:] = reduce_arrays([dst], ReductionOp.SUM,
                                           self.dt,
                                           alpha=1.0 / self.gsize)
            plan.release_dst()
            return
        # terminal error/cancel: deliberately KEEP plan._dst — the plan
        # may have parked zero-copy sends pointing into it, and the
        # dirty-destroy pin (NativePlan.destroy) needs the reference
        if st == _plan_mod.ST_CANCELED:
            raise UccError(Status.ERR_CANCELED, "native plan canceled")
        if st == _plan_mod.ST_CORRUPT:
            # the C matcher caught a crc mismatch on one of this plan's
            # recvs; the first offending sender's ctx rank was harvested
            # into the plan counters at wait time
            src = plan.counters()["corrupt_src"]
            self._integrity_error(
                src if src >= 0 else None,
                f"data corrupted: crc32 mismatch in native plan round "
                f"{payload}" + (f" (from ctx rank {src})"
                                if src >= 0 else ""))
        if st == _plan_mod.ST_FENCED:
            self._obs_error("fenced: stale team epoch (native plan)")
        self._obs_error(f"native plan failed at round {payload} "
                        f"(state {st})")

    def _run_fallback(self):
        """Interpreted execution of the SAME program (wire-compatible
        with peers that did engage their plans)."""
        if self.qp is not None and self.prog.wire:
            yield from self._run_wire()
        else:
            yield from self._run_interp()

    def _plan_harvest(self, plan) -> None:
        """Fold the plan's C-side accounting back into the transport
        counters and the flight recorder (once per post, including the
        cancel path): wire-kind counts stay accurate with Python off the
        data path, and the flight ring still gets one event per completed
        round for straggler attribution."""
        if self._plan_harvested:
            return
        self._plan_harvested = True
        c = plan.counters()
        tr = self.tl_team.transport
        tr.n_direct += c["direct"]
        tr.n_eager += c["eager"]
        tr.n_rndv += c["rndv"]
        tr.n_fenced += c["fenced"]
        fr = getattr(tr, "_flight", None)
        if fr is not None:
            # one event per completed round, from the C-side round
            # counter, not per-message callbacks
            kind = "rndv" if c["rndv"] else "direct"
            tkey = (self.tl_team.team_key, self.tl_team.team_epoch,
                    self.tag, 0, getattr(self.tl_team, "_my_ctx_rank", 0))
            rb = plan.low.round_bytes
            for rnd in range(min(c["rounds"], plan.n_rounds)):
                fr.append(kind,
                          (tkey[0], tkey[1], tkey[2], rnd, tkey[4]),
                          rb[rnd] if rnd < len(rb) else 0)

    def cancel_fn(self) -> None:
        plan = self._plan
        if plan is not None and self._plan_active:
            try:
                plan.cancel()   # withdraws posted recvs (native skip)
            except Exception:  # noqa: BLE001 - cancel is best-effort
                pass
            self._plan_active = False
            try:
                self._plan_harvest(plan)
            except Exception:  # noqa: BLE001
                pass
        super().cancel_fn()

    def finalize_fn(self):
        plan, self._plan = self._plan, None
        if plan is not None:
            from . import plan as _plan_mod
            clean = self.super_status == Status.OK and \
                not self.status.is_error and not self._plan_active
            try:
                _plan_mod.release(self.tl_team, plan, clean)
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
        return super().finalize_fn()

    def obs_describe(self, now=None) -> dict:
        d = super().obs_describe(now)
        plan = self._plan
        if plan is not None and self._plan_active:
            try:
                st, payload = plan.poll()
                d["plan"] = {"state": int(st), "payload": int(payload),
                             "rounds_done": plan.counters()["rounds"],
                             "n_rounds": plan.n_rounds}
            except Exception:  # noqa: BLE001 - diagnostics only
                pass
        return d

    # ------------------------------------------------------------------
    def _peer(self, p: int) -> int:
        """Program rank -> team (group) rank: the bcast root rotation
        (identity for every other collective)."""
        return (p + self.root) % self.gsize if self.root else p

    def _owned_slice(self, vec: np.ndarray) -> np.ndarray:
        """My rank-block of the full vector (the standard near-equal
        n-way split; nested chunk splits align with it)."""
        off = block_offset(self.count, self.gsize, self._prog_rank)
        cnt = block_count(self.count, self.gsize, self._prog_rank)
        return vec[off:off + cnt]

    def _run_interp(self):
        args = self.args
        coll = self.coll
        nd = storage_dtype(self.dt)
        out_block = None
        if coll == CollType.ALLGATHER:
            # vector = dst (total); my owned block starts as my src
            vec = binfo_typed(args.dst, self.count)
            if not args.is_inplace:
                own = self._owned_slice(vec)
                own[:] = binfo_typed(args.src, own.size)
        elif coll == CollType.REDUCE_SCATTER:
            # vector = the full INPUT, interpreted on scratch; my owned
            # block lands in dst at the end (ReduceScatterRing contract)
            vec = self.scratch("rsw", self.count, nd)
            if args.is_inplace:
                full = binfo_typed(args.dst, self.count)
                vec[:] = full
                out_block = self._owned_slice(full)
            else:
                vec[:] = binfo_typed(args.src, self.count)
                out_block = binfo_typed(
                    args.dst, min(int(args.dst.count),
                                  self._owned_slice(vec).size))
        elif coll == CollType.BCAST:
            vec = binfo_typed(args.src, self.count)
        else:                                   # ALLREDUCE
            vec = binfo_typed(args.dst, self.count)
            if not args.is_inplace:
                vec[:] = binfo_typed(args.src, self.count)
        red_op = ReductionOp.SUM if self.op == ReductionOp.AVG else self.op
        # gsize >= 2 always: generators refuse n < 2 and __init__
        # rejects a program/team size mismatch
        size = self.gsize
        bounds = self._chunk_bounds()
        max_chunk = max(c for _, c in bounds)
        rtmp = self.scratch("rt", (max(1, self._max_reduces),
                                   max(1, max_chunk)), nd)
        qp = self.qp if self._edge_wire else None
        if qp is not None:
            max_wire = quant.wire_count(max_chunk, qp.block)
            ews = self.scratch("ews", (max(1, self._max_wire_sends),
                                       max_wire), np.uint8)
            ewr = self.scratch("ewr", (max(1, self._max_wire_recvs),
                                       max_wire), np.uint8)
            dtmp = self.scratch("edeq", max(1, max_chunk), np.float32)
            rng = np.random.default_rng() if qp.stochastic else None

        def view(c):
            off, cnt = bounds[c]
            return vec[off:off + cnt]

        pool = self._pool_rounds
        if pool is not None:
            if self._pool_count != self.count:
                # pipelined-fragment retarget: window geometry is
                # count-exact, swap to this count's windows
                self._pool_resolve()
                pool = self._pool_rounds
            seq = int(self.tag) + 1
            claims = self.tl_team.__dict__.setdefault("_pool_claims", {})
        for rnd, (sends, recvs, local) in enumerate(self._rounds):
            reqs = []
            landings = []
            wire_landings = []
            encoded = {}
            if qp is not None:
                # encode (and sender-side re-decode) BEFORE posting any
                # send of this round: a chunk shipped both exact and
                # quantized this round must deliver ONE value — the
                # re-decoded one — on every edge, or ranks disagree
                # bitwise on the slice (and the copy-free matcher could
                # even race the mutation against a parked exact send)
                si = 0
                for op in sends:
                    if not op.wire or op.chunk in encoded:
                        continue
                    cnt = bounds[op.chunk][1]
                    w = ews[si, :quant.wire_count(cnt, qp.block)]
                    si += 1
                    src = view(op.chunk)
                    qp.codec.encode(src, w, qp.block,
                                    stochastic=qp.stochastic, rng=rng)
                    qp.codec.decode(w, cnt, qp.block, src)
                    encoded[op.chunk] = w
            for op in sends:
                peer = self._peer(op.peer)
                if op.wire:
                    reqs.append(self.send_nb(peer, encoded[op.chunk],
                                             slot=op.slot))
                else:
                    reqs.append(self.send_nb(peer, view(op.chunk),
                                             slot=op.slot))
            ri = wi = 0
            for op in recvs:
                peer = self._peer(op.peer)
                cnt = bounds[op.chunk][1]
                if op.wire:
                    w = ewr[wi, :quant.wire_count(cnt, qp.block)]
                    wi += 1
                    reqs.append(self.recv_nb(peer, w, slot=op.slot))
                    wire_landings.append((op, w, cnt))
                elif op.kind == OpKind.RECV:
                    # allgather-style move: deliver straight into the
                    # destination slice, no staging copy
                    reqs.append(self.recv_nb(peer, view(op.chunk),
                                             slot=op.slot))
                else:
                    tmp = rtmp[ri, :cnt]
                    ri += 1
                    reqs.append(self.recv_nb(peer, tmp, slot=op.slot))
                    landings.append((op.chunk, tmp))
            if pool is not None and pool[rnd][0]:
                # publish BEFORE the two-sided wait: peers spinning on
                # these flags may be the very ranks our recvs need
                yield from self._pool_publish(pool[rnd][0], vec, bounds,
                                              seq, claims)
            if reqs:
                yield from self.wait(*reqs)
            for chunk, tmp in landings:
                acc = view(chunk)
                reduce_arrays([acc, tmp], red_op, self.dt, out=acc)
            for op, w, cnt in wire_landings:
                if op.kind == OpKind.RECV:
                    qp.codec.decode(w, cnt, qp.block, view(op.chunk))
                else:
                    t = dtmp[:cnt]
                    qp.codec.decode(w, cnt, qp.block, t)
                    acc = view(op.chunk)
                    reduce_arrays([acc, t], red_op, _DT_F32, out=acc)
            if pool is not None and pool[rnd][1]:
                yield from self._pool_consume(pool[rnd][1], vec, bounds,
                                              seq, nd, red_op)
            for op in local:
                view(op.chunk)[:] = view(op.src_chunk)
        if coll == CollType.ALLREDUCE and self.op == ReductionOp.AVG:
            vec[:] = reduce_arrays([vec], ReductionOp.SUM, self.dt,
                                   alpha=1.0 / size)
        if out_block is not None:
            mine = self._owned_slice(vec)
            if self.op == ReductionOp.AVG:
                mine = reduce_arrays([mine], ReductionOp.SUM, self.dt,
                                     alpha=1.0 / size)
            out_block[:] = mine[:out_block.size]

    # ------------------------------------------------------------------
    def _run_wire(self):
        """Quantized interpretation: f32 accumulate, codec at send
        edges, sender-side re-decode for cross-rank bit agreement."""
        args = self.args
        qp = self.qp
        dst = binfo_typed(args.dst, self.count)
        if not args.is_inplace:
            dst[:] = binfo_typed(args.src, self.count)
        size = self.gsize
        if dst.dtype == _F32:
            work = dst
        else:
            # bfloat16 payloads are uint16 bit patterns here
            work = self.scratch("work", self.count, np.float32)
            work[:] = bf16_to_f32(dst)
        bounds = self._chunk_bounds()
        max_chunk = max(c for _, c in bounds)
        max_wire = quant.wire_count(max_chunk, qp.block)
        ws = self.scratch("ws", (max(1, self._max_sends), max_wire),
                          np.uint8)
        wr = self.scratch("wr", (max(1, self._max_recvs), max_wire),
                          np.uint8)
        dtmp = self.scratch("deq", max(1, max_chunk), np.float32)
        rng = np.random.default_rng() if qp.stochastic else None

        def view(c):
            off, cnt = bounds[c]
            return work[off:off + cnt]

        for sends, recvs, local in self._rounds:
            reqs = []
            landings = []
            # one encode per (round, chunk): a chunk sent to several
            # peers this round (the allgather fan-out) reuses its wire
            encoded = {}
            si = 0
            for op in sends:
                w = encoded.get(op.chunk)
                if w is None:
                    cnt = bounds[op.chunk][1]
                    w = ws[si, :quant.wire_count(cnt, qp.block)]
                    si += 1
                    src = view(op.chunk)
                    qp.codec.encode(src, w, qp.block,
                                    stochastic=qp.stochastic, rng=rng)
                    # re-decode into my own copy: receivers hold
                    # decode(wire), so the sender must too or ranks
                    # disagree bitwise on this slice
                    qp.codec.decode(w, cnt, qp.block, src)
                    encoded[op.chunk] = w
                reqs.append(self.send_nb(op.peer, w, slot=op.slot))
            for wi, op in enumerate(recvs):
                cnt = bounds[op.chunk][1]
                w = wr[wi, :quant.wire_count(cnt, qp.block)]
                reqs.append(self.recv_nb(op.peer, w, slot=op.slot))
                landings.append((op, w, cnt))
            if reqs:
                yield from self.wait(*reqs)
            for op, w, cnt in landings:
                if op.kind == OpKind.RECV:
                    qp.codec.decode(w, cnt, qp.block, view(op.chunk))
                else:
                    t = dtmp[:cnt]
                    qp.codec.decode(w, cnt, qp.block, t)
                    acc = view(op.chunk)
                    # work is always f32 (dst view or scratch), so the
                    # accumulate runs in f32 like the hand-written
                    # quantized variants
                    reduce_arrays([acc, t], ReductionOp.SUM, _DT_F32,
                                  out=acc)
            for op in local:
                view(op.chunk)[:] = view(op.src_chunk)
        if self.op == ReductionOp.AVG:
            np.multiply(work, 1.0 / size, out=work)
        if work is not dst:
            dst[:] = f32_to_bf16(work)


# ---------------------------------------------------------------------------
# init fns (score-map candidates)
# ---------------------------------------------------------------------------

def generated_init(init_args, team, program: Program):
    """Plain (single-schedule) generated algorithm init."""
    return GeneratedCollTask(init_args, team, program)


def generated_pipelined_init(init_args, team, program: Program):
    """Pipelined-family init: split the vector into ``depth`` fragments,
    each running *program*, driven through a PipelinedSchedule window
    (sequential order, window 2 — fragment k+1 starts when fragment k
    completes its matching stage, overlapping reduce-scatter with the
    previous fragment's allgather)."""
    from ..api.types import BufferInfo, CollArgs
    from ..schedule.pipelined import PipelinedSchedule, PipelineOrder
    from ..schedule.schedule import Schedule

    depth = int(program.params.get("depth", 2))
    args = init_args.args
    count = int(args.dst.count)
    dt = args.dst.datatype
    esz = storage_dtype(dt).itemsize
    # every fragment needs at least one element per chunk
    if block_count(count, depth, depth - 1) < program.nchunks:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"count {count} too small for pipeline depth "
                       f"{depth} x {program.nchunks} chunks")
    full_dst = binfo_typed(args.dst, count)
    full_src = full_dst if args.is_inplace else binfo_typed(args.src, count)
    ia_cls = type(init_args)

    def frag_args(frag_num: int) -> CollArgs:
        off = block_offset(count, depth, frag_num)
        cnt = block_count(count, depth, frag_num)
        return CollArgs(
            coll_type=CollType.ALLREDUCE,
            src=BufferInfo(full_src[off:off + cnt], cnt, dt),
            dst=BufferInfo(full_dst[off:off + cnt], cnt, dt),
            op=args.op,
            flags=args.flags & ~(CollArgsFlags.PERSISTENT
                                 | CollArgsFlags.IN_PLACE))

    def frag_init(sched_p, idx):
        frag = Schedule(team=team)
        fa = frag_args(idx)
        fia = ia_cls(args=fa, team=init_args.team,
                     mem_type=init_args.mem_type,
                     msgsize=int(fa.dst.count) * esz)
        t = GeneratedCollTask(fia, team, program)
        frag.add_task(t)
        frag.add_dep_on_schedule_start(t)
        return frag

    def frag_setup(sched_p, frag, frag_num):
        fa = frag_args(frag_num)
        for t in frag.tasks:
            t.args.src = fa.src
            t.args.dst = fa.dst
            t.count = int(fa.dst.count)
        return Status.OK

    return PipelinedSchedule(
        team=team, args=init_args.args, frag_init=frag_init,
        frag_setup=frag_setup, n_frags=min(2, depth), n_frags_total=depth,
        order=PipelineOrder.SEQUENTIAL)
