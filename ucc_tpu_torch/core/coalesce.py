"""Small-collective coalescing: N logical allreduces, one wire op (the
port of the JAX package's ``core/coalesce.py``).

The multi-tenant service's throughput half (the priority lanes in
schedule/progress.py are the latency half): storms of small same-team
allreduces: gradient buckets, per-layer scalars, counters: are packed
into one contiguous vector and retired as a SINGLE generated collective
(dsl/fused.py), so N logical posts cost one verified program execution
and, when the native plan executor is on, one ffi crossing total.

Lifecycle contract. Member requests keep their full identity: each one
runs the normal ``CollRequest.post`` accounting (coll_posted metric,
flight post event with its own flight_seq, coll trace) BEFORE being
held, and on fused completion each member task's ``complete()`` runs :
per-request status, duration, user callback, EVENT cascade. Cancelling
one held member is local and cheap: the member completes CANCELED but
its segment stays in the packed vector (membership must stay symmetric
across ranks), it just skips result delivery. Team fault/shrink/grow/
destroy paths call :meth:`TeamCoalescer.abort`, which fails held
members exactly like queued tasks (fence/epoch contracts hold because
members never touch the wire: only the fused carrier does, inside one
epoch).

Batch-membership determinism. A fused batch is a wire-level collective,
so every rank MUST seal the same member set into the same batch. The
primary closure triggers are all program-order events, identical on
every rank by the UCC ordered-issue contract:

- the batch reaches ``UCC_COALESCE_MAX_BATCH`` members;
- a post on the same team that cannot join (different op/dtype,
  oversized, ineligible coll: e.g. a barrier) arrives;
- the user first tests/waits a held member (the instance-attr ``test``
  shadow below);
- an explicit ``flush()`` (team retirement, abort).

The ``UCC_COALESCE_WINDOW`` expiry (stepped from ``Context.progress``)
and the cross-team high-priority-post flush are latency valves for
quiescent ranks; they assume the SPMD symmetric-posting discipline
every collective here already assumes: ranks that stop posting stop
together, so a timer flush only ever seals a batch no rank is still
extending. Tag parity cannot be skewed either way: members consume
``next_coll_tag()`` at init (program order), and fused carriers tag
from the dedicated ``FUSED_TAG_BASE`` space (dsl/fused.py).

Off by default (``UCC_COALESCE=y`` to enable): with the knob off no
coalescer is ever attached, ``CollRequest`` sees only its class-attr
``None`` defaults, and candidate lists/dispatch are byte-identical to
the pre-coalescing build.

HOST buffers: numpy arrays and CPU tensors. A C-contiguous CPU tensor is
eligible under the same rule as a C-contiguous ndarray; both pack and
unpack through a typed view of their storage (``ec/cpu._as_typed``;
bfloat16 as its uint16 bit pattern), so a coalesced tensor member is
bitwise its ndarray twin.
"""
from __future__ import annotations

import os
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..constants import CollType, GenericDataType, ReductionOp
from ..obs import metrics
from ..status import Status
from ..utils.log import get_logger

logger = get_logger("coalesce")

_raw = os.environ.get("UCC_COALESCE", "").strip().lower()
ENABLED: bool = _raw not in ("", "0", "n", "no", "off")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


#: per-member payload ceiling in bytes: above it a collective is
#: bandwidth-bound and batching only adds a copy
LIMIT_BYTES: int = _env_int("UCC_COALESCE_LIMIT", 4096)
#: gather window in microseconds (flushed earlier by any closure
#: trigger; this is only the quiescent-rank valve)
WINDOW_S: float = _env_float("UCC_COALESCE_WINDOW", 200.0) * 1e-6
#: deterministic batch-size cap: the primary closure trigger
MAX_BATCH: int = _env_int("UCC_COALESCE_MAX_BATCH", 16)

#: reductions the fused generated program supports (dsl/compile.py
#: _EXACT_OPS; AVG is SUM + one end scale over the whole packed vector,
#: which distributes over the member segments)
_FUSED_OPS = frozenset((ReductionOp.SUM, ReductionOp.AVG, ReductionOp.PROD,
                        ReductionOp.MAX, ReductionOp.MIN))


def configure(enabled: Optional[bool] = None,
              limit: Optional[int] = None,
              window_us: Optional[float] = None,
              max_batch: Optional[int] = None) -> None:
    """Test hook: mirror of the UCC_COALESCE_* env knobs."""
    global ENABLED, LIMIT_BYTES, WINDOW_S, MAX_BATCH
    if enabled is not None:
        ENABLED = bool(enabled)
    if limit is not None:
        LIMIT_BYTES = int(limit)
    if window_us is not None:
        WINDOW_S = float(window_us) * 1e-6
    if max_batch is not None:
        MAX_BATCH = int(max_batch)


def _flat(buf: Any, count: int, nd: np.dtype) -> np.ndarray:
    """A zero-copy typed view of the first *count* elements of a host
    buffer (ndarray or CPU tensor; bfloat16 as uint16)."""
    from ..ec.cpu import _as_typed
    return _as_typed(buf, count, nd)


def _host_buffer_ok(b: Any, count: int) -> bool:
    """A C-contiguous ndarray, or a contiguous CPU tensor, holding at
    least *count* elements: the buffers a batch can pack and unpack."""
    if isinstance(b, np.ndarray):
        return b.flags.c_contiguous and b.size >= count
    if isinstance(b, torch.Tensor):
        return (b.device.type == "cpu" and b.is_contiguous()
                and b.numel() >= count)
    return False


class _FusedDispatchTask:
    """Deferred-dispatch proxy: membership is SEALED synchronously at the
    flush trigger (program order: the determinism contract above), but
    the expensive tail (pack copy, program lookup, native plan acquire,
    carrier post: ~0.2-0.5ms) runs from the progress queue, in the
    member team's own priority lane. A high-priority post that pulls the
    cross-team flush valve therefore pays only the seal, not the bulk
    teams' carrier construction.

    Tag/order symmetry holds: proxies from one team dispatch in lane
    FIFO order = flush order = program order, so the deferred
    ``_fused_seq`` consumption is identical on every rank.

    Lazily rebased onto CollTask at first use (import-cycle guard :
    schedule.task must not import at coalesce module load)."""

    _cls = None

    def __new__(cls, coal, members, reason):
        if cls._cls is None:
            from ..schedule.task import CollTask

            class _Impl(CollTask):
                # no coll_name/alg_name: the proxy is pure scheduling
                # machinery: the carrier it creates carries the batch's
                # full attribution
                def __init__(self, coal, members, reason):
                    super().__init__(team=coal.team, flags_internal=True)
                    self._coal = coal
                    self._members = members
                    self._reason = reason
                    self._armed = False
                    self._defer_t0 = None

                def post_fn(self) -> Status:
                    return Status.IN_PROGRESS

                def progress_fn(self) -> None:
                    if not self._armed:
                        # first progress runs synchronously inside
                        # enqueue (the enqueue-progresses-once
                        # optimization): i.e. still on the flusher's
                        # critical path. Stay queued; dispatch on the
                        # next queue-serve pass.
                        self._armed = True
                        return
                    pq = self.progress_queue
                    if pq is not None and \
                            pq.higher_busy(getattr(self, "_pq_lane", 0)):
                        # latency-class traffic in flight: carrier
                        # construction (~0.2-0.5ms) must not occupy this
                        # WRR slot. Yield: bounded by the aging valve
                        # (measured from the FIRST yield, not task post:
                        # queue time before any hi traffic appeared is
                        # not starvation) so a busy hi lane can't starve
                        # bulk dispatch.
                        now = time.monotonic()
                        if self._defer_t0 is None:
                            self._defer_t0 = now
                        if now - self._defer_t0 < pq._age_s:
                            return
                    try:
                        self._coal._dispatch(self._members, self._reason)
                    finally:
                        self.status = Status.OK

                def cancel_fn(self) -> None:
                    # queue sweep (team destroy/fault/grow) cancelled the
                    # batch before dispatch: held members must reach a
                    # terminal state
                    st = getattr(self, "_cancel_status",
                                 Status.ERR_CANCELED)
                    failed = getattr(self, "failed_ranks", None)
                    for req in self._members:
                        task = req.task
                        if task.is_completed():
                            continue
                        if failed:
                            task.failed_ranks = set(failed)
                        task.cancel(st)

            cls._cls = _Impl
        return cls._cls(coal, members, reason)


class TeamCoalescer:
    """Per-team batcher: holds eligible member requests, seals batches
    at deterministic closure points, dispatches each batch as one fused
    generated collective (or falls back to individual posts when no
    program fits)."""

    def __init__(self, team, tl_team):
        self.team = team            # core Team
        self.tl_team = tl_team      # full-membership HostTlTeam
        self.pending: List[Any] = []     # held CollRequests, post order
        self._sig: Optional[Tuple] = None
        self._deadline = 0.0
        self._fused_seq = 0
        self._aborted = False

    # ------------------------------------------------------------ policy
    def eligible(self, args, mem_type, msgsize: int) -> bool:
        """Can this collective join a batch? Pure function of the args :
        identical on every rank. Checked once at init (after candidate
        selection, so with coalescing disabled OR ineligible the
        dispatch walk is untouched)."""
        from ..api.types import BufferInfo
        from ..constants import CollArgsFlags, MemoryType
        from ..ec.cpu import storage_dtype
        if args.coll_type != CollType.ALLREDUCE or \
                mem_type != MemoryType.HOST:
            return False
        if not (0 < msgsize <= LIMIT_BYTES):
            return False
        if args.op not in _FUSED_OPS:
            return False
        if args.is_persistent or (args.flags & CollArgsFlags.TIMEOUT):
            # persistent re-post lanes cache task identity; held members
            # are outside the progress queue so timeouts would not fire
            return False
        dst = args.dst
        if not isinstance(dst, BufferInfo):
            return False
        src = dst if args.is_inplace else args.src
        if not isinstance(src, BufferInfo):
            return False
        if isinstance(dst.datatype, GenericDataType) or \
                src.datatype != dst.datatype:
            return False
        count = int(dst.count)
        if count < 1 or int(src.count) != count:
            return False
        for bi in (src, dst):
            if not _host_buffer_ok(bi.buffer, count):
                return False
        try:
            np_dt = storage_dtype(dst.datatype)
        except Exception:  # noqa: BLE001 - unknown dtype -> not fusable
            return False
        return np_dt.itemsize * count == msgsize

    def _sig_of(self, args) -> Tuple:
        return (args.op, args.dst.datatype)

    # ------------------------------------------------------------ intake
    def add(self, req) -> Status:
        """Hold a posted member request (called from CollRequest.post
        after the per-request accounting ran). Seals the open batch
        first when this member cannot join it."""
        if self._aborted or self.team._shrunk:
            # raced a teardown: run the ordinary post
            return req.task.post()
        sig = self._sig_of(req.args)
        if self.pending and sig != self._sig:
            self.flush("signature")
        task = req.task
        # the held member is live for the user: IN_PROGRESS, aging from
        # now (complete() computes its duration from start_time)
        task.start_time = time.monotonic()
        task.status = Status.IN_PROGRESS
        task.super_status = Status.IN_PROGRESS
        if not self.pending:
            self._sig = sig
            self._deadline = task.start_time + WINDOW_S
        self.pending.append(req)
        # first test()/wait() on a held member seals the batch: a
        # program-order closure point (the caller moved from posting to
        # waiting). Instance attr shadows the class method (the tuner
        # `_tuner_post` pattern); flush() pops it.
        req.test = self._held_test(req)
        if len(self.pending) >= MAX_BATCH:
            self.flush("max-batch")
        return Status.OK

    def _held_test(self, req):
        def test() -> Status:
            self.flush("member-test")
            return req.test()   # class method again after the pop
        return test

    # ------------------------------------------------------------ flush
    def flush(self, reason: str = "explicit") -> None:
        """Seal the open batch (synchronous: program order on every
        rank) and hand it to a deferred-dispatch proxy in this team's
        own priority lane. Never raises: a fused dispatch failure
        degrades to individual posts."""
        members = self.pending
        if not members:
            return
        self.pending = []
        self._sig = None
        for req in members:
            req.__dict__.pop("test", None)
        if metrics.ENABLED:
            metrics.observe("qos_coalesce_batch", float(len(members)),
                            component="qos", coll="allreduce", alg=reason)
        if len(members) == 1:
            members[0].task.post()
            return
        task = _FusedDispatchTask(self, members, reason)
        task.progress_queue = self.team.context.progress_queue
        if task.progress_queue is None:
            # no queue to defer into (teardown-adjacent): dispatch here
            self._dispatch(members, reason)
            return
        task.post()

    def _dispatch(self, members, reason: str) -> None:
        """Pack and post the sealed batch as one fused carrier. Runs from
        the progress queue (the deferred tail of flush)."""
        if self._aborted or getattr(self.team, "_destroyed", False):
            # team went away between seal and dispatch: the members can
            # never ride a carrier: fail them like abort() would
            for req in members:
                if not req.task.is_completed():
                    req.task.cancel(Status.ERR_CANCELED)
            return
        # a member cancelled while held keeps its segment in the batch
        # (peers sealed the same membership); only its delivery skips
        from ..ec.cpu import storage_dtype
        op = members[0].args.op
        dt = members[0].args.dst.datatype
        np_dt = storage_dtype(dt)
        counts = [int(r.args.dst.count) for r in members]
        total = sum(counts)
        from ..dsl import fused
        tag = fused.FUSED_TAG_BASE + self._fused_seq
        packed = np.empty(total, dtype=np_dt)
        off = 0
        segs = []
        for req, cnt in zip(members, counts):
            a = req.args
            src = a.dst if a.is_inplace else a.src
            packed[off:off + cnt] = _flat(src.buffer, cnt, np_dt)
            segs.append((off, cnt))
            off += cnt
        carrier = fused.fused_allreduce_task(self.team, self.tl_team,
                                             packed, total, dt, op, tag)
        if carrier is None:
            # no verified program at this (n, count) shape: symmetric
            # across ranks (a pure function of team size and counts)
            for req in members:
                if not req.task.is_completed():
                    req.task.post()
            return
        self._fused_seq += 1
        carrier.coll_name = "allreduce"
        carrier.alg_name = f"coalesced[{len(members)}]"
        # internal + parentless -> complete() auto-finalizes the
        # carrier, returning its NativePlan to the team's plan cache;
        # without this every batch rebuilds the plan (~0.4ms, and the C
        # handle + scratch lease linger until GC)
        carrier.flags_internal = True
        carrier.progress_queue = self.team.context.progress_queue
        carrier.cb = self._unpack_cb(members, segs, packed, np_dt)
        if metrics.ENABLED:
            metrics.inc("qos_coalesce_fused", component="qos",
                        coll="allreduce", alg=reason)
        st = carrier.post()
        if isinstance(st, Status) and st.is_error:
            # carrier.post already completed the carrier -> the cb above
            # delivered the error to every member; nothing more to do
            logger.warning("fused batch post failed: %s", st.name)

    def _unpack_cb(self, members, segs, packed, np_dt):
        def cb(carrier, st: Status) -> None:
            failed = getattr(carrier, "failed_ranks", None)
            for req, (off, cnt) in zip(members, segs):
                task = req.task
                if task.is_completed():
                    continue   # cancelled while in flight
                if not st.is_error:
                    a = req.args
                    _flat(a.dst.buffer, cnt, np_dt)[:] = packed[off:off + cnt]
                elif failed:
                    task.failed_ranks = set(failed)
                task.complete(st)
        return cb

    # ------------------------------------------------------------ valves
    def step(self, now: float) -> None:
        """Window-expiry valve, driven from Context.progress()."""
        if self.pending and now >= self._deadline:
            self.flush("window")

    def abort(self, status: Status = Status.ERR_CANCELED,
              failed_ranks=None) -> None:
        """Fail every held member (team destroy / fault / membership
        retirement). In-flight fused carriers are swept by the caller's
        normal queue cancellation: they live in the progress queue and
        resolve to this team."""
        members = self.pending
        self.pending = []
        self._sig = None
        for req in members:
            req.__dict__.pop("test", None)
            task = req.task
            if task.is_completed():
                continue
            if failed_ranks:
                task.failed_ranks = set(failed_ranks)
            task.cancel(status)

    def detach(self) -> None:
        self._aborted = True
        oc = getattr(self.team.context, "_open_coalescers", None)
        if oc is not None and self in oc:
            oc.remove(self)


# ---------------------------------------------------------------------------
def maybe_attach(team) -> None:
    """Attach a coalescer to *team* at activation when the knob is on
    and the team has a full-membership host TL to dispatch fused
    batches on. No-op (and no per-post cost anywhere) otherwise."""
    if not ENABLED or team.size < 2:
        return
    if getattr(team, "priority", 1) >= 2:
        # latency-class teams post immediately: batching trades exactly
        # the latency they asked to keep
        return
    from ..dsl import fused
    tl = fused.find_host_tl_team(team)
    if tl is None:
        return
    coal = TeamCoalescer(team, tl)
    team.coalescer = coal
    ctx = team.context
    if getattr(ctx, "_open_coalescers", None) is None:
        ctx._open_coalescers = []
    ctx._open_coalescers.append(coal)
    logger.debug("coalescer attached: team %s limit=%dB window=%.0fus "
                 "max_batch=%d", team.id, LIMIT_BYTES, WINDOW_S * 1e6,
                 MAX_BATCH)


def flush_open(ctx, reason: str) -> None:
    """Flush every open coalescer in *ctx*: the cross-team valve a
    high-priority post pulls so its collective never waits out a bulk
    team's gather window."""
    for coal in list(getattr(ctx, "_open_coalescers", None) or ()):
        coal.flush(reason)
