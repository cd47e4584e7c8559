"""Collective dispatch — the hot path (UCC's ``ucc_collective_init``).

Memtype auto-detect via MC, the zero-size fast path with a stub task
(host memory only), the active-set restriction to bcast, the gate of
one-sided args, the score-map lookup with fallback at init and, once, at
run time, the datatype check of rooted collectives
(``UCC_CHECK_ASYMMETRIC_DT``), timeout stamping, persistent re-post, the
user callback, the request's metrics and profiling spans, and the tuner's
probe lane (``UCC_TUNER=online``, score/tuner.py).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import integrity
from ..api.types import BufferInfo, BufferInfoV, CollArgs, coll_args_msgsize
from ..constants import (CollArgsFlags, CollType, DataType, EventType,
                         GenericDataType, MemoryType, ReductionOp,
                         coll_type_str)
from ..mc.base import detect_mem_type
from ..obs import metrics
from ..schedule.schedule import Schedule
from ..schedule.task import CollTask
from ..status import RankFailedError, Status, UccError
from ..utils import profiling
from ..utils.log import get_logger
from .team import Team

logger = get_logger("coll")


class _DtCheckTask(CollTask):
    """Datatype consistency check of a rooted collective (UCC's
    ucc_service_coll dt check): a service allreduce(MIN) over [dt, -dt,
    mem, -mem]; if min(dt) != -min(-dt) some rank passed another datatype
    (or memory type), and the collective ends ERR_INVALID_PARAM on every
    rank instead of corrupting data."""

    def __init__(self, team: Team, dt_id: int, mem_id: int):
        super().__init__(team=team)
        self.core_team = team
        self.vec = np.array([dt_id, -dt_id, mem_id, -mem_id], dtype=np.int64)
        self._svc = None

    def post_fn(self) -> Status:
        self._svc = self.core_team.service_team.service_allreduce(
            self.vec, ReductionOp.MIN)
        self._svc.post()
        return Status.OK

    def progress_fn(self) -> None:
        svc = self._svc
        if svc is None or not svc.is_completed():
            return
        self._svc = None
        svc.finalize()
        if svc.super_status.is_error:
            self.status = svc.super_status
            return
        r = svc.result
        if int(r[0]) != -int(r[1]) or int(r[2]) != -int(r[3]):
            logger.error("asymmetric datatype/memtype detected across team "
                         "%s ranks", self.core_team.id)
            self.status = Status.ERR_INVALID_PARAM
            return
        self.status = Status.OK


@dataclass
class InitArgs:
    """ucc_base_coll_args_t: resolved args handed to algorithm inits."""

    args: CollArgs
    team: Team
    mem_type: MemoryType
    msgsize: int


class _StubTask(CollTask):
    """Zero-size fast path: completes at post."""

    def post_fn(self) -> Status:
        self.status = Status.OK
        return Status.OK


#: task failure statuses eligible for the runtime fallback: local
#: resource and support failures. Timeouts and cancels are excluded (peers
#: were engaged already), as is INVALID_PARAM (another algorithm will not
#: fix the caller's arguments).
_FALLBACK_ELIGIBLE = frozenset((Status.ERR_NOT_SUPPORTED,
                                Status.ERR_NO_RESOURCE,
                                Status.ERR_NO_MESSAGE,
                                Status.ERR_NO_MEMORY))


class CollRequest:
    """ucc_coll_req_h: post/test/finalize + persistent re-post."""

    #: tuner probe lane (score/tuner.py): while a (coll, mem, size-bucket)
    #: key is still exploring, ``_bind_tuner`` shadows the class ``post``
    #: with ``_tuner_post`` as an INSTANCE attribute, so UCC_TUNER=off adds
    #: no per-post branch
    _tuner = None
    #: flight recorder (obs/flight.py): the context's recorder, bound once
    #: at init; None when UCC_FLIGHT=n, so a post pays one branch
    _flight = None
    _flight_msgsize = 0
    #: small-collective coalescer (core/coalesce.py): bound at init for
    #: eligible members of a UCC_COALESCE team; post() hands the task to
    #: the batcher instead of the wire. The class-attr None keeps the off
    #: path at one branch
    _coalesce = None
    #: latency valve bound on priority >= 2 teams' requests while any
    #: coalescer is attached in the context: posting flushes the open
    #: batches, so this collective never waits out a bulk gather window
    _coal_flush = None
    #: sampled result attestation (integrity/): bound by collective_init
    #: at the deterministic UCC_INTEGRITY_SAMPLE cadence under
    #: UCC_INTEGRITY=verify; test() holds the request IN_PROGRESS until
    #: the cross-rank digest exchange settles. None when off
    _attest = None

    def __init__(self, task: CollTask, team: Team, args: CollArgs):
        self.task = task
        self.team = team
        self.args = args
        fr = team.context.flight
        if fr is not None:
            self._flight = fr
        self._posted = False
        self._finalized = False
        #: runtime fallback chain: (init_args, [remaining MsgRange]), set
        #: by collective_init for plain non-persistent requests
        self._fallback = None
        self._fb_used = False
        self._persistent = args.is_persistent
        self._trace = bool(team.context.lib.config.coll_trace)
        # persistent fast re-post lane (TL opt-in, e.g. DeviceCollTask):
        # eligibility probed once on the first re-post, after the first
        # full post has warmed the TL's launch caches
        self._fast = None if (self._persistent and not self._trace and
                              hasattr(task, "fast_repost")) else False

    @property
    def status(self) -> Status:
        return self.task.super_status

    @property
    def failed_ranks(self):
        """For an ERR_RANK_FAILED outcome, the failed context ranks its
        cancellation named, else the context health registry's view; None
        when no failure has been attributed."""
        fr = getattr(self.task, "failed_ranks", None)
        if fr:
            return sorted(int(r) for r in fr)
        # the registry only for a rank-failure outcome: a healthy request
        # on an unaffected team reports None even when some other team's
        # rank is known dead
        if self.task.super_status == Status.ERR_RANK_FAILED:
            reg = getattr(self.team.context, "health", None)
            if reg is not None and reg.dead:
                return sorted(reg.dead_set())
        return None

    def post(self) -> Status:
        """ucc_collective_post."""
        st = self.task.super_status
        if self._posted:
            if st == Status.IN_PROGRESS:
                raise UccError(Status.ERR_INVALID_PARAM,
                               "collective re-posted while in progress")
            if not self._persistent:
                raise UccError(Status.ERR_INVALID_PARAM,
                               "re-post of non-persistent collective")
            if self._fast or (self._fast is None and st == Status.OK and
                              self._probe_fast()):
                # the probe caches STRUCTURAL eligibility; observers
                # attached between posts (an EE's chained cb, a triggered
                # proxy, schedule events) divert this round to the generic
                # path, which runs them
                task = self.task
                if task.cb is None and task.triggered_task is None and \
                        task.schedule is None and not task.timeout and \
                        not any(task.em.listeners):
                    if metrics.ENABLED:
                        metrics.inc("coll_posted", component="core",
                                    coll=task.coll_name or "",
                                    alg=task.alg_name or "")
                        metrics.inc("coll_fast_repost", component="core",
                                    coll=task.coll_name or "",
                                    alg=task.alg_name or "")
                    if self._flight is not None:
                        self._flight_post(task)
                    return task.fast_repost()
            self.task.reset()
        self._posted = True
        self.task.progress_queue = self.team.context.progress_queue
        if metrics.ENABLED:
            metrics.inc("coll_posted", component="core",
                        coll=self.task.coll_name or "",
                        alg=self.task.alg_name or "")
        if self._flight is not None:
            self._flight_post(self.task)
        if self._trace:
            logger.info("coll post: %s team %s seq %d",
                        coll_type_str(self.args.coll_type), self.team.id,
                        self.task.seq_num)
        if self._coalesce is not None:
            # hand the fully accounted post (metrics, flight and trace
            # above keep per-request attribution) to the team's batcher
            return self._coalesce.add(self)
        if self._coal_flush is not None:
            self._coal_flush()
        return self.task.post()

    def _flight_post(self, task: CollTask) -> None:
        """Flight-ring post event. The per-team ``flight_seq`` advances in
        program order, the same on every member by UCC's ordered-issue
        rule: the key the diagnosis joins ranks on (obs/diagnose.py)."""
        team = self.team
        fs = team.flight_seq + 1
        team.flight_seq = fs
        self._flight.post(team.id, team.epoch, fs, task.seq_num,
                          task.coll_name or "", task.alg_name or "",
                          self._flight_msgsize)

    def _probe_fast(self) -> bool:
        try:
            self._fast = bool(self.task.fast_repost_ok())
        except Exception:  # noqa: BLE001 - opt-in probe must never break post
            self._fast = False
        return self._fast

    # ------------------------------------------------------------------
    # tuner probe lane (UCC_TUNER=online; score/tuner.py). While bound the
    # request never takes the persistent fast re-post lane: every post
    # goes through the task's own post and completes through the progress
    # queue, where the timing callback runs. A swapped-in task takes a new
    # tag of its TL, so a device TL's launch cache (keyed by tag) never
    # serves it another task's pointer table.
    def _bind_tuner(self, tuner, key, init_args, candidates,
                    chosen) -> None:
        self._tuner = tuner
        self._tuner_key = key
        self._tuner_ia = init_args
        self._tuner_cands = candidates
        self._tuner_cur = chosen
        self._tuner_user_cb = self.task.cb   # restore target on unbind
        self._tuner_wrapped_cb = None
        self.post = self._tuner_post         # shadow the class method

    def _tuner_unbind(self) -> None:
        if self._tuner_wrapped_cb is not None and \
                self.task.cb is self._tuner_wrapped_cb:
            self.task.cb = self._tuner_user_cb
        self._tuner_wrapped_cb = None
        self._tuner = None
        self.__dict__.pop("post", None)      # back to the class post
        # the fast lane is probed afresh on the task the lane leaves
        self._fast = None if (self._persistent and not self._trace and
                              hasattr(self.task, "fast_repost")) else False

    def _tuner_swap_task(self, cand, new_task) -> None:
        old = self.task
        try:
            old.finalize()
        except Exception:  # noqa: BLE001 - probe teardown is best-effort
            logger.debug("finalize of the replaced task raised",
                         exc_info=True)
        new_task.coll_name = old.coll_name
        new_task.alg_name = str(cand.alg_name or cand.team)
        new_task.timeout = old.timeout
        _attach_user_opts(new_task, self.args)
        if profiling.ENABLED:
            _attach_profiling(new_task, self.args.coll_type)
        self.task = new_task
        self._tuner_cur = cand
        self._tuner_user_cb = new_task.cb
        self._tuner_wrapped_cb = None

    def _tuner_swap_to_winner(self, winner) -> None:
        """Re-init the frozen winner under this request, so later posts
        run it without another collective_init. An init failure
        propagates: every peer switches to the team's winner at this same
        post, so a rank that cannot run it must fail loudly — keeping
        another algorithm would deadlock the team."""
        from ..score.tuner import cand_label
        if cand_label(self._tuner_cur) == winner:
            return
        for cand in self._tuner_cands:
            if cand.init is None or cand_label(cand) != winner:
                continue
            new_task = cand.init(self._tuner_ia, cand.team)
            self._tuner_swap_task(cand, new_task)
            return

    def _tuner_post(self) -> Status:
        """Exploration-round post: deterministic candidate rotation with
        post -> completion timing, until the rank-0 decision freezes the
        key and the request drops back to the plain post."""
        from ..score.tuner import cand_label
        task = self.task
        st = task.super_status
        if self._posted and st == Status.IN_PROGRESS:
            raise UccError(Status.ERR_INVALID_PARAM,
                           "collective re-posted while in progress")
        if self._posted and not self._persistent:
            # the class post's user-error contract; re-running would also
            # take an exploration slot on this rank only and desync the
            # per-key counters
            raise UccError(Status.ERR_INVALID_PARAM,
                           "re-post of non-persistent collective")
        if task.triggered_task is not None:
            # an EE dispatches this request and observes THIS task: keep
            # the plain lifecycle (EE use is the same on every rank, so
            # leaving without a rotation slot keeps the counters aligned)
            self._tuner_unbind()
            return self.post()
        tuner = self._tuner
        key = self._tuner_key
        frozen, winner = tuner.poll(key)
        if frozen:
            if winner is not None:
                self._tuner_swap_to_winner(winner)
            self._tuner_unbind()
            return self.post()
        if not tuner.claim(key, self):
            # another un-finalized request drives this key (overlapped
            # posts): the key froze to the static defaults
            self._tuner_unbind()
            return self.post()
        new_task = None
        chosen = None
        for cand in tuner.explore_order(key, self._tuner_cands):
            if cand is self._tuner_cur:
                new_task, chosen = task, cand
                break
            try:
                new_task = cand.init(self._tuner_ia, cand.team)
            except UccError as e:
                if e.status != Status.ERR_NOT_SUPPORTED:
                    # only NOT_SUPPORTED is the same on every rank (a
                    # function of the args); a rank-local failure must
                    # surface, not shift this rank's rotation
                    raise
                tuner.record_unsupported(key, cand)
                continue
            chosen = cand
            break
        if new_task is None:
            # nothing explorable survived init: leave the probe lane
            self._tuner_unbind()
            return self.post()
        if new_task is not task:
            self._tuner_swap_task(chosen, new_task)
        elif self._posted:
            new_task.reset()
        self._posted = True
        new_task.progress_queue = self.team.context.progress_queue
        if metrics.ENABLED:
            metrics.inc("coll_posted", component="core",
                        coll=new_task.coll_name or "",
                        alg=new_task.alg_name or "")
        if self._flight is not None:
            self._flight_post(new_task)
        if self._trace:
            logger.info("coll post (tuner explore): %s alg %s team %s "
                        "seq %d", new_task.coll_name, new_task.alg_name,
                        self.team.id, new_task.seq_num)
        label = cand_label(chosen)
        t0 = time.perf_counter()
        user_cb = self._tuner_user_cb

        def cb(t, s, _t0=t0):
            tuner.record(key, label, time.perf_counter() - _t0, s)
            if user_cb is not None:
                user_cb(t, s)
        new_task.cb = cb
        self._tuner_wrapped_cb = cb
        return new_task.post()

    def test(self) -> Status:
        st = self.task.super_status
        if st == Status.IN_PROGRESS and self._fast:
            # fast-posted tasks are on no progress queue: their owner
            # observes completion here
            st = self.task.fast_test()
        if st.is_error and self._try_runtime_fallback():
            return Status.IN_PROGRESS
        if st == Status.OK and self._attest is not None:
            # sampled result attestation: the collective is done, but the
            # request stays IN_PROGRESS until every live rank's result
            # digest has been exchanged and compared (raises
            # DataCorruptedError on a digest minority)
            return integrity.attest_test(self)
        return st

    def _try_runtime_fallback(self) -> bool:
        """The score map's fallback walk, extended to run time: a posted
        task that failed with a local resource error BEFORE committing any
        data is re-initialized once on the next candidate of the chain and
        re-posted, invisibly to the caller (test() keeps returning
        IN_PROGRESS across the swap). A task that sent or received
        anything is not retried: peers may have consumed part of the first
        attempt. Device tasks keep ``data_committed`` True, so a failed
        kernel launch is never retried."""
        fb = self._fallback
        task = self.task
        if fb is None or self._fb_used or not self._posted or \
                self._persistent or task.data_committed or \
                task.super_status not in _FALLBACK_ELIGIBLE:
            return False
        if task.cb is not None or any(task.em.listeners) or \
                task.triggered_task is not None:
            # observers (a user callback, event subscribers, an EE) saw the
            # first attempt's error completion already: a fallback would
            # signal one collective twice (error, then success)
            return False
        init_args, remaining = fb
        for cand in remaining:
            if cand.init is None:
                continue
            try:
                new_task = cand.init(init_args, cand.team)
            except UccError:
                continue
            self._fb_used = True
            new_task.coll_name = task.coll_name
            new_task.alg_name = str(cand.alg_name or cand.team)
            new_task.timeout = task.timeout
            new_task.progress_queue = self.team.context.progress_queue
            logger.warning(
                "runtime fallback: %s alg %s failed (%s) before data "
                "commit; retrying once on %s", task.coll_name,
                task.alg_name, task.super_status.name, new_task.alg_name)
            if metrics.ENABLED:
                metrics.inc("coll_fallback_runtime", component="core",
                            coll=new_task.coll_name or "",
                            alg=new_task.alg_name or "")
            try:
                task.finalize()
            except Exception:  # noqa: BLE001 - the old task's teardown is
                # best-effort; the replacement is wired in already
                logger.exception("finalize of the failed task raised")
            self.task = new_task
            new_task.post()
            return True
        return False

    def wait(self, timeout: float = 60.0) -> Status:
        deadline = time.monotonic() + timeout
        while self.test() == Status.IN_PROGRESS:
            self.team.context.progress()
            if time.monotonic() > deadline:
                # cancel, don't just raise: a task left IN_PROGRESS would
                # be orphaned in the progress queue and un-finalizable
                self.task.cancel(Status.ERR_TIMED_OUT)
                raise UccError(Status.ERR_TIMED_OUT,
                               "CollRequest.wait timed out")
        return self.test()

    def finalize(self) -> Status:
        """ucc_collective_finalize."""
        if self.task.super_status == Status.IN_PROGRESS:
            raise UccError(Status.ERR_INVALID_PARAM,
                           "finalize of in-progress collective")
        # program-order marker of the tuner's per-key claim(): a finalized
        # request posts no more, so a later request on its key is
        # sequential, not overlapped
        self._finalized = True
        return self.task.finalize()


def _resolve_mem_type(args: CollArgs) -> MemoryType:
    """Memtype auto-detect. Every buffer gets its mem_type resolved; the
    collective's selection memtype prefers dst, else src."""
    chosen: Optional[MemoryType] = None
    for bi in (args.dst, args.src):
        if bi is None:
            continue
        if bi.mem_type is None:
            mt = detect_mem_type(bi.buffer)
            if mt != MemoryType.UNKNOWN:
                bi.mem_type = mt
        if chosen is None and bi.mem_type is not None:
            chosen = bi.mem_type
    return chosen if chosen is not None else MemoryType.HOST


def _is_zero_size(args: CollArgs) -> bool:
    ct = args.coll_type
    if ct in (CollType.BARRIER, CollType.FANIN, CollType.FANOUT):
        return False
    for bi in (args.src, args.dst):
        if bi is None:
            continue
        if isinstance(bi, BufferInfoV):
            if bi.counts and any(int(c) > 0 for c in bi.counts):
                return False
        elif isinstance(bi, BufferInfo):
            if bi.count > 0:
                return False
    return True


def collective_init(args: CollArgs, team: Team) -> CollRequest:
    """ucc_collective_init."""
    if team._shrunk:
        # the old epoch's tag space is fenced: collectives move to the
        # successor team the shrink or grow request returned
        how = team._retired_by or "shrunk"
        raise RankFailedError(
            f"team {team.id} was retired by a membership {how}; post on "
            "the successor team")
    if team.score_map is None:
        raise UccError(Status.ERR_INVALID_PARAM, "team is not active")
    ct = args.coll_type
    if args.active_set is not None and ct != CollType.BCAST:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       "active sets supported for bcast only")
    mem_type = _resolve_mem_type(args)
    onesided_args = (args.global_work_buffer is not None
                     or args.src_memh is not None
                     or args.dst_memh is not None
                     or bool(args.flags & CollArgsFlags.MEM_MAPPED_BUFFERS))
    if onesided_args and mem_type == MemoryType.CUDA:
        # one-sided args on host memory go on to the score map, where the
        # host TLs serve them (tl/host/onesided.py); on device memory they
        # are refused, as the JAX package refuses them on TPU memory
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       "one-sided (global_work_buffer / mem-mapped) "
                       "collectives are host-memory only")
    if _is_zero_size(args) and mem_type == MemoryType.HOST and \
            not onesided_args:
        # zero-size fast path — HOST memory only: device collectives meet
        # in a rendezvous, where a rank that stubs out would desync the
        # team's deposit count. One-sided collectives are excluded: peers
        # count this rank's puts, so a zero-count rank must still post
        task: CollTask = _StubTask()
        task.coll_name = coll_type_str(ct)
        task.alg_name = "zero_size_stub"
        _attach_user_opts(task, args)
        return CollRequest(task, team, args)

    msgsize = coll_args_msgsize(args, team.size, team.rank)
    init_args = InitArgs(args=args, team=team, mem_type=mem_type,
                         msgsize=msgsize)
    bias = team.rank_bias
    if bias is not None:
        # promote a staged straggler table at its deterministic switch
        # index: every rank ticks here in program order over the same
        # flight_seq sequence, so the flagged set (and the candidate
        # order below) changes on the same post everywhere
        bias.tick(team.flight_seq)
    candidates = team.score_map.lookup(ct, mem_type, msgsize, bias=bias)
    task, chosen = team.score_map.init_coll(ct, mem_type, msgsize, init_args,
                                            candidates)
    task.coll_name = coll_type_str(ct)
    task.alg_name = str(chosen.alg_name or chosen.team)
    if team.context.lib.config.coll_trace:
        logger.info("coll init: %s/%s msgsize %d -> %s (score %d) team %s",
                    coll_type_str(ct), mem_type.name.lower(), msgsize,
                    chosen.alg_name or chosen.team, chosen.score, team.id)
    inner = task
    task = _maybe_wrap_dt_check(task, args, team, mem_type)
    if task is not inner:
        task.coll_name = inner.coll_name
        task.alg_name = inner.alg_name
    _attach_user_opts(task, args)
    if profiling.ENABLED:
        _attach_profiling(task, ct)
    req = CollRequest(task, team, args)
    req._flight_msgsize = msgsize
    tuner = team.tuner
    coal = team.coalescer
    if coal is None and team.priority >= 2 and \
            getattr(team.context, "_open_coalescers", None):
        # latency-class tenant while bulk teams batch: posting this
        # request seals their open windows (core/coalesce.py valve)
        from .coalesce import flush_open
        req._coal_flush = (lambda ctx=team.context:
                           flush_open(ctx, "priority-post"))
    if tuner is not None and task is inner and args.active_set is None \
            and tuner.wants(ct, mem_type, msgsize, candidates):
        # tuner probe lane (UCC_TUNER=online): the first UCC_TUNER_SAMPLES
        # posts of this (coll, mem, size-bucket) rotate through the
        # candidates, then the rank-0 winner freezes. Plain tasks only (a
        # dt-checked schedule's identity is not the algorithm's), and not
        # with the runtime fallback: the lane owns the task's identity
        req._bind_tuner(tuner, tuner.key_for(ct, mem_type, msgsize),
                        init_args, candidates, chosen)
    elif coal is not None and task is inner and \
            coal.eligible(args, mem_type, msgsize):
        # small-collective coalescing (UCC_COALESCE, core/coalesce.py):
        # post() hands this member to the team's batcher. Bound AFTER the
        # candidate walk, so candidate lists and the chosen algorithm are
        # the same with the knob off, and exclusive of the tuner and
        # runtime-fallback lanes (both re-post task identity at rank-local
        # times, which would skew wire-tag parity for a held member)
        req._coalesce = coal
    elif task is inner and not args.is_persistent:
        # keep the chain's tail for the runtime fallback; a persistent
        # request's re-post lanes cache the task's identity, and a
        # dt-checked schedule's failure status is the schedule's
        try:
            rest = candidates[candidates.index(chosen) + 1:]
        except ValueError:
            rest = []
        if rest:
            req._fallback = (init_args, rest)
    if coal is not None and req._coalesce is None and coal.pending:
        # a same-team post that cannot join the open batch is a
        # program-order closure point: seal it (every rank inits this
        # collective at the same point by the ordered-issue rule)
        coal.flush("ineligible")
    if integrity.VERIFY and task is inner and team.size > 1 and \
            args.active_set is None and mem_type == MemoryType.HOST and \
            (ct & integrity.ATTEST_COLLS) and req._coalesce is None and \
            req._tuner is None:
        # sampled cross-rank result attestation (UCC_INTEGRITY=verify):
        # binds _attest at the deterministic UCC_INTEGRITY_SAMPLE cadence.
        # Every predicate is rank-invariant (coll type, active set, team
        # size, memory type, wrap status; tuner and coalescer binding by
        # the ordered-issue and tag-parity rules), so all ranks tick the
        # per-team attestation counter in lockstep
        integrity.bind(req, team)
    return req


def _maybe_wrap_dt_check(task: CollTask, args: CollArgs, team: Team,
                         mem_type: MemoryType) -> CollTask:
    """Under UCC_CHECK_ASYMMETRIC_DT, a rooted collective (gather(v),
    scatter(v), bcast, reduce) of a multi-rank team with a service team
    becomes a schedule: the datatype check, then the collective. Active
    sets are excluded (only the subset posts, the check is team-wide), as
    are generic datatypes and zero-size calls (the stub path)."""
    checked = (CollType.GATHER | CollType.GATHERV | CollType.SCATTER
               | CollType.SCATTERV | CollType.BCAST | CollType.REDUCE)
    if not (args.coll_type & checked) or team.size <= 1 or \
            args.active_set is not None:
        return task
    if not team.context.lib.config.check_asymmetric_dt:
        return task
    if team.service_team is None or \
            not hasattr(team.service_team, "service_allreduce"):
        return task
    bi = args.src if args.src is not None else args.dst
    if bi is None or isinstance(bi.datatype, GenericDataType):
        return task
    sched = Schedule(team=team, args=args)
    chk = _DtCheckTask(team, int(DataType(bi.datatype)) + 1,
                       int(mem_type) + 1)
    sched.add_task(chk)
    sched.add_dep_on_schedule_start(chk)
    sched.add_task(task)
    task.subscribe_dep(chk, EventType.EVENT_COMPLETED)
    return sched


def _attach_profiling(task: CollTask, ct: CollType) -> None:
    name = coll_type_str(ct)
    # the request's span id IS the task's seq_num; the task's own span
    # carries the same id, so one collective's request -> task lifetime
    # reassembles offline
    profiling.request_new(name, task.seq_num, alg=task.alg_name or "")
    prev = task.cb

    def cb(t, st):
        profiling.request_complete(name, t.seq_num, status=st.name)
        if prev is not None:
            prev(t, st)
    task.cb = cb


def _attach_user_opts(task: CollTask, args: CollArgs) -> None:
    if args.flags & CollArgsFlags.TIMEOUT and args.timeout > 0:
        task.timeout = args.timeout
    if args.cb is not None:
        task.cb = args.cb
