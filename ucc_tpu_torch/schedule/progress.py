"""Progress queues.

UCC's ucc_progress_queue_{st,mt}: the single-threaded queue walks enqueued
tasks calling their progress fn, completing finished ones and detecting
per-task timeouts; the MT variant locks. Enqueue progresses the task once
immediately so fast ops never hit the queue.

Priority lanes: the queue is split into ``NUM_LANES`` deques indexed by the
owning team's priority class (``UCC_TEAM_PRIORITY`` /
``TeamParams.priority``; 0 = bulk lowest, 3 = latency highest). Each pass
services lanes high to low. When a higher lane is non-empty, lower lanes
are capped to their weighted round-robin share (``UCC_QOS_WEIGHTS``) per
pass; deferred tasks that have waited longer than the aging threshold
(``UCC_QOS_AGE_MS``) are serviced regardless of the cap, so a saturating
high-priority stream can slow bulk traffic but never starve it.
Single-lane workloads (every team at the default priority) drain exactly
as one plain queue would.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Deque, List

from ..fault import health
from ..fault import inject as fault
from ..obs import flight, metrics, watchdog
from ..status import Status
from ..utils.log import get_logger
from .task import CollTask

logger = get_logger("schedule")

#: priority classes: 0 = bulk (lowest) .. 3 = latency (highest)
NUM_LANES = 4
#: default team priority class (middle of the ladder)
DEFAULT_PRIORITY = 1


def _parse_weights(spec: str) -> List[int]:
    """"1,2,4,8" -> per-lane WRR caps (services per pass when a higher
    lane is non-empty). Malformed specs fall back to the default."""
    try:
        w = [max(1, int(x)) for x in spec.split(",")]
    except ValueError:
        w = []
    if len(w) < NUM_LANES:
        w = [1, 2, 4, 8]
    return w[:NUM_LANES]


def _resolve_knobs():
    env = os.environ
    weights = _parse_weights(env.get("UCC_QOS_WEIGHTS", "1,2,4,8"))
    try:
        age_s = float(env.get("UCC_QOS_AGE_MS", "10")) / 1e3
    except ValueError:
        age_s = 0.010
    return weights, max(age_s, 0.0)


def clamp_priority(p) -> int:
    try:
        return min(max(int(p), 0), NUM_LANES - 1)
    except (TypeError, ValueError):
        return DEFAULT_PRIORITY


def _task_lane(task: CollTask) -> int:
    """Priority lane of a task = its owning CORE team's priority class,
    cached on the task (a task never migrates teams)."""
    lane = task.__dict__.get("_pq_lane")
    if lane is None:
        core = getattr(task.team, "core_team", task.team)
        lane = clamp_priority(getattr(core, "priority", DEFAULT_PRIORITY))
        task._pq_lane = lane
    return lane


class ProgressQueue:
    """Single-threaded progress queue with priority lanes."""

    def __init__(self):
        self._lanes: List[Deque[CollTask]] = \
            [deque() for _ in range(NUM_LANES)]
        #: extra progress callbacks registered by components (the analog of
        #: ucc_context_progress_register)
        self._progress_fns: List[Callable[[], None]] = []
        self._throttle = 0
        self._throttle_period = 64
        self._weights, self._age_s = _resolve_knobs()

    # ------------------------------------------------------------------
    @property
    def _q(self):
        """Flat snapshot of every lane, highest priority first: what the
        watchdog and the fault-tolerance cancel sweeps walk."""
        return tuple(t for lane in reversed(self._lanes) for t in lane)

    def register_progress_fn(self, fn: Callable[[], None]) -> None:
        self._progress_fns.append(fn)

    def deregister_progress_fn(self, fn: Callable[[], None]) -> None:
        if fn in self._progress_fns:
            self._progress_fns.remove(fn)

    def enqueue(self, task: CollTask) -> None:
        task.progress_queue = self
        task.progress()
        if task.status != Status.IN_PROGRESS:
            if not task.is_completed():
                task.complete()
            return
        task._pq_enq = task._pq_last = time.monotonic()
        self._lanes[_task_lane(task)].append(task)

    def _first_service(self, task: CollTask, lane: int, now: float) -> None:
        """The task leaves the queued state for the first time: a wait
        past the aging bound becomes a ``qos:qwait:pN`` stage completion
        on the flight ring, so the diagnosis can name the team and lane
        whose traffic sat queued."""
        wait = now - task._pq_enq
        del task._pq_enq
        if flight.ENABLED and wait > self._age_s and \
                task.coll_name is not None:
            core = getattr(task.team, "core_team", task.team)
            rec = getattr(getattr(core, "context", None), "flight", None)
            if rec is not None:
                rec.complete(getattr(core, "id", None),
                             getattr(core, "epoch", 0), task.seq_num,
                             task.coll_name, task.alg_name,
                             f"qos:qwait:p{lane}", wait, "OK")

    # ------------------------------------------------------------------
    def _serve(self, task: CollTask, lane: int, now: float) -> bool:
        """Progress one queued task; True when it left the queue."""
        if task.is_completed():
            return True
        if "_pq_enq" in task.__dict__:
            self._first_service(task, lane, now)
        task._pq_last = now
        if task.check_timeout(now):
            task.cancel(Status.ERR_TIMED_OUT)
            return True
        try:
            task.progress()
        except Exception as e:  # noqa: BLE001 - a broken task must not
            # kill an unrelated caller's progress loop; fail it instead,
            # keeping the real exception on task.exc
            task.exc = e
            logger.exception(
                "progress: task %s seq %d (coll=%s alg=%s) raised; "
                "failing with ERR_NO_MESSAGE", type(task).__name__,
                task.seq_num, task.coll_name or "?",
                task.alg_name or "?")
            task.complete(Status.ERR_NO_MESSAGE)
            return True
        if task.status != Status.IN_PROGRESS:
            if not task.is_completed():
                task.complete()
            return True
        self._lanes[lane].append(task)
        return False

    def progress(self) -> int:
        """One pass over registered fns + queued tasks; returns number of
        tasks completed this pass."""
        depth = sum(len(q) for q in self._lanes)
        # throttle component progress fns when queue is empty
        if depth or self._throttle == 0:
            for fn in self._progress_fns:
                fn()
        self._throttle = (self._throttle + 1) % self._throttle_period
        if metrics.ENABLED:
            # a deep queue is the first visible symptom of a stall; the
            # mailbox backlogs are sampled beside it
            metrics.gauge("progress_queue_depth", depth,
                          component="schedule")
            metrics.sample()
        if watchdog.ENABLED:
            # at most one scan a second: one-shot dumps for tasks past
            # the soft deadline; with UCC_WATCHDOG_ACTION=cancel|abort,
            # cancels tasks past the hard deadline
            watchdog.check(self)
        if fault.ENABLED:
            # release injected delayed deliveries that have come due
            fault.progress()
        if health.ENABLED:
            # UCC_FT=shrink: heartbeat and peer-liveness scan; cancels
            # tasks that depend on failed ranks with ERR_RANK_FAILED
            health.check(self)
        if not depth:
            return 0
        completed = 0
        now = time.monotonic()
        # highest non-empty lane: only lanes BELOW it are WRR-capped, so
        # a single-lane workload drains exactly like a plain queue
        top = NUM_LANES - 1
        while top > 0 and not self._lanes[top]:
            top -= 1
        for lane in range(NUM_LANES - 1, -1, -1):
            q = self._lanes[lane]
            n = len(q)
            if not n:
                continue
            cap = n if lane >= top else self._weights[lane]
            served = 0
            for _ in range(n):
                task = q.popleft()
                if served < cap:
                    served += 1
                    if self._serve(task, lane, now):
                        completed += 1
                    continue
                # over the WRR cap: a task past the anti-starvation bound
                # (time since its last service) is serviced anyway
                if now - task.__dict__.get("_pq_last", now) > self._age_s:
                    if self._serve(task, lane, now):
                        completed += 1
                    continue
                q.append(task)
        return completed

    def __len__(self) -> int:
        return sum(len(q) for q in self._lanes)


class ProgressQueueMT(ProgressQueue):
    """Locked variant for ThreadMode.MULTIPLE."""

    def __init__(self):
        super().__init__()
        self._lock = threading.RLock()

    def enqueue(self, task: CollTask) -> None:
        with self._lock:
            super().enqueue(task)

    def progress(self) -> int:
        with self._lock:
            return super().progress()
