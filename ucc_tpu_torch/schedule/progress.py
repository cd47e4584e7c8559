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

QoS accounting: queue-wait (enqueue -> first service) is split from
service time per team: ``qos_queue_wait_us`` histograms keyed by
team/lane, a ``progress_starvation_max_ms`` gauge, a priority-inversion
counter (a high-lane task that waited past the aging threshold while
lower-lane tasks were serviced), and per-lane depth gauges. Waits past
the aging threshold are also recorded on the flight ring as
``qos:qwait:pN`` stage completions so ``ucc_fr`` can name the team/lane
of queue-wait outliers.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List

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


_WEIGHTS, _AGE_S = _resolve_knobs()


def configure(weights=None, age_ms=None) -> None:
    """Test/tool hook: override the QoS knobs after import (existing
    queues pick the new values up on construction only)."""
    global _WEIGHTS, _AGE_S
    if weights is not None:
        _WEIGHTS = _parse_weights(weights) if isinstance(weights, str) \
            else list(weights)[:NUM_LANES]
    if age_ms is not None:
        _AGE_S = max(float(age_ms) / 1e3, 0.0)


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
        self._weights = list(_WEIGHTS)
        self._age_s = _AGE_S
        #: cumulative services per lane (priority-inversion detection:
        #: tasks snapshot the below-their-lane sum at enqueue)
        self._svc_count = [0] * NUM_LANES
        #: qos counters for the collector fold-in (qos_snapshot)
        self.inversions = 0
        self.starvation_max_s = 0.0
        #: team id -> [n, sum_wait_s, max_wait_s] since last snapshot
        self._team_wait: Dict[int, List[float]] = {}

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

    def higher_busy(self, lane: int) -> bool:
        """Queued work in any lane strictly above *lane*? Deferrable
        bulk tasks (the coalescer's dispatch proxies) poll this to yield
        their WRR slot while latency-class traffic is in flight."""
        return any(self._lanes[lv] for lv in range(lane + 1, NUM_LANES))

    def enqueue(self, task: CollTask) -> None:
        task.progress_queue = self
        self._finish_or_queue(task, queue=True)

    def _finish_or_queue(self, task: CollTask, queue: bool) -> None:
        task.progress()
        if task.status != Status.IN_PROGRESS:
            if not task.is_completed():
                task.complete()
        elif queue:
            task._pq_enq = task._pq_last = time.monotonic()
            lane = _task_lane(task)
            # below-lane service snapshot: if lower lanes advance while
            # this task waits past the aging bound, that's an inversion
            task._pq_low_snap = sum(self._svc_count[:lane])
            self._lanes[lane].append(task)

    def _first_service(self, task: CollTask, lane: int, now: float) -> None:
        """QoS split: the task leaves the queued state for the first
        time: everything before this instant is queue wait, everything
        after is service. Records per-team wait, the inversion counter,
        and (for waits past the aging bound) a ``qos:qwait:pN`` stage
        completion on the flight ring, so the diagnosis can name the
        team and lane whose traffic sat queued."""
        wait = now - task._pq_enq
        del task._pq_enq
        core = getattr(task.team, "core_team", task.team)
        tid = getattr(core, "id", None)
        if tid is not None:
            acc = self._team_wait.get(tid)
            if acc is None:
                if len(self._team_wait) < 256:
                    self._team_wait[tid] = [1, wait, wait]
            else:
                acc[0] += 1
                acc[1] += wait
                if wait > acc[2]:
                    acc[2] = wait
        inverted = (lane > 0 and wait > self._age_s and
                    sum(self._svc_count[:lane]) >
                    task.__dict__.get("_pq_low_snap", 0))
        if inverted:
            self.inversions += 1
        if metrics.ENABLED:
            metrics.observe("qos_queue_wait_us", wait * 1e6,
                            component="qos",
                            coll=task.coll_name or "",
                            alg=f"team{tid}/p{lane}")
            if inverted:
                metrics.inc("qos_priority_inversions", component="qos",
                            alg=f"team{tid}/p{lane}")
        if flight.ENABLED and wait > self._age_s and \
                task.coll_name is not None:
            rec = getattr(getattr(core, "context", None), "flight", None)
            if rec is not None:
                rec.complete(tid, getattr(core, "epoch", 0), task.seq_num,
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
        starve_max = 0.0
        svc = self._svc_count
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
                    svc[lane] += 1
                    if self._serve(task, lane, now):
                        completed += 1
                    continue
                # over the WRR cap: a task past the anti-starvation bound
                # (time since its last service, or enqueue) is serviced
                # anyway, and measured
                waited = now - task.__dict__.get("_pq_last", now)
                if waited > self._age_s:
                    if waited > starve_max:
                        starve_max = waited
                    svc[lane] += 1
                    if self._serve(task, lane, now):
                        completed += 1
                    continue
                q.append(task)
        if starve_max > self.starvation_max_s:
            self.starvation_max_s = starve_max
        if metrics.ENABLED:
            metrics.gauge("progress_starvation_max_ms", starve_max * 1e3,
                          component="qos")
            if top > 0:
                # per-lane depth only once lanes are actually in play
                for lane in range(NUM_LANES):
                    metrics.gauge("qos_lane_depth", len(self._lanes[lane]),
                                  component="qos", alg=f"p{lane}")
        return completed

    # ------------------------------------------------------------------
    def qos_snapshot(self, reset: bool = True) -> Dict:
        """Per-team queue-wait + contention counters since the last
        snapshot, so per-tenant contention travels with the straggler
        telemetry."""
        snap = {
            "lane_depth": [len(q) for q in self._lanes],
            "inversions": self.inversions,
            "starvation_max_ms": round(self.starvation_max_s * 1e3, 3),
            "team_wait_ms": {
                tid: {"n": int(a[0]),
                      "mean": round(a[1] / a[0] * 1e3, 3) if a[0] else 0.0,
                      "max": round(a[2] * 1e3, 3)}
                for tid, a in self._team_wait.items()},
        }
        if reset:
            self._team_wait = {}
            self.starvation_max_s = 0.0
        return snap

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

    def qos_snapshot(self, reset: bool = True) -> Dict:
        with self._lock:
            return super().qos_snapshot(reset)
