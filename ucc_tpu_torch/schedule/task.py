"""Collective task — the universal async operation.

UCC's ``ucc_coll_task_t`` and its event manager:

  - a task has a user-visible ``status`` plus post/progress/finalize hooks
  - tasks publish events (COMPLETED / STARTED / ERROR / ...) to subscribers
  - dependency edges: a task with ``n_deps`` starts only after that many
    dependency events arrive (``ucc_dependency_handler``) — a tiny DAG engine
  - completion runs the user callback, notifies the parent schedule, and
    stamps timing for timeout detection

A device task's ``progress()`` polls the CUDA event of the kernel launch
that carries it; host tasks are driven by the progress queue.
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Callable, List, Optional, Tuple

from ..constants import EventType
from ..fault import inject as fault
from ..obs import flight, metrics
from ..status import Status
from ..utils import profiling
from ..utils.log import get_logger

logger = get_logger("schedule")

#: one counter for the whole process, which holds every rank: profiling
#: spans key on seq_num. next() on an itertools.count is atomic under the
#: GIL, so tasks created from several rank threads never share a number
_seq_counter = itertools.count(1)


def _next_seq() -> int:
    return next(_seq_counter)


def _flight_rec(task: "CollTask"):
    """The owning context's flight recorder (None when UCC_FLIGHT=n or
    the task has no team). Called once per labeled lifecycle step, never
    per message."""
    core = getattr(task.team, "core_team", task.team)
    if core is None:
        return None
    return getattr(getattr(core, "context", None), "flight", None)


class EventManager:
    """Per-task subscriber lists.

    Handlers: ``fn(parent_task, event, subscriber_task) -> None``.
    """

    __slots__ = ("listeners",)

    def __init__(self):
        self.listeners: List[List[Tuple[Callable, Any]]] = \
            [[] for _ in range(EventType.EVENT_LAST)]

    def subscribe(self, event: EventType, handler: Callable, subscriber: Any) -> None:
        self.listeners[event].append((handler, subscriber))

    def notify(self, parent: "CollTask", event: EventType) -> None:
        for handler, subscriber in list(self.listeners[event]):
            handler(parent, event, subscriber)


class CollTask:
    """Base async collective task.

    Subclasses provide:
      ``post_fn()``   — start the operation; returns Status
      ``progress_fn()`` — advance; sets ``self.status`` (IN_PROGRESS / OK / error)
      ``finalize_fn()`` — release resources

    Lifecycle: init -> OPERATION_INITIALIZED -> post -> IN_PROGRESS -> OK
    """

    #: labels stamped by core dispatch (coll/alg on the top-level task);
    #: cl/hier sets stage on its sub-collectives
    coll_name: Optional[str] = None
    alg_name: Optional[str] = None
    obs_stage: Optional[str] = None
    _span_open = False
    #: exception that crashed the task (set by the progress queue when a
    #: progress_fn escapes — the real traceback behind an ERR_NO_MESSAGE)
    exc: Optional[BaseException] = None
    #: has this task put data on the wire or into peer-visible state? The
    #: runtime fallback of core/coll.py retries only a failed task that
    #: provably committed nothing, so the class default is True: a task
    #: type that does not track the transition is never retried. A task
    #: that does sets an instance copy False at post and True on its
    #: first send.
    data_committed: bool = True

    def __init__(self, team=None, args=None, flags_internal: bool = False):
        self.team = team
        self.args = args
        self.status: Status = Status.OPERATION_INITIALIZED
        self.super_status: Status = Status.OPERATION_INITIALIZED  # user-visible
        self.em = EventManager()
        self.n_deps = 0
        self.n_deps_satisfied = 0
        self.n_deps_base = 0          # for persistent re-post reset
        self.schedule = None
        self.flags_internal = flags_internal
        self.cb: Optional[Callable[["CollTask", Status], None]] = None
        self.start_time: float = 0.0
        self.timeout: float = 0.0      # seconds; 0 = no timeout
        self.seq_num = _next_seq()
        self.progress_queue = None     # set at post time by core/schedule
        self.triggered_task = None     # EE proxy task when triggered

    # ------------------------------------------------------------------ hooks
    def post_fn(self) -> Status:
        raise NotImplementedError

    def progress_fn(self) -> None:
        """Advance the op; must update self.status."""

    def finalize_fn(self) -> Status:
        return Status.OK

    def cancel_fn(self) -> None:
        """Abort the underlying operation. Must be idempotent and
        best-effort — cancel() swallows anything it raises."""

    def triggered_post_setup(self) -> Status:
        return Status.OK

    # ------------------------------------------------------------------ core
    def post(self, inherit_start: bool = False) -> Status:
        """Stamp start time, run post_fn, then hand the task to the
        progress queue (which runs one progress pass immediately, so fast
        ops never sit in the queue).

        ``inherit_start=True`` keeps a start_time assigned by the caller
        (schedules propagate the collective's start so timeouts bound the
        whole operation).
        """
        if not inherit_start or not self.start_time:
            self.start_time = time.monotonic()
        self.status = Status.IN_PROGRESS
        self.super_status = Status.IN_PROGRESS
        if profiling.ENABLED:
            self._span_open = True
            fields = {}
            if self.coll_name:
                fields["coll"] = self.coll_name
            if self.alg_name:
                fields["alg"] = self.alg_name
            if self.obs_stage:
                fields["stage"] = self.obs_stage
            profiling.span_begin(
                f"task_{type(self).__name__}", self.seq_num,
                parent=self.schedule.seq_num if self.schedule is not None
                else None, **fields)
        if flight.ENABLED and self.obs_stage:
            # start event for staged tasks only (cl/hier phase tasks:
            # obs_stage names the tree level); a top-level task's post
            # event and completion already carry its identity
            rec = _flight_rec(self)
            if rec is not None:
                core = getattr(self.team, "core_team", self.team)
                tag = self.__dict__.get("tag")
                rec.start(getattr(core, "id", None),
                          getattr(core, "epoch", 0), self.seq_num,
                          self.coll_name, self.alg_name, self.obs_stage,
                          tag if isinstance(tag, int) else None)
        if fault.ENABLED:
            bad = fault.post_inject(self)
            if bad is not None:
                self.status = bad
                self.complete(bad)
                return bad
        st = self.post_fn()
        if isinstance(st, Status) and st.is_error:
            self.status = st
            self.complete(st)
            return st
        if self.status.is_error:
            # post_fn signaled failure via self.status while returning OK
            self.complete(self.status)
            return self.status
        if self.status == Status.OK:
            # post_fn completed synchronously without calling complete()
            if self.super_status == Status.IN_PROGRESS:
                self.complete(Status.OK)
        elif self.status == Status.IN_PROGRESS and self.progress_queue is not None:
            self.progress_queue.enqueue(self)
        return st if isinstance(st, Status) else Status.OK

    def progress(self) -> None:
        self.progress_fn()

    def finalize(self) -> Status:
        return self.finalize_fn()

    def cancel(self, status: Status = Status.ERR_CANCELED) -> None:
        """Abort this task with a terminal *status* on THIS rank: run the
        type's ``cancel_fn``, then complete, which fires the normal
        EVENT_ERROR cascade. Idempotent; never raises."""
        if self.is_completed():
            return
        self._cancel_status = status   # schedules propagate it to children
        try:
            self.cancel_fn()
        except Exception:  # noqa: BLE001 - teardown is best-effort
            logger.exception("cancel_fn of %s seq %d raised",
                             type(self).__name__, self.seq_num)
        if metrics.ENABLED:
            metrics.inc("coll_cancelled", component="core",
                        coll=self.coll_name or "", alg=self.alg_name or "")
        if flight.ENABLED and (self.coll_name or self.obs_stage):
            rec = _flight_rec(self)
            if rec is not None:
                core = getattr(self.team, "core_team", self.team)
                rec.cancel(getattr(core, "id", None),
                           getattr(core, "epoch", 0), self.seq_num,
                           self.coll_name, self.alg_name, status.name)
        if not self.is_completed():  # cancel_fn may have completed us
            self.complete(status)

    def reset(self) -> None:
        """Prepare for re-post (persistent collectives)."""
        self.status = Status.OPERATION_INITIALIZED
        self.super_status = Status.OPERATION_INITIALIZED
        self.exc = None
        self.n_deps_satisfied = 0
        self.n_deps = self.n_deps_base

    # -------------------------------------------------------------- events
    def subscribe(self, event: EventType, handler: Callable,
                  subscriber: "CollTask") -> None:
        self.em.subscribe(event, handler, subscriber)

    def notify(self, event: EventType) -> None:
        self.em.notify(self, event)

    def subscribe_dep(self, parent: "CollTask", event: EventType) -> None:
        """Start after *parent* raises *event*. Errors in the parent
        propagate: the dependency handler completes this task with the
        parent's error status."""
        parent.subscribe(event, dependency_handler, self)
        if event != EventType.EVENT_ERROR:
            parent.subscribe(EventType.EVENT_ERROR, dependency_handler, self)
        self.n_deps += 1
        self.n_deps_base = self.n_deps

    # ------------------------------------------------------------ completion
    def complete(self, status: Optional[Status] = None) -> None:
        """ucc_task_complete. Idempotent: late events after completion
        must not re-run callbacks or double-count in a parent schedule."""
        if self.is_completed():
            return
        if status is not None:
            self.status = status
        st = self.status
        if st == Status.IN_PROGRESS:
            st = self.status = Status.OK
        # mark completed BEFORE notifying: cyclically-subscribed tasks
        # re-enter complete() from the EVENT handlers, and the idempotence
        # guard above must already see the final state
        self.super_status = st
        if self._span_open:
            # set only under profiling.ENABLED: the E closes the B of
            # post(), so pairs stay balanced through error cascades too
            self._span_open = False
            profiling.span_end(f"task_{type(self).__name__}", self.seq_num,
                               status=st.name)
        if metrics.ENABLED and self.coll_name:
            alg = self.alg_name or ""
            if st == Status.ERR_TIMED_OUT:
                metrics.inc("coll_timed_out", component="core",
                            coll=self.coll_name, alg=alg)
            metrics.inc("coll_failed" if st.is_error else "coll_completed",
                        component="core", coll=self.coll_name, alg=alg)
        if flight.ENABLED and (self.coll_name or self.obs_stage):
            rec = _flight_rec(self)
            if rec is not None:
                core = getattr(self.team, "core_team", self.team)
                dur = (time.monotonic() - self.start_time) \
                    if self.start_time else 0.0
                rec.complete(getattr(core, "id", None),
                             getattr(core, "epoch", 0), self.seq_num,
                             self.coll_name, self.alg_name,
                             self.obs_stage, dur, st.name)
        if st.is_error:
            if self.timeout and st == Status.ERR_TIMED_OUT:
                logger.warning(
                    "timeout %.3fs: coll task %s seq %d", self.timeout,
                    type(self).__name__, self.seq_num)
            self.notify(EventType.EVENT_ERROR)
        else:
            self.notify(EventType.EVENT_COMPLETED)
        if self.cb is not None:
            self.cb(self, st)
        if self.schedule is not None:
            self.schedule.child_completed(self)
        if self.flags_internal and self.schedule is None:
            # internal tasks with no parent are auto-finalized
            self.finalize()

    def is_completed(self) -> bool:
        return self.super_status != Status.IN_PROGRESS and \
            self.super_status != Status.OPERATION_INITIALIZED

    # --------------------------------------------------------------- obs
    def obs_describe(self, now: Optional[float] = None) -> dict:
        """Self-description for watchdog state dumps (cold: built only
        for a dump)."""
        if now is None:
            now = time.monotonic()
        d: dict = {"task": type(self).__name__, "seq": self.seq_num,
                   "status": self.status.name}
        if self.coll_name:
            d["coll"] = self.coll_name
        if self.alg_name:
            d["alg"] = self.alg_name
        if self.obs_stage:
            d["stage"] = self.obs_stage
        if self.start_time:
            d["age_s"] = round(now - self.start_time, 3)
        if self.timeout:
            d["timeout_s"] = self.timeout
        core = getattr(self.team, "core_team", self.team)
        if core is not None:
            d["team"] = getattr(core, "id", None)
            d["rank"] = getattr(core, "rank", None)
        return d

    def check_timeout(self, now: float) -> bool:
        return bool(self.timeout) and (now - self.start_time) > self.timeout

    def __repr__(self):
        return (f"<{type(self).__name__} seq={self.seq_num} "
                f"status={self.status.name}>")


def dependency_handler(parent: CollTask, event: EventType,
                       task: CollTask) -> None:
    """ucc_dependency_handler: count satisfied deps, post the task once
    all arrived."""
    if event == EventType.EVENT_ERROR:
        if not task.is_completed():
            task.complete(parent.status)
        return
    task.n_deps_satisfied += 1
    if task.n_deps_satisfied == task.n_deps:
        task.start_time = parent.start_time or task.start_time
        st = task.post(inherit_start=True)
        if not (isinstance(st, Status) and st.is_error):
            task.notify(EventType.EVENT_TASK_STARTED)
