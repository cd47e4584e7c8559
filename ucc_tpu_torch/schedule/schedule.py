"""Schedules — DAGs of collective tasks (UCC's ``ucc_schedule_t``).

A schedule completes when all child tasks complete; the first error
status wins and is propagated; persistent schedules reset and re-post
children.

Typical wiring:
    sched = Schedule(team)
    sched.add_task(t1); t1.subscribe_dep(sched, EVENT_SCHEDULE_STARTED)
    sched.add_task(t2); t2.subscribe_dep(t1, EVENT_COMPLETED)
    sched.post()
"""
from __future__ import annotations

from typing import List, Optional

from ..constants import EventType
from ..status import Status
from .task import CollTask


class Schedule(CollTask):
    def __init__(self, team=None, args=None, flags_internal: bool = False):
        super().__init__(team=team, args=args, flags_internal=flags_internal)
        self.tasks: List[CollTask] = []
        self.n_completed = 0
        self.first_error: Optional[Status] = None

    # ------------------------------------------------------------------
    def add_task(self, task: CollTask) -> None:
        task.schedule = self
        task.progress_queue = self.progress_queue
        self.tasks.append(task)

    def add_dep_on_schedule_start(self, task: CollTask) -> None:
        task.subscribe_dep(self, EventType.EVENT_SCHEDULE_STARTED)

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    # ------------------------------------------------------------------
    def post_fn(self) -> Status:
        self.n_completed = 0
        self.first_error = None
        for t in self.tasks:
            if t.progress_queue is None:
                t.progress_queue = self.progress_queue
        self.notify(EventType.EVENT_SCHEDULE_STARTED)
        # tasks with zero deps are started directly (as ucc_schedule_start
        # does)
        for t in self.tasks:
            if t.n_deps == 0 and t.status == Status.OPERATION_INITIALIZED:
                t.start_time = self.start_time or t.start_time
                st = t.post(inherit_start=True)
                if not (isinstance(st, Status) and st.is_error):
                    t.notify(EventType.EVENT_TASK_STARTED)
        return Status.OK

    def progress_fn(self) -> None:
        # children progress via the progress queue; schedule completes via
        # child_completed bookkeeping
        pass

    def child_completed(self, task: CollTask) -> None:
        self.n_completed += 1
        if task.status.is_error and self.first_error is None:
            self.first_error = task.status
        if self.n_completed == self.n_tasks:
            self.status = self.first_error if self.first_error else Status.OK
            self.complete(self.status)

    def cancel_fn(self) -> None:
        """Cancel every incomplete child with the same status. Child
        completions re-enter ``child_completed`` and may complete the
        schedule mid-loop — ``cancel`` tolerates that (idempotent
        complete), and first_error carries the identical status."""
        st = getattr(self, "_cancel_status", Status.ERR_CANCELED)
        for t in list(self.tasks):
            if not t.is_completed():
                t.cancel(st)

    def reset(self) -> None:
        super().reset()
        self.n_completed = 0
        self.first_error = None
        for t in self.tasks:
            t.reset()

    def finalize_fn(self) -> Status:
        st = Status.OK
        for t in self.tasks:
            s = t.finalize()
            if isinstance(s, Status) and s.is_error:
                st = s
        return st
