"""Pipelined schedules — the fragmentation engine for long messages
(UCC's ``ucc_schedule_pipelined``).

A collective is split into ``n_frags_total`` fragments executed through
a window of ``n_frags`` reusable fragment schedules. ``frag_init`` builds
each window entry once; ``frag_setup(sched, frag, frag_num)`` re-targets
its buffer offsets at every (re)launch. Cross-fragment ordering:

  - PARALLEL:   no cross-frag deps, out-of-order frag launch allowed
  - ORDERED:    frag i's task j waits for frag i-1's task j to *start*
  - SEQUENTIAL: frag i's task j waits for frag i-1's task j to *complete*

Restart semantics are UCC's: on restart a task's ``n_deps`` is
*incremented* by its base (dependency events of the previous window may
already have arrived; satisfied counts are never reset mid-pipeline).
The hierarchical CL drives its fragment pipelines through it.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, List, Optional

from ..constants import EventType
from ..obs import metrics
from ..status import Status
from ..utils import profiling
from ..utils.config import SIZE_INF
from ..utils.mathutils import div_round_up
from .schedule import Schedule
from .task import CollTask


class PipelineOrder(enum.IntEnum):
    PARALLEL = 0
    ORDERED = 1
    SEQUENTIAL = 2


PIPELINE_ORDER_NAMES = {
    PipelineOrder.PARALLEL: "parallel",
    PipelineOrder.ORDERED: "ordered",
    PipelineOrder.SEQUENTIAL: "sequential",
}


@dataclass
class PipelineParams:
    """ucc_pipeline_params_t: the knobs shared by CLs and TLs, parsed
    from config strings like
    ``thresh=64k:fragsize=1m:nfrags=4:pdepth=2:ordered``."""

    threshold: int = SIZE_INF   # pipelining off by default
    frag_size: int = SIZE_INF
    n_frags: int = 2
    pdepth: int = 2
    order: PipelineOrder = PipelineOrder.SEQUENTIAL

    def nfrags_pdepth(self, msgsize: int):
        """ucc_pipeline_nfrags_pdepth: (fragments, pipeline depth)."""
        n_frags = 1
        if msgsize > self.threshold:
            min_num = div_round_up(msgsize, self.frag_size)
            n_frags = max(min_num, self.n_frags)
        return n_frags, min(n_frags, self.pdepth)


def parse_pipeline_params(s: str) -> PipelineParams:
    """Parse UCC's pipeline config syntax: colon-separated ``key=value`` plus bare order tokens, e.g.
    ``thresh=64K:fragsize=1M:nfrags=4:pdepth=2:ordered`` or ``n``/``auto``."""
    from ..utils.config import parse_memunits

    p = PipelineParams()
    s = s.strip().lower()
    if s in ("", "n", "no", "none", "auto"):
        return p
    for tok in s.split(":"):
        tok = tok.strip()
        if not tok:
            continue
        if tok in ("parallel", "ordered", "sequential"):
            p.order = {"parallel": PipelineOrder.PARALLEL,
                       "ordered": PipelineOrder.ORDERED,
                       "sequential": PipelineOrder.SEQUENTIAL}[tok]
            continue
        if "=" not in tok:
            raise ValueError(f"invalid pipeline token '{tok}'")
        k, v = tok.split("=", 1)
        k = k.strip()
        if k in ("thresh", "threshold"):
            p.threshold = parse_memunits(v)
        elif k in ("fragsize", "frag_size"):
            p.frag_size = parse_memunits(v)
        elif k in ("nfrags", "n_frags"):
            p.n_frags = int(v)
        elif k in ("pdepth", "depth"):
            p.pdepth = int(v)
        else:
            raise ValueError(f"unknown pipeline param '{k}'")
    return p


class PipelinedSchedule(Schedule):
    """See module docstring. ``frag_init(sched, idx) -> Schedule`` builds a
    window entry; ``frag_setup(sched, frag, frag_num)`` retargets it.

    Memory: window entries are built once and re-posted for every
    fragment they serve, so a task's pool-leased scratch (``mc.pool``)
    survives retargeting: one fragment's scratch serves the whole window
    (fragments are near-equal splits, so the first lease fits every
    later one). Leases return to the pool when this schedule is
    finalized (``finalize_fn`` -> frag -> task)."""

    MAX_FRAGS = 4  # window size cap (UCC's UCC_SCHEDULE_FRAG_MAX)

    def __init__(self, team=None, args=None, *,
                 frag_init: Callable[["PipelinedSchedule", int], Schedule],
                 frag_setup: Optional[Callable[["PipelinedSchedule", Schedule, int], Status]],
                 n_frags: int, n_frags_total: int,
                 order: PipelineOrder = PipelineOrder.SEQUENTIAL):
        super().__init__(team=team, args=args)
        if n_frags > self.MAX_FRAGS:
            n_frags = self.MAX_FRAGS
        n_frags = min(n_frags, n_frags_total)
        self.n_frags = n_frags
        self.n_frags_total = n_frags_total
        self.order = order
        self.frag_setup = frag_setup
        self.n_frags_started = 0
        self.n_frags_in_pipeline = 0
        self.next_frag_to_post = 0
        self.frags: List[Schedule] = []
        self._restart_pending: List[bool] = [False] * n_frags

        for i in range(n_frags):
            frag = frag_init(self, i)
            frag.schedule = self
            self.frags.append(frag)

        dep_event = None
        if n_frags > 1:
            if order == PipelineOrder.ORDERED:
                dep_event = EventType.EVENT_TASK_STARTED
            elif order == PipelineOrder.SEQUENTIAL:
                dep_event = EventType.EVENT_COMPLETED
        if dep_event is not None:
            for i in range(n_frags):
                prev = self.frags[(i + n_frags - 1) % n_frags]
                for j, t in enumerate(self.frags[i].tasks):
                    prev.tasks[j].subscribe(dep_event, _pipeline_dep_handler, t)
                    prev.tasks[j].subscribe(EventType.EVENT_ERROR,
                                            _pipeline_dep_handler, t)
                    t.n_deps += 1
                    t.n_deps_base = t.n_deps

    # ------------------------------------------------------------------
    @property
    def n_tasks(self) -> int:  # the schedule counts fragments, as UCC's
        return self.n_frags_total

    def post_fn(self) -> Status:
        self.n_completed = 0
        self.first_error = None
        self.n_frags_started = 0
        self.next_frag_to_post = 0
        self.n_frags_in_pipeline = 0
        for i, frag in enumerate(self.frags):
            self._restart_pending[i] = False
            frag.n_completed = 0
            frag.first_error = None
            frag.status = Status.OPERATION_INITIALIZED
            frag.super_status = Status.OPERATION_INITIALIZED
            frag.progress_queue = self.progress_queue
            for t in frag.tasks:
                t.n_deps = t.n_deps_base
                t.n_deps_satisfied = 0
                t.status = Status.OPERATION_INITIALIZED
                t.super_status = Status.OPERATION_INITIALIZED
                t.progress_queue = self.progress_queue
                if i == 0 and self.n_frags > 1 and \
                        self.order != PipelineOrder.PARALLEL:
                    # first window launch: frag 0 has no previous frag, its
                    # cross-frag dep is pre-credited (as ucc_schedule_pipelined_post)
                    t.n_deps_satisfied += 1
        self.notify(EventType.EVENT_SCHEDULE_STARTED)
        for frag in self.frags:
            st = self._frag_start(frag)
            if st.is_error:
                return st
        return Status.OK

    def _frag_start(self, frag: Schedule) -> Status:
        """ucc_frag_start_handler."""
        frag.start_time = self.start_time
        if self.frag_setup is not None:
            st = self.frag_setup(self, frag, self.n_frags_started)
            if isinstance(st, Status) and st.is_error:
                return st
        if profiling.ENABLED:
            # per-fragment begin; the matching E fires in child_completed.
            # span id is the frag schedule's seq (window entries are
            # reused, so B/E pairs alternate on the same id — exactly
            # what accum pairing and chrome nesting expect)
            profiling.span_begin("pipeline_frag", frag.seq_num,
                                 parent=self.seq_num,
                                 frag_num=self.n_frags_started,
                                 n_frags_total=self.n_frags_total)
        if metrics.ENABLED:
            metrics.inc("frags_pipelined", component="schedule",
                        coll=self.coll_name or "",
                        alg=self.alg_name or "")
        self.next_frag_to_post = (self.next_frag_to_post + 1) % self.n_frags
        self.n_frags_started += 1
        self.n_frags_in_pipeline += 1
        return frag.post()

    def child_completed(self, frag: CollTask) -> None:
        """ucc_schedule_pipelined_completed_handler."""
        if self.is_completed():
            return  # straggler frag after an error already completed us
        if profiling.ENABLED:
            profiling.span_end("pipeline_frag", frag.seq_num,
                               status=frag.status.name)
        idx = self.frags.index(frag)
        self.n_completed += 1
        self.n_frags_in_pipeline -= 1
        self._restart_pending[idx] = True
        if frag.status.is_error and self.first_error is None:
            self.first_error = frag.status
        if self.n_completed == self.n_frags_total or self.first_error:
            self.status = self.first_error if self.first_error else Status.OK
            self.complete(self.status)
            return
        while self.n_completed + self.n_frags_in_pipeline < self.n_frags_total:
            nxt = self.frags[self.next_frag_to_post]
            nidx = self.frags.index(nxt)
            if not self._restart_pending[nidx]:
                break  # next frag still in flight; its completion will resume
            self._restart_pending[nidx] = False
            nxt.status = Status.OPERATION_INITIALIZED
            nxt.super_status = Status.OPERATION_INITIALIZED
            nxt.n_completed = 0
            for t in nxt.tasks:
                # deps accumulate across restarts; satisfied never resets
                t.n_deps += t.n_deps_base
                t.status = Status.OPERATION_INITIALIZED
                t.super_status = Status.OPERATION_INITIALIZED
            st = self._frag_start(nxt)
            if isinstance(st, Status) and st.is_error:
                self.status = st
                self.complete(st)
                return

    def cancel_fn(self) -> None:
        """Cancel the live fragment window. Fragments not yet (re)posted
        are OPERATION_INITIALIZED and cancel cleanly; in-flight ones
        unwind their TL tasks. ``child_completed`` restarts nothing
        afterwards because the first cancelled frag sets first_error,
        which completes the pipeline."""
        st = getattr(self, "_cancel_status", Status.ERR_CANCELED)
        for frag in list(self.frags):
            if not frag.is_completed():
                frag.cancel(st)

    def finalize_fn(self) -> Status:
        st = Status.OK
        for frag in self.frags:
            s = frag.finalize()
            if isinstance(s, Status) and s.is_error:
                st = s
        return st


def _pipeline_dep_handler(parent: CollTask, event: EventType,
                          task: CollTask) -> None:
    """Cross-frag dependency edge. Unlike the plain dependency handler this
    must tolerate arriving while *task* is not yet (re)initialized for its
    next launch — satisfied counts simply accumulate."""
    if event == EventType.EVENT_ERROR:
        if not task.is_completed():
            task.complete(parent.status)
        return
    task.n_deps_satisfied += 1
    if task.n_deps_satisfied == task.n_deps and \
            task.status == Status.OPERATION_INITIALIZED:
        task.start_time = parent.start_time or task.start_time
        st = task.post(inherit_start=True)
        if not (isinstance(st, Status) and st.is_error):
            task.notify(EventType.EVENT_TASK_STARTED)
