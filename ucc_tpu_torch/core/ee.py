"""Execution engines and triggered collectives (UCC's ucc_ee and
``ucc_collective_triggered_post``).

An EE is an execution context bound to a team, with in and out event
queues. ``triggered_post(event, req)`` defers the post of ``req`` until
``event`` fires on the EE; the post and the completion each push an
event onto ``event_out``.

- ``EeType.CUDA_STREAM``: threadless; the context's progress queue polls
  the pending triggers (a registered progress function), and
  ``triggered_post``/``set_event`` poll once inline. Its trigger is data
  readiness: a ``UccEvent`` whose payload is a ``torch.cuda.Event`` fires
  when the event's work has finished; one whose payload is a CUDA tensor
  records an event on the current stream of the tensor's own device when
  the ``UccEvent`` is made, and fires on it — posting on a stream after
  the kernel that produced the tensor, as torch-ucc does. A CPU tensor
  payload fires at once.
- ``EeType.CPU_THREAD``: a thread runs the EE and the team's context
  progress, so the caller need not poll. The context and the caller then
  progress from two threads: create the context with
  ``ThreadMode.MULTIPLE`` (its locked progress queue).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import torch

from ..constants import EeType
from ..status import Status


class UccEvent:
    """ucc_ev_t: a signalable event with an optional payload whose
    readiness also fires it (see the module docstring)."""

    def __init__(self, ev_type: str = "compute_complete", payload=None):
        self.ev_type = ev_type
        self.payload = payload
        self._set = threading.Event()
        #: what fires the event on readiness: anything with query(), as a
        #: torch.cuda.Event has
        self._ready = None
        if isinstance(payload, torch.Tensor):
            if payload.is_cuda:
                self._ready = torch.cuda.Event()
                self._ready.record(torch.cuda.current_stream(payload.device))
            else:
                self._set.set()
        elif callable(getattr(payload, "query", None)):
            self._ready = payload

    def set(self) -> None:
        self._set.set()

    def is_set(self) -> bool:
        if self._set.is_set():
            return True
        if self._ready is not None and self._ready.query():
            self._set.set()
            return True
        return False


class Ee:
    """ucc_ee_h: an execution engine of `team`."""

    def __init__(self, team, ee_type: EeType = EeType.CPU_THREAD):
        self.team = team
        self.ee_type = EeType(ee_type)
        self.event_in: Deque[UccEvent] = deque()
        self.event_out: Deque[UccEvent] = deque()
        self._pending: List[Tuple[UccEvent, object]] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._ctx_progress_hook = None
        if self.ee_type == EeType.CPU_THREAD:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="ucc-ee")
            self._thread.start()
        else:
            self._ctx_progress_hook = self.progress
            team.context.progress_queue.register_progress_fn(
                self._ctx_progress_hook)

    def triggered_post(self, event: UccEvent, req) -> Status:
        """ucc_collective_triggered_post: post `req` when `event` fires; a
        ``collective_post`` event lands on event_out."""
        with self._lock:
            self._pending.append((event, req))
        if self._thread is None:
            self.progress()
        return Status.OK

    def get_event(self) -> Optional[UccEvent]:
        """ucc_ee_get_event: pop an out event, or None."""
        self.progress()
        with self._lock:
            return self.event_out.popleft() if self.event_out else None

    def ack_event(self, ev: UccEvent) -> Status:
        return Status.OK

    def set_event(self, ev: UccEvent) -> Status:
        """ucc_ee_set_event: an external signal into the EE."""
        ev.set()
        self.event_in.append(ev)
        if self._thread is None:
            self.progress()
        return Status.OK

    def progress(self) -> None:
        fired = []
        with self._lock:
            still = []
            for ev, req in self._pending:
                if ev.is_set():
                    fired.append((ev, req))
                else:
                    still.append((ev, req))
            self._pending = still
        for ev, req in fired:
            # chain the completion event BEFORE posting: a collective may
            # complete synchronously inside post()
            req.task.cb = _chain_cb(req.task, self, req)
            out = UccEvent("collective_post", payload=req)
            with self._lock:
                self.event_out.append(out)
            req.post()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.progress()
            self.team.context.progress()
            time.sleep(0)

    def destroy(self) -> Status:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._ctx_progress_hook is not None:
            self.team.context.progress_queue.deregister_progress_fn(
                self._ctx_progress_hook)
            self._ctx_progress_hook = None
        return Status.OK


def _chain_cb(task, ee: Ee, req):
    """A callback that pushes the completion event once and then gives the
    task its earlier callback back, so that only the triggered round has
    an observer: a persistent request's later plain rounds take the fast
    re-post lane again, and a later triggered round pushes one completion
    event, not one per earlier trigger."""
    prev_cb = task.cb

    def cb(t, status):
        if task.cb is cb:
            task.cb = prev_cb
        if prev_cb is not None:
            prev_cb(t, status)
        with ee._lock:
            ee.event_out.append(UccEvent("collective_complete", payload=req))
    return cb
