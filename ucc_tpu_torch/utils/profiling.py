"""Profiling — request-lifetime event tracing (UCC's ``UCC_PROFILE_MODE``).

``UCC_PROFILE_MODE=log`` writes one chrome://tracing-compatible JSON
event per line to ``UCC_PROFILE_FILE`` (default ucc_profile.json);
``accum`` aggregates per-event counts and total times and writes them at
exit. Off by default: hot paths test the module-level ``ENABLED`` before
any formatting, the Python counterpart of UCC's compiled-out macros. The
environment is read at import.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any, Dict, Optional

_mode = os.environ.get("UCC_PROFILE_MODE", "").strip().lower()
ENABLED = _mode in ("log", "accum")
_file = os.environ.get("UCC_PROFILE_FILE", "ucc_profile.json")
_lock = threading.Lock()
_fh = None
_accum: Dict[str, Dict[str, float]] = {}
_t0 = time.perf_counter()


def _ensure_fh():
    global _fh
    if _fh is None:
        _fh = open(_file, "a", buffering=1)
    return _fh


def event(name: str, phase: str = "i", **fields: Any) -> None:
    """Record one event. phase: 'B' begin / 'E' end / 'i' instant."""
    if not ENABLED:
        return
    ts = (time.perf_counter() - _t0) * 1e6
    if _mode == "accum":
        with _lock:
            slot = _accum.setdefault(name, {"count": 0, "last_B": 0.0,
                                            "total_us": 0.0})
            if phase == "B":
                slot["last_B"] = ts
            elif phase == "E":
                # count completed B/E pairs only; clear last_B so a
                # persistent re-post's extra E does not add the whole time
                # since init
                if slot["last_B"]:
                    slot["count"] += 1
                    slot["total_us"] += ts - slot["last_B"]
                    slot["last_B"] = 0.0
            else:
                slot["count"] += 1
        return
    rec = {"name": name, "ph": phase, "ts": ts, "pid": os.getpid(),
           "tid": threading.get_ident() % 100000}
    rec.update(fields)
    with _lock:
        _ensure_fh().write(json.dumps(rec) + "\n")


def request_new(coll: str, seq: int, **fields) -> None:
    """Collective-request begin. ``seq`` doubles as the span id (task
    sequence numbers are unique in the process)."""
    event(f"coll_{coll}", "B", seq=seq, span=seq, **fields)


def request_complete(coll: str, seq: int, **fields) -> None:
    event(f"coll_{coll}", "E", seq=seq, span=seq, **fields)


def span_begin(name: str, span: int, parent: Optional[int] = None,
               **fields: Any) -> None:
    """A named B event with a process-unique id (a task's seq_num) and an
    optional parent span, so a trace shows a collective's request ->
    schedule -> task lifetime."""
    if not ENABLED:
        return
    if parent is not None:
        fields["parent"] = parent
    event(name, "B", span=span, **fields)


def span_end(name: str, span: int, **fields: Any) -> None:
    if not ENABLED:
        return
    event(name, "E", span=span, **fields)


@atexit.register
def _dump_accum() -> None:
    if ENABLED and _mode == "accum" and _accum:
        with open(_file, "a") as fh:
            for name, slot in sorted(_accum.items()):
                fh.write(json.dumps({
                    "name": name, "count": int(slot["count"]),
                    "total_us": round(slot["total_us"], 1),
                    "avg_us": round(slot["total_us"] /
                                    max(1, slot["count"]), 2)}) + "\n")
