"""Metrics registry — process-wide counters, gauges, log2 histograms.

Every series is keyed by a metric name plus a ``(component, collective,
algorithm)`` triple, so one registry answers both "how many collectives
did allreduce post" and "which algorithm fell back at run time".

Zero-cost when off: ``UCC_STATS`` unset leaves ``ENABLED`` False and
every instrumented hot path guards with ``if metrics.ENABLED:`` before
any formatting or locking.

Dumps are JSON lines (one snapshot object per line) appended to
``UCC_STATS_FILE``:

- at interpreter exit (when enabled and anything was recorded);
- on ``SIGUSR2`` (an operator-triggered mid-run snapshot);
- every ``UCC_STATS_INTERVAL`` seconds from a daemon thread.

The environment is read at import; ``enable()``/``disable()`` switch the
registry at run time.
"""
from __future__ import annotations

import atexit
import json
import os
import signal
import threading
import time
from typing import Any, Dict, Optional, Tuple

_raw = os.environ.get("UCC_STATS", "").strip().lower()
ENABLED: bool = _raw not in ("", "0", "n", "no", "off")
_file: str = os.environ.get("UCC_STATS_FILE", "ucc_stats.json")
try:
    _interval: float = float(os.environ.get("UCC_STATS_INTERVAL", "0") or 0)
except ValueError:
    _interval = 0.0

_lock = threading.Lock()
_t0 = time.monotonic()

Key = Tuple[str, str, str, str]   # (name, component, collective, algorithm)

_counters: Dict[Key, float] = {}
_gauges: Dict[Key, float] = {}
#: histogram slot: {"buckets": {log2_bucket: count}, "count", "sum", "max"}
_hists: Dict[Key, Dict[str, Any]] = {}


def _key(name: str, component: str, coll: str, alg: str) -> Key:
    return (name, component or "", coll or "", alg or "")


# ---------------------------------------------------------------------------
# recording API — callers guard with `if metrics.ENABLED:` on hot paths
# ---------------------------------------------------------------------------

def inc(name: str, value: float = 1, component: str = "", coll: str = "",
        alg: str = "") -> None:
    """Add ``value`` to a monotonically increasing counter."""
    if not ENABLED:
        return
    k = _key(name, component, coll, alg)
    with _lock:
        _counters[k] = _counters.get(k, 0) + value


def gauge(name: str, value: float, component: str = "", coll: str = "",
          alg: str = "") -> None:
    """Set a point-in-time gauge (last write wins)."""
    if not ENABLED:
        return
    with _lock:
        _gauges[_key(name, component, coll, alg)] = value


def observe(name: str, value: float, component: str = "", coll: str = "",
            alg: str = "") -> None:
    """Record one sample into a log2-bucket histogram. Bucket b counts
    samples in [2^(b-1), 2^b); bucket 0 counts values < 1."""
    if not ENABLED:
        return
    bucket = max(0, int(value)).bit_length()
    k = _key(name, component, coll, alg)
    with _lock:
        slot = _hists.get(k)
        if slot is None:
            slot = _hists[k] = {"buckets": {}, "count": 0, "sum": 0.0,
                                "max": 0.0}
        slot["buckets"][bucket] = slot["buckets"].get(bucket, 0) + 1
        slot["count"] += 1
        slot["sum"] += value
        slot["max"] = max(slot["max"], value)


#: the counters of device teams that span processes (tl/device_sync.py):
#: rounds launched, peer buffers opened (CUDA IPC mappings, or the CPU
#: stand-in's staging files) and descriptors sent through the sync area.
#: A persistent round after the first opens nothing and sends nothing.
#: They are kept in ``span_counts`` whether or not UCC_STATS is on (tests
#: and chip_smoke.py read them), and recorded as counters when it is.
DEVICE_SPAN_COUNTERS = ("dev_span_rounds", "dev_ipc_opens", "dev_desc_sends")
span_counts: Dict[str, int] = dict.fromkeys(DEVICE_SPAN_COUNTERS, 0)


def count_span(name: str, value: int = 1) -> None:
    """Add to one of DEVICE_SPAN_COUNTERS."""
    span_counts[name] += value
    if ENABLED:
        inc(name, value, component="tl_device")


# ---------------------------------------------------------------------------
# snapshot / dump
# ---------------------------------------------------------------------------

def _flatten(table: Dict[Key, Any]) -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    for (name, component, coll, alg), v in sorted(table.items()):
        out.setdefault(name, {})["|".join((component, coll, alg))] = v
    return out


def snapshot() -> Dict[str, Any]:
    """Deep-copied point-in-time view of every series."""
    with _lock:
        return {
            "ts": time.time(),
            "pid": os.getpid(),
            "uptime_s": round(time.monotonic() - _t0, 3),
            "counters": _flatten(dict(_counters)),
            "gauges": _flatten(dict(_gauges)),
            "histograms": _flatten(
                {k: {"buckets": dict(v["buckets"]), "count": v["count"],
                     "sum": v["sum"], "max": v["max"]}
                 for k, v in _hists.items()}),
        }


def dump(path: Optional[str] = None, reason: str = "explicit") -> str:
    """Append one snapshot line to ``path`` (default UCC_STATS_FILE);
    returns the path written."""
    path = path or _file
    snap = snapshot()
    snap["reason"] = reason
    with open(path, "a") as fh:
        fh.write(json.dumps(snap) + "\n")
    return path


def reset() -> None:
    """Clear every series."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()


# ---------------------------------------------------------------------------
# runtime enable/disable (the environment is read at import)
# ---------------------------------------------------------------------------

def enable(file: Optional[str] = None,
           interval: Optional[float] = None) -> None:
    """Runtime enable, with the contract of UCC_STATS=y: the at-exit dump
    is armed (it tests ENABLED itself, so a later ``disable()``
    suppresses it), and an interval from the environment is kept unless
    given here."""
    global ENABLED, _file, _interval
    ENABLED = True
    if file is not None:
        _file = file
    if interval is not None:
        _interval = interval
    _start_background()


def disable() -> None:
    global ENABLED
    ENABLED = False


# ---------------------------------------------------------------------------
# dump triggers: exit / SIGUSR2 / interval
# ---------------------------------------------------------------------------

_bg_started = False
_interval_thread: Optional[threading.Thread] = None
_prev_sigusr2 = None


def _sigusr2(signum, frame) -> None:
    if ENABLED:
        # never dump inline: the handler runs on the main thread between
        # bytecodes, possibly while that thread holds the non-reentrant
        # _lock inside inc()/observe(), and snapshot() would deadlock. A
        # short-lived thread waits its turn for the lock.
        threading.Thread(target=dump, kwargs={"reason": "SIGUSR2"},
                         daemon=True, name="ucc-stats-sigusr2").start()
    # chain an earlier handler instead of unseating it
    prev = _prev_sigusr2
    if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
        prev(signum, frame)


def _interval_loop() -> None:
    while True:
        time.sleep(max(0.05, _interval))
        if ENABLED and _interval > 0:
            dump(reason="interval")


def _start_background() -> None:
    global _bg_started, _interval_thread, _prev_sigusr2
    if not _bg_started:
        _bg_started = True
        atexit.register(lambda: ENABLED and
                        (_counters or _gauges or _hists) and
                        dump(reason="atexit"))
        try:
            # only valid in the main thread; an embedder that imports off
            # the main thread loses the signal trigger, not the registry
            prev = signal.getsignal(signal.SIGUSR2)
            if prev is not _sigusr2:
                _prev_sigusr2 = prev
            signal.signal(signal.SIGUSR2, _sigusr2)
        except (ValueError, OSError):
            pass
    if _interval > 0 and _interval_thread is None:
        _interval_thread = threading.Thread(
            target=_interval_loop, daemon=True, name="ucc-stats-dump")
        _interval_thread.start()


if ENABLED:
    _start_background()
