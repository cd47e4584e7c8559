"""Stall watchdog: turns silent hangs into state dumps, and bounds them.

Hooks the progress queue (schedule/progress.py): any task IN_PROGRESS
past a soft deadline (``UCC_WATCHDOG_TIMEOUT`` seconds; unset/0 = off,
the default) fires a one-shot dump: every in-flight task with its
collective, algorithm, round slots, outstanding peers and tags, the
progress-queue depth, every live team's state-machine position (a
CL_AGREE dwell is named: a peer that failed every CL create), the
mailbox backlogs of the host transports and tl/ipc arenas, and the
flight recorder's diagnosis, to the log at ERROR and as a JSON line
appended to ``UCC_WATCHDOG_FILE``.

The escalation ladder (``UCC_WATCHDOG_ACTION``): ``dump`` (default) only
diagnoses; ``cancel`` also cancels any task still IN_PROGRESS past the
hard deadline (``UCC_WATCHDOG_HARD_TIMEOUT``, default twice the soft
one) with ERR_TIMED_OUT, unwinding its posted transport ops; ``abort``
cancels every in-flight task once any one crosses the hard deadline,
and fails stalled team creates (timeout, abort, then the caller's
re-init).

Off costs nothing: the progress loop tests ``watchdog.ENABLED`` (a
module-level boolean) first, and even when on the scan runs at most
once per ``_SCAN_PERIOD`` seconds per queue.
"""
from __future__ import annotations

import json
import os
import time
import weakref
from typing import Any, Dict, List, Optional, Set, Tuple

from ..status import Status
from ..utils.log import get_logger

logger = get_logger("obs")

try:
    TIMEOUT: float = float(os.environ.get("UCC_WATCHDOG_TIMEOUT", "0") or 0)
except ValueError:
    TIMEOUT = 0.0
ENABLED: bool = TIMEOUT > 0
_file: str = os.environ.get("UCC_WATCHDOG_FILE", "ucc_watchdog.json")
ACTION: str = os.environ.get("UCC_WATCHDOG_ACTION", "dump").strip().lower()
if ACTION not in ("dump", "cancel", "abort"):
    logger.warning("unknown UCC_WATCHDOG_ACTION %r; using 'dump'", ACTION)
    ACTION = "dump"
try:
    HARD_TIMEOUT: float = float(
        os.environ.get("UCC_WATCHDOG_HARD_TIMEOUT", "0") or 0)
except ValueError:
    HARD_TIMEOUT = 0.0
if HARD_TIMEOUT <= 0:
    HARD_TIMEOUT = 2 * TIMEOUT

_SCAN_PERIOD = 1.0
_last_scan = 0.0
#: one-shot guards: task seq nums / (team id, state) already reported
_fired_tasks: Set[int] = set()
_fired_teams: Set[Tuple[Any, str]] = set()

#: every Team registers here at construction (cheap, not a hot path) so
#: a dump can name state-machine positions even for teams that never
#: reach the progress queue (the team-create hang class)
TEAMS: "weakref.WeakSet" = weakref.WeakSet()


def configure(timeout: float, file: Optional[str] = None,
              action: Optional[str] = None,
              hard_timeout: Optional[float] = None) -> None:
    """Runtime enable/disable (tests and embedders; env read at import)."""
    global TIMEOUT, ENABLED, _file, _last_scan, ACTION, HARD_TIMEOUT
    TIMEOUT = float(timeout)
    ENABLED = TIMEOUT > 0
    if file is not None:
        _file = file
    if action is not None:
        if action not in ("dump", "cancel", "abort"):
            raise ValueError(f"watchdog action must be dump|cancel|abort, "
                             f"got {action!r}")
        ACTION = action
    HARD_TIMEOUT = float(hard_timeout) if hard_timeout is not None \
        else 2 * TIMEOUT
    _last_scan = 0.0


def reset() -> None:
    """Clear one-shot state (tests)."""
    _fired_tasks.clear()
    _fired_teams.clear()


def register_team(team: Any) -> None:
    TEAMS.add(team)


def note_rank_failure(ranks, source: str = "", detail: str = "") -> None:
    """Append a ``rank_failed`` evidence line to the watchdog file
    (called by fault/health on detection). Only when the watchdog is
    armed: a harness that reads the file classifies the run
    ``rank_failed(ranks=...)`` instead of ``hang``/``timeout``."""
    if not ENABLED:
        return
    rec = {"ts": time.time(), "pid": os.getpid(), "reason": "rank_failed",
           "failed_ranks": sorted(int(r) for r in ranks),
           "source": source, "detail": detail}
    try:
        with open(_file, "a") as fh:
            fh.write(json.dumps(rec, default=str) + "\n")
    except OSError:
        logger.exception("watchdog rank-failure note write failed")


def note_integrity(kind: str, ranks, detail: str = "") -> None:
    """Append a data-integrity evidence line (``wire_mismatch`` /
    ``digest_mismatch`` / ``quarantine``) naming the attributed ctx
    ranks, which tell detected corruption from silent corruption and
    from hangs."""
    if not ENABLED:
        return
    rec = {"ts": time.time(), "pid": os.getpid(), "reason": "integrity",
           "kind": kind, "ranks": sorted(int(r) for r in ranks),
           "detail": detail}
    try:
        with open(_file, "a") as fh:
            fh.write(json.dumps(rec, default=str) + "\n")
    except OSError:
        logger.exception("watchdog integrity note write failed")


# ---------------------------------------------------------------------------
# scan — called from ProgressQueue.progress() under `if watchdog.ENABLED:`
# ---------------------------------------------------------------------------

def check(queue: Any, now: Optional[float] = None) -> bool:
    """Scan one progress queue + the team registry for stalls; fire a
    dump for each newly-detected one. Returns True when a dump fired.

    The scan throttle is PER QUEUE: a process with several contexts
    (in-process multi-rank jobs, the test harness shape) calls check
    from every context's progress loop, and a single global stamp would
    hand the one scan slot per second to whichever queue polls first,
    starving the queue that actually holds the stuck task (escalation
    needs two scans of the right queue). The module-level
    ``_last_scan`` survives as a test hook: zeroing it forces the next
    check through regardless of the per-queue stamp."""
    global _last_scan
    if now is None:
        now = time.monotonic()
    last_q = getattr(queue, "_wd_last_scan", 0.0)
    if now - last_q < _SCAN_PERIOD and now - _last_scan < _SCAN_PERIOD:
        return False
    queue._wd_last_scan = now
    _last_scan = now

    stalled: List[Any] = []
    for task in list(getattr(queue, "_q", ())):
        if task.start_time and (now - task.start_time) > TIMEOUT and \
                task.seq_num not in _fired_tasks:
            _fired_tasks.add(task.seq_num)
            stalled.append(task)

    stalled_teams: List[Any] = []
    for team in list(TEAMS):
        state = getattr(team, "state", None)
        if state is None or getattr(state, "name", "") in ("ACTIVE",
                                                           "FAILED"):
            continue
        dwell = now - getattr(team, "state_since", now)
        if dwell > TIMEOUT and (id(team), state.name) not in _fired_teams:
            _fired_teams.add((id(team), state.name))
            stalled_teams.append(team)

    fired = False
    if stalled or stalled_teams:
        dump_state(queue, stalled, stalled_teams, now)
        fired = True
    if ACTION != "dump":
        fired = _escalate(queue, now) or fired
    return fired


def _escalate(queue: Any, now: float) -> bool:
    """The cancel/abort rungs: tasks IN_PROGRESS past HARD_TIMEOUT are
    cancelled (ERR_TIMED_OUT) — under ``abort``, one hard-stalled task
    condemns every in-flight task, since a collective stack with one
    wedged collective rarely has healthy neighbors (they share the
    fabric and usually the team), and stalled team creates are failed
    so ``create_test`` returns instead of spinning forever."""
    q = list(getattr(queue, "_q", ()))
    hard = [t for t in q
            if not t.is_completed() and getattr(t, "start_time", 0)
            and (now - t.start_time) > HARD_TIMEOUT]
    acted = False
    if ACTION == "abort":
        # only the abort rung condemns team creates: an operator who
        # opted into per-task cancel did not opt into failing a
        # legitimately slow large-job bootstrap
        for team in list(TEAMS):
            state = getattr(team, "state", None)
            if state is None or getattr(state, "name", "") in ("ACTIVE",
                                                               "FAILED"):
                continue
            dwell = now - getattr(team, "state_since", now)
            if dwell > HARD_TIMEOUT:
                fail = getattr(team, "fail", None)
                if fail is None:
                    continue
                try:
                    fail(Status.ERR_TIMED_OUT,
                         f"watchdog abort: create stalled {dwell:.1f}s "
                         f"in {state.name}")
                except Exception:  # noqa: BLE001
                    logger.exception("watchdog team fail raised")
                acted = True
    if hard:
        targets = [t for t in q if not t.is_completed()] \
            if ACTION == "abort" else hard
        # failure attribution (UCC_FT=shrink): before cancelling, report
        # each hard-stalled task's outstanding recv peers to the health
        # registry as suspects — a suspect whose heartbeat is also stale
        # is confirmed failed, feeding the shrink pipeline
        reg = getattr(queue, "_ft_health", None)
        if reg is not None:
            for t in hard:
                try:
                    reg.suspect_task_peers(t, now)
                except Exception:  # noqa: BLE001 - attribution best-effort
                    pass
        for t in targets:
            logger.error(
                "WATCHDOG: %s: cancelling task %s seq %s (coll=%s alg=%s) "
                "stuck > %.1fs", ACTION, type(t).__name__,
                getattr(t, "seq_num", "?"), getattr(t, "coll_name", None),
                getattr(t, "alg_name", None), HARD_TIMEOUT)
            cancel = getattr(t, "cancel", None)
            if cancel is None:
                continue
            try:
                cancel(Status.ERR_TIMED_OUT)
            except Exception:  # noqa: BLE001 - escalation must never kill
                logger.exception("watchdog cancel raised")
        acted = True
    return acted


# ---------------------------------------------------------------------------
# the dump
# ---------------------------------------------------------------------------

def _describe_task(task: Any, now: float) -> Dict[str, Any]:
    describe = getattr(task, "obs_describe", None)
    if describe is not None:
        try:
            return describe(now)
        except Exception:  # noqa: BLE001 - diagnostics must never raise
            pass
    return {"task": type(task).__name__,
            "seq": getattr(task, "seq_num", None),
            "status": getattr(getattr(task, "status", None), "name", "?")}


def _describe_team(team: Any, now: float) -> Dict[str, Any]:
    state = getattr(team, "state", None)
    d: Dict[str, Any] = {
        "team_id": getattr(team, "id", None),
        "rank": getattr(team, "rank", None),
        "size": getattr(team, "size", None),
        "state": getattr(state, "name", "?"),
        "dwell_s": round(now - getattr(team, "state_since", now), 3),
    }
    if getattr(state, "name", "") == "CL_AGREE":
        # a peer that failed every CL create and never posted its
        # agreement allgather (core/team.py _cl_agree_step) leaves
        # everyone else parked here
        d["hint"] = ("stuck in CL_AGREE: a peer likely failed CL create "
                     "and never posted the agreement allgather; its "
                     "local CL set is the thing to inspect")
    return d


def _occupancy_section() -> List[Dict[str, Any]]:
    """Mailbox backlog per live endpoint (unexpected-queue length,
    posted recvs, native slot-table in-use) — a backlog is invisible
    until it becomes a stall, so the dump samples it explicitly. Rows
    from the cross-process arena endpoints ride along (parked traffic +
    payload-block pressure per attached arena): block-class exhaustion
    there stalls exactly like a mailbox backlog but lives in another
    process's address space, so it has to be sampled from the shared
    segment."""
    rows: List[Dict[str, Any]] = []
    try:
        from ..tl.host.transport import occupancy_snapshot
        rows.extend(occupancy_snapshot())
    except Exception:  # noqa: BLE001 - diagnostics must never raise
        pass
    try:
        from ..tl.ipc import occupancy_snapshot as ipc_occupancy
        rows.extend(ipc_occupancy())
    except Exception:  # noqa: BLE001 - diagnostics must never raise
        pass
    return rows


def _config_provenance() -> Dict[str, Any]:
    """Resolved configuration in effect — so a pod-scale hang dump
    names the layer configuration without a repro: quant policy, tuner
    decisions (learned score rows), and the resolved hier tree
    (levels/leaders) per live team."""
    cfg: Dict[str, Any] = {
        "quant": {k: v for k, v in os.environ.items()
                  if k.startswith("UCC_QUANT")} or {"UCC_QUANT": "off"},
        "tuner": {"mode": os.environ.get("UCC_TUNER", "off") or "off"},
        "ft": os.environ.get("UCC_FT", "none") or "none",
    }
    teams = []
    for team in list(TEAMS):
        if getattr(getattr(team, "state", None), "name", "") != "ACTIVE":
            continue
        d: Dict[str, Any] = {"team_id": getattr(team, "id", None),
                             "size": getattr(team, "size", None),
                             "epoch": getattr(team, "epoch", 0)}
        try:
            sm = getattr(team, "score_map", None)
            if sm is not None:
                learned = [ln.strip() for ln in
                           sm.print_info("").splitlines()
                           if "learned" in ln]
                if learned:
                    d["tuner_learned"] = learned[:32]
        except Exception:  # noqa: BLE001
            pass
        try:
            for cl in getattr(team, "cl_teams", ()) or ():
                describe = getattr(cl, "describe_topology", None)
                if describe is not None:
                    d.setdefault("hier", {})[getattr(cl, "name", "?")] = \
                        describe().splitlines()
        except Exception:  # noqa: BLE001
            pass
        if len(d) > 3:
            teams.append(d)
    if teams:
        cfg["teams"] = teams
    return cfg


def dump_state(queue: Any, stalled: List[Any], stalled_teams: List[Any],
               now: Optional[float] = None,
               reason: str = "watchdog") -> Dict[str, Any]:
    """Build + emit the diagnostic report (log ERROR + JSON line)."""
    if now is None:
        now = time.monotonic()
    in_flight = [_describe_task(t, now)
                 for t in list(getattr(queue, "_q", ()))]
    report = {
        "ts": time.time(),
        "pid": os.getpid(),
        "reason": reason,
        "timeout_s": TIMEOUT,
        "progress_queue_depth": len(getattr(queue, "_q", ())),
        "stalled_tasks": [_describe_task(t, now) for t in stalled],
        "in_flight_tasks": in_flight,
        "teams": [_describe_team(t, now) for t in list(TEAMS)],
        "stalled_teams": [_describe_team(t, now) for t in stalled_teams],
        "transports": _occupancy_section(),
        "config": _config_provenance(),
    }
    # flight-recorder fold-in: collect every ring this process can see,
    # diagnose (desync / straggler / missing participant), and carry the
    # verdict inside the watchdog report — the dump that previously said
    # "something is stuck" now names the culprit when the rings can
    from . import flight as _flight
    if _flight.ENABLED:
        try:
            from . import diagnose as _diagnose
            merged = _flight.collect_process(None, reason=reason)
            diag = _diagnose.diagnose(merged)
            report["flight_diagnosis"] = diag
            merged["diagnosis"] = diag
            _flight.dump_merged(merged, diagnose=False)
            for line in diag.get("summary", ())[:8]:
                logger.error("WATCHDOG flight diagnosis: %s", line)
        except Exception:  # noqa: BLE001 - diagnostics must never raise
            logger.exception("flight diagnosis failed")
    for t in report["stalled_tasks"]:
        logger.error(
            "WATCHDOG: task stalled > %.1fs: %s", TIMEOUT,
            json.dumps(t, default=str))
    for t in report["stalled_teams"]:
        logger.error(
            "WATCHDOG: team create stalled > %.1fs in %s: %s", TIMEOUT,
            t.get("state"), json.dumps(t, default=str))
    logger.error(
        "WATCHDOG: state dump (%d in-flight, queue depth %d) -> %s",
        len(in_flight), report["progress_queue_depth"], _file)
    try:
        with open(_file, "a") as fh:
            fh.write(json.dumps(report, default=str) + "\n")
    except OSError:
        logger.exception("watchdog dump write failed")
    return report
