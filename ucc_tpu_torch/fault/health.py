"""Peer liveness: detect and attribute rank failures.

The detect and attribute steps of recovery (detect -> attribute -> agree
-> shrink -> resume). Every context gets a ``HealthRegistry`` that names
failed ranks from five kinds of evidence:

- **heartbeats**: each context stamps a process-visible liveness board
  every ``UCC_HEARTBEAT_INTERVAL`` seconds from its progress loop; a peer
  whose stamp goes stale past ``UCC_HEARTBEAT_TIMEOUT`` is failed. The
  board is in-process state: peers in other processes are judged by the
  liveness sources below.
- **liveness sources**: ``add_liveness_source`` takes an oracle that
  sees other processes (tl/ipc's arena pid board): a peer whose process
  is gone is failed without waiting for a watchdog.
- **transport evidence**: a send/recv post targeting a known-dead
  context rank fails fast with ``ERR_RANK_FAILED`` (tl/host/task.py).
- **watchdog escalation**: a hard-stalled task's outstanding recv peers
  are suspects; a suspect whose heartbeat is also stale is failed
  (obs/watchdog.py ``_escalate``).
- **fault injection**: ``UCC_FAULT=kill=R`` ranks never beat (and report
  themselves), so drills run the production detection path.

Everything is cold unless ``UCC_FT=shrink``: the progress queue tests
``health.ENABLED`` (a module-level boolean) first.

On detection the registry cancels every in-flight task whose team holds a
failed rank with ``Status.ERR_RANK_FAILED`` (stamping
``task.failed_ranks``), device tasks included, counts
``rank_failures_detected``, appends a ``rank_failed`` line to the
watchdog file when the watchdog is armed, and dumps the flight rings with
the failed rank named.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional, Set

from ..status import Status
from ..utils.log import get_logger
from . import inject

logger = get_logger("fault")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


#: recovery mode: "none" (default; zero-cost, seed behavior) or "shrink"
#: (liveness + agreement + Team.shrink available)
MODE: str = os.environ.get("UCC_FT", "none").strip().lower() or "none"
if MODE not in ("none", "shrink"):
    logger.warning("unknown UCC_FT mode %r; using 'none'", MODE)
    MODE = "none"
ENABLED: bool = MODE == "shrink"
HEARTBEAT_INTERVAL: float = _env_float("UCC_HEARTBEAT_INTERVAL", 0.05)
HEARTBEAT_TIMEOUT: float = _env_float("UCC_HEARTBEAT_TIMEOUT", 2.0)

#: process-visible liveness board: context uid -> last heartbeat
#: (time.monotonic). Contexts publish their own stamp; registries read
#: their peers'.
_BOARD: Dict[str, float] = {}
_BOARD_LOCK = threading.Lock()


def configure(mode: str = "none", interval: Optional[float] = None,
              timeout: Optional[float] = None) -> None:
    """Runtime (re)configuration (tests/embedders; env read at import)."""
    global MODE, ENABLED, HEARTBEAT_INTERVAL, HEARTBEAT_TIMEOUT
    mode = (mode or "none").strip().lower()
    if mode not in ("none", "shrink"):
        raise ValueError(f"UCC_FT mode must be none|shrink, got {mode!r}")
    MODE = mode
    ENABLED = mode == "shrink"
    if interval is not None:
        HEARTBEAT_INTERVAL = float(interval)
    if timeout is not None:
        HEARTBEAT_TIMEOUT = float(timeout)


def reset() -> None:
    """Disable and clear the board (tests)."""
    configure("none")
    with _BOARD_LOCK:
        _BOARD.clear()
    _STANDALONE_NOTED.clear()


#: ranks already attributed when no registry exists (UCC_FAULT=kill
#: drill without UCC_FT): keeps the fail-fast path's metric per-rank,
#: not per-send
_STANDALONE_NOTED: Set[int] = set()


def note_dead_target(ctx_rank: int, registry: Optional["HealthRegistry"],
                     source: str = "send", detail: str = "") -> None:
    """Attribution for a post that targeted a known-dead rank (the
    fail-fast path, tl/host/task.py). Idempotent per rank; routes
    through the registry when one exists."""
    if registry is not None:
        registry.report_failure(ctx_rank, source, detail)
        return
    ctx_rank = int(ctx_rank)
    if ctx_rank in _STANDALONE_NOTED:
        return
    _STANDALONE_NOTED.add(ctx_rank)
    logger.error("rank failure detected: ctx rank %d (source=%s%s)",
                 ctx_rank, source, f": {detail}" if detail else "")
    from ..obs import flight, metrics, watchdog
    if metrics.ENABLED:
        metrics.inc("rank_failures_detected", component="fault", alg=source)
    watchdog.note_rank_failure([ctx_rank], source, detail)
    # flight recorder: dump what this process can see with the failed
    # rank named — the "what was in flight when rank N died" record
    flight.on_rank_failure(ctx_rank, source, detail)


# ---------------------------------------------------------------------------
# per-context registry
# ---------------------------------------------------------------------------

class HealthRegistry:
    """Per-context failed/suspected rank bookkeeping. Attached as
    ``context.health`` when FT is enabled; fed from the context's
    progress loop (``check``), the fail-fast transport path
    (``report_failure``), and watchdog escalation (``suspect_task_peers``).
    """

    def __init__(self, context):
        self.context = context
        self.uid: str = context._ctx_uid
        #: failed ctx ranks -> {"source", "ts", "detail"}
        self.dead: Dict[int, Dict[str, Any]] = {}
        #: ctx rank -> suspicion count (watchdog reports not yet
        #: corroborated by a stale heartbeat)
        self.suspected: Dict[int, int] = {}
        self._peer_uids: Dict[int, str] = {}
        self._t0 = time.monotonic()
        self._last_beat = 0.0
        self._last_poll = 0.0
        self._lock = threading.Lock()
        #: external liveness oracles, ``fn(ctx_rank) -> Optional[bool]``
        #: (True = positively alive, False = conclusively dead, None =
        #: no verdict). The in-process heartbeat board cannot see peers
        #: in OTHER processes; a cross-process transport (tl/ipc arena
        #: pid board) registers a source here so process death is
        #: detected without waiting for a watchdog escalation.
        self._sources: list = []

    # -- wiring --------------------------------------------------------
    def add_liveness_source(self, fn) -> None:
        """Register a cross-process liveness oracle (see ``_sources``)."""
        self._sources.append(fn)

    def _source_verdict(self, ctx_rank: int) -> Optional[bool]:
        for fn in self._sources:
            try:
                v = fn(ctx_rank)
            except Exception:  # noqa: BLE001 - oracles are best-effort
                continue
            if v is not None:
                return v
        return None

    def set_peers(self, uids: Dict[int, str]) -> None:
        """ctx rank -> context uid, learned from the context OOB address
        exchange (core/context.py stuffs each context's uid into the
        exchanged payload)."""
        self._peer_uids = {int(r): u for r, u in uids.items() if u}

    # -- evidence ------------------------------------------------------
    def beat(self, now: Optional[float] = None) -> None:
        """Publish my liveness stamp. A fault-injection-killed rank
        stops beating — the drill-side simulation of process death."""
        if inject.ENABLED and inject.killed(self.context.rank):
            self.report_failure(self.context.rank, "inject",
                                "UCC_FAULT kill of this rank")
            return
        with _BOARD_LOCK:
            _BOARD[self.uid] = now if now is not None else time.monotonic()

    def poll(self, now: Optional[float] = None) -> Set[int]:
        """Check peer heartbeats; returns the set of NEWLY failed ctx
        ranks detected this scan."""
        now = now if now is not None else time.monotonic()
        newly: Set[int] = set()
        for rank, uid in self._peer_uids.items():
            if rank == self.context.rank or rank in self.dead:
                continue
            with _BOARD_LOCK:
                last = _BOARD.get(uid)
            if last is None:
                # never beaten HERE: the board is process-local, so a
                # healthy peer in ANOTHER process never appears on it —
                # abstain rather than condemn, unless a registered
                # cross-process source (tl/ipc arena pid board) returns
                # a conclusive death verdict
                if self._source_verdict(rank) is False:
                    if self.report_failure(
                            rank, "liveness",
                            "peer process dead (arena pid probe)"):
                        newly.add(rank)
                continue
            if now - last > HEARTBEAT_TIMEOUT:
                if self.report_failure(
                        rank, "heartbeat",
                        f"no heartbeat for {now - last:.3f}s "
                        f"(timeout {HEARTBEAT_TIMEOUT}s)"):
                    newly.add(rank)
        return newly

    def report_failure(self, ctx_rank: int, source: str,
                       detail: str = "") -> bool:
        """Mark *ctx_rank* failed. Idempotent: returns True only on the
        first report (which logs, counts ``rank_failures_detected``, and
        leaves watchdog-file evidence for CI classification)."""
        ctx_rank = int(ctx_rank)
        with self._lock:
            if ctx_rank in self.dead:
                return False
            self.dead[ctx_rank] = {"source": source, "detail": detail,
                                   "ts": time.time()}
            self.suspected.pop(ctx_rank, None)
        logger.error("rank failure detected: ctx rank %d (source=%s%s)",
                     ctx_rank, source, f": {detail}" if detail else "")
        from ..obs import flight, metrics, watchdog
        if metrics.ENABLED:
            metrics.inc("rank_failures_detected", component="fault",
                        alg=source)
        watchdog.note_rank_failure(sorted(self.dead), source, detail)
        flight.on_rank_failure(ctx_rank, source, detail)
        return True

    def suspect(self, ctx_rank: int, source: str = "watchdog",
                now: Optional[float] = None) -> bool:
        """A soft report (e.g. watchdog escalation naming a stuck recv
        peer): confirmed as failed only when the peer's heartbeat is
        ALSO stale — a slow-but-alive peer must not be declared dead by
        one stuck collective. Returns True when confirmed."""
        ctx_rank = int(ctx_rank)
        if ctx_rank in self.dead:
            return True
        now = now if now is not None else time.monotonic()
        uid = self._peer_uids.get(ctx_rank)
        with _BOARD_LOCK:
            last = _BOARD.get(uid) if uid else None
        # a peer that never beat on THIS process's board (cross-process
        # peer) cannot be condemned by staleness — suspicion only,
        # unless a cross-process source returns a death verdict
        if last is not None and now - last > HEARTBEAT_TIMEOUT:
            return self.report_failure(
                ctx_rank, source, "stalled task peer with stale heartbeat")
        if last is None and self._source_verdict(ctx_rank) is False:
            return self.report_failure(
                ctx_rank, source,
                "stalled task peer whose process is dead (arena pid probe)")
        with self._lock:
            self.suspected[ctx_rank] = self.suspected.get(ctx_rank, 0) + 1
        return False

    def suspect_task_peers(self, task, now: Optional[float] = None) -> None:
        """Watchdog-escalation attribution: report the task's outstanding
        recv peers as suspects (they are who the task is waiting on)."""
        reqs = getattr(task, "__dict__", {}).get("_obs_reqs") or ()
        ctx_of = getattr(task, "_ctx_of", None)
        if ctx_of is None:
            return
        for kind, peer, _slot, req in list(reqs):
            if kind != "recv" or req.test():
                continue
            try:
                self.suspect(ctx_of(peer), "watchdog", now)
            except Exception:  # noqa: BLE001 - attribution is best-effort
                pass

    # -- queries -------------------------------------------------------
    def is_dead(self, ctx_rank: int) -> bool:
        return ctx_rank in self.dead

    def dead_set(self) -> Set[int]:
        return set(self.dead)

    def is_fresh(self, ctx_rank: int, now: Optional[float] = None) -> bool:
        """Positive liveness evidence: the peer's heartbeat stamp is
        within ``HEARTBEAT_TIMEOUT``. Used by the agreement's round
        deadline to avoid mis-suspecting a slow-but-alive survivor
        (a slow survivor condemned at a round deadline). A peer that never beat on THIS process's board
        yields False — absence of evidence, not evidence of life."""
        uid = self._peer_uids.get(int(ctx_rank))
        if not uid:
            return False
        with _BOARD_LOCK:
            last = _BOARD.get(uid)
        if last is None:
            # cross-process peer: a registered source's recent arena
            # beat is the same positive evidence
            return self._source_verdict(int(ctx_rank)) is True
        now = now if now is not None else time.monotonic()
        return now - last <= HEARTBEAT_TIMEOUT

    # -- elastic membership --------------------------------------------
    def revive(self, ctx_rank: int, source: str = "grow",
               detail: str = "") -> bool:
        """Re-admit *ctx_rank*: clear it from the failed/suspected sets
        and refresh its board stamp (a grace period so the next poll
        scan does not instantly re-condemn a joiner whose progress loop
        has not beaten yet). The reverse transition of
        ``report_failure``; used by ``Team.grow`` / ``Team.join`` when
        membership agreement admits the rank back. Returns True when
        the rank was previously marked dead."""
        ctx_rank = int(ctx_rank)
        with self._lock:
            was = self.dead.pop(ctx_rank, None)
            self.suspected.pop(ctx_rank, None)
        # re-admission wipes the integrity strike ledger too: a rank
        # quarantined for corruption rejoins with a clean slate (its first
        # mismatch after the rejoin starts a fresh budget)
        from .. import integrity
        integrity.clear_strikes(self.context, ctx_rank)
        _STANDALONE_NOTED.discard(ctx_rank)
        uid = self._peer_uids.get(ctx_rank)
        if uid:
            with _BOARD_LOCK:
                _BOARD[uid] = time.monotonic()
        if was is not None:
            logger.warning(
                "ctx rank %d re-admitted (source=%s%s; was dead via %s)",
                ctx_rank, source, f": {detail}" if detail else "",
                was.get("source", "?"))
        return was is not None

    # -- progress hook -------------------------------------------------
    def check(self, queue, now: Optional[float] = None) -> None:
        """Called from the owning context's progress loop (under
        ``health.ENABLED``): beat, poll peers, and bound every in-flight
        task that depends on a failed rank."""
        now = now if now is not None else time.monotonic()
        if now - self._last_beat >= HEARTBEAT_INTERVAL:
            self._last_beat = now
            self.beat(now)
        if now - self._last_poll >= HEARTBEAT_INTERVAL:
            self._last_poll = now
            self.poll(now)
            if self.dead:
                self._cancel_dead_team_tasks(queue)

    def _cancel_dead_team_tasks(self, queue) -> None:
        """Cancel (ERR_RANK_FAILED) every queued task whose team contains
        a failed rank — run on every poll scan, not just the detection
        transition, so a collective posted AFTER detection on a
        not-yet-shrunk team is bounded too."""
        dead = self.dead_set()

        def failed_for(task):
            members = _team_member_ctx_ranks(task.team)
            return members & dead if members else None

        cancel_queued_tasks(queue, failed_for, Status.ERR_RANK_FAILED)


def cancel_queued_tasks(queue, failed_for, status) -> int:
    """Shared bound-the-damage loop (used by the health scan and by
    ``Team._cancel_in_flight``): cancel every live queued task for which
    ``failed_for(task)`` returns a non-empty set of failed CONTEXT
    ranks, stamping ``task.failed_ranks`` for attribution. Recovery
    traffic (agreement tasks routing AROUND the dead ranks) is exempt
    via ``task._ft_exempt``. Returns the number cancelled."""
    n = 0
    for task in list(getattr(queue, "_q", ())):
        if task.is_completed() or getattr(task, "_ft_exempt", False):
            continue
        failed = failed_for(task)
        if not failed:
            continue
        task.failed_ranks = sorted(int(r) for r in failed)
        logger.warning(
            "cancelling %s seq %d: depends on failed ctx rank(s) %s",
            type(task).__name__, task.seq_num, task.failed_ranks)
        task.cancel(status)
        n += 1
    return n


def _team_member_ctx_ranks(team) -> Optional[Set[int]]:
    """Member context ranks of a task's team (TL team or core team),
    cached on the core team — O(size) once, O(1) per scan."""
    if team is None:
        return None
    core = getattr(team, "core_team", team)
    cached = getattr(core, "_ft_member_ctx", None)
    if cached is not None:
        return cached
    ctx_map = getattr(core, "ctx_map", None)
    size = getattr(core, "size", 0)
    if ctx_map is None:
        members = set(range(size))
    else:
        try:
            members = {int(ctx_map.eval(i)) for i in range(size)}
        except Exception:  # noqa: BLE001 - facade teams may lack maps
            return None
    try:
        core._ft_member_ctx = members
    except Exception:  # noqa: BLE001 - frozen/slotted facade
        pass
    return members


# ---------------------------------------------------------------------------
# progress-queue hook — called under `if health.ENABLED:`
# ---------------------------------------------------------------------------

def check(queue) -> None:
    reg = getattr(queue, "_ft_health", None)
    if reg is not None:
        reg.check(queue)
