"""Flight recorder: always-on collective event rings.

Every rank keeps a small, fixed-size ring of compact collective lifecycle
events (post / start / complete / cancel / fence, with team key and
epoch, collective, algorithm, message size and monotonic timestamps),
cheap enough to leave on (``UCC_FLIGHT=y`` is the default;
``UCC_FLIGHT=n`` removes every append). When something goes wrong (a
watchdog escalation, a rank-failure detection, an operator ``SIGUSR2``,
or ``python -m ucc_tpu_torch.tools.fr``) the rings are collected across
ranks into one merged dump that ``obs/diagnose.py`` turns into names:
which rank posted a mismatched collective, which rank is the straggler,
what was in flight when a rank died.

- **Rings are preallocated and allocation-free.** Events live in
  fixed-size typed columns (``array('d')``/``array('q')``), strings and
  team keys interned to small integers: an append is a handful of
  unboxed stores and allocates nothing, so the rings never feed the
  garbage collector. Depth is a power of two (the wrap is a mask).
  Concurrent appends (ThreadMode MULTIPLE) may rarely tear one slot
  across two events, a corrupt event the diagnosis tolerates; there is
  no lock on the hot path.
- **Bound once.** Producers cache the ring reference once (the transport
  endpoint at construction, the CollRequest and the device task at
  init), so the cost is one attribute test when off and one append when
  on.
- **Two rings per rank.** The *coll* ring holds lifecycle events; the
  *wire* ring holds per-message events (send kinds direct/eager/rndv/
  fenced, and the device collectives' ``dev_launch``/``dev_ready``), so
  message storms cannot evict the lifecycle history.
- **Collection degrades gracefully.** ``collect_process`` merges every
  ring registered in this process (the watchdog and rank-failure
  triggers use it: peers cannot be assumed to cooperate mid-hang).
  ``FlightCollection`` is the cooperative gather over the service
  team's transport (``TransportOob``) among ranks believed alive; known
  dead ranks are named in ``absent_ranks`` instead of wedging it.

Dumps carry ``version`` = ``diagnose.DUMP_VERSION`` (a tag naming this
package), by which ``ucc_fr`` tells them from the JAX package's.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
import weakref
from array import array
from typing import Any, Dict, List, Optional

from ..status import Status
from ..utils.config import (ConfigField, ConfigTable, parse_bool,
                            parse_string, parse_uint, register_table)
from ..utils.log import get_logger

logger = get_logger("obs")

_FLIGHT_CONFIG = register_table(ConfigTable(
    prefix="", name="obs/flight", fields=[
        ConfigField("FLIGHT", "y",
                    "always-on flight recorder: per-rank ring of compact "
                    "collective lifecycle events (post/start/round/"
                    "complete/cancel/fence). Collected across ranks and "
                    "diagnosed on watchdog escalation, rank failure, "
                    "SIGUSR2, or via the ucc_fr CLI. n removes every "
                    "ring append", parse_string),
        ConfigField("FLIGHT_DEPTH", "2048",
                    "events kept per ring (rounded up to a power of "
                    "two); each rank keeps one collective-lifecycle ring "
                    "and one wire ring of this depth", parse_uint),
        ConfigField("FLIGHT_FILE", "ucc_flight.json",
                    "flight-dump destination: one JSON line per local "
                    "ring dump or merged cross-rank collection; read "
                    "with `ucc_fr <file>`", parse_string),
    ]))


def _resolve_knobs():
    from ..utils.config import Config
    try:
        cfg = Config(_FLIGHT_CONFIG)
        try:
            enabled = parse_bool(str(cfg.flight))
        except ValueError:
            enabled = True
        depth = int(cfg.flight_depth) or 2048
        return enabled, depth, str(cfg.flight_file)
    except Exception:  # noqa: BLE001 - knob resolution must never break import
        return True, 2048, "ucc_flight.json"


ENABLED, _DEPTH, _file = _resolve_knobs()

#: schema tag stamped into every dump (ucc_fr refuses records it does
#: not understand instead of mis-diagnosing them)
from .diagnose import DUMP_VERSION  # noqa: E402

# event kinds (coll ring)
EV_POST = "post"
EV_START = "start"
EV_COMPLETE = "cmpl"
EV_CANCEL = "cancel"
EV_FENCE = "fence"
# wire-ring kind codes: send transitions (tl/host/transport.py), plus the
# device-collective pair: "dev_launch" = the rendezvous launched the
# kernel, "dev_ready" = this rank observed its completion. The per-rank
# launch stamps share a (team, tag, slot) key across ranks, which is what
# the diagnosis's wire-lag signal joins on.
WIRE_KINDS = ("direct", "eager", "rndv", "fenced", "dev_launch",
              "dev_ready")


def _pow2(n: int) -> int:
    n = max(16, int(n))
    return 1 << (n - 1).bit_length()


class _Interner:
    """Hashable object -> small int, with reverse lookup for decode.
    Code 0 is reserved for None/empty. Growth is bounded by the label
    vocabulary (coll/alg/stage/status names, team keys, service tags)."""

    __slots__ = ("ids", "objs")

    def __init__(self):
        self.ids: Dict[Any, int] = {None: 0, "": 0}
        self.objs: List[Any] = [None]

    def code(self, obj) -> int:
        i = self.ids.get(obj)
        if i is None:
            i = self.ids[obj] = len(self.objs)
            self.objs.append(obj)
        return i

    def obj(self, i: int):
        return self.objs[i] if 0 <= i < len(self.objs) else None


_EV_CODES = {EV_POST: 1, EV_START: 2, EV_COMPLETE: 3, EV_CANCEL: 4,
             EV_FENCE: 5}
_EV_NAMES = {v: k for k, v in _EV_CODES.items()}
_WIRE_CODES = {k: i for i, k in enumerate(WIRE_KINDS)}


class CollRing:
    """Collective-lifecycle ring: fixed typed columns, allocation-free
    appends (see module doc). ``append`` takes pre-coded ints only."""

    __slots__ = ("idx", "mask", "ts", "ev", "team", "epoch", "fseq",
                 "seq", "coll", "alg", "stage", "auxf", "auxi", "strs")

    def __init__(self, depth: int, strs: _Interner):
        d = _pow2(depth)
        self.mask = d - 1
        self.idx = 0
        self.ts = array("d", bytes(8 * d))
        self.auxf = array("d", bytes(8 * d))
        for name in ("ev", "team", "epoch", "fseq", "seq", "coll", "alg",
                     "stage", "auxi"):
            setattr(self, name, array("q", bytes(8 * d)))
        self.strs = strs

    def append(self, ev: int, team: int, epoch: int, fseq: int, seq: int,
               coll: int, alg: int, stage: int, auxf: float,
               auxi: int) -> None:
        i = self.idx & self.mask
        self.ts[i] = time.monotonic()
        self.ev[i] = ev
        self.team[i] = team
        self.epoch[i] = epoch
        self.fseq[i] = fseq
        self.seq[i] = seq
        self.coll[i] = coll
        self.alg[i] = alg
        self.stage[i] = stage
        self.auxf[i] = auxf
        self.auxi[i] = auxi
        self.idx += 1

    @property
    def dropped(self) -> int:
        return max(0, self.idx - self.mask - 1)

    def events(self) -> List[Dict[str, Any]]:
        """JSON-safe decode, oldest-first (cold: collection/dump only)."""
        n = min(self.idx, self.mask + 1)
        first = (self.idx - n) & self.mask
        strs = self.strs
        out = []
        for j in range(n):
            i = (first + j) & self.mask
            evc = self.ev[i]
            ev = _EV_NAMES.get(evc)
            if ev is None:
                continue
            team = self.team[i]
            seq = self.seq[i]
            d: Dict[str, Any] = {
                "t": self.ts[i], "ev": ev,
                "team": (strs.obj(-team - 2) if team <= -2 else
                         (None if team == -1 else team)),
                "epoch": self.epoch[i],
                "seq": None if seq == -1 else seq,
            }
            if self.fseq[i] != -1:
                d["fseq"] = self.fseq[i]
            coll = strs.obj(self.coll[i])
            alg = strs.obj(self.alg[i])
            stage = strs.obj(self.stage[i])
            if coll:
                d["coll"] = coll
            if alg:
                d["alg"] = alg
            if stage:
                d["stage"] = stage
            if evc == 1:                       # post
                d["size"] = self.auxi[i]
            elif evc == 3:                     # cmpl
                d["dur_s"] = self.auxf[i]
                d["status"] = strs.obj(self.auxi[i]) or "?"
            elif evc == 4:                     # cancel
                d["status"] = strs.obj(self.auxi[i]) or "?"
            elif evc == 5:                     # fence
                d["purged"] = self.auxi[i]
            elif self.auxi[i] != -1:           # start: tag
                d["tag"] = self.auxi[i]
            out.append(d)
        return out


class WireRing:
    """Per-message round ring (send kind transitions). Same typed-column
    discipline; the team key and any non-int tag are interned."""

    __slots__ = ("idx", "mask", "ts", "kind", "tkey", "epoch", "tag",
                 "slot", "nbytes", "objs")

    def __init__(self, depth: int, objs: _Interner):
        d = _pow2(depth)
        self.mask = d - 1
        self.idx = 0
        self.ts = array("d", bytes(8 * d))
        for name in ("kind", "tkey", "epoch", "tag", "slot", "nbytes"):
            setattr(self, name, array("q", bytes(8 * d)))
        self.objs = objs

    def append(self, kind: str, key, nbytes: int) -> None:
        """One round event. *key* is the transport TagKey
        (team_key, epoch, coll_tag, slot, src)."""
        i = self.idx & self.mask
        self.ts[i] = time.monotonic()
        self.kind[i] = _WIRE_CODES.get(kind, 3)
        self.tkey[i] = self.objs.code(key[0])
        self.epoch[i] = key[1]
        tag = key[2]
        # int tags stored as-is (>= 0); tuple tags (service/active-set
        # spaces) interned into the negative range
        self.tag[i] = tag if type(tag) is int \
            else -(self.objs.code(tag) + 1)
        self.slot[i] = key[3]
        self.nbytes[i] = nbytes
        self.idx += 1

    @property
    def dropped(self) -> int:
        return max(0, self.idx - self.mask - 1)

    def events(self) -> List[Dict[str, Any]]:
        n = min(self.idx, self.mask + 1)
        first = (self.idx - n) & self.mask
        objs = self.objs
        out = []
        for j in range(n):
            i = (first + j) & self.mask
            tag = self.tag[i]
            k = self.kind[i]
            out.append({
                "t": self.ts[i], "ev": "snd",
                "kind": WIRE_KINDS[k] if 0 <= k < len(WIRE_KINDS)
                else "?",
                "tkey": _keystr(objs.obj(self.tkey[i])),
                "epoch": self.epoch[i],
                "tag": tag if tag >= 0 else str(objs.obj(-tag - 1)),
                "slot": self.slot[i], "nbytes": self.nbytes[i],
            })
        return out


class FlightRecorder:
    """Per-context (per-rank) pair of rings plus identity. Attached as
    ``context.flight``; registered process-wide so in-process collection
    can reach every rank's ring."""

    __slots__ = ("coll", "wire", "rank", "uid", "pid", "t0", "_strs",
                 "__weakref__")

    def __init__(self, rank: int, uid: str, depth: Optional[int] = None):
        d = depth if depth is not None else _DEPTH
        self._strs = _Interner()
        self.coll = CollRing(d, self._strs)
        self.wire = WireRing(d, self._strs)
        self.rank = int(rank)
        self.uid = uid
        self.pid = os.getpid()
        self.t0 = time.monotonic()

    # ------------------------------------------------------------------
    # recording helpers (hot-ish: one call per collective lifecycle step;
    # producers that run per message append to self.wire directly)
    def post(self, team_id, epoch: int, fseq: int, seq: int, coll: str,
             alg: str, msgsize: int) -> None:
        s = self._strs
        self.coll.append(1, team_id if team_id is not None else -1,
                         epoch, fseq, seq, s.code(coll), s.code(alg), 0,
                         0.0, msgsize)

    def start(self, team_id, epoch: int, seq: int, coll, alg,
              stage, tag) -> None:
        s = self._strs
        self.coll.append(2, team_id if team_id is not None else -1,
                         epoch, -1, seq, s.code(coll), s.code(alg),
                         s.code(stage), 0.0,
                         tag if type(tag) is int else -1)

    def complete(self, team_id, epoch: int, seq: int, coll, alg, stage,
                 dur_s: float, status: str) -> None:
        s = self._strs
        self.coll.append(3, team_id if team_id is not None else -1,
                         epoch, -1, seq, s.code(coll), s.code(alg),
                         s.code(stage), dur_s, s.code(status))

    def cancel(self, team_id, epoch: int, seq: int, coll, alg,
               status: str) -> None:
        s = self._strs
        self.coll.append(4, team_id if team_id is not None else -1,
                         epoch, -1, seq, s.code(coll), s.code(alg), 0,
                         0.0, s.code(status))

    def fence(self, team_key, min_epoch: int, purged: int) -> None:
        # the fenced tag space is a team KEY, not a team id: interned
        # and stored in the negative id range of the team column
        code = self._strs.code(_keystr(team_key))
        self.coll.append(5, -code - 2, min_epoch, -1, -1, 0, 0, 0,
                         0.0, purged)

    def membership(self, team_id, epoch: int, kind: str,
                   detail: str) -> None:
        """Membership-change marker (shrink / grow / join): rides the
        coll ring as a completed ``membership`` event, so a merged trace
        shows each epoch boundary inline with the collectives it fences
        — including on a JOINER whose ring has no pre-change history."""
        self.complete(team_id, epoch, -1, "membership", kind, detail,
                      0.0, "OK")

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe decode of both rings (cold path)."""
        return {
            "rank": self.rank,
            "uid": self.uid,
            "pid": self.pid,
            "t0": self.t0,
            "dropped": self.coll.dropped + self.wire.dropped,
            "events": self.coll.events(),
            "wire": self.wire.events(),
        }


def _keystr(k) -> str:
    return k if isinstance(k, str) else repr(k)


# ---------------------------------------------------------------------------
# process registry
# ---------------------------------------------------------------------------

#: context uid -> FlightRecorder. Weak: a recorder lives exactly as long
#: as its context (tests create hundreds of contexts per process).
_RECORDERS: "weakref.WeakValueDictionary[str, FlightRecorder]" = \
    weakref.WeakValueDictionary()
_REG_LOCK = threading.Lock()


def register_context(context) -> Optional[FlightRecorder]:
    """Create + register this context's recorder (``Context.__init__``).
    Returns None when the recorder is disabled — callers keep a None
    ``context.flight`` and every producer's one-branch guard stays
    false."""
    if not ENABLED:
        return None
    rec = FlightRecorder(getattr(context, "rank", 0),
                         getattr(context, "_ctx_uid", ""))
    with _REG_LOCK:
        _RECORDERS[rec.uid] = rec
    return rec


def recorders() -> List[FlightRecorder]:
    with _REG_LOCK:
        return list(_RECORDERS.values())


def configure(enabled: Optional[bool] = None, depth: Optional[int] = None,
              file: Optional[str] = None) -> None:
    """Runtime (re)configuration (tests/embedders; env read at import).
    Existing recorders keep their rings; *depth* applies to recorders
    created afterwards."""
    global ENABLED, _DEPTH, _file
    if enabled is not None:
        ENABLED = bool(enabled)
    if depth is not None:
        _DEPTH = int(depth)
    if file is not None:
        _file = file


# ---------------------------------------------------------------------------
# collection
# ---------------------------------------------------------------------------

def _merged_skeleton(reason: str) -> Dict[str, Any]:
    return {"version": DUMP_VERSION, "kind": "flight_merged",
            "reason": reason, "ts": time.time(), "pid": os.getpid(),
            "ranks": {}, "absent_ranks": []}


def collect_process(context=None, reason: str = "explicit"
                    ) -> Dict[str, Any]:
    """Merge every ring reachable INSIDE this process. With *context*,
    scope to that context's job (peers resolved through the context OOB
    address storage — uid per rank); without, merge every registered
    recorder. This is the trigger-side collection: watchdog escalation
    and rank-failure detection cannot assume remote ranks will
    cooperate, so they take what the process can see and name the rest
    absent."""
    merged = _merged_skeleton(reason)
    with _REG_LOCK:
        by_uid = dict(_RECORDERS)
    if context is not None and getattr(context, "addr_storage", None):
        for r, entry in enumerate(context.addr_storage):
            uid = entry.get("uid", "") if isinstance(entry, dict) else ""
            rec = by_uid.get(uid)
            if rec is None and r == context.rank:
                # no-OOB contexts don't exchange uids; our own ring is
                # reachable directly
                rec = getattr(context, "flight", None)
            if rec is not None:
                merged["ranks"][str(r)] = rec.snapshot()
            else:
                merged["absent_ranks"].append(r)
    else:
        for rec in by_uid.values():
            merged["ranks"].setdefault(str(rec.rank), rec.snapshot())
    return merged


class FlightCollection:
    """Nonblocking cross-rank ring gather over a team's service-team
    transport (the ``TransportOob`` tree), among the members
    believed ALIVE — ranks known dead (health registry, fault-injection
    kills) are excluded from the exchange and listed in the result's
    ``absent_ranks``, so collection past a killed rank yields a partial
    dump instead of a hang. Every surviving member must drive ``test()``
    (the TransportOob polling contract). ``result`` is the merged dump,
    identical on every member."""

    def __init__(self, team, reason: str = "explicit",
                 timeout: float = 30.0):
        from ..core.oob import TransportOob
        from ..fault import inject as fault
        self.team = team
        self.reason = reason
        self.status = Status.IN_PROGRESS
        self.result: Optional[Dict[str, Any]] = None
        self._timeout = timeout
        self._deadline = time.monotonic() + timeout
        ctx = team.context
        svc = team.service_team
        if svc is None or getattr(svc, "transport", None) is None:
            # no transport-backed service team (size-1 / facade teams):
            # local-only "collection" — still carries this rank's ring
            rec = getattr(ctx, "flight", None)
            self._req = None
            self._members = [team.rank]
            self._dead = []
            self._local_snap = rec.snapshot() if rec is not None else None
            return
        dead_ctx = set()
        reg = getattr(ctx, "health", None)
        if reg is not None:
            dead_ctx |= reg.dead_set()
        if fault.ENABLED:
            dead_ctx |= {r for r in fault.SPEC.kill}
        members, dead = [], []
        for tr in range(team.size):
            cr = int(team.ctx_map.eval(tr))
            (dead if cr in dead_ctx else members).append(tr)
        self._members = members
        self._dead = dead
        seq = getattr(team, "_flight_collect_seq", 0)
        team._flight_collect_seq = seq + 1
        member_ctx = [int(team.ctx_map.eval(r)) for r in members]
        # kept for the wait loop: a member that dies MID-collection shows
        # up as fresh health/fault evidence against these ctx ranks
        self._member_ctx = member_ctx
        self._dead_ctx0 = set(dead_ctx)
        oob = TransportOob(svc.comp_context, svc.transport, member_ctx,
                           ctx.rank, ("flight", team.team_key, seq),
                           team.epoch)
        import pickle
        rec = getattr(ctx, "flight", None)
        snap = rec.snapshot() if rec is not None else {
            "rank": ctx.rank, "uid": "", "pid": os.getpid(),
            "events": [], "wire": [], "dropped": 0}
        self._req = oob.allgather(pickle.dumps(snap))
        self._local_snap = None

    def test(self) -> Status:
        if self.status != Status.IN_PROGRESS:
            return self.status
        if self._req is None:
            self._finish([self._local_snap]
                         if self._local_snap is not None else None)
            return self.status
        try:
            st = self._req.test()
        except Exception as e:  # noqa: BLE001 - a torn-down transport mid-
            # collection degrades to a partial local view, never a raise
            logger.warning("flight collection exchange failed: %s", e)
            self._finish(None)
            return self.status
        if st == Status.IN_PROGRESS:
            died = self._died_mid_collection()
            if died:
                logger.warning(
                    "flight collection (%s): member rank(s) %s died "
                    "mid-collection; returning the partial dump now",
                    self.reason, ",".join(str(r) for r in died))
                self._finish(None, dead_now=died)
                return self.status
            if time.monotonic() > self._deadline:
                logger.warning(
                    "flight collection (%s) timed out after %.1fs; "
                    "degrading to the in-process view", self.reason,
                    self._timeout)
                self._finish(None)
            return self.status
        import pickle
        self._finish([pickle.loads(b) for b in self._req.result])
        return self.status

    def _died_mid_collection(self) -> List[int]:
        """Team ranks among the exchange members with FRESH death
        evidence (health registry / fault kills) that arrived after the
        exchange started. The up-front exclusion in ``__init__`` only
        sees deaths known at post time; without this check a rank dying
        mid-collection degrades the whole dump via the full deadline."""
        from ..fault import inject as fault
        ctx = self.team.context
        dead_ctx = set()
        reg = getattr(ctx, "health", None)
        if reg is not None:
            dead_ctx |= reg.dead_set()
        if fault.ENABLED:
            dead_ctx |= {r for r in fault.SPEC.kill}
        fresh = dead_ctx - self._dead_ctx0 - {ctx.rank}
        if not fresh:
            return []
        return sorted(tr for tr, cr in zip(self._members,
                                           self._member_ctx)
                      if cr in fresh)

    def _finish(self, snaps, dead_now: Optional[List[int]] = None
                ) -> None:
        team = self.team
        merged = _merged_skeleton(self.reason)
        if snaps is None:
            # timeout/failure/mid-death fallback: whatever this process
            # can see
            proc = collect_process(team.context, self.reason)
            merged["ranks"] = proc["ranks"]
            merged["partial"] = True
            present = {int(r) for r in merged["ranks"]}
            merged["absent_ranks"] = sorted(
                (set(range(team.size)) - present) | set(dead_now or ()))
            if dead_now:
                merged["mid_collection_dead"] = sorted(dead_now)
        else:
            for tr, snap in zip(self._members, snaps):
                merged["ranks"][str(tr)] = snap
            merged["absent_ranks"] = sorted(self._dead)
            if self._dead:
                merged["partial"] = True
        merged["team"] = getattr(team, "id", None)
        merged["team_size"] = getattr(team, "size", None)
        self.result = merged
        self.status = Status.OK


def collect_team_post(team, reason: str = "explicit",
                      timeout: float = 30.0) -> FlightCollection:
    """Post a cooperative cross-rank collection (every surviving member
    of *team* must call this in the same program order and poll
    ``test()`` while progressing its context)."""
    return FlightCollection(team, reason, timeout)


def collect_team(team, reason: str = "explicit",
                 timeout: float = 30.0) -> Dict[str, Any]:
    """Blocking convenience over :func:`collect_team_post` — usable when
    the other members progress concurrently (threads/processes)."""
    req = collect_team_post(team, reason, timeout)
    while req.test() == Status.IN_PROGRESS:
        team.context.progress()
        time.sleep(0)
    assert req.result is not None
    return req.result


# ---------------------------------------------------------------------------
# dumps
# ---------------------------------------------------------------------------

_dump_lock = threading.Lock()


def dump_merged(merged: Dict[str, Any], path: Optional[str] = None,
                diagnose: bool = True) -> str:
    """Append one merged dump (with its diagnosis folded in) as a JSON
    line; returns the path written."""
    path = path or _file
    if diagnose and "diagnosis" not in merged:
        try:
            from . import diagnose as _dz
            merged["diagnosis"] = _dz.diagnose(merged)
        except Exception:  # noqa: BLE001 - diagnostics must never raise
            logger.exception("flight diagnosis failed; dumping raw")
    try:
        with _dump_lock, open(path, "a") as fh:
            fh.write(json.dumps(merged, default=str) + "\n")
    except OSError:
        logger.exception("flight dump write failed")
    return path


def dump_local(recorder: FlightRecorder, reason: str = "explicit",
               path: Optional[str] = None) -> str:
    """Append one rank's ring snapshot as a JSON line (the per-rank
    building block ``ucc_fr`` merges offline)."""
    path = path or _file
    rec = {"version": DUMP_VERSION, "kind": "flight_local",
           "reason": reason, "ts": time.time()}
    rec.update(recorder.snapshot())
    try:
        with _dump_lock, open(path, "a") as fh:
            fh.write(json.dumps(rec, default=str) + "\n")
    except OSError:
        logger.exception("flight dump write failed")
    return path


def dump_all_local(reason: str = "explicit",
                   path: Optional[str] = None) -> int:
    """Dump every recorder registered in this process (SIGUSR2 path);
    returns the number written."""
    n = 0
    for rec in recorders():
        dump_local(rec, reason, path)
        n += 1
    return n


# ---------------------------------------------------------------------------
# triggers: rank failure + SIGUSR2 (watchdog escalation calls
# collect_process itself so the diagnosis lands inside its report)
# ---------------------------------------------------------------------------

def on_rank_failure(ctx_rank: int, source: str = "",
                    detail: str = "") -> None:
    """Rank-failure trigger (fault/health): collect what this process
    can see, diagnose, and dump with the failed rank named — the
    "what was in flight when rank N died" record. One shot per rank."""
    if not ENABLED:
        return
    noted = _failure_noted
    if ctx_rank in noted:
        return
    noted.add(ctx_rank)
    try:
        merged = collect_process(None, reason="rank_failed")
        merged["failed_rank"] = int(ctx_rank)
        merged["source"] = source
        if detail:
            merged["detail"] = detail
        dump_merged(merged)
    except Exception:  # noqa: BLE001 - diagnostics must never raise
        logger.exception("flight rank-failure dump failed")


_failure_noted: set = set()


def on_integrity(kind: str, ctx_rank: int, detail: str = "") -> None:
    """Data-integrity trigger (integrity subsystem): record the event in
    every ring this process can see (the merged dump then shows the
    corruption inline with the collectives around it), and on
    ``quarantine`` also dump — the "what was in flight when rank N was
    quarantined" record, one shot per rank like the failure path."""
    if not ENABLED:
        return
    for rec in recorders():
        rec.complete(-1, -1, -1, "integrity", kind,
                     f"ctx_rank={ctx_rank}", 0.0, "ERR_DATA_CORRUPTED")
    if kind != "quarantine" or ctx_rank in _integrity_noted:
        return
    _integrity_noted.add(ctx_rank)
    try:
        merged = collect_process(None, reason="quarantine")
        merged["quarantined_rank"] = int(ctx_rank)
        if detail:
            merged["detail"] = detail
        dump_merged(merged)
    except Exception:  # noqa: BLE001 - diagnostics must never raise
        logger.exception("flight quarantine dump failed")


_integrity_noted: set = set()


def reset() -> None:
    """Clear trigger one-shots (tests)."""
    _failure_noted.clear()
    _integrity_noted.clear()


_prev_sigusr2 = None
_signal_armed = False


def _sigusr2(signum, frame) -> None:
    # same no-inline-dump rule as obs.metrics: a short-lived thread waits
    # its turn instead of deadlocking a lock the main thread holds
    if ENABLED:
        threading.Thread(target=dump_all_local,
                         kwargs={"reason": "SIGUSR2"}, daemon=True,
                         name="ucc-flight-sigusr2").start()
    prev = _prev_sigusr2
    if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
        prev(signum, frame)


def _arm_signal() -> None:
    """Chain onto SIGUSR2 WITHOUT unseating an earlier handler (the
    metrics registry arms the same signal)."""
    global _prev_sigusr2, _signal_armed
    if _signal_armed:
        return
    try:
        _prev_sigusr2 = signal.getsignal(signal.SIGUSR2)
        signal.signal(signal.SIGUSR2, _sigusr2)
        _signal_armed = True
    except (ValueError, OSError):
        pass   # off-main-thread import: lose the signal, keep the rings


if ENABLED:
    _arm_signal()
