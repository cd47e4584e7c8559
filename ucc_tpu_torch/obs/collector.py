"""Continuous telemetry collector: the flight recorder as a control loop.

The flight recorder (obs/flight.py) answers *what happened* only when
something triggers a dump. This module runs it continuously and feeds
what it learns back into selection:

- a background **collection service** (``UCC_COLLECT=y``, owned by the
  context) that periodically snapshots every watched team's ring
  *window* (the events since the previous window) and gathers it across
  ranks over the service team's transport (``core/oob.TransportOob``,
  the channel on-demand collection rides);
- **per-pod merge before forwarding up**: window snapshots are
  exchanged inside each level-0 group of the team's hier tree, each
  group reduces its raw rings to a compact severity summary, and only
  the summaries travel between group leaders, so no rank ever holds
  O(world) raw rings;
- a rolling **on-disk trace store** (bounded JSON-line segments,
  ``UCC_COLLECT_DIR``) that ``ucc_fr`` merges and tails;
- an incremental **straggler scorer** (obs/diagnose.StragglerScorer):
  per-rank EWMA slowness from the window-scoped straggler signals
  (device rounds stamp ``dev_launch``/``dev_ready`` on the wire ring, so
  a late device rank scores like a late host sender), with hysteresis;
- the **feedback edge**: a per-team :class:`RankBias` that selection
  consults. The score map demotes ring-family algorithms whose critical
  path serializes through a flagged rank, the online tuner weights its
  rank-0 medians, the cost model scales a flagged rank's link terms,
  and cl/hier demotes flagged ranks from leader positions at (re)build.

Divergence safety: every rank derives the flagged set from the SAME
global summary (the stage-3 rebroadcast), and a new table only takes
effect at a deterministic flight-sequence index (``apply_at`` = the
window's largest ``flight_seq`` + ``UCC_RANK_BIAS_SLACK``), the
switch-at-a-post-index rule of the tuner's decision, because ranks that
disagree on candidate order deadlock the team.

Threading: the collector THREAD only marks windows due on a timer; all
transport work (posting and polling the window exchanges) runs from
``Context.progress()``, so the collector never races the progress loop.
Telemetry never raises into a rebuild or the progress loop.

Store records carry ``version`` = ``diagnose.DUMP_VERSION`` (a tag naming
this package); :func:`load_dir_records` skips records of another schema,
so the JAX package's store is not merged into this one's.
"""
from __future__ import annotations

import json
import os
import pickle
import threading
import time
import weakref
from typing import Any, Dict, FrozenSet, List, Optional

from ..status import Status
from ..utils.config import (ConfigField, ConfigTable, parse_bool,
                            parse_double, parse_string, parse_uint,
                            register_table)
from ..utils.log import get_logger
from .diagnose import DUMP_VERSION

logger = get_logger("obs")

_COLLECT_CONFIG = register_table(ConfigTable(
    prefix="", name="obs/collector", fields=[
        ConfigField("COLLECT", "n",
                    "continuous telemetry collection: a background "
                    "service gathers flight-recorder ring windows "
                    "cross-rank over the service team, merges them "
                    "per-pod along the hier tree, scores per-rank "
                    "slowness, and publishes a RankBias table that "
                    "algorithm selection consults. n = forensic-only "
                    "flight recorder (dump-triggered collection)",
                    parse_string),
        ConfigField("COLLECT_INTERVAL", "30.0",
                    "seconds between collection windows (the timer that "
                    "marks a window due; exchanges run on the progress "
                    "thread)", parse_double),
        ConfigField("COLLECT_SAMPLE", "1",
                    "collect every Nth window: window indices not "
                    "divisible by N are skipped without any exchange "
                    "(deterministic across ranks). 1 = every window",
                    parse_uint),
        ConfigField("COLLECT_DIR", "ucc_traces",
                    "rolling on-disk trace store: per-pod merged window "
                    "dumps and global severity summaries appended as "
                    "JSON lines into bounded segment files; read with "
                    "`ucc_fr <dir>` / `ucc_fr <dir> --tail N`. Empty "
                    "disables the store", parse_string),
        ConfigField("COLLECT_SEGMENT_BYTES", "4194304",
                    "trace-store segment rotation threshold (bytes)",
                    parse_uint),
        ConfigField("COLLECT_SEGMENTS", "8",
                    "trace-store segments kept per process; the oldest "
                    "is deleted on rotation", parse_uint),
        ConfigField("RANK_BIAS", "y",
                    "feed collector straggler findings back into "
                    "algorithm selection: flagged ranks demote "
                    "ring-family candidates in the score map, weight "
                    "tuner medians, scale cost-model link terms, and "
                    "are demoted from hier-tree leader positions at "
                    "team (re)build. n = observe-only collection",
                    parse_string),
        ConfigField("RANK_BIAS_DECAY", "0.5",
                    "EWMA weight of the newest window's severity in a "
                    "rank's slowness score (0..1; higher reacts faster)",
                    parse_double),
        ConfigField("RANK_BIAS_FLAG_ON", "0.7",
                    "slowness score a rank must reach (with "
                    "UCC_RANK_BIAS_WINDOWS consecutive slow windows) to "
                    "be flagged", parse_double),
        ConfigField("RANK_BIAS_FLAG_OFF", "0.2",
                    "hysteresis: a flagged rank unflags only once its "
                    "score decays below this", parse_double),
        ConfigField("RANK_BIAS_WINDOWS", "2",
                    "consecutive slow windows required before a rank "
                    "can be flagged (transient spikes never flag)",
                    parse_uint),
        ConfigField("RANK_BIAS_PENALTY", "4096",
                    "score-map penalty per flagged member on the "
                    "critical path of a ring-family candidate; any "
                    "penalized candidate orders after every unpenalized "
                    "one (user-forced `inf` scores are exempt)",
                    parse_uint),
        ConfigField("RANK_BIAS_SLACK", "16",
                    "flight-sequence posts between a window's global "
                    "summary and the deterministic index at which every "
                    "rank applies the new RankBias to selection (the "
                    "tuner-style divergence-free switch point)",
                    parse_uint),
        ConfigField("RANK_BIAS_SLOW_MULT", "4.0",
                    "slowness multiplier on a flagged rank's cost-model "
                    "link terms (and the tuner's ring-family medians): "
                    "searched/tuned programs price traffic through a "
                    "flagged rank this many times slower",
                    parse_double),
    ]))


class _Knobs:
    """Resolved collector knobs; module-level so that tests and drills can
    override them through :func:`configure` without the environment."""

    def __init__(self):
        from ..utils.config import Config
        self.enabled = False
        self.interval = 30.0
        self.sample = 1
        self.dir = "ucc_traces"
        self.segment_bytes = 4 << 20
        self.segments = 8
        self.bias = True
        self.decay = 0.5
        self.flag_on = 0.7
        self.flag_off = 0.2
        self.windows = 2
        self.penalty = 4096
        self.slack = 16
        self.slow_mult = 4.0
        try:
            cfg = Config(_COLLECT_CONFIG)
            try:
                self.enabled = parse_bool(str(cfg.collect))
            except ValueError:
                self.enabled = False
            self.interval = max(0.05, float(cfg.collect_interval))
            self.sample = max(1, int(cfg.collect_sample))
            self.dir = str(cfg.collect_dir)
            self.segment_bytes = max(4096, int(cfg.collect_segment_bytes))
            self.segments = max(1, int(cfg.collect_segments))
            try:
                self.bias = parse_bool(str(cfg.rank_bias))
            except ValueError:
                self.bias = True
            self.decay = min(1.0, max(0.01, float(cfg.rank_bias_decay)))
            self.flag_on = float(cfg.rank_bias_flag_on)
            self.flag_off = float(cfg.rank_bias_flag_off)
            self.windows = max(1, int(cfg.rank_bias_windows))
            self.penalty = int(cfg.rank_bias_penalty)
            self.slack = max(1, int(cfg.rank_bias_slack))
            self.slow_mult = max(1.0, float(cfg.rank_bias_slow_mult))
        except Exception:  # noqa: BLE001 - knob resolution never breaks import
            pass


KNOBS = _Knobs()
ENABLED = KNOBS.enabled


def configure(**kw) -> None:
    """Runtime (re)configuration; the environment is read at import.
    Keyword names are :class:`_Knobs` attributes (``enabled`` among
    them); an unknown name raises AttributeError."""
    global ENABLED
    for k, v in kw.items():
        if not hasattr(KNOBS, k):
            raise AttributeError(f"unknown collector knob {k!r}")
        setattr(KNOBS, k, v)
    ENABLED = KNOBS.enabled


# ---------------------------------------------------------------------------
# RankBias: the feedback table selection consults
# ---------------------------------------------------------------------------

#: algorithm-name tokens whose critical path serializes through EVERY
#: team member (one slow rank stalls each round): the candidates a
#: flagged rank demotes. Tree and knomial families route around a slow
#: leaf. tl/ring_cuda's ``ring_cuda`` and tl/torch_ops' ``ring`` are
#: ring-family; ``xla`` and ``short`` are not.
_RING_TOKENS = ("ring", "sliding", "sra")


def is_ring_family(alg_name: str, gen: str = "") -> bool:
    s = f"{alg_name or ''} {gen or ''}".lower()
    return any(tok in s for tok in _RING_TOKENS)


class RankBias:
    """Per-team straggler feedback table published by the collector.

    ``flagged`` holds TEAM ranks currently scored slow (the scorer's
    hysteresis keeps it stable); ``scores`` the underlying EWMA values.
    :meth:`publish` stages a new table and :meth:`tick` promotes it once
    the team's flight sequence reaches the staged ``apply_at``: every
    rank ticks at the same program-order points, so the flagged set (and
    with it the candidate order) never diverges across ranks.
    """

    __slots__ = ("penalty", "slow_mult", "flagged", "scores", "window",
                 "_pending", "first_flag_window")

    def __init__(self, penalty: Optional[int] = None,
                 slow_mult: Optional[float] = None):
        self.penalty = KNOBS.penalty if penalty is None else int(penalty)
        self.slow_mult = KNOBS.slow_mult if slow_mult is None \
            else float(slow_mult)
        self.flagged: FrozenSet[int] = frozenset()
        self.scores: Dict[int, float] = {}
        self.window = -1
        self._pending = None
        #: window index of the first nonempty flagged set ever published
        #: (drills count "flagged within N windows" from it)
        self.first_flag_window: Optional[int] = None

    # -- collector side -------------------------------------------------
    def publish(self, flagged, scores: Dict[int, float], window: int,
                apply_at: int) -> None:
        flagged = frozenset(flagged)
        if flagged and self.first_flag_window is None:
            self.first_flag_window = int(window)
        p = self._pending
        if p is not None and p[1] == flagged:
            # the same flagged set again: refresh the observations but
            # KEEP the first switch index. Re-staging with a fresh
            # apply_at every window would push the switch past the post
            # frontier of a team that posts fewer than `slack`
            # collectives a window, and the table would never apply
            self._pending = (p[0], flagged, dict(scores), int(window))
            return
        if p is None and flagged == self.flagged:
            # no change of candidate order: fold the fresh scores in
            # place (selection reads only `flagged`, so this cannot
            # diverge)
            self.scores = dict(scores)
            self.window = int(window)
            return
        self._pending = (int(apply_at), flagged, dict(scores),
                         int(window))

    # -- dispatch side --------------------------------------------------
    def tick(self, flight_seq: int) -> None:
        """Promote a staged table once the switch index is reached.
        Called from dispatch in program order on every rank."""
        p = self._pending
        if p is not None and flight_seq >= p[0]:
            self._pending = None
            _, self.flagged, self.scores, self.window = p

    def penalty_units(self, cand) -> int:
        """Flagged members on *cand*'s critical path: a ring-family
        candidate serializes through every member, so it pays one unit a
        flagged rank; a tree-family candidate pays none."""
        if not self.flagged:
            return 0
        if is_ring_family(getattr(cand, "alg_name", "") or "",
                          getattr(cand, "gen", "") or ""):
            return len(self.flagged)
        return 0

    def reorder(self, cands: List[Any]) -> List[Any]:
        """Bias-aware candidate order (ScoreMap.lookup): every candidate
        that pays a penalty sorts after every one that does not (a
        user-forced SCORE_MAX entry is exempt: an explicit `inf` still
        outranks feedback), and penalized candidates order among
        themselves by score minus ``penalty`` per flagged member. The
        input order and the flagged set are the same on every rank, so
        the output is too."""
        if not self.flagged:
            return cands
        from ..score.score import SCORE_MAX

        def key(p):
            i, r = p
            u = 0 if r.score >= SCORE_MAX else self.penalty_units(r)
            return (1 if u else 0, -(r.score - u * self.penalty), i)

        return [r for _, r in sorted(enumerate(cands), key=key)]

    def time_multiplier(self, alg_name: str, gen: str = "") -> float:
        """The weight the tuner's rank-0 decision gives a measured
        median: a ring-family candidate's is inflated per flagged
        member, so a winner that serializes through a straggler must
        beat the others by the slowness factor to stay the winner."""
        if not self.flagged or not is_ring_family(alg_name, gen):
            return 1.0
        return 1.0 + (self.slow_mult - 1.0) * len(self.flagged)

    def slow_map(self) -> Dict[int, float]:
        """{team rank: multiplier} for the cost model's per-rank
        slowness (score/cost.CostModel.predict_us's ``slow``)."""
        return {r: self.slow_mult for r in self.flagged}

    def describe(self) -> str:
        if not self.flagged and not self.scores:
            return "rank bias: clean"
        segs = [f"rank bias (window {self.window}):"]
        for r in sorted(self.scores):
            mark = " FLAGGED" if r in self.flagged else ""
            segs.append(f" r{r}={self.scores[r]:.2f}{mark}")
        return "".join(segs)


# ---------------------------------------------------------------------------
# rolling on-disk trace store
# ---------------------------------------------------------------------------

#: segment file prefix: per process (the pid follows), and not the JAX
#: package's ``fr-``, so neither package's rotation deletes the other's
#: segments in a shared directory
SEGMENT_PREFIX = "frt-"


class TraceStore:
    """Bounded JSON-line segment files under one directory. Rotation is
    by size; at most ``max_segments`` segments are kept per process (the
    oldest deleted first). Segment names carry the pid, so processes of
    one job can share a directory without interleaving writes."""

    def __init__(self, dirpath: str, segment_bytes: int,
                 max_segments: int):
        self.dir = dirpath
        self.segment_bytes = int(segment_bytes)
        self.max_segments = max(1, int(max_segments))
        self._lock = threading.Lock()
        self._seq = 0
        self._cur: Optional[str] = None
        self._cur_bytes = 0

    def _segment_name(self, seq: int) -> str:
        return os.path.join(
            self.dir, f"{SEGMENT_PREFIX}{os.getpid()}-{seq:06d}.jsonl")

    def _my_segments(self) -> List[str]:
        mine = f"{SEGMENT_PREFIX}{os.getpid()}-"
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.startswith(mine) and n.endswith(".jsonl"))
        except OSError:
            return []
        return [os.path.join(self.dir, n) for n in names]

    def append(self, rec: Dict[str, Any]) -> Optional[str]:
        """Append one record; returns the segment written (None when the
        store failed: telemetry never raises into its caller)."""
        line = json.dumps(rec, default=str) + "\n"
        with self._lock:
            try:
                os.makedirs(self.dir, exist_ok=True)
                if self._cur is None or \
                        self._cur_bytes >= self.segment_bytes:
                    self._rotate()
                with open(self._cur, "a") as fh:
                    fh.write(line)
                self._cur_bytes += len(line)
                return self._cur
            except OSError:
                logger.exception("trace store append failed")
                return None

    def _rotate(self) -> None:
        self._seq += 1
        self._cur = self._segment_name(self._seq)
        self._cur_bytes = 0
        segs = self._my_segments()
        # the new segment does not exist yet; +1 counts it
        excess = len(segs) + 1 - self.max_segments
        for path in segs[:max(0, excess)]:
            try:
                os.remove(path)
            except OSError:
                pass


def load_dir_records(dirpath: str,
                     tail: Optional[int] = None) -> List[Dict[str, Any]]:
    """Read trace-store records from *dirpath* (every process's segments,
    oldest first by mtime, then name). ``tail`` keeps only the N freshest
    segments (``ucc_fr --tail``). Lines that are not JSON objects are
    skipped, and so are records whose ``version`` names another schema
    (the JAX package's store stamps 1); unversioned lines are read."""
    try:
        names = [n for n in os.listdir(dirpath) if n.endswith(".jsonl")]
    except OSError:
        return []
    paths = [os.path.join(dirpath, n) for n in names]

    def order(p):
        try:
            return (os.stat(p).st_mtime, p)
        except OSError:
            return (0.0, p)

    paths.sort(key=order)
    if tail is not None:
        paths = paths[-max(1, int(tail)):]
    recs: List[Dict[str, Any]] = []
    for p in paths:
        try:
            with open(p) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and \
                            rec.get("version", DUMP_VERSION) == DUMP_VERSION:
                        recs.append(rec)
        except OSError:
            continue
    return recs


# ---------------------------------------------------------------------------
# per-team window state machine
# ---------------------------------------------------------------------------

def _window_events(events: List[dict], cut: float) -> List[dict]:
    """Events newer than *cut*, PLUS the post events of any completion
    inside the window (the scorer's duration join needs the post even
    when it predates the window)."""
    if cut <= 0.0:
        return list(events)
    out = [ev for ev in events if (ev.get("t") or 0.0) > cut]
    need = {ev.get("seq") for ev in out
            if ev.get("ev") == "cmpl" and ev.get("seq") is not None}
    if need:
        have = {ev.get("seq") for ev in out if ev.get("ev") == "post"}
        for ev in events:
            if ev.get("ev") == "post" and ev.get("seq") in need and \
                    ev.get("seq") not in have and \
                    (ev.get("t") or 0.0) <= cut:
                out.append(ev)
        # back to ring (time) order: the cmpl->post join walks events in
        # sequence, and a post appended AFTER its cmpl never joins
        out.sort(key=lambda ev: ev.get("t") or 0.0)
    return out


class _TeamWatch:
    """One watched team's collection state: window counters, the 3-stage
    exchange in flight (if any), the incremental scorer and the
    published RankBias."""

    # exchange stages of one sampled window
    ST_GATHER = 1      # intra-group allgather of raw window snapshots
    ST_LEADERS = 2     # leaders-only allgather of pod summaries
    ST_BCAST = 3       # intra-group rebroadcast of the global summary

    def __init__(self, service: "CollectorService", team):
        from . import diagnose
        self.service = service
        self.team_ref = weakref.ref(team)
        self.window = 0            # next window index to run
        self.due = 0               # windows the timer has marked due
        self.stage = 0             # 0 = idle
        self.cut_t = 0.0           # ring high-water mark (monotonic)
        self._req = None
        self._deadline = 0.0
        self._pod_summary: Optional[dict] = None
        self._global: Optional[dict] = None
        # level-0 group (team ranks) and group leaders from the hier
        # tree: the per-pod merge domain. Flat and one-node teams are one
        # group over the team (stages 2 and 3 skipped).
        tree = None
        try:
            if team.topo is not None and team.size > 1:
                tree = team.topo.hier_tree()
        except Exception:  # noqa: BLE001 - a topology quirk must not
            logger.exception("collector: hier tree build failed; "
                             "using a flat group")
        if tree is not None and len(tree.level(0).groups) > 1:
            self.group = list(tree.group(0, team.rank))
            self.leaders = [g[0] for g in tree.level(0).groups]
        else:
            self.group = list(range(team.size))
            self.leaders = [self.group[0]]
        self.is_leader = team.rank == self.group[0]
        self.is_top = team.rank == self.leaders[0]
        k = KNOBS
        self.scorer = diagnose.StragglerScorer(
            decay=k.decay, flag_on=k.flag_on, flag_off=k.flag_off,
            windows=k.windows)
        self.bias = RankBias() if k.bias else None
        if self.bias is not None:
            team.rank_bias = self.bias

    # ------------------------------------------------------------------
    def _oob(self, team, members: List[int], stage: int):
        from ..core.oob import TransportOob
        svc = team.service_team
        member_ctx = [int(team.ctx_map.eval(r)) for r in members]
        return TransportOob(
            svc.comp_context, svc.transport, member_ctx,
            team.context.rank,
            ("fcw", team.team_key, self.window, stage), team.epoch)

    def _snapshot_window(self, team) -> dict:
        rec = getattr(team.context, "flight", None)
        snap = rec.snapshot() if rec is not None else {
            "rank": team.rank, "uid": "", "pid": os.getpid(),
            "events": [], "wire": [], "dropped": 0}
        cut = self.cut_t
        snap["events"] = _window_events(snap.get("events") or [], cut)
        # drop the collector's OWN exchange traffic ("fcw" keys): quiet
        # windows would otherwise be dominated by it, and the wire-lag
        # detector would see rounds the application never ran
        snap["wire"] = [w for w in (snap.get("wire") or [])
                        if (w.get("t") or 0.0) > cut
                        and "fcw" not in str(w.get("tkey"))]
        snap["window"] = self.window
        # the tenants' QoS counters ride with the window (queue wait per
        # team, lane depths, inversion and starvation counters since the
        # last window; schedule/progress.qos_snapshot), kept in the pod
        # record for ucc_fr and offline analysis
        try:
            snap["qos"] = team.context.progress_queue.qos_snapshot(
                reset=True)
        except Exception:  # noqa: BLE001 - telemetry must never take
            # down the window exchange
            pass
        return snap

    def step(self) -> None:
        team = self.team_ref()
        if team is None or team._destroyed or team._shrunk:
            self.service.unwatch(self)
            return
        if self.stage == 0:
            if self.due <= self.window:
                return
            if self.window % KNOBS.sample:
                self.window += 1        # unsampled window: no exchange
                return
            self._start(team)
            return
        req = self._req
        if req is None:
            return
        try:
            st = req.test()
        except Exception as e:  # noqa: BLE001 - a transport torn down
            # mid-window abandons the window, it never raises
            logger.warning("collector window %d exchange failed: %s",
                           self.window, e)
            self._abandon()
            return
        if st == Status.IN_PROGRESS:
            if time.monotonic() > self._deadline:
                logger.warning(
                    "collector window %d stage %d timed out; abandoning",
                    self.window, self.stage)
                self._abandon()
            return
        try:
            self._advance(team, req.result)
        except Exception:  # noqa: BLE001 - telemetry must never take
            # down the progress loop
            logger.exception("collector window %d stage %d failed",
                             self.window, self.stage)
            self._abandon()

    def _start(self, team) -> None:
        svc = team.service_team
        if svc is None or getattr(svc, "transport", None) is None or \
                team.size <= 1:
            # no exchange channel: a window over this rank alone has no
            # peer to compare with, so only the high-water mark moves
            self.cut_t = time.monotonic()
            self.window += 1
            return
        snap = self._snapshot_window(team)
        payload = pickle.dumps({"fseq": team.flight_seq, "snap": snap})
        self._req = self._oob(team, self.group, self.ST_GATHER)\
            .allgather(payload)
        self.stage = self.ST_GATHER
        self._deadline = time.monotonic() + max(30.0, KNOBS.interval * 2)
        # the next window's events start where this snapshot ended
        self.cut_t = time.monotonic()

    def _advance(self, team, result) -> None:
        from . import diagnose
        if self.stage == self.ST_GATHER:
            msgs = [pickle.loads(b) for b in result]
            pod = {"version": DUMP_VERSION, "kind": "flight_merged",
                   "reason": "collect", "ts": time.time(),
                   "pid": os.getpid(), "window": self.window,
                   "team": team.id, "team_size": team.size,
                   # membership epoch: the windows before and after a
                   # change of one job merge cleanly in the store
                   # (readers key on (team, epoch, window))
                   "epoch": int(getattr(team, "epoch", 0)),
                   "absent_ranks": [],
                   "ranks": {str(r): m["snap"]
                             for r, m in zip(self.group, msgs)}}
            idx = diagnose._index(pod)
            sev = self.scorer.observe(pod, _idx=idx)
            self._pod_summary = {
                "ranks": list(self.group),
                "sev": {int(r): float(s) for r, s in sev.items()},
                "max_fseq": max(int(m.get("fseq") or 0) for m in msgs),
            }
            if len(self.leaders) > 1:
                # compact per-collective durations ride up with the
                # summary, so leaders can find outliers ACROSS pods (the
                # >= 3-rank duration signal is blind inside a small
                # pod). Only durations cross the pod boundary: they
                # compare across hosts, raw monotonic stamps do not.
                durs: Dict[Any, Dict[int, float]] = {}
                for r, ri in idx.items():
                    for key, d in ri.durs.items():
                        durs.setdefault(key, {})[int(r)] = float(d)
                self._pod_summary["durs"] = durs
            if self.is_leader:
                self.service.store_append(pod)
            if len(self.leaders) > 1:
                if self.is_leader:
                    self._req = self._oob(team, self.leaders,
                                          self.ST_LEADERS).allgather(
                        pickle.dumps(self._pod_summary))
                    self.stage = self.ST_LEADERS
                else:
                    # non-leaders wait for the leader's rebroadcast
                    self._req = self._oob(team, self.group,
                                          self.ST_BCAST).allgather(b"")
                    self.stage = self.ST_BCAST
                return
            # one group: the pod summary IS the global summary
            self._apply(team, self._merge_summaries([self._pod_summary]))
            return
        if self.stage == self.ST_LEADERS:
            summaries = [pickle.loads(b) for b in result]
            self._global = self._merge_summaries(summaries)
            if len(self.group) > 1:
                self._req = self._oob(team, self.group,
                                      self.ST_BCAST).allgather(
                    pickle.dumps(self._global))
                self.stage = self.ST_BCAST
                return
            self._apply(team, self._global)
            return
        if self.stage == self.ST_BCAST:
            # the leader's entry (group position 0) carries the global
            # summary; everyone else contributed b""
            data = result[0]
            if not data and self._global is not None:
                g = self._global
            else:
                g = pickle.loads(data) if data else None
            if g is None:
                logger.warning("collector window %d: empty global "
                               "summary; abandoning", self.window)
                self._abandon()
                return
            self._apply(team, g)

    def _merge_summaries(self, summaries: List[dict]) -> dict:
        ranks: List[int] = []
        sev: Dict[int, float] = {}
        max_fseq = 0
        durs: Dict[Any, Dict[int, float]] = {}
        for s in summaries:
            ranks.extend(int(r) for r in s.get("ranks") or ())
            for r, v in (s.get("sev") or {}).items():
                sev[int(r)] = sev.get(int(r), 0.0) + float(v)
            max_fseq = max(max_fseq, int(s.get("max_fseq") or 0))
            for key, per in (s.get("durs") or {}).items():
                dst = durs.setdefault(key, {})
                for r, d in per.items():
                    dst[int(r)] = float(d)
        # duration outliers across pods: every leader merges the same
        # summary list, so this runs identically on each and the verdict
        # agrees without another exchange
        slow: Dict[int, int] = {}
        factor, min_s = self.scorer.factor, self.scorer.min_s
        for per in durs.values():
            if len(per) < 3:
                continue
            vals = sorted(per.values())
            n = len(vals)
            med = vals[n // 2] if n % 2 else \
                0.5 * (vals[n // 2 - 1] + vals[n // 2])
            r_max = max(per, key=lambda r: per[r])
            if per[r_max] > max(med * factor, med + min_s):
                slow[r_max] = slow.get(r_max, 0) + 1
        for r in slow:
            sev[r] = sev.get(r, 0.0) + 1.0
        return {"ranks": sorted(set(ranks)), "sev": sev,
                "max_fseq": max_fseq}

    def _apply(self, team, g: dict) -> None:
        flagged = self.scorer.update(g.get("sev") or {},
                                     g.get("ranks") or ())
        apply_at = int(g.get("max_fseq") or 0) + KNOBS.slack
        if self.bias is not None:
            self.bias.publish(flagged, self.scorer.scores, self.window,
                              apply_at)
        if self.is_top:
            self.service.store_append({
                "version": DUMP_VERSION, "kind": "collect_summary",
                "ts": time.time(), "team": team.id,
                "epoch": int(getattr(team, "epoch", 0)),
                "window": self.window,
                "sev": {str(r): round(v, 4)
                        for r, v in (g.get("sev") or {}).items()},
                "scores": {str(r): round(v, 4)
                           for r, v in self.scorer.scores.items()},
                "flagged": sorted(flagged),
                "apply_at": apply_at,
            })
        if flagged:
            logger.info("collector: team %s window %d flagged rank(s) "
                        "%s", team.id, self.window,
                        ",".join(str(r) for r in sorted(flagged)))
        self._finish_window()

    def _abandon(self) -> None:
        self._finish_window()

    def _finish_window(self) -> None:
        self._req = None
        self._pod_summary = None
        self._global = None
        self.stage = 0
        self.window += 1


# ---------------------------------------------------------------------------
# per-context service
# ---------------------------------------------------------------------------

class CollectorService:
    """Per-context collection service: owns the window timer thread and
    drives every watched team's window state machine from the progress
    path (``Context.progress`` calls :meth:`step`)."""

    def __init__(self, context):
        self.context_ref = weakref.ref(context)
        self._watches: List[_TeamWatch] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.store: Optional[TraceStore] = None
        if KNOBS.dir:
            self.store = TraceStore(KNOBS.dir, KNOBS.segment_bytes,
                                    KNOBS.segments)
        self._thread = threading.Thread(
            target=self._timer_loop, daemon=True,
            name=f"ucc-collector-{getattr(context, 'rank', 0)}")
        self._thread.start()

    # -- team registry --------------------------------------------------
    def watch(self, team) -> Optional[_TeamWatch]:
        """Start collection for *team* (called at team activation).
        Returns the watch, or None for a team that cannot be watched."""
        if team.size <= 1:
            return None
        w = _TeamWatch(self, team)
        with self._lock:
            self._watches.append(w)
        return w

    def unwatch(self, watch: _TeamWatch) -> None:
        with self._lock:
            try:
                self._watches.remove(watch)
            except ValueError:
                pass

    def flagged_ctx(self) -> FrozenSet[int]:
        """Union of the flagged ranks of every watched team, as CONTEXT
        ranks: the view a NEW team's address exchange publishes, so that
        its hier tree can demote stragglers from leader positions."""
        out = set()
        with self._lock:
            watches = list(self._watches)
        for w in watches:
            team = w.team_ref()
            if team is None or w.bias is None:
                continue
            for tr in w.bias.flagged:
                try:
                    out.add(int(team.ctx_map.eval(tr)))
                except Exception:  # noqa: BLE001 - a torn-down map
                    continue
        return frozenset(out)

    def watch_for(self, team) -> Optional[_TeamWatch]:
        """The watch driving *team*'s windows, if any (tools, drills)."""
        with self._lock:
            for w in self._watches:
                if w.team_ref() is team:
                    return w
        return None

    def handoff(self, old_team, new_team) -> None:
        """Telemetry across a membership change (Team shrink and grow):
        the retired team's straggler state moves into the successor's
        watch, so the new epoch does not learn its flags again from
        nothing. Rank-keyed state is remapped THROUGH context ranks (old
        team rank -> ctx -> new team rank): the rank set is not monotone
        once teams can grow. The successor's window index restarts at 0
        on purpose: exchange keys carry it, and a joiner's watch has no
        pre-grow count to agree with; the records' epoch stamps keep the
        windows before and after the change mergeable instead. Survivors
        keep the ring high-water mark (no event is reported twice across
        the change); joiners keep cut 0, so their ``boot:*`` spans land
        in the first merged window."""
        old_w = self.watch_for(old_team)
        new_w = self.watch_for(new_team)
        if old_w is not None:
            self.unwatch(old_w)   # retired teams stop exchanging NOW
        if old_w is None or new_w is None:
            return
        ctx_to_new = {}
        for i in range(new_team.size):
            try:
                ctx_to_new[int(new_team.ctx_map.eval(i))] = i
            except Exception:  # noqa: BLE001 - torn-down map: no carry
                return

        def remap(d):
            out = {}
            for r, v in d.items():
                try:
                    c = int(old_team.ctx_map.eval(int(r)))
                except Exception:  # noqa: BLE001 - rank gone from map
                    continue
                nr = ctx_to_new.get(c)
                if nr is not None:
                    out[nr] = v
            return out

        sc_old, sc_new = old_w.scorer, new_w.scorer
        sc_new.scores = remap(sc_old.scores)
        sc_new.streaks = remap(sc_old.streaks)
        sc_new.flagged = set(remap({r: r for r in sc_old.flagged}))
        sc_new.windows_seen = sc_old.windows_seen
        new_w.cut_t = old_w.cut_t if new_w.cut_t == 0.0 else new_w.cut_t
        if old_w.bias is not None and new_w.bias is not None:
            # promoted state only: a table still staged on the retired
            # team would apply at a flight index of the OLD epoch's
            # program order, which the successor does not have; it is
            # learned again within a window if it still holds
            new_w.bias.flagged = frozenset(
                remap({r: r for r in old_w.bias.flagged}))
            new_w.bias.scores = remap(old_w.bias.scores)
        logger.info(
            "collector handoff: team %s -> %s (epoch %s): carried "
            "%d score(s), flagged %s", old_team.id, new_team.id,
            getattr(new_team, "epoch", "?"), len(sc_new.scores),
            sorted(sc_new.flagged) or "none")

    def windows_run(self) -> int:
        """Highest window index reached across watched teams: how many
        collection windows closed (soak and tool reports)."""
        with self._lock:
            return max((w.window for w in self._watches), default=0)

    def store_append(self, rec: Dict[str, Any]) -> None:
        if self.store is not None:
            self.store.append(rec)

    # -- the progress path ----------------------------------------------
    def step(self) -> None:
        with self._lock:
            watches = list(self._watches)
        for w in watches:
            w.step()

    # -- timer thread ---------------------------------------------------
    def _timer_loop(self) -> None:
        while not self._stop.wait(KNOBS.interval):
            with self._lock:
                watches = list(self._watches)
            for w in watches:
                w.due += 1

    def stop(self) -> None:
        self._stop.set()


def maybe_create(context) -> Optional[CollectorService]:
    """Context.__init__ hook: a service when UCC_COLLECT is on, else None
    (the default: dispatch and progress test the attribute once)."""
    if not ENABLED:
        return None
    return CollectorService(context)
