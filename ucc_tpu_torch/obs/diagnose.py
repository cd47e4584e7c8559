"""Flight-dump diagnosis — turn merged per-rank event rings into names.

Input: the merged dump ``obs/flight.py`` collection produces —
``{"ranks": {"<team rank>": {"events": [...], "wire": [...]}, ...},
"absent_ranks": [...]}`` — where each rank's ``events`` are collective
lifecycle records (post/start/cmpl/cancel/fence) and ``wire`` holds
per-message send records. Output: findings that name culprits:

- **desync** — rank R posted flight-sequence N on team T with a
  different (collective, algorithm, size) than its peers. Posts carry a
  per-team ``fseq`` stamped in program order, and UCC requires
  collectives to be issued in the same order on every member, so fseq N
  is the same logical collective everywhere — any signature mismatch is
  a real application/stack divergence, the class of bug that otherwise
  surfaces as a hang or silent corruption.
- **straggler** — per-round completion-time outliers. Two signals:
  completion DURATIONS for the same (team, fseq) across ranks (clocks
  differ across processes; durations don't), and per-round wire-send
  lag (a rank whose sends consistently leave later than every peer's in
  the same round — the signature of a delayed/overloaded rank, which
  plain completion times smear across all of its victims). Stage-tagged
  completions (cl/hier phase tasks) localize the slow tree level.
- **missing / stuck** — ranks behind on a team's flight sequence, and
  collectives posted but never completed (with age), the hang culprits.
- **failed** — absent ranks (excluded from collection as dead) and
  ranks whose ring ends in error completions, each with what was in
  flight when it died.
- **queue_wait** — per-tenant scheduling contention: ``qos:qwait:pN``
  stage completions (priority-lane progress queue, waits past the
  anti-starvation bound) grouped per (team, lane), naming the team and
  priority class whose traffic sat queued behind other tenants.

Everything here is a cold path operating on plain dicts, so it is
equally usable in-process (watchdog fold-in), from the ``ucc_fr`` CLI
over dump files, and from tests over synthetic dumps.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

#: schema tag of every flight dump this package writes (obs/flight.py
#: stamps it as ``version``); ``ucc_fr`` reads only records that carry it,
#: so the JAX package's dumps (version 1) are refused, not mis-read
DUMP_VERSION = "ucc_tpu_torch/1"

#: a duration must beat the peer median by this factor AND this floor
#: before it is called an outlier (noise guard)
STRAGGLER_FACTOR = 2.0
STRAGGLER_MIN_S = 1e-3
#: wire-send lag floor: a rank's median round-lag must exceed this to be
#: named (in-process delivery jitter sits well under it)
WIRE_LAG_MIN_S = 5e-3


def _ranks(merged: Dict[str, Any]) -> Dict[int, Dict[str, Any]]:
    out = {}
    for r, snap in (merged.get("ranks") or {}).items():
        try:
            out[int(r)] = snap
        except (TypeError, ValueError):
            continue
    return out


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if not n:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


# ---------------------------------------------------------------------------
# per-rank index
# ---------------------------------------------------------------------------

class _RankIndex:
    """Decoded view of one rank's coll ring: posts keyed by (team, epoch,
    fseq), seq->post join, completion durations, in-flight set."""

    def __init__(self, rank: int, snap: Dict[str, Any]):
        self.rank = rank
        self.events: List[Dict[str, Any]] = snap.get("events") or []
        self.wire: List[Dict[str, Any]] = snap.get("wire") or []
        #: (team, epoch, fseq) -> post event
        self.posts: Dict[Tuple, Dict[str, Any]] = {}
        #: local task seq -> post event (the cmpl join key)
        self.by_seq: Dict[int, Dict[str, Any]] = {}
        #: per-seq post/complete counts (persistent re-posts)
        self._nposts: Dict[int, int] = {}
        self._ncmpls: Dict[int, int] = {}
        #: (team, epoch, fseq) -> completion duration (seconds, last)
        self.durs: Dict[Tuple, float] = {}
        #: (team, epoch, fseq) -> completion status
        self.statuses: Dict[Tuple, str] = {}
        #: (stage,) occurrence list: stage -> [durations in order]
        self.stage_durs: Dict[str, List[float]] = {}
        self.last_t = 0.0
        for ev in self.events:
            t = ev.get("t") or 0.0
            self.last_t = max(self.last_t, t)
            kind = ev.get("ev")
            seq = ev.get("seq")
            if kind == "post" and ev.get("fseq") is not None:
                key = (ev.get("team"), ev.get("epoch"), ev.get("fseq"))
                self.posts[key] = ev
                if seq is not None:
                    self.by_seq[seq] = ev
                    self._nposts[seq] = self._nposts.get(seq, 0) + 1
            elif kind == "cmpl":
                stage = ev.get("stage")
                dur = ev.get("dur_s") or 0.0
                if stage:
                    self.stage_durs.setdefault(stage, []).append(dur)
                if seq is not None and seq in self.by_seq:
                    self._ncmpls[seq] = self._ncmpls.get(seq, 0) + 1
                    post = self.by_seq[seq]
                    key = (post.get("team"), post.get("epoch"),
                           post.get("fseq"))
                    self.durs[key] = dur
                    self.statuses[key] = ev.get("status", "")

    def in_flight(self) -> List[Dict[str, Any]]:
        """Posts with no matching completion — what this rank was doing
        when the ring was snapped, each with its age at snapshot time."""
        out = []
        for seq, post in self.by_seq.items():
            if self._ncmpls.get(seq, 0) < self._nposts.get(seq, 0):
                out.append({"fseq": post.get("fseq"),
                            "team": post.get("team"),
                            "coll": post.get("coll"),
                            "alg": post.get("alg"),
                            "seq": seq,
                            "age_s": round(self.last_t -
                                           (post.get("t") or 0.0), 4)})
        out.sort(key=lambda d: d.get("fseq") or 0)
        return out

    def max_fseq(self) -> Dict[Tuple, int]:
        """(team, epoch) -> highest posted flight sequence."""
        out: Dict[Tuple, int] = {}
        for (team, epoch, fseq) in self.posts:
            k = (team, epoch)
            if fseq is not None and fseq > out.get(k, -1):
                out[k] = fseq
        return out


def _index(merged: Dict[str, Any],
           prebuilt: Optional[Dict[int, _RankIndex]] = None
           ) -> Dict[int, _RankIndex]:
    """Decode every rank's ring into a _RankIndex. Detectors accept a
    *prebuilt* index so ``diagnose`` decodes a pod-scale dump once, not
    once per detector."""
    if prebuilt is not None:
        return prebuilt
    return {r: _RankIndex(r, snap) for r, snap in _ranks(merged).items()}


# ---------------------------------------------------------------------------
# detectors
# ---------------------------------------------------------------------------

def detect_desync(merged: Dict[str, Any], _idx=None
                  ) -> List[Dict[str, Any]]:
    """Collective-sequence desync: for every (team, epoch, fseq) posted
    by 2+ ranks, the (coll, alg, size) signature must agree; minority
    ranks are the culprits (ties name every disagreeing rank)."""
    idx = _index(merged, _idx)
    by_key: Dict[Tuple, Dict[int, Tuple]] = {}
    for r, ri in idx.items():
        for key, post in ri.posts.items():
            by_key.setdefault(key, {})[r] = (post.get("coll"),
                                             post.get("alg"),
                                             post.get("size"))
    findings = []
    for key in sorted(by_key, key=lambda k: (str(k[0]), k[1] or 0,
                                             k[2] or 0)):
        sigs = by_key[key]
        if len(sigs) < 2:
            continue
        counts: Dict[Tuple, int] = {}
        for sig in sigs.values():
            counts[sig] = counts.get(sig, 0) + 1
        if len(counts) <= 1:
            continue
        expect = max(counts, key=lambda s: counts[s])
        culprits = sorted(r for r, sig in sigs.items() if sig != expect)
        team, epoch, fseq = key
        findings.append({
            "kind": "desync", "team": team, "epoch": epoch, "fseq": fseq,
            "culprits": culprits,
            "expect": {"coll": expect[0], "alg": expect[1],
                       "size": expect[2]},
            "got": {str(r): {"coll": s[0], "alg": s[1], "size": s[2]}
                    for r, s in sorted(sigs.items()) if s != expect},
        })
    return findings


def detect_missing(merged: Dict[str, Any], _idx=None
                   ) -> List[Dict[str, Any]]:
    """Missing participants: ranks behind on a team's flight sequence
    (never posted fseq N that peers posted — the rank everyone else is
    waiting on), plus per-rank stuck collectives (posted, never
    completed)."""
    idx = _index(merged, _idx)
    findings: List[Dict[str, Any]] = []
    # behind on the sequence
    frontier: Dict[Tuple, Dict[int, int]] = {}
    for r, ri in idx.items():
        for k, mx in ri.max_fseq().items():
            frontier.setdefault(k, {})[r] = mx
    for k in sorted(frontier, key=str):
        per_rank = frontier[k]
        if len(per_rank) < 2:
            continue
        mx = max(per_rank.values())
        behind = {r: f for r, f in per_rank.items() if f < mx}
        if behind:
            team, epoch = k
            findings.append({
                "kind": "missing", "team": team, "epoch": epoch,
                "fseq": mx,
                "culprits": sorted(behind),
                "last_fseq": {str(r): f
                              for r, f in sorted(behind.items())},
            })
    # stuck in flight
    for r in sorted(idx):
        for rec in idx[r].in_flight():
            rec.update({"kind": "stuck", "rank": r})
            findings.append(rec)
    return findings


def detect_stragglers(merged: Dict[str, Any],
                      factor: float = STRAGGLER_FACTOR,
                      min_s: float = STRAGGLER_MIN_S,
                      _idx=None) -> List[Dict[str, Any]]:
    """Straggler attribution — see module doc for the three signals."""
    idx = _index(merged, _idx)
    findings: List[Dict[str, Any]] = []

    # (1) completion-duration outliers per logical collective
    by_key: Dict[Tuple, Dict[int, float]] = {}
    for r, ri in idx.items():
        for key, dur in ri.durs.items():
            by_key.setdefault(key, {})[r] = dur
    slow_count: Dict[int, int] = {}
    worst: Dict[int, Dict[str, Any]] = {}
    for key, durs in by_key.items():
        if len(durs) < 3:
            continue
        med = _median(list(durs.values()))
        r_max = max(durs, key=lambda r: durs[r])
        d = durs[r_max]
        if d > max(med * factor, med + min_s):
            slow_count[r_max] = slow_count.get(r_max, 0) + 1
            team, epoch, fseq = key
            post = idx[r_max].posts.get(key) or {}
            cand = {"team": team, "epoch": epoch, "fseq": fseq,
                    "coll": post.get("coll"), "dur_s": round(d, 6),
                    "median_s": round(med, 6)}
            if d > (worst.get(r_max) or {}).get("dur_s", 0.0):
                worst[r_max] = cand
    for r in sorted(slow_count):
        w = worst[r]
        findings.append({"kind": "straggler", "signal": "duration",
                         "rank": r, "outlier_colls": slow_count[r],
                         **w})

    # (2) wire-send lag per source rank: group sends by round — at slot
    # granularity (knomial-style algorithms share a slot per round) AND
    # at tag granularity (first send per rank per collective). The two
    # granularities are scored SEPARATELY: in a pipelined ring a single
    # delayed sender serializes every downstream hop, so slot groups
    # show every rank a multiple of the delay behind the group min and
    # a pooled median blames nobody (base * 4 swallows the signal). A
    # collective's first sends are posted independently on every rank —
    # the one point where a delayed sender lags without dragging its
    # neighbors — so the tag granularity stays clean there, while the
    # slot granularity carries the signal for round-synchronous
    # algorithms (knomial exchanges, device launch/ready pairs).
    grans: Dict[str, Dict[Tuple, Dict[int, float]]] = {
        "slot": {}, "tag": {}}
    for r, ri in idx.items():
        for w in ri.wire:
            t = w.get("t") or 0.0
            tkey, epoch, tag = w.get("tkey"), w.get("epoch"), w.get("tag")
            for gran, k in (("slot", (tkey, epoch, tag, w.get("slot"))),
                            ("tag", (tkey, epoch, tag))):
                per = grans[gran].setdefault(k, {})
                if r not in per or t < per[r]:
                    per[r] = t
    wire_best: Dict[int, Dict[str, Any]] = {}
    for gran, rounds in grans.items():
        deltas: Dict[int, List[float]] = {}
        for per in rounds.values():
            if len(per) < 2:
                continue
            t0 = min(per.values())
            for r, t in per.items():
                deltas.setdefault(r, []).append(t - t0)
        if len(deltas) < 2:
            continue
        lag = {r: _median(v) for r, v in deltas.items()}
        for r in sorted(lag):
            others = [v for rr, v in lag.items() if rr != r]
            base = _median(others)
            if lag[r] > max(WIRE_LAG_MIN_S, base * 4 + 1e-6):
                cand = {
                    "kind": "straggler", "signal": "wire_lag", "rank": r,
                    "lag_s": round(lag[r], 6),
                    "peer_lag_s": round(base, 6),
                    "rounds": len(deltas[r]), "gran": gran,
                    "seqs": _lagged_seqs(idx.get(r), lag[r] / 2),
                }
                if r not in wire_best or cand["lag_s"] > \
                        wire_best[r]["lag_s"]:
                    wire_best[r] = cand
    findings.extend(wire_best[r] for r in sorted(wire_best))

    # (3) stage-duration outliers (hier phase tasks name the tree level).
    # qos:* stages are scheduling contention, not rank slowness — they
    # have their own detector (detect_queue_wait)
    stages: Dict[Tuple[str, int], Dict[int, float]] = {}
    for r, ri in idx.items():
        for stage, durs in ri.stage_durs.items():
            if stage.startswith("qos:"):
                continue
            for i, d in enumerate(durs):
                stages.setdefault((stage, i), {})[r] = d
    stage_slow: Dict[Tuple[int, str], Tuple[int, float, float]] = {}
    for (stage, _i), per in stages.items():
        if len(per) < 3:
            continue
        med = _median(list(per.values()))
        r_max = max(per, key=lambda r: per[r])
        d = per[r_max]
        if d > max(med * factor, med + min_s):
            n, dmax, _ = stage_slow.get((r_max, stage), (0, 0.0, 0.0))
            stage_slow[(r_max, stage)] = (n + 1, max(dmax, d), med)
    for (r, stage) in sorted(stage_slow, key=str):
        n, dmax, med = stage_slow[(r, stage)]
        findings.append({"kind": "straggler", "signal": "stage",
                         "rank": r, "stage": stage, "occurrences": n,
                         "dur_s": round(dmax, 6),
                         "median_s": round(med, 6)})
    return findings


def _lagged_seqs(ri: Optional[_RankIndex],
                 threshold: float) -> List[Dict[str, Any]]:
    """Collectives on *ri*'s ring that were IN FLIGHT while its lagged
    sends left — the 'stuck collective seq' attribution for a wire-lag
    straggler."""
    if ri is None:
        return []
    lagged_ts = []
    rounds: Dict[Tuple, float] = {}
    for w in ri.wire:
        k = (w.get("tkey"), w.get("epoch"), w.get("tag"), w.get("slot"))
        t = w.get("t") or 0.0
        if k not in rounds or t < rounds[k]:
            rounds[k] = t
    lagged_ts = sorted(rounds.values())
    if not lagged_ts:
        return []
    out = []
    seen = set()
    for key, post in sorted(ri.posts.items(), key=lambda kv: str(kv[0])):
        t_post = post.get("t") or 0.0
        # completion time, if any — else open interval
        dur = ri.durs.get(key)
        t_end = (t_post + dur + threshold) if dur is not None else None
        for t in lagged_ts:
            if t >= t_post and (t_end is None or t <= t_end):
                k2 = (post.get("team"), post.get("fseq"))
                if k2 not in seen:
                    seen.add(k2)
                    out.append({"team": post.get("team"),
                                "fseq": post.get("fseq"),
                                "coll": post.get("coll")})
                break
    return out[:16]


def detect_queue_wait(merged: Dict[str, Any], _idx=None
                      ) -> List[Dict[str, Any]]:
    """Per-tenant queue-wait outliers: the priority-lane progress queue
    (schedule/progress.py) records enqueue -> first-service waits past
    the anti-starvation aging bound as ``qos:qwait:pN`` stage
    completions. Grouped per (team, lane), each finding names the team
    and priority lane whose traffic sat queued behind other tenants,
    with the ranks that saw it and the worst wait."""
    idx = _index(merged, _idx)
    groups: Dict[Tuple, Dict[str, Any]] = {}
    for r, ri in idx.items():
        for ev in ri.events:
            if ev.get("ev") != "cmpl":
                continue
            stage = ev.get("stage") or ""
            if not stage.startswith("qos:qwait:p"):
                continue
            try:
                lane = int(stage[len("qos:qwait:p"):])
            except ValueError:
                continue
            key = (ev.get("team"), lane)
            g = groups.setdefault(key, {"count": 0, "max_wait_s": 0.0,
                                        "ranks": set(), "coll": None})
            g["count"] += 1
            w = float(ev.get("dur_s") or 0.0)
            if w >= g["max_wait_s"]:
                g["max_wait_s"] = w
                g["coll"] = ev.get("coll")
            g["ranks"].add(r)
    findings = []
    for (team, lane) in sorted(groups, key=str):
        g = groups[(team, lane)]
        findings.append({
            "kind": "queue_wait", "team": team, "lane": lane,
            "count": g["count"],
            "max_wait_ms": round(g["max_wait_s"] * 1e3, 3),
            "worst_coll": g["coll"],
            "ranks": sorted(g["ranks"])})
    return findings


def detect_failed(merged: Dict[str, Any], _idx=None
                  ) -> List[Dict[str, Any]]:
    """Dead/failed ranks: collection-time absentees (excluded as dead —
    the graceful-degradation path) and ranks whose ring ends in error
    completions; each with what was in flight."""
    idx = _index(merged, _idx)
    findings: List[Dict[str, Any]] = []
    for r in sorted(int(x) for x in (merged.get("absent_ranks") or [])):
        findings.append({"kind": "failed", "rank": r, "absent": True})
    failed_rank = merged.get("failed_rank")
    for r in sorted(idx):
        ri = idx[r]
        errs = [(k, s) for k, s in ri.statuses.items()
                if s and s not in ("OK",)]
        is_named = failed_rank is not None and r == int(failed_rank)
        if not errs and not is_named:
            continue
        f: Dict[str, Any] = {"kind": "failed", "rank": r,
                             "absent": False,
                             "error_colls": len(errs)}
        if errs:
            k, s = errs[-1]
            f["last_error"] = {"team": k[0], "fseq": k[2], "status": s}
        fl = ri.in_flight()
        if fl:
            f["in_flight"] = fl[:8]
        if is_named:
            f["named_by_detection"] = True
        findings.append(f)
    return findings


def detect_integrity(merged: Dict[str, Any], _idx=None
                     ) -> List[Dict[str, Any]]:
    """Data-corruption attribution: ``integrity`` events the wire
    checksum / result-attestation machinery recorded (kind ``wire``,
    ``attest``, ``quarantine``, each naming the offending ctx rank) are
    aggregated per offender, joined with the dump-level
    ``quarantined_rank`` marker the quarantine trigger stamps."""
    idx = _index(merged, _idx)
    per: Dict[int, Dict[str, Any]] = {}

    def slot(ctx: int) -> Dict[str, Any]:
        return per.setdefault(ctx, {"kind": "integrity", "rank": ctx,
                                    "wire_events": 0, "attest_events": 0,
                                    "quarantined": False,
                                    "reported_by": set()})

    for r in sorted(idx):
        for ev in idx[r].events:
            if ev.get("ev") != "cmpl" or ev.get("coll") != "integrity":
                continue
            stage = ev.get("stage") or ""
            try:
                ctx = int(stage.split("=", 1)[1])
            except (IndexError, ValueError):
                continue
            f = slot(ctx)
            f["reported_by"].add(r)
            k = ev.get("alg")
            if k == "wire":
                f["wire_events"] += 1
            elif k == "attest":
                f["attest_events"] += 1
            elif k == "quarantine":
                f["quarantined"] = True
    qr = merged.get("quarantined_rank")
    if qr is not None:
        slot(int(qr))["quarantined"] = True
    findings = []
    for ctx in sorted(per):
        f = per[ctx]
        f["reported_by"] = sorted(f["reported_by"])
        findings.append(f)
    return findings


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def diagnose(merged: Dict[str, Any]) -> Dict[str, Any]:
    """Run every detector; returns findings plus human-readable summary
    lines (the watchdog report and ``ucc_fr`` print them verbatim)."""
    idx = _index(merged)        # decoded ONCE, shared by every detector
    desync = detect_desync(merged, _idx=idx)
    stragglers = detect_stragglers(merged, _idx=idx)
    missing = detect_missing(merged, _idx=idx)
    failed = detect_failed(merged, _idx=idx)
    queue_wait = detect_queue_wait(merged, _idx=idx)
    integrity = detect_integrity(merged, _idx=idx)
    summary: List[str] = []
    for f in desync:
        summary.append(
            f"DESYNC team {f['team']} seq {f['fseq']}: rank(s) "
            f"{','.join(str(r) for r in f['culprits'])} posted "
            f"{_sig_str(list(f['got'].values())[0])} while peers posted "
            f"{_sig_str(f['expect'])}")
    for f in stragglers:
        if f["signal"] == "wire_lag":
            seqs = ",".join(str(s.get("fseq")) for s in f.get("seqs", []))
            summary.append(
                f"STRAGGLER rank {f['rank']}: sends lag peers by "
                f"{f['lag_s'] * 1e3:.1f}ms (median over {f['rounds']} "
                f"rounds)" + (f"; in-flight seq(s) {seqs}" if seqs else ""))
        elif f["signal"] == "stage":
            summary.append(
                f"STRAGGLER rank {f['rank']} at stage {f['stage']}: "
                f"{f['dur_s'] * 1e3:.1f}ms vs median "
                f"{f['median_s'] * 1e3:.1f}ms")
        else:
            summary.append(
                f"STRAGGLER rank {f['rank']}: {f['outlier_colls']} "
                f"outlier completion(s), worst {f['coll']} seq "
                f"{f['fseq']} {f['dur_s'] * 1e3:.1f}ms vs median "
                f"{f['median_s'] * 1e3:.1f}ms")
    for f in missing:
        if f["kind"] == "missing":
            summary.append(
                f"MISSING team {f['team']}: rank(s) "
                f"{','.join(str(r) for r in f['culprits'])} never posted "
                f"seq {f['fseq']} peers posted")
        else:
            summary.append(
                f"STUCK rank {f['rank']}: {f.get('coll')} team "
                f"{f.get('team')} seq {f.get('fseq')} in flight "
                f"{f.get('age_s')}s without completing")
    for f in failed:
        if f.get("absent"):
            summary.append(f"FAILED rank {f['rank']}: absent from "
                           f"collection (excluded as dead)")
        else:
            fl = f.get("in_flight") or []
            tail = (": in flight " + ", ".join(
                f"{x.get('coll')} seq {x.get('fseq')}" for x in fl[:3])) \
                if fl else ""
            summary.append(f"FAILED rank {f['rank']}: "
                           f"{f.get('error_colls', 0)} error "
                           f"completion(s){tail}")
    for f in queue_wait:
        ranks = ",".join(str(r) for r in f["ranks"])
        summary.append(
            f"QUEUE-WAIT team {f['team']} lane p{f['lane']}: "
            f"{f['count']} wait(s) past the aging bound on rank(s) "
            f"{ranks}, worst {f['max_wait_ms']:.1f}ms"
            + (f" ({f['worst_coll']})" if f.get("worst_coll") else ""))
    for f in integrity:
        rep = ",".join(str(r) for r in f["reported_by"]) or "-"
        parts = []
        if f["wire_events"]:
            parts.append(f"{f['wire_events']} wire crc mismatch(es)")
        if f["attest_events"]:
            parts.append(f"{f['attest_events']} attestation "
                         f"minority event(s)")
        what = ", ".join(parts) or "corruption evidence"
        summary.append(
            f"CORRUPT ctx rank {f['rank']}: {what}, reported by "
            f"rank(s) {rep}"
            + ("; QUARANTINED" if f["quarantined"] else ""))
    return {"desync": desync, "stragglers": stragglers,
            "missing": missing, "failed": failed,
            "queue_wait": queue_wait, "integrity": integrity,
            "summary": summary}


def _sig_str(sig: Dict[str, Any]) -> str:
    return f"{sig.get('coll')}/{sig.get('alg')}/{sig.get('size')}"


# ---------------------------------------------------------------------------
# incremental scoring (continuous collection — obs/collector.py)
# ---------------------------------------------------------------------------

class StragglerScorer:
    """Per-rank EWMA slowness over collection windows, with hysteresis.

    The dump-triggered detectors above answer "who was slow in THIS
    dump"; the continuous collector needs "who has been slow LATELY,
    with enough persistence to act on". This scorer turns per-window
    findings from the same three straggler signals (wire-send lag —
    including the dev_launch/dev_ready device-side events, which
    ride the wire ring and group into rounds like any send — completion-
    duration outliers, and hier stage-duration outliers) into a rolling
    per-rank score:

    - :meth:`observe` is the pure half: one (pod-)merged window dump in,
      raw severity per rank out (one unit per straggler finding naming
      that rank). Every group member runs it identically over the pod
      merge, so pod summaries agree without another exchange.
    - :meth:`update` is the stateful half, fed the GLOBAL severity map
      (pod summaries merged across leaders): EWMA
      ``s += decay * (raw - s)``, a consecutive-slow-window streak, and
      two thresholds. A rank flags only once its streak reaches
      ``windows`` AND its score reaches ``flag_on`` (a one-window spike
      never flags); a flagged rank unflags only when its score decays
      below ``flag_off`` — the hysteresis band that keeps the published
      RankBias stable while selection acts on it.
    """

    def __init__(self, decay: float = 0.5, flag_on: float = 0.7,
                 flag_off: float = 0.2, windows: int = 2,
                 factor: float = STRAGGLER_FACTOR,
                 min_s: float = STRAGGLER_MIN_S):
        self.decay = min(1.0, max(0.01, float(decay)))
        self.flag_on = float(flag_on)
        self.flag_off = float(flag_off)
        self.windows = max(1, int(windows))
        self.factor = float(factor)
        self.min_s = float(min_s)
        self.scores: Dict[int, float] = {}
        self.streaks: Dict[int, int] = {}
        self.flagged: set = set()
        self.windows_seen = 0
        #: 1-based windows_seen index of the first window with any
        #: severity / the first flag — "flagged within N windows" is
        #: measured between these (windows before the straggler's
        #: traffic even existed don't count against the budget)
        self.first_sev_index: Optional[int] = None
        self.first_flag_index: Optional[int] = None

    def observe(self, merged: Dict[str, Any],
                _idx=None) -> Dict[int, float]:
        """Raw window severity per rank from one merged window dump
        (pure — no scorer state touched). *_idx* lets the collector
        reuse one decoded index for observe + summary features."""
        sev: Dict[int, float] = {}
        for f in detect_stragglers(merged, self.factor, self.min_s,
                                   _idx=_idx):
            r = f.get("rank")
            if r is None:
                continue
            sev[int(r)] = sev.get(int(r), 0.0) + 1.0
        return sev

    def update(self, sev: Dict[Any, float], ranks=()) -> frozenset:
        """Fold one window's global severity into the rolling scores;
        returns the current flagged set. *ranks* lists every rank the
        window covered, so clean ranks decay toward zero.

        A window in which NO rank shows severity is *uninformative* —
        an idle team, a sampled-out window, or a collection cadence out
        of phase with the collective rate. Such a window decays scores
        at quarter weight and keeps streaks: "nothing was compared" must
        not read as "everyone was fast", or any straggler whose team
        posts slower than the window interval oscillates forever just
        under the flag threshold."""
        self.windows_seen += 1
        universe = {int(r) for r in ranks}
        norm = {int(r): float(v) for r, v in sev.items()}
        universe.update(norm)
        if not any(v > 0.0 for v in norm.values()):
            for r in list(self.scores):
                s = self.scores[r] * (1.0 - self.decay / 4.0)
                self.scores[r] = s
                if r in self.flagged and s <= self.flag_off:
                    self.flagged.discard(r)
            return frozenset(self.flagged)
        if self.first_sev_index is None:
            self.first_sev_index = self.windows_seen
        for r in sorted(universe):
            raw = norm.get(r, 0.0)
            s = self.scores.get(r, 0.0)
            s += self.decay * (raw - s)
            self.scores[r] = s
            self.streaks[r] = self.streaks.get(r, 0) + 1 if raw > 0 else 0
            if r in self.flagged:
                if s <= self.flag_off:
                    self.flagged.discard(r)
            elif self.streaks[r] >= self.windows and s >= self.flag_on:
                self.flagged.add(r)
        if self.flagged and self.first_flag_index is None:
            self.first_flag_index = self.windows_seen
        return frozenset(self.flagged)

    def step(self, merged: Dict[str, Any]) -> frozenset:
        """observe + update in one call, for single-group/offline use
        where the window dump already covers the whole team."""
        sev = self.observe(merged)
        ranks = [int(r) for r in (merged.get("ranks") or {})]
        return self.update(sev, ranks)

    def describe(self) -> str:
        if not self.scores:
            return "scorer: no windows observed"
        segs = [f"scorer ({self.windows_seen} windows):"]
        for r in sorted(self.scores):
            mark = " FLAGGED" if r in self.flagged else ""
            segs.append(f" r{r}={self.scores[r]:.2f}{mark}")
        return "".join(segs)


# ---------------------------------------------------------------------------
# offline merge (ucc_fr over dump files)
# ---------------------------------------------------------------------------

def merge_records(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Combine parsed flight-dump JSON lines into one merged dump. A
    ``flight_merged`` record (cross-rank collection output) wins — the
    LAST one in the file is the freshest. Continuous-collection stores
    write one *pod-scoped* merged record per group per window, all
    stamped with the window index: every merged record sharing the last
    record's window (and team) is unioned rank-wise, so ``ucc_fr`` over
    a trace-store directory reconstructs the full-team view no single
    rank ever held. Otherwise per-rank ``flight_local`` lines are merged
    (latest line per rank)."""
    merged_recs = [r for r in records if r.get("kind") == "flight_merged"]
    if merged_recs:
        last = merged_recs[-1]
        win = last.get("window")
        if win is None:
            return last
        out = dict(last)
        out["ranks"] = dict(last.get("ranks") or {})
        absent = set(last.get("absent_ranks") or [])
        for rec in merged_recs[:-1]:
            if rec.get("window") == win and \
                    rec.get("team") == last.get("team"):
                for r, snap in (rec.get("ranks") or {}).items():
                    out["ranks"].setdefault(r, snap)
                absent.update(rec.get("absent_ranks") or [])
        out["absent_ranks"] = sorted(int(a) for a in absent)
        return out
    out = {"version": DUMP_VERSION, "kind": "flight_merged",
           "reason": "offline",
           "ranks": {}, "absent_ranks": []}
    for rec in records:
        if rec.get("kind") != "flight_local":
            continue
        r = rec.get("rank")
        if r is None:
            continue
        out["ranks"][str(r)] = rec   # later lines overwrite: latest wins
    return out


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export
# ---------------------------------------------------------------------------

def to_chrome_trace(merged: Dict[str, Any]) -> Dict[str, Any]:
    """Merged timeline -> Chrome-trace JSON (loads in Perfetto /
    chrome://tracing): one process per rank, with a ``collectives``
    track, one track per hier stage (tree level), and a ``wire`` track.
    Completions become X (complete) slices spanning their duration;
    posts, cancels, fences and wire sends become instants."""
    ranks = _ranks(merged)
    t0 = None
    for snap in ranks.values():
        for ev in (snap.get("events") or []) + (snap.get("wire") or []):
            t = ev.get("t")
            if t is not None and (t0 is None or t < t0):
                t0 = t
    t0 = t0 or 0.0

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    events: List[Dict[str, Any]] = []
    TID_COLL, TID_WIRE = 0, 999
    for r in sorted(ranks):
        snap = ranks[r]
        events.append({"ph": "M", "name": "process_name", "pid": r,
                       "tid": 0, "args": {"name": f"rank {r}"}})
        events.append({"ph": "M", "name": "thread_name", "pid": r,
                       "tid": TID_COLL, "args": {"name": "collectives"}})
        events.append({"ph": "M", "name": "thread_name", "pid": r,
                       "tid": TID_WIRE, "args": {"name": "wire"}})
        stage_tids: Dict[str, int] = {}

        def tid_for(stage: Optional[str]) -> int:
            if not stage:
                return TID_COLL
            tid = stage_tids.get(stage)
            if tid is None:
                tid = stage_tids[stage] = 1 + len(stage_tids)
                events.append({"ph": "M", "name": "thread_name", "pid": r,
                               "tid": tid, "args": {"name": stage}})
            return tid

        for ev in snap.get("events") or []:
            kind = ev.get("ev")
            t = ev.get("t") or 0.0
            if kind == "cmpl":
                dur = ev.get("dur_s") or 0.0
                name = ev.get("stage") or \
                    f"{ev.get('coll') or '?'}:{ev.get('alg') or '?'}"
                events.append({
                    "ph": "X", "pid": r, "tid": tid_for(ev.get("stage")),
                    "ts": us(t - dur), "dur": round(dur * 1e6, 3),
                    "name": name,
                    "args": {k: ev.get(k) for k in
                             ("seq", "team", "epoch", "status")
                             if ev.get(k) is not None}})
            elif kind == "post":
                events.append({
                    "ph": "i", "s": "t", "pid": r, "tid": TID_COLL,
                    "ts": us(t),
                    "name": f"post {ev.get('coll')} seq {ev.get('fseq')}",
                    "args": {k: ev.get(k) for k in
                             ("team", "epoch", "fseq", "alg", "size")
                             if ev.get(k) is not None}})
            elif kind in ("cancel", "fence"):
                events.append({
                    "ph": "i", "s": "t", "pid": r, "tid": TID_COLL,
                    "ts": us(t),
                    "name": f"{kind} {ev.get('coll') or ev.get('team')}",
                    "args": {k: ev.get(k) for k in
                             ("team", "epoch", "seq", "status", "purged")
                             if ev.get(k) is not None}})
        for w in snap.get("wire") or []:
            events.append({
                "ph": "i", "s": "p", "pid": r, "tid": TID_WIRE,
                "ts": us(w.get("t") or 0.0),
                "name": f"snd:{w.get('kind')}",
                "args": {"tag": w.get("tag"), "slot": w.get("slot"),
                         "nbytes": w.get("nbytes")}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"source": "ucc_tpu_torch flight recorder",
                          "reason": merged.get("reason"),
                          "absent_ranks": merged.get("absent_ranks")}}
