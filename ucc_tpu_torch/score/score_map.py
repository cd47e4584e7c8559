"""Compiled score map with fallback chains (UCC's coll_score_map).

At team activation the merged CollScore is compiled into a lookup
structure; ``lookup(coll, mem, msgsize)`` returns candidates sorted
best-first, and ``init_coll`` walks the fallback chain when a candidate's
init returns ERR_NOT_SUPPORTED. The team-creation score dump
(``ucc_coll_score_map_print_info``, shown via UCC_COLL_TRACE) is
``print_info()``; ``apply_learned`` is the tuner's recompile in place.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, List, Optional, Tuple

from ..constants import CollType, MemoryType, coll_type_str
from ..status import Status, UccError
from ..utils.log import get_logger
from .score import CollScore, MsgRange, SCORE_MAX

logger = get_logger("score")

#: score the tuner promotes a measured winner to: above every default and
#: every finite tune-str score, below SCORE_MAX so that an explicit
#: ``...:inf`` in a TUNE string still outranks a learned decision
LEARNED_SCORE = SCORE_MAX - 1


def comp_name(r: MsgRange) -> str:
    """Serving-component label of a range (the CL/TL UCC prints per
    score-map entry)."""
    return getattr(r.team, "NAME", None) or \
        (getattr(r.team, "name", "") or "?")


def _cand_order(lst: List[MsgRange]) -> List[MsgRange]:
    """Deterministic candidate order: (score desc, alg name, generated
    parameter string, component, registration order). Score alone would
    leave equal-score candidates to list/merge ordering — any cross-rank
    divergence there makes ranks pick different algorithms for the same
    collective and deadlocks the team, so ties break on content, not
    construction history. The generated parameter string takes part
    because the DSL registers many same-score candidates at once."""
    return [r for _, r in sorted(
        enumerate(lst),
        key=lambda p: (-p[1].score, p[1].alg_name or "", p[1].gen or "",
                       comp_name(p[1]), p[0]))]


class ScoreMap:
    def __init__(self, score: CollScore):
        self._score = score
        # candidates pre-sorted per (coll, mem); see _cand_order
        self._sorted = {
            key: _cand_order(lst) for key, lst in score.ranges.items()
        }

    def lookup(self, coll: CollType, mem: MemoryType,
               msgsize: int, bias=None) -> List[MsgRange]:
        """All candidates whose range contains msgsize, best score first.

        ``bias`` is the team's RankBias (obs/collector.py) once the
        collector has flagged stragglers: candidates whose critical path
        serializes through a flagged rank (the ring family) go behind
        every unpenalized one. The reorder is a function of the sorted
        list and the flagged set alone, both the same on every rank at
        the bias's switch index, so ranks keep one candidate order."""
        lst = self._sorted.get((coll, mem), [])
        # score 0 disables a candidate (`alltoall:0` in a tune string
        # disables the coll for that component)
        out = [r for r in lst if r.contains(msgsize) and r.score > 0]
        if bias is not None and getattr(bias, "flagged", None):
            out = bias.reorder(out)
        return out

    def init_coll(self, coll: CollType, mem: MemoryType, msgsize: int,
                  init_args,
                  candidates: Optional[List[MsgRange]] = None
                  ) -> Tuple[Any, MsgRange]:
        """ucc_coll_init: try winner, walk fallbacks on ERR_NOT_SUPPORTED.
        Returns (task, chosen_range). ``candidates`` lets the caller
        pre-compute the lookup."""
        if candidates is None:
            candidates = self.lookup(coll, mem, msgsize)
        if not candidates:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"no candidates for {coll_type_str(coll)}/"
                           f"{mem.name.lower()} msgsize={msgsize}")
        last_err: Optional[UccError] = None
        for cand in candidates:
            if cand.init is None:
                continue
            try:
                task = cand.init(init_args, cand.team)
                return task, cand
            except UccError as e:
                if e.status == Status.ERR_NOT_SUPPORTED:
                    logger.debug(
                        "fallback: %s/%s msgsize=%d alg=%s not supported, "
                        "trying next", coll_type_str(coll), mem.name.lower(),
                        msgsize, cand.alg_name or "?")
                    last_err = e
                    continue
                raise
        raise last_err or UccError(Status.ERR_NOT_SUPPORTED,
                                   f"all candidates failed for "
                                   f"{coll_type_str(coll)}")

    # ------------------------------------------------------------------
    # the tuner's recompile in place (score/tuner.py)
    def apply_learned(self, coll: CollType, mem: MemoryType, start: int,
                      end: int, alg: str, comp: Optional[str] = None,
                      score: int = LEARNED_SCORE,
                      origin: str = "learned") -> bool:
        """Promote the measured winner *alg* (of the component *comp*,
        when given) to *score* over [start, end), splitting its ranges at
        the window's bounds. Other candidates keep their scores and stay
        the fallback chain. False when no range of that algorithm overlaps
        the window (an entry learned on a build with other algorithms).
        ``origin`` is the promoted range's provenance in the score dump."""
        if start >= end:
            return False
        key = (coll, mem)
        lst = self._score.ranges.get(key)
        if not lst:
            return False
        out: List[MsgRange] = []
        hit = False
        for r in lst:
            if r.alg_name != alg or r.init is None or \
                    (comp is not None and comp_name(r) != comp) or \
                    not r.overlaps(start, end):
                out.append(r)
                continue
            lo = max(r.start, start)
            hi = min(r.end, end)
            if r.start < lo:
                out.append(replace(r, end=lo))
            mid = replace(r, start=lo, end=hi)
            mid.score = score
            mid.origin = origin or "learned"
            out.append(mid)
            if hi < r.end:
                out.append(replace(r, start=hi))
            hit = True
        if hit:
            self._score.ranges[key] = out
            self._sorted[key] = _cand_order(out)
        return hit

    def print_info(self, team_name: str = "team") -> str:
        """Score-map dump like UCC's team-create log: every row names the
        SERVING COMPONENT, entries identical in (component, alg, range,
        score) collapse, and each entry carries its PROVENANCE —
        ``(default)`` or ``(tune-str)`` — so UCC_COLL_TRACE logs show why
        an algorithm was chosen, not just that it was.
        """
        from ..utils.config import memunits_str
        lines = [f"ucc_tpu_torch score map for {team_name}:"]
        for (c, m), lst in sorted(self._sorted.items()):
            segs = []
            seen = set()
            for r in lst:
                score = "inf" if r.score >= SCORE_MAX else str(r.score)
                comp = comp_name(r)
                name = r.alg_name or comp
                origin = r.origin or "default"
                # plan-executed candidates (native execution plans,
                # dsl/plan.py) are marked "+plan": "(default+plan)" = a
                # hand-written algorithm retired inside the native core
                if r.plan:
                    origin = f"{origin}+plan"
                # quantized variants carry their wire precision, generated
                # candidates their family/parameters:
                # "(generated-device gen:ring(chunks=2))"
                if r.precision:
                    origin = f"{origin},{r.precision}"
                if r.gen:
                    origin = f"{origin} gen:{r.gen}"
                key = (comp, name, r.start, r.end, r.score, origin)
                if key in seen:
                    continue
                seen.add(key)
                label = comp if name == comp else f"{comp}/{name}"
                segs.append(
                    f"[{memunits_str(r.start)}..{memunits_str(r.end)}]"
                    f" {label}:{score} ({origin})")
            lines.append(f"  {coll_type_str(c)}/{m.name.lower():10s} "
                         + " ".join(segs))
        return "\n".join(lines)
