"""Collective selection scores.

UCC's coll_score: each team builds, per (coll_type × mem_type), a set of
message-size ranges carrying a score and an algorithm-init callable.
Scores from multiple components (TLs within a CL, CLs within the core
team) are merged — highest score wins at lookup, lower-scored candidates
remain as the fallback chain walked on ERR_NOT_SUPPORTED.

User tuning via UCC's tune DSL (``UCC_TL_RING_CUDA_TUNE``), e.g.::

    allreduce:0-4k:@knomial:inf#bcast:host:0-inf:50#alltoall:0

Sections separated by ``#``; tokens inside a section by ``:``. A token is a
comma-list of coll types, a comma-list of mem types, a msg-size range
(``0-4k``, ``4k-inf``), an algorithm (``@name`` or ``@id``), or a score
(number or ``inf``). Omitted selectors default to "all".
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..constants import COLL_TYPE_LIST, CollType, MemoryType, coll_type_str
from ..status import Status
from ..utils.config import SIZE_INF, parse_memunits

SCORE_MAX = (1 << 31) - 1     # "inf" in tune strings (forces selection)
SCORE_INVALID = -1
SCORE_MIN = 0

_COLL_NAMES = {coll_type_str(c): c for c in COLL_TYPE_LIST}
_MEM_NAMES = {"host": MemoryType.HOST, "cuda": MemoryType.CUDA,
              "cuda_managed": MemoryType.CUDA_MANAGED}
_SCORE_MEM_TYPES = (MemoryType.HOST, MemoryType.CUDA,
                    MemoryType.CUDA_MANAGED)


@dataclass
class MsgRange:
    """ucc_msg_range_t: [start, end) with score+init."""

    start: int
    end: int                      # SIZE_INF for open-ended
    score: int
    init: Optional[Callable] = None   # algorithm init fn
    team: Any = None                  # owning component team (TL/CL)
    alg_name: str = ""
    #: provenance of this range's (score, alg): "default" = component
    #: alg-table defaults, "tune-str" = a UCC_*_TUNE overlay touched it.
    #: Shown in the score dump so team logs say WHY an algorithm was chosen.
    origin: str = "default"
    #: wire-precision tag of quantized variants ("int8"/"fp8"; empty =
    #: exact), kept across tune-str splits
    precision: str = ""
    #: generated-program family/parameter string of DSL candidates
    #: ("ring(chunks=4)"; empty = hand-written), kept across splits
    gen: str = ""
    #: True when the candidate executes as a native plan on this team
    #: (dsl/plan.py): "+plan" in the score dump's provenance column
    plan: bool = False

    def contains(self, msgsize: int) -> bool:
        return self.start <= msgsize < self.end or \
            (self.end == SIZE_INF and msgsize >= self.start)

    def overlaps(self, start: int, end: int) -> bool:
        return self.start < end and start < self.end

    def __repr__(self):
        from ..utils.config import memunits_str
        score = "inf" if self.score >= SCORE_MAX else str(self.score)
        alg = f"@{self.alg_name}" if self.alg_name else ""
        return (f"{{{memunits_str(self.start)}..{memunits_str(self.end)}"
                f"{alg}:{score}}}")


class CollScore:
    """A score table: (coll_type, mem_type) -> list of candidate MsgRanges.

    Candidates may overlap — the map lookup resolves by score. This folds the
    separate score + fallback-list structures of UCC into one."""

    def __init__(self):
        self.ranges: Dict[Tuple[CollType, MemoryType], List[MsgRange]] = {}

    # ------------------------------------------------------------------
    def add_range(self, coll: CollType, mem: MemoryType, start: int, end: int,
                  score: int, init: Optional[Callable] = None, team: Any = None,
                  alg_name: str = "", origin: str = "default",
                  precision: str = "", gen: str = "",
                  plan: bool = False) -> Status:
        """ucc_coll_score_add_range."""
        if start >= end or score < 0:
            return Status.ERR_INVALID_PARAM
        self.ranges.setdefault((coll, mem), []).append(
            MsgRange(start, end, score, init, team, alg_name, origin=origin,
                     precision=precision, gen=gen, plan=plan))
        return Status.OK

    def merge(self, other: "CollScore") -> "CollScore":
        """ucc_coll_score_merge: combine candidates (max-score wins at
        lookup; losers stay as fallbacks)."""
        out = CollScore()
        for src in (self, other):
            for key, lst in src.ranges.items():
                out.ranges.setdefault(key, []).extend(lst)
        return out

    # ------------------------------------------------------------------
    def update_from_str(self, tune: str,
                        alg_resolver: Optional[Callable[[CollType, str], Optional[Callable]]] = None,
                        team: Any = None) -> Status:
        """ucc_coll_score_update_from_str: apply a user/built-in tune string to existing ranges, splitting them at
        range boundaries. ``alg_resolver(coll, alg) -> init fn`` resolves
        ``@alg`` tokens (name or numeric id)."""
        try:
            sections = parse_tune_str(tune)
        except ValueError:
            return Status.ERR_INVALID_PARAM
        for sec in sections:
            colls = sec.colls if sec.colls else list(_COLL_NAMES.values())
            mems = sec.mems if sec.mems else list(_SCORE_MEM_TYPES)
            msg_ranges = sec.msg_ranges if sec.msg_ranges else [(0, SIZE_INF)]
            for c in colls:
                new_init = None
                if sec.alg is not None and alg_resolver is not None:
                    new_init = alg_resolver(c, sec.alg)
                    if new_init is None:
                        return Status.ERR_INVALID_PARAM
                for m in mems:
                    key = (c, m)
                    for (s, e) in msg_ranges:
                        self._update_range(key, s, e, sec.score, new_init,
                                           sec.alg, team)
        return Status.OK

    def _update_range(self, key, start: int, end: int, score: Optional[int],
                      new_init: Optional[Callable], alg: Optional[str],
                      team: Any) -> None:
        lst = self.ranges.get(key)
        if not lst:
            if new_init is not None or score is not None:
                # nothing to update for this (coll, mem) — UCC silently
                # skips colls the component doesn't support
                return
            return
        out: List[MsgRange] = []
        for r in lst:
            if not r.overlaps(start, end):
                out.append(r)
                continue
            lo = max(r.start, start)
            hi = min(r.end, end)
            if r.start < lo:
                out.append(replace(r, end=lo))
            mid = replace(r, start=lo, end=hi)
            if score is not None:
                mid.score = score
                mid.origin = "tune-str"
            if new_init is not None:
                mid.init = new_init
                mid.alg_name = alg or ""
                mid.origin = "tune-str"
                # the resolver hands back an init fn alone: the swapped-in
                # algorithm's precision and generated parameters are
                # unknown here, so the old range's tags go rather than
                # mislabel it (the JAX package's rule)
                mid.precision = ""
                mid.gen = ""
            out.append(mid)
            if hi < r.end:
                out.append(replace(r, start=hi))
        self.ranges[key] = out

    def __repr__(self):
        parts = []
        for (c, m), lst in sorted(self.ranges.items()):
            parts.append(f"{coll_type_str(c)}/{m.name.lower()}:"
                         + ",".join(map(repr, lst)))
        return "CollScore(" + "; ".join(parts) + ")"


# ---------------------------------------------------------------------------
# tune-string parser
# ---------------------------------------------------------------------------

@dataclass
class TuneSection:
    colls: List[CollType] = field(default_factory=list)
    mems: List[MemoryType] = field(default_factory=list)
    msg_ranges: List[Tuple[int, int]] = field(default_factory=list)
    alg: Optional[str] = None
    score: Optional[int] = None


def _try_parse_colls(tok: str) -> Optional[List[CollType]]:
    items = [t.strip().lower() for t in tok.split(",")]
    if all(i in _COLL_NAMES for i in items):
        return [_COLL_NAMES[i] for i in items]
    return None


def _try_parse_mems(tok: str) -> Optional[List[MemoryType]]:
    items = [t.strip().lower() for t in tok.split(",")]
    if all(i in _MEM_NAMES for i in items):
        return [_MEM_NAMES[i] for i in items]
    return None


def _try_parse_msgrange(tok: str) -> Optional[Tuple[int, int]]:
    if "-" not in tok:
        return None
    lo, hi = tok.split("-", 1)
    try:
        start = parse_memunits(lo)
        end = parse_memunits(hi)
    except ValueError:
        return None
    return (start, end)


def parse_tune_str(tune: str) -> List[TuneSection]:
    """Parse the TUNE DSL. Raises ValueError on malformed input."""
    sections: List[TuneSection] = []
    for sec_str in tune.split("#"):
        sec_str = sec_str.strip()
        if not sec_str:
            continue
        sec = TuneSection()
        for tok in sec_str.split(":"):
            tok = tok.strip()
            if not tok:
                continue
            if tok.startswith("@"):
                if sec.alg is not None:
                    raise ValueError(f"duplicate alg token '{tok}'")
                sec.alg = tok[1:].strip().lower()
                continue
            colls = _try_parse_colls(tok)
            if colls is not None:
                sec.colls.extend(colls)
                continue
            mems = _try_parse_mems(tok)
            if mems is not None:
                sec.mems.extend(mems)
                continue
            rng = _try_parse_msgrange(tok)
            if rng is not None:
                sec.msg_ranges.append(rng)
                continue
            if tok.lower() in ("inf", "infinity"):
                sec.score = SCORE_MAX
                continue
            try:
                sec.score = int(tok)
            except ValueError:
                raise ValueError(f"unparseable tune token '{tok}'") from None
            if sec.score < 0:
                raise ValueError(f"negative score '{tok}'")
        sections.append(sec)
    return sections
