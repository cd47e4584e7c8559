"""Measurement-fitted alpha-beta cost model for DSL programs (the port of
``ucc_tpu/score/cost.py``).

It prices a program before it is measured: ``ucc_tune`` and ``ucc_perftest
--sweep`` stamp a ``predicted_us`` column on generated candidates' rows
from a fitted model, and the program search (``dsl/search``) prunes its
space with it. The model is the classic alpha-beta
decomposition, priced per *link class*:

    cost(program, S) = sum over rounds [ alpha(slowest link in round)
                       + max over ranks sum over that rank's send edges
                         bytes(edge) * beta(link of edge) ]

- ``alpha`` is the per-round latency of a link class (microseconds):
  a round completes when its slowest participant's wire ops complete,
  and every round pays at least one latency.
- ``beta`` is the inverse bandwidth (us/byte): within a round a rank's
  sends serialize through its injection path, so the round's byte cost
  is the busiest rank's total — the critical path, not the sum.
- Quantized edges (program-level ``wire`` or per-edge ``Op.wire``) are
  priced at their WIRE bytes (payload/4 + scales for int8).

Link classes: ``shm`` (same host), ``socket`` (same pod, different
host), ``dcn`` (different pod). Coefficients start from documented
seeds; :func:`fit_records` replaces the probed class with a
least-squares fit over sweep measurement records of GENERATED programs
(their ``gen`` string lets us rebuild the exact program and therefore
its feature vector — rounds and critical-path bytes), and rescales the
other classes by the same factors (marked derived, not fitted). A
one-point sweep already fits: different programs at one size have
different (rounds, bytes) ratios, which is enough to separate alpha
from beta.

The fitted model persists as JSON (``UCC_GEN_COST_CACHE``, default
``~/.cache/ucc_tpu_torch/cost.json``: the port never reads the JAX
package's file). Programs are rebuilt through the port's
``dsl/registry.build_named``; a ``hier`` program rebuilds from the team's
topology paths when the caller passes them, and does not rebuild (its
rows are skipped) without them.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils.log import get_logger
from ..utils.mathutils import block_count

logger = get_logger("cost")

DEFAULT_COST_CACHE = "~/.cache/ucc_tpu_torch/cost.json"
COST_VERSION = 1

#: (alpha_us, beta_us_per_byte) seeds per link class — order-of-
#: magnitude priors for an in-process shm mailbox, a TCP socket hop,
#: and a simulated DCN hop. A fit replaces the probed class and scales
#: the others by the same factors.
SEED_LINKS: Dict[str, Tuple[float, float]] = {
    "shm": (2.0, 4.0e-4),
    "socket": (60.0, 1.2e-3),
    "dcn": (250.0, 8.0e-3),
    # the device fabric of the generated device programs: ~1us step
    # latency, ~50 GB/s a link (the JAX package's seed, kept so that a
    # fit from its records and from the port's agree)
    "ici": (1.0, 2.0e-5),
    # one-sided put+flag windows in the process-shared mmap arena (the
    # pooled tier): no mailbox match, no bounce copy — cheaper latency
    # and slightly better bytes than the two-sided shm path
    "pooled": (1.5, 3.0e-4),
}

#: slowest-first ordering for "which link bounds this round's latency"
_LINK_RANK = {"dcn": 4, "socket": 3, "shm": 2, "pooled": 1, "ici": 0}


@dataclass
class LinkCoeffs:
    alpha_us: float
    beta_us_per_byte: float
    fitted: bool = False     # least-squares fit vs seed/derived


def _wire_bytes(payload_bytes: int, mode: str, block: int) -> int:
    """Wire bytes of a quantized edge carrying *payload_bytes* of f32
    (the block-scaled format: 1B/elem for int8/fp8 + one f32 scale per
    *block* elements)."""
    if not mode:
        return payload_bytes
    elems = max(1, payload_bytes // 4)
    nblocks = (elems + block - 1) // block
    return elems + 4 * nblocks


class CostModel:
    """Per-link-class alpha-beta coefficients + program pricing."""

    def __init__(self, links: Optional[Dict[str, LinkCoeffs]] = None,
                 source: str = "seed"):
        self.links: Dict[str, LinkCoeffs] = links or {
            k: LinkCoeffs(a, b) for k, (a, b) in SEED_LINKS.items()}
        self.source = source

    @property
    def fitted(self) -> bool:
        return any(c.fitted for c in self.links.values())

    # ------------------------------------------------------------------
    def features(self, prog, nbytes: int,
                 link_of: Optional[Callable[[int, int], str]] = None,
                 quant_block: int = 256,
                 slow: Optional[Dict[int, float]] = None
                 ) -> Dict[str, List[float]]:
        """Per-link-class feature vector of *prog* moving an
        ``nbytes``-byte vector: {link: [rounds_bounded, critical_bytes]}.
        Linear in (alpha, beta), so the same function serves prediction
        and least-squares fitting.

        ``slow`` is a {rank: slowness multiplier} map: a flagged rank's
        send bytes are weighted by its multiplier both when electing the
        round's critical rank and when accumulating that rank's byte
        features, so a program whose critical path runs through a
        straggler prices proportionally worse."""
        from ..dsl.ir import PUT_KINDS, OpKind
        feats: Dict[str, List[float]] = {}

        def feat(link: str) -> List[float]:
            return feats.setdefault(link, [0.0, 0.0])

        def w(r: int) -> float:
            return slow.get(r, 1.0) if slow else 1.0

        nch = prog.nchunks
        for k in range(prog.n_rounds):
            per_rank: Dict[int, Dict[str, int]] = {}
            round_links: set = set()
            for r in range(prog.nranks):
                for op in prog.ranks[r].rounds[k]:
                    if op.kind == OpKind.SEND:
                        link = link_of(r, op.peer) if link_of else "shm"
                    elif op.kind in PUT_KINDS:
                        # one-sided window puts always ride the arena,
                        # whatever the topology says about the edge
                        link = "pooled"
                    else:
                        continue
                    payload = block_count(nbytes, nch, op.chunk)
                    wire = prog.wire or op.wire
                    byts = _wire_bytes(payload, wire, quant_block)
                    per_rank.setdefault(r, {})[link] = \
                        per_rank.get(r, {}).get(link, 0) + byts
                    round_links.add(link)
            if not round_links:
                continue            # local-only round: no wire latency
            slow_link = max(round_links,
                            key=lambda l: _LINK_RANK.get(l, 0))
            feat(slow_link)[0] += 1.0
            crit = max(per_rank,
                       key=lambda r: w(r) * sum(per_rank[r].values()))
            for link, byts in per_rank[crit].items():
                feat(link)[1] += float(byts) * w(crit)
        return feats

    def predict_us(self, prog, nbytes: int,
                   link_of: Optional[Callable[[int, int], str]] = None,
                   quant_block: int = 256,
                   slow: Optional[Dict[int, float]] = None) -> float:
        """Critical-path price of *prog* in microseconds. Pipelined
        families (sra_pipe) price one fragment at ``nbytes/depth`` and
        scale by the 2-stage-overlap factor ``(depth+1)/2``."""
        depth = int((prog.params or {}).get("depth", 0) or 0)
        if prog.family == "sra_pipe" and depth >= 2:
            frag = max(1, nbytes // depth)
            base = self._price(prog, frag, link_of, quant_block, slow)
            return base * (depth + 1) / 2.0
        return self._price(prog, nbytes, link_of, quant_block, slow)

    def _price(self, prog, nbytes, link_of, quant_block,
               slow=None) -> float:
        total = 0.0
        for link, (rounds, byts) in self.features(
                prog, nbytes, link_of, quant_block, slow).items():
            c = self.links.get(link) or self.links.get("shm") or \
                LinkCoeffs(*SEED_LINKS["shm"])
            total += c.alpha_us * rounds + c.beta_us_per_byte * byts
        return total

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"version": COST_VERSION, "source": self.source,
                "updated": time.time(),
                "links": {k: {"alpha_us": c.alpha_us,
                              "beta_us_per_byte": c.beta_us_per_byte,
                              "fitted": c.fitted}
                          for k, c in self.links.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "CostModel":
        links = {}
        for k, v in (d.get("links") or {}).items():
            try:
                links[k] = LinkCoeffs(float(v["alpha_us"]),
                                      float(v["beta_us_per_byte"]),
                                      bool(v.get("fitted")))
            except (KeyError, TypeError, ValueError):
                continue
        if not links:
            return cls()
        return cls(links, source=str(d.get("source") or "file"))


# ---------------------------------------------------------------------------
# topology -> link classification
# ---------------------------------------------------------------------------

def link_of_device() -> Callable[[int, int], str]:
    """Edge classifier for device-lowered programs: every edge is a hop of
    the device fabric (the "ici" class)."""
    return lambda a, b: "ici"


def link_of_paths(paths) -> Callable[[int, int], str]:
    """Edge classifier from per-rank topology attribute paths (the
    HierTree input): same full path = shm, same pod prefix = socket,
    different pod = dcn. With no topology every edge is shm (the flat
    in-process mesh)."""
    if not paths:
        return lambda a, b: "shm"
    depth = len(paths[0])

    def link(a: int, b: int) -> str:
        if paths[a] == paths[b]:
            return "shm"
        if depth >= 2 and paths[a][0] != paths[b][0]:
            return "dcn"
        return "socket"

    return link


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

def _rebuild_program(gen: str, n: int, paths=None):
    """Rebuild the Program a sweep record's ``gen`` provenance string
    names (``ring(chunks=4)`` / ``hier(top=2,wire=int8)``), or None."""
    from ..dsl.registry import build_named
    famname, params, wire = parse_param_str(gen)
    if not famname:
        return None
    return build_named(famname, params, n, wire=wire, paths=paths)


def parse_param_str(s: str) -> Tuple[str, Dict[str, int], str]:
    """Inverse of ``Program.param_str``: ``"ring(chunks=4)"`` ->
    ``("ring", {"chunks": 4}, "")``. Bare tokens (``int8``/``fp8``) are
    the wire precision; a ``wire=`` key (hier) also routes there."""
    s = (s or "").strip()
    if "(" not in s or not s.endswith(")"):
        return ("", {}, "")
    fam, _, inner = s.partition("(")
    params: Dict[str, int] = {}
    wire = ""
    for tok in inner[:-1].split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" in tok:
            k, _, v = tok.partition("=")
            if k.strip() == "wire":
                wire = v.strip()
            else:
                try:
                    params[k.strip()] = int(v)
                except ValueError:
                    return ("", {}, "")
        else:
            wire = tok
    return (fam.strip(), params, wire)


def fit_records(records: Sequence[dict], link: str = "shm",
                paths=None, uniform: bool = False) -> Optional[CostModel]:
    """Least-squares fit of (alpha, beta) for *link* from sweep
    measurement records of GENERATED programs (rows carrying a ``gen``
    string). Returns None when fewer than two usable rows exist or the
    system is degenerate. Other link classes are rescaled from their
    seeds by the fitted factors (marked derived) — EXCEPT with
    ``uniform=True``, where every class gets the fitted coefficients
    verbatim: the right call on an in-process simulated mesh, whose
    "DCN" links are topological labels over the same memcpy transport
    (quantized edges still price cheaper through wire bytes, but a
    simulated pod hop is not actually slower)."""
    import numpy as np
    rows: List[Tuple[float, float, float]] = []   # (rounds, bytes, us)
    for r in records:
        gen = str(r.get("gen") or "")
        if not gen:
            continue
        try:
            n = int(r["ranks"])
            size = int(r["size_bytes"])
            us = float(r.get("p50_us") if r.get("p50_us") is not None
                       else r["avg_us"])
        except (KeyError, TypeError, ValueError):
            continue
        prog = _rebuild_program(gen, n, paths=paths)
        if prog is None:
            continue
        model = CostModel()
        feats = model.features(prog, size)       # single-class probe
        f = feats.get("shm") or [0.0, 0.0]
        if f[0] <= 0:
            continue
        rows.append((f[0], f[1], us))
    if len(rows) < 2:
        return None
    A = np.array([[r[0], r[1]] for r in rows])
    y = np.array([r[2] for r in rows])
    try:
        sol, *_ = np.linalg.lstsq(A, y, rcond=None)
    except np.linalg.LinAlgError:
        return None
    alpha = float(max(sol[0], 1e-3))
    beta = float(max(sol[1], 1e-9))
    seeds = SEED_LINKS
    sa, sb = seeds.get(link, seeds["shm"])
    fa, fb = alpha / sa, beta / sb
    links = {}
    for k, (a, b) in seeds.items():
        if k == link:
            links[k] = LinkCoeffs(alpha, beta, fitted=True)
        elif uniform:
            links[k] = LinkCoeffs(alpha, beta, fitted=False)
        else:
            links[k] = LinkCoeffs(a * fa, b * fb, fitted=False)
    m = CostModel(links,
                  source=f"fit:{link}:{len(rows)}rows"
                         + (":uniform" if uniform else ""))
    logger.info("cost: fitted %s alpha=%.2fus beta=%.3gus/B from %d "
                "sweep rows", link, alpha, beta, len(rows))
    return m


def predict_for_record(model: Optional[CostModel], gen: str, n: int,
                       size_bytes: int, paths=None) -> Optional[float]:
    """Price the program a sweep record's ``gen`` string names, for the
    record's ``predicted_us`` column; None when no fitted model, no gen
    provenance, or the program does not rebuild."""
    if model is None or not gen:
        return None
    try:
        prog = _rebuild_program(gen, n, paths=paths)
        if prog is None:
            return None
        return model.predict_us(prog, size_bytes, link_of_paths(paths))
    except Exception:  # noqa: BLE001 - a pricing failure must not cost
        # the sweep its measurement row
        logger.debug("cost: no price for %s at n=%d", gen, n,
                     exc_info=True)
        return None


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def resolve_cost_path(raw: str = "") -> str:
    return os.path.expanduser(
        raw or os.environ.get("UCC_GEN_COST_CACHE", "")
        or DEFAULT_COST_CACHE)


def save_model(model: CostModel, path: str = "") -> str:
    p = resolve_cost_path(path)
    d = os.path.dirname(p)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{p}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(model.to_dict(), fh, indent=1, sort_keys=True)
    os.replace(tmp, p)
    return p


def load_model(path: str = "") -> Optional[CostModel]:
    """Load a previously fitted model; None when absent/unreadable or
    never fitted (a pure seed model is not worth a predicted_us
    column)."""
    p = resolve_cost_path(path)
    try:
        with open(p) as fh:
            d = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(d, dict) or d.get("version") != COST_VERSION:
        return None
    m = CostModel.from_dict(d)
    return m if m.fitted else None
