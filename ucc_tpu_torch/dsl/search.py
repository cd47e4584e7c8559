"""Cost-model-guided program search (the port of ``ucc_tpu/dsl/search.py``).

``UCC_GEN_FAMILIES`` sweeps fixed parameter grids nobody picked; this
module replaces enumeration with SEARCH over the joint candidate space
(family x radix x chunking x pipeline depth x per-edge quantization x
hierarchical composition), in three stages:

1. **Propose** (:func:`propose`): build + statically verify every
   applicable program of the joint space for the target (collective,
   team size, topology). The verifier is the safety gate — an invalid
   point of the space is rejected exactly like a broken grid entry.
2. **Prune** (:func:`shortlist`): price every candidate with the
   measurement-fitted alpha-beta model (score/cost.py) and keep the
   ``UCC_GEN_SEARCH_BUDGET`` cheapest per message size — predicted
   cost turns an unmeasurably large space into a measurable one.
3. **Refine** (:func:`successive_halving`): measure the survivors
   through the tuner sweep engine with INTERLEAVED iterations
   (candidates alternate inside one timing loop, so drift hits all of
   them equally; per-candidate medians), halving the field while
   doubling the iteration budget until a winner remains.

Winners persist twice, with full provenance (family/parameter string,
predicted AND measured cost):

- into the **search cache** (``UCC_GEN_SEARCH_CACHE``, default
  ``~/.cache/ucc_tpu_torch/search.json``), which
  :func:`searched_programs` replays at team creation — behind
  ``UCC_GEN_SEARCH`` the registry registers every persisted winner as
  an ordinary score-map candidate with ``origin="searched"``;
- into the **tuner cache** (score/tuner.py) for the points a searched
  program actually won, so ``UCC_TUNER=offline`` activation dispatches
  the searched program with ``(searched gen:...)`` provenance in the
  score dump.

The device target (:func:`run_device_search`) searches the programs
``dsl/lower_device`` lowers to tl/torch_ops' ``gen_dev_*`` candidates
(CUDA memory; on the GPU they launch the generated-collective kernels of
``csrc/gen_fold.cu``), refines them against the library candidates of
the same team and writes the winners into the tuning cache with mem
``cuda`` and origin ``searched``.

Both packages read ``UCC_GEN_SEARCH_CACHE``. The port's search cache
carries the package name in its version tag: the port reads no file the
JAX package wrote (and the JAX package reads the port's as a version
mismatch).

Hierarchical candidates compose per-level programs along the CL/HIER
topology tree (families.gen_hier): exact ICI-class intra-node edges,
optionally-quantized DCN-class inter-pod edges — the HiCCL composition
as a searchable point of the same space.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..constants import CollType, coll_type_str
from ..utils.log import get_logger
from . import families as fam
from .ir import Program
from .registry import build_named, paths_digest

logger = get_logger("search")

DEFAULT_SEARCH_CACHE = "~/.cache/ucc_tpu_torch/search.json"
SEARCH_VERSION = 1
#: the version tag of the port's search-cache file
SEARCH_TAG = f"ucc_tpu_torch/{SEARCH_VERSION}"

_COLL_BY_NAME = {coll_type_str(c): c for c in CollType}


def _coll_count(coll: CollType, size: int, n: int) -> int:
    """Per-rank element count such that the collective's FULL logical
    vector is ~``size`` bytes of f32 — the same quantity the cost model
    prices, so predicted and measured costs refer to one message size.
    (make_args: allgather dst / reduce_scatter src are count*n.)"""
    if coll in (CollType.ALLGATHER, CollType.REDUCE_SCATTER):
        return max(1, size // 4 // n)
    return max(1, size // 4)


def _make_args(coll: CollType, r: int, n: int, count: int, mem):
    """Rank *r*'s persistent float32 SUM args of the sweep (perftest's
    ``make_args``: ones in, zeros out), on the device *mem* names."""
    from ..constants import DataType, ReductionOp
    from ..tools.perftest import buffer_device, make_args
    return make_args(coll, n, count, DataType.FLOAT32, ReductionOp.SUM,
                     mem, False, 0, True, buffer_device(mem), rank=r)


# ---------------------------------------------------------------------------
# candidate space
# ---------------------------------------------------------------------------

@dataclass
class Candidate:
    """One searchable program plus its search provenance."""

    prog: Program
    family: str
    params: Dict[str, Any]
    wire: str = ""
    hier: bool = False
    predicted_us: Optional[float] = None
    measured_us: Optional[float] = None
    from_grid: bool = False        # also reachable by UCC_GEN_FAMILIES

    @property
    def name(self) -> str:
        return self.prog.name

    def entry(self, coll: CollType, n: int, digest: str) -> dict:
        e = {"coll": coll_type_str(coll), "n": int(n),
             "family": self.family, "params": dict(self.params),
             "wire": self.wire, "name": self.name,
             "gen": self.prog.param_str, "paths_digest": digest,
             "created": time.time()}
        if self.predicted_us is not None:
            e["predicted_us"] = round(self.predicted_us, 2)
        if self.measured_us is not None:
            e["measured_us"] = round(self.measured_us, 2)
        return e


def _radix_grid(n: int) -> List[int]:
    """Radices worth trying at team size n: every r with n == r^k plus
    the direct exchange (r = n)."""
    out = []
    for r in range(2, min(n, 17)):
        full = 1
        while full < n:
            full *= r
        if full == n:
            out.append(r)
    if n not in out:
        out.append(n)
    return out


def propose(coll: CollType, n: int, paths=None, quant_mode: str = "",
            grid_names: Optional[set] = None,
            target: str = "host") -> List[Candidate]:
    """Every verified candidate of the joint space for (coll, n,
    topology). ``grid_names`` marks which names the fixed
    UCC_GEN_FAMILIES grids already reach (the acceptance criterion
    cares whether a WINNER lies outside them). ``target="device"``
    restricts the space to DEVICE-LOWERABLE programs (tl/torch_ops'
    generated collectives — ring chunkings, rhd radices, bcast
    trees/chains, the fused quantized direct exchange) and drops
    everything whose layer plan refuses to lower; price those with
    :func:`~..score.cost.link_of_device` (the "ici" device link class)."""
    cands: List[Candidate] = []
    seen: set = set()
    grid_names = grid_names or set()
    device = target == "device"
    if device:
        if coll not in (CollType.ALLREDUCE, CollType.BCAST):
            # the device buffer contract covers full-vector collectives
            # only (allgather/reduce_scatter stay host-side)
            return []
        from .lower_device import plan_rounds

    def add(family: str, params: Dict[str, Any], wire: str = "",
            hier: bool = False) -> None:
        if device and (hier or family in ("sra", "sra_pipe")):
            return
        p = build_named(family, params, n, wire=wire,
                        paths=paths if hier else None)
        if p is None or p.name in seen:
            return
        if device:
            try:
                plan_rounds(p, n)
            except fam.Inapplicable:
                return
        seen.add(p.name)
        cands.append(Candidate(p, family, params, wire, hier,
                               from_grid=p.name in grid_names))

    if device and coll == CollType.ALLREDUCE:
        # power-of-two chunkings only: the device contract needs
        # chunk-divisible counts (no near-equal split), and the sweep
        # grid is power-of-two sizes — ring(chunks=3/6) would shortlist
        # but always refuse dispatch, burning budget slots on None rows
        for m in (1, 2, 4, 8):
            add("ring", {"chunks": m})
        for r in _radix_grid(n):
            add("rhd", {"radix": r})
        if quant_mode:
            # the device codec serves the direct exchange (radix n)
            add("qdirect", {"radix": n}, wire=quant_mode)
        return cands
    if coll == CollType.ALLREDUCE:
        for m in (1, 2, 3, 4, 6, 8):
            add("ring", {"chunks": m})
        for r in _radix_grid(n):
            add("rhd", {"radix": r})
            if quant_mode:
                add("qdirect", {"radix": r}, wire=quant_mode)
        for r in (2, 3, 4, 8):
            if r < n:
                add("sra", {"radix": r})
        for d in (2, 3, 4, 6, 8):
            add("sra_pipe", {"depth": d})
            for r in (2, 4):
                if r < n:
                    add("sra_pipe", {"depth": d, "radix": r})
        if paths:
            for top in (0, 2, 4, 8):
                add("hier", {"top": top}, hier=True)
                if quant_mode:
                    add("hier", {"top": top}, wire=quant_mode, hier=True)
            for m in (1, 2, 4):     # ring-top leaders at wire chunking m
                add("hier", {"top": 1, "chunks": m}, hier=True)
    elif coll == CollType.ALLGATHER:
        for m in (1, 2, 4):
            add("ag_ring", {"chunks": m})
        for r in _radix_grid(n):
            add("ag_rd", {"radix": r})
    elif coll == CollType.REDUCE_SCATTER:
        for m in (1, 2, 4):
            add("rs_ring", {"chunks": m})
        add("rs_direct", {})
    elif coll == CollType.BCAST:
        for r in (2, 3, 4, 8, n):
            if 2 <= r <= n:
                add("bc_kn", {"radix": r})
        for m in (1, 2, 4, 8):
            add("bc_chain", {"chunks": m})
    return cands


def grid_program_names(coll: CollType, n: int, paths=None,
                       quant_mode: str = "") -> set:
    """Names the fixed UCC_GEN_FAMILIES default grids reach at this
    (coll, n) — the baseline set a searched winner must beat to count
    as a search-only discovery. Delegates to the registry's own grid
    walk so the qdirect/hier-quant gating rules live in ONE place.
    Window (pooled) programs are excluded: they only dispatch on
    arena-backed teams, so the search neither proposes nor measures
    them — they are not part of the searchable baseline."""
    from .registry import built_in_programs
    return {p.name
            for p in built_in_programs(n, quant_mode=quant_mode,
                                       paths=paths)
            if p.coll == coll and not p.uses_windows}


def shortlist(cands: Sequence[Candidate], model, nbytes: int,
              budget: int,
              link_of: Optional[Callable[[int, int], str]] = None,
              slow: Optional[Dict[int, float]] = None
              ) -> List[Candidate]:
    """Price every candidate at THIS message size and keep the
    ``budget`` cheapest (stable order by predicted cost, then name for
    determinism). Returns per-size Candidate copies — the same program
    prices differently at different sizes, so shortlists must not
    share mutable prediction state.

    ``slow`` is a {rank: slowness multiplier} map (the continuous
    collector's RankBias.slow_map, obs/collector.py): the cost model
    weights a flagged rank's link terms by its multiplier, so a search
    re-run under a live straggler shortlists programs that route around
    it instead of through it."""
    import dataclasses
    priced = []
    for c in cands:
        cc = dataclasses.replace(c)
        cc.predicted_us = model.predict_us(c.prog, nbytes, link_of,
                                           slow=slow)
        priced.append(cc)
    priced.sort(key=lambda c: (c.predicted_us, c.name))
    return priced[:max(1, int(budget))]


# ---------------------------------------------------------------------------
# interleaved measurement + successive halving (via the tuner sweep
# engine's forced-candidate dispatch)
# ---------------------------------------------------------------------------

def interleaved_measure(teams, contexts, argses, coll: CollType, mem,
                        msgsize: int, idxs: Sequence[int], iters: int,
                        warmup: int = 1, timeout: float = 60.0
                        ) -> Dict[int, Optional[float]]:
    """Time score-map candidates *idxs* with INTERLEAVED iterations:
    iteration i runs every candidate once before iteration i+1 runs
    any, so clock drift and background noise hit all candidates
    equally (the interleaved-median methodology). On CUDA memory a
    round ends when every rank's request completes, which the device
    tasks report at their CUDA event. Returns {idx: median_us or
    None-for-failed}."""
    from ..score.tuner import forced_request
    from ..status import Status, UccError

    reqs_by: Dict[int, list] = {}
    samples: Dict[int, List[float]] = {}
    for idx in idxs:
        # EVERY rank attempts its init even when one refuses: the task
        # ctor consumes a team coll tag before its NOT_SUPPORTED
        # checks, so bailing early would desync tag counters across
        # ranks and wedge every later candidate on this job
        reqs, errs = [], []
        for r in range(len(teams)):
            try:
                reqs.append(forced_request(teams[r], argses[r], coll,
                                           mem, msgsize, idx))
            except UccError as e:
                errs.append(e)
        if errs:
            for rq in reqs:
                try:
                    rq.finalize()
                except Exception:  # noqa: BLE001 - sweep cleanup
                    pass
            samples[idx] = None  # type: ignore[assignment]
        else:
            reqs_by[idx] = reqs
            samples[idx] = []
    dead: set = set()
    for it in range(warmup + iters):
        for idx, reqs in reqs_by.items():
            if idx in dead:
                continue
            t0 = time.perf_counter()
            for rq in reqs:
                rq.post()
            deadline = time.monotonic() + timeout
            ok = True
            while any(rq.test() == Status.IN_PROGRESS for rq in reqs):
                for c in contexts:
                    c.progress()
                if time.monotonic() > deadline:
                    for rq in reqs:
                        rq.task.cancel(Status.ERR_TIMED_OUT)
                    ok = False
                    break
            if not ok or any(rq.test() != Status.OK for rq in reqs):
                dead.add(idx)
                samples[idx] = None  # type: ignore[assignment]
                continue
            if it >= warmup:
                samples[idx].append((time.perf_counter() - t0) * 1e6)
    for reqs in reqs_by.values():
        for rq in reqs:
            try:
                rq.finalize()
            except Exception:  # noqa: BLE001 - sweep cleanup
                pass
    out: Dict[int, Optional[float]] = {}
    for idx, ss in samples.items():
        if not ss:
            out[idx] = None
        else:
            ss = sorted(ss)
            out[idx] = ss[len(ss) // 2]
    return out


def successive_halving(teams, contexts, argses, coll: CollType, mem,
                       msgsize: int, idxs: Sequence[int],
                       iters0: int = 3, max_iters: int = 24,
                       timeout: float = 60.0
                       ) -> Tuple[Dict[int, float], List[int]]:
    """Refine candidate indices by successive halving: measure the
    field interleaved, keep the best half, double the budget, repeat
    until <= 2 survive (those get the final full-budget comparison).
    Returns ({idx: last-rung median_us}, final survivor order)."""
    field = list(idxs)
    iters = max(1, int(iters0))
    best: Dict[int, float] = {}
    while field:
        meds = interleaved_measure(teams, contexts, argses, coll, mem,
                                   msgsize, field, iters,
                                   timeout=timeout)
        live = [(m, i) for i, m in meds.items() if m is not None]
        for m, i in live:
            best[i] = m
        if not live:
            return best, []
        live.sort()
        field = [i for _m, i in live]
        if len(field) <= 1:
            break
        if len(field) == 2:
            # the last two ALWAYS get a doubled-budget confirmation
            # rung before one is declared the winner — including when
            # the field ENTERED at two (truncating here would decide on
            # the lowest-iteration samples, the opposite of the
            # methodology)
            if iters >= iters0 * 2:
                break
        else:
            field = field[:max(1, (len(field) + 1) // 2)]
        if iters >= max_iters:
            break
        iters = min(max_iters, iters * 2)
    return best, field


# ---------------------------------------------------------------------------
# search cache (persisted searched programs, flock'd like the tuner's)
# ---------------------------------------------------------------------------

def resolve_search_cache_path(raw: str = "") -> str:
    return os.path.expanduser(
        raw or os.environ.get("UCC_GEN_SEARCH_CACHE", "")
        or DEFAULT_SEARCH_CACHE)


def load_search_cache(path: str) -> Dict[str, Any]:
    try:
        with open(path) as fh:
            data = json.load(fh)
        if isinstance(data, dict) and data.get("version") == SEARCH_TAG:
            return data
    except (OSError, ValueError):
        pass
    return {"version": SEARCH_TAG, "entries": []}


def store_search_entries(path: str, entries: Sequence[dict],
                         replace_scopes: Sequence[Tuple[str, int, str]] = ()
                         ) -> None:
    """flock'd read-modify-write. Each ``replace_scopes`` item
    (coll, n, digest) drops every existing entry of that scope first —
    a fresh search replaces the previous winners for its target, and
    throwaway shortlist candidates don't accumulate."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    scopes = {(str(c), int(n), str(dg)) for (c, n, dg) in replace_scopes}
    with open(f"{path}.lock", "w") as lk:
        try:
            import fcntl
            fcntl.flock(lk, fcntl.LOCK_EX)
        except (ImportError, OSError):
            pass
        cache = load_search_cache(path)
        cur = [e for e in (cache.get("entries") or [])
               if isinstance(e, dict) and
               (str(e.get("coll") or ""), int(e.get("n") or 0),
                str(e.get("paths_digest") or "")) not in scopes]
        names = {(e.get("coll"), e.get("n"), e.get("paths_digest"),
                  e.get("name")) for e in cur}
        for e in entries:
            key = (e.get("coll"), e.get("n"), e.get("paths_digest"),
                   e.get("name"))
            if key not in names:
                names.add(key)
                cur.append(dict(e))
        cache["entries"] = cur
        cache["updated"] = time.time()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(cache, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)


#: mtime-keyed memo of the parsed search cache: team creates are per
#: rank per job, and re-parsing an unchanged JSON for each one defeats
#: the "zero cost when the cache has no entries" promise
_SEARCH_CACHE_MEMO: Dict[str, Any] = {"key": None, "data": None}


def _load_search_cache_memo(path: str) -> Dict[str, Any]:
    try:
        mt = os.path.getmtime(path)
    except OSError:
        mt = None
    key = (path, mt)
    if _SEARCH_CACHE_MEMO["key"] != key:
        _SEARCH_CACHE_MEMO["key"] = key
        _SEARCH_CACHE_MEMO["data"] = load_search_cache(path)
    return _SEARCH_CACHE_MEMO["data"]


def _winner_entry_from_gen(cname: str, n: int, alg: str, gen: str,
                           digest: str) -> Optional[dict]:
    """Search-cache entry for a measured winner that was NOT in the
    shortlist (a grid-generated candidate the measurement rung beat the
    shortlist with): the search measured and validated it, so it earns
    the same persisted provenance. None for hand-written winners."""
    from ..score.cost import parse_param_str
    famname, params, wire = parse_param_str(gen)
    if not famname:
        return None
    return {"coll": cname, "n": int(n), "family": famname,
            "params": params, "wire": wire, "name": alg, "gen": gen,
            "paths_digest": digest if famname == "hier" else "",
            "created": time.time()}


def _previous_winners(path: str, scopes) -> List[dict]:
    """Measured winner entries currently persisted for *scopes* — the
    restore set when a fresh search dies before measuring anything (a
    transient failure must not wipe good prior tuning state)."""
    keys = {(str(c), int(n), str(d)) for (c, n, d) in scopes}
    out = []
    for e in load_search_cache(path).get("entries") or []:
        if isinstance(e, dict) and e.get("measured_us") is not None and \
                (str(e.get("coll") or ""), int(e.get("n") or 0),
                 str(e.get("paths_digest") or "")) in keys:
            out.append(dict(e))
    return out


def searched_programs(team, n: int, paths=None) -> List[Program]:
    """Rebuild + verify the persisted searched programs applicable to
    this (team size, topology) — the registry's UCC_GEN_SEARCH hook.
    Every program re-passes the static verifier via build_named (a
    cache written by a different DSL version simply rebuilds); entries
    that no longer build are skipped with a log line. Quantized
    winners only register when the team's quant policy enables their
    wire mode — otherwise every dispatch would pay a failed task build
    before the fallback walk recovers."""
    path = resolve_search_cache_path()
    try:
        cache = _load_search_cache_memo(path)
    except Exception:  # noqa: BLE001 - unreadable cache = no candidates
        return []
    digest = paths_digest(paths)
    out: List[Program] = []
    for e in cache.get("entries") or []:
        if not isinstance(e, dict) or int(e.get("n") or 0) != int(n):
            continue
        e_dig = str(e.get("paths_digest") or "")
        hier = e.get("family") == "hier"
        if hier and e_dig != digest:
            continue            # a hier program is topology-exact
        if not hier and e_dig not in ("", digest):
            continue
        wire = str(e.get("wire") or "")
        if wire:
            coll = _COLL_BY_NAME.get(str(e.get("coll") or ""))
            try:
                from .. import quant
                if team is None or coll is None or \
                        (quant.coll_mode(team, coll) or "") != wire:
                    continue
            except Exception:  # noqa: BLE001 - policy probe only
                continue
        try:
            prog = build_named(str(e.get("family") or ""),
                               dict(e.get("params") or {}), n,
                               wire=wire,
                               paths=paths if hier else None)
        except ValueError:
            prog = None             # family no longer exists
        if prog is None:
            logger.info("search: cached entry %s no longer builds; "
                        "skipped", e.get("name"))
            continue
        out.append(prog)
    return out


# ---------------------------------------------------------------------------
# end-to-end search run (ucc_tune --gen-search, dsl/smoke, chip_smoke)
# ---------------------------------------------------------------------------

def _shm_index_by_name(cands) -> Dict[str, int]:
    """Score-map lookup index per algorithm name, preferring the shm
    TL's instance (the in-process mesh's fast path)."""
    from ..score.score_map import comp_name
    out: Dict[str, int] = {}
    for i, c in enumerate(cands):
        name = c.alg_name or ""
        if name not in out:
            out[name] = i
        elif comp_name(c) == "shm" and \
                comp_name(cands[out[name]]) != "shm":
            out[name] = i
    return out


def run_search(n: int, colls: Sequence[str], sizes: Sequence[int],
               iters: int = 3, budget: Optional[int] = None,
               quant_mode: str = "", search_cache: str = "",
               tuner_cache: str = "", model=None,
               fit_iters: int = 6, verbose: bool = True,
               measure_grid: bool = True) -> dict:
    """The full pipeline on an in-process n-rank mesh: fit (or load)
    the cost model, propose + prune the joint space, register the
    shortlist via the search cache, refine by successive halving, and
    persist winners into both caches with origin "searched". Returns a
    report dict (the ``ucc_tune --gen-search`` output, the smoke probe's
    record)."""
    from ..api.types import coll_args_msgsize
    from ..constants import MemoryType
    from ..score import cost
    from ..score.tuner import (store_entries, sweep_candidates,
                               topo_signature)
    from ..tools.perftest import COLLS
    from ..tools.tune import _Job, run_sweep

    budget = budget or int(os.environ.get("UCC_GEN_SEARCH_BUDGET",
                                          "10") or 10)
    search_cache = resolve_search_cache_path(search_cache)
    report: dict = {"metric": "gen_search", "ranks": n,
                    "sizes": list(sizes), "budget": budget,
                    "colls": list(colls)}
    overrides = {"GEN": "y", "TUNER": "off"}
    if quant_mode:
        overrides["QUANT"] = quant_mode

    # -- stage 0: the cost model (load a fitted one, else fit from a
    # one-point generated sweep probe)
    if model is None:
        model = cost.load_model()
        if model is not None:
            report["cost_model"] = f"loaded:{model.source}"
    if model is None:
        job = _Job(n, dict(overrides))
        try:
            # three probe decades: a single size cannot condition the
            # (alpha, beta) separation the pruning ordering rests on
            mid = sorted(sizes)[len(sizes) // 2]
            probe_sizes = sorted({max(1024, mid // 16), mid,
                                  mid * 8})
            recs = run_sweep(job, ["allreduce"], probe_sizes, fit_iters,
                             2, verbose=False)
        finally:
            job.destroy()
        # uniform: the probe mesh is in-process — every link class is
        # the same memcpy transport; only the shm TL's rows calibrate
        model = cost.fit_records(
            [r for r in recs
             if r.get("gen") and r.get("comp") in (None, "shm")],
            uniform=True)
        if model is None:
            model = cost.CostModel()
            report["cost_model"] = "seed (probe fit failed)"
        else:
            cost.save_model(model)
            report["cost_model"] = model.source
    report["cost_links"] = {k: [round(c.alpha_us, 3),
                                c.beta_us_per_byte]
                            for k, c in model.links.items()}

    # -- stage 1: propose + prune, persist shortlist so the probe team
    # registers every searched candidate
    probe = _Job(n, dict(overrides))
    results: List[dict] = []
    try:
        team0 = probe.teams[0]
        sig = topo_signature(team0)
        from .registry import team_paths
        host_team = None
        for c in sweep_candidates(team0, CollType.ALLREDUCE,
                                  MemoryType.HOST, 4096):
            host_team = c.team
            break
        paths = team_paths(host_team) if host_team is not None else None
        digest = paths_digest(paths)
        link_of = cost.link_of_paths(paths)
        shortlists: Dict[Tuple[str, int], List[Candidate]] = {}
        cand_entries: List[dict] = []
        scopes = set()
        for cname in colls:
            ct = COLLS[cname]
            grid = grid_program_names(ct, n, paths, quant_mode)
            space = propose(ct, n, paths, quant_mode, grid_names=grid)
            report.setdefault("space", {})[cname] = len(space)
            scopes.add((cname, n, ""))
            scopes.add((cname, n, digest))
            for size in sizes:
                sl = shortlist(list(space), model, size, budget, link_of)
                shortlists[(cname, size)] = sl
                for c in sl:
                    cand_entries.append(c.entry(ct, n, digest
                                                if c.hier else ""))
        prev_winners = _previous_winners(search_cache, scopes)
        store_search_entries(search_cache, cand_entries,
                             replace_scopes=sorted(scopes))
    finally:
        probe.destroy()

    # -- stage 2: measurement job with the shortlist REGISTERED
    # (UCC_GEN_SEARCH picks the candidates up from the search cache;
    # the env override is restored after the job)
    saved_env = os.environ.get("UCC_GEN_SEARCH_CACHE")
    os.environ["UCC_GEN_SEARCH_CACHE"] = search_cache
    job = None
    winners: List[dict] = []
    tuner_entries: List[dict] = []
    measured_any = False
    try:
        job = _Job(n, dict(overrides, GEN_SEARCH="y"))
        sig = topo_signature(job.teams[0])
        for (cname, size), sl in sorted(shortlists.items()):
            ct = COLLS[cname]
            count = _coll_count(ct, size, n)
            argses = [_make_args(ct, r, n, count, MemoryType.HOST)
                      for r in range(n)]
            msgsize = coll_args_msgsize(argses[0], n, 0)
            cands = sweep_candidates(job.teams[0], ct,
                                     MemoryType.HOST, msgsize)
            by_name = _shm_index_by_name(cands)
            want = {c.name for c in sl}
            if measure_grid:
                want |= {cands[i].alg_name for i in by_name.values()
                         if cands[i].origin in ("generated", "searched")}
                # the static default (best hand-written) as the floor
                for i, c in enumerate(cands):
                    if c.origin not in ("generated", "searched"):
                        want.add(c.alg_name)
                        break
            idxs = [by_name[nm] for nm in sorted(want) if nm in by_name]
            meds, order = successive_halving(
                job.teams, job.contexts, argses, ct, MemoryType.HOST,
                msgsize, idxs, iters0=iters)
            if any(m is not None for m in meds.values()):
                measured_any = True
            sl_by_name = {c.name: c for c in sl}
            finalists = []
            for i in sorted(meds, key=lambda i: meds[i]):
                c = cands[i]
                sc = sl_by_name.get(c.alg_name)
                finalists.append({
                    "alg": c.alg_name, "origin": c.origin,
                    "gen": c.gen, "measured_us": round(meds[i], 2),
                    "predicted_us": round(sc.predicted_us, 2)
                    if sc is not None and sc.predicted_us is not None
                    else None,
                    "from_grid": sc.from_grid if sc else
                    c.origin != "searched"})
            res = {"coll": cname, "size_bytes": size,
                   "finalists": finalists}
            if order:
                win = cands[order[0]]
                win_c = sl_by_name.get(win.alg_name)
                res["winner"] = win.alg_name
                res["winner_gen"] = win.gen
                res["winner_measured_us"] = round(meds[order[0]], 2)
                if win_c is None and win.gen:
                    e = _winner_entry_from_gen(cname, n, win.alg_name,
                                               win.gen, digest)
                    if e is not None:
                        e["measured_us"] = res["winner_measured_us"]
                        winners.append(e)
                        from ..score.tuner import (bucket_range,
                                                   size_bucket)
                        start, end = bucket_range(size_bucket(msgsize))
                        tuner_entries.append(
                            {"coll": cname, "mem": "host",
                             "start": start, "end": end,
                             "alg": win.alg_name, "comp": "shm",
                             "origin": "searched", "gen": win.gen,
                             "measured_us": res["winner_measured_us"]})
                if win_c is not None:
                    win_c.measured_us = meds[order[0]]
                    res["winner_predicted_us"] = round(
                        win_c.predicted_us, 2) \
                        if win_c.predicted_us is not None else None
                    res["search_only"] = not win_c.from_grid
                    winners.append(win_c.entry(
                        _COLL_BY_NAME[cname], n,
                        digest if win_c.hier else ""))
                    from ..score.tuner import bucket_range, size_bucket
                    start, end = bucket_range(size_bucket(msgsize))
                    tuner_entries.append(
                        {"coll": cname, "mem": "host", "start": start,
                         "end": end, "alg": win.alg_name,
                         "comp": "shm", "origin": "searched",
                         "gen": win.gen,
                         "predicted_us": res.get("winner_predicted_us"),
                         "measured_us": res["winner_measured_us"]})
            results.append(res)
            if verbose:
                top = finalists[0] if finalists else {}
                print(f"# search {cname} {size}B: winner "
                      f"{res.get('winner')} "
                      f"({res.get('winner_measured_us')}us, predicted "
                      f"{res.get('winner_predicted_us')}us, "
                      f"{len(finalists)} finalists, best measured "
                      f"{top.get('alg')})", flush=True)
    finally:
        # persist IN THE FINALLY: searched winners (however many were
        # decided before any failure) replace the throwaway shortlist
        # candidates for every scope this run touched — an interrupted
        # measurement must not leave unmeasured candidates permanently
        # registered as "searched"; a run that died before measuring
        # ANYTHING restores the previous winners instead of wiping them
        try:
            store_search_entries(search_cache,
                                 winners if measured_any
                                 else prev_winners,
                                 replace_scopes=sorted(scopes))
            if tuner_entries and tuner_cache:
                store_entries(tuner_cache, sig, tuner_entries,
                              source="searched")
                report["tuner_entries"] = len(tuner_entries)
        except Exception:  # noqa: BLE001 - cache cleanup best-effort
            logger.exception("search: winner persistence failed")
        if job is not None:
            job.destroy()
        if saved_env is None:
            os.environ.pop("UCC_GEN_SEARCH_CACHE", None)
        else:
            os.environ["UCC_GEN_SEARCH_CACHE"] = saved_env
    report["results"] = results
    report["winners"] = [w.get("name") for w in winners]
    report["signature"] = sig
    return report


def _device_family_spec(cands: List[Candidate], n: int) -> str:
    """UCC_GEN_DEVICE_FAMILIES string registering exactly *cands* (the
    measurement job's grid). Radix/param n maps to the grid's 0."""
    by_fam: Dict[str, List[int]] = {}
    key_of = {"ring": "chunks", "rhd": "radix", "bc_kn": "radix",
              "bc_chain": "chunks", "qdirect": "radix"}
    for c in cands:
        pk = key_of.get(c.family)
        if pk is None:
            continue
        v = int(c.params.get(pk, 0))
        if c.family in ("rhd", "bc_kn", "qdirect") and v == n:
            v = 0
        lst = by_fam.setdefault(c.family, [])
        if v not in lst:
            lst.append(v)
    return ",".join(
        f"{famname}({','.join(str(v) for v in sorted(ps))})"
        for famname, ps in sorted(by_fam.items()))


def run_device_search(n: int, colls: Sequence[str],
                      sizes: Sequence[int], iters: int = 3,
                      budget: Optional[int] = None,
                      quant_mode: str = "", tuner_cache: str = "",
                      model=None, verbose: bool = True) -> dict:
    """Cost-model-guided search over DEVICE programs: price the
    device-lowerable space with the device ("ici") link class, register
    the predicted-cheapest shortlist on a CUDA-memory team
    (UCC_GEN_DEVICE_FAMILIES carries exactly the shortlist, as tl/torch_ops'
    ``gen_dev_*`` rows), refine by successive halving against the
    library candidates of the same team (torch_ops ``xla``/``short``/
    ``ring``, ring_cuda), and persist winning generated-device selections
    into the tuner cache (mem "cuda", origin "searched"). On the GPU the
    measured programs launch the generated-collective kernels; a team on
    the CPU (``UCC_TL_RING_CUDA_DEVICE=cpu``) runs their plain
    versions."""
    from ..api.types import coll_args_msgsize
    from ..constants import MemoryType
    from ..score import cost
    from ..score.score_map import comp_name
    from ..score.tuner import (bucket_range, size_bucket, store_entries,
                               sweep_candidates, topo_signature)
    from ..tools.perftest import COLLS
    from ..tools.tune import _Job

    budget = budget or int(os.environ.get("UCC_GEN_SEARCH_BUDGET",
                                          "10") or 10)
    report: dict = {"metric": "gen_device_search", "ranks": n,
                    "sizes": list(sizes), "budget": budget,
                    "colls": list(colls)}
    if model is None:
        model = cost.load_model()
    if model is None:
        model = cost.CostModel()
        report["cost_model"] = "seed"
    else:
        report["cost_model"] = model.source
    if "ici" not in model.links:
        # a persisted model fitted before the ici class existed would
        # silently price every device edge with the shm fallback
        # (20x the beta); derive ici coefficients from the model's shm
        # scale factors instead, the same derived-class rule fit_records
        # applies to unfitted classes
        shm = model.links.get("shm")
        sa, sb = cost.SEED_LINKS["shm"]
        ia, ib = cost.SEED_LINKS["ici"]
        fa = (shm.alpha_us / sa) if shm else 1.0
        fb = (shm.beta_us_per_byte / sb) if shm else 1.0
        model.links["ici"] = cost.LinkCoeffs(ia * fa, ib * fb)
        report["cost_model"] += "+derived-ici"
    link_of = cost.link_of_device()
    shortlists: Dict[Tuple[str, int], List[Candidate]] = {}
    space_cands: List[Candidate] = []
    for cname in colls:
        ct = COLLS[cname]
        space = propose(ct, n, quant_mode=quant_mode, target="device")
        report.setdefault("space", {})[cname] = len(space)
        for size in sizes:
            sl = shortlist(list(space), model, size, budget, link_of)
            shortlists[(cname, size)] = sl
            space_cands.extend(sl)
    spec = _device_family_spec(space_cands, n)
    report["device_families"] = spec
    if not spec:
        report["error"] = "no device-lowerable candidate survived"
        return report

    from .lower_device import dev_alg_name
    overrides = {"TUNER": "off", "GEN_DEVICE": "y",
                 "GEN_DEVICE_FAMILIES": spec}
    if quant_mode:
        overrides["QUANT"] = quant_mode
    results: List[dict] = []
    tuner_entries: List[dict] = []
    job = _Job(n, overrides)
    try:
        sig = topo_signature(job.teams[0])
        for (cname, size), sl in sorted(shortlists.items()):
            ct = COLLS[cname]
            count = max(4, size // 4)
            argses = [_make_args(ct, r, n, count, MemoryType.CUDA)
                      for r in range(n)]
            msgsize = coll_args_msgsize(argses[0], n, 0)
            cands = sweep_candidates(job.teams[0], ct, MemoryType.CUDA,
                                     msgsize)
            by_name: Dict[str, int] = {}
            for i, c in enumerate(cands):
                if c.alg_name and c.alg_name not in by_name:
                    by_name[c.alg_name] = i
            want = {dev_alg_name(c.prog) for c in sl}
            # the library candidates are the floor the winner must beat
            for i, c in enumerate(cands):
                if c.origin != "generated-device":
                    want.add(c.alg_name)
            idxs = [by_name[nm] for nm in sorted(want) if nm in by_name]
            meds, order = successive_halving(
                job.teams, job.contexts, argses, ct, MemoryType.CUDA,
                msgsize, idxs, iters0=iters)
            sl_by_name = {dev_alg_name(c.prog): c for c in sl}
            finalists = [{
                "alg": cands[i].alg_name, "origin": cands[i].origin,
                "gen": cands[i].gen, "measured_us": round(meds[i], 2),
                "predicted_us": round(
                    sl_by_name[cands[i].alg_name].predicted_us, 2)
                if cands[i].alg_name in sl_by_name and
                sl_by_name[cands[i].alg_name].predicted_us is not None
                else None,
            } for i in sorted(meds, key=lambda i: meds[i])]
            res = {"coll": cname, "size_bytes": size,
                   "finalists": finalists}
            if order:
                win = cands[order[0]]
                res["winner"] = win.alg_name
                res["winner_origin"] = win.origin
                res["winner_gen"] = win.gen
                res["winner_measured_us"] = round(meds[order[0]], 2)
                if win.origin == "generated-device":
                    start, end = bucket_range(size_bucket(msgsize))
                    tuner_entries.append(
                        {"coll": cname, "mem": "cuda", "start": start,
                         "end": end, "alg": win.alg_name,
                         "comp": comp_name(win), "origin": "searched",
                         "gen": win.gen,
                         "measured_us": res["winner_measured_us"]})
            results.append(res)
            if verbose:
                print(f"# device search {cname} {size}B: winner "
                      f"{res.get('winner')} "
                      f"({res.get('winner_measured_us')}us, "
                      f"{len(finalists)} finalists)", flush=True)
    finally:
        job.destroy()
    if tuner_entries and tuner_cache:
        store_entries(tuner_cache, sig, tuner_entries, source="searched")
        report["tuner_entries"] = len(tuner_entries)
    report["results"] = results
    report["winners"] = [e["alg"] for e in tuner_entries]
    report["signature"] = sig
    return report


# ---------------------------------------------------------------------------
# the bench (python -m ucc_tpu_torch.dsl.search --bench): searched vs
# EVERY fixed grid point on a simulated mesh, interleaved medians,
# predicted-vs-measured for every finalist
# ---------------------------------------------------------------------------

def synthetic_paths(n: int) -> Optional[List[tuple]]:
    """Per-rank topology paths the UCC_TOPO_FAKE_* env would give a
    live n-rank team (the fake-topology hashes), so the bench
    can propose hierarchical candidates and classify links BEFORE
    paying a 128-rank context create."""
    import zlib

    from ..topo.proc_info import fake_topology
    raw = []
    pods = set()
    for r in range(n):
        node, pod = fake_topology(r)
        if node is None:
            return None
        raw.append((node, pod))
        if pod is not None:
            pods.add(pod)
    with_pods = len(pods) > 1
    out = []
    for node, pod in raw:
        hh = zlib.crc32(f"fake-node-{node}".encode())
        if with_pods:
            out.append((zlib.crc32(f"fake-pod-{pod}".encode()), hh))
        else:
            out.append((hh,))
    return out


def run_search_bench(n: int, sizes: Sequence[int],
                     colls: Sequence[str] = ("allreduce",),
                     iters: int = 5, budget: int = 12,
                     quant_mode: str = "", fit_n: int = 8,
                     verbose: bool = True) -> dict:
    """Measure searched vs every fixed-grid candidate on an n-rank
    simulated mesh with interleaved medians. One n-rank job total:
    proposal/pruning run against synthetic topology paths, the cost
    model fits on a small side mesh, and only the measurement pays the
    big context create."""
    from ..api.types import coll_args_msgsize
    from ..constants import MemoryType
    from ..score import cost
    from ..score.tuner import (resolve_cache_path, store_entries,
                               sweep_candidates, topo_signature)
    from ..tools.perftest import COLLS
    from ..tools.tune import _Job, run_sweep

    rec: dict = {"bench": "search", "metric": "search_bench",
                 "ranks": n, "sizes": list(sizes), "iters": iters,
                 "budget": budget,
                 "topo_fake_ppn": os.environ.get("UCC_TOPO_FAKE_PPN"),
                 "topo_fake_npp": os.environ.get(
                     "UCC_TOPO_FAKE_NODES_PER_POD"),
                 "methodology": "interleaved per-iteration rotation "
                                "across all candidates, per-candidate "
                                "medians"}
    overrides = {"GEN": "y", "TUNER": "off"}
    if quant_mode:
        overrides["QUANT"] = quant_mode
    paths = synthetic_paths(n)
    link_of = cost.link_of_paths(paths)
    digest = paths_digest(paths)

    model = cost.load_model()
    if model is None:
        job = _Job(fit_n, dict(overrides))
        try:
            # multi-size probe: a single size cannot condition the
            # (alpha, beta) separation; three decades can
            recs = run_sweep(job, ["allreduce"], [4096, 65536, 524288],
                             max(4, iters), 2, verbose=False)
        finally:
            job.destroy()
        # uniform: simulated meshes have one physical link class; only
        # the shm TL's rows calibrate it (the loopback-socket instances
        # of the same programs measure a different transport)
        model = cost.fit_records(
            [r for r in recs
             if r.get("gen") and r.get("comp") in (None, "shm")],
            uniform=True)
        if model is not None:
            cost.save_model(model)
    if model is None:
        model = cost.CostModel()
    rec["cost_model"] = model.source

    # propose + prune without a live team, persist the shortlist so the
    # measurement job registers every searched candidate
    search_cache = resolve_search_cache_path()
    scopes = set()
    cand_entries: List[dict] = []
    shortlists: Dict[Tuple[str, int], List[Candidate]] = {}
    for cname in colls:
        ct = COLLS[cname]
        grid = grid_program_names(ct, n, paths, quant_mode)
        space = propose(ct, n, paths, quant_mode, grid_names=grid)
        rec.setdefault("space", {})[cname] = len(space)
        rec.setdefault("grid", {})[cname] = sorted(grid)
        scopes.add((cname, n, ""))
        scopes.add((cname, n, digest))
        for size in sizes:
            sl = shortlist(list(space), model, size, budget, link_of)
            shortlists[(cname, size)] = sl
            for c in sl:
                cand_entries.append(c.entry(ct, n,
                                            digest if c.hier else ""))
    prev_winners = _previous_winners(search_cache, scopes)
    store_search_entries(search_cache, cand_entries,
                         replace_scopes=sorted(scopes))

    t0 = time.time()
    # a 128+-rank in-process context create is GIL-bound (minutes):
    # give it a budget that scales with n
    job = _Job(n, dict(overrides, GEN_SEARCH="y"),
               create_timeout=max(600.0, n * 5.0))
    rec["team_create_s"] = round(time.time() - t0, 1)
    cells: List[dict] = []
    winners: List[dict] = []
    tuner_entries: List[dict] = []
    measured_any = False
    try:
        sig = topo_signature(job.teams[0])
        rec["signature"] = sig
        for (cname, size), sl in sorted(shortlists.items()):
            ct = COLLS[cname]
            count = _coll_count(ct, size, n)
            argses = [_make_args(ct, r, n, count, MemoryType.HOST)
                      for r in range(n)]
            msgsize = coll_args_msgsize(argses[0], n, 0)
            cands = sweep_candidates(job.teams[0], ct,
                                     MemoryType.HOST, msgsize)
            by_name = _shm_index_by_name(cands)
            grid_names = set(rec["grid"][cname])
            want = {c.name for c in sl} | grid_names
            for i, c in enumerate(cands):   # static default as floor
                if c.origin not in ("generated", "searched"):
                    want.add(c.alg_name)
                    break
            idxs = [by_name[nm] for nm in sorted(want)
                    if nm in by_name]
            meds = interleaved_measure(job.teams, job.contexts, argses,
                                       ct, MemoryType.HOST, msgsize,
                                       idxs, iters, warmup=1,
                                       timeout=180.0)
            if any(m is not None for m in meds.values()):
                measured_any = True
            sl_by_name = {c.name: c for c in sl}
            rows = []
            for i in sorted((i for i in meds if meds[i] is not None),
                            key=lambda i: meds[i]):
                c = cands[i]
                sc = sl_by_name.get(c.alg_name)
                predicted = sc.predicted_us if sc is not None else \
                    cost.predict_for_record(model, c.gen, n, size,
                                            paths=paths)
                rows.append({
                    "alg": c.alg_name, "origin": c.origin,
                    "gen": c.gen,
                    "measured_us": round(meds[i], 1),
                    "predicted_us": round(predicted, 1)
                    if predicted is not None else None,
                    "grid": c.alg_name in grid_names or
                    not c.gen})
            cell = {"coll": cname, "size_bytes": size,
                    "finalists": rows}
            if rows:
                win = rows[0]
                cell["winner"] = win["alg"]
                grid_best = next((r for r in rows if r["grid"]), None)
                cell["grid_best"] = grid_best["alg"] if grid_best \
                    else None
                cell["search_only_win"] = not win["grid"]
                if cell["search_only_win"] and grid_best:
                    cell["win_vs_grid_best"] = round(
                        grid_best["measured_us"] / win["measured_us"],
                        3)
                win_c = sl_by_name.get(win["alg"])
                if win_c is None and win["gen"]:
                    e = _winner_entry_from_gen(cname, n, win["alg"],
                                               win["gen"], digest)
                    if e is not None:
                        e["measured_us"] = win["measured_us"]
                        winners.append(e)
                        from ..score.tuner import (bucket_range,
                                                   size_bucket)
                        start, end = bucket_range(size_bucket(msgsize))
                        tuner_entries.append(
                            {"coll": cname, "mem": "host",
                             "start": start, "end": end,
                             "alg": win["alg"], "comp": "shm",
                             "origin": "searched", "gen": win["gen"],
                             "predicted_us": win["predicted_us"],
                             "measured_us": win["measured_us"]})
                if win_c is not None:
                    win_c.measured_us = win["measured_us"]
                    winners.append(win_c.entry(
                        _COLL_BY_NAME[cname], n,
                        digest if win_c.hier else ""))
                    from ..score.tuner import bucket_range, size_bucket
                    start, end = bucket_range(size_bucket(msgsize))
                    tuner_entries.append(
                        {"coll": cname, "mem": "host", "start": start,
                         "end": end, "alg": win["alg"], "comp": "shm",
                         "origin": "searched", "gen": win["gen"],
                         "predicted_us": win["predicted_us"],
                         "measured_us": win["measured_us"]})
            cells.append(cell)
            if verbose:
                print(f"# cell {cname} {size}B: winner "
                      f"{cell.get('winner')} "
                      f"(search_only={cell.get('search_only_win')}, "
                      f"vs grid best {cell.get('grid_best')} "
                      f"x{cell.get('win_vs_grid_best', 1.0)}) — "
                      f"{len(rows)} candidates measured", flush=True)
    finally:
        # same crash-cleanup contract as run_search: winners-so-far
        # replace the throwaway shortlist scopes even on failure, and a
        # run that never measured restores the previous winners
        try:
            store_search_entries(search_cache,
                                 winners if measured_any
                                 else prev_winners,
                                 replace_scopes=sorted(scopes))
            if tuner_entries:
                store_entries(
                    resolve_cache_path(
                        os.environ.get("UCC_TUNER_CACHE", "")),
                    sig, tuner_entries, source="searched")
                rec["tuner_entries"] = len(tuner_entries)
        except Exception:  # noqa: BLE001 - cache cleanup best-effort
            logger.exception("search: winner persistence failed")
        job.destroy()
    rec["cells"] = cells
    rec["search_only_wins"] = sum(
        1 for c in cells if c.get("search_only_win"))
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="python -m ucc_tpu_torch.dsl.search",
        description="cost-model-guided program search — the bench")
    p.add_argument("--bench", action="store_true",
                   help="searched-vs-grid bench on a simulated mesh "
                        "(interleaved medians)")
    p.add_argument("-n", "--nprocs", type=int, default=128)
    p.add_argument("--sizes", default="16K,256K,2M")
    p.add_argument("-i", "--iters", type=int, default=5)
    p.add_argument("--budget", type=int, default=12)
    p.add_argument("--colls", default="allreduce")
    p.add_argument("--ppn", default="",
                   help="UCC_TOPO_FAKE_PPN for the simulated mesh")
    p.add_argument("--npp", default="",
                   help="UCC_TOPO_FAKE_NODES_PER_POD")
    p.add_argument("--quant", default="")
    p.add_argument("-o", "--output", default="")
    args = p.parse_args(argv)
    if args.ppn:
        os.environ["UCC_TOPO_FAKE_PPN"] = args.ppn
    if args.npp:
        os.environ["UCC_TOPO_FAKE_NODES_PER_POD"] = args.npp
    from ..utils.config import parse_memunits
    sizes = [parse_memunits(t) for t in args.sizes.split(",")
             if t.strip()]
    colls = [c.strip() for c in args.colls.split(",") if c.strip()]
    rec = run_search_bench(args.nprocs, sizes, colls, iters=args.iters,
                           budget=args.budget, quant_mode=args.quant)
    out = json.dumps(rec, indent=1)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(out + "\n")
        print(f"# -> {args.output}")
    else:
        print(out)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
