"""Registration gate — generated programs as score-map candidates (the
port of ``ucc_tpu/dsl/registry.py``).

Behind ``UCC_GEN`` (default off: the candidate lists, dispatch path and
tuner rotation stay byte-identical to a build without this package,
the same zero-cost contract as ``UCC_QUANT``). When on, the host TL's
algorithm table gains one :class:`~..tl.base.AlgSpec` per applicable
(family, parameter) pair:

- every program is built once per (family, param, team size, wire)
  process-wide (cached — in-process multi-rank jobs verify each program
  once, not once per rank) and passes the static verifier; a program
  that fails verification is logged and SKIPPED, never registered;
- candidates register at a LOW default score (tuner-explorable,
  TUNE-addressable by name, never the static default) with provenance
  ``origin="generated"`` and the family/parameter string shown in the
  score dump (``ScoreMap.print_info``) and carried into tuner cache
  entries;
- the fused quantized program registers only when ``UCC_QUANT`` selects
  a precision (and carries that precision tag like the hand-written
  quantized variants).

``UCC_GEN_FAMILIES`` restricts/parameterizes the families, e.g.
``ring(1,2,4),rhd(2,8),sra_pipe(2)``; empty = every family at its
default grid (families.DEFAULT_GRIDS).
"""
from __future__ import annotations

import hashlib
import io
import os
import pickle
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..constants import CollType
from ..status import Status, UccError
from ..utils.log import get_logger
from . import families as fam
from .ir import DSL_VERSION, Program
from .verify import VerifyError, verify

logger = get_logger("dsl")

#: AlgSpec id base for generated candidates (hand-written tables use
#: single digits; @100+ keeps numeric TUNE addressing unambiguous)
GEN_ALG_ID_BASE = 100

#: program generation is O(n^2) ops (every rank's stream is built and
#: verified); beyond this team size generated candidates are skipped
#: with a log line (pod-scale teams are served by CL/HIER composition,
#: not per-rank flat programs)
MAX_GEN_RANKS = 128

#: process-wide verified-program cache: (family, params, n, wire,
#: paths digest) -> Program (or None for inapplicable/rejected, so
#: failures are also computed once)
_CACHE: Dict[Tuple, Optional[Program]] = {}

DEFAULT_PROG_CACHE = "~/.cache/ucc_tpu_torch/programs.pkl"

# ---------------------------------------------------------------------------
# verified-program cache on disk: verified-program construction is O(n^2)
# and re-runs per process at every team size, so verified IR is persisted
# next to the tuner cache, keyed by (family, params, n, wire, topology
# digest) AND the DSL version — a semantics bump invalidates every stored
# program, so a cached program can never run under rules it was not
# proven against. Writes take an exclusive flock around the
# read-modify-write; a load hit skips verification.
#
# The JAX package reads the same UCC_GEN_PROG_CACHE variable and pickles
# its own Program class. The port's file carries the package name in its
# version tag (so the JAX package reads it as a version mismatch and
# starts fresh), and the port unpickles through _ProgramUnpickler, which
# resolves only the port's own IR classes: a file the JAX package wrote
# is refused without importing anything, and the port starts fresh.
# ---------------------------------------------------------------------------

#: the version tag of the port's program-cache file
CACHE_TAG = f"ucc_tpu_torch/{DSL_VERSION}"

#: the only globals a program-cache pickle may name
_PICKLE_ALLOWED = frozenset((
    ("ucc_tpu_torch.dsl.ir", "Program"),
    ("ucc_tpu_torch.dsl.ir", "RankProgram"),
    ("ucc_tpu_torch.dsl.ir", "Op"),
    ("ucc_tpu_torch.dsl.ir", "OpKind"),
    ("ucc_tpu_torch.constants", "CollType"),
))


class _ProgramUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) not in _PICKLE_ALLOWED:
            raise pickle.UnpicklingError(
                f"program cache names {module}.{name}, which is not one "
                f"of the port's IR classes")
        return super().find_class(module, name)


def _load_cache_file(path: str):
    """The programs of the port's cache file at *path* ({} when the file
    is another package's, another DSL version's, or unreadable: the
    caller starts fresh). FileNotFoundError propagates."""
    with open(path, "rb") as fh:
        data = _ProgramUnpickler(io.BytesIO(fh.read())).load()
    if isinstance(data, dict) and data.get("version") == CACHE_TAG:
        return dict(data.get("programs") or {})
    logger.info("dsl: program cache %s has version %r (want %r); "
                "starting fresh", path,
                data.get("version") if isinstance(data, dict) else None,
                CACHE_TAG)
    return {}


_DISK_LOCK = threading.Lock()
_DISK: Dict[str, Any] = {"path": False, "programs": None}
_PENDING: Dict[Tuple, Program] = {}
_FLUSH_EVERY = 8

#: programs above this TOTAL op count are kept in the in-memory cache
#: only: a 128-rank ring(chunks=8) pickles to ~50MB, and a cache full
#: of those costs more to read+rewrite than regeneration costs
MAX_CACHE_OPS = 150_000


def _prog_cache_path() -> Optional[str]:
    raw = os.environ.get("UCC_GEN_PROG_CACHE", "").strip()
    if raw.lower() in ("0", "n", "no", "off", "false", "f"):
        return None
    return os.path.expanduser(raw or DEFAULT_PROG_CACHE)


def _prog_ops(prog: Program) -> int:
    return sum(len(ops) for rp in prog.ranks for ops in rp.rounds)


def _disk_load() -> Optional[Dict[Tuple, Program]]:
    """Lazy-load the on-disk program cache once per process (returns
    None when disabled)."""
    with _DISK_LOCK:
        if _DISK["path"] is not False:
            return _DISK["programs"]
        path = _prog_cache_path()
        _DISK["path"] = path
        progs: Optional[Dict[Tuple, Program]] = None
        if path is not None:
            progs = {}
            try:
                progs = _load_cache_file(path)
            except FileNotFoundError:
                pass
            except Exception as e:  # noqa: BLE001 - a corrupt or foreign
                # cache must never break program generation; rebuild it
                logger.warning("dsl: unreadable program cache %s (%s); "
                               "starting fresh", path, e)
        _DISK["programs"] = progs
        return progs


def _disk_store(key: Tuple, prog: Program) -> None:
    """Queue one verified program for the next batched flush. A write
    per program would read+rewrite the whole (growing) cache file once
    per build — O(k^2) I/O over a search's proposal burst — so writes
    batch up and flush every ``_FLUSH_EVERY`` programs plus once at
    process exit. Programs above MAX_CACHE_OPS stay memory-only (their
    pickles outweigh their regeneration cost)."""
    if _prog_ops(prog) > MAX_CACHE_OPS:
        return
    with _DISK_LOCK:
        _PENDING[key] = prog
        pending = len(_PENDING)
        if pending == 1 and not _DISK.get("atexit"):
            import atexit
            atexit.register(flush_program_cache)
            _DISK["atexit"] = True
    if pending >= _FLUSH_EVERY:
        flush_program_cache()


def flush_program_cache() -> None:
    """flock'd read-modify-write of every pending verified program."""
    with _DISK_LOCK:
        path = _DISK.get("path")
        if not path or not _PENDING:
            _PENDING.clear()
            return
        batch = dict(_PENDING)
        _PENDING.clear()
    d = os.path.dirname(path)
    try:
        if d:
            os.makedirs(d, exist_ok=True)
        with open(f"{path}.lock", "w") as lk:
            try:
                import fcntl
                fcntl.flock(lk, fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass                # no flock: best-effort (non-POSIX)
            cur: Dict[Tuple, Program] = {}
            try:
                cur = _load_cache_file(path)
            except Exception:  # noqa: BLE001 - stale/corrupt: rewrite
                pass
            cur.update(batch)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as fh:
                pickle.dump({"version": CACHE_TAG, "programs": cur}, fh)
            os.replace(tmp, path)
    except OSError as e:
        logger.debug("dsl: program-cache write to %s failed: %s", path, e)


def paths_digest(paths) -> str:
    """Stable digest of a topology path list (the hier program cache /
    search-cache key component; '' for flat programs)."""
    if not paths:
        return ""
    h = hashlib.sha1()
    for p in paths:
        h.update(repr(tuple(p)).encode())
    return h.hexdigest()[:16]


def _lib_config(team):
    try:
        return team.core_team.context.lib.config
    except AttributeError:
        return None


def _cfg_str(team, field: str, env: str, default: str = "") -> str:
    cfg = _lib_config(team)
    if cfg is not None:
        try:
            return str(cfg.get(field) or "").strip().lower()
        except KeyError:
            pass
    return os.environ.get(env, default).strip().lower()


def gen_enabled(team) -> bool:
    """One config read per team create (alg-table construction) — never
    on the dispatch path."""
    return _cfg_str(team, "gen", "UCC_GEN") in ("y", "yes", "on", "1",
                                                "true", "t")


def _apply_pool_knobs(team, fams: Dict[str, List[int]]) \
        -> Dict[str, List[int]]:
    """UCC_POOL_ENABLE / UCC_POOL_CHUNKS: the pooled (one-sided window)
    variants get their own gates so an operator can drop or re-grid
    them without rewriting the whole UCC_GEN_FAMILIES spec — the
    windows pin arena heap for the life of the team, which a
    memory-tight deployment may want off even with generation on.

    ENABLE: auto (default) keeps whatever the family spec produced;
    ``n`` drops the pooled family even if the spec named it; ``y``
    forces it in at its grid when the spec left it out. CHUNKS is a
    comma-separated chunk-count list replacing the pooled grid."""
    en = _cfg_str(team, "pool_enable", "UCC_POOL_ENABLE") or "auto"
    if en in ("n", "no", "off", "0", "false", "f"):
        fams.pop("pooled", None)
        return fams
    if en in ("y", "yes", "on", "1", "true", "t") and "pooled" not in fams:
        fams["pooled"] = list(fam.DEFAULT_GRIDS["pooled"])
    chunks = _cfg_str(team, "pool_chunks", "UCC_POOL_CHUNKS")
    if chunks and "pooled" in fams:
        try:
            grid = sorted({int(c) for c in chunks.split(",")
                           if c.strip()})
        except ValueError:
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"bad UCC_POOL_CHUNKS: '{chunks}'")
        if not grid or any(g < 1 for g in grid):
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"bad UCC_POOL_CHUNKS: '{chunks}' (need "
                           f"positive chunk counts)")
        fams["pooled"] = grid
    return fams


def parse_families(spec: str) -> Dict[str, List[int]]:
    """``ring(1,2,4),rhd(2,8),qdirect`` -> {family: params}. Empty spec
    = every family at its default grid. Unknown families or malformed
    params raise ValueError (a typo'd knob must not silently register
    nothing)."""
    spec = (spec or "").strip().lower()
    if not spec:
        return {k: list(v) for k, v in fam.DEFAULT_GRIDS.items()}
    out: Dict[str, List[int]] = {}
    # split on commas at paren depth 0 (params use commas too)
    toks, depth, cur = [], 0, ""
    for ch in spec:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                raise ValueError(f"unbalanced ')' in '{spec}'")
        if ch == "," and depth == 0:
            toks.append(cur)
            cur = ""
        else:
            cur += ch
    if depth != 0:
        raise ValueError(f"unbalanced '(' in '{spec}'")
    toks.append(cur)
    for tok in toks:
        tok = tok.strip()
        if not tok:
            continue
        name, _, rest = tok.partition("(")
        name = name.strip()
        if name not in fam.DEFAULT_GRIDS:
            raise ValueError(f"unknown generated family '{name}' "
                             f"(known: {', '.join(fam.FAMILY_NAMES)})")
        if rest:
            if not rest.endswith(")"):
                raise ValueError(f"malformed family token '{tok}'")
            params = [int(p) for p in rest[:-1].split(",") if p.strip()]
            if not params:
                # 'ring()' registering nothing would be exactly the
                # silent-typo failure this parser exists to reject
                raise ValueError(f"empty parameter list in '{tok}'")
        else:
            params = list(fam.DEFAULT_GRIDS[name])
        lst = out.setdefault(name, [])
        for p in params:
            if p not in lst:
                lst.append(p)
    return out


def _construct(family: str, params: Dict[str, Any], n: int, wire: str,
               paths) -> Program:
    """Dispatch one family generator (raises Inapplicable/VerifyError
    upward)."""
    if family == "ring":
        return fam.gen_ring(n, chunks=int(params.get("chunks", 1)))
    if family == "rhd":
        return fam.gen_rhd(n, radix=(int(params.get("radix", 0)) or n))
    if family == "sra":
        return fam.gen_sra(n, radix=int(params.get("radix", 2)))
    if family == "sra_pipe":
        return fam.sra_pipe_fragment(
            n, depth=int(params.get("depth", 2)),
            radix=int(params.get("radix", 0)) or None)
    if family == "qdirect":
        if wire not in ("int8", "fp8"):
            raise fam.Inapplicable(f"unknown wire precision '{wire}'")
        # the search proposes quantized rhd at every applicable radix
        # (the grid's qdirect is the radix-n direct exchange)
        return fam.gen_rhd(n, radix=(int(params.get("radix", 0)) or n),
                           wire=wire)
    if family == "ag_ring":
        return fam.gen_ag_ring(n, chunks=int(params.get("chunks", 1)))
    if family == "ag_rd":
        return fam.gen_ag_rd(n, radix=(int(params.get("radix", 0)) or n))
    if family == "rs_ring":
        return fam.gen_rs_ring(n, chunks=int(params.get("chunks", 1)))
    if family == "rs_direct":
        return fam.gen_rs_direct(n)
    if family == "bc_kn":
        return fam.gen_bc_kn(n, radix=(int(params.get("radix", 0)) or n))
    if family == "bc_chain":
        return fam.gen_bc_chain(n, chunks=int(params.get("chunks", 2)))
    if family == "pooled":
        return fam.gen_pooled(n, chunks=int(params.get("chunks", 1)))
    if family == "hier":
        if not paths:
            raise fam.Inapplicable(
                "hier programs need the team's topology paths")
        return fam.gen_hier(paths, top=int(params.get("top", 2)),
                            wire=wire,
                            chunks=int(params.get("chunks", 1)))
    raise ValueError(f"unknown family '{family}'")


def build_named(family: str, params: Dict[str, Any], n: int,
                wire: str = "", paths=None) -> Optional[Program]:
    """Build + verify one program from a full parameter dict; cached
    process-wide AND (for verified programs) on disk keyed by
    DSL_VERSION. Returns None when the (family, params) pair is
    inapplicable at this size or the program failed verification
    (logged — rejected programs never ship)."""
    pkey = tuple(sorted((str(k), str(v)) for k, v in (params or {}).items()))
    # only hier programs depend on the topology: keying flat families
    # by the paths digest would generate+verify (and disk-cache) the
    # identical program once per topology shape
    key = (family, pkey, int(n), wire,
           paths_digest(paths) if family == "hier" else "")
    if key in _CACHE:
        return _CACHE[key]
    disk = _disk_load()
    if disk is not None and key in disk:
        prog = disk[key]
        _CACHE[key] = prog
        from ..obs import metrics
        if metrics.ENABLED:
            metrics.inc("gen_prog_cache_hits", component="dsl")
        return prog
    prog: Optional[Program] = None
    try:
        prog = _construct(family, params or {}, n, wire, paths)
        verify(prog)
    except fam.Inapplicable as e:
        logger.debug("dsl: %s(%s) inapplicable at n=%d: %s", family,
                     params, n, e)
        prog = None
    except VerifyError as e:
        # a generator bug: reject loudly, never register
        logger.error("dsl: generated program %s(%s) n=%d REJECTED by "
                     "the verifier: %s", family, params, n, e)
        prog = None
    _CACHE[key] = prog
    if prog is not None and disk is not None:
        disk[key] = prog
        _disk_store(key, prog)
    return prog


#: grid-int -> parameter-dict key per family (the UCC_GEN_FAMILIES
#: grids stay flat ints; the search explores the full dicts)
_GRID_PARAM_KEY = {
    "ring": "chunks", "rhd": "radix", "sra": "radix",
    "sra_pipe": "depth", "ag_ring": "chunks", "ag_rd": "radix",
    "rs_ring": "chunks", "bc_kn": "radix", "bc_chain": "chunks",
    "hier": "top", "pooled": "chunks",
}


def build_program(family: str, param: int, n: int, wire: str = "",
                  paths=None) -> Optional[Program]:
    """Grid-entry form of :func:`build_named` (one int parameter per
    family, the UCC_GEN_FAMILIES contract)."""
    pk = _GRID_PARAM_KEY.get(family)
    return build_named(family, {pk: int(param)} if pk else {}, n,
                       wire=wire, paths=paths)


def built_in_programs(n: int,
                      quant_mode: str = "",
                      spec: str = "",
                      paths=None) -> List[Program]:
    """Every verified built-in program at team size *n* (the smoke
    probe's compile+verify sweep). ``quant_mode`` enables the fused
    quantized program (and the quantized-DCN hier variants when
    *paths* describe a multi-node topology)."""
    out: List[Program] = []
    names: set = set()

    def _add(p: Optional[Program]) -> None:
        if p is not None and p.name not in names:
            names.add(p.name)
            out.append(p)

    for family, params in parse_families(spec).items():
        if family == "qdirect":
            if quant_mode:
                _add(build_program(family, 0, n, wire=quant_mode))
            continue
        for param in params:
            _add(build_program(family, param, n, paths=paths))
            if family == "hier" and quant_mode:
                _add(build_program(family, param, n, wire=quant_mode,
                                   paths=paths))
    return out


def search_enabled(team) -> bool:
    """UCC_GEN_SEARCH (default y): register persisted searched winners
    from the search cache alongside the grid families. Zero cost when
    the cache has no entries for this topology. The field is
    parse_bool, so the config table hands back a real bool (env > file
    > default already resolved) — _cfg_str would stringify False to
    ''."""
    cfg = _lib_config(team)
    if cfg is not None:
        try:
            return bool(cfg.get("gen_search"))
        except KeyError:
            pass
    return os.environ.get("UCC_GEN_SEARCH", "y").strip().lower() \
        not in ("n", "no", "off", "0", "false", "f")


def team_paths(team) -> Optional[List[tuple]]:
    """Per-rank topology attribute paths of *team* for hierarchical
    program generation; None when no multi-node topology is known.
    Thin wrapper over the CL/HIER tree export (cl/hier exports the
    same tree it composes its own units from, so DSL hier programs and
    CL/HIER units agree on the layout)."""
    try:
        from ..cl.hier import tree_paths_for_search
        return tree_paths_for_search(team)
    except Exception:  # noqa: BLE001 - topology is an optimization input
        return None


def generated_alg_specs(team) -> Dict[CollType, List]:
    """The generated AlgSpec rows for *team*'s algorithm table; {} when
    UCC_GEN is off, the team is a stub/singleton, or too large (logged).
    Called once per team create from HostTlTeam.alg_table. Covers the
    grid families of every supported collective (allreduce, allgather,
    reduce_scatter, bcast), the hierarchical compositions when the
    team spans multiple nodes, and — behind UCC_GEN_SEARCH — the
    persisted winners of earlier cost-model-guided searches
    (origin "searched")."""
    from ..tl.base import AlgSpec

    if not gen_enabled(team):
        return {}
    n = int(getattr(team, "size", 0) or 0)
    if n < 2:
        return {}
    if n > MAX_GEN_RANKS:
        logger.warning("dsl: UCC_GEN skipped: team size %d above the "
                       "%d-rank program-generation cap", n, MAX_GEN_RANKS)
        return {}
    spec = _cfg_str(team, "gen_families", "UCC_GEN_FAMILIES")
    try:
        fams = parse_families(spec)
    except ValueError as e:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"bad UCC_GEN_FAMILIES: {e}")
    fams = _apply_pool_knobs(team, fams)
    from .. import quant
    from .compile import generated_init, generated_pipelined_init

    from .plan import native_mode, team_plan_capable
    plan_cap = team_plan_capable(team)
    gn_mode = native_mode(team)
    paths = team_paths(team)
    by_coll: Dict[CollType, List[AlgSpec]] = {}
    seen: set = set()

    def add(prog: Program, origin: str = "generated") -> None:
        if prog.name in seen:
            # e.g. rhd radix 4 and radix 0 (= n) coincide on a 4-rank
            # team — one candidate, not two rotation slots
            return
        seen.add(prog.name)
        init_fn = generated_pipelined_init if prog.family == "sra_pipe" \
            else generated_init

        def init(ia, _team, _p=prog, _fn=init_fn):
            return _fn(ia, team, _p)
        lst = by_coll.setdefault(prog.coll, [])
        lst.append(AlgSpec(
            GEN_ALG_ID_BASE + len(lst), prog.name, init,
            # low default score: never the static default, explorable by
            # the tuner and TUNE-addressable by name exactly like the
            # hand-written candidates
            default_select="0-inf:2",
            precision=prog.wire or prog.edge_wire_mode,
            origin=origin,
            gen=prog.param_str,
            # wire (quantized) programs only run as plans under an
            # explicit UCC_GEN_NATIVE=y (auto always interprets them);
            # non-allreduce/per-edge-wire programs never do; window (pooled) programs retire through the arena's
            # one-sided path, never through a mailbox plan
            plan=plan_cap and prog.coll == CollType.ALLREDUCE
            and not prog.edge_wire_mode
            and not prog.uses_windows
            and (not prog.wire or gn_mode == "y")))

    # searched winners FIRST: a winner the grid can also reach (the
    # search validated a grid point) registers once, with the more
    # informative origin — "searched" (measured + predicted provenance
    # in the cache), not "generated"
    if search_enabled(team):
        try:
            from .search import searched_programs
            for prog in searched_programs(team, n, paths):
                add(prog, origin="searched")
        except Exception:  # noqa: BLE001 - a corrupt search cache must
            # never fail team creation; grid candidates still register
            logger.exception("dsl: search-cache registration failed")
    for family, params in fams.items():
        coll = fam.FAMILY_COLL.get(family, CollType.ALLREDUCE)
        qmode = quant.coll_mode(team, coll) or ""
        if family == "qdirect":
            if qmode:
                p = build_program(family, 0, n, wire=qmode)
                if p is not None:
                    add(p)
            continue
        for param in params:
            p = build_program(family, param, n, paths=paths)
            if p is not None:
                # pooled (one-sided window) variants carry their own
                # origin so provenance survives into tuner records
                add(p, origin="pooled" if family == "pooled"
                    else "generated")
            if family == "hier" and qmode:
                # the quantized-DCN-edge variant rides along whenever a
                # wire precision is enabled (its exact twin stays too)
                p = build_program(family, param, n, wire=qmode,
                                  paths=paths)
                if p is not None:
                    add(p)
    if not by_coll:
        return {}
    total = sum(len(v) for v in by_coll.values())
    logger.info("dsl: registered %d generated candidates for team size "
                "%d: %s", total, n,
                ", ".join(s.name for v in by_coll.values() for s in v))
    return by_coll
