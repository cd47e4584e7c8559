"""Program registry — build, verify and cache the DSL's built-in programs
(the part of ``ucc_tpu/dsl/registry.py`` that the device path needs).

Every program is built once per (family, parameters, team size, wire) in
this process and passes the static verifier first: a program the verifier
rejects is logged and never returned, so it can never register. The JAX
package also keeps verified programs on disk, searches program space and
registers generated HOST candidates; none of that is ported yet.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

from ..utils.log import get_logger
from . import families as fam
from .ir import Program
from .verify import VerifyError, verify

logger = get_logger("dsl")

#: process-wide verified-program cache: (family, params, n, wire) ->
#: Program, or None for an inapplicable or rejected pair, so that failures
#: are also computed once
_CACHE: Dict[Tuple, Optional[Program]] = {}


def _lib_config(team):
    try:
        return team.core_team.context.lib.config
    except AttributeError:
        return None


def _cfg_str(team, field: str, env: str, default: str = "") -> str:
    """A lib config field of *team*'s lib, lowercased; the environment
    variable *env* (or *default*) for a team without a lib."""
    cfg = _lib_config(team)
    if cfg is not None:
        try:
            return str(cfg.get(field) or "").strip().lower()
        except KeyError:
            pass
    return os.environ.get(env, default).strip().lower()


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


def _construct(family: str, params: Dict[str, Any], n: int,
               wire: str) -> Program:
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
        return fam.gen_hier([], top=int(params.get("top", 2)), wire=wire,
                            chunks=int(params.get("chunks", 1)))
    raise ValueError(f"unknown family '{family}'")


def build_named(family: str, params: Dict[str, Any], n: int,
                wire: str = "") -> Optional[Program]:
    """Build and verify one program from a full parameter dict, cached in
    this process. None when the (family, params) pair is inapplicable at
    this size or the program failed verification (logged: a rejected
    program never ships)."""
    pkey = tuple(sorted((str(k), str(v)) for k, v in (params or {}).items()))
    key = (family, pkey, int(n), wire)
    if key in _CACHE:
        return _CACHE[key]
    prog: Optional[Program] = None
    try:
        prog = _construct(family, params or {}, n, wire)
        verify(prog)
    except fam.Inapplicable as e:
        logger.debug("dsl: %s(%s) inapplicable at n=%d: %s", family,
                     params, n, e)
        prog = None
    except VerifyError as e:
        logger.error("dsl: generated program %s(%s) n=%d REJECTED by "
                     "the verifier: %s", family, params, n, e)
        prog = None
    _CACHE[key] = prog
    return prog


#: grid-int -> parameter-dict key per family (the UCC_GEN_FAMILIES
#: grids stay flat ints)
_GRID_PARAM_KEY = {
    "ring": "chunks", "rhd": "radix", "sra": "radix",
    "sra_pipe": "depth", "ag_ring": "chunks", "ag_rd": "radix",
    "rs_ring": "chunks", "bc_kn": "radix", "bc_chain": "chunks",
    "hier": "top", "pooled": "chunks",
}


def build_program(family: str, param: int, n: int,
                  wire: str = "") -> Optional[Program]:
    """Grid-entry form of :func:`build_named` (one int parameter per
    family, the UCC_GEN_FAMILIES contract)."""
    pk = _GRID_PARAM_KEY.get(family)
    return build_named(family, {pk: int(param)} if pk else {}, n,
                       wire=wire)
