"""Fused small-collective dispatch: the coalescer's DSL backend (the
port of the JAX package's ``dsl/fused.py``).

The multi-tenant coalescing layer (core/coalesce.py) packs N same-team
small allreduces with an identical (op, dtype) signature into one
contiguous vector and retires them as ONE generated collective: a
verified DSL program, interpreted or (when the native plan executor is
enabled) executed in a single ffi crossing over the packed buffer.
This module owns the program choice and the fused task construction;
the coalescer owns batching policy and member lifecycle.

Program choice (per team size *n*, packed element count *c*):

- ``rhd`` radix *n*: a single-level recursive-halving/doubling level,
  i.e. a direct pairwise exchange; ``nchunks == n`` so it needs
  ``c >= n``. Preferred: one round, the latency shape that wins for
  small-message storms.
- ``sra`` radix 2: scatter-reduce/allgather fallback for any *n*;
  ``nchunks`` is the largest power of two <= *n*.
- ``None`` when even the fallback needs more elements than the batch
  packs: the coalescer then posts the members individually; fusing
  must never turn an eligible post into a failure.

Programs come out of :func:`registry.build_named`, so each (family,
param, n) shape is generated + verified exactly once per process (and
disk-cached across processes); per-signature reuse above that is a
small local memo.

Fused tag space: fused batches carry an explicit integer tag offset by
``FUSED_TAG_BASE`` from a per-team fused sequence counter instead of
consuming ``next_coll_tag()``. Member requests never consumed wire
tags (they never reach a TL), so the organic per-team tag counter
advances identically on every rank regardless of WHERE each rank's
flush points fall: tag parity cannot be skewed by rank-local batching.
Plain ints (not the service/active-set tuple tags) because the native
plan executor packs the tag into a C-side word (dsl/plan.py post()).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..constants import CollType, MemoryType, ReductionOp, dt_size
from ..utils.log import get_logger
from .ir import Program

logger = get_logger("dsl")

#: fused-batch tags live at (1 << 30) + fused_seq: far above any
#: organic next_coll_tag() value a long-lived team can reach, and a
#: plain int for the native matcher
FUSED_TAG_BASE = 1 << 30

#: (team size) -> (rhd_direct program | None, sra program | None)
_PROGS: Dict[int, Tuple[Optional[Program], Optional[Program]]] = {}


def _programs_for(n: int) -> Tuple[Optional[Program], Optional[Program]]:
    got = _PROGS.get(n)
    if got is None:
        from . import registry
        # radix == n collapses rhd to one direct-exchange level; sra
        # radix 2 verifies at any n (extras fold into the power-of-two
        # core)
        got = (registry.build_named("rhd", {"radix": n}, n),
               registry.build_named("sra", {"radix": 2}, n))
        _PROGS[n] = got
    return got


def pick_program(n: int, count: int) -> Optional[Program]:
    """The fused program for a packed batch of *count* elements on a
    team of *n* ranks, or None when no verified program fits (batch too
    small for even the fallback's chunk count)."""
    if n < 2 or count < 2:
        return None
    direct, sra = _programs_for(n)
    if direct is not None and count >= direct.nchunks:
        return direct
    if sra is not None and count >= sra.nchunks:
        return sra
    return None


def fused_allreduce_task(core_team, tl_team, packed, count: int, dt,
                         op: ReductionOp, tag: int):
    """Build the GeneratedCollTask that retires one fused batch over
    *packed* (the concatenated member payloads, reduced in place), or
    None when no program fits this (n, count) shape. Raises nothing:
    any construction failure returns None and the coalescer falls back
    to individual posts."""
    program = pick_program(tl_team.size, count)
    if program is None:
        return None
    from ..api.types import BufferInfo, CollArgs
    from ..constants import CollArgsFlags
    from ..core.coll import InitArgs
    from .compile import GeneratedCollTask
    args = CollArgs(
        coll_type=CollType.ALLREDUCE,
        dst=BufferInfo(packed, count, dt, MemoryType.HOST),
        op=op,
        flags=CollArgsFlags.IN_PLACE)
    ia = InitArgs(args=args, team=core_team, mem_type=MemoryType.HOST,
                  msgsize=count * dt_size(dt))
    try:
        return GeneratedCollTask(ia, tl_team, program, tag=tag)
    except Exception:  # noqa: BLE001 - a fused-construction failure
        # must degrade to individual posts, never fail the members
        logger.exception("fused task construction failed (n=%d count=%d "
                         "dt=%s op=%s); posting members individually",
                         tl_team.size, count, dt, op)
        return None


def find_host_tl_team(core_team):
    """The full-membership host-transport TL team hanging off
    *core_team*, or None. Walks the CL structure duck-typed (cl/basic
    ``tl_teams``, cl/hier ``sbgps``/``_extra_units``) the way the
    epoch fence does, and accepts any HostTlTeam subclass (shm,
    sockets) whose subset covers the whole team."""
    from ..tl.host.team import HostTlTeam

    def visit(t):
        if t is None:
            return None
        if isinstance(t, HostTlTeam) and t.size == core_team.size:
            return t
        for sub in getattr(t, "tl_teams", ()) or ():
            found = visit(sub)
            if found is not None:
                return found
        sbgps = getattr(t, "sbgps", None)
        if sbgps:
            for sub in sbgps.values():
                found = visit(sub)
                if found is not None:
                    return found
        for sub in getattr(t, "_extra_units", ()) or ():
            found = visit(sub)
            if found is not None:
                return found
        return None

    for cl in getattr(core_team, "cl_teams", ()) or ():
        found = visit(cl)
        if found is not None:
            return found
    return None
