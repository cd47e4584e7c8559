"""TL shared infrastructure: buffer views, algorithm tables, score
building, team base.

The per-TL score construction pattern of UCC: defaults from the TL's
algorithm table and its coll plugins, then the user's
``UCC_TL_<NAME>_TUNE`` overlay.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..api.types import BufferInfoV
from ..constants import CollType, MemoryType, dt_size
from ..core.components import BaseTeam
from ..score.score import CollScore
from ..status import Status, UccError
from ..utils.config import SIZE_INF, parse_memunits


def binfo_u8(bi) -> torch.Tensor:
    """Flat uint8 view of a buffer's first ``count`` elements (of a
    BufferInfoV: ``sum(counts)``, from its start), as a tensor on the
    buffer's device: a torch tensor's own storage, a numpy array's or a
    writable bytes-like object's memory, or a copy of a read-only one."""
    counts = (bi.counts or []) if isinstance(bi, BufferInfoV) \
        else [bi.count]
    nbytes = sum(int(c) for c in counts) * dt_size(bi.datatype)
    buf = bi.buffer
    if isinstance(buf, torch.Tensor):
        if not buf.is_contiguous():
            raise UccError(Status.ERR_INVALID_PARAM,
                           "buffers must be contiguous tensors")
        flat = buf.reshape(-1).view(torch.uint8)
    else:
        if isinstance(buf, np.ndarray):
            if not buf.flags.c_contiguous:
                raise UccError(Status.ERR_INVALID_PARAM,
                               "buffers must be contiguous arrays")
            arr = buf.reshape(-1).view(np.uint8)
        else:
            arr = np.frombuffer(buf, dtype=np.uint8)
        flat = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return flat[:nbytes]


def _host_u8(buf) -> np.ndarray:
    """Flat uint8 numpy view of a host buffer (``mc/cpu._as_u8``) that a
    collective may write through: a contiguous CPU tensor or numpy array,
    or a bytes-like object."""
    from ..mc.cpu import _as_u8
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu":
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"host collectives need CPU tensors, got a "
                           f"tensor on {buf.device}")
        buf = buf.detach()
    contiguous = buf.is_contiguous() if isinstance(buf, torch.Tensor) \
        else not isinstance(buf, np.ndarray) or buf.flags.c_contiguous
    if not contiguous:
        raise UccError(Status.ERR_INVALID_PARAM,
                       "collective buffers must be contiguous")
    return _as_u8(buf)


def binfo_typed(bi, count: Optional[int] = None,
                elem_offset: int = 0) -> np.ndarray:
    """Typed 1-D numpy view (zero-copy) of `count` elements of a host
    buffer from `elem_offset` (default: all of ``count``, or
    ``sum(counts)`` of a BufferInfoV). bfloat16 is its uint16 bit
    pattern (``ec/cpu.storage_dtype``); a generic datatype is raw bytes
    of count * size."""
    from ..constants import GenericDataType
    from ..ec.cpu import storage_dtype
    if count is None:
        count = int(bi.count) if not isinstance(bi, BufferInfoV) else \
            sum(int(c) for c in (bi.counts or []))
    flat = _host_u8(bi.buffer)
    if isinstance(bi.datatype, GenericDataType):
        esz = bi.datatype.size
        return flat[elem_offset * esz:(elem_offset + count) * esz]
    return flat.view(storage_dtype(bi.datatype))[elem_offset:
                                                 elem_offset + count]


def binfo_v_block(bi: BufferInfoV, block: int) -> np.ndarray:
    """Typed view of rank `block`'s section of a vector host buffer."""
    counts = bi.counts or []
    displs = bi.displacements
    if displs is None:
        displs = np.cumsum([0] + [int(c) for c in counts[:-1]])
    return binfo_typed(bi, int(counts[block]), int(displs[block]))


@dataclass
class AlgSpec:
    """One algorithm of a coll within a TL."""

    id: int
    name: str
    init: Callable                      # fn(init_args, tl_team) -> CollTask
    #: default selection ranges "0-4k:score,4k-inf:score" (None -> whole
    #: range at the TL default score)
    default_select: Optional[str] = None
    #: wire-precision tag of quantized variants ("int8"/"fp8"; empty =
    #: exact), carried into every MsgRange the spec produces
    precision: str = ""
    #: provenance: "default" for hand-written algorithms,
    #: "generated-device" for lowered DSL programs (dsl/lower_device)
    origin: str = "default"
    #: generated-program family/parameter string ("ring(chunks=4)");
    #: empty for hand-written algorithms
    gen: str = ""
    #: True when this candidate executes as a native plan on this team
    #: (UCC_GEN_NATIVE resolved on at table-build time, dsl/plan.py):
    #: "+plan" in the score dump
    plan: bool = False


def load_coll_plugins(tl_name: str):
    """TL coll plugins (UCC's tlcp modules): modules outside this package
    that add algorithms and score ranges to an existing TL.

    ``UCC_TL_<NAME>_COLL_PLUGINS`` is a comma-separated list of importable
    module paths; each module exposes

        def ucc_coll_plugin(tl_team) -> Dict[CollType, List[AlgSpec]]

    whose AlgSpecs join the TL's algorithm table before its scores are
    built: a plugin algorithm gets default ranges from its
    ``default_select`` and is named in the TUNE string like a built-in
    one. Returns [(path, ucc_coll_plugin)]; a plugin that fails to import
    is ERR_INVALID_PARAM, as a requested but broken tlcp is in UCC."""
    import importlib

    raw = os.environ.get(f"UCC_TL_{tl_name.upper()}_COLL_PLUGINS", "")
    plugins = []
    for path in filter(None, (m.strip() for m in raw.split(","))):
        try:
            mod = importlib.import_module(path)
            plugins.append((path, getattr(mod, "ucc_coll_plugin")))
        except Exception as e:  # noqa: BLE001 - surface the broken plugin
            raise UccError(
                Status.ERR_INVALID_PARAM,
                f"coll plugin '{path}' for tl/{tl_name} failed to "
                f"load: {e}") from e
    return plugins


def build_scores(team: BaseTeam, default_score: int,
                 alg_table: Dict[CollType, List[AlgSpec]],
                 mem_types: Sequence[MemoryType],
                 tune_env: str = "") -> CollScore:
    """Default ranges + built-in per-alg selection + coll plugins + user
    TUNE overlay."""
    plugins = load_coll_plugins(getattr(team, "NAME", ""))
    if plugins:
        alg_table = {k: list(v) for k, v in alg_table.items()}
        for path, fn in plugins:
            try:
                extra = fn(team)
            except Exception as e:  # noqa: BLE001 - surface the broken plugin
                raise UccError(Status.ERR_INVALID_PARAM,
                               f"coll plugin '{path}' registration "
                               f"failed: {e}") from e
            for coll, specs in (extra or {}).items():
                alg_table.setdefault(coll, []).extend(specs)
    score = CollScore()
    for coll, specs in alg_table.items():
        for mt in mem_types:
            for spec in specs:
                if spec.default_select:
                    for tok in spec.default_select.split(","):
                        rng, sc = tok.rsplit(":", 1)
                        lo, hi = rng.split("-", 1)
                        score.add_range(coll, mt, parse_memunits(lo),
                                        parse_memunits(hi), int(sc),
                                        spec.init, team, spec.name,
                                        origin=spec.origin,
                                        precision=spec.precision,
                                        gen=spec.gen, plan=spec.plan)
                else:
                    score.add_range(coll, mt, 0, SIZE_INF, default_score,
                                    spec.init, team, spec.name,
                                    origin=spec.origin,
                                    precision=spec.precision, gen=spec.gen,
                                    plan=spec.plan)
    if tune_env:
        tune = os.environ.get(tune_env, "")
        if tune:
            def resolver(coll: CollType, alg: str):
                for s in alg_table.get(coll, []):
                    if s.name == alg or str(s.id) == alg:
                        return lambda ia, t=team, fn=s.init: fn(ia, t)
                return None
            st = score.update_from_str(tune, resolver, team)
            if st.is_error:
                raise UccError(st, f"bad tune string in {tune_env}")
    return score


class TlTeamBase(BaseTeam):
    """Common TL team plumbing: rank/size shortcuts and the team key."""

    NAME = "tl_base"

    def __init__(self, comp_context, core_team, scope: str = "cl"):
        super().__init__(comp_context, core_team)
        self.scope = scope
        self.rank = core_team.rank
        self.size = core_team.size
        self.team_key = (core_team.team_key, scope)

    @property
    def context(self):
        return self.comp_context
