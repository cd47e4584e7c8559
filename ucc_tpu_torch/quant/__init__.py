"""Quantized (block-scaled low-precision) collectives — the policy layer
(the port's copy of ``ucc_tpu/quant/__init__.py``).

When ``UCC_QUANT`` selects a precision, tl/shm (``tl/host/quantized.py``:
``q<mode>_sra``, ``q<mode>_ring``, ``q<mode>_linear``) and tl/torch_ops
(``q<mode>``, the torch ops of ``quant/torch_ops.py``) register quantized
variants with a precision tag; the tuner explores them like any other
candidate, and the error budget gates them per collective at init (a
refused candidate is ERR_NOT_SUPPORTED, and the fallback walk lands on an
exact algorithm). With ``UCC_QUANT=off`` (the default) nothing quantized
registers: candidate lists and dispatch stay as they were. Knobs of
the lib's global table: ``UCC_QUANT=off|int8|fp8``, the per-collective
overrides ``UCC_QUANT_ALLREDUCE`` / ``UCC_QUANT_ALLGATHER`` (empty
inherits), ``UCC_QUANT_BLOCK`` (256 elements per scale), the error budget
``UCC_QUANT_ERROR_BUDGET`` (auto: int8 0.1, fp8 1.0; a float gates
strictly) and ``UCC_QUANT_STOCHASTIC``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from ..constants import CollType, DataType
from .codec import CODECS, BlockCodec, get_codec, n_blocks, wire_count

__all__ = ["QuantParams", "coll_mode", "params_for", "admits",
           "predicted_error", "default_budget", "wire_ratio", "CODECS",
           "BlockCodec", "get_codec", "wire_count", "n_blocks",
           "QUANT_COLLS", "QUANT_DTS"]

_MODES = ("int8", "fp8")

#: collectives served by quantized variants, and the payload dtypes the
#: codecs accept (block-absmax scaling needs a float payload)
QUANT_COLLS = (CollType.ALLREDUCE, CollType.ALLGATHER)
QUANT_DTS = (DataType.FLOAT32, DataType.BFLOAT16)

_COLL_FIELD = {CollType.ALLREDUCE: "quant_allreduce",
               CollType.ALLGATHER: "quant_allgather"}
_COLL_ENV = {CollType.ALLREDUCE: "UCC_QUANT_ALLREDUCE",
             CollType.ALLGATHER: "UCC_QUANT_ALLGATHER"}

#: auto error budgets: selecting a precision is itself the opt-in to its
#: error class; an explicit numeric budget gates strictly
_AUTO_BUDGET = {"int8": 0.1, "fp8": 1.0}


@dataclass(frozen=True)
class QuantParams:
    """Resolved quantization policy for one (team, collective)."""

    codec: BlockCodec
    block: int
    budget: float
    stochastic: bool

    @property
    def mode(self) -> str:
        return self.codec.name


def _lib_config(team):
    """The owning lib's global Config, or None for a team without one."""
    try:
        return team.core_team.context.lib.config
    except AttributeError:
        return None


def _cfg_str(cfg, field: str, env: str, default: str = "") -> str:
    if cfg is not None:
        try:
            return str(cfg.get(field) or "").strip().lower()
        except KeyError:
            pass
    return os.environ.get(env, default).strip().lower()


def coll_mode(team, coll: CollType) -> Optional[str]:
    """The wire precision serving *coll* on *team*'s lib, or None. Read at
    team creation (algorithm tables), never on the dispatch path."""
    if coll not in _COLL_FIELD:
        return None
    cfg = _lib_config(team)
    mode = _cfg_str(cfg, "quant", "UCC_QUANT")
    override = _cfg_str(cfg, _COLL_FIELD[coll], _COLL_ENV[coll])
    if override:
        mode = override
    return mode if mode in _MODES else None


def default_budget(mode: str) -> float:
    return _AUTO_BUDGET[mode]


def params_for(team, coll: CollType) -> Optional[QuantParams]:
    """Full quantization policy for (team, coll); None when off."""
    mode = coll_mode(team, coll)
    if mode is None:
        return None
    cfg = _lib_config(team)
    block = 256
    budget_s = "auto"
    stochastic = False
    if cfg is not None:
        try:
            block = int(cfg.get("quant_block"))
            budget_s = str(cfg.get("quant_error_budget")).strip().lower()
            stochastic = bool(cfg.get("quant_stochastic"))
        except KeyError:
            pass
    else:
        block = int(os.environ.get("UCC_QUANT_BLOCK", "256") or 256)
        budget_s = os.environ.get("UCC_QUANT_ERROR_BUDGET",
                                  "auto").strip().lower()
        stochastic = os.environ.get("UCC_QUANT_STOCHASTIC", "n") \
            .strip().lower() in ("y", "yes", "1", "true", "on")
    block = max(8, block)
    if budget_s in ("", "auto"):
        budget = default_budget(mode)
    else:
        try:
            budget = float(budget_s)
        except ValueError:
            budget = default_budget(mode)
    return QuantParams(codec=get_codec(mode), block=block, budget=budget,
                       stochastic=stochastic)


def predicted_error(codec: BlockCodec, coll: CollType, team_size: int,
                    variant: str = "direct") -> float:
    """Worst-case relative error (fraction of per-block absmax) of a
    quantized collective, the predictor the budget gates: (n + 1)
    half-steps for the direct allreduce (every contribution and the
    result quantized once), ~2n for the ring (partial sums re-quantized
    every hop), one for allgather."""
    h = codec.half_step
    n = max(1, int(team_size))
    if coll == CollType.ALLGATHER:
        return h
    if variant == "ring":
        return 2.0 * n * h
    return (n + 1.0) * h


def admits(params: QuantParams, coll: CollType, team_size: int,
           variant: str = "direct") -> bool:
    """Does the caller's error budget admit this quantized candidate?"""
    return predicted_error(params.codec, coll, team_size,
                           variant) <= params.budget


def wire_ratio(count: int, elem_size: int, block: int) -> float:
    """wire bytes / logical bytes for a count-element payload."""
    logical = count * elem_size
    return wire_count(count, block) / logical if logical else 1.0
