"""Quantization verification and reporting helpers (the port of
``ucc_tpu/quant/verify.py``).

One home for the ``detail.quant`` record shape that ``ucc_perftest
--quant`` (and chip_smoke's quant phase) print: the static wire
accounting, the random-data error stats, and a measured-bytes probe that
switches the metrics registry on around a verification round and reads
the ``bytes_sent`` delta — the host transports' actual traffic, not the
formula the static fields come from.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..constants import CollType
from ..obs import metrics
from . import QuantParams, wire_count, wire_ratio

__all__ = ["base_detail", "error_stats", "MeasuredBytes",
           "exact_wire_floor"]


def exact_wire_floor(coll: CollType, count: int, esz: int,
                     n: int) -> Optional[int]:
    """Minimum TOTAL bytes (summed over ranks) any exact algorithm must
    put on the wire: allreduce moves >= 2*(n-1)/n of the vector per rank,
    allgather (n-1)/n of the result. The bar measured quantized traffic
    must beat."""
    if n <= 1:
        return 0
    if coll == CollType.ALLREDUCE:
        return 2 * (n - 1) * count * esz
    if coll == CollType.ALLGATHER:
        # `count` is the per-rank contribution; each block reaches n-1
        # peers
        return (n - 1) * n * count * esz
    return None


def base_detail(params: QuantParams, coll: CollType, count: int,
                esz: int, busbw: float, n: int) -> dict:
    """Static fields of a detail.quant record (formula-derived; the
    measured fields come from MeasuredBytes / error_stats)."""
    ratio = wire_ratio(count, esz, params.block)
    d = {
        "mode": params.mode,
        "block": params.block,
        "error_budget": params.budget,
        "logical_bytes": count * esz,
        "wire_bytes": wire_count(count, params.block),
        "wire_ratio": round(ratio, 4),
        # busbw over the bytes actually on the wire
        "busbw_wire_GBps": round(busbw * ratio, 3) if busbw else 0.0,
    }
    floor = exact_wire_floor(coll, count, esz, n)
    if floor:
        d["exact_wire_floor_bytes_total"] = floor
    return d


def error_stats(exact_f64: np.ndarray, results: Sequence[np.ndarray],
                budget: float) -> dict:
    """max-abs / max-rel error of per-rank *results* (float arrays)
    against the f64 reference (rel = fraction of the reference's peak
    magnitude)."""
    max_abs = 0.0
    for got in results:
        g = np.asarray(got).astype(np.float64).reshape(-1)
        max_abs = max(max_abs, float(np.max(np.abs(
            g[:exact_f64.size] - exact_f64))))
    peak = float(np.max(np.abs(exact_f64))) or 1.0
    rel = max_abs / peak
    return {"max_abs_err": round(max_abs, 6),
            "max_rel_err": round(rel, 6),
            "within_budget": rel <= budget}


class MeasuredBytes:
    """Context manager: ``bytes_sent`` delta across the wrapped region.

    Flips ``metrics.ENABLED`` directly so the host TLs' per-post
    instrumentation counts the round's traffic, and restores the prior
    state on exit. ``total`` is the summed delta over every (component,
    coll, alg) label — 0 on paths that do not go through the instrumented
    host transport (the device TLs), so consumers treat 0 as "not
    measured".
    """

    total: float = 0.0

    @staticmethod
    def _bytes() -> float:
        snap = metrics.snapshot()
        return float(sum((snap["counters"].get("bytes_sent")
                          or {}).values()))

    def __enter__(self) -> "MeasuredBytes":
        self._was_enabled = metrics.ENABLED
        metrics.ENABLED = True
        self._start = self._bytes()
        return self

    def __exit__(self, *exc) -> None:
        self.total = self._bytes() - self._start
        metrics.ENABLED = self._was_enabled
