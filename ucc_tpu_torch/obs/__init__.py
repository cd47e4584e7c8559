"""Observability: the metrics registry (``obs.metrics``, ``UCC_STATS``),
the stall watchdog (``obs.watchdog``, ``UCC_WATCHDOG_TIMEOUT``), the
flight recorder (``obs.flight``, ``UCC_FLIGHT``) and its diagnosis
(``obs.diagnose``; ``python -m ucc_tpu_torch.tools.fr``).

Span tracing lives in ``utils.profiling`` (``UCC_PROFILE_MODE``). The
metrics registry and the watchdog are off by default; the flight
recorder is on (``UCC_FLIGHT=y``) and is bound once, at context, request
and device-task creation. Hot paths test a module-level boolean
(``metrics.ENABLED``, ``watchdog.ENABLED``, ``flight.ENABLED``,
``profiling.ENABLED``) or a bound reference before any formatting or
locking. The continuous collector with its rank bias (the JAX package's
``obs/collector.py``) comes with ROADMAP item 8b.
"""
from . import diagnose, flight, metrics, watchdog  # noqa: F401

__all__ = ["diagnose", "flight", "metrics", "watchdog"]
