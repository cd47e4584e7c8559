"""Observability: the metrics registry (``obs.metrics``, ``UCC_STATS``),
the stall watchdog (``obs.watchdog``, ``UCC_WATCHDOG_TIMEOUT``), the
flight recorder (``obs.flight``, ``UCC_FLIGHT``) and its diagnosis
(``obs.diagnose``; ``python -m ucc_tpu_torch.tools.fr``), and the
continuous collector with its rank bias (``obs.collector``,
``UCC_COLLECT``).

Span tracing lives in ``utils.profiling`` (``UCC_PROFILE_MODE``). The
metrics registry, the watchdog and the collector are off by default; the
flight recorder is on (``UCC_FLIGHT=y``) and is bound once, at context,
request and device-task creation. Hot paths test a module-level boolean
(``metrics.ENABLED``, ``watchdog.ENABLED``, ``flight.ENABLED``,
``profiling.ENABLED``) or a bound reference (``context.collector``,
``team.rank_bias``) before any formatting or locking.
"""
from . import collector, diagnose, flight, metrics, watchdog  # noqa: F401

__all__ = ["collector", "diagnose", "flight", "metrics", "watchdog"]
