"""Observability: the metrics registry (``obs.metrics``, ``UCC_STATS``).

Span tracing lives in ``utils.profiling`` (``UCC_PROFILE_MODE``). The
JAX package's other pillars, the stall watchdog, the flight recorder and
the continuous collector, come with ROADMAP item A.8 (fault tolerance).
Each pillar is off by default, and hot paths test a module-level boolean
(``metrics.ENABLED``, ``profiling.ENABLED``) before any formatting or
locking.
"""
from . import metrics  # noqa: F401

__all__ = ["metrics"]
