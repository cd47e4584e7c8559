"""Fault injection, peer health and agreement: detect, bound and survive
failures.

- ``fault.inject``: env-driven (``UCC_FAULT=spec``, seeded by
  ``UCC_FAULT_SEED``) probabilistic drop / delay / error / corrupt /
  rank-kill at the transport boundary (tl/host send/recv) and the task
  boundary (CollTask.post). Off costs nothing: hot paths test the
  module-level ``inject.ENABLED`` boolean first.
- ``fault.health``: peer liveness under ``UCC_FT=shrink``: a heartbeat
  board and a per-context ``HealthRegistry`` that names failed ranks from
  heartbeats, fail-fast posts, watchdog escalation, kill injection and
  cross-process liveness sources (tl/ipc's pid board); in-flight work on
  a team with a dead rank is cancelled with ``ERR_RANK_FAILED``.
- ``fault.agree``: fault-tolerant agreement over the service team:
  survivors converge on one (failed set, admit set, epoch) while routing
  around dead members; feeds ``Team.shrink`` and ``Team.grow``.
- ``fault.soak``: drills that run collectives under injection and assert
  that every rank ends in a terminal status (``python -m
  ucc_tpu_torch.fault.soak``).

Spec grammar (comma-separated)::

    UCC_FAULT=drop=0.01,delay=0.05:0.003,error=0.02,post_error=0.01,kill=2
    UCC_FAULT_SEED=7

``drop=P``            drop a send with probability P (message lost)
``delay=P:S``         delay a send's delivery by S seconds with prob P
``delay_rank=R``      pin delays to ctx rank R
``error=P``           fail a send/recv post with ERR_NO_MESSAGE
``post_error=P``      fail a task at post() before any wire traffic
``kill=R[+R2..]``     simulate dead rank(s): ctx rank R drops every
                      send and fails every task post
``corrupt=P``         flip one bit of a send's payload with prob P (no
                      wire checksum in this package yet: the corrupted
                      bytes are delivered)
``corrupt_rank=R``    pin corruption to ctx rank R

Call sites import the owning module (``from ..fault import inject``) so
runtime reconfiguration stays visible; a re-exported boolean would be a
stale copy.
"""
from . import health, inject  # noqa: F401

__all__ = ["health", "inject"]
