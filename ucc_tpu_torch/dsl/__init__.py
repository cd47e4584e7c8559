"""Collective compiler — a dataflow DSL for generated algorithms (the port
of ``ucc_tpu/dsl``).

Collective algorithms expressed as small chunk-dataflow programs can be
compiled, specialized and searched instead of hand-written one variant
at a time (GC3, HiCCL; PAPERS.md). Whole algorithm FAMILIES are generated
as per-rank dataflow programs, statically verified, compiled onto the
host-TL machinery or lowered to generated device collectives, and
registered as ordinary score-map candidates the tuner explores.

Layers:

- :mod:`ir` — the collective-program IR: a per-rank dataflow over
  symbolic ranks and buffer chunks (``send``/``recv``/``reduce``/``copy``
  and the one-sided ``put``/``put_red`` ops grouped into rounds), authored
  via :class:`ir.ProgramBuilder`.
- :mod:`verify` — the static verifier every program passes BEFORE
  registration: symbolic chunk tracking proves each rank's final buffer
  holds the collective's postcondition, and a round-ordered wait-graph
  check proves deadlock-freedom. Rejected programs never ship.
- :mod:`families` — the built-in generators: ``ring`` (chunking),
  ``rhd`` (radix), ``sra``/``sra_pipe`` (radix, pipeline depth),
  ``qdirect`` (fused allreduce+quantize), the allgather, reduce_scatter
  and bcast families, ``pooled`` (one-sided windows) and ``hier`` (the
  composition along the topology tree).
- :mod:`compile` — lowers a verified program to a ``HostCollTask``
  (``GeneratedCollTask``): pool ``scratch()`` leases, ``reduce_arrays(out=)``
  accumulation, ``send_nb``/``recv_nb`` posting, the block codec at wire
  edges, the arena windows of the pooled tier, and ``PipelinedSchedule``
  for the pipelined family.
- :mod:`plan` — lowers an allreduce program to a packed op table the
  native core retires in C (``UCC_GEN_NATIVE``), and bridges the
  hand-written ring and sra allreduce onto it.
- :mod:`registry` — the verified-program cache (in memory and on disk)
  and the ``UCC_GEN`` gate that produces the ``AlgSpec`` rows (origin
  ``generated``/``searched``/``pooled``, low default score) the host TLs
  merge into their algorithm tables.
- :mod:`search` — the cost-model-guided program search (propose, prune
  by predicted cost, refine by successive halving) over host programs
  and over device programs (``ucc_tune --gen-search [--device]``).
- :mod:`lower_device` — a verified program as a generated device
  collective of tl/torch_ops (``UCC_GEN_DEVICE``, origin
  ``generated-device``; kernels of ``csrc/gen_fold.cu`` and
  ``csrc/gen_device.cu`` on the GPU).
- :mod:`smoke` — the warn-only probes (``python -m
  ucc_tpu_torch.dsl.smoke``).

The coalescer's fused batches (the JAX package's ``dsl/fused.py``) come
with ``core/coalesce.py``, ROADMAP item 8b.
"""
from __future__ import annotations

from .ir import DSL_VERSION, Op, OpKind, Program, ProgramBuilder, RankProgram
from .verify import VerifyError, verify

__all__ = ["DSL_VERSION", "Op", "OpKind", "Program", "ProgramBuilder",
           "RankProgram", "VerifyError", "verify"]
