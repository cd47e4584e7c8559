"""Allreduce over the n ranks of one device: the CUDA kernel of
``csrc/ring_allreduce.cu``, its two entry points, and their plain PyTorch
versions.

Two entry points, one kernel (see the note at the top of the source):

- ``ring_allreduce_pass`` replaces ``ucc_tpu/tl/ring_dma.py:_ring_kernel``
  in allreduce mode: one ring over the whole vector, padded to a multiple
  of n, ``blk = ceil(count / n)``.
- ``ring_allreduce_chunked`` replaces ``_hbm_allreduce_kernel``: the same
  ring once per chunk of ``csize = pass_elems(n)`` elements.

The kernel is no ring: one pass over the ranks' buffers folds every
element from its n srcs in the ring's order (block b from rank b on) and
stores it into the n dsts, so its result is bitwise the ring's. It needs
no comm slots, flag words or error word.

A wrapper takes one src and one dst tensor per rank (``src is dst`` runs
in place) and writes the result into the dst tensors. On CPU tensors it
runs the plain version; on CUDA tensors it launches the kernel or raises.
It returns a :class:`RingLaunch` whose ``done()``/``wait()`` tell when
the launch has finished. Each wrapper counts its kernel launches in its
``launches`` attribute, a plain int. ``workspace`` is accepted, as every
ring wrapper takes it, and left untouched.

The plain versions ``ring_allreduce_pass_ref`` /
``ring_allreduce_chunked_ref`` run the ring's steps over the same
geometry with PyTorch ops, so their results are bitwise those of the
kernel and of the JAX package's Pallas kernels in interpret mode. The
chunked one takes the chunk size as a parameter, so a test can use the
JAX package's.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..constants import ReductionOp
# RingWorkspace, make_ptr_table, THREADS, SUPPORTED_DTYPES, launch_ctas
# and the plain fold (_accum, _divide) stay importable from here
from .ring_common import (OPS, SUPPORTED_DTYPES, THREADS,  # noqa: F401
                          DirectSource, RingLaunch, RingWorkspace, dispatch,
                          launch_ctas, make_ptr_table)
from .ring_common import accumulate as _accum
from .ring_common import divide as _divide

SOURCE = "ring_allreduce.cu"
_SOURCE = DirectSource(SOURCE, "ucc_ring_allreduce")

#: per-rank elements one pass covers; counts above pass_elems(n) run the
#: chunked entry point. The chunk fixes the blocks, and so the order in
#: which an element's ranks are folded: it stays the ring's 1 Mi
#: elements, though the kernel reads no comm slots and a chunk costs it
#: nothing.
CHUNK_ELEMS = 1 << 20


def pass_elems(n: int) -> int:
    """Per-rank elements one pass covers (n-divisible), as
    ``_vmem_pass_elems`` is for the TPU kernels."""
    return max(n, (CHUNK_ELEMS // n) * n)


def pass_geometry(count: int, n: int) -> Tuple[int, int]:
    """(blk, n_chunks) of the pass kernel: one chunk, count padded to a
    multiple of n."""
    return -(-max(count, 1) // n), 1


def chunked_geometry(count: int, n: int,
                     csize: Optional[int] = None) -> Tuple[int, int]:
    """(blk, n_chunks) of the chunked kernel: count padded to a multiple
    of csize (default ``pass_elems(n)``), blk = csize / n."""
    csize = pass_elems(n) if csize is None else int(csize)
    if csize < n or csize % n:
        raise ValueError(f"chunk size {csize} is not a positive multiple "
                         f"of n={n}")
    return csize // n, -(-max(count, 1) // csize)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def ring_allreduce_ref(srcs: Sequence[torch.Tensor], op: ReductionOp,
                       blk: int, n_chunks: int) -> List[torch.Tensor]:
    """The ring step schedule over ranks and steps, for every chunk at
    once (chunks are independent): n-1 reduce-scatter steps, then n-1
    allgather steps, ``work[recv] = acc(work[recv], incoming)``."""
    n = len(srcs)
    count = srcs[0].numel()
    acc = _accum(op)
    work = torch.zeros((n, n_chunks, n, blk), dtype=srcs[0].dtype,
                       device=srcs[0].device)
    flat = work.view(n, -1)
    for r in range(n):
        flat[r, :count] = srcs[r].reshape(-1)
    for s in range(n - 1):
        # rank r-1 sends block r-1-s, which rank r folds into the same block
        sent = [work[r, :, (r - s) % n] for r in range(n)]
        for r in range(n):
            i = (r - s - 1) % n
            work[r, :, i] = acc(work[r, :, i], sent[(r - 1) % n])
    for s in range(n - 1):
        sent = [work[r, :, (r + 1 - s) % n] for r in range(n)]
        for r in range(n):
            work[r, :, (r - s) % n] = sent[(r - 1) % n]
    if op == ReductionOp.AVG:
        work = _divide(work, n)
        flat = work.view(n, -1)
    return [flat[r, :count] for r in range(n)]


def ring_allreduce_pass_ref(srcs: Sequence[torch.Tensor],
                            op: ReductionOp) -> List[torch.Tensor]:
    """Plain version of ``ring_allreduce_pass``."""
    blk, n_chunks = pass_geometry(srcs[0].numel(), len(srcs))
    return ring_allreduce_ref(srcs, op, blk, n_chunks)


def ring_allreduce_chunked_ref(srcs: Sequence[torch.Tensor],
                               op: ReductionOp,
                               csize: Optional[int] = None
                               ) -> List[torch.Tensor]:
    """Plain version of ``ring_allreduce_chunked`` (chunk size *csize*,
    default ``pass_elems(n)``)."""
    blk, n_chunks = chunked_geometry(srcs[0].numel(), len(srcs), csize)
    return ring_allreduce_ref(srcs, op, blk, n_chunks)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def allreduce_walk(count: int, n: int) -> int:
    """Elements of the kernel's walk: every element of a rank."""
    return count


def allreduce_pieces(count: int, n: int, lo: int, hi: int):
    """(rank, start, stop) of every dst range that elements [lo, hi) of
    the walk write: the same range of every rank."""
    return [(r, lo, hi) for r in range(n)]


def _dispatch(chunked: int, srcs, dsts, op, geometry, ref, stream,
              workspace, ptr_table, part) -> Optional[RingLaunch]:
    def plan(count, n):
        blk, n_chunks = geometry(count, n)
        return count, blk, n_chunks, count, 0, 0
    return dispatch(_SOURCE, chunked, "ring allreduce", srcs, dsts, op,
                    ops=OPS, dst_count=lambda count, n: count,
                    ref=lambda: ref(srcs, op), plan=plan, stream=stream,
                    workspace=workspace, ptr_table=ptr_table, part=part,
                    walk=allreduce_walk, pieces=allreduce_pieces)


def ring_allreduce_pass(srcs: Sequence[torch.Tensor],
                        dsts: Sequence[torch.Tensor], op: ReductionOp, *,
                        stream=None, workspace: Optional[RingWorkspace] = None,
                        ptr_table: Optional[torch.Tensor] = None,
                        root: int = 0,
                        part: Optional[Tuple[int, int]] = None
                        ) -> RingLaunch:
    """One-pass ring allreduce of ``srcs`` into ``dsts`` (one per rank);
    ``root`` is ignored; ``part=(p, P)`` folds part p of P of the
    elements (kernels/ring_common.py)."""
    h = _dispatch(0, srcs, dsts, op, pass_geometry, ring_allreduce_pass_ref,
                  stream, workspace, ptr_table, part)
    if h is None:
        return RingLaunch()
    ring_allreduce_pass.launches += 1
    return h


def ring_allreduce_chunked(srcs: Sequence[torch.Tensor],
                           dsts: Sequence[torch.Tensor], op: ReductionOp, *,
                           stream=None,
                           workspace: Optional[RingWorkspace] = None,
                           ptr_table: Optional[torch.Tensor] = None,
                           root: int = 0,
                           part: Optional[Tuple[int, int]] = None
                           ) -> RingLaunch:
    """Chunked ring allreduce of ``srcs`` into ``dsts`` (one per rank);
    ``root`` is ignored; ``part=(p, P)`` folds part p of P of the
    elements."""
    h = _dispatch(1, srcs, dsts, op, chunked_geometry,
                  ring_allreduce_chunked_ref, stream, workspace, ptr_table,
                  part)
    if h is None:
        return RingLaunch()
    ring_allreduce_chunked.launches += 1
    return h


ring_allreduce_pass.launches = 0
ring_allreduce_chunked.launches = 0
