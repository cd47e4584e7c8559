"""Reduce_scatter and allgather over the n ranks of one device: the CUDA
kernels of ``csrc/reduce_scatter.cu`` and ``csrc/allgather.cu``, their
wrappers, and their plain PyTorch versions.

Four entry points (see the notes at the top of the sources):

- ``ring_reduce_scatter_pass`` replaces ``ucc_tpu/tl/ring_dma.py:
  _ring_kernel`` in reduce_scatter mode, ``ring_reduce_scatter_chunked``
  replaces ``_hbm_reduce_scatter_kernel``: rank r's src is n blocks of
  ``blk`` elements, its dst is block r of the reduction. Both launch the
  one kernel of ``csrc/reduce_scatter.cu``, which is no ring: one pass
  over the ranks' srcs folds every element of block r from the n srcs in
  the ring's order (from rank r+1 round to rank r) into dst r, so its
  result is bitwise the ring's.
- ``ring_allgather_pass`` replaces ``_ring_kernel`` in allgather mode,
  ``ring_allgather_chunked`` replaces ``_hbm_allgather_kernel``: rank r's
  src is one block, its dst all n blocks in rank order. Both launch the
  one kernel of ``csrc/allgather.cu``, which is no ring either: one pass
  copies each rank's src into its block of every dst (skipping a rank's
  own block when it is its src), so its result is bitwise
  ``torch.cat(srcs)`` and the ring's.

Neither kernel takes comm slots, flag words, an error word or a
cooperative launch, and any n runs. No result depends on the chunk size:
the pass and chunked entry points of a collective differ only in the TPU
kernel each stands for, and in the counts that tl/ring_cuda routes to
each.

A wrapper takes one src and one dst tensor per rank and writes the result
into the dst tensors: reduce_scatter takes n·c elements in and c out,
allgather c in and n·c out. In place, reduce_scatter's src is the whole
dst vector and its dst that vector's block r; allgather's src is block r
of its dst. On CPU tensors a wrapper runs the plain version; on CUDA
tensors it launches the kernel or raises. It returns a ``RingLaunch``
whose ``done()``/``wait()`` tell when the launch has finished, and counts
its kernel launches in its ``launches`` attribute, a plain int. Allgather
takes an op, and every wrapper a ``root`` and a ``workspace``, for the
common calling shape; each ignores them (reduce_scatter uses its op) and
leaves the workspace untouched.

The plain versions ``ring_reduce_scatter_ref`` / ``ring_allgather_ref``,
one per collective, run the ring's steps with PyTorch ops, so their
results are bitwise those of both kernels of their collective and of the
JAX package's Pallas kernels in interpret mode. They take the chunk size
as a parameter, so a test can use the JAX package's.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..constants import ReductionOp
from ..status import Status, UccError
from .ring_common import (OPS, DirectSource, RingLaunch, RingWorkspace,
                          accumulate, divide, dispatch)

#: the allgather kernel's source
SOURCE = "allgather.cu"
_SOURCE = DirectSource(SOURCE, "ucc_allgather")
#: the reduce_scatter kernel's source
RS_SOURCE = "reduce_scatter.cu"
_RS_SOURCE = DirectSource(RS_SOURCE, "ucc_reduce_scatter", per_rank=True)

#: the allgather entry points (one kernel; the id is the common interface's)
K_AG_PASS, K_AG_CHUNKED = range(2)

#: the elements of one chunk over all n blocks; a block's chunk is
#: CHUNK_ELEMS // n, as the JAX package's reduce_scatter cblk. Neither
#: kernel reads chunks, and no result depends on them: the value sets the
#: count above which tl/ring_cuda routes to the chunked entry points, and
#: the chunks of the plain versions.
CHUNK_ELEMS = 1 << 20


def reduce_scatter_pass_elems(n: int) -> int:
    """Src elements per rank (n blocks) one pass covers; larger counts
    run the chunked kernel, as ``_vmem_pass_elems`` routes the TPU's."""
    return max(n, (CHUNK_ELEMS // n) * n)


def allgather_pass_elems(n: int) -> int:
    """Src elements per rank (one block) one pass covers; larger counts
    run the chunked kernel, as the TPU's routing does."""
    return max(1, CHUNK_ELEMS // n)


def chunk_geometry(blk: int, n: int,
                   cblk: Optional[int] = None) -> Tuple[int, int]:
    """(cblk, n_chunks) of the plain versions' walk over blocks of *blk*
    elements: chunks of *cblk* elements per block (default ``CHUNK_ELEMS // n``,
    never more than blk), the last one ragged."""
    if cblk is None:
        cblk = min(max(1, CHUNK_ELEMS // n), max(blk, 1))
    elif cblk < 1:
        raise ValueError(f"chunk size {cblk} is not positive")
    return cblk, -(-blk // cblk)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _blocks(srcs: Sequence[torch.Tensor], n_blocks: int, blk: int,
            cblk: int, n_chunks: int) -> torch.Tensor:
    """(rank, block, padded element) view of the srcs' blocks, each padded
    with zeros to n_chunks x cblk elements."""
    x = torch.zeros((len(srcs), n_blocks, n_chunks * cblk),
                    dtype=srcs[0].dtype, device=srcs[0].device)
    for r, s in enumerate(srcs):
        x[r, :, :blk] = s.reshape(n_blocks, blk)
    return x


def ring_reduce_scatter_ref(srcs: Sequence[torch.Tensor], op: ReductionOp,
                            cblk: Optional[int] = None
                            ) -> List[torch.Tensor]:
    """Plain version of both reduce_scatter kernels: the ring (shift
    c = 1) over ranks and steps, for every chunk of *cblk* elements
    (default ``chunk_geometry``'s, one chunk at pass sizes) at once, as
    chunks fold alike. Rank r sends its block r-1, then at step m folds
    the incoming message into its block r-m-2 as ``acc(local,
    incoming)`` and sends the fold on; after n-1 steps it holds block r.
    AVG divides at the end."""
    n = len(srcs)
    blk = srcs[0].numel() // n
    cblk, n_chunks = chunk_geometry(blk, n, cblk)
    acc = accumulate(op)
    x = _blocks(srcs, n, blk, cblk, n_chunks)
    msg = [x[r, (r - 1) % n] for r in range(n)]
    for m in range(n - 1):
        msg = [acc(x[r, (r - m - 2) % n], msg[(r - 1) % n])
               for r in range(n)]
    if op == ReductionOp.AVG:
        msg = [divide(v, n) for v in msg]
    return [v[:blk] for v in msg]


def ring_allgather_ref(srcs: Sequence[torch.Tensor],
                       cblk: Optional[int] = None) -> List[torch.Tensor]:
    """Plain version of both allgather kernels: the ring over ranks and
    steps, for every chunk of *cblk* elements (default
    ``chunk_geometry``'s) at once: rank r puts its block in place r, and
    at step s forwards block r-s to rank r+1."""
    n = len(srcs)
    blk = srcs[0].numel()
    cblk, n_chunks = chunk_geometry(blk, n, cblk)
    own = _blocks(srcs, 1, blk, cblk, n_chunks)
    out = torch.zeros((n, n, n_chunks * cblk), dtype=srcs[0].dtype,
                      device=srcs[0].device)
    for r in range(n):
        out[r, r] = own[r, 0]
    for s in range(n - 1):
        for r in range(n):
            b = (r - s) % n
            out[(r + 1) % n, b] = out[r, b]
    return [out[r, :, :blk].reshape(-1) for r in range(n)]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _scatter_count(count: int, n: int) -> int:
    if count % n:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"ring reduce_scatter needs a src count divisible by "
                       f"n={n} (got {count})")
    return count // n


def _reduce_scatter(chunked: int, srcs, dsts, op, stream,
                    ptr_table) -> Optional[RingLaunch]:
    def plan(count, n):
        # one row of CTAs per rank walks its blk elements; no chunks, comm
        # slots or flag words
        blk = count // n
        return blk, blk, 1, blk, 0, 0
    return dispatch(_RS_SOURCE, chunked, "ring reduce_scatter", srcs, dsts,
                    op, ops=OPS, dst_count=_scatter_count,
                    ref=lambda: ring_reduce_scatter_ref(srcs, op), plan=plan,
                    stream=stream, workspace=None, ptr_table=ptr_table)


def allgather_plan(count: int, n: int):
    """The allgather kernel's launch plan: count elements per rank, and the
    n·count elements of its n units, which size its grid."""
    return count, count, 1, n * count, 0, 0


def _allgather(kernel: int, srcs, dsts, stream,
               ptr_table) -> Optional[RingLaunch]:
    return dispatch(_SOURCE, kernel, "ring allgather", srcs, dsts, None,
                    ops=None, dst_count=lambda count, n: n * count,
                    ref=lambda: ring_allgather_ref(srcs),
                    plan=allgather_plan, stream=stream, workspace=None,
                    ptr_table=ptr_table)


def ring_reduce_scatter_pass(srcs: Sequence[torch.Tensor],
                             dsts: Sequence[torch.Tensor], op: ReductionOp,
                             *, stream=None,
                             workspace: Optional[RingWorkspace] = None,
                             ptr_table: Optional[torch.Tensor] = None,
                             root: int = 0) -> RingLaunch:
    """Reduce_scatter of ``srcs`` (n·c each) into ``dsts`` (c each), for
    the counts that the TPU's one-pass ring takes; ``workspace`` and
    ``root`` are ignored."""
    h = _reduce_scatter(0, srcs, dsts, op, stream, ptr_table)
    if h is None:
        return RingLaunch()
    ring_reduce_scatter_pass.launches += 1
    return h


def ring_reduce_scatter_chunked(srcs: Sequence[torch.Tensor],
                                dsts: Sequence[torch.Tensor],
                                op: ReductionOp, *, stream=None,
                                workspace: Optional[RingWorkspace] = None,
                                ptr_table: Optional[torch.Tensor] = None,
                                root: int = 0) -> RingLaunch:
    """Reduce_scatter of ``srcs`` (n·c each) into ``dsts`` (c each), for
    the counts that the TPU's chunked ring takes; ``workspace`` and
    ``root`` are ignored."""
    h = _reduce_scatter(1, srcs, dsts, op, stream, ptr_table)
    if h is None:
        return RingLaunch()
    ring_reduce_scatter_chunked.launches += 1
    return h


def ring_allgather_pass(srcs: Sequence[torch.Tensor],
                        dsts: Sequence[torch.Tensor],
                        op: Optional[ReductionOp] = None, *, stream=None,
                        workspace: Optional[RingWorkspace] = None,
                        ptr_table: Optional[torch.Tensor] = None,
                        root: int = 0) -> RingLaunch:
    """Allgather of ``srcs`` (c each) into ``dsts`` (n·c each), for the
    counts that the TPU's one-pass ring takes; ``op``, ``root`` and
    ``workspace`` are ignored."""
    h = _allgather(K_AG_PASS, srcs, dsts, stream, ptr_table)
    if h is None:
        return RingLaunch()
    ring_allgather_pass.launches += 1
    return h


def ring_allgather_chunked(srcs: Sequence[torch.Tensor],
                           dsts: Sequence[torch.Tensor],
                           op: Optional[ReductionOp] = None, *, stream=None,
                           workspace: Optional[RingWorkspace] = None,
                           ptr_table: Optional[torch.Tensor] = None,
                           root: int = 0) -> RingLaunch:
    """Allgather of ``srcs`` (c each) into ``dsts`` (n·c each), for the
    counts that the TPU's chunked ring takes; ``op``, ``root`` and
    ``workspace`` are ignored."""
    h = _allgather(K_AG_CHUNKED, srcs, dsts, stream, ptr_table)
    if h is None:
        return RingLaunch()
    ring_allgather_chunked.launches += 1
    return h


ring_reduce_scatter_pass.launches = 0
ring_reduce_scatter_chunked.launches = 0
ring_allgather_pass.launches = 0
ring_allgather_chunked.launches = 0
