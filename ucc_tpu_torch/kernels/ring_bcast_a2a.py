"""Bcast and pairwise alltoall over the n ranks of one device: the CUDA
kernels of ``csrc/bcast.cu`` (bcast) and ``csrc/alltoall.cu`` (alltoall),
their wrappers, and their plain PyTorch versions.

- ``ring_bcast_pass`` replaces ``ucc_tpu/tl/ring_dma.py:_bcast_kernel``,
  ``ring_bcast_chunked`` replaces ``_hbm_bcast_kernel``: the root's count
  elements reach every rank. Both launch the one flag-free kernel of
  ``csrc/bcast.cu`` with the same arguments: the grid copies the root's
  src into every other dst (and into the root's dst when it is not the
  root's src) in one pass, with no flags, error word or workspace;
- ``ring_alltoall_pass`` replaces ``_alltoall_kernel`` (with
  ``_all_rank_barrier``), ``ring_alltoall_chunked`` replaces
  ``_hbm_alltoall_kernel``: rank r's src and dst are n blocks, and dst_p's
  block r is src_r's block p. Both launch the one flag-free kernel of
  ``csrc/alltoall.cu`` with the same arguments: each diagonal block and
  each pair of ranks (``alltoall_units``, owned as ``owns_pair`` says) is
  moved by the threads that own its elements, with no flags, error word
  or workspace.

Neither result depends on the geometry.

A wrapper takes one src and one dst tensor per rank, of the same count,
and writes the result into the dst tensors. bcast takes the ``root``
keyword; its non-root srcs are not read, and a rank whose src is its dst
(UCC's bcast passes src alone) is in place: the root's buffer is then its
result and is not copied onto itself. alltoall's count is n blocks; in
place its src is its dst. On CPU tensors a wrapper runs the plain version
(computing the whole result before writing any dst); on CUDA tensors it
launches the kernel or raises. It returns a ``RingLaunch`` whose
``done()``/``wait()`` tell when the launch has finished, and counts its
kernel launches in its ``launches`` attribute, a plain int. Both take an
op for the common calling shape and ignore it, and accept a
``workspace`` and leave it untouched; alltoall ignores ``root``.

The plain versions ``ring_bcast_ref`` / ``ring_alltoall_ref`` run the
TPU kernels' schedules with PyTorch ops, sub-block by sub-block and step
by step around the ring (bcast) or unit by unit (alltoall), and take the
sub-block or chunk size as a parameter, so a test can use the JAX
package's.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..constants import ReductionOp
from ..status import Status, UccError
from .ring_common import DirectSource, RingLaunch, RingWorkspace, dispatch

#: the bcast kernel's source
SOURCE = "bcast.cu"
_SOURCE = DirectSource(SOURCE, "ucc_bcast")
#: the alltoall kernel's source
A2A_SOURCE = "alltoall.cu"
_A2A_SOURCE = DirectSource(A2A_SOURCE, "ucc_alltoall")

#: the bcast entry points (one kernel; the id is the common interface's)
K_BCAST_PASS, K_BCAST_CHUNKED = range(2)
#: the alltoall entry points (one kernel; the id is the common interface's)
K_A2A_PASS, K_A2A_CHUNKED = range(2)
#: the most ranks an alltoall launch takes (csrc/alltoall.cu: MAX_RANKS)
A2A_MAX_RANKS = 32768

#: per-rank elements one pass covers, for both collectives; larger counts
#: on more than one rank run the chunked entry points, as tl/ring_dma
#: routes the TPU's. Neither kernel reads sub-blocks or chunks; the plain
#: bcast walks the ring in sub-blocks of CHUNK_ELEMS // 2 elements, as the
#: JAX package's, and the plain alltoall walks a block in chunks of
#: CHUNK_ELEMS // n elements, which changes no bit.
CHUNK_ELEMS = 1 << 20


def pass_elems(n: int) -> int:
    """Per-rank elements one pass of either collective covers."""
    return CHUNK_ELEMS


def bcast_geometry(count: int, blk: Optional[int] = None) -> Tuple[int, int]:
    """(blk, nsub) of the plain bcast's ring: sub-blocks of *blk* elements
    (default ``CHUNK_ELEMS // 2``, never more than count), the last one
    ragged."""
    if blk is None:
        blk = min(max(count, 1), max(1, CHUNK_ELEMS // 2))
    elif blk < 1:
        raise ValueError(f"sub-block size {blk} is not positive")
    return blk, -(-count // blk)


def alltoall_chunk_geometry(blk: int, n: int,
                            cblk: Optional[int] = None) -> Tuple[int, int]:
    """(cblk, n_chunks) of the plain alltoall's walk over blocks of *blk*
    elements: chunks of *cblk* elements per block (default ``CHUNK_ELEMS
    // n``, never more than blk), the last one ragged."""
    if cblk is None:
        cblk = min(max(1, CHUNK_ELEMS // n), max(blk, 1))
    elif cblk < 1:
        raise ValueError(f"chunk size {cblk} is not positive")
    return cblk, -(-blk // cblk)


def owns_pair(r: int, p: int, n: int) -> bool:
    """Whether rank r exchanges the pair {r, p} (the other rank does not):
    r owns {r, r+s} when 2s < n, and, when 2s = n, if it is the lower."""
    s = (p - r) % n
    return 2 * s < n or (2 * s == n and r < p)


def alltoall_units(n: int) -> List[Tuple[int, int]]:
    """The alltoall kernel's work units in its order, as (r, q): the n
    diagonals (r, r), then for s = 1 .. (n-1)//2 the pairs (r, r+s) of
    each rank r in turn, then, for even n, (r, r + n/2) for r < n/2. Unit
    (r, q) moves src_r's block q to dst_q's block r and src_q's block r to
    dst_r's block q; r owns it (``owns_pair``)."""
    m = (n - 1) // 2
    units = [(r, r) for r in range(n)]
    units += [(r, (r + s) % n) for r in range(n) for s in range(1, m + 1)]
    if n % 2 == 0:
        units += [(r, r + n // 2) for r in range(n // 2)]
    return units


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def ring_bcast_ref(srcs: Sequence[torch.Tensor], root: int,
                   blk: Optional[int] = None) -> List[torch.Tensor]:
    """Plain version of both bcast entry points: the root's src in
    sub-blocks of *blk* elements (default ``bcast_geometry``'s), over the
    steps of the TPU kernels' ring: at step t the rank at distance d >= 1
    from the root takes sub-block t - (d - 1) from its left neighbour
    (the order changes no bit). Non-root srcs are not read."""
    n = len(srcs)
    count = srcs[root].numel()
    blk, nsub = bcast_geometry(count, blk)
    out = [torch.empty_like(srcs[root]) for _ in range(n)]
    out[root].copy_(srcs[root])
    for t in range(nsub + n - 2):
        for d in range(1, n):
            s = t - (d - 1)
            if 0 <= s < nsub:
                r = (root + d) % n
                sub = slice(s * blk, min((s + 1) * blk, count))
                out[r][sub] = out[(r - 1) % n][sub]
    return out


def ring_alltoall_ref(srcs: Sequence[torch.Tensor],
                      cblk: Optional[int] = None) -> List[torch.Tensor]:
    """Plain version of both alltoall entry points: unit by unit
    (``alltoall_units``: the diagonals, then the owned pairs), each block
    walked in chunks of *cblk* elements (default
    ``alltoall_chunk_geometry``'s; the order changes no bit): dst_q's
    block r takes src_r's block q and dst_r's block q takes src_q's
    block r."""
    n = len(srcs)
    blk = srcs[0].numel() // n
    cblk, n_chunks = alltoall_chunk_geometry(blk, n, cblk)
    out = [torch.empty_like(s) for s in srcs]
    for r, q in alltoall_units(n):
        for k in range(n_chunks):
            lo, hi = k * cblk, min((k + 1) * cblk, blk)
            out[q][r * blk + lo:r * blk + hi] = \
                srcs[r][q * blk + lo:q * blk + hi]
            out[r][q * blk + lo:q * blk + hi] = \
                srcs[q][r * blk + lo:r * blk + hi]
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def bcast_plan(count: int, n: int):
    """The bcast kernel's launch plan: count elements per rank, which also
    size its grid."""
    return count, count, 1, count, 0, 0


def _bcast(kernel: int, srcs, dsts, root, stream,
           ptr_table) -> Optional[RingLaunch]:
    n = len(srcs)
    if not 0 <= root < max(n, 1):
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"ring bcast: root {root} is not a rank of {n}")
    return dispatch(_SOURCE, kernel, "ring bcast", srcs, dsts, None,
                    ops=None, dst_count=lambda count, n: count,
                    ref=lambda: ring_bcast_ref(srcs, root), plan=bcast_plan,
                    stream=stream, workspace=None, ptr_table=ptr_table,
                    root=root)


def _alltoall_count(count: int, n: int) -> int:
    if count % n:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"ring alltoall needs a count divisible by n={n} "
                       f"(got {count})")
    return count


def alltoall_plan(count: int, n: int):
    """The alltoall kernel's launch plan: blocks of count // n elements,
    and the elements of its n(n+1)/2 units, which size its grid."""
    if n > A2A_MAX_RANKS:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"ring alltoall takes at most {A2A_MAX_RANKS} ranks "
                       f"(got {n})")
    blk = count // n
    return blk, blk, 1, n * (n + 1) // 2 * blk, 0, 0


def _alltoall(kernel: int, srcs, dsts, stream,
              ptr_table) -> Optional[RingLaunch]:
    return dispatch(_A2A_SOURCE, kernel, "ring alltoall", srcs, dsts, None,
                    ops=None, dst_count=_alltoall_count,
                    ref=lambda: ring_alltoall_ref(srcs), plan=alltoall_plan,
                    stream=stream, workspace=None, ptr_table=ptr_table)


def ring_bcast_pass(srcs: Sequence[torch.Tensor],
                    dsts: Sequence[torch.Tensor],
                    op: Optional[ReductionOp] = None, *, root: int = 0,
                    stream=None, workspace: Optional[RingWorkspace] = None,
                    ptr_table: Optional[torch.Tensor] = None) -> RingLaunch:
    """Bcast of ``srcs[root]`` into ``dsts`` (c each), for the counts that
    the TPU's one-pass kernel takes; ``op`` and ``workspace`` are
    ignored."""
    h = _bcast(K_BCAST_PASS, srcs, dsts, root, stream, ptr_table)
    if h is None:
        return RingLaunch()
    ring_bcast_pass.launches += 1
    return h


def ring_bcast_chunked(srcs: Sequence[torch.Tensor],
                       dsts: Sequence[torch.Tensor],
                       op: Optional[ReductionOp] = None, *, root: int = 0,
                       stream=None, workspace: Optional[RingWorkspace] = None,
                       ptr_table: Optional[torch.Tensor] = None
                       ) -> RingLaunch:
    """Bcast of ``srcs[root]`` into ``dsts`` (c each), for the counts that
    the TPU's chunked kernel takes; ``op`` and ``workspace`` are
    ignored."""
    h = _bcast(K_BCAST_CHUNKED, srcs, dsts, root, stream, ptr_table)
    if h is None:
        return RingLaunch()
    ring_bcast_chunked.launches += 1
    return h


def ring_alltoall_pass(srcs: Sequence[torch.Tensor],
                       dsts: Sequence[torch.Tensor],
                       op: Optional[ReductionOp] = None, *, root: int = 0,
                       stream=None, workspace: Optional[RingWorkspace] = None,
                       ptr_table: Optional[torch.Tensor] = None
                       ) -> RingLaunch:
    """Pairwise alltoall of ``srcs`` (n·b each) into ``dsts`` (n·b each),
    for the counts that the TPU's one-pass kernel takes; ``op``, ``root``
    and ``workspace`` are ignored."""
    h = _alltoall(K_A2A_PASS, srcs, dsts, stream, ptr_table)
    if h is None:
        return RingLaunch()
    ring_alltoall_pass.launches += 1
    return h


def ring_alltoall_chunked(srcs: Sequence[torch.Tensor],
                          dsts: Sequence[torch.Tensor],
                          op: Optional[ReductionOp] = None, *, root: int = 0,
                          stream=None,
                          workspace: Optional[RingWorkspace] = None,
                          ptr_table: Optional[torch.Tensor] = None
                          ) -> RingLaunch:
    """Pairwise alltoall of ``srcs`` (n·b each) into ``dsts`` (n·b each),
    for the counts that the TPU's chunked kernel takes; ``op``, ``root``
    and ``workspace`` are ignored."""
    h = _alltoall(K_A2A_CHUNKED, srcs, dsts, stream, ptr_table)
    if h is None:
        return RingLaunch()
    ring_alltoall_chunked.launches += 1
    return h


ring_bcast_pass.launches = 0
ring_bcast_chunked.launches = 0
ring_alltoall_pass.launches = 0
ring_alltoall_chunked.launches = 0
