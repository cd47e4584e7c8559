"""The in-graph collective API: the port of ``ucc_tpu/ops.py``.

The JAX package's ``ops`` are collectives on a named mesh axis, called
inside ``shard_map`` on one rank's shard. Here one call takes the shards of
every rank of a ``mesh.RankMesh`` at once: ``xs`` holds one tensor per rank
in mesh order, and the result holds one tensor per rank, shaped as the JAX
function's shard result. ``axis_name`` is an axis of the mesh or a tuple of
axes, as in JAX; the ranks that share the other axes' coordinates form one
group, and a collective runs within each group.

The collectives run through the library: ``allreduce``, ``reduce_scatter``,
``allgather``, ``alltoall``, ``bcast``, ``reduce``, ``gather`` and
``scatter`` post library collectives (``collective_init`` → ``post`` →
``test``) on the mesh's team of each group, with the default selection, so
a TUNE string routes them (``UCC_TL_RING_CUDA_TUNE=allreduce:@ring_cuda:inf``
sends an allreduce to the kernel of ``csrc/ring_allreduce.cu``). Where the
JAX meaning differs from the library's, the JAX meaning holds:

- ``reduce`` and ``gather`` return the result on every rank (they run as
  ALLREDUCE and ALLGATHER);
- ``allgatherv`` and ``alltoallv`` are a padded ALLGATHER and ALLTOALL
  plus the static unpack of the JAX package (not the library's v-types,
  whose gaps and padding differ);
- ``bcast`` and ``scatter`` are the masked sum: the root's values plus
  zero, so a -0.0 at the root arrives as +0.0;
- AVG of an integer type is the integer sum divided by n, in float32;
- ``ring_shift`` rotates the list (a clone per rank: the ranks share one
  device), over a tuple of axes in the mesh's axis order as JAX's
  ppermute; ``allreduce_ring`` folds in the JAX ring's order
  (``tl/torch_ops.allreduce_ring_ops``) without a library collective.

A library collective sees one flat buffer per rank, so an op along the
last axis of ``(..., count)`` (allgather, reduce_scatter, alltoall,
scatter) first moves the rank blocks of that axis to the front.

Each op is a ``torch.library.custom_op`` over ``Tensor[]`` (the mesh goes
as its int handle), so functions of them compile under ``torch.compile``
(``fullgraph=True``), and is differentiable where the JAX function is,
with JAX's transposes under ``shard_map`` without replication checks: SUM
(AVG) allreduce to SUM (AVG) of the cotangents, allgather and
reduce_scatter to each other, alltoall to itself, ``ring_shift(s)`` to
``ring_shift(-s)``, bcast and scatter to a sum at the root. ``barrier``
takes no tensor and is a plain function.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .api.types import BufferInfo, CollArgs
from .constants import (CollType, DataType, MemoryType, ReductionOp,
                        dt_from_torch)
from .mesh import Axis, RankMesh, mesh_of
from .status import Status, UccError
from .tl.torch_ops import allreduce_ring_ops

Tensors = List[torch.Tensor]

_LINEAR = (ReductionOp.SUM, ReductionOp.AVG)


# ---------------------------------------------------------------------------
# running one library collective in every group
# ---------------------------------------------------------------------------

def _axis_key(axis: Axis) -> str:
    return axis if isinstance(axis, str) else ",".join(axis)


def _axes(key: str):
    return tuple(key.split(","))


def _group_size(handle: int, axis: str) -> int:
    return mesh_of(handle).axis_size(_axes(axis))


def _binfo(t: torch.Tensor) -> BufferInfo:
    # device TLs take CPU tensors (device "cpu") as device memory too
    return BufferInfo(t, t.numel(), dt_from_torch(t.dtype),
                      mem_type=MemoryType.CUDA)


def _run(handle: int, axis: str, coll: CollType, make_args) -> None:
    """Post ``coll`` on every group's team (``make_args(rank, index)`` is
    one rank's CollArgs) and progress the mesh until all complete."""
    mesh = mesh_of(handle)
    groups, teams = mesh.teams(_axes(axis))
    reqs = []
    for group, ts in zip(groups, teams):
        for i, (rank, team) in enumerate(zip(group, ts)):
            reqs.append(team.collective_init(make_args(rank, i)))
    try:
        for rq in reqs:
            rq.post()
        # listified: a short-circuiting all() would stop testing the later
        # ranks' requests
        mesh.progress_until(lambda: all(
            [rq.test() != Status.IN_PROGRESS for rq in reqs]),
            f"ops {coll.name} over {axis}")
        bad = [rq.test() for rq in reqs if rq.test() != Status.OK]
        if bad:
            raise UccError(bad[0], f"ops {coll.name} over {axis} failed: "
                           f"{bad[0].name}")
    finally:
        for rq in reqs:
            rq.finalize()


def _check(xs, handle: int) -> None:
    n = mesh_of(handle).size
    if len(xs) != n:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"ops take one tensor per rank of the mesh ({n}), "
                       f"got {len(xs)}")


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(-1)


# ---------------------------------------------------------------------------
# the custom ops (flat per-rank vectors; allreduce keeps shapes)
# ---------------------------------------------------------------------------

@torch.library.custom_op("ucc_tpu_torch::allreduce", mutates_args=())
def _allreduce(xs: List[torch.Tensor], mesh: int, axis: str,
               op: int) -> List[torch.Tensor]:
    _check(xs, mesh)
    srcs = [_flat(x) for x in xs]
    dsts = [torch.empty_like(s) for s in srcs]
    if srcs[0].numel():
        _run(mesh, axis, CollType.ALLREDUCE, lambda r, i: CollArgs(
            coll_type=CollType.ALLREDUCE, op=ReductionOp(op),
            src=_binfo(srcs[r]), dst=_binfo(dsts[r])))
    return [d.view(x.shape) for d, x in zip(dsts, xs)]


@torch.library.custom_op("ucc_tpu_torch::allreduce_ring", mutates_args=())
def _allreduce_ring(xs: List[torch.Tensor], mesh: int, axis: str,
                    op: int) -> List[torch.Tensor]:
    _check(xs, mesh)
    out = [None] * len(xs)
    for group in mesh_of(mesh).groups(_axes(axis)):
        res = allreduce_ring_ops([_flat(xs[r]) for r in group],
                                 ReductionOp(op))
        for r in group:
            out[r] = res.clone().view(xs[r].shape)
    return out


@torch.library.custom_op("ucc_tpu_torch::reduce_scatter", mutates_args=())
def _reduce_scatter(xs: List[torch.Tensor], mesh: int, axis: str,
                    op: int) -> List[torch.Tensor]:
    _check(xs, mesh)
    n = _group_size(mesh, axis)
    dsts = [x.new_empty(x.numel() // n) for x in xs]
    _run(mesh, axis, CollType.REDUCE_SCATTER, lambda r, i: CollArgs(
        coll_type=CollType.REDUCE_SCATTER, op=ReductionOp(op),
        src=_binfo(_flat(xs[r])), dst=_binfo(dsts[r])))
    return dsts


@torch.library.custom_op("ucc_tpu_torch::allgather", mutates_args=())
def _allgather(xs: List[torch.Tensor], mesh: int,
               axis: str) -> List[torch.Tensor]:
    _check(xs, mesh)
    n = _group_size(mesh, axis)
    dsts = [x.new_empty(n * x.numel()) for x in xs]
    _run(mesh, axis, CollType.ALLGATHER, lambda r, i: CollArgs(
        coll_type=CollType.ALLGATHER, src=_binfo(_flat(xs[r])),
        dst=_binfo(dsts[r])))
    return dsts


@torch.library.custom_op("ucc_tpu_torch::alltoall", mutates_args=())
def _alltoall(xs: List[torch.Tensor], mesh: int,
              axis: str) -> List[torch.Tensor]:
    _check(xs, mesh)
    dsts = [torch.empty_like(_flat(x)) for x in xs]
    _run(mesh, axis, CollType.ALLTOALL, lambda r, i: CollArgs(
        coll_type=CollType.ALLTOALL, src=_binfo(_flat(xs[r])),
        dst=_binfo(dsts[r])))
    return dsts


def _plus_zero(t: torch.Tensor) -> torch.Tensor:
    # the masked sum's last add: -0.0 + 0.0 is +0.0, every other value
    # stays as it is
    return t.add_(0) if t.is_floating_point() else t


@torch.library.custom_op("ucc_tpu_torch::bcast", mutates_args=())
def _bcast(xs: List[torch.Tensor], mesh: int, axis: str,
           root: int) -> List[torch.Tensor]:
    _check(xs, mesh)
    bufs = [_flat(x).clone() for x in xs]
    _run(mesh, axis, CollType.BCAST, lambda r, i: CollArgs(
        coll_type=CollType.BCAST, root=root, src=_binfo(bufs[r])))
    return [_plus_zero(b).view(x.shape) for b, x in zip(bufs, xs)]


@torch.library.custom_op("ucc_tpu_torch::scatter", mutates_args=())
def _scatter(xs: List[torch.Tensor], mesh: int, axis: str,
             root: int) -> List[torch.Tensor]:
    _check(xs, mesh)
    n = _group_size(mesh, axis)
    dsts = [x.new_empty(x.numel() // n) for x in xs]
    _run(mesh, axis, CollType.SCATTER, lambda r, i: CollArgs(
        coll_type=CollType.SCATTER, root=root,
        src=_binfo(_flat(xs[r])) if i == root else None,
        dst=_binfo(dsts[r])))
    return [_plus_zero(d) for d in dsts]


@torch.library.custom_op("ucc_tpu_torch::ring_shift", mutates_args=())
def _ring_shift(xs: List[torch.Tensor], mesh: int, axis: str,
                shift: int) -> List[torch.Tensor]:
    _check(xs, mesh)
    m = mesh_of(mesh)
    # JAX's ppermute numbers a tuple of axes in the mesh's axis order,
    # whatever the tuple's order
    ring = sorted(_axes(axis), key=m.axis_names.index)
    out = [None] * len(xs)
    for group in m.groups(ring):
        k = len(group)
        for i, r in enumerate(group):
            out[group[(i + shift) % k]] = xs[r].clone()
    return out


# -- shapes for tracing ------------------------------------------------------

@_allreduce.register_fake
def _(xs, mesh, axis, op):
    return [torch.empty_like(x) for x in xs]


@_allreduce_ring.register_fake
def _(xs, mesh, axis, op):
    return [torch.empty_like(x) for x in xs]


@_reduce_scatter.register_fake
def _(xs, mesh, axis, op):
    n = _group_size(mesh, axis)
    return [x.new_empty(x.numel() // n) for x in xs]


@_allgather.register_fake
def _(xs, mesh, axis):
    n = _group_size(mesh, axis)
    return [x.new_empty(n * x.numel()) for x in xs]


@_alltoall.register_fake
def _(xs, mesh, axis):
    return [x.new_empty(x.numel()) for x in xs]


@_bcast.register_fake
def _(xs, mesh, axis, root):
    return [torch.empty_like(x) for x in xs]


@_scatter.register_fake
def _(xs, mesh, axis, root):
    n = _group_size(mesh, axis)
    return [x.new_empty(x.numel() // n) for x in xs]


@_ring_shift.register_fake
def _(xs, mesh, axis, shift):
    return [torch.empty_like(x) for x in xs]


# -- gradients ---------------------------------------------------------------

def _save_args(ctx, inputs, output):
    # (xs, mesh, axis[, op | root | shift])
    ctx.mesh, ctx.axis = inputs[1], inputs[2]
    ctx.arg = inputs[3] if len(inputs) > 3 else None


def _linear_op(ctx, what: str) -> int:
    if ReductionOp(ctx.arg) not in _LINEAR:
        raise RuntimeError(f"ops.{what} is differentiable for SUM and AVG "
                           f"only, not {ReductionOp(ctx.arg).name}")
    return ctx.arg


def _allreduce_bwd(ctx, grads):
    op = _linear_op(ctx, "allreduce")
    return _allreduce(list(grads), ctx.mesh, ctx.axis, op), None, None, None


def _reduce_scatter_bwd(ctx, grads):
    op = _linear_op(ctx, "reduce_scatter")
    full = _allgather(list(grads), ctx.mesh, ctx.axis)
    if op == ReductionOp.AVG:
        n = _group_size(ctx.mesh, ctx.axis)
        full = [g / n for g in full]
    return full, None, None, None


def _allgather_bwd(ctx, grads):
    return (_reduce_scatter(list(grads), ctx.mesh, ctx.axis,
                            int(ReductionOp.SUM)), None, None)


def _alltoall_bwd(ctx, grads):
    return _alltoall(list(grads), ctx.mesh, ctx.axis), None, None


def _at_root(ctx, grads):
    """Zero but on each group's root: the masked sum's transpose."""
    mesh = mesh_of(ctx.mesh)
    return [g if mesh.axis_index(r, _axes(ctx.axis)) == ctx.arg
            else torch.zeros_like(g) for r, g in enumerate(grads)]


def _bcast_bwd(ctx, grads):
    total = _allreduce(list(grads), ctx.mesh, ctx.axis,
                       int(ReductionOp.SUM))
    return _at_root(ctx, total), None, None, None


def _scatter_bwd(ctx, grads):
    # the blocks are disjoint: their sum at the root is their allgather
    full = _allgather(list(grads), ctx.mesh, ctx.axis)
    return _at_root(ctx, full), None, None, None


def _ring_shift_bwd(ctx, grads):
    return _ring_shift(list(grads), ctx.mesh, ctx.axis, -ctx.arg), None, \
        None, None


for _op, _bwd in ((_allreduce, _allreduce_bwd),
                  (_allreduce_ring, _allreduce_bwd),
                  (_reduce_scatter, _reduce_scatter_bwd),
                  (_allgather, _allgather_bwd),
                  (_alltoall, _alltoall_bwd),
                  (_bcast, _bcast_bwd), (_scatter, _scatter_bwd),
                  (_ring_shift, _ring_shift_bwd)):
    _op.register_autograd(_bwd, setup_context=_save_args)


# ---------------------------------------------------------------------------
# the API
# ---------------------------------------------------------------------------

def _blocks_front(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n·b) as a flat vector of n blocks (..., b), rank block first."""
    c = x.shape[-1]
    if c % n:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"the last axis ({c}) does not divide over {n} ranks")
    return x.reshape(*x.shape[:-1], n, c // n).movedim(-2, 0).reshape(-1)


def _blocks_back(flat: torch.Tensor, lead, n: int) -> torch.Tensor:
    """The inverse of ``_blocks_front``: n flat blocks as (*lead, n·b)."""
    return flat.reshape(n, *lead, -1).movedim(0, -2).reshape(*lead, -1)


def axis_size(*, mesh: RankMesh, axis_name: Axis = "r") -> int:
    return mesh.axis_size(axis_name)


def _int_avg(xs, mesh, key) -> Tensors:
    # the JAX meaning: the integer psum, then a true division by n
    n = mesh.axis_size(_axes(key))
    return [s / n for s in _allreduce(list(xs), mesh.handle, key,
                                      int(ReductionOp.SUM))]


def allreduce(xs: Sequence[torch.Tensor],
              op: ReductionOp = ReductionOp.SUM, *, mesh: RankMesh,
              axis_name: Axis = "r") -> Tensors:
    """Every op of the library (SUM, AVG, MAX, MIN, PROD, the logical,
    bitwise and loc ops) over each group, the result on every rank."""
    key = _axis_key(axis_name)
    if op == ReductionOp.AVG and not xs[0].is_floating_point():
        return _int_avg(xs, mesh, key)
    return _allreduce(list(xs), mesh.handle, key, int(op))


def allreduce_ring(xs: Sequence[torch.Tensor],
                   op: ReductionOp = ReductionOp.SUM, *, mesh: RankMesh,
                   axis_name: Axis = "r") -> Tensors:
    """SUM and AVG in the JAX ring's order (its bits): block j of the last
    axis summed from rank j+1 round to rank j, AVG times 1/n; the last
    axis must divide over the ranks. Other ops are ``allreduce``."""
    if op not in _LINEAR:
        return allreduce(xs, op, mesh=mesh, axis_name=axis_name)
    key = _axis_key(axis_name)
    n = mesh.axis_size(axis_name)
    flats = [_blocks_front(x, n) for x in xs]
    out = _allreduce_ring(flats, mesh.handle, key, int(op))
    return [_blocks_back(o, x.shape[:-1], n) for o, x in zip(out, xs)]


def reduce_scatter(xs: Sequence[torch.Tensor],
                   op: ReductionOp = ReductionOp.SUM, *, mesh: RankMesh,
                   axis_name: Axis = "r") -> Tensors:
    """(..., total) -> (..., total/n): rank i of a group gets block i of
    the reduction along the last axis."""
    key = _axis_key(axis_name)
    n = mesh.axis_size(axis_name)
    flats = [_blocks_front(x, n) for x in xs]
    if op == ReductionOp.AVG and not xs[0].is_floating_point():
        out = [s / n for s in _reduce_scatter(
            flats, mesh.handle, key, int(ReductionOp.SUM))]
    else:
        out = _reduce_scatter(flats, mesh.handle, key, int(op))
    return [o.view(*x.shape[:-1], -1) for o, x in zip(out, xs)]


def allgather(xs: Sequence[torch.Tensor], *, mesh: RankMesh,
              axis_name: Axis = "r") -> Tensors:
    """(..., count) -> (..., n·count): the group's blocks along the last
    axis, in index order."""
    n = mesh.axis_size(axis_name)
    out = _allgather([_flat(x) for x in xs], mesh.handle,
                     _axis_key(axis_name))
    return [_blocks_back(o, x.shape[:-1], n) for o, x in zip(out, xs)]


def alltoall(xs: Sequence[torch.Tensor], *, mesh: RankMesh,
             axis_name: Axis = "r") -> Tensors:
    """(..., n·blk) -> (..., n·blk): block p of rank i's last axis becomes
    block i of rank p's."""
    n = mesh.axis_size(axis_name)
    out = _alltoall([_blocks_front(x, n) for x in xs], mesh.handle,
                    _axis_key(axis_name))
    return [_blocks_back(o, x.shape[:-1], n) for o, x in zip(out, xs)]


def _pad_to(flat: torch.Tensor, size: int) -> torch.Tensor:
    if flat.numel() < size:
        flat = torch.cat([flat, flat.new_zeros(size - flat.numel())])
    return flat[:size]


def allgatherv(xs: Sequence[torch.Tensor], counts: Sequence[int], *,
               mesh: RankMesh, axis_name: Axis = "r") -> Tensors:
    """Static per-rank counts: index i of a group contributes ``counts[i]``
    elements of its flattened x; every rank gets the packed concatenation
    (sum(counts) elements). A padded allgather plus a static unpack."""
    c = [int(v) for v in counts]
    n = len(c)
    maxc = max(1, max(c) if c else 1)
    rows = _allgather([_pad_to(x.reshape(-1), maxc) for x in xs],
                      mesh.handle, _axis_key(axis_name))
    idx = np.concatenate([i * maxc + np.arange(c[i]) for i in range(n)]) \
        if sum(c) else np.empty(0, np.int64)
    idx = torch.as_tensor(idx, dtype=torch.long, device=xs[0].device)
    return [r[idx] for r in rows]


def a2av_index_maps(srows, drows):
    """Static pack/unpack index maps for alltoallv, as the JAX package's
    (``srows[i] = (scounts, sdispls)`` is index i's send layout,
    ``drows[i]`` its receive layout, displacements may have gaps).
    Returns (pidx, uidx, maxblk, max_src, max_span) where
    PIDX[i][p*maxblk+j] = sdispl_i[p]+j and, over the exchanged rows (row
    p = data from index p), UIDX[i][ddispl_i[p]+j] = p*maxblk+j (-1 =
    padding)."""
    n = len(srows)
    maxblk = max((c for sc, _ in srows for c in sc), default=1) or 1
    max_src = max((sum(sc) for sc, _ in srows), default=1) or 1
    max_span = max((max((dd[p] + dc[p] for p in range(n)), default=0)
                    for dc, dd in drows), default=1) or 1
    pidx = np.full((n, n * maxblk), -1, dtype=np.int32)
    for r, (sc, sd) in enumerate(srows):
        for p in range(n):
            pidx[r, p * maxblk:p * maxblk + sc[p]] = \
                np.arange(sd[p], sd[p] + sc[p])
    uidx = np.full((n, max_span), -1, dtype=np.int32)
    for r, (dc, dd) in enumerate(drows):
        for p in range(n):
            uidx[r, dd[p]:dd[p] + dc[p]] = \
                np.arange(p * maxblk, p * maxblk + dc[p])
    return pidx, uidx, maxblk, max_src, max_span


def _take(flat: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    """flat[idx] where idx >= 0, else 0 (idx clipped into [0, size))."""
    got = flat[idx.clamp(0, size - 1)]
    return torch.where(idx >= 0, got, torch.zeros_like(got))


def a2av_exchange(xs: Sequence[torch.Tensor], pidx_c, uidx_c, n: int,
                  maxblk: int, max_src: int, *, mesh: RankMesh,
                  axis_name: Axis = "r") -> Tensors:
    """The alltoallv body over prebuilt index maps: pack each rank's
    flattened x by its row of ``pidx_c`` (its index in its group), one
    alltoall of n·maxblk, unpack by its row of ``uidx_c``."""
    dev = xs[0].device
    pidx = torch.as_tensor(np.asarray(pidx_c), dtype=torch.long, device=dev)
    uidx = torch.as_tensor(np.asarray(uidx_c), dtype=torch.long, device=dev)
    me = [mesh.axis_index(r, axis_name) for r in range(len(xs))]
    packed = [_take(_pad_to(x.reshape(-1), max(max_src, x.numel())),
                    pidx[i], max_src) for x, i in zip(xs, me)]
    rows = _alltoall(packed, mesh.handle, _axis_key(axis_name))
    return [_take(r, uidx[i], n * maxblk) for r, i in zip(rows, me)]


def alltoallv(xs: Sequence[torch.Tensor], counts, *, mesh: RankMesh,
              axis_name: Axis = "r") -> Tensors:
    """Static per-pair counts (``counts[i][j]`` elements from index i to
    index j of a group). Index i's x holds its blocks for 0..n-1 back to
    back, padded to max_i sum_j counts[i][j]; the result is the blocks from
    0..n-1 back to back, padded to max_j sum_i counts[i][j]."""
    m = np.asarray(counts, dtype=np.int64)
    n = m.shape[0]
    sdispl = np.zeros((n, n), dtype=np.int64)
    sdispl[:, 1:] = np.cumsum(m, axis=1)[:, :-1]
    rdispl = np.zeros((n, n), dtype=np.int64)
    rdispl[1:, :] = np.cumsum(m, axis=0)[:-1, :]
    srows = [([int(c) for c in m[i]], [int(d) for d in sdispl[i]])
             for i in range(n)]
    drows = [([int(m[p, i]) for p in range(n)],
              [int(rdispl[p, i]) for p in range(n)]) for i in range(n)]
    pidx, uidx, maxblk, max_src, _ = a2av_index_maps(srows, drows)
    return a2av_exchange(xs, pidx, uidx, n, maxblk, max_src, mesh=mesh,
                         axis_name=axis_name)


def bcast(xs: Sequence[torch.Tensor], root: int, *, mesh: RankMesh,
          axis_name: Axis = "r") -> Tensors:
    """Index ``root``'s shard to every rank of its group (the masked sum:
    -0.0 arrives as +0.0)."""
    return _bcast(list(xs), mesh.handle, _axis_key(axis_name), int(root))


def reduce(xs: Sequence[torch.Tensor], root: int,
           op: ReductionOp = ReductionOp.SUM, *, mesh: RankMesh,
           axis_name: Axis = "r") -> Tensors:
    """An allreduce: the result is on every rank, the root's included."""
    return allreduce(xs, op, mesh=mesh, axis_name=axis_name)


def gather(xs: Sequence[torch.Tensor], root: int, *, mesh: RankMesh,
           axis_name: Axis = "r") -> Tensors:
    """An allgather: the result is on every rank, the root's included."""
    return allgather(xs, mesh=mesh, axis_name=axis_name)


def scatter(xs: Sequence[torch.Tensor], root: int, *, mesh: RankMesh,
            axis_name: Axis = "r") -> Tensors:
    """Index ``root`` holds (..., total); index i of its group gets block i
    of the last axis (the other ranks' xs give only the shape)."""
    n = mesh.axis_size(axis_name)
    out = _scatter([_blocks_front(x, n) for x in xs], mesh.handle,
                   _axis_key(axis_name), int(root))
    return [o.view(*x.shape[:-1], -1) for o, x in zip(out, xs)]


def barrier(*, mesh: RankMesh, axis_name: Axis = "r") -> Tensors:
    """A library BARRIER in every group; each rank gets the JAX result, a
    (1, 1) int32 tensor holding n."""
    key = _axis_key(axis_name)
    _run(mesh.handle, key, CollType.BARRIER, lambda r, i: CollArgs(
        coll_type=CollType.BARRIER, src=BufferInfo(
            None, 0, DataType.UINT8, mem_type=MemoryType.CUDA)))
    n = mesh.axis_size(axis_name)
    return [torch.full((1, 1), n, dtype=torch.int32, device=mesh.device)
            for _ in range(mesh.size)]


def ring_shift(xs: Sequence[torch.Tensor], *, mesh: RankMesh,
               axis_name: Axis = "r", shift: int = 1) -> Tensors:
    """Rotate shards around each group: index i's tensor goes to index
    i + shift. Over a tuple of axes the ring runs row-major in the mesh's
    axis order, whatever the tuple's order, as JAX's ppermute numbers
    them."""
    return _ring_shift(list(xs), mesh.handle, _axis_key(axis_name),
                       int(shift))
