"""RankMesh — the ranks of a named device mesh, in one process.

The counterpart of ``jax.make_mesh`` together with the axis binding that
``shard_map`` gives the JAX package's ``ops`` (its examples reach both
through ``utils/jaxshim.shard_map_compat``, which is JAX-only and has no
port). A ``RankMesh({"dp": 2, "sp": 4})`` holds one lib and one context per
rank, all in this process and on one device, bootstrapped as
``tools/perftest.InProcJob`` bootstraps its job. Ranks are numbered
row-major over the axes, as ``jax.make_mesh`` orders its devices, and
``ops`` takes one tensor per rank in that order.

For an axis name, or a tuple of names, the ranks split into groups: the
ranks that differ only in those axes' coordinates. Inside a group a rank's
index (``axis_index``) is row-major over the named axes in the tuple's
order, as JAX linearizes a tuple of axes, so an allgather over
``("sp", "dp")`` concatenates sp-major. The mesh creates one library team
per group the first time an axis is used and keeps it: every context
creates its teams in the same order, so the team ids its counter hands out
agree with its peers'.

``device`` goes to every device TL through the libs' config
(``TL_RING_CUDA_DEVICE``), not through the environment: ``cuda`` (the
default, cuda:0) raises ERR_NO_RESOURCE without a GPU; ``cpu`` runs the
collectives' plain versions, for tests. TUNE strings are read from the
environment when a team is created (``UCC_TL_RING_CUDA_TUNE``,
``UCC_TL_TORCH_OPS_TUNE``), so they apply to the axes first used after
they are set. ``destroy()`` frees the teams and contexts.
"""
from __future__ import annotations

import itertools
import math
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .api.types import ContextParams, TeamParams
from .core.context import Context
from .core.lib import init
from .core.oob import ThreadOobWorld
from .status import Status, UccError
from .tl.device import resolve_device

Axis = Union[str, Sequence[str]]

#: live meshes by handle: the int that ``ops``' custom ops carry
_MESHES: Dict[int, "RankMesh"] = {}
_HANDLES = itertools.count(1)
#: seconds a context or team creation, or a collective, may take
CREATE_TIMEOUT = 120.0


def mesh_of(handle: int) -> "RankMesh":
    """The live mesh a handle names."""
    try:
        return _MESHES[handle]
    except KeyError:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"no live RankMesh has handle {handle}") from None


class RankMesh:
    """Named axes over ranks of one process and one device."""

    def __init__(self, axes: Mapping[str, int], *, device: str = "cuda"):
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Tuple[int, ...] = tuple(int(v) for v in axes.values())
        if not self.axis_names or min(self.shape) < 1 or \
                len(set(self.axis_names)) != len(self.axis_names):
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"a mesh needs distinct axis names of size >= 1, "
                           f"got {dict(axes)}")
        self.size = math.prod(self.shape)
        self.device = resolve_device(device)
        #: rank -> its coordinate on each axis
        self._ranks = np.arange(self.size).reshape(self.shape)
        #: normalized axes -> (groups of ranks, teams of each group)
        self._teams: Dict[Tuple[str, ...], Tuple[List[List[int]],
                                                 List[list]]] = {}
        self.contexts: List[Optional[Context]] = [None] * self.size
        world = ThreadOobWorld(self.size)
        libs = [init(TL_RING_CUDA_DEVICE=str(self.device))
                for _ in range(self.size)]
        errs: List[BaseException] = []

        def make(r):
            try:
                self.contexts[r] = Context(
                    libs[r], ContextParams(oob=world.endpoint(r)))
            except Exception as e:  # noqa: BLE001 - re-raised below
                errs.append(e)

        threads = [threading.Thread(target=make, args=(r,))
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=CREATE_TIMEOUT)
        if errs or any(c is None for c in self.contexts):
            self.destroy()
            if errs:
                raise errs[0]
            raise UccError(Status.ERR_TIMED_OUT, "mesh context create "
                           f"took more than {CREATE_TIMEOUT} s")
        self.handle = next(_HANDLES)
        _MESHES[self.handle] = self

    # -- axes ------------------------------------------------------------
    def axes(self, axis: Axis) -> Tuple[str, ...]:
        """An axis name or tuple of names as a tuple of this mesh's axes."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        bad = [a for a in names if a not in self.axis_names]
        if not names or bad or len(set(names)) != len(names):
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"axis {axis!r} is not a set of distinct axes of "
                           f"the mesh {self.axis_names}")
        return names

    def axis_size(self, axis: Axis) -> int:
        n = 1
        for a in self.axes(axis):
            n *= self.shape[self.axis_names.index(a)]
        return n

    def groups(self, axis: Axis) -> List[List[int]]:
        """The ranks of each group of ``axis``, each group in its own
        index order (row-major over the named axes in order), the groups
        row-major over the other axes."""
        names = self.axes(axis)
        order = [i for i, a in enumerate(self.axis_names)
                 if a not in names] + [self.axis_names.index(a)
                                       for a in names]
        k = self.axis_size(names)
        return self._ranks.transpose(order).reshape(-1, k).tolist()

    def axis_index(self, rank: int, axis: Axis) -> int:
        """``lax.axis_index(axis)`` of ``rank``: its index in its group."""
        names = self.axes(axis)
        coords = np.unravel_index(rank, self.shape)
        idx = 0
        for a in names:
            i = self.axis_names.index(a)
            idx = idx * self.shape[i] + int(coords[i])
        return idx

    # -- teams -------------------------------------------------------------
    def teams(self, axis: Axis) -> Tuple[List[List[int]], List[list]]:
        """(groups, teams): each group's ranks and, beside them, its library
        team on each of those ranks' contexts, team rank = index in the
        group. Created on first use, then kept."""
        names = self.axes(axis)
        if names not in self._teams:
            if self.contexts and self.contexts[0] is None:
                raise UccError(Status.ERR_INVALID_PARAM,
                               "the mesh was destroyed")
            groups = self.groups(names)
            teams = []
            # every context creates its team of this axis now, in the
            # order of the groups: team ids stay in step across contexts
            for group in groups:
                world = ThreadOobWorld(len(group))
                teams.append([self.contexts[r].create_team_post(
                    TeamParams(oob=world.endpoint(i)))
                    for i, r in enumerate(group)])
            flat = [t for ts in teams for t in ts]
            self.progress_until(lambda: all(
                [t.create_test() != Status.IN_PROGRESS for t in flat]))
            failed = [t.create_test() for t in flat
                      if t.create_test() != Status.OK]
            if failed:
                for t in flat:
                    t.destroy()
                raise UccError(failed[0], f"team create over {names} "
                               f"failed: {failed[0].name}")
            self._teams[names] = (groups, teams)
        return self._teams[names]

    def progress_until(self, cond, what: str = "mesh") -> None:
        """Progress every context until ``cond()`` holds."""
        deadline = time.monotonic() + CREATE_TIMEOUT
        while not cond():
            for c in self.contexts:
                c.progress()
            if time.monotonic() > deadline:
                raise UccError(Status.ERR_TIMED_OUT, f"{what} did not "
                               f"complete in {CREATE_TIMEOUT} s")

    # -- placement ---------------------------------------------------------
    def _spec(self, spec, ndim):
        spec = tuple(spec) + (None,) * (ndim - len(spec))
        if len(spec) != ndim:
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"spec {spec} has more entries than the "
                           f"tensor's {ndim} dimensions")
        return [None if s is None else self.axes(s) for s in spec]

    def shard(self, x: torch.Tensor, spec: Sequence[Optional[Axis]]
              ) -> List[torch.Tensor]:
        """One new contiguous tensor per rank on the mesh's device: ``x`` split
        as a ``PartitionSpec`` splits it (entry d: None, an axis or a tuple
        of axes sharding dimension d; missing entries are None)."""
        dims = self._spec(spec, x.dim())
        out = []
        for r in range(self.size):
            t = x
            for d, names in enumerate(dims):
                if names is not None:
                    k = self.axis_size(names)
                    if t.shape[d] % k:
                        raise UccError(Status.ERR_INVALID_PARAM,
                                       f"dimension {d} ({t.shape[d]}) does "
                                       f"not divide over {names} ({k})")
                    b = t.shape[d] // k
                    t = t.narrow(d, self.axis_index(r, names) * b, b)
            # a copy of its own, even where the block is the whole tensor
            out.append(torch.empty(t.shape, dtype=t.dtype,
                                   device=self.device).copy_(t))
        return out

    def unshard(self, xs: Sequence[torch.Tensor],
                spec: Sequence[Optional[Axis]]) -> torch.Tensor:
        """The inverse of ``shard``: the global tensor that the ranks'
        blocks make up. A dimension that no axis shards is taken from the
        lowest rank that holds each block, as ``shard_map``'s out_specs
        take a replicated result from one device."""
        dims = self._spec(spec, xs[0].dim())
        names = [n for d in dims if d is not None for n in d]
        if len(set(names)) != len(names):
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"spec {spec} names an axis twice")
        shape = [s * (1 if d is None else self.axis_size(d))
                 for s, d in zip(xs[0].shape, dims)]
        out = xs[0].new_empty(shape)
        seen = set()
        for r, t in enumerate(xs):
            key = tuple(None if d is None else self.axis_index(r, d)
                        for d in dims)
            if key in seen:
                continue
            seen.add(key)
            view = out
            for d, i in enumerate(key):
                if i is not None:
                    view = view.narrow(d, i * t.shape[d], t.shape[d])
            view.copy_(t)
        return out

    # -- lifetime ----------------------------------------------------------
    def destroy(self) -> None:
        """Destroy every team, then every context. Idempotent."""
        for _, teams in self._teams.values():
            for ts in teams:
                for t in ts:
                    t.destroy()
        self._teams.clear()
        for c in self.contexts:
            if c is not None:
                c.destroy()
        self.contexts = [None] * self.size
        _MESHES.pop(getattr(self, "handle", None), None)

    def __enter__(self) -> "RankMesh":
        return self

    def __exit__(self, *exc) -> None:
        self.destroy()

    def __repr__(self) -> str:
        return (f"RankMesh({dict(zip(self.axis_names, self.shape))}, "
                f"device={self.device})")
