"""Reference workload: expert-parallel MoE token routing on the library,
the port of ``ucc_tpu/examples/moe_ep.py``.

Every rank of the ``ep`` axis of a ``mesh.RankMesh`` holds a shard of the
batch and one expert (a distinct MLP). Tokens go to the rank that owns
their expert, are processed and come back: the dispatch and combine
exchanges are ``ops.alltoall``. Capacity-style routing keeps the shapes
static, as in the JAX package: every (source rank, expert) pair exchanges a
block of ``capacity`` slots, padded with zeros, and tokens beyond an
expert's capacity from one source are dropped (their output is zero).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .. import ops
from ..mesh import RankMesh


def _expert(x: torch.Tensor, w_up: torch.Tensor,
            w_dn: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ w_up, approximate="tanh") @ w_dn


def make_moe_layer(mesh: RankMesh, d_model: int, capacity: int,
                   axis: str = "ep") -> Callable:
    """An expert-parallel MoE layer over the ``axis`` of ``mesh`` (n ranks,
    one expert each). Returns ``fn(x, w_up, w_dn, assign) -> y`` with x
    (n·tokens_local, d_model) and assign (n·tokens_local,), each token's
    expert id, sharded over ``axis``; w_up (n, d_model, h) and w_dn (n, h,
    d_model), expert e on index e; y (n·tokens_local, d_model)."""
    n = mesh.axis_size(axis)

    def pack(x, assign):
        # x: (tokens_local, d); assign: (tokens_local,)
        d = x.shape[1]
        # 1. each token's position in its expert's block; pack the kept
        #    ones into (n, capacity, d) slots
        onehot = F.one_hot(assign.long(), n)
        pos = ((onehot.cumsum(0) - 1) * onehot).sum(1)
        keep = pos < capacity
        dispatch = x.new_zeros(n, capacity, d)
        dispatch.index_put_((assign[keep].long(), pos[keep]), x[keep],
                            accumulate=True)
        return dispatch.reshape(1, n * capacity * d), pos, keep

    def fn(x, w_up, w_dn, assign):
        d = x.shape[1]
        xs, ups, dns, assigns = (mesh.shard(t, (axis,))
                                 for t in (x, w_up, w_dn, assign))
        packed = [pack(t, a) for t, a in zip(xs, assigns)]
        # 2. route: each expert receives its capacity block from every rank
        routed = ops.alltoall([p[0] for p in packed], mesh=mesh,
                              axis_name=axis)
        # 3. this rank's expert
        outs = [_expert(r.reshape(n, capacity, d), up[0], dn[0])
                .reshape(1, n * capacity * d)
                for r, up, dn in zip(routed, ups, dns)]
        # 4. combine: results back, unpacked to token order (a dropped
        #    token reads a clipped slot, zeroed by keep)
        combined = ops.alltoall(outs, mesh=mesh, axis_name=axis)
        ys = []
        for c, a, (_, pos, keep) in zip(combined, assigns, packed):
            c = c.reshape(n, capacity, d)
            ys.append(c[a.long(), pos.clamp(max=capacity - 1)] *
                      keep[:, None].to(c.dtype))
        return mesh.unshard(ys, (axis,))

    return fn


def reference_moe(x, w_up, w_dn, assign, capacity: int) -> torch.Tensor:
    """Unsharded reference: each token through its assigned expert; tokens
    beyond an expert's per-source capacity give zeros. The kept tokens are
    found on the host, then each expert runs once over all of its own."""
    n = w_up.shape[0]
    per = x.shape[0] // n
    owner = [int(e) for e in assign.tolist()]
    kept = [[] for _ in range(n)]            # expert -> its kept tokens
    for dev in range(n):
        counts = [0] * n
        for t in range(dev * per, (dev + 1) * per):
            e = owner[t]
            if counts[e] < capacity:
                kept[e].append(t)
            counts[e] += 1
    y = torch.zeros_like(x)
    for e, tokens in enumerate(kept):
        if tokens:
            idx = torch.tensor(tokens, device=x.device)
            y[idx] = _expert(x[idx], w_up[e], w_dn[e])
    return y
