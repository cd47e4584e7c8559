"""Reference workload: a DP×TP sharded training step on the library's
collectives, the port of ``ucc_tpu/examples/dp_tp_training.py``.

A two-layer MLP trained with data parallelism × tensor parallelism over a
``mesh.RankMesh`` with axes ("dp", "tp"), every communication through
``ops``:

  - TP: the row-parallel matmul's partial sums reduced across ``tp`` with
    ``ops.allreduce`` (SUM);
  - DP: the loss and the gradients averaged across ``dp`` with
    ``ops.allreduce`` (AVG), the allreduce-in-the-optimizer pattern.

The backward is written out by hand, as in the JAX package, so that the
collectives' placement is explicit (megatron-style TP).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import ops
from ..constants import ReductionOp
from ..mesh import RankMesh
from ..tl.device import resolve_device

Tensors = List[torch.Tensor]

#: the JAX package's init scale
INIT_STD = 0.02
#: shardings of w1 (column-parallel), w2 (row-parallel) and x, y
W1_SPEC, W2_SPEC, X_SPEC = (None, "tp"), ("tp", None), ("dp", None)


def init_params(d_model: int, d_hidden: int, *,
                generator: Optional[torch.Generator] = None,
                device: str = "cuda"):
    """w1 (d_model, d_hidden) and w2 (d_hidden, d_model), float32 normal
    with std 0.02, drawn from ``generator`` (a fresh one seeded 0 when
    None, on ``device``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    w1 = torch.randn(d_model, d_hidden, generator=generator, device=dev)
    w2 = torch.randn(d_hidden, d_model, generator=generator, device=dev)
    return {"w1": w1 * INIT_STD, "w2": w2 * INIT_STD}


def _gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """The derivative of the tanh approximation of gelu (jax.nn.gelu's
    default)."""
    c = math.sqrt(2.0 / math.pi)
    t = torch.tanh(c * (x + 0.044715 * x ** 3))
    return 0.5 * (1 + t) + 0.5 * x * (1 - t ** 2) * c * \
        (1 + 3 * 0.044715 * x ** 2)


def make_train_step(mesh: RankMesh, lr: float = 1e-2):
    """The DP×TP train step over mesh axes ("dp", "tp").

    ``step(w1s, w2s, xs, ys) -> (w1s, w2s, losses)`` takes each rank's
    shards: w1 on P(None, "tp") (column-parallel), w2 on P("tp", None)
    (row-parallel), x and y on P("dp", None) (``mesh.shard`` with
    ``W1_SPEC``, ``W2_SPEC``, ``X_SPEC``); it returns the updated shards and
    every rank's (1, 1) loss, the mean over the data ranks.
    """

    @torch.no_grad()
    def step(w1s: Sequence[torch.Tensor], w2s: Sequence[torch.Tensor],
             xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor]
             ) -> Tuple[Tensors, Tensors, Tensors]:
        # forward: column-parallel w1 -> local gelu -> row-parallel w2
        pre = [x @ w1 for x, w1 in zip(xs, w1s)]        # (b_local, hid/tp)
        h = [F.gelu(p, approximate="tanh") for p in pre]
        outs = ops.allreduce([a @ w2 for a, w2 in zip(h, w2s)],
                             ReductionOp.SUM, mesh=mesh, axis_name="tp")
        diffs = [o - y for o, y in zip(outs, ys)]
        losses = ops.allreduce([(d ** 2).mean().reshape(1, 1)
                                for d in diffs], ReductionOp.AVG,
                               mesh=mesh, axis_name="dp")
        # backward, written out so the collectives' placement is explicit
        dw1s, dw2s = [], []
        for x, w2, a, p, d in zip(xs, w2s, h, pre, diffs):
            dout = 2.0 * d / d.numel()
            dh = dout @ w2.T
            dw2s.append(a.T @ dout)
            dw1s.append(x.T @ (dh * _gelu_grad(p)))
        # DP gradient sync: the mean over the data axis
        dw1s = ops.allreduce(dw1s, ReductionOp.AVG, mesh=mesh,
                             axis_name="dp")
        dw2s = ops.allreduce(dw2s, ReductionOp.AVG, mesh=mesh,
                             axis_name="dp")
        return ([w - lr * g for w, g in zip(w1s, dw1s)],
                [w - lr * g for w, g in zip(w2s, dw2s)], losses)

    return step


def run_one_step(mesh: RankMesh, batch: int = 8, d_model: int = 16,
                 d_hidden: int = 32) -> float:
    """Place sharded inputs (x ones, y zeros) and run a single step on the
    mesh's device; returns the loss."""
    dev = mesh.device
    params = init_params(d_model, d_hidden, device=str(dev))
    x = torch.ones(batch, d_model, device=dev)
    y = torch.zeros(batch, d_model, device=dev)
    _, _, losses = make_train_step(mesh)(
        mesh.shard(params["w1"], W1_SPEC), mesh.shard(params["w2"], W2_SPEC),
        mesh.shard(x, X_SPEC), mesh.shard(y, X_SPEC))
    return float(losses[0][0, 0])
