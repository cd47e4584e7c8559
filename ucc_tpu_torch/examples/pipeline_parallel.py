"""Reference workload: pipeline parallelism (GPipe-style) on the library,
the port of ``ucc_tpu/examples/pipeline_parallel.py``.

Each rank of the ``pp`` axis of a ``mesh.RankMesh`` owns one layer
(stage), and activations stream stage to stage while microbatches fill the
pipeline. The stage-to-stage transfer is ``ops.ring_shift``. The schedule
runs n_micro + n_stages - 1 ticks: at tick t stage s works on microbatch
t - s (and passes its input through outside [0, n_micro)), the last stage
banks its result, everyone shifts right; a final ``ops.allreduce`` (SUM)
over ``pp`` makes the banked outputs, zeros everywhere but on the last
stage, every rank's result.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .. import ops
from ..mesh import RankMesh


def _stage(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ w, approximate="tanh")


def make_pipeline(mesh: RankMesh, n_micro: int, axis: str = "pp"
                  ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Forward pipeline over the ``axis`` of ``mesh``: index s of a group
    applies layer s (gelu(x @ w)). Returns ``fn(x, w) -> y`` with x:
    (n_micro, b, d) input microbatches (replicated); w: (n_stages, d, d),
    sharded over ``axis``; y: (n_micro, b, d), every microbatch through
    every stage."""
    n = mesh.axis_size(axis)

    def fn(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        nm, b, d = x.shape
        if nm != n_micro:
            raise ValueError(f"x holds {nm} microbatches, the pipeline "
                             f"{n_micro}")
        xs = mesh.shard(x, ())
        ws = [t[0] for t in mesh.shard(w, (axis,))]   # my stage's layer
        me = [mesh.axis_index(r, axis) for r in range(mesh.size)]
        outputs = [x.new_zeros(nm, b, d) for x in xs]
        acts = [x.new_zeros(b, d) for x in xs]        # in-flight activation
        for t in range(nm + n - 1):
            ys = []
            for r in range(mesh.size):
                # stage 0 ingests microbatch t; later stages use what
                # arrived
                if me[r] == 0:
                    cur = xs[r][t] if t < nm else xs[r].new_zeros(b, d)
                else:
                    cur = acts[r]
                mb = t - me[r]                        # my microbatch
                active = 0 <= mb < nm
                y = _stage(cur, ws[r]) if active else cur
                if active and me[r] == n - 1:         # the last stage banks
                    outputs[r][mb] = y
                ys.append(y)
            # activations flow to the next stage (the wraparound n-1 -> 0
            # arrival is unused: stage 0 takes the injected microbatch)
            acts = ops.ring_shift(ys, mesh=mesh, axis_name=axis, shift=1)
        # only the last stage banked results: the sum over the axis is the
        # replicated output
        return mesh.unshard(ops.allreduce(outputs, mesh=mesh,
                                          axis_name=axis), ())

    return fn


def reference_pipeline(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Sequential reference: every microbatch through every layer."""
    y = x
    for s in range(w.shape[0]):
        y = _stage(y, w[s])
    return y
