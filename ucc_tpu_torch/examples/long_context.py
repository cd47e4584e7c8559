"""Long-context training: SP ring attention × DP gradient sync, the port
of ``ucc_tpu/examples/long_context.py``.

Two attention "models" whose sequence axis is sharded over the ``sp`` axis
of a ``mesh.RankMesh`` and whose batch is sharded over ``dp``: the MHA
block (``init_params``, ``make_train_step``, ``run_one_step``; x of shape
(batch, heads, seq, d), per-head projections) and the GQA token-stream
block (``init_gqa_params``, ``make_gqa_train_step``; x of shape (batch,
seq, dm), wq (dm, heads·e), wk and wv (dm, kv_heads·e), wo (heads·e, dm)).
No RoPE, norm or MLP, as in the JAX package.

A train step runs, over every rank of the mesh:
  - the per-rank loss, mean((out - y)²) of its block, averaged over the
    sequence and data ranks with ``ops.allreduce(AVG, ("sp", "dp"))``,
    differentiably;
  - attention as ``fused_attention.ring_flash_attention`` over each sp
    ring of the mesh: forward through the CUDA kernel on GPU tensors (the
    f32 route for the f32 steps), backward by recompute one query rank at
    a time;
  - one ``ops.allreduce(AVG, axis_name=("sp", "dp"))`` per weight through
    the library (weight gradients are per-rank partials: the ring
    backward aggregates dK/dV, never weight gradients), and the SGD
    update.
Every rank holds its own replica of the weights; the replicas stay bitwise
equal, because every rank's gradient is the same allreduce result.

``GqaRingAttentionBlock`` is the GQA block's forward as a module over one
ring of ranks, with one set of weights.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import ops
from ..constants import ReductionOp
from ..fused_attention import ring_flash_attention
from ..mesh import RankMesh
from ..tl.device import resolve_device

Tensors = List[torch.Tensor]
#: weights name -> one replica per rank of the mesh
Replicas = Dict[str, Tensors]

#: the weights of both blocks, in the JAX steps' argument order
WEIGHTS = ("wq", "wk", "wv", "wo")
#: the axes that the loss and the weight gradients are averaged over
JOINT = ("sp", "dp")

#: the JAX package's init scale (init_gqa_params)
INIT_STD = 0.1


def init_gqa_params(dm: int, heads: int, kv_heads: int, e: int, *,
                    generator: Optional[torch.Generator] = None,
                    dtype: torch.dtype = torch.float32,
                    device: str = "cuda") -> Dict[str, torch.Tensor]:
    """Token-stream projections, normal with std 0.1: wq (dm, heads·e),
    wk and wv (dm, kv_heads·e), wo (heads·e, dm). Drawn in float32 from
    ``generator`` (which must live on ``device``; a fresh one seeded 0 when
    None), then cast to ``dtype``. ``device`` defaults to cuda, which
    raises ERR_NO_RESOURCE when there is no GPU."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def normal(rows, cols):
        w = torch.randn(rows, cols, generator=generator, device=dev)
        return (w * INIT_STD).to(dtype)

    return {"wq": normal(dm, heads * e), "wk": normal(dm, kv_heads * e),
            "wv": normal(dm, kv_heads * e), "wo": normal(heads * e, dm)}


def params_from_jax(params, *, device: str = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter dict, MHA or GQA (arrays of any kind
    numpy can read), as the port's float32 tensors, so both run on the
    same weights."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(w, dtype=np.float32)).to(dev)
            for name, w in params.items()}


def init_params(heads: int, d: int, *,
                generator: Optional[torch.Generator] = None,
                device: str = "cuda") -> Dict[str, torch.Tensor]:
    """The MHA block's per-head projections wq, wk, wv, wo, each (heads, d,
    d), float32 normal with std 0.1 (the JAX package's init scale), drawn
    from ``generator`` as ``init_gqa_params`` draws them."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return {name: torch.randn(heads, d, d, generator=generator,
                              device=dev) * INIT_STD for name in WEIGHTS}


def replicate(params: Dict[str, torch.Tensor], mesh: RankMesh) -> Replicas:
    """One copy of every weight per rank of the mesh, on its device."""
    return {name: mesh.shard(w, ()) for name, w in params.items()}


# ---------------------------------------------------------------------------
# the GQA block's fold and merge (shared by the module and the train step)
# ---------------------------------------------------------------------------

def gqa_fold(t: torch.Tensor, heads: int, e: int) -> torch.Tensor:
    """(b, s, heads·e) -> (b·heads, s, e), contiguous (at b = 1 the reshape
    alone would be a strided view). Folded q head bi·heads + hi reads
    folded kv head bi·kv_heads + hi // (heads/kv_heads): the kernel's
    grouping."""
    b, s, _ = t.shape
    return t.reshape(b, s, heads, e).transpose(1, 2).contiguous() \
        .view(b * heads, s, e)


def gqa_merge(a: torch.Tensor, wo: torch.Tensor, batch: int, heads: int,
              e: int) -> torch.Tensor:
    """One rank's attention (batch·heads, s, e) unfolded to (batch, s,
    heads·e) and projected through wo."""
    s = a.shape[1]
    return a.reshape(batch, heads, s, e).transpose(1, 2) \
        .reshape(batch, s, heads * e) @ wo


class GqaRingAttentionBlock(nn.Module):
    """The GQA block over a ring of ranks: ``forward(xs)`` takes one
    (batch, seq_local, dm) block per rank, in sequence order, and returns
    one (batch, seq_local, dm) output per rank."""

    def __init__(self, params: Dict[str, torch.Tensor], heads: int,
                 kv_heads: int, e: int, *, causal: bool = True):
        super().__init__()
        if heads % kv_heads != 0:
            raise ValueError(f"heads ({heads}) must divide by kv_heads "
                             f"({kv_heads})")
        self.heads, self.kv_heads, self.e = heads, kv_heads, e
        self.causal = causal
        for name in WEIGHTS:
            setattr(self, name, nn.Parameter(params[name]))

    def project(self, xs: Sequence[torch.Tensor]
                ) -> Tuple[Tensors, Tensors, Tensors]:
        """q, k and v of every rank, each batch folded into the head axis
        (``gqa_fold``): (batch·heads, seq_local, e) and (batch·kv_heads,
        seq_local, e)."""
        return ([gqa_fold(x @ self.wq, self.heads, self.e) for x in xs],
                [gqa_fold(x @ self.wk, self.kv_heads, self.e) for x in xs],
                [gqa_fold(x @ self.wv, self.kv_heads, self.e) for x in xs])

    def merge(self, attns: Sequence[torch.Tensor], batch: int) -> Tensors:
        """Each rank's attention unfolded and projected through wo."""
        return [gqa_merge(a, self.wo, batch, self.heads, self.e)
                for a in attns]

    def forward(self, xs: Sequence[torch.Tensor]) -> Tensors:
        qs, ks, vs = self.project(xs)
        attns = ring_flash_attention(qs, ks, vs, causal=self.causal)
        return self.merge(attns, xs[0].shape[0])


def gqa_loss(block: GqaRingAttentionBlock, xs: Sequence[torch.Tensor],
             ys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global mean of (out - y)² over every rank's block: what
    ``make_gqa_train_step`` returns as its loss."""
    outs = block(xs)
    total = sum(((o - y) ** 2).sum() for o, y in zip(outs, ys))
    return total / sum(y.numel() for y in ys)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

#: make_loss(weights, xs, ys) -> every rank's local loss, a 0-d tensor;
#: weights maps each name of WEIGHTS to one leaf tensor per rank
LossFn = Callable[[Replicas, Sequence[torch.Tensor],
                   Sequence[torch.Tensor]], Tensors]


class TrainStep:
    """One SGD step over every rank of ``mesh`` (the shared scaffolding of
    ``_make_step`` in the JAX package): per-rank loss -> its AVG over
    ("sp", "dp") -> backward, each rank's loss seeded with 1 as JAX's
    per-shard ``value_and_grad`` seeds it -> one joint-axis AVG of each
    weight's gradient through the library -> update.

    ``step(params, xs, ys)`` takes each weight's per-rank replicas and
    each rank's blocks of x and y, and returns (losses, new params): every
    rank's copy of the global mean loss, a 0-d tensor, and the new
    replicas. For inspection: with ``timed`` set, ``last`` holds the split
    of the last step's time (seconds on the host clock, CUDA work
    synchronised at each mark: forward, backward, grad_avg, update); with
    ``keep_grads`` set, ``grads`` holds its averaged gradients (one per
    rank, as the update used them)."""

    def __init__(self, mesh: RankMesh, make_loss: LossFn, lr: float):
        self.mesh, self.make_loss, self.lr = mesh, make_loss, float(lr)
        self.timed = self.keep_grads = False
        self.last: Dict[str, float] = {}
        self.grads: Optional[Replicas] = None

    def _now(self) -> float:
        if self.timed and self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        return time.perf_counter()

    def _mark(self, name: str, t0: float) -> float:
        if not self.timed:
            return t0
        now = self._now()
        self.last[name] = now - t0
        return now

    def __call__(self, params: Replicas, xs: Sequence[torch.Tensor],
                 ys: Sequence[torch.Tensor]) -> Tuple[Tensors, Replicas]:
        mesh = self.mesh
        t = self._now()
        leaves = {k: [w.detach().requires_grad_() for w in params[k]]
                  for k in WEIGHTS}
        local = self.make_loss(leaves, xs, ys)
        losses = [v[0] for v in ops.allreduce(
            [v.reshape(1) for v in local], ReductionOp.AVG, mesh=mesh,
            axis_name=JOINT)]
        t = self._mark("forward", t)
        torch.autograd.backward(losses, [torch.ones_like(v) for v in losses])
        t = self._mark("backward", t)
        grads = {k: ops.allreduce([w.grad for w in leaves[k]],
                                  ReductionOp.AVG, mesh=mesh,
                                  axis_name=JOINT) for k in WEIGHTS}
        t = self._mark("grad_avg", t)
        self.grads = grads if self.keep_grads else None
        with torch.no_grad():
            new = {k: [w.detach() - self.lr * g
                       for w, g in zip(params[k], grads[k])]
                   for k in WEIGHTS}
        self._mark("update", t)
        return [v.detach() for v in losses], new


def make_train_step(mesh: RankMesh, lr: float = 1e-2,
                    causal: bool = True) -> TrainStep:
    """The MHA train step over mesh axes ("dp", "sp").

    xs, ys: each rank's block of x, y (batch, heads, seq, d), batch
    sharded on "dp" and seq on "sp" (``mesh.shard(x, ("dp", None, "sp"))``);
    params: per-rank replicas of ``init_params``'s weights.
    """

    def make_loss(w: Replicas, xs, ys) -> Tensors:
        qs, ks, vs = [], [], []
        for r, x in enumerate(xs):
            b, h, s_loc, e = x.shape
            # per-head projections; heads are independent in the kernel,
            # so the local batch folds into the head axis
            for out, name in ((qs, "wq"), (ks, "wk"), (vs, "wv")):
                out.append(torch.einsum("bhsd,hde->bhse", x, w[name][r])
                           .reshape(b * h, s_loc, e).contiguous())
        attns = ring_flash_attention(qs, ks, vs, causal=causal, mesh=mesh,
                                     axis_name="sp")
        local = []
        for r, (a, x, y) in enumerate(zip(attns, xs, ys)):
            out = torch.einsum("bhse,hed->bhsd", a.reshape(x.shape),
                               w["wo"][r])
            local.append(((out - y) ** 2).mean())
        return local

    return TrainStep(mesh, make_loss, lr)


def run_one_step(mesh: RankMesh, batch: int, heads: int, seq: int, d: int,
                 causal: bool = True) -> float:
    """Convenience: init (seed 0), tokens (seed 7, as the JAX package's
    key), shard, run one MHA step on the mesh's device; returns the
    loss."""
    dev = mesh.device
    params = init_params(heads, d, device=str(dev))
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(batch, heads, seq, d, generator=gen, device=dev)
    y = torch.randn(batch, heads, seq, d, generator=gen, device=dev)
    spec = ("dp", None, "sp")
    losses, _ = make_train_step(mesh, causal=causal)(
        replicate(params, mesh), mesh.shard(x, spec), mesh.shard(y, spec))
    return float(losses[0])


def make_gqa_train_step(mesh: RankMesh, heads: int, kv_heads: int, e: int,
                        lr: float = 1e-2, causal: bool = True) -> TrainStep:
    """The GQA train step over mesh axes ("dp", "sp").

    xs, ys: each rank's block of x, y (batch, seq, dm), batch on "dp" and
    seq on "sp" (``mesh.shard(x, ("dp", "sp"))``); params: per-rank
    replicas of ``init_gqa_params``'s weights. The ring rotates only
    kv_heads K/V blocks a step, and the batch folds into the head axis
    compatibly with the kernel's grouping (``gqa_fold``).
    """
    if heads % kv_heads != 0:
        raise ValueError(f"heads ({heads}) must divide by kv_heads "
                         f"({kv_heads})")

    def make_loss(w: Replicas, xs, ys) -> Tensors:
        qs = [gqa_fold(x @ w["wq"][r], heads, e) for r, x in enumerate(xs)]
        ks = [gqa_fold(x @ w["wk"][r], kv_heads, e)
              for r, x in enumerate(xs)]
        vs = [gqa_fold(x @ w["wv"][r], kv_heads, e)
              for r, x in enumerate(xs)]
        attns = ring_flash_attention(qs, ks, vs, causal=causal, mesh=mesh,
                                     axis_name="sp")
        return [((gqa_merge(a, w["wo"][r], x.shape[0], heads, e) - y) ** 2)
                .mean() for r, (a, x, y) in enumerate(zip(attns, xs, ys))]

    return TrainStep(mesh, make_loss, lr)
