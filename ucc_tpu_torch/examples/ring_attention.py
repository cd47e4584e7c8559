"""Sequence-parallel attention on the library's collectives, the port of
``ucc_tpu/examples/ring_attention.py``.

Two ways to shard the sequence axis over the ranks of an axis of a
``mesh.RankMesh``, in plain torch ops around ``ops`` by design (the fused
kernel is ``fused_attention.ring_flash_attention``):

- the ring (``make_ring_attention``): each step a rank attends its Q
  block to the K/V block in hand, then the K/V blocks rotate one hop with
  ``ops.ring_shift``; a running max and normalizer (flash-attention's
  streaming softmax) make the result exact;
- Ulysses (``make_ulysses_attention``): ``ops.alltoall`` trades the
  sequence sharding for a head sharding (one exchange each for q, k and
  v), each rank runs full attention over its heads, and one more exchange
  trades back.

Both are unmasked, with scale 1/sqrt(d) in the inputs' dtype, as in the
JAX package.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence

import torch

from .. import ops
from ..mesh import RankMesh

Tensors = List[torch.Tensor]


def _scale(d: int, dtype: torch.dtype) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=dtype))


def _ring_attention_shard(qs: Sequence[torch.Tensor],
                          ks: Sequence[torch.Tensor],
                          vs: Sequence[torch.Tensor], *, mesh: RankMesh,
                          axis_name: str) -> Tensors:
    """Ring attention of every rank's q, k, v (heads, seq_local, d): exact
    attention over the whole (sharded) sequence of its group."""
    n = mesh.axis_size(axis_name)
    h, s_local, d = qs[0].shape
    scale = _scale(d, qs[0].dtype).to(qs[0].device)
    acc = [torch.zeros_like(q) for q in qs]
    m_run = [q.new_full((h, s_local), -math.inf) for q in qs]
    l_run = [q.new_zeros(h, s_local) for q in qs]
    k_cur, v_cur = list(ks), list(vs)
    for step in range(n):
        for r, q in enumerate(qs):
            scores = torch.einsum("hqd,hkd->hqk", q, k_cur[r]) * scale
            m_new = torch.maximum(m_run[r], scores.amax(-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m_run[r] - m_new)       # rescale the old acc
            l_run[r] = l_run[r] * corr + p.sum(-1)
            acc[r] = acc[r] * corr[..., None] + torch.einsum(
                "hqk,hkd->hqd", p, v_cur[r])
            m_run[r] = m_new
        if step < n - 1:          # rotate K/V to the next rank
            k_cur = ops.ring_shift(k_cur, mesh=mesh, axis_name=axis_name)
            v_cur = ops.ring_shift(v_cur, mesh=mesh, axis_name=axis_name)
    return [a / l[..., None] for a, l in zip(acc, l_run)]


def _global(mesh: RankMesh, axis_name: str, shard_fn) -> Callable:
    """fn(q, k, v) over global (heads, seq, d) tensors, seq sharded on
    ``axis_name``: the output, sharded the same way, gathered back."""
    spec = (None, axis_name)

    def fn(q, k, v):
        outs = shard_fn(*(mesh.shard(t, spec) for t in (q, k, v)),
                        mesh=mesh, axis_name=axis_name)
        return mesh.unshard(outs, spec)

    return fn


def make_ring_attention(mesh: RankMesh, axis_name: str = "sp") -> Callable:
    """Exact attention with the sequence axis sharded over ``axis_name``:
    fn(q, k, v) of global (heads, seq, d) tensors."""
    return _global(mesh, axis_name, _ring_attention_shard)


def _ulysses_shard(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], *, mesh: RankMesh,
                   axis_name: str) -> Tensors:
    """Ulysses sequence parallelism: alltoall seq-sharding into
    head-sharding, full local attention, alltoall back. q, k, v: (heads,
    seq_local, d) per rank; heads % n == 0."""
    n = mesh.axis_size(axis_name)
    h, s_local, d = qs[0].shape
    if h % n:
        raise ValueError(f"heads ({h}) must divide over {n} ranks")

    def seq2head(xs):
        # (h, s_local, d) -> (h/n, n·s_local, d): head group j goes to
        # index j; the pieces received stack in source order = sequence
        # order
        ys = ops.alltoall([x.reshape(-1) for x in xs], mesh=mesh,
                          axis_name=axis_name)
        return [y.reshape(n, h // n, s_local, d).transpose(0, 1)
                .reshape(h // n, n * s_local, d) for y in ys]

    def head2seq(xs):
        # the inverse: sequence block j goes to index j; the pieces
        # received stack in head-group order
        ys = ops.alltoall([x.reshape(h // n, n, s_local, d).transpose(0, 1)
                           .reshape(-1) for x in xs], mesh=mesh,
                          axis_name=axis_name)
        return [y.reshape(h, s_local, d) for y in ys]

    scale = _scale(d, qs[0].dtype).to(qs[0].device)
    outs = []
    for q, k, v in zip(seq2head(qs), seq2head(ks), seq2head(vs)):
        scores = torch.einsum("hqd,hkd->hqk", q, k) * scale
        outs.append(torch.einsum("hqk,hkd->hqd", scores.softmax(-1), v))
    return head2seq(outs)


def make_ulysses_attention(mesh: RankMesh, axis_name: str = "sp"
                           ) -> Callable:
    """``make_ring_attention``'s function, computed the Ulysses way."""
    return _global(mesh, axis_name, _ulysses_shard)


def reference_attention(q, k, v) -> torch.Tensor:
    """Unsharded exact attention for validation."""
    scale = _scale(q.shape[-1], q.dtype).to(q.device)
    scores = torch.einsum("hqd,hkd->hqk", q, k) * scale
    return torch.einsum("hqk,hkd->hqd", scores.softmax(-1), v)
