"""Fused ring flash-attention: context parallelism as one CUDA kernel.

The port of ``ucc_tpu/fused_attention.py``. A sequence of S positions is
split over n ranks of an in-process team, each holding one contiguous
block of S/n positions; every rank gets exact attention of its queries
against the whole sequence, computed as a stream over the ring (running
row max and normalizer in float32, so the result equals full
softmax(QKᵀ)V). Causal masking uses global positions: rank r owns queries
and keys [r·S/n, (r+1)·S/n).

Here the ranks are buffers on one GPU, and the forward is one launch of
the kernel of ``csrc/ring_flash_attn.cu`` (``kernels/ring_attention.py``),
which reads each rank's K/V block through a pointer table in the ring's
order. On CPU tensors the plain PyTorch version runs instead. The
backward differentiates ``ring_shard``, the port of the JAX package's
``_xla_ring_shard``, one query rank at a time (there is no backward
kernel, in either package). On a ``mesh.RankMesh`` the rings are the
groups of an axis (``mesh=``, ``axis_name=``), one launch each.

The JAX package's ``fused=`` and ``multi_axis=`` options (and its
``_mesh_multi_axis`` probe) are not ported: they choose between TPU
addressing modes and the lax ring that Pallas interpret mode falls back to,
and the port has neither.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from .kernels.ring_attention import (default_scale, ring_flash_attention_fwd,
                                     ring_shard)
from .tl.device import resolve_device


class _RingFlashAttention(torch.autograd.Function):
    """Forward through the kernel (the plain version on CPU tensors);
    backward recomputes ``ring_shard`` and differentiates it, as the JAX
    package's custom_vjp differentiates its lax ring schedule
    (flash-style rematerialization). One query rank at a time: rank r's
    output depends on q[r] and every k and v, so the gradient of out[r]
    alone gives dq[r] and adds into every dk and dv, and the recompute
    graph held at once is one rank's. There is no backward kernel."""

    @staticmethod
    def forward(ctx, n, scale, causal, *qkv):
        ctx.n, ctx.scale, ctx.causal = n, scale, causal
        ctx.save_for_backward(*qkv)
        return tuple(ring_flash_attention_fwd(
            qkv[:n], qkv[n:2 * n], qkv[2 * n:], scale, causal))

    @staticmethod
    def backward(ctx, *grad_outs):
        n = ctx.n
        saved = ctx.saved_tensors
        ks = [t.detach().requires_grad_() for t in saved[n:2 * n]]
        vs = [t.detach().requires_grad_() for t in saved[2 * n:]]
        dq = []
        dk = [torch.zeros_like(k) for k in ks]
        dv = [torch.zeros_like(v) for v in vs]
        for me in range(n):
            q = saved[me].detach().requires_grad_()
            with torch.enable_grad():
                out = ring_shard(q, ks, vs, me, ctx.scale, ctx.causal)
                grads = torch.autograd.grad(out, [q, *ks, *vs],
                                            grad_outs[me],
                                            allow_unused=True)
            dq.append(grads[0])
            for acc, g in zip(dk + dv, grads[1:]):
                if g is not None:
                    acc += g
        return (None, None, None, *dq, *dk, *dv)


def ring_flash_attention(qs: Sequence[torch.Tensor],
                         ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor], *,
                         scale: Optional[float] = None,
                         causal: bool = False, mesh=None,
                         axis_name="r") -> List[torch.Tensor]:
    """Shard-level ring attention of n ranks.

    qs[r]: (heads, seq_local, head_dim); ks[r], vs[r]: (kv_heads,
    seq_local, head_dim) with heads % kv_heads == 0 — rank r's sequence
    block, contiguous, of one dtype (float32, float16 or bfloat16) and one
    device. kv_heads < heads is grouped-query attention: consecutive groups
    of heads/kv_heads query heads share one K/V head. Returns one
    (heads, seq_local, head_dim) output per rank. ``scale`` defaults to
    1/sqrt(head_dim).

    Without ``mesh`` the n blocks are one ring in sequence order. With a
    ``mesh.RankMesh`` they are one per rank of the mesh, and each group of
    ``axis_name`` (an axis or a tuple of axes) is a ring in its index
    order, as in the JAX package's ``axis_name``.

    Differentiable with respect to every q, k and v. CUDA tensors launch
    the kernel (or raise); CPU tensors run the plain version.
    """
    h, _, d = qs[0].shape
    h_kv = ks[0].shape[0]
    if h % h_kv != 0 or vs[0].shape[0] != h_kv:
        raise ValueError(
            f"GQA shapes: q has {h} heads but k/v have {ks[0].shape[0]}/"
            f"{vs[0].shape[0]} — q heads must be a multiple of kv heads and "
            f"k/v must agree")
    if scale is None:
        scale = default_scale(d)
    if mesh is None:
        n = len(qs)
        return list(_RingFlashAttention.apply(n, float(scale), bool(causal),
                                              *qs, *ks, *vs))
    if not len(qs) == len(ks) == len(vs) == mesh.size:
        raise ValueError(f"a mesh of {mesh.size} ranks takes one q, k and v "
                         f"per rank, got {len(qs)}, {len(ks)}, {len(vs)}")
    outs = [None] * mesh.size
    for group in mesh.groups(axis_name):
        ring = _RingFlashAttention.apply(
            len(group), float(scale), bool(causal),
            *[qs[r] for r in group], *[ks[r] for r in group],
            *[vs[r] for r in group])
        for r, o in zip(group, ring):
            outs[r] = o
    return outs


def make_ring_flash_attention(n_ranks: int, *, causal: bool = False,
                              scale: Optional[float] = None,
                              device: str = "cuda") -> Callable:
    """Global entry: a function of q (heads, seq, head_dim) and k, v
    (kv_heads, seq, head_dim) that splits seq into ``n_ranks`` contiguous
    blocks, one buffer per rank on ``device``, runs
    ``ring_flash_attention`` and concatenates the outputs back into
    (heads, seq, head_dim). A seq not divisible by ``n_ranks`` raises
    ValueError. ``device`` defaults to cuda, which raises ERR_NO_RESOURCE
    when there is no GPU; ``cpu`` runs the plain version."""
    dev = resolve_device(device)

    def fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> torch.Tensor:
        seq = q.shape[1]
        if seq % n_ranks != 0 or k.shape[1] != seq or v.shape[1] != seq:
            raise ValueError(f"seq lengths {q.shape[1]}/{k.shape[1]}/"
                             f"{v.shape[1]} must agree and divide over "
                             f"{n_ranks} ranks")
        s = seq // n_ranks

        def blocks(x):
            return [b.to(dev).contiguous() for b in x.split(s, dim=1)]

        outs = ring_flash_attention(blocks(q), blocks(k), blocks(v),
                                    scale=scale, causal=causal)
        return torch.cat(outs, dim=1)

    return fn
