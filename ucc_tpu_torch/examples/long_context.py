"""Long-context attention: the GQA token-stream block of
``ucc_tpu/examples/long_context.py`` with its sequence sharded over the
ranks of a ring.

Every rank holds a block of consecutive tokens x (batch, seq_local, dm).
The block projects it to q (heads·e), k and v (kv_heads·e each), folds the
batch into the head axis, runs ``fused_attention.ring_flash_attention``
over all ranks (the CUDA kernel on GPU tensors) and projects the result
back through wo. It is the forward of ``make_gqa_train_step``'s loss: no
RoPE, norm or MLP, as in the JAX package.

The train steps (``make_train_step``, ``make_gqa_train_step``, the MHA
``init_params`` and ``run_one_step``) are not ported yet: their weight
gradients are averaged over the sequence and data ranks in-graph
(``ops.allreduce(AVG)``), which the port does not have yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..fused_attention import ring_flash_attention
from ..tl.device import resolve_device

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
    """The JAX package's parameter dict (arrays of any kind numpy can
    read) as the port's float32 tensors, so both run on the same
    weights."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(w, dtype=np.float32)).to(dev)
            for name, w in params.items()}


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
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Parameter(params[name]))

    def project(self, xs: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                           List[torch.Tensor]]:
        """q, k and v of every rank, each batch folded into the head axis:
        (batch·heads, seq_local, e) and (batch·kv_heads, seq_local, e).
        Folded q head bi·heads + hi reads folded kv head
        bi·kv_heads + hi // (heads/kv_heads), the kernel's grouping."""
        qs, ks, vs = [], [], []
        for x in xs:
            b, s, _ = x.shape

            def fold(t, h):
                # (b, s, h·e) -> (b, s, h, e) -> (b·h, s, e), contiguous
                # (at b = 1 the reshape alone would be a strided view)
                return t.reshape(b, s, h, self.e).transpose(1, 2) \
                    .contiguous().view(b * h, s, self.e)

            qs.append(fold(x @ self.wq, self.heads))
            ks.append(fold(x @ self.wk, self.kv_heads))
            vs.append(fold(x @ self.wv, self.kv_heads))
        return qs, ks, vs

    def merge(self, attns: Sequence[torch.Tensor], batch: int
              ) -> List[torch.Tensor]:
        """Unfold each rank's attention (batch·heads, seq_local, e) back to
        (batch, seq_local, heads·e) and project it through wo."""
        outs = []
        for a in attns:
            s = a.shape[1]
            outs.append(a.reshape(batch, self.heads, s, self.e)
                        .transpose(1, 2).reshape(batch, s,
                                                 self.heads * self.e)
                        @ self.wo)
        return outs

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
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
