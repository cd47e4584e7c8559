"""Block-scaled quantized collectives as torch ops (the port of
``ucc_tpu/quant/xla_ops.py``): the device half of the quantized variants,
run by tl/torch_ops' ``q<mode>`` algorithms on the team's stream.

Each rank's vector (zero-padded to a multiple of the block) is quantized
block-scaled — the host codec's absmax-per-block format without the byte
packing — then every rank's quantized blocks are dequantized and reduced
in float32. In tl/xla the quantized blocks are what ``lax.all_gather``
moves between devices; here every rank of the team lies on one device
(or is mapped into the process), so the same arithmetic runs over the
stacked ranks. The arithmetic is the reference's, step by step:

- scale = amax x float32(1 / QMAX) (1.0 where the block is all zero): the
  reference writes ``amax / QMAX``, and XLA compiles a division by a
  constant into that product, so it is what the reference computes;
- int8: ``clip(round_half_even(x / scale), -127, 127)``; fp8:
  ``clip(x / scale, -448, 448)`` cast to ``float8_e4m3fn`` (x / scale is
  a true division, as in the reference);
- dequantize, then sum the n contributions in float32 in rank order,
  starting from zero;
- AVG divides by n;
- the result is quantized and dequantized once more, so every rank holds
  the same bits;
- the allgather slices each rank's row back to ``count``.

The allgather is the reference's bit for bit. The allreduce's sum is
where the two may part: XLA's CPU backend fuses the dequantize into the
sum (a multiply-add a rank at n = 3 or 5, a pairwise tree at n = 8), so
a partial sum can differ in its last bit and the requantized result by
one quantization step (``tests/test_torch_quant_tl.py``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..constants import ReductionOp

__all__ = ["quant_allreduce", "quant_allgather", "block_quantize",
           "block_dequantize", "padded_count"]

_QMAX = {"int8": 127.0, "fp8": 448.0}
#: float32(1 / QMAX): XLA compiles the reference's ``amax / QMAX`` (a
#: division by a constant) into a product with the constant's float32
#: reciprocal, and that product is what the reference computes
_INV_QMAX = {m: float(np.float32(1.0) / np.float32(q))
             for m, q in _QMAX.items()}


def padded_count(count: int, block: int) -> int:
    """*count* rounded up to a multiple of *block* (at least one block's
    worth when count is 0, as the reference's ``max(count, 1)``)."""
    padded = max(int(count), 1)
    return padded + (-padded) % block


def _padded_rows(xs: Sequence[torch.Tensor], block: int) -> torch.Tensor:
    """(n, padded) float32: each rank's vector, zero-padded."""
    count = xs[0].numel()
    rows = torch.zeros(len(xs), padded_count(count, block),
                       dtype=torch.float32, device=xs[0].device)
    for r, x in enumerate(xs):
        rows[r, :count] = x.reshape(-1)
    return rows


def block_quantize(xf: torch.Tensor, mode: str, block: int):
    """(..., padded) float32 -> ((..., nb, block) quantized, (..., nb)
    float32 scales)."""
    x2 = xf.reshape(*xf.shape[:-1], -1, block)
    amax = x2.abs().amax(-1)
    scale = torch.where(amax > 0.0, amax * _INV_QMAX[mode],
                        torch.ones_like(amax))
    scaled = x2 / scale[..., None]
    if mode == "int8":
        q = torch.clamp(torch.round(scaled), -127.0, 127.0).to(torch.int8)
    else:
        q = torch.clamp(scaled, -448.0, 448.0).to(torch.float8_e4m3fn)
    return q, scale


def block_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """((..., nb, block), (..., nb)) -> (..., nb, block) float32."""
    return q.to(torch.float32) * scale[..., None]


def quant_allreduce(xs: Sequence[torch.Tensor], op: ReductionOp, mode: str,
                    block: int) -> torch.Tensor:
    """Every rank's allreduce result (``count`` elements, the inputs'
    dtype) from one tensor per rank: each contribution quantized once,
    reduced in float32, the result quantized once more — the direct host
    variant's error model, (n + 1) half-steps at most."""
    n, count, dtype = len(xs), xs[0].numel(), xs[0].dtype
    q, scale = block_quantize(_padded_rows(xs, block), mode, block)
    deq = block_dequantize(q, scale)                 # (n, nb, block)
    red = torch.zeros_like(deq[0])
    for r in range(n):
        red += deq[r]
    if op == ReductionOp.AVG:
        red = red / torch.full_like(red, n)
    rq, rs = block_quantize(red.reshape(-1), mode, block)
    return block_dequantize(rq, rs).reshape(-1)[:count].to(dtype)


def quant_allgather(xs: Sequence[torch.Tensor], mode: str, block: int,
                    count: int) -> torch.Tensor:
    """The n * count gathered vector of the dequantized contributions (one
    round trip per block), each row's padding sliced off."""
    dtype = xs[0].dtype
    q, scale = block_quantize(_padded_rows(xs, block), mode, block)
    rows = block_dequantize(q, scale).reshape(len(xs), -1)
    return rows[:, :count].reshape(-1).to(dtype)
