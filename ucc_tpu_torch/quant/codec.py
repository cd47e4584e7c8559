"""Block-scaled low-precision codecs of quantized collectives: the wire
format's shape and each precision's constants (the port's part of
``ucc_tpu/quant/codec.py``).

A float32 payload is split into blocks of ``B`` elements; each block
carries one float32 absmax scale, and its elements travel as int8 or
fp8-e4m3 (``torch.float8_e4m3fn``). ``half_step`` is the worst-case
round-trip error of one element relative to its block's absmax: the
eligibility gate of ``quant.admits`` reads it. The kernels that quantize
on the device (``kernels/gen_device.py``) carry their own arithmetic; the
host encode/decode is not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["BlockCodec", "CODECS", "get_codec", "wire_count", "n_blocks"]


def n_blocks(count: int, block: int) -> int:
    return (int(count) + block - 1) // block


def wire_count(count: int, block: int) -> int:
    """Wire bytes for ``count`` encoded elements (scales + 1B/elem)."""
    return int(count) + 4 * n_blocks(count, block)


class BlockCodec:
    """One precision: ``qdtype`` holds the quantized elements, ``qmax`` is
    the largest magnitude after scaling, ``half_step`` the worst-case
    round-trip error of one element, relative to its block's absmax."""

    def __init__(self, name: str, qdtype: torch.dtype, qmax: float,
                 half_step: float):
        self.name = name
        self.qdtype = qdtype
        self.qmax = float(qmax)
        self.half_step = float(half_step)

    def __repr__(self):
        return f"BlockCodec({self.name})"


#: int8: symmetric round-to-nearest over [-127, 127]; fp8-e4m3: scaled
#: dtype cast (3 mantissa bits -> half-ulp 2^-4)
CODECS: Dict[str, BlockCodec] = {
    "int8": BlockCodec("int8", torch.int8, 127.0, 0.5 / 127.0),
    "fp8": BlockCodec("fp8", torch.float8_e4m3fn, 448.0, 2.0 ** -4),
}


def get_codec(name: str) -> BlockCodec:
    return CODECS[name]
