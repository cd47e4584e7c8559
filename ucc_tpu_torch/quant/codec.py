"""Block-scaled low-precision codecs of quantized collectives (the port of
``ucc_tpu/quant/codec.py``).

A float32 (or bfloat16) payload is split into blocks of ``B`` elements;
each block carries one float32 absmax scale, and its elements travel as
int8 or fp8-e4m3 — 2-4x fewer wire bytes for a bounded, block-relative
rounding error. The host codecs are numpy transforms that encode into and
decode from caller-provided buffers, so the host algorithms
(``tl/host/quantized.py``) run them over mc-pool scratch leases and keep
the steady state free of allocations. A bfloat16 payload is its uint16
bit pattern, as everywhere on the port's host path (``ec/cpu``).

Wire layout of an encoded vector of ``count`` elements at block size
``B`` (``nb = ceil(count / B)`` blocks)::

    [ nb * 4 bytes : float32 per-block scales ][ count bytes : q elems ]

Both sides derive the layout from (count, B) alone, so the block size
must agree across the team. The bytes equal the JAX package's codec's
byte for byte (``tests/test_torch_quant.py``).

Error model (the eligibility gate of ``quant.admits``): one round trip
perturbs an element by at most ``half_step`` of its block's absmax (int8:
1/254; fp8-e4m3: 2^-4, the conservative envelope of fp8's per-element
error). ``qdtype`` is the torch dtype of the quantized elements, which
the device path (``quant/torch_ops.py``) casts to; ``np_qdtype`` is the
numpy view of the wire's element bytes (fp8 travels as raw uint8).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["BlockCodec", "CODECS", "get_codec", "wire_count", "n_blocks"]


def n_blocks(count: int, block: int) -> int:
    return (int(count) + block - 1) // block


def wire_count(count: int, block: int) -> int:
    """Wire bytes for ``count`` encoded elements (scales + 1B/elem)."""
    return int(count) + 4 * n_blocks(count, block)


#: per-thread float32 work buffers, grown monotonically and reused, so the
#: encode/decode loops do not fault in fresh temporaries on every call
_TLS = threading.local()


def _tmp(slot: int, n: int, dtype=np.float32) -> np.ndarray:
    bufs = getattr(_TLS, "bufs", None)
    if bufs is None:
        bufs = _TLS.bufs = {}
    buf = bufs.get(slot)
    if buf is None or buf.size < n or buf.dtype != dtype:
        buf = bufs[slot] = np.empty(n, dtype)
    return buf[:n]


def _tmp_f32(slot: int, n: int) -> np.ndarray:
    return _tmp(slot, n, np.float32)


def _as_f32(x: np.ndarray, slot: int = 1) -> np.ndarray:
    """float32 compute view of a payload; bfloat16 bits (uint16) widen
    exactly into the reusable thread-local work buffer."""
    if x.dtype == np.float32:
        return x
    t = _tmp_f32(slot, x.size)
    if x.dtype == np.uint16:
        u = t.view(np.uint32)
        u[:] = x
        np.left_shift(u, np.uint32(16), out=u)
    else:
        t[:] = x
    return t


def _store(dst: np.ndarray, t: np.ndarray) -> None:
    """float32 values into *dst*: bfloat16 bits (uint16) rounded to
    nearest even, other float dtypes cast on assignment."""
    if dst.dtype == np.uint16:
        from ..ec.cpu import f32_to_bf16
        dst[:] = f32_to_bf16(t)
    else:
        dst[:] = t


#: fp8 cast tables (built once per process): fp8 encode rounds each
#: float32's upper 16 bits (+0x8000 with carry: round to nearest on the
#: truncated value, safe for the finite, range-bounded scaled inputs) and
#: gathers the fp8 byte from a 64K-entry table keyed on them; decode is a
#: 256-entry byte -> float32 gather. The tables are torch's casts, with
#: magnitudes past 464 and non-finite rows mapped to NaN (0x7f, signed),
#: so that every row equals the JAX package's table.
_f8_tables: Dict[str, np.ndarray] = {}


def _f8_from_f32hi_lut() -> np.ndarray:
    lut = _f8_tables.get("enc")
    if lut is None:
        f = (np.arange(1 << 16, dtype=np.uint32)
             << np.uint32(16)).view(np.float32)
        lut = torch.from_numpy(f.copy()).to(torch.float8_e4m3fn) \
            .view(torch.uint8).numpy().copy()
        with np.errstate(invalid="ignore"):
            bad = ~(np.abs(f) <= 464.0)
        lut[bad] = np.where(np.signbit(f[bad]), 0xff, 0x7f)
        _f8_tables["enc"] = lut
    return lut


def _f8_to_f32_lut() -> np.ndarray:
    lut = _f8_tables.get("dec")
    if lut is None:
        lut = _f8_tables["dec"] = torch.arange(256, dtype=torch.uint8) \
            .view(torch.float8_e4m3fn).float().numpy().copy()
    return lut


class BlockCodec:
    """One precision's encode/decode pair.

    ``qmax`` is the largest representable magnitude after scaling;
    ``half_step`` the worst-case round-trip error of one element,
    relative to its block's absmax.
    """

    def __init__(self, name: str, qdtype: torch.dtype, np_qdtype,
                 qmax: float, half_step: float):
        self.name = name
        self.qdtype = qdtype
        self.np_qdtype = np.dtype(np_qdtype)
        self.qmax = float(qmax)
        self.half_step = float(half_step)

    def __repr__(self):
        return f"BlockCodec({self.name})"

    # ------------------------------------------------------------------
    def _split_wire(self, wire: np.ndarray, count: int, block: int):
        nb = n_blocks(count, block)
        scales = wire[:4 * nb].view(np.float32)
        q = wire[4 * nb:4 * nb + count].view(self.np_qdtype)
        return scales, q

    def encode(self, src: np.ndarray, wire: np.ndarray, block: int,
               stochastic: bool = False,
               rng: Optional[np.random.Generator] = None) -> None:
        """Encode ``src`` (1-D float32, or bfloat16 bits) into ``wire``
        (uint8, >= wire_count(src.size, block) bytes)."""
        count = src.size
        scales, q = self._split_wire(wire, count, block)
        x = _as_f32(src)
        m = (count // block) * block

        def one(xs: np.ndarray, sc_out: np.ndarray, q_out: np.ndarray,
                blk: int) -> None:
            x2 = xs.reshape(-1, blk)
            t = _tmp_f32(0, xs.size).reshape(-1, blk)
            np.abs(x2, out=t)
            amax = t.max(axis=1)
            # a zero block keeps scale 1 so 0 encodes to 0 exactly
            nz = amax > 0.0
            sc_out[:] = np.where(nz, amax / self.qmax, 1.0)
            inv = np.where(nz, self.qmax / np.where(nz, amax, 1.0), 1.0)
            np.multiply(x2, inv[:, None], out=t)
            # |t| <= qmax up to one rounding of inv, so round to nearest
            # cannot leave the code range: no clip pass
            if self.name == "int8":
                if stochastic and rng is not None:
                    np.add(t, rng.random(t.shape, dtype=np.float32), out=t)
                    np.floor(t, out=t)
                    # floor(t + u) can cross 127 where t sits an ulp or
                    # two past it, and the int8 cast would wrap that to
                    # -128: the stochastic path clips
                    np.clip(t, -127.0, 127.0, out=t)
                else:
                    np.rint(t, out=t)
                q_out.reshape(-1, blk)[:] = t   # dtype cast on assignment
            else:
                v = t.reshape(-1).view(np.uint32)
                u = _tmp(3, v.size, np.uint32)
                np.add(v, np.uint32(0x8000), out=u)
                np.right_shift(u, np.uint32(16), out=u)
                np.take(_f8_from_f32hi_lut(), u,
                        out=q_out.view(np.uint8).reshape(-1))

        if m:
            one(x[:m], scales[:m // block], q[:m], block)
        if m < count:                      # tail block (count % block)
            one(x[m:], scales[m // block:], q[m:], count - m)

    def decode(self, wire: np.ndarray, count: int, block: int,
               out: np.ndarray) -> None:
        """Decode ``count`` elements from ``wire`` into ``out`` (float32,
        or bfloat16 bits; values are computed in float32)."""
        scales, q = self._split_wire(wire, count, block)
        m = (count // block) * block

        def one(q_in: np.ndarray, sc: np.ndarray, dst: np.ndarray,
                blk: int) -> None:
            if self.name == "int8":
                q2 = q_in.reshape(-1, blk)
            else:
                t8 = _tmp_f32(2, q_in.size)
                np.take(_f8_to_f32_lut(), q_in.view(np.uint8).reshape(-1),
                        out=t8)
                q2 = t8.reshape(-1, blk)
            if dst.dtype == np.float32:
                np.multiply(q2, sc[:, None], out=dst.reshape(-1, blk))
                return
            t = _tmp_f32(0, q_in.size).reshape(-1, blk)
            np.multiply(q2, sc[:, None], out=t)
            _store(dst, t.reshape(-1))

        if m:
            one(q[:m], scales[:m // block], out[:m], block)
        if m < count:
            one(q[m:], scales[m // block:], out[m:], count - m)

    # ------------------------------------------------------------------
    def roundtrip_max_err(self, src: np.ndarray, wire: np.ndarray,
                          block: int) -> float:
        """max |src - decode(wire)|: the probe behind the
        ``quant_max_abs_err`` gauge (callers guard on metrics.ENABLED)."""
        tmp = np.empty(src.size, np.float32)
        self.decode(wire, src.size, block, tmp)
        return float(np.max(np.abs(_as_f32(src) - tmp))) if src.size \
            else 0.0


#: int8: symmetric round-to-nearest over [-127, 127]; fp8-e4m3: scaled
#: dtype cast (3 mantissa bits -> half-ulp 2^-4)
CODECS: Dict[str, BlockCodec] = {
    "int8": BlockCodec("int8", torch.int8, np.int8, 127.0, 0.5 / 127.0),
    "fp8": BlockCodec("fp8", torch.float8_e4m3fn, np.uint8, 448.0,
                      2.0 ** -4),
}


def get_codec(name: str) -> BlockCodec:
    return CODECS[name]
