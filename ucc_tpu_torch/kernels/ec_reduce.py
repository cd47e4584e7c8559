"""The execution component's reduce: the CUDA kernel of
``csrc/ec_reduce.cu``, its wrapper, and its plain PyTorch version.

``ec_reduce`` replaces ``ucc_tpu/ec/tpu.py:_build_reduce_kernel``: k <= 9
sources of ``count`` elements fold into ``dst``,
``dst = cast_T(alpha * fold_op(x_0, ..., x_{k-1}))``, with the rules set
out at the top of the source (float32 accumulation for the half types,
source order, NaN-propagating MAX/MIN, logical ops as 0/1, alpha in
float32, or float64 for the 64-bit types). It takes the eight integer
types, float16, bfloat16, float32 and float64, and SUM, PROD, MAX, MIN,
LAND, LOR, LXOR, AVG and, on integer types only, BAND, BOR, BXOR.

The wrapper writes into ``dst`` (which may be one of the sources). On CPU
tensors it runs the plain version ``ec_reduce_ref``; on CUDA tensors it
launches the kernel on the current stream of their device, without
synchronising, or raises. It counts its kernel launches in its
``launches`` attribute, a plain int.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..constants import DataType, ReductionOp, dt_torch
from ..ec.base import EXECUTOR_NUM_BUFS
from ..status import Status, UccError
from . import build

SOURCE = "ec_reduce.cu"

#: torch dtype -> dtype code of csrc/ec_reduce.cu
DTYPE_CODES = {
    torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.uint16: 3,
    torch.int32: 4, torch.uint32: 5, torch.int64: 6, torch.uint64: 7,
    torch.float16: 8, torch.bfloat16: 9, torch.float32: 10,
    torch.float64: 11,
}

LOGICAL = (ReductionOp.LAND, ReductionOp.LOR, ReductionOp.LXOR)
BITWISE = (ReductionOp.BAND, ReductionOp.BOR, ReductionOp.BXOR)
OPS = (ReductionOp.SUM, ReductionOp.PROD, ReductionOp.MAX, ReductionOp.MIN,
       *LOGICAL, *BITWISE, ReductionOp.AVG)

_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
#: unsigned types whose arithmetic the plain version runs through the
#: signed view of the same width (torch lacks add/maximum/gt for them)
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def torch_dtype(dt: DataType) -> torch.dtype:
    """The torch dtype of *dt*; ERR_NOT_SUPPORTED for the complex and
    128-bit types, which the kernel does not take."""
    try:
        td = dt_torch(dt)
    except TypeError:
        td = None
    if td not in DTYPE_CODES:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"ec reduce does not implement {DataType(dt).name}")
    return td


def check_args(count: int, dt: DataType, op: ReductionOp, k: int
               ) -> torch.dtype:
    """The torch dtype of *dt*, after refusing what the kernel does not
    take: ERR_INVALID_PARAM for a bad source count or count,
    ERR_NOT_SUPPORTED for complex and 128-bit types, MINLOC/MAXLOC, and
    bitwise ops on floating types."""
    if not 1 <= k <= EXECUTOR_NUM_BUFS:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"reduce takes 1 to {EXECUTOR_NUM_BUFS} sources, "
                       f"got {k}")
    if count < 0:
        raise UccError(Status.ERR_INVALID_PARAM, f"negative count {count}")
    if op not in OPS:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"ec reduce kernel does not implement {op}")
    td = torch_dtype(dt)
    if op in BITWISE and td in _FLOATS:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"{op.name} on floating-point dtype")
    return td


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _to_float(x: torch.Tensor, td: torch.dtype) -> torch.Tensor:
    """The accumulator *x* (a signed view for unsigned *td*) as float32,
    or float64 for the 64-bit types, rounded to nearest even."""
    if x.is_floating_point():
        return x
    if td == torch.uint64:
        # hi * 2^32 and lo are exact in float64; their sum rounds once
        hi = ((x >> 32) & 0xFFFFFFFF).double() * 4294967296.0
        return hi + (x & 0xFFFFFFFF).double()
    if td.itemsize == 8:
        return x.double()
    if td in _SIGNED:
        return (x.to(torch.int64) & ((1 << (8 * td.itemsize)) - 1)).float()
    return x.float()


def _from_float(f: torch.Tensor, td: torch.dtype) -> torch.Tensor:
    """A float tensor to *td*: nearest even for floats, truncation toward
    zero for integers (unsigned results as the signed view)."""
    if td in _FLOATS:
        return f.to(td)
    if td == torch.uint64:
        top = float(1 << 63)
        big = (f - top).to(torch.int64) + torch.iinfo(torch.int64).min
        return torch.where(f >= top, big, f.to(torch.int64))
    if td in _SIGNED:
        return f.to(torch.int64).to(_SIGNED[td])
    return f.to(td)


def _fold(op: ReductionOp, a: torch.Tensor, b: torch.Tensor,
          unsigned: bool) -> torch.Tensor:
    if op in (ReductionOp.SUM, ReductionOp.AVG):
        return torch.add(a, b)
    if op == ReductionOp.PROD:
        return torch.mul(a, b)
    if op in (ReductionOp.MAX, ReductionOp.MIN):
        # NaN propagates, as in the kernel: op(a, b) = (a > b or a is
        # NaN) ? a : b; an unsigned view compares with its sign bit flipped
        ka, kb = a, b
        if unsigned:
            flip = torch.iinfo(a.dtype).min
            ka, kb = a ^ flip, b ^ flip
        pick = ka > kb if op == ReductionOp.MAX else ka < kb
        if a.is_floating_point():
            pick = pick | torch.isnan(a)
        return torch.where(pick, a, b)
    return {ReductionOp.BAND: torch.bitwise_and,
            ReductionOp.BOR: torch.bitwise_or,
            ReductionOp.BXOR: torch.bitwise_xor}[op](a, b)


def ec_reduce_ref(srcs: Sequence[torch.Tensor], count: int, dt: DataType,
                  op: ReductionOp, alpha: Optional[float] = None
                  ) -> torch.Tensor:
    """Plain version of ``ec_reduce``: a new tensor of ``count`` elements,
    computed with the kernel's rules on the first ``count`` elements of
    every source."""
    return _reduce_ref(srcs, count, check_args(count, dt, op, len(srcs)),
                       op, alpha)


def _reduce_ref(srcs, count, td, op, alpha):
    """``ec_reduce_ref`` on arguments already checked; *td* is the torch
    dtype."""
    unsigned = td in _SIGNED
    xs = [s.reshape(-1)[:count] for s in srcs]
    if unsigned:
        xs = [x.view(_SIGNED[td]) for x in xs]
    if td in (torch.float16, torch.bfloat16):
        xs = [x.float() for x in xs]
    acc = xs[0].clone()
    if op in LOGICAL:
        if len(xs) > 1 or td.itemsize == 8:
            b = acc != 0
            for x in xs[1:]:
                c = x != 0
                b = b & c if op == ReductionOp.LAND else \
                    b | c if op == ReductionOp.LOR else b ^ c
            acc = b.to(acc.dtype)
    else:
        for x in xs[1:]:
            acc = _fold(op, acc, x, unsigned)
    if alpha is not None:
        f = _to_float(acc, td)
        acc = _from_float(f * torch.full_like(f, alpha), td)
    elif acc.dtype != td and not unsigned:
        acc = acc.to(td)
    return acc.view(td) if unsigned else acc


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        lib.ucc_ec_reduce.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
        lib.ucc_ec_reduce.restype = ctypes.c_int
        lib.ucc_ec_reduce_error_string.argtypes = [ctypes.c_int]
        lib.ucc_ec_reduce_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ec_reduce(dst: torch.Tensor, srcs: Sequence[torch.Tensor], count: int,
              dt: DataType, op: ReductionOp,
              alpha: Optional[float] = None) -> torch.Tensor:
    """Reduce the first ``count`` elements of every source into ``dst``
    and return ``dst``. Every buffer is a contiguous tensor of ``dt``'s
    torch dtype, of one device, holding at least ``count`` elements."""
    td = check_args(count, dt, op, len(srcs))
    bufs = [dst, *srcs]
    for t in bufs:
        if not isinstance(t, torch.Tensor):
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"ec reduce buffers must be tensors, got "
                           f"{type(t).__name__}")
        if t.dtype != td or t.device != dst.device or \
                t.numel() < count or not t.is_contiguous():
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"ec reduce buffers must be contiguous {td} "
                           f"tensors of one device with at least {count} "
                           "elements")
    if dst.device.type == "cpu":
        dst.reshape(-1)[:count].copy_(
            _reduce_ref(srcs, count, td, op, alpha))
        return dst
    if dst.device.type != "cuda":
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"ec reduce runs on cuda or cpu tensors, not "
                       f"{dst.device.type}")
    if count == 0:
        return dst
    lib = _library()
    ptrs = (ctypes.c_void_p * len(srcs))(*[s.data_ptr() for s in srcs])
    with torch.cuda.device(dst.device):
        stream = torch.cuda.current_stream(dst.device).cuda_stream
        rc = lib.ucc_ec_reduce(
            DTYPE_CODES[td], int(op), ptrs, len(srcs), dst.data_ptr(), count,
            0.0 if alpha is None else float(alpha), int(alpha is not None),
            stream)
    if rc != 0:
        raise UccError(Status.ERR_NO_RESOURCE,
                       f"ec reduce launch failed: CUDA error {rc} "
                       f"({lib.ucc_ec_reduce_error_string(rc).decode()})")
    ec_reduce.launches += 1
    return dst


ec_reduce.launches = 0
