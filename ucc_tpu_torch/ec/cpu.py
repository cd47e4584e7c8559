"""Host execution component — synchronous numpy reductions.

UCC's ec/cpu generates one reduction loop per (op x dtype); here one
vectorized numpy expression per op. All 13 reduction ops are supported,
AVG through the alpha post-scale flag, and MINLOC/MAXLOC over (value,
index) pairs (MPI-style loc semantics: value compared, lowest index wins
ties). Generic datatypes fold through their reduce callback.

float16 and bfloat16 accumulate in float32 and round once at the end, as
UCC's CUDA executor's half kernels do. numpy has no bfloat16 (the port
does not depend on ml_dtypes), so a bfloat16 buffer travels as its uint16
bit pattern: a CPU tensor of torch.bfloat16, or any 2-byte numpy array.

This is also the port's definition of what a reduce computes for the
64-bit types (int64, uint64, float64), which the JAX package's device
executor cannot run: ``reduce_arrays`` is the reference that
``kernels/ec_reduce.py`` is held to for them.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..constants import (DataType, GenericDataType, ReductionOp, dt_numpy,
                         dt_size)
from ..mc.cpu import _as_u8
from ..status import Status, UccError
from .base import (EXECUTOR_NUM_BUFS, Executor, ExecutorTask,
                   ExecutorTaskType, check_multi_op_bufs)

_LOGICAL = (ReductionOp.LAND, ReductionOp.LOR, ReductionOp.LXOR)
_BITWISE = (ReductionOp.BAND, ReductionOp.BOR, ReductionOp.BXOR)
_LOC_OPS = (ReductionOp.MINLOC, ReductionOp.MAXLOC)
_HALF = (np.float16,)


def storage_dtype(dt: DataType) -> np.dtype:
    """The numpy dtype that holds *dt*'s elements: bfloat16 as uint16."""
    if dt == DataType.BFLOAT16:
        return np.dtype(np.uint16)
    return dt_numpy(dt)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns -> their float32 values (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values -> bfloat16 bit patterns, rounded to nearest even."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _as_typed(buf: Any, count: int, nd: np.dtype) -> np.ndarray:
    """View a buffer (CPU tensor, ndarray, bytes) as `count` elements of
    dtype nd (zero-copy)."""
    if isinstance(buf, torch.Tensor):
        return _as_u8(buf).view(nd)[:count]
    if isinstance(buf, np.ndarray):
        if buf.dtype == nd:
            return buf.reshape(-1)[:count]
        return buf.reshape(-1).view(nd)[:count]
    return np.frombuffer(buf, dtype=nd, count=count)


#: ops eligible for the allocation-free `out=` accumulate path
_OUT_UFUNC = {ReductionOp.SUM: np.add,
              ReductionOp.PROD: np.multiply,
              ReductionOp.MAX: np.maximum,
              ReductionOp.MIN: np.minimum}


def reduce_arrays(srcs: Sequence[np.ndarray], op: ReductionOp,
                  dt: DataType, alpha: Optional[float] = None,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    """Reduce a list of equally-shaped 1-D typed arrays (bfloat16 as
    uint16 bit patterns; the result likewise).

    ``out`` (hot-path opt-in): the result lands in *out* (which may
    alias ``srcs[0]``) and is returned. When the op is a plain
    elementwise ufunc (SUM/PROD/MAX/MIN) and the dtype needs no
    widening (not half/bfloat16), accumulation runs straight into *out*
    with no temporary allocation; otherwise the allocating path runs
    and copies back — so callers can pass ``out`` unconditionally.
    """
    bf16 = dt == DataType.BFLOAT16
    nd = storage_dtype(dt)
    if bf16 and len(srcs) and srcs[0].dtype != nd:
        # a bfloat16 payload already widened into float32 scratch (the
        # quantized collectives' dequantize-and-accumulate): reduce in
        # that dtype and keep its precision, never rounding partial sums
        # through bfloat16
        bf16, nd = False, srcs[0].dtype
    is_float_like = bf16 or np.issubdtype(nd, np.floating) or \
        np.issubdtype(nd, np.complexfloating)

    if op in _LOC_OPS:
        if bf16:
            res = f32_to_bf16(_reduce_loc([bf16_to_f32(s) for s in srcs],
                                          op))
        else:
            res = _reduce_loc(srcs, op)
        if out is not None:
            out[:] = res
            return out
        return res

    if (out is not None and alpha is None and op in _OUT_UFUNC and
            len(srcs) >= 2 and not bf16 and out.dtype.type not in _HALF and
            all(s.dtype == out.dtype for s in srcs)):
        # accumulate in the buffers' COMMON dtype — which may be a WIDER
        # accumulation dtype than dt (a payload reduced in f32 scratch):
        # the result must stay in that dtype, not round-trip through nd
        ufunc = _OUT_UFUNC[op]
        ufunc(srcs[0], srcs[1], out=out)
        for s in srcs[2:]:
            ufunc(out, s, out=out)
        return out

    compute = srcs
    if bf16:
        compute = [bf16_to_f32(s) for s in srcs]
    elif nd.type in _HALF:
        compute = [s.astype(np.float32) for s in srcs]

    acc = compute[0]
    if op in (ReductionOp.SUM, ReductionOp.AVG):
        acc = np.sum(compute, axis=0)
    elif op == ReductionOp.PROD:
        acc = compute[0].copy()
        for s in compute[1:]:
            acc = acc * s
    elif op == ReductionOp.MAX:
        acc = np.maximum.reduce(compute)
    elif op == ReductionOp.MIN:
        acc = np.minimum.reduce(compute)
    elif op == ReductionOp.LAND:
        acc = np.logical_and.reduce(compute)
    elif op == ReductionOp.LOR:
        acc = np.logical_or.reduce(compute)
    elif op == ReductionOp.LXOR:
        acc = np.logical_xor.reduce([c.astype(bool) for c in compute])
    elif op in _BITWISE:
        if is_float_like:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"{op.name} on floating-point dtype")
        ufunc = {ReductionOp.BAND: np.bitwise_and,
                 ReductionOp.BOR: np.bitwise_or,
                 ReductionOp.BXOR: np.bitwise_xor}[op]
        acc = ufunc.reduce(compute)
    else:
        raise UccError(Status.ERR_NOT_SUPPORTED, f"op {op}")

    if op in _LOGICAL:
        acc = acc.astype(np.float32 if bf16 else nd)
    if alpha is not None:
        acc = acc * alpha
    if bf16:
        acc = f32_to_bf16(acc)
    if out is not None:
        # contract: with out=, the result ALWAYS lands in out. The cast
        # targets OUT's dtype: an out wider than nd keeps full precision
        if acc is not out:
            out[:] = acc if acc.dtype == out.dtype else \
                acc.astype(out.dtype)
        return out
    return acc.astype(nd) if acc.dtype != nd else acc


def _reduce_loc(srcs: Sequence[np.ndarray], op: ReductionOp) -> np.ndarray:
    """MINLOC/MAXLOC over flattened (value, index) pairs."""
    if srcs[0].size % 2 != 0:
        raise UccError(Status.ERR_INVALID_PARAM,
                       "MINLOC/MAXLOC requires (value, index) pairs")
    pairs = [s.reshape(-1, 2) for s in srcs]
    vals = np.stack([p[:, 0] for p in pairs])          # (n_src, n)
    idxs = np.stack([p[:, 1] for p in pairs])
    if op == ReductionOp.MINLOC:
        best = np.argmin(vals, axis=0)
    else:
        best = np.argmax(vals, axis=0)
    # ties: lowest index wins (MPI semantics)
    sel_val = vals[best, np.arange(vals.shape[1])]
    ties = vals == sel_val[None, :]
    tie_idx = np.where(ties, idxs, np.inf)
    sel_idx = np.min(tie_idx, axis=0)
    out = np.empty_like(pairs[0])
    out[:, 0] = sel_val
    out[:, 1] = sel_idx
    return out.reshape(-1)


class EcCpu(Executor):
    """Synchronous executor: every task completes at post time."""

    EC_NAME = "cpu"

    # ------------------------------------------------------------------
    def reduce(self, dst, srcs, count, dt, op, alpha=None) -> ExecutorTask:
        if len(srcs) > EXECUTOR_NUM_BUFS:
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"reduce takes at most {EXECUTOR_NUM_BUFS} bufs")
        if isinstance(dt, GenericDataType):
            # user datatype: fold via the reduce callback over raw bytes
            # (ucc_dt_create_generic reduce semantics)
            if dt.reduce_cb is None:
                raise UccError(Status.ERR_NOT_SUPPORTED,
                               "generic datatype has no reduce callback")
            nb = count * dt.size
            acc = _as_typed(srcs[0], nb, np.dtype(np.uint8)).tobytes()
            for s in srcs[1:]:
                acc = bytes(dt.reduce_cb(
                    acc, _as_typed(s, nb, np.dtype(np.uint8)).tobytes(),
                    count))
            out = np.frombuffer(acc, dtype=np.uint8)
            if isinstance(dst, np.ndarray) and \
                    not dst.flags["C_CONTIGUOUS"]:
                raise UccError(Status.ERR_INVALID_PARAM,
                               "generic-dtype dst must be contiguous")
            if dst is not None:
                _as_typed(dst, out.size, np.dtype(np.uint8))[:] = out
            return ExecutorTask(ExecutorTaskType.REDUCE, Status.OK,
                                array=dst)
        nd = storage_dtype(dt)
        typed = [_as_typed(s, count, nd) for s in srcs]
        res = reduce_arrays(typed, op, dt, alpha)
        _as_typed(dst, count, nd)[:] = res
        return ExecutorTask(ExecutorTaskType.REDUCE, Status.OK, array=dst)

    def reduce_strided(self, dst, src1, src2_base, stride_bytes, n_src2,
                       count, dt, op, alpha=None) -> ExecutorTask:
        nd = storage_dtype(dt)
        esz = dt_size(dt)
        if stride_bytes % esz != 0:
            raise UccError(Status.ERR_INVALID_PARAM, "unaligned stride")
        stride = stride_bytes // esz
        base = _as_typed(src2_base, stride * max(n_src2 - 1, 0) + count, nd)
        srcs = [_as_typed(src1, count, nd)] + \
            [base[i * stride:i * stride + count] for i in range(n_src2)]
        res = reduce_arrays(srcs, op, dt, alpha)
        _as_typed(dst, count, nd)[:] = res
        return ExecutorTask(ExecutorTaskType.REDUCE_STRIDED, Status.OK,
                            array=dst)

    def reduce_multi_dst(self, jobs) -> ExecutorTask:
        check_multi_op_bufs(len(jobs))
        for j in jobs:
            self.reduce(j["dst"], [j["src1"], j["src2"]], j["count"],
                        j["dt"], j["op"], j.get("alpha"))
        return ExecutorTask(ExecutorTaskType.REDUCE_MULTI_DST, Status.OK,
                            array=[j["dst"] for j in jobs])

    def copy(self, dst, src, size_bytes) -> ExecutorTask:
        _as_u8(dst)[:size_bytes] = _as_u8(src)[:size_bytes]
        return ExecutorTask(ExecutorTaskType.COPY, Status.OK, array=dst)

    def copy_multi(self, pairs) -> ExecutorTask:
        check_multi_op_bufs(len(pairs))
        for dst, src, nb in pairs:
            self.copy(dst, src, nb)
        return ExecutorTask(ExecutorTaskType.COPY_MULTI, Status.OK,
                            array=[d for d, _, _ in pairs])
