"""CUDA execution component — reductions and copies on GPU tensors.

The counterpart of UCC's ec_cuda (reduction kernels templated over op x
dtype, a task queue with asynchronous completion) and of the JAX
package's ec/tpu:

  - the REDUCE family runs the hand-written kernel of
    ``kernels/ec_reduce.py`` (``csrc/ec_reduce.cu``): ``reduce`` with k <= 9
    sources, ``reduce_strided`` with pointers ``src2_base + i * stride``
    into the base (no copies), ``reduce_multi_dst`` with one launch per job
    (at most 7); MINLOC/MAXLOC run as PyTorch ops, as the JAX package runs
    them as jnp ops outside any kernel;
  - ``copy`` and ``copy_multi`` are ``Tensor.copy_`` on byte views, with
    the capacity check of the JAX package's ``_copy_one``;
  - completion is a CUDA event recorded on the current stream after the
    task's work: ``task_test`` returns IN_PROGRESS until it has fired.

Results land in the caller's ``dst`` tensor, as in UCC, and
``task.array`` points at it; with ``dst=None`` the executor allocates the
output, as the JAX executor does. The device comes from the tensors: a
CPU tensor runs the kernel's plain version (that is how the tests run
this executor; such a call is not a launch), a CUDA tensor runs the
kernel, any other device raises. Complex and 128-bit types are
ERR_NOT_SUPPORTED.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from ..constants import ReductionOp, dt_size
from ..kernels.ec_reduce import check_args, ec_reduce, torch_dtype
from ..status import Status, UccError
from .base import (EXECUTOR_NUM_BUFS, Executor, ExecutorTask,
                   ExecutorTaskType, check_multi_op_bufs)

_LOC_OPS = (ReductionOp.MINLOC, ReductionOp.MAXLOC)


def _tensor(buf: Any, what: str) -> torch.Tensor:
    if not isinstance(buf, torch.Tensor):
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"ec {what} must be a tensor, got {type(buf).__name__}")
    if buf.device.type not in ("cuda", "cpu"):
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"the cuda executor runs on cuda or cpu tensors, not "
                       f"{buf.device.type}")
    return buf


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def _reduce_loc(srcs: Sequence[torch.Tensor], count: int,
                op: ReductionOp) -> torch.Tensor:
    """MINLOC/MAXLOC over flattened (value, index) pairs, as the JAX
    executor's ``_reduce_loc``: the value picked by argmin/argmax, the
    lowest index among the sources that tie with it."""
    g = torch.stack([s.reshape(-1)[:count] for s in srcs])
    vals, idxs = g[:, 0::2], g[:, 1::2]
    pick = torch.argmin(vals, dim=0) if op == ReductionOp.MINLOC else \
        torch.argmax(vals, dim=0)
    sel_val = torch.take_along_dim(vals, pick[None], dim=0)[0]
    ties = vals == sel_val[None]
    big = float("inf") if g.is_floating_point() else \
        torch.iinfo(g.dtype).max
    sel_idx = torch.where(ties, idxs, torch.full_like(idxs, big)).amin(dim=0)
    out = torch.empty(count, dtype=g.dtype, device=g.device)
    out[0::2] = sel_val
    out[1::2] = sel_idx
    return out


class EcCuda(Executor):
    """Device executor: tasks complete when their CUDA event fires."""

    EC_NAME = "cuda"

    # ------------------------------------------------------------------
    def _post(self, task_type: ExecutorTaskType, array: Any,
              device: torch.device) -> ExecutorTask:
        task = ExecutorTask(task_type, Status.IN_PROGRESS, array=array)
        if device.type == "cuda":
            task.payload = torch.cuda.Event()
            task.payload.record(torch.cuda.current_stream(device))
        return task

    def _reduce(self, dst, srcs, count, dt, op, alpha) -> torch.Tensor:
        """One reduce into dst (allocated when None); returns dst. The
        kernel's wrapper checks its own arguments; MINLOC/MAXLOC, which do
        not reach it, are checked here."""
        if op in _LOC_OPS:
            if len(srcs) > EXECUTOR_NUM_BUFS:
                raise UccError(Status.ERR_INVALID_PARAM,
                               f"reduce takes at most {EXECUTOR_NUM_BUFS} "
                               "bufs")
            torch_dtype(dt)
            if count % 2:
                raise UccError(Status.ERR_INVALID_PARAM,
                               "MINLOC/MAXLOC requires (value, index) pairs")
            res = _reduce_loc([_tensor(s, "source") for s in srcs], count,
                              op)
            if dst is None:
                return res
            _tensor(dst, "destination").reshape(-1)[:count].copy_(res)
            return dst
        if dst is None:
            td = check_args(count, dt, op, len(srcs))
            dst = torch.empty(count, dtype=td,
                              device=_tensor(srcs[0], "source").device)
        return ec_reduce(_tensor(dst, "destination"), srcs, count, dt, op,
                         alpha)

    def reduce(self, dst, srcs, count, dt, op, alpha=None) -> ExecutorTask:
        dst = self._reduce(dst, srcs, count, dt, op, alpha)
        return self._post(ExecutorTaskType.REDUCE, dst, dst.device)

    def reduce_strided(self, dst, src1, src2_base, stride_bytes, n_src2,
                       count, dt, op, alpha=None) -> ExecutorTask:
        esz = dt_size(dt)
        if stride_bytes % esz != 0:
            raise UccError(Status.ERR_INVALID_PARAM, "unaligned stride")
        stride = stride_bytes // esz
        base = _tensor(src2_base, "strided base").reshape(-1)
        if n_src2 > 0 and base.numel() < stride * (n_src2 - 1) + count:
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"strided base of {base.numel()} elements holds "
                           f"no {n_src2} sources of {count} at stride "
                           f"{stride}")
        srcs = [src1] + [base[i * stride:i * stride + count]
                         for i in range(n_src2)]
        dst = self._reduce(dst, srcs, count, dt, op, alpha)
        return self._post(ExecutorTaskType.REDUCE_STRIDED, dst, dst.device)

    def reduce_multi_dst(self, jobs) -> ExecutorTask:
        check_multi_op_bufs(len(jobs))
        dsts = [self._reduce(j.get("dst"), [j["src1"], j["src2"]],
                             j["count"], j["dt"], j["op"], j.get("alpha"))
                for j in jobs]
        device = dsts[0].device if dsts else torch.device("cpu")
        return self._post(ExecutorTaskType.REDUCE_MULTI_DST, dsts, device)

    def _copy_one(self, dst, src, size_bytes) -> torch.Tensor:
        """Copy size_bytes of src into dst (allocated like src when None);
        more bytes than dst holds is ERR_INVALID_PARAM."""
        src = _tensor(src, "copy source")
        if dst is None:
            dst = torch.empty_like(src.reshape(-1))
        dst = _tensor(dst, "copy destination")
        room = dst.numel() * dst.element_size()
        if size_bytes > room:
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"ec copy: {size_bytes} bytes into a "
                           f"{room}-byte destination")
        if size_bytes > src.numel() * src.element_size():
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"ec copy: {size_bytes} bytes from a "
                           f"{src.numel() * src.element_size()}-byte source")
        _bytes(dst)[:size_bytes].copy_(_bytes(src)[:size_bytes])
        return dst

    def copy(self, dst, src, size_bytes) -> ExecutorTask:
        dst = self._copy_one(dst, src, size_bytes)
        return self._post(ExecutorTaskType.COPY, dst, dst.device)

    def copy_multi(self, pairs) -> ExecutorTask:
        check_multi_op_bufs(len(pairs))
        dsts = [self._copy_one(d, s, n) for d, s, n in pairs]
        device = dsts[0].device if dsts else torch.device("cpu")
        return self._post(ExecutorTaskType.COPY_MULTI, dsts, device)

    # ------------------------------------------------------------------
    def task_test(self, task: ExecutorTask) -> Status:
        if task.status == Status.IN_PROGRESS:
            if task.payload is None or task.payload.query():
                task.payload = None
                task.status = Status.OK
        return task.status
