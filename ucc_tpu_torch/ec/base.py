"""Execution components (EC) — compute executors.

UCC's executor (ucc_ec_base.h) is a queue of compute tasks of types
REDUCE / REDUCE_STRIDED / REDUCE_MULTI_DST / COPY / COPY_MULTI, with the
alpha-scaling flag that implements AVG as SUM x (1/N).
``EXECUTOR_NUM_BUFS = 9`` caps the source buffers of one reduce task,
which in turn caps the knomial radix; kept for parity.

EcCpu (ec/cpu.py) reduces host buffers with numpy and completes at post
time; EcCuda (ec/cuda.py) launches the hand-written reduce kernel on
GPU tensors and completes when its CUDA event has fired. Both take the
same task API.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

from ..constants import DataType, MemoryType, ReductionOp
from ..status import Status, UccError

EXECUTOR_NUM_BUFS = 9    # ucc_ec_base.h: UCC_EE_EXECUTOR_NUM_BUFS
MULTI_OP_NUM_BUFS = 7    # ucc_ec_base.h: UCC_EE_EXECUTOR_MULTI_OP_NUM_BUFS


def check_multi_op_bufs(n: int) -> None:
    """copy_multi/reduce_multi_dst vector cap shared by every executor
    (UCC sizes the fixed arg arrays to 7 entries)."""
    if n > MULTI_OP_NUM_BUFS:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"multi-op takes at most {MULTI_OP_NUM_BUFS} "
                       "vectors")


class ExecutorTaskType(enum.IntEnum):
    REDUCE = 0
    REDUCE_STRIDED = 1
    REDUCE_MULTI_DST = 2
    COPY = 3
    COPY_MULTI = 4


@dataclass
class ExecutorTask:
    """One posted task. ``array`` is the result buffer (a list of them for
    the multi ops); ``payload`` is the executor's completion state (the
    CUDA event of EcCuda)."""

    task_type: ExecutorTaskType
    status: Status = Status.IN_PROGRESS
    payload: Any = None
    array: Any = None


class Executor:
    """ucc_ee_executor: init/start/task_post/task_test/task_finalize/stop."""

    EC_NAME = "base"

    def __init__(self):
        self.started = False
        self.context = None

    def start(self, context: Any = None) -> Status:
        self.started = True
        self.context = context
        return Status.OK

    def stop(self) -> Status:
        self.started = False
        return Status.OK

    def finalize(self) -> Status:
        return Status.OK

    # ------------------------------------------------------------------
    def reduce(self, dst, srcs: Sequence[Any], count: int, dt: DataType,
               op: ReductionOp, alpha: Optional[float] = None) -> ExecutorTask:
        raise NotImplementedError

    def reduce_strided(self, dst, src1, src2_base, stride_bytes: int,
                       n_src2: int, count: int, dt: DataType,
                       op: ReductionOp,
                       alpha: Optional[float] = None) -> ExecutorTask:
        raise NotImplementedError

    def reduce_multi_dst(self, jobs: Sequence[dict]) -> ExecutorTask:
        """jobs: [{dst, src1, src2, count, dt, op, alpha?}]"""
        raise NotImplementedError

    def copy(self, dst, src, size_bytes: int) -> ExecutorTask:
        raise NotImplementedError

    def copy_multi(self, pairs: Sequence[tuple]) -> ExecutorTask:
        """pairs: [(dst, src, size_bytes)]"""
        raise NotImplementedError

    def task_test(self, task: ExecutorTask) -> Status:
        return task.status

    def task_finalize(self, task: ExecutorTask) -> None:
        pass


_executors: Dict[MemoryType, Any] = {}


def register_ec(mem_type: MemoryType, executor_cls) -> None:
    _executors[mem_type] = executor_cls


def create_executor(mem_type: MemoryType) -> Executor:
    _ensure_defaults()
    if mem_type not in _executors:
        raise UccError(Status.ERR_NOT_FOUND,
                       f"no execution component for {mem_type.name}")
    return _executors[mem_type]()


def _ensure_defaults() -> None:
    from .cpu import EcCpu
    from .cuda import EcCuda
    _executors.setdefault(MemoryType.HOST, EcCpu)
    _executors.setdefault(MemoryType.CUDA, EcCuda)
