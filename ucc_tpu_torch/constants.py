"""Core enums and flags of the ucc_tpu_torch public API.

The integer values are those of ``ucc_tpu.constants`` (and of UCC's
ucc.h), so score-map rows, tune strings and wire formats line up between
the two packages. The memory axis is CUDA's: MemoryType.CUDA means "a
torch.Tensor resident in GPU memory"; HOST means numpy or a CPU tensor.
"""
from __future__ import annotations

import enum

import numpy as np
import torch


class CollType(enum.IntFlag):
    """Collective operation types (bitflags, like ucc_coll_type_t)."""

    BARRIER = 1 << 0
    BCAST = 1 << 1
    ALLREDUCE = 1 << 2
    REDUCE = 1 << 3
    ALLTOALL = 1 << 4
    ALLTOALLV = 1 << 5
    ALLGATHER = 1 << 6
    ALLGATHERV = 1 << 7
    GATHER = 1 << 8
    GATHERV = 1 << 9
    SCATTER = 1 << 10
    SCATTERV = 1 << 11
    REDUCE_SCATTER = 1 << 12
    REDUCE_SCATTERV = 1 << 13
    FANIN = 1 << 14
    FANOUT = 1 << 15


COLL_TYPE_ALL = CollType((1 << 16) - 1)
COLL_TYPE_LIST = list(CollType)

#: Rooted collectives — have a root rank whose buffers differ from non-roots
ROOTED_COLLS = (
    CollType.BCAST
    | CollType.REDUCE
    | CollType.GATHER
    | CollType.GATHERV
    | CollType.SCATTER
    | CollType.SCATTERV
    | CollType.FANIN
    | CollType.FANOUT
)


def coll_type_str(ct: CollType) -> str:
    """Pretty name like UCC's ucc_coll_type_str."""
    try:
        return CollType(ct).name.lower()
    except ValueError:
        return f"coll_type_0x{int(ct):x}"


class MemoryType(enum.IntEnum):
    """Where a buffer lives. CUDA takes the place of the JAX package's TPU
    axis with the same integer values."""

    HOST = 0          # numpy / CPU tensor
    CUDA = 1          # torch.Tensor in GPU memory
    CUDA_MANAGED = 2  # managed (unified) memory
    UNKNOWN = 3

    @classmethod
    def parse(cls, s: str) -> "MemoryType":
        s = s.strip().lower()
        aliases = {
            "host": cls.HOST, "cpu": cls.HOST,
            "cuda": cls.CUDA, "gpu": cls.CUDA, "device": cls.CUDA,
            "cuda_managed": cls.CUDA_MANAGED, "managed": cls.CUDA_MANAGED,
        }
        if s not in aliases:
            raise ValueError(f"unknown memory type '{s}'")
        return aliases[s]


class ReductionOp(enum.IntEnum):
    """13 predefined reduction ops (ucc_reduction_op_t)."""

    SUM = 0
    PROD = 1
    MAX = 2
    MIN = 3
    LAND = 4
    LOR = 5
    LXOR = 6
    BAND = 7
    BOR = 8
    BXOR = 9
    MINLOC = 10
    MAXLOC = 11
    AVG = 12


class DataType(enum.IntEnum):
    """18 predefined datatypes (ucc_datatype_t)."""

    INT8 = 0
    UINT8 = 1
    INT16 = 2
    UINT16 = 3
    INT32 = 4
    UINT32 = 5
    INT64 = 6
    UINT64 = 7
    INT128 = 8
    UINT128 = 9
    FLOAT16 = 10
    FLOAT32 = 11
    FLOAT64 = 12
    FLOAT128 = 13
    BFLOAT16 = 14
    FLOAT32_COMPLEX = 15
    FLOAT64_COMPLEX = 16
    FLOAT128_COMPLEX = 17


#: DataType -> (size, numpy dtype or None, torch dtype or None). numpy has
#: no bfloat16 without ml_dtypes, which the port does not depend on.
_DT_INFO = {
    DataType.INT8: (1, np.dtype(np.int8), torch.int8),
    DataType.UINT8: (1, np.dtype(np.uint8), torch.uint8),
    DataType.INT16: (2, np.dtype(np.int16), torch.int16),
    DataType.UINT16: (2, np.dtype(np.uint16), getattr(torch, "uint16", None)),
    DataType.INT32: (4, np.dtype(np.int32), torch.int32),
    DataType.UINT32: (4, np.dtype(np.uint32), getattr(torch, "uint32", None)),
    DataType.INT64: (8, np.dtype(np.int64), torch.int64),
    DataType.UINT64: (8, np.dtype(np.uint64), getattr(torch, "uint64", None)),
    DataType.INT128: (16, None, None),
    DataType.UINT128: (16, None, None),
    DataType.FLOAT16: (2, np.dtype(np.float16), torch.float16),
    DataType.FLOAT32: (4, np.dtype(np.float32), torch.float32),
    DataType.FLOAT64: (8, np.dtype(np.float64), torch.float64),
    DataType.FLOAT128: (16, None, None),
    DataType.BFLOAT16: (2, None, torch.bfloat16),
    DataType.FLOAT32_COMPLEX: (8, np.dtype(np.complex64), torch.complex64),
    DataType.FLOAT64_COMPLEX: (16, np.dtype(np.complex128),
                               torch.complex128),
    DataType.FLOAT128_COMPLEX: (32, None, None),
}

_TORCH_TO_DT = {info[2]: dt for dt, info in _DT_INFO.items()
                if info[2] is not None}


class GenericDataType:
    """User-defined datatype (ucc_dt_create_generic): pack/unpack/reduce
    callbacks over contiguous byte views. One without a reduce_cb serves
    only non-reducing collectives, as in UCC."""

    __slots__ = ("size", "pack_cb", "unpack_cb", "reduce_cb", "name")

    def __init__(self, size: int, pack_cb=None, unpack_cb=None, reduce_cb=None,
                 name: str = "generic"):
        if size <= 0:
            raise ValueError("generic datatype size must be positive")
        self.size = int(size)
        self.pack_cb = pack_cb
        self.unpack_cb = unpack_cb
        self.reduce_cb = reduce_cb
        self.name = name

    def __repr__(self):
        return f"GenericDataType({self.name}, size={self.size})"


def dt_size(dt: "DataType | GenericDataType") -> int:
    """Element size in bytes (ucc_dt_size analog)."""
    if isinstance(dt, GenericDataType):
        return dt.size
    return _DT_INFO[DataType(dt)][0]


def dt_numpy(dt: DataType) -> np.dtype:
    """numpy dtype for a predefined DataType; raises where numpy has none."""
    nd = _DT_INFO[DataType(dt)][1]
    if nd is None:
        raise TypeError(f"{DataType(dt).name} has no numpy representation")
    return nd


_NP_TO_DT = {info[1]: dt for dt, info in _DT_INFO.items()
             if info[1] is not None}


def dt_from_numpy(nd) -> DataType:
    nd = np.dtype(nd)
    if nd not in _NP_TO_DT:
        raise TypeError(f"no predefined DataType for numpy dtype {nd}")
    return _NP_TO_DT[nd]


def dt_torch(dt: DataType) -> torch.dtype:
    """torch dtype for a predefined DataType; raises for 128-bit types."""
    td = _DT_INFO[DataType(dt)][2]
    if td is None:
        raise TypeError(f"{DataType(dt).name} not representable in torch")
    return td


def dt_from_torch(td: torch.dtype) -> DataType:
    if td not in _TORCH_TO_DT:
        raise TypeError(f"no predefined DataType for torch dtype {td}")
    return _TORCH_TO_DT[td]


class ThreadMode(enum.IntEnum):
    """ucc_thread_mode_t."""

    SINGLE = 0
    FUNNELED = 1
    MULTIPLE = 2


class CollSyncType(enum.IntEnum):
    """Synchronous vs non-synchronous collective model."""

    NON_SYNC_COLLECTIVES = 0
    SYNC_COLLECTIVES = 1


class CollArgsFlags(enum.IntFlag):
    """ucc_coll_args_flags_t."""

    IN_PLACE = 1 << 0
    PERSISTENT = 1 << 1
    COUNT_64BIT = 1 << 2
    DISPLACEMENTS_64BIT = 1 << 3
    CONTIG_SRC_BUFFER = 1 << 4
    CONTIG_DST_BUFFER = 1 << 5
    TIMEOUT = 1 << 6
    MEM_MAPPED_BUFFERS = 1 << 7
    MEM_MAP_SRC_MEMH = 1 << 8
    MEM_MAP_DST_MEMH = 1 << 9


class EventType(enum.IntEnum):
    """Task/schedule events (ucc_event_t)."""

    EVENT_COMPLETED = 0
    EVENT_SCHEDULE_STARTED = 1
    EVENT_TASK_STARTED = 2
    EVENT_COMPLETED_SCHEDULE = 3
    EVENT_ERROR = 4
    EVENT_LAST = 5


class EeType(enum.IntEnum):
    """Execution-engine types (ucc_ee_type_t). The values are the JAX
    package's; its TPU_STREAM (0) is UCC's own UCC_EE_CUDA_STREAM."""

    CUDA_STREAM = 0    # triggered on data readiness on the card's streams
    CPU_THREAD = 1
    LAST = 2
