"""Public parameter/argument structures.

UCC's masked-field param structs (ucc_lib_params_t, ucc_context_params_t,
ucc_team_params_t, ucc_coll_args_t) with the mask expressed as Optional
fields — ``None`` means "not set".

Buffers: device collectives take ``torch.Tensor``s; the result is written
INTO the caller's ``dst`` tensor, as UCC does in C (the JAX package instead
rebinds ``dst.buffer``, because jax arrays are immutable).
``BufferInfo.count`` is in elements of ``datatype``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Union

from ..constants import (CollArgsFlags, CollSyncType, CollType, DataType,
                         MemoryType, ReductionOp, ThreadMode)
from ..status import Status
from ..utils.ep_map import EpMap


# ---------------------------------------------------------------------------
# OOB
# ---------------------------------------------------------------------------

class OobRequest:
    """Handle for a nonblocking OOB allgather (ucc_oob_coll_t semantics:
    allgather/req_test/req_free)."""

    def test(self) -> Status:
        raise NotImplementedError

    @property
    def result(self) -> List[bytes]:
        raise NotImplementedError

    def free(self) -> None:
        pass

    def wait(self) -> List[bytes]:
        # adaptive backoff: pure sleep(0) spinning turns a 512-thread
        # simulated bootstrap into GIL thrash that starves even thread
        # STARTUP; after a short hot spin, waiters back off
        # exponentially to a 20ms poll — invisible against store RTTs
        # and bootstrap deadlines, and it keeps the GIL available for
        # ranks still doing real work
        import time
        spins = 0
        delay = 0.0005
        while self.test() == Status.IN_PROGRESS:
            spins += 1
            if spins < 20:
                time.sleep(0)
            else:
                time.sleep(delay)
                delay = min(delay * 1.5, 0.02)
        return self.result


class OobColl:
    """Out-of-band bootstrap collective provided by the caller (MPI, a TCP
    store, threads-in-process for tests)."""

    @property
    def oob_ep(self) -> int:           # my rank in the OOB world
        raise NotImplementedError

    @property
    def n_oob_eps(self) -> int:        # OOB world size
        raise NotImplementedError

    def allgather(self, data: bytes) -> OobRequest:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# lib / context / team params
# ---------------------------------------------------------------------------

class ContextType(enum.IntEnum):
    EXCLUSIVE = 0
    SHARED = 1


@dataclass
class LibParams:
    """ucc_lib_params_t."""

    thread_mode: ThreadMode = ThreadMode.SINGLE
    coll_types: Optional[CollType] = None      # requested coll mask
    sync_type: CollSyncType = CollSyncType.NON_SYNC_COLLECTIVES


@dataclass
class LibAttr:
    thread_mode: ThreadMode = ThreadMode.SINGLE
    coll_types: CollType = CollType(0)


@dataclass
class ContextParams:
    """ucc_context_params_t."""

    type: ContextType = ContextType.EXCLUSIVE
    oob: Optional[OobColl] = None


@dataclass
class ContextAttr:
    """ucc_context_attr_t: the context type, its packed address, and the
    scratch size one-sided collectives ask of a user's
    ``global_work_buffer``."""

    type: ContextType = ContextType.EXCLUSIVE
    ctx_addr: bytes = b""
    ctx_addr_len: int = 0
    global_work_buffer_size: int = 0


@dataclass
class TeamParams:
    """ucc_team_params_t: ep_map kinds FULL/STRIDED/ARRAY/CB, per-team
    OOB, ordering/sync requirements."""

    oob: Optional[OobColl] = None
    ep: Optional[int] = None                 # my endpoint (rank) if known
    ep_map: Optional[EpMap] = None           # team rank -> context OOB rank
    team_size: Optional[int] = None
    ordered: bool = True                     # EP_RANGE contig / ordering flag
    id: Optional[int] = None                 # user-provided team id
    #: QoS priority class: 0 = bulk (lowest) .. 3 = latency (highest);
    #: None resolves from the UCC_TEAM_PRIORITY env at team create
    #: (default 1). Selects the progress-queue lane for every collective
    #: this team posts.
    priority: Optional[int] = None


@dataclass
class TeamAttr:
    size: int = 0
    ep: int = 0
    coll_types: CollType = CollType(0)


# ---------------------------------------------------------------------------
# collective args
# ---------------------------------------------------------------------------

@dataclass
class BufferInfo:
    """ucc_coll_buffer_info_t: buffer + count + datatype (+ mem type)."""

    buffer: Any = None
    count: int = 0
    datatype: DataType = DataType.UINT8
    mem_type: Optional[MemoryType] = None    # None -> auto-detect via MC


@dataclass
class BufferInfoV:
    """ucc_coll_buffer_info_v_t: vector variant with per-rank counts and
    displacements (64-bit clean by construction — Python ints)."""

    buffer: Any = None
    counts: Optional[Sequence[int]] = None
    displacements: Optional[Sequence[int]] = None
    datatype: DataType = DataType.UINT8
    mem_type: Optional[MemoryType] = None


@dataclass
class ActiveSet:
    """Subset execution over (start, stride, size)."""

    start: int = 0
    stride: int = 1
    size: int = 0


@dataclass
class CollArgs:
    """ucc_coll_args_t."""

    coll_type: CollType = CollType.BARRIER
    src: Optional[Union[BufferInfo, BufferInfoV]] = None
    dst: Optional[Union[BufferInfo, BufferInfoV]] = None
    op: Optional[ReductionOp] = None
    root: int = 0
    flags: CollArgsFlags = CollArgsFlags(0)
    tag: Optional[int] = None
    timeout: float = 0.0                     # seconds, used with FLAG TIMEOUT
    active_set: Optional[ActiveSet] = None
    cb: Optional[Callable[[Any, Status], None]] = None
    global_work_buffer: Any = None           # one-sided scratchpad
    #: mem_map handles of one-sided collectives: one exported handle
    #: (local) or a list of one per team rank (global; flags
    #: MEM_MAP_SRC_MEMH / MEM_MAP_DST_MEMH)
    src_memh: Any = None
    dst_memh: Any = None

    # -- convenience predicates ------------------------------------------
    @property
    def is_inplace(self) -> bool:
        return bool(self.flags & CollArgsFlags.IN_PLACE)

    @property
    def is_persistent(self) -> bool:
        return bool(self.flags & CollArgsFlags.PERSISTENT)

    @property
    def is_rooted(self) -> bool:
        from ..constants import ROOTED_COLLS
        return bool(self.coll_type & ROOTED_COLLS)


def coll_args_msgsize(args: CollArgs, team_size: int, rank: int = 0) -> int:
    """ucc_coll_args_msgsize: bytes that drive score-range selection.
    Vector colls sum their counts; rooted colls use the root-relevant
    size."""
    from ..constants import dt_size

    ct = args.coll_type
    if ct == CollType.BARRIER or ct == CollType.FANIN or ct == CollType.FANOUT:
        return 0
    src, dst = args.src, args.dst

    def binfo_size(bi) -> int:
        if bi is None:
            return 0
        if isinstance(bi, BufferInfoV):
            if not bi.counts:
                return 0
            return sum(int(c) for c in bi.counts) * dt_size(bi.datatype)
        return int(bi.count) * dt_size(bi.datatype)

    if ct in (CollType.ALLGATHER, CollType.ALLGATHERV, CollType.GATHER,
              CollType.GATHERV, CollType.ALLTOALL, CollType.ALLTOALLV):
        return binfo_size(dst)
    if ct in (CollType.SCATTER, CollType.SCATTERV):
        return binfo_size(src) if src is not None else binfo_size(dst)
    # allreduce/reduce/bcast/reduce_scatter(v)
    if ct == CollType.BCAST:
        return binfo_size(src)
    return binfo_size(dst) or binfo_size(src)
