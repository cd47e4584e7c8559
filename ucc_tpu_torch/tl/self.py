"""TL/SELF — loopback transport for single-rank teams (the counterpart of
the JAX package's tl/self).

Every collective type on a team of size 1 (ERR_NOT_SUPPORTED on larger
teams), on HOST and CUDA memory, at score 50, above every other TL: a
1-rank collective's result is its src, so dst receives the bytes of src
(``min`` of the two buffers' ``count`` elements, or ``sum(counts)`` of a
BufferInfoV, from their starts), and an in-place call or one with src
alone (bcast) leaves the buffer as it is. The copy is ``copy_`` between
uint8 views (tl/base ``binfo_u8``): synchronous on the host, on the
caller's current stream on a GPU, where the task completes when an event
recorded after the copy has passed. It is also the service team of 1-rank
teams, with the three trivial service collectives.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..constants import (COLL_TYPE_ALL, COLL_TYPE_LIST, MemoryType,
                         ReductionOp)
from ..core.components import (BaseContext, BaseLib, TransportLayer,
                               register_tl)
from ..schedule.task import CollTask
from ..score.score import CollScore
from ..status import Status, UccError
from .base import AlgSpec, TlTeamBase, binfo_u8, build_scores


class TlSelfTask(CollTask):
    """Local copy task: dst <- src (nothing for in-place or src-less
    calls and for the collectives without buffers)."""

    def __init__(self, init_args, team):
        super().__init__(team=team, args=init_args.args)
        self.init_args = init_args
        self._event = None

    def post_fn(self) -> Status:
        args = self.args
        self._event = None
        if not args.is_inplace and args.src is not None and \
                args.dst is not None and args.src.buffer is not None and \
                args.dst.buffer is not None:
            src, dst = binfo_u8(args.src), binfo_u8(args.dst)
            n = min(src.numel(), dst.numel())
            dst[:n].copy_(src[:n])
            if dst.device.type == "cuda":
                self._event = torch.cuda.Event()
                self._event.record(torch.cuda.current_stream(dst.device))
                self.status = Status.IN_PROGRESS
                return Status.OK
        self.status = Status.OK
        return Status.OK

    def progress_fn(self) -> None:
        if self._event is not None and self._event.query():
            self._event = None
            self.status = Status.OK


class _SelfServiceTask(CollTask):
    def __init__(self, result):
        super().__init__()
        self.result = result

    def post_fn(self) -> Status:
        self.status = Status.OK
        return Status.OK


class TlSelfTeam(TlTeamBase):
    NAME = "self"

    def __init__(self, comp_context, core_team, scope: str = "cl"):
        if core_team.size != 1:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "tl/self requires team size 1")
        super().__init__(comp_context, core_team, scope)

    def get_scores(self) -> CollScore:
        def init(ia, team):
            return TlSelfTask(ia, self)
        return build_scores(self, TlSelf.DEFAULT_SCORE,
                            {c: [AlgSpec(0, "self", init)]
                             for c in COLL_TYPE_LIST},
                            TlSelf.SUPPORTED_MEM_TYPES)

    # ---- service collectives (1-rank trivial) -------------------------
    def service_allreduce(self, arr: np.ndarray, op: ReductionOp) -> CollTask:
        return _SelfServiceTask(arr.copy())

    def service_allgather(self, data: bytes) -> CollTask:
        return _SelfServiceTask([bytes(data)])

    def service_bcast(self, data: Optional[bytes], root: int = 0) -> CollTask:
        return _SelfServiceTask(bytes(data or b""))


@register_tl
class TlSelf(TransportLayer):
    NAME = "self"
    DEFAULT_SCORE = 50
    SUPPORTED_COLLS = COLL_TYPE_ALL
    SUPPORTED_MEM_TYPES = (MemoryType.HOST, MemoryType.CUDA)
    SERVICE_CAPABLE = True
    lib_cls = BaseLib
    context_cls = BaseContext
    team_cls = TlSelfTeam
