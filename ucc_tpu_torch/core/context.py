"""Context — per-process communication resource bundle (UCC's
``ucc_context_create``).

Create all TL contexts then CL contexts, init the progress queue, run the
blocking OOB address exchange, then give TLs a ``create_epilog`` pass.
``progress()`` drives the progress queue plus registered component
progress callbacks.

``mem_map`` exports a buffer for one-sided access: a HOST buffer is
registered in the process's segment registry (``tl/host/onesided.py``)
under (context uid, segment id), which the host TLs' puts and gets
address; a CUDA buffer exports its metadata only.

A TL context that declines (ERR_NOT_SUPPORTED) is skipped; any other
failure raises, so a device that was asked for and is missing stops
context creation instead of leaving the job to run elsewhere.
"""
from __future__ import annotations

import itertools
import os
import pickle
import socket
import uuid
from typing import Any, Dict, List, Optional

from ..api.types import ContextAttr, ContextParams
from ..constants import ThreadMode
from ..schedule.progress import ProgressQueue, ProgressQueueMT
from ..status import Status, UccError
from ..utils.log import get_logger
from .lib import Lib

logger = get_logger("core")


class TlContextHandle:
    def __init__(self, tl_lib, context: "Context"):
        self.tl_lib = tl_lib
        cfg = context.lib.component_config(tl_lib.tl_cls.CONTEXT_CONFIG)
        self.obj = tl_lib.tl_cls.context_cls(tl_lib.obj, context, cfg)

    @property
    def name(self) -> str:
        return self.tl_lib.name


class ClContextHandle:
    def __init__(self, cl_lib, context: "Context"):
        self.cl_lib = cl_lib
        cfg = context.lib.component_config(cl_lib.cl_cls.CONTEXT_CONFIG)
        self.obj = cl_lib.cl_cls.context_cls(cl_lib.obj, context, cfg)

    @property
    def name(self) -> str:
        return self.cl_lib.name


class Context:
    """ucc_context_h."""

    def __init__(self, lib: Lib, params: Optional[ContextParams] = None):
        self.lib = lib
        self.params = params or ContextParams()
        oob = self.params.oob
        self.rank = oob.oob_ep if oob else 0
        self.size = oob.n_oob_eps if oob else 1
        #: process identity: device TLs rendezvous only ranks that share
        #: a process
        self.proc = (socket.gethostname(), os.getpid())
        #: process-unique context identity: mem-map segments are
        #: addressed by (uid, segment id)
        self._ctx_uid = uuid.uuid4().hex

        if lib.params.thread_mode == ThreadMode.MULTIPLE:
            self.progress_queue = ProgressQueueMT()
        else:
            self.progress_queue = ProgressQueue()

        # TL contexts first, then CLs
        self.tl_contexts: Dict[str, TlContextHandle] = {}
        for name, tl_lib in lib.tl_libs.items():
            try:
                self.tl_contexts[name] = TlContextHandle(tl_lib, self)
            except UccError as e:
                if e.status != Status.ERR_NOT_SUPPORTED:
                    raise
                logger.warning("TL %s context create skipped: %s", name, e)
        self.cl_contexts: Dict[str, ClContextHandle] = {}
        for cl_lib in lib.cl_libs:
            self.cl_contexts[cl_lib.name] = ClContextHandle(cl_lib, self)

        # blocking OOB address exchange
        self.addr_storage: List[Dict[str, Any]] = []
        payload = {"proc": self.proc,
                   "tl": {name: h.obj.pack_address()
                          for name, h in self.tl_contexts.items()}}
        self._packed_addr = pickle.dumps(payload)
        if oob is not None:
            req = oob.allgather(self._packed_addr)
            peers = req.wait()
            req.free()
            self.addr_storage = [pickle.loads(p) for p in peers]
        else:
            self.addr_storage = [payload]
        for name, h in self.tl_contexts.items():
            h.obj.unpack_addresses(
                {r: a["tl"].get(name, b"")
                 for r, a in enumerate(self.addr_storage)})
        for h in self.tl_contexts.values():
            h.obj.create_epilog()

        self._team_id_counter = 1
        self._destroyed = False
        self._mem_maps: Dict[int, Any] = {}
        # next() on a count is atomic under the GIL: concurrent mem_map
        # calls never mint the same id
        self._seg_ids = itertools.count(1)

    # ------------------------------------------------------------------
    def local_ranks(self) -> set:
        """Context ranks living in this process."""
        return {r for r, a in enumerate(self.addr_storage)
                if tuple(a["proc"]) == self.proc}

    def get_attr(self) -> ContextAttr:
        """ucc_context_get_attr: the packed address and the global work
        buffer size, the largest any TL context asks for."""
        wbs = 0
        for h in self.tl_contexts.values():
            fn = getattr(h.obj, "global_work_buffer_size", None)
            if fn is not None:
                wbs = max(wbs, int(fn()))
        return ContextAttr(type=self.params.type,
                           ctx_addr=self._packed_addr,
                           ctx_addr_len=len(self._packed_addr),
                           global_work_buffer_size=wbs)

    def progress(self) -> int:
        """ucc_context_progress."""
        return self.progress_queue.progress()

    def create_team_post(self, params) -> "Any":
        from .team import Team
        return Team(self, params)

    def create_team(self, params, progress_others=None) -> "Any":
        """Blocking convenience: post + test loop."""
        team = self.create_team_post(params)
        while team.create_test() == Status.IN_PROGRESS:
            self.progress()
            if progress_others:
                progress_others()
        return team

    # ------------------------------------------------------------------
    # memory map (ucc_mem_map / ucc_mem_unmap)
    def mem_map(self, buffer, mode: str = "export") -> bytes:
        """Export *buffer*; returns an opaque handle (a pickled
        descriptor). HOST buffers are registered for one-sided access;
        other memory exports its metadata only."""
        from ..constants import MemoryType
        from ..mc.base import detect_mem_type
        mt = detect_mem_type(buffer)
        nbytes = getattr(buffer, "nbytes", None)
        if nbytes is None:
            nbytes = len(buffer)
        seg_id = next(self._seg_ids)
        desc = {"ctx_rank": self.rank, "ctx_uid": self._ctx_uid,
                "mem_type": int(mt), "nbytes": int(nbytes), "mode": mode,
                "seg_id": seg_id, "onesided": False,
                "addr_id": id(buffer)}
        if mt == MemoryType.HOST:
            from ..tl.host.onesided import REGISTRY
            desc["nbytes"] = REGISTRY.register(self._ctx_uid, seg_id, buffer)
            desc["onesided"] = True
        self._mem_maps[seg_id] = buffer
        return pickle.dumps(desc)

    def mem_unmap(self, handle: bytes) -> Status:
        desc = pickle.loads(handle)
        seg_id = desc.get("seg_id")
        if self._mem_maps.pop(seg_id, None) is not None and \
                desc.get("onesided"):
            from ..tl.host.onesided import REGISTRY
            REGISTRY.unregister(self._ctx_uid, seg_id)
        return Status.OK

    def mem_import(self, handle: bytes) -> dict:
        """A peer's exported handle as a descriptor dict; ``buffer`` is
        the live buffer only when this context exported it."""
        desc = pickle.loads(handle)
        if desc.get("ctx_uid") == self._ctx_uid:
            desc["buffer"] = self._mem_maps.get(desc.get("seg_id"))
        else:
            desc["buffer"] = None
        return desc

    def destroy(self) -> Status:
        if self._destroyed:
            return Status.OK
        for h in self.tl_contexts.values():
            h.obj.destroy()
        if self._mem_maps:
            from ..tl.host.onesided import REGISTRY
            REGISTRY.unregister_ctx(self._ctx_uid)
            self._mem_maps.clear()
        self._destroyed = True
        return Status.OK
