"""TL/SHM — in-process shared-memory transport layer (the port of the JAX
package's tl/shm).

Ranks whose contexts live in one process (threads) exchange messages
through mailboxes (``tl/host/transport.InProcTransport``, matched by the
native core when it is built) and run the ``tl/host`` algorithm suite on
HOST memory: numpy arrays, CPU tensors and bytes-like objects. Score 40,
HOST only, so selection on CUDA memory does not see it. It is
service-capable: every multi-rank team of contexts in one process gets a
tl/shm service team, over which the core agrees team ids and runs the
datatype check of rooted collectives. A team with a rank in another
process is declined (tl/ipc and tl/sockets serve those).

One-sided puts and gets (``tl/host/onesided.py``) apply directly to the
target segment under the registry lock, since every peer is in this
process; a flush is a completed no-op.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

from ..constants import COLL_TYPE_ALL, MemoryType
from ..core.components import BaseContext, BaseLib, TransportLayer, register_tl
from ..status import Status, UccError
from ..utils.config import (SIZE_AUTO, ConfigField, ConfigTable, parse_bool,
                            parse_memunits, parse_string, register_table)
from .host.config_fields import HOST_ALG_FIELDS
from .host.onesided import local_os_get, local_os_put, sw_max_work_buffer
from .host.team import HostTlTeam
from .host.transport import InProcTransport, SendReq

TL_SHM_CONFIG = register_table(ConfigTable(
    prefix="TL_SHM_", name="tl/shm", fields=HOST_ALG_FIELDS + [
        ConfigField("EAGER_THRESH", "auto", "eager copy threshold for "
                    "unexpected sends; larger sends are zero-copy "
                    "rendezvous (sends matching a posted recv are always "
                    "copy-free). auto = UCC_HOST_EAGER_LIMIT (default 8k)",
                    parse_memunits),
        ConfigField("NATIVE", "auto", "use the native C++ tag matcher for "
                    "this endpoint. auto = on when the core builds, else "
                    "the Python matcher; y = required (an endpoint whose "
                    "core cannot be built raises); n = the Python matcher. "
                    "The process-wide switch is UCC_NATIVE", parse_string),
    ]))


class TlShmContext(BaseContext):
    def __init__(self, comp_lib, core_context, config):
        super().__init__(comp_lib, core_context, config)
        use_native = None
        if config is not None:
            nv = str(config.get("native")).strip().lower()
            if nv and nv != "auto":
                use_native = parse_bool(nv)
        self.transport = InProcTransport(use_native=use_native)
        if config is not None and config.eager_thresh != SIZE_AUTO:
            self.transport.EAGER_THRESHOLD = config.eager_thresh
        rec = getattr(core_context, "flight", None)
        if rec is not None:
            self.transport._flight = rec.wire
        self.peer_info: Dict[int, tuple] = {}
        self._mailboxes: Dict[int, InProcTransport] = {}

    def pack_address(self) -> bytes:
        return pickle.dumps((os.getpid(), self.transport.uid))

    def unpack_addresses(self, addrs: Dict[int, bytes]) -> None:
        for rank, blob in addrs.items():
            if blob:
                self.peer_info[rank] = pickle.loads(blob)

    def same_process(self, ctx_rank: int) -> bool:
        info = self.peer_info.get(ctx_rank)
        return bool(info) and info[0] == os.getpid()

    def _peer(self, ctx_rank: int) -> InProcTransport:
        peer = self._mailboxes.get(ctx_rank)
        if peer is None:
            info = self.peer_info.get(ctx_rank)
            if info is None:
                raise UccError(Status.ERR_NOT_FOUND,
                               f"no shm address for ctx rank {ctx_rank}")
            peer = InProcTransport.resolve(info[1].encode())
            if peer is None:
                raise UccError(Status.ERR_NOT_FOUND,
                               f"shm peer {ctx_rank} endpoint gone")
            self._mailboxes[ctx_rank] = peer
        return peer

    def send_to(self, peer_ctx_rank: int, key, data: np.ndarray, crc=None):
        return self.transport.send_nb(self._peer(peer_ctx_rank), key, data,
                                      crc=crc)

    # -- one-sided: in-order, synchronous application ------------------
    def os_put(self, peer_ctx_rank: int, desc: dict, offset: int,
               data: np.ndarray, notify=None) -> None:
        local_os_put(desc, offset, data, notify)

    def os_get(self, peer_ctx_rank: int, desc: dict, offset: int,
               dst: np.ndarray):
        return local_os_get(desc, offset, dst)

    def os_flush(self, peer_ctx_rank: int) -> SendReq:
        return SendReq(done=True)

    def global_work_buffer_size(self) -> int:
        """Scratch a one-sided collective may take from the user's
        global_work_buffer: the sliding window's in-flight gets."""
        return sw_max_work_buffer(self.config)

    def destroy(self) -> None:
        self.transport.close()


class TlShmTeam(HostTlTeam):
    NAME = "shm"

    def __init__(self, comp_context, core_team, scope: str = "cl"):
        super().__init__(comp_context, core_team, scope)
        my_ctx = core_team.context.rank
        for gr in range(self.size):
            cr = self.ctx_map.eval(gr)
            if cr != my_ctx and not comp_context.same_process(cr):
                raise UccError(Status.ERR_NOT_SUPPORTED,
                               "tl/shm requires all team ranks in-process")


@register_tl
class TlShm(TransportLayer):
    NAME = "shm"
    DEFAULT_SCORE = 40
    SUPPORTED_COLLS = COLL_TYPE_ALL
    SUPPORTED_MEM_TYPES = (MemoryType.HOST,)
    SERVICE_CAPABLE = True
    CONTEXT_CONFIG = TL_SHM_CONFIG
    lib_cls = BaseLib
    context_cls = TlShmContext
    team_cls = TlShmTeam


TlShmTeam.TL_CLS = TlShm
