"""TL/IPC — cross-process shared-memory transport layer (the port of the
JAX package's tl/ipc).

The tier between tl/shm (threads of one process) and tl/sockets (byte
streams): ranks in different processes of one host match and deliver
through one mmap'd arena (``native.IpcArena``, the port's copy of the
native arena) that holds the tag-matching structures in process-shared
memory. A send whose recv is already posted is copied into the
receiver's arena block inside the push call, with no syscall per
message, and the whole ``tl/host`` algorithm suite runs unchanged on top
(the direct/eager/rndv/fenced accounting, epoch fences and cancel are the
arena's own). Score 25, HOST memory, service-capable: a team that spans
processes of one host takes its service team here.

Rendezvous rides the context OOB address exchange: every rank advertises
(hostname, pid, context uid, heap, window). Ranks of one host derive the
same segment name from the sorted uids of that host's ranks (no extra
OOB round) and race O_CREAT|O_EXCL; the loser attaches. The sizes are
those of the lowest same-host rank, so every process maps one layout.
The creator unlinks the name at ``destroy``; a crashed job's segment is
unlinked by ``native.reap_stale_arenas`` at the next context create once
every process registered in it is dead.

By default the arena is attached only when the same-host ranks span more
than one process (a job of threads keeps tl/shm and creates no segment);
``UCC_TL_IPC_ENABLE=y`` attaches it within one process too, and ``n``
turns the TL off.

One-sided puts and gets reach only segments registered in this process,
as in the JAX package: a target in another process ends the collective
with ERR_NOT_SUPPORTED (tl/sockets carries them across processes).
"""
from __future__ import annotations

import hashlib
import os
import pickle
import time
from typing import Dict, Optional

import numpy as np

from ..constants import COLL_TYPE_ALL, MemoryType
from ..core.components import BaseContext, BaseLib, TransportLayer, register_tl
from ..status import Status, UccError
from ..utils.config import (SIZE_AUTO, ConfigField, ConfigTable, parse_bool,
                            parse_memunits, parse_string, register_table)
from ..utils.log import get_logger
from .host.config_fields import HOST_ALG_FIELDS
from .host.onesided import REGISTRY, local_os_get, local_os_put
from .host.team import HostTlTeam
from .host.transport import SendReq, eager_limit_from_env

logger = get_logger("tl_ipc")

TL_IPC_CONFIG = register_table(ConfigTable(
    prefix="TL_IPC_", name="tl/ipc", fields=HOST_ALG_FIELDS + [
        ConfigField("ENABLE", "auto", "attach the cross-process arena: "
                    "auto = only when the same-host ranks span more than "
                    "one process; y = also within one process; n = the "
                    "TL is off", parse_string),
        ConfigField("HEAP", "256M", "arena payload heap per host (blocks "
                    "in 4K/64K/1M/8M classes; the largest class is the "
                    "largest single message). The lowest same-host "
                    "rank's value sizes the arena", parse_memunits),
        ConfigField("WINDOW", "64M", "arena window heap per host "
                    "(persistent named segments)", parse_memunits),
        ConfigField("EAGER_THRESH", "auto", "eager copy threshold for "
                    "unexpected sends; larger sends are staged into an "
                    "arena block but complete only when received (rndv). "
                    "auto = UCC_HOST_EAGER_LIMIT (default 8k)",
                    parse_memunits),
    ]))

#: how often a progressing endpoint refreshes its beat on the arena's
#: pid board (seconds)
_BEAT_PERIOD = 0.05


class IpcTransport:
    """One endpoint per (context, arena): the face the host algorithms
    drive (``recv_nb``, ``fence``, ``progress``) plus the send path the TL
    context routes through ``send_to``. Its send counters are those of
    ``InProcTransport``; the arena's shared ones are
    ``arena.counters()``."""

    def __init__(self, arena, my_ctx_rank: int, eager_limit: int):
        self.arena = arena
        self.my_ctx_rank = int(my_ctx_rank)
        self.EAGER_THRESHOLD = int(eager_limit)
        self.n_direct = 0
        self.n_eager = 0
        self.n_rndv = 0
        self.n_fenced = 0
        self._last_beat = 0.0

    def send_to(self, peer_ctx_rank: int, key, data: np.ndarray):
        req, kind = self.arena.push(key, int(peer_ctx_rank),
                                    data.reshape(-1).view(np.uint8),
                                    self.EAGER_THRESHOLD)
        if kind == "direct":
            self.n_direct += 1
        elif kind == "eager":
            self.n_eager += 1
        elif kind == "rndv":
            self.n_rndv += 1
        else:
            self.n_fenced += 1
        return req

    def recv_nb(self, key, dst: np.ndarray):
        return self.arena.post_recv(key, self.my_ctx_rank,
                                    dst.reshape(-1).view(np.uint8))

    def fence(self, team_key, min_epoch: int) -> int:
        """Arena-wide (the match space is shared): one rank's fence bounds
        stale traffic for every attached process."""
        return self.arena.fence(team_key, min_epoch)

    def progress(self) -> None:
        """Refresh this rank's beat on the pid board, at most once per
        ``_BEAT_PERIOD``."""
        now = time.monotonic()
        if now - self._last_beat >= _BEAT_PERIOD:
            self._last_beat = now
            self.arena.beat(self.my_ctx_rank)


class TlIpcContext(BaseContext):
    def __init__(self, comp_lib, core_context, config):
        super().__init__(comp_lib, core_context, config)
        self.transport: Optional[IpcTransport] = None
        self.arena = None
        self.peer_addrs: Dict[int, tuple] = {}
        self._uid = core_context._ctx_uid
        self._host = core_context.proc[0]
        self._enable = "auto"
        self._heap = 256 << 20
        self._win = 64 << 20
        self._eager = eager_limit_from_env()
        if config is not None:
            self._enable = str(config.enable).strip().lower() or "auto"
            self._heap = int(config.heap)
            self._win = int(config.window)
            if config.eager_thresh != SIZE_AUTO:
                self._eager = int(config.eager_thresh)

    # -- address plumbing ---------------------------------------------
    def pack_address(self) -> bytes:
        return pickle.dumps((self._host, os.getpid(), self._uid,
                             self._heap, self._win))

    def unpack_addresses(self, addrs: Dict[int, bytes]) -> None:
        for rank, blob in addrs.items():
            if blob:
                self.peer_addrs[rank] = pickle.loads(blob)

    def _same_host_set(self):
        """Context ranks on this process's host, sorted."""
        return sorted(r for r, a in self.peer_addrs.items()
                      if a[0] == self._host)

    def same_arena(self, ctx_rank: int) -> bool:
        a = self.peer_addrs.get(int(ctx_rank))
        return (self.transport is not None and a is not None
                and a[0] == self._host)

    # -- arena rendezvous ---------------------------------------------
    def create_epilog(self) -> None:
        if self._enable == "n":
            return
        local = self._same_host_set()
        if len(local) < 2:
            return
        pids = {self.peer_addrs[r][1] for r in local}
        force = False
        if self._enable not in ("", "auto"):
            try:
                force = parse_bool(self._enable)
            except ValueError:
                force = False
        if len(pids) < 2 and not force:
            return                 # threads of one process: tl/shm's
        from .. import native
        if native.get_lib() is None:
            logger.warning("tl/ipc disabled: native core unavailable "
                           "(the arena has no Python fallback)")
            return
        # unlink the segments of crashed runs first (the kernel reclaims
        # a segment only at unlink)
        try:
            native.reap_stale_arenas()
        except Exception:  # noqa: BLE001 - hygiene must not block create
            logger.debug("stale-arena reap failed", exc_info=True)
        digest = hashlib.sha1(
            "|".join(self.peer_addrs[r][2] for r in local).encode()
        ).hexdigest()[:16]
        name = native.ARENA_PREFIX + digest
        heap, win = self.peer_addrs[local[0]][3:5]
        my_rank = self.core_context.rank
        try:
            self.arena = native.IpcArena(name, heap_bytes=int(heap),
                                         win_bytes=int(win))
        except (RuntimeError, OSError) as e:
            logger.warning("tl/ipc arena attach failed (%s): %s; teams "
                           "fall back to the socket TL", name, e)
            return
        self.arena.register(my_rank)
        self.arena.beat(my_rank)
        self.transport = IpcTransport(self.arena, my_rank, self._eager)
        logger.info("tl/ipc arena %s attached (%s, %d ranks on host, "
                    "%d MiB heap)", name,
                    "created" if self.arena.created else "joined",
                    len(local), int(heap) >> 20)

    # -- send path -----------------------------------------------------
    def send_to(self, peer_ctx_rank: int, key, data: np.ndarray):
        tr = self.transport
        if tr is None:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "ipc arena not attached")
        if not self.same_arena(peer_ctx_rank) \
                and peer_ctx_rank != self.core_context.rank:
            raise UccError(Status.ERR_NOT_FOUND,
                           f"ctx rank {peer_ctx_rank} not in this arena")
        return tr.send_to(peer_ctx_rank, key, data)

    # -- one-sided: only segments registered in this process ----------
    def _check_local(self, desc: dict, what: str) -> None:
        if desc.get("ctx_uid") != self._uid and REGISTRY.read_get(
                desc.get("ctx_uid"), desc.get("seg_id"), 0, 0) is None:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/ipc one-sided {what} targets another "
                           "process")

    def os_put(self, peer_ctx_rank: int, desc: dict, offset: int,
               data: np.ndarray, notify=None) -> None:
        self._check_local(desc, "put")
        local_os_put(desc, offset, data, notify)

    def os_get(self, peer_ctx_rank: int, desc: dict, offset: int,
               dst: np.ndarray):
        self._check_local(desc, "get")
        return local_os_get(desc, offset, dst)

    def os_flush(self, peer_ctx_rank: int) -> SendReq:
        return SendReq(done=True)

    def destroy(self) -> None:
        self.transport = None
        if self.arena is not None:
            # the creator unlinks the name (attached peers keep their
            # mappings until they detach)
            self.arena.detach(unlink=self.arena.created)
            self.arena = None


class TlIpcTeam(HostTlTeam):
    NAME = "ipc"

    def __init__(self, comp_context, core_team, scope: str = "cl"):
        if comp_context.transport is None:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "tl/ipc: no arena attached (one process, "
                           "ranks on other hosts, or UCC_TL_IPC_ENABLE=n)")
        super().__init__(comp_context, core_team, scope)
        my_ctx = core_team.context.rank
        for gr in range(self.size):
            cr = self.ctx_map.eval(gr)
            if cr != my_ctx and not comp_context.same_arena(cr):
                raise UccError(Status.ERR_NOT_SUPPORTED,
                               "tl/ipc requires all team ranks in one "
                               "host's arena")


@register_tl
class TlIpc(TransportLayer):
    NAME = "ipc"
    #: between tl/shm (40, one process) and tl/sockets (10)
    DEFAULT_SCORE = 25
    SUPPORTED_COLLS = COLL_TYPE_ALL
    SUPPORTED_MEM_TYPES = (MemoryType.HOST,)
    SERVICE_CAPABLE = True
    CONTEXT_CONFIG = TL_IPC_CONFIG
    lib_cls = BaseLib
    context_cls = TlIpcContext
    team_cls = TlIpcTeam


TlIpcTeam.TL_CLS = TlIpc
