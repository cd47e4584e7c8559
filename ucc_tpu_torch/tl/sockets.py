"""TL/SOCKET — tagged point-to-point over TCP (the port of the JAX
package's tl/sockets).

Every context runs a small listener; its (host, port) rides the context
OOB address exchange. Connections open lazily on the first send to a
peer, or at team create for teams of up to UCC_TL_SOCKET_PRECONNECT ranks
(a zero-byte tagged exchange). One reader thread per accepted connection
demultiplexes frames into the same ``Mailbox`` the in-process transport
uses, so the whole ``tl/host`` algorithm suite runs unchanged over TCP.
Score 10, HOST memory, service-capable: a team that spans processes on
hosts without a shared arena gets its service team here.

Frame: [key_len u32][payload_len u64][key_crc u32][payload_crc_word u64]
[pickled key][payload bytes]. The key crc is always checked before the
key is unpickled, and implausible lengths are refused before anything is
allocated: a torn or desynced stream drops its connection with one error
line instead of unpickling garbage or killing the reader. The payload crc
word is ``(1 << 32) | crc32`` of the payload under ``UCC_INTEGRITY=wire``
or ``verify`` and 0 (unchecked) when integrity is off; the receiving
mailbox verifies it at delivery.

One-sided frames (``tl/host/onesided.py``): a put is applied by the
target's reader thread; a get and a flush are answered through a reply
thread, so a reader never blocks in a send.

The listener binds all interfaces and advertises the address of the
interface that carries the default route (127.0.0.1 where there is none);
``UCC_TL_SOCKET_BIND_HOST`` binds and advertises one address instead.
``close()`` shuts every socket and joins every thread it started; an
outbound connection closes gracefully, so a peer still receives what was
sent before it.
"""
from __future__ import annotations

import pickle
import socket
import struct
import threading
import time
import zlib
from queue import SimpleQueue
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import integrity as _integrity
from ..constants import COLL_TYPE_ALL, MemoryType
from ..core.components import BaseContext, BaseLib, TransportLayer, register_tl
from ..core.oob import _connect, _shut
from ..status import Status, UccError
from ..utils.config import (ConfigField, ConfigTable, parse_string,
                            parse_uint, register_table)
from ..utils.log import get_logger
from .host.config_fields import HOST_ALG_FIELDS
from .host.onesided import (OS_FLUSH, OS_GET, OS_OPS, OS_PUT, REGISTRY,
                            local_os_get, local_os_put, sw_max_work_buffer)
from .host.team import HostTlTeam
from .host.transport import Mailbox, RecvReq, SendReq, _PendingSend

logger = get_logger("tl_socket")

_HDR = struct.Struct("!IQIQ")   # key_len, payload_len, key_crc, pcrc word

#: desync bounds: keys are small pickled tuples, and one frame carries at
#: most one collective's fragment
_MAX_KEY_BYTES = 1 << 20
_MAX_FRAME_BYTES = 1 << 30

_EMPTY = np.empty(0, dtype=np.uint8)


class FlushReq:
    """Remote-completion fence (ucp_ep_flush): completes when the target
    acks; a nonzero error count in the ack fails it (an earlier put or get
    on this connection was rejected)."""

    __slots__ = ("_inner", "error", "done")

    def __init__(self, inner: RecvReq):
        self._inner = inner
        self.error = None
        self.done = False

    def test(self) -> bool:
        if self.done:
            return True
        if not self._inner.test():
            return False
        self.done = True
        if self._inner.nbytes != 8:
            self.error = "one-sided flush ack malformed"
        else:
            nerr = int(self._inner.dst.view(np.uint64)[0])
            if nerr:
                self.error = (f"one-sided flush: target rejected {nerr} "
                              "prior operation(s) (bad handle/bounds)")
        return True


TL_SOCKET_CONFIG = register_table(ConfigTable(
    prefix="TL_SOCKET_", name="tl/socket", fields=HOST_ALG_FIELDS + [
        ConfigField("BIND_HOST", "", "address to bind and advertise "
                    "(default: bind all interfaces, advertise the default "
                    "route's interface, 127.0.0.1 fallback)", parse_string),
        ConfigField("PRECONNECT", "0", "team sizes up to this many ranks "
                    "open every TCP connection during team create by a "
                    "zero-byte tagged exchange; 0 = connect lazily on "
                    "the first send", parse_uint),
    ]))


#: SIOCGIFADDR: an interface's IPv4 address
_SIOCGIFADDR = 0x8915


def _default_host() -> str:
    """The IPv4 address of the interface that carries the default route
    (lowest metric first), else 127.0.0.1. Read from the kernel's routing
    table and the interface itself: nothing is sent or connected."""
    try:
        import fcntl
        with open("/proc/net/route") as f:
            rows = [ln.split() for ln in f.read().splitlines()[1:]]
        # Iface Destination Gateway Flags RefCnt Use Metric Mask ...
        routes = sorted((int(r[6]), r[0]) for r in rows
                        if len(r) > 7 and r[1] == "00000000"
                        and r[7] == "00000000" and int(r[3], 16) & 1)
        for _, iface in routes:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                ifreq = struct.pack("256s", iface.encode()[:15])
                got = fcntl.ioctl(s.fileno(), _SIOCGIFADDR, ifreq)
                return socket.inet_ntoa(got[20:24])
            except OSError:
                continue
            finally:
                s.close()
    except (OSError, ValueError, ImportError):
        pass
    return "127.0.0.1"


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        b = sock.recv(min(n - got, 1 << 20))
        if not b:
            raise ConnectionError("socket peer closed")
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


class SocketTransport:
    """Listener, lazy outbound connections, reader threads."""

    def __init__(self, bind_host: str = ""):
        self.mailbox = Mailbox()
        self.host = bind_host or _default_host()
        self.lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self.lsock.bind((self.host if bind_host else "0.0.0.0", 0))
            self.lsock.listen(128)
        except OSError:
            self.lsock.close()
            raise
        self.port = self.lsock.getsockname()[1]
        self._conns: Dict[Tuple[str, int], socket.socket] = {}
        self._send_locks: Dict[Tuple[str, int], threading.Lock] = {}
        self._lock = threading.Lock()
        self._os_reply_seq = 0
        #: accepted connections and their reader threads (close shuts and
        #: joins them)
        self._readers: List[Tuple[socket.socket, threading.Thread]] = []
        # one-sided replies (get data, flush acks) leave through their own
        # thread, started on the first reply: a reader that sent them
        # itself would stop draining its socket, and two hosts replying
        # to each other over full buffers would deadlock
        self._reply_q: "SimpleQueue" = SimpleQueue()
        self._reply_thread: Optional[threading.Thread] = None
        self._closing = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="ucc-sock-accept")
        self._accept_thread.start()

    # ------------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self.lsock.accept()
            except OSError:
                return
            with self._lock:
                if self._closing:
                    _shut(conn)
                    return
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                th = threading.Thread(target=self._reader, args=(conn,),
                                      daemon=True, name="ucc-sock-reader")
                self._readers = [(c, t) for c, t in self._readers
                                 if t.is_alive()]
                self._readers.append((conn, th))
            th.start()

    def _reader(self, conn: socket.socket) -> None:
        # per-connection one-sided error count: a flush ack reports (and
        # resets) the rejections among the frames this connection carried
        # since the last flush (TCP ordering makes it a fence for exactly
        # the initiator's earlier operations)
        errbox = [0]
        try:
            peer = conn.getpeername()
        except OSError:
            peer = "?"
        try:
            while True:
                hdr = _recv_exact(conn, _HDR.size)
                klen, plen, kcrc, pcrcw = _HDR.unpack(hdr)
                # a desynced stream decodes payload bytes as a header:
                # validate before allocating or reading
                if klen > _MAX_KEY_BYTES or plen > _MAX_FRAME_BYTES:
                    logger.error(
                        "socket frame desync from %s (implausible header "
                        "klen=%d plen=%d): dropping connection",
                        peer, klen, plen)
                    _shut(conn)
                    return
                kb = _recv_exact(conn, klen)
                if zlib.crc32(kb) & 0xFFFFFFFF != kcrc:
                    from ..obs import metrics
                    logger.error(
                        "%s: socket frame key crc mismatch from %s "
                        "(%d-byte key, head %r): dropping connection",
                        Status.ERR_DATA_CORRUPTED.name, peer, klen, kb[:16])
                    if metrics.ENABLED:
                        metrics.inc("integrity_wire_mismatch",
                                    component="tl/socket")
                    _shut(conn)
                    return
                try:
                    # a corrupt key may fail to unpickle, unpickle to a
                    # malformed one-sided tuple, or be unhashable: the
                    # stream cannot be resynced, so the connection goes
                    # (the sender reconnects) and the reader ends cleanly
                    key = pickle.loads(kb)
                    payload = _recv_exact(conn, plen)
                    data = np.frombuffer(payload, dtype=np.uint8)
                    if isinstance(key, tuple) and key and key[0] in OS_OPS:
                        # one-sided frames are applied here, by the
                        # target's reader thread
                        self._handle_onesided(key, data, errbox)
                        continue
                    self.mailbox.push(key, _PendingSend(
                        data, SendReq(done=True), copied=True,
                        crc=(pcrcw & 0xFFFFFFFF) if pcrcw >> 32 else None))
                except (ConnectionError, OSError):
                    raise
                except Exception as e:  # noqa: BLE001 - stream desync
                    logger.error(
                        "socket frame desync from %s (%d-byte key, head "
                        "%r): %r: dropping connection",
                        peer, klen, kb[:16], e)
                    _shut(conn)
                    return
        except (ConnectionError, OSError):
            return

    def _handle_onesided(self, key, data: np.ndarray, errbox) -> None:
        op = key[0]
        if op == OS_PUT:
            _, ctx_uid, seg_id, offset, notify = key
            err = REGISTRY.apply_put(ctx_uid, seg_id, offset, data, notify)
            if err:
                logger.warning("one-sided put rejected: %s", err)
                errbox[0] += 1
        elif op == OS_GET:
            _, ctx_uid, seg_id, offset, nbytes, reply_key, rhost, rport = key
            out = REGISTRY.read_get(ctx_uid, seg_id, offset, nbytes)
            if out is None:
                logger.warning("one-sided get rejected: segment (%s…,%s) "
                               "[%s,+%s)", str(ctx_uid)[:8], seg_id, offset,
                               nbytes)
                errbox[0] += 1
                out = _EMPTY          # a short reply is the error
            self._reply((rhost, rport), reply_key, out)
        elif op == OS_FLUSH:
            _, reply_key, rhost, rport = key
            ack = np.array([errbox[0]], dtype=np.uint64).view(np.uint8)
            errbox[0] = 0
            self._reply((rhost, rport), reply_key, ack)

    def _reply(self, addr, key, data: np.ndarray) -> None:
        with self._lock:
            if self._closing:
                return
            if self._reply_thread is None:
                self._reply_thread = threading.Thread(
                    target=self._reply_loop, daemon=True,
                    name="ucc-sock-reply")
                self._reply_thread.start()
        self._reply_q.put((addr, key, data))

    def _reply_loop(self) -> None:
        while True:
            item = self._reply_q.get()
            if item is None:
                return
            addr, key, data = item
            try:
                self.send_to_addr(addr, key, data)
            except (ConnectionError, OSError, UccError) as e:
                if not self._closing:
                    logger.warning("one-sided reply to %s failed: %s",
                                   addr, e)

    # ------------------------------------------------------------------
    def _addr_lock(self, addr: Tuple[str, int]) -> threading.Lock:
        with self._lock:
            lk = self._send_locks.get(addr)
            if lk is None:
                lk = self._send_locks[addr] = threading.Lock()
            return lk

    def _conn_to(self, addr: Tuple[str, int]) -> socket.socket:
        """Called with the per-address lock held: a slow or dead peer
        never stalls sends to the others."""
        c = self._conns.get(addr)
        if c is None:
            if self._closing:
                raise UccError(Status.ERR_NO_RESOURCE,
                               "socket transport is closed")
            c = _connect(addr, 30)
            c.settimeout(None)
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns[addr] = c
        return c

    def send_to_addr(self, addr: Tuple[str, int], key, data: np.ndarray,
                     crc: Optional[int] = None) -> SendReq:
        payload = data.reshape(-1).view(np.uint8).tobytes()
        kb = pickle.dumps(key)
        if crc is None and _integrity.WIRE:
            crc = zlib.crc32(payload) & 0xFFFFFFFF
        # the reader's desync bounds, checked here so an oversized frame
        # fails at the sender instead of being dropped at the target
        if len(kb) > _MAX_KEY_BYTES or len(payload) > _MAX_FRAME_BYTES:
            raise UccError(
                Status.ERR_INVALID_PARAM,
                f"socket frame exceeds transport bounds (key {len(kb)}B > "
                f"{_MAX_KEY_BYTES} or payload {len(payload)}B > "
                f"{_MAX_FRAME_BYTES}); fragment the collective (pipelined "
                f"schedule / sliding window) instead")
        frame = _HDR.pack(len(kb), len(payload),
                          zlib.crc32(kb) & 0xFFFFFFFF,
                          ((1 << 32) | crc) if crc is not None else 0
                          ) + kb + payload
        with self._addr_lock(addr):
            conn = self._conn_to(addr)
            try:
                conn.sendall(frame)
            except (ConnectionError, OSError):
                # drop the broken socket and retry once (peer restart)
                with self._lock:
                    self._conns.pop(addr, None)
                _shut(conn)
                conn = self._conn_to(addr)
                conn.sendall(frame)
        return SendReq(done=True)

    def recv_nb(self, key, dst: np.ndarray) -> RecvReq:
        req = RecvReq(dst.reshape(-1).view(np.uint8))
        self.mailbox.post_recv(key, req)
        return req

    def fence(self, team_key, min_epoch: int) -> int:
        """Epoch-fence the receive side: frames of a fenced epoch are
        discarded by ``Mailbox.push`` as they arrive."""
        return self.mailbox.fence(team_key, min_epoch)

    # -- one-sided initiator side --------------------------------------
    def _reply_key(self) -> tuple:
        with self._lock:
            self._os_reply_seq += 1
            return ("__os_reply__", self.host, self.port, self._os_reply_seq)

    def os_put_to_addr(self, addr, desc: dict, offset: int,
                       data: np.ndarray, notify) -> None:
        self.send_to_addr(addr, (OS_PUT, desc["ctx_uid"], desc["seg_id"],
                                 int(offset), notify), data)

    def os_get_from_addr(self, addr, desc: dict, offset: int,
                         dst: np.ndarray) -> RecvReq:
        rk = self._reply_key()
        req = self.recv_nb(rk, dst)        # posted before the request
        nbytes = dst.reshape(-1).view(np.uint8).nbytes
        self.send_to_addr(addr, (OS_GET, desc["ctx_uid"], desc["seg_id"],
                                 int(offset), int(nbytes), rk, self.host,
                                 self.port), _EMPTY)
        return req

    def os_flush_addr(self, addr) -> FlushReq:
        rk = self._reply_key()
        inner = self.recv_nb(rk, np.empty(8, dtype=np.uint8))
        self.send_to_addr(addr, (OS_FLUSH, rk, self.host, self.port), _EMPTY)
        return FlushReq(inner)

    def progress(self) -> None:
        time.sleep(0)

    def close(self) -> None:
        with self._lock:
            if self._closing:
                return
            self._closing = True
            conns = list(self._conns.values())
            self._conns.clear()
            readers = list(self._readers)
            self._readers.clear()
            reply = self._reply_thread
        _shut(self.lsock)
        # outbound: a graceful shutdown, whose FIN follows every byte
        # still queued (a send is complete once the kernel holds it)
        for c in conns:
            _shut(c)
        for c, _ in readers:
            _shut(c)
        self._reply_q.put(None)
        me = threading.current_thread()
        for th in [self._accept_thread, reply] + [t for _, t in readers]:
            if th is not None and th is not me and th.ident is not None:
                th.join(timeout=5)


class TlSocketContext(BaseContext):
    def __init__(self, comp_lib, core_context, config):
        super().__init__(comp_lib, core_context, config)
        bind = config.bind_host if config is not None else ""
        self.transport = SocketTransport(bind)
        self.peer_addrs: Dict[int, Tuple[str, int]] = {}

    def pack_address(self) -> bytes:
        return pickle.dumps((self.transport.host, self.transport.port))

    def unpack_addresses(self, addrs: Dict[int, bytes]) -> None:
        for rank, blob in addrs.items():
            if blob:
                self.peer_addrs[rank] = pickle.loads(blob)

    def _addr(self, peer_ctx_rank: int) -> Tuple[str, int]:
        addr = self.peer_addrs.get(peer_ctx_rank)
        if addr is None:
            raise UccError(Status.ERR_NOT_FOUND,
                           f"no socket address for ctx rank {peer_ctx_rank}")
        return addr

    def send_to(self, peer_ctx_rank: int, key, data: np.ndarray,
                crc: Optional[int] = None) -> SendReq:
        addr = self._addr(peer_ctx_rank)
        if peer_ctx_rank == self.core_context.rank:
            # loopback without the network
            data = data.reshape(-1).view(np.uint8)
            if crc is None and _integrity.WIRE:
                crc = zlib.crc32(data) & 0xFFFFFFFF
            self.transport.mailbox.push(
                key, _PendingSend(data.copy(), SendReq(done=True), True,
                                  crc=crc))
            return SendReq(done=True)
        return self.transport.send_to_addr(addr, key, data, crc=crc)

    # -- one-sided (tl/host/onesided.py) -------------------------------
    def os_put(self, peer_ctx_rank: int, desc: dict, offset: int,
               data: np.ndarray, notify=None) -> None:
        if peer_ctx_rank == self.core_context.rank:
            return local_os_put(desc, offset, data, notify)
        self.transport.os_put_to_addr(self._addr(peer_ctx_rank), desc,
                                      offset, data, notify)

    def os_get(self, peer_ctx_rank: int, desc: dict, offset: int,
               dst: np.ndarray):
        if peer_ctx_rank == self.core_context.rank:
            return local_os_get(desc, offset, dst)
        return self.transport.os_get_from_addr(self._addr(peer_ctx_rank),
                                               desc, offset, dst)

    def os_flush(self, peer_ctx_rank: int):
        if peer_ctx_rank == self.core_context.rank:
            return SendReq(done=True)
        return self.transport.os_flush_addr(self._addr(peer_ctx_rank))

    def global_work_buffer_size(self) -> int:
        """Scratch a one-sided collective may take from the user's
        global_work_buffer: the sliding window's in-flight gets."""
        return sw_max_work_buffer(self.config)

    def destroy(self) -> None:
        self.transport.close()


class TlSocketTeam(HostTlTeam):
    NAME = "socket"

    def __init__(self, comp_context, core_team, scope: str = "cl"):
        super().__init__(comp_context, core_team, scope)
        cfg = comp_context.config
        thresh = 0
        if cfg is not None:
            try:
                thresh = int(cfg.get("preconnect"))
            except KeyError:
                pass
        self._preconnect_reqs = None
        self._want_preconnect = 1 < self.size <= thresh

    def create_test(self) -> Status:
        """Preconnect: a zero-byte tagged exchange with every peer opens
        the TCP connections at team create, so the first collective pays
        no connect. Tag 0 cannot collide: collectives take tags from 1."""
        if not self._want_preconnect:
            return Status.OK
        if self._preconnect_reqs is None:
            sub = self.full_subset()
            empty = np.zeros(0, dtype=np.uint8)
            reqs = []
            for i in range(1, self.size):
                dst = (self.rank + i) % self.size
                src = (self.rank - i + self.size) % self.size
                reqs.append(self.send_nb_ctx(
                    self._peer_ctx_rank(sub, dst), 0, 0, empty))
                reqs.append(self.recv_nb_ctx(
                    self._peer_ctx_rank(sub, src), 0, 0, empty))
            self._preconnect_reqs = reqs
        self._preconnect_reqs = [r for r in self._preconnect_reqs
                                 if not r.test()]
        if self._preconnect_reqs:
            return Status.IN_PROGRESS
        self._want_preconnect = False
        return Status.OK


@register_tl
class TlSocket(TransportLayer):
    NAME = "socket"
    DEFAULT_SCORE = 10
    SUPPORTED_COLLS = COLL_TYPE_ALL
    SUPPORTED_MEM_TYPES = (MemoryType.HOST,)
    SERVICE_CAPABLE = True
    CONTEXT_CONFIG = TL_SOCKET_CONFIG
    lib_cls = BaseLib
    context_cls = TlSocketContext
    team_cls = TlSocketTeam


TlSocketTeam.TL_CLS = TlSocket
