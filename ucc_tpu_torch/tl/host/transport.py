"""Tagged point-to-point transport for the host TLs (the port of the JAX
package's ``tl/host/transport.py``).

The stand-in for UCX tagged send/recv: ``InProcTransport`` ("shm") joins
ranks whose contexts live in one process (threads); matching is a mailbox
keyed by (team_key, epoch, coll_tag, slot, src ctx rank). A send whose
recv is already posted lands straight in the recv's buffer; an unexpected
send at or under the eager limit is copied and completes, a larger one
parks a zero-copy view (rendezvous) and completes when a recv takes it.

The matching runs in the native C++ core (``ucc_tpu_torch.native``) when
it is built, else in the Python ``Mailbox`` below; both keep the same
contract. ``UCC_TL_SHM_NATIVE=y`` (or ``UCC_NATIVE=y``) requires the
native core: without it the endpoint raises ERR_NO_RESOURCE instead of
falling back.
"""
from __future__ import annotations

import threading
import uuid
from collections import deque
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ... import native as _native
from ...status import Status, UccError
from ...utils.config import (Config, ConfigField, ConfigTable, SIZE_AUTO,
                             parse_bool, parse_memunits, register_table)

#: matching key: (team_key, epoch, coll_tag, slot, src ctx rank). The
#: epoch is the team's recovery epoch (0 for every team that never
#: shrank); a fence drops every message of an older epoch of a team key.
TagKey = Tuple[Any, int, int, int, int]


class SendReq:
    __slots__ = ("done", "cancelled")

    def __init__(self, done: bool = False):
        self.done = done
        self.cancelled = False

    def test(self) -> bool:
        return self.done

    def cancel(self) -> None:
        """Give up on completion (the message may already sit in the
        peer's unexpected queue; the caller just stops waiting)."""
        self.cancelled = True
        self.done = True


class RecvReq:
    __slots__ = ("done", "dst", "nbytes", "error", "cancelled", "_mb")

    def __init__(self, dst: np.ndarray):
        self.done = False
        self.dst = dst
        self.nbytes = 0
        self.error = None   # str reason when the matched send misbehaved
        self.cancelled = False
        self._mb = None     # owning Mailbox (set at post; cancel sync)

    def test(self) -> bool:
        return self.done

    def cancel(self) -> None:
        """Withdraw a posted recv under the owning mailbox's lock, which
        delivery also holds: a late send can no longer write into a
        buffer the caller may have reclaimed, and a delivered request
        stays delivered."""
        mb = self._mb
        if mb is None:
            if not self.done:
                self.error = self.error or "canceled"
            self.cancelled = True
            self.done = True
            return
        with mb.lock:
            if not self.done:
                self.error = self.error or "canceled"
                self.done = True
            self.cancelled = True


class _PendingSend:
    __slots__ = ("data", "req", "copied")

    def __init__(self, data: np.ndarray, req: SendReq, copied: bool):
        self.data = data
        self.req = req
        self.copied = copied


class Mailbox:
    """Per-context receive side with unexpected-message queues."""

    def __init__(self):
        self.lock = threading.Lock()
        #: key -> deque of _PendingSend (unexpected messages)
        self.unexpected: Dict[TagKey, deque] = {}
        #: key -> deque of RecvReq (posted receives)
        self.posted: Dict[TagKey, deque] = {}
        #: epoch fences: team_key -> minimum accepted epoch
        self.fences: Dict[Any, int] = {}

    def _is_fenced(self, key: TagKey) -> bool:
        f = self.fences.get(key[0])
        return f is not None and key[1] < f

    def fence(self, team_key, min_epoch: int) -> int:
        """Fence every epoch of *team_key* below *min_epoch*: posted recvs
        fail as "fenced", unexpected sends are dropped and their requests
        completed. Returns the number of purged entries."""
        purged = 0
        with self.lock:
            cur = self.fences.get(team_key)
            if cur is None or min_epoch > cur:
                self.fences[team_key] = min_epoch
            for key in [k for k in self.posted
                        if k[0] == team_key and k[1] < min_epoch]:
                for req in self.posted.pop(key):
                    if not req.done:
                        req.error = req.error or "fenced: stale team epoch"
                        req.done = True
                    req.cancelled = True
                    purged += 1
            for key in [k for k in self.unexpected
                        if k[0] == team_key and k[1] < min_epoch]:
                for ps in self.unexpected.pop(key):
                    ps.req.done = True
                    purged += 1
        return purged

    def _match_posted_locked(self, key: TagKey) -> Optional[RecvReq]:
        """Pop the first live posted recv for *key* (lock held)."""
        rq = self.posted.get(key)
        while rq:
            cand = rq.popleft()
            if not rq:
                del self.posted[key]
            if not cand.cancelled:
                return cand
        return None

    def push(self, key: TagKey, ps: _PendingSend) -> None:
        """Deliver a message that already owns its bytes (a frame a
        socket reader received): into a posted recv, else parked as
        unexpected. Delivery runs under the lock that ``RecvReq.cancel``
        takes."""
        with self.lock:
            if self.fences and self._is_fenced(key):
                ps.req.done = True   # discarded: stale-epoch delivery
                return
            req = self._match_posted_locked(key)
            if req is None:
                self.unexpected.setdefault(key, deque()).append(ps)
                return
            _deliver(req, ps)

    def send(self, key: TagKey, data_u8: np.ndarray,
             eager_limit: int) -> Tuple[SendReq, str]:
        """Sender side: deliver straight from the sender's buffer into a
        posted recv ("direct"), else park the message: an eager copy at
        or under *eager_limit* ("eager"), a zero-copy view above it
        ("rndv"). Returns the send request and the kind."""
        with self.lock:
            if self.fences and self._is_fenced(key):
                return SendReq(done=True), "fenced"
            req = self._match_posted_locked(key)
            if req is not None:
                ps = _PendingSend(data_u8, SendReq(), copied=False)
                _deliver(req, ps)
                return ps.req, "direct"
            if data_u8.nbytes <= eager_limit:
                ps = _PendingSend(data_u8.copy(), SendReq(done=True),
                                  copied=True)
                kind = "eager"
            else:
                ps = _PendingSend(data_u8, SendReq(), copied=False)
                kind = "rndv"
            self.unexpected.setdefault(key, deque()).append(ps)
            return ps.req, kind

    def occupancy(self) -> Tuple[int, int]:
        """(parked unexpected messages, live posted recvs)."""
        with self.lock:
            unexp = sum(len(q) for q in self.unexpected.values())
            posted = sum(len(q) for q in self.posted.values())
        return unexp, posted

    def post_recv(self, key: TagKey, req: RecvReq) -> None:
        with self.lock:
            req._mb = self
            if self.fences and self._is_fenced(key):
                req.error = "fenced: stale team epoch"
                req.cancelled = True
                req.done = True
                return
            uq = self.unexpected.get(key)
            if uq:
                ps = uq.popleft()
                if not uq:
                    del self.unexpected[key]
            else:
                self.posted.setdefault(key, deque()).append(req)
                return
            _deliver(req, ps)


def _deliver(req: RecvReq, ps: _PendingSend) -> None:
    n = min(req.dst.size, ps.data.size)
    if ps.data.size > req.dst.size:
        # inconsistent per-rank counts: fail the task rather than complete
        # with partial data (cf. UCS_ERR_MESSAGE_TRUNCATED)
        req.error = (f"message truncated: sent {ps.data.size} elements "
                     f"into a {req.dst.size}-element recv buffer")
    req.dst[:n] = ps.data[:n]
    req.nbytes = n
    req.done = True
    ps.req.done = True


# ---------------------------------------------------------------------------
# in-process transport
# ---------------------------------------------------------------------------

#: process-global endpoint registry: uid -> InProcTransport
_SHM_WORLD: Dict[str, "InProcTransport"] = {}
_SHM_LOCK = threading.Lock()

_DEFAULT_EAGER_LIMIT = 8192

HOST_TRANSPORT_CONFIG = register_table(ConfigTable(
    prefix="HOST_", name="tl/host-transport", fields=[
        ConfigField("EAGER_LIMIT", str(_DEFAULT_EAGER_LIMIT),
                    "eager copy limit for host transports: unexpected "
                    "sends at or under it are copied and complete, larger "
                    "ones park a zero-copy rendezvous view; sends that "
                    "match an already-posted recv are always delivered "
                    "copy-free", parse_memunits),
    ]))


def eager_limit_from_env() -> int:
    """UCC_HOST_EAGER_LIMIT (env or UCC_CONFIG_FILE), else 8K; ``inf``
    means always eager, ``auto`` the default."""
    try:
        v = Config(HOST_TRANSPORT_CONFIG).eager_limit
        if v != SIZE_AUTO:
            return int(v)
    except ValueError:
        pass
    return _DEFAULT_EAGER_LIMIT


def resolve_native(use_native: Optional[bool]) -> Tuple[bool, bool]:
    """(use the native core?, is it required?). An explicit argument wins;
    else UCC_TL_SHM_NATIVE (y/n; auto or unset = on when it builds);
    UCC_NATIVE=n turns it off and UCC_NATIVE=y requires it."""
    import os
    mode = _native.native_mode()
    if mode == "n":
        return False, False
    forced = mode == "y"
    if use_native is None:
        env = os.environ.get("UCC_TL_SHM_NATIVE", "").strip().lower()
        if env and env != "auto":
            use_native = parse_bool(env)
            forced = forced or use_native
        else:
            use_native = True
    else:
        forced = forced or bool(use_native)
    return bool(use_native), forced and bool(use_native)


class InProcTransport:
    """One endpoint per core context."""

    EAGER_THRESHOLD = _DEFAULT_EAGER_LIMIT

    def __init__(self, use_native: Optional[bool] = None):
        self.uid = uuid.uuid4().hex
        self.mailbox = Mailbox()
        self.EAGER_THRESHOLD = eager_limit_from_env()
        # data-path accounting (tests and perftest read them)
        self.n_direct = 0        # copy-free deliveries into posted recvs
        self.n_eager = 0         # unexpected sends staged by eager copy
        self.n_rndv = 0          # unexpected zero-copy rendezvous views
        self.n_fenced = 0        # stale-epoch sends discarded at the fence
        self.native = None
        want, required = resolve_native(use_native)
        if want:
            try:
                if _native.get_lib() is not None:
                    self.native = _native.NativeMailbox()
            except (RuntimeError, OSError) as e:
                if required:
                    raise UccError(Status.ERR_NO_RESOURCE,
                                   f"native matcher required but it "
                                   f"failed: {e}") from e
            if self.native is None and required:
                raise UccError(Status.ERR_NO_RESOURCE,
                               "native matcher required (UCC_TL_SHM_NATIVE"
                               "/UCC_NATIVE=y) but the core is "
                               f"unavailable: {_native.build_error()}")
        with _SHM_LOCK:
            _SHM_WORLD[self.uid] = self

    # -- address plumbing ---------------------------------------------
    def pack_address(self) -> bytes:
        return self.uid.encode()

    @staticmethod
    def resolve(addr: bytes) -> Optional["InProcTransport"]:
        with _SHM_LOCK:
            return _SHM_WORLD.get(addr.decode())

    # -- data path -----------------------------------------------------
    def _count_send(self, kind: str) -> None:
        if kind == "direct":
            self.n_direct += 1
        elif kind == "eager":
            self.n_eager += 1
        elif kind == "rndv":
            self.n_rndv += 1
        else:
            self.n_fenced += 1

    def occupancy(self) -> Dict[str, int]:
        """Mailbox backlog: unexpected/posted queue lengths, plus the
        native core's live request slots when it matches."""
        unexp, posted = self.mailbox.occupancy()
        d = {"unexpected": unexp, "posted": posted}
        if self.native is not None:
            n = self.native.occupancy()
            d["unexpected"] += int(n[0])
            d["posted"] += int(n[1])
            d["native_slots_in_use"] = int(n[2])
        return d

    def send_nb(self, peer: "InProcTransport", key: TagKey,
                data: np.ndarray) -> SendReq:
        if peer.native is not None:
            # matching lives in the RECEIVER's mailbox: route by the
            # peer's matcher only
            req, kind = peer.native.push_native(key, data,
                                                self.EAGER_THRESHOLD)
        else:
            req, kind = peer.mailbox.send(
                key, data.reshape(-1).view(np.uint8), self.EAGER_THRESHOLD)
        self._count_send(kind)
        return req

    def recv_nb(self, key: TagKey, dst: np.ndarray):
        if self.native is not None:
            return self.native.post_recv_native(key, dst)
        req = RecvReq(dst.reshape(-1).view(np.uint8))
        self.mailbox.post_recv(key, req)
        return req

    def fence(self, team_key, min_epoch: int) -> int:
        """Epoch-fence *team_key* on this endpoint's receive side."""
        purged = self.mailbox.fence(team_key, min_epoch)
        if self.native is not None:
            purged += self.native.fence(team_key, min_epoch)
        return purged

    def progress(self) -> None:
        pass  # delivery happens inline at send/recv

    def close(self) -> None:
        with _SHM_LOCK:
            _SHM_WORLD.pop(self.uid, None)
        if self.native is not None:
            self.native.destroy()
            self.native = None
