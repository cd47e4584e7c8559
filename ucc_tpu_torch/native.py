"""ctypes bindings for the port's native tag-matching core
(``native_src/ucc_tpu_torch_core.cc``, the port's own copy of the JAX
package's C++ core, v2, ABI 6).

The core is built on first use with ``g++`` into
``ucc_tpu_torch/build/native-<hash>/libucc_tpu_torch_core.so``, the hash
covering the source and the compiler flags, so an edited source is rebuilt
and an unchanged one is not. Several processes (test workers) may ask at
once: the build holds an ``fcntl`` lock on a file beside the library,
compiles to a temporary name and ``os.replace``s it into place, so no
reader ever sees a partial library. A loaded library must answer
``ucc_abi_version() == ABI_VERSION``.

Knobs (names as in the JAX package):

- ``UCC_NATIVE``: ``auto`` (default) builds and loads the core when a
  toolchain is there, and the transports fall back to the Python matcher
  when it is not; ``y`` requires it (a failed build raises); ``n`` turns
  the core off for the process.
- ``UCC_HOST_EAGER_LIMIT`` (``tl/host/transport.py``): the eager limit of
  unexpected sends.

``NativeMailbox`` implements the push/post_recv contract of
``tl/host/transport.Mailbox`` in C++: copy-free delivery into posted
recvs, the eager/rndv split at the eager limit, truncation, cancelled
entries skipped at match time, and epoch fences. Tag keys are packed into
three u64 words (team_id<<32|epoch, coll_tag, slot<<32|src); non-integer
key parts (team keys, tuple tags) are interned once per mailbox. The C
side publishes completion state into a flat array that this module maps
once, so polling a request is a memory load, not an ffi call.

Not bound here (later slices): the execution plans (``ucc_plan_*``), the
MPMC queue and the CPython fastcall extension, which is not built.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import numpy as np

from .status import Status, UccError
from .utils.config import ConfigField, ConfigTable, parse_string, register_table
from .utils.log import get_logger

logger = get_logger("native")

#: must match kAbiVersion in native_src/ucc_tpu_torch_core.cc
ABI_VERSION = 6

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC_PATH = os.path.join(_PKG, "native_src", "ucc_tpu_torch_core.cc")
_BUILD_DIR = os.path.join(_PKG, "build")
LIB_NAME = "libucc_tpu_torch_core.so"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-Werror",
            "-pthread"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ERROR: Optional[str] = None
_LOCK = threading.Lock()
#: seconds the last build took in this process (0.0 when the library was
#: already on disk) and the path of the loaded library
build_seconds = 0.0
lib_path: Optional[str] = None

# request-id layout (mirrors the C side): rid = (gen << 20) | slot index;
# pub word = (gen << 32) | (min(nbytes, _NB_MAX) << 3) | state
_SLOT_BITS = 20
_MAX_SLOTS = 1 << _SLOT_BITS
_IDX_MASK = _MAX_SLOTS - 1
_NB_MAX = (1 << 29) - 1

_ST_TRUNCATED = 2
_ST_FENCED = 3
_ST_CANCELED = 4

_KIND_STR = ("direct", "eager", "rndv", "fenced")

# process-global team-id counter: see NativeMailbox._intern_team
_NEXT_TEAM_ID = 1
_TEAM_ID_LOCK = threading.Lock()

# ("svc", n) tags count up for the life of a service team: special-cased
# into a reserved range so they never grow the intern table
_SVC_TAG_BASE = 1 << 60
_TUPLE_TAG_BASE = 1 << 61

NATIVE_CONFIG = register_table(ConfigTable(
    prefix="", name="native-core", fields=[
        ConfigField(
            "NATIVE", "auto",
            "build/load the native C++ tag-matching core "
            "(native_src/ucc_tpu_torch_core.cc, built into "
            "ucc_tpu_torch/build/): auto = use it when it builds, else the "
            "Python matcher; y = require it (a failed build raises); n = "
            "off for the process (every endpoint matches in Python). "
            "Per-endpoint selection is UCC_TL_SHM_NATIVE", parse_string),
    ]))


def native_mode() -> str:
    """UCC_NATIVE resolved to 'auto', 'y' or 'n' (env, then
    UCC_CONFIG_FILE, then the default)."""
    from .utils.config import Config, parse_bool
    raw = str(Config(NATIVE_CONFIG).native).strip().lower()
    if raw in ("", "auto"):
        return "auto"
    return "y" if parse_bool(raw) else "n"


def _build_key() -> str:
    digest = hashlib.sha256(" ".join(CXXFLAGS).encode())
    with open(_SRC_PATH, "rb") as fh:
        digest.update(fh.read())
    return digest.hexdigest()[:16]


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    return os.path.join(_BUILD_DIR, f"native-{_build_key()}", LIB_NAME)


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    return cxx


def build() -> str:
    """Build the library if it is not on disk; returns its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    global build_seconds
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".lock", "w") as lock_fh:
        fcntl.flock(lock_fh, fcntl.LOCK_EX)
        try:
            if os.path.isfile(out):        # another process built it
                return out
            t0 = time.perf_counter()
            tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
            cmd = [_compiler(), *CXXFLAGS, "-shared", "-o", tmp, _SRC_PATH]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=300)
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError(f"{cmd[0]} did not run: {e}") from e
            if r.returncode != 0:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise RuntimeError(f"{' '.join(cmd)} failed "
                                   f"(rc {r.returncode}):\n"
                                   f"{r.stdout}{r.stderr}")
            os.replace(tmp, out)
            build_seconds = time.perf_counter() - t0
        finally:
            fcntl.flock(lock_fh, fcntl.LOCK_UN)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    u64 = ctypes.c_uint64
    vp = ctypes.c_void_p
    lib.ucc_mailbox_create.restype = vp
    lib.ucc_mailbox_create.argtypes = []
    lib.ucc_mailbox_destroy.restype = None
    lib.ucc_mailbox_destroy.argtypes = [vp]
    lib.ucc_mailbox_pub_base.restype = vp
    lib.ucc_mailbox_pub_base.argtypes = [vp]
    lib.ucc_mailbox_push.restype = u64
    lib.ucc_mailbox_push.argtypes = [vp, u64, u64, u64, vp, u64, u64]
    lib.ucc_mailbox_post_recv.restype = u64
    lib.ucc_mailbox_post_recv.argtypes = [vp, u64, u64, u64, vp, u64]
    lib.ucc_mailbox_fence.restype = u64
    lib.ucc_mailbox_fence.argtypes = [vp, u64, u64]
    lib.ucc_mailbox_purge.restype = u64
    lib.ucc_mailbox_purge.argtypes = [vp]
    lib.ucc_mailbox_occupancy.restype = None
    lib.ucc_mailbox_occupancy.argtypes = [vp, ctypes.POINTER(u64)]
    lib.ucc_req_poll.restype = u64
    lib.ucc_req_poll.argtypes = [vp, u64]
    lib.ucc_req_test_many.restype = u64
    lib.ucc_req_test_many.argtypes = [vp, u64, ctypes.POINTER(u64),
                                      ctypes.POINTER(u64)]
    lib.ucc_req_nbytes.restype = u64
    lib.ucc_req_nbytes.argtypes = [vp, u64]
    lib.ucc_req_sent_nbytes.restype = u64
    lib.ucc_req_sent_nbytes.argtypes = [vp, u64]
    lib.ucc_req_cancel.restype = ctypes.c_int
    lib.ucc_req_cancel.argtypes = [vp, u64]
    lib.ucc_req_free.restype = None
    lib.ucc_req_free.argtypes = [vp, u64]
    lib.ucc_req_free_many.restype = None
    lib.ucc_req_free_many.argtypes = [vp, u64, ctypes.POINTER(u64)]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded core, building it first if needed; None when UCC_NATIVE
    is n or the build failed under auto (``build_error()`` says why).
    Under UCC_NATIVE=y a failed build raises ERR_NO_RESOURCE."""
    global _LIB, _TRIED, _ERROR, lib_path
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            mode = native_mode()
            if mode == "n":
                _ERROR = "UCC_NATIVE=n"
            else:
                try:
                    path = build()
                    lib = ctypes.CDLL(path)
                    abi_fn = lib.ucc_abi_version
                    abi_fn.restype = ctypes.c_uint64
                    abi = int(abi_fn())
                    if abi != ABI_VERSION:
                        raise RuntimeError(f"{path} speaks ABI {abi}, "
                                           f"want {ABI_VERSION}")
                    _bind(lib)
                    _LIB, lib_path = lib, path
                    logger.info("native core v%d loaded: %s", abi, path)
                except (OSError, RuntimeError) as e:
                    _ERROR = str(e)
                    logger.warning("native core unavailable; the Python "
                                   "matcher is used: %s", e)
        if _LIB is None and native_mode() == "y":
            raise UccError(Status.ERR_NO_RESOURCE,
                           f"UCC_NATIVE=y but the native core is "
                           f"unavailable: {_ERROR}")
        return _LIB


def build_error() -> Optional[str]:
    """Why the core is not loaded (None when it is, or was never asked)."""
    return _ERROR


def _reset() -> None:
    """Forget the load attempt, so the next ``get_lib()`` tries again
    (for tests that point the build at another source)."""
    global _LIB, _TRIED, _ERROR, lib_path
    with _LOCK:
        _LIB, _TRIED, _ERROR, lib_path = None, False, None, None


# ---------------------------------------------------------------------------
# native requests and mailbox with the Python transport's interface
# ---------------------------------------------------------------------------

class _DoneSend:
    """Send request that completed inside the push call (direct delivery,
    eager staging copy or fenced discard): the sender may reuse its buffer
    at once."""

    __slots__ = ("cancelled",)
    done = True
    _done = True          # test_many/poll_pending filter on _done

    def __init__(self):
        self.cancelled = False

    def test(self) -> bool:
        return True

    def cancel(self) -> None:
        self.cancelled = True


class NativeSendReq:
    """Rendezvous send: parked zero-copy in the peer's unexpected queue;
    completes when a matching recv lands it (the C side frees the request
    at delivery, so a bumped generation reads as complete). The mailbox
    keeps the payload alive (``_send_keep``) until then."""

    __slots__ = ("mb", "rid", "_idx", "_gen", "_done", "cancelled")

    def __init__(self, mb: "NativeMailbox", rid: int):
        self.mb = mb
        self.rid = rid
        self._idx = rid & _IDX_MASK
        self._gen = rid >> _SLOT_BITS
        self._done = False
        self.cancelled = False

    @property
    def done(self) -> bool:
        return self.test()

    def test(self) -> bool:
        if self._done:
            return True
        mb = self.mb
        pub = mb._pub
        if pub is None:               # mailbox destroyed mid-flight
            self._done = True
            return True
        v = pub[self._idx]
        if (v >> 32) != self._gen or (v & 7):
            # confirm with an acquire-ordered ffi load before releasing
            # the payload keepalive (the receiver's memcpy must be visible
            # before the sender may reuse the buffer); one ffi per request
            ptr = mb.ptr
            if ptr is None or int(mb.lib.ucc_req_poll(ptr, self.rid)):
                mb._send_keep.pop(self.rid, None)
                self._done = True
        return self._done

    def cancel(self) -> None:
        """Stop waiting. The message cannot be unsent (it sits in the
        peer's unexpected queue); the payload keepalive stays with the
        mailbox so a late match cannot read freed memory."""
        self.cancelled = True
        self._done = True


class NativeRecvReq:
    __slots__ = ("mb", "rid", "_idx", "_gen", "dst_keepalive", "_done",
                 "nbytes", "error", "cancelled")

    def __init__(self, mb: "NativeMailbox", rid: int, dst: np.ndarray):
        self.mb = mb
        self.rid = rid
        self._idx = rid & _IDX_MASK
        self._gen = rid >> _SLOT_BITS
        self.dst_keepalive = dst     # pin the buffer the C side writes into
        self._done = False
        self.nbytes = 0
        self.error = None
        self.cancelled = False

    @property
    def done(self) -> bool:
        return self.test()

    def test(self) -> bool:
        if self._done:
            return True
        pub = self.mb._pub
        if pub is None:               # mailbox destroyed mid-flight
            self._done = True
            return True
        v = pub[self._idx]
        if (v >> 32) != self._gen:
            self._done = True         # freed under us (endpoint purge)
            return True
        if not (v & 7):
            return False
        # the mapped read is a hint: confirm through one acquire-ordered
        # ffi load before touching the delivered payload
        mb = self.mb
        ptr = mb.ptr
        if ptr is None:
            self._done = True
            return True
        v = int(mb.lib.ucc_req_poll(ptr, self.rid))
        if v == 0:
            return False
        self._finish(v, ptr)
        return True

    def _finish(self, v: int, ptr=None) -> None:
        """Harvest a completed pub word and free the C-side request."""
        mb = self.mb
        ptr = ptr if ptr is not None else mb.ptr
        st = v & 7
        nb = (v >> 3) & _NB_MAX
        if nb == _NB_MAX and ptr is not None:  # saturated: exact size
            nb = int(mb.lib.ucc_req_nbytes(ptr, self.rid))
        self.nbytes = nb
        if st == _ST_TRUNCATED:
            sent = int(mb.lib.ucc_req_sent_nbytes(ptr, self.rid)) \
                if ptr is not None else 0
            self.error = (f"message truncated: sent {sent} bytes into "
                          f"a {self.dst_keepalive.nbytes}-byte recv "
                          f"buffer")
        elif st == _ST_FENCED:
            self.error = "fenced: stale team epoch"
            self.cancelled = True
        elif st == _ST_CANCELED:
            self.error = self.error or "canceled"
            self.cancelled = True
        mb._free(self.rid)
        self._done = True

    def cancel(self) -> None:
        """Withdraw a posted recv: the matcher skips cancelled entries
        under the same shard lock that delivers, so cancel and match
        cannot interleave; a delivered request stays delivered."""
        if self._done:
            self.cancelled = True
            return
        mb = self.mb
        ptr = mb.ptr
        if ptr is None:
            self.error = self.error or "canceled"
            self.cancelled = True
            self._done = True
            return
        if mb.lib.ucc_req_cancel(ptr, self.rid):
            self.error = self.error or "canceled"
            self.cancelled = True
            self._done = True
            mb._free(self.rid)
        else:
            self.test()               # already delivered/fenced: harvest
            self.cancelled = True


class NativeMailbox:
    """The C++ tag matcher behind the Mailbox interface."""

    def __init__(self):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native core unavailable: {_ERROR}")
        self.lib = lib
        self.ptr = lib.ucc_mailbox_create()
        if not self.ptr:
            raise RuntimeError("native mailbox allocation failed")
        # completion-publication window: one aligned u64 load per poll
        base = lib.ucc_mailbox_pub_base(self.ptr)
        self._pub_buf = (ctypes.c_uint64 * _MAX_SLOTS).from_address(base)
        self._pub = memoryview(self._pub_buf).cast("B").cast("Q")
        self._team_ids = {}
        self._tag_ids = {}
        self._intern_mu = threading.Lock()
        #: rndv payload keepalives: the C side parks a raw pointer, so the
        #: mailbox pins the array until delivery
        self._send_keep = {}
        self._free_pending = []
        self._free_mu = threading.Lock()
        self._push_fn = lib.ucc_mailbox_push
        self._post_fn = lib.ucc_mailbox_post_recv

    # -- key packing ---------------------------------------------------
    def _intern(self, table: dict, obj, base: int) -> int:
        v = table.get(obj)
        if v is None:
            with self._intern_mu:
                v = table.setdefault(obj, base + len(table))
        return v

    def _intern_team(self, team_key) -> int:
        """Team ids come from a process-global counter: the C mailbox is
        recycled across endpoint lives, and per-life ids restarting at 1
        could let a stale message match a new endpoint's recv."""
        v = self._team_ids.get(team_key)
        if v is None:
            global _NEXT_TEAM_ID
            with _TEAM_ID_LOCK:
                v = self._team_ids.get(team_key)
                if v is None:
                    v = _NEXT_TEAM_ID
                    _NEXT_TEAM_ID += 1
                    self._team_ids[team_key] = v
        return v

    def _pack(self, key):
        """TagKey -> three u64 words. The host-TL key is (team_key, epoch,
        coll_tag, slot, src); anything else is interned whole as a team id
        with epoch 0."""
        try:
            team, epoch, tag, slot, src = key
        except (TypeError, ValueError):
            return self._pack_other(key)
        if type(epoch) is not int or type(slot) is not int \
                or type(src) is not int:
            return self._pack_other(key)
        if type(tag) is not int:
            if isinstance(tag, tuple) and len(tag) == 2 \
                    and tag[0] == "svc" and type(tag[1]) is int:
                tag = _SVC_TAG_BASE | (tag[1] & 0xFFFFFFFFFFFF)
            else:
                tag = self._intern(self._tag_ids, tag, _TUPLE_TAG_BASE)
        team_id = self._intern_team(team)
        return ((team_id << 32) | (epoch & 0xFFFFFFFF), tag,
                ((slot & 0xFFFFFFFF) << 32) | (src & 0xFFFFFFFF))

    def _pack_other(self, key):
        return (self._intern_team(key) << 32, 0, 0)

    def team_id(self, team_key) -> int:
        return self._intern_team(team_key)

    # -- data path -----------------------------------------------------
    def push_native(self, key, data: np.ndarray,
                    eager_limit: Optional[int] = None):
        """Send: ``(req, kind)`` with kind in direct / eager / rndv /
        fenced. A direct send lands copy-free in the posted dst inside
        this call. *eager_limit* defaults to UCC_HOST_EAGER_LIMIT."""
        if eager_limit is None:
            from .tl.host.transport import eager_limit_from_env
            eager_limit = eager_limit_from_env()
        ptr = self.ptr
        if ptr is None:
            # endpoint already closed: the message has nowhere to land
            return _DoneSend(), "eager"
        a, b, c = self._pack(key)
        if not data.flags["C_CONTIGUOUS"]:
            data = np.ascontiguousarray(data)
        ret = self._push_fn(ptr, a, b, c, data.ctypes.data, data.nbytes,
                            eager_limit)
        kind = ret & 7
        if kind == 2:                 # rndv: parked zero-copy
            rid = ret >> 3
            self._send_keep[rid] = data
            return NativeSendReq(self, rid), "rndv"
        return _DoneSend(), _KIND_STR[kind]

    def post_recv_native(self, key, dst: np.ndarray) -> NativeRecvReq:
        ptr = self.ptr
        if ptr is None:
            raise RuntimeError("native mailbox is closed")
        if not dst.flags["C_CONTIGUOUS"] or not dst.flags["WRITEABLE"]:
            raise ValueError("recv destination must be C-contiguous and "
                             "writable")
        a, b, c = self._pack(key)
        rid = self._post_fn(ptr, a, b, c, dst.ctypes.data, dst.nbytes)
        if rid == 0:
            raise RuntimeError("native mailbox request slots exhausted")
        return NativeRecvReq(self, rid, dst)

    def fence(self, team_key, min_epoch: int) -> int:
        """Epoch-fence *team_key*: purge parked entries below *min_epoch*
        and discard later stale arrivals. Returns the purged count."""
        ptr = self.ptr
        if ptr is None:
            return 0
        return int(self.lib.ucc_mailbox_fence(
            ptr, self.team_id(team_key), min_epoch))

    def occupancy(self):
        """(unexpected parked msgs, posted recvs, live request slots)."""
        ptr = self.ptr
        if ptr is None:
            return (0, 0, 0)
        out = (ctypes.c_uint64 * 3)()
        self.lib.ucc_mailbox_occupancy(ptr, out)
        return (int(out[0]), int(out[1]), int(out[2]))

    # -- request plumbing ----------------------------------------------
    def _free(self, rid: int) -> None:
        """Batched request free: one ffi call per 256 completions."""
        with self._free_mu:
            fp = self._free_pending
            fp.append(rid)
            ptr = self.ptr
            if len(fp) >= 256 and ptr:
                n = len(fp)
                arr = (ctypes.c_uint64 * n)(*fp)
                self.lib.ucc_req_free_many(ptr, n, arr)
                fp.clear()

    def test_many(self, reqs):
        """Batch-poll native requests in one ffi call; completed ones are
        finished in place. Returns the still-pending subset."""
        reqs = [r for r in reqs if not r._done]
        n = len(reqs)
        if n == 0:
            return []
        ptr = self.ptr
        if ptr is None:
            for r in reqs:
                r.test()
            return []
        rids = (ctypes.c_uint64 * n)(*[r.rid for r in reqs])
        out = (ctypes.c_uint64 * n)()
        self.lib.ucc_req_test_many(ptr, n, rids, out)
        pending = []
        for i, r in enumerate(reqs):
            v = int(out[i])
            if v == 0:
                pending.append(r)
            elif isinstance(r, NativeRecvReq):
                if not r._done:
                    r._finish(v)
            else:
                r.test()
        return pending

    def purge(self) -> int:
        """Reclaim every outstanding request and parked message; handles
        read as complete afterwards."""
        ptr = self.ptr
        if ptr is None:
            return 0
        with self._free_mu:
            self._free_pending.clear()
        n = int(self.lib.ucc_mailbox_purge(ptr))
        # only after the C purge has dropped every parked pointer may the
        # rndv payloads go
        self._send_keep.clear()
        return n

    def destroy(self) -> None:
        """Release the C mailbox. The C side purges and parks it for
        recycling rather than freeing, so a thread that snapshotted the
        pointer just before polls bumped generations, never freed heap."""
        if self.ptr:
            ptr, self.ptr = self.ptr, None
            self._pub = None
            self._pub_buf = None
            self.lib.ucc_mailbox_destroy(ptr)
            self._send_keep.clear()


def poll_pending(reqs):
    """Poll a mixed request list, batching native requests per mailbox
    through ``ucc_req_test_many``; returns the still-pending subset."""
    groups = {}
    pending = []
    for r in reqs:
        mb = getattr(r, "mb", None)
        if mb is not None and getattr(r, "rid", 0) and not r._done:
            groups.setdefault(id(mb), (mb, []))[1].append(r)
        elif not r.test():
            pending.append(r)
    for mb, group in groups.values():
        pending.extend(mb.test_many(group))
    return pending
