"""ctypes bindings for the port's native core: the tag matcher
(``native_src/ucc_tpu_torch_core.cc``) and the cross-process arena
(``native_src/ucc_tpu_torch_ipc.cc``), the port's own copies of the JAX
package's C++ sources (v2, ABI 6).

Both sources are built on first use with ``g++`` into one library,
``ucc_tpu_torch/build/native-<hash>/libucc_tpu_torch_core.so`` (linked
with ``-lrt`` for POSIX shared memory), the hash covering both sources
and the compiler flags, so an edited source is rebuilt and an unchanged
one is not. Several processes (test workers) may ask at
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

``IpcArena`` is one attached arena: a POSIX shared-memory segment
(``/dev/shm/ucc-torch-ipc-<digest>``) holding the match structures, the
completion slots, the payload blocks, a key intern table and a per-rank
pid board, so ranks in different processes of one host match and deliver
through it (tl/ipc). Segments whose processes are all dead are unlinked
by ``reap_stale_arenas``, which only ever touches the port's own prefix.

The native execution plans (``ucc_plan_*``, driven by ``dsl/plan.py``),
the MPMC queue (``NativeMpmcQueue``) and the arena's window heap (the
pooled tier of ``dsl/compile.py``: ``IpcArena.window/view/store_release/
load_acquire``) are bound too. Not bound: the arena's occupancy and
per-rank purge, and the CPython fastcall extension, which is not built.
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
_IPC_SRC_PATH = os.path.join(_PKG, "native_src", "ucc_tpu_torch_ipc.cc")
_BUILD_DIR = os.path.join(_PKG, "build")
LIB_NAME = "libucc_tpu_torch_core.so"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-Werror",
            "-pthread"]
LDLIBS = ["-lrt"]

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

_ST_OK = 1
_ST_TRUNCATED = 2
_ST_FENCED = 3
_ST_CANCELED = 4
_ST_CORRUPT = 6

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


def _sources():
    return [_SRC_PATH, _IPC_SRC_PATH]


def _build_key() -> str:
    digest = hashlib.sha256(" ".join(CXXFLAGS + LDLIBS).encode())
    for path in _sources():
        with open(path, "rb") as fh:
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
            cmd = [_compiler(), *CXXFLAGS, "-shared", "-o", tmp,
                   *_sources(), *LDLIBS]
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
    lib.ucc_mailbox_push2.restype = u64
    lib.ucc_mailbox_push2.argtypes = [vp, u64, u64, u64, vp, u64, u64, u64]
    lib.ucc_mailbox_set_integrity.restype = None
    lib.ucc_mailbox_set_integrity.argtypes = [vp, u64]
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
    # native execution plans (dsl/plan.py)
    lib.ucc_plan_build.restype = vp
    lib.ucc_plan_build.argtypes = [vp, u64, ctypes.POINTER(vp), u64,
                                   ctypes.POINTER(u64), vp, u64,
                                   ctypes.POINTER(u64)]
    lib.ucc_plan_post.restype = ctypes.c_int
    lib.ucc_plan_post.argtypes = [vp, vp, u64]
    lib.ucc_plan_test.restype = u64
    lib.ucc_plan_test.argtypes = [vp]
    lib.ucc_plan_assist_done.restype = None
    lib.ucc_plan_assist_done.argtypes = [vp]
    lib.ucc_plan_cancel.restype = u64
    lib.ucc_plan_cancel.argtypes = [vp]
    lib.ucc_plan_counters.restype = None
    lib.ucc_plan_counters.argtypes = [vp, ctypes.POINTER(u64)]
    lib.ucc_plan_destroy.restype = None
    lib.ucc_plan_destroy.argtypes = [vp]
    lib.ucc_plan_ffi_calls.restype = u64
    lib.ucc_plan_ffi_calls.argtypes = []
    # the bounded MPMC queue
    lib.ucc_mpmc_create.restype = vp
    lib.ucc_mpmc_create.argtypes = [u64]
    lib.ucc_mpmc_destroy.restype = None
    lib.ucc_mpmc_destroy.argtypes = [vp]
    lib.ucc_mpmc_push.restype = ctypes.c_int
    lib.ucc_mpmc_push.argtypes = [vp, u64]
    lib.ucc_mpmc_pop.restype = ctypes.c_int
    lib.ucc_mpmc_pop.argtypes = [vp, ctypes.POINTER(u64)]
    # the cross-process arena (ucc_tpu_torch_ipc.cc)
    lib.ucc_mailbox_attach.restype = vp
    lib.ucc_mailbox_attach.argtypes = [ctypes.c_char_p, u64, u64]
    lib.ucc_arena_probe.restype = u64
    lib.ucc_arena_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(u64),
                                    u64]
    lib.ucc_arena_detach.restype = None
    lib.ucc_arena_detach.argtypes = [vp, ctypes.c_int]
    for name in ("ucc_arena_created", "ucc_ipc_slot_cap",
                 "ucc_arena_max_msg"):
        getattr(lib, name).restype = u64
        getattr(lib, name).argtypes = [vp]
    lib.ucc_ipc_pub_base.restype = vp
    lib.ucc_ipc_pub_base.argtypes = [vp]
    lib.ucc_arena_base.restype = vp
    lib.ucc_arena_base.argtypes = [vp]
    lib.ucc_arena_register.restype = u64
    lib.ucc_arena_register.argtypes = [vp, u64, u64]
    lib.ucc_arena_beat.restype = None
    lib.ucc_arena_beat.argtypes = [vp, u64]
    for name in ("ucc_arena_peer_pid", "ucc_arena_beat_age_ms",
                 "ucc_arena_alloc", "ucc_ipc_req_poll", "ucc_ipc_req_nbytes",
                 "ucc_ipc_req_sent_nbytes"):
        getattr(lib, name).restype = u64
        getattr(lib, name).argtypes = [vp, u64]
    lib.ucc_arena_intern.restype = u64
    lib.ucc_arena_intern.argtypes = [vp, ctypes.c_char_p, u64]
    lib.ucc_arena_free.restype = None
    lib.ucc_arena_free.argtypes = [vp, u64]
    lib.ucc_ipc_push.restype = u64
    lib.ucc_ipc_push.argtypes = [vp, u64, u64, u64, u64, vp, u64, u64, u64]
    lib.ucc_ipc_set_integrity.restype = None
    lib.ucc_ipc_set_integrity.argtypes = [vp, u64]
    lib.ucc_ipc_post_recv.restype = u64
    lib.ucc_ipc_post_recv.argtypes = [vp, u64, u64, u64, u64, u64, u64]
    lib.ucc_ipc_req_cancel.restype = ctypes.c_int
    lib.ucc_ipc_req_cancel.argtypes = [vp, u64, u64, u64, u64, u64]
    lib.ucc_ipc_req_free.restype = None
    lib.ucc_ipc_req_free.argtypes = [vp, u64]
    lib.ucc_ipc_fence.restype = u64
    lib.ucc_ipc_fence.argtypes = [vp, u64, u64]
    lib.ucc_ipc_purge_rank.restype = u64
    lib.ucc_ipc_purge_rank.argtypes = [vp, u64]
    lib.ucc_arena_counters.restype = None
    lib.ucc_arena_counters.argtypes = [vp, ctypes.POINTER(u64)]
    lib.ucc_store_release_u64.restype = None
    lib.ucc_store_release_u64.argtypes = [vp, u64]
    lib.ucc_load_acquire_u64.restype = u64
    lib.ucc_load_acquire_u64.argtypes = [vp]
    # the arena's window heap (the pooled tier)
    lib.ucc_arena_window.restype = u64
    lib.ucc_arena_window.argtypes = [vp, u64, u64]
    lib.ucc_arena_store_release.restype = None
    lib.ucc_arena_store_release.argtypes = [vp, u64, u64]
    lib.ucc_arena_load_acquire.restype = u64
    lib.ucc_arena_load_acquire.argtypes = [vp, u64]


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


def available() -> bool:
    """True when the native core is loaded (or loads now)."""
    return get_lib() is not None


def plan_ffi_calls() -> int:
    """Process-wide count of the plans' data-path ffi crossings
    (``ucc_plan_post/test/assist_done``): one per collective when a plan
    runs without assist rounds. 0 when the core is not loaded."""
    lib = get_lib()
    return int(lib.ucc_plan_ffi_calls()) if lib is not None else 0


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
                 "nbytes", "error", "cancelled", "corrupt_src")

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
        self.corrupt_src = None      # sender ctx rank on a wire crc mismatch

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
        if st == _ST_CORRUPT:
            # the nbytes field carries the SENDER's ctx rank (the C side
            # parks it there for attribution; the payload failed its
            # checksum and must not be consumed)
            self.corrupt_src = nb
            self.nbytes = 0
            self.error = (f"data corrupted: crc32 mismatch (from ctx "
                          f"rank {nb})")
        elif st == _ST_TRUNCATED:
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
        #: buffers pinned for the mailbox's life (``pin``)
        self._pin_keep = []
        self._free_pending = []
        self._free_mu = threading.Lock()
        self._push_fn = lib.ucc_mailbox_push
        self._push2_fn = lib.ucc_mailbox_push2
        self._post_fn = lib.ucc_mailbox_post_recv
        # UCC_INTEGRITY=wire|verify arms the C-side checksum and verify
        # for this endpoint's whole life, plan-executor rounds included
        # (they never re-enter python). Off leaves the flag 0 (a recycled
        # C mailbox is disarmed at create): the entry path is unchanged
        from . import integrity as _integ
        if _integ.WIRE:
            lib.ucc_mailbox_set_integrity(self.ptr, 1)

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
                    eager_limit: Optional[int] = None,
                    crc: Optional[int] = None):
        """Send: ``(req, kind)`` with kind in direct / eager / rndv /
        fenced. A direct send lands copy-free in the posted dst inside
        this call. *eager_limit* defaults to UCC_HOST_EAGER_LIMIT. *crc*
        (a zlib.crc32 of the payload as the SENDER computed it) goes
        through ``ucc_mailbox_push2``, so delivery verifies against that
        word instead of recomputing it: the fault injector's clean
        checksum beside a corrupted payload."""
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
        if crc is None:
            ret = self._push_fn(ptr, a, b, c, data.ctypes.data,
                                data.nbytes, eager_limit)
        else:
            ret = self._push2_fn(ptr, a, b, c, data.ctypes.data,
                                 data.nbytes, eager_limit,
                                 (1 << 32) | (crc & 0xFFFFFFFF))
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

    def pin(self, obj) -> None:
        """Keep *obj* alive until this mailbox's purge or destroy: the
        keepalive of last resort for zero-copy entries the C side holds
        raw pointers into when their owner cannot track delivery (a
        cancelled or failed execution plan, ``dsl/plan.NativePlan``)."""
        self._pin_keep.append(obj)

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
        self._pin_keep.clear()
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
            self._pin_keep.clear()


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


# ---------------------------------------------------------------------------
# cross-process shared-memory arena (native_src/ucc_tpu_torch_ipc.cc)
# ---------------------------------------------------------------------------

#: /dev/shm segment name prefix of the port's arenas: the reaper only ever
#: touches these (the JAX package's ``ucc-ipc-`` segments are not its own)
ARENA_PREFIX = "ucc-torch-ipc-"

#: ucc_arena_counters export order (the C_* enum of ucc_tpu_torch_ipc.cc)
ARENA_COUNTER_NAMES = (
    "n_direct", "n_eager", "n_rndv", "n_fenced", "bytes_moved",
    "attaches", "alloc_fail", "unexp_parked", "posted_parked",
    "slots_live", "purged", "corrupt", "truncated", "canceled",
    "interned_keys", "windows", "window_bytes", "blocks_live")


class IpcSendReq:
    """Cross-process rendezvous send: the payload is STAGED into an arena
    block (raw pointers cannot cross address spaces), but the request
    keeps rndv semantics — it completes only when a matching recv on the
    other side consumes the entry."""

    __slots__ = ("arena", "rid", "_idx", "_gen", "_done", "cancelled")

    def __init__(self, arena: "IpcArena", rid: int):
        self.arena = arena
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
        ar = self.arena
        pub = ar._pub
        if pub is None:
            self._done = True
            return True
        v = pub[self._idx]
        if (v >> 32) != self._gen or (v & 7):
            ptr = ar.ptr
            if ptr is None or int(ar.lib.ucc_ipc_req_poll(ptr, self.rid)):
                if ptr is not None:
                    ar.lib.ucc_ipc_req_free(ptr, self.rid)
                self._done = True
        return self._done

    def cancel(self) -> None:
        """Stop waiting; the staged payload stays deliverable (arena-
        owned — no keepalive to release)."""
        self.cancelled = True
        self._done = True


class IpcRecvReq:
    """Posted cross-process recv. The destination ndarray cannot be
    handed to the other process, so delivery lands in an arena bounce
    block and this request copies out exactly once at completion."""

    __slots__ = ("arena", "rid", "_idx", "_gen", "_key4", "_blk",
                 "dst_keepalive", "_done", "nbytes", "error", "cancelled",
                 "corrupt_src")

    def __init__(self, arena: "IpcArena", rid: int, key4, blk: int,
                 dst: np.ndarray):
        self.arena = arena
        self.rid = rid
        self._idx = rid & _IDX_MASK
        self._gen = rid >> _SLOT_BITS
        self._key4 = key4
        self._blk = blk
        self.dst_keepalive = dst
        self._done = False
        self.nbytes = 0
        self.error = None
        self.cancelled = False
        self.corrupt_src = None

    @property
    def done(self) -> bool:
        return self.test()

    def test(self) -> bool:
        if self._done:
            return True
        ar = self.arena
        pub = ar._pub
        if pub is None:
            self._release(None)
            self._done = True
            return True
        v = pub[self._idx]
        if (v >> 32) != self._gen:
            self._release(ar.ptr)
            self._done = True         # freed under us (purge/teardown)
            return True
        if not (v & 7):
            return False
        # confirm with one acquire-ordered ffi load before copying the
        # payload out of the arena (same visibility contract as
        # NativeRecvReq.test — the delivering memcpy ran in ANOTHER
        # PROCESS, so the barrier is the only ordering we own)
        ptr = ar.ptr
        if ptr is None:
            self._release(None)
            self._done = True
            return True
        v = int(ar.lib.ucc_ipc_req_poll(ptr, self.rid))
        if v == 0:
            return False
        self._finish(v, ptr)
        return True

    def _finish(self, v: int, ptr) -> None:
        ar = self.arena
        st = v & 7
        nb = (v >> 3) & _NB_MAX
        if nb == _NB_MAX:
            nb = int(ar.lib.ucc_ipc_req_nbytes(ptr, self.rid))
        if st == _ST_CORRUPT:
            self.corrupt_src = nb
            self.nbytes = 0
            self.error = (f"data corrupted: crc32 mismatch (from ctx "
                          f"rank {nb})")
        elif st in (_ST_OK, _ST_TRUNCATED):
            self.nbytes = nb
            if self._blk and nb:
                ctypes.memmove(self.dst_keepalive.ctypes.data,
                               ar.base + self._blk, nb)
            if st == _ST_TRUNCATED:
                sent = int(ar.lib.ucc_ipc_req_sent_nbytes(ptr, self.rid))
                self.error = (f"message truncated: sent {sent} bytes "
                              f"into a {self.dst_keepalive.nbytes}-byte "
                              f"recv buffer")
        elif st == _ST_FENCED:
            self.error = "fenced: stale team epoch"
            self.cancelled = True
        elif st == _ST_CANCELED:
            self.error = self.error or "canceled"
            self.cancelled = True
        ar.lib.ucc_ipc_req_free(ptr, self.rid)
        self._release(ptr, keep_rid=True)
        self._done = True

    def _release(self, ptr, keep_rid: bool = False) -> None:
        """Return the bounce block (and, unless already freed, the
        request slot) to the arena."""
        ar = self.arena
        if self._blk and ptr is not None:
            ar.lib.ucc_arena_free(ptr, self._blk)
        self._blk = 0
        if not keep_rid and ptr is not None:
            ar.lib.ucc_ipc_req_free(ptr, self.rid)

    def cancel(self) -> None:
        """Withdraw: unlinked under the shard lock that matches, so a
        delivered request stays delivered (RecvReq.cancel contract)."""
        if self._done:
            self.cancelled = True
            return
        ar = self.arena
        ptr = ar.ptr
        if ptr is None:
            self.error = self.error or "canceled"
            self.cancelled = True
            self._done = True
            return
        a, b, c, d = self._key4
        if ar.lib.ucc_ipc_req_cancel(ptr, a, b, c, d, self.rid):
            self.error = self.error or "canceled"
            self.cancelled = True
            self._release(ptr)
            self._done = True
        else:
            self.test()               # already delivered/fenced: harvest
            self.cancelled = True


class IpcArena:
    """Python handle on one attached cross-process arena: key packing
    (via the arena's shared intern table, so every process derives the
    SAME ids), the push/post_recv data path, fences, the pid board and
    the shared counters. With *integrity* (UCC_INTEGRITY=wire|verify)
    the arena checksums every push lacking a caller word and verifies
    every delivery."""

    def __init__(self, shm_name: str, heap_bytes: int = 256 << 20,
                 win_bytes: int = 16 << 20, integrity: bool = False):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native core unavailable (the IPC arena "
                               "has no Python fallback)")
        self.lib = lib
        self.name = shm_name if shm_name.startswith("/") \
            else "/" + shm_name
        self.ptr = lib.ucc_mailbox_attach(self.name.encode(), heap_bytes,
                                          win_bytes)
        if not self.ptr:
            raise RuntimeError(f"arena attach failed: {self.name}")
        self.created = bool(lib.ucc_arena_created(self.ptr))
        self.base = int(lib.ucc_arena_base(self.ptr))
        self.max_msg = int(lib.ucc_arena_max_msg(self.ptr))
        self.slot_cap = int(lib.ucc_ipc_slot_cap(self.ptr))
        pub_addr = lib.ucc_ipc_pub_base(self.ptr)
        self._pub_buf = (ctypes.c_uint64 * self.slot_cap).from_address(
            pub_addr)
        self._pub = memoryview(self._pub_buf).cast("B").cast("Q")
        self._intern_cache: dict = {}
        self._intern_mu = threading.Lock()
        if integrity:
            lib.ucc_ipc_set_integrity(self.ptr, 1)

    # -- key packing (cross-process-stable) ----------------------------
    def _intern(self, obj) -> int:
        """Deterministic bytes -> shared id: every process interning the
        same key gets the same id back from the arena table (the process-
        global counter NativeMailbox uses cannot work across processes)."""
        v = self._intern_cache.get(obj)
        if v is not None:
            return v
        raw = repr(obj).encode()
        if len(raw) > 120:
            import hashlib
            raw = hashlib.sha1(raw).hexdigest().encode()
        with self._intern_mu:
            v = self._intern_cache.get(obj)
            if v is None:
                v = int(self.lib.ucc_arena_intern(self.ptr, raw,
                                                  len(raw)))
                if v == 0:
                    raise RuntimeError("arena intern table full")
                self._intern_cache[obj] = v
        return v

    def pack(self, key):
        """TagKey -> three u64 words, same canonical shape as
        NativeMailbox._pack but with arena-interned ids."""
        try:
            team, epoch, tag, slot, src = key
        except (TypeError, ValueError):
            return (self._intern(("K", key)) << 32, 0, 0)
        if type(epoch) is not int or type(slot) is not int \
                or type(src) is not int:
            return (self._intern(("K", key)) << 32, 0, 0)
        if type(tag) is not int:
            if isinstance(tag, tuple) and len(tag) == 2 \
                    and tag[0] == "svc" and type(tag[1]) is int:
                tag = _SVC_TAG_BASE | (tag[1] & 0xFFFFFFFFFFFF)
            else:
                tag = _TUPLE_TAG_BASE | self._intern(("T", tag))
        team_id = self._intern(("team", team))
        return ((team_id << 32) | (epoch & 0xFFFFFFFF), tag,
                ((slot & 0xFFFFFFFF) << 32) | (src & 0xFFFFFFFF))

    def team_id(self, team_key) -> int:
        return self._intern(("team", team_key))

    # -- data path -----------------------------------------------------
    def push(self, key, dst_rank: int, data: np.ndarray,
             eager_limit: Optional[int] = None,
             crc: Optional[int] = None):
        """Send *data* to context rank *dst_rank*: ``(req, kind)`` with
        the Mailbox.send kind vocabulary. Direct sends memcpy straight
        into the receiver's bounce inside this call — across the process
        boundary."""
        ptr = self.ptr
        if ptr is None:
            return _DoneSend(), "eager"
        if data.nbytes > self.max_msg:
            raise ValueError(
                f"message of {data.nbytes} bytes exceeds the arena "
                f"payload class cap ({self.max_msg}); raise "
                f"UCC_TL_IPC_HEAP or route this team over the socket TL")
        if eager_limit is None:
            from .tl.host.transport import eager_limit_from_env
            eager_limit = eager_limit_from_env()
        if not data.flags["C_CONTIGUOUS"]:
            data = np.ascontiguousarray(data)
        a, b, c = self.pack(key)
        # the last word is the caller's payload checksum, (1 << 32) | crc32,
        # or 0: none (an armed arena then computes it itself)
        crc_word = (1 << 32) | (crc & 0xFFFFFFFF) if crc is not None \
            else 0
        ret = int(self.lib.ucc_ipc_push(
            ptr, a, b, c, dst_rank, data.ctypes.data, data.nbytes,
            eager_limit, crc_word))
        kind = ret & 7
        if kind == 2:
            return IpcSendReq(self, ret >> 3), "rndv"
        if kind == 7:
            raise RuntimeError(
                "arena payload heap exhausted (alloc_fail): raise "
                "UCC_TL_IPC_HEAP or drain posted traffic")
        return _DoneSend(), _KIND_STR[kind]

    def post_recv(self, key, dst_rank: int,
                  dst: np.ndarray) -> IpcRecvReq:
        ptr = self.ptr
        if ptr is None:
            raise RuntimeError("arena is detached")
        if not dst.flags["C_CONTIGUOUS"] or not dst.flags["WRITEABLE"]:
            raise ValueError("recv destination must be C-contiguous "
                             "and writable")
        if dst.nbytes > self.max_msg:
            raise ValueError(
                f"recv of {dst.nbytes} bytes exceeds the arena payload "
                f"class cap ({self.max_msg}); raise UCC_TL_IPC_HEAP or "
                f"route this team over the socket TL")
        blk = int(self.lib.ucc_arena_alloc(ptr, max(dst.nbytes, 1)))
        if blk == 0:
            raise RuntimeError(
                "arena payload heap exhausted (alloc_fail): raise "
                "UCC_TL_IPC_HEAP or drain posted traffic")
        a, b, c = self.pack(key)
        rid = int(self.lib.ucc_ipc_post_recv(ptr, a, b, c, dst_rank, blk,
                                             dst.nbytes))
        if rid == 0:
            self.lib.ucc_arena_free(ptr, blk)
            raise RuntimeError("arena request slots exhausted")
        return IpcRecvReq(self, rid, (a, b, c, dst_rank), blk, dst)

    # -- control plane -------------------------------------------------
    def fence(self, team_key, min_epoch: int) -> int:
        ptr = self.ptr
        if ptr is None:
            return 0
        return int(self.lib.ucc_ipc_fence(ptr, self.team_id(team_key),
                                          min_epoch))

    def purge_rank(self, ctx_rank: int) -> int:
        """Reclaim every arena entry addressed to *ctx_rank* (a rank
        confirmed dead): its posted recvs are cancelled and the payloads
        parked for it freed. Returns the number of entries purged."""
        ptr = self.ptr
        if ptr is None:
            return 0
        return int(self.lib.ucc_ipc_purge_rank(ptr, int(ctx_rank)))

    def register(self, ctx_rank: int, pid: Optional[int] = None) -> None:
        if self.ptr:
            self.lib.ucc_arena_register(self.ptr, ctx_rank,
                                        pid if pid is not None
                                        else os.getpid())

    def beat(self, ctx_rank: int) -> None:
        if self.ptr:
            self.lib.ucc_arena_beat(self.ptr, ctx_rank)

    def peer_pid(self, ctx_rank: int) -> int:
        return int(self.lib.ucc_arena_peer_pid(self.ptr, ctx_rank)) \
            if self.ptr else 0

    def beat_age_ms(self, ctx_rank: int) -> Optional[float]:
        """Milliseconds since *ctx_rank* last beat; None when it never
        registered in this arena."""
        if not self.ptr:
            return None
        v = int(self.lib.ucc_arena_beat_age_ms(self.ptr, ctx_rank))
        return None if v == (1 << 64) - 1 else float(v)

    # -- the window heap (pooled tier, dsl/compile.py) ------------------
    def window(self, key_obj, nbytes: int) -> int:
        """Get or create the persistent named window *key_obj* of at least
        *nbytes*; its arena offset, 0 when the window heap is full."""
        return int(self.lib.ucc_arena_window(
            self.ptr, self._intern(("W", key_obj)), nbytes)) \
            if self.ptr else 0

    def store_release(self, off: int, val: int) -> None:
        self.lib.ucc_arena_store_release(self.ptr, off, val)

    def load_acquire(self, off: int) -> int:
        return int(self.lib.ucc_arena_load_acquire(self.ptr, off))

    def view(self, off: int, nbytes: int) -> np.ndarray:
        """uint8 view of arena bytes [off, off + nbytes)."""
        buf = (ctypes.c_uint8 * nbytes).from_address(self.base + off)
        return np.frombuffer(buf, dtype=np.uint8)

    def counters(self) -> dict:
        out = (ctypes.c_uint64 * 24)()
        if self.ptr:
            self.lib.ucc_arena_counters(self.ptr, out)
        return {name: int(out[i])
                for i, name in enumerate(ARENA_COUNTER_NAMES)}

    def detach(self, unlink: bool = False) -> None:
        if self.ptr:
            ptr, self.ptr = self.ptr, None
            self._pub = None
            self._pub_buf = None
            self.lib.ucc_arena_detach(ptr, 1 if unlink else 0)


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True               # exists, owned by someone else
    except OSError:
        return True               # unknowable: never reap on doubt


def reap_stale_arenas(prefix: str = ARENA_PREFIX) -> list:
    """Unlink /dev/shm/ucc-torch-ipc-* segments whose creator AND every
    registered rank pid are dead (a crashed run leaks its arena — the
    kernel only reclaims at unlink). Called at context create; returns
    the reaped names. A segment that probes as not-ready is left alone
    unless its file is old enough that no live create can explain it."""
    lib = get_lib()
    if lib is None:
        return []
    try:
        names = os.listdir("/dev/shm")
    except OSError:
        return []
    reaped = []
    for fn in names:
        if not fn.startswith(prefix):
            continue
        path = "/dev/shm/" + fn
        out = (ctypes.c_uint64 * 300)()
        n = int(lib.ucc_arena_probe(("/" + fn).encode(), out, 300))
        if n == 0:
            # unreadable or mid-create: only a long-abandoned file
            # (creator crashed between shm_open and ready=1) is reaped
            try:
                import time
                if time.time() - os.path.getmtime(path) < 300:
                    continue
            except OSError:
                continue
        elif any(_pid_alive(int(out[i])) for i in range(n)):
            continue
        try:
            os.unlink(path)
            reaped.append(fn)
            logger.info("reaped stale arena %s", fn)
        except OSError:
            pass
    return reaped


class NativeMpmcQueue:
    """Bounded lock-free MPMC queue of uint64 handles (UCC's
    ucc_lock_free_queue)."""

    def __init__(self, capacity: int = 4096):
        self.lib = get_lib()
        if self.lib is None:
            raise RuntimeError(f"native core unavailable: {_ERROR}")
        self.ptr = self.lib.ucc_mpmc_create(capacity)

    def push(self, v: int) -> bool:
        """False when the queue is full."""
        return bool(self.lib.ucc_mpmc_push(self.ptr, v))

    def pop(self) -> Optional[int]:
        """The oldest handle, or None when the queue is empty."""
        out = ctypes.c_uint64()
        if self.lib.ucc_mpmc_pop(self.ptr, ctypes.byref(out)):
            return int(out.value)
        return None

    def destroy(self) -> None:
        if self.ptr:
            self.lib.ucc_mpmc_destroy(self.ptr)
            self.ptr = None
