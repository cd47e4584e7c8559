"""The rounds of a device team whose ranks live in several processes of
one host: the per-team sync area in shared memory, the descriptors of the
ranks' buffers, and one launch per process per round.

This is the half of the JAX package's tl/xla rendezvous that a team
spanning processes needs there (``ucc_tpu/tl/xla.py``: one program over
the global array of every process's local shards). The port follows UCC's
tl/cuda instead (its ``UCC_TL_CUDA_TEAM_SYNC`` control segment of per-rank
sync slots): every process launches its own part of the round over the
buffers of all n ranks, its own and its peers' mapped through CUDA IPC.

The sync area is one file in /dev/shm per spanning team and TL, named
``ucc-torch-dev-<digest>``; every process derives the digest from the
team's key and its lowest rank's context id, as tl/ipc derives its
arena's name, so no message is needed to agree on it. Process 0 (the
process of the team's rank 0) creates it (a temporary file linked into
place once written, so a peer never maps a half-made one); the others
attach; it unlinks it at destroy. Layout (8-byte words, each written by
one process):

- a header: magic, P processes, K slots, the slot capacity, the creator's
  pid;
- per process: its hello word (its pid, once attached), its done word (the
  last round it launched) and, on CUDA, the IPC handles of its K
  interprocess events E_ready and E_done (exchanged once, at create);
- per process and slot: the sequence word (the round last published
  there), the round's tag, and the descriptor: the process's local ranks'
  buffers (a CUDA IPC descriptor each, ``kernels/cuda_ipc.py``), and the
  counts, displacements and blocks that a v-collective's peers need. A
  descriptor equal to the last one the process sent for the same tag is
  not sent again (length 0): persistent rounds send none. Slots are sized
  at create to hold the descriptor of every collective of the team's size,
  the v-collectives' n counts included.

The sequence and done words are published with release stores and read
with acquire loads (the native core's ``ucc_store_release_u64`` /
``ucc_load_acquire_u64``): a spanning team needs the native core.

One round r (slot k = r mod K) in process p:

1. When p's local ranks have all deposited, the team stream waits for
   their inputs, and E_ready[p][k] is recorded on it.
2. p writes its descriptor and the tag into slot (p, k) and publishes r in
   its sequence word, once every process's done word shows r - K (so every
   peer has read the slot's last round and waits no more on its events).
3. When every peer's slot k shows r, p opens the buffers it has not
   opened before, makes the team stream wait on every peer's E_ready,
   launches its part, records E_done[p][k] and publishes r in its done
   word.
4. A local rank's request completes when every process's done word shows r
   and every E_done[.][k] has completed: peers write into p's dsts and
   read p's srcs, so a src may be reused and a dst read once ``test()``
   returns OK.

No kernel waits on another process: the launches are ordered by the
interprocess events on the streams, and the host polls the words without
blocking (``test()``). A peer that stops (dies, or never posts) ends the
requests of the others with ERR_TIMED_OUT after ``SPAN_TIMEOUT_S`` seconds
(600, PyTorch's default for a NCCL process group), or within a second
when its process is gone, and the team fails every later round.

The CPU stand-in (DEVICE ``cpu``): there is no CUDA IPC, so each process
stages its local ranks' srcs (and, where peers write them, its dsts) into
files of its own in /dev/shm (``<name>-d<p>-<i>``), which its peers map;
the same part-p-of-P plain versions run over those views, and each process
copies its local ranks' dsts back when the round completes. Tier-1 tests
run the split, the sync area and the descriptors this way; it is never
used on CUDA.
"""
from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import mmap
import os
import pickle
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..obs import metrics
from ..status import Status, UccError
from ..utils.log import get_logger

logger = get_logger("tl_device")

#: the port's own prefix (tl/ipc's arenas are ucc-torch-ipc-, the JAX
#: package's ucc-ipc-)
SYNC_PREFIX = "ucc-torch-dev-"
#: concurrent rounds a spanning team keeps in flight
SLOTS = 8
_MAGIC = 0x75636374646576   # "ucctdev"
_WORD = 8
_HEADER = 64
_EVENT_HANDLE = 64
#: a process's hello block: hello, done, pid words, then 2 x SLOTS handles
_HELLO = 64 + 2 * SLOTS * _EVENT_HANDLE
#: a slot's header: sequence, tag, descriptor length
_SLOT_HEAD = 64
#: descriptor bytes of one rank: its two buffers and, for v-collectives,
#: four vectors of n counts
_RANK_DESC = 1024
#: first size of a process's host staging file (CPU stand-in)
_STAGE_MIN = 1 << 20
#: (process, tag) descriptors a process keeps; a writer remembers fewer
#: (``_SENT_MAX``), so a reader always holds what a writer calls unchanged
_PEER_DESC_MAX = 4096
_SENT_MAX = 64
#: seconds between a stalled round's checks that its peers' processes
#: are alive
_CHECK_PERIOD = 0.5
#: seconds a spanning team waits for a live peer process, at create and in
#: a round, before it ends the request with ERR_TIMED_OUT: PyTorch's
#: default for a NCCL process group. A request's own deadline is
#: CollArgsFlags.TIMEOUT, as on every team.
SPAN_TIMEOUT_S = 600.0


def shm_dir() -> str:
    return "/dev/shm" if os.path.isdir("/dev/shm") else "/tmp"


def sync_name(team_key, scope, tl: str, uid: str) -> str:
    """The sync area's name: the same in every process of the team."""
    digest = hashlib.sha1(repr((team_key, scope, tl, uid)).encode())
    return SYNC_PREFIX + digest.hexdigest()[:20]


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    return True


def _atomics():
    from .. import native
    lib = native.get_lib()
    if lib is None:
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       "device teams across processes publish their rounds "
                       "through the native core, which is unavailable: "
                       f"{native.build_error()}")
    return lib


# ---------------------------------------------------------------------------
# the mapped area
# ---------------------------------------------------------------------------

class SyncArea:
    """One mapped sync area: P processes, SLOTS slots each."""

    def __init__(self, path: str, fd: int, created: bool, nprocs: int,
                 slot_cap: int):
        self.path = path
        self.created = created
        self.nprocs = nprocs
        self.slot_cap = slot_cap
        self.size = self.bytes_for(nprocs, slot_cap)
        self.mm = mmap.mmap(fd, self.size)
        os.close(fd)
        self._anchor = ctypes.c_char.from_buffer(self.mm)
        self.base = ctypes.addressof(self._anchor)
        self.lib = _atomics()

    @staticmethod
    def bytes_for(nprocs: int, slot_cap: int) -> int:
        return _HEADER + nprocs * (_HELLO + SLOTS * (_SLOT_HEAD + slot_cap))

    @classmethod
    def create(cls, path: str, nprocs: int, slot_cap: int) -> "SyncArea":
        tmp = f"{path}.{os.getpid()}.tmp"
        fd = os.open(tmp, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, cls.bytes_for(nprocs, slot_cap))
            area = cls(path, fd, True, nprocs, slot_cap)
            for i, v in enumerate((_MAGIC, nprocs, SLOTS, slot_cap,
                                   os.getpid())):
                area.store(i * _WORD, v)
            os.link(tmp, path)     # visible only once whole
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return area

    @classmethod
    def attach(cls, path: str, nprocs: int,
               slot_cap: int) -> Optional["SyncArea"]:
        try:
            fd = os.open(path, os.O_RDWR)
        except FileNotFoundError:
            return None
        if os.fstat(fd).st_size != cls.bytes_for(nprocs, slot_cap):
            os.close(fd)
            raise UccError(Status.ERR_NO_MESSAGE,
                           f"sync area {path} has another layout")
        area = cls(path, fd, False, nprocs, slot_cap)
        if area.load(0) != _MAGIC or area.load(_WORD) != nprocs:
            area.close()
            raise UccError(Status.ERR_NO_MESSAGE,
                           f"sync area {path} has another layout")
        return area

    # words
    def store(self, off: int, val: int) -> None:
        self.lib.ucc_store_release_u64(self.base + off, int(val))

    def load(self, off: int) -> int:
        return int(self.lib.ucc_load_acquire_u64(self.base + off))

    # offsets
    def creator_pid(self) -> int:
        return self.load(4 * _WORD)

    def hello_off(self, p: int) -> int:
        return _HEADER + p * _HELLO

    def done_off(self, p: int) -> int:
        return self.hello_off(p) + _WORD

    def event_off(self, p: int, which: int, k: int) -> int:
        return self.hello_off(p) + 64 + (which * SLOTS + k) * _EVENT_HANDLE

    def slot_off(self, p: int, k: int) -> int:
        return (_HEADER + self.nprocs * _HELLO +
                (p * SLOTS + k) * (_SLOT_HEAD + self.slot_cap))

    def write(self, off: int, data: bytes) -> None:
        self.mm[off:off + len(data)] = data

    def read(self, off: int, n: int) -> bytes:
        return bytes(self.mm[off:off + n])

    def close(self) -> None:
        del self._anchor
        self.mm.close()


# ---------------------------------------------------------------------------
# host staging (the CPU stand-in)
# ---------------------------------------------------------------------------

class HostStage:
    """This process's staging files, and its peers' mapped ones. A region
    is kept per (tag, rank, side) so that persistent rounds stage into the
    same place (and send no new descriptor); a retired tag's regions are
    taken again once every process has passed its last round."""

    def __init__(self, name: str, me: int):
        self.prefix = os.path.join(shm_dir(), f"{name}-d{me}-")
        self.files: List[Tuple[str, mmap.mmap, int]] = []
        self.used = 0
        self.regions: Dict[tuple, tuple] = {}
        #: retired regions: (file index, offset, bytes, last round)
        self.free: List[tuple] = []
        self.peers: Dict[str, mmap.mmap] = {}

    def _new_file(self, need: int) -> None:
        size = max(_STAGE_MIN, need,
                   2 * (self.files[-1][2] if self.files else 0))
        path = f"{self.prefix}{len(self.files)}"
        fd = os.open(path, os.O_CREAT | os.O_TRUNC | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, size)
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self.files.append((path, mm, size))
        self.used = 0

    def region(self, key, nbytes: int, min_done: int) -> tuple:
        """(file index, offset, bytes) of *key*'s region of at least
        *nbytes*."""
        have = self.regions.get(key)
        if have is not None and have[2] >= nbytes:
            return have
        for i, (f, off, size, last) in enumerate(self.free):
            if size >= nbytes and last <= min_done:
                del self.free[i]
                self.regions[key] = (f, off, size)
                return self.regions[key]
        need = -(-max(nbytes, 1) // 64) * 64
        if not self.files or self.used + need > self.files[-1][2]:
            self._new_file(need)
        self.regions[key] = (len(self.files) - 1, self.used, need)
        self.used += need
        return self.regions[key]

    def retire(self, tag, last_round: int) -> None:
        for key in [k for k in self.regions if k[0] == tag]:
            f, off, size = self.regions.pop(key)
            self.free.append((f, off, size, last_round))

    def view(self, reg: tuple, like: torch.Tensor) -> torch.Tensor:
        f, off, _ = reg
        nbytes = like.numel() * like.element_size()
        if nbytes == 0:
            return torch.empty(0, dtype=like.dtype)
        return torch.frombuffer(self.files[f][1], dtype=torch.uint8,
                                count=nbytes, offset=off).view(like.dtype)

    def desc(self, reg: tuple, t: torch.Tensor) -> tuple:
        """A staged buffer's descriptor; it also names the caller's buffer
        (its address), so that it changes when the caller's buffers do,
        as a CUDA descriptor does."""
        return ("host", self.files[reg[0]][0], reg[1],
                t.numel() * t.element_size(), t.data_ptr())

    def open_peer(self, desc: tuple) -> Tuple[torch.Tensor, bool]:
        _, path, off, nbytes, _ = desc
        mm = self.peers.get(path)
        opened = mm is None
        if opened:
            fd = os.open(path, os.O_RDWR)
            try:
                mm = self.peers[path] = mmap.mmap(fd, os.fstat(fd).st_size)
            finally:
                os.close(fd)
        if nbytes == 0:
            return torch.empty(0, dtype=torch.uint8), opened
        return torch.frombuffer(mm, dtype=torch.uint8, count=nbytes,
                                offset=off), opened

    def close(self) -> None:
        for path, mm, _ in self.files:
            try:
                os.unlink(path)
            except OSError:
                pass
        # the views' buffers are released with their tensors; the maps
        # close when the last view goes
        self.files, self.peers, self.regions, self.free = [], {}, {}, []


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------

class _Peer:
    """A peer rank's part of a round, as the task programs read it: its
    block (reduce_scatters) and layout (v-collectives, the scatter root)."""

    def __init__(self, meta):
        self.block, self.layout = meta


class Round:
    """One round of a spanning team in this process."""

    __slots__ = ("r", "k", "tag", "slot", "proto", "state", "error",
                 "srcs", "dsts", "staged", "t0", "keep")

    def __init__(self, r: int, tag, slot):
        self.r = r
        self.k = r % SLOTS
        self.tag = tag
        self.slot = slot              # team rank -> (src, dst, ready, task)
        self.proto = slot[min(slot)][3]
        self.state = "queued"         # published, launched, done
        self.error: Optional[UccError] = None
        self.srcs: Dict[int, Any] = {}  # this process's ranks' srcs as sent
        self.dsts: Dict[int, Any] = {}  # and dsts (staged ones on the CPU)
        self.staged: List[tuple] = []   # (staged dst, caller's dst)
        self.t0 = time.monotonic()
        self.keep: tuple = ()


class RoundHandle:
    """What a local rank's task polls: ``done()`` drives the team's rounds
    and says whether this one has completed; it raises the round's
    error."""

    def __init__(self, span: "SpanTeam", rd: Round):
        self.span = span
        self.rd = rd
        self.what = "spanning round"

    def done(self) -> bool:
        with self.span.shared.lock:
            self.span.progress()
        if self.rd.error is not None:
            raise self.rd.error
        return self.rd.state == "done"


class SpanTeam:
    """The rounds of one spanning device team in this process
    (``DeviceTeamShared.span``); every method runs under the shared
    rendezvous lock."""

    def __init__(self, shared, layout, name: str):
        self.shared = shared
        self.device = shared.device
        self.cuda = self.device.type == "cuda"
        self.procs = layout.procs           # process -> its team ranks
        self.P = len(layout.procs)
        self.me = layout.me
        self.n = sum(len(p) for p in layout.procs)
        self.name = name
        self.path = os.path.join(shm_dir(), name)
        self.timeout = SPAN_TIMEOUT_S
        n_local = max(len(p) for p in self.procs)
        self.slot_cap = 4096 + n_local * (_RANK_DESC + 4 * 24 * self.n)
        self.area: Optional[SyncArea] = None
        self.ready = False
        self.t_create = time.monotonic()
        self.rounds: collections.deque = collections.deque()
        self.next_round = 0
        self.failed: Optional[UccError] = None
        self.sent: "collections.OrderedDict" = collections.OrderedDict()
        self.peer_desc: "collections.OrderedDict" = collections.OrderedDict()
        self.peer_tensors: "collections.OrderedDict" = \
            collections.OrderedDict()
        self.last_round: Dict[Any, int] = {}
        self.held: set = set()              # CUDA IPC bases this team holds
        self.stage = None if self.cuda else HostStage(name, self.me)
        self.dev_stage: Dict[tuple, torch.Tensor] = {}
        self.events: List[List[Any]] = []   # [which][k] own events
        self.peer_events: Dict[Tuple[int, int, int], Any] = {}
        self._pids: List[int] = [0] * self.P
        self._last_check = 0.0

    # -- create ---------------------------------------------------------
    def create_step(self) -> Status:
        """One step of team create: attach (or create) the area, publish
        this process's hello and events, wait for every peer's."""
        if self.ready:
            return Status.OK
        if time.monotonic() - self.t_create > self.timeout:
            raise UccError(Status.ERR_TIMED_OUT,
                           f"sync area {self.name}: not every process of "
                           f"the team attached within {self.timeout} s")
        if self.area is None:
            if self.me == 0:
                self.area = SyncArea.create(self.path, self.P, self.slot_cap)
            else:
                self.area = SyncArea.attach(self.path, self.P,
                                            self.slot_cap)
                if self.area is None:
                    return Status.IN_PROGRESS
            if self.cuda:
                with torch.cuda.device(self.device):
                    self.events = [[torch.cuda.Event(interprocess=True)
                                    for _ in range(SLOTS)]
                                   for _ in range(2)]
                    for which in range(2):
                        for k, ev in enumerate(self.events[which]):
                            self.area.write(self.area.event_off(
                                self.me, which, k), bytes(ev.ipc_handle()))
            self.area.store(self.area.hello_off(self.me) + 2 * _WORD,
                            os.getpid())
            self.area.store(self.area.hello_off(self.me), 1)
        for p in range(self.P):
            if self.area.load(self.area.hello_off(p)) == 0:
                return Status.IN_PROGRESS
            self._pids[p] = self.area.load(self.area.hello_off(p) + 2 * _WORD)
        if self.cuda:
            for p in range(self.P):
                if p == self.me:
                    continue
                for which in range(2):
                    for k in range(SLOTS):
                        h = self.area.read(self.area.event_off(p, which, k),
                                           _EVENT_HANDLE)
                        self.peer_events[(p, which, k)] = \
                            torch.cuda.Event.from_ipc_handle(self.device, h)
        self.ready = True
        return Status.OK

    # -- descriptors ----------------------------------------------------
    def _export(self, t: Optional[torch.Tensor]):
        if t is None:
            return None
        from ..kernels import cuda_ipc
        return cuda_ipc.export(t)

    def _open(self, q: int, desc, like_dtype) -> Optional[torch.Tensor]:
        if desc is None:
            return None
        if desc[0] == "cuda":
            from ..kernels import cuda_ipc
            t, opened = cuda_ipc.open_buffer(desc, self.device, self.held)
        else:
            t, opened = self.stage.open_peer(desc)
        if opened:
            metrics.count_span("dev_ipc_opens")
        return t.view(like_dtype)

    def _min_done(self) -> int:
        a = self.area
        return min(a.load(a.done_off(p)) for p in range(self.P))

    def _stage_round(self, rd: Round) -> None:
        """This process's ranks' buffers as its peers will reach them."""
        peers_write = rd.proto.PEERS_WRITE
        local = self.procs[self.me]
        local_dsts = [s[1] for s in rd.slot.values() if s[1] is not None]
        min_done = self._min_done() if not self.cuda else 0
        for tr, (src, dst, _ready, _t) in sorted(rd.slot.items()):
            if self.cuda:
                if src is not None and \
                        rd.proto.peers_read_src(tr, local) and \
                        any(_overlap(src, d) for d in local_dsts):
                    # peers read this src while this process writes its
                    # dsts: an src inside a local dst is read from a copy
                    key = (rd.tag, tr)
                    buf = self.dev_stage.get(key)
                    if buf is None or buf.shape != src.shape:
                        buf = self.dev_stage[key] = torch.empty_like(src)
                    buf.copy_(src)
                    src = buf
                rd.srcs[tr], rd.dsts[tr] = src, dst
                continue
            st = self.stage
            if src is not None:
                reg = st.region((rd.tag, tr, "src"),
                                src.numel() * src.element_size(), min_done)
                view = st.view(reg, src)
                view.copy_(src)
                rd.srcs[tr] = (view, st.desc(reg, src))
            else:
                rd.srcs[tr] = (None, None)
            if dst is not None and peers_write:
                reg = st.region((rd.tag, tr, "dst"),
                                dst.numel() * dst.element_size(), min_done)
                view = st.view(reg, dst)
                rd.staged.append((view, dst))
                rd.dsts[tr] = (view, st.desc(reg, dst))
            else:
                rd.dsts[tr] = (dst, None)

    def _descriptor(self, rd: Round) -> bytes:
        peers_write = rd.proto.PEERS_WRITE
        out = []
        for tr, (_s, _d, _r, task) in sorted(rd.slot.items()):
            if self.cuda:
                sd = self._export(rd.srcs[tr])
                dd = self._export(rd.dsts[tr]) if peers_write else None
                src, dst = rd.srcs[tr], rd.dsts[tr]
            else:
                (src, sd), (dst, dd) = rd.srcs[tr], rd.dsts[tr]
            out.append((tr, sd, None if src is None else src.numel(),
                        dd, None if dst is None else dst.numel(),
                        (getattr(task, "block", None),
                         getattr(task, "layout", None))))
        return pickle.dumps(out, protocol=4)

    # -- round steps ----------------------------------------------------
    def start(self, tag, slot) -> Round:
        """A round whose local deposits are all in: hand every local task
        its handle and move the team's rounds on."""
        self.next_round += 1
        rd = Round(self.next_round, tag, slot)
        self.last_round[tag] = rd.r
        self.rounds.append(rd)
        if self.failed is not None:
            rd.error = self.failed
        handle = RoundHandle(self, rd)
        for _tr, (_s, _d, _r, task) in slot.items():
            task.set_result(handle)
        self.progress()
        return rd

    def _publish(self, rd: Round) -> None:
        a = self.area
        if self.cuda:
            stream = self.shared.stream
            with torch.cuda.device(self.device), torch.cuda.stream(stream):
                for _tr, (_s, _d, ready, _t) in rd.slot.items():
                    if ready is not None:
                        stream.wait_event(ready)
                self._stage_round(rd)
                self.events[0][rd.k].record(stream)
        else:
            self._stage_round(rd)
        blob = self._descriptor(rd)
        if self.sent.get(rd.tag) == blob:
            self.sent.move_to_end(rd.tag)
            length = 0
        else:
            if len(blob) > self.slot_cap:
                raise UccError(Status.ERR_NO_RESOURCE,
                               f"descriptor of {len(blob)} bytes exceeds "
                               f"the sync slot's {self.slot_cap}")
            self.sent[rd.tag] = blob
            self.sent.move_to_end(rd.tag)
            while len(self.sent) > _SENT_MAX:
                self.sent.popitem(last=False)
            length = len(blob)
            a.write(a.slot_off(self.me, rd.k) + _SLOT_HEAD, blob)
            metrics.count_span("dev_desc_sends")
        off = a.slot_off(self.me, rd.k)
        a.store(off + _WORD, _tag_word(rd.tag))
        a.store(off + 2 * _WORD, length)
        a.store(off, rd.r)
        rd.state = "published"

    def _peer_parts(self, rd: Round):
        """Every peer's descriptor of this round."""
        a = self.area
        parts = {}
        for q in range(self.P):
            if q == self.me:
                continue
            off = a.slot_off(q, rd.k)
            if a.load(off + _WORD) != _tag_word(rd.tag):
                raise UccError(Status.ERR_INVALID_PARAM,
                               f"process {q} posted another collective in "
                               f"round {rd.r} (collectives must be posted "
                               "in one order on every rank)")
            length = a.load(off + 2 * _WORD)
            key = (q, rd.tag)
            if length:
                desc = pickle.loads(a.read(off + _SLOT_HEAD, length))
                self.peer_desc[key] = desc
            else:
                desc = self.peer_desc.get(key)
                if desc is None:
                    raise UccError(Status.ERR_NO_MESSAGE,
                                   f"process {q} sent no descriptor for "
                                   f"tag {rd.tag}")
            self.peer_desc.move_to_end(key)
            while len(self.peer_desc) > _PEER_DESC_MAX:
                self.peer_desc.popitem(last=False)
            parts[q] = desc
        return parts

    def _launch(self, rd: Round) -> None:
        proto = rd.proto
        n = self.n
        srcs: List[Any] = [None] * n
        dsts: List[Any] = [None] * n
        tasks: List[Any] = [None] * n
        dtype = proto.dtype if proto.dtype is not None else torch.uint8
        for tr, (_s, dst, _r, task) in rd.slot.items():
            if self.cuda:
                srcs[tr], dsts[tr] = rd.srcs[tr], rd.dsts[tr]
            else:
                srcs[tr], dsts[tr] = rd.srcs[tr][0], rd.dsts[tr][0]
            tasks[tr] = task
        for q, desc in self._peer_parts(rd).items():
            for tr, sd, sn, dd, dn, meta in desc:
                srcs[tr] = self._peer_tensor(q, sd, sn, dtype)
                if proto.PEERS_WRITE:
                    dsts[tr] = self._peer_tensor(q, dd, dn, dtype)
                tasks[tr] = _Peer(meta)
        part = (self.me, self.P)
        if self.cuda:
            stream = self.shared.stream
            with torch.cuda.device(self.device), torch.cuda.stream(stream):
                for q in range(self.P):
                    if q != self.me:
                        stream.wait_event(self.peer_events[(q, 0, rd.k)])
                launch = proto.launch(self.shared, tuple(srcs), tuple(dsts),
                                      tuple(tasks), part=part)
                self.events[1][rd.k].record(stream)
            rd.keep = (launch, srcs, dsts)
        else:
            proto.launch(self.shared, tuple(srcs), tuple(dsts),
                         tuple(tasks), part=part)
        self.area.store(self.area.done_off(self.me), rd.r)
        rd.state = "launched"
        metrics.count_span("dev_span_rounds")

    def _peer_tensor(self, q, desc, numel, dtype):
        """A peer's buffer, kept across rounds by its descriptor (so a
        persistent round opens nothing and keeps its pointer table)."""
        if desc is None:
            return None
        key = (q, desc, numel, dtype)
        t = self.peer_tensors.get(key)
        if t is None:
            t = self._open(q, desc, dtype)
            t = self.peer_tensors[key] = t[:numel] if numel is not None \
                else t
        self.peer_tensors.move_to_end(key)
        while len(self.peer_tensors) > _PEER_DESC_MAX:
            self.peer_tensors.popitem(last=False)
        return t

    def _complete(self, rd: Round) -> bool:
        a = self.area
        for q in range(self.P):
            if a.load(a.done_off(q)) < rd.r:
                return False
        if self.cuda:
            for q in range(self.P):
                ev = self.events[1][rd.k] if q == self.me else \
                    self.peer_events[(q, 1, rd.k)]
                if not ev.query():
                    return False
        for view, dst in rd.staged:
            dst.copy_(view)
        rd.state = "done"
        rd.keep = ()
        return True

    def _fail(self, err: UccError) -> None:
        self.failed = err
        logger.error("spanning device team %s failed: %s", self.name, err)
        for rd in self.rounds:
            if rd.state != "done" and rd.error is None:
                rd.error = err
        self.rounds.clear()

    def progress(self) -> None:
        """Complete, publish and launch what can be, in round order."""
        if self.failed is not None:
            for rd in self.rounds:
                rd.error = rd.error or self.failed
            self.rounds.clear()
            return
        try:
            while self.rounds and self.rounds[0].state == "launched" and \
                    self._complete(self.rounds[0]):
                self.rounds.popleft()
            for rd in self.rounds:
                if rd.state == "queued":
                    if rd.r > SLOTS and self._min_done() < rd.r - SLOTS:
                        break
                    self._publish(rd)
            a = self.area
            for rd in self.rounds:
                if rd.state == "launched":
                    continue
                if rd.state != "published":
                    break
                if any(a.load(a.slot_off(q, rd.k)) < rd.r
                       for q in range(self.P) if q != self.me):
                    break
                self._launch(rd)
            # a launched round may already be complete (the CPU stand-in)
            while self.rounds and self.rounds[0].state == "launched" and \
                    self._complete(self.rounds[0]):
                self.rounds.popleft()
            if self.rounds:
                self._check_stall(self.rounds[0])
        except UccError as e:
            self._fail(e)
        except Exception as e:  # noqa: BLE001 - a failed open or launch
            logger.exception("spanning round failed")
            self._fail(UccError(Status.ERR_NO_MESSAGE,
                                f"spanning device round failed: {e}"))

    def _check_stall(self, rd: Round) -> None:
        now = time.monotonic()
        waited = now - rd.t0
        if waited < min(1.0, self.timeout) or \
                now - self._last_check < _CHECK_PERIOD:
            return
        self._last_check = now
        for q, pid in enumerate(self._pids):
            if q != self.me and pid and not _pid_alive(pid):
                raise UccError(Status.ERR_TIMED_OUT,
                               f"process {q} of the team (pid {pid}) "
                               f"exited during round {rd.r}")
        if waited > self.timeout:
            raise UccError(Status.ERR_TIMED_OUT,
                           f"round {rd.r} of spanning device team "
                           f"{self.name}: a peer process did not take part "
                           f"within {self.timeout} s")

    # -- lifecycle ------------------------------------------------------
    def retire(self, tag) -> None:
        """Every local rank finalized *tag*'s requests: its cached
        descriptor and staging go."""
        self.sent.pop(tag, None)
        last = self.last_round.pop(tag, 0)
        for key in [k for k in self.dev_stage if k[0] == tag]:
            del self.dev_stage[key]
        if self.stage is not None:
            self.stage.retire(tag, last)

    def destroy(self) -> None:
        self.peer_tensors.clear()
        if self.cuda:
            from ..kernels import cuda_ipc
            try:
                cuda_ipc.release(self.held)
            except UccError:
                logger.exception("closing CUDA IPC mappings failed")
        self.peer_events.clear()
        self.peer_tensors.clear()
        self.dev_stage.clear()
        if self.stage is not None:
            self.stage.close()
        area = self.area
        if area is not None:
            creator = area.creator_pid()
            dead = [p for q, p in enumerate(self._pids)
                    if q != self.me and p and not _pid_alive(p)]
            if area.created or not _pid_alive(creator) or dead:
                # the creator's job, or a survivor's when it is gone; a
                # dead peer's staging files too
                for path in [self.path] + (glob.glob(self.path + "-d*")
                                           if dead else []):
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
            area.close()
            self.area = None


def _tag_word(tag) -> int:
    return hash(tag) & ((1 << 63) - 1) if not isinstance(tag, int) \
        else int(tag) & ((1 << 63) - 1)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors' bytes overlap."""
    if a.numel() == 0 or b.numel() == 0:
        return False
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and \
        b0 < a0 + a.numel() * a.element_size()
