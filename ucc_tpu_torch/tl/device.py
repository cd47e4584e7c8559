"""Device TL plumbing: the rendezvous that turns the per-rank posts of a
team into kernel launches over all of its ranks' buffers.

This is the rendezvous half of the JAX package's ``tl/xla.py``. Every team
rank is a UCC context; the ranks of one process share a
``DeviceTeamShared``. ``post()`` deposits the rank's buffers; the last
local rank to deposit launches the round's program on the team's own CUDA
stream, so launches are ordered by the rendezvous and not by which thread
happened to deposit last.

Ranks of a team live on ONE device, each with its own buffers there. The
device is ``DEVICE_CONFIG``'s ``DEVICE`` (``UCC_TL_RING_CUDA_DEVICE``,
default ``cuda``, meaning cuda:0), one setting that every device TL's
context reads, since the ranks of a team hand every TL the same tensors; a
context that asks for CUDA on a machine without one raises. On ``cpu`` the
programs run the kernels' plain versions. Contexts compare their devices
by the card's UUID (``cuda:0`` names different cards under different
``CUDA_VISIBLE_DEVICES``) and their processes by the context address
table's ``(hostname, pid)``.

The ranks may live in several processes of one host (``team_layout``,
the counterpart of the JAX package's ``n_local`` gates): processes are
numbered in the order of their lowest team rank, and a team of one process
launches one program over every rank's buffers, as before. A team that
spans P processes runs its rounds through ``tl/device_sync.py``: each
process launches part p of P of the round over all n ranks' buffers (its
own and its peers', reached through CUDA IPC), ordered by interprocess
CUDA events and a per-team sync area. Teams whose ranks are on several
hosts, or on several cards, are ERR_NOT_SUPPORTED (their host TLs serve
them), and so are spanning teams under
``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``.

Buffer convention: tensors are mutable, so a device collective writes its
result INTO the caller's ``dst`` tensor, as UCC does in C. (The JAX
package rebinds ``dst.buffer`` instead, because jax arrays are
immutable.) A collective completes when its launch has finished on the
device (on a spanning team: every process's part): ``test()`` polls the
launch's CUDA event, so a caller may read ``dst`` on any stream once it
returns OK.

No TL is registered from this module; tl/ring_cuda and tl/torch_ops build
on it. A rank's src or dst may be None (a rooted collective's non-root
ranks, the buffer-less barrier): the launch gets None there.
"""
from __future__ import annotations

import pickle
import threading
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from ..api.types import BufferInfoV
from ..constants import (ROOTED_COLLS, CollType, MemoryType, ReductionOp,
                         coll_type_str, dt_torch)
from ..core.components import BaseContext
from ..kernels.ring_common import RingWorkspace, make_ptr_table
from ..schedule.task import CollTask
from ..status import Status, UccError
from ..utils.config import (ConfigField, ConfigTable, parse_string,
                            register_table)
from ..utils.ep_map import EpMap
from ..utils.log import get_logger
from .base import TlTeamBase

logger = get_logger("tl_device")

#: the context config of every device TL (tl/ring_cuda, tl/torch_ops): one
#: DEVICE, named after the first of them
DEVICE_CONFIG = register_table(ConfigTable(
    prefix="TL_RING_CUDA_", name="tl/device", fields=[
        ConfigField("DEVICE", "cuda", "device the ranks' buffers live on, "
                    "for every device TL: cuda[:i] (raises at context "
                    "creation when there is no GPU) or cpu (runs the "
                    "kernels' plain versions)", parse_string),
    ]))


def resolve_device(spec: str) -> torch.device:
    """The device a context config names; raises ERR_NO_RESOURCE when it
    names CUDA and there is none. A bare ``cuda`` means cuda:0."""
    try:
        dev = torch.device(spec or "cuda")
    except RuntimeError as e:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"bad device '{spec}': {e}") from None
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise UccError(Status.ERR_NO_RESOURCE,
                           "device 'cuda' was asked for but torch finds no "
                           "CUDA device; set the TL's DEVICE to 'cpu' to run "
                           "the plain versions on the CPU")
        dev = torch.device("cuda", 0 if dev.index is None else dev.index)
        if dev.index >= torch.cuda.device_count():
            raise UccError(Status.ERR_NO_RESOURCE,
                           f"device {dev} does not exist "
                           f"({torch.cuda.device_count()} CUDA devices)")
    elif dev.type != "cpu":
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"device '{spec}': expected cuda[:i] or cpu")
    return dev


# ---------------------------------------------------------------------------
# context: device claim
# ---------------------------------------------------------------------------

def device_uuid(dev: torch.device) -> str:
    """The card's UUID (``cpu`` for the CPU): what two contexts compare to
    know they share a device."""
    if dev.type != "cuda":
        return "cpu"
    return str(torch.cuda.get_device_properties(dev.index).uuid)


class TlDeviceContext(BaseContext):
    def __init__(self, comp_lib, core_context, config):
        super().__init__(comp_lib, core_context, config)
        self.device = resolve_device(config.device if config else "cuda")
        #: ctx rank -> (device string, card UUID, context uid) of the peer
        self.peer_devices: Dict[int, tuple] = {
            core_context.rank: self.address()}

    def address(self) -> tuple:
        return (str(self.device), device_uuid(self.device),
                self.core_context._ctx_uid)

    def pack_address(self) -> bytes:
        return pickle.dumps(self.address())

    def unpack_addresses(self, addrs: Dict[int, bytes]) -> None:
        for rank, blob in addrs.items():
            if blob:
                self.peer_devices[rank] = tuple(pickle.loads(blob))


class Layout(NamedTuple):
    """Where a team's ranks live: ``procs[p]`` lists the team ranks of
    process p (processes in the order of their lowest team rank), ``me``
    is this process's index."""
    procs: List[List[int]]
    me: int


def team_layout(size: int, ctx_of, proc_of, device_of, my_proc,
                my_device, what: str = "device") -> Layout:
    """The layout of a team of *size* ranks: ``ctx_of(gr)`` is team rank
    gr's context rank, ``proc_of(cr)`` that context's ``(hostname, pid)``
    and ``device_of(cr)`` its ``(device string, card UUID, ...)``. Raises
    ERR_NOT_SUPPORTED for a rank on another host or another card."""
    procs: Dict[tuple, List[int]] = {}
    for gr in range(size):
        cr = ctx_of(gr)
        proc = tuple(proc_of(cr))
        if proc[0] != my_proc[0]:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/{what}: team rank {gr} is on host "
                           f"{proc[0]}, not {my_proc[0]} (device teams "
                           "across hosts are not ported)")
        dev = device_of(cr)
        if dev is None or dev[1] != my_device[1]:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/{what}: team rank {gr} is on "
                           f"{dev[0] if dev else None} (card "
                           f"{dev[1] if dev else None}), not {my_device[0]} "
                           f"(card {my_device[1]})")
        procs.setdefault(proc, []).append(gr)
    order = sorted(procs.values(), key=min)
    me = [i for i, ranks in enumerate(order)
          if tuple(proc_of(ctx_of(ranks[0]))) == tuple(my_proc)]
    if not me:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"tl/{what}: this process holds no rank of the team")
    return Layout(order, me[0])


# ---------------------------------------------------------------------------
# shared per-team state (process-global rendezvous)
# ---------------------------------------------------------------------------

_SHARED: Dict[Any, "DeviceTeamShared"] = {}
_SHARED_LOCK = threading.Lock()

#: per-team bound on launch_cache entries (oldest evicted first), the
#: default of the JAX package's UCC_TL_XLA_LAUNCH_CACHE_MAX
LAUNCH_CACHE_MAX = 64


class DeviceTeamShared:
    def __init__(self, key, device: torch.device, n: int,
                 layout: "Layout" = None, span_name: str = ""):
        self.key = key
        self.device = device
        self.devices = [device] * n     # team rank -> device
        self.layout = layout or Layout([list(range(n))], 0)
        self.n_local = len(self.layout.procs[self.layout.me])
        self.lock = threading.Lock()
        #: the rounds of a team that spans processes (tl/device_sync)
        self.span = None
        #: local ranks that finalized each tag (a spanning team retires a
        #: tag when all of them have)
        self.finalized: Dict[int, int] = {}
        #: tag -> {team_rank: (src, dst, ready_event, task)}
        self.pending: Dict[int, Dict[int, Tuple]] = {}
        #: persistent-collective launch cache: tag -> (pointers, table),
        #: the kernel's device pointer table of an unchanged buffer set
        self.launch_cache: Dict[int, Tuple[tuple, Any]] = {}
        #: launch callables bound to their plan tables, by the task's key
        #: (the generated device collectives' lowered programs); dropped
        #: at team destroy
        self.programs: Dict[Any, Any] = {}
        self.refcount = 0
        #: the one stream every launch of this team goes onto
        self.stream = None
        #: scratch of the team's launches (comm slots, flags), reused
        self.workspace = None
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
            self.workspace = RingWorkspace(device)
        if len(self.layout.procs) > 1:
            from .device_sync import SpanTeam
            self.span = SpanTeam(self, self.layout, span_name)

    @classmethod
    def get_or_create(cls, key, make) -> "DeviceTeamShared":
        with _SHARED_LOCK:
            shared = _SHARED.get(key)
            if shared is None:
                shared = _SHARED[key] = make()
            shared.refcount += 1
            return shared

    def put(self) -> None:
        with _SHARED_LOCK:
            self.refcount -= 1
            if self.refcount <= 0:
                _SHARED.pop(self.key, None)
                self.launch_cache.clear()
                self.programs.clear()
                self.pending.clear()
                self.workspace = None
                if self.span is not None:
                    with self.lock:
                        self.span.destroy()

    def retire(self, tag) -> None:
        """A local rank finalized *tag*'s request; a spanning team lets
        the tag's descriptor and staging go once every local rank has."""
        with self.lock:
            self.launch_cache.pop(tag, None)
            if self.span is None:
                return
            done = self.finalized.get(tag, 0) + 1
            if done < self.n_local:
                self.finalized[tag] = done
                return
            self.finalized.pop(tag, None)
            self.span.retire(tag)

    def _cache_insert(self, key, value) -> None:
        """Bounded insert: evict the oldest entries beyond
        LAUNCH_CACHE_MAX. Replacing an existing key must not evict an
        unrelated entry."""
        cache = self.launch_cache
        if key not in cache:
            while len(cache) >= LAUNCH_CACHE_MAX:
                cache.pop(next(iter(cache)))
        cache[key] = value

    # ------------------------------------------------------------------
    def deposit(self, tag, team_rank: int, src, dst, ready,
                task: "DeviceCollTask") -> None:
        with self.lock:
            slot = self.pending.setdefault(tag, {})
            slot[team_rank] = (src, dst, ready, task)
            if len(slot) == self.n_local:
                del self.pending[tag]
                # launched under the lock: every rank posts in program
                # order, so slots fill in program order, and launches reach
                # the stream (and the shared workspace) in that order
                # whichever thread deposits last; a spanning team's rounds
                # are numbered in that order in every process
                if self.span is not None:
                    self.span.start(tag, slot)
                else:
                    self._launch(slot)

    def _launch(self, slot) -> None:
        items = sorted(slot.items())
        try:
            # deterministic proto: the lowest team rank's task (the program
            # must not depend on deposit order)
            proto = items[0][1][3]
            srcs = tuple(it[1][0] for it in items)
            dsts = tuple(it[1][1] for it in items)
            for _, (_s, _d, ready, _t) in items:
                if ready is not None:
                    self.stream.wait_event(ready)
            launch = proto.launch(self, srcs, dsts,
                                  tuple(it[1][3] for it in items))
            for _, (_s, _d, _r, task) in items:
                task.set_result(launch)
        except Exception:  # noqa: BLE001 - build/launch failure
            logger.exception("device collective launch failed")
            for _, (_s, _d, _r, task) in items:
                task.fail(Status.ERR_NO_MESSAGE)


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------

class DeviceCollTask(CollTask):
    """One rank's view of a device collective. Subclasses provide
    ``validate()`` and ``build_program(shared)``, which returns the kernel
    wrapper to launch: ``kernel(srcs, dsts, op, *, root, stream,
    workspace, ptr_table, part)`` returning a launch handle with
    ``done()``; or they replace ``launch`` and the buffer conventions as a
    whole. ``PEERS_WRITE``: on a team that spans processes, a process's
    launch writes other processes' dsts (the kernels' parts), so the
    round's descriptors carry the dsts too; a program that writes only its
    own process's dsts sets it False. ``peers_read_src`` says which srcs
    another process reads after this one may have begun to write its
    dsts: an src inside a local dst is then read from a copy."""

    PEERS_WRITE = True

    def peers_read_src(self, tr: int, local) -> bool:
        """Whether, on a spanning team, another process than the one of
        ``local`` (its team ranks) reads team rank tr's src while this one
        writes its dsts. The kernels' parts write an element only in the
        thread that reads everything it depends on (a fold, a copy, a
        swap of two blocks), as one launch over all ranks does: none."""
        return False

    def __init__(self, init_args, team: "TlDeviceTeam"):
        super().__init__(team=team, args=init_args.args)
        self.init_args = init_args
        self.tl_team = team
        self._launch = None
        self._fast_round = False   # set per-round by fast_repost
        self._ready = None         # CUDA event: this rank's inputs ready
        args = init_args.args
        if args.active_set is not None:
            # only the subset posts an active-set coll; the full-team
            # rendezvous would wait for deposits that never come
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "device TLs do not run active-set collectives")
        self.coll = args.coll_type
        self.op = args.op if args.op is not None else ReductionOp.SUM
        self.root = int(args.root) if self.coll & ROOTED_COLLS else 0
        if not 0 <= self.root < team.size:
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"root {self.root} is not a rank of a team of "
                           f"{team.size}")
        self.check_buffer_infos()
        bi = args.src if args.src is not None else args.dst
        self.dtype = None                  # collectives without buffers
        if bi is not None:
            try:
                self.dtype = dt_torch(bi.datatype)
            except (TypeError, ValueError, KeyError):
                raise UccError(Status.ERR_NOT_SUPPORTED,
                               f"no torch dtype for {bi.datatype}") from None
        self._contrib_src = args.src is not None and not args.is_inplace
        self.validate()
        self.src_count, self.dst_count = self._buffer_counts()
        self.local_buffers()       # reject bad buffers here, not mid-rendezvous
        # tag allocation LAST: a validation error above must not consume a
        # team tag, or this rank's tag sequence desyncs from its peers
        self.tag = team.next_coll_tag()

    def check_buffer_infos(self) -> None:
        """A contiguous BufferInfo as src or dst (the kernels' rule)."""
        args = self.args
        bi = args.src if args.src is not None else args.dst
        if bi is None or isinstance(bi, BufferInfoV) or (
                args.dst is not None and isinstance(args.dst, BufferInfoV)):
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "device TLs take contiguous BufferInfo buffers")

    def validate(self) -> None:
        """The TL's own NOT_SUPPORTED rules, run before the tag is taken."""

    # -- buffers -----------------------------------------------------------
    def _buffer_counts(self) -> Tuple[int, int]:
        """(src, dst) elements per rank, by UCC's count conventions:
        allgather takes c and gives n·c (src.count c, dst.count n·c);
        reduce_scatter takes n·c and gives c (src.count n·c, dst.count c);
        in place, dst.count is n·c for both. alltoall takes and gives n
        blocks (src.count = dst.count). Blocks are equal: a reduce_scatter
        or alltoall total not divisible by n is NOT_SUPPORTED. bcast
        takes src.count, and src alone when there is no dst."""
        args = self.args
        n = self.tl_team.size
        if self.coll == CollType.BCAST:
            bi = args.src if args.src is not None else args.dst
            return int(bi.count), int(bi.count)
        if self.coll not in (CollType.ALLGATHER, CollType.REDUCE_SCATTER,
                             CollType.ALLTOALL):
            bi = args.src if self._contrib_src else args.dst
            return int(bi.count), int(bi.count)
        if args.dst is None:
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"{coll_type_str(self.coll)} needs a dst buffer")
        total = int(args.dst.count)          # in place: n·c for both
        if self._contrib_src:
            total = int(args.src.count)
            if self.coll == CollType.ALLGATHER:
                total *= n
        if total % n:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/{self.tl_team.NAME} "
                           f"{coll_type_str(self.coll)} requires count % "
                           f"team_size == 0 (count {total}, team size {n})")
        c = total // n
        counts = {CollType.ALLGATHER: (c, total),
                  CollType.REDUCE_SCATTER: (total, c)}.get(self.coll,
                                                           (total, total))
        if self._contrib_src:
            given = (int(args.src.count), int(args.dst.count))
            if given != counts:
                raise UccError(Status.ERR_INVALID_PARAM,
                               f"{coll_type_str(self.coll)} of {n} ranks "
                               f"takes src/dst counts {counts}, got {given}")
        return counts

    def _flat(self, bi, count: int) -> torch.Tensor:
        buf = None if bi is None else bi.buffer
        dev = self.tl_team.shared.device
        if not isinstance(buf, torch.Tensor):
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"device collectives take torch tensors, got "
                           f"{type(buf).__name__}")
        if buf.device != dev or buf.dtype != self.dtype or \
                not buf.is_contiguous() or buf.numel() < count:
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"buffer must be a contiguous {self.dtype} tensor "
                           f"of >= {count} elements on {dev} (got "
                           f"{buf.dtype} {tuple(buf.shape)} on {buf.device})")
        return buf.reshape(-1)[:count]

    def local_buffers(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's (src, dst) for the kernel wrappers. bcast's dst is
        args.dst when given, else its src (as the JAX package has it): the
        root's buffer is then its result. In place (the conventions of the
        host ring, tl/host/ring.py): allgather reads its own block from
        dst[me·c:(me+1)·c]; reduce_scatter reads the whole n·c vector from
        dst and writes its result to that block, leaving the other blocks
        as they were; alltoall's src is its dst."""
        args = self.args
        if self.coll == CollType.BCAST:
            src = args.src if args.src is not None else args.dst
            dst = args.dst if args.dst is not None else args.src
            return (self._flat(src, self.src_count),
                    self._flat(dst, self.dst_count))
        if self._contrib_src:
            return (self._flat(args.src, self.src_count),
                    self._flat(args.dst, self.dst_count))
        full = self._flat(args.dst, max(self.src_count, self.dst_count))
        if self.src_count == self.dst_count:
            return full, full
        c = min(self.src_count, self.dst_count)
        me = self.tl_team.rank
        own = full[me * c:(me + 1) * c]
        return (own, full) if self.coll == CollType.ALLGATHER else (full, own)

    def _deposit(self) -> None:
        src, dst = self.local_buffers()
        ready = None
        device = self.tl_team.shared.device
        if device.type == "cuda":
            # the launch stream waits for this rank's writes, made on the
            # posting thread's current stream
            if self._ready is None:
                self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(device))
            ready = self._ready
        self.tl_team.shared.deposit(self.tag, self.tl_team.rank, src, dst,
                                    ready, self)

    def launch(self, shared: DeviceTeamShared, srcs, dsts, tasks,
               part=None):
        """The one launch over every rank's buffers (*tasks*: every rank's
        task, in rank order; on a spanning team a peer rank's is its
        block and layout alone), on the launching thread under the
        rendezvous lock; returns the launch handle. *part* ``(p, P)``:
        this process's part of a spanning team's round."""
        table = None
        if self.args.is_persistent and shared.stream is not None:
            ptrs = tuple(t.data_ptr() for t in srcs + dsts)
            cached = shared.launch_cache.get(self.tag)
            if cached is not None and cached[0] == ptrs:
                # persistent re-post on unchanged buffers: reuse the
                # device pointer table (LRU refresh keeps hot tags alive
                # under the LAUNCH_CACHE_MAX bound)
                table = cached[1]
                shared.launch_cache[self.tag] = \
                    shared.launch_cache.pop(self.tag)
            else:
                table = make_ptr_table(srcs, dsts)
                shared._cache_insert(self.tag, (ptrs, table))
        kernel = self.build_program(shared)
        kw = {} if part is None else {"part": part}
        return kernel(srcs, dsts, self.op, root=self.root,
                      stream=shared.stream, workspace=shared.workspace,
                      ptr_table=table, **kw)

    # -- lifecycle --------------------------------------------------------
    def post_fn(self) -> Status:
        self._launch = None
        self._deposit()
        return Status.OK

    def set_result(self, launch) -> None:
        """Called on the launching thread for every rank's task."""
        self._launch = launch

    def fail(self, status: Status) -> None:
        self.status = status
        if self._fast_round:
            # fast-posted tasks have no progress pass to surface the error
            self._fast_round = False
            self.super_status = status

    def progress_fn(self) -> None:
        if self.status != Status.IN_PROGRESS or self._launch is None:
            return
        try:
            if self._launch.done():
                self.status = Status.OK
        except UccError as e:
            logger.error("device collective failed: %s", e)
            self.status = e.status

    # -- persistent fast re-post lane -------------------------------------
    # A persistent device collective with no observers needs none of the
    # generic post machinery: re-post is "deposit my (unchanged) buffers
    # again", and completion is the launch's event, which the owner polls
    # from CollRequest.test via fast_test.
    def fast_repost_ok(self) -> bool:
        bi = self.args.src if self._contrib_src else self.args.dst
        return bi is not None and bi.mem_type == MemoryType.CUDA

    def fast_repost(self) -> Status:
        self._launch = None
        self._fast_round = True
        self.status = Status.IN_PROGRESS
        self.super_status = Status.IN_PROGRESS
        self._deposit()
        return Status.OK

    def fast_test(self) -> Status:
        if self._fast_round:
            self.progress_fn()
            if self.status != Status.IN_PROGRESS:
                self._fast_round = False
                self.super_status = self.status
        return self.super_status

    def reset(self) -> None:
        super().reset()
        self._launch = None

    def finalize_fn(self) -> Status:
        self.tl_team.shared.retire(self.tag)
        return Status.OK


# ---------------------------------------------------------------------------
# team
# ---------------------------------------------------------------------------

class TlDeviceTeam(TlTeamBase):
    """Team of a device TL: its ranks on one device, in one process or in
    several of one host (``team_layout``)."""

    NAME = "device"

    def __init__(self, comp_context: TlDeviceContext, core_team,
                 scope="cl"):
        super().__init__(comp_context, core_team, scope)
        ctx = comp_context
        ctx_map = core_team.ctx_map or EpMap.full(core_team.size)
        core = core_team.context
        mine = ctx.address()
        layout = team_layout(
            self.size, ctx_map.eval,
            lambda cr: core.addr_storage[cr]["proc"]
            if cr < len(core.addr_storage) else core.proc,
            ctx.peer_devices.get, core.proc, mine, self.NAME)
        name = ""
        if len(layout.procs) > 1:
            self.check_spanning(ctx)
            first = ctx.peer_devices.get(ctx_map.eval(0)) or mine
            from .device_sync import sync_name
            name = sync_name(core_team.team_key, scope, self.NAME, first[2])
        self._coll_tag = 0
        key = (core_team.team_key, scope, self.NAME)
        self.shared = DeviceTeamShared.get_or_create(
            key, lambda: DeviceTeamShared(key, ctx.device, self.size,
                                          layout, name))

    @property
    def spanning(self) -> bool:
        """Whether the team's ranks live in more than one process."""
        return self.shared.span is not None

    def check_spanning(self, ctx: TlDeviceContext) -> None:
        """The refusals of a team that spans processes: a CUDA allocator
        whose allocations IPC cannot export, and no native core (the sync
        area's words)."""
        if ctx.device.type == "cuda":
            from ..kernels import cuda_ipc
            cuda_ipc.check_allocator()
        from .device_sync import _atomics
        _atomics()

    def create_test(self) -> Status:
        span = self.shared.span
        if span is None:
            return Status.OK
        with self.shared.lock:
            return span.create_step()

    def next_coll_tag(self) -> int:
        self._coll_tag += 1
        return self._coll_tag

    def destroy(self) -> None:
        self.shared.put()
