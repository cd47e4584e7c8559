"""One-sided (put/get) collectives over the host transports (the port of
the JAX package's ``tl/host/onesided.py``).

``Context.mem_map`` registers a HOST buffer in the process's segment
registry (``REGISTRY``) under (context uid, segment id): the memh/rkey
analog. A put or get addresses a segment by that pair:

- tl/shm, and any target in this process, applies it directly under the
  registry lock;
- tl/sockets sends it as a frame, which the target's reader thread
  applies (the target's user thread never takes part); a flush frame,
  acked by the target, is the remote-completion fence and reports the
  operations it rejected since the last flush;
- delivery is notified through atomic arrival counters.

The algorithms: ``AlltoallOnesided`` (put or get variant),
``AlltoallvOnesided`` (the SHMEM target-relative displacement convention
with explicit handles), and ``AllreduceSlidingWindow`` (reduce-scatter
and allgather as windowed gets and puts). Each takes global handles
(``src_memh``/``dst_memh``, one per team rank) or, without them, maps
its own buffers and exchanges the handles over the team first.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ...constants import ReductionOp, dt_size
from ...ec.cpu import reduce_arrays, storage_dtype
from ...status import Status, UccError
from ...utils.mathutils import block_count, block_offset, div_round_up
from ..base import _host_u8, binfo_typed
from .task import HostCollTask
from .transport import RecvReq

# frame-op sentinels (first element of a socket frame key; TagKeys always
# start with a team_key tuple, so plain strings cannot collide)
OS_PUT = "__os_put__"
OS_GET = "__os_get__"
OS_CTR = "__os_ctr__"
OS_FLUSH = "__os_flush__"
OS_OPS = frozenset((OS_PUT, OS_GET, OS_CTR, OS_FLUSH))

def sw_knobs(cfg, msg_bytes: int):
    """Resolve the sliding-window (window_bytes, inflight) knobs.

    ``auto`` is the JAX package's formula: the window is msg/64 clamped
    to [256K, 1M] and 4 gets are in flight (UCC's num_buffers/window
    knobs).

    ``Config.get`` returns PARSED values: ``parse_memunits``/
    ``parse_uint_auto`` map the string "auto" to the ``SIZE_AUTO``
    sentinel (and "inf" to ``SIZE_INF``/``UINT_MAX``), so detection
    compares against the sentinels, never the raw string. ``inf`` has
    no literal meaning for a scratch-buffer knob: both sentinels fall
    back to auto rather than sizing an allocation from 2^64."""
    from ...utils.config import SIZE_AUTO, SIZE_INF, UINT_MAX

    w = i = SIZE_AUTO
    if cfg is not None:
        try:
            w = int(cfg.get("allreduce_sw_window"))
        except KeyError:
            pass
        try:
            i = int(cfg.get("allreduce_sw_inflight"))
        except KeyError:
            pass
    if w in (SIZE_AUTO, SIZE_INF):
        window = max(SW_AUTO_MIN_WINDOW,
                     min(SW_AUTO_MAX_WINDOW,
                         int(msg_bytes) // SW_AUTO_WINDOW_DIVISOR))
    else:
        window = w
    if i in (SIZE_AUTO, UINT_MAX):
        inflight = SW_AUTO_INFLIGHT
    else:
        inflight = i
    return window, max(1, inflight)


#: the auto formula: window msg/64 clamped to [256K, 1M], 4 in flight
SW_AUTO_MIN_WINDOW = 256 << 10
SW_AUTO_MAX_WINDOW = 1 << 20
SW_AUTO_WINDOW_DIVISOR = 64
SW_AUTO_INFLIGHT = 4


def sw_max_work_buffer(cfg) -> int:
    """Upper bound on sliding-window scratch for a context attr query
    (ucc_context_get_attr GLOBAL_WORK_BUFFER — the reference sizes it as
    num_buffers x buffer segments before any collective is posted,
    ucc_context.c get_attr path). Resolves explicit window/inflight from
    ``cfg``; auto values take the auto-formula maxima 1M x 4 (probed with
    a message large enough to hit the window ceiling)."""
    window, inflight = sw_knobs(cfg,
                                SW_AUTO_MAX_WINDOW * SW_AUTO_WINDOW_DIVISOR)
    return int(window) * int(inflight)


class _Registry:
    """Process-global exported-segment + atomic-counter store.

    One per process (like the reference's per-context memh storage,
    ucc_context.c:1250-1559 — process-global here because in-process
    "ranks" are contexts inside one process and must reach each other's
    segments without a copy)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.segments: Dict[Tuple[str, int], np.ndarray] = {}
        self.counters: Dict[Any, int] = {}
        #: notify-key -> error strings: a REJECTED put with a notify still
        #: bumps the counter but poisons it, so the waiting target
        #: completes with an error instead of hanging on a count that can
        #: never arrive (the error-propagation role of the reference's
        #: schedule ERROR events, ucc_schedule.h:258)
        self.counter_errors: Dict[Any, List[str]] = {}

    # -- segments ------------------------------------------------------
    def register(self, ctx_uid: str, seg_id: int, buffer) -> int:
        """Register a host buffer for remote access; returns nbytes.
        Read-only buffers (bytes) register GET-only — a PUT into them
        fails at apply time, like an rkey without remote-write access."""
        contiguous = buffer.flags["C_CONTIGUOUS"] \
            if isinstance(buffer, np.ndarray) else \
            getattr(buffer, "is_contiguous", lambda: True)()
        if not contiguous:
            raise UccError(Status.ERR_INVALID_PARAM,
                           "mem_map buffer must be C-contiguous")
        # numpy arrays and CPU tensors as writable views; bytes register
        # get-only (read-only view)
        flat = _host_u8(buffer)
        with self.lock:
            self.segments[(ctx_uid, seg_id)] = flat
        return int(flat.nbytes)

    def unregister(self, ctx_uid: str, seg_id: int) -> None:
        with self.lock:
            self.segments.pop((ctx_uid, seg_id), None)

    def unregister_ctx(self, ctx_uid: str) -> None:
        with self.lock:
            for k in [k for k in self.segments if k[0] == ctx_uid]:
                del self.segments[k]

    # -- data ops (applied by the passive side) ------------------------
    def apply_put(self, ctx_uid: str, seg_id: int, offset: int,
                  data: np.ndarray, notify: Any = None) -> Optional[str]:
        """Write ``data`` into the segment at byte ``offset``; bump the
        ``notify`` counter on success, bump-and-POISON it on rejection
        (see counter_errors). Returns an error string instead of raising
        (the socket reader must not die on a bad frame)."""
        with self.lock:
            seg = self.segments.get((ctx_uid, seg_id))
            err = None
            if seg is None:
                err = f"put to unknown segment ({ctx_uid[:8]}…,{seg_id})"
            elif not seg.flags["WRITEABLE"]:
                err = f"put to read-only segment {seg_id}"
            elif offset < 0 or offset + data.nbytes > seg.nbytes:
                err = (f"put out of bounds: [{offset},{offset + data.nbytes})"
                       f" into {seg.nbytes}-byte segment {seg_id}")
            else:
                seg[offset:offset + data.nbytes] = \
                    data.reshape(-1).view(np.uint8)
            if notify is not None:
                self.counters[notify] = self.counters.get(notify, 0) + 1
                if err is not None:
                    self.counter_errors.setdefault(notify, []).append(err)
        return err

    def read_get(self, ctx_uid: str, seg_id: int, offset: int,
                 nbytes: int) -> Optional[np.ndarray]:
        """Copy ``nbytes`` out of the segment (None on bad address)."""
        with self.lock:
            seg = self.segments.get((ctx_uid, seg_id))
            if seg is None or offset < 0 or offset + nbytes > seg.nbytes:
                return None
            return seg[offset:offset + nbytes].copy()

    # -- atomic counters ----------------------------------------------
    def counter_add(self, key: Any, delta: int = 1) -> None:
        with self.lock:
            self.counters[key] = self.counters.get(key, 0) + delta

    def counter_read(self, key: Any) -> int:
        with self.lock:
            return self.counters.get(key, 0)

    def counter_errs(self, key: Any) -> List[str]:
        with self.lock:
            return list(self.counter_errors.get(key, ()))

    def counter_del(self, key: Any) -> None:
        with self.lock:
            self.counters.pop(key, None)
            self.counter_errors.pop(key, None)


#: the process singleton (module import is the "global constructor")
REGISTRY = _Registry()


def local_os_put(desc: dict, offset: int, data: np.ndarray,
                 notify: Any = None) -> None:
    """In-process put (shm peers / socket loopback): apply directly under
    the registry lock. A rejection poisons the notify counter (unblocking
    the waiting target with an error) AND raises at the initiator."""
    err = REGISTRY.apply_put(desc["ctx_uid"], desc["seg_id"], offset, data,
                             notify)
    if err:
        raise UccError(Status.ERR_INVALID_PARAM, f"one-sided put: {err}")


def local_os_get(desc: dict, offset: int, dst: np.ndarray) -> RecvReq:
    """In-process get: synchronous copy-out. A short read (nbytes=0)
    marks a bad handle/bounds — callers validate via _check_get, the same
    convention the socket reply path uses."""
    req = RecvReq(dst.reshape(-1).view(np.uint8))
    data = REGISTRY.read_get(desc["ctx_uid"], desc["seg_id"], offset,
                             req.dst.nbytes)
    if data is not None:
        req.dst[:] = data
        req.nbytes = data.nbytes
    req.done = True
    return req


def import_memh(handle: bytes) -> dict:
    """Decode an exported handle into its descriptor (remote form of
    Context.mem_import: no live-buffer resolution)."""
    import pickle
    desc = pickle.loads(handle)
    if not isinstance(desc, dict) or "seg_id" not in desc:
        raise UccError(Status.ERR_INVALID_PARAM,
                       "not a mem_map handle (no seg_id)")
    return desc


# ---------------------------------------------------------------------------
# task-side helpers
# ---------------------------------------------------------------------------

class OneSidedMixin:
    """One-sided p2p for HostCollTask algorithms (group-rank addressed).

    The comp_context must expose ``os_put/os_get/os_flush`` (TL/SHM:
    direct registry; TL/SOCKET: frames with loopback fast path)."""

    def _os_resolve(self, peer_grank: int) -> int:
        return self.tl_team._peer_ctx_rank(self.subset, peer_grank)

    def os_put(self, peer_grank: int, desc: dict, offset: int,
               data: np.ndarray, notify: Any = None) -> None:
        """Local-completion put (sender buffer reusable on return)."""
        self.tl_team.comp_context.os_put(
            self._os_resolve(peer_grank), desc, int(offset), data, notify)

    def os_get(self, peer_grank: int, desc: dict, offset: int,
               dst: np.ndarray) -> RecvReq:
        return self.tl_team.comp_context.os_get(
            self._os_resolve(peer_grank), desc, int(offset), dst)

    def os_flush(self, peer_grank: int):
        """Remote-completion fence for prior puts to this peer
        (ucp_ep_flush analog). Returns a waitable request."""
        return self.tl_team.comp_context.os_flush(self._os_resolve(peer_grank))

    def os_wait_counter(self, key: Any, target: int):
        """Yield until the local atomic counter reaches ``target``; a
        poisoned counter (some put was rejected) fails the task."""
        while REGISTRY.counter_read(key) < target:
            yield
        errs = REGISTRY.counter_errs(key)
        if errs:
            REGISTRY.counter_del(key)
            raise UccError(Status.ERR_NO_MESSAGE,
                           f"one-sided delivery failed: {errs[0]} "
                           f"({len(errs)} rejected)")

    def ctr_key(self, target_uid: str) -> Any:
        """Per-collective arrival-counter key on the rank owning
        ``target_uid`` (team-sequenced tags are symmetric across ranks,
        so every rank derives the same key for a given target)."""
        return (OS_CTR, target_uid, self.tl_team.team_key, self.tag)

    def _check_get(self, req: RecvReq, nbytes: int) -> None:
        """Socket get errors surface as short replies (see sockets.py)."""
        if req.nbytes != nbytes:
            raise UccError(Status.ERR_NO_MESSAGE,
                           f"one-sided get failed: expected {nbytes} bytes, "
                           f"got {req.nbytes} (bad handle/bounds at target)")


def _memh_descs(task: HostCollTask, memh, which: str,
                allow_none: bool = False) -> Optional[List[dict]]:
    """Validate + decode a global memh array (one handle per team rank,
    ucc.h global_memh). Accepts raw exported handles (bytes) or
    already-imported descriptor dicts. ``allow_none`` returns None for
    absent memh — the algorithm then SELF-BOOTSTRAPS: it mem_maps its
    own buffers and exchanges the handles inline (beyond-reference
    convenience; the explicit-memh path stays bit-for-bit)."""
    size = task.gsize
    if memh is None:
        if allow_none:
            return None
        raise UccError(Status.ERR_NOT_SUPPORTED,
                       f"onesided algorithm requires {which}_memh global "
                       "handles (flags MEM_MAP_{SRC,DST}_MEMH)")
    if not isinstance(memh, (list, tuple)) or len(memh) != size:
        raise UccError(Status.ERR_INVALID_PARAM,
                       f"{which}_memh must be a list of {size} handles "
                       "(one per team rank)")
    descs = []
    for h in memh:
        descs.append(import_memh(h) if isinstance(h, (bytes, bytearray))
                     else dict(h))
    for d in descs:
        if "seg_id" not in d or "ctx_uid" not in d:
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"bad {which}_memh handle: {d}")
    return descs


def _bootstrap_exchange(task: HostCollTask, payload: bytes,
                        slot: int = 8200, pad: int = 8192):
    """Inline all-to-all of small fixed-size blobs over the team's tagged
    p2p — the rkey exchange a runtime would otherwise do out of band
    before a one-sided collective. Returns the per-rank blobs (own
    payload included)."""
    size, me = task.gsize, task.grank
    if len(payload) > pad - 8:
        raise UccError(Status.ERR_INVALID_PARAM,
                       "one-sided bootstrap payload too large")
    blob = np.zeros(pad, np.uint8)
    blob[:8] = np.frombuffer(np.int64(len(payload)).tobytes(), np.uint8)
    blob[8:8 + len(payload)] = np.frombuffer(payload, np.uint8)
    inbox = np.zeros((size, pad), np.uint8)
    reqs = []
    for p in range(size):
        if p == me:
            continue
        reqs.append(task.send_nb(p, blob, slot=slot))
        reqs.append(task.recv_nb(p, inbox[p], slot=slot))
    yield from task.wait(*reqs)
    inbox[me] = blob
    out = []
    for p in range(size):
        ln = int(np.frombuffer(inbox[p, :8].tobytes(), np.int64)[0])
        out.append(inbox[p, 8:8 + ln].tobytes())
    return out


def _self_map(task: HostCollTask, *buffers):
    """mem_map this rank's buffers through the core context; returns
    (handles, unmap_fn)."""
    ctx = task.tl_team.core_team.context
    handles = [ctx.mem_map(b) for b in buffers]

    def unmap():
        for h in handles:
            ctx.mem_unmap(h)
    return handles, unmap


def _dissemination_barrier(task: HostCollTask, slot_base: int = 7000):
    """Inline barrier rounds (the schedule-level barrier the reference
    appends to the get-based onesided alltoall,
    alltoall_onesided.c:183-240)."""
    size, me = task.gsize, task.grank
    tok = np.zeros(1, dtype=np.uint8)
    sink = np.empty(1, dtype=np.uint8)
    dist = 1
    rnd = 0
    while dist < size:
        to = (me + dist) % size
        frm = (me - dist) % size
        sreq = task.send_nb(to, tok, slot=slot_base + rnd)
        rreq = task.recv_nb(frm, sink, slot=slot_base + rnd)
        yield from task.wait(sreq, rreq)
        dist *= 2
        rnd += 1


# ---------------------------------------------------------------------------
# onesided alltoall (tl_ucp alltoall_onesided.c)
# ---------------------------------------------------------------------------

class AlltoallOnesided(OneSidedMixin, HostCollTask):
    """One-sided alltoall over globally mem-mapped buffers.

    Two variants, selected by ``UCC_TL_<X>_ALLTOALL_ONESIDED_ALG``
    (reference knob ``alltoall_onesided_alg``):

    - ``put`` (default): rank r puts src block p into peer p's *dst
      segment* at offset r*block, each put carrying an arrival-counter
      notify; completion = own counter reaching team size (the
      ``onesided.put_completed`` / atomic-counter protocol,
      alltoall_onesided.c:128-170). Requires ``dst_memh`` global handles.
    - ``get``: rank r gets peer p's src block r from p's *src segment*
      into its own dst (alltoall_onesided.c:84-126), then a closing
      barrier keeps every src segment valid until all readers are done
      (the reference schedules a barrier task after the a2a task for the
      same reason). Requires ``src_memh`` global handles.

    Like the reference, this algorithm is never the default: it is
    selected via the TUNE DSL (``UCC_TL_SOCKET_TUNE=alltoall:@onesided``)
    and errors cleanly when the memh args are absent, which lets the
    score-map fallback walk pick a two-sided algorithm instead.
    """

    def __init__(self, init_args, team, variant: Optional[str] = None):
        super().__init__(init_args, team)
        args = init_args.args
        if args.is_inplace:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "onesided alltoall does not support in-place")
        if variant is None:
            cfg = team.comp_context.config
            try:
                variant = cfg.get("alltoall_onesided_alg") if cfg else "put"
            except KeyError:
                variant = "put"
        self.variant = variant or "put"
        if self.variant not in ("put", "get"):
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"unknown onesided alltoall variant "
                           f"'{self.variant}' (put|get)")
        self.which = "dst" if self.variant == "put" else "src"
        self.descs = _memh_descs(
            self, getattr(args, f"{self.which}_memh", None), self.which,
            allow_none=True)
        self.count = int(args.src.count)
        if self.count % self.gsize:
            raise UccError(Status.ERR_INVALID_PARAM,
                           "alltoall count must divide by team size")

    def run(self):
        unmap = None
        descs = self.descs
        try:
            if descs is None:
                # self-bootstrap (see _memh_descs): map the variant's
                # remote side and exchange handles inline
                buf = (self.args.dst if self.which == "dst"
                       else self.args.src).buffer
                handles, unmap = _self_map(self, buf)
                blobs = yield from _bootstrap_exchange(self, handles[0])
                descs = [import_memh(b) for b in blobs]
            if self.variant == "put":
                yield from self._run_put(descs)
            else:
                yield from self._run_get(descs)
        finally:
            # success: put = my counter full (no more writes to my dst
            # segment), get = closing barrier (no more reads of my src).
            # Failure: the task is dead; unregister rather than leak a
            # live remote window onto the user's buffer.
            if unmap is not None:
                unmap()
            if descs:
                REGISTRY.counter_del(
                    self.ctr_key(descs[self.grank]["ctx_uid"]))

    def _run_put(self, descs):
        args = self.args
        size, me = self.gsize, self.grank
        nb = (self.count // size) * dt_size(args.src.datatype)
        src_u8 = binfo_typed(args.src, self.count).view(np.uint8)
        my_uid = descs[me]["ctx_uid"]
        my_ctr = self.ctr_key(my_uid)
        # put loop starting at grank+1 (the reference's peer rotation,
        # alltoall_onesided.c:143 — spreads target load across ranks)
        for i in range(1, size + 1):
            peer = (me + i) % size
            self.os_put(peer, descs[peer], me * nb,
                        src_u8[peer * nb:(peer + 1) * nb],
                        notify=self.ctr_key(descs[peer]["ctx_uid"]))
        # completion: everyone has landed in MY dst segment
        yield from self.os_wait_counter(my_ctr, size)
        REGISTRY.counter_del(my_ctr)

    def _run_get(self, descs):
        args = self.args
        size, me = self.gsize, self.grank
        nb = (self.count // size) * dt_size(args.src.datatype)
        dst_u8 = binfo_typed(args.dst, self.count).view(np.uint8)
        reqs = []
        for i in range(1, size + 1):
            peer = (me + i) % size
            reqs.append((self.os_get(peer, descs[peer], me * nb,
                                     dst_u8[peer * nb:(peer + 1) * nb]), nb))
        yield from self.wait(*[r for r, _ in reqs])
        for r, n in reqs:
            self._check_get(r, n)
        # src segments must outlive every reader (reference appends a
        # barrier task to the schedule for the get path)
        yield from _dissemination_barrier(self)


class AlltoallvOnesided(OneSidedMixin, HostCollTask):
    """One-sided alltoallv — a port of alltoallv_onesided.c's semantics.

    IMPORTANT layout convention (inherited from the reference,
    alltoallv_onesided.c:36-48 "perform a put to each member peer using
    the peer's index in the destination displacement"): the initiator's
    ``dst.displacements[peer]`` is TARGET-RELATIVE — the offset inside
    *peer's* destination buffer where THIS rank's block lands (the
    SHMEM symmetric-layout convention), not the local receive offset the
    two-sided algorithms use. Callers build it as the transpose of the
    usual receive-displacement table. Counts follow the usual meaning
    (``src.counts[peer]`` elements go to ``peer``).

    Completion: per-put notify counters (the reference's pSync
    atomic_inc protocol, :55-57) — rank r completes when all team
    members' blocks have landed in its destination segment.

    Two variants, selected by ``UCC_TL_<X>_ALLTOALLV_ONESIDED_ALG``:

    - ``put`` (default; the reference's alltoallv_onesided.c is
      put-ONLY — only the non-v alltoall grew a get variant,
      tl_ucp.h:46-51 ALLTOALL_ONESIDED_{PUT,GET}).
    - ``get`` (beyond-reference): rank r gets peer p's block-for-r out
      of p's *source* segment into its own dst, then a closing barrier
      keeps every src segment readable until all readers finish (the
      same liveness protocol as the alltoall get path). In explicit-memh
      mode ``src.displacements[peer]`` is TARGET-RELATIVE — the offset
      inside *peer's* source buffer of the block destined for this rank
      (the exact mirror of the put convention below); byte counts come
      from the initiator's own ``dst.counts``.

    WITHOUT explicit memh the task self-bootstraps (see _memh_descs) and
    the exchange carries each rank's OWN displacement table (receive
    displacements for put, send displacements for get), so both variants
    keep standard MPI alltoallv semantics in bootstrap mode, while the
    explicit-memh path keeps the reference's target-relative convention
    bit-for-bit.
    """

    def __init__(self, init_args, team, variant: Optional[str] = None):
        super().__init__(init_args, team)
        args = init_args.args
        if args.is_inplace:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "onesided alltoallv does not support in-place")
        if variant is None:
            cfg = team.comp_context.config
            try:
                variant = cfg.get("alltoallv_onesided_alg") if cfg \
                    else "put"
            except KeyError:
                variant = "put"
        self.variant = variant or "put"
        if self.variant not in ("put", "get"):
            raise UccError(Status.ERR_INVALID_PARAM,
                           f"unknown onesided alltoallv variant "
                           f"'{self.variant}' (put|get)")
        self.which = "dst" if self.variant == "put" else "src"
        self.descs = _memh_descs(
            self, getattr(args, f"{self.which}_memh", None), self.which,
            allow_none=True)
        for bi, name in ((args.src, "src"), (args.dst, "dst")):
            if bi is None or bi.counts is None:
                raise UccError(Status.ERR_INVALID_PARAM,
                               f"alltoallv requires {name} counts")

    @staticmethod
    def _displ(bi, counts):
        d = bi.displacements
        if d is None:
            d = np.cumsum([0] + counts[:-1])
        return d

    def run(self):
        if self.variant == "put":
            yield from self._run_put()
        else:
            yield from self._run_get()

    def _run_put(self):
        args = self.args
        size, me = self.gsize, self.grank
        s_esz = dt_size(args.src.datatype)
        d_esz = dt_size(args.dst.datatype)
        s_counts = [int(c) for c in args.src.counts]
        s_displ = self._displ(args.src, s_counts)
        d_displ = self._displ(args.dst, [int(c) for c in args.dst.counts])
        descs = self.descs
        unmap = None
        peer_doffs = None      # bootstrap mode: peer -> my offset there
        try:
            if descs is None:
                import pickle
                handles, unmap = _self_map(self, args.dst.buffer)
                payload = pickle.dumps(
                    (handles[0], [int(d) for d in d_displ]))
                blobs = yield from _bootstrap_exchange(self, payload)
                decoded = [pickle.loads(b) for b in blobs]
                descs = [import_memh(h) for h, _ in decoded]
                # standard semantics: put to peer p at p's OWN receive
                # displacement for source rank me
                peer_doffs = [int(dd[me]) for _, dd in decoded]
            total_src = max(int(s_displ[p]) + s_counts[p]
                            for p in range(size))
            src_u8 = binfo_typed(args.src, total_src).view(np.uint8) \
                if total_src else np.empty(0, dtype=np.uint8)
            my_ctr = self.ctr_key(descs[me]["ctx_uid"])
            for i in range(1, size + 1):
                peer = (me + i) % size
                sd = int(s_displ[peer]) * s_esz
                nb = s_counts[peer] * s_esz
                if peer_doffs is not None:
                    dd = peer_doffs[peer] * d_esz
                else:
                    dd = int(d_displ[peer]) * d_esz  # TARGET-relative (doc)
                self.os_put(peer, descs[peer], dd, src_u8[sd:sd + nb],
                            notify=self.ctr_key(descs[peer]["ctx_uid"]))
            yield from self.os_wait_counter(my_ctr, size)
        finally:
            # failure path included: unregister the bootstrap window and
            # drop the arrival counter rather than leak them
            if unmap is not None:
                unmap()
            if descs:
                REGISTRY.counter_del(
                    self.ctr_key(descs[me]["ctx_uid"]))

    def _run_get(self):
        args = self.args
        size, me = self.gsize, self.grank
        s_esz = dt_size(args.src.datatype)
        d_esz = dt_size(args.dst.datatype)
        d_counts = [int(c) for c in args.dst.counts]
        s_displ = self._displ(args.src, [int(c) for c in args.src.counts])
        d_displ = self._displ(args.dst, d_counts)
        descs = self.descs
        unmap = None
        peer_soffs = None      # bootstrap mode: peer -> my block's offset
        try:
            if descs is None:
                import pickle
                handles, unmap = _self_map(self, args.src.buffer)
                payload = pickle.dumps(
                    (handles[0], [int(d) for d in s_displ]))
                blobs = yield from _bootstrap_exchange(self, payload)
                decoded = [pickle.loads(b) for b in blobs]
                descs = [import_memh(h) for h, _ in decoded]
                # standard semantics: get from peer p at p's OWN send
                # displacement for destination rank me
                peer_soffs = [int(sd[me]) for _, sd in decoded]
            total_dst = max(int(d_displ[p]) + d_counts[p]
                            for p in range(size))
            dst_u8 = binfo_typed(args.dst, total_dst).view(np.uint8) \
                if total_dst else np.empty(0, dtype=np.uint8)
            reqs = []
            for i in range(1, size + 1):
                peer = (me + i) % size
                nb = d_counts[peer] * d_esz
                if peer_soffs is not None:
                    so = peer_soffs[peer] * s_esz
                else:
                    so = int(s_displ[peer]) * s_esz  # TARGET-relative (doc)
                do = int(d_displ[peer]) * d_esz
                reqs.append((self.os_get(peer, descs[peer], so,
                                         dst_u8[do:do + nb]), nb))
            yield from self.wait(*[r for r, _ in reqs])
            for r, n in reqs:
                self._check_get(r, n)
            # src segments must outlive every reader (same closing
            # barrier as the alltoall get path)
            yield from _dissemination_barrier(self)
        finally:
            if unmap is not None:
                unmap()


# ---------------------------------------------------------------------------
# sliding-window one-sided allreduce (tl_ucp allreduce_sliding_window.{c,h})
# ---------------------------------------------------------------------------

class AllreduceSlidingWindow(OneSidedMixin, HostCollTask):
    """One-sided windowed allreduce over globally mem-mapped src/dst.

    The reference's sliding-window allreduce
    (allreduce_sliding_window.h:30-50) exists for messages larger than
    the working set: each rank owns partition r of the vector, GETs the
    other ranks' fragments of that partition window-by-window (bounded
    in-flight get buffers), reduces them, and PUTs the reduced window
    into every peer's dst — a reduce_scatter + allgather expressed
    entirely as one-sided ops against the global work buffers.

    Completion protocol: every put carries an arrival-counter notify;
    rank r's dst is complete when its counter reaches
    sum(windows(owner) for owner != r) + its own local windows. That
    counter full also proves every owner has *read* r's src (an owner
    only puts a window after getting all contributions for it), so no
    closing barrier is needed — the same property the reference's
    count_serviced tracking provides.

    In-place is safe: the only writer of partition q (owner q's put) is
    also the only remote reader of partition q (owner q's gets), and the
    owner sequences its gets before its puts per window.
    """

    def __init__(self, init_args, team, window_bytes: Optional[int] = None,
                 inflight: Optional[int] = None):
        super().__init__(init_args, team)
        args = init_args.args
        # absent memh -> self-bootstrap at run time (mem_map own buffers
        # + inline handle exchange): plain TUNE selection works without
        # any rkey plumbing, which is what lets CL/HIER's DCN leader
        # stage pick this algorithm up unchanged
        self.src_descs = _memh_descs(self, getattr(args, "src_memh", None),
                                     "src", allow_none=True)
        self.dst_descs = _memh_descs(self, getattr(args, "dst_memh", None),
                                     "dst", allow_none=True)
        self.count = int(args.dst.count)
        self.dt = args.dst.datatype
        self.op = args.op if args.op is not None else ReductionOp.SUM
        esz = dt_size(self.dt)
        auto_w, auto_i = sw_knobs(team.comp_context.config,
                                  self.count * esz)
        if window_bytes is None:
            window_bytes = auto_w
        if inflight is None:
            inflight = auto_i
        self.window = max(1, int(window_bytes) // esz)
        #: bounded get buffers (reference num_buffers / avail_buffs,
        #: allreduce_sliding_window.h:36-38)
        self.inflight = max(1, int(inflight))

    def _nwin(self, owner: int) -> int:
        return div_round_up(block_count(self.count, self.gsize, owner),
                            self.window)

    def _scratch(self, gwb, wlen: int, nd, esz: int) -> np.ndarray:
        """In-flight get buffers, backed by the user's global_work_buffer
        when one of sufficient size is provided (ucc.h:1878-1887: "at
        least the size returned by ucc_context_get_attr with
        WORK_BUFFER_SIZE"); internal allocation otherwise."""
        need = self.inflight * wlen * esz
        if isinstance(gwb, np.ndarray) and gwb.nbytes >= need and \
                gwb.flags["C_CONTIGUOUS"] and gwb.flags["WRITEABLE"]:
            try:
                return gwb.reshape(-1).view(np.uint8)[:need].view(nd) \
                    .reshape(self.inflight, wlen)
            except ValueError:
                pass      # misaligned user buffer: fall back
        return np.empty((self.inflight, wlen), dtype=nd)

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        esz = dt_size(self.dt)
        nd = storage_dtype(self.dt)
        src = binfo_typed(args.dst if args.is_inplace else args.src,
                          self.count)
        dst = binfo_typed(args.dst, self.count)
        op = ReductionOp.SUM if self.op == ReductionOp.AVG else self.op
        alpha = 1.0 / size if self.op == ReductionOp.AVG else None

        if size == 1:
            out = reduce_arrays([src], ReductionOp.SUM, self.dt, alpha=alpha) \
                if alpha is not None else src
            dst[:] = out
            return

        src_descs, dst_descs = self.src_descs, self.dst_descs
        unmap = None
        if src_descs is None or dst_descs is None:
            import pickle
            same = args.is_inplace or args.src is None or \
                args.src.buffer is args.dst.buffer
            if same:
                handles, unmap = _self_map(self, args.dst.buffer)
                h_src = h_dst = handles[0]
            else:
                handles, unmap = _self_map(self, args.src.buffer,
                                           args.dst.buffer)
                h_src, h_dst = handles
            blobs = yield from _bootstrap_exchange(
                self, pickle.dumps((h_src, h_dst)))
            pairs = [pickle.loads(b) for b in blobs]
            src_descs = [import_memh(h) for h, _ in pairs]
            dst_descs = [import_memh(h) for _, h in pairs]

        try:
            yield from self._windows(args, src, dst, src_descs, dst_descs,
                                     op, alpha, esz, nd)
        finally:
            # failure path included: unregister bootstrap windows and the
            # arrival counter rather than leak a live remote window
            if unmap is not None:
                unmap()
            REGISTRY.counter_del(
                self.ctr_key(dst_descs[me]["ctx_uid"]))

    def _windows(self, args, src, dst, src_descs, dst_descs, op, alpha,
                 esz, nd):
        size, me = self.gsize, self.grank
        my_ctr = self.ctr_key(dst_descs[me]["ctx_uid"])
        my_count = block_count(self.count, size, me)
        my_off = block_offset(self.count, size, me)

        # expected arrivals into MY dst: one put per (owner, window) pair
        # from every other owner, plus my own local window writes
        expect = sum(self._nwin(r) for r in range(size) if r != me)

        peers = [(me + i) % size for i in range(1, size)]
        wlen = min(self.window, max(my_count, 1))
        getbuf = self._scratch(args.global_work_buffer, wlen, nd, esz)
        # cross-window pipeline: the in-flight get-buffer bound is
        # global, so window w+1's gets issue while window w is still
        # reducing/putting (UCC's num_buffers semantics: buffers in
        # flight across the message, not per window). In-place stays
        # safe across windows: my gets and my puts
        # for MY partition touch disjoint window ranges of the peers'
        # buffers, and within one window all gets complete before its
        # puts (see class docstring invariant).
        nwin = self._nwin(me)

        def w_n(w_idx: int) -> int:
            return min(self.window, my_count - w_idx * self.window)

        tasks = [(w, p) for w in range(nwin) for p in peers]
        accs: Dict[int, np.ndarray] = {}
        remaining: Dict[int, int] = {}
        pending: List[Tuple[RecvReq, int, int]] = []   # (req, slot, w)
        free_slots = list(range(self.inflight))
        issued = 0

        def finalize(w_idx: int) -> None:
            acc = accs.pop(w_idx)
            del remaining[w_idx]
            if alpha is not None:
                acc = reduce_arrays([acc], ReductionOp.SUM, self.dt,
                                    alpha=alpha)
            w0 = w_idx * self.window
            goff = (my_off + w0) * esz
            for p in peers:
                self.os_put(p, dst_descs[p], goff,
                            np.ascontiguousarray(acc).view(np.uint8),
                            notify=self.ctr_key(dst_descs[p]["ctx_uid"]))
            dst[my_off + w0:my_off + w0 + w_n(w_idx)] = acc

        while issued < len(tasks) or pending:
            while issued < len(tasks) and free_slots:
                w_idx, peer = tasks[issued]
                if w_idx not in accs:
                    w0 = w_idx * self.window
                    accs[w_idx] = src[my_off + w0:
                                      my_off + w0 + w_n(w_idx)].copy()
                    remaining[w_idx] = len(peers)
                slot = free_slots.pop()
                wn = w_n(w_idx)
                goff = (my_off + w_idx * self.window) * esz
                req = self.os_get(peer, src_descs[peer], goff,
                                  getbuf[slot, :wn].view(np.uint8))
                pending.append((req, slot, w_idx))
                issued += 1
            # reduce whichever get has landed (reference REDUCING state);
            # slots come from a free-list — a slot is only reissued after
            # ITS request completed (gets finish out of order)
            done_i = None
            for i, (req, slot, w_idx) in enumerate(pending):
                if req.test():
                    done_i = i
                    break
            if done_i is None:
                yield
                continue
            req, slot, w_idx = pending.pop(done_i)
            wn = w_n(w_idx)
            self._check_get(req, wn * esz)
            accs[w_idx] = reduce_arrays([accs[w_idx], getbuf[slot, :wn]],
                                        op, self.dt)
            free_slots.append(slot)
            remaining[w_idx] -= 1
            if remaining[w_idx] == 0:
                finalize(w_idx)
        # completion: all owners' windows have landed in my dst — which
        # also proves every owner has read my src (see class docstring).
        # Counter full also makes the bootstrap unmap safe: nobody will
        # touch my segments again (see class docstring invariant).
        yield from self.os_wait_counter(my_ctr, expect)
