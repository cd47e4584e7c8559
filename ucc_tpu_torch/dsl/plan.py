"""Plan lowering — verified programs as native execution plans (the port
of ``ucc_tpu/dsl/plan.py``).

The compiler (``compile.py``) interprets a verified :class:`~.ir.Program`
from Python: every round pays generator resumption, per-message ``send_nb``/
``recv_nb`` posts, wait polling, and numpy reductions. A verified
program is a *static* round-structured schedule, so this module lowers
one rank's stream to a flat packed op table — ``POST_SEND / POST_RECV /
WAIT_ROUND / REDUCE / COPY / ENCODE / DECODE`` entries with pre-resolved
buffer offsets, packed tag words, slots and peer ctx ranks — that the
port's native core (``native_src/ucc_tpu_torch_core.cc``,
``ucc_plan_build/post/test/cancel``) retires entirely in C++:

- ``post`` is ONE ffi crossing per collective: round 0's recvs and
  sends go out inside the call, and every later round advances
  *delivery-driven* — whichever thread completes a round's last message
  (inside its own push/post ffi call) runs the round's reductions in C
  and posts the next round, cascading across ranks without re-entering
  Python anywhere;
- the owner polls a single completion word in the already-mapped pub
  window (a memory load, zero ffi);
- SUM/PROD/MAX/MIN reductions over contiguous f32/f64 run in C (plain
  loops the compiler autovectorizes); bf16/other dtypes and the
  quantized codec edges are flagged at lowering time as **assist**
  rounds — the plan pauses, publishes ``NEED_ASSIST`` and the owning
  task runs that round's local ops in numpy before resuming — so
  correctness never regresses to support the fast path;
- wire/scratch buffers (reduce landing zones, quantized wire staging)
  are a single mc-pool lease resolved at BUILD time, so offsets are
  absolute for the plan's lifetime; only the user dst base and the
  collective tag rebind per post (plans survive persistent re-posts and
  stay cached per (program, team, epoch, dtype, count));
- the team recovery epoch is baked into every packed tag word, so the
  fence semantics hold: a stale-epoch plan's late sends are discarded at
  the match boundary (``n_fenced``) and ``ucc_plan_cancel`` withdraws
  posted recvs under the delivering shard lock (native cancel-skip). The
  team's epoch is bumped by every shrink and grow.

``UCC_GEN_NATIVE`` (y|n|auto, default auto) selects the mode; ``auto``
engages when the native matcher serves every endpoint of the team and
the dtype/op pair runs fully native (f32/f64, exact programs), and
interprets otherwise. Explicit ``y`` additionally routes assist-dependent
programs (bf16 payloads, quantized wire) through plans, and makes the
plan required: when the native core cannot be loaded or a plan cannot be
built, the collective's init raises ERR_NO_RESOURCE (the rule of
``UCC_NATIVE=y``) instead of falling back to the interpreter.

Hand-written algorithms ride the same path: ``tl/host/ring.py`` and
``tl/host/sra.py`` emit their inner loops as IR programs (gated by the
same verifier as any family) and execute them as plans when the knob
resolves on — generated and hand-written algorithms share one execution
engine.
"""
from __future__ import annotations

import ctypes
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..constants import ReductionOp
from ..ec.cpu import storage_dtype
from ..status import Status, UccError
from ..utils.log import get_logger
from ..utils.mathutils import block_count, block_offset
from .ir import OpKind, Program

logger = get_logger("dsl")

# --- packed op table (must match native_src/ucc_tpu_torch_core.cc) ---------
PLAN_OP_WORDS = 8

OP_POST_SEND = 0
OP_POST_RECV = 1
OP_WAIT_ROUND = 2
OP_REDUCE = 3
OP_COPY = 4
OP_ENCODE = 5
OP_DECODE = 6

FLAG_PRE_ASSIST = 1
FLAG_POST_ASSIST = 2

REG_USER = 0
REG_SCRATCH = 1

# plan state word (low 3 bits of the mapped pub word)
ST_RUNNING = 0
ST_DONE = 1
ST_ERROR = 2       # slot exhaustion / truncated delivery / purge
ST_FENCED = 3
ST_CANCELED = 4
ST_ASSIST = 5
ST_CORRUPT = 6     # wire crc32 mismatch on a plan recv (payload=round)
ST_DEAD = 7        # python-side: state slot freed under us

_DT_NATIVE = {np.dtype(np.float32): 1, np.dtype(np.float64): 2}
_ROP_CODE = {ReductionOp.SUM: 0, ReductionOp.PROD: 1,
             ReductionOp.MAX: 2, ReductionOp.MIN: 3}

_SLOT_BITS = 20
_IDX_MASK = (1 << _SLOT_BITS) - 1
_NB_MASK = (1 << 29) - 1


# UCC_GEN_NATIVE is a field of core/lib.py's GLOBAL_CONFIG (next to
# UCC_GEN); resolution below reads the team lib config with the env
# fallback the other dsl knobs use.


def native_mode(team) -> str:
    """Resolve UCC_GEN_NATIVE (y|n|auto) once per team, cached."""
    mode = team.__dict__.get("_gen_native_mode")
    if mode is None:
        from .registry import _cfg_str
        raw = _cfg_str(team, "gen_native", "UCC_GEN_NATIVE", "auto")
        mode = raw if raw in ("y", "yes", "on", "1", "true", "t",
                              "n", "no", "off", "0", "false", "f",
                              "auto") else "auto"
        if mode in ("yes", "on", "1", "true", "t"):
            mode = "y"
        elif mode in ("no", "off", "0", "false", "f"):
            mode = "n"
        team.__dict__["_gen_native_mode"] = mode
    return mode


def team_plan_capable(team) -> bool:
    """True when this team's endpoints can execute plans at all: the
    native core is loaded and matching natively on OUR endpoint (peer
    endpoints are checked per subset at build time). One resolution per
    team, cached — never on the dispatch path."""
    cap = team.__dict__.get("_plan_capable")
    if cap is None:
        cap = False
        if native_mode(team) != "n":
            try:
                from .. import native
                tr = getattr(team, "transport", None)
                cap = native.available() and \
                    getattr(tr, "native", None) is not None
            except Exception:  # noqa: BLE001 - capability probe only
                cap = False
        team.__dict__["_plan_capable"] = cap
    return cap


def _require_core() -> None:
    """UCC_GEN_NATIVE=y: the plans' native core must load."""
    from .. import native
    try:
        ok = native.available()
    except UccError:
        ok = False                  # UCC_NATIVE=y and the build failed
    if not ok:
        raise UccError(Status.ERR_NO_RESOURCE,
                       f"UCC_GEN_NATIVE=y but the native core is "
                       f"unavailable: {native.build_error()}")


def _peer_mailboxes(team, subset, nranks: int):
    """(my NativeMailbox, my ctx rank, [peer ctx rank per grank],
    {ctx: NativeMailbox}) — or None when any endpoint lacks the native
    matcher (a plan cannot push into a python-matched peer)."""
    tr = team.transport
    mine = getattr(tr, "native", None)
    if mine is None:
        return None
    my_ctx = team._my_ctx_rank
    ctx_of: List[int] = []
    boxes: Dict[int, Any] = {}
    comp = team.comp_context
    if not hasattr(comp, "_peer"):
        return None                 # socket TL: peers are remote
    for g in range(nranks):
        ctx = team._peer_ctx_rank(subset, g)
        ctx_of.append(ctx)
        if ctx == my_ctx:
            boxes[ctx] = mine
            continue
        try:
            peer = comp._peer(ctx)
        except Exception:  # noqa: BLE001 - address not resolvable
            return None
        nb = getattr(peer, "native", None)
        if nb is None or nb.ptr is None:
            return None
        boxes[ctx] = nb
    return mine, my_ctx, ctx_of, boxes


def _fault_blocks_plans(team=None, invariant=False) -> bool:
    """Probabilistic wire-fault injection (drop/delay/error/post_error)
    targets the per-message Python posts a plan bypasses: running plans
    under it would silently skip the injection. kill-only specs keep
    plans on (the kill and shrink drill: detection cancels the task,
    which withdraws the plan's recvs natively).

    Corruption rides the Python send path too. When the spec pins a
    corrupting rank only that rank has to interpret (its interpreted
    sends are wire-compatible with the other ranks' plan recvs), which
    makes the answer differ between ranks: it may gate :func:`resolve`
    only. Candidate selection passes ``invariant=True`` and keeps the
    generated task on every rank, or the corrupting rank would pick a
    classic algorithm with another slot scheme and deadlock the
    collective. An unpinned corrupt spec can strike any sender: plans
    are off everywhere."""
    from ..fault import inject as fault
    if not fault.ENABLED:
        return False
    s = fault.SPEC
    if s.drop or s.delay or s.error or s.post_error:
        return True
    if s.corrupt:
        if s.corrupt_rank is None:
            return True
        if invariant:
            return False
        my = getattr(team, "_my_ctx_rank", None) if team is not None \
            else None
        return my is None or my == s.corrupt_rank
    return False


def resolve(task, team, program: Program) -> bool:
    """Final per-task eligibility (dtype/op known here)."""
    from ..constants import CollType
    if program.coll != CollType.ALLREDUCE or program.edge_wire_mode:
        # the plan format encodes the allreduce contract only (the
        # allgather/reduce_scatter/bcast programs and per-edge
        # quantization interpret)
        return False
    mode = native_mode(team)
    if mode == "n" or not team_plan_capable(team):
        return False
    if _fault_blocks_plans(team):
        return False
    nd = storage_dtype(task.dt)
    if mode == "auto":
        # fully-native execution only: exact program, C-reducible dtype
        if program.wire or nd not in _DT_NATIVE:
            return False
    else:
        if program.wire and nd != np.dtype(np.float32):
            return False            # wire assist accumulates in f32
        try:
            nd.itemsize  # noqa: B018 - any numpy dtype is lowerable
        except Exception:  # noqa: BLE001
            return False
    return True


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

class _AssistOps:
    """Python-side description of one round's assist ops, executed by
    the owning task when the plan publishes NEED_ASSIST. Offsets are in
    BYTES over the same two regions the C side uses."""

    __slots__ = ("pre", "post")

    def __init__(self):
        self.pre: List[tuple] = []     # ("enc", coff, cnt, woff, wlen)
        self.post: List[tuple] = []    # ("red", coff, soff, cnt) |
        #                                ("copy", doff, soff, cnt) |
        #                                ("dec", coff, woff, wlen, cnt) |
        #                                ("redq", coff, woff, wlen, cnt)


class _Lowered:
    """Lowering result: the packed table plus everything the python
    wrapper needs to post/assist/account."""

    __slots__ = ("ops", "scratch_bytes", "assists", "round_bytes",
                 "n_rounds", "dtype_code", "any_assist")

    def __init__(self):
        self.ops: List[List[int]] = []
        self.scratch_bytes = 0
        self.assists: Dict[int, _AssistOps] = {}
        self.round_bytes: List[int] = []
        self.n_rounds = 0
        self.dtype_code = 0
        self.any_assist = False


def lower(program: Program, grank: int, count: int, nd: np.dtype,
          rop: ReductionOp, my_ctx: int, ctx_of: List[int],
          my_team_word: int, peer_team_word: List[int],
          qp=None) -> _Lowered:
    """Lower *program*'s stream for *grank* at element count *count*.

    ``my_team_word`` / ``peer_team_word[g]`` are the pre-packed
    ``team_id<<32|epoch`` words of my own and each peer's mailbox (team
    ids are interned per mailbox, so the word differs per destination).
    ``qp`` is the quant policy for wire-tagged programs (assist codec).
    """
    esz = nd.itemsize
    nch = program.nchunks
    bounds = [(block_offset(count, nch, c) * esz,
               block_count(count, nch, c)) for c in range(nch)]
    max_chunk = max(c for _, c in bounds)
    dtype_code = _DT_NATIVE.get(nd, 0)
    ropc = _ROP_CODE[ReductionOp.SUM if rop == ReductionOp.AVG else rop]
    out = _Lowered()
    out.dtype_code = dtype_code

    wire = bool(program.wire)
    if wire:
        from .. import quant
        max_wire = quant.wire_count(max_chunk, qp.block)
    else:
        max_wire = 0

    # scratch layout (bytes, all offsets absolute within one lease):
    #   exact:  [ landing zones: max_reduces x max_chunk*esz ]
    #   wire:   [ send wire: max_sends x max_wire ]
    #           [ recv wire: max_recvs x max_wire ]
    rounds = program.ranks[grank].rounds
    max_reduces = max_sends = max_recvs = 0
    for ops in rounds:
        max_sends = max(max_sends, len({op.chunk for op in ops
                                        if op.kind == OpKind.SEND}))
        max_recvs = max(max_recvs, sum(1 for op in ops if op.kind in
                                       (OpKind.RECV, OpKind.REDUCE)))
        max_reduces = max(max_reduces, sum(1 for op in ops
                                           if op.kind == OpKind.REDUCE))
    if wire:
        # [send wire staging | recv wire staging]
        out.scratch_bytes = (max_sends + max_recvs) * max_wire
    else:
        out.scratch_bytes = max_reduces * max_chunk * esz
    out.scratch_bytes = max(1, out.scratch_bytes)

    table = out.ops
    for rnd, ops in enumerate(rounds):
        sends = [op for op in ops if op.kind == OpKind.SEND]
        recvs = [op for op in ops
                 if op.kind in (OpKind.RECV, OpKind.REDUCE)]
        copies = [op for op in ops if op.kind == OpKind.COPY]
        assist = _AssistOps()
        pre_flag = post_flag = False
        rbytes = 0

        if not wire:
            for op in sends:
                coff, cnt = bounds[op.chunk]
                rbytes += cnt * esz
                table.append([
                    OP_POST_SEND,
                    peer_team_word[op.peer],
                    (op.slot << 32) | (my_ctx & 0xFFFFFFFF),
                    op.peer, REG_USER, coff, 0, cnt * esz])
            ri = 0
            for op in recvs:
                coff, cnt = bounds[op.chunk]
                if op.kind == OpKind.RECV:
                    table.append([
                        OP_POST_RECV, my_team_word,
                        (op.slot << 32) | (ctx_of[op.peer] & 0xFFFFFFFF),
                        0, REG_USER, coff, 0, cnt * esz])
                else:
                    soff = ri * max_chunk * esz
                    ri += 1
                    table.append([
                        OP_POST_RECV, my_team_word,
                        (op.slot << 32) | (ctx_of[op.peer] & 0xFFFFFFFF),
                        0, REG_SCRATCH, soff, 0, cnt * esz])
                    # landing-zone accumulate, in recv order (the
                    # interpreter's landings list)
                    table.append([
                        OP_REDUCE, 0, 0, 0,
                        REG_USER | (REG_SCRATCH << 4)
                        | (dtype_code << 8) | (ropc << 16),
                        coff, soff, cnt * esz])
                    if dtype_code == 0:
                        post_flag = True
                    assist.post.append(("red", coff, soff, cnt))
            for op in copies:
                doff, cnt = bounds[op.chunk]
                soff = bounds[op.src_chunk][0]
                table.append([
                    OP_COPY, 0, 0, 0,
                    REG_USER | (REG_USER << 4),
                    doff, soff, cnt * esz])
                assist.post.append(("copy", doff, soff, cnt))
        else:
            from .. import quant
            # one encode per (round, chunk): fan-out sends reuse the wire
            enc_off: Dict[int, Tuple[int, int]] = {}
            si = 0
            for op in sends:
                coff, cnt = bounds[op.chunk]
                wlen = quant.wire_count(cnt, qp.block)
                if op.chunk not in enc_off:
                    woff = si * max_wire
                    si += 1
                    enc_off[op.chunk] = (woff, wlen)
                    table.append([OP_ENCODE, 0, 0, 0, 0, coff, woff, wlen])
                    assist.pre.append(("enc", coff, cnt, woff, wlen))
                    pre_flag = True
                woff, wlen = enc_off[op.chunk]
                rbytes += wlen
                table.append([
                    OP_POST_SEND,
                    peer_team_word[op.peer],
                    (op.slot << 32) | (my_ctx & 0xFFFFFFFF),
                    op.peer, REG_SCRATCH, woff, 0, wlen])
            recv_base = max_sends * max_wire
            for wi, op in enumerate(recvs):
                coff, cnt = bounds[op.chunk]
                wlen = quant.wire_count(cnt, qp.block)
                woff = recv_base + wi * max_wire
                table.append([
                    OP_POST_RECV, my_team_word,
                    (op.slot << 32) | (ctx_of[op.peer] & 0xFFFFFFFF),
                    0, REG_SCRATCH, woff, 0, wlen])
                table.append([OP_DECODE, 0, 0, 0, 0, coff, woff, wlen])
                post_flag = True
                if op.kind == OpKind.RECV:
                    assist.post.append(("dec", coff, woff, wlen, cnt))
                else:
                    assist.post.append(("redq", coff, woff, wlen, cnt))
            for op in copies:
                doff, cnt = bounds[op.chunk]
                soff = bounds[op.src_chunk][0]
                table.append([
                    OP_COPY, 0, 0, 0,
                    REG_USER | (REG_USER << 4),
                    doff, soff, cnt * esz])
                assist.post.append(("copy", doff, soff, cnt))

        flags = (FLAG_PRE_ASSIST if pre_flag else 0) | \
                (FLAG_POST_ASSIST if post_flag else 0)
        table.append([OP_WAIT_ROUND | (flags << 8), 0, 0, 0, 0, 0, 0, 0])
        if pre_flag or post_flag:
            out.assists[rnd] = assist
            out.any_assist = True
        out.round_bytes.append(rbytes)
    out.n_rounds = len(rounds)
    return out


# ---------------------------------------------------------------------------
# the plan object
# ---------------------------------------------------------------------------

class PlanError(RuntimeError):
    pass


class NativePlan:
    """One built plan: C handle + mapped state word + assist executor.

    NOT thread-safe across concurrent posts — a plan serves one
    collective at a time (the cache hands concurrent tasks separate
    instances)."""

    def __init__(self, team, subset, program: Program, count: int,
                 nd: np.dtype, rop: ReductionOp, qp=None, dt=None):
        from .. import native
        from ..constants import dt_from_numpy
        from ..mc.pool import ScratchLease, host_pool
        lib = native.get_lib()
        if lib is None:
            raise PlanError("native core unavailable")
        peers = _peer_mailboxes(team, subset, program.nranks)
        if peers is None:
            raise PlanError("peer endpoints are not native-matched")
        mine, my_ctx, ctx_of, boxes = peers
        grank = subset.myrank
        tkey = team.team_key
        epoch = int(team.team_epoch) & 0xFFFFFFFF
        my_word = (mine.team_id(tkey) << 32) | epoch
        peer_word = [(boxes[ctx_of[g]].team_id(tkey) << 32) | epoch
                     for g in range(program.nranks)]
        low = lower(program, grank, count, nd, rop, my_ctx, ctx_of,
                    my_word, peer_word, qp=qp)
        self.lib = lib
        self.mb = mine
        self.program = program
        self.count = int(count)
        self.nd = nd
        #: the payload's DataType (bfloat16 is uint16 storage here, so the
        #: numpy dtype alone cannot name it)
        self.dt = dt if dt is not None else dt_from_numpy(nd)
        self.rop = rop
        self.qp = qp
        self.low = low
        self.n_rounds = low.n_rounds
        #: peer NativeMailbox objects, kept for the dirty-teardown
        #: keepalive pin (see destroy): a canceled/errored plan may have
        #: parked zero-copy sends (raw pointers into scratch / user dst)
        #: in these mailboxes' C unexpected queues with no per-entry
        #: python ref
        self._peer_boxes = [boxes[ctx_of[g]]
                            for g in range(program.nranks)]
        self._dst: Optional[np.ndarray] = None
        # plan-lifetime scratch lease: offsets are baked into the op
        # table, so the buffer must stay put until the plan dies
        self._lease = ScratchLease(host_pool())
        self._scratch = self._lease.get("plan", low.scratch_bytes,
                                        torch.uint8).numpy()
        ops = np.asarray(low.ops, dtype=np.uint64)
        assert ops.shape[1] == PLAN_OP_WORDS
        ops = np.ascontiguousarray(ops)
        n_peers = program.nranks
        peer_arr = (ctypes.c_void_p * n_peers)(
            *[boxes[ctx_of[g]].ptr for g in range(n_peers)])
        out = (ctypes.c_uint64 * 2)()
        ptr = lib.ucc_plan_build(
            mine.ptr, n_peers, peer_arr, ops.shape[0],
            ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            self._scratch.ctypes.data, team.transport.EAGER_THRESHOLD,
            out)
        if not ptr:
            raise PlanError("ucc_plan_build rejected the op table")
        self.ptr = ptr
        self.state_rid = int(out[0])
        self._state_idx = self.state_rid & _IDX_MASK
        self._state_gen = self.state_rid >> _SLOT_BITS
        self._ctr = (ctypes.c_uint64 * 8).from_address(int(out[1]))
        self._pub = mine._pub
        self._confirmed = False
        self._clean = True
        # backstop: parks the C plan if the python side is GC'd without
        # an explicit destroy (team teardown drops the cache)
        self._finalizer = weakref.finalize(
            self, lib.ucc_plan_destroy, ptr)

    # -- per-post lifecycle --------------------------------------------
    def post(self, dst: np.ndarray, tag: int) -> int:
        """One ffi crossing: run the collective. *dst* is the typed
        user vector (region-0 base); *tag* the per-post collective
        tag."""
        if not dst.flags["C_CONTIGUOUS"] or not dst.flags["WRITEABLE"]:
            return -3
        self._dst = dst             # pinned until terminal state
        self._confirmed = False
        return int(self.lib.ucc_plan_post(self.ptr, dst.ctypes.data,
                                          int(tag)))

    def poll(self) -> Tuple[int, int]:
        """(state, payload) from the mapped plan word — a memory load.
        Terminal and assist states are confirmed through one
        acquire-ordered ffi load before the caller may touch delivered
        data (the NativeRecvReq.test discipline)."""
        pub = self._pub
        if pub is None:
            return ST_DEAD, 0
        v = pub[self._state_idx]
        if (v >> 32) != self._state_gen:
            return ST_DEAD, 0
        st = v & 7
        if st == ST_RUNNING:
            return ST_RUNNING, 0
        if not self._confirmed:
            ptr = self.mb.ptr
            if ptr is not None:
                v = int(self.lib.ucc_req_poll(ptr, self.state_rid))
                if v == 0:
                    return ST_RUNNING, 0
            if st != ST_ASSIST:
                self._confirmed = True
            st = v & 7
        return int(st), int((v >> 3) & _NB_MASK)

    def run_assist(self, payload: int) -> None:
        """Execute the flagged assist phase for the round the plan
        paused on, then resume C-side advancement."""
        rnd = payload >> 1
        phase_post = bool(payload & 1)
        a = self.low.assists.get(rnd)
        dst = self._dst
        if a is not None and dst is not None:
            scr = self._scratch
            if phase_post:
                self._assist_post(a, dst, scr)
            else:
                self._assist_pre(a, dst, scr)
        self.lib.ucc_plan_assist_done(self.ptr)

    def _assist_pre(self, a: _AssistOps, dst, scr) -> None:
        qp = self.qp
        for op in a.pre:
            _, coff, cnt, woff, wlen = op
            src = dst[coff // self.nd.itemsize:][:cnt]
            w = scr[woff:woff + wlen]
            qp.codec.encode(src, w, qp.block)
            # sender-side re-decode: receivers hold decode(wire), so the
            # sender must too or ranks disagree bitwise on this slice
            qp.codec.decode(w, cnt, qp.block, src)

    def _assist_post(self, a: _AssistOps, dst, scr) -> None:
        from ..constants import DataType
        from ..ec.cpu import reduce_arrays
        esz = self.nd.itemsize
        red = ReductionOp.SUM if self.rop == ReductionOp.AVG else self.rop
        qp = self.qp
        for op in a.post:
            kind = op[0]
            if kind == "red":
                _, coff, soff, cnt = op
                acc = dst[coff // esz:][:cnt]
                tmp = scr[soff:soff + cnt * esz].view(self.nd)
                reduce_arrays([acc, tmp], red, self.dt, out=acc)
            elif kind == "copy":
                _, doff, soff, cnt = op
                dst[doff // esz:][:cnt] = dst[soff // esz:][:cnt]
            elif kind == "dec":
                _, coff, woff, wlen, cnt = op
                qp.codec.decode(scr[woff:woff + wlen], cnt, qp.block,
                                dst[coff // esz:][:cnt])
            else:   # "redq"
                _, coff, woff, wlen, cnt = op
                tmp = np.empty(cnt, np.float32)
                qp.codec.decode(scr[woff:woff + wlen], cnt, qp.block, tmp)
                acc = dst[coff // esz:][:cnt]
                reduce_arrays([acc, tmp], ReductionOp.SUM,
                              DataType.FLOAT32, out=acc)

    def test(self) -> int:
        """ffi fallback nudge (stall recovery): re-checks completions."""
        return int(self.lib.ucc_plan_test(self.ptr))

    def cancel(self) -> int:
        """Withdraw posted recvs; returns how many were withdrawn."""
        self._clean = False
        return int(self.lib.ucc_plan_cancel(self.ptr))

    def counters(self) -> Dict[str, int]:
        c = self._ctr
        return {"direct": int(c[0]), "eager": int(c[1]),
                "rndv": int(c[2]), "fenced": int(c[3]),
                "rounds": int(c[4]), "withdrawn": int(c[5]),
                "corrupt": int(c[6]),
                # first corrupt sender's ctx rank (C stores rank+1 so
                # zero means "none")
                "corrupt_src": int(c[7]) - 1}

    def release_dst(self) -> None:
        self._dst = None

    def destroy(self, clean: Optional[bool] = None) -> None:
        """Retire the plan (parked C-side, idempotent). A cleanly-idle
        plan's scratch returns to the pool; a canceled/errored one may
        have parked zero-copy rndv sends — raw pointers into scratch or
        the user dst — in peer mailboxes' C unexpected queues, so those
        buffers are PINNED on the peer mailboxes (released at their
        purge/destroy, exactly when the C entries die) and the lease is
        dropped instead of recycled (the scratch-taint rule of
        ``tl/host/task.py``). The Python matcher gets the same lifetime
        from Mailbox._send_keep; plan pushes happen in C, so the pin is
        the coarse equivalent."""
        if clean is not None:
            self._clean = self._clean and clean
        if not self._clean:
            dst = self._dst
            for box in self._peer_boxes:
                try:
                    box.pin(self._scratch)
                    if dst is not None:
                        box.pin(dst)
                except Exception:  # noqa: BLE001 - box already torn down
                    pass
        self._finalizer()
        lease, self._lease = self._lease, None
        if lease is not None and self._clean:
            lease.release()
        self._dst = None


# ---------------------------------------------------------------------------
# per-team plan cache
# ---------------------------------------------------------------------------

_CACHE_LOCK = threading.Lock()


def _cache(team) -> Dict:
    c = team.__dict__.get("_plan_cache")
    if c is None:
        c = team.__dict__["_plan_cache"] = {}
    return c


def _subset_sig(subset, nranks: int, team) -> tuple:
    return (subset.myrank,
            tuple(team._peer_ctx_rank(subset, g) for g in range(nranks)))


def acquire(task, team, program: Program) -> Optional["NativePlan"]:
    """Check a plan out of the team cache (or build one) for *task*;
    None when plan mode does not resolve for this (program, dtype, op).
    Plans are keyed per (program, team epoch via team identity, dtype,
    count) — two counts NEVER share a plan (offsets are count-exact), so
    a recycled scratch lease cannot alias across a count boundary."""
    if native_mode(team) == "y":
        _require_core()
    if not resolve(task, team, program):
        return None
    nd = storage_dtype(task.dt)
    sig = _subset_sig(task.subset, program.nranks, team)
    key = (program.name, program.param_str, int(task.count), nd.str,
           int(task.op), sig)
    with _CACHE_LOCK:
        lst = _cache(team).get(key)
        if lst:
            return lst.pop()
    try:
        plan = NativePlan(team, task.subset, program, task.count, nd,
                          task.op, qp=task.qp, dt=task.dt)
    except PlanError as e:
        if native_mode(team) == "y":
            raise UccError(Status.ERR_NO_RESOURCE,
                           f"UCC_GEN_NATIVE=y but the plan of "
                           f"{program.name} could not be built: {e}")
        logger.debug("dsl: plan build fell back to the interpreter "
                     "for %s: %s", program.name, e)
        return None
    plan._cache_key = key
    return plan


def release(team, plan: "NativePlan", clean: bool) -> None:
    """Return a checked-out plan. Clean plans re-enter the cache;
    dirty (canceled/errored) ones are destroyed with their lease
    dropped."""
    key = getattr(plan, "_cache_key", None)
    if not clean or key is None:
        plan.destroy(clean=False)
        return
    plan.release_dst()
    with _CACHE_LOCK:
        _cache(team).setdefault(key, []).append(plan)


# ---------------------------------------------------------------------------
# hand-written algorithm bridge (tl/host/ring.py, tl/host/sra.py)
# ---------------------------------------------------------------------------

def handwritten_plan_task(init_args, team, family: str,
                          subset=None, radix: Optional[int] = None):
    """Run a hand-written allreduce as a native plan: generate its IR
    (``ring`` -> the classic 1-chunk ring; ``sra`` -> radix-r recursive
    halving with the extra/proxy fold), verify it like any family, and
    execute it through :class:`~.compile.GeneratedCollTask` in plan
    mode. Returns the task, or None to fall back to the classic
    generator implementation (knob off, native unavailable, unsupported
    dtype/op/count, verification failure)."""
    from .compile import GeneratedCollTask

    mode = native_mode(team)
    if mode == "y":
        _require_core()
    if mode == "n" or not team_plan_capable(team):
        return None
    sub = subset or team.full_subset()
    n = sub.size
    if n < 2:
        return None
    from .registry import MAX_GEN_RANKS
    if n > MAX_GEN_RANKS:
        return None
    prog = _bridge_program(family, n, radix)
    if prog is None:
        return None
    if not _args_plan_eligible(team, prog, init_args):
        # cheap pre-filter on (dtype, op, count, fault spec): avoids
        # constructing-and-discarding a GeneratedCollTask per collective
        # on the latency path when plans cannot engage anyway
        return None
    try:
        task = GeneratedCollTask(init_args, team, prog, subset=sub)
    except UccError as e:
        if e.status == Status.ERR_NO_RESOURCE:
            raise                   # UCC_GEN_NATIVE=y: the plan failed
        return None                 # dtype/op/count outside plan support
    # task._plan may be None here — a RANK-LOCAL acquire failure (peer
    # address not yet resolvable, pool/slot exhaustion, build rejection).
    # Every deterministic, rank-invariant reason to skip plans was
    # filtered above, so peers may already be running the PLAN of this
    # same program: return the task anyway (interpreted execution of
    # the identical IR is wire-compatible with peer plans — same slots,
    # same rounds), NEVER the classic generator task, whose slot scheme
    # differs and would deadlock the collective one rank at a time.
    return task


def _args_plan_eligible(team, program: Program, init_args) -> bool:
    """The dtype/op/count part of :func:`resolve`, computable straight
    from the init args — run BEFORE building a task."""
    args = init_args.args
    op = args.op if args.op is not None else ReductionOp.SUM
    if op not in (ReductionOp.SUM, ReductionOp.AVG, ReductionOp.PROD,
                  ReductionOp.MAX, ReductionOp.MIN):
        return False
    if _fault_blocks_plans(team, invariant=True):
        return False
    try:
        nd = storage_dtype(args.dst.datatype)
        count = int(args.dst.count)
    except Exception:  # noqa: BLE001 - exotic dtype/buffer: classic path
        return False
    if count < program.nchunks:
        return False
    if native_mode(team) == "auto" and \
            (program.wire or nd not in _DT_NATIVE):
        return False
    if program.wire and nd != np.dtype(np.float32):
        return False
    return True


def stale_fence_probe(transport, team_key) -> Optional[bool]:
    """Post a ONE-OP native plan keyed to epoch 0 of *team_key* on
    *transport*'s own mailbox: after a rank-failure shrink has fenced
    the old epoch, the plan's send must be discarded at the match
    boundary (the C push returns fenced and the plan counts it) — the
    native-plan form of the stale-send fence probe, proving a
    pre-shrink plan's late sends can never land in a post-shrink
    buffer. Returns True/False (fenced or not), or None when the
    native core is not serving this endpoint. Counted into the
    endpoint's ``n_fenced`` like any other fenced send. On a team that
    was never fenced the probe's send is delivered, and it returns
    False."""
    from .. import native
    lib = native.get_lib()
    nb = getattr(transport, "native", None)
    if lib is None or nb is None or nb.ptr is None:
        return None
    tid = nb.team_id(team_key)
    ops = np.zeros((2, PLAN_OP_WORDS), np.uint64)
    # one 8-byte send to myself in the pre-shrink (epoch 0) tag space
    ops[0] = [OP_POST_SEND, (tid << 32) | 0, (999 << 32), 0,
              REG_USER, 0, 0, 8]
    ops[1] = [OP_WAIT_ROUND, 0, 0, 0, 0, 0, 0, 0]
    peer = (ctypes.c_void_p * 1)(nb.ptr)
    out = (ctypes.c_uint64 * 2)()
    scratch = np.zeros(8, np.uint8)
    plan = lib.ucc_plan_build(
        nb.ptr, 1, peer, 2,
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        scratch.ctypes.data, 1 << 20, out)
    if not plan:
        return None
    buf = np.zeros(1, np.float64)
    try:
        lib.ucc_plan_post(plan, buf.ctypes.data, (1 << 20) + 7)
        # the single round has no recvs: the post retires it inline
        ctr = (ctypes.c_uint64 * 8).from_address(int(out[1]))
        fenced = int(ctr[3]) > 0
        if fenced:
            transport.n_fenced += 1
        return fenced
    finally:
        lib.ucc_plan_destroy(plan)


#: verified bridge programs, cached process-wide like registry._CACHE
_BRIDGE_CACHE: Dict[tuple, Optional[Program]] = {}


def _bridge_program(family: str, n: int,
                    radix: Optional[int]) -> Optional[Program]:
    from . import families as fam
    from .verify import VerifyError, verify
    key = (family, n, int(radix or 0))
    if key in _BRIDGE_CACHE:
        return _BRIDGE_CACHE[key]
    prog: Optional[Program] = None
    try:
        if family == "ring":
            prog = fam.gen_ring(n, chunks=1)
        elif family == "sra":
            prog = fam.gen_sra(n, radix=int(radix or 2))
        else:
            raise fam.Inapplicable(f"no bridge family '{family}'")
        verify(prog)
    except fam.Inapplicable as e:
        logger.debug("dsl: %s bridge inapplicable at n=%d: %s",
                     family, n, e)
        prog = None
    except VerifyError as e:
        logger.error("dsl: hand-written %s bridge program n=%d REJECTED "
                     "by the verifier: %s", family, n, e)
        prog = None
    _BRIDGE_CACHE[key] = prog
    return prog
