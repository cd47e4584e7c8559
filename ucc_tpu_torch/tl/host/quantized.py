"""Quantized host collectives — block-scaled low-precision wire formats
(the port of the JAX package's ``tl/host/quantized.py``).

Payloads are encoded block-scaled int8/fp8 (``quant/codec.py``) right
before the send and decoded (then accumulated through
``reduce_arrays(out=)``) on receive, shrinking wire bytes 2-4x. All wire
and dequantize scratch is leased from the mc pool, so the steady state of
a persistent quantized collective allocates nothing; cancellation and the
lease taint of ``HostCollTask`` apply unchanged.

Three variants, registered as ordinary candidates (``team.py``) when
``UCC_QUANT`` selects a precision:

- ``q<mode>_sra`` allreduce: a direct quantized reduce-scatter (rank p
  receives block p of every rank, quantized once) and a direct quantized
  allgather of the reduced blocks: (n + 1) half-steps of error at most.
- ``q<mode>_ring`` allreduce: the bandwidth ring with quantized hops; the
  reduce-scatter re-quantizes the partial sum every hop (~2n half-steps),
  the allgather forwards the received wire bytes as they came.
- ``q<mode>_linear`` allgather: one encode of the local block, a direct
  exchange, a decode on receive.

Accumulation runs in float32: a bfloat16 payload (its uint16 bits on the
port's host path) is widened into a leased float32 vector and reduced
there, never rounding partial sums through bfloat16. Every rank decodes
its own wire too, so all ranks hold the same bits.
"""
from __future__ import annotations

import numpy as np

from ... import quant
from ...constants import CollType, DataType, ReductionOp
from ...ec.cpu import bf16_to_f32, reduce_arrays
from ...obs import metrics
from ...status import Status, UccError
from ...utils.mathutils import block_count, block_offset
from ..base import binfo_typed
from .task import HostCollTask

_F32 = DataType.FLOAT32

#: slot bases (far above every exact algorithm's round-indexed slots; the
#: ring phases are step-indexed, so the bases stay apart for any team size
#: that runs them)
_SLOT_RS_DIRECT = 2900
_SLOT_AG_DIRECT = 2901
_SLOT_AG_LINEAR = 2950
_SLOT_RING_RS = 3000
_SLOT_RING_AG = 4000


def _widen(dst: np.ndarray, src: np.ndarray) -> None:
    """*src* (float32, or bfloat16 bits) into the float32 *dst*."""
    dst[:] = bf16_to_f32(src) if src.dtype == np.uint16 else src


class _QuantCollTask(HostCollTask):
    """Shared policy resolution + encode/decode helpers."""

    VARIANT = "direct"

    def __init__(self, init_args, team, subset=None):
        super().__init__(init_args, team, subset)
        args = init_args.args
        coll = args.coll_type
        self.qp = quant.params_for(team, coll)
        if self.qp is None:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "quantized collectives disabled (UCC_QUANT)")
        bi = args.src if args.src is not None and not args.is_inplace \
            else args.dst
        self.dt = bi.datatype
        if self.dt not in quant.QUANT_DTS:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"quantized wire format needs a float payload "
                           f"(got {self.dt})")
        if coll == CollType.ALLREDUCE:
            op = args.op if args.op is not None else ReductionOp.SUM
            if op not in (ReductionOp.SUM, ReductionOp.AVG):
                raise UccError(Status.ERR_NOT_SUPPORTED,
                               f"quantized allreduce supports SUM/AVG "
                               f"(got {op.name})")
            self.op = op
        # the error budget gates eligibility: a refused candidate raises
        # NOT_SUPPORTED and the fallback walk lands on an exact algorithm
        if not quant.admits(self.qp, coll, self.gsize, self.VARIANT):
            raise UccError(
                Status.ERR_NOT_SUPPORTED,
                f"quantized {self.qp.mode} predicted error "
                f"{quant.predicted_error(self.qp.codec, coll, self.gsize, self.VARIANT):.4f}"
                f" exceeds error budget {self.qp.budget:.4f}")
        self._rng = None
        self._q_err = 0.0

    # ------------------------------------------------------------------
    def _encode(self, src_view: np.ndarray, wire: np.ndarray) -> None:
        qp = self.qp
        if qp.stochastic and self._rng is None:
            self._rng = np.random.default_rng()
        qp.codec.encode(src_view, wire, qp.block,
                        stochastic=qp.stochastic, rng=self._rng)
        if metrics.ENABLED:
            coll, alg = self._obs_names()
            metrics.inc("quant_bytes_saved",
                        int(src_view.nbytes) - int(wire.size),
                        component="tl/host", coll=coll, alg=alg)
            err = qp.codec.roundtrip_max_err(src_view, wire, qp.block)
            if err > self._q_err:
                self._q_err = err
                metrics.gauge("quant_max_abs_err", err,
                              component="tl/host", coll=coll, alg=alg)

    def _decode(self, wire: np.ndarray, count: int,
                out: np.ndarray) -> None:
        self.qp.codec.decode(wire, count, self.qp.block, out)

    def _wire_scratch(self, key, count: int) -> np.ndarray:
        return self.scratch(key, quant.wire_count(count, self.qp.block),
                            np.uint8)


def _blk(total: int, size: int, b: int):
    return block_offset(total, size, b), block_count(total, size, b)


class AllreduceQuantSra(_QuantCollTask):
    """Direct (radix = team size) quantized reduce-scatter + allgather."""

    VARIANT = "direct"

    def __init__(self, init_args, team, subset=None):
        super().__init__(init_args, team, subset)
        self.count = int(init_args.args.dst.count)

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        count = self.count
        dst = binfo_typed(args.dst, count)
        if not args.is_inplace:
            dst[:] = binfo_typed(args.src, count)
        if size == 1:
            if self.op == ReductionOp.AVG:
                dst[:] = reduce_arrays([dst], ReductionOp.SUM, self.dt,
                                       alpha=1.0)
            return
        moff, mcnt = _blk(count, size, me)
        # the accumulate runs in f32; an f32 payload's own dst block is
        # the accumulator
        if dst.dtype == np.float32:
            acc = dst[moff:moff + mcnt]
        else:
            acc = self.scratch("acc", max(1, mcnt), np.float32)[:mcnt]
            _widen(acc, dst[moff:moff + mcnt])

        # phase 1: direct quantized reduce-scatter — block p of this
        # rank's (original) vector goes straight to rank p, quantized once
        reqs = []
        recv_wires = {}
        for p in range(size):
            if p == me:
                continue
            off, cnt = _blk(count, size, p)
            if cnt:
                ws = self._wire_scratch(("qs", p), cnt)
                self._encode(dst[off:off + cnt], ws)
                reqs.append(self.send_nb(p, ws, slot=_SLOT_RS_DIRECT))
            if mcnt:
                wr = recv_wires[p] = self._wire_scratch(("qr", p), mcnt)
                reqs.append(self.recv_nb(p, wr, slot=_SLOT_RS_DIRECT))
        yield from self.wait(*reqs)
        if mcnt:
            tmp = self.scratch("deq", mcnt, np.float32)
            for p, wr in recv_wires.items():
                self._decode(wr, mcnt, tmp)
                reduce_arrays([acc, tmp], ReductionOp.SUM, _F32, out=acc)
            if self.op == ReductionOp.AVG:
                np.multiply(acc, 1.0 / size, out=acc)

        # phase 2: direct quantized allgather of the reduced blocks
        reqs = []
        wg = None
        if mcnt:
            wg = self._wire_scratch("qg", mcnt)
            self._encode(acc, wg)
        recv_ag = {}
        for p in range(size):
            if p == me:
                continue
            if mcnt:
                reqs.append(self.send_nb(p, wg, slot=_SLOT_AG_DIRECT))
            off, cnt = _blk(count, size, p)
            if cnt:
                wr = recv_ag[p] = self._wire_scratch(("qag", p), cnt)
                reqs.append(self.recv_nb(p, wr, slot=_SLOT_AG_DIRECT))
        yield from self.wait(*reqs)
        for p, wr in recv_ag.items():
            off, cnt = _blk(count, size, p)
            self._decode(wr, cnt, dst[off:off + cnt])
        if mcnt:
            # decode this rank's own wire too: every rank then holds the
            # same dequantized bits of every block
            self._decode(wg, mcnt, dst[moff:moff + mcnt])


class AllreduceQuantRing(_QuantCollTask):
    """Bandwidth ring with quantized hops; phase 2 forwards wire bytes as
    received (no re-quantization in the allgather)."""

    VARIANT = "ring"

    def __init__(self, init_args, team, subset=None):
        super().__init__(init_args, team, subset)
        self.count = int(init_args.args.dst.count)

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        count = self.count
        dst = binfo_typed(args.dst, count)
        if not args.is_inplace:
            dst[:] = binfo_typed(args.src, count)
        if size == 1:
            if self.op == ReductionOp.AVG:
                dst[:] = reduce_arrays([dst], ReductionOp.SUM, self.dt,
                                       alpha=1.0)
            return
        if dst.dtype == np.float32:
            work = dst
        else:
            work = self.scratch("work", count, np.float32)
            _widen(work, dst)
        right = (me + 1) % size
        left = (me - 1) % size
        max_blk = max(block_count(count, size, b) for b in range(size))
        tmp = self.scratch("deq", max(1, max_blk), np.float32)

        # phase 1: reduce-scatter ring; the partial sum is re-quantized at
        # every hop (the "ring" error model)
        for step in range(size - 1):
            sb = (me - 1 - step) % size
            rb = (me - 2 - step) % size
            soff, scnt = _blk(count, size, sb)
            roff, rcnt = _blk(count, size, rb)
            reqs = []
            if scnt:
                ws = self._wire_scratch(("rs_s", step), scnt)
                self._encode(work[soff:soff + scnt], ws)
                reqs.append(self.send_nb(right, ws,
                                         slot=_SLOT_RING_RS + step))
            if rcnt:
                wr = self._wire_scratch(("rs_r", step), rcnt)
                reqs.append(self.recv_nb(left, wr,
                                         slot=_SLOT_RING_RS + step))
            yield from self.wait(*reqs)
            if rcnt:
                t = tmp[:rcnt]
                self._decode(wr, rcnt, t)
                acc = work[roff:roff + rcnt]
                reduce_arrays([acc, t], ReductionOp.SUM, _F32, out=acc)
        moff, mcnt = _blk(count, size, me)
        if mcnt and self.op == ReductionOp.AVG:
            mine = work[moff:moff + mcnt]
            np.multiply(mine, 1.0 / size, out=mine)

        # phase 2: allgather ring forwarding WIRE bytes — each block is
        # quantized once, by the owner of its reduced segment
        wires = {}
        if mcnt:
            wires[me] = self._wire_scratch(("ag", me), mcnt)
            self._encode(work[moff:moff + mcnt], wires[me])
            self._decode(wires[me], mcnt, dst[moff:moff + mcnt])
        for step in range(size - 1):
            sb = (me - step) % size
            rb = (me - step - 1) % size
            soff, scnt = _blk(count, size, sb)
            roff, rcnt = _blk(count, size, rb)
            reqs = []
            if scnt:
                reqs.append(self.send_nb(right, wires[sb],
                                         slot=_SLOT_RING_AG + step))
            if rcnt:
                wires[rb] = self._wire_scratch(("ag", rb), rcnt)
                reqs.append(self.recv_nb(left, wires[rb],
                                         slot=_SLOT_RING_AG + step))
            yield from self.wait(*reqs)
            if rcnt:
                self._decode(wires[rb], rcnt, dst[roff:roff + rcnt])


class AllgatherQuant(_QuantCollTask):
    """Direct quantized allgather: one encode, n-1 sends, decode on
    receive. Single round-trip error per block."""

    VARIANT = "direct"

    def run(self):
        args = self.args
        size, me = self.gsize, self.grank
        total = int(args.dst.count)
        dst = binfo_typed(args.dst, total)
        moff, mcnt = _blk(total, size, me)
        if not args.is_inplace and mcnt:
            dst[moff:moff + mcnt] = binfo_typed(args.src, mcnt)
        if size == 1:
            return
        reqs = []
        wg = None
        if mcnt:
            wg = self._wire_scratch("qg", mcnt)
            self._encode(dst[moff:moff + mcnt], wg)
        recvs = {}
        for p in range(size):
            if p == me:
                continue
            if mcnt:
                reqs.append(self.send_nb(p, wg, slot=_SLOT_AG_LINEAR))
            off, cnt = _blk(total, size, p)
            if cnt:
                wr = recvs[p] = self._wire_scratch(("qr", p), cnt)
                reqs.append(self.recv_nb(p, wr, slot=_SLOT_AG_LINEAR))
        yield from self.wait(*reqs)
        for p, wr in recvs.items():
            off, cnt = _blk(total, size, p)
            self._decode(wr, cnt, dst[off:off + cnt])
