"""TL/TORCH_OPS — the default device TL for ALLREDUCE and BCAST (the
counterpart of the JAX package's tl/xla for these two collectives).

Where tl/xla runs one ``lax`` collective over the mesh, this TL runs
PyTorch library ops over the buffers of every rank of an in-process team,
on the team's stream (the rendezvous and launch plumbing is tl/device):

- ``xla`` (id 0; the reference's name, so TUNE strings and score rows
  carry over with only the TL name mapped): ALLREDUCE as one reduction
  over the stacked ranks, every op with the meaning of the reference's
  ``ops.allreduce`` (SUM, AVG of floating types, MAX, MIN, PROD; LAND,
  LOR and LXOR as 0/1 in the dtype; BAND, BOR and BXOR on integer types;
  MINLOC and MAXLOC on interleaved (value, index) pairs, an even count,
  ties to the lowest index). tl/xla's AVG of an integer type returns
  floats, which the caller's integer dst cannot hold, so that one falls to
  tl/ring_cuda's truncated mean; a bitwise op on a floating type and a loc
  op on an odd count fail at run time in the reference and are refused
  here at init. BCAST as the root's
  buffer plus zero into every rank, as the reference's masked psum (a
  -0.0 at the root arrives as +0.0 everywhere). They need no kernel of
  their own.
- ``gen_dev_*`` (ids 200+, score 2, behind ``UCC_GEN_DEVICE=y``): verified
  DSL programs lowered by ``dsl/lower_device`` and run by the kernels of
  ``kernels/gen_device.py`` (exact plans by the flag-free fold kernel,
  plans with wire layers by the layer kernel).

Default score 40, as tl/xla's, above tl/ring_cuda's 20: ALLREDUCE and BCAST
on CUDA memory select this TL unless a TUNE string says otherwise, e.g.
``UCC_TL_TORCH_OPS_TUNE=allreduce:@gen_dev_rhd_r2:inf`` or
``UCC_TL_RING_CUDA_TUNE=allreduce:@ring_cuda:inf``. Its device is the one
every device TL reads (tl/device's ``DEVICE_CONFIG``,
``UCC_TL_RING_CUDA_DEVICE``): ``cuda`` raises at context creation without
a GPU, ``cpu`` runs everything on the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..constants import CollType, MemoryType, ReductionOp
from ..core.components import BaseLib, TransportLayer, register_tl
from ..dsl import lower_device as ld
from ..dsl.ir import Program
from ..kernels import ring_common as kc
from ..kernels.ring_common import RingLaunch
from ..score.score import CollScore
from ..status import Status, UccError
from .base import AlgSpec, build_scores
from .device import (DEVICE_CONFIG, DeviceCollTask, TlDeviceContext,
                     TlDeviceTeam)

_COLLS = (CollType.ALLREDUCE, CollType.BCAST)


#: BAND, BOR, BXOR: a left fold over ranks 0..n-1, on integer types
_BITWISE = {ReductionOp.BAND: torch.bitwise_and,
            ReductionOp.BOR: torch.bitwise_or,
            ReductionOp.BXOR: torch.bitwise_xor}
#: interleaved (value, index) pairs
_LOC = (ReductionOp.MINLOC, ReductionOp.MAXLOC)


def _loc(stack: torch.Tensor, op: ReductionOp) -> torch.Tensor:
    """MINLOC / MAXLOC over the ranks of (value, index) pairs, even
    elements the values and odd ones the indices: the value of the first
    rank whose value is least (most), a NaN before any number, as the
    reference's argmin (argmax); its index the lowest index among the
    ranks whose value equals it (none for a NaN: then the dtype's infinity
    or largest integer, as the reference's)."""
    vals, idxs = stack[:, 0::2], stack[:, 1::2]
    sel = vals[0]
    for v in vals[1:]:
        better = v < sel if op == ReductionOp.MINLOC else v > sel
        if stack.dtype.is_floating_point:
            better |= v.isnan() & ~sel.isnan()
        sel = torch.where(better, v, sel)
    big = float("inf") if stack.dtype.is_floating_point else \
        torch.iinfo(stack.dtype).max
    out = torch.empty_like(stack[0])
    out[0::2] = sel
    out[1::2] = torch.where(vals == sel, idxs,
                            torch.full_like(idxs, big)).amin(0)
    return out


def allreduce_ops(srcs, op: ReductionOp) -> torch.Tensor:
    """One reduction over the stacked ranks, in the buffers' dtype
    (integers wrap), with the meaning of the reference's
    ``ops.allreduce`` for every op."""
    stack = torch.stack([s.reshape(-1) for s in srcs])
    if op in (ReductionOp.SUM, ReductionOp.AVG):
        out = stack.sum(0)
        if op == ReductionOp.AVG:              # floating types only
            out = kc.divide(out, len(srcs))
    elif op == ReductionOp.MAX:
        out = stack.amax(0)
    elif op == ReductionOp.MIN:
        out = stack.amin(0)
    elif op == ReductionOp.PROD:
        out = stack.prod(0)
    elif op == ReductionOp.LAND:
        out = (stack != 0).all(0)
    elif op == ReductionOp.LOR:
        out = (stack != 0).any(0)
    elif op == ReductionOp.LXOR:
        out = (stack != 0).sum(0) % 2
    elif op in _BITWISE:                       # integer types only
        out = stack[0]
        for x in stack[1:]:
            out = _BITWISE[op](out, x)
    else:                                      # MINLOC, MAXLOC; even count
        out = _loc(stack, op)
    return out.to(stack.dtype)


def bcast_ops(srcs, root: int) -> torch.Tensor:
    """The root's buffer plus zero: the masked psum's result."""
    src = srcs[root].reshape(-1)
    return src + 0 if src.dtype.is_floating_point else src


def _run(stream, srcs, dsts, compute) -> RingLaunch:
    if srcs[0].device.type != "cuda":
        out = compute()
        for d in dsts:
            d.copy_(out)
        return RingLaunch()
    with torch.cuda.device(srcs[0].device), torch.cuda.stream(stream):
        out = compute()
        for d in dsts:
            d.copy_(out)
    return RingLaunch(stream, keep=(out,), what="torch ops")


def xla_allreduce(srcs, dsts, op, *, root=0, stream=None, workspace=None,
                  ptr_table=None) -> RingLaunch:
    return _run(stream, srcs, dsts, lambda: allreduce_ops(srcs, op))


def xla_bcast(srcs, dsts, op=None, *, root=0, stream=None, workspace=None,
              ptr_table=None) -> RingLaunch:
    return _run(stream, srcs, dsts, lambda: bcast_ops(srcs, root))


class TorchOpsCollTask(DeviceCollTask):
    """Rendezvous/dispatch of tl/device; the launched program is PyTorch
    library ops (``xla``) or, in the subclass below, a generated
    program."""

    def __init__(self, init_args, team, alg: str = "xla"):
        self.alg = alg
        super().__init__(init_args, team)

    def validate(self) -> None:
        if self.coll not in _COLLS:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/torch_ops does not implement {self.coll}")
        if self.coll == CollType.ALLREDUCE and self.op not in ReductionOp:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/torch_ops does not implement op {self.op}")
        if self.dtype not in kc.SUPPORTED_DTYPES:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/torch_ops does not implement {self.dtype}")
        if self.coll != CollType.ALLREDUCE:
            return
        floating = self.dtype.is_floating_point
        if self.op == ReductionOp.AVG and not floating:
            # tl/xla's pmean of an integer type is a float array, which an
            # integer dst cannot hold: tl/ring_cuda's truncated mean serves
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "tl/torch_ops takes AVG of floating types only")
        if self.op in _BITWISE and floating:
            # the reference's jnp.bitwise_* raise on floats at run time
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/torch_ops takes {self.op.name} of integer "
                           "types only")
        bi = self.args.src if self.args.src is not None else self.args.dst
        if self.op in _LOC and int(bi.count) % 2:
            # an odd count has one value more than indices: the
            # reference's g[..., 0::2] and g[..., 1::2] do not pair up
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/torch_ops takes {self.op.name} of an even "
                           f"count of (value, index) pairs, not {bi.count}")

    def build_program(self, shared):
        return xla_allreduce if self.coll == CollType.ALLREDUCE \
            else xla_bcast


class GenDeviceCollTask(TorchOpsCollTask):
    """One rank's view of a lowered device collective: the launched
    program is generated from the verified IR (dsl/lower_device)."""

    def __init__(self, init_args, team, program: Program, backend: str):
        self.prog = program
        self._backend = backend
        self.qp = None
        self._qmode = program.wire or program.edge_wire_mode
        super().__init__(init_args, team, alg=ld.dev_alg_name(program))

    def validate(self) -> None:
        bi = self.args.src if self.args.src is not None else self.args.dst
        self.qp = ld.device_eligibility(self.prog, self.tl_team, self.coll,
                                        self.op, self.dtype, int(bi.count))

    def build_program(self, shared):
        qblock = self.qp.block if self.qp is not None else 256
        key = ("gen_dev", self.prog.name, self.prog.param_str,
               self._backend, self.coll, self.op, self.dtype,
               self.src_count, self.root, qblock)
        program = shared.programs.get(key)
        if program is None:
            program = shared.programs[key] = ld.build_device_program(
                self.prog, len(shared.devices), self.src_count,
                self.root, self._backend, qblock, self._qmode)
        return program


class TlTorchOpsTeam(TlDeviceTeam):
    NAME = "torch_ops"
    TL_CLS: Any = None

    def alg_table(self) -> Dict[CollType, List[AlgSpec]]:
        def init(ia, team):
            return TorchOpsCollTask(ia, self)
        table = {coll: [AlgSpec(0, "xla", init)] for coll in _COLLS}
        # generated-device candidates, behind UCC_GEN_DEVICE: off keeps
        # the lists unchanged
        backend = ld.device_backend(self)
        for p in ld.registered_device_programs(self):
            def gen_init(ia, team, _p=p):
                return GenDeviceCollTask(ia, self, _p, backend)
            rows = table[p.coll]
            rows.append(AlgSpec(
                ld.GEN_DEV_ALG_ID_BASE + len(rows) - 1, ld.dev_alg_name(p),
                gen_init,
                # low default score: TUNE-addressable, never the default
                default_select="0-inf:2",
                precision=p.wire or p.edge_wire_mode,
                origin="generated-device", gen=p.param_str))
        return table

    def get_scores(self) -> CollScore:
        return build_scores(self, TlTorchOps.DEFAULT_SCORE, self.alg_table(),
                            TlTorchOps.SUPPORTED_MEM_TYPES,
                            tune_env="UCC_TL_TORCH_OPS_TUNE")


@register_tl
class TlTorchOps(TransportLayer):
    """Library ops over the ranks of one device, and the generated device
    collectives."""

    NAME = "torch_ops"
    DEFAULT_SCORE = 40
    SUPPORTED_COLLS = CollType.ALLREDUCE | CollType.BCAST
    SUPPORTED_MEM_TYPES = (MemoryType.CUDA,)
    SERVICE_CAPABLE = False
    CONTEXT_CONFIG = DEVICE_CONFIG
    lib_cls = BaseLib
    context_cls = TlDeviceContext
    team_cls = TlTorchOpsTeam


TlTorchOpsTeam.TL_CLS = TlTorchOps
