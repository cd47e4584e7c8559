"""TL/TORCH_OPS — the default device TL for ALLREDUCE and BCAST (the
counterpart of the JAX package's tl/xla for these two collectives).

Where tl/xla runs one ``lax`` collective over the mesh, this TL runs
PyTorch library ops over the buffers of every rank of an in-process team,
on the team's stream (the rendezvous and launch plumbing is tl/device):

- ``xla`` (id 0; the reference's name, so TUNE strings and score rows
  carry over with only the TL name mapped): ALLREDUCE as one reduction
  over the stacked ranks (SUM, AVG of floating types, MAX, MIN, PROD;
  tl/xla's AVG of an integer type returns floats, which the caller's
  integer dst cannot hold, so that one falls to tl/ring_cuda's truncated
  mean), BCAST as the root's
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


def allreduce_ops(srcs, op: ReductionOp) -> torch.Tensor:
    """One reduction over the stacked ranks, in the buffers' dtype
    (integers wrap)."""
    stack = torch.stack([s.reshape(-1) for s in srcs])
    if op in (ReductionOp.SUM, ReductionOp.AVG):
        out = stack.sum(0)
        if op == ReductionOp.AVG:              # floating types only
            out = kc.divide(out, len(srcs))
    elif op == ReductionOp.MAX:
        out = stack.amax(0)
    elif op == ReductionOp.MIN:
        out = stack.amin(0)
    else:
        out = stack.prod(0)
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
        if self.coll == CollType.ALLREDUCE and self.op not in kc.OPS:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/torch_ops does not implement op {self.op}")
        if self.dtype not in kc.SUPPORTED_DTYPES:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/torch_ops does not implement {self.dtype}")
        if self.op == ReductionOp.AVG and self.coll == CollType.ALLREDUCE \
                and not self.dtype.is_floating_point:
            # tl/xla's pmean of an integer type is a float array, which an
            # integer dst cannot hold: tl/ring_cuda's truncated mean serves
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "tl/torch_ops takes AVG of floating types only")

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
