"""TL/RING_CUDA — ring collectives as hand-written CUDA kernels over the
ranks of one device (the counterpart of the JAX package's tl/ring_dma).

Where tl/ring_dma drives inter-chip remote DMAs from Pallas kernels, this
TL runs every rank of an in-process team on one GPU and launches ONE
kernel over all of their buffers: CTA (r, c) plays rank r on lane slice c,
and a "remote copy" is a store into the right neighbour's receive slot in
global memory followed by a release flag (kernels/ring_allreduce.py,
csrc/ring_allreduce.cu). The rendezvous and launch plumbing is tl/device.

Allreduce routes by count as ``RingDmaCollTask.build_program`` does: up to
``pass_elems(n)`` elements per rank run the one-pass kernel, larger counts
the chunked one. Only ALLREDUCE is ported so far; other collective types
are ERR_NOT_SUPPORTED, so selection falls back to other TLs.

Default score 20 (below an accelerator default TL, as tl/ring_dma); select
it with ``UCC_TL_RING_CUDA_TUNE`` (e.g. ``allreduce:@ring_cuda:inf``) or by
loading it as the only device TL.
"""
from __future__ import annotations

from typing import Any, Dict, List

from ..constants import CollType, MemoryType
from ..core.components import BaseLib, TransportLayer, register_tl
from ..kernels import ring_allreduce as kr
from ..score.score import CollScore
from ..status import Status, UccError
from ..utils.config import (ConfigField, ConfigTable, parse_string,
                            register_table)
from .base import AlgSpec, build_scores
from .device import DeviceCollTask, TlDeviceContext, TlDeviceTeam

TL_RING_CUDA_CONFIG = register_table(ConfigTable(
    prefix="TL_RING_CUDA_", name="tl/ring_cuda", fields=[
        ConfigField("DEVICE", "cuda", "device the ranks' buffers live on: "
                    "cuda[:i] (raises at context creation when there is no "
                    "GPU) or cpu (runs the kernels' plain versions)",
                    parse_string),
    ]))


class RingCudaCollTask(DeviceCollTask):
    """Rendezvous/dispatch of tl/device; the launched program is the CUDA
    ring kernel."""

    def validate(self) -> None:
        if self.coll != CollType.ALLREDUCE:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/ring_cuda does not implement {self.coll} "
                           "yet")
        if self.op not in kr.OPS:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/ring_cuda does not implement op {self.op}")
        if self.dtype not in kr.SUPPORTED_DTYPES:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/ring_cuda does not implement {self.dtype}")

    def build_program(self, shared):
        if self.count > kr.pass_elems(len(shared.devices)):
            # larger than one pass: the chunked kernel
            return kr.ring_allreduce_chunked
        return kr.ring_allreduce_pass


class TlRingCudaTeam(TlDeviceTeam):
    NAME = "ring_cuda"
    TL_CLS: Any = None

    def alg_table(self) -> Dict[CollType, List[AlgSpec]]:
        def init(ia, team):
            return RingCudaCollTask(ia, self)
        return {CollType.ALLREDUCE: [AlgSpec(0, "ring_cuda", init)]}

    def get_scores(self) -> CollScore:
        return build_scores(self, TlRingCuda.DEFAULT_SCORE, self.alg_table(),
                            TlRingCuda.SUPPORTED_MEM_TYPES,
                            tune_env="UCC_TL_RING_CUDA_TUNE")


@register_tl
class TlRingCuda(TransportLayer):
    """Ring transport over the ranks of one GPU: CUDA kernels own the
    schedule at the level of CTA flags."""

    NAME = "ring_cuda"
    DEFAULT_SCORE = 20
    SUPPORTED_COLLS = CollType.ALLREDUCE
    SUPPORTED_MEM_TYPES = (MemoryType.CUDA,)
    SERVICE_CAPABLE = False
    CONTEXT_CONFIG = TL_RING_CUDA_CONFIG
    lib_cls = BaseLib
    context_cls = TlDeviceContext
    team_cls = TlRingCudaTeam


TlRingCudaTeam.TL_CLS = TlRingCuda
