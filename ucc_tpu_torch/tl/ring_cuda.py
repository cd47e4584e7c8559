"""TL/RING_CUDA — ring collectives as hand-written CUDA kernels over the
ranks of one device (the counterpart of the JAX package's tl/ring_dma).

Where tl/ring_dma drives inter-chip remote DMAs from Pallas kernels, this
TL runs the ranks of a team on one GPU and launches ONE kernel over all of
their buffers per process and round, in one pass with no flags: allreduce
and reduce_scatter fold every element from the n srcs in the ring's order
(kernels/ring_allreduce.py, kernels/ring_rs_ag.py); allgather copies each
rank's src into its block of every dst (kernels/ring_rs_ag.py); alltoall
exchanges each pair of ranks' blocks and bcast copies the root's src into
every other dst (kernels/ring_bcast_a2a.py). The sources are under csrc/;
the rendezvous and launch plumbing is tl/device. On a team whose ranks
live in one process the launch covers the whole collective; on a team
that spans P processes of one host (tl/device_sync) process p launches
part p of P of the kernel's walk over the pointers of all n ranks, its
peers' mapped through CUDA IPC, and the parts' union is bitwise the single
launch. ``UCC_TL_RING_CUDA_TUNE=allreduce:@ring_cuda:inf`` then runs the
reference's TUNE-pinned ring allreduce across processes
(``UCC_TL_RING_DMA_TUNE`` in the JAX package). The generated programs of
tl/torch_ops (``gen_dev_*``, kernels/gen_device.py) split the same way
beside these five kernels: a range of elements on the fold route, of whole
qblock groups on the wire fold, and the layer kernel whole in process 0.

Collectives and routing, as ``RingDmaCollTask`` has them: ALLREDUCE,
REDUCE_SCATTER and ALLTOALL take SUM/AVG/MAX/MIN/PROD (an alltoall folds
nothing, but tl/ring_dma refuses the other ops for it all the same);
ALLGATHER and BCAST any op (they have none). Each runs its one-pass kernel up to a per-rank
src count and its chunked kernel above it: ``pass_elems(n)`` for
allreduce, ``n·c > reduce_scatter_pass_elems(n)`` for reduce_scatter,
``c > allgather_pass_elems(n)`` for allgather, and a per-rank total above
``CHUNK_ELEMS`` on more than one rank for bcast and alltoall. A
reduce_scatter or alltoall total not divisible by n is ERR_NOT_SUPPORTED
at init (tl/device), and so is a bcast or alltoall above ``CHUNK_ELEMS``
on a 1-rank team (tl/ring_dma's rule). Other collective types are
ERR_NOT_SUPPORTED, so selection falls back to other TLs.

Default score 20 (below an accelerator default TL, as tl/ring_dma); select
it with ``UCC_TL_RING_CUDA_TUNE`` (e.g. ``allreduce:@ring_cuda:inf``) or by
loading it as the only device TL.
"""
from __future__ import annotations

from typing import Any, Dict, List

from ..constants import CollType, MemoryType
from ..core.components import BaseLib, TransportLayer, register_tl
from ..kernels import ring_allreduce as kr
from ..kernels import ring_bcast_a2a as kba
from ..kernels import ring_common as kc
from ..kernels import ring_rs_ag as krs
from ..score.score import CollScore
from ..status import Status, UccError
from .base import AlgSpec, build_scores
from .device import (DEVICE_CONFIG, DeviceCollTask, TlDeviceContext,
                     TlDeviceTeam)

#: UCC_TL_RING_CUDA_DEVICE, which every device TL reads (tl/device)
TL_RING_CUDA_CONFIG = DEVICE_CONFIG


#: collective -> (per-rank src elements one pass covers, pass kernel,
#: chunked kernel)
_PROGRAMS = {
    CollType.ALLREDUCE: (kr.pass_elems, kr.ring_allreduce_pass,
                         kr.ring_allreduce_chunked),
    CollType.REDUCE_SCATTER: (krs.reduce_scatter_pass_elems,
                              krs.ring_reduce_scatter_pass,
                              krs.ring_reduce_scatter_chunked),
    CollType.ALLGATHER: (krs.allgather_pass_elems, krs.ring_allgather_pass,
                         krs.ring_allgather_chunked),
    CollType.BCAST: (kba.pass_elems, kba.ring_bcast_pass,
                     kba.ring_bcast_chunked),
    CollType.ALLTOALL: (kba.pass_elems, kba.ring_alltoall_pass,
                        kba.ring_alltoall_chunked),
}

#: collectives whose op is not checked (tl/ring_dma's exemption)
_NO_OP = (CollType.ALLGATHER, CollType.BCAST)


class RingCudaCollTask(DeviceCollTask):
    """Rendezvous/dispatch of tl/device; the launched program is a CUDA
    ring kernel."""

    def validate(self) -> None:
        if self.coll not in _PROGRAMS:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/ring_cuda does not implement {self.coll} "
                           "yet")
        if self.coll not in _NO_OP and self.op not in kc.OPS:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/ring_cuda does not implement op {self.op}")
        if self.dtype not in kc.SUPPORTED_DTYPES:
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           f"tl/ring_cuda does not implement {self.dtype}")
        if self.coll in (CollType.BCAST, CollType.ALLTOALL) and \
                self.tl_team.size == 1:
            bi = self.args.dst if self.args.dst is not None else self.args.src
            if int(bi.count) > kba.CHUNK_ELEMS:
                # tl/ring_dma's rule, kept so that both TLs offer the same
                # candidates: on the TPU a 1-rank team has no ring to
                # pipeline over and its whole-vector kernel is bounded by
                # VMEM
                raise UccError(Status.ERR_NOT_SUPPORTED,
                               f"tl/ring_cuda {self.coll} count {bi.count} "
                               f"exceeds {kba.CHUNK_ELEMS} on a 1-rank team")

    def build_program(self, shared):
        pass_elems, one_pass, chunked = _PROGRAMS[self.coll]
        # (a 1-rank bcast or alltoall above one pass was refused at init)
        if self.src_count > pass_elems(len(shared.devices)):
            # larger than one pass: the chunked kernel
            return chunked
        return one_pass


class TlRingCudaTeam(TlDeviceTeam):
    NAME = "ring_cuda"
    TL_CLS: Any = None

    def alg_table(self) -> Dict[CollType, List[AlgSpec]]:
        def init(ia, team):
            return RingCudaCollTask(ia, self)
        return {coll: [AlgSpec(0, "ring_cuda", init)] for coll in _PROGRAMS}

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
    SUPPORTED_COLLS = (CollType.ALLREDUCE | CollType.ALLGATHER |
                       CollType.REDUCE_SCATTER | CollType.BCAST |
                       CollType.ALLTOALL)
    SUPPORTED_MEM_TYPES = (MemoryType.CUDA,)
    SERVICE_CAPABLE = False
    CONTEXT_CONFIG = TL_RING_CUDA_CONFIG
    lib_cls = BaseLib
    context_cls = TlDeviceContext
    team_cls = TlRingCudaTeam


TlRingCudaTeam.TL_CLS = TlRingCuda
