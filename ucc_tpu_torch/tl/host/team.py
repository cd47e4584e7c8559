"""Host TL team (the port of the JAX package's ``tl/host/team.py``; the
role of UCC's ucc_tl_ucp_team).

It owns the p2p endpoints, the per-team collective tags, the algorithm
table with the JAX package's ids, names and default selections, score
construction, active-set subsets, and the three service collectives
(allreduce, allgather, bcast; the core runs the allreduce to agree team
ids and for the datatype check).

The one-sided rows (allreduce ``sliding_window``, alltoall and
alltoallv ``onesided``; ``onesided.py``) sit at score 1, TUNE-only, as in
the JAX package. Left for later slices, with the candidate lists
unchanged where they are off by default: the ``q*`` quantized rows
(UCC_QUANT), the generated candidates (UCC_GEN) and the native-plan
``+plan`` marks (UCC_GEN_NATIVE) come with the compiler's host half; the
rank reorder of multi-node teams (``topo_ordered_subset``) comes with
``topo/``: every team of the port lives on one node, where the JAX
package does not reorder either.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ...api.types import BufferInfo, CollArgs
from ...constants import CollType, MemoryType, ReductionOp, dt_from_numpy
from ...schedule.task import CollTask
from ...score.score import CollScore
from ...utils.ep_map import EpMap, Subset
from ..base import AlgSpec, TlTeamBase, build_scores
from .allgather import (AllgatherBruck, AllgatherKnomial, AllgatherLinear,
                        AllgatherLinearBatched, AllgatherNeighbor,
                        AllgatherSparbit, AllgathervKnomial)
from .alltoall import (AlltoallBruck, AlltoallLinear, AlltoallPairwise,
                       AlltoallvHybrid, AlltoallvPairwise)
from .dbt import AllreduceDbt, BcastDbt, ReduceDbt
from .knomial import (AllreduceKnomial, BarrierKnomial, BcastKnomial,
                      FaninKnomial, FanoutKnomial, GatherLinear,
                      ReduceKnomial, ScatterLinear)
from .knomial2 import (BcastSagKnomial, GatherKnomial, ReduceScatterKnomial,
                       ScatterKnomial)
from .onesided import (AllreduceSlidingWindow, AlltoallOnesided,
                       AlltoallvOnesided)
from .ring import (AllgatherRing, AllgathervRing, ReduceScatterRing,
                   ReduceScatterRingBidirectional, ReduceScattervRing,
                   allreduce_ring_init)
from .sra import sra_pipelined_init, srg_pipelined_init
from .task import HostCollTask


#: knobs the global KN_RADIX override applies to (the JAX package's set:
#: its reduce_scatter/scatter/gather trees are binomial, radix fixed)
_KN_RADIX_GLOBAL = frozenset((
    "barrier_kn_radix", "bcast_kn_radix", "reduce_kn_radix"))


class HostTlTeam(TlTeamBase):
    """Needs a comp_context with ``.transport`` (the endpoint) and
    ``.send_to(ctx_rank, key, data)``."""

    NAME = "host"
    TL_CLS: Any = None

    def __init__(self, comp_context, core_team, scope: str = "cl"):
        super().__init__(comp_context, core_team, scope)
        self.transport = comp_context.transport
        self.ctx_map: EpMap = core_team.ctx_map or EpMap.full(core_team.size)
        self._coll_tag = 0
        self._my_ctx_rank = core_team.context.rank
        #: recovery epoch, stamped into every match key
        self.team_epoch = int(getattr(core_team, "epoch", 0))

    # ------------------------------------------------------------------
    def full_subset(self) -> Subset:
        return Subset(EpMap.full(self.size), self.rank)

    def topo_ordered_subset(self):
        """The host-ordered rank subset of a multi-node team; None (no
        reorder) until the port has ``topo/``: every team of the port is
        on one node."""
        return None

    def next_coll_tag(self) -> int:
        self._coll_tag += 1
        return self._coll_tag

    def cfg_radix(self, knob: str, msgsize: int, default: int = 4) -> int:
        cfg = self.comp_context.config
        if cfg is None:
            return default
        # the global KN_RADIX knob supersedes the barrier/bcast/reduce
        # radixes; sentinel values (auto/inf) defer
        if knob in _KN_RADIX_GLOBAL:
            from ...utils.config import SIZE_AUTO, UINT_MAX
            try:
                g = int(cfg.get("kn_radix"))
                if 0 < g < UINT_MAX and g != SIZE_AUTO:
                    return g
            except KeyError:
                pass
        try:
            val = cfg.get(knob)
        except KeyError:
            return default
        from ...utils.config import MRangeUint, SIZE_AUTO
        if isinstance(val, MRangeUint):
            v = val.get(msgsize)
            return default if v == SIZE_AUTO else int(v)
        return int(val)

    # -- p2p ------------------------------------------------------------
    def _peer_ctx_rank(self, subset: Subset, grank: int) -> int:
        return self.ctx_map.eval(subset.map.eval(grank))

    # ctx-rank addressed: HostCollTask resolves group rank -> ctx rank
    # once per peer
    def send_nb_ctx(self, peer_ctx: int, coll_tag, slot: int,
                    data: np.ndarray):
        return self.comp_context.send_to(
            peer_ctx, (self.team_key, self.team_epoch, coll_tag, slot,
                       self._my_ctx_rank), data)

    def recv_nb_ctx(self, peer_ctx: int, coll_tag, slot: int,
                    dst: np.ndarray):
        return self.transport.recv_nb(
            (self.team_key, self.team_epoch, coll_tag, slot, peer_ctx), dst)

    def _ag_large_alg(self) -> str:
        """Large-message allgather default: neighbor on even team sizes
        (half the rounds of ring), ring on odd ones (neighbor cannot run)
        and on reordered multi-node teams."""
        if getattr(self, "size", 0) % 2 != 0:
            return "ring"
        if getattr(self, "core_team", None) is not None and \
                self.topo_ordered_subset() is not None:
            return "ring"
        return "neighbor"

    # ------------------------------------------------------------------
    # algorithm table (ids stable for @N tuning, as in the JAX package)
    def alg_table(self) -> Dict[CollType, List[AlgSpec]]:
        S = self.TL_CLS.DEFAULT_SCORE
        tsize = max(1, getattr(self, "size", 2))
        ring_large, nbr_large = (S + 5, S + 3) \
            if self._ag_large_alg() == "ring" else (S + 3, S + 5)
        a2a_switch = 129 * tsize

        def spec(i, name, cls, sel=None, **kw):
            def init(ia, team, _cls=cls, _kw=kw):
                if ia.args.active_set is not None:
                    # active-set subset execution (bcast only, enforced
                    # by core dispatch)
                    return self.coll_init_active_set(ia)
                return _cls(ia, self, **_kw)
            return AlgSpec(i, name, init, sel)

        return {
            CollType.ALLREDUCE: [
                spec(0, "knomial", AllreduceKnomial,
                     sel=f"0-4k:{S + 5},4k-inf:{S - 5}"),
                spec(1, "sra_knomial", sra_pipelined_init,
                     sel=f"0-4k:{S - 5},4k-inf:{S + 5}"),
                spec(2, "ring", allreduce_ring_init,
                     sel=f"0-4k:{S - 6},4k-inf:{S + 4}"),
                spec(3, "dbt", AllreduceDbt,
                     sel=f"0-4k:{S - 7},4k-inf:{S + 3}"),
                spec(4, "sliding_window", AllreduceSlidingWindow,
                     sel="0-inf:1"),
            ],
            CollType.ALLGATHER: [
                spec(0, "ring", AllgatherRing,
                     sel=f"0-8k:{S - 2},8k-inf:{ring_large}"),
                spec(1, "bruck", AllgatherBruck,
                     sel=f"0-8k:{S + 5},8k-inf:{S - 2}"),
                spec(2, "neighbor", AllgatherNeighbor,
                     sel=f"0-8k:{S - 4},8k-inf:{nbr_large}"),
                spec(3, "linear", AllgatherLinear),
                spec(4, "sparbit", AllgatherSparbit,
                     sel=f"0-8k:{S + 4},8k-inf:{S - 3}"),
                spec(5, "knomial", AllgatherKnomial,
                     sel=f"0-8k:{S + 3},8k-inf:{S - 1}"),
                spec(6, "linear_batched", AllgatherLinearBatched),
            ],
            CollType.ALLGATHERV: [
                spec(0, "ring", AllgathervRing),
                spec(1, "knomial", AllgathervKnomial,
                     sel=f"0-8k:{S + 2},8k-inf:{S - 1}"),
            ],
            CollType.ALLTOALL: [
                # the bruck/pairwise crossover scales with team size
                spec(0, "pairwise", AlltoallPairwise,
                     sel=f"0-{a2a_switch}:{S - 5},"
                         f"{a2a_switch}-inf:{S + 5}"),
                spec(1, "bruck", AlltoallBruck,
                     sel=f"0-{a2a_switch}:{S + 5},"
                         f"{a2a_switch}-inf:{S - 5}"),
                spec(2, "linear", AlltoallLinear),
                spec(3, "onesided", AlltoallOnesided, sel="0-inf:1"),
            ],
            CollType.ALLTOALLV: [
                # pairwise keeps a one-point edge: ties break on the alg
                # name and "hybrid" sorts first
                spec(0, "pairwise", AlltoallvPairwise,
                     sel=f"0-inf:{S + 1}"),
                spec(1, "hybrid", AlltoallvHybrid),
                spec(2, "onesided", AlltoallvOnesided, sel="0-inf:1"),
            ],
            CollType.BARRIER: [
                spec(0, "knomial", BarrierKnomial),
            ],
            CollType.BCAST: [
                spec(0, "knomial", BcastKnomial,
                     sel=f"0-8k:{S + 5},8k-inf:{S - 3}"),
                spec(1, "sag_knomial", BcastSagKnomial,
                     sel=f"0-8k:{S - 3},8k-inf:{S + 5}"),
                spec(2, "dbt", BcastDbt,
                     sel=f"0-8k:{S - 4},8k-inf:{S + 3}"),
            ],
            CollType.FANIN: [
                spec(0, "knomial", FaninKnomial),
            ],
            CollType.FANOUT: [
                spec(0, "knomial", FanoutKnomial),
            ],
            CollType.GATHER: [
                spec(0, "knomial", GatherKnomial, sel=f"0-inf:{S + 2}"),
                spec(1, "linear", GatherLinear),
            ],
            CollType.GATHERV: [
                spec(0, "linear", GatherLinear),
            ],
            CollType.REDUCE: [
                spec(0, "knomial", ReduceKnomial,
                     sel=f"0-8k:{S + 5},8k-inf:{S - 3}"),
                spec(1, "dbt", ReduceDbt,
                     sel=f"0-8k:{S - 3},8k-inf:{S + 5}"),
                spec(2, "srg_knomial", srg_pipelined_init,
                     sel=f"0-8k:{S - 4},8k-inf:{S + 4}"),
            ],
            CollType.REDUCE_SCATTER: [
                spec(0, "ring", ReduceScatterRing),
                spec(1, "knomial", ReduceScatterKnomial,
                     sel=f"0-8k:{S + 3},8k-inf:{S - 2}"),
                spec(2, "ring_bidirectional",
                     ReduceScatterRingBidirectional,
                     sel=f"0-8k:{S - 1},8k-inf:{S + 4}"),
            ],
            CollType.REDUCE_SCATTERV: [
                spec(0, "ring", ReduceScattervRing),
            ],
            CollType.SCATTER: [
                spec(0, "knomial", ScatterKnomial, sel=f"0-inf:{S + 2}"),
                spec(1, "linear", ScatterLinear),
            ],
            CollType.SCATTERV: [
                spec(0, "linear", ScatterLinear),
            ],
        }

    def get_scores(self) -> CollScore:
        return build_scores(self, self.TL_CLS.DEFAULT_SCORE, self.alg_table(),
                            self.TL_CLS.SUPPORTED_MEM_TYPES,
                            tune_env=f"UCC_TL_{self.TL_CLS.NAME.upper()}_TUNE")

    # ------------------------------------------------------------------
    # active-set bcast (restricted to bcast by core dispatch)
    def coll_init_active_set(self, init_args) -> CollTask:
        aset = init_args.args.active_set
        amap = EpMap.strided(aset.start, aset.stride, aset.size)
        my = amap.local_rank(self.rank)
        subset = Subset(amap, my)
        root_team_rank = int(init_args.args.root)
        task = BcastKnomial(init_args, self, subset=subset)
        self._coll_tag -= 1   # undo the ctor's team-wide tag consumption
        # root is given in team ranks; translate to subset rank
        task.root = amap.local_rank(root_team_rank)
        # a strict subset must not consume the team-wide tag counter (it
        # would desync members from non-members): the user tag and the
        # set's geometry form the tag
        task.tag = ("as", aset.start, aset.stride, aset.size,
                    init_args.args.tag or 0)
        return task

    # ------------------------------------------------------------------
    # service collectives (core-facing)
    def service_allreduce(self, arr: np.ndarray, op: ReductionOp) -> CollTask:
        from ...core.coll import InitArgs
        res = arr.copy()
        args = CollArgs(coll_type=CollType.ALLREDUCE,
                        src=BufferInfo(arr.copy(), arr.size,
                                       dt_from_numpy(arr.dtype)),
                        dst=BufferInfo(res, res.size, dt_from_numpy(res.dtype)),
                        op=op)
        ia = InitArgs(args=args, team=self.core_team,
                      mem_type=MemoryType.HOST, msgsize=res.nbytes)
        task = AllreduceKnomial(ia, self)
        task.tag = ("svc", self.next_coll_tag())
        task.result = res
        task.progress_queue = self.core_team.context.progress_queue
        return task

    def service_allgather(self, data: bytes) -> CollTask:
        task = _ServiceAllgather(self, bytes(data))
        task.progress_queue = self.core_team.context.progress_queue
        return task

    def service_bcast(self, data: Optional[bytes], root: int = 0,
                      max_size: int = 4096) -> CollTask:
        task = _ServiceBcast(self, data, root, max_size)
        task.progress_queue = self.core_team.context.progress_queue
        return task


class _ServiceAllgather(HostCollTask):
    """Linear allgather of byte blobs of any sizes (sizes, then
    payloads)."""

    def __init__(self, team: HostTlTeam, data: bytes):
        super().__init__(None, team)
        self.data = data
        self.tag = ("svc", team.next_coll_tag())
        self.result: List[bytes] = []

    def run(self):
        size, me = self.gsize, self.grank
        szbuf = np.zeros(size, dtype=np.int64)
        szbuf[me] = len(self.data)
        my_sz = np.array([len(self.data)], dtype=np.int64)
        reqs = []
        for p in range(size):
            if p == me:
                continue
            reqs.append(self.send_nb(p, my_sz, slot=0))
            reqs.append(self.recv_nb(p, szbuf[p:p + 1], slot=0))
        yield from self.wait(*reqs)
        payload = np.frombuffer(self.data, dtype=np.uint8)
        bufs = {p: np.empty(int(szbuf[p]), dtype=np.uint8)
                for p in range(size) if p != me}
        reqs = []
        for p in range(size):
            if p == me:
                continue
            reqs.append(self.send_nb(p, payload, slot=1))
            reqs.append(self.recv_nb(p, bufs[p], slot=1))
        yield from self.wait(*reqs)
        self.result = [self.data if p == me else bufs[p].tobytes()
                       for p in range(size)]


class _ServiceBcast(HostCollTask):
    def __init__(self, team: HostTlTeam, data: Optional[bytes], root: int,
                 max_size: int):
        super().__init__(None, team)
        self.data = data
        self.root = root
        self.max_size = max_size
        self.tag = ("svc", team.next_coll_tag())
        self.result: bytes = b""

    def run(self):
        me = self.grank
        szbuf = np.zeros(1, dtype=np.int64)
        if me == self.root:
            szbuf[0] = len(self.data or b"")
        yield from knomial_bcast_via(self, szbuf, self.root)
        buf = np.zeros(int(szbuf[0]), dtype=np.uint8)
        if me == self.root and self.data:
            buf[:] = np.frombuffer(self.data, dtype=np.uint8)
        yield from knomial_bcast_via(self, buf, self.root, slot_base=100)
        self.result = buf.tobytes()


def knomial_bcast_via(task: HostCollTask, buf: np.ndarray, root: int,
                      radix: int = 4, slot_base: int = 90):
    from .knomial import knomial_bcast_steps
    yield from knomial_bcast_steps(task, buf, root, min(radix, task.gsize),
                                   slot_base=slot_base)
