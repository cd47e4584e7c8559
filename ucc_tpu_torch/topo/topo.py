"""Context and team topology (UCC's ``ucc_context_topo_t``: node count
and min/max ppn, built from the proc-info table of the context address
exchange; and the per-team ``ucc_topo_t``, which builds subgroups lazily
over the team's ranks), plus the hierarchy tree cl/hier composes its
N-level algorithms along.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..utils.ep_map import EpMap
from .proc_info import ProcInfo
from .sbgp import Sbgp, SbgpStatus, SbgpType


class ContextTopo:
    """All processes' ProcInfo, indexed by context (OOB) rank."""

    def __init__(self, procs: List[ProcInfo]):
        self.procs = procs
        hosts: Dict[int, List[int]] = {}
        for r, p in enumerate(procs):
            hosts.setdefault(p.host_hash, []).append(r)
        self.hosts = hosts

    @property
    def nnodes(self) -> int:
        return len(self.hosts)

    @property
    def min_ppn(self) -> int:
        return min(len(v) for v in self.hosts.values())

    @property
    def max_ppn(self) -> int:
        return max(len(v) for v in self.hosts.values())


class TeamTopo:
    """Subgroup factory over a team. ``ctx_map`` maps team rank -> context
    rank."""

    def __init__(self, ctx_topo: ContextTopo, ctx_map: EpMap, my_team_rank: int):
        self.ctx_topo = ctx_topo
        self.ctx_map = ctx_map
        self.my_rank = my_team_rank
        self._cache: Dict[SbgpType, Sbgp] = {}
        self.team_size = ctx_map.ep_num

    def _proc(self, team_rank: int) -> ProcInfo:
        return self.ctx_topo.procs[self.ctx_map.eval(team_rank)]

    def get_sbgp(self, t: SbgpType) -> Sbgp:
        if t not in self._cache:
            self._cache[t] = self._build(t)
        return self._cache[t]

    # ------------------------------------------------------------------
    def _build(self, t: SbgpType) -> Sbgp:
        size = self.team_size
        if t == SbgpType.FULL:
            return Sbgp(t, SbgpStatus.ENABLED, self.my_rank, EpMap.full(size))
        if t == SbgpType.FULL_HOST_ORDERED:
            order = sorted(range(size),
                           key=lambda r: (self._proc(r).host_hash, r))
            m = EpMap.from_array(order)
            return Sbgp(t, SbgpStatus.ENABLED, order.index(self.my_rank), m)
        if t == SbgpType.NODE:
            my_host = self._proc(self.my_rank).host_hash
            members = [r for r in range(size)
                       if self._proc(r).host_hash == my_host]
            if len(members) == size and self.ctx_topo.nnodes == 1:
                # single-node team: NODE == FULL; UCC still ENABLEs it
                pass
            grp_rank = members.index(self.my_rank)
            return Sbgp(t, SbgpStatus.ENABLED, grp_rank,
                        EpMap.from_array(members))
        if t == SbgpType.NODE_LEADERS:
            # leader = lowest team rank on each host; ordered by first
            # appearance (UCC uses the node order of the team)
            leaders: List[int] = []
            seen = set()
            for r in range(size):
                hh = self._proc(r).host_hash
                if hh not in seen:
                    seen.add(hh)
                    leaders.append(r)
            if len(leaders) < 2:
                return Sbgp(t, SbgpStatus.NOT_EXISTS)
            grp_rank = leaders.index(self.my_rank) \
                if self.my_rank in leaders else -1
            status = SbgpStatus.ENABLED if grp_rank >= 0 else SbgpStatus.DISABLED
            return Sbgp(t, status, grp_rank, EpMap.from_array(leaders))
        if t == SbgpType.NET:
            # my local-rank peers across nodes ("rails"): exists only when
            # every node has the same ppn (UCC's NET subgroup rule)
            if self.ctx_topo.nnodes < 2:
                return Sbgp(t, SbgpStatus.NOT_EXISTS)
            by_host: Dict[int, List[int]] = {}
            for r in range(size):
                by_host.setdefault(self._proc(r).host_hash, []).append(r)
            ppns = {len(v) for v in by_host.values()}
            if len(ppns) != 1:
                return Sbgp(t, SbgpStatus.NOT_EXISTS)
            my_host = self._proc(self.my_rank).host_hash
            local_rank = by_host[my_host].index(self.my_rank)
            members = [v[local_rank] for v in by_host.values()]
            grp_rank = members.index(self.my_rank)
            return Sbgp(t, SbgpStatus.ENABLED, grp_rank,
                        EpMap.from_array(members))
        # NUMA/SOCKET flavors: single-socket hosts assumed
        return Sbgp(t, SbgpStatus.NOT_EXISTS)

    # ------------------------------------------------------------------
    # N-level hierarchy tree: rank -> node -> pod, derived from the
    # proc-info paths (pod_hash, host_hash). The tree is the source of
    # cl/hier's unit construction; its depth is that of the layout
    # present (no pods -> the classic two levels).
    def rank_path(self, team_rank: int, with_pods: bool) -> tuple:
        p = self._proc(team_rank)
        return (p.pod_hash, p.host_hash) if with_pods else (p.host_hash,)

    def pods_active(self) -> bool:
        """True when the team spans more than one pod (ranks with unknown
        pod identity count as one shared pod)."""
        pods = {self._proc(r).pod_hash for r in range(self.team_size)}
        return len(pods) > 1

    def hier_tree(self, max_levels: Optional[int] = None,
                  demote=()) -> "HierTree":
        """Build the team's hierarchy tree. ``max_levels`` caps the number
        of unit levels (2 = classic node/leaders split even when pods
        exist); None/oversized = full depth. ``demote`` lists team ranks to
        push out of leader positions wherever a non-demoted group member
        exists (see HierTree)."""
        with_pods = self.pods_active()
        if max_levels is not None and max_levels < 3:
            # a 2-level cap collapses the pod attribute: groups form by
            # host only, leaders span pods directly
            with_pods = False
        paths = [self.rank_path(r, with_pods)
                 for r in range(self.team_size)]
        return HierTree(paths, self.my_rank, demote=demote)

    def node_layout(self) -> tuple:
        """Per-node member counts of THIS team, sorted: the node shape of
        a topology signature (a (2,2) split and a (1,3) one are both 4
        ranks over 2 nodes)."""
        by_host: Dict[int, int] = {}
        for r in range(self.team_size):
            h = self._proc(r).host_hash
            by_host[h] = by_host.get(h, 0) + 1
        return tuple(sorted(by_host.values()))

    @property
    def n_nodes(self) -> int:
        hosts = {self._proc(r).host_hash for r in range(self.team_size)}
        return len(hosts)

    def is_single_node(self) -> bool:
        return self.n_nodes == 1

    def all_procs_same_node(self) -> bool:
        return self.is_single_node()


@dataclass
class HierTreeLevel:
    """One tier of the hierarchy: a partition of (a subset of) team ranks
    into unit groups. Level 0 partitions ALL team ranks into nodes; level
    l >= 1 partitions the level-(l-1) group leaders by shrinking path
    prefix; the top level is a single group. Within a group members are
    in ascending team-rank order — except demoted ranks, which sort
    last — so ``group[0]`` is the group's leader;
    groups are in hierarchical (parent-subtree-contiguous) order."""

    name: str
    groups: List[List[int]]
    prefix_len: int


class HierTree:
    """Topology tree over a team, built from per-rank attribute paths
    (e.g. ``(pod_hash, host_hash)``). Constructed from raw paths so unit
    tests can exercise arbitrary (asymmetric) layouts without a context.

    Definitions used throughout CL/HIER's N-level algorithms, for a team
    rank ``r`` and level ``l``:

    - ``rep(l, r)``: r's representative at level l — r itself at level 0,
      then the leader of the previous representative's group (the chain
      data travels when funneled up the tree).
    - ``group_index(l, r)``: the level-l unit associated with r (the one
      containing ``rep(l, r)``); defined for every rank, member or not.
    - ``is_member(l, r)``: whether r itself participates in its level-l
      unit (``rep(l, r) == r``). Every rank is a member at level 0.
    """

    def __init__(self, paths: List[tuple], my_rank: int, demote=()):
        if not paths:
            raise ValueError("empty team")
        self.my_rank = my_rank
        self.team_size = n = len(paths)
        self.paths = list(paths)
        #: team ranks demoted from leader positions: within a group they
        #: order AFTER every non-demoted member, so ``group[0]`` (the
        #: leader every funnel and fanout goes through) is a demoted rank
        #: only when its whole group is. The set must be identical on
        #: every rank, or the trees diverge and hier collectives
        #: deadlock.
        self.demoted = frozenset(demote)
        depth = len(paths[0])
        if any(len(p) != depth for p in paths):
            raise ValueError("inconsistent path depths")
        # hierarchical order: subtrees contiguous, ordered by the first
        # team rank appearing under each prefix (deterministic and
        # identical on every rank)
        first_of: Dict[tuple, int] = {}
        for r in range(n):
            for i in range(depth + 1):
                first_of.setdefault(paths[r][:i], min(
                    first_of.get(paths[r][:i], r), r))

        def sort_key(r: int) -> tuple:
            return tuple(first_of[paths[r][:i]]
                         for i in range(1, depth + 1)) + (r,)

        self.tree_order: List[int] = sorted(range(n), key=sort_key)
        # level 0: full-path groups over all ranks; level l: previous
        # leaders grouped by prefix of length depth-l; top: one group
        self.levels: List[HierTreeLevel] = []
        members = self.tree_order
        for l in range(depth + 1):
            plen = depth - l
            groups: List[List[int]] = []
            seen: Dict[tuple, int] = {}
            for r in members:       # members already in hierarchical order
                key = paths[r][:plen]
                gi = seen.get(key)
                if gi is None:
                    gi = seen[key] = len(groups)
                    groups.append([])
                groups[gi].append(r)
            for g in groups:
                g.sort(key=lambda r: (r in self.demoted, r))
            name = ("node" if l == 0 else
                    "top" if plen == 0 else f"tier{l}")
            self.levels.append(HierTreeLevel(name, groups, plen))
            leaders = [g[0] for g in groups]
            members = sorted(leaders, key=sort_key)
        # per-level maps: rank -> group index (via path prefix)
        self._gidx: List[Dict[tuple, int]] = []
        for lvl in self.levels:
            d = {}
            for gi, g in enumerate(lvl.groups):
                d[paths[g[0]][:lvl.prefix_len]] = gi
            self._gidx.append(d)

    # ------------------------------------------------------------------
    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def level(self, l: int) -> HierTreeLevel:
        return self.levels[l]

    def group_index(self, l: int, rank: Optional[int] = None) -> int:
        rank = self.my_rank if rank is None else rank
        return self._gidx[l][self.paths[rank][:self.levels[l].prefix_len]]

    def group(self, l: int, rank: Optional[int] = None) -> List[int]:
        return self.levels[l].groups[self.group_index(l, rank)]

    def rep(self, l: int, rank: Optional[int] = None) -> int:
        """Team rank of *rank*'s representative at level l."""
        rank = self.my_rank if rank is None else rank
        r = rank
        for i in range(l):
            r = self.levels[i].groups[self.group_index(i, rank)][0]
        return r

    def is_member(self, l: int, rank: Optional[int] = None) -> bool:
        rank = self.my_rank if rank is None else rank
        return self.rep(l, rank) == rank

    def rep_group_rank(self, l: int, rank: Optional[int] = None) -> int:
        """Index of *rank*'s representative within its level-l group (the
        root index a rooted sub-collective at that level needs)."""
        rank = self.my_rank if rank is None else rank
        return self.group(l, rank).index(self.rep(l, rank))

    def describe(self) -> str:
        """One line per level: sizes and leader ranks (truncated), as the
        team-activation log prints it."""
        out = [f"hier tree: {self.n_levels} levels over "
               f"{self.team_size} ranks"
               + (f", demoted [{','.join(str(r) for r in sorted(self.demoted))}]"
                  if self.demoted else "")]
        for l, lvl in enumerate(self.levels):
            sizes = [len(g) for g in lvl.groups]
            leaders = [g[0] for g in lvl.groups]
            s_sizes = ",".join(str(s) for s in sizes[:8]) + \
                (",..." if len(sizes) > 8 else "")
            s_lead = ",".join(str(x) for x in leaders[:8]) + \
                (",..." if len(leaders) > 8 else "")
            out.append(f"  L{l} {lvl.name:<6} x{len(lvl.groups):<4} "
                       f"sizes [{s_sizes}] leaders [{s_lead}]")
        return "\n".join(out)
