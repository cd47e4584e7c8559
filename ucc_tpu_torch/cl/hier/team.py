"""cl/hier team: a hierarchical composition of TL teams over subgroups.

The team builds the units NODE, NODE_LEADERS, NET and FULL (UCC's
cl_hier units), each an ``HierSbgp``: a topology subgroup, the TL teams
made over it and a score map of its own, with a TL allow-list per unit
(``UCC_CL_HIER_{NODE,NODE_LEADERS,NET,FULL}_TLS``). It also builds one unit
per level of the topology's hierarchy tree this rank takes part in (level
0 and a depth-2 top alias NODE and NODE_LEADERS). Algorithms are
schedules of sub-collectives on these units (``algs.py``, ``nlevel.py``,
``cuda.py``).

A unit's TL teams get the scope ``hier_<unit>``: the device TLs key their
shared state, and a team that spans processes its sync area, on (team
key, scope, TL), so a NODE unit whose ranks span processes gets a sync
area of its own.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from ...api.types import CollArgs
from ...constants import MemoryType
from ...core.components import BaseContext, BaseTeam
from ...score.score import CollScore
from ...score.score_map import ScoreMap
from ...status import Status, UccError
from ...topo.sbgp import SbgpStatus, SbgpType
from ...utils.ep_map import EpMap
from ...utils.log import get_logger

logger = get_logger("cl_hier")

#: hierarchy units (the cl_hier unit types)
HIER_SBGPS = (SbgpType.NODE, SbgpType.NODE_LEADERS, SbgpType.NET,
              SbgpType.FULL)


class SbgpCoreTeamFacade:
    """Core-team-like view of a subgroup, handed to TL team constructors.

    TL teams only touch ctx_map, rank, size, team_key and context; this
    facade scopes them to the subgroup (subgroup rank -> team rank ->
    context rank by map composition).
    """

    def __init__(self, core_team, sbgp_type: SbgpType, sbgp,
                 unit_key: Optional[int] = None):
        self.parent = core_team
        self.context = core_team.context
        self.ctx_map = core_team.ctx_map.compose(sbgp.map)
        self.rank = sbgp.group_rank
        self.size = sbgp.size
        # the ctx-rank tuple disambiguates sibling units of the same type
        # (e.g. each node's NODE team) sharing one process; unit_key
        # disambiguates tree-level units whose membership could coincide
        # with a classic sbgp's on degenerate layouts
        self.team_key = (core_team.team_key, "hier",
                         int(sbgp_type) if unit_key is None else unit_key,
                         tuple(int(self.ctx_map.eval(i))
                               for i in range(self.size)))
        self.id = core_team.id
        # the parent's epoch rides through to the unit TL teams' match keys
        self.epoch = getattr(core_team, "epoch", 0)


class HierSbgp:
    """A unit (UCC's ucc_hier_sbgp_t): subgroup + TL teams + score map."""

    def __init__(self, sbgp_type: SbgpType, sbgp, core_team,
                 tl_allow: List[str], unit_key: Optional[int] = None):
        self.type = sbgp_type
        self.sbgp = sbgp
        self.tl_teams: List[Any] = []
        self._pending: List[Any] = []
        self.score_map: Optional[ScoreMap] = None
        self.facade = SbgpCoreTeamFacade(core_team, sbgp_type, sbgp,
                                         unit_key)
        key_id = int(sbgp_type) if unit_key is None else unit_key
        ctx = core_team.context
        for name, handle in ctx.tl_contexts.items():
            if tl_allow != ["all"] and name not in tl_allow:
                continue
            try:
                self._pending.append(handle.tl_lib.tl_cls.team_cls(
                    handle.obj, self.facade, scope=f"hier_{key_id}"))
            except UccError:
                continue

    def create_test(self) -> Status:
        still = []
        for t in self._pending:
            st = t.create_test()
            if st == Status.IN_PROGRESS:
                still.append(t)
            elif st.is_error:
                t.destroy()
            else:
                self.tl_teams.append(t)
        self._pending = still
        if still:
            return Status.IN_PROGRESS
        if not self.tl_teams:
            return Status.ERR_NO_RESOURCE
        merged = CollScore()
        for t in self.tl_teams:
            merged = merged.merge(t.get_scores())
        self.score_map = ScoreMap(merged)
        return Status.OK

    def coll_init(self, args: CollArgs, mem_type: MemoryType, msgsize: int):
        """Init a sub-collective on this unit via its score map."""
        from ...core.coll import InitArgs
        ia = InitArgs(args=args, team=self.facade, mem_type=mem_type,
                      msgsize=msgsize)
        task, _ = self.score_map.init_coll(args.coll_type, mem_type,
                                           msgsize, ia)
        return task

    def destroy(self) -> None:
        for t in self.tl_teams + self._pending:
            t.destroy()


class ClHierTeam(BaseTeam):
    NAME = "hier"

    def __init__(self, comp_context: BaseContext, core_team):
        super().__init__(comp_context, core_team)
        topo = _team_topo(core_team)
        if topo.n_nodes < 2:
            # single node: hierarchy adds nothing; let cl/basic serve
            # (UCC's cl_hier team create declines the same way)
            raise UccError(Status.ERR_NOT_SUPPORTED,
                           "cl/hier requires a multi-node team")
        self.core_team = core_team
        cfg = comp_context.config
        self.sbgps: Dict[SbgpType, HierSbgp] = {}
        for st in HIER_SBGPS:
            sbgp = topo.get_sbgp(st)
            if sbgp.status != SbgpStatus.ENABLED or not sbgp.is_member:
                continue
            allow = ["all"]
            if cfg is not None:
                try:
                    allow = cfg.get(f"{st.name}_TLS")
                except KeyError:
                    pass
            self.sbgps[st] = HierSbgp(st, sbgp, core_team, allow)

        # N-level topology tree: one unit per tree level this rank takes
        # part in, derived from the proc-info paths (rank -> node -> pod).
        # Level 0 aliases the NODE unit and a depth-2 top aliases
        # NODE_LEADERS (no duplicate TL teams for the classic split);
        # deeper layouts add per-pod leader units.
        cap = None
        if cfg is not None:
            try:
                lv = str(cfg.get("LEVELS")).strip().lower()
                if lv and lv != "auto":
                    cap = max(2, int(lv))
            except (KeyError, ValueError):
                logger.warning("bad UCC_CL_HIER_LEVELS value; using auto")
        # leader demotion: CONTEXT ranks the team agreed to flag at its
        # bootstrap (``boot_flagged_ctx``, the same set on every member)
        # are pushed out of leader positions at every tree level; a
        # flagged rank still takes part in its level-0 unit. The set is
        # the union of the members' collector views (obs/collector.py),
        # empty when UCC_COLLECT is off.
        demote = set()
        flagged_ctx = getattr(core_team, "boot_flagged_ctx", None)
        if flagged_ctx:
            demote = {tr for tr in range(core_team.size)
                      if int(core_team.ctx_map.eval(tr)) in flagged_ctx}
            if demote:
                logger.info(
                    "cl/hier team %s (epoch %d): demoting flagged "
                    "rank(s) %s from leader positions", core_team.id,
                    getattr(core_team, "epoch", 0),
                    ",".join(str(r) for r in sorted(demote)))
        self.tree = topo.hier_tree(cap, demote=demote)
        self.level_units: List[Optional[HierSbgp]] = []
        self._extra_units: List[HierSbgp] = []
        from ...topo.sbgp import Sbgp
        for lvl in range(self.tree.n_levels):
            if not self.tree.is_member(lvl):
                self.level_units.append(None)
                continue
            members = self.tree.group(lvl)
            unit = self._alias_unit(members)
            if unit is None:
                st = SbgpType.NODE if lvl == 0 else SbgpType.NODE_LEADERS
                sbgp = Sbgp(st, SbgpStatus.ENABLED,
                            members.index(core_team.rank),
                            EpMap.from_array(members))
                allow = ["all"]
                if cfg is not None:
                    try:
                        allow = cfg.get(f"{st.name}_TLS")
                    except KeyError:
                        pass
                unit = HierSbgp(st, sbgp, core_team, allow,
                                unit_key=100 + lvl)
                self._extra_units.append(unit)
            self.level_units.append(unit)

    def _alias_unit(self, members: List[int]) -> Optional[HierSbgp]:
        """Reuse a classic unit whose membership coincides with a tree
        level's, so the two-level layout builds no extra TL teams."""
        for st in (SbgpType.NODE, SbgpType.NODE_LEADERS):
            u = self.sbgps.get(st)
            if u is not None and u.sbgp.map is not None and \
                    list(int(x) for x in u.sbgp.map.to_array()) == members:
                return u
        return None

    def create_test(self) -> Status:
        any_in_progress = False
        for st in list(self.sbgps):
            s = self.sbgps[st].create_test()
            if s == Status.IN_PROGRESS:
                any_in_progress = True
            elif s.is_error:
                if st in (SbgpType.NODE, SbgpType.NODE_LEADERS):
                    return s       # hierarchy needs its core units
                self.sbgps[st].destroy()
                del self.sbgps[st]
        for u in self._extra_units:
            s = u.create_test()
            if s == Status.IN_PROGRESS:
                any_in_progress = True
            elif s.is_error:
                # level units are load-bearing for the N-level
                # composition: failing the CL here keeps the outcome
                # symmetric (CL_AGREE drops hier team-wide) instead of
                # leaving ranks with divergent candidate sets
                return s
        if any_in_progress:
            return Status.IN_PROGRESS
        if SbgpType.NODE not in self.sbgps and \
                SbgpType.NODE_LEADERS not in self.sbgps:
            return Status.ERR_NO_RESOURCE
        return Status.OK

    # ------------------------------------------------------------------
    def get_scores(self) -> CollScore:
        from .algs import build_hier_scores
        return build_hier_scores(self)

    def sbgp(self, st: SbgpType) -> Optional[HierSbgp]:
        return self.sbgps.get(st)

    # -- N-level tree accessors ----------------------------------------
    @property
    def n_levels(self) -> int:
        return self.tree.n_levels

    def level_unit(self, lvl: int) -> Optional[HierSbgp]:
        """The unit team for tree level *lvl*, or None when this rank is
        not a participant at that level."""
        return self.level_units[lvl]

    def describe_topology(self) -> str:
        """The resolved hierarchy, as the team-activation log prints it:
        the tree plus, per level this rank serves, the TLs its unit
        actually created, so a mis-detected topology shows here instead
        of silently degrading to flat algorithms."""
        ep = int(getattr(self.core_team, "epoch", 0))
        head = self.tree.describe()
        if ep:
            # a rebuilt membership carries a new epoch: name it
            head = f"{head} [epoch {ep}]"
        lines = [head]
        for lvl, unit in enumerate(self.level_units):
            if unit is None:
                lines.append(f"  L{lvl}: (not a participant)")
            else:
                tls = ",".join(t.name for t in unit.tl_teams) or "pending"
                lines.append(f"  L{lvl}: unit size {unit.sbgp.size} "
                             f"rank {unit.sbgp.group_rank} tls [{tls}]")
        return "\n".join(lines)

    @property
    def is_node_leader(self) -> bool:
        nl = self.sbgps.get(SbgpType.NODE_LEADERS)
        return nl is not None and nl.sbgp.is_member

    def destroy(self) -> None:
        for s in self.sbgps.values():
            s.destroy()
        for u in self._extra_units:
            u.destroy()


def _team_topo(core_team):
    if core_team.topo is not None:
        return core_team.topo
    from ...topo.topo import TeamTopo
    return TeamTopo(core_team.context.topo, core_team.ctx_map
                    or EpMap.full(core_team.size), core_team.rank)
