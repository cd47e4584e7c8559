"""cl/hier: the hierarchical collective layer (UCC's cl/hier), its
registration and its knobs.

A team that spans nodes builds units over the topology's subgroups (NODE,
NODE_LEADERS, NET, FULL) and over the levels of its hierarchy tree, each
a set of TL teams with a score map of its own, and composes collectives
from sub-collectives on those units (``algs.py``, ``nlevel.py``; CUDA
memory: ``cuda.py``). A team on one node has nothing to compose: its
cl/hier team declines with ERR_NOT_SUPPORTED and cl/basic serves it.
"""
from __future__ import annotations

from ...core.components import (BaseContext, BaseLib, CollectiveLayer,
                                register_cl)
from ...utils.config import (ConfigField, ConfigTable, parse_list,
                             parse_string, register_table)
from .team import ClHierTeam

CL_HIER_CONFIG = register_table(ConfigTable(
    prefix="CL_HIER_", name="cl/hier", fields=[
        ConfigField("NODE_TLS", "shm,torch_ops,self",
                    "TLs for the intra-node unit", parse_list),
        ConfigField("NODE_LEADERS_TLS", "socket,shm,self",
                    "TLs for the inter-node unit", parse_list),
        ConfigField("NET_TLS", "socket,shm,self",
                    "TLs for the per-rail NET unit", parse_list),
        ConfigField("FULL_TLS", "all", "TLs for the FULL unit", parse_list),
        ConfigField("LEVELS", "auto",
                    "number of hierarchy-tree unit levels: auto = the full "
                    "detected depth (rank -> node -> pod when pod identity "
                    "is known); 2 = the classic node/leaders split even "
                    "when pods exist", parse_string),
        ConfigField("ALLREDUCE_RAB_PIPELINE", "n",
                    "pipeline spec for RAB allreduce, e.g. "
                    "thresh=64K:fragsize=1M:nfrags=4:pdepth=2:ordered",
                    parse_string),
        ConfigField("ALLREDUCE_SPLIT_RAIL_PIPELINE", "n",
                    "pipeline spec for split_rail allreduce (same syntax "
                    "as ALLREDUCE_RAB_PIPELINE)", parse_string),
        ConfigField("A2AV_NODE_THRESH", "1k",
                    "alltoall(v) node-aggregation threshold",
                    parse_string),
    ]))


def tree_paths_for_search(team, max_levels=None):
    """Per-rank topology attribute paths of *team*'s hierarchy tree, for a
    program search that composes hierarchical programs along the same
    tree cl/hier builds its units from. Takes a core team or a TL team
    (resolved through ``core_team``); None for a single-node team (flat
    families serve those) or when no topology is known."""
    core = getattr(team, "core_team", None) or team
    topo = getattr(core, "topo", None)
    if topo is None:
        ctx = getattr(core, "context", None)
        ctx_topo = getattr(ctx, "topo", None)
        cmap = getattr(team, "ctx_map", None)
        if cmap is None:
            cmap = getattr(core, "ctx_map", None)
        if ctx_topo is None or cmap is None:
            return None
        from ...topo.topo import TeamTopo
        topo = TeamTopo(ctx_topo, cmap, int(getattr(team, "rank", 0)))
    try:
        if topo.n_nodes < 2:
            return None
        with_pods = topo.pods_active()
        if max_levels is not None and max_levels < 3:
            with_pods = False
        return [topo.rank_path(r, with_pods)
                for r in range(topo.team_size)]
    except Exception:  # noqa: BLE001 - topology export is best-effort
        return None


class ClHierContext(BaseContext):
    pass


@register_cl
class ClHier(CollectiveLayer):
    NAME = "hier"
    DEFAULT_SCORE = 55
    CONTEXT_CONFIG = CL_HIER_CONFIG
    lib_cls = BaseLib
    context_cls = ClHierContext
    team_cls = ClHierTeam
