"""The port's topology (ucc_tpu_torch/topo/) held against the JAX
package's on the layouts of tests/test_hier_nlevel.py and a few more:
the fake-topology knobs, the context's proc-info hashes, every subgroup's
status, group rank and map, every hierarchy-tree level's groups, every
rank's representatives, and the renderings. Pure Python, no ranks.
"""
import ast
import pathlib
import subprocess
import sys
import zlib

import pytest

from ucc_tpu.cl.hier import tree_paths_for_search as j_paths_for_search
from ucc_tpu.topo.proc_info import ProcInfo as JProcInfo
from ucc_tpu.topo.proc_info import fake_topology as j_fake_topology
from ucc_tpu.topo.sbgp import SbgpType as JSbgpType
from ucc_tpu.topo.topo import ContextTopo as JContextTopo
from ucc_tpu.topo.topo import HierTree as JHierTree
from ucc_tpu.topo.topo import TeamTopo as JTeamTopo
from ucc_tpu.utils.ep_map import EpMap as JEpMap

from ucc_tpu_torch.cl.hier import tree_paths_for_search
from ucc_tpu_torch.topo.proc_info import (ProcInfo, context_proc_info,
                                          fake_topology, host_hash)
from ucc_tpu_torch.topo.sbgp import SbgpType
from ucc_tpu_torch.topo.topo import ContextTopo, HierTree, TeamTopo
from ucc_tpu_torch.utils.ep_map import EpMap

REPO = pathlib.Path(__file__).resolve().parent.parent

#: (name, rank -> node, node -> pod or None)
LAYOUTS = [
    ("two_level_asym", [0, 0, 1, 2, 2, 2], None),
    ("one_node_pod", [0, 0, 1, 2, 2, 2], [0, 0, 1]),
    ("single_rank_nodes", [0, 1, 2, 3], None),
    ("interleaved", [0, 1, 0, 1], None),
    ("lopsided_pods", [0, 0, 0, 0, 1, 2, 2, 3, 4, 4, 4], [0, 0, 0, 1, 2]),
    ("two_pods", [0, 0, 1, 1], [0, 1]),
    ("two_nodes", [0, 0, 1, 1], None),
    ("ppn4", [0] * 4 + [1] * 4, None),
    ("nlevel_job", [0, 0, 1, 2, 2, 2, 3, 3], [0, 0, 1, 1]),
    ("one_node", [0, 0, 0], None),
]
IDS = [name for name, _, _ in LAYOUTS]


def _hashes(node_of, pod_of):
    out = []
    for node in node_of:
        hh = zlib.crc32(f"fake-node-{node}".encode())
        ph = -1 if pod_of is None else \
            zlib.crc32(f"fake-pod-{pod_of[node]}".encode())
        out.append((hh, ph))
    return out


def _topos(node_of, pod_of, me, ctx_order=None):
    """The port's and the reference's TeamTopo of one layout (team rank
    i is context rank ctx_order[i])."""
    hs = _hashes(node_of, pod_of)
    mine = [ProcInfo(host_hash=h, pid=100 + r, real_host_hash=7,
                     pod_hash=p) for r, (h, p) in enumerate(hs)]
    ref = [JProcInfo(host_hash=h, pid=100 + r, real_host_hash=7,
                     pod_hash=p) for r, (h, p) in enumerate(hs)]
    n = len(node_of)
    order = list(range(n)) if ctx_order is None else ctx_order
    return (TeamTopo(ContextTopo(mine), EpMap.from_array(order), me),
            JTeamTopo(JContextTopo(ref), JEpMap.from_array(order), me))


def _map(sb):
    return None if sb.map is None else \
        [int(sb.map.eval(i)) for i in range(sb.size)]


# ---------------------------------------------------------------------------
# identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ppn,npp", [("4", ""), ("2,1,3", ""), ("2", "2"),
                                     ("2,1,3", "2"), ("", ""), ("x", ""),
                                     ("3", "y"), (" 1 ", "3")])
def test_fake_topology_matches(ppn, npp):
    env = {"UCC_TOPO_FAKE_PPN": ppn, "UCC_TOPO_FAKE_NODES_PER_POD": npp}
    for r in range(13):
        assert fake_topology(r, env) == j_fake_topology(r, env), r


@pytest.mark.parametrize("ppn,npp", [("4", ""), ("2,1,3", "2"), ("", "")])
def test_context_proc_info_rewrites_the_topology_identity_only(ppn, npp):
    env = {"UCC_TOPO_FAKE_PPN": ppn, "UCC_TOPO_FAKE_NODES_PER_POD": npp}
    for r in range(9):
        info = context_proc_info(r, env)
        node, pod = j_fake_topology(r, env)
        want_hh = host_hash() if node is None else \
            zlib.crc32(f"fake-node-{node}".encode())
        want_ph = -1 if pod is None else \
            zlib.crc32(f"fake-pod-{pod}".encode())
        assert (info.host_hash, info.pod_hash) == (want_hh, want_ph)
        # the physical identity never moves
        assert info.real_host_hash == host_hash() == info.phys_host_hash \
            or node is not None
        assert info.real_host_hash == host_hash()


# ---------------------------------------------------------------------------
# subgroups
# ---------------------------------------------------------------------------

SBGPS = ["NODE", "NODE_LEADERS", "NET", "FULL", "FULL_HOST_ORDERED",
         "NUMA", "SOCKET"]


@pytest.mark.parametrize("sbgp", SBGPS)
@pytest.mark.parametrize("name,node_of,pod_of", LAYOUTS, ids=IDS)
def test_sbgp_matches(name, node_of, pod_of, sbgp):
    for me in range(len(node_of)):
        mine, ref = _topos(node_of, pod_of, me)
        a = mine.get_sbgp(SbgpType[sbgp])
        b = ref.get_sbgp(JSbgpType[sbgp])
        assert (int(a.status), a.group_rank, _map(a), a.is_member) == \
            (int(b.status), b.group_rank, _map(b), b.is_member), me


@pytest.mark.parametrize("sbgp", ["NODE", "NODE_LEADERS", "NET",
                                  "FULL_HOST_ORDERED"])
def test_sbgp_matches_on_a_permuted_team(sbgp):
    node_of = [0, 0, 0, 1, 1, 1, 2, 2, 2]
    order = [4, 0, 8, 3, 1, 6, 2, 5, 7]
    for me in range(len(order)):
        mine, ref = _topos(node_of, None, me, order)
        a = mine.get_sbgp(SbgpType[sbgp])
        b = ref.get_sbgp(JSbgpType[sbgp])
        assert (int(a.status), a.group_rank, _map(a)) == \
            (int(b.status), b.group_rank, _map(b)), me


@pytest.mark.parametrize("name,node_of,pod_of", LAYOUTS, ids=IDS)
def test_team_and_context_shape_match(name, node_of, pod_of):
    mine, ref = _topos(node_of, pod_of, 0)
    assert (mine.node_layout(), mine.n_nodes, mine.is_single_node(),
            mine.pods_active()) == \
        (ref.node_layout(), ref.n_nodes, ref.is_single_node(),
         ref.pods_active())
    a, b = mine.ctx_topo, ref.ctx_topo
    assert (a.nnodes, a.min_ppn, a.max_ppn, a.hosts) == \
        (b.nnodes, b.min_ppn, b.max_ppn, b.hosts)


# ---------------------------------------------------------------------------
# the hierarchy tree
# ---------------------------------------------------------------------------

def _levels(tree):
    return [(lv.name, lv.groups, lv.prefix_len) for lv in tree.levels]


@pytest.mark.parametrize("cap", [None, 2, 3, 5])
@pytest.mark.parametrize("name,node_of,pod_of", LAYOUTS, ids=IDS)
def test_tree_levels_match(name, node_of, pod_of, cap):
    mine, ref = _topos(node_of, pod_of, 0)
    a, b = mine.hier_tree(cap), ref.hier_tree(cap)
    assert (a.n_levels, _levels(a), a.tree_order) == \
        (b.n_levels, _levels(b), b.tree_order)


@pytest.mark.parametrize("name,node_of,pod_of", LAYOUTS, ids=IDS)
def test_tree_reps_match(name, node_of, pod_of):
    n = len(node_of)
    for me in range(n):
        mine, ref = _topos(node_of, pod_of, me)
        a, b = mine.hier_tree(), ref.hier_tree()
        for lvl in range(a.n_levels):
            for r in range(n):
                assert (a.rep(lvl, r), a.is_member(lvl, r),
                        a.group_index(lvl, r), a.group(lvl, r),
                        a.rep_group_rank(lvl, r)) == \
                    (b.rep(lvl, r), b.is_member(lvl, r),
                     b.group_index(lvl, r), b.group(lvl, r),
                     b.rep_group_rank(lvl, r)), (me, lvl, r)
            assert (a.rep(lvl), a.is_member(lvl), a.group(lvl)) == \
                (b.rep(lvl), b.is_member(lvl), b.group(lvl))


@pytest.mark.parametrize("demote", [(), (0,), (0, 3), (2, 4, 5)])
@pytest.mark.parametrize("name,node_of,pod_of", LAYOUTS, ids=IDS)
def test_tree_describe_matches(name, node_of, pod_of, demote):
    paths = [(p, h) if pod_of is not None else (h,)
             for h, p in _hashes(node_of, pod_of)]
    demote = [d for d in demote if d < len(node_of)]
    a = HierTree(paths, 0, demote=demote)
    b = JHierTree(paths, 0, demote=demote)
    assert a.describe() == b.describe()
    assert _levels(a) == _levels(b)


def test_tree_rejects_what_the_reference_rejects():
    for paths in ([], [(1,), (1, 2)]):
        with pytest.raises(ValueError):
            JHierTree(paths, 0)
        with pytest.raises(ValueError):
            HierTree(paths, 0)


class _Core:
    def __init__(self, topo):
        self.topo = topo


@pytest.mark.parametrize("cap", [None, 2])
@pytest.mark.parametrize("name,node_of,pod_of", LAYOUTS, ids=IDS)
def test_tree_paths_for_search_match(name, node_of, pod_of, cap):
    mine, ref = _topos(node_of, pod_of, 0)
    assert tree_paths_for_search(_Core(mine), cap) == \
        j_paths_for_search(_Core(ref), cap)


# ---------------------------------------------------------------------------
# the new modules stand alone
# ---------------------------------------------------------------------------

NEW_MODULES = ["topo/__init__.py", "topo/proc_info.py", "topo/sbgp.py",
               "topo/topo.py", "cl/hier/__init__.py", "cl/hier/team.py",
               "cl/hier/algs.py", "cl/hier/nlevel.py", "cl/hier/cuda.py",
               "bootstrap.py"]


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_new_modules_import_neither_jax_nor_the_jax_package(rel):
    path = REPO / "ucc_tpu_torch" / rel
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for mod in names:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "ucc_tpu"), \
                (rel, mod)


def test_hier_registers_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['ucc_tpu'] = None; import ucc_tpu_torch as ut; "
            "from ucc_tpu_torch import bootstrap; "
            "from ucc_tpu_torch.cl.hier import algs, nlevel, cuda, team; "
            "from ucc_tpu_torch.topo import topo, sbgp, proc_info; "
            "lib = ut.init(); "
            "print([c.name for c in lib.cl_libs])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['basic', 'hier']"
