"""The port's N-level cl/hier algorithms (nrab, nstep, nlvl) end to end on
tests/test_hier_nlevel.py's asymmetric 3-level layout: 8 in-process ranks
in fake nodes of 2,1,3,2 (UCC_TOPO_FAKE_PPN="2,1,3") grouped two nodes a
pod (UCC_TOPO_FAKE_NODES_PER_POD=2), a single-rank node whose rank serves
two tree levels included. HOST memory, bitwise the JAX package's on the
same seeded inputs, with the same trees, units and selections.
"""
import numpy as np
import pytest

import ucc_tpu
import ucc_tpu_torch as ut

from torch_hier_cases import (N, HierJob, bits, candidates, hier_rows,
                              hier_team_of)

LAYOUT = {"UCC_TOPO_FAKE_PPN": "2,1,3", "UCC_TOPO_FAKE_NODES_PER_POD": "2"}
COMPS = ("hier", "shm", "socket", "self")


@pytest.fixture(scope="module")
def jobs():
    ref = HierJob(ucc_tpu, N, **LAYOUT)
    mine = HierJob(ut, N, **LAYOUT)
    pair = {"ref": ref, "mine": mine,
            "ref_teams": ref.team(), "mine_teams": mine.team()}
    yield pair
    ref.cleanup()
    mine.cleanup()


def _data(seed, count, nd, rank):
    rng = np.random.default_rng(seed * 1000 + rank)
    if np.issubdtype(nd, np.floating):
        return (rng.random(count) * 4 - 2).astype(nd)
    return rng.integers(-50, 50, size=count).astype(nd)


def _both(jobs, build, alg):
    got = {}
    for side, mod in (("ref", ucc_tpu), ("mine", ut)):
        argses, outs = build(mod)
        names = jobs[side].run(jobs[f"{side}_teams"], argses)
        assert names == [alg] * len(argses), (side, names)
        got[side] = [np.array(o, copy=True) for o in outs]
    assert len(got["ref"]) == len(got["mine"])
    for a, b in zip(got["ref"], got["mine"]):
        np.testing.assert_array_equal(bits(b), bits(a))


# ---------------------------------------------------------------------------
# tree, units, selection
# ---------------------------------------------------------------------------

def test_tree_resolved(jobs):
    for r in range(N):
        a = hier_team_of(jobs["mine_teams"][r])
        b = hier_team_of(jobs["ref_teams"][r])
        assert a.n_levels == b.n_levels == 3
        assert [lv.groups for lv in a.tree.levels] == \
            [lv.groups for lv in b.tree.levels]
        for lvl in range(3):
            ua, ub = a.level_unit(lvl), b.level_unit(lvl)
            assert (ua is None) == (ub is None), (r, lvl)
            if ua is not None:
                assert (ua.sbgp.size, ua.sbgp.group_rank,
                        ua.sbgp.map.to_array().tolist()) == \
                    (ub.sbgp.size, ub.sbgp.group_rank,
                     ub.sbgp.map.to_array().tolist())
                assert sorted(t.NAME for t in ua.tl_teams) == sorted(
                    "torch_ops" if t.NAME == "xla" else t.NAME
                    for t in ub.tl_teams), (r, lvl)
        assert a.describe_topology() == \
            b.describe_topology().replace("xla", "torch_ops")
    ht = hier_team_of(jobs["mine_teams"][0])
    assert ht.tree.level(0).groups == [[0, 1], [2], [3, 4, 5], [6, 7]]
    assert ht.tree.level(1).groups == [[0, 2], [3, 6]]
    assert ht.tree.level(2).groups == [[0, 3]]
    ht4 = hier_team_of(jobs["mine_teams"][4])
    assert ht4.level_unit(1) is None and ht4.level_unit(2) is None


def test_hier_rows_match(jobs):
    assert hier_rows(jobs["mine_teams"][2], ut) == \
        hier_rows(jobs["ref_teams"][2], ucc_tpu)


@pytest.mark.parametrize("coll", ["ALLREDUCE", "BCAST", "REDUCE", "BARRIER",
                                  "ALLGATHER", "ALLGATHERV"])
def test_nlvl_is_the_default_on_pods(jobs, coll):
    for r in (0, 2, 5):
        mine = candidates(jobs["mine_teams"][r], ut.CollType[coll],
                          ut.MemoryType.HOST, 1 << 16, COMPS)
        ref = candidates(jobs["ref_teams"][r], ucc_tpu.CollType[coll],
                         ucc_tpu.MemoryType.HOST, 1 << 16, COMPS)
        assert mine == ref
        assert mine[0][1] in ("nrab", "nstep", "nlvl")


def test_a_two_level_cap_keeps_the_classic_split():
    out = {}
    for side, mod in (("ref", ucc_tpu), ("mine", ut)):
        job = HierJob(mod, N, UCC_CL_HIER_LEVELS="2", **LAYOUT)
        try:
            teams = job.team()
            ht = hier_team_of(teams[0])
            out[side] = (ht.n_levels, [lv.groups for lv in ht.tree.levels],
                         candidates(teams[0], mod.CollType.ALLREDUCE,
                                    mod.MemoryType.HOST, 4096, COMPS))
        finally:
            job.cleanup()
    assert out["mine"] == out["ref"]
    assert out["mine"][0] == 2 and out["mine"][2][0][1] == "rab"


# ---------------------------------------------------------------------------
# collectives over the 3-level tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count", [1, 37, 4096])
def test_allreduce(jobs, count):
    def build(mod):
        srcs = [_data(1, count, np.float32, r) for r in range(N)]
        dsts = [np.zeros(count, np.float32) for _ in range(N)]
        return [mod.CollArgs(
            coll_type=mod.CollType.ALLREDUCE, op=mod.ReductionOp.SUM,
            src=mod.BufferInfo(srcs[r], count, mod.DataType.FLOAT32),
            dst=mod.BufferInfo(dsts[r], count, mod.DataType.FLOAT32))
            for r in range(N)], dsts

    _both(jobs, build, "nrab")


@pytest.mark.parametrize("dtype", ["FLOAT64", "INT32"])
def test_allreduce_avg_inplace(jobs, dtype):
    nd = np.float64 if dtype == "FLOAT64" else np.int32
    count = 65

    def build(mod):
        bufs = [_data(2, count, nd, r) for r in range(N)]
        return [mod.CollArgs(
            coll_type=mod.CollType.ALLREDUCE, op=mod.ReductionOp.AVG,
            dst=mod.BufferInfo(bufs[r], count, mod.DataType[dtype]),
            flags=mod.CollArgsFlags.IN_PLACE) for r in range(N)], bufs

    _both(jobs, build, "nrab")


# roots at every tree position: the pod/global leader, a node leader that
# is no pod leader, a plain member, the single-rank node's rank
@pytest.mark.parametrize("root", [0, 2, 4, 6, 7])
def test_bcast(jobs, root):
    count = 50

    def build(mod):
        bufs = [_data(3, count, np.float32, r) if r == root else
                np.zeros(count, np.float32) for r in range(N)]
        return [mod.CollArgs(
            coll_type=mod.CollType.BCAST, root=root,
            src=mod.BufferInfo(bufs[r], count, mod.DataType.FLOAT32))
            for r in range(N)], bufs

    _both(jobs, build, "nstep")


@pytest.mark.parametrize("op", ["SUM", "AVG"])
@pytest.mark.parametrize("root", [0, 2, 5, 6])
def test_reduce(jobs, root, op):
    count = 29

    def build(mod):
        srcs = [_data(4, count, np.float32, r) for r in range(N)]
        dst = np.zeros(count, np.float32)
        return [mod.CollArgs(
            coll_type=mod.CollType.REDUCE, root=root, op=mod.ReductionOp[op],
            src=mod.BufferInfo(srcs[r], count, mod.DataType.FLOAT32),
            dst=mod.BufferInfo(dst, count, mod.DataType.FLOAT32)
            if r == root else None) for r in range(N)], [dst]

    _both(jobs, build, "nstep")


def test_reduce_inplace_at_a_plain_member(jobs):
    count = 31
    root = 4

    def build(mod):
        bufs = [_data(5, count, np.float64, r) for r in range(N)]
        return [mod.CollArgs(
            coll_type=mod.CollType.REDUCE, root=root, op=mod.ReductionOp.SUM,
            src=None if r == root else
            mod.BufferInfo(bufs[r], count, mod.DataType.FLOAT64),
            dst=mod.BufferInfo(bufs[r], count, mod.DataType.FLOAT64)
            if r == root else None,
            flags=mod.CollArgsFlags.IN_PLACE if r == root else
            mod.CollArgsFlags(0)) for r in range(N)], [bufs[root]]

    _both(jobs, build, "nstep")


def test_barrier(jobs):
    def build(mod):
        return [mod.CollArgs(coll_type=mod.CollType.BARRIER)
                for _ in range(N)], []

    _both(jobs, build, "nlvl")


@pytest.mark.parametrize("blk", [1, 3])
def test_allgather(jobs, blk):
    def build(mod):
        srcs = [_data(6, blk, np.float32, r) for r in range(N)]
        dsts = [np.zeros(blk * N, np.float32) for _ in range(N)]
        return [mod.CollArgs(
            coll_type=mod.CollType.ALLGATHER,
            src=mod.BufferInfo(srcs[r], blk, mod.DataType.FLOAT32),
            dst=mod.BufferInfo(dsts[r], blk * N, mod.DataType.FLOAT32))
            for r in range(N)], dsts

    _both(jobs, build, "nlvl")


@pytest.mark.parametrize("gapped", [False, True])
def test_allgatherv_uneven(jobs, gapped):
    counts = [r + 1 for r in range(N)]
    displs = [sum(counts[:r]) + (r if gapped else 0) for r in range(N)]
    span = displs[-1] + counts[-1]

    def build(mod):
        srcs = [_data(7, counts[r], np.int32, r) for r in range(N)]
        dsts = [np.full(span, -1, np.int32) for _ in range(N)]
        return [mod.CollArgs(
            coll_type=mod.CollType.ALLGATHERV,
            src=mod.BufferInfo(srcs[r], counts[r], mod.DataType.INT32),
            dst=mod.BufferInfoV(dsts[r], counts, displs, mod.DataType.INT32))
            for r in range(N)], dsts

    _both(jobs, build, "nlvl")


def test_cuda_allreduce_on_the_three_level_layout(jobs):
    """CUDA memory on the same team: rab_tpu over the NODE units and the
    node leaders (device "cpu"), the bits of the host nrab's result on
    integer-valued data."""
    import torch
    count = 96
    vals = [np.random.default_rng(8 + r).integers(-64, 64, count).astype(
        np.float32) for r in range(N)]
    dsts = [torch.zeros(count) for _ in range(N)]
    names = jobs["mine"].run(jobs["mine_teams"], [ut.CollArgs(
        coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
        src=ut.BufferInfo(torch.from_numpy(vals[r].copy()), count,
                          ut.DataType.FLOAT32, mem_type=ut.MemoryType.CUDA),
        dst=ut.BufferInfo(dsts[r], count, ut.DataType.FLOAT32,
                          mem_type=ut.MemoryType.CUDA)) for r in range(N)])
    assert names == ["rab_tpu"] * N
    want = np.sum(vals, axis=0)
    for d in dsts:
        np.testing.assert_array_equal(d.numpy(), want)
