"""The port's cl/hier on HOST memory, held bitwise against the JAX
package's: tests/test_cl_hier.py's cases (8 in-process ranks, two fake
nodes of 4) on the same seeded numpy inputs through both packages, plus
the host ring's rank reorder on a team whose ranks interleave nodes and
the RAB leaders' stage picking the one-sided sliding window.

The port's host TLs are bitwise the JAX package's, and cl/hier composes
them along the same units, so every result must match bit for bit, with
the same selected algorithm, candidate lists and ``print_info`` rows.
"""
import numpy as np
import pytest

import ucc_tpu
import ucc_tpu_torch as ut
from ucc_tpu.topo.sbgp import SbgpType as JSbgpType
from ucc_tpu_torch.topo.sbgp import SbgpType

from torch_hier_cases import (N, HierJob, bits, candidates, hier_rows,
                              hier_team_of)

PPN = "4"
HOST_COMPS = ("hier", "shm", "socket", "self")


@pytest.fixture(scope="module")
def jobs():
    ref = HierJob(ucc_tpu, N, UCC_TOPO_FAKE_PPN=PPN)
    mine = HierJob(ut, N, UCC_TOPO_FAKE_PPN=PPN)
    pair = {"ref": ref, "mine": mine,
            "ref_teams": ref.team(), "mine_teams": mine.team()}
    yield pair
    ref.cleanup()
    mine.cleanup()


def _dt(mod, name):
    return mod.DataType[name]


def _data(seed, count, nd, rank):
    rng = np.random.default_rng(seed * 1000 + rank)
    if np.issubdtype(nd, np.floating):
        return (rng.random(count) * 4 - 2).astype(nd)
    return rng.integers(-50, 50, size=count).astype(nd)


def _bf16(x):
    import ml_dtypes
    return x.astype(np.float32).astype(ml_dtypes.bfloat16)


def _both(jobs, build, key=""):
    """Run ``build(mod)`` -> (argses, outputs) through both packages'
    teams (``<side>_teams<key>``); returns (ref outputs, port outputs,
    ref alg names, port alg names)."""
    got = {}
    for side, mod in (("ref", ucc_tpu), ("mine", ut)):
        argses, outs = build(mod)
        names = jobs[side].run(jobs[f"{side}_teams{key}"], argses)
        got[side] = ([np.array(o, copy=True) for o in outs], names)
    return got["ref"][0], got["mine"][0], got["ref"][1], got["mine"][1]


def _same(ref, mine):
    assert len(ref) == len(mine)
    for a, b in zip(ref, mine):
        assert a.shape == b.shape
        np.testing.assert_array_equal(bits(b), bits(a))


# ---------------------------------------------------------------------------
# topology and selection
# ---------------------------------------------------------------------------

def test_units_match(jobs):
    for r in range(N):
        a = hier_team_of(jobs["mine_teams"][r])
        b = hier_team_of(jobs["ref_teams"][r])
        assert a is not None and b is not None
        for st in ("NODE", "NODE_LEADERS", "NET", "FULL"):
            ua, ub = a.sbgp(SbgpType[st]), b.sbgp(JSbgpType[st])
            assert (ua is None) == (ub is None), (r, st)
            if ua is not None:
                assert (ua.sbgp.size, ua.sbgp.group_rank,
                        ua.sbgp.map.to_array().tolist()) == \
                    (ub.sbgp.size, ub.sbgp.group_rank,
                     ub.sbgp.map.to_array().tolist())
        assert a.tree.describe() == b.tree.describe()
        assert a.is_node_leader == b.is_node_leader


def test_describe_topology_names_the_units(jobs):
    text = hier_team_of(jobs["mine_teams"][0]).describe_topology()
    ref = hier_team_of(jobs["ref_teams"][0]).describe_topology()
    # the NODE unit's device TL is torch_ops where the reference has xla
    assert text == ref.replace("xla", "torch_ops")


def test_hier_rows_match(jobs):
    assert hier_rows(jobs["mine_teams"][0], ut) == \
        hier_rows(jobs["ref_teams"][0], ucc_tpu)


@pytest.mark.parametrize("coll", ["ALLREDUCE", "BCAST", "REDUCE", "BARRIER",
                                  "ALLGATHERV", "ALLGATHER", "ALLTOALL",
                                  "ALLTOALLV", "REDUCE_SCATTER", "GATHER"])
@pytest.mark.parametrize("msgsize", [0, 256, 4096, 1 << 20])
def test_host_candidates_match(jobs, coll, msgsize):
    for r in (0, 3, 4):
        mine = candidates(jobs["mine_teams"][r], ut.CollType[coll],
                          ut.MemoryType.HOST, msgsize, HOST_COMPS)
        ref = candidates(jobs["ref_teams"][r], ucc_tpu.CollType[coll],
                         ucc_tpu.MemoryType.HOST, msgsize, HOST_COMPS)
        assert mine == ref, r


def test_hier_wins_selection(jobs):
    cands = jobs["mine_teams"][0].score_map.lookup(
        ut.CollType.ALLREDUCE, ut.MemoryType.HOST, 1 << 20)
    assert cands[0].alg_name == "rab"


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count", [1, 40, 4096])
@pytest.mark.parametrize("dtype", ["FLOAT32", "FLOAT64", "INT32"])
def test_rab_sum(jobs, count, dtype):
    nd = {"FLOAT32": np.float32, "FLOAT64": np.float64,
          "INT32": np.int32}[dtype]

    def build(mod):
        srcs = [_data(1, count, nd, r) for r in range(N)]
        dsts = [np.zeros(count, nd) for _ in range(N)]
        return [mod.CollArgs(
            coll_type=mod.CollType.ALLREDUCE, op=mod.ReductionOp.SUM,
            src=mod.BufferInfo(srcs[r], count, _dt(mod, dtype)),
            dst=mod.BufferInfo(dsts[r], count, _dt(mod, dtype)))
            for r in range(N)], dsts

    ref, mine, rn, mn = _both(jobs, build)
    assert mn == rn == ["rab"] * N
    _same(ref, mine)


@pytest.mark.parametrize("op", ["AVG", "MAX", "PROD"])
def test_rab_ops(jobs, op):
    count = 33

    def build(mod):
        srcs = [_data(2, count, np.float64, r) for r in range(N)]
        dsts = [np.zeros(count, np.float64) for _ in range(N)]
        return [mod.CollArgs(
            coll_type=mod.CollType.ALLREDUCE, op=mod.ReductionOp[op],
            src=mod.BufferInfo(srcs[r], count, mod.DataType.FLOAT64),
            dst=mod.BufferInfo(dsts[r], count, mod.DataType.FLOAT64))
            for r in range(N)], dsts

    ref, mine, rn, mn = _both(jobs, build)
    assert mn == rn
    _same(ref, mine)


@pytest.mark.parametrize("dtype", ["BFLOAT16", "INT32", "FLOAT16"])
def test_rab_avg_scales_like_the_reference(jobs, dtype):
    """AVG divides at the leader: bfloat16 as float32 rounded to nearest
    even, integers truncated, as the JAX package's numpy does."""
    count = 50

    def build(mod):
        vals = [_data(3, count, np.float32, r) * 8 for r in range(N)]
        if dtype == "BFLOAT16":
            srcs = [_bf16(v) if mod is ucc_tpu else
                    _bf16(v).view(np.uint16) for v in vals]
            dsts = [np.zeros(count, s.dtype) for s in srcs]
        else:
            nd = np.int32 if dtype == "INT32" else np.float16
            srcs = [v.astype(nd) for v in vals]
            dsts = [np.zeros(count, nd) for _ in range(N)]
        return [mod.CollArgs(
            coll_type=mod.CollType.ALLREDUCE, op=mod.ReductionOp.AVG,
            src=mod.BufferInfo(srcs[r], count, _dt(mod, dtype)),
            dst=mod.BufferInfo(dsts[r], count, _dt(mod, dtype)))
            for r in range(N)], dsts

    ref, mine, rn, mn = _both(jobs, build)
    assert mn == rn
    _same(ref, mine)


def test_rab_inplace(jobs):
    count = 16

    def build(mod):
        bufs = [_data(4, count, np.float32, r) for r in range(N)]
        return [mod.CollArgs(
            coll_type=mod.CollType.ALLREDUCE, op=mod.ReductionOp.SUM,
            dst=mod.BufferInfo(bufs[r], count, mod.DataType.FLOAT32),
            flags=mod.CollArgsFlags.IN_PLACE) for r in range(N)], bufs

    ref, mine, _, _ = _both(jobs, build)
    _same(ref, mine)


def _tuned_pair(tune, ppn=PPN, n=N, **ctx):
    """A job pair whose teams are made under *tune* (UCC_CL_HIER_TUNE)
    and whose contexts under *ctx*."""
    ref = HierJob(ucc_tpu, n, UCC_TOPO_FAKE_PPN=ppn, **ctx)
    mine = HierJob(ut, n, UCC_TOPO_FAKE_PPN=ppn, **ctx)
    return {"ref": ref, "mine": mine,
            "ref_teams": ref.team(UCC_CL_HIER_TUNE=tune),
            "mine_teams": mine.team(UCC_CL_HIER_TUNE=tune)}


def _cleanup(pair):
    pair["ref"].cleanup()
    pair["mine"].cleanup()


@pytest.mark.parametrize("pipeline", ["", "thresh=0:fragsize=256:pdepth=2"])
@pytest.mark.parametrize("count", [64, 1000])
def test_split_rail(count, pipeline):
    pair = _tuned_pair(
        "allreduce:@split_rail:inf",
        UCC_CL_HIER_ALLREDUCE_SPLIT_RAIL_PIPELINE=pipeline or None)
    try:
        def build(mod):
            srcs = [_data(5, count, np.float64, r) for r in range(N)]
            dsts = [np.zeros(count, np.float64) for _ in range(N)]
            return [mod.CollArgs(
                coll_type=mod.CollType.ALLREDUCE, op=mod.ReductionOp.SUM,
                src=mod.BufferInfo(srcs[r], count, mod.DataType.FLOAT64),
                dst=mod.BufferInfo(dsts[r], count, mod.DataType.FLOAT64))
                for r in range(N)], dsts

        argses, _ = build(ut)
        reqs = pair["mine"].init(pair["mine_teams"], argses)
        from ucc_tpu_torch.schedule.pipelined import PipelinedSchedule
        assert isinstance(reqs[0].task, PipelinedSchedule) == bool(pipeline)
        for rq in reqs:
            rq.finalize()
        ref, mine, rn, mn = _both(pair, build)
        assert mn == rn == ["split_rail"] * N
        _same(ref, mine)
    finally:
        _cleanup(pair)


@pytest.mark.parametrize("order", ["sequential", "ordered", "parallel"])
def test_rab_pipelined(order):
    n = 4
    pair = _tuned_pair(
        "", ppn="2", n=n,
        UCC_CL_HIER_ALLREDUCE_RAB_PIPELINE=f"thresh=64:fragsize=256:"
        f"nfrags=4:pdepth=2:{order}")
    try:
        count = 1000

        def build(mod):
            srcs = [_data(6, count, np.float32, r) for r in range(n)]
            dsts = [np.zeros(count, np.float32) for _ in range(n)]
            return [mod.CollArgs(
                coll_type=mod.CollType.ALLREDUCE, op=mod.ReductionOp.SUM,
                src=mod.BufferInfo(srcs[r], count, mod.DataType.FLOAT32),
                dst=mod.BufferInfo(dsts[r], count, mod.DataType.FLOAT32))
                for r in range(n)], dsts

        ref, mine, rn, mn = _both(pair, build)
        assert mn == rn == ["rab"] * n
        _same(ref, mine)
    finally:
        _cleanup(pair)


# ---------------------------------------------------------------------------
# rooted, barrier, allgather(v), alltoall(v)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("root", [0, 3, 5])
def test_bcast_2step(jobs, root):
    count = 50

    def build(mod):
        bufs = [_data(7, count, np.int32, r) if r == root else
                np.zeros(count, np.int32) for r in range(N)]
        return [mod.CollArgs(
            coll_type=mod.CollType.BCAST, root=root,
            src=mod.BufferInfo(bufs[r], count, mod.DataType.INT32))
            for r in range(N)], bufs

    ref, mine, rn, mn = _both(jobs, build)
    assert mn == rn == ["2step"] * N
    _same(ref, mine)


@pytest.mark.parametrize("op", ["SUM", "AVG"])
@pytest.mark.parametrize("root", [0, 4, 6])
def test_reduce_2step(jobs, root, op):
    count = 24

    def build(mod):
        srcs = [_data(8, count, np.float32, r) for r in range(N)]
        dst = np.zeros(count, np.float32)
        return [mod.CollArgs(
            coll_type=mod.CollType.REDUCE, root=root, op=mod.ReductionOp[op],
            src=mod.BufferInfo(srcs[r], count, mod.DataType.FLOAT32),
            dst=mod.BufferInfo(dst, count, mod.DataType.FLOAT32)
            if r == root else None) for r in range(N)], [dst]

    ref, mine, rn, mn = _both(jobs, build)
    assert mn == rn == ["2step"] * N
    _same(ref, mine)


def test_barrier(jobs):
    def build(mod):
        return [mod.CollArgs(coll_type=mod.CollType.BARRIER)
                for _ in range(N)], []

    _, _, rn, mn = _both(jobs, build)
    assert mn == rn == ["knomial_hier"] * N


@pytest.mark.parametrize("gapped", [False, True])
def test_allgatherv_unpack(jobs, gapped):
    counts = [2, 5, 1, 3, 4, 2, 6, 1]
    displs = [sum(counts[:r]) + (2 * r if gapped else 0) for r in range(N)]
    span = displs[-1] + counts[-1]

    def build(mod):
        srcs = [_data(9, counts[r], np.float32, r) for r in range(N)]
        dsts = [np.full(span, -1, np.float32) for _ in range(N)]
        return [mod.CollArgs(
            coll_type=mod.CollType.ALLGATHERV,
            src=mod.BufferInfo(srcs[r], counts[r], mod.DataType.FLOAT32),
            dst=mod.BufferInfoV(dsts[r], counts, displs,
                                mod.DataType.FLOAT32))
            for r in range(N)], dsts

    ref, mine, rn, mn = _both(jobs, build)
    assert mn == rn == ["unpack"] * N
    _same(ref, mine)


@pytest.mark.parametrize("blk", [1, 3])
@pytest.mark.parametrize("inplace", [False, True])
def test_alltoall_node_agg(jobs, blk, inplace):
    total = N * blk

    def build(mod):
        srcs = [_data(10, total, np.int32, r) for r in range(N)]
        if inplace:
            return [mod.CollArgs(
                coll_type=mod.CollType.ALLTOALL,
                dst=mod.BufferInfo(srcs[r], total, mod.DataType.INT32),
                flags=mod.CollArgsFlags.IN_PLACE) for r in range(N)], srcs
        dsts = [np.zeros(total, np.int32) for _ in range(N)]
        return [mod.CollArgs(
            coll_type=mod.CollType.ALLTOALL,
            src=mod.BufferInfo(srcs[r], total, mod.DataType.INT32),
            dst=mod.BufferInfo(dsts[r], total, mod.DataType.INT32))
            for r in range(N)], dsts

    ref, mine, rn, mn = _both(jobs, build)
    assert mn == rn == ["node_agg"] * N
    _same(ref, mine)


def test_alltoall_inplace_persistent_repost(jobs):
    """A persistent in-place node-agg alltoall snapshots at every post,
    not at init: re-posts read fresh data."""
    total = N
    got = {}
    for side, mod in (("ref", ucc_tpu), ("mine", ut)):
        bufs = [np.zeros(total, np.float32) for _ in range(N)]
        reqs = jobs[side].init(jobs[f"{side}_teams"], [mod.CollArgs(
            coll_type=mod.CollType.ALLTOALL,
            dst=mod.BufferInfo(bufs[r], total, mod.DataType.FLOAT32),
            flags=mod.CollArgsFlags.IN_PLACE | mod.CollArgsFlags.PERSISTENT)
            for r in range(N)])
        rounds = []
        for it in (1, 2):
            for r in range(N):
                bufs[r][:] = np.arange(total) + 100 * r + 1000 * it
            jobs[side].post_wait(reqs)
            rounds.append([b.copy() for b in bufs])
        for rq in reqs:
            rq.finalize()
        got[side] = rounds
    for a, b in zip(got["ref"], got["mine"]):
        _same(a, b)
    # round 2 carries round 2's data: rank 0's block 1 is rank 1's block 0
    assert got["mine"][1][0][1] == 100 + 2000


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("gapped", [False, True])
def test_alltoallv_node_agg(jobs, seed, gapped):
    m = np.random.default_rng(seed).integers(0, 6, size=(N, N))

    def build(mod):
        argses, dsts = [], []
        for r in range(N):
            scounts = [int(c) for c in m[r]]
            rcounts = [int(m[p][r]) for p in range(N)]
            rdispls = [sum(rcounts[:p]) + (3 * p if gapped else 0)
                       for p in range(N)]
            src = _data(seed, sum(scounts), np.int64, r)
            dst = np.full(rdispls[-1] + rcounts[-1], -1, np.int64)
            dsts.append(dst)
            argses.append(mod.CollArgs(
                coll_type=mod.CollType.ALLTOALLV,
                src=mod.BufferInfoV(src, scounts, None, mod.DataType.INT64),
                dst=mod.BufferInfoV(dst, rcounts, rdispls,
                                    mod.DataType.INT64)))
        return argses, dsts

    ref, mine, rn, mn = _both(jobs, build)
    assert mn == rn == ["node_agg"] * N
    _same(ref, mine)


# ---------------------------------------------------------------------------
# the host ring's rank reorder, the one-sided leaders' stage
# ---------------------------------------------------------------------------

class TestTopoOrderedRing:
    def test_allreduce_ring_reorders_on_multinode(self, jobs):
        """Ring allreduce over FULL_HOST_ORDERED on a team whose ranks
        alternate fake nodes: the subset reorders, and the result is the
        reference's bit for bit."""
        count = 4096
        ranks = [0, 4, 1, 5]
        out = {}
        for side, mod in (("ref", ucc_tpu), ("mine", ut)):
            teams = jobs[side].team(ranks,
                                    UCC_TL_SHM_TUNE="allreduce:@ring:inf")
            srcs = [_data(12, count, np.float32, r) for r in range(4)]
            dsts = [np.zeros(count, np.float32) for _ in range(4)]
            names = jobs[side].run(teams, [mod.CollArgs(
                coll_type=mod.CollType.ALLREDUCE, op=mod.ReductionOp.SUM,
                src=mod.BufferInfo(srcs[r], count, mod.DataType.FLOAT32),
                dst=mod.BufferInfo(dsts[r], count, mod.DataType.FLOAT32))
                for r in range(4)])
            shm = [t for cl in teams[0].cl_teams if cl.name == "basic"
                   for t in cl.tl_teams if t.name == "shm"][0]
            ss = shm.topo_ordered_subset()
            out[side] = (dsts, names, ss.map.to_array().tolist(),
                         shm._ag_large_alg())
        assert out["mine"][1] == out["ref"][1] == ["ring"] * 4
        assert out["mine"][2] == out["ref"][2] != [0, 1, 2, 3]
        assert out["mine"][3] == out["ref"][3] == "ring"
        _same(out["ref"][0], out["mine"][0])

    def test_single_node_team_does_not_reorder(self, jobs):
        teams = jobs["mine"].team([0, 1, 2, 3])
        shm = [t for cl in teams[0].cl_teams if cl.name == "basic"
               for t in cl.tl_teams if t.name == "shm"][0]
        assert shm.topo_ordered_subset() is None
        assert hier_team_of(teams[0]) is None


def test_hier_leaders_pick_sliding_window():
    """The RAB leaders' allreduce stage selects the one-sided sliding
    window through a plain TL TUNE; compared over integer data (the
    window reduces in get-completion order)."""
    n, count = 4, 512
    out = {}
    for side, mod in (("ref", ucc_tpu), ("mine", ut)):
        job = HierJob(mod, n, UCC_TOPO_FAKE_PPN="2")
        try:
            teams = job.team(UCC_TL_SHM_TUNE="allreduce:@sliding_window")
            srcs = [_data(13, count, np.int64, r).astype(np.float64)
                    for r in range(n)]
            dsts = [np.zeros(count, np.float64) for _ in range(n)]
            names = job.run(teams, [mod.CollArgs(
                coll_type=mod.CollType.ALLREDUCE, op=mod.ReductionOp.SUM,
                src=mod.BufferInfo(srcs[r], count, mod.DataType.FLOAT64),
                dst=mod.BufferInfo(dsts[r], count, mod.DataType.FLOAT64))
                for r in range(n)])
            sbgp_type = SbgpType if mod is ut else JSbgpType
            leaders = hier_team_of(teams[0]).sbgp(sbgp_type.NODE_LEADERS)
            lead = leaders.score_map.lookup(mod.CollType.ALLREDUCE,
                                            mod.MemoryType.HOST, count * 8)
            out[side] = (dsts, names, lead[0].alg_name)
            np.testing.assert_array_equal(dsts[0], np.sum(srcs, axis=0))
        finally:
            job.cleanup()
    assert out["mine"][1] == out["ref"][1] == ["rab"] * n
    assert out["mine"][2] == out["ref"][2] == "sliding_window"
    _same(out["ref"][0], out["mine"][0])


def test_single_node_team_keeps_its_candidate_lists():
    """With CLS=basic,hier a team on one node drops cl/hier quietly: its
    candidates are those of CLS=basic."""
    lists = {}
    for cls in ("basic", "basic,hier"):
        job = HierJob(ut, 4, UCC_CLS=cls)
        try:
            teams = job.team()
            assert [c.name for c in teams[0].cl_teams] == ["basic"]
            lists[cls] = teams[0].score_map.print_info("t")
        finally:
            job.cleanup()
    assert lists["basic"] == lists["basic,hier"]


def _captured(logger_name, level):
    """A handler that keeps the records of *logger_name* at *level*."""
    import logging

    class Keep(logging.Handler):
        def __init__(self):
            super().__init__(level)
            self.lines, self.levels = [], []

        def emit(self, record):
            self.lines.append(record.getMessage())
            self.levels.append(record.levelno)

    logger = logging.getLogger(logger_name)
    return logger, Keep()


@pytest.mark.parametrize("fake", ["2", ""])
def test_coll_trace_logs_the_topology_and_no_warning(fake):
    """Under UCC_COLL_TRACE each CL's resolved topology is logged beside
    the score map at activation; a one-node team drops cl/hier without a
    warning."""
    import logging
    logger, keep = _captured("ucc_tpu_torch.core", logging.DEBUG)
    old = logger.level
    logger.addHandler(keep)
    logger.setLevel(logging.DEBUG)
    try:
        job = HierJob(ut, 4, UCC_TOPO_FAKE_PPN=fake or None,
                      UCC_COLL_TRACE="y")
        try:
            job.team()
        finally:
            job.cleanup()
    finally:
        logger.removeHandler(keep)
        logger.setLevel(old)
    topo = [x for x in keep.lines if "hier topology:" in x]
    if fake:
        assert len(topo) == 4
        assert "hier tree: 2 levels over 4 ranks" in topo[0]
    else:
        assert not topo
        # the drop is a debug line; nothing at warning level or above
        assert any("CL hier team create skipped" in x for x in keep.lines)
    assert all(lv < logging.WARNING for lv in keep.levels), keep.lines
