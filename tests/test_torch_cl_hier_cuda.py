"""The port's cl/hier on CUDA memory (device "cpu"), held against the JAX
package's cl/hier on TPU memory over 8 virtual CPU devices:
tests/test_cl_hier_tpu.py's cases on the same seeded inputs. Selection
must match (``rab_tpu`` with the NODE unit's torch_ops team where the
reference has xla; the staged rows), results must be bitwise the
reference's on integer-valued data and within float32 tolerance on
random data. The port writes every result into the caller's tensor.
"""
import numpy as np
import pytest
import torch

import ucc_tpu
import ucc_tpu_torch as ut
from ucc_tpu.topo.sbgp import SbgpType as JSbgpType
from ucc_tpu_torch.topo.sbgp import SbgpType

from torch_hier_cases import (N, HierJob, bits, candidates, hier_team_of,
                              port_cuda, ref_tpu, result)

pytest.importorskip("jax")

PPN = "4"


def _pair(n=N, ppn=PPN, tune=None, **ctx):
    ref = HierJob(ucc_tpu, n, UCC_TOPO_FAKE_PPN=ppn, **ctx)
    mine = HierJob(ut, n, UCC_TOPO_FAKE_PPN=ppn, **ctx)
    return {"n": n, "ref": ref, "mine": mine,
            "ref_teams": ref.team(UCC_CL_HIER_TUNE=tune),
            "mine_teams": mine.team(UCC_CL_HIER_TUNE=tune)}


def _cleanup(pair):
    pair["ref"].cleanup()
    pair["mine"].cleanup()


@pytest.fixture(scope="module")
def jobs():
    pair = _pair()
    yield pair
    _cleanup(pair)


def _ints(seed, count, rank, nd=np.float32):
    rng = np.random.default_rng(seed * 100 + rank)
    return rng.integers(-64, 64, size=count).astype(nd)


def _floats(seed, count, rank):
    rng = np.random.default_rng(seed * 100 + rank)
    return (rng.random(count) * 4 - 2).astype(np.float32)


class Buf:
    """A rank's buffer on both sides: *data* (numpy) or, for a result, a
    dst of *size* elements (the port's tensor filled with 7s; the
    reference's dst has no buffer, its device TLs rebind it); *counts*
    and *displs* make it a BufferInfoV."""

    def __init__(self, data=None, size=None, counts=None, displs=None):
        self.data, self.counts, self.displs = data, counts, displs
        self.size = int(data.size) if size is None else int(size)
        self.dtype = None if data is None else data.dtype


def _bi(mod, job, r, b, dt, nd):
    if b is None:
        return None
    if mod is ut:
        buf = port_cuda(b.data) if b.data is not None else \
            port_cuda(np.full(b.size, 7, nd))
        mt = ut.MemoryType.CUDA
    else:
        buf = ref_tpu(job, r, b.data) if b.data is not None else None
        mt = ucc_tpu.MemoryType.TPU
    if b.counts is not None:
        return mod.BufferInfoV(buf, b.counts, b.displs, dt, mem_type=mt)
    return mod.BufferInfo(buf, b.size, dt, mem_type=mt)


def _run(pair, coll, bufs, dtype="FLOAT32", op=None, root=0, flags=(),
         rounds=1):
    """*coll* on both sides, rank r passing ``bufs[r] = (src, dst)``;
    returns {side: (per-rank results as numpy, alg names)}."""
    out = {}
    nd = {"FLOAT32": np.float32, "FLOAT64": np.float64,
          "INT32": np.int32}[dtype]
    for side, mod in (("ref", ucc_tpu), ("mine", ut)):
        job = pair[side]
        dt = mod.DataType[dtype]
        fl = mod.CollArgsFlags(0)
        for f in flags:
            fl |= mod.CollArgsFlags[f]
        argses = [mod.CollArgs(
            coll_type=mod.CollType[coll], root=root,
            op=None if op is None else mod.ReductionOp[op],
            src=_bi(mod, job, r, s, dt, nd), dst=_bi(mod, job, r, d, dt, nd),
            flags=fl) for r, (s, d) in enumerate(bufs)]
        names = job.run(pair[f"{side}_teams"], argses, rounds)
        res = []
        for a in argses:
            bi = a.dst if a.dst is not None else a.src
            res.append(None if bi is None or bi.buffer is None
                       else result(bi))
        out[side] = (res, names)
    return out


def _bitwise(out, ranks=None):
    ref, mine = out["ref"][0], out["mine"][0]
    for r in (range(len(ref)) if ranks is None else ranks):
        assert mine[r] is not None and ref[r] is not None, r
        np.testing.assert_array_equal(bits(mine[r].reshape(-1)),
                                      bits(ref[r].reshape(-1)))


def _close(out):
    for a, b in zip(out["ref"][0], out["mine"][0]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

class TestSelection:
    def test_cuda_allreduce_selects_rab_tpu(self, jobs):
        cands = jobs["mine_teams"][0].score_map.lookup(
            ut.CollType.ALLREDUCE, ut.MemoryType.CUDA, 1 << 16)
        assert cands[0].alg_name == "rab_tpu"

    def test_node_unit_has_a_torch_ops_team(self, jobs):
        for r in range(N):
            ht = hier_team_of(jobs["mine_teams"][r])
            mine = [t.NAME for t in ht.sbgp(SbgpType.NODE).tl_teams]
            ref = [t.NAME for t in hier_team_of(
                jobs["ref_teams"][r]).sbgp(JSbgpType.NODE).tl_teams]
            assert "torch_ops" in mine and "xla" in ref
            assert sorted(mine) == sorted(
                "torch_ops" if x == "xla" else x for x in ref)

    def test_device_tls_rendezvous_by_physical_process(self, jobs):
        """The fake topology rewrites the topology identity only: every
        context keeps its physical (hostname, pid), so the 8-rank device
        teams over both fake nodes (cl/basic's, the FULL unit's) are one
        in-process rendezvous, while the topology sees two nodes."""
        import os
        import socket
        ctxs = jobs["mine"].contexts
        assert {c.proc for c in ctxs} == {(socket.gethostname(),
                                           os.getpid())}
        assert ctxs[0].topo.nnodes == 2
        assert len({c.proc_info.host_hash for c in ctxs}) == 2
        from ucc_tpu_torch.topo.proc_info import host_hash
        assert {c.proc_info.real_host_hash for c in ctxs} == {host_hash()}
        team = jobs["mine_teams"][0]
        basic = [cl for cl in team.cl_teams if cl.name == "basic"][0]
        full = hier_team_of(team).sbgp(SbgpType.FULL)
        for tls in (basic.tl_teams, full.tl_teams):
            ops = [t for t in tls if t.NAME == "torch_ops"]
            assert ops and ops[0].size == N and not ops[0].spanning

    @pytest.mark.parametrize("coll", ["ALLREDUCE", "BCAST", "REDUCE",
                                      "BARRIER", "ALLGATHERV", "ALLGATHER",
                                      "ALLTOALL", "ALLTOALLV"])
    @pytest.mark.parametrize("msgsize", [0, 4096, 1 << 24])
    def test_hier_cuda_rows_match(self, jobs, coll, msgsize):
        for r in (0, 5):
            mine = candidates(jobs["mine_teams"][r], ut.CollType[coll],
                              ut.MemoryType.CUDA, msgsize, ("hier",))
            ref = candidates(jobs["ref_teams"][r], ucc_tpu.CollType[coll],
                             ucc_tpu.MemoryType.TPU, msgsize, ("hier",))
            assert mine == ref and mine


# ---------------------------------------------------------------------------
# allreduce: rab_tpu
# ---------------------------------------------------------------------------

class TestRabTpu:
    @pytest.mark.parametrize("count", [16, 1000])
    def test_sum_bitwise_on_integers(self, jobs, count):
        out = _run(jobs, "ALLREDUCE", [
            (Buf(_ints(1, count, r)), Buf(size=count)) for r in range(N)],
            op="SUM")
        assert out["mine"][1] == out["ref"][1] == ["rab_tpu"] * N
        _bitwise(out)

    def test_sum_random_floats(self, jobs):
        out = _run(jobs, "ALLREDUCE", [
            (Buf(_floats(2, 777, r)), Buf(size=777)) for r in range(N)],
            op="SUM")
        _close(out)

    @pytest.mark.parametrize("dtype", ["FLOAT32", "INT32"])
    def test_avg(self, jobs, dtype):
        nd = np.float32 if dtype == "FLOAT32" else np.int32
        out = _run(jobs, "ALLREDUCE", [
            (Buf(_ints(3, 64, r, nd)), Buf(size=64)) for r in range(N)],
            dtype=dtype, op="AVG")
        _bitwise(out)

    def test_inplace_f64(self, jobs):
        out = _run(jobs, "ALLREDUCE", [
            (None, Buf(_ints(4, 32, r, np.float64))) for r in range(N)],
            dtype="FLOAT64", op="SUM", flags=("IN_PLACE",))
        # the reference's jax arrays are float32 (x64 off): equal values
        for a, b in zip(out["ref"][0], out["mine"][0]):
            assert b.dtype == np.float64
            np.testing.assert_array_equal(b, a.astype(np.float64))

    def test_max(self, jobs):
        out = _run(jobs, "ALLREDUCE", [
            (Buf(_floats(5, 100, r)), Buf(size=100)) for r in range(N)],
            op="MAX")
        _bitwise(out)

    def test_node_stages_run_on_the_device(self, jobs):
        """The rab_tpu schedule's node stages are torch_ops tasks, not the
        staged path's host chain."""
        t = [torch.zeros(8) for _ in range(N)]
        reqs = jobs["mine"].init(jobs["mine_teams"], [ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
            src=ut.BufferInfo(t[r].clone(), 8, ut.DataType.FLOAT32,
                              mem_type=ut.MemoryType.CUDA),
            dst=ut.BufferInfo(t[r], 8, ut.DataType.FLOAT32,
                              mem_type=ut.MemoryType.CUDA))
            for r in range(N)])
        stages = [getattr(x, "obs_stage", "") for x in reqs[0].task.tasks]
        kinds = {getattr(x, "obs_stage", ""): type(x).__name__
                 for x in reqs[0].task.tasks}
        assert stages[0] == "rab_tpu.node_reduce"
        assert stages[-1] == "rab_tpu.node_bcast"
        assert kinds["rab_tpu.node_reduce"] == "TorchOpsCollTask"
        assert kinds["rab_tpu.node_bcast"] == "TorchOpsCollTask"
        assert "rab_tpu.leaders.allreduce" in stages       # rank 0 leads
        jobs["mine"].post_wait(reqs)
        for rq in reqs:
            rq.finalize()

    def test_persistent_reposts(self, jobs):
        """Init once, post three times: new values copied into the same
        src, then src rebound to another tensor (the reference rebinds
        its jax arrays)."""
        count = 24
        srcs = [torch.ones(count) for _ in range(N)]
        dsts = [torch.zeros(count) for _ in range(N)]
        argses = [ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
            src=ut.BufferInfo(srcs[r], count, ut.DataType.FLOAT32,
                              mem_type=ut.MemoryType.CUDA),
            dst=ut.BufferInfo(dsts[r], count, ut.DataType.FLOAT32,
                              mem_type=ut.MemoryType.CUDA),
            flags=ut.CollArgsFlags.PERSISTENT) for r in range(N)]
        reqs = jobs["mine"].init(jobs["mine_teams"], argses)
        for it in range(3):
            for r in range(N):
                if it == 1:
                    srcs[r].fill_(2.0)
                elif it == 2:
                    argses[r].src.buffer = torch.full((count,), 3.0 + r)
            jobs["mine"].post_wait(reqs)
            want = [N, 2 * N, 3 * N + sum(range(N))][it]
            for r in range(N):
                assert torch.equal(dsts[r], torch.full((count,),
                                                       float(want))), it
        for rq in reqs:
            rq.finalize()


@pytest.mark.parametrize("order", ["sequential", "ordered"])
@pytest.mark.parametrize("count", [64, 1000])
def test_rab_tpu_pipelined(order, count):
    pair = _pair(UCC_CL_HIER_ALLREDUCE_RAB_PIPELINE=(
        f"thresh=64:fragsize=256:nfrags=4:pdepth=2:{order}"))
    try:
        out = _run(pair, "ALLREDUCE", [
            (Buf(_ints(6, count, r)), Buf(size=count)) for r in range(N)],
            op="SUM")
        assert out["mine"][1] == ["rab_tpu"] * N
        _bitwise(out)
        # the unpipelined path gives the same bits
        single = _pair()
        try:
            plain = _run(single, "ALLREDUCE", [
                (Buf(_ints(6, count, r)), Buf(size=count))
                for r in range(N)], op="SUM")
        finally:
            _cleanup(single)
        for a, b in zip(out["mine"][0], plain["mine"][0]):
            np.testing.assert_array_equal(bits(a), bits(b))
    finally:
        _cleanup(pair)


def test_rab_tpu_pipelined_avg_inplace():
    pair = _pair(UCC_CL_HIER_ALLREDUCE_RAB_PIPELINE=(
        "thresh=64:fragsize=128:nfrags=3:pdepth=2:sequential"))
    try:
        out = _run(pair, "ALLREDUCE", [
            (None, Buf(_ints(7, 300, r))) for r in range(N)], op="AVG",
            flags=("IN_PLACE",))
        _bitwise(out)
    finally:
        _cleanup(pair)


def test_rab_tpu_pipelined_persistent_reads_live_buffers():
    """Persistent re-posts: the fragments slice the caller's tensors at
    every post (a rebound src included), not the init-time ones."""
    pair = _pair(UCC_CL_HIER_ALLREDUCE_RAB_PIPELINE=(
        "thresh=64:fragsize=256:nfrags=4:pdepth=2:sequential"))
    try:
        count = 500
        dsts = [torch.zeros(count) for _ in range(N)]
        argses = [ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
            src=ut.BufferInfo(torch.ones(count), count, ut.DataType.FLOAT32,
                              mem_type=ut.MemoryType.CUDA),
            dst=ut.BufferInfo(dsts[r], count, ut.DataType.FLOAT32,
                              mem_type=ut.MemoryType.CUDA),
            flags=ut.CollArgsFlags.PERSISTENT) for r in range(N)]
        reqs = pair["mine"].init(pair["mine_teams"], argses)
        for val in (1.0, 2.0, 3.0):
            for r in range(N):
                argses[r].src.buffer = torch.full((count,), val)
            pair["mine"].post_wait(reqs)
            for r in range(N):
                assert torch.equal(dsts[r], torch.full((count,), N * val))
        for rq in reqs:
            rq.finalize()
    finally:
        _cleanup(pair)


@pytest.mark.parametrize("inplace", [False, True])
def test_staged_allreduce_pipelined(inplace):
    """Without device TLs the CUDA-memory allreduce takes the staged
    wrapper (its rows keep their names), pipelined by the RAB knob."""
    n = 4
    pair = _pair(n=n, ppn="2", UCC_TLS="shm,self",
                 UCC_CL_HIER_ALLREDUCE_RAB_PIPELINE=(
                     "thresh=64:fragsize=256:nfrags=4:pdepth=2:sequential"))
    try:
        count = 500
        for side, mod in (("ref", ucc_tpu), ("mine", ut)):
            mem = ut.MemoryType.CUDA if mod is ut else \
                ucc_tpu.MemoryType.TPU
            cands = pair[f"{side}_teams"][0].score_map.lookup(
                mod.CollType.ALLREDUCE, mem, count * 4)
            assert cands[0].alg_name == "rab_tpu"
        vals = [np.arange(count, dtype=np.float32) + r + 1 for r in range(n)]
        if inplace:
            bufs = [(None, Buf(vals[r])) for r in range(n)]
        else:
            bufs = [(Buf(vals[r]), Buf(size=count)) for r in range(n)]
        # the reference's staged path puts results on the default device
        out = _run(pair, "ALLREDUCE", bufs, op="SUM",
                   flags=("IN_PLACE",) if inplace else ())
        _bitwise(out)
        assert out["mine"][1] == ["rab_tpu"] * n
    finally:
        _cleanup(pair)


# ---------------------------------------------------------------------------
# allreduce: split_rail_tpu
# ---------------------------------------------------------------------------

class TestSplitRailTpu:
    @pytest.fixture(scope="class")
    def sr(self):
        pair = _pair(tune="allreduce:@split_rail_tpu:inf")
        yield pair
        _cleanup(pair)

    def test_selected_and_sum(self, sr):
        count = 64
        cands = sr["mine_teams"][0].score_map.lookup(
            ut.CollType.ALLREDUCE, ut.MemoryType.CUDA, count * 4)
        assert cands[0].alg_name == "split_rail_tpu"
        out = _run(sr, "ALLREDUCE", [
            (Buf(_ints(8, count, r)), Buf(size=count)) for r in range(N)],
            op="SUM")
        assert out["mine"][1] == ["split_rail_tpu"] * N
        _bitwise(out)

    def test_avg_inplace(self, sr):
        out = _run(sr, "ALLREDUCE", [
            (None, Buf(_ints(9, 160, r))) for r in range(N)], op="AVG",
            flags=("IN_PLACE",))
        _bitwise(out)

    def test_on_device_stages(self, sr):
        t = [torch.zeros(64) for _ in range(N)]
        reqs = sr["mine"].init(sr["mine_teams"], [ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
            dst=ut.BufferInfo(t[r], 64, ut.DataType.FLOAT32,
                              mem_type=ut.MemoryType.CUDA),
            flags=ut.CollArgsFlags.IN_PLACE) for r in range(N)])
        stages = [x.obs_stage for x in reqs[0].task.tasks]
        assert stages[0] == "split_rail_tpu.node_reduce_scatter"
        assert stages[-1] == "split_rail_tpu.node_allgather"
        sr["mine"].post_wait(reqs)
        for rq in reqs:
            rq.finalize()

    def test_non_divisible_falls_back_staged(self, sr):
        """count % ppn != 0: the host split_rail under the staged wrapper,
        the same bits."""
        count = 66
        out = _run(sr, "ALLREDUCE", [
            (Buf(_ints(10, count, r)), Buf(size=count)) for r in range(N)],
            op="SUM")
        _bitwise(out)
        t = [torch.zeros(count) for _ in range(N)]
        reqs = sr["mine"].init(sr["mine_teams"], [ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
            dst=ut.BufferInfo(t[r], count, ut.DataType.FLOAT32,
                              mem_type=ut.MemoryType.CUDA),
            flags=ut.CollArgsFlags.IN_PLACE) for r in range(N)])
        assert reqs[0].task.tasks[0].obs_stage == "staged.d2h"
        sr["mine"].post_wait(reqs)
        for rq in reqs:
            rq.finalize()


# ---------------------------------------------------------------------------
# the staged rows
# ---------------------------------------------------------------------------

class TestStagedRows:
    @pytest.mark.parametrize("root", [0, 3, 5])
    def test_bcast(self, jobs, root):
        data = _ints(11, 40, root)
        out = _run(jobs, "BCAST", [
            (Buf(data if r == root else np.zeros(40, np.float32)), None)
            for r in range(N)], root=root)
        assert out["mine"][1] == out["ref"][1] == ["2step_staged"] * N
        _bitwise(out)

    @pytest.mark.parametrize("root", [0, 3, 5])
    @pytest.mark.parametrize("op", ["SUM", "AVG"])
    def test_reduce(self, jobs, root, op):
        out = _run(jobs, "REDUCE", [
            (Buf(_ints(12, 24, r)), Buf(size=24) if r == root else None)
            for r in range(N)], op=op, root=root)
        assert out["mine"][1] == ["2step_staged"] * N
        _bitwise(out, [root])

    @pytest.mark.parametrize("blk", [1, 3])
    def test_alltoall(self, jobs, blk):
        total = N * blk
        out = _run(jobs, "ALLTOALL", [
            (Buf(_ints(13, total, r, np.int32)), Buf(size=total))
            for r in range(N)], dtype="INT32")
        assert out["mine"][1] == ["node_agg_staged"] * N
        _bitwise(out)

    def test_alltoall_inplace(self, jobs):
        out = _run(jobs, "ALLTOALL", [
            (None, Buf(_ints(14, 2 * N, r))) for r in range(N)],
            flags=("IN_PLACE",))
        _bitwise(out)

    def test_allgatherv(self, jobs):
        counts = [2, 5, 1, 3, 4, 2, 6, 1]
        out = _run(jobs, "ALLGATHERV", [
            (Buf(_ints(15, counts[r], r, np.int32)),
             Buf(size=sum(counts), counts=counts)) for r in range(N)],
            dtype="INT32")
        assert out["mine"][1] == ["unpack_staged"] * N
        _bitwise(out)

    def test_allgatherv_gaps_stay_as_they_were(self, jobs):
        """The port writes the blocks in place; the gaps between them keep
        the caller's values (the reference's rebound array has zeros
        there), the blocks are the reference's bits."""
        counts = [2] * N
        displs = [3 * r for r in range(N)]
        out = _run(jobs, "ALLGATHERV", [
            (Buf(_ints(16, 2, r)), Buf(size=3 * N - 1, counts=counts,
                                       displs=displs)) for r in range(N)])
        for r in range(N):
            mine, ref = out["mine"][0][r], out["ref"][0][r]
            for p in range(N):
                np.testing.assert_array_equal(
                    bits(mine[3 * p:3 * p + 2]), bits(ref[3 * p:3 * p + 2]))
            assert (mine[2::3] == 7).all()

    def test_allgather(self, jobs):
        out = _run(jobs, "ALLGATHER", [
            (Buf(_ints(17, 5, r)), Buf(size=5 * N)) for r in range(N)])
        assert out["mine"][1] == out["ref"][1] == ["unpack_staged"] * N
        _bitwise(out)

    def test_alltoallv(self, jobs):
        m = np.random.default_rng(5).integers(0, 4, size=(N, N))
        bufs = []
        for r in range(N):
            sc = [int(c) for c in m[r]]
            rc = [int(m[p][r]) for p in range(N)]
            bufs.append((Buf(_ints(18, sum(sc), r), counts=sc),
                         Buf(size=sum(rc), counts=rc)))
        out = _run(jobs, "ALLTOALLV", bufs)
        assert out["mine"][1] == ["node_agg_staged"] * N
        _bitwise(out)

    def test_barrier(self, jobs):
        out = _run(jobs, "BARRIER", [(Buf(size=0), None)] * N)
        assert out["mine"][1] == out["ref"][1] == ["knomial_hier"] * N


# ---------------------------------------------------------------------------
# ring_cuda on the node units
# ---------------------------------------------------------------------------

def test_ring_cuda_serves_the_node_units_when_named():
    """UCC_CL_HIER_NODE_TLS with ring_cuda and its TUNE: rab_tpu's node
    bcast and split_rail_tpu's node reduce_scatter and allgather are
    ring_cuda tasks (the chunked kernels on a GPU), the node reduce stays
    on torch_ops; the results are unchanged."""
    tune = "bcast,reduce_scatter,allgather:@ring_cuda:inf"
    job = HierJob(ut, N, UCC_TOPO_FAKE_PPN=PPN,
                  UCC_CL_HIER_NODE_TLS="shm,torch_ops,ring_cuda,self")
    try:
        count = 1024
        want = np.sum([_ints(19, count, r) for r in range(N)], axis=0)
        for alg in ("rab_tpu", "split_rail_tpu"):
            teams = job.team(UCC_TL_RING_CUDA_TUNE=tune,
                             UCC_CL_HIER_TUNE=f"allreduce:@{alg}:inf")
            dsts = [torch.zeros(count) for _ in range(N)]
            reqs = job.init(teams, [ut.CollArgs(
                coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
                src=ut.BufferInfo(port_cuda(_ints(19, count, r)), count,
                                  ut.DataType.FLOAT32,
                                  mem_type=ut.MemoryType.CUDA),
                dst=ut.BufferInfo(dsts[r], count, ut.DataType.FLOAT32,
                                  mem_type=ut.MemoryType.CUDA))
                for r in range(N)])
            kinds = {x.obs_stage: type(x).__name__
                     for x in reqs[0].task.tasks}
            if alg == "rab_tpu":
                assert kinds["rab_tpu.node_reduce"] == "TorchOpsCollTask"
                assert kinds["rab_tpu.node_bcast"] == "RingCudaCollTask"
            else:
                assert kinds["split_rail_tpu.node_reduce_scatter"] == \
                    "RingCudaCollTask"
                assert kinds["split_rail_tpu.node_allgather"] == \
                    "RingCudaCollTask"
            job.post_wait(reqs)
            for rq in reqs:
                rq.finalize()
            for d in dsts:
                np.testing.assert_array_equal(d.numpy(), want)
    finally:
        job.cleanup()
