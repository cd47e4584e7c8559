"""The whole stack for reduce_scatter and allgather: 8-rank persistent
requests through ucc_tpu_torch (tl/ring_cuda on device "cpu", pinned by
its TUNE string over tl/torch_ops, the default) against ucc_tpu's tl/ring_dma on the virtual CPU mesh
(Pallas interpret mode), on the same numpy inputs, with the jobs of
tests/torch_stack_cases.py. Each request is posted 3 times, the fast
re-post lane included, and every round is compared bitwise: at one-pass
sizes, and at chunked sizes with ``CHUNK_ELEMS = 64`` in both packages,
where both route the same counts to their chunked kernels (the allgather
chunks differ, and copies do not care).

In place, the reference's device TLs rebind ``dst.buffer`` instead of
writing it, so the port is held to numpy and to the conventions of the
host ring (tl/host/ring.py) instead: allgather reads its own block from
dst, reduce_scatter reads the whole vector from dst and writes its block.
"""
import ml_dtypes
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import ucc_tpu  # noqa: E402
import ucc_tpu.tl.ring_dma as rd  # noqa: E402
from torch_stack_cases import (N, bits, jax_persistent,  # noqa: E402
                               make_jax_job, make_torch_job)

import ucc_tpu_torch as ut  # noqa: E402
from ucc_tpu_torch.kernels import ring_rs_ag as krs  # noqa: E402
from ucc_tpu_torch.tl.ring_cuda import RingCudaCollTask  # noqa: E402
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy  # noqa: E402

DT = {np.float32: "FLOAT32", ml_dtypes.bfloat16: "BFLOAT16",
      np.int32: "INT32"}


@pytest.fixture(scope="module")
def jax_job():
    job, teams = make_jax_job("allgather,reduce_scatter:@ring_dma:inf")
    yield job, teams
    job.cleanup()


@pytest.fixture(scope="module")
def torch_job():
    job = make_torch_job("allreduce,reduce_scatter,allgather:@ring_cuda:inf")
    yield job
    job.cleanup()


@pytest.fixture
def programs(monkeypatch):
    """Names of the kernel wrappers tl/ring_cuda launches."""
    seen = []
    build = RingCudaCollTask.build_program

    def spy(self, shared):
        prog = build(self, shared)
        seen.append(prog.__name__)
        return prog
    monkeypatch.setattr(RingCudaCollTask, "build_program", spy)
    return seen


def inputs(count, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return [rng.integers(-50, 50, count).astype(np.int32)
                for _ in range(N)]
    return [rng.standard_normal(count).astype(dtype) for _ in range(N)]


def assert_rounds_equal(want, got):
    for w_round, g_round in zip(want, got):
        for w, g in zip(w_round, g_round):
            np.testing.assert_array_equal(bits(g), bits(w))


def run_both(jax_job, torch_job, coll, hosts, op, dtype, dst_count):
    dt = DT[dtype]
    want = jax_persistent(*jax_job, ucc_tpu.CollType[coll], hosts,
                          ucc_tpu.ReductionOp[op], ucc_tpu.DataType[dt],
                          dst_count)
    got = torch_job.persistent(ut.CollType[coll], hosts, ut.ReductionOp[op],
                               ut.DataType[dt], dst_count)
    assert_rounds_equal(want, got)
    return got


@pytest.mark.parametrize("c,dtype,op", [
    (125, np.float32, "SUM"), (97, ml_dtypes.bfloat16, "AVG"),
    (64, np.int32, "MAX")])
def test_reduce_scatter_matches_ring_dma_bitwise(jax_job, torch_job,
                                                 programs, c, dtype, op):
    hosts = inputs(N * c, dtype, seed=c)
    run_both(jax_job, torch_job, "REDUCE_SCATTER", hosts, op, dtype, c)
    assert set(programs) == {"ring_reduce_scatter_pass"}


@pytest.mark.parametrize("c,dtype", [(100, np.float32),
                                     (37, ml_dtypes.bfloat16)])
def test_allgather_matches_ring_dma_bitwise(jax_job, torch_job, programs, c,
                                            dtype):
    hosts = inputs(c, dtype, seed=c)
    got = run_both(jax_job, torch_job, "ALLGATHER", hosts, "SUM", dtype,
                   N * c)
    assert set(programs) == {"ring_allgather_pass"}
    cat = bits(np.concatenate(hosts))
    assert all(np.array_equal(bits(g), cat) for rnd in got for g in rnd)


@pytest.mark.parametrize("coll,c,want", [
    ("REDUCE_SCATTER", 40, "ring_reduce_scatter_chunked"),
    ("ALLGATHER", 150, "ring_allgather_chunked")])
def test_chunked_matches_ring_dma_bitwise(jax_job, torch_job, programs,
                                          monkeypatch, coll, c, want):
    """64-element chunks in both packages: reduce_scatter blocks of 40 in
    5 chunks of 8 on both sides; allgather blocks of 150 in 19 chunks of 8
    here and 3 of 64 in the JAX package, the last ragged."""
    monkeypatch.setattr(rd, "CHUNK_ELEMS", 64)
    monkeypatch.setattr(krs, "CHUNK_ELEMS", 64)
    count = N * c if coll == "REDUCE_SCATTER" else c
    dst_count = c if coll == "REDUCE_SCATTER" else N * c
    run_both(jax_job, torch_job, coll, inputs(count, np.float32, seed=c),
             "SUM", np.float32, dst_count)
    assert set(programs) == {want}


# ---------------------------------------------------------------------------
# in place, against numpy and the host ring's conventions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,op", [(np.int32, "SUM"),
                                      (np.float32, "AVG")])
def test_reduce_scatter_in_place(torch_job, dtype, op):
    """dst holds the n·c input; block r becomes the result, the other
    blocks stay as they were."""
    c = 33
    hosts = inputs(N * c, dtype, seed=3)
    rounds = torch_job.persistent(ut.CollType.REDUCE_SCATTER, hosts,
                                  ut.ReductionOp[op], ut.DataType[DT[dtype]],
                                  inplace=True)
    plain = krs.ring_reduce_scatter_ref(
        [from_numpy(h, "cpu") for h in hosts], ut.ReductionOp[op])
    total = np.sum(np.stack(hosts).astype(np.float64), axis=0)
    if op == "AVG":
        total /= N
    for got in rounds:
        for r, g in enumerate(got):
            mine = slice(r * c, (r + 1) * c)
            np.testing.assert_array_equal(bits(g[mine]),
                                          bits(to_numpy(plain[r])))
            np.testing.assert_allclose(g[mine], total[mine], rtol=1e-5,
                                       atol=1e-5)
            rest = np.ones(N * c, bool)
            rest[mine] = False
            np.testing.assert_array_equal(g[rest], hosts[r][rest])


def test_allgather_in_place(torch_job):
    """Rank r's block already sits in dst[r·c:(r+1)·c]; every other block
    is overwritten with the other ranks' blocks."""
    c = 29
    blocks = inputs(c, np.float32, seed=4)
    hosts = []
    for r in range(N):
        h = np.full(N * c, 7.0, np.float32)
        h[r * c:(r + 1) * c] = blocks[r]
        hosts.append(h)
    rounds = torch_job.persistent(ut.CollType.ALLGATHER, hosts,
                                  ut.ReductionOp.SUM, ut.DataType.FLOAT32,
                                  inplace=True)
    for got in rounds:
        for g in got:
            np.testing.assert_array_equal(bits(g),
                                          bits(np.concatenate(blocks)))


# ---------------------------------------------------------------------------
# selection and what tl/ring_cuda refuses
# ---------------------------------------------------------------------------

def _args(coll, src_count, dst_count, inplace=False):
    dst = ut.BufferInfo(from_numpy(np.zeros(dst_count, np.float32), "cpu"),
                        dst_count, ut.DataType.FLOAT32,
                        mem_type=ut.MemoryType.CUDA)
    if inplace:
        return ut.CollArgs(coll_type=coll, op=ut.ReductionOp.SUM, dst=dst,
                           flags=ut.CollArgsFlags.IN_PLACE)
    src = ut.BufferInfo(from_numpy(np.zeros(src_count, np.float32), "cpu"),
                        src_count, ut.DataType.FLOAT32,
                        mem_type=ut.MemoryType.CUDA)
    return ut.CollArgs(coll_type=coll, op=ut.ReductionOp.SUM, src=src,
                       dst=dst)


@pytest.mark.parametrize("coll,src_count,dst_count,inplace", [
    (ut.CollType.REDUCE_SCATTER, N * 5 + 1, 5, False),
    (ut.CollType.REDUCE_SCATTER, 0, N * 5 + 3, True),
    (ut.CollType.ALLGATHER, 0, N * 5 + 3, True)])
def test_indivisible_totals_are_not_supported(torch_job, coll, src_count,
                                              dst_count, inplace):
    """tl/ring_cuda's refusal (the stack then falls to tl/torch_ops, which
    splits a reduce_scatter near-equally, tests/test_torch_ops_tl_colls)."""
    from ucc_tpu_torch.api.types import coll_args_msgsize
    from ucc_tpu_torch.core.coll import InitArgs
    team = torch_job.teams[0]
    ring = next(t for t in team.cl_teams[0].tl_teams
                if t.NAME == "ring_cuda")
    args = _args(coll, src_count, dst_count, inplace)
    with pytest.raises(ut.UccError) as ei:
        RingCudaCollTask(InitArgs(args=args, team=team,
                                  mem_type=ut.MemoryType.CUDA,
                                  msgsize=coll_args_msgsize(args, N, 0)),
                         ring)
    assert ei.value.status == ut.Status.ERR_NOT_SUPPORTED


@pytest.mark.parametrize("coll,src_count,dst_count", [
    (ut.CollType.REDUCE_SCATTER, N * 5, 4),
    (ut.CollType.ALLGATHER, 5, N * 5 + 1)])
def test_mismatched_counts_are_invalid(torch_job, coll, src_count,
                                       dst_count):
    with pytest.raises(ut.UccError) as ei:
        torch_job.teams[0].collective_init(_args(coll, src_count, dst_count))
    assert ei.value.status == ut.Status.ERR_INVALID_PARAM


@pytest.mark.parametrize("coll", [ut.CollType.REDUCE_SCATTER,
                                  ut.CollType.ALLGATHER,
                                  ut.CollType.ALLREDUCE])
@pytest.mark.parametrize("msgsize", [4, 1 << 20, 1 << 30])
def test_score_map_picks_ring_cuda_on_cuda_memory(torch_job, coll, msgsize):
    best = torch_job.teams[0].score_map.lookup(coll, ut.MemoryType.CUDA,
                                               msgsize)[0]
    assert best.alg_name == "ring_cuda"
