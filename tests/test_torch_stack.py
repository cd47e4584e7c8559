"""The whole stack: an 8-rank persistent allreduce through ucc_tpu_torch
(lib -> contexts over a ThreadOobWorld -> team -> collective_init ->
post/test, tl/ring_cuda on device "cpu") against ucc_tpu's tl/ring_dma on
the virtual CPU mesh (Pallas interpret mode), on the same numpy inputs.

Each request is posted 3 times (persistent re-post; from the second post
on, the port takes its fast re-post lane), and every round's result is
compared. Where both packages run the same ring geometry the results
must be bitwise equal; where the chunk sizes differ, the blocks start at
other offsets, so each element is summed in another order and f32 results
agree to rounding only (rtol 1e-6 on positive inputs, whose sums have no
cancellation to magnify the last-bit differences). The jobs are those of
tests/torch_stack_cases.py.
"""
import ml_dtypes
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import ucc_tpu  # noqa: E402
import ucc_tpu.tl.ring_dma as rd  # noqa: E402
from torch_stack_cases import (N, bits, jax_persistent_allreduce,  # noqa: E402
                               make_jax_job, make_torch_job)

import ucc_tpu_torch as ut  # noqa: E402
from ucc_tpu_torch.kernels import ring_allreduce as kr  # noqa: E402


@pytest.fixture(scope="module")
def jax_job():
    job, teams = make_jax_job("allreduce:@ring_dma:inf")
    yield job, teams
    job.cleanup()


@pytest.fixture(scope="module")
def torch_job():
    job = make_torch_job("allreduce:@ring_cuda:inf")
    yield job
    job.cleanup()


@pytest.mark.parametrize("count,dtype,op", [
    (1000, np.float32, "SUM"),            # one pass on both sides
    (777, ml_dtypes.bfloat16, "AVG"),
])
def test_stack_matches_ring_dma_bitwise(jax_job, torch_job, count, dtype, op):
    rng = np.random.default_rng(count)
    hosts = [rng.standard_normal(count).astype(dtype) for _ in range(N)]
    dt = "FLOAT32" if dtype == np.float32 else "BFLOAT16"
    want = jax_persistent_allreduce(*jax_job, hosts, ucc_tpu.ReductionOp[op],
                                    ucc_tpu.DataType[dt])
    got = torch_job.persistent_allreduce(hosts, ut.ReductionOp[op],
                                         ut.DataType[dt])
    assert torch_job.teams[0].score_map.lookup(
        ut.CollType.ALLREDUCE, ut.MemoryType.CUDA,
        count * 4)[0].alg_name == "ring_cuda"
    for w_round, g_round in zip(want, got):
        for w, g in zip(w_round, g_round):
            np.testing.assert_array_equal(bits(g), bits(w))


def test_stack_matches_ring_dma_chunked_bitwise(jax_job, torch_job,
                                                 monkeypatch):
    """Both packages on 64-element chunks: the chunked kernels' geometry
    is the same, so the results are bitwise equal."""
    monkeypatch.setattr(rd, "CHUNK_ELEMS", 64)
    monkeypatch.setattr(kr, "CHUNK_ELEMS", 64)
    count = 500                       # 8 chunks, the last one ragged
    rng = np.random.default_rng(5)
    hosts = [rng.standard_normal(count).astype(np.float32) for _ in range(N)]
    want = jax_persistent_allreduce(*jax_job, hosts, ucc_tpu.ReductionOp.SUM,
                                    ucc_tpu.DataType.FLOAT32)
    got = torch_job.persistent_allreduce(hosts, ut.ReductionOp.SUM,
                                         ut.DataType.FLOAT32)
    for w_round, g_round in zip(want, got):
        for w, g in zip(w_round, g_round):
            np.testing.assert_array_equal(bits(g), bits(w))


def test_stack_matches_ring_dma_across_geometries(jax_job, torch_job,
                                                  monkeypatch):
    """ucc_tpu chunks at 64 elements, the port runs its default one pass:
    other block boundaries, so another summation order per element."""
    monkeypatch.setattr(rd, "CHUNK_ELEMS", 64)
    count = 300
    rng = np.random.default_rng(6)
    hosts = [(1.0 + rng.random(count)).astype(np.float32) for _ in range(N)]
    want = jax_persistent_allreduce(*jax_job, hosts, ucc_tpu.ReductionOp.SUM,
                                    ucc_tpu.DataType.FLOAT32)
    got = torch_job.persistent_allreduce(hosts, ut.ReductionOp.SUM,
                                         ut.DataType.FLOAT32)
    for w_round, g_round in zip(want, got):
        for w, g in zip(w_round, g_round):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
