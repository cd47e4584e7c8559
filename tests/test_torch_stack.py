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
cancellation to magnify the last-bit differences).
"""
import os
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ucc_tpu  # noqa: E402
import ucc_tpu.tl.ring_dma as rd  # noqa: E402
from harness import UccJob  # noqa: E402

import ucc_tpu_torch as ut  # noqa: E402
from ucc_tpu_torch.kernels import ring_allreduce as kr  # noqa: E402
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy  # noqa: E402

N = 8
ROUNDS = 3


class TorchJob:
    """N ranks of ucc_tpu_torch in one process: a Lib and a Context each,
    bootstrapped by a thread OOB (contexts are created in threads: the
    address exchange blocks), then driven cooperatively."""

    def __init__(self, n: int):
        self.n = n
        world = ut.ThreadOobWorld(n)
        libs = [ut.init() for _ in range(n)]
        self.contexts = [None] * n
        errs = []

        def make(r):
            try:
                self.contexts[r] = ut.Context(
                    libs[r], ut.ContextParams(oob=world.endpoint(r)))
            except Exception as e:  # noqa: BLE001 - re-raised below
                errs.append(e)

        threads = [threading.Thread(target=make, args=(r,))
                   for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        if errs:
            raise errs[0]
        tworld = ut.ThreadOobWorld(n)
        self.teams = [c.create_team_post(ut.TeamParams(oob=tworld.endpoint(r)))
                      for r, c in enumerate(self.contexts)]
        self.progress_until(lambda: all(
            [t.create_test() == ut.Status.OK for t in self.teams]))

    def progress_until(self, cond, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while not cond():
            for c in self.contexts:
                c.progress()
            if time.monotonic() > deadline:
                raise TimeoutError("progress_until timed out")

    def persistent_allreduce(self, hosts, op, dt):
        """Post one persistent request per rank ROUNDS times; returns each
        round's per-rank results as numpy arrays."""
        count = hosts[0].size
        srcs = [from_numpy(h, "cpu") for h in hosts]
        dsts = [torch.empty_like(s) for s in srcs]
        reqs = [self.teams[r].collective_init(ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=op,
            src=ut.BufferInfo(srcs[r], count, dt, mem_type=ut.MemoryType.CUDA),
            dst=ut.BufferInfo(dsts[r], count, dt, mem_type=ut.MemoryType.CUDA),
            flags=ut.CollArgsFlags.PERSISTENT)) for r in range(self.n)]
        rounds = []
        for _ in range(ROUNDS):
            for d in dsts:
                d.fill_(7)           # every round must rewrite dst
            for rq in reqs:
                rq.post()
            self.progress_until(lambda: all(
                [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]))
            assert all(rq.test() == ut.Status.OK for rq in reqs)
            rounds.append([to_numpy(d) for d in dsts])
        assert reqs[0]._fast          # re-posts took the fast lane
        for rq in reqs:
            rq.finalize()
        return rounds

    def cleanup(self) -> None:
        for t in self.teams:
            t.destroy()
        for c in self.contexts:
            c.destroy()


@pytest.fixture(scope="module")
def jax_job():
    os.environ["UCC_TL_RING_DMA_TUNE"] = "allreduce:@ring_dma:inf"
    try:
        job = UccJob(N)
        teams = job.create_team()
    finally:
        os.environ.pop("UCC_TL_RING_DMA_TUNE", None)
    yield job, teams
    job.cleanup()


@pytest.fixture(scope="module")
def torch_job():
    saved = {k: os.environ.get(k) for k in ("UCC_TL_RING_CUDA_DEVICE",
                                             "UCC_TL_RING_CUDA_TUNE")}
    os.environ["UCC_TL_RING_CUDA_DEVICE"] = "cpu"
    os.environ["UCC_TL_RING_CUDA_TUNE"] = "allreduce:@ring_cuda:inf"
    try:
        job = TorchJob(N)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    yield job
    job.cleanup()


def jax_persistent_allreduce(job, teams, hosts, op, dt):
    count = hosts[0].size
    argses = []
    for r in range(N):
        dev = job.contexts[r].tl_contexts["ring_dma"].obj.device
        argses.append(ucc_tpu.CollArgs(
            coll_type=ucc_tpu.CollType.ALLREDUCE, op=op,
            src=ucc_tpu.BufferInfo(jax.device_put(jnp.asarray(hosts[r]), dev),
                                   count, dt,
                                   mem_type=ucc_tpu.MemoryType.TPU),
            dst=ucc_tpu.BufferInfo(None, count, dt,
                                   mem_type=ucc_tpu.MemoryType.TPU),
            flags=ucc_tpu.CollArgsFlags.PERSISTENT))
    reqs = [teams[r].collective_init(argses[r]) for r in range(N)]
    assert reqs[0].task.alg_name == "ring_dma"
    rounds = []
    for _ in range(ROUNDS):
        for rq in reqs:
            rq.post()
        job.progress_until(lambda: all(
            [rq.test() != ucc_tpu.Status.IN_PROGRESS for rq in reqs]))
        assert all(rq.test() == ucc_tpu.Status.OK for rq in reqs)
        rounds.append([np.asarray(a.dst.buffer) for a in argses])
    for rq in reqs:
        rq.finalize()
    return rounds


def bits(a):
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


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
