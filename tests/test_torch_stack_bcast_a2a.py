"""The whole stack for bcast and alltoall: 8-rank persistent requests
through ucc_tpu_torch (tl/ring_cuda on device "cpu", pinned by its TUNE
string over tl/torch_ops, the default) against ucc_tpu's tl/ring_dma on the virtual CPU mesh
(Pallas interpret mode), on the same numpy inputs, with the jobs of
tests/torch_stack_cases.py. Each request is posted 3 times, the fast
re-post lane included, and every round is compared bitwise: at one-pass
sizes, and at chunked sizes with ``CHUNK_ELEMS = 64`` in both packages,
where both route the same counts to their chunked kernels (their
sub-blocks and chunks may differ, and copies do not care).

bcast passes src alone on every rank, as UCC's bcast does; the result
lands in it. In place, the reference's device TLs rebind ``dst.buffer``
instead of writing it, so the port's in-place alltoall is held to numpy
and to the JAX package's host alltoall (tl/host/alltoall.py) instead.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import ucc_tpu  # noqa: E402
import ucc_tpu.tl.ring_dma as rd  # noqa: E402
from ucc_tpu.constants import MemoryType as JMemoryType  # noqa: E402
from torch_stack_cases import (N, bits, jax_persistent,  # noqa: E402
                               jax_persistent_bcast, make_jax_job,
                               make_torch_job)

import ml_dtypes  # noqa: E402
import ucc_tpu_torch as ut  # noqa: E402
from ucc_tpu_torch.kernels import ring_bcast_a2a as kba  # noqa: E402
from ucc_tpu_torch.tl.ring_cuda import RingCudaCollTask  # noqa: E402
from ucc_tpu_torch.utils.convert import from_numpy  # noqa: E402

DT = {np.float32: "FLOAT32", ml_dtypes.bfloat16: "BFLOAT16",
      np.int32: "INT32"}


@pytest.fixture(scope="module")
def jax_job():
    job, teams = make_jax_job("bcast,alltoall:@ring_dma:inf")
    yield job, teams
    job.cleanup()


@pytest.fixture(scope="module")
def torch_job():
    job = make_torch_job("bcast,alltoall:@ring_cuda:inf")
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


def a2a_expected(hosts):
    """dst_r is the concatenation of block r of every rank's src."""
    blk = hosts[0].size // N
    return [np.concatenate([h[r * blk:(r + 1) * blk] for h in hosts])
            for r in range(N)]


@pytest.mark.parametrize("count,root,dtype,chunked", [
    (37, 0, np.float32, False), (37, 5, ml_dtypes.bfloat16, False),
    (500, 5, np.float32, True), (96, 0, np.int32, True)])
def test_bcast_matches_ring_dma_bitwise(jax_job, torch_job, programs,
                                        monkeypatch, count, root, dtype,
                                        chunked):
    """src alone on every rank; non-root srcs hold other data, which every
    round must overwrite. Chunked: sub-blocks of 32 on both sides."""
    if chunked:
        monkeypatch.setattr(rd, "CHUNK_ELEMS", 64)
        monkeypatch.setattr(kba, "CHUNK_ELEMS", 64)
    hosts = inputs(count, dtype, seed=count + root)
    dt = DT[dtype]
    want = jax_persistent_bcast(*jax_job, hosts, root, ucc_tpu.DataType[dt])
    got = torch_job.persistent(ut.CollType.BCAST, hosts, None,
                               ut.DataType[dt], root=root)
    assert_rounds_equal(want, got)
    for rnd in got:
        for g in rnd:
            np.testing.assert_array_equal(bits(g), bits(hosts[root]))
    assert set(programs) == {"ring_bcast_chunked" if chunked
                             else "ring_bcast_pass"}


@pytest.mark.parametrize("blk,dtype,chunked", [
    (5, np.float32, False), (9, ml_dtypes.bfloat16, False),
    (25, np.float32, True), (12, np.int32, True)])
def test_alltoall_matches_ring_dma_bitwise(jax_job, torch_job, programs,
                                           monkeypatch, blk, dtype, chunked):
    """Chunked: blocks of 25 in 4 chunks of 8 here (the last ragged) and 7
    of 4 in the JAX package, which re-pads each block to 28; blocks of 12
    in 2 chunks here and 3 there."""
    if chunked:
        monkeypatch.setattr(rd, "CHUNK_ELEMS", 64)
        monkeypatch.setattr(kba, "CHUNK_ELEMS", 64)
    hosts = inputs(N * blk, dtype, seed=blk)
    dt = DT[dtype]
    want = jax_persistent(*jax_job, ucc_tpu.CollType.ALLTOALL, hosts,
                          ucc_tpu.ReductionOp.SUM, ucc_tpu.DataType[dt])
    got = torch_job.persistent(ut.CollType.ALLTOALL, hosts,
                               ut.ReductionOp.SUM, ut.DataType[dt])
    assert_rounds_equal(want, got)
    for rnd in got:
        for g, e in zip(rnd, a2a_expected(hosts)):
            np.testing.assert_array_equal(bits(g), bits(e))
    assert set(programs) == {"ring_alltoall_chunked" if chunked
                             else "ring_alltoall_pass"}


def host_alltoall_in_place(jax_job, hosts):
    """The JAX package's host alltoall, in place on numpy buffers."""
    job, teams = jax_job
    bufs = [h.copy() for h in hosts]
    job.run_coll(teams, lambda r: ucc_tpu.CollArgs(
        coll_type=ucc_tpu.CollType.ALLTOALL,
        dst=ucc_tpu.BufferInfo(bufs[r], bufs[r].size,
                               ucc_tpu.DataType.FLOAT32,
                               mem_type=JMemoryType.HOST),
        flags=ucc_tpu.CollArgsFlags.IN_PLACE))
    return bufs


@pytest.mark.parametrize("blk,chunked", [(7, False), (25, True)])
def test_alltoall_in_place(jax_job, torch_job, programs, monkeypatch, blk,
                           chunked):
    """dst holds the n blocks to send and receives the n blocks sent."""
    if chunked:
        monkeypatch.setattr(kba, "CHUNK_ELEMS", 64)
    hosts = inputs(N * blk, np.float32, seed=40 + blk)
    want = a2a_expected(hosts)
    host = host_alltoall_in_place(jax_job, hosts)
    rounds = torch_job.persistent(ut.CollType.ALLTOALL, hosts,
                                  ut.ReductionOp.SUM, ut.DataType.FLOAT32,
                                  inplace=True)
    for got in rounds:
        for g, w, h in zip(got, want, host):
            np.testing.assert_array_equal(bits(g), bits(w))
            np.testing.assert_array_equal(bits(g), bits(h))
    assert set(programs) == {"ring_alltoall_chunked" if chunked
                             else "ring_alltoall_pass"}


# ---------------------------------------------------------------------------
# selection and what tl/ring_cuda refuses
# ---------------------------------------------------------------------------

def _buf(count):
    return ut.BufferInfo(from_numpy(np.zeros(count, np.float32), "cpu"),
                         count, ut.DataType.FLOAT32,
                         mem_type=ut.MemoryType.CUDA)


def _ring_cuda_init(torch_job, args):
    """tl/ring_cuda's task for *args* on rank 0, built directly."""
    from ucc_tpu_torch.api.types import coll_args_msgsize
    from ucc_tpu_torch.core.coll import InitArgs
    team = torch_job.teams[0]
    ring = next(t for t in team.cl_teams[0].tl_teams
                if t.NAME == "ring_cuda")
    return RingCudaCollTask(InitArgs(args=args, team=team,
                                     mem_type=ut.MemoryType.CUDA,
                                     msgsize=coll_args_msgsize(args, N, 0)),
                            ring)


@pytest.mark.parametrize("inplace", [False, True])
def test_indivisible_alltoall_is_not_supported(torch_job, inplace):
    """tl/ring_cuda's refusal (the stack then falls to tl/torch_ops, which
    splits the count as the reference pads it,
    tests/test_torch_ops_tl_colls)."""
    count = N * 5 + 3
    args = ut.CollArgs(coll_type=ut.CollType.ALLTOALL, dst=_buf(count),
                       src=None if inplace else _buf(count),
                       flags=ut.CollArgsFlags.IN_PLACE if inplace
                       else ut.CollArgsFlags(0))
    with pytest.raises(ut.UccError) as ei:
        _ring_cuda_init(torch_job, args)
    assert ei.value.status == ut.Status.ERR_NOT_SUPPORTED


@pytest.mark.parametrize("bad", ["counts", "root"])
def test_bad_arguments_are_invalid(torch_job, bad):
    if bad == "counts":
        args = ut.CollArgs(coll_type=ut.CollType.ALLTOALL, src=_buf(N * 5),
                           dst=_buf(N * 6))
    else:
        args = ut.CollArgs(coll_type=ut.CollType.BCAST, root=N,
                           src=_buf(5))
    with pytest.raises(ut.UccError) as ei:
        torch_job.teams[0].collective_init(args)
    assert ei.value.status == ut.Status.ERR_INVALID_PARAM


@pytest.fixture
def one_rank_team(monkeypatch):
    """A 1-rank team of tl/ring_cuda alone: tl/torch_ops, which serves any
    bcast, would otherwise take the refused counts."""
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    ctx = ut.Context(ut.init(TLS="ring_cuda"))
    team = ctx.create_team(ut.TeamParams())
    yield team
    team.destroy()
    ctx.destroy()


@pytest.mark.parametrize("coll", [ut.CollType.BCAST, ut.CollType.ALLTOALL])
def test_one_rank_cap(one_rank_team, coll):
    """Above CHUNK_ELEMS a 1-rank bcast or alltoall is NOT_SUPPORTED (the
    rule of tl/ring_dma.py:1489-1499); at CHUNK_ELEMS it runs, as a copy
    for alltoall and in place for bcast."""
    big = kba.CHUNK_ELEMS + 1

    def args(count, src, dst):
        if coll == ut.CollType.BCAST:
            return ut.CollArgs(coll_type=coll, src=src)
        return ut.CollArgs(coll_type=coll, src=src, dst=dst)
    with pytest.raises(ut.UccError) as ei:
        one_rank_team.collective_init(args(big, _buf(big), _buf(big)))
    assert ei.value.status == ut.Status.ERR_NOT_SUPPORTED
    count = kba.CHUNK_ELEMS
    src, dst = _buf(count), _buf(count)
    src.buffer.copy_(from_numpy(np.arange(count, dtype=np.float32), "cpu"))
    req = one_rank_team.collective_init(args(count, src, dst))
    req.post()
    assert req.wait() == ut.Status.OK
    out = src if coll == ut.CollType.BCAST else dst
    np.testing.assert_array_equal(out.buffer.numpy(),
                                  np.arange(count, dtype=np.float32))
    req.finalize()


@pytest.mark.parametrize("coll", [ut.CollType.BCAST, ut.CollType.ALLTOALL])
@pytest.mark.parametrize("msgsize", [4, 1 << 20, 1 << 30])
def test_score_map_picks_ring_cuda_on_cuda_memory(torch_job, coll, msgsize):
    best = torch_job.teams[0].score_map.lookup(coll, ut.MemoryType.CUDA,
                                               msgsize)[0]
    assert best.alg_name == "ring_cuda"


def test_alltoall_with_a_reduction_op_is_not_supported(jax_job, torch_job):
    """An alltoall folds nothing, yet tl/ring_dma refuses ops other than
    SUM/AVG/MAX/MIN/PROD for it (tl/ring_dma.py:1481-1487), and so does
    tl/ring_cuda: BAND is ERR_NOT_SUPPORTED at its init. The stack then
    falls to tl/torch_ops (``short`` at this size), as the reference's
    falls to tl/xla (initialised on every rank, so that the tags stay in
    step, and not posted)."""
    from ucc_tpu.api.types import coll_args_msgsize as jmsgsize
    from ucc_tpu.core.coll import InitArgs as JInitArgs
    from ucc_tpu_torch.api.types import coll_args_msgsize
    from ucc_tpu_torch.core.coll import InitArgs
    job, teams = jax_job
    dev = job.contexts[0].tl_contexts["ring_dma"].obj.device
    jargs = ucc_tpu.CollArgs(
        coll_type=ucc_tpu.CollType.ALLTOALL, op=ucc_tpu.ReductionOp.BAND,
        src=ucc_tpu.BufferInfo(jax.device_put(np.zeros(N * 4, np.float32),
                                              dev), N * 4,
                               ucc_tpu.DataType.FLOAT32,
                               mem_type=JMemoryType.TPU),
        dst=ucc_tpu.BufferInfo(None, N * 4, ucc_tpu.DataType.FLOAT32,
                               mem_type=JMemoryType.TPU))
    args = ut.CollArgs(coll_type=ut.CollType.ALLTOALL,
                       op=ut.ReductionOp.BAND, src=_buf(N * 4),
                       dst=_buf(N * 4))
    for team, a, mem, size, ia_cls, name in (
            (teams[0], jargs, JMemoryType.TPU, jmsgsize(jargs, N, 0),
             JInitArgs, "ring_dma"),
            (torch_job.teams[0], args, ut.MemoryType.CUDA,
             coll_args_msgsize(args, N, 0), InitArgs, "ring_cuda")):
        cand = next(c for c in team.score_map.lookup(
            a.coll_type, mem, size) if c.alg_name == name)
        with pytest.raises(Exception) as ei:
            cand.init(ia_cls(args=a, team=team, mem_type=mem, msgsize=size),
                      cand.team)
        assert ei.value.status.name == "ERR_NOT_SUPPORTED", name
    jreqs = [t.collective_init(jargs) for t in teams]
    reqs = [t.collective_init(ut.CollArgs(
        coll_type=ut.CollType.ALLTOALL, op=ut.ReductionOp.BAND,
        src=_buf(N * 4), dst=_buf(N * 4))) for t in torch_job.teams]
    assert {rq.task.alg_name for rq in jreqs} == \
        {rq.task.alg_name for rq in reqs} == {"short"}
    for rq in jreqs + reqs:
        rq.finalize()
