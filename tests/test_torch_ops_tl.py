"""tl/torch_ops, the port's default device TL for ALLREDUCE and BCAST,
against the JAX package's tl/xla: 8-rank persistent requests through
ucc_tpu_torch (device "cpu") and through ucc_tpu on the virtual CPU mesh
(``xla`` pinned by its TUNE string: on the CPU mesh tl/xla's ``short``
algorithm would otherwise take these sizes), on the same numpy inputs.
Integer results agree bitwise; float results within the reference's own
tolerance (the two sum in different orders). bcast's result is the masked
psum's: a -0.0 at the root arrives as +0.0."""
import numpy as np
import pytest

pytest.importorskip("jax")

import ucc_tpu  # noqa: E402
from torch_stack_cases import (N, bits, jax_persistent,  # noqa: E402
                               jax_persistent_bcast, make_jax_job,
                               make_torch_job)
import ucc_tpu_torch as ut  # noqa: E402


@pytest.fixture(scope="module")
def jax_job():
    job, teams = make_jax_job("allreduce,bcast:@xla:inf", tl="xla")
    yield job, teams
    job.cleanup()


@pytest.fixture(scope="module")
def torch_job():
    job = make_torch_job()
    yield job
    job.cleanup()


def inputs(count, dt, seed):
    rng = np.random.default_rng(seed)
    if dt == "INT32":
        return [rng.integers(-50, 50, count).astype(np.int32)
                for _ in range(N)]
    return [rng.standard_normal(count).astype(np.float32) for _ in range(N)]


@pytest.mark.parametrize("dt", ["FLOAT32", "INT32"])
@pytest.mark.parametrize("op", ["SUM", "AVG", "MAX", "MIN", "PROD"])
def test_allreduce_matches_tl_xla(jax_job, torch_job, op, dt):
    """An integer AVG is tl/xla's float pmean; tl/torch_ops refuses it,
    and tl/ring_cuda's mean is that float truncated toward zero."""
    hosts = inputs(37, dt, seed=len(op))
    want = jax_persistent(*jax_job, ucc_tpu.CollType.ALLREDUCE, hosts,
                          ucc_tpu.ReductionOp[op], ucc_tpu.DataType[dt],
                          tl="xla")
    int_avg = op == "AVG" and dt == "INT32"
    got = torch_job.persistent(ut.CollType.ALLREDUCE, hosts,
                               ut.ReductionOp[op], ut.DataType[dt],
                               alg="ring_cuda" if int_avg else "xla")
    if int_avg:
        want = [[np.trunc(w).astype(np.int32) for w in rnd] for rnd in want]
    for w_round, g_round in zip(want, got):
        for w, g in zip(w_round, g_round):
            assert g.dtype == w.dtype
            if dt == "INT32":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
        for g in g_round[1:]:
            np.testing.assert_array_equal(bits(g), bits(g_round[0]))


@pytest.mark.parametrize("dt", ["FLOAT32", "INT32"])
@pytest.mark.parametrize("root", [0, 3, 7])
def test_bcast_matches_tl_xla(jax_job, torch_job, root, dt):
    hosts = inputs(45, dt, seed=root)
    if dt == "FLOAT32":
        hosts[root][5] = -0.0
    want = jax_persistent_bcast(*jax_job, hosts, root, ucc_tpu.DataType[dt],
                                tl="xla")
    got = torch_job.persistent(ut.CollType.BCAST, hosts, None,
                               ut.DataType[dt], root=root, alg="xla")
    for w_round, g_round in zip(want, got):
        for w, g in zip(w_round, g_round):
            np.testing.assert_array_equal(bits(g), bits(w))
    if dt == "FLOAT32":
        assert bits(got[0][0])[5] == 0            # +0.0, as the masked psum


def test_torch_ops_is_the_default_for_allreduce_and_bcast(torch_job):
    for coll in (ut.CollType.ALLREDUCE, ut.CollType.BCAST):
        for msgsize in (4, 1 << 20, 1 << 30):
            best = torch_job.teams[0].score_map.lookup(
                coll, ut.MemoryType.CUDA, msgsize)[0]
            assert (best.team.NAME, best.alg_name, best.score) == \
                ("torch_ops", "xla", 40)
    from ucc_tpu.tl.xla import TlXla
    from ucc_tpu_torch.tl.torch_ops import TlTorchOps
    assert TlTorchOps.DEFAULT_SCORE == TlXla.DEFAULT_SCORE == 40


@pytest.mark.parametrize("coll,op", [("REDUCE", "SUM"), ("ALLREDUCE", "BXOR"),
                                     ("ALLTOALL", "SUM")])
def test_what_torch_ops_refuses(torch_job, coll, op):
    from ucc_tpu_torch.api.types import coll_args_msgsize
    from ucc_tpu_torch.core.coll import InitArgs
    from ucc_tpu_torch.tl.torch_ops import TorchOpsCollTask
    import torch
    buf = torch.zeros(8 * N)
    args = ut.CollArgs(
        coll_type=ut.CollType[coll], op=ut.ReductionOp[op],
        src=ut.BufferInfo(buf, 8 * N, ut.DataType.FLOAT32,
                          mem_type=ut.MemoryType.CUDA),
        dst=ut.BufferInfo(buf.clone(), 8 * N, ut.DataType.FLOAT32,
                          mem_type=ut.MemoryType.CUDA))
    team = torch_job.teams[0]
    ops = next(t for t in team.cl_teams[0].tl_teams
               if t.NAME == "torch_ops")
    ia = InitArgs(args=args, team=team, mem_type=ut.MemoryType.CUDA,
                  msgsize=coll_args_msgsize(args, N, 0))
    with pytest.raises(ut.UccError) as ei:
        TorchOpsCollTask(ia, ops)
    assert ei.value.status == ut.Status.ERR_NOT_SUPPORTED
