"""tl/torch_ops, the port's default device TL, on ALLREDUCE and BCAST
against the JAX package's tl/xla: 8-rank persistent requests through
ucc_tpu_torch (device "cpu") and through ucc_tpu on the virtual CPU mesh
(``xla`` pinned by the TUNE strings of both: on the CPU tl/xla's and
tl/torch_ops's ``short`` algorithm would otherwise take these sizes), on
the same numpy inputs, in float32, int32, bfloat16, float16, int8 and
float64. Integer results agree bitwise; float results within the
reference's own tolerance (the two sum in different orders); float16 and
bfloat16 within rtol 1e-2 of the float64 reduction; float64 (JAX runs
with x64 off here) against the reference on the same float32 values.
bcast's result is the masked psum's: a -0.0 at the root arrives as
+0.0. The other collective types are in tests/test_torch_ops_tl_colls.py.
"""
import ml_dtypes
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
    job = make_torch_job(UCC_TL_TORCH_OPS_TUNE="allreduce,bcast:@xla:inf")
    yield job
    job.cleanup()


NP = {"FLOAT32": np.float32, "INT32": np.int32,
      "BFLOAT16": ml_dtypes.bfloat16, "FLOAT16": np.float16,
      "INT8": np.int8, "FLOAT64": np.float64}
DTYPES = list(NP)


def inputs(count, dt, seed, op="SUM"):
    """float32 and float64 (float32 values): normal samples; the half
    types 1 + 0.3·N(0, 1); int32 -50..49; int8 -5..5 (-1..1 for PROD,
    which the reference computes in int32)."""
    rng = np.random.default_rng(seed)
    if dt == "INT32":
        return [rng.integers(-50, 50, count).astype(np.int32)
                for _ in range(N)]
    if dt == "INT8":
        lo, hi = (-1, 2) if op == "PROD" else (-5, 6)
        return [rng.integers(lo, hi, count).astype(np.int8)
                for _ in range(N)]
    if dt in ("BFLOAT16", "FLOAT16"):
        return [(1 + 0.3 * rng.standard_normal(count)).astype(NP[dt])
                for _ in range(N)]
    return [rng.standard_normal(count).astype(np.float32).astype(NP[dt])
            for _ in range(N)]


def reduce64(hosts, op):
    st = np.stack([h.astype(np.float64) for h in hosts])
    return {"SUM": st.sum(0), "AVG": st.mean(0), "MAX": st.max(0),
            "MIN": st.min(0), "PROD": st.prod(0)}[op]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("op", ["SUM", "AVG", "MAX", "MIN", "PROD"])
def test_allreduce_matches_tl_xla(jax_job, torch_job, op, dt):
    """An integer AVG is tl/xla's float pmean; tl/torch_ops refuses it,
    and tl/ring_cuda's mean is that float truncated toward zero."""
    hosts = inputs(37, dt, seed=len(op), op=op)
    ints = dt in ("INT32", "INT8")
    int_avg = op == "AVG" and ints
    got = torch_job.persistent(ut.CollType.ALLREDUCE, hosts,
                               ut.ReductionOp[op], ut.DataType[dt],
                               alg="ring_cuda" if int_avg else "xla")
    if dt in ("BFLOAT16", "FLOAT16"):
        want = reduce64(hosts, op)
        for g_round in got:
            for g in g_round:
                assert g.dtype == NP[dt]
                np.testing.assert_allclose(g.astype(np.float64), want,
                                           rtol=1e-2)
        return
    rdt = "FLOAT32" if dt == "FLOAT64" else dt
    want = jax_persistent(*jax_job, ucc_tpu.CollType.ALLREDUCE,
                          [h.astype(NP[rdt]) for h in hosts],
                          ucc_tpu.ReductionOp[op], ucc_tpu.DataType[rdt],
                          tl="xla")
    if int_avg:
        want = [[np.trunc(w).astype(NP[dt]) for w in rnd] for rnd in want]
    for w_round, g_round in zip(want, got):
        for w, g in zip(w_round, g_round):
            assert g.dtype == NP[dt]
            if ints:
                # the reference's integer product is int32
                np.testing.assert_array_equal(g.astype(np.int64),
                                              w.astype(np.int64))
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
        for g in g_round[1:]:
            np.testing.assert_array_equal(bits(g), bits(g_round[0]))


@pytest.mark.parametrize("dt", ["BFLOAT16", "FLOAT16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_half_prod_rounds_once(jax_job, torch_job, dt, seed):
    """PROD of bfloat16 and float16 is computed in float32 and rounded once,
    as the reference's jnp.prod: at 8 ranks of 4096 elements 1 +
    0.3·N(0, 1), both within rtol 1e-2 of the float64 product (rounding
    after every rank was up to 0.0174 off)."""
    hosts = inputs(4096, dt, seed)
    want = reduce64(hosts, "PROD")
    ref = jax_persistent(*jax_job, ucc_tpu.CollType.ALLREDUCE, hosts,
                         ucc_tpu.ReductionOp.PROD, ucc_tpu.DataType[dt],
                         tl="xla")[0][0]
    np.testing.assert_allclose(ref.astype(np.float64), want, rtol=1e-2)
    got = torch_job.persistent(ut.CollType.ALLREDUCE, hosts,
                               ut.ReductionOp.PROD, ut.DataType[dt],
                               alg="xla")
    for g_round in got:
        for g in g_round:
            np.testing.assert_allclose(g.astype(np.float64), want,
                                       rtol=1e-2)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("root", [0, 3, 7])
def test_bcast_matches_tl_xla(jax_job, torch_job, root, dt):
    hosts = inputs(45, dt, seed=root)
    floats = dt not in ("INT32", "INT8")
    if floats:
        hosts[root][5] = -0.0
    rdt = "FLOAT32" if dt == "FLOAT64" else dt
    want = jax_persistent_bcast(*jax_job,
                                [h.astype(NP[rdt]) for h in hosts], root,
                                ucc_tpu.DataType[rdt], tl="xla")
    got = torch_job.persistent(ut.CollType.BCAST, hosts, None,
                               ut.DataType[dt], root=root, alg="xla")
    for w_round, g_round in zip(want, got):
        for w, g in zip(w_round, g_round):
            np.testing.assert_array_equal(bits(g),
                                          bits(w.astype(NP[dt])))
    if floats:
        assert bits(got[0][0])[5] == 0            # +0.0, as the masked psum


@pytest.fixture(scope="module")
def default_job():
    job = make_torch_job()
    yield job
    job.cleanup()


def test_torch_ops_is_the_default_for_allreduce_and_bcast(default_job):
    """``short`` (45) below 128 KiB on a cpu team, ``xla`` (40) above."""
    for coll in (ut.CollType.ALLREDUCE, ut.CollType.BCAST):
        for msgsize, alg, score in ((4, "short", 45), (1 << 20, "xla", 40),
                                    (1 << 30, "xla", 40)):
            best = default_job.teams[0].score_map.lookup(
                coll, ut.MemoryType.CUDA, msgsize)[0]
            assert (best.team.NAME, best.alg_name, best.score) == \
                ("torch_ops", alg, score)
    from ucc_tpu.tl.xla import TlXla
    from ucc_tpu_torch.tl.torch_ops import TlTorchOps
    assert TlTorchOps.DEFAULT_SCORE == TlXla.DEFAULT_SCORE == 40


def other_op_inputs(op, dt, count, seed):
    """Inputs of the logical, bitwise and loc ops, from a seed: logical
    ops see zeros (and, in f32, -0.0 and a NaN) on some ranks and not on
    others; bitwise ops any 32-bit pattern; loc ops (value, index) pairs
    whose values come from three levels (in f32 with +0.0 and -0.0 among
    them), so that several ranks tie on most values, with indices that
    differ across the tying ranks."""
    rng = np.random.default_rng(seed)
    if op in ("LAND", "LOR", "LXOR"):
        if dt == "INT32":
            return [rng.integers(-2, 3, count).astype(np.int32)
                    for _ in range(N)]
        hosts = [rng.choice(np.array([0.0, -0.0, 1.5, -2.0], np.float32),
                            count) for _ in range(N)]
        hosts[2][5] = np.nan
        return hosts
    if op in ("BAND", "BOR", "BXOR"):
        return [rng.integers(-2**31, 2**31, count, dtype=np.int64)
                .astype(np.int32) for _ in range(N)]
    levels = np.array([-1.0, 0.0, -0.0, 2.0] if dt == "FLOAT32"
                      else [-7, 0, 3], dtype=np.float32 if dt == "FLOAT32"
                      else np.int32)
    hosts = []
    for r in range(N):
        h = np.empty(count, dtype=levels.dtype)
        h[0::2] = rng.choice(levels, count // 2)
        h[1::2] = rng.permutation(np.arange(100, 100 + count // 2))[::-1] \
            - 10 * r
        hosts.append(h)
    return hosts


OTHER_OPS = [(op, dt) for op in ("LAND", "LOR", "LXOR")
             for dt in ("FLOAT32", "INT32")] + \
    [(op, "INT32") for op in ("BAND", "BOR", "BXOR")] + \
    [(op, dt) for op in ("MINLOC", "MAXLOC") for dt in ("FLOAT32", "INT32")]


@pytest.mark.parametrize("op,dt", OTHER_OPS)
def test_logical_bitwise_and_loc_ops_match_tl_xla(jax_job, torch_job, op,
                                                  dt):
    """Every op tl/xla's ``xla`` runs, bitwise: the logical ops as 0/1 in
    the dtype, the bitwise ones as a fold over the ranks, the loc ops with
    ties to the lowest index."""
    hosts = other_op_inputs(op, dt, 38, seed=sum(map(ord, op + dt)))
    want = jax_persistent(*jax_job, ucc_tpu.CollType.ALLREDUCE, hosts,
                          ucc_tpu.ReductionOp[op], ucc_tpu.DataType[dt],
                          tl="xla")
    got = torch_job.persistent(ut.CollType.ALLREDUCE, hosts,
                               ut.ReductionOp[op], ut.DataType[dt],
                               alg="xla")
    for w_round, g_round in zip(want, got):
        for w, g in zip(w_round, g_round):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(bits(g), bits(w))
    if op in ("MINLOC", "MAXLOC"):
        # ties across ranks were there to break
        vals = np.stack(hosts)[:, 0::2]
        best = vals.min(0) if op == "MINLOC" else vals.max(0)
        assert ((vals == best).sum(0) > 1).any()


def args_for(coll, op, dt="FLOAT32", count=8 * N):
    """One rank's arguments: zeros in and out, on CUDA memory."""
    import torch
    buf = torch.zeros(count, dtype=torch.float32 if dt == "FLOAT32"
                      else torch.int32)
    return ut.CollArgs(
        coll_type=ut.CollType[coll], op=ut.ReductionOp[op],
        src=ut.BufferInfo(buf, count, ut.DataType[dt],
                          mem_type=ut.MemoryType.CUDA),
        dst=ut.BufferInfo(buf.clone(), count, ut.DataType[dt],
                          mem_type=ut.MemoryType.CUDA))


def refused(torch_job, args):
    """The status with which a tl/torch_ops task refuses *args*."""
    from ucc_tpu_torch.api.types import coll_args_msgsize
    from ucc_tpu_torch.core.coll import InitArgs
    from ucc_tpu_torch.tl.torch_ops import TorchOpsCollTask
    team = torch_job.teams[0]
    ops = next(t for t in team.cl_teams[0].tl_teams
               if t.NAME == "torch_ops")
    ia = InitArgs(args=args, team=team, mem_type=ut.MemoryType.CUDA,
                  msgsize=coll_args_msgsize(args, N, 0))
    with pytest.raises(ut.UccError) as ei:
        TorchOpsCollTask(ia, ops)
    return ei.value.status


@pytest.mark.parametrize("op,dt,count", [
    ("BAND", "FLOAT32", 8), ("BOR", "FLOAT32", 8), ("BXOR", "FLOAT32", 8),
    ("MINLOC", "FLOAT32", 7), ("MAXLOC", "INT32", 37)])
def test_what_the_reference_fails_at_run_time_is_refused_at_init(
        torch_job, op, dt, count):
    """A bitwise op on a floating type (jnp.bitwise_* raise on floats) and
    a loc op on an odd count (values and indices do not pair up) fail in
    tl/xla when its program runs; tl/torch_ops refuses them at init, and
    so does the whole stack, as tl/ring_cuda takes none of these ops."""
    args = args_for("ALLREDUCE", op, dt, count)
    assert refused(torch_job, args) == ut.Status.ERR_NOT_SUPPORTED
    with pytest.raises(ut.UccError) as ei:
        torch_job.teams[0].collective_init(args)
    assert ei.value.status == ut.Status.ERR_NOT_SUPPORTED


@pytest.mark.parametrize("coll,op", [("REDUCE", "BXOR"),
                                     ("ALLREDUCE", "BXOR"),
                                     ("REDUCE_SCATTER", "BAND")])
def test_what_torch_ops_refuses(torch_job, coll, op):
    """A bitwise op on a floating type, for every reducing collective."""
    assert refused(torch_job, args_for(coll, op)) == \
        ut.Status.ERR_NOT_SUPPORTED
