"""tl/torch_ops' quantized variants (qint8, qfp8: quant/torch_ops.py) held
against tl/xla's on the virtual CPU mesh, on the same seeded numpy
inputs, each pinned by its TL's TUNE string.

- allgather: bit for bit, at a count that the block divides and one that
  it does not (the padded path), float32 and bfloat16, 8 and 3 ranks;
- allreduce SUM and AVG: every rank holds the same bits, and the port's
  result is within ONE quantization step of the reference's (the stated
  tolerance: 2 x half_step x the largest magnitude of the result, the
  step of int8 at the block's absmax and fp8's envelope). XLA's CPU
  backend fuses the dequantize into the reduction (a multiply-add a rank,
  or a pairwise tree at 8 ranks), so a partial sum can differ from the
  port's rank-order float32 sum in its last bit, and the requantized
  element by one step; both are within the reference's own bound against
  float64, which is checked too;
- the candidate lists (ids, scores, precision tags) with UCC_QUANT off,
  int8 and fp8, and the init refusals (integer payload, PROD, a budget
  below the predicted error): NOT_SUPPORTED, and the same fallback walk.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import ucc_tpu
import ucc_tpu_torch as ut
from test_torch_host_colls import env
from torch_stack_cases import (Buf, _env, jax_coll, make_jax_job,
                               make_torch_job, torch_coll)

from ucc_tpu import quant as jq

MODES = ("int8", "fp8")
DTYPES = ("FLOAT32", "BFLOAT16")
_NP = {"FLOAT32": np.float32, "BFLOAT16": ml_dtypes.bfloat16}


def tune_of(mode):
    return f"allreduce:@q{mode}:inf#allgather:@q{mode}:inf"


@pytest.fixture(scope="module")
def jobs():
    """(mode, n) -> (jax job, jax teams, torch job), made on first use."""
    made = {}

    def get(mode, n):
        if (mode, n) not in made:
            with _env(UCC_QUANT=mode):
                job, teams = make_jax_job(tune_of(mode), tl="xla", n=n)
            tj = make_torch_job(n=n, UCC_QUANT=mode,
                                UCC_TL_TORCH_OPS_TUNE=tune_of(mode))
            made[(mode, n)] = (job, teams, tj)
        return made[(mode, n)]
    yield get
    for job, _, tj in made.values():
        tj.cleanup()
        job.cleanup()


def inputs(n, count, dt, seed):
    rng = np.random.default_rng(seed)
    return [((rng.random(count, dtype=np.float32) - 0.5) * 4)
            .astype(_NP[dt]) for _ in range(n)]


def run_both(jobs, mode, n, coll, hosts, dt, op=None):
    job, teams, tj = jobs(mode, n)
    count = hosts[0].size
    dst = count * n if coll == "ALLGATHER" else count
    bufs = [(Buf(h), Buf(size=dst)) for h in hosts]
    want = jax_coll(job, teams, coll, bufs, dt, op=op, alg=f"q{mode}")
    got = torch_coll(tj, coll, bufs, dt, op=op, alg=f"q{mode}",
                     rounds=2)
    return [np.asarray(w) for w in want], got


def as_f64(a):
    return np.asarray(a).astype(np.float32).astype(np.float64)


@pytest.mark.parametrize("n", (8, 3))
@pytest.mark.parametrize("count", (512, 1000))
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_allgather_is_the_references_bit_for_bit(jobs, mode, dt, count, n):
    hosts = inputs(n, count, dt, seed=count + n)
    want, got = run_both(jobs, mode, n, "ALLGATHER", hosts, dt)
    for rnd in got:                 # every persistent round
        for w, g in zip(want, rnd):
            assert g.size == count * n
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("n", (8, 3))
@pytest.mark.parametrize("op", ("SUM", "AVG"))
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_allreduce_is_within_one_step_of_the_reference(jobs, mode, dt, op,
                                                       n):
    count = 1000                    # padded to 1024: the last block short
    hosts = inputs(n, count, dt, seed=7 * n + len(op))
    want, got = run_both(jobs, mode, n, "ALLREDUCE", hosts, dt, op)
    exact = np.sum(np.stack([as_f64(h) for h in hosts]), axis=0)
    if op == "AVG":
        exact /= n
    codec = jq.get_codec(mode)
    step = 2 * codec.half_step * float(np.max(np.abs(as_f64(want[0]))))
    budget = jq.default_budget(mode)
    for rnd in got:
        for r in range(n):
            # the ranks agree, bit for bit, in both packages
            np.testing.assert_array_equal(rnd[r].view(np.uint8),
                                          rnd[0].view(np.uint8))
            np.testing.assert_array_equal(want[r].view(np.uint8),
                                          want[0].view(np.uint8))
        diff = np.max(np.abs(as_f64(rnd[0]) - as_f64(want[0])))
        assert diff <= step, (diff, step)
        peak = float(np.max(np.abs(exact)))
        for res in (rnd[0], want[0]):
            assert np.max(np.abs(as_f64(res) - exact)) / peak <= budget


def test_quant_ops_allgather_is_bitwise_at_every_mode_and_block():
    """The ops of quant/torch_ops against the reference's xla_ops, called
    directly (the reference under jax.jit over a one-axis mesh), at
    another block size."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:
        from jax.experimental.shard_map import shard_map
    from ucc_tpu.quant import xla_ops
    from ucc_tpu_torch.quant import torch_ops as qo
    n, count = 4, 300
    devs = np.array(jax.devices()[:n])
    mesh = Mesh(devs, ("r",))
    hosts = inputs(n, count, "FLOAT32", seed=3)
    for mode in MODES:
        for block in (32, 64):
            padded = qo.padded_count(count, block)
            x = np.zeros((n, padded), np.float32)
            x[:, :count] = np.stack(hosts)
            f = jax.jit(shard_map(
                lambda s: xla_ops.quant_allgather(s, mode, block, count),
                mesh=mesh, in_specs=P("r"), out_specs=P("r")))
            want = np.asarray(f(x))[0]
            got = qo.quant_allgather([torch.from_numpy(h) for h in hosts],
                                     mode, block, count).numpy()
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


def _device_rows(team, mod, tl):
    out = []
    for ct in ("ALLREDUCE", "ALLGATHER"):
        mem = mod.MemoryType.TPU if mod is ucc_tpu else mod.MemoryType.CUDA
        for msgsize in (64, 64 << 10, 64 << 20):
            out.append([(c.alg_name, c.score, c.precision)
                        for c in team.score_map.lookup(mod.CollType[ct], mem,
                                                       msgsize)
                        if getattr(c.team, "NAME", "") == tl])
    return out


@pytest.mark.parametrize("mode", ("off", "int8", "fp8"))
def test_candidate_lists_match(mode):
    """tl/torch_ops' rows against tl/xla's: the same algorithms, scores
    and precision tags, and none quantized with UCC_QUANT off."""
    q = None if mode == "off" else mode
    with env(UCC_QUANT=q):
        job, teams = make_jax_job("", tl="xla", n=4)
        tj = make_torch_job(n=4)
    try:
        want = _device_rows(teams[0], ucc_tpu, "xla")
        got = _device_rows(tj.teams[0], ut, "torch_ops")
        assert got == want
        flat = [p for rows in got for _, _, p in rows]
        assert any(flat) == (q is not None)
        if q:
            dump = tj.teams[0].score_map.print_info("t")
            assert f"torch_ops/q{q}:38 (default,{q})" in dump
    finally:
        tj.cleanup()
        job.cleanup()


def _init_status(mod, teams, coll, dt, op, count, mem):
    """The status of collective_init on rank 0 alone (device tasks check
    before they take a tag, so the team's tags stay aligned)."""
    import jax.numpy as jnp
    D = mod.DataType[dt]
    if mod is ucc_tpu:
        buf = jnp.zeros(count, _NP.get(dt, np.int32) if dt != "INT32"
                        else np.int32)
    else:
        buf = torch.zeros(count, dtype=ut.dt_torch(ut.DataType[dt]))
    dst_count = count * (4 if coll == "ALLGATHER" else 1)
    args = mod.CollArgs(
        coll_type=mod.CollType[coll],
        op=None if op is None else mod.ReductionOp[op],
        src=mod.BufferInfo(buf, count, D, mem_type=mem),
        dst=mod.BufferInfo(None if mod is ucc_tpu else
                           torch.zeros(dst_count, dtype=buf.dtype),
                           dst_count, D, mem_type=mem))
    try:
        req = teams[0].collective_init(args)
    except mod.UccError as e:
        return e.status.name
    return req.task.alg_name


@pytest.mark.parametrize("case", (("ALLREDUCE", "INT32", "SUM", ""),
                                  ("ALLREDUCE", "FLOAT32", "PROD", ""),
                                  ("ALLREDUCE", "FLOAT32", "SUM", "1e-6"),
                                  ("ALLGATHER", "INT32", None, "")))
def test_init_refusals_walk_as_the_reference(case):
    """The pinned qint8 refuses these args at init (NOT_SUPPORTED) in both
    packages, and the fallback walk lands on the other device TL's ring:
    tl/ring_dma's in the reference, tl/ring_cuda's (its port) here."""
    coll, dt, op, budget = case
    lib = {"UCC_QUANT": "int8", "UCC_QUANT_ERROR_BUDGET": budget or None}
    with env(**lib):
        job, teams = make_jax_job(tune_of("int8"), tl="xla", n=4)
        tj = make_torch_job(n=4, UCC_TL_TORCH_OPS_TUNE=tune_of("int8"))
    try:
        want = _init_status(ucc_tpu, teams, coll, dt, op, 1024,
                            ucc_tpu.MemoryType.TPU)
        got = _init_status(ut, tj.teams, coll, dt, op, 1024,
                           ut.MemoryType.CUDA)
        assert (want, got) == ("ring_dma", "ring_cuda")
    finally:
        tj.cleanup()
        job.cleanup()


def test_task_refuses_in_the_references_order():
    """TorchOpsCollTask's own checks on a quantized task: a precision
    that is not the lib's is NOT_SUPPORTED; the lib's own passes and
    takes the lib's block."""
    from ucc_tpu_torch.core.coll import InitArgs
    from ucc_tpu_torch.tl.torch_ops import TorchOpsCollTask
    with env(UCC_QUANT="fp8"):
        tj = make_torch_job(n=2)
    try:
        tl_team = next(t for cl in tj.teams[0].cl_teams
                       for t in getattr(cl, "tl_teams", [])
                       if getattr(t, "NAME", "") == "torch_ops")
        buf = torch.zeros(64)
        args = ut.CollArgs(coll_type=ut.CollType.ALLREDUCE,
                           op=ut.ReductionOp.SUM,
                           src=ut.BufferInfo(buf, 64, ut.DataType.FLOAT32,
                                             mem_type=ut.MemoryType.CUDA),
                           dst=ut.BufferInfo(buf.clone(), 64,
                                             ut.DataType.FLOAT32,
                                             mem_type=ut.MemoryType.CUDA))
        ia = InitArgs(args=args, team=tj.teams[0],
                      mem_type=ut.MemoryType.CUDA, msgsize=256)
        with pytest.raises(ut.UccError) as ei:
            TorchOpsCollTask(ia, tl_team, "qint8")   # the lib says fp8
        assert ei.value.status == ut.Status.ERR_NOT_SUPPORTED
        assert "disabled" in str(ei.value)
        task = TorchOpsCollTask(ia, tl_team, "qfp8")
        assert task.qblock == 256
        task.finalize()
    finally:
        tj.cleanup()
