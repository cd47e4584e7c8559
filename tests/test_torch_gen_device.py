"""Generated device collectives (ucc_tpu_torch/dsl/lower_device,
kernels/gen_device, tl/torch_ops) against the JAX package's
(ucc_tpu/dsl/lower_device, tl/xla) on the same numpy inputs:

- the layer plans, ring schedules and arenas of every device program;
- the plain version of kernel B11 (``gen_device_ref``) against the
  reference's Pallas kernel in interpret mode, bitwise, on exact programs
  and on programs with int8/fp8 edges (whose scale is amax times
  float32(1/QMAX), as the reference's compiled kernel computes it);
- the plain version against the reference's XLA backend over a wider grid
  of exact programs, ops and dtypes;
- against the reference's host interpreter (GeneratedCollTask);
- the ``gen_dev_*`` score rows against tl/xla's, the candidate lists with
  the feature off, the eligibility refusals that fall back to ``xla``, and
  persistent runs through the whole stack with a TUNE pin.

The CUDA kernel itself runs only on the card: chip_smoke.py holds both of
its entry points bitwise to this plain version there."""
import os

import ml_dtypes
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import ucc_tpu  # noqa: E402
from ucc_tpu.constants import CollType as JCollType  # noqa: E402
from ucc_tpu.constants import MemoryType as JMemoryType  # noqa: E402
from ucc_tpu.constants import ReductionOp as JReductionOp  # noqa: E402
from ucc_tpu.dsl import lower_device as jld  # noqa: E402
from ucc_tpu.dsl import registry as jreg  # noqa: E402
from ucc_tpu.dsl.ir import ProgramBuilder as JProgramBuilder  # noqa: E402
from harness import UccJob  # noqa: E402
from torch_ring_cases import bitwise_equal  # noqa: E402
from torch_stack_cases import _env, make_torch_job  # noqa: E402

import ucc_tpu_torch as ut  # noqa: E402
from ucc_tpu_torch.api.types import coll_args_msgsize  # noqa: E402
from ucc_tpu_torch.core.coll import InitArgs  # noqa: E402
from ucc_tpu_torch.dsl import lower_device as ld  # noqa: E402
from ucc_tpu_torch.dsl import registry as reg  # noqa: E402
from ucc_tpu_torch.dsl.ir import ProgramBuilder  # noqa: E402
from ucc_tpu_torch.kernels import gen_device as kgd  # noqa: E402
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy  # noqa: E402

DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16, "i8": np.int8,
          "i32": np.int32}


def bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def assert_bitwise(got, want):
    """Bitwise per rank, NaN positions compared as NaN (their payloads
    are each library's own)."""
    for g, w in zip(got, want):
        assert bitwise_equal(g, w), (g, w)


def jax_prog(family, param, n, wire=""):
    pk = jreg._GRID_PARAM_KEY.get(family)
    return jreg._construct(family, {pk: param} if pk else {}, n, wire, None)


def progs(family, param, n, wire=""):
    """(reference program, port program) of one grid entry."""
    return jax_prog(family, param, n, wire), \
        reg.build_program(family, param, n, wire=wire)


def inputs(n, count, dt, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(DTYPES[dt]).kind == "i":
        return [rng.integers(-50, 50, count).astype(DTYPES[dt])
                for _ in range(n)]
    return [(rng.standard_normal(count) * 3).astype(DTYPES[dt])
            for _ in range(n)]


def run_jax(prog, n, arrs, op, root, backend, qblock=256, qmode=""):
    """The reference's lowered program on an n-device mesh (the Pallas
    backend runs in interpret mode on the CPU); per-rank results."""
    count = arrs[0].size
    mesh = jax.make_mesh((n,), ("r",), devices=jax.devices()[:n])
    program, _ = jld.build_device_program(
        mesh, prog, n, count, JReductionOp[op], arrs[0].dtype, root, backend,
        qblock, qmode)
    shards = [jax.device_put(jnp.asarray(a), jax.devices()[r])
              for r, a in enumerate(arrs)]
    garr = jax.make_array_from_single_device_arrays(
        (n * count,), NamedSharding(mesh, P("r")), shards)
    return list(np.asarray(jax.block_until_ready(program(garr)))
                .reshape(n, count))


def run_port(prog, n, arrs, op, root, qblock=256, qmode="", inplace=False):
    """The port's wrapper on CPU tensors (its plain version); per-rank
    results. In place, each rank's src is its dst."""
    plan = ld.device_plan(prog, n, arrs[0].size, root, qblock, qmode)
    srcs = [from_numpy(a, "cpu") for a in arrs]
    dsts = srcs if inplace else [torch.empty_like(s) for s in srcs]
    wrapper = kgd.gen_device_ring if plan.ring else kgd.gen_device_gen
    before = wrapper.launches
    wrapper(srcs, dsts, ut.ReductionOp[op], plan=plan).wait()
    assert wrapper.launches == before            # CPU tensors: no launch
    return [to_numpy(d) for d in dsts], plan


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def _plan_rows(plans):
    out = []
    for rp in plans:
        layers = [([(r.p, r.q, r.chunk0, r.length, int(r.kind), r.wire)
                    for r in lay.runs], lay.length, int(lay.kind), lay.wire,
                   lay.send_chunk0.tolist(), lay.has_send.tolist(),
                   lay.recv_chunk0.tolist(), lay.has_recv.tolist(),
                   list(lay.perm), lay.dst_full.tolist())
                  for lay in rp.layers]
        copies = [(c.src_chunk.tolist(), c.dst_chunk.tolist(),
                   c.has.tolist()) for c in rp.copies]
        out.append((layers, copies))
    return out


@pytest.mark.parametrize("n", [2, 4, 8])
def test_plans_schedules_and_arenas_match(n):
    want = jld.device_programs(n, "int8")
    got = ld.device_programs(n, "int8")
    assert [p.name for p in got] == [p.name for p in want]
    assert len(got) >= 6
    for jp, p in zip(want, got):
        roots = [0, n - 1] if p.coll == ut.CollType.BCAST else [0]
        for root in roots:
            jplans = jld.plan_rounds(jp, n, root)
            plans = ld.plan_rounds(p, n, root)
            assert _plan_rows(plans) == _plan_rows(jplans), (p.name, root)
            js, s = jld.ring_schedule(jplans, n), ld.ring_schedule(plans, n)
            assert (s is None) == (js is None)
            if s is not None:
                assert [(m, int(k)) for m, k in s] == \
                    [(m, int(k)) for m, k in js]
            for ce, qblock in ((37, 256), (40, 32)):
                assert ld.pallas_arena(plans, ce, qblock) == \
                    jld._pallas_arena(jplans, ce, qblock)
        if p.name.startswith("gen_qint8"):
            # program-level wire: every layer exact, no wire arena
            assert ld.pallas_arena(ld.plan_rounds(p, n), 1 << 21, 256)[1:3] \
                == (0, 0)


def test_program_level_wire_lowers_exact():
    p = reg.build_program("qdirect", 0, 8, wire="int8")
    assert p.wire == "int8" and p.edge_wire_mode == ""
    plan = ld.device_plan(p, 8, 8 * 64, qmode="int8")
    assert not plan.ring and plan.arena == 0
    assert set(plan.prog[:, 0].tolist()) == {kgd.I_EXACT}
    ex, wb, sc, nl = ld.pallas_arena(ld.plan_rounds(p, 8), 1 << 21, 256)
    # 208 MiB of exact arena per rank at 16 Mi f32 in the reference
    assert (wb, sc, nl) == (0, 0, 26) and ex * 4 == 208 << 20


def test_ring_plans_take_the_ring_entry():
    plan = ld.device_plan(reg.build_program("ring", 2, 8), 8, 16 * 37)
    assert plan.ring and plan.blk == 2 * 37 and len(plan.prog) == 14
    plan = ld.device_plan(reg.build_program("rhd", 2, 8), 8, 8 * 37)
    assert not plan.ring and len(plan.prog) == 6


# ---------------------------------------------------------------------------
# the plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

PALLAS_CASES = [
    # (family, param, n, dtype, op, root, inplace)
    ("ring", 2, 4, "f32", "SUM", 0, False),
    ("ring", 2, 2, "bf16", "AVG", 0, True),
    ("rhd", 2, 4, "bf16", "SUM", 0, False),
    ("rhd", 2, 8, "f32", "AVG", 0, True),
    ("rhd", 0, 4, "f32", "AVG", 0, False),
    ("qdirect", 0, 4, "f32", "SUM", 0, False),
    ("bc_kn", 2, 4, "f32", None, 3, False),
    ("bc_chain", 2, 8, "bf16", None, 5, True),
]


@pytest.mark.parametrize("family,param,n,dt,op,root,inplace", PALLAS_CASES)
def test_plain_version_matches_pallas_kernel(family, param, n, dt, op, root,
                                             inplace):
    wire = "int8" if family == "qdirect" else ""
    jp, p = progs(family, param, n, wire)
    arrs = inputs(n, p.nchunks * 37, dt, seed=n + param + len(family))
    want = run_jax(jp, n, arrs, op or "SUM", root, "pallas", 256, wire)
    got, _ = run_port(p, n, arrs, op or "SUM", root, 256, wire, inplace)
    assert_bitwise(got, want)
    if op is None:
        for g in got:
            np.testing.assert_array_equal(bits(g), bits(arrs[root]))


# ---------------------------------------------------------------------------
# int8/fp8 edges
# ---------------------------------------------------------------------------

def wire_direct(builder, ct, n, rs_wire, ag_wire):
    """The direct exchange with int8/fp8 tags on the edges of its reduce
    round and/or its gather round (one layer per round at n = 2)."""
    b = builder("wdirect", ct.ALLREDUCE, n, n)
    b.next_round()
    for p in range(n):
        for q in range(n):
            if p != q:
                b.send(p, q, to=q, wire=rs_wire)
    for q in range(n):
        for p in range(n):
            if p != q:
                b.reduce(q, q, frm=p, wire=rs_wire)
    b.next_round()
    for q in range(n):
        for p in range(n):
            if p != q:
                b.send(q, q, to=p, wire=ag_wire)
    for p in range(n):
        for q in range(n):
            if p != q:
                b.recv(p, q, frm=q, wire=ag_wire)
    return b.build("gen_wdirect")


@pytest.mark.parametrize("n,rs,ag", [
    (2, "int8", "int8"), (2, "fp8", "fp8"), (4, "int8", ""),
    (4, "", "fp8"), (4, "fp8", "fp8"), (8, "int8", "int8")])
def test_edge_wire_programs_hold_to_the_pallas_kernel(n, rs, ag):
    """Bitwise, one wired layer per round (n = 2, gather rounds) or n - 1
    of them (reduce rounds at n > 2). 40 elements per chunk in blocks of
    32: every run ends in a tail block padded with zeros."""
    jp = wire_direct(JProgramBuilder, JCollType, n, rs, ag)
    p = wire_direct(ProgramBuilder, ut.CollType, n, rs, ag)
    qmode = rs or ag
    arrs = inputs(n, n * 40, "f32", seed=n * 7 + len(qmode))
    want = run_jax(jp, n, arrs, "SUM", 0, "pallas", 32, qmode)
    got, plan = run_port(p, n, arrs, "SUM", 0, 32, qmode)
    assert plan.arena > 0
    assert_bitwise(got, want)
    if n == 2 or not ag:
        for g in got[1:]:                  # every rank holds one result
            np.testing.assert_array_equal(bits(g), bits(got[0]))
    # else each layer of the wired gather round re-quantizes the sender's
    # decoded copy, which is not idempotent: receivers of later layers get
    # a value an ulp or so away, in the reference as here (ROADMAP §C)
    exact = np.stack(arrs).sum(0)
    tol = {"int8": 0.02, "fp8": 0.25}[qmode] * np.abs(exact).max()
    assert np.abs(got[0] - exact).max() <= tol


@pytest.mark.parametrize("rs,ag", [("int8", ""), ("", "int8")])
def test_reference_backends_differ_on_wire_reduce_layers(rs, ag):
    """A fact about the reference that the port does not inherit: on the
    same edge-wire program its XLA and Pallas (interpret) backends
    disagree by up to an f32 ulp of the sum when the reduce round is wired,
    and agree bitwise when only the gather round is (n = 4, 64 elements
    per chunk, qblock 32). The port holds to the Pallas kernel bitwise."""
    n = 4
    jp = wire_direct(JProgramBuilder, JCollType, n, rs, ag)
    arrs = inputs(n, n * 64, "f32", seed=0)
    pallas = np.stack(run_jax(jp, n, arrs, "SUM", 0, "pallas", 32, "int8"))
    xla = np.stack(run_jax(jp, n, arrs, "SUM", 0, "xla", 32, "int8"))
    differ = int((bits(pallas) != bits(xla)).sum())
    if rs:
        scale = np.spacing(np.sum(np.abs(np.stack(arrs)), axis=0))
        assert differ > 0 and (np.abs(pallas - xla) <= scale).all()
    else:
        assert differ == 0


@pytest.mark.parametrize("qmode", ["int8", "fp8"])
def test_payload_and_scales_match_the_reference_formula(qmode):
    """quantize() against lower_device.py:615-627 (divide, then one cast)
    compiled as the reference's kernel is (jitted, with QMAX a constant),
    on a run with a tail block and an all-zero block."""
    from ucc_tpu.dsl.lower_device import _QMAX, _q_cast
    x = inputs(1, 3 * 32 + 11, "f32", seed=5)[0]
    x[32:64] = 0.0
    wl = 4 * 32

    @jax.jit
    def ref(x):
        x2 = jnp.pad(x, (0, wl - x.size)).reshape(-1, 32)
        amax = jnp.max(jnp.abs(x2), axis=1)
        jscale = jnp.where(amax > 0.0, amax / _QMAX[qmode], 1.0)
        jq = _q_cast(x2 / jscale[:, None], qmode)
        return jscale, jq, (jq.astype(jnp.float32)
                            * jscale[:, None]).reshape(-1)[:x.size]
    q, scale, deq = kgd.quantize(torch.from_numpy(x.copy()), qmode, 32)
    jscale, jq, jdeq = ref(jnp.asarray(x))
    # the compiled division by the constant is a multiply by its reciprocal
    amax = np.abs(np.pad(x, (0, wl - x.size)).reshape(-1, 32)).max(1)
    inv = np.float32(1) / np.float32(_QMAX[qmode])
    np.testing.assert_array_equal(
        bits(np.asarray(jscale)),
        bits(np.where(amax > 0, amax * inv, np.float32(1)).astype(np.float32)))
    np.testing.assert_array_equal(bits(scale.numpy()), bits(np.asarray(jscale)))
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(jq).reshape(-1).view(np.uint8))
    np.testing.assert_array_equal(bits(deq.numpy()), bits(np.asarray(jdeq)))
    assert float(scale[1]) == 1.0 and not q[32:64].view(torch.uint8).any()


# ---------------------------------------------------------------------------
# the plain version against the reference's XLA backend
# ---------------------------------------------------------------------------

XLA_CASES = [
    # (family, param, n, dtype, op)
    ("ring", 1, 2, "i8", "SUM"), ("ring", 4, 4, "i32", "PROD"),
    ("ring", 2, 8, "bf16", "MAX"), ("rhd", 2, 2, "f32", "MIN"),
    ("rhd", 2, 8, "i8", "MAX"), ("rhd", 0, 4, "bf16", "AVG"),
    ("rhd", 0, 8, "i32", "SUM"), ("rhd", 2, 4, "i32", "MIN"),
    ("ring", 1, 8, "f32", "PROD"), ("bc_kn", 0, 8, "i8", None),
    ("bc_kn", 2, 2, "bf16", None), ("bc_chain", 2, 4, "i32", None),
]


@pytest.mark.parametrize("family,param,n,dt,op", XLA_CASES)
def test_plain_version_matches_xla_backend(family, param, n, dt, op):
    jp, p = progs(family, param, n)
    root = n - 1 if op is None else 0
    arrs = inputs(n, p.nchunks * 21, dt, seed=3 * n + param)
    if op in ("MAX", "MIN") and dt in ("f32", "bf16"):
        arrs[1][3] = np.nan                 # must propagate
    want = run_jax(jp, n, arrs, op or "SUM", root, "xla")
    got, _ = run_port(p, n, arrs, op or "SUM", root)
    assert_bitwise(got, want)


# ---------------------------------------------------------------------------
# the plain version against the host interpreter (GeneratedCollTask)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_job():
    job = UccJob(4, lib_overrides={"GEN": "y", "GEN_NATIVE": "n",
                                   "GEN_FAMILIES": "ring(2),rhd(2,0)"})
    yield job, job.create_team()
    job.cleanup()


@pytest.mark.parametrize("family,param", [("ring", 2), ("rhd", 2),
                                          ("rhd", 0)])
def test_plain_version_matches_host_interpreter(host_job, family, param):
    from ucc_tpu.score.tuner import forced_request, sweep_candidates
    job, teams = host_job
    n, count = 4, 8 * 37
    _, p = progs(family, param, n)
    arrs = inputs(n, count, "f32", seed=param + 11)
    msgsize = count * 4
    cands = sweep_candidates(teams[0], JCollType.ALLREDUCE,
                             JMemoryType.HOST, msgsize)
    idx = next(i for i, c in enumerate(cands) if c.alg_name == p.name)
    dsts = [np.zeros(count, np.float32) for _ in range(n)]
    reqs = [forced_request(teams[r], ucc_tpu.CollArgs(
        coll_type=JCollType.ALLREDUCE, op=JReductionOp.SUM,
        src=ucc_tpu.BufferInfo(arrs[r].copy(), count,
                               ucc_tpu.DataType.FLOAT32),
        dst=ucc_tpu.BufferInfo(dsts[r], count, ucc_tpu.DataType.FLOAT32)),
        JCollType.ALLREDUCE, JMemoryType.HOST, msgsize, idx)
        for r in range(n)]
    for rq in reqs:
        rq.post()
    job.progress_until(lambda: all(
        [rq.test() != ucc_tpu.Status.IN_PROGRESS for rq in reqs]))
    assert all(rq.test() == ucc_tpu.Status.OK for rq in reqs)
    for rq in reqs:
        rq.finalize()
    got, _ = run_port(p, n, arrs, "SUM", 0)
    assert_bitwise(got, dsts)


# ---------------------------------------------------------------------------
# registration, eligibility, the stack
# ---------------------------------------------------------------------------

def _torch_ops_team(team):
    return next(t for t in team.cl_teams[0].tl_teams
                if t.NAME == "torch_ops")


def _gen_rows(team, coll, mem):
    return [(r.alg_name, r.start, r.end, r.score, r.origin, r.precision,
             r.gen) for r in team.score_map.lookup(coll, mem, 4096)
            if r.origin == "generated-device"]


@pytest.fixture(scope="module")
def torch_gen_job():
    job = make_torch_job(n=4, UCC_GEN_DEVICE="y", UCC_QUANT="int8")
    yield job
    job.cleanup()


def test_score_rows_match_tl_xla(torch_gen_job):
    with _env(UCC_GEN_DEVICE="y", UCC_QUANT="int8"):
        job = UccJob(4)
        try:
            teams = job.create_team()
            for coll in ("ALLREDUCE", "BCAST"):
                want = _gen_rows(teams[0], JCollType[coll], JMemoryType.TPU)
                got = _gen_rows(torch_gen_job.teams[0], ut.CollType[coll],
                                ut.MemoryType.CUDA)
                assert got == want and got
            xla = next(t for t in teams[0].cl_teams[0].tl_teams
                       if t.name == "xla")
            ops = _torch_ops_team(torch_gen_job.teams[0])
            for coll in ("ALLREDUCE", "BCAST"):
                want = [(s.id, s.name, s.default_select, s.precision,
                         s.origin, s.gen) for s in
                        xla.alg_table()[JCollType[coll]]
                        if s.origin == "generated-device"]
                got = [(s.id, s.name, s.default_select, s.precision,
                        s.origin, s.gen) for s in
                       ops.alg_table()[ut.CollType[coll]]
                       if s.origin == "generated-device"]
                assert got == want
        finally:
            job.cleanup()
    info = torch_gen_job.teams[0].score_map.print_info("t")
    assert "generated-device gen:ring(chunks=1)" in info
    assert "generated-device,int8 gen:qdirect(radix=4,int8)" in info


def test_off_leaves_the_candidate_lists_unchanged():
    """No gen_dev_* row: tl/torch_ops's short (4096 bytes lie below its
    cpu threshold), xla and, for allreduce, ring; then tl/ring_cuda's
    five."""
    from ucc_tpu_torch.tl.ring_cuda import TlRingCuda
    job = make_torch_job(n=2)
    try:
        smap = job.teams[0].score_map
        short = (ut.CollType.ALLREDUCE | ut.CollType.REDUCE |
                 ut.CollType.BCAST | ut.CollType.ALLGATHER |
                 ut.CollType.ALLTOALL | ut.CollType.BARRIER |
                 ut.CollType.FANIN | ut.CollType.FANOUT)
        for coll in ut.CollType:
            rows = [(r.team.NAME, r.alg_name, r.score, r.origin)
                    for r in smap.lookup(coll, ut.MemoryType.CUDA, 4096)]
            want = [("torch_ops", "short", 45, "default")] \
                if coll & short else []
            want.append(("torch_ops", "xla", 40, "default"))
            if coll == ut.CollType.ALLREDUCE:
                want.append(("torch_ops", "ring", 39, "default"))
            if coll & TlRingCuda.SUPPORTED_COLLS:
                want.append(("ring_cuda", "ring_cuda", 20, "default"))
            assert rows == want
    finally:
        job.cleanup()


def _args(coll, count, dt="FLOAT32", op=ut.ReductionOp.SUM, root=0):
    td = ut.dt_torch(ut.DataType[dt])
    buf = torch.zeros(count, dtype=td)
    if coll == ut.CollType.BCAST:
        return ut.CollArgs(coll_type=coll, root=root, src=ut.BufferInfo(
            buf, count, ut.DataType[dt], mem_type=ut.MemoryType.CUDA))
    return ut.CollArgs(
        coll_type=coll, op=op,
        src=ut.BufferInfo(buf, count, ut.DataType[dt],
                          mem_type=ut.MemoryType.CUDA),
        dst=ut.BufferInfo(buf.clone(), count, ut.DataType[dt],
                          mem_type=ut.MemoryType.CUDA))


@pytest.mark.parametrize("alg,count,dt,op", [
    ("gen_dev_ring_c2", 8 * 5 + 1, "FLOAT32", "SUM"),   # indivisible
    ("gen_dev_rhd_r2", 4 * 5, "INT32", "AVG"),         # integer AVG
    ("gen_dev_rhd_r2", 4 * 5, "FLOAT32", "BXOR"),      # op
    ("gen_dev_rhd_r2", 4 * 5, "UINT16", "SUM"),        # dtype
    ("gen_dev_qint8_direct", 4 * 5, "BFLOAT16", "SUM"),  # wire payload
    ("gen_dev_qint8_direct", 4 * 5, "FLOAT32", "MAX"),   # wire op
])
def test_eligibility_refusals_fall_back_to_xla(torch_gen_job, alg, count, dt,
                                               op):
    team = torch_gen_job.teams[0]
    args = _args(ut.CollType.ALLREDUCE, count, dt, ut.ReductionOp[op])
    msgsize = coll_args_msgsize(args, 4, 0)
    cands = team.score_map.lookup(ut.CollType.ALLREDUCE, ut.MemoryType.CUDA,
                                  msgsize)
    gen = [c for c in cands if c.alg_name == alg]
    assert gen
    ia = InitArgs(args=args, team=team, mem_type=ut.MemoryType.CUDA,
                  msgsize=msgsize)
    ops = _torch_ops_team(team)
    tag = ops._coll_tag
    with pytest.raises(ut.UccError) as ei:
        gen[0].init(ia, gen[0].team)
    assert ei.value.status == ut.Status.ERR_NOT_SUPPORTED
    assert ops._coll_tag == tag            # refused before the tag
    rest = [c for c in cands if not c.alg_name.startswith("gen_dev")]
    if dt == "UINT16" or op == "BXOR":     # every TL refuses these
        with pytest.raises(ut.UccError) as ei:
            team.score_map.init_coll(ut.CollType.ALLREDUCE,
                                     ut.MemoryType.CUDA, msgsize, ia,
                                     gen + rest)
        assert ei.value.status == ut.Status.ERR_NOT_SUPPORTED
        return
    task, chosen = team.score_map.init_coll(
        ut.CollType.ALLREDUCE, ut.MemoryType.CUDA, msgsize, ia, gen + rest)
    # the library ops take AVG of floating types only: an integer mean is
    # the ring's; at these sizes they run as ``short``, as tl/xla's do
    assert chosen.alg_name == ("ring_cuda" if op == "AVG" else "short")


def test_quant_knobs_gate_the_wire_program():
    for env in ({"UCC_QUANT_STOCHASTIC": "y"},
                {"UCC_QUANT_ERROR_BUDGET": "1e-6"}):
        job = make_torch_job(n=2, UCC_GEN_DEVICE="y", UCC_QUANT="int8", **env)
        try:
            team = job.teams[0]
            args = _args(ut.CollType.ALLREDUCE, 8)
            ms = coll_args_msgsize(args, 2, 0)
            cand = next(c for c in team.score_map.lookup(
                ut.CollType.ALLREDUCE, ut.MemoryType.CUDA, ms)
                if c.alg_name == "gen_dev_qint8_direct")
            with pytest.raises(ut.UccError) as ei:
                cand.init(InitArgs(args=args, team=team,
                                   mem_type=ut.MemoryType.CUDA, msgsize=ms),
                          cand.team)
            assert ei.value.status == ut.Status.ERR_NOT_SUPPORTED
        finally:
            job.cleanup()
    job = make_torch_job(n=2, UCC_GEN_DEVICE="y")
    try:
        names = {r.alg_name for r in job.teams[0].score_map.lookup(
            ut.CollType.ALLREDUCE, ut.MemoryType.CUDA, 64)}
        assert "gen_dev_ring_c1" in names
        assert not any("qint8" in a or "qfp8" in a for a in names)
    finally:
        job.cleanup()


@pytest.mark.parametrize("coll,alg,dt,op,root,backend", [
    ("ALLREDUCE", "gen_dev_ring_c2", "f32", "SUM", None, "auto"),
    ("ALLREDUCE", "gen_dev_rhd_r4", "bf16", "AVG", None, "auto"),
    ("ALLREDUCE", "gen_dev_rhd_r2", "i8", "PROD", None, "xla"),
    ("BCAST", "gen_dev_bc_chain_c2", "f32", None, 3, "auto"),
])
def test_persistent_through_the_stack(coll, alg, dt, op, root, backend):
    """init -> context -> team -> collective_init with UCC_GEN_DEVICE=y and
    a TUNE pin, three persistent rounds, against the plain version."""
    job = make_torch_job(
        n=4, UCC_GEN_DEVICE="y", UCC_GEN_DEVICE_BACKEND=backend,
        UCC_TL_TORCH_OPS_TUNE=f"{coll.lower()}:@{alg}:inf")
    try:
        fam_name = alg[len("gen_dev_"):]
        prog = next(p for p in ld.device_programs(4)
                    if p.name == "gen_" + fam_name)
        hosts = inputs(4, prog.nchunks * 9, dt, seed=len(alg))
        ct = ut.CollType[coll]
        dtype = {"f32": "FLOAT32", "bf16": "BFLOAT16", "i8": "INT8"}[dt]
        rounds = job.persistent(ct, hosts, ut.ReductionOp[op or "SUM"],
                                ut.DataType[dtype], root=root, alg=alg)
        plan = ld.device_plan(prog, 4, hosts[0].size, root or 0)
        want = [to_numpy(o) for o in kgd.gen_device_ref(
            [from_numpy(h, "cpu") for h in hosts], plan,
            ut.ReductionOp[op or "SUM"])]
        for got in rounds:
            assert_bitwise(got, want)
    finally:
        job.cleanup()


def test_wrappers_refuse_the_wrong_plan():
    ring = ld.device_plan(reg.build_program("ring", 1, 4), 4, 8)
    gen = ld.device_plan(reg.build_program("rhd", 2, 4), 4, 8)
    assert ring.ring and not gen.ring
    srcs = [torch.zeros(8) for _ in range(4)]
    with pytest.raises(ut.UccError):
        kgd.gen_device_ring(srcs, srcs, ut.ReductionOp.SUM, plan=gen)
    with pytest.raises(ut.UccError):
        kgd.gen_device_gen(srcs, srcs, ut.ReductionOp.SUM, plan=ring)
    with pytest.raises(ut.UccError):
        kgd.gen_device_gen([torch.zeros(6)] * 4, [torch.zeros(6)] * 4,
                           ut.ReductionOp.SUM, plan=gen)


def test_device_families_knob():
    with pytest.raises(ValueError):
        ld.parse_device_families("ag_ring(1)")
    with pytest.raises(ValueError):
        jld.parse_device_families("ag_ring(1)")
    assert ld.parse_device_families("ring(2),qdirect") == \
        jld.parse_device_families("ring(2),qdirect")
    assert ld.MAX_DEVICE_RANKS == jld.MAX_DEVICE_RANKS == 32
    assert os.environ.get("UCC_GEN_DEVICE") is None
