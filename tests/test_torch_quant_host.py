"""The port's quantized host collectives (tl/host/quantized.py on tl/shm)
held bitwise against the JAX package's on the same seeded numpy inputs.

Both packages run 8 in-process ranks with TLS=shm,self and the lib's
UCC_QUANT set; every q* variant is pinned through UCC_TL_SHM_TUNE at team
sizes 2, 3, 5 and 8, float32 and bfloat16 (the reference runs with
UCC_GEN_NATIVE=n, its classic generators). The candidate lists and the
score dump's rows must be the same with UCC_QUANT off, int8 and fp8, and
an error budget that refuses quantization must walk to the same exact
algorithm."""
import numpy as np
import pytest

import ucc_tpu
import ucc_tpu_torch as ut
from test_torch_host_colls import Job, env, run_case

SIZES = (2, 3, 5, 8)
MODES = ("int8", "fp8")
#: per-rank elements: odd, so the blocks of the reduce-scatter split
#: unevenly and no block ends on a scale block's bound
AR_COUNT = 1031
AG_COUNT = 333


def _jobs(**lib_env):
    values = dict(UCC_GEN_NATIVE="n", UCC_GEN=None, UCC_TL_SHM_TUNE=None,
                  UCC_QUANT=None, UCC_QUANT_ERROR_BUDGET=None)
    values.update(lib_env)
    with env(**values):
        return {"ref": Job(ucc_tpu), "native": Job(ut)}


@pytest.fixture(scope="module")
def quant_jobs():
    jobs = {"off": _jobs(), "int8": _jobs(UCC_QUANT="int8"),
            "fp8": _jobs(UCC_QUANT="fp8"),
            "budget": _jobs(UCC_QUANT="int8", UCC_QUANT_ERROR_BUDGET="1e-6")}
    yield jobs
    for pair in jobs.values():
        for j in pair.values():
            j.destroy()


VARIANTS = (("ALLREDUCE", "sra"), ("ALLREDUCE", "ring"),
            ("ALLGATHER", "linear"))


@pytest.mark.parametrize("dt", ("FLOAT32", "BFLOAT16"))
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("coll,variant", VARIANTS)
@pytest.mark.parametrize("mode", MODES)
def test_quantized_variants_match_the_reference(quant_jobs, mode, coll,
                                                variant, n, dt):
    alg = f"q{mode}_{variant}"
    want = run_case(quant_jobs[mode], coll, n,
                    AR_COUNT if coll == "ALLREDUCE" else AG_COUNT, dt=dt,
                    tune=f"{coll.lower()}:@{alg}:inf", seed=n + 10 * len(dt))
    assert want[0] == ["OK"] * n and want[1] == [alg] * n


@pytest.mark.parametrize("n", (3, 8))
@pytest.mark.parametrize("variant", ("sra", "ring"))
@pytest.mark.parametrize("mode", MODES)
def test_avg_matches_the_reference(quant_jobs, mode, variant, n):
    alg = f"q{mode}_{variant}"
    want = run_case(quant_jobs[mode], "ALLREDUCE", n, AR_COUNT, op="AVG",
                    tune=f"allreduce:@{alg}:inf", seed=5)
    assert want[1] == [alg] * n


@pytest.mark.parametrize("coll,variant", VARIANTS)
@pytest.mark.parametrize("mode", MODES)
def test_in_place_matches_the_reference(quant_jobs, mode, coll, variant):
    alg = f"q{mode}_{variant}"
    want = run_case(quant_jobs[mode], coll, 3,
                    AR_COUNT if coll == "ALLREDUCE" else AG_COUNT,
                    inplace=True, tune=f"{coll.lower()}:@{alg}:inf", seed=6)
    assert want[1] == [alg] * 3


@pytest.mark.parametrize("n", (2, 5))
@pytest.mark.parametrize("mode", MODES)
def test_persistent_reposts_match_the_reference(quant_jobs, mode, n):
    """Three posts of one persistent request: the leased wire scratch is
    reused, the result stays the reference's."""
    alg = f"q{mode}_sra"
    want = run_case(quant_jobs[mode], "ALLREDUCE", n, AR_COUNT,
                    tune=f"allreduce:@{alg}:inf", seed=8, rounds=3)
    assert want[1] == [alg] * n


def _rows(team, mod):
    """(collective, memory) -> [(component, alg, start, end, score,
    origin, precision)] of a team's score map."""
    from ucc_tpu.score.score_map import comp_name as jname
    from ucc_tpu_torch.score.score_map import comp_name as pname
    name = jname if mod is ucc_tpu else pname
    out = {}
    for (c, m), lst in team.score_map._sorted.items():
        if m.name != "HOST":
            continue
        out[c.name] = [(name(r), r.alg_name, r.start, r.end, r.score,
                        r.origin, r.precision) for r in lst]
    return out


@pytest.mark.parametrize("mode", ("off", "int8", "fp8", "budget"))
def test_candidate_lists_and_score_rows_match(quant_jobs, mode):
    ref = quant_jobs[mode]["ref"].team(4)
    port = quant_jobs[mode]["native"].team(4)
    assert _rows(port[0], ut) == _rows(ref[0], ucc_tpu)
    for ct in ("ALLREDUCE", "ALLGATHER"):
        for msgsize in (256, 64 << 10, 1 << 20):
            want = [(c.alg_name, c.score, c.precision) for c in
                    ref[0].score_map.lookup(ucc_tpu.CollType[ct],
                                            ucc_tpu.MemoryType.HOST,
                                            msgsize)]
            got = [(c.alg_name, c.score, c.precision) for c in
                   port[0].score_map.lookup(ut.CollType[ct],
                                            ut.MemoryType.HOST, msgsize)]
            assert got == want
            if mode == "off":
                assert not any(p for _, _, p in got)

    def host_lines(team):
        return [ln for ln in team.score_map.print_info("t").splitlines()
                if "/host" in ln]
    assert host_lines(port[0]) == host_lines(ref[0])
    if mode in ("int8", "fp8"):
        assert f"(default,{mode})" in "\n".join(host_lines(port[0]))


def test_default_selection_takes_the_quantized_range(quant_jobs):
    """Without TUNE, >= 64K of allreduce and allgather go to the
    quantized defaults in both packages; small messages stay exact."""
    want = run_case(quant_jobs["int8"], "ALLREDUCE", 4, 32 << 10, seed=1)
    assert want[1] == ["qint8_sra"] * 4
    want = run_case(quant_jobs["int8"], "ALLGATHER", 4, 8 << 10, seed=2)
    assert want[1] == ["qint8_linear"] * 4
    want = run_case(quant_jobs["int8"], "ALLREDUCE", 4, 64, seed=3)
    assert not want[1][0].startswith("q")


@pytest.mark.parametrize("coll", ("ALLREDUCE", "ALLGATHER"))
def test_budget_refusal_walks_to_the_same_exact_algorithm(quant_jobs, coll):
    """The quantized default of the >= 64K range is refused at init (its
    predicted error exceeds the budget) and the fallback walk lands on the
    same exact algorithm in both packages."""
    want = run_case(quant_jobs["budget"], coll, 4, 32 << 10, seed=4)
    assert want[0] == ["OK"] * 4
    assert not want[1][0].startswith("q")


@pytest.mark.parametrize("alg", ("qint8_sra", "qint8_ring"))
def test_budget_refusal_of_a_pinned_variant(quant_jobs, alg):
    """A TUNE string that pins the refused variant leaves no candidate:
    init is NOT_SUPPORTED on every rank, in both packages."""
    want = run_case(quant_jobs["budget"], "ALLREDUCE", 4, 32 << 10,
                    tune=f"allreduce:@{alg}:inf", seed=4)
    assert want[0] == ["init ERR_NOT_SUPPORTED"] * 4


@pytest.mark.parametrize("dt,op", (("INT32", "SUM"), ("FLOAT32", "PROD"),
                                   ("FLOAT64", "SUM")))
def test_unsupported_payloads_fall_back_as_the_reference(quant_jobs, dt, op):
    want = run_case(quant_jobs["int8"], "ALLREDUCE", 2, 32 << 10, dt=dt,
                    op=op, seed=7)
    assert want[0] == ["OK"] * 2
    assert not want[1][0].startswith("q")


def test_cancel_drops_the_tainted_lease(quant_jobs):
    """A quantized collective cancelled mid-flight withdraws its recvs,
    and its lease never re-enters the pool (a late peer send could
    scribble on it)."""
    from ucc_tpu_torch.mc.pool import HostMemPool, reset_host_pool
    job = quant_jobs["int8"]["native"]
    teams = job.team(2, "allreduce:@qint8_sra:inf")
    pool = HostMemPool()
    reset_host_pool(pool)
    try:
        import torch
        count = 32 << 10
        src, dst = torch.ones(count), torch.zeros(count)
        req = teams[0].collective_init(ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
            src=ut.BufferInfo(src, count, ut.DataType.FLOAT32),
            dst=ut.BufferInfo(dst, count, ut.DataType.FLOAT32)))
        assert req.task.alg_name == "qint8_sra"
        req.post()
        for _ in range(10):
            job.contexts[0].progress()
        assert req.test() == ut.Status.IN_PROGRESS
        assert pool.stats()["leased"] > 0
        req.task.cancel()
        assert req.test() == ut.Status.ERR_CANCELED
        req.finalize()
        assert pool.stats()["cached_elems"] == 0
    finally:
        reset_host_pool(None)
    # the team's tags are desynced now: never use it again
    job.teams.pop((2, "allreduce:@qint8_sra:inf"))
    for t in teams:
        t.destroy()
