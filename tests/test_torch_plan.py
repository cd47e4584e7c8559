"""The port's native execution plans (ucc_tpu_torch/dsl/plan.py over the
``ucc_plan_*`` entries of native_src/ucc_tpu_torch_core.cc) held against
the JAX package's dsl/plan.py and against numpy.

The cases of the reference's tests/test_plan.py, but for
``test_kill_shrink_with_plans``, which needs fault injection and shrink
(ROADMAP item 8): the lowered op tables equal the reference's entry for
entry; plans run the hand-written ring and sra bridges and the generated
programs bitwise as the interpreter does, and as the reference's plans do,
for float32/float64 SUM/PROD/MAX/MIN/AVG and bfloat16 through the assist
rounds (tolerance: none); float64 against numpy within rtol 1e-12 and
float32 within rtol 1e-4 (the sum order differs from numpy's); one ffi
crossing per collective; count-exact plan caching; cancel withdraws the
posted recvs and pins the buffers; team destroy returns the plans'
leases. ``UCC_GEN_NATIVE=y`` makes the plan required: when the core
cannot load or a plan cannot be built, the collective's init raises
ERR_NO_RESOURCE, where ``auto`` interprets.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import ucc_tpu
import ucc_tpu_torch as ut
from ucc_tpu.dsl import families as jfam
from ucc_tpu.dsl import plan as jplan
from ucc_tpu_torch import native
from ucc_tpu_torch.dsl import families as fam
from ucc_tpu_torch.dsl import plan as plan_mod
from ucc_tpu_torch.status import Status, UccError

from torch_gen_jobs import GenJob, pinned, same_bits

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native core not built")

_TD = {"FLOAT32": torch.float32, "FLOAT64": torch.float64,
       "BFLOAT16": torch.bfloat16}


def run_ar(job, n, dt, count, op="SUM", inplace=False, seed=0, tune=""):
    """One port allreduce on every member; returns (srcs as float64,
    per-rank result tensors, tasks, the plan each task ran or None)."""
    teams = job.team(n, tune)
    rng = np.random.default_rng(seed)
    srcs = [torch.from_numpy(rng.standard_normal(count) * 2).to(_TD[dt])
            for _ in range(n)]
    D = ut.DataType[dt]
    dsts, reqs = [], []
    for r, t in enumerate(teams):
        if inplace:
            buf = srcs[r].clone()
            dsts.append(buf)
            args = ut.CollArgs(coll_type=ut.CollType.ALLREDUCE,
                               src=ut.BufferInfo(buf, count, D),
                               dst=ut.BufferInfo(buf, count, D),
                               op=ut.ReductionOp[op],
                               flags=ut.CollArgsFlags.IN_PLACE)
        else:
            dst = torch.zeros(count, dtype=_TD[dt])
            dsts.append(dst)
            args = ut.CollArgs(coll_type=ut.CollType.ALLREDUCE,
                               src=ut.BufferInfo(srcs[r].clone(), count, D),
                               dst=ut.BufferInfo(dst, count, D),
                               op=ut.ReductionOp[op])
        reqs.append(t.collective_init(args))
    for rq in reqs:
        rq.post()
    job.until(lambda: all([rq.test() != ut.Status.IN_PROGRESS
                           for rq in reqs]))
    tasks = [rq.task for rq in reqs]
    # before finalize: finalize_fn hands the plan back to the team cache
    plans = [getattr(t, "_plan", None) for t in tasks]
    for rq in reqs:
        assert rq.test() == ut.Status.OK
        rq.finalize()
    return ([s.double().numpy() for s in srcs], dsts, tasks, plans)


def raw(dsts):
    return [d.view(torch.uint8).numpy().tobytes() for d in dsts]


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

def lowered(mod, prog, grank, count, nd, op, qp=None):
    n = prog.nranks
    ctx_of = [10 + g for g in range(n)]
    return mod.lower(prog, grank, count, nd, op, my_ctx=ctx_of[grank],
                     ctx_of=ctx_of, my_team_word=(7 << 32) | 2,
                     peer_team_word=[((g + 1) << 32) | 2 for g in range(n)],
                     qp=qp)


def same_lowering(got, want):
    assert got.ops == want.ops
    assert got.scratch_bytes == want.scratch_bytes
    assert got.round_bytes == want.round_bytes
    assert got.n_rounds == want.n_rounds
    assert got.dtype_code == want.dtype_code
    assert got.any_assist == want.any_assist
    assert sorted(got.assists) == sorted(want.assists)
    for k in want.assists:
        assert got.assists[k].pre == want.assists[k].pre
        assert got.assists[k].post == want.assists[k].post


class TestLowering:
    def test_ring_table_shape(self):
        prog = fam.gen_ring(4, chunks=1)
        low = plan_mod.lower(prog, 1, 100, np.dtype(np.float32),
                             ut.ReductionOp.SUM, my_ctx=1,
                             ctx_of=[0, 1, 2, 3], my_team_word=(7 << 32),
                             peer_team_word=[(g + 1) << 32
                                             for g in range(4)])
        waits = [o for o in low.ops
                 if (o[0] & 0xFF) == plan_mod.OP_WAIT_ROUND]
        assert len(waits) == prog.n_rounds == low.n_rounds == 6
        assert not low.assists and not low.any_assist
        kinds = [o[0] & 0xFF for o in low.ops]
        assert kinds.count(plan_mod.OP_POST_SEND) == 6
        assert kinds.count(plan_mod.OP_POST_RECV) == 6
        assert kinds.count(plan_mod.OP_REDUCE) == 3
        assert low.scratch_bytes >= 25 * 4

    def test_bf16_rounds_flagged_for_assist(self):
        # bfloat16 is uint16 storage in the port: no native dtype code
        low = plan_mod.lower(fam.gen_ring(2, chunks=1), 0, 64,
                             np.dtype(np.uint16), ut.ReductionOp.SUM,
                             my_ctx=0, ctx_of=[0, 1],
                             my_team_word=(1 << 32),
                             peer_team_word=[(1 << 32), (2 << 32)])
        assert low.any_assist and 0 in low.assists
        assert low.assists[0].post[0][0] == "red"

    def test_slot_and_epoch_packing(self):
        epoch_word = (9 << 32) | 3
        low = plan_mod.lower(fam.gen_ring(2, chunks=1), 0, 64,
                             np.dtype(np.float64), ut.ReductionOp.SUM,
                             my_ctx=5, ctx_of=[5, 8],
                             my_team_word=epoch_word,
                             peer_team_word=[epoch_word, (4 << 32) | 3])
        sends = [o for o in low.ops
                 if (o[0] & 0xFF) == plan_mod.OP_POST_SEND]
        recvs = [o for o in low.ops
                 if (o[0] & 0xFF) == plan_mod.OP_POST_RECV]
        assert all(o[1] == (4 << 32) | 3 for o in sends)
        assert all((o[2] & 0xFFFFFFFF) == 5 for o in sends)
        assert all(o[1] == epoch_word for o in recvs)
        assert all((o[2] & 0xFFFFFFFF) == 8 for o in recvs)

    def test_constants_match_the_reference(self):
        for name in ("PLAN_OP_WORDS", "OP_POST_SEND", "OP_POST_RECV",
                     "OP_WAIT_ROUND", "OP_REDUCE", "OP_COPY", "OP_ENCODE",
                     "OP_DECODE", "FLAG_PRE_ASSIST", "FLAG_POST_ASSIST",
                     "REG_USER", "REG_SCRATCH", "ST_RUNNING", "ST_DONE",
                     "ST_ERROR", "ST_FENCED", "ST_CANCELED", "ST_ASSIST",
                     "ST_CORRUPT", "ST_DEAD"):
            assert getattr(plan_mod, name) == getattr(jplan, name), name

    @pytest.mark.parametrize("op", ["SUM", "AVG", "PROD", "MAX", "MIN"])
    @pytest.mark.parametrize("dt", ["f32", "f64", "bf16"])
    @pytest.mark.parametrize("prog_args", [
        ("ring", 4, {"chunks": 1}), ("ring", 5, {"chunks": 2}),
        ("rhd", 4, {"radix": 2}), ("rhd", 8, {"radix": 8}),
        ("sra", 5, {"radix": 2}), ("sra", 8, {"radix": 4})])
    def test_tables_match_the_reference(self, prog_args, dt, op):
        family, n, params = prog_args
        make = {"ring": "gen_ring", "rhd": "gen_rhd", "sra": "gen_sra"}
        prog = getattr(fam, make[family])(n, **params)
        jprog = getattr(jfam, make[family])(n, **params)
        nd = {"f32": np.float32, "f64": np.float64, "bf16": np.uint16}[dt]
        jnd = {"bf16": ml_dtypes.bfloat16}.get(dt, nd)
        for grank in range(n):
            for count in (n * 3 + 1, 1000):
                same_lowering(
                    lowered(plan_mod, prog, grank, count, np.dtype(nd),
                            ut.ReductionOp[op]),
                    lowered(jplan, jprog, grank, count, np.dtype(jnd),
                            ucc_tpu.ReductionOp[op]))

    @pytest.mark.parametrize("mode", ["int8", "fp8"])
    def test_wire_tables_match_the_reference(self, mode):
        from ucc_tpu import quant as jquant
        from ucc_tpu_torch import quant
        qp = quant.QuantParams(quant.get_codec(mode), 256, 1.0, False)
        jqp = jquant.QuantParams(jquant.get_codec(mode), 256, 1.0, False)
        prog = fam.gen_rhd(4, radix=4, wire=mode)
        jprog = jfam.gen_rhd(4, radix=4, wire=mode)
        for grank in range(4):
            got = lowered(plan_mod, prog, grank, 4099, np.dtype(np.float32),
                          ut.ReductionOp.SUM, qp)
            same_lowering(got, lowered(jplan, jprog, grank, 4099,
                                       np.dtype(np.float32),
                                       ucc_tpu.ReductionOp.SUM, jqp))
            assert any((o[0] & 0xFF) == plan_mod.OP_ENCODE for o in got.ops)


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plan_jobs():
    """Port jobs under UCC_GEN_NATIVE=y / n, and reference ones under y,
    per team size; UCC_GEN=y for the generated programs."""
    made = {}

    def get(mod, n, native_mode):
        key = (mod.__name__, n, native_mode)
        if key not in made:
            made[key] = GenJob(mod, n, UCC_GEN_NATIVE=native_mode)
        return made[key]
    yield get
    for job in made.values():
        job.destroy()


class TestPlanExecution:
    @pytest.mark.parametrize("n", [2, 4, 5, 8])
    def test_ring_bridge_matches_the_reference(self, plan_jobs, n):
        job = plan_jobs(ut, n, "y")
        srcs, dsts, tasks, plans = run_ar(job, n, "FLOAT32", 1003,
                                          tune="allreduce:@ring:inf")
        assert all(p is not None for p in plans), "no plan ran"
        assert all(t.prog.family == "ring" for t in tasks)
        want = np.sum(np.stack(srcs), axis=0)
        for d in dsts:
            np.testing.assert_allclose(d.numpy(), want, rtol=1e-4,
                                       atol=1e-5)
        case = {"coll": "ALLREDUCE", "c": 1003, "dt": "FLOAT32",
                "op": "SUM", "seed": n}
        same_bits(pinned(job, case, n, "ring"),
                  pinned(plan_jobs(ucc_tpu, n, "y"), case, n, "ring"),
                  "ring")

    @pytest.mark.parametrize("dt", ["FLOAT32", "FLOAT64", "BFLOAT16"])
    @pytest.mark.parametrize("alg", ["ring", "sra_knomial"])
    @pytest.mark.parametrize("n", [5, 8])
    def test_bridges_bitwise_the_classic_algorithms(self, plan_jobs, n,
                                                    alg, dt):
        """The bridge programs are the classic generators' loops: a plan
        (UCC_GEN_NATIVE=y) gives the classic task's bytes (n)."""
        case = {"coll": "ALLREDUCE", "c": 10007, "dt": dt, "op": "SUM",
                "seed": n}
        same_bits(pinned(plan_jobs(ut, n, "y"), case, n, alg),
                  pinned(plan_jobs(ut, n, "n"), case, n, alg), alg)

    @pytest.mark.parametrize("op", ["SUM", "PROD", "MAX", "MIN", "AVG"])
    def test_ops_f64_vs_numpy_and_the_reference(self, plan_jobs, op):
        job = plan_jobs(ut, 4, "y")
        srcs, dsts, _, plans = run_ar(job, 4, "FLOAT64", 257, op=op,
                                      seed=3, tune="allreduce:@ring:inf")
        assert all(p is not None for p in plans)
        stack = np.stack(srcs)
        want = {"SUM": stack.sum(0), "PROD": stack.prod(0),
                "MAX": stack.max(0), "MIN": stack.min(0),
                "AVG": stack.sum(0) / 4}[op]
        for d in dsts:
            np.testing.assert_allclose(d.numpy(), want, rtol=1e-12)
        case = {"coll": "ALLREDUCE", "c": 257, "dt": "FLOAT64", "op": op,
                "seed": 3}
        same_bits(pinned(job, case, 4, "ring"),
                  pinned(plan_jobs(ucc_tpu, 4, "y"), case, 4, "ring"),
                  "ring")

    @pytest.mark.parametrize("n", [5, 8])
    def test_sra_bridge_runs_plan_incl_extras(self, plan_jobs, n):
        job = plan_jobs(ut, n, "y")
        srcs, dsts, tasks, plans = run_ar(
            job, n, "FLOAT32", 777, seed=5,
            tune="allreduce:@sra_knomial:inf")
        assert all(p is not None for p in plans)
        assert tasks[0].prog.family == "sra"
        want = np.sum(np.stack(srcs), axis=0)
        for d in dsts:
            np.testing.assert_allclose(d.numpy(), want, rtol=1e-4,
                                       atol=1e-5)
        case = {"coll": "ALLREDUCE", "c": 777, "dt": "FLOAT32",
                "op": "SUM", "seed": 5}
        same_bits(pinned(job, case, n, "sra_knomial"),
                  pinned(plan_jobs(ucc_tpu, n, "y"), case, n,
                         "sra_knomial"), "sra_knomial")

    def test_one_ffi_crossing_per_collective(self, plan_jobs):
        n = 4
        job = plan_jobs(ut, n, "y")
        run_ar(job, n, "FLOAT32", 512, tune="allreduce:@ring:inf")
        f0 = native.plan_ffi_calls()
        _, _, _, plans = run_ar(job, n, "FLOAT32", 512, seed=1,
                                tune="allreduce:@ring:inf")
        assert all(p is not None for p in plans)
        assert native.plan_ffi_calls() - f0 == n

    @pytest.mark.parametrize("name", ["gen_ring_c2", "gen_rhd_r4",
                                      "gen_ring_c1"])
    def test_bitwise_identical_to_interpreter(self, plan_jobs, name):
        """Plan and interpreted runs of one program give the same bytes
        (float32 SUM, float64 inplace AVG, bfloat16 SUM through the
        assist rounds), and so do the reference's plans."""
        tune = f"allreduce:@{name}:inf"
        out = {}
        for mode in ("n", "y"):
            job = plan_jobs(ut, 4, mode)
            _, d1, _, p1 = run_ar(job, 4, "FLOAT32", 1009, seed=7,
                                  tune=tune)
            _, d2, _, p2 = run_ar(job, 4, "FLOAT64", 400, op="AVG",
                                  inplace=True, seed=8, tune=tune)
            _, d3, _, p3 = run_ar(job, 4, "BFLOAT16", 333, seed=9,
                                  tune=tune)
            assert all((p is not None) == (mode == "y")
                       for p in p1 + p2 + p3)
            out[mode] = raw(d1 + d2 + d3)
        assert out["n"] == out["y"]
        for case in ({"coll": "ALLREDUCE", "c": 1009, "dt": "FLOAT32",
                      "op": "SUM", "seed": 7},
                     {"coll": "ALLREDUCE", "c": 333, "dt": "BFLOAT16",
                      "op": "SUM", "seed": 9}):
            same_bits(pinned(plan_jobs(ut, 4, "y"), case, 4, name),
                      pinned(plan_jobs(ucc_tpu, 4, "y"), case, 4, name),
                      name)

    def test_auto_mode_excludes_bf16(self):
        job = GenJob(ut, 2, UCC_GEN_NATIVE="auto")
        try:
            _, _, _, p_f32 = run_ar(job, 2, "FLOAT32", 256,
                                    tune="allreduce:@ring:inf")
            _, _, _, p_bf = run_ar(job, 2, "BFLOAT16", 256, seed=2,
                                   tune="allreduce:@ring:inf")
            assert all(p is not None for p in p_f32)
            assert all(p is None for p in p_bf)
        finally:
            job.destroy()

    def test_counters_fold_into_the_endpoint(self, plan_jobs):
        job = plan_jobs(ut, 4, "y")
        tr = job.contexts[0].tl_contexts["shm"].obj.transport
        d0 = tr.n_direct + tr.n_eager + tr.n_rndv
        _, _, _, plans = run_ar(job, 4, "FLOAT32", 2048,
                                tune="allreduce:@ring:inf")
        assert plans[0] is not None and plans[0].n_rounds == 6
        assert plans[0].counters()["rounds"] >= 6
        assert tr.n_direct + tr.n_eager + tr.n_rndv > d0

    def test_cancel_withdraws_posted_recvs(self):
        job = GenJob(ut, 2, UCC_GEN_NATIVE="y")
        try:
            teams = job.team(2, "allreduce:@ring:inf")
            dst = torch.zeros(512)
            # only rank 0 posts: its plan parks a posted recv for good
            rq = teams[0].collective_init(ut.CollArgs(
                coll_type=ut.CollType.ALLREDUCE,
                src=ut.BufferInfo(torch.ones(512), 512, ut.DataType.FLOAT32),
                dst=ut.BufferInfo(dst, 512, ut.DataType.FLOAT32),
                op=ut.ReductionOp.SUM))
            rq.post()
            for _ in range(50):
                for c in job.contexts:
                    c.progress()
            task = rq.task
            assert task._plan is not None
            assert rq.test() == ut.Status.IN_PROGRESS
            plan = task._plan
            boxes = list(plan._peer_boxes)
            task.cancel(ut.Status.ERR_TIMED_OUT)
            assert rq.test() != ut.Status.IN_PROGRESS
            assert plan.counters()["withdrawn"] >= 1
            rq.finalize()
            # a dirty teardown pins the plan's buffers on the mailboxes
            assert any(box._pin_keep for box in boxes)
        finally:
            job.destroy()

    def test_plan_cache_is_count_exact(self, plan_jobs):
        job = plan_jobs(ut, 2, "y")
        tune = "allreduce:@ring:inf"
        run_ar(job, 2, "FLOAT32", 1024, tune=tune)
        run_ar(job, 2, "FLOAT32", 100, tune=tune)
        srcs, dsts, tasks, _ = run_ar(job, 2, "FLOAT32", 1024, seed=4,
                                      tune=tune)
        cache = tasks[0].tl_team.__dict__.get("_plan_cache") or {}
        by_count = {}
        for k, lst in cache.items():
            for p in lst:
                by_count.setdefault(k[2], []).append(p)
        assert {100, 1024} <= set(by_count)
        assert by_count[100][0] is not by_count[1024][0]
        np.testing.assert_allclose(dsts[0].numpy(), srcs[0] + srcs[1],
                                   rtol=1e-4, atol=1e-5)

    def test_interpreter_correct_across_count_shrink(self, plan_jobs):
        job = plan_jobs(ut, 4, "n")
        for count, seed in ((4096, 1), (129, 2), (2048, 3)):
            srcs, dsts, _, _ = run_ar(job, 4, "FLOAT32", count, seed=seed,
                                      tune="allreduce:@gen_rhd_r4:inf")
            want = np.stack(srcs).sum(0)
            for d in dsts:
                np.testing.assert_allclose(d.numpy(), want, rtol=1e-4,
                                           atol=1e-4)


# ---------------------------------------------------------------------------
# provenance, the knob's rule, the fence probe, lease lifetime
# ---------------------------------------------------------------------------

class TestPlanProvenance:
    def test_score_dump_marks_plan_candidates(self, plan_jobs):
        info = "\n".join(plan_jobs(ut, 2, "y").info(2))
        assert "shm/ring:44 (default+plan)" in info
        assert "shm/sra_knomial:45 (default+plan)" in info
        assert "+plan gen:ring(chunks=1)" in info

    def test_gen_native_n_disables_plans(self, plan_jobs):
        from ucc_tpu_torch.tl.host.ring import AllreduceRing
        _, _, tasks, plans = run_ar(plan_jobs(ut, 2, "n"), 2, "FLOAT32",
                                    512, tune="allreduce:@ring:inf")
        assert all(p is None for p in plans)
        assert all(isinstance(t, AllreduceRing) for t in tasks)


class TestGenNativeRule:
    """UCC_GEN_NATIVE=y requires the plan; auto falls back."""

    def _init(self, job, n, tune):
        teams = job.team(n, tune)
        return [t.collective_init(ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE,
            src=ut.BufferInfo(torch.ones(256), 256, ut.DataType.FLOAT32),
            dst=ut.BufferInfo(torch.zeros(256), 256, ut.DataType.FLOAT32),
            op=ut.ReductionOp.SUM)) for t in teams]

    @pytest.mark.parametrize("tune", ["allreduce:@ring:inf",
                                      "allreduce:@gen_ring_c2:inf"])
    def test_a_plan_that_cannot_be_built(self, monkeypatch, tune):
        def refuse(*a, **k):
            raise plan_mod.PlanError("refused for the test")
        monkeypatch.setattr(plan_mod.NativePlan, "__init__", refuse)
        job = GenJob(ut, 2, UCC_GEN_NATIVE="y")
        try:
            with pytest.raises(UccError) as ei:
                self._init(job, 2, tune)
            assert ei.value.status == Status.ERR_NO_RESOURCE
        finally:
            job.destroy()
        job = GenJob(ut, 2, UCC_GEN_NATIVE="auto")
        try:
            reqs = self._init(job, 2, tune)
            assert all(rq.task.__dict__.get("_plan") is None for rq in reqs)
            for rq in reqs:
                rq.post()
            job.until(lambda: all([rq.test() != ut.Status.IN_PROGRESS
                                   for rq in reqs]))
            assert [rq.test() for rq in reqs] == [ut.Status.OK] * 2
            assert torch.equal(reqs[0].args.dst.buffer, torch.full((256,),
                                                                   2.0))
            for rq in reqs:
                rq.finalize()
        finally:
            job.destroy()

    def test_a_core_that_cannot_load(self, monkeypatch):
        job = GenJob(ut, 2, UCC_GEN_NATIVE="y")
        try:
            job.team(2, "allreduce:@ring:inf")
            monkeypatch.setattr(native, "available", lambda: False)
            with pytest.raises(UccError) as ei:
                self._init(job, 2, "allreduce:@ring:inf")
            assert ei.value.status == Status.ERR_NO_RESOURCE
        finally:
            monkeypatch.undo()
            job.destroy()


def test_stale_fence_probe_unfenced_team(plan_jobs):
    job = plan_jobs(ut, 2, "y")
    tr = job.contexts[0].tl_contexts["shm"].obj.transport
    assert plan_mod.stale_fence_probe(tr, "never-fenced-team") is False
    assert plan_mod.stale_fence_probe(object(), "t") is None


def test_team_destroy_releases_plan_leases():
    from ucc_tpu_torch.mc.pool import host_pool
    job = GenJob(ut, 2, UCC_GEN_NATIVE="y")
    try:
        _, _, tasks, plans = run_ar(job, 2, "FLOAT32", 2048,
                                    tune="allreduce:@ring:inf")
        assert plans[0] is not None
        tl_team = tasks[0].tl_team
        assert tl_team.__dict__.get("_plan_cache")
        leased = host_pool().stats()["leased"]
        assert leased > 0
        for teams in job.teams.values():
            for t in teams:
                t.destroy()
        job.teams = {}
        assert host_pool().stats()["leased"] < leased
        assert not tl_team.__dict__.get("_plan_cache")
    finally:
        job.destroy()


# ---------------------------------------------------------------------------
# the other bindings of this slice: the MPMC queue and the arena windows
# (tests/test_native.py's MPMC cases)
# ---------------------------------------------------------------------------

class TestNativeMpmc:
    def test_fifo_and_bounds(self):
        q = native.NativeMpmcQueue(4)
        for i in range(4):
            assert q.push(i)
        assert not q.push(99)
        assert [q.pop() for _ in range(4)] == [0, 1, 2, 3]
        assert q.pop() is None
        q.destroy()
        q.destroy()

    def test_threaded(self):
        import threading
        q = native.NativeMpmcQueue(1024)
        got = []
        lock = threading.Lock()

        def producer(base):
            for i in range(100):
                while not q.push(base + i):
                    pass

        def consumer():
            for _ in range(100):
                v = None
                while v is None:
                    v = q.pop()
                with lock:
                    got.append(v)
        ts = [threading.Thread(target=producer, args=(0,)),
              threading.Thread(target=producer, args=(1000,)),
              threading.Thread(target=consumer),
              threading.Thread(target=consumer)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert sorted(got) == list(range(100)) + list(range(1000, 1100))
        q.destroy()


def test_arena_windows(tmp_path):
    """Named windows persist per key, grow only by a new key, zero on
    creation, and carry release/acquire flag words."""
    import uuid
    arena = native.IpcArena(native.ARENA_PREFIX + "test-" +
                            uuid.uuid4().hex[:12], heap_bytes=16 << 20,
                            win_bytes=1 << 20)
    try:
        a = arena.window(("pool", "t", 0, 1, 0, 64), 128)
        assert a and arena.window(("pool", "t", 0, 1, 0, 64), 128) == a
        b = arena.window(("pool", "t", 0, 2, 0, 64), 128)
        assert b and b != a
        assert not arena.view(a, 128).any()
        arena.view(a + 64, 4)[:] = [1, 2, 3, 4]
        arena.store_release(a, 7)
        assert arena.load_acquire(a) == 7
        assert list(arena.view(a + 64, 4)) == [1, 2, 3, 4]
        assert arena.window(("pool", "t", 0, 3, 0, 0), 2 << 20) == 0
        ctr = arena.counters()
        assert ctr["windows"] == 2 and ctr["window_bytes"] >= 256
    finally:
        arena.detach(unlink=True)
