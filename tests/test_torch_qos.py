"""The multi-tenant service in the port against the JAX package: the
priority-lane progress queue (``schedule/progress.py``'s QoS half), the
small-collective coalescer (``core/coalesce.py``) with its fused DSL
backend (``dsl/fused.py``), perftest ``--storm`` and soak ``--multi``.

Queue-level cases drive a bare ProgressQueue of each package with the
same counter tasks owned by fake teams and compare what they serve.
Harness-level cases run in-process jobs with UCC_COALESCE on and hold
the fused batches bitwise against the unfused posts and against the JAX
package's fused result on the same inputs, on both matchers. Inputs are
integer-valued (made with numpy from a seed where random), so every
reduction order is exact.
"""
import json
import time

import numpy as np
import pytest
import torch

import ucc_tpu
import ucc_tpu_torch as ut
from ucc_tpu.core import coalesce as jcoal
from ucc_tpu.schedule import progress as jpg
from ucc_tpu_torch.core import coalesce as tcoal
from ucc_tpu_torch.dsl import fused as tfused
from ucc_tpu_torch.ec.cpu import f32_to_bf16, storage_dtype
from ucc_tpu_torch.schedule import progress as tpg

from harness import UccJob
from torch_ft_jobs import LOAD, FtJob

PGS = {"port": tpg, "jax": jpg}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    for k in ("UCC_TEAM_PRIORITY", "UCC_TL_SHM_TUNE", "UCC_GEN_NATIVE",
              "UCC_TL_SHM_NATIVE"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def qos_knobs():
    """Restore both packages' QoS and coalescing knobs."""
    saved = [(m, m._WEIGHTS, m._AGE_S) for m in (tpg, jpg)]
    csaved = [(c, (c.ENABLED, c.LIMIT_BYTES, c.WINDOW_S, c.MAX_BATCH))
              for c in (tcoal, jcoal)]
    yield
    for m, w, a in saved:
        m._WEIGHTS, m._AGE_S = w, a
    for c, v in csaved:
        c.ENABLED, c.LIMIT_BYTES, c.WINDOW_S, c.MAX_BATCH = v


# ---------------------------------------------------------------------------
# priority lanes: a bare queue of each package, the same tasks
# ---------------------------------------------------------------------------

class _FakeTeam:
    def __init__(self, priority, tid=7):
        self.priority = priority
        self.id = tid
        self.context = None


def _lane_task(pg, priority, trace=None, n_steps=1, name=""):
    """A counter task of *pg*'s CollTask: completes after n_steps."""
    class LaneTask(pg.CollTask):
        def post_fn(self):
            return pg.Status.OK

        def progress_fn(self):
            self.steps += 1
            self.trace.append(self.name)
            if self.steps >= self.n_steps:
                self.status = pg.Status.OK

    t = LaneTask(team=_FakeTeam(priority))
    t.trace = trace if trace is not None else []
    t.n_steps = n_steps
    t.name = name
    t.steps = 0
    return t


def _enqueue(pg, pq, *tasks):
    for t in tasks:
        t.status = t.super_status = pg.Status.IN_PROGRESS
        t.steps = 0
        pq._lanes[pg._task_lane(t)].append(t)
        t._pq_enq = t._pq_last = time.monotonic()
        t._pq_low_snap = sum(pq._svc_count[:pg._task_lane(t)])
        t.progress_queue = pq


def _both(fn):
    """Run a scenario on both packages' queues; {pkg: result}."""
    return {k: fn(pg) for k, pg in PGS.items()}


def test_high_lane_served_first_and_bulk_capped(qos_knobs):
    def run(pg):
        pg.configure(weights="1,2,4,8", age_ms=10_000)
        pq = pg.ProgressQueue()
        trace = []
        bulk = [_lane_task(pg, 0, trace, 99, f"b{i}") for i in range(4)]
        hot = _lane_task(pg, 3, trace, 99, "hot")
        _enqueue(pg, pq, *bulk, hot)
        pq.progress()
        return trace
    got = _both(run)
    # latency lane first; bulk lane capped to weight 1 while a higher
    # lane is non-empty
    assert got["port"][0] == "hot"
    assert sum(1 for n in got["port"] if n.startswith("b")) == 1
    assert got["port"] == got["jax"]


def test_single_lane_drains_uncapped(qos_knobs):
    def run(pg):
        pg.configure(weights="1,2,4,8", age_ms=10_000)
        pq = pg.ProgressQueue()
        trace = []
        _enqueue(pg, pq, *[_lane_task(pg, 1, trace, 99, f"t{i}")
                           for i in range(8)])
        pq.progress()
        return trace
    got = _both(run)
    # no higher lane occupied: the WRR cap never engages
    assert len(got["port"]) == 8
    assert got["port"] == got["jax"]


def test_starved_task_ages_into_service(qos_knobs):
    # a bulk task beyond the WRR cap is serviced once it waits past the
    # aging bound, even under a saturating latency-lane stream
    def run(pg):
        pg.configure(weights="1,2,4,8", age_ms=5)
        pq = pg.ProgressQueue()
        hot = _lane_task(pg, 3, n_steps=10**9, name="hot")
        bulk = [_lane_task(pg, 0, n_steps=10**9, name=f"b{i}")
                for i in range(3)]
        _enqueue(pg, pq, hot, *bulk)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and \
                not all(b.steps > 0 for b in bulk):
            pq.progress()
            time.sleep(0.002)
        served = all(b.steps > 0 for b in bulk)
        measured = pq.starvation_max_s > 0.0
        snap = pq.qos_snapshot()
        return served, measured, snap["starvation_max_ms"] > 0.0, \
            pq.starvation_max_s == 0.0
    got = _both(run)
    assert got["port"] == (True, True, True, True), \
        "bulk tasks starved behind the latency lane"
    assert got["port"] == got["jax"]


def test_priority_inversion_counter(qos_knobs):
    def run(pg):
        pg.configure(weights="1,2,4,8", age_ms=1)
        pq = pg.ProgressQueue()
        hot = _lane_task(pg, 2, n_steps=1, name="hot")
        _enqueue(pg, pq, hot)
        # lower-lane services advance after hot's enqueue snapshot while
        # hot waits past the aging bound
        pq._svc_count[0] += 5
        hot._pq_enq -= 0.05
        pq.progress()
        return pq.inversions, pq.qos_snapshot()["inversions"]
    got = _both(run)
    assert got["port"] == (1, 1)
    assert got["port"] == got["jax"]


def test_flat_q_compat_surface(qos_knobs):
    # watchdog dumps and the FT cancel sweeps walk queue._q
    def run(pg):
        pq = pg.ProgressQueue()
        b = _lane_task(pg, 0, n_steps=99, name="b")
        h = _lane_task(pg, 3, n_steps=99, name="h")
        _enqueue(pg, pq, b, h)
        return [t.name for t in pq._q], len(pq), \
            pq.higher_busy(0), pq.higher_busy(3)
    got = _both(run)
    assert got["port"] == (["h", "b"], 2, True, False)  # highest first
    assert got["port"] == got["jax"]


def test_qos_snapshot_team_wait(qos_knobs):
    def run(pg):
        pg.configure(weights="1,2,4,8", age_ms=10_000)
        pq = pg.ProgressQueue()
        t = _lane_task(pg, 1, n_steps=2, name="t")
        t.team.id = 42
        _enqueue(pg, pq, t)
        t._pq_enq -= 0.010
        pq.progress()
        snap = pq.qos_snapshot()
        w = snap["team_wait_ms"][42]
        return (sorted(snap), w["n"], w["max"] >= 10.0,
                pq.qos_snapshot()["team_wait_ms"])
    got = _both(run)
    assert got["port"][1:] == (1, True, {})  # reset after the snapshot
    assert got["port"] == got["jax"]


def test_clamp_priority():
    for v in (-3, 99, "2", "bogus", None, 0, 3):
        assert tpg.clamp_priority(v) == jpg.clamp_priority(v)
    assert tpg.clamp_priority(-3) == 0
    assert tpg.clamp_priority(99) == tpg.NUM_LANES - 1
    assert tpg.clamp_priority("bogus") == tpg.DEFAULT_PRIORITY


# ---------------------------------------------------------------------------
# coalescing: in-process jobs of both packages
# ---------------------------------------------------------------------------

def _team_with_priority(job, pkg, priority):
    world = pkg.ThreadOobWorld(job.n)
    teams = [job.contexts[r].create_team_post(
        pkg.TeamParams(oob=world.endpoint(r), priority=priority))
        for r in range(job.n)]
    # create_test on EVERY member each pass (a list, no short-circuit)
    job.progress_until(lambda: all(
        [t.create_test() == pkg.Status.OK for t in teams]), 30)
    job.teams.append(teams)
    return teams


def _ar_args(pkg, src, dst, op=None, dt=None, inplace=False):
    op = op if op is not None else pkg.ReductionOp.SUM
    dt = dt if dt is not None else pkg.DataType.FLOAT32
    cnt = int(dst.numel() if isinstance(dst, torch.Tensor) else dst.size)
    flags = pkg.CollArgsFlags.IN_PLACE if inplace else \
        pkg.CollArgsFlags(0)
    return pkg.CollArgs(coll_type=pkg.CollType.ALLREDUCE,
                        src=None if inplace else pkg.BufferInfo(src, cnt, dt),
                        dst=pkg.BufferInfo(dst, cnt, dt), op=op, flags=flags)


def _wait_reqs(job, reqs, timeout=30.0):
    job.progress_until(lambda: all(
        [rq.test() != ut.Status.IN_PROGRESS for per in reqs for rq in per]),
        timeout)


def _coal_on(mod, window_us=5e4):
    mod.configure(enabled=True, limit=8192, window_us=window_us,
                  max_batch=16)


def test_team_priority_resolution(qos_knobs, monkeypatch):
    job = FtJob(2)
    try:
        teams = _team_with_priority(job, ut, 3)
        assert all(t.priority == 3 for t in teams)
        monkeypatch.setenv("UCC_TEAM_PRIORITY", "2")
        teams2 = job.create_team()
        assert all(t.priority == 2 for t in teams2)
    finally:
        job.cleanup()


#: (op, dtype name, inplace): the reference's bitwise cases
_CASES = [("SUM", "FLOAT32", False), ("SUM", "FLOAT32", True),
          ("AVG", "FLOAT32", False), ("SUM", "BFLOAT16", False)]
_CNT = 16


def _payload_f32(r, k):
    return (np.arange(_CNT) % 5 + r + k).astype(np.float32)


def _run_cases(pkg, job, teams, enabled):
    """Post the reference's eight members (two per case) on every rank;
    returns each member's result as raw bytes (bf16 as its bits)."""
    dsts = []
    reqs = [[] for _ in teams]
    for ci, (op, dtn, inplace) in enumerate(_CASES):
        op = pkg.ReductionOp[op]
        dt = pkg.DataType[dtn]
        for j in range(2):
            k = 2 * ci + j
            per = []
            for r, t in enumerate(teams):
                vals = _payload_f32(r, k)
                if pkg is ut:
                    arr = f32_to_bf16(vals) if dtn == "BFLOAT16" \
                        else vals.copy()
                else:
                    from ucc_tpu.constants import dt_numpy
                    arr = vals.astype(dt_numpy(dt))
                if inplace:
                    dst = arr
                    args = _ar_args(pkg, None, dst, op, dt, inplace=True)
                else:
                    dst = np.zeros_like(arr)
                    args = _ar_args(pkg, arr, dst, op, dt)
                rq = t.collective_init(args)
                rq.post()
                reqs[r].append(rq)
                per.append(dst)
            dsts.append(per)
    if enabled:
        held = [len(t.coalescer.pending) for t in teams]
        assert all(h == 2 for h in held), held
    job.progress_until(lambda: all(
        [rq.test() != pkg.Status.IN_PROGRESS for per in reqs for rq in per]),
        30)
    for per in reqs:
        for rq in per:
            assert rq.test() == pkg.Status.OK
    if enabled:
        # cases 0+1 share a signature (one 4-member batch), AVG and bf16
        # sealed their own pair batches
        assert all(t.coalescer._fused_seq >= 3 for t in teams)
    return [[d.view(np.uint8).tobytes() for d in per] for per in dsts]


@pytest.mark.parametrize("matcher", ["native", "python"])
def test_coalesced_bitwise_vs_independent(qos_knobs, monkeypatch,
                                          matcher):
    """The reference's bitwise claim on each matcher: a coalesced batch
    delivers byte-identical results to the same collectives posted
    independently with coalescing off, and to the JAX package's fused
    result on the same inputs. Covers SUM, AVG, an in-place member and
    bf16; on the native matcher every fused carrier is a native plan
    (UCC_GEN_NATIVE=y) whose tag sits in the fused tag space."""
    if matcher == "native":
        monkeypatch.setenv("UCC_GEN_NATIVE", "y")
    else:
        monkeypatch.setenv("UCC_TL_SHM_NATIVE", "0")
    carriers = []
    real = tfused.fused_allreduce_task

    def spy(*a, **kw):
        c = real(*a, **kw)
        carriers.append((c, c is not None and c._plan is not None))
        return c
    monkeypatch.setattr(tfused, "fused_allreduce_task", spy)
    n = 4
    results = {}
    for enabled in (False, True):
        tcoal.configure(enabled=enabled, limit=8192, window_us=5e4,
                        max_batch=16)
        job = FtJob(n)
        try:
            teams = job.create_team()
            assert all((t.coalescer is not None) == enabled for t in teams)
            results[enabled] = _run_cases(ut, job, teams, enabled)
        finally:
            job.cleanup()
    assert results[True] == results[False]
    assert len(carriers) >= 3 * n and all(c is not None
                                          for c, _ in carriers)
    assert all(c.tag >= tfused.FUSED_TAG_BASE for c, _ in carriers)
    if matcher == "native":
        assert all(planned for _, planned in carriers)
    # the JAX package's fused result on the same inputs
    monkeypatch.delenv("UCC_GEN_NATIVE", raising=False)
    monkeypatch.delenv("UCC_TL_SHM_NATIVE", raising=False)
    _coal_on(jcoal)
    job = UccJob(n)
    try:
        ref = _run_cases(ucc_tpu, job, job.create_team(), True)
    finally:
        job.cleanup()
    assert results[True] == ref


@pytest.mark.parametrize("dtn", ["FLOAT32", "BFLOAT16"])
def test_cpu_tensor_members_are_bitwise_their_ndarray_twins(qos_knobs,
                                                             dtn):
    """A difference by design: the port's HOST memory takes CPU tensors,
    and a contiguous CPU tensor is eligible under the same rule as a
    C-contiguous ndarray. Packing and unpacking go through the tensor's
    storage (bf16 as uint16 bits), so its results are its twin's."""
    _coal_on(tcoal)
    n, cnt = 4, 24
    rng = np.random.default_rng(11)
    vals = [[rng.integers(-8, 8, cnt).astype(np.float32) for _ in range(n)]
            for _ in range(3)]
    dt = ut.DataType[dtn]
    tdt = torch.float32 if dtn == "FLOAT32" else torch.bfloat16
    out = {}
    for kind in ("tensor", "ndarray"):
        job = FtJob(n)
        try:
            teams = job.create_team()
            reqs = [[] for _ in range(n)]
            dsts = []
            for k in range(3):
                per = []
                for r, t in enumerate(teams):
                    if kind == "tensor":
                        src = torch.from_numpy(vals[k][r]).to(tdt)
                        dst = torch.zeros(cnt, dtype=tdt)
                    else:
                        src = vals[k][r].copy() if dtn == "FLOAT32" \
                            else f32_to_bf16(vals[k][r])
                        dst = np.zeros(cnt, storage_dtype(dt))
                    rq = t.collective_init(_ar_args(ut, src, dst, dt=dt))
                    assert rq._coalesce is not None
                    rq.post()
                    reqs[r].append(rq)
                    per.append(dst)
                dsts.append(per)
            assert all(len(t.coalescer.pending) == 3 for t in teams)
            _wait_reqs(job, reqs)
            assert all(rq.test() == ut.Status.OK
                       for per in reqs for rq in per)
            assert all(t.coalescer._fused_seq == 1 for t in teams)
            out[kind] = [[(d.view(torch.uint8).numpy() if kind == "tensor"
                           else d.view(np.uint8)).tobytes() for d in per]
                         for per in dsts]
        finally:
            job.cleanup()
    assert out["tensor"] == out["ndarray"]
    # and the values are the exact sums
    for k in range(3):
        want = np.sum(vals[k], axis=0).astype(np.float32)
        want = want.tobytes() if dtn == "FLOAT32" else \
            f32_to_bf16(want).tobytes()
        assert out["ndarray"][k][0] == want


def test_mixed_signature_seals_batch(qos_knobs):
    # a post with another (op, dtype) signature is a program-order
    # closure point: the open batch seals, both batches complete
    _coal_on(tcoal)
    n = 4
    job = FtJob(n)
    try:
        teams = job.create_team()
        cnt = 8
        dsts, reqs = [], [[] for _ in range(n)]
        for k, op in enumerate((ut.ReductionOp.SUM, ut.ReductionOp.SUM,
                                ut.ReductionOp.MAX)):
            per_d = []
            for r, t in enumerate(teams):
                src = (np.arange(cnt) + r + k).astype(np.float32)
                dst = np.zeros(cnt, dtype=np.float32)
                rq = t.collective_init(_ar_args(ut, src, dst, op))
                rq.post()
                reqs[r].append(rq)
                per_d.append(dst)
            dsts.append(per_d)
        # MAX arrived with another signature: the SUM batch sealed
        assert all(len(t.coalescer.pending) == 1 for t in teams)
        _wait_reqs(job, reqs)
        base = np.arange(cnt).astype(np.float32)
        for r in range(n):
            assert np.array_equal(dsts[0][r], sum(base + q for q in range(n)))
            assert np.array_equal(dsts[2][r], base + n - 1 + 2)
    finally:
        job.cleanup()


def test_cancel_one_of_batch(qos_knobs):
    # cancelling one held member is rank-local: its segment stays in the
    # sealed batch (membership symmetry), only its delivery is skipped
    _coal_on(tcoal)
    n = 4
    job = FtJob(n)
    try:
        teams = job.create_team()
        cnt = 8
        dsts, reqs = [], [[] for _ in range(n)]
        for k in range(3):
            per_d = []
            for r, t in enumerate(teams):
                src = (np.arange(cnt) + r + 10 * k).astype(np.float32)
                dst = np.full(cnt, -1.0, dtype=np.float32)
                rq = t.collective_init(_ar_args(ut, src, dst))
                rq.post()
                reqs[r].append(rq)
                per_d.append(dst)
            dsts.append(per_d)
        reqs[0][1].task.cancel()
        assert reqs[0][1].test() == ut.Status.ERR_CANCELED
        others = [[rq for i, rq in enumerate(per) if (r, i) != (0, 1)]
                  for r, per in enumerate(reqs)]
        _wait_reqs(job, others)
        base = np.arange(cnt).astype(np.float32)
        for k in (0, 1, 2):
            expect = sum(base + q + 10 * k for q in range(n))
            for r in range(n):
                if (r, k) == (0, 1):
                    assert np.all(dsts[k][r] == -1.0)
                    continue
                assert reqs[r][k].test() == ut.Status.OK
                # rank 0's contribution still participated
                assert np.array_equal(dsts[k][r], expect)
    finally:
        job.cleanup()


def test_destroy_mid_batch_aborts_members(qos_knobs):
    # team teardown with a held batch fails the members terminally
    _coal_on(tcoal, window_us=1e6)
    job = FtJob(2)
    try:
        teams = job.create_team()
        reqs = []
        for t in teams:
            rq = t.collective_init(_ar_args(
                ut, np.ones(8, np.float32), np.zeros(8, np.float32)))
            rq.post()
            reqs.append(rq)
        assert all(len(t.coalescer.pending) == 1 for t in teams)
        for t in teams:
            t.destroy()
        assert all(rq.task.super_status == ut.Status.ERR_CANCELED
                   for rq in reqs)
        assert all(t.coalescer not in (t.context._open_coalescers or ())
                   for t in teams)
    finally:
        job.cleanup()


def test_window_flush_without_test(qos_knobs):
    # quiescent-rank valve: nobody tests the requests; the window expiry
    # (driven from Context.progress) seals the same members on every rank
    _coal_on(tcoal, window_us=2e3)
    n = 4
    job = FtJob(n)
    try:
        teams = job.create_team()
        cnt = 8
        reqs, dsts = [], []
        for r, t in enumerate(teams):
            for k in range(2):
                src = (np.arange(cnt) + r + k).astype(np.float32)
                dst = np.zeros(cnt, dtype=np.float32)
                rq = t.collective_init(_ar_args(ut, src, dst))
                rq.post()
                reqs.append(rq)
                dsts.append((k, dst))
        deadline = time.monotonic() + 10.0
        while not all(rq.task.is_completed() for rq in reqs):
            for ctx in job.contexts:
                ctx.progress()
            assert time.monotonic() < deadline, "window never flushed"
        assert all(t.coalescer._fused_seq == 1 for t in teams)
        for k, dst in dsts:
            expect = sum(np.arange(cnt).astype(np.float32) + q + k
                         for q in range(n))
            assert np.array_equal(dst, expect)
    finally:
        job.cleanup()


def test_priority_post_flushes_bulk_window(qos_knobs):
    # the cross-team latency valve: a latency-class team's post seals
    # every open bulk batch in the context at once
    _coal_on(tcoal, window_us=1e6)
    job = FtJob(2)
    try:
        bulk = job.create_team()
        hot = _team_with_priority(job, ut, 3)
        assert all(t.coalescer is None for t in hot)
        held = []
        for t in bulk:
            rq = t.collective_init(_ar_args(
                ut, np.ones(8, np.float32), np.zeros(8, np.float32)))
            rq.post()
            held.append(rq)
        assert all(len(t.coalescer.pending) == 1 for t in bulk)
        hot_reqs = [t.collective_init(ut.CollArgs(
            coll_type=ut.CollType.BARRIER)) for t in hot]
        for rq in hot_reqs:
            rq.post()
        assert all(len(t.coalescer.pending) == 0 for t in bulk)
        _wait_reqs(job, [held + hot_reqs])
    finally:
        job.cleanup()


def test_disabled_dispatch_identical(qos_knobs):
    # UCC_COALESCE off (the default): no coalescer attached, no request
    # binding, and the candidate walk picks what it always picked, the
    # same algorithm the JAX package picks
    _coal_on(tcoal)
    job_on = FtJob(2)
    t_on = job_on.create_team()
    tcoal.configure(enabled=False)
    job_off = FtJob(2)
    try:
        t_off = job_off.create_team()
        assert all(t.coalescer is not None for t in t_on)
        assert all(t.coalescer is None for t in t_off)
        algs = {}
        for label, job, teams in (("on", job_on, t_on),
                                  ("off", job_off, t_off)):
            reqs = [t.collective_init(_ar_args(
                ut, np.ones(8, np.float32), np.zeros(8, np.float32)))
                for t in teams]
            algs[label] = [rq.task.alg_name for rq in reqs]
            cands = teams[0].score_map.lookup(
                ut.CollType.ALLREDUCE, ut.MemoryType.HOST, 32)
            algs[label + "_cands"] = [str(c.alg_name) for c in cands]
            assert all((rq._coalesce is None) == (label == "off")
                       for rq in reqs)
            for rq in reqs:
                rq.post()
            job.progress_until(lambda: all(
                [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]), 30)
        assert algs["on"] == algs["off"]
        assert algs["on_cands"] == algs["off_cands"]
        jcoal.configure(enabled=False)
        jjob = UccJob(2)
        try:
            jteams = jjob.create_team()
            jrq = jteams[0].collective_init(_ar_args(
                ucc_tpu, np.ones(8, np.float32), np.zeros(8, np.float32)))
            assert jrq.task.alg_name == algs["off"][0]
            jrq.task.cancel()
        finally:
            jjob.cleanup()
    finally:
        job_on.cleanup()
        job_off.cleanup()


def test_fused_program_choice_matches_the_jax_package():
    from ucc_tpu.dsl import fused as jfused
    assert tfused.FUSED_TAG_BASE == jfused.FUSED_TAG_BASE == 1 << 30
    for n, count in ((2, 1), (2, 2), (3, 2), (3, 3), (4, 16), (5, 4),
                     (5, 3), (8, 7), (8, 64)):
        tp = tfused.pick_program(n, count)
        jp = jfused.pick_program(n, count)
        assert (tp is None) == (jp is None), (n, count)
        if tp is not None:
            assert (tp.name, tp.nchunks) == (jp.name, jp.nchunks)


# ---------------------------------------------------------------------------
# the tools: perftest --storm and soak --multi against the JAX package
# ---------------------------------------------------------------------------

def _records(out):
    return [json.loads(ln) for ln in out.splitlines()
            if ln.startswith("{")]


def test_perftest_storm_emits_the_reference_records(qos_knobs, capsys):
    from ucc_tpu.tools import perftest as jperf
    from ucc_tpu_torch.tools import perftest as tperf
    argv = ["--teams", "3", "--storm", "--storm-burst", "4", "-n", "3",
            "-w", "1", "-p", "2", "--json"]
    rc_t = tperf.main(argv)
    port = _records(capsys.readouterr().out)
    rc_j = jperf.main(argv)
    ref = _records(capsys.readouterr().out)
    assert rc_t in (0, 1) and rc_j in (0, 1)
    assert [r["bench"] for r in port] == ["storm", "storm", "storm_summary"]
    assert [r["bench"] for r in port] == [r["bench"] for r in ref]
    for a, b in zip(port, ref):
        assert set(a) == set(b)
        if "classes" in a:
            assert set(a["classes"]) == set(b["classes"])
            for cls in a["classes"]:
                assert set(a["classes"][cls]) == set(b["classes"][cls])
                assert a["classes"][cls]["priority"] == \
                    b["classes"][cls]["priority"]
    qos = port[1]
    assert qos["mode"] == "qos" and qos["coalesce_fused_batches"] > 0
    assert set(qos["qos"]) == set(ref[1]["qos"])


def test_soak_multi_agrees_with_the_jax_package(qos_knobs):
    from ucc_tpu.fault import soak as jsoak
    from ucc_tpu_torch.fault import soak as tsoak
    # the reference's 0.3 s heartbeat timeout, scaled for loaded runs as
    # the port's fault-tolerance tests scale theirs
    kw = dict(n_ranks=4, n_teams=3, rounds=2, burst=3, post_rounds=2,
              kill_rank=2, hb_timeout=0.3 * LOAD)
    port = tsoak.run_multi_tenant_soak(**kw)
    ref = jsoak.run_multi_tenant_soak(**kw)
    assert port["violations"] == [] == ref["violations"]
    # same failed set, epochs and statuses; nothing left IN_PROGRESS
    assert port["killed"] == ref["killed"]
    assert port["shrunk_epochs"] == ref["shrunk_epochs"]
    assert port["grown_epochs"] == ref["grown_epochs"]
    assert port["detected"] == ref["detected"]
    assert sorted(port["outcomes"]) == sorted(ref["outcomes"])
    assert all(k.endswith(":OK") for k in port["outcomes"])
    assert port["post_rounds_ok"] == ref["post_rounds_ok"] == 2
    assert port["fused_batches"] > 0
