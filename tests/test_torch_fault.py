"""Fault injection, cancellation, the watchdog's escalation, the runtime
fallback and the no-hang soak in the port, the counterpart of
tests/test_fault.py (all of its cases), plus cross-checks: the same
UCC_FAULT spec and seed give the JAX package's sequence of decisions."""
import json
import time

import numpy as np
import pytest

from ucc_tpu_torch import (BufferInfo, CollArgs, CollArgsFlags, CollType,
                           DataType, ReductionOp, Status)
from ucc_tpu_torch.fault import inject
from ucc_tpu_torch.fault.soak import run_soak
from ucc_tpu_torch.obs import metrics, watchdog
from ucc_tpu_torch.schedule.progress import ProgressQueue
from ucc_tpu_torch.schedule.schedule import Schedule
from ucc_tpu_torch.schedule.task import CollTask

from torch_ft_jobs import FtJob


@pytest.fixture(autouse=True)
def _clean_fault(monkeypatch):
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    for k in ("UCC_TLS", "UCC_TL_SHM_TUNE", "UCC_FAULT"):
        monkeypatch.delenv(k, raising=False)
    inject.reset()
    yield
    inject.reset()


# ---------------------------------------------------------------------------
# spec parsing and decisions
# ---------------------------------------------------------------------------

class TestSpec:
    def test_disabled_by_default(self):
        assert not inject.ENABLED

    def test_parse_full(self):
        s = inject.parse_spec("drop=0.1,delay=0.2:0.005,error=0.3,"
                              "post_error=0.05,kill=2+5")
        assert s.drop == 0.1 and s.delay == 0.2 and s.delay_s == 0.005
        assert s.error == 0.3 and s.post_error == 0.05
        assert s.kill == {2, 5}
        assert s.active

    def test_parse_off(self):
        for spec in ("", "n", "off", "0"):
            assert not inject.parse_spec(spec).active

    def test_unknown_key_raises(self):
        with pytest.raises(ValueError):
            inject.parse_spec("dorp=0.1")

    def test_bad_probability_raises(self):
        with pytest.raises(ValueError):
            inject.parse_spec("drop=1.5")

    def test_configure_enables_and_reset_disables(self):
        inject.configure("drop=0.5", seed=1)
        assert inject.ENABLED
        inject.reset()
        assert not inject.ENABLED

    def test_determinism(self):
        inject.configure("drop=0.3,error=0.2", seed=42)
        a = [inject.send_action() for _ in range(200)]
        inject.configure("drop=0.3,error=0.2", seed=42)
        b = [inject.send_action() for _ in range(200)]
        assert a == b
        assert "drop" in a and "error" in a


def _decisions(mod, spec, seed, n=400):
    """One seeded run of every decision kind, interleaved as the
    transport and task boundaries call them, on the injector *mod*."""
    mod.configure(spec, seed)
    out = []
    payload = np.arange(64, dtype=np.float32)

    class _Task:
        flags_internal = False
        schedule = None

        def __init__(self, rank):
            ctx = type("C", (), {"rank": rank})()
            self.team = type("T", (), {"context": ctx, "core_team": None})()
            self.team.core_team = self.team
    for i in range(n):
        r = i % 4
        out.append(("send", r, mod.send_action(r)))
        out.append(("recv", r, mod.recv_action(r)))
        c = mod.corrupt_action(r)
        out.append(("corrupt", r, c))
        if c:
            bad, crc = mod.corrupt_send(payload)
            out.append(("flip", bytes(bad.tobytes()), crc))
        st = mod.post_inject(_Task(r))
        out.append(("post", r, None if st is None else int(st)))
    out.append(("counts", dict(mod.COUNTS)))
    mod.reset()
    return out


@pytest.mark.parametrize("spec,seed", [
    ("drop=0.1,delay=0.2:0.005,error=0.05,post_error=0.1", 7),
    ("drop=0.02,delay=0.5:0.001,delay_rank=2,error=0.1", 3),
    ("corrupt=0.3,error=0.05,kill=1", 11),
    ("corrupt=1.0,corrupt_rank=3,post_error=0.5", 0),
])
def test_decisions_match_jax_package(spec, seed):
    """The same spec and seed give the JAX package's sequence of drop,
    delay, error, corrupt (with the flipped bytes) and post-error
    decisions."""
    from ucc_tpu.fault import inject as jax_inject
    try:
        assert _decisions(inject, spec, seed) == \
            _decisions(jax_inject, spec, seed)
    finally:
        jax_inject.reset()


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------

class _HangTask(CollTask):
    """Never completes on its own; counts cancel_fn calls."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.cancel_fn_calls = 0

    def post_fn(self):
        return Status.OK

    def progress_fn(self):
        pass

    def cancel_fn(self):
        self.cancel_fn_calls += 1


class TestCancel:
    def test_cancel_completes_with_status(self):
        t = _HangTask()
        t.post()
        assert t.super_status == Status.IN_PROGRESS
        t.cancel()
        assert t.super_status == Status.ERR_CANCELED
        assert t.cancel_fn_calls == 1

    def test_cancel_idempotent(self):
        t = _HangTask()
        t.post()
        t.cancel(Status.ERR_TIMED_OUT)
        t.cancel()
        assert t.super_status == Status.ERR_TIMED_OUT
        assert t.cancel_fn_calls == 1

    def test_cancel_after_complete_is_noop(self):
        t = _HangTask()
        t.post()
        t.complete(Status.OK)
        t.cancel()
        assert t.super_status == Status.OK
        assert t.cancel_fn_calls == 0

    def test_schedule_cancel_propagates_status_to_children(self):
        sched = Schedule()
        kids = [_HangTask(), _HangTask()]
        for k in kids:
            sched.add_task(k)
        sched.post()
        for k in kids:
            k.post()
        sched.cancel(Status.ERR_TIMED_OUT)
        assert sched.super_status == Status.ERR_TIMED_OUT
        for k in kids:
            assert k.super_status == Status.ERR_TIMED_OUT
            assert k.cancel_fn_calls == 1

    def test_progress_queue_timeout_cancels(self):
        q = ProgressQueue()
        t = _HangTask()
        t.timeout = 0.01
        t.progress_queue = q
        t.post()
        time.sleep(0.02)
        q.progress()
        assert t.super_status == Status.ERR_TIMED_OUT
        assert t.cancel_fn_calls == 1
        assert len(q) == 0

    def test_host_task_cancel_unwinds_posted_ops(self):
        """Cancelling rank 0's collective withdraws its posted recvs and
        closes the generator."""
        job = FtJob(2)
        try:
            teams = job.create_team()
            count = 8
            dst = np.zeros(count, np.float64)
            req = teams[0].collective_init(CollArgs(
                coll_type=CollType.ALLREDUCE,
                src=BufferInfo(np.ones(count), count, DataType.FLOAT64),
                dst=BufferInfo(dst, count, DataType.FLOAT64),
                op=ReductionOp.SUM))
            req.post()
            for _ in range(10):
                job.contexts[0].progress()
            assert req.test() == Status.IN_PROGRESS
            req.task.cancel()
            assert req.test() == Status.ERR_CANCELED
            req.finalize()
        finally:
            job.cleanup()


# ---------------------------------------------------------------------------
# watchdog escalation
# ---------------------------------------------------------------------------

class TestWatchdogEscalation:
    @pytest.fixture(autouse=True)
    def _wd(self, tmp_path):
        watchdog.reset()
        watchdog.configure(0.03, file=str(tmp_path / "wd.json"),
                           action="cancel", hard_timeout=0.06)
        yield
        watchdog.configure(0, action="dump")
        watchdog.reset()

    def test_bad_action_rejected(self):
        with pytest.raises(ValueError):
            watchdog.configure(1, action="explode")

    def test_cancel_at_hard_deadline(self):
        q = ProgressQueue()
        t = _HangTask()
        t.progress_queue = q
        t.post()
        deadline = time.monotonic() + 5
        while not t.is_completed():
            q.progress()
            watchdog._last_scan = 0.0   # defeat the 1 s scan throttle
            assert time.monotonic() < deadline, "escalation never fired"
            time.sleep(0.005)
        assert t.super_status == Status.ERR_TIMED_OUT
        assert t.cancel_fn_calls == 1

    def test_abort_cancels_all_in_flight(self):
        watchdog.configure(0.03, action="abort", hard_timeout=0.06)
        q = ProgressQueue()
        old = _HangTask()
        old.progress_queue = q
        old.post()
        time.sleep(0.08)
        fresh = _HangTask()          # not past the hard deadline
        fresh.progress_queue = q
        fresh.post()
        watchdog._last_scan = 0.0
        q.progress()
        assert old.super_status == Status.ERR_TIMED_OUT
        assert fresh.super_status == Status.ERR_TIMED_OUT

    def test_dump_action_never_cancels(self):
        watchdog.configure(0.02, action="dump")
        q = ProgressQueue()
        t = _HangTask()
        t.progress_queue = q
        t.post()
        time.sleep(0.08)
        watchdog._last_scan = 0.0
        q.progress()
        assert t.super_status == Status.IN_PROGRESS
        t.cancel()


# ---------------------------------------------------------------------------
# runtime score-map fallback
# ---------------------------------------------------------------------------

class TestRuntimeFallback:
    def test_precommit_failure_retries_next_candidate(self):
        """The winning algorithm fails before any send: the request moves
        to the next candidate and still sums correctly."""
        job = FtJob(4)
        try:
            teams = job.create_team()
            count = 16
            srcs = [np.full(count, r + 1.0, np.float64) for r in range(4)]
            dsts = [np.zeros(count, np.float64) for _ in range(4)]
            reqs = [teams[r].collective_init(CollArgs(
                coll_type=CollType.ALLREDUCE,
                src=BufferInfo(srcs[r], count, DataType.FLOAT64),
                dst=BufferInfo(dsts[r], count, DataType.FLOAT64),
                op=ReductionOp.SUM)) for r in range(4)]
            assert all(rq._fallback for rq in reqs)
            for rq in reqs:
                rq.task.post_fn = lambda: Status.ERR_NO_RESOURCE
            first_algs = [rq.task.alg_name for rq in reqs]
            for rq in reqs:
                rq.post()
            job.progress_until(lambda: all(
                [rq.test() != Status.IN_PROGRESS for rq in reqs]))
            for r, rq in enumerate(reqs):
                assert rq.test() == Status.OK, rq.test()
                assert rq._fb_used
                assert rq.task.alg_name != first_algs[r]
                np.testing.assert_allclose(dsts[r], 10.0)
        finally:
            job.cleanup()

    def _bare_request(self, t):
        from ucc_tpu_torch.core.coll import CollRequest
        req = CollRequest.__new__(CollRequest)
        req.task = t
        req._posted = True
        req._persistent = False
        req._fallback = (None, [object()])
        req._fb_used = False
        return req

    def test_committed_failure_does_not_retry(self):
        t = _HangTask()
        t.data_committed = True
        req = self._bare_request(t)
        t.post()
        t.complete(Status.ERR_NO_RESOURCE)
        assert not req._try_runtime_fallback()

    def test_timed_out_failure_does_not_retry(self):
        t = _HangTask()
        t.data_committed = False
        req = self._bare_request(t)
        t.post()
        t.complete(Status.ERR_TIMED_OUT)
        assert not req._try_runtime_fallback()


# ---------------------------------------------------------------------------
# no-hang invariant
# ---------------------------------------------------------------------------

class TestNoHangOnRankKill:
    def test_killed_rank_leaves_peers_terminal(self):
        """A rank killed mid-collective leaves every peer at a terminal
        status within the collective's deadline."""
        job = FtJob(3)
        try:
            teams = job.create_team()
            inject.configure(f"kill={job.contexts[2].rank}", seed=0)
            count = 8
            dsts = [np.zeros(count, np.float64) for _ in range(3)]
            reqs = [teams[r].collective_init(CollArgs(
                coll_type=CollType.ALLREDUCE,
                src=BufferInfo(np.ones(count), count, DataType.FLOAT64),
                dst=BufferInfo(dsts[r], count, DataType.FLOAT64),
                op=ReductionOp.SUM, flags=CollArgsFlags.TIMEOUT,
                timeout=0.5)) for r in range(3)]
            for rq in reqs:
                rq.post()
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                for c in job.contexts:
                    c.progress()
                if all(rq.test() != Status.IN_PROGRESS for rq in reqs):
                    break
            sts = [rq.test() for rq in reqs]
            assert all(s != Status.IN_PROGRESS for s in sts), sts
            assert all(s.is_error for s in sts), sts
            inject.reset()
            for rq in reqs:
                rq.finalize()
        finally:
            inject.reset()
            job.cleanup()


class TestSoak:
    def test_soak_no_hang_with_stats(self, tmp_path):
        """200 iterations of the collective matrix under drop, delay,
        error and post_error with no rank left IN_PROGRESS, and a
        metrics dump whose coll_cancelled and coll_fallback_runtime
        counters are nonzero."""
        stats_file = tmp_path / "soak_stats.json"
        metrics.reset()
        metrics.enable(file=str(stats_file))
        try:
            report = run_soak(
                n_ranks=4, iterations=200,
                spec="drop=0.01,delay=0.05:0.003,error=0.02,"
                     "post_error=0.01",
                seed=7, coll_timeout_s=0.4, iter_deadline_s=10.0)
            assert report["hangs"] == [], report["hangs"]
            assert report["iterations"] == 200
            for kind in ("drop", "delay", "error", "post_error"):
                assert report["injected"][kind] > 0, report["injected"]
            metrics.dump(str(stats_file), reason="soak")
        finally:
            metrics.disable()
        snap = json.loads(stats_file.read_text().strip().splitlines()[-1])
        counters = snap["counters"]
        assert sum(counters.get("coll_cancelled", {}).values()) > 0
        assert sum(counters.get("coll_fallback_runtime", {}).values()) > 0
        metrics.reset()

    def test_soak_deterministic(self):
        kw = dict(n_ranks=2, iterations=12, spec="drop=0.05,error=0.05",
                  seed=3, coll_timeout_s=0.3, iter_deadline_s=6.0)
        a = run_soak(**kw)
        b = run_soak(**kw)
        assert a["injected"] == b["injected"]
        assert a["outcomes"] == b["outcomes"]
        assert a["hangs"] == b["hangs"] == []


def test_soak_main_refuses_later_drills(capsys):
    """The name is historical: soak refused the churn drill until the
    telemetry collector was ported. ``--churn`` now runs it (one cycle)
    and prints a clean report; no drill is refused by name any more
    (``--collect`` beside it: tests/test_torch_collector.py)."""
    from ucc_tpu_torch.fault import soak
    assert soak.main(["--churn", "--cycles", "1", "--post-iters", "6"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["violations"] == [] and rep["cycles"] == 1
    assert rep["post_churn_ok"] == 6 and rep["readmitted"] is True
    assert "collector" not in rep
    assert not hasattr(soak, "_LATER_MODES")
    assert callable(soak.run_corrupt_soak)
    assert callable(soak.run_multi_tenant_soak)
