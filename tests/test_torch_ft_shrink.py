"""Rank-failure recovery in the port (UCC_FT=shrink), the counterpart of
tests/test_ft_shrink.py: liveness detection and attribution, fail-fast
posts to dead ranks, fault-tolerant agreement, Team.shrink, epoch fences
and the half-created-team destroy; plus the cross-checks against the JAX
package (the kill-and-shrink drill's report, the agreement's views), the
device-memory case (a killed rank's rendezvous deposit never lands) and
the drills of tests/test_ipc.py and tests/test_plan.py."""
import json
import time

import numpy as np
import pytest
import torch

import ucc_tpu_torch as ut
from ucc_tpu_torch import RankFailedError, Status
from ucc_tpu_torch.fault import health, inject
from ucc_tpu_torch.obs import metrics
from ucc_tpu_torch.tl.host.transport import (Mailbox, RecvReq, SendReq,
                                             _PendingSend)

from torch_ft_jobs import LOAD, FtJob, ar_args, drive


@pytest.fixture(autouse=True)
def _clean_ft(monkeypatch):
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    for k in ("UCC_TLS", "UCC_TL_SHM_TUNE", "UCC_TL_TORCH_OPS_TUNE",
              "UCC_TL_RING_CUDA_TUNE", "UCC_FAULT"):
        monkeypatch.delenv(k, raising=False)
    inject.reset()
    health.reset()
    yield
    inject.reset()
    health.reset()


def _ft_on(interval=0.02, timeout=0.3):
    health.configure("shrink", interval=interval, timeout=timeout * LOAD)


# ---------------------------------------------------------------------------
# detection and attribution
# ---------------------------------------------------------------------------

class TestDetection:
    def test_default_mode_is_cold(self):
        assert health.MODE == "none"
        assert not health.ENABLED
        job = FtJob(2)
        try:
            assert job.contexts[0].health is None
        finally:
            job.cleanup()

    def test_heartbeat_detects_killed_rank(self):
        """A rank that stops beating (kill injection) is detected by
        every survivor, and the in-flight collectives that depend on it
        end ERR_RANK_FAILED naming it."""
        _ft_on()
        job = FtJob(3)
        try:
            teams = job.create_team()
            # posted BEFORE the kill: detection, not fail-fast, bounds it
            reqs = [t.collective_init(ar_args(i)[0]) for i, t in
                    enumerate(teams[:2])]
            killed_ctx = job.contexts[2].rank
            inject.configure(f"kill={killed_ctx}", seed=0)
            for rq in reqs:
                rq.post()
            assert drive(job.contexts, lambda: all(
                rq.test() != Status.IN_PROGRESS for rq in reqs), 10)
            for rq in reqs:
                assert rq.test() == Status.ERR_RANK_FAILED, rq.test()
                assert killed_ctx in (rq.failed_ranks or [])
            for r in (0, 1):
                reg = job.contexts[r].health
                assert reg is not None and reg.is_dead(killed_ctx)
                assert reg.dead[killed_ctx]["source"] in (
                    "heartbeat", "send", "inject")
            for rq in reqs:
                rq.finalize()
        finally:
            job.cleanup()

    def test_fail_fast_post_to_dead_rank(self):
        """A post that targets a known-dead rank fails fast with
        ERR_RANK_FAILED and attribution, and counts in
        rank_failures_detected, with UCC_FT off (the kill drill alone)."""
        metrics.reset()
        metrics.enable(file="/dev/null")
        job = FtJob(3)
        try:
            teams = job.create_team()
            killed_ctx = job.contexts[2].rank
            inject.configure(f"kill={killed_ctx}", seed=0)
            rq = teams[0].collective_init(ar_args(0)[0])
            t0 = time.monotonic()
            rq.post()
            assert drive(job.contexts, lambda:
                         rq.test() != Status.IN_PROGRESS, 5)
            assert time.monotonic() - t0 < 2.0
            assert rq.test() == Status.ERR_RANK_FAILED
            assert killed_ctx in (rq.failed_ranks or [])
            snap = metrics.snapshot()
            hits = snap.get("counters", {}).get("rank_failures_detected", {})
            assert hits and sum(hits.values()) >= 1
            rq.finalize()
        finally:
            metrics.disable()
            metrics.reset()
            job.cleanup()


# ---------------------------------------------------------------------------
# agreement
# ---------------------------------------------------------------------------

def _agree_views(pkg_job, teams, agree_cls, views):
    tasks = {}
    for r, local in views.items():
        t = agree_cls(teams[r].service_team, local, epoch=0,
                      round_timeout_s=8.0)
        t.progress_queue = pkg_job.contexts[r].progress_queue
        tasks[r] = t
        t.post()
    assert drive(pkg_job.contexts, lambda: all(
        t.is_completed() for t in tasks.values()), 15)
    return {r: (frozenset(t.result_dead), t.result_epoch)
            for r, t in tasks.items()}


class TestAgreement:
    def test_divergent_views_converge(self):
        """Survivors entering agreement with different views converge on
        the union and one epoch, as the JAX package's agreement does on
        the same views."""
        from ucc_tpu_torch.fault.agree import FtAgreement
        _ft_on(timeout=10.0)   # heartbeats effectively off: views stay split
        views = {0: {2}, 1: set(), 3: set()}
        job = FtJob(4)
        try:
            got = _agree_views(job, job.create_team(), FtAgreement, views)
        finally:
            job.cleanup()
        assert set(got.values()) == {(frozenset({2}), 1)}, got

        from ucc_tpu.fault import health as jhealth
        from ucc_tpu.fault.agree import FtAgreement as JaxAgreement
        from harness import UccJob
        jhealth.configure("shrink", interval=0.02, timeout=10.0 * LOAD)
        jjob = UccJob(4)
        try:
            want = _agree_views(jjob, jjob.create_team(), JaxAgreement,
                                views)
        finally:
            jjob.cleanup()
            jhealth.reset()
        assert got == want


# ---------------------------------------------------------------------------
# kill -> detect -> agree -> shrink -> resume
# ---------------------------------------------------------------------------

def _soak_summary(report):
    return (report["violations"], report["post_iters"],
            {r: (v["status"], tuple(v["ranks"]))
             for r, v in report["detected"].items()},
            {r: (v["status"], tuple(v["dead"] or ()), v["epoch"])
             for r, v in report["agreed"].items()},
            report["killed"])


class TestKillShrinkSoak:
    def test_kill_shrink_resume(self):
        """With UCC_FAULT=kill and UCC_FT=shrink a 4-rank matrix survives
        the kill: every survivor ends ERR_RANK_FAILED naming the dead
        rank, all agree on one (dead set, epoch), the shrink completes,
        and >= 50 checked collectives finish on the shrunk team."""
        from ucc_tpu_torch.fault.soak import run_kill_shrink_soak
        report = run_kill_shrink_soak(n_ranks=4, kill_rank=2,
                                      pre_iters=3, post_iters=54)
        assert report["violations"] == [], report
        assert report["post_iters"] >= 50
        views = {(tuple(v["dead"]), v["epoch"])
                 for v in report["agreed"].values()}
        assert len(views) == 1
        for v in report["detected"].values():
            assert v["status"] == "ERR_RANK_FAILED"
            assert report["killed"]["ctx_rank"] in v["ranks"]

    def test_soak_report_matches_jax_package(self):
        """The same drill in both packages: the same failed set, epoch,
        statuses, attribution and no hang."""
        from ucc_tpu.fault.soak import run_kill_shrink_soak as jax_soak
        from ucc_tpu_torch.fault.soak import run_kill_shrink_soak
        kw = dict(n_ranks=4, kill_rank=1, pre_iters=2, post_iters=12,
                  hb_timeout=0.3 * LOAD)
        mine = run_kill_shrink_soak(**kw)
        theirs = jax_soak(**kw)
        assert _soak_summary(mine) == _soak_summary(theirs)
        assert mine["violations"] == []

    def test_old_team_rejects_posts_after_shrink(self):
        _ft_on()
        job = FtJob(3)
        try:
            teams = job.create_team()
            killed_ctx = job.contexts[2].rank
            inject.configure(f"kill={killed_ctx}", seed=0)
            assert drive(job.contexts, lambda: all(
                job.contexts[r].health.is_dead(killed_ctx)
                for r in (0, 1)), 5 * LOAD)
            shrinks = {r: teams[r].shrink_post() for r in (0, 1)}
            assert drive(job.contexts, lambda: all(
                [s.test() != Status.IN_PROGRESS
                 for s in shrinks.values()]), 15)
            for s in shrinks.values():
                assert s.test() == Status.OK
                assert s.new_team.epoch == s.epoch
            with pytest.raises(RankFailedError):
                teams[0].collective_init(ar_args(0)[0])
            reqs = []
            for g, s in enumerate(shrinks.values()):
                args, dst = ar_args(g)
                rq = s.new_team.collective_init(args)
                rq.post()
                reqs.append((rq, dst))
            assert drive(job.contexts, lambda: all(
                rq.test() != Status.IN_PROGRESS for rq, _ in reqs), 10)
            for rq, dst in reqs:
                assert rq.test() == Status.OK
                assert np.allclose(dst, 1.0 + 2.0)
                rq.finalize()
            for s in shrinks.values():
                s.new_team.destroy()
        finally:
            job.cleanup()

    def test_kill_shrink_with_plans(self):
        """The drill with the allreduces on native execution plans (the
        counterpart of tests/test_plan.py::test_kill_shrink_with_plans):
        cancellation withdraws the plans' posted recvs and a pre-shrink
        plan send is fenced."""
        from ucc_tpu_torch.fault.soak import run_kill_shrink_soak
        report = run_kill_shrink_soak(n_ranks=4, kill_rank=2,
                                      pre_iters=2, post_iters=10,
                                      plans=True)
        assert report["violations"] == [], report
        assert report["plan_mode"] is True
        assert report["plan_recvs_withdrawn"] >= 1
        assert report["plan_stale_fenced"] is True


def test_procs_kill_shrink_drill(tmp_path):
    """One whole process SIGKILLed (the counterpart of
    tests/test_ipc.py::test_procs_kill_shrink_drill): the survivors in
    the other process detect it through the arena's pid board, agree,
    shrink and run a checked matrix on the shrunk team. The survivors'
    rank-failure dumps go to the parent's flight file, not to the
    working directory."""
    from ucc_tpu_torch import native
    if native.get_lib() is None:
        pytest.skip(f"native core unavailable: {native.build_error()}")
    from ucc_tpu_torch.fault.soak import run_procs_kill_shrink
    from ucc_tpu_torch.obs import flight
    old_file = flight._file
    path = tmp_path / "flight.json"
    flight.configure(file=str(path))
    try:
        report = run_procs_kill_shrink(n_procs=2, ranks_per=2, pre_iters=1,
                                       post_iters=6)
    finally:
        flight.configure(file=old_file)
    assert report["violations"] == [], report
    for r in (0, 1):
        rep = report["per_rank"][r]
        assert rep["detected"]["status"] == "ERR_RANK_FAILED"
        assert set(rep["detected"]["ranks"]) & {2, 3}
        assert set(rep["agreed"]["dead"]) >= {2, 3}
        assert rep["post"] == 6
    dumps = [json.loads(line) for line in path.read_text().splitlines()]
    assert {d.get("failed_rank") for d in dumps} & {2, 3}, dumps


@pytest.mark.parametrize("device", [None, "cpu"])
def test_procs_kill_shrink_across_survivor_processes(device):
    """Three processes, one killed: the survivors live in two processes,
    so the agreement crosses the arena while the first survivor to agree
    fences the old epoch (arena-wide). Host memory over tl/ipc, and CUDA
    memory (device ``cpu`` here) on a device team that spans the
    processes, each result bitwise the kernel's plain version."""
    from ucc_tpu_torch import native
    if native.get_lib() is None:
        pytest.skip(f"native core unavailable: {native.build_error()}")
    from ucc_tpu_torch.fault.soak import run_procs_kill_shrink
    kw = dict(count=4096, device=device) if device else {}
    report = run_procs_kill_shrink(n_procs=3, ranks_per=2, pre_iters=1,
                                   post_iters=2, **kw)
    assert report["violations"] == [], report
    views = {(tuple(rep["agreed"]["dead"]), rep["agreed"]["epoch"])
             for rep in report["per_rank"].values()}
    assert views == {((4, 5), 1)}
    for rep in report["per_rank"].values():
        assert rep["detected"]["status"] == "ERR_RANK_FAILED"
        if device:
            assert rep["bitwise"] == 3 and set(rep["algs"]) == {"ring_cuda"}
    if device:
        # one count per surviving process; CPU tensors launch nothing
        assert report["proc_launches"] == {
            p: {"ring_allreduce_pass": 0, "ring_allreduce_chunked": 0}
            for p in (0, 1)}
        assert report["launches"] == {"ring_allreduce_pass": 0,
                                      "ring_allreduce_chunked": 0}


# ---------------------------------------------------------------------------
# device memory: a killed rank's deposit never lands
# ---------------------------------------------------------------------------

def test_device_team_kill_shrink():
    """An in-process CUDA-memory team (device ``cpu`` here) whose killed
    rank never deposits: the survivors' allreduce ends ERR_RANK_FAILED
    naming it, their deposits are withdrawn from the old rendezvous, and
    the shrunk team meets in a new one and sums correctly."""
    _ft_on()
    n, count, victim = 4, 64, 3
    job = FtJob(n)
    try:
        teams = job.create_team()
        g = np.random.default_rng(5)
        srcs = [torch.from_numpy(g.standard_normal(count).astype(np.float32))
                for _ in range(n)]
        dsts = [torch.zeros(count) for _ in range(n)]

        def args(r, src, dst):
            return ut.CollArgs(
                coll_type=ut.CollType.ALLREDUCE,
                src=ut.BufferInfo(src, count, ut.DataType.FLOAT32,
                                  mem_type=ut.MemoryType.CUDA),
                dst=ut.BufferInfo(dst, count, ut.DataType.FLOAT32,
                                  mem_type=ut.MemoryType.CUDA),
                op=ut.ReductionOp.SUM)
        survivors = [r for r in range(n) if r != victim]
        killed_ctx = job.contexts[victim].rank
        inject.configure(f"kill={killed_ctx}", seed=0)
        reqs = {r: teams[r].collective_init(args(r, srcs[r], dsts[r]))
                for r in survivors}
        for rq in reqs.values():
            rq.post()
        dev = [t for t in reqs[0].task.team.core_team.cl_teams]
        assert dev
        assert drive(job.contexts, lambda: all(
            rq.test() != Status.IN_PROGRESS for rq in reqs.values()),
            10 * LOAD)
        shared = reqs[0].task.tl_team.shared
        for rq in reqs.values():
            assert rq.test() == Status.ERR_RANK_FAILED, rq.test()
            assert killed_ctx in rq.failed_ranks
        assert not shared.pending, shared.pending
        for rq in reqs.values():
            rq.finalize()
        shrinks = {r: teams[r].shrink_post() for r in survivors}
        assert drive(job.contexts, lambda: all(
            [s.test() != Status.IN_PROGRESS for s in shrinks.values()]), 20)
        assert [s.test() for s in shrinks.values()] == [Status.OK] * 3
        assert {s.epoch for s in shrinks.values()} == {1}
        new = [shrinks[r].new_team for r in survivors]
        nsrc = [srcs[r].clone() for r in survivors]
        ndst = [torch.zeros(count) for _ in survivors]
        reqs2 = [t.collective_init(args(i, nsrc[i], ndst[i]))
                 for i, t in enumerate(new)]
        for rq in reqs2:
            rq.post()
        assert drive(job.contexts, lambda: all(
            rq.test() != Status.IN_PROGRESS for rq in reqs2), 10)
        assert reqs2[0].task.tl_team.shared is not shared
        want = torch.stack(nsrc).sum(0)
        for rq, d in zip(reqs2, ndst):
            assert rq.test() == Status.OK
            assert torch.equal(d, want)
            rq.finalize()
        for t in new:
            t.destroy()
    finally:
        job.cleanup()


# ---------------------------------------------------------------------------
# epoch fences
# ---------------------------------------------------------------------------

TEAM_KEY = (("unit",), "cl")


class TestEpochFence:
    def test_fence_purges_parked_stale_state(self):
        """Fencing an epoch completes parked senders, fails stale posted
        recvs and discards late stale arrivals, so a parked pre-shrink
        rendezvous send can no longer alias a buffer the pool reissues."""
        mb = Mailbox()
        old_key = (TEAM_KEY, 0, 7, 0, 1)
        lease_buf = np.arange(64, dtype=np.uint8)
        ps = _PendingSend(lease_buf, SendReq(), copied=False)
        mb.push(old_key, ps)
        stale_dst = np.zeros(64, np.uint8)
        stale_recv = RecvReq(stale_dst)
        mb.post_recv((TEAM_KEY, 0, 8, 0, 1), stale_recv)
        purged = mb.fence(TEAM_KEY, 1)
        assert purged == 2
        assert not mb.unexpected and not mb.posted
        assert ps.req.done
        assert stale_recv.done and "fenced" in stale_recv.error

    def test_stale_send_cannot_match_post_shrink_recv(self):
        mb = Mailbox()
        mb.fence(TEAM_KEY, 1)
        new_dst = np.zeros(8, np.uint8)
        new_recv = RecvReq(new_dst)
        mb.post_recv((TEAM_KEY, 1, 1, 0, 0), new_recv)
        sreq, kind = mb.send((TEAM_KEY, 0, 1, 0, 0),
                             np.full(8, 0xAB, np.uint8), 8192)
        assert kind == "fenced" and sreq.done
        assert not new_recv.done
        assert not new_dst.any()
        sreq2, kind2 = mb.send((TEAM_KEY, 1, 1, 0, 0),
                               np.full(8, 0xCD, np.uint8), 8192)
        assert kind2 == "direct" and new_recv.done
        assert (new_dst == 0xCD).all()
        late = RecvReq(np.zeros(4, np.uint8))
        mb.post_recv((TEAM_KEY, 0, 2, 0, 0), late)
        assert late.done and "fenced" in late.error

    def test_shrink_fences_old_tl_teams(self):
        """After Team.shrink a late message keyed to the old team's tag
        space is discarded by the survivor's transport, not delivered."""
        _ft_on()
        job = FtJob(3)
        try:
            teams = job.create_team()
            old_tl_keys = {r: teams[r]._tl_tag_spaces() for r in (0, 1)}
            assert all(old_tl_keys.values())
            killed_ctx = job.contexts[2].rank
            inject.configure(f"kill={killed_ctx}", seed=0)
            assert drive(job.contexts, lambda: all(
                job.contexts[r].health.is_dead(killed_ctx)
                for r in (0, 1)), 5 * LOAD)
            shrinks = {r: teams[r].shrink_post() for r in (0, 1)}
            assert drive(job.contexts, lambda: all(
                [s.test() != Status.IN_PROGRESS
                 for s in shrinks.values()]), 15)
            assert all(s.test() == Status.OK for s in shrinks.values())
            tr1 = job.contexts[1].tl_contexts["shm"].obj.transport
            tk = old_tl_keys[1][0][0]
            tr0 = job.contexts[0].tl_contexts["shm"].obj
            req = tr0.send_to(job.contexts[1].rank,
                              (tk, teams[1].epoch, 999, 0,
                               job.contexts[0].rank),
                              np.ones(8, np.float64))
            assert req.test()                    # discarded, not parked
            assert tr1.mailbox.fences or tr1.native is not None
            assert not any(k[0] == tk for k in tr1.mailbox.unexpected)
            for s in shrinks.values():
                s.new_team.destroy()
        finally:
            job.cleanup()


# ---------------------------------------------------------------------------
# half-created team destroy
# ---------------------------------------------------------------------------

class TestHalfCreatedTeamDestroy:
    def test_destroy_after_mid_cl_create_failure(self, monkeypatch):
        """Team.fail()/destroy() on a team stuck in CL_CREATE tears down
        the service team and the half-created CL team without raising,
        even when a component's own destroy raises."""
        from ucc_tpu_torch.cl.basic import ClBasicTeam
        from ucc_tpu_torch.core.team import TeamState

        monkeypatch.setattr(ClBasicTeam, "create_test",
                            lambda self: Status.IN_PROGRESS)
        destroyed = []
        orig_destroy = ClBasicTeam.destroy

        def raising_destroy(self):
            destroyed.append(self)
            orig_destroy(self)
            raise RuntimeError("component destroy bug")

        monkeypatch.setattr(ClBasicTeam, "destroy", raising_destroy)
        job = FtJob(2)
        try:
            world = ut.ThreadOobWorld(2)
            teams = [job.contexts[r].create_team_post(
                ut.TeamParams(oob=world.endpoint(r))) for r in range(2)]
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                [t.create_test() for t in teams]
                for c in job.contexts:
                    c.progress()
                if all(t.state == TeamState.CL_CREATE for t in teams):
                    break
            assert all(t.state == TeamState.CL_CREATE for t in teams)
            for t in teams:
                t.fail(Status.ERR_TIMED_OUT, "test escalation")
                assert t.create_test() == Status.ERR_TIMED_OUT
            for t in teams:
                t.destroy()
                t.destroy()
            assert destroyed
        finally:
            job.cleanup()
