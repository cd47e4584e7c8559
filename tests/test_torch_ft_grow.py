"""Elastic membership in the port, the counterpart of
tests/test_ft_grow.py (less its collector-continuity and churn classes,
whose telemetry collector is not ported yet): Team.grow / Team.join, the
grow-side epoch fence, rollback when a joiner never arrives, the
fresh-heartbeat agreement race, re-admission of a falsely suspected
survivor; and a cross-check of a grow's epochs and results against the
JAX package."""
import numpy as np
import pytest

import ucc_tpu_torch as ut
from ucc_tpu_torch import RankFailedError, Status
from ucc_tpu_torch.core.team import Team
from ucc_tpu_torch.fault import health, inject
from ucc_tpu_torch.tl.host.transport import InProcTransport, Mailbox, RecvReq

from torch_ft_jobs import FtJob, ar_args, drive, grow_to_full


@pytest.fixture(autouse=True)
def _clean_ft(monkeypatch):
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    for k in ("UCC_TLS", "UCC_TL_SHM_TUNE", "UCC_FAULT",
              "UCC_FT_AGREE_GRACE"):
        monkeypatch.delenv(k, raising=False)
    inject.reset()
    health.reset()
    yield
    inject.reset()
    health.reset()


def _ft_on(interval=0.02, timeout=0.3):
    health.configure("shrink", interval=interval, timeout=timeout)


def _allreduce_all(job, teams, n):
    reqs = []
    for g, t in enumerate(teams):
        args, dst = ar_args(g)
        rq = t.collective_init(args)
        rq.post()
        reqs.append((rq, dst))
    assert drive(job.contexts, lambda: all(
        rq.test() != Status.IN_PROGRESS for rq, _ in reqs), 10)
    out = []
    for rq, dst in reqs:
        assert rq.test() == Status.OK, rq.test()
        out.append(dst.copy())
        rq.finalize()
    return out


class TestGrowBasic:
    def test_grow_admits_rank_and_retires_old_team(self):
        """Members grow_post and the joiner join_post converge on one
        epoch; the old team refuses new posts (naming the grow) and the
        grown team sums correctly with the joiner."""
        job = FtJob(4)
        try:
            teams = dict(enumerate(job.create_team(ranks=[0, 1, 2])))
            grows, jn = grow_to_full(job, teams, 3)
            for g in grows.values():
                assert g.test() == Status.OK, g.test()
            assert jn.test() == Status.OK
            epochs = {g.epoch for g in grows.values()} | {jn.epoch}
            assert epochs == {1}, epochs
            new_teams = [grows[r].new_team for r in sorted(grows)] \
                + [jn.new_team]
            for t in new_teams:
                assert t.size == 4 and t.epoch == 1
            with pytest.raises(RankFailedError, match="grow"):
                teams[0].collective_init(ar_args(0)[0])
            for dst in _allreduce_all(job, new_teams, 4):
                assert np.allclose(dst, sum(g + 1.0 for g in range(4)))
            for t in new_teams:
                t.destroy()
        finally:
            job.cleanup()

    def test_grow_validates_inputs(self):
        job = FtJob(3)
        try:
            teams = job.create_team()
            with pytest.raises(Exception):
                teams[0].grow_post([job.contexts[1].rank])
            with pytest.raises(Exception):
                teams[0].grow_post([])
        finally:
            job.cleanup()

    def test_grow_matches_jax_package(self):
        """The same grow (3 members admit context rank 3) in both
        packages: the same epochs, team sizes, joiner team rank and
        allreduce results."""
        def run(job_cls, team_cls, pkg):
            job = job_cls(4)
            try:
                teams = dict(enumerate(job.create_team(ranks=[0, 1, 2])))
                joiner = job.contexts[3].rank
                grows = {r: t.grow_post([joiner]) for r, t in teams.items()}
                jn = team_cls.join_post(job.contexts[3])
                assert drive(job.contexts, lambda: all(
                    [g.test() != pkg.Status.IN_PROGRESS
                     for g in grows.values()]
                    + [jn.test() != pkg.Status.IN_PROGRESS]), 20)
                new = [grows[r].new_team for r in sorted(grows)] \
                    + [jn.new_team]
                shape = ([g.test().name for g in grows.values()],
                         jn.test().name, [t.epoch for t in new],
                         [t.size for t in new], [t.rank for t in new])
                reqs = []
                for g, t in enumerate(new):
                    args, dst = ar_args(g, pkg=pkg)
                    rq = t.collective_init(args)
                    rq.post()
                    reqs.append((rq, dst))
                assert drive(job.contexts, lambda: all(
                    rq.test() != pkg.Status.IN_PROGRESS
                    for rq, _ in reqs), 10)
                res = [dst.tolist() for _, dst in reqs]
                for rq, _ in reqs:
                    rq.finalize()
                for t in new:
                    t.destroy()
                return shape, res
            finally:
                job.cleanup()
        import ucc_tpu
        from ucc_tpu.core.team import Team as JaxTeam
        from harness import UccJob
        assert run(FtJob, Team, ut) == run(UccJob, JaxTeam, ucc_tpu)


TEAM_KEY = (("unit",), "cl")


class TestGrowFence:
    def test_stale_pre_grow_send_cannot_match_post_grow_recv(self):
        mb = Mailbox()
        mb.fence(TEAM_KEY, 2)
        new_dst = np.zeros(8, np.uint8)
        new_recv = RecvReq(new_dst)
        mb.post_recv((TEAM_KEY, 2, 1, 0, 0), new_recv)
        sreq, kind = mb.send((TEAM_KEY, 1, 1, 0, 0),
                             np.full(8, 0xAB, np.uint8), 8192)
        assert kind == "fenced" and sreq.done
        assert not new_recv.done and not new_dst.any()
        sreq2, kind2 = mb.send((TEAM_KEY, 2, 1, 0, 0),
                               np.full(8, 0xCD, np.uint8), 8192)
        assert kind2 == "direct" and new_recv.done
        assert (new_dst == 0xCD).all()

    def test_grow_fences_old_tl_teams(self):
        """After Team.grow a late send keyed to the old team's tag space
        is discarded by the transport (n_fenced ticks), native matcher
        included."""
        job = FtJob(4)
        try:
            teams = dict(enumerate(job.create_team(ranks=[0, 1, 2])))
            grows, jn = grow_to_full(job, teams, 3)
            assert all(g.test() == Status.OK for g in grows.values())
            assert jn.test() == Status.OK
            probed = False
            for team_key, tr in teams[0]._tl_tag_spaces():
                if not isinstance(tr, InProcTransport):
                    continue
                before = tr.n_fenced
                key = (team_key, 0, (1 << 20) + 1, 999, 0)
                req = tr.send_nb(tr, key, np.ones(8, np.uint8))
                assert req.test()
                assert tr.n_fenced == before + 1
                probed = True
                break
            assert probed, "no loopback transport to probe"
            for t in [g.new_team for g in grows.values()] + [jn.new_team]:
                t.destroy()
        finally:
            job.cleanup()


class TestGrowRollback:
    def test_absent_joiner_times_out_and_old_team_survives(self):
        """A grow whose joiner never bootstraps fails ERR_TIMED_OUT
        naming it; the old team stays usable, and a retried grow with
        the joiner present succeeds."""
        job = FtJob(4)
        try:
            teams = dict(enumerate(job.create_team(ranks=[0, 1, 2])))
            joiner_ctx = job.contexts[3].rank
            grows = {r: t.grow_post([joiner_ctx], timeout_s=2.0)
                     for r, t in teams.items()}
            assert drive(job.contexts, lambda: all(
                [g.test() != Status.IN_PROGRESS
                 for g in grows.values()]), 20)
            for g in grows.values():
                assert g.test() == Status.ERR_TIMED_OUT, g.test()
                assert g.absent_joiners == [joiner_ctx]
                assert g.new_team is None
            assert not teams[0]._shrunk
            for dst in _allreduce_all(job, list(teams.values()), 3):
                assert np.allclose(dst, 1.0 + 2.0 + 3.0)
            grows2, jn = grow_to_full(job, teams, 3)
            sts = [g.test() for g in grows2.values()] + [jn.test()]
            assert all(s == Status.OK for s in sts), sts
            for t in [g.new_team for g in grows2.values()] \
                    + [jn.new_team]:
                t.destroy()
        finally:
            job.cleanup()


class TestAgreeRace:
    def _run_agreement(self, job, round_timeout_s):
        """Every rank enters agreement with an empty view while ctx rank
        1's sends are delayed past the round timeout."""
        from ucc_tpu_torch.fault.agree import FtAgreement
        teams = job.create_team()
        delayed_ctx = job.contexts[1].rank
        inject.configure(f"delay=1.0:0.6,delay_rank={delayed_ctx}",
                         seed=0)
        tasks = {}
        for r in range(len(teams)):
            t = FtAgreement(teams[r].service_team, set(), epoch=0,
                            round_timeout_s=round_timeout_s)
            t.progress_queue = job.contexts[r].progress_queue
            tasks[r] = t
            t.post()
        assert drive(job.contexts, lambda: all(
            t.is_completed() for t in tasks.values()), 20)
        return tasks

    def test_fresh_heartbeat_rank_survives_slow_agreement(self):
        """A live rank whose agreement messages are slower than the round
        timeout but whose heartbeat is fresh is not suspected."""
        _ft_on(interval=0.02, timeout=5.0)
        job = FtJob(3)
        try:
            tasks = self._run_agreement(job, round_timeout_s=0.25)
            views = {(frozenset(t.result_dead), t.result_epoch)
                     for t in tasks.values()}
            assert views == {(frozenset(), 1)}, views
        finally:
            job.cleanup()

    def test_grace_zero_documents_the_old_race(self, monkeypatch):
        """Control: with no freshness grace the same drill condemns the
        slow but live rank."""
        monkeypatch.setenv("UCC_FT_AGREE_GRACE", "0")
        _ft_on(interval=0.02, timeout=5.0)
        job = FtJob(3)
        try:
            tasks = self._run_agreement(job, round_timeout_s=0.25)
            dead_views = [t.result_dead for r, t in tasks.items()
                          if r != 1]
            assert any(1 in d for d in dead_views), dead_views
        finally:
            job.cleanup()


class TestRejoinAfterFalseExclusion:
    def test_falsely_excluded_live_rank_rejoins(self):
        """Survivors shrink a live rank out (a wrong hint); it tears its
        stale team down and re-enters through join: revived in every
        survivor's registry and summing correctly on the new epoch."""
        _ft_on()
        job = FtJob(4)
        try:
            teams = job.create_team()
            victim = 3
            victim_ctx = job.contexts[victim].rank
            shrinks = {r: teams[r].shrink_post(dead_hint=[victim])
                       for r in range(4) if r != victim}
            assert drive(job.contexts, lambda: all(
                [s.test() != Status.IN_PROGRESS
                 for s in shrinks.values()]), 20)
            for s in shrinks.values():
                assert s.test() == Status.OK, s.test()
            for r in shrinks:
                assert victim_ctx in job.contexts[r].health.dead_set()
            teams[victim].destroy()
            small = {r: shrinks[r].new_team for r in shrinks}
            grows, jn = grow_to_full(job, small, victim)
            assert all(g.test() == Status.OK for g in grows.values())
            assert jn.test() == Status.OK
            for r in shrinks:
                assert victim_ctx not in job.contexts[r].health.dead_set()
            new_teams = [grows[r].new_team for r in sorted(grows)] \
                + [jn.new_team]
            assert {t.epoch for t in new_teams} == {2}
            for dst in _allreduce_all(job, new_teams, 4):
                assert np.allclose(dst, sum(g + 1.0 for g in range(4)))
            for t in new_teams:
                t.destroy()
        finally:
            job.cleanup()
