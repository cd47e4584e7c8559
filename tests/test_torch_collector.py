"""The continuous telemetry collector in the port (ucc_tpu_torch/obs/
collector.py) against the JAX package's (ucc_tpu/obs/collector.py).

Every case of tests/test_obs.py's TestRankBias, TestTraceStore and
TestCollectorPipeline runs here on the port, and where the outcome is
deterministic the JAX package runs the same inputs and the two agree:
RankBias's staged switch, ``reorder`` (by alg_name on the same candidate
lists), ``time_multiplier`` and ``slow_map`` compared exactly; the trace
store's rotation and reads on the same records; the closed loop (a
fault-delayed rank flagged within two windows, selection moved off the
ring family) on ndarrays and on CPU tensors, beside the JAX package's
loop on ndarrays. Then tests/test_ft_grow.py's TestObsContinuity and
TestChurn::test_mini_churn_cycle, held against the JAX package's
hand-off and ``run_churn_soak`` report; the core's hooks (the flagged
piggyback of the address exchange and cl/hier's leader demotion, the
bias-aware lookup and its switch index at dispatch, the tuner's weighted
medians); and the differences by design: the port's store records carry
its schema tag, and neither package's store is read as the other's.
"""
import json
import time

import numpy as np
import pytest
import torch

import ucc_tpu
import ucc_tpu_torch as ut
from ucc_tpu.obs import collector as jcol
from ucc_tpu_torch.obs import collector as pcol
from ucc_tpu_torch.obs import diagnose, flight

from torch_ft_jobs import LOAD, FtJob

KNOB_NAMES = ("enabled", "interval", "sample", "dir", "segment_bytes",
              "segments", "bias", "decay", "flag_on", "flag_off",
              "windows", "penalty", "slack", "slow_mult")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    for k in ("UCC_TLS", "UCC_TL_SHM_TUNE", "UCC_FAULT", "UCC_COLLECT",
              "UCC_TOPO_FAKE_PPN", "UCC_TOPO_FAKE_NODES_PER_POD"):
        monkeypatch.delenv(k, raising=False)
    flight.reset()
    prev = {m: {n: getattr(m.KNOBS, n) for n in KNOB_NAMES}
            for m in (pcol, jcol)}
    yield
    for m, knobs in prev.items():
        m.configure(**knobs)
    from ucc_tpu.fault import inject as jinject
    from ucc_tpu_torch.fault import inject
    inject.reset()
    jinject.reset()


# ---------------------------------------------------------------------------
# the config table and the knobs
# ---------------------------------------------------------------------------

def test_config_table_matches_the_reference():
    """The 14 fields of obs/collector, UCC_COLLECT through
    UCC_RANK_BIAS_SLOW_MULT: names, defaults and docs."""
    want = [(f.name, f.default, f.doc) for f in jcol._COLLECT_CONFIG.fields]
    got = [(f.name, f.default, f.doc) for f in pcol._COLLECT_CONFIG.fields]
    assert got == want and len(got) == 14
    assert pcol._COLLECT_CONFIG.name == jcol._COLLECT_CONFIG.name


@pytest.mark.parametrize("env", [
    {}, {"UCC_COLLECT": "y", "UCC_COLLECT_INTERVAL": "0.01",
         "UCC_COLLECT_SAMPLE": "0", "UCC_RANK_BIAS": "n",
         "UCC_RANK_BIAS_DECAY": "3", "UCC_RANK_BIAS_SLACK": "0",
         "UCC_RANK_BIAS_SLOW_MULT": "0.5", "UCC_COLLECT_DIR": ""},
    {"UCC_COLLECT": "maybe", "UCC_RANK_BIAS_WINDOWS": "5",
     "UCC_COLLECT_SEGMENT_BYTES": "10"}])
def test_knobs_resolve_as_the_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p, j = pcol._Knobs(), jcol._Knobs()
    assert {n: getattr(p, n) for n in KNOB_NAMES} == \
        {n: getattr(j, n) for n in KNOB_NAMES}
    assert p.enabled == (env.get("UCC_COLLECT") == "y")


def test_unknown_knob_rejected_in_both():
    for m in (pcol, jcol):
        with pytest.raises(AttributeError):
            m.configure(intervall=5)


# ---------------------------------------------------------------------------
# RankBias (tests/test_obs.py::TestRankBias)
# ---------------------------------------------------------------------------

class _Cand:
    def __init__(self, alg, score, gen=""):
        self.alg_name, self.score, self.gen = alg, score, gen


def _both():
    return (pcol.RankBias(penalty=4096, slow_mult=4.0),
            jcol.RankBias(penalty=4096, slow_mult=4.0))


def _state(b):
    return (b.flagged, dict(b.scores), b.window, b.first_flag_window,
            b._pending)


class TestRankBias:
    def test_staged_promotion_is_deterministic(self):
        for b in _both():
            b.publish({1}, {1: 0.9}, window=0, apply_at=10)
            assert b.flagged == frozenset()        # staged, not applied
            b.tick(9)
            assert b.flagged == frozenset()
            b.tick(10)
            assert b.flagged == frozenset({1})
            assert b.first_flag_window == 0

    def test_republish_same_set_keeps_apply_at(self):
        """Re-publishing the same flagged set every window must NOT push
        apply_at forward, or a team that posts fewer than `slack`
        collectives a window never reaches the switch."""
        states = []
        for b in _both():
            b.publish({1}, {1: 0.8}, window=0, apply_at=10)
            b.publish({1}, {1: 0.9}, window=1, apply_at=50)
            b.publish({1}, {1: 0.95}, window=2, apply_at=90)
            b.tick(10)
            assert b.flagged == frozenset({1})
            assert b.scores[1] == pytest.approx(0.95)
            assert b.window == 2
            states.append(_state(b))
        assert states[0] == states[1]

    def test_changed_set_restages(self):
        states = []
        for b in _both():
            b.publish({1}, {1: 0.9}, window=0, apply_at=10)
            b.tick(10)
            b.publish({1, 2}, {1: 0.9, 2: 0.8}, window=3, apply_at=20)
            assert b.flagged == frozenset({1})  # old table until switch
            b.tick(20)
            assert b.flagged == frozenset({1, 2})
            states.append(_state(b))
        assert states[0] == states[1]

    def test_scores_fold_in_place_when_set_unchanged(self):
        states = []
        for b in _both():
            b.publish({1}, {1: 0.9}, window=0, apply_at=5)
            b.tick(5)
            b.publish({1}, {1: 0.72}, window=4, apply_at=99)
            assert b._pending is None
            assert b.flagged == frozenset({1})
            assert b.scores[1] == pytest.approx(0.72)
            states.append(_state(b))
        assert states[0] == states[1]

    @pytest.mark.parametrize("flagged", [{2}, {0, 3}, set()])
    def test_reorder_demotes_ring_family_only(self, flagged):
        names = [("ring", 100), ("knomial", 90), ("sra_knomial", 80),
                 ("dbt", 10), ("sliding_window", 1), ("ring_cuda", 20),
                 ("xla", 40), ("short", 45), ("gen_ring_c2", 2),
                 ("gen_rhd_r2", 2)]
        orders = []
        for b in _both():
            b.publish(flagged, {r: 0.9 for r in flagged}, window=0,
                      apply_at=0)
            b.tick(0)
            cands = [_Cand(a, s) for a, s in names]
            orders.append([c.alg_name for c in b.reorder(cands)])
            if not flagged:
                assert b.reorder(cands) is cands
        assert orders[0] == orders[1]
        if flagged:
            ring = [a for a in orders[0] if pcol.is_ring_family(a)]
            assert orders[0][-len(ring):] == ring

    def test_user_forced_inf_outranks_feedback(self):
        from ucc_tpu.score.score import SCORE_MAX as J_MAX
        from ucc_tpu_torch.score.score import SCORE_MAX
        assert SCORE_MAX == J_MAX
        for b in _both():
            b.publish({0}, {0: 0.9}, window=0, apply_at=0)
            b.tick(0)
            out = b.reorder([_Cand("ring_cuda", SCORE_MAX),
                             _Cand("xla", 50)])
            assert [c.alg_name for c in out] == ["ring_cuda", "xla"]

    def test_time_multiplier_and_slow_map(self):
        out = []
        for b in _both():
            b.publish({1, 3}, {1: 0.9, 3: 0.8}, window=0, apply_at=0)
            b.tick(0)
            out.append(([b.time_multiplier(a, g) for a, g in (
                ("ring", ""), ("knomial", ""), ("gen_x", "ring(chunks=2)"),
                ("ring_cuda", ""), ("xla", ""))], b.slow_map(),
                b.describe()))
        assert out[0] == out[1]
        assert out[0][0][:2] == [pytest.approx(7.0), 1.0]
        assert out[0][1] == {1: 4.0, 3: 4.0}

    @pytest.mark.parametrize("alg,gen,ring", [
        ("ring", "", True), ("sra_knomial", "", True),
        ("sliding_window", "", True), ("gen_dev_ring_c2", "ring(chunks=2)",
                                      True),
        ("knomial", "", False), ("dbt", "", False),
        # the port's device TLs: ring_cuda and tl/torch_ops's ring are
        # ring-family, xla and short are not
        ("ring_cuda", "", True), ("xla", "", False), ("short", "", False),
        ("qint8", "", False)])
    def test_is_ring_family_tokens(self, alg, gen, ring):
        assert pcol.is_ring_family(alg, gen) is ring
        assert jcol.is_ring_family(alg, gen) is ring
        assert pcol._RING_TOKENS == jcol._RING_TOKENS


# ---------------------------------------------------------------------------
# the trace store (tests/test_obs.py::TestTraceStore)
# ---------------------------------------------------------------------------

def _strip(recs):
    return [{k: v for k, v in r.items() if k != "version"} for r in recs]


class TestTraceStore:
    def test_rotation_keeps_bounded_segments(self, tmp_path):
        got = {}
        for name, m in (("port", pcol), ("ref", jcol)):
            d = tmp_path / name
            st = m.TraceStore(str(d), segment_bytes=200, max_segments=3)
            for i in range(60):
                st.append({"kind": "collect_summary", "i": i,
                           "pad": "x" * 50})
            segs = [n for n in d.iterdir() if n.suffix == ".jsonl"]
            assert 0 < len(segs) <= 3
            recs = m.load_dir_records(str(d))
            assert recs[-1]["i"] == 59
            assert all(r["kind"] == "collect_summary" for r in recs)
            got[name] = recs
        assert got["port"] == got["ref"]

    def test_load_dir_tail_and_garbage(self, tmp_path):
        got = {}
        for name, m in (("port", pcol), ("ref", jcol)):
            d = tmp_path / name
            st = m.TraceStore(str(d), segment_bytes=100, max_segments=8)
            for i in range(20):
                st.append({"i": i, "pad": "y" * 40})
            (d / "fr-junk-000001.jsonl").write_text(
                "not json\n{\"i\": 999}\n")
            all_recs = m.load_dir_records(str(d))
            assert any(r.get("i") == 999 for r in all_recs)   # salvages
            tailed = m.load_dir_records(str(d), tail=1)
            assert 0 < len(tailed) < len(all_recs)
            assert m.load_dir_records(str(d / "nope")) == []
            got[name] = sorted(r["i"] for r in all_recs)
        assert got["port"] == got["ref"]

    def test_neither_package_merges_the_others_store(self, tmp_path):
        """A difference by design: the port's records carry its schema
        tag (``diagnose.DUMP_VERSION``), its reader skips the JAX
        package's (version 1), and its segments are named apart (frt-),
        so a shared directory's rotations leave the other's alone."""
        d = tmp_path / "shared"
        jst = jcol.TraceStore(str(d), segment_bytes=80, max_segments=2)
        pst = pcol.TraceStore(str(d), segment_bytes=80, max_segments=2)
        for i in range(12):
            jst.append({"version": 1, "kind": "collect_summary", "i": i})
            pst.append({"version": diagnose.DUMP_VERSION,
                        "kind": "collect_summary", "i": 100 + i})
        names = sorted(p.name for p in d.iterdir())
        assert sum(n.startswith("fr-") for n in names) == 2
        assert sum(n.startswith(pcol.SEGMENT_PREFIX) for n in names) == 2
        mine = pcol.load_dir_records(str(d))
        assert mine and all(r["i"] >= 100 for r in mine)
        assert all(r["version"] == diagnose.DUMP_VERSION for r in mine)


# ---------------------------------------------------------------------------
# the closed loop (tests/test_obs.py::TestCollectorPipeline)
# ---------------------------------------------------------------------------

def _allreduce(pkg, bufs):
    srcs, dsts, count = bufs
    return lambda r: pkg.CollArgs(
        coll_type=pkg.CollType.ALLREDUCE,
        src=pkg.BufferInfo(srcs[r], count, pkg.DataType.FLOAT64),
        dst=pkg.BufferInfo(dsts[r], count, pkg.DataType.FLOAT64),
        op=pkg.ReductionOp.SUM)


def _buffers(n, count, kind):
    if kind == "tensor":
        return ([torch.full((count,), r + 1.0, dtype=torch.float64)
                 for r in range(n)],
                [torch.zeros(count, dtype=torch.float64) for _ in range(n)],
                count)
    return ([np.full(count, r + 1.0) for r in range(n)],
            [np.zeros(count) for _ in range(n)], count)


def _closed_loop(pkg, col, inject, job, tmp, kind="ndarray"):
    """The drill of TestCollectorPipeline::test_closed_loop_flags_delayed_
    rank on *pkg*: returns (flagged, biased candidate names, plain names,
    the store's record kinds, whether rank 1 has severity on disk)."""
    col.configure(enabled=True, interval=0.25, dir=str(tmp), slack=2,
                  windows=2)
    inject.configure("delay=1.0:0.12,delay_rank=1", seed=0)
    n, count = 4, 256
    j = job(n)
    try:
        teams = j.create_team()
        assert j.contexts[0].collector is not None
        assert teams[0].rank_bias is not None
        bufs = _buffers(n, count, kind)
        flagged = frozenset()
        for _ in range(60):
            j.run_coll(teams, _allreduce(pkg, bufs))
            flagged = teams[0].rank_bias.flagged
            if flagged:
                break
        inject.reset()
        exp = float(sum(range(1, n + 1)))
        for d in bufs[1]:
            assert float(d[0]) == exp and float(d[-1]) == exp
        mem = pkg.MemoryType.HOST
        plain = teams[0].score_map.lookup(pkg.CollType.ALLREDUCE, mem,
                                          count * 8)
        biased = teams[0].score_map.lookup(pkg.CollType.ALLREDUCE, mem,
                                           count * 8,
                                           bias=teams[0].rank_bias)
        recs = col.load_dir_records(str(tmp))
        sev = any("1" in r["sev"] for r in recs
                  if r.get("kind") == "collect_summary" and r.get("sev"))
        return (set(flagged), [c.alg_name for c in biased],
                [c.alg_name for c in plain],
                {r.get("kind") for r in recs}, sev)
    finally:
        inject.reset()
        j.cleanup()


class TestCollectorPipeline:
    @pytest.mark.parametrize("pkg", ["port", "ref"])
    def test_disabled_is_zero_cost_shape(self, pkg):
        from harness import UccJob
        mod, col, job = (ut, pcol, FtJob) if pkg == "port" else \
            (ucc_tpu, jcol, UccJob)
        col.configure(enabled=False)
        j = job(2)
        try:
            teams = j.create_team()
            assert j.contexts[0].collector is None
            assert teams[0].rank_bias is None
            assert teams[0].boot_flagged_ctx == frozenset()
            j.run_coll(teams, _allreduce(mod, _buffers(2, 4, "ndarray")))
        finally:
            j.cleanup()

    def test_unknown_knob_rejected(self):
        with pytest.raises(AttributeError):
            pcol.configure(intervall=5)

    @pytest.mark.parametrize("kind", ["ndarray", "tensor"])
    def test_closed_loop_flags_delayed_rank(self, tmp_path, kind):
        """Continuous windows over the flight rings flag a fault-delayed
        rank with no dump trigger, the RankBias reaches the team, store
        records land on disk, and the bias-aware lookup demotes the ring
        family, in both packages, with the same demoted order."""
        from harness import UccJob
        from ucc_tpu.fault import inject as jinject
        from ucc_tpu_torch.fault import inject
        got = _closed_loop(ut, pcol, inject, FtJob, tmp_path / "port", kind)
        want = _closed_loop(ucc_tpu, jcol, jinject, UccJob,
                            tmp_path / "ref")
        for flagged, biased, plain, kinds, sev in (got, want):
            assert 1 in flagged, flagged
            last_clean = max(i for i, a in enumerate(biased)
                             if not pcol.is_ring_family(a))
            first_ring = min(i for i, a in enumerate(biased)
                             if pcol.is_ring_family(a))
            assert first_ring > last_clean
            assert {"flight_merged", "collect_summary"} <= kinds
            assert sev
        assert got[2] == want[2]          # the same candidates ...
        if got[0] == want[0]:
            assert got[1] == want[1]      # ... in the same biased order

    def test_store_records_carry_the_schema_and_merge_in_ucc_fr(
            self, tmp_path, capsys):
        from ucc_tpu_torch.fault import inject
        from ucc_tpu_torch.tools.fr import main
        _closed_loop(ut, pcol, inject, FtJob, tmp_path)
        recs = pcol.load_dir_records(str(tmp_path))
        assert all(r.get("version") == diagnose.DUMP_VERSION for r in recs)
        assert main([str(tmp_path), "--json"]) == 0
        out = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert out["ranks"] == ["0", "1", "2", "3"]
        assert main([str(tmp_path), "--tail", "1"]) == 0


# ---------------------------------------------------------------------------
# the core's hooks
# ---------------------------------------------------------------------------

def _flag(team, ranks, apply_at=0):
    team.rank_bias.publish(set(ranks), {r: 0.9 for r in ranks}, window=0,
                           apply_at=apply_at)
    team.rank_bias.tick(apply_at)


def test_flagged_ranks_ride_the_address_exchange(monkeypatch):
    """A team created while the collector has flagged ranks agrees on them
    (``boot_flagged_ctx``, the union over members), keeps them out of its
    team key, and cl/hier demotes them from leader positions, as the JAX
    package's does on the same layout."""
    from harness import UccJob
    monkeypatch.setenv("UCC_TOPO_FAKE_PPN", "2")
    out = {}
    for name, col, job in (("port", pcol, FtJob), ("ref", jcol, UccJob)):
        col.configure(enabled=True, interval=30.0, dir="")
        j = job(4)
        try:
            first = j.create_team()
            _flag(first[0], [2])
            assert j.contexts[0].collector.flagged_ctx() == frozenset({2})
            second = j.create_team()
            assert all(t.boot_flagged_ctx == frozenset({2}) for t in second)
            assert second[0].team_key[0] == (0, 1, 2, 3)
            hier = [cl for cl in second[0].cl_teams if cl.name == "hier"]
            out[name] = [list(g) for g in hier[0].tree.level(0).groups] \
                if hier else None
        finally:
            j.cleanup()
    assert out["port"] == out["ref"] and out["port"]
    assert all(g[0] != 2 for g in out["port"])


def test_dispatch_switches_at_the_staged_index():
    """collective_init ticks the bias with the team's flight sequence:
    the staged table takes effect on the post at apply_at on every rank,
    and the ring pinned at a finite score gives way to the next
    candidate from there on."""
    pcol.configure(enabled=True, interval=30.0, dir="", slack=2)
    import os
    os.environ["UCC_TL_SHM_TUNE"] = "allreduce:@ring:2000000000"
    try:
        j = FtJob(4)
        teams = j.create_team()
    finally:
        os.environ.pop("UCC_TL_SHM_TUNE", None)
    try:
        bufs = _buffers(4, 1024, "ndarray")
        algs = []
        apply_at = teams[0].flight_seq + 3
        for t in teams:
            t.rank_bias.publish({1}, {1: 0.9}, window=0, apply_at=apply_at)
        for _ in range(5):
            reqs = j.run_coll(teams, _allreduce(ut, bufs))
            names = {rq.task.alg_name for rq in reqs}
            assert len(names) == 1          # every rank chose the same
            algs.append(names.pop())
        assert algs[:3] == ["ring"] * 3
        assert not pcol.is_ring_family(algs[3]) and algs[3] == algs[4]
    finally:
        j.cleanup()


@pytest.mark.parametrize("flagged", [set(), {1}, {0, 2}])
def test_tuner_weights_ring_medians_as_the_reference(flagged):
    """The online tuner's rank-0 winner is taken over medians weighted by
    RankBias.time_multiplier in both packages (the port once left them
    unweighted)."""
    from types import SimpleNamespace

    from ucc_tpu.score import tuner as jt
    from ucc_tpu_torch.score import tuner as pt
    samples = {("shm", "ring"): [1.0, 1.1, 0.9],
               ("shm", "knomial"): [2.0, 2.2, 2.1],
               ("shm", "sra_knomial"): [1.5, 1.6, 1.4],
               ("shm", "dbt"): [9.0, float("inf"), 9.1]}
    out = []
    for mod, col in ((pt, pcol), (jt, jcol)):
        bias = col.RankBias(penalty=4096, slow_mult=4.0)
        bias.publish(flagged, {r: 0.9 for r in flagged}, window=0,
                     apply_at=0)
        bias.tick(0)
        st = mod._KeyState()
        st.samples = {k: list(v) for k, v in samples.items()}
        me = SimpleNamespace(team=SimpleNamespace(rank_bias=bias))
        out.append(mod.OnlineTuner._local_winner(me, st))
    assert out[0] == out[1]
    assert out[0][0] == (("shm", "ring") if not flagged
                         else ("shm", "knomial"))


# ---------------------------------------------------------------------------
# membership changes (tests/test_ft_grow.py::TestObsContinuity, TestChurn)
# ---------------------------------------------------------------------------

def _grow_to_full(job, teams, joiner, team_cls, status, timeout=30.0):
    """grow_post on every member and join_post on the joiner, every
    request polled each pass (test() drives the rebuild rounds)."""
    ctx = job.contexts[joiner].rank
    grows = {r: t.grow_post([ctx]) for r, t in teams.items()}
    jn = team_cls.join_post(job.contexts[joiner])
    job.progress_until(lambda: all(
        [g.test() != status.IN_PROGRESS for g in grows.values()]
        + [jn.test() != status.IN_PROGRESS]), timeout)
    return grows, jn


def _continuity(job, team_cls, status, col, flight_mod):
    """Plant straggler state on a 3-rank team's watch, grow ctx 3 in, and
    return what the grown team's watch carried."""
    flight_mod.configure(enabled=True)
    col.configure(enabled=True, interval=0.25, dir="")
    j = job(4)
    try:
        teams = dict(enumerate(j.create_team(ranks=[0, 1, 2])))
        c = j.contexts[0].collector
        old_w = c.watch_for(teams[0])
        old_w.scorer.scores = {1: 2.5}
        old_w.scorer.streaks = {1: 3}
        old_w.scorer.flagged = {1}
        old_w.scorer.windows_seen = 7
        old_w.bias.flagged = frozenset({1})
        old_w.bias.scores = {1: 2.5}
        grows, jn = _grow_to_full(j, teams, 3, team_cls, status)
        assert all(g.test() == status.OK for g in grows.values())
        assert jn.test() == status.OK
        new_team = grows[0].new_team
        new_w = c.watch_for(new_team)
        boots = [e for e in j.contexts[3].flight.snapshot()["events"]
                 if str(e.get("stage", "")).startswith("boot:")
                 and e.get("epoch") == 1]
        marks = [e for e in j.contexts[0].flight.snapshot()["events"]
                 if e.get("coll") == "membership"]
        res = (new_w.scorer.scores, new_w.scorer.streaks,
               new_w.scorer.flagged, new_w.scorer.windows_seen,
               new_w.window, c.watch_for(teams[0]) is None,
               set(new_w.bias.flagged), new_w.bias.scores, bool(boots),
               any(e.get("alg") == "grow" for e in marks))
        for t in [g.new_team for g in grows.values()] + [jn.new_team]:
            t.destroy()
        return res
    finally:
        j.cleanup()


class TestObsContinuity:
    def test_collector_state_survives_grow(self):
        """The scorer's learned state rides the hand-off into the grown
        team's watch (remapped through ctx ranks), the retired team stops
        being watched, the window index restarts, and the joiner's boot
        spans exist under the new epoch; the JAX package carries the
        same state."""
        from harness import UccJob
        from ucc_tpu.core.team import Team as JTeam
        from ucc_tpu.fault import health as jhealth
        from ucc_tpu.obs import flight as jflight
        from ucc_tpu_torch.core.team import Team
        from ucc_tpu_torch.fault import health
        health.reset()
        jhealth.reset()
        got = _continuity(FtJob, Team, ut.Status, pcol, flight)
        want = _continuity(UccJob, JTeam, ucc_tpu.Status, jcol, jflight)
        assert got == want
        assert got[:6] == ({1: 2.5}, {1: 3}, {1}, 7, 0, True)
        assert got[6:] == ({1}, {1: 2.5}, True, True)


CHURN_KEYS = ("cycles", "violations", "fenced", "epochs", "post_churn_ok",
              "readmitted", "matcher")
#: the drills' 0.3 s heartbeat timeout, scaled for loaded runs as the
#: port's fault-tolerance tests scale theirs (torch_ft_jobs.LOAD)
HB = 0.3 * LOAD


class TestChurn:
    def test_mini_churn_cycle(self):
        """One kill -> shrink -> grow(rejoin) cycle plus the false
        suspicion round, collectives in flight on every epoch, fences
        tripped both ways; the report equals the JAX package's on the
        keys both give."""
        from ucc_tpu.fault.soak import run_churn_soak as jrun
        from ucc_tpu_torch.fault.soak import run_churn_soak
        from torch_host_jobs import reference_core
        reference_core()            # C10: the reference's matcher as it runs
        kw = dict(n_ranks=4, cycles=1, iters_per_epoch=2, post_iters=6,
                  hb_timeout=HB)
        t0 = time.monotonic()
        report = run_churn_soak(**kw)
        assert time.monotonic() - t0 < 60
        assert report["violations"] == [], report
        assert report["cycles"] == 1
        assert report["fenced"]["shrink"] > 0
        assert report["fenced"]["grow"] > 0
        assert report["readmitted"] is True
        assert report["post_churn_ok"] == 6
        ref = jrun(**kw)
        assert {k: report[k] for k in CHURN_KEYS} == \
            {k: ref[k] for k in CHURN_KEYS}

    @pytest.mark.parametrize("pkg", ["port", "ref"])
    def test_churn_with_collection_reports_the_collector(self, pkg):
        if pkg == "port":
            from ucc_tpu_torch.fault.soak import run_churn_soak
        else:
            from ucc_tpu.fault.soak import run_churn_soak
        rep = run_churn_soak(n_ranks=4, cycles=1, iters_per_epoch=2,
                             post_iters=4, collect=True, hb_timeout=HB)
        assert rep["violations"] == []
        assert set(rep["collector"]) == {"windows", "flagged_ctx"}
        assert rep["collector"]["flagged_ctx"] == []
        assert not pcol.KNOBS.enabled and not jcol.KNOBS.enabled

    def test_churn_on_device_memory(self):
        """The port's device form: every collective an allreduce of f32
        CPU tensors passed as CUDA memory (the device TLs' plain
        versions), checked against the exact sum after the churn."""
        from ucc_tpu_torch.fault.soak import run_churn_soak
        rep = run_churn_soak(n_ranks=4, cycles=1, iters_per_epoch=2,
                             post_iters=6, device="cpu", hb_timeout=HB)
        assert rep["violations"] == [], rep
        assert rep["post_churn_ok"] == 6
        assert rep["epochs"] == [1, 2, 3, 4]
        assert any(k.startswith("post-churn") for k in rep["outcomes"])


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_soak_collect_reports_the_collector(pkg):
    """run_soak(collect=True): the report's collector section (windows
    closed, flagged ctx ranks) in both packages, knobs restored after."""
    if pkg == "port":
        from ucc_tpu_torch.fault.soak import run_soak
    else:
        from ucc_tpu.fault.soak import run_soak
    rep = run_soak(n_ranks=2, iterations=6, spec="delay=0.2:0.02", seed=1,
                   coll_timeout_s=0.5, iter_deadline_s=6.0, collect=True)
    assert rep["hangs"] == []
    assert set(rep["collector"]) == {"windows", "flagged_ctx"}
    assert not pcol.KNOBS.enabled and not jcol.KNOBS.enabled
