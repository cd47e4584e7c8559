"""The watchdog, the flight recorder and its diagnosis in the port, the
counterpart of tests/test_obs.py's TestWatchdog, TestFlightRing,
TestFlightCollection, TestDesyncDiagnosis (with TestStragglerDiagnosis
and TestPerfettoExport), TestFlightTools, TestWatchdogFlightFoldIn,
TestStragglerScorer, TestBootstrapSpans and TestMidCollectionDeath; plus
cross-checks: ``diagnose`` and ``to_chrome_trace`` give the JAX package's
output on the same merged record, ``ucc_fr`` refuses the JAX package's
dumps, and device rounds leave dev_launch/dev_ready on the wire ring."""
import json
import os
import time

import numpy as np
import pytest
import torch

import ucc_tpu_torch as ut
from ucc_tpu_torch import (BufferInfo, CollArgs, CollType, DataType,
                           ReductionOp, Status)
from ucc_tpu_torch.obs import diagnose, flight, metrics, watchdog

from torch_ft_jobs import FtJob


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    for k in ("UCC_TLS", "UCC_TL_SHM_TUNE", "UCC_FAULT"):
        monkeypatch.delenv(k, raising=False)
    flight.reset()


def _allreduce_args(srcs, dsts, count):
    return lambda r: CollArgs(
        coll_type=CollType.ALLREDUCE,
        src=BufferInfo(srcs[r], count, DataType.FLOAT64),
        dst=BufferInfo(dsts[r], count, DataType.FLOAT64),
        op=ReductionOp.SUM)


@pytest.fixture
def stats(tmp_path):
    metrics.reset()
    metrics.enable(file=str(tmp_path / "stats.json"))
    yield metrics
    metrics.disable()
    metrics.reset()


@pytest.fixture
def wd(tmp_path):
    path = tmp_path / "watchdog.json"
    watchdog.reset()
    watchdog.configure(0.05, file=str(path))
    yield path
    watchdog.configure(0)
    watchdog.reset()


class TestWatchdog:
    def test_injected_stall_names_the_task(self, wd):
        """A rank whose peer never posts stalls with outstanding recvs:
        the dump names collective, algorithm, round slots and peers."""
        n, count = 2, 8
        job = FtJob(n)
        try:
            teams = job.create_team()
            dst = np.zeros(count)
            req = teams[0].collective_init(CollArgs(
                coll_type=CollType.ALLREDUCE,
                src=BufferInfo(np.full(count, 1.0), count, DataType.FLOAT64),
                dst=BufferInfo(dst, count, DataType.FLOAT64),
                op=ReductionOp.SUM))
            req.post()
            deadline = time.monotonic() + 5.0
            while not wd.exists() or not wd.read_text().strip():
                job.contexts[0].progress()
                watchdog._last_scan = 0.0
                assert time.monotonic() < deadline, "watchdog never fired"
            report = json.loads(wd.read_text().splitlines()[0])
            assert report["progress_queue_depth"] >= 1
            t = report["stalled_tasks"][0]
            assert t["coll"] == "allreduce" and t["alg"]
            assert t["status"] == "IN_PROGRESS"
            assert t["age_s"] >= 0.05
            assert {o["peer"] for o in t["outstanding"]} == {1}
            assert t["round_slots"], t
            watchdog._last_scan = 0.0
            job.contexts[0].progress()
            assert len(wd.read_text().splitlines()) == 1
            dst1 = np.zeros(count)
            req1 = teams[1].collective_init(CollArgs(
                coll_type=CollType.ALLREDUCE,
                src=BufferInfo(np.full(count, 2.0), count, DataType.FLOAT64),
                dst=BufferInfo(dst1, count, DataType.FLOAT64),
                op=ReductionOp.SUM))
            req1.post()
            job.progress_until(lambda: all(
                [r.test() != Status.IN_PROGRESS for r in (req, req1)]))
            assert req.test() == Status.OK
            np.testing.assert_allclose(dst, 3.0)
        finally:
            job.cleanup()

    def test_team_state_dwell_names_cl_agree(self, wd):
        from ucc_tpu_torch.core.team import TeamState

        class FakeTeam:
            id = 7
            rank = 0
            size = 2
            state = TeamState.CL_AGREE
            state_since = time.monotonic() - 10.0

        team = FakeTeam()
        watchdog.register_team(team)
        queue = type("Q", (), {"_q": []})()
        watchdog._last_scan = 0.0
        assert watchdog.check(queue)
        report = json.loads(wd.read_text().splitlines()[-1])
        names = {t["state"]: t for t in report["stalled_teams"]}
        assert "CL_AGREE" in names["CL_AGREE"]["hint"]
        assert names["CL_AGREE"]["dwell_s"] > 5

    def test_disabled_watchdog_never_scans(self):
        watchdog.configure(0)
        assert not watchdog.ENABLED


class TestFlightRing:
    def test_ring_wraps_at_depth(self):
        rec = flight.FlightRecorder(0, "uid", depth=16)
        for i in range(40):
            rec.post(1, 0, i, i, "allreduce", "ring", 64)
        evs = rec.coll.events()
        assert [e["fseq"] for e in evs] == list(range(24, 40))
        assert rec.coll.dropped == 24
        assert all(e["coll"] == "allreduce" and e["size"] == 64
                   for e in evs)

    def test_appends_allocate_nothing(self):
        import gc
        rec = flight.FlightRecorder(0, "uid", depth=64)
        key = (("t", 9, 1), 0, 7, 3, 0)
        rec.post(1, 0, 0, 0, "allreduce", "ring", 64)
        rec.complete(1, 0, 0, "allreduce", "ring", None, 0.1, "OK")
        rec.wire.append("direct", key, 64)
        gc.collect()
        before = len(gc.get_objects())
        for i in range(200):
            rec.post(1, 0, i, i, "allreduce", "ring", 64)
            rec.complete(1, 0, i, "allreduce", "ring", None, 0.1, "OK")
            rec.wire.append("direct", key, 64)
        assert len(gc.get_objects()) - before < 20

    def test_lifecycle_events_recorded(self):
        n, count, iters = 2, 8, 3
        job = FtJob(n)
        try:
            teams = job.create_team()
            srcs = [np.full(count, r + 1.0) for r in range(n)]
            dsts = [np.zeros(count) for _ in range(n)]
            for _ in range(iters):
                job.run_coll(teams, _allreduce_args(srcs, dsts, count))
            for r in range(n):
                snap = job.contexts[r].flight.snapshot()
                posts = [e for e in snap["events"] if e["ev"] == "post"]
                assert [e["fseq"] for e in posts] == [1, 2, 3]
                for e in posts:
                    assert e["team"] == teams[0].id and e["epoch"] == 0
                    assert e["coll"] == "allreduce" and e["alg"]
                    assert e["size"] == count * 8
                cmpls = [e for e in snap["events"] if e["ev"] == "cmpl"]
                assert len(cmpls) >= iters
                assert all(c["status"] == "OK" for c in cmpls)
                kinds = {w["kind"] for w in snap["wire"]}
                assert snap["wire"] and \
                    kinds <= {"direct", "eager", "rndv", "fenced"}
        finally:
            job.cleanup()

    def test_disabled_records_nothing(self):
        flight.configure(enabled=False)
        try:
            job = FtJob(2)
            try:
                teams = job.create_team()
                assert job.contexts[0].flight is None
                srcs = [np.full(4, 1.0) for _ in range(2)]
                dsts = [np.zeros(4) for _ in range(2)]
                job.run_coll(teams, _allreduce_args(srcs, dsts, 4))
            finally:
                job.cleanup()
        finally:
            flight.configure(enabled=True)

    def test_device_rounds_on_wire_ring(self):
        """A device collective (CUDA memory, device ``cpu`` here) leaves
        one dev_launch and one dev_ready per rank and round, keyed by the
        team's tag."""
        n, count, iters = 4, 32, 2
        job = FtJob(n)
        try:
            teams = job.create_team()
            for it in range(iters):
                srcs = [torch.full((count,), float(r)) for r in range(n)]
                dsts = [torch.zeros(count) for _ in range(n)]
                job.run_coll(teams, lambda r: CollArgs(
                    coll_type=CollType.ALLREDUCE,
                    src=BufferInfo(srcs[r], count, DataType.FLOAT32,
                                   mem_type=ut.MemoryType.CUDA),
                    dst=BufferInfo(dsts[r], count, DataType.FLOAT32,
                                   mem_type=ut.MemoryType.CUDA),
                    op=ReductionOp.SUM))
                assert all(torch.equal(d, torch.full((count,), 6.0))
                           for d in dsts)
            for r in range(n):
                wire = job.contexts[r].flight.snapshot()["wire"]
                launches = [w for w in wire if w["kind"] == "dev_launch"]
                ready = [w for w in wire if w["kind"] == "dev_ready"]
                assert len(launches) == iters and len(ready) == iters
                assert [w["tag"] for w in launches] == \
                    [w["tag"] for w in ready]
        finally:
            job.cleanup()


class TestFlightCollection:
    def test_cooperative_cross_rank_collection(self):
        n, count = 3, 16
        job = FtJob(n)
        try:
            teams = job.create_team()
            srcs = [np.full(count, r + 1.0) for r in range(n)]
            dsts = [np.zeros(count) for _ in range(n)]
            for _ in range(4):
                job.run_coll(teams, _allreduce_args(srcs, dsts, count))
            reqs = [flight.collect_team_post(t, reason="test")
                    for t in teams]
            job.progress_until(lambda: all(
                [r.test() != Status.IN_PROGRESS for r in reqs]))
            merged = reqs[0].result
            assert sorted(merged["ranks"], key=int) == ["0", "1", "2"]
            assert merged["absent_ranks"] == []
            for rq in reqs[1:]:
                assert sorted(rq.result["ranks"]) == sorted(merged["ranks"])
            diag = diagnose.diagnose(merged)
            assert diag["desync"] == [] and diag["missing"] == []
            assert diag["failed"] == []
        finally:
            job.cleanup()

    def test_collection_past_killed_rank_degrades(self):
        """Collection with a killed rank does not hang: the dead rank is
        excluded up front, named in the dump and in the diagnosis."""
        from ucc_tpu_torch.fault import inject as fault
        n = 4
        job = FtJob(n)
        try:
            teams = job.create_team()
            srcs = [np.full(8, r + 1.0) for r in range(n)]
            dsts = [np.zeros(8) for _ in range(n)]
            job.run_coll(teams, _allreduce_args(srcs, dsts, 8))
            fault.configure("kill=3", seed=0)
            try:
                reqs = [flight.collect_team_post(teams[r], reason="kill",
                                                 timeout=20)
                        for r in range(3)]
                deadline = time.monotonic() + 30
                while not all([r.test() != Status.IN_PROGRESS
                               for r in reqs]):
                    for c in job.contexts[:3]:
                        c.progress()
                    assert time.monotonic() < deadline
            finally:
                fault.reset()
            merged = reqs[0].result
            assert sorted(merged["ranks"], key=int) == ["0", "1", "2"]
            assert merged["absent_ranks"] == [3] and merged.get("partial")
            assert any(f["rank"] == 3 and f.get("absent")
                       for f in diagnose.detect_failed(merged))
        finally:
            job.cleanup()


class TestDesyncDiagnosis:
    @staticmethod
    def _post(t, fseq, coll="allreduce", alg="ring", size=128, team=7,
              seq=None):
        return {"t": t, "ev": "post", "team": team, "epoch": 0,
                "fseq": fseq, "seq": seq if seq is not None else fseq,
                "coll": coll, "alg": alg, "size": size}

    @staticmethod
    def _cmpl(t, seq, dur=0.001, status="OK", team=7, stage=None,
              coll="allreduce", alg="ring"):
        d = {"t": t, "ev": "cmpl", "team": team, "epoch": 0, "seq": seq,
             "dur_s": dur, "status": status}
        if stage:
            d["stage"] = stage
        else:
            d["coll"], d["alg"] = coll, alg
        return d

    @classmethod
    def _merged(cls, events_by_rank, wire_by_rank=None, absent=()):
        return {"ranks": {str(r): {"events": ev,
                                   "wire": (wire_by_rank or {}).get(r, [])}
                          for r, ev in events_by_rank.items()},
                "absent_ranks": list(absent)}

    def test_mismatched_post_names_minority_rank(self):
        P = self._post
        merged = self._merged({
            0: [P(1.0, 1), P(2.0, 2)],
            1: [P(1.0, 1), P(2.0, 2)],
            2: [P(1.0, 1), P(2.0, 2, coll="allgather", alg="linear",
                             size=64)],
        })
        findings = diagnose.detect_desync(merged)
        assert len(findings) == 1
        f = findings[0]
        assert f["fseq"] == 2 and f["culprits"] == [2]
        assert f["expect"]["coll"] == "allreduce"
        assert f["got"]["2"]["coll"] == "allgather"
        summary = diagnose.diagnose(merged)["summary"]
        assert any("DESYNC" in s and "rank(s) 2" in s for s in summary)

    def test_size_mismatch_is_desync_too(self):
        P = self._post
        merged = self._merged({0: [P(1.0, 1, size=256)],
                               1: [P(1.0, 1, size=256)],
                               2: [P(1.0, 1, size=512)]})
        f = diagnose.detect_desync(merged)
        assert f and f[0]["culprits"] == [2]

    def test_missing_participant_named(self):
        P, C = self._post, self._cmpl
        full = [P(1.0, 1), C(1.1, 1), P(2.0, 2), C(2.1, 2),
                P(3.0, 3), P(9.0, 4)]
        merged = self._merged({0: list(full), 1: list(full),
                               2: full[:4]})
        findings = diagnose.detect_missing(merged)
        miss = [f for f in findings if f["kind"] == "missing"]
        assert len(miss) == 1 and miss[0]["culprits"] == [2]
        assert miss[0]["last_fseq"]["2"] == 2
        stuck = [f for f in findings if f["kind"] == "stuck"]
        assert {f["rank"] for f in stuck} == {0, 1}
        assert {f["fseq"] for f in stuck} == {3, 4}

    def test_healthy_timeline_is_clean(self):
        P, C = self._post, self._cmpl
        ev = [P(1.0, 1), C(1.1, 1), P(2.0, 2), C(2.1, 2)]
        merged = self._merged({0: list(ev), 1: list(ev), 2: list(ev)})
        assert diagnose.diagnose(merged)["summary"] == []


class TestStragglerDiagnosis(TestDesyncDiagnosis):
    def test_duration_outlier_names_rank(self):
        P, C = self._post, self._cmpl
        ranks = {}
        for r in range(4):
            dur = 0.5 if r == 2 else 0.01
            ranks[r] = [P(1.0, 1), C(1.0 + dur, 1, dur=dur),
                        P(2.0, 2), C(2.0 + dur, 2, dur=dur)]
        dur_f = [f for f in diagnose.detect_stragglers(self._merged(ranks))
                 if f["signal"] == "duration"]
        assert len(dur_f) == 1
        assert dur_f[0]["rank"] == 2 and dur_f[0]["outlier_colls"] == 2
        assert dur_f[0]["coll"] == "allreduce"

    def test_wire_lag_names_source_rank_and_seq(self):
        P, C = self._post, self._cmpl
        events, wire = {}, {}
        for r in range(3):
            lag = 0.08 if r == 1 else 0.0
            events[r] = [P(1.0, 5, seq=50), C(1.5, 50, dur=0.5)]
            wire[r] = [{"t": 1.01 + lag + 0.1 * s, "ev": "snd",
                        "kind": "direct", "tkey": "tk", "epoch": 0,
                        "tag": 9, "slot": s, "nbytes": 64}
                       for s in range(4)]
        lag_f = [f for f in diagnose.detect_stragglers(
            self._merged(events, wire)) if f["signal"] == "wire_lag"]
        assert len(lag_f) == 1 and lag_f[0]["rank"] == 1
        assert lag_f[0]["lag_s"] == pytest.approx(0.08, abs=0.01)
        assert {s["fseq"] for s in lag_f[0]["seqs"]} == {5}

    def test_stage_outlier_names_tree_level(self):
        C = self._cmpl
        ranks = {r: [C(1.0, 100 + r, dur=0.2 if r == 3 else 0.005,
                       stage="rab.leaders_allreduce"),
                     C(2.0, 200 + r, dur=0.005, stage="rab.node_bcast")]
                 for r in range(4)}
        st = [f for f in diagnose.detect_stragglers(self._merged(ranks))
              if f["signal"] == "stage"]
        assert len(st) == 1 and st[0]["rank"] == 3
        assert st[0]["stage"] == "rab.leaders_allreduce"

    def test_symmetric_timings_are_quiet(self):
        P, C = self._post, self._cmpl
        ranks = {r: [P(1.0, 1), C(1.01, 1, dur=0.01)] for r in range(4)}
        assert diagnose.detect_stragglers(self._merged(ranks)) == []


class TestPerfettoExport(TestDesyncDiagnosis):
    def test_export_has_per_rank_tracks(self):
        P, C = self._post, self._cmpl
        ranks = {r: [P(1.0, 1), C(1.2, 1, dur=0.2),
                     C(1.1, 9, dur=0.05, stage="rab.node_reduce")]
                 for r in range(3)}
        wire = {0: [{"t": 1.05, "ev": "snd", "kind": "direct",
                     "tkey": "tk", "epoch": 0, "tag": 1, "slot": 0,
                     "nbytes": 64}]}
        trace = diagnose.to_chrome_trace(self._merged(ranks, wire))
        evs = trace["traceEvents"]
        json.dumps(trace)
        assert {e["pid"] for e in evs} == {0, 1, 2}
        assert any(e["ph"] == "X" and e["name"] == "allreduce:ring"
                   for e in evs)
        names = {e["args"]["name"] for e in evs
                 if e["ph"] == "M" and e["name"] == "thread_name"}
        assert {"collectives", "wire", "rab.node_reduce"} <= names
        assert any(e["ph"] == "i" and e["name"].startswith("post ")
                   for e in evs)
        assert any(e["ph"] == "i" and e["name"] == "snd:direct"
                   for e in evs)

    def test_export_from_live_run_loads(self, tmp_path):
        n, count = 2, 8
        job = FtJob(n)
        try:
            teams = job.create_team()
            srcs = [np.full(count, r + 1.0) for r in range(n)]
            dsts = [np.zeros(count) for _ in range(n)]
            job.run_coll(teams, _allreduce_args(srcs, dsts, count))
            merged = flight.collect_process(job.contexts[0], "test")
        finally:
            job.cleanup()
        out = tmp_path / "trace.json"
        out.write_text(json.dumps(diagnose.to_chrome_trace(merged)))
        back = json.loads(out.read_text())
        assert {e["pid"] for e in back["traceEvents"]} == {0, 1}


def _synthetic_records():
    """Merged records with every finding kind: a desync, a missing rank,
    stuck posts, a duration outlier, a wire-lag straggler, a stage
    outlier, a queue wait, an absent rank and failed completions, from
    seeded timings."""
    g = np.random.default_rng(11)
    P, C = TestDesyncDiagnosis._post, TestDesyncDiagnosis._cmpl
    events, wire = {}, {}
    for r in range(5):
        ev = []
        for f in range(1, 7):
            t0 = float(f) + float(g.uniform(0, 0.01))
            dur = 0.4 if (r == 2 and f % 2) else float(g.uniform(0.005,
                                                                0.01))
            coll = "allgather" if (r == 4 and f == 3) else "allreduce"
            ev.append(P(t0, f, coll=coll, seq=10 * f + r))
            if not (r == 3 and f > 4):
                ev.append(C(t0 + dur, 10 * f + r, dur=dur,
                            status="ERR_TIMED_OUT" if (r == 1 and f == 6)
                            else "OK"))
        ev.append(C(9.0, 900 + r, dur=0.3 if r == 0 else 0.004,
                    stage="rab.leaders_allreduce"))
        ev.append(C(9.5, 950 + r, dur=0.2, stage="qos:qwait:p0"))
        events[r] = ev
        lag = 0.09 if r == 2 else 0.0
        wire[r] = [{"t": 1.01 + lag + 0.1 * s, "ev": "snd",
                    "kind": "dev_launch" if s % 2 else "direct",
                    "tkey": "tk", "epoch": 0, "tag": 9, "slot": s,
                    "nbytes": 4096} for s in range(6)]
    merged = TestDesyncDiagnosis._merged(events, wire, absent=(5,))
    merged.update({"reason": "test", "team": 7, "team_size": 6})
    return merged


def test_diagnose_and_trace_match_jax_package():
    """The same merged record through both packages' diagnose and
    to_chrome_trace: equal findings and equal trace events."""
    from ucc_tpu.obs import diagnose as jax_diagnose
    merged = _synthetic_records()
    mine = diagnose.diagnose(json.loads(json.dumps(merged)))
    theirs = jax_diagnose.diagnose(json.loads(json.dumps(merged)))
    assert mine == theirs
    for kind in ("desync", "missing", "stragglers", "failed"):
        assert mine[kind], kind
    t_mine = diagnose.to_chrome_trace(json.loads(json.dumps(merged)))
    t_theirs = jax_diagnose.to_chrome_trace(json.loads(json.dumps(merged)))
    assert t_mine["traceEvents"] == t_theirs["traceEvents"]


class TestFlightTools:
    def test_ucc_fr_merges_and_diagnoses(self, tmp_path, capsys):
        from ucc_tpu_torch.tools.fr import main
        path = tmp_path / "fl.json"
        n = 2
        job = FtJob(n)
        try:
            teams = job.create_team()
            srcs = [np.full(8, r + 1.0) for r in range(n)]
            dsts = [np.zeros(8) for _ in range(n)]
            job.run_coll(teams, _allreduce_args(srcs, dsts, 8))
            for ctx in job.contexts:
                flight.dump_local(ctx.flight, "test", str(path))
        finally:
            job.cleanup()
        assert main([str(path)]) == 0
        out = capsys.readouterr().out
        assert "2 rank(s)" in out and "clean" in out
        trace_path = tmp_path / "t.json"
        assert main([str(path), "--perfetto", str(trace_path),
                     "--json"]) == 0
        rec = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert rec["ranks"] == ["0", "1"]
        assert json.loads(trace_path.read_text())["traceEvents"]
        empty = tmp_path / "empty.json"
        empty.write_text("")
        assert main([str(empty)]) == 1

    def test_ucc_fr_refuses_jax_package_dumps(self, tmp_path, capsys):
        """A dump of the JAX package's recorder (schema version 1) in
        the same file is skipped, not merged."""
        from ucc_tpu.obs import flight as jax_flight
        from ucc_tpu_torch.tools.fr import load_records, main
        path = tmp_path / "mixed.json"
        jax_flight.dump_local(jax_flight.FlightRecorder(0, "j"), "jax",
                              str(path))
        flight.dump_local(flight.FlightRecorder(1, "t"), "torch", str(path))
        recs = load_records(str(path))
        assert [r["rank"] for r in recs] == [1]
        assert "another schema" in capsys.readouterr().err
        only_jax = tmp_path / "jax.json"
        jax_flight.dump_local(jax_flight.FlightRecorder(0, "j"), "jax",
                              str(only_jax))
        assert main([str(only_jax)]) == 1

    def test_merge_records_prefers_latest_merged(self):
        recs = [
            {"kind": "flight_local", "rank": 0, "events": []},
            {"kind": "flight_merged", "reason": "old", "ranks": {}},
            {"kind": "flight_merged", "reason": "new",
             "ranks": {"0": {"events": []}}},
        ]
        assert diagnose.merge_records(recs)["reason"] == "new"
        locals_only = diagnose.merge_records(
            [{"kind": "flight_local", "rank": 1, "events": [],
              "wire": []}])
        assert "1" in locals_only["ranks"]

    def test_delay_rank_spec_parses_and_pins(self):
        from ucc_tpu_torch.fault.inject import parse_spec
        spec = parse_spec("delay=1.0:0.02,delay_rank=2")
        assert spec.delay == 1.0 and spec.delay_rank == 2 and spec.active
        with pytest.raises(ValueError):
            parse_spec("delay_rnk=2")

    def test_fr_smoke_names_the_delayed_rank(self, capsys):
        from ucc_tpu_torch.tools.fr import main
        assert main(["--smoke", "--smoke-iters", "4"]) == 0
        rec = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert rec["culprit_ranks"] == [1] and rec["stuck_seqs"]

    def test_collector_modes_refused(self, tmp_path, capsys, monkeypatch):
        """The name is historical: the collector's modes ran refused until
        the collector was ported. ``--feedback-smoke`` now runs its
        closed loop (the pinned rank flagged within two windows,
        selection off the ring, the p99 down) and leaves no TUNE behind,
        and a trace-store directory merges (only this package's records:
        a store of the JAX package's alone has no flight records)."""
        from ucc_tpu.obs import collector as jcol
        from ucc_tpu_torch.obs import collector
        from ucc_tpu_torch.tools.fr import main
        monkeypatch.setenv("UCC_TL_SHM_TUNE", "")
        monkeypatch.delenv("UCC_TL_SHM_TUNE")
        knobs = dict(vars(collector.KNOBS))
        try:
            assert main(["--feedback-smoke"]) == 0
        finally:
            collector.configure(**knobs)
        rec = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert rec["flagged"] == [1] and rec["windows_to_flag"] <= 2
        assert rec["pre_alg"] == "ring" and rec["post_alg"] != "ring"
        assert rec["post_p99_ms"] < rec["pre_p99_ms"] and rec["ok"]
        assert "UCC_TL_SHM_TUNE" not in os.environ
        store = tmp_path / "store"
        st = collector.TraceStore(str(store), 1 << 20, 2)
        st.append({"version": diagnose.DUMP_VERSION, "kind": "flight_merged",
                   "reason": "collect", "ranks": {
                       str(r): {"rank": r, "events": [], "wire": []}
                       for r in range(2)}})
        st.append({"version": diagnose.DUMP_VERSION,
                   "kind": "collect_summary", "flagged": []})
        assert main([str(store), "--tail", "1"]) == 0
        assert "2 rank(s)" in capsys.readouterr().out
        jstore = tmp_path / "jax"
        jcol.TraceStore(str(jstore), 1 << 20, 2).append(
            {"version": 1, "kind": "flight_merged", "ranks": {}})
        assert main([str(jstore)]) == 1


class TestWatchdogFlightFoldIn:
    def test_dump_includes_diagnosis_config_and_occupancy(self, wd):
        queue = type("Q", (), {"_q": []})()
        report = watchdog.dump_state(queue, [], [], reason="test")
        assert "summary" in report["flight_diagnosis"]
        cfg = report["config"]
        assert "quant" in cfg and "tuner" in cfg and "ft" in cfg
        assert isinstance(report["transports"], list)
        line = json.loads(wd.read_text().splitlines()[-1])
        assert "config" in line and "flight_diagnosis" in line

    def test_mailbox_occupancy_counts_backlog(self):
        from ucc_tpu_torch.tl.host.transport import InProcTransport
        tr = InProcTransport(use_native=False)
        try:
            tr.send_nb(tr, (("t", 1, 2), 0, 1, 0, 0), np.zeros(4))
            assert tr.occupancy()["unexpected"] == 1
            tr.recv_nb((("t", 1, 2), 0, 2, 0, 0), np.zeros(4))
            assert tr.occupancy()["posted"] == 1
        finally:
            tr.close()

    def test_backlog_gauges_in_stats_snapshot(self, stats):
        n = 2
        job = FtJob(n)
        try:
            teams = job.create_team()
            srcs = [np.full(4, 1.0) for _ in range(n)]
            dsts = [np.zeros(4) for _ in range(n)]
            job.run_coll(teams, _allreduce_args(srcs, dsts, 4))
            snap = metrics.snapshot()
            for g in ("progress_queue_depth", "mailbox_unexpected",
                      "mailbox_posted_recvs"):
                assert g in snap["gauges"], g
        finally:
            job.cleanup()


class TestStragglerScorer:
    def _scorer(self, **kw):
        kw.setdefault("decay", 0.5)
        kw.setdefault("flag_on", 0.7)
        kw.setdefault("flag_off", 0.2)
        kw.setdefault("windows", 2)
        return diagnose.StragglerScorer(**kw)

    def test_one_window_spike_never_flags(self):
        sc = self._scorer()
        assert sc.update({1: 1.0}, ranks=range(4)) == frozenset()
        assert sc.update({2: 1.0}, ranks=range(4)) == frozenset()

    def test_streak_plus_threshold_flags(self):
        sc = self._scorer()
        for _ in range(4):
            flagged = sc.update({1: 1.0}, ranks=range(4))
        assert flagged == frozenset({1}) and sc.scores[1] >= sc.flag_on

    def test_hysteresis_band_unflags_low(self):
        sc = self._scorer()
        for _ in range(4):
            sc.update({1: 1.0}, ranks=range(4))
        sc.update({2: 0.4}, ranks=range(4))
        assert 1 in sc.flagged
        for _ in range(8):
            flagged = sc.update({2: 0.4}, ranks=range(4))
        assert 1 not in flagged and sc.scores[1] <= sc.flag_off

    def test_uninformative_windows_keep_streaks(self):
        sc = self._scorer()
        flagged = frozenset()
        for _ in range(8):
            flagged = sc.update({1: 1.0}, ranks=range(4))
            if 1 in flagged:
                break
            flagged = sc.update({}, ranks=range(4))
            if 1 in flagged:
                break
        assert 1 in flagged

    def test_uninformative_window_decays_into_unflag(self):
        sc = self._scorer()
        for _ in range(4):
            sc.update({1: 1.0}, ranks=range(4))
        for _ in range(40):
            sc.update({}, ranks=range(4))
        assert 1 not in sc.flagged

    def test_scores_match_jax_package(self):
        """The same seeded severity stream through both scorers: equal
        scores and flags after every window."""
        from ucc_tpu.obs import diagnose as jax_diagnose
        g = np.random.default_rng(3)
        a = self._scorer()
        b = jax_diagnose.StragglerScorer(decay=0.5, flag_on=0.7,
                                         flag_off=0.2, windows=2)
        for _ in range(30):
            sev = {int(r): float(v) for r, v in
                   zip(g.integers(0, 6, 2), g.uniform(0, 1.5, 2))
                   if g.uniform() < 0.7}
            assert a.update(sev, ranks=range(6)) == \
                b.update(sev, ranks=range(6))
            assert a.scores == b.scores


class TestBootstrapSpans:
    def test_context_and_team_spans_on_ring(self, capsys):
        job = FtJob(2)
        try:
            job.create_team()
            spans = []
            for r in range(2):
                snap = job.contexts[r].flight.snapshot()
                spans.extend(e for e in snap["events"]
                             if e.get("coll") == "bootstrap")
            stages = {e.get("stage") for e in spans}
            assert "boot:ctx_addr_exchange" in stages
            assert stages - {"boot:ctx_addr_exchange"}, stages
            assert all(e["dur_s"] >= 0.0 for e in spans)
            from ucc_tpu_torch.tools.fr import print_report
            merged = flight.collect_process(job.contexts[0], "test")
            print_report(merged, diagnose.diagnose(merged))
            out = capsys.readouterr().out
            assert "bootstrap spans" in out
            assert "boot:ctx_addr_exchange" in out
        finally:
            job.cleanup()


class TestMidCollectionDeath:
    def test_fresh_death_evidence_returns_partial_promptly(self):
        """A rank that dies after the collection started is folded in as
        fresh evidence: the survivors return a partial dump naming it
        long before the collection deadline."""
        from ucc_tpu_torch.fault import inject as fault
        n = 4
        job = FtJob(n)
        try:
            teams = job.create_team()
            srcs = [np.full(8, r + 1.0) for r in range(n)]
            dsts = [np.zeros(8) for _ in range(n)]
            job.run_coll(teams, _allreduce_args(srcs, dsts, 8))
            reqs = [flight.collect_team_post(teams[r], reason="middeath",
                                             timeout=60.0)
                    for r in range(3)]
            fault.configure("kill=3", seed=0)
            try:
                t0 = time.monotonic()
                while not all([reqs[r].test() != Status.IN_PROGRESS
                               for r in range(3)]):
                    for c in job.contexts[:3]:
                        c.progress()
                    assert time.monotonic() < t0 + 30.0
                elapsed = time.monotonic() - t0
            finally:
                fault.reset()
            assert elapsed < 20.0
            merged = reqs[0].result
            assert merged.get("partial") and 3 in merged["absent_ranks"]
            assert merged.get("mid_collection_dead") == [3]
        finally:
            job.cleanup()
