"""The port's measured selection (score/tuner.py, the TUNER_SYNC state of
core/team.py, the probe lane of core/coll.py, tools/tune.py and perftest
--sweep/--quant) on the CPU: the counterparts of tests/test_tuner.py's
four classes and of tests/test_quant.py's TestQuantTunerIntegration, run
against the port, and cross-package cases that hold the port's tuner
against the JAX package's: the same compiled entries from the same
records, the same size buckets, the same rotation order and frozen winner
for the same candidates, the same signature under the TL name map. Every
cache lives under tmp_path (UCC_TUNER_CACHE), never under ~."""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import ucc_tpu
import ucc_tpu_torch as ut
from ucc_tpu.score import tuner as jt
from ucc_tpu.score.score import MsgRange as JMsgRange
from ucc_tpu_torch.constants import CollType, DataType, MemoryType
from ucc_tpu_torch.score import tuner as pt
from ucc_tpu_torch.score.score import MsgRange as PMsgRange
from ucc_tpu_torch.score.tuner import (bucket_range, cache_entries,
                                       compile_measurements, load_cache,
                                       size_bucket, store_entries,
                                       topo_signature)
from ucc_tpu_torch.utils.config import SIZE_INF

COUNT = 8192                       # 32 KiB f32: the bandwidth-alg regime
NBYTES = COUNT * 4


#: the settings no test may inherit or leave behind
_AMBIENT = ("UCC_TUNER", "UCC_TUNER_SAMPLES", "UCC_QUANT", "UCC_TL_SHM_TUNE",
            "UCC_TL_TORCH_OPS_TUNE", "UCC_TL_RING_CUDA_TUNE")


def _unset(monkeypatch):
    """Each ambient variable recorded as unset (set, then deleted), so
    that the undo removes what a test's CLI sets (ucc_tune --quant sets
    UCC_QUANT). A bare delenv of an absent variable records nothing, and
    a later delenv of the CLI's value makes the undo put that value back,
    leaking it into every later test of the process and into the
    processes they spawn."""
    for var in _AMBIENT:
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    # device TLs on the CPU; no ambient tuner, quant or TUNE settings; a
    # fresh in-process session cache around each test
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    _unset(monkeypatch)
    monkeypatch.setenv("UCC_TUNER_CACHE", str(tmp_path / "ambient.json"))
    pt.session_reset()
    jt.session_reset()
    yield
    pt.session_reset()
    jt.session_reset()


class PortJob:
    """n ranks of the port in this process (the port's counterpart of the
    reference's harness.UccJob): a lib with `lib_overrides` and a context
    each over a thread OOB, one team over all of them."""

    def __init__(self, n, lib_overrides=None):
        self.n = n
        world = ut.ThreadOobWorld(n)
        libs = [ut.init(**(lib_overrides or {})) for _ in range(n)]
        self.contexts = [None] * n

        def mk(r):
            self.contexts[r] = ut.Context(
                libs[r], ut.ContextParams(oob=world.endpoint(r)))
        ths = [threading.Thread(target=mk, args=(r,)) for r in range(n)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        self.teams = []

    def create_team(self):
        world = ut.ThreadOobWorld(self.n)
        teams = [c.create_team_post(ut.TeamParams(oob=world.endpoint(r)))
                 for r, c in enumerate(self.contexts)]
        self.progress_until(lambda: all(
            [t.create_test() != ut.Status.IN_PROGRESS for t in teams]))
        assert all(t.create_test() == ut.Status.OK for t in teams)
        self.teams.append(teams)
        return teams

    def progress_until(self, cond, timeout=30.0):
        deadline = time.monotonic() + timeout
        while not cond():
            for c in self.contexts:
                c.progress()
            if time.monotonic() > deadline:
                raise TimeoutError("progress timed out")

    def cleanup(self):
        for teams in self.teams:
            for t in teams:
                t.destroy()
        for c in self.contexts:
            c.destroy()


def _persistent_allreduce(teams, srcs, dsts, mem=MemoryType.HOST):
    argses = [ut.CollArgs(coll_type=CollType.ALLREDUCE,
                          op=ut.ReductionOp.SUM,
                          src=ut.BufferInfo(srcs[r], COUNT, DataType.FLOAT32,
                                            mem_type=mem),
                          dst=ut.BufferInfo(dsts[r], COUNT, DataType.FLOAT32,
                                            mem_type=mem),
                          flags=ut.CollArgsFlags.PERSISTENT)
              for r in range(len(teams))]
    return [teams[r].collective_init(argses[r]) for r in range(len(teams))]


def _drive(job, reqs, rounds, dsts, n):
    for _ in range(rounds):
        for rq in reqs:
            rq.post()
        job.progress_until(lambda: all(
            [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]))
        for rq in reqs:
            assert rq.test() == ut.Status.OK, rq.test()
        # exploration never trades correctness: a real allreduce of ones
        for d in dsts:
            assert abs(float(d[0]) - n) < 1e-6


def _bufs(n):
    return ([torch.ones(COUNT) for _ in range(n)],
            [torch.zeros(COUNT) for _ in range(n)])


# ---------------------------------------------------------------------------
# unit level (tests/test_tuner.py::TestUnits)
# ---------------------------------------------------------------------------

class TestUnits:
    def test_size_buckets(self):
        assert size_bucket(0) == 0
        assert bucket_range(0) == (0, 1)
        for msg in (1, 7, 4096, 32768, (1 << 20) + 3):
            lo, hi = bucket_range(size_bucket(msg))
            assert lo <= msg < hi

    def test_compile_measurements_merges_adjacent_winners(self):
        recs = []
        for size, winner in ((1024, "a"), (2048, "a"), (4096, "b")):
            for alg in ("a", "b"):
                recs.append({"coll": "allreduce", "mem": "host",
                             "alg": alg, "comp": "shm", "size_bytes": size,
                             "p50_us": 1.0 if alg == winner else 9.0})
        assert compile_measurements(recs) == [
            {"coll": "allreduce", "mem": "host", "start": 0, "end": 4096,
             "alg": "a", "comp": "shm"},
            {"coll": "allreduce", "mem": "host", "start": 4096,
             "end": SIZE_INF, "alg": "b", "comp": "shm"},
        ]

    def test_compile_skips_malformed_records(self):
        entries = compile_measurements([
            {"coll": "allreduce"},
            {"size_bytes": 8, "alg": "x", "p50_us": 1},
            {"coll": "bcast", "mem": "host", "alg": "kn",
             "size_bytes": 64, "avg_us": 2.0},
        ])
        assert len(entries) == 1 and entries[0]["coll"] == "bcast"

    def test_cache_roundtrip_and_merge(self, tmp_path):
        path = str(tmp_path / "tune.json")
        e1 = {"coll": "allreduce", "mem": "host", "start": 0, "end": 4096,
              "alg": "a"}
        store_entries(path, "sigA", [e1])
        e2 = dict(e1, alg="b")
        e3 = {"coll": "allreduce", "mem": "host", "start": 4096,
              "end": 8192, "alg": "c"}
        store_entries(path, "sigA", [e2, e3], source="online")
        store_entries(path, "sigB", [e1])
        cache = load_cache(path)
        assert [e["alg"] for e in cache_entries(cache, "sigA")] == ["b", "c"]
        assert cache_entries(cache, "sigB")[0]["alg"] == "a"
        assert cache_entries(cache, "nope") == []

    def test_load_cache_tolerates_garbage(self, tmp_path):
        p = tmp_path / "bad.json"
        p.write_text("{not json")
        assert load_cache(str(p)) == {}
        assert load_cache(str(tmp_path / "missing.json")) == {}

    def test_default_cache_is_the_ports_own(self):
        assert pt.resolve_cache_path() == \
            os.path.expanduser("~/.cache/ucc_tpu_torch/tune.json")
        assert pt.resolve_cache_path() != jt.resolve_cache_path()
        assert pt.CACHE_VERSION == jt.CACHE_VERSION


# ---------------------------------------------------------------------------
# cross-package: entries, buckets, rotation, winner, signature
# ---------------------------------------------------------------------------

def _sweep_like_records(seed):
    rng = np.random.default_rng(seed)
    recs = []
    for coll in ("allreduce", "allgather", "bcast"):
        for mem in ("host", "cuda"):
            for size in (8, 64, 1024, 4096, 65536, 1 << 20):
                for alg, prec in (("knomial", ""), ("ring", ""),
                                  ("qint8_sra", "int8"), ("xla", "")):
                    r = {"coll": coll, "mem": mem, "size_bytes": size,
                         "alg": alg, "comp": "shm" if mem == "host"
                         else "torch_ops",
                         "p50_us": float(rng.integers(1, 6))}
                    if prec:
                        r["precision"] = prec
                    if rng.random() < 0.1:
                        r["gen"] = "ring(chunks=2)"
                    if rng.random() < 0.1:
                        r.pop("p50_us")
                        r["avg_us"] = float(rng.integers(1, 6))
                    recs.append(r)
    return recs


@pytest.mark.parametrize("seed", range(4))
def test_compile_measurements_gives_the_references_entries(seed):
    recs = _sweep_like_records(seed)
    assert compile_measurements(recs) == jt.compile_measurements(recs)


def test_buckets_agree_at_every_power_of_two():
    for b in range(31):
        for msg in (max(0, (1 << b) - 1), 1 << b, (1 << b) + 1):
            assert size_bucket(msg) == jt.size_bucket(msg)
            assert bucket_range(size_bucket(msg)) == \
                jt.bucket_range(jt.size_bucket(msg))
    assert size_bucket(1 << 30) == jt.size_bucket(1 << 30) == 31


class _FakeScoreMap:
    def __init__(self):
        self.learned = []

    def apply_learned(self, coll, mem, start, end, alg, comp=None):
        self.learned.append((start, end, alg, comp))
        return True

    def lookup(self, *a):
        return []


class _FakeTeam:
    """A 1-rank stand-in: no service team, so the decision is local."""

    def __init__(self):
        self.size, self.rank, self.id = 4, 0, 0
        self.service_team = None
        self.score_map = _FakeScoreMap()


class _Comp:
    def __init__(self, name):
        self.NAME = name


def _cands(cls, spec):
    return [cls(0, SIZE_INF, score, (lambda ia, t: None), _Comp(comp), alg)
            for comp, alg, score in spec]


@pytest.mark.parametrize("samples", (2, 4, 8))
def test_rotation_and_winner_agree(samples):
    spec = (("shm", "sra_knomial", 45), ("shm", "ring", 44),
            ("shm", "dbt", 43), ("socket", "knomial", 10))
    rng = np.random.default_rng(samples)
    times = {a: float(rng.random()) for _, a, _ in spec}
    out = {}
    for mod, cls in ((pt, PMsgRange), (jt, JMsgRange)):
        team = _FakeTeam()
        tuner = mod.OnlineTuner(team, samples, "", "sig", [])
        cands = _cands(cls, spec)
        key = (CollType.ALLREDUCE, MemoryType.HOST, size_bucket(NBYTES))
        order = []
        for _ in range(samples + 1):
            walk = tuner.explore_order(key, cands)
            label = mod.cand_label(walk[0])
            order.append(label)
            tuner.record(key, label, times[label[1]], None)
        out[mod.__name__] = (order, tuner.poll(key), team.score_map.learned)
    assert out[pt.__name__] == out[jt.__name__]
    order, (frozen, winner), _ = out[pt.__name__]
    sampled = {label[1] for label in order[:samples]}
    assert frozen and winner[1] == min(sampled, key=times.get)


def test_signature_matches_under_the_tl_name_map():
    """The same format, size, layout and thread mode; the TL sets differ
    by the device TLs' names alone (torch_ops/ring_cuda for xla/ring_dma)."""
    names = {"torch_ops": "xla", "ring_cuda": "ring_dma"}
    port = PortJob(2, {"TLS": "shm,self,torch_ops,ring_cuda"})
    ref = None
    try:
        psig = topo_signature(port.create_team()[0])
        from harness import UccJob
        ref = UccJob(2, lib_overrides={"TLS": "shm,self,xla,ring_dma"})
        jsig = jt.topo_signature(ref.create_team()[0])
    finally:
        port.cleanup()
        if ref is not None:
            ref.cleanup()

    def split(sig):
        parts = dict(p.split("=", 1) if "=" in p else (p, "")
                     for p in sig.split("|"))
        tls = sorted(names.get(t, t) for t in parts.pop("tls").split(","))
        return parts, tls
    assert split(psig) == split(jsig)
    assert psig.startswith("v1|n2|nodes1|ppn2|tls=")


# ---------------------------------------------------------------------------
# online mode (tests/test_tuner.py::TestOnline)
# ---------------------------------------------------------------------------

SAMPLES = 8
# SAMPLES exploration posts, the decision post (the first hold post), the
# hold window (service-bcast depth + 2 = 3 at 4 ranks), the switch post
FREEZE_ROUNDS = SAMPLES + 1 + 3 + 1


class TestOnline:
    def test_converges_freezes_and_agrees(self, tmp_path):
        cache = str(tmp_path / "tune.json")
        job = PortJob(4, {"TUNER": "online", "TUNER_SAMPLES": str(SAMPLES),
                          "TUNER_CACHE": cache})
        try:
            teams = job.create_team()
            assert all(t.tuner is not None for t in teams)
            sigs = {topo_signature(t) for t in teams}
            assert len(sigs) == 1
            srcs, dsts = _bufs(4)
            reqs = _persistent_allreduce(teams, srcs, dsts)
            assert all("post" in rq.__dict__ for rq in reqs)
            _drive(job, reqs, FREEZE_ROUNDS + 1, dsts, 4)
            assert all("post" not in rq.__dict__ for rq in reqs)
            assert all(not t.tuner.exploring(
                t.tuner.key_for(CollType.ALLREDUCE, MemoryType.HOST,
                                NBYTES)) for t in teams)
            algs = {rq.task.alg_name for rq in reqs}
            assert len(algs) == 1, algs
            tops = {(t.score_map.lookup(CollType.ALLREDUCE, MemoryType.HOST,
                                        NBYTES)[0].alg_name,
                     t.score_map.lookup(CollType.ALLREDUCE, MemoryType.HOST,
                                        NBYTES)[0].origin)
                    for t in teams}
            assert len(tops) == 1 and next(iter(tops))[1] == "learned"
            _drive(job, reqs, 3, dsts, 4)
            assert {rq.task.alg_name for rq in reqs} == algs
            entries = cache_entries(load_cache(cache), next(iter(sigs)))
            lo, hi = bucket_range(size_bucket(NBYTES))
            assert any(e["coll"] == "allreduce" and e["start"] == lo and
                       e["end"] == hi for e in entries)
            for rq in reqs:
                rq.finalize()
        finally:
            job.cleanup()

    def test_device_memory_freezes_on_the_same_winner(self, tmp_path):
        """The lane on CUDA memory (the CPU device here): tl/torch_ops and
        tl/ring_cuda rotate, completion is the launch handle's, and every
        rank freezes one winner; re-posts after the freeze take the
        persistent fast lane when the winner has one."""
        cache = str(tmp_path / "tune.json")
        job = PortJob(4, {"TUNER": "online", "TUNER_SAMPLES": "4",
                          "TUNER_CACHE": cache})
        try:
            teams = job.create_team()
            srcs, dsts = _bufs(4)
            reqs = _persistent_allreduce(teams, srcs, dsts, MemoryType.CUDA)
            seen = set()
            for _ in range(4 + 1 + 3 + 1 + 3):
                _drive(job, reqs, 1, dsts, 4)
                seen.add(reqs[0].task.alg_name)
            assert len(seen) > 1                     # it explored
            assert all("post" not in rq.__dict__ for rq in reqs)
            assert len({rq.task.alg_name for rq in reqs}) == 1
            for rq in reqs:
                rq.finalize()
        finally:
            job.cleanup()

    def test_cache_reload_starts_tuned_with_zero_exploration(self,
                                                             tmp_path):
        cache = str(tmp_path / "tune.json")
        overrides = {"TUNER": "online", "TUNER_SAMPLES": str(SAMPLES),
                     "TUNER_CACHE": cache}
        job = PortJob(4, overrides)
        try:
            teams = job.create_team()
            srcs, dsts = _bufs(4)
            reqs = _persistent_allreduce(teams, srcs, dsts)
            _drive(job, reqs, FREEZE_ROUNDS + 1, dsts, 4)
            winner = reqs[0].task.alg_name
            for rq in reqs:
                rq.finalize()
        finally:
            job.cleanup()
        pt.session_reset()                 # the file alone must carry it
        job2 = PortJob(4, overrides)
        try:
            teams2 = job2.create_team()
            top = teams2[0].score_map.lookup(CollType.ALLREDUCE,
                                             MemoryType.HOST, NBYTES)[0]
            assert top.origin == "learned" and top.alg_name == winner
            srcs, dsts = _bufs(4)
            reqs = _persistent_allreduce(teams2, srcs, dsts)
            assert all("post" not in rq.__dict__ for rq in reqs)
            assert all(rq.task.alg_name == winner for rq in reqs)
            _drive(job2, reqs, 2, dsts, 4)
            assert all(not t.tuner._keys for t in teams2)
            for rq in reqs:
                rq.finalize()
        finally:
            job2.cleanup()

    def test_overlapped_posts_freeze_to_static_defaults(self, tmp_path):
        cache = str(tmp_path / "tune.json")
        job = PortJob(2, {"TUNER": "online", "TUNER_SAMPLES": "4",
                          "TUNER_CACHE": cache})
        try:
            teams = job.create_team()
            srcs = [torch.ones(COUNT) for _ in range(2)]
            d1 = [torch.zeros(COUNT) for _ in range(2)]
            d2 = [torch.zeros(COUNT) for _ in range(2)]
            r1 = _persistent_allreduce(teams, srcs, d1)
            r2 = _persistent_allreduce(teams, srcs, d2)
            assert all("post" in rq.__dict__ for rq in r1 + r2)
            for rq in r1:
                rq.post()
            for rq in r2:
                rq.post()
            job.progress_until(lambda: all(
                [rq.test() != ut.Status.IN_PROGRESS for rq in r1 + r2]))
            for rq in r1 + r2:
                assert rq.test() == ut.Status.OK
            for d in d1 + d2:
                assert abs(float(d[0]) - 2) < 1e-6
            key = teams[0].tuner.key_for(CollType.ALLREDUCE,
                                         MemoryType.HOST, NBYTES)
            for t in teams:
                st = t.tuner._keys[key]
                assert st.frozen and st.winner is None
            top = teams[0].score_map.lookup(CollType.ALLREDUCE,
                                            MemoryType.HOST, NBYTES)[0]
            assert top.origin == "default"
            for _ in range(2):
                for rq in r1:
                    rq.post()
                job.progress_until(lambda: all(
                    [rq.test() != ut.Status.IN_PROGRESS for rq in r1]))
            assert all("post" not in rq.__dict__ for rq in r1 + r2)
            assert len({rq.task.alg_name for rq in r1}) == 1
            for rq in r1 + r2:
                rq.finalize()
        finally:
            job.cleanup()

    def test_single_rank_team_activates_and_runs(self, tmp_path):
        cache = str(tmp_path / "tune.json")
        job = PortJob(1, {"TUNER": "online", "TUNER_SAMPLES": "2",
                          "TUNER_CACHE": cache})
        try:
            teams = job.create_team()
            srcs, dsts = _bufs(1)
            reqs = _persistent_allreduce(teams, srcs, dsts)
            _drive(job, reqs, 3, dsts, 1)
            for rq in reqs:
                rq.finalize()
        finally:
            job.cleanup()


# ---------------------------------------------------------------------------
# off and offline modes (tests/test_tuner.py::TestOffModes)
# ---------------------------------------------------------------------------

class TestOffModes:
    def test_off_leaves_dispatch_unbound(self):
        job = PortJob(2)
        try:
            teams = job.create_team()
            assert all(t.tuner is None for t in teams)
            srcs, dsts = _bufs(2)
            reqs = _persistent_allreduce(teams, srcs, dsts)
            assert all("post" not in rq.__dict__ for rq in reqs)
            assert all(rq._tuner is None for rq in reqs)
            _drive(job, reqs, 2, dsts, 2)
            for rq in reqs:
                rq.finalize()
        finally:
            job.cleanup()

    def test_offline_applies_cache_without_exploring(self, tmp_path):
        cache = str(tmp_path / "tune.json")
        probe = PortJob(2)
        try:
            sig = topo_signature(probe.create_team()[0])
        finally:
            probe.cleanup()
        store_entries(cache, sig, [
            {"coll": "allreduce", "mem": "host", "start": 0,
             "end": SIZE_INF, "alg": "ring", "comp": "shm"},
            {"coll": "allreduce", "mem": "cuda", "start": 0,
             "end": SIZE_INF, "alg": "ring_cuda", "comp": "ring_cuda"}])
        job = PortJob(2, {"TUNER": "offline", "TUNER_CACHE": cache})
        try:
            teams = job.create_team()
            assert all(t.tuner is None for t in teams)
            for t in teams:
                top = t.score_map.lookup(CollType.ALLREDUCE,
                                         MemoryType.HOST, NBYTES)[0]
                assert (top.alg_name, top.origin) == ("ring", "learned")
                top = t.score_map.lookup(CollType.ALLREDUCE,
                                         MemoryType.CUDA, NBYTES)[0]
                assert (top.alg_name, top.origin) == ("ring_cuda",
                                                      "learned")
            srcs, dsts = _bufs(2)
            reqs = _persistent_allreduce(teams, srcs, dsts)
            assert all(rq.task.alg_name == "ring" for rq in reqs)
            _drive(job, reqs, 2, dsts, 2)
            for rq in reqs:
                rq.finalize()
        finally:
            job.cleanup()

    def test_mismatched_signature_is_ignored(self, tmp_path):
        cache = str(tmp_path / "tune.json")
        store_entries(cache, "v1|n999|some-other-shape", [
            {"coll": "allreduce", "mem": "host", "start": 0,
             "end": SIZE_INF, "alg": "ring", "comp": "shm"}])
        job = PortJob(2, {"TUNER": "offline", "TUNER_CACHE": cache})
        try:
            teams = job.create_team()
            top = teams[0].score_map.lookup(CollType.ALLREDUCE,
                                            MemoryType.HOST, NBYTES)[0]
            assert top.origin == "default"
        finally:
            job.cleanup()

    def test_the_references_cache_is_never_read(self, tmp_path,
                                                monkeypatch):
        """The port's default path is its own: a file at the JAX
        package's default path is not the port's cache."""
        monkeypatch.setenv("HOME", str(tmp_path))
        monkeypatch.delenv("UCC_TUNER_CACHE")
        ref_path = jt.resolve_cache_path()
        assert ref_path.startswith(str(tmp_path))
        probe = PortJob(2)
        try:
            sig = topo_signature(probe.create_team()[0])
        finally:
            probe.cleanup()
        store_entries(ref_path, sig, [
            {"coll": "allreduce", "mem": "host", "start": 0,
             "end": SIZE_INF, "alg": "ring", "comp": "shm"}])
        job = PortJob(2, {"TUNER": "offline"})
        try:
            teams = job.create_team()
            top = teams[0].score_map.lookup(CollType.ALLREDUCE,
                                            MemoryType.HOST, NBYTES)[0]
            assert top.origin == "default"
        finally:
            job.cleanup()


# ---------------------------------------------------------------------------
# quantized candidates under the tuner
# (tests/test_quant.py::TestQuantTunerIntegration)
# ---------------------------------------------------------------------------

class TestQuantTunerIntegration:
    def test_compile_measurements_carries_precision(self):
        recs = [
            {"coll": "allreduce", "mem": "host", "size_bytes": 65536,
             "alg": "qint8_sra", "comp": "shm", "p50_us": 10.0,
             "precision": "int8"},
            {"coll": "allreduce", "mem": "host", "size_bytes": 65536,
             "alg": "sra_knomial", "comp": "shm", "p50_us": 20.0},
        ]
        entries = compile_measurements(recs)
        assert entries == jt.compile_measurements(recs)
        assert len(entries) == 1
        assert entries[0]["alg"] == "qint8_sra"
        assert entries[0]["precision"] == "int8"

    @pytest.mark.parametrize("mem,alg", (("HOST", "qint8_sra"),
                                         ("CUDA", "qint8")))
    def test_learned_quant_range_shows_precision_tag(self, mem, alg):
        job = PortJob(2, {"QUANT": "int8"})
        try:
            teams = job.create_team()
            sm = teams[0].score_map
            assert sm.apply_learned(CollType.ALLREDUCE, MemoryType[mem],
                                    1 << 16, 1 << 20, alg)
            assert "(learned,int8)" in sm.print_info("t")
            cands = sm.lookup(CollType.ALLREDUCE, MemoryType[mem], 1 << 18)
            assert cands[0].alg_name == alg
            assert cands[0].origin == "learned"
            assert cands[0].precision == "int8"
        finally:
            job.cleanup()


# ---------------------------------------------------------------------------
# ucc_tune (tests/test_tuner.py::TestOfflineCli) and perftest --sweep
# ---------------------------------------------------------------------------

class TestOfflineCli:
    @pytest.mark.parametrize("mem", ("host", "cuda"))
    def test_sweep_writes_cache_and_from_compiles(self, tmp_path, mem,
                                                  capsys):
        from ucc_tpu_torch.tools.tune import main as tune_main
        cache = str(tmp_path / "cache.json")
        meas = str(tmp_path / "sweep.jsonl")
        assert tune_main(["-p", "2", "-m", mem, "-c", "allreduce", "-b",
                          "1k", "-e", "2k", "-n", "2", "-w", "0", "-o",
                          cache, "--measurements", meas]) == 0
        data = load_cache(cache)
        sigs = list(data.get("signatures") or {})
        assert len(sigs) == 1 and sigs[0].startswith("v1|n2|")
        entries = cache_entries(data, sigs[0])
        assert entries and entries[0]["coll"] == "allreduce"
        assert {e["mem"] for e in entries} == {mem}
        records = [json.loads(ln) for ln in open(meas)]
        assert all(r["bench"] == "sweep" for r in records)
        want = {"knomial", "ring"} if mem == "host" else \
            {"xla", "ring", "ring_cuda"}
        assert {r["alg"] for r in records} >= want
        # the records compile as the reference compiles them
        assert compile_measurements(records) == \
            jt.compile_measurements(records)
        cache2 = str(tmp_path / "cache2.json")
        assert tune_main(["--from", meas, "--signature", sigs[0], "-o",
                          cache2]) == 0
        assert cache_entries(load_cache(cache2), sigs[0]) == entries
        assert "grid winners" in capsys.readouterr().out

    def test_quant_sweep_records_carry_precision(self, tmp_path,
                                                 monkeypatch):
        from ucc_tpu_torch.tools.tune import main as tune_main
        meas = str(tmp_path / "sweep.jsonl")
        assert tune_main(["-p", "2", "-m", "host", "-c", "allreduce",
                          "-b", "128K", "-e", "128K", "-n", "1", "-w", "0",
                          "--quant", "int8", "--dry-run",
                          "--measurements", meas]) == 0
        monkeypatch.delenv("UCC_QUANT")          # --quant set it
        recs = [json.loads(ln) for ln in open(meas)]
        q = [r for r in recs if r["alg"].startswith("qint8")]
        assert {r["alg"] for r in q} == {"qint8_sra", "qint8_ring"}
        assert all(r["precision"] == "int8" for r in q)

    def test_from_probes_the_files_team_size(self, tmp_path, capsys):
        from ucc_tpu_torch.tools.tune import main as tune_main
        meas = tmp_path / "sweep.jsonl"
        recs = [{"bench": "sweep", "coll": "allreduce", "mem": "host",
                 "ranks": 3, "comp": "shm", "alg": a, "size_bytes": 64,
                 "p50_us": p} for a, p in (("knomial", 1.0), ("ring", 2.0))]
        meas.write_text("".join(json.dumps(r) + "\n" for r in recs))
        assert tune_main(["--from", str(meas), "--dry-run"]) == 0
        out = capsys.readouterr().out
        assert "3-rank" in out and '"v1|n3|' in out

    def test_gate_smoke_round_trips_the_cache(self, capsys):
        from ucc_tpu_torch.tools.tune import main as tune_main
        assert tune_main(["--gate-smoke", "-n", "3"]) == 0
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["metric"] == "tuner_gate_smoke"
        assert rec["learned_selection"] is True
        assert rec["default_us"] > 0 and rec["tuned_us"] > 0

    def test_gen_search_is_refused_clearly(self, capsys):
        """--gen-search runs now (tests/test_torch_search.py); what it
        still refuses, it refuses by name: an unknown collective."""
        from ucc_tpu_torch.tools.tune import main as tune_main
        with pytest.raises(SystemExit) as ei:
            tune_main(["--gen-search", "-c", "nosuch"])
        assert ei.value.code not in (0, None)
        assert "unknown collective 'nosuch'" in capsys.readouterr().err

    def test_perftest_sweep_feeds_ucc_tune(self, tmp_path, capsys):
        from ucc_tpu_torch.tools import perftest
        from ucc_tpu_torch.tools.tune import main as tune_main
        assert perftest.main(["-c", "allgather", "-m", "cuda", "-p", "2",
                              "-b", "64", "-e", "128", "-n", "2", "-w", "1",
                              "--sweep"]) == 0
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]
        recs = [json.loads(ln) for ln in lines]
        assert {r["size_bytes"] for r in recs} == {64, 128}
        assert {r["alg"] for r in recs} >= {"xla", "ring_cuda"}
        assert all(r["mem"] == "cuda" and r["ranks"] == 2 for r in recs)
        meas = tmp_path / "sweep.jsonl"
        meas.write_text("\n".join(lines) + "\n")
        assert tune_main(["--from", str(meas), "-p", "2", "-o",
                          str(tmp_path / "c.json")]) == 0
        data = load_cache(str(tmp_path / "c.json"))
        (sig,) = data["signatures"]
        assert {e["coll"] for e in cache_entries(data, sig)} == \
            {"allgather"}



def test_no_cli_setting_outlives_the_tests_that_made_it(tmp_path):
    """The isolation of this file, around ucc_tune --quant as
    TestOfflineCli runs it: once its monkeypatch is undone, no UCC_QUANT
    is left in the process environment (where a later test's spawned
    workers would inherit it: the JAX package's socket sweep then ran
    quantized allreduces)."""
    import os
    from ucc_tpu_torch.tools.tune import main as tune_main
    mp = pytest.MonkeyPatch()
    _unset(mp)
    try:
        assert tune_main(["-p", "2", "-m", "host", "-c", "allreduce",
                          "-b", "128K", "-e", "128K", "-n", "1", "-w", "0",
                          "--quant", "int8", "--dry-run", "--measurements",
                          str(tmp_path / "m.jsonl")]) == 0
        assert os.environ.get("UCC_QUANT") == "int8"
        mp.delenv("UCC_QUANT")
    finally:
        mp.undo()
    assert [v for v in _AMBIENT if v in os.environ] == []
