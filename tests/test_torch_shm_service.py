"""The multi-rank service team (tl/shm) and what the core runs over it:
team-id agreement in ALLOC_ID (teams, sub-teams split from a parent, ids
equal to the JAX package's for the same sequence of creates), the
datatype check of rooted collectives under UCC_CHECK_ASYMMETRIC_DT (an
asymmetric datatype ends ERR_INVALID_PARAM on every rank, as in the
reference), CUDA-memory selection that tl/shm leaves as it was, and
``perftest -m host`` through tl/shm."""
import os
import threading
import time

import numpy as np
import pytest
import torch

import ucc_tpu
import ucc_tpu_torch as ut
from ucc_tpu_torch.tl.self import TlSelfTeam
from ucc_tpu_torch.tl.shm import TlShmTeam

from harness import UccJob


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    monkeypatch.setenv("UCC_GEN_NATIVE", "n")
    for k in ("UCC_TLS", "UCC_TL_SHM_TUNE", "UCC_TL_TORCH_OPS_TUNE",
              "UCC_TL_RING_CUDA_TUNE", "UCC_CHECK_ASYMMETRIC_DT"):
        monkeypatch.delenv(k, raising=False)


class TorchJob:
    """n ranks of the port in this process (contexts made in threads)."""

    def __init__(self, n, **lib):
        world = ut.ThreadOobWorld(n)
        libs = [ut.init(**lib) for _ in range(n)]
        self.contexts = [None] * n

        def make(r):
            self.contexts[r] = ut.Context(libs[r], ut.ContextParams(
                oob=world.endpoint(r)))
        ths = [threading.Thread(target=make, args=(r,)) for r in range(n)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        self.teams = []

    def until(self, cond, timeout=30.0):
        deadline = time.monotonic() + timeout
        while not cond():
            for c in self.contexts:
                c.progress()
            assert time.monotonic() < deadline, "progress timed out"

    def create_team(self, ranks=None):
        ranks = list(ranks) if ranks is not None else \
            list(range(len(self.contexts)))
        world = ut.ThreadOobWorld(len(ranks))
        teams = [self.contexts[r].create_team_post(
            ut.TeamParams(oob=world.endpoint(i)))
            for i, r in enumerate(ranks)]
        self.created(teams)
        return teams

    def created(self, teams):
        self.until(lambda: all([t.create_test() != ut.Status.IN_PROGRESS
                                for t in teams]))
        assert [t.create_test() for t in teams] == [ut.Status.OK] * len(teams)
        self.teams.append(teams)

    def cleanup(self):
        for teams in self.teams:
            for t in teams:
                t.destroy()
        for c in self.contexts:
            c.destroy()


def split(parents, ranks):
    subs = [type(p).create_from_parent(p, ranks) for p in parents]
    return [s for s in subs if s is not None]


def _jcreated(job, teams):
    job.progress_until(lambda: all(
        [t.create_test() != ucc_tpu.Status.IN_PROGRESS for t in teams]))
    assert all(t.create_test() == ucc_tpu.Status.OK for t in teams)
    job.teams.append(teams)


def test_service_team_is_tl_self_for_one_rank_and_tl_shm_above():
    job = TorchJob(4)
    try:
        one = job.create_team([2])
        assert isinstance(one[0].service_team, TlSelfTeam)
        four = job.create_team()
        assert all(isinstance(t.service_team, TlShmTeam) for t in four)
        assert all(t.service_team.scope == "svc" for t in four)
        # the service team's tag space is its own
        keys = {t.service_team.team_key for t in four}
        assert len(keys) == 1 and keys.pop()[1] == "svc"
    finally:
        job.cleanup()


def test_no_host_tl_no_service_team():
    """Without tl/shm a multi-rank team has no service team, and ALLOC_ID
    takes the context's counter (the path of the previous slices)."""
    job = TorchJob(2, TLS="ring_cuda,torch_ops,self")
    try:
        teams = job.create_team()
        assert all(t.service_team is None for t in teams)
    finally:
        job.cleanup()


def _torch_sequence(job):
    ids = []
    top = job.create_team()
    ids.append([t.id for t in top])
    lo = split(top, [0, 1, 2, 3])
    job.created(lo)
    hi = split(top, [4, 5, 6, 7])
    job.created(hi)
    ids += [[t.id for t in lo], [t.id for t in hi]]
    pair = split(lo, [0, 2])
    job.created(pair)
    ids.append([t.id for t in pair])
    ids.append([t.id for t in job.create_team([1, 3, 5])])
    ids.append([t.id for t in job.create_team()])
    return ids


def _jax_sequence(job):
    ids = []
    top = job.create_team()
    ids.append([t.id for t in top])
    lo = split(top, [0, 1, 2, 3])
    _jcreated(job, lo)
    hi = split(top, [4, 5, 6, 7])
    _jcreated(job, hi)
    ids += [[t.id for t in lo], [t.id for t in hi]]
    pair = split(lo, [0, 2])
    _jcreated(job, pair)
    ids.append([t.id for t in pair])
    ids.append([t.id for t in job.create_team([1, 3, 5])])
    ids.append([t.id for t in job.create_team()])
    return ids


def test_team_ids_agree_and_equal_the_references():
    """Members of every team (sub-teams [0..3], [4..7] and [0, 2] split
    from a parent, a team over ranks 1, 3, 5) hold one id, agreed by a
    service allreduce(MAX) of the members' counters; the ids equal the
    reference's for the same sequence of creates."""
    jjob = UccJob(8)
    try:
        want = _jax_sequence(jjob)
    finally:
        jjob.cleanup()
    job = TorchJob(8)
    try:
        got = _torch_sequence(job)
    finally:
        job.cleanup()
    assert all(len(set(ids)) == 1 for ids in got), got
    assert got == want


def test_device_team_runs_after_agreed_ids():
    """With ids agreed over tl/shm, the device rendezvous still keys on
    team_key: sub-teams and a later full team run a CUDA-memory allreduce
    (device "cpu") in step."""
    job = TorchJob(4)
    try:
        top = job.create_team()
        lo = split(top, [0, 1])
        hi = split(top, [2, 3])
        job.created(lo + hi)
        again = job.create_team()
        for teams in (lo, hi, again):
            n = len(teams)
            srcs = [torch.full((64,), float(r + 1)) for r in range(n)]
            dsts = [torch.zeros(64) for _ in range(n)]
            reqs = [t.collective_init(ut.CollArgs(
                coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
                src=ut.BufferInfo(s, 64, ut.DataType.FLOAT32,
                                  mem_type=ut.MemoryType.CUDA),
                dst=ut.BufferInfo(d, 64, ut.DataType.FLOAT32,
                                  mem_type=ut.MemoryType.CUDA)))
                for t, s, d in zip(teams, srcs, dsts)]
            for rq in reqs:
                rq.post()
            job.until(lambda: all([rq.test() != ut.Status.IN_PROGRESS
                                   for rq in reqs]))
            assert all(rq.test() == ut.Status.OK for rq in reqs)
            want = float(sum(range(1, n + 1)))
            assert all(torch.equal(d, torch.full((64,), want)) for d in dsts)
    finally:
        job.cleanup()


# ---------------------------------------------------------------------------
# the datatype check of rooted collectives
# ---------------------------------------------------------------------------

def _bcast_args(mod, r, n, odd_rank, mem, count=16, check_root=2):
    dt = mod.DataType.INT32 if r == odd_rank else mod.DataType.FLOAT32
    if mod is ut:
        buf = torch.zeros(count, dtype=torch.int32 if r == odd_rank
                          else torch.float32)
        mt = ut.MemoryType.CUDA if mem == "cuda" else ut.MemoryType.HOST
    else:
        buf = np.zeros(count, np.int32 if r == odd_rank else np.float32)
        mt = None
    return mod.CollArgs(coll_type=mod.CollType.BCAST, root=check_root,
                        src=mod.BufferInfo(buf, count, dt, mem_type=mt))


def _run(reqs, until):
    for rq in reqs:
        rq.post()
    until(lambda: all([rq.test() != type(reqs[0].test()).IN_PROGRESS
                       for rq in reqs]))
    return [rq.test() for rq in reqs]


@pytest.mark.parametrize("odd_rank", [None, 0, 3])
def test_asymmetric_dtype_is_refused_on_every_rank(monkeypatch, odd_rank):
    """UCC_CHECK_ASYMMETRIC_DT=y: a bcast where one rank passes INT32 and
    the others FLOAT32 ends ERR_INVALID_PARAM on every rank, in both
    packages (host memory), and on the port's CUDA memory (device
    "cpu"), where the device collective is never posted."""
    monkeypatch.setenv("UCC_CHECK_ASYMMETRIC_DT", "y")
    n = 4
    want = "OK" if odd_rank is None else "ERR_INVALID_PARAM"
    jjob = UccJob(n)
    try:
        teams = jjob.create_team()
        reqs = [t.collective_init(_bcast_args(ucc_tpu, r, n, odd_rank,
                                              "host"))
                for r, t in enumerate(teams)]
        assert [s.name for s in _run(reqs, jjob.progress_until)] == [want] * n
    finally:
        jjob.cleanup()
    job = TorchJob(n)
    try:
        teams = job.create_team()
        for mem in ("host", "cuda"):
            reqs = [t.collective_init(_bcast_args(ut, r, n, odd_rank, mem))
                    for r, t in enumerate(teams)]
            from ucc_tpu_torch.schedule.schedule import Schedule
            assert all(isinstance(rq.task, Schedule) for rq in reqs)
            inner = [rq.task.tasks[1] for rq in reqs]
            assert [s.name for s in _run(reqs, job.until)] == [want] * n
            if odd_rank is not None:
                # the collective itself was never posted
                assert all(t.start_time == 0.0 and
                           t.super_status == ut.Status.ERR_INVALID_PARAM
                           for t in inner)
            for rq in reqs:
                rq.finalize()
    finally:
        job.cleanup()


def test_dt_check_is_off_by_default_and_skips_unrooted():
    job = TorchJob(2)
    try:
        teams = job.create_team()
        from ucc_tpu_torch.schedule.schedule import Schedule
        for r, t in enumerate(teams):
            rq = t.collective_init(_bcast_args(ut, r, 2, None, "host"))
            assert not isinstance(rq.task, Schedule)
        assert teams[0].context.lib.config.check_asymmetric_dt is False
    finally:
        job.cleanup()
    os.environ["UCC_CHECK_ASYMMETRIC_DT"] = "y"
    try:
        job = TorchJob(2)
        teams = job.create_team()
        from ucc_tpu_torch.schedule.schedule import Schedule
        for t in teams:      # every rank inits (tags stay in step)
            buf = torch.zeros(4)
            rq = t.collective_init(ut.CollArgs(
                coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
                src=ut.BufferInfo(buf, 4, ut.DataType.FLOAT32),
                dst=ut.BufferInfo(buf.clone(), 4, ut.DataType.FLOAT32)))
            assert not isinstance(rq.task, Schedule)
        # the checked bcast is a schedule of [check, bcast] and keeps the
        # bcast's labels
        rqs = [t.collective_init(_bcast_args(ut, r, 2, None, "host",
                                             check_root=0))
               for r, t in enumerate(teams)]
        assert isinstance(rqs[0].task, Schedule)
        assert rqs[0].task.coll_name == "bcast"
        assert _run(rqs, job.until) == [ut.Status.OK] * 2
        job.cleanup()
    finally:
        del os.environ["UCC_CHECK_ASYMMETRIC_DT"]


# ---------------------------------------------------------------------------
# CUDA-memory selection is unchanged by tl/shm
# ---------------------------------------------------------------------------

def _cuda_rows(team):
    return [line for line in team.score_map.print_info("t").splitlines()
            if "/cuda" in line]


@pytest.mark.parametrize("n", [2, 8])
def test_cuda_selection_is_unchanged(n):
    """The CUDA rows of the team's score map, and every CUDA lookup, are
    the same with and without tl/shm loaded; tl/shm adds HOST rows only."""
    with_shm = TorchJob(n)
    without = TorchJob(n, TLS="ring_cuda,torch_ops,self")
    try:
        a = with_shm.create_team()[0]
        b = without.create_team()[0]
        assert _cuda_rows(a) == _cuda_rows(b)
        assert any(line for line in a.score_map.print_info("t").splitlines()
                   if "/host" in line and "shm/" in line)
        for coll in ut.CollType:
            for size in (0, 4096, 1 << 20):
                ga = [(r.alg_name, r.score) for r in a.score_map.lookup(
                    coll, ut.MemoryType.CUDA, size)]
                gb = [(r.alg_name, r.score) for r in b.score_map.lookup(
                    coll, ut.MemoryType.CUDA, size)]
                assert ga == gb
    finally:
        with_shm.cleanup()
        without.cleanup()


# ---------------------------------------------------------------------------
# perftest -m host
# ---------------------------------------------------------------------------

def test_perftest_host_allreduce(capsys):
    from ucc_tpu_torch.tools import perftest as perf
    assert perf.main(["-c", "allreduce", "-m", "host", "-p", "4", "-b",
                      "8", "-e", "64K", "-n", "3", "-w", "1", "--json",
                      "-F"]) == 0
    import json
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert len(recs) == 14
    for r in recs:
        assert r["mem"] == "host" and r["ranks"] == 4
        # tl/shm moves the data; the tier is named as the JAX perftest
        # names it: "socket" once a tl/sockets team (score 10, beside
        # tl/shm's 40) holds a tag space of the team
        assert r["detail"] == {"transport": "socket"}
        assert r["p50_us"] > 0


@pytest.mark.parametrize("coll", ["reduce_scatter", "allgather", "bcast",
                                  "alltoall"])
def test_perftest_host_collectives(capsys, coll):
    from ucc_tpu_torch.tools import perftest as perf
    assert perf.main(["-c", coll, "-m", "host", "-p", "3", "-b", "96",
                      "-e", "96K", "-n", "2", "-w", "1", "--persistent"]) == 0
    out = capsys.readouterr().out
    assert "mem=host ranks=3 transport=socket" in out


@pytest.mark.parametrize("n", [3, 8])
def test_the_other_service_collectives(n):
    """tl/shm's service allgather (byte blobs of any sizes) and bcast, on
    the service team, beside the allreduce the core runs."""
    job = TorchJob(n)
    try:
        teams = job.create_team()
        svc = [t.service_team for t in teams]
        blobs = [bytes([r]) * (r * 37 + 1) for r in range(n)]
        tasks = [s.service_allgather(b) for s, b in zip(svc, blobs)]
        tasks += [s.service_bcast(b"root says hi" if r == n - 1 else None,
                                  root=n - 1) for r, s in enumerate(svc)]
        tasks += [s.service_allreduce(np.array([r, -r], np.int64),
                                      ut.ReductionOp.MAX)
                  for r, s in enumerate(svc)]
        for t in tasks:
            t.post()
        job.until(lambda: all([t.is_completed() for t in tasks]))
        assert all(t.super_status == ut.Status.OK for t in tasks)
        assert all(t.result == blobs for t in tasks[:n])
        assert all(t.result == b"root says hi" for t in tasks[n:2 * n])
        assert all(list(t.result) == [n - 1, 0] for t in tasks[2 * n:])
        for t in tasks:
            t.finalize()
    finally:
        job.cleanup()
