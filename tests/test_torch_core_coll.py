"""The port's core additions against the JAX package's: the runtime
fallback (tests/test_fault.py's TestRuntimeFallback), the gate of
one-sided args (tests/test_aux.py's TestOneSidedGating), the request
counters and profiling spans of a persistent collective, TL coll plugins
(tests/test_coll_plugin.py, with tests/dummy_torch_coll_plugin.py on
tl/torch_ops) and sub-teams (tests/test_regressions.py's TestTeamSplit,
tests/test_oob_tree.py's subset cases). The port's buffers are CPU
tensors of CUDA memory on device "cpu"."""
import importlib
import json
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ucc_tpu  # noqa: E402
from ucc_tpu.core import oob as joob  # noqa: E402
from ucc_tpu.obs import metrics as jmetrics  # noqa: E402
import ucc_tpu_torch as ut  # noqa: E402
from ucc_tpu_torch.core import coll as tcoll  # noqa: E402
from ucc_tpu_torch.core import oob as toob  # noqa: E402
from ucc_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from ucc_tpu_torch.schedule.task import CollTask  # noqa: E402
from ucc_tpu_torch.tl.base import load_coll_plugins  # noqa: E402
from ucc_tpu_torch.utils import profiling as tprof  # noqa: E402
from ucc_tpu_torch.utils.convert import to_numpy  # noqa: E402

from harness import UccJob  # noqa: E402
from torch_stack_cases import (_env, bits, make_jax_job,  # noqa: E402
                               make_torch_job)

CUDA = ut.MemoryType.CUDA
TPU = ucc_tpu.MemoryType.TPU


def tbuf(t, count=None, dt=ut.DataType.FLOAT32, mem=CUDA):
    return ut.BufferInfo(t, t.numel() if count is None else count, dt,
                         mem_type=mem)


def jbuf(job, team, arr, count, tl="xla"):
    """A reference device BufferInfo of `arr` on `team`'s device (None:
    a result the device TL rebinds)."""
    if arr is not None:
        dev = team.context.tl_contexts[tl].obj.device
        arr = jax.device_put(jnp.asarray(arr), dev)
    return ucc_tpu.BufferInfo(arr, count, ucc_tpu.DataType.FLOAT32,
                              mem_type=TPU)


def progress(contexts, cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        for c in contexts:
            c.progress()
        assert time.monotonic() < deadline, "progress timed out"


def hosts_of(n, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(count).astype(np.float32) for _ in range(n)]


@pytest.fixture
def both_metrics():
    saved = [(m, m.ENABLED) for m in (jmetrics, tmetrics)]
    for m in (jmetrics, tmetrics):
        m.reset()
        m.ENABLED = True
    yield jmetrics, tmetrics
    for m, was in saved:
        m.reset()
        m.ENABLED = was


def counters(m):
    return m.snapshot()["counters"]


# ---------------------------------------------------------------------------
# runtime fallback
# ---------------------------------------------------------------------------

def fail_first(reqs, status):
    """Make every rank's chosen task fail at post before committing data."""
    first = []
    for rq in reqs:
        first.append(rq.task.alg_name)
        rq.task.post_fn = lambda st=status: st
        rq.task.data_committed = False
    return first


@pytest.mark.parametrize("pin", ["", "ring"])
def test_precommit_failure_retries_next_candidate(both_metrics, pin):
    """The chosen algorithm fails before any data moves: each request
    swaps to the next candidate invisibly, and the result is the JAX
    job's, whose chosen task fails the same way."""
    n, count = 4, 16
    hosts = hosts_of(n, count, seed=21)
    jm, tm = both_metrics
    job, teams = make_jax_job("allreduce:@ring_dma:inf" if pin else "",
                              tl="ring_dma" if pin else "xla", n=n)
    try:
        argses = [ucc_tpu.CollArgs(
            coll_type=ucc_tpu.CollType.ALLREDUCE,
            op=ucc_tpu.ReductionOp.SUM,
            src=jbuf(job, teams[r], hosts[r], count),
            dst=jbuf(job, teams[r], None, count)) for r in range(n)]
        reqs = [teams[r].collective_init(argses[r]) for r in range(n)]
        assert all(rq._fallback for rq in reqs)
        jfirst = fail_first(reqs, ucc_tpu.Status.ERR_NO_RESOURCE)
        for rq in reqs:
            rq.post()
        job.progress_until(lambda: all(
            [rq.test() != ucc_tpu.Status.IN_PROGRESS for rq in reqs]))
        assert [rq.test() for rq in reqs] == [ucc_tpu.Status.OK] * n
        jnext = [rq.task.alg_name for rq in reqs]
        jres = [np.asarray(a.dst.buffer) for a in argses]
    finally:
        job.cleanup()

    tjob = make_torch_job("allreduce:@ring_cuda:inf" if pin else "", n=n)
    try:
        srcs = [torch.from_numpy(h.copy()) for h in hosts]
        dsts = [torch.full_like(s, 7) for s in srcs]
        reqs = [tjob.teams[r].collective_init(ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
            src=tbuf(srcs[r]), dst=tbuf(dsts[r]))) for r in range(n)]
        assert all(rq._fallback for rq in reqs)
        first = fail_first(reqs, ut.Status.ERR_NO_RESOURCE)
        for rq in reqs:
            rq.post()
        # a list, not a generator: test() performs the fallback re-post,
        # so every rank must be polled each pass
        tjob.progress_until(lambda: all(
            [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]))
        assert [rq.test() for rq in reqs] == [ut.Status.OK] * n
        assert all(rq._fb_used for rq in reqs)
        nxt = [rq.task.alg_name for rq in reqs]
    finally:
        tjob.cleanup()
    tl_name = {"ring_dma": "ring_cuda"}
    assert first == [tl_name.get(a, a) for a in jfirst]
    assert nxt == [tl_name.get(a, a) for a in jnext] and nxt != first
    for r in range(n):
        np.testing.assert_array_equal(bits(to_numpy(dsts[r])),
                                      bits(jres[r]))
    got, want = counters(tm), counters(jm)
    assert got["coll_fallback_runtime"] == {f"core|allreduce|{nxt[0]}": n}
    assert list(want["coll_fallback_runtime"].values()) == [n]


class _HangTask(CollTask):
    def post_fn(self):
        return ut.Status.OK


def _bare_request(task, persistent=False, fallback=True):
    req = tcoll.CollRequest.__new__(tcoll.CollRequest)
    req.task = task
    req._posted = True
    req._persistent = persistent
    req._fallback = (None, [object()]) if fallback else None
    req._fb_used = False
    return req


@pytest.mark.parametrize("committed,status,observed,persistent", [
    (True, "ERR_NO_RESOURCE", False, False),     # data committed
    (False, "ERR_TIMED_OUT", False, False),      # peers were engaged
    (False, "ERR_CANCELED", False, False),
    (False, "ERR_INVALID_PARAM", False, False),  # the caller's args
    (False, "ERR_NO_RESOURCE", True, False),     # an observer saw it fail
    (False, "ERR_NO_RESOURCE", False, True)])    # persistent
def test_failure_that_must_not_retry(committed, status, observed,
                                     persistent):
    t = _HangTask()
    t.data_committed = committed
    if observed:
        t.cb = lambda task, st: None
    req = _bare_request(t, persistent)
    t.post()
    t.complete(ut.Status[status])
    assert not req._try_runtime_fallback()
    assert not req._fb_used


def test_device_tasks_keep_data_committed():
    """A device task never turns data_committed off, so a failed kernel
    launch is never retried on another candidate."""
    job = make_torch_job(n=2)
    try:
        s = [torch.ones(8) for _ in range(2)]
        reqs = [job.teams[r].collective_init(ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
            src=tbuf(s[r]), dst=tbuf(torch.empty(8))))
            for r in range(2)]
        assert all(rq.task.data_committed for rq in reqs)
        for rq in reqs:
            rq.post()
        job.progress_until(lambda: all(
            [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]))
        assert all(rq.task.data_committed for rq in reqs)
    finally:
        job.cleanup()


def test_persistent_request_keeps_no_chain():
    job = make_torch_job(n=2)
    try:
        rq = job.teams[0].collective_init(ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
            src=tbuf(torch.ones(8)), dst=tbuf(torch.empty(8)),
            flags=ut.CollArgsFlags.PERSISTENT))
        assert rq._fallback is None
        other = job.teams[1].collective_init(ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
            src=tbuf(torch.ones(8)), dst=tbuf(torch.empty(8)),
            flags=ut.CollArgsFlags.PERSISTENT))
        for r in (rq, other):
            r.post()
        job.progress_until(lambda: all(
            [r.test() != ut.Status.IN_PROGRESS for r in (rq, other)]))
    finally:
        job.cleanup()


# ---------------------------------------------------------------------------
# one-sided args
# ---------------------------------------------------------------------------

ONESIDED = {
    "global_work_buffer": dict(global_work_buffer=np.zeros(16, np.uint8)),
    "src_memh": dict(src_memh=object()),
    "dst_memh": dict(dst_memh=object()),
    "mem_mapped_flag": dict(flags="MEM_MAPPED_BUFFERS"),
}


def _onesided(pkg, kind):
    kw = dict(ONESIDED[kind])
    if "flags" in kw:
        kw["flags"] = pkg.CollArgsFlags[kw["flags"]]
    return kw


@pytest.mark.parametrize("kind", sorted(ONESIDED))
def test_onesided_refused_on_device_memory(kind):
    job = UccJob(2)
    try:
        teams = job.create_team()
        x = jnp.zeros(4, dtype=jnp.float32)
        with pytest.raises(ucc_tpu.UccError) as jerr:
            teams[0].collective_init(ucc_tpu.CollArgs(
                coll_type=ucc_tpu.CollType.ALLREDUCE,
                op=ucc_tpu.ReductionOp.SUM,
                src=ucc_tpu.BufferInfo(x, 4, ucc_tpu.DataType.FLOAT32,
                                       mem_type=TPU),
                dst=ucc_tpu.BufferInfo(x, 4, ucc_tpu.DataType.FLOAT32,
                                       mem_type=TPU),
                **_onesided(ucc_tpu, kind)))
    finally:
        job.cleanup()
    tjob = make_torch_job(n=2)
    try:
        with pytest.raises(ut.UccError) as terr:
            tjob.teams[0].collective_init(ut.CollArgs(
                coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
                src=tbuf(torch.zeros(4)), dst=tbuf(torch.zeros(4)),
                **_onesided(ut, kind)))
        assert "one-sided" in str(terr.value)
        assert int(terr.value.status) == int(jerr.value.status) == \
            int(ut.Status.ERR_NOT_SUPPORTED)
    finally:
        tjob.cleanup()


def _host_alltoall(pkg, team, count, onesided, src=None):
    src = np.arange(count, dtype=np.float32) if src is None else src
    dst = np.zeros(count, np.float32)
    kw = dict(global_work_buffer=np.zeros(16, np.uint8)) if onesided else {}
    rq = team.collective_init(pkg.CollArgs(
        coll_type=pkg.CollType.ALLTOALL,
        src=pkg.BufferInfo(src.copy(), count, pkg.DataType.FLOAT32),
        dst=pkg.BufferInfo(dst, count, pkg.DataType.FLOAT32), **kw))
    return rq, dst


@pytest.mark.parametrize("count", [4, 0])
def test_onesided_host_memory_passes_through(count):
    """Host memory with one-sided args goes on to the score map, and the
    zero-size stub leaves one-sided collectives alone: on the reference's
    2-rank host team (tl/shm serves them) and on the port's 1-rank team
    (tl/self), as both packages' host paths have them."""
    job = UccJob(2)
    try:
        teams = job.create_team()
        jalgs = {}
        for onesided in (True, False):
            reqs = [_host_alltoall(ucc_tpu, t, count, onesided)[0]
                    for t in teams]
            jalgs[onesided] = reqs[0].task.alg_name
            for rq in reqs:
                rq.post()
            job.progress_until(lambda: all(
                rq.test() != ucc_tpu.Status.IN_PROGRESS for rq in reqs))
            assert all(rq.test() == ucc_tpu.Status.OK for rq in reqs)
    finally:
        job.cleanup()
    with _env(UCC_TL_RING_CUDA_DEVICE="cpu"):
        ctx = ut.Context(ut.init())
    team = ctx.create_team(ut.TeamParams())
    try:
        talgs = {}
        for onesided in (True, False):
            rq, dst = _host_alltoall(ut, team, count, onesided)
            talgs[onesided] = rq.task.alg_name
            rq.post()
            assert rq.wait() == ut.Status.OK
            np.testing.assert_array_equal(dst, np.arange(count,
                                                         dtype=np.float32))
        for algs in (jalgs, talgs):
            assert (algs[False] == "zero_size_stub") == (count == 0)
            assert algs[True] != "zero_size_stub"
        assert talgs[True] == "self"
    finally:
        team.destroy()
        ctx.destroy()


def test_onesided_host_memory_reaches_the_score_map():
    """On a multi-rank team the request gets past the one-sided gate and
    the score map selects a tl/shm algorithm, the one the reference
    selects for the same request (the one-sided rows score 1)."""
    jjob = UccJob(2)
    job = make_torch_job(n=2)
    try:
        jteams = jjob.create_team()
        want = _host_alltoall(ucc_tpu, jteams[0], 4, True)[0]
        rq = _host_alltoall(ut, job.teams[0], 4, True)[0]
        assert rq.task.alg_name == want.task.alg_name
        assert "one-sided" not in rq.task.alg_name
    finally:
        job.cleanup()
        jjob.cleanup()


# ---------------------------------------------------------------------------
# counters and spans of a persistent collective
# ---------------------------------------------------------------------------

ROUNDS = 5


def _jax_persistent_rounds(n, hosts):
    job = UccJob(n)
    try:
        teams = job.create_team()
        count = hosts[0].size
        argses = [ucc_tpu.CollArgs(
            coll_type=ucc_tpu.CollType.ALLREDUCE, op=ucc_tpu.ReductionOp.SUM,
            src=jbuf(job, teams[r], hosts[r], count),
            dst=jbuf(job, teams[r], None, count),
            flags=ucc_tpu.CollArgsFlags.PERSISTENT) for r in range(n)]
        reqs = [teams[r].collective_init(argses[r]) for r in range(n)]
        for _ in range(ROUNDS):
            for rq in reqs:
                rq.post()
            job.progress_until(lambda: all(
                rq.test() == ucc_tpu.Status.OK for rq in reqs))
        return reqs[0].task.alg_name
    finally:
        job.cleanup()


def _torch_persistent_rounds(job, hosts):
    n = job.n
    srcs = [torch.from_numpy(h.copy()) for h in hosts]
    dsts = [torch.full_like(s, 7) for s in srcs]
    reqs = [job.teams[r].collective_init(ut.CollArgs(
        coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
        src=tbuf(srcs[r]), dst=tbuf(dsts[r]),
        flags=ut.CollArgsFlags.PERSISTENT)) for r in range(n)]
    for _ in range(ROUNDS):
        for rq in reqs:
            rq.post()
        job.progress_until(lambda: all(
            [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]))
        assert all(rq.test() == ut.Status.OK for rq in reqs)
    return reqs


def test_persistent_counters_match_the_reference(both_metrics):
    """coll_posted counts every round; the fast re-post lane, armed by the
    probe on the second post, counts every round from the second on —
    in both packages. The lane is still taken with metrics on."""
    n = 2
    hosts = hosts_of(n, 16, seed=4)
    jm, tm = both_metrics
    jalg = _jax_persistent_rounds(n, hosts)
    job = make_torch_job(n=n)
    try:
        reqs = _torch_persistent_rounds(job, hosts)
        alg = reqs[0].task.alg_name
        assert reqs[0]._fast
    finally:
        job.cleanup()
    want, got = counters(jm), counters(tm)
    assert alg == jalg
    key = f"core|allreduce|{alg}"
    for c in (want, got):
        assert c["coll_posted"] == {key: n * ROUNDS}
        assert c["coll_fast_repost"] == {key: n * (ROUNDS - 1)}


def test_profiling_diverts_the_fast_lane(tmp_path, monkeypatch):
    """With profiling on, every round takes the generic path (the request
    span's callback is an observer), and the trace holds one request B
    at init, an E per round, and a task span per round whose id is the
    request's."""
    trace = tmp_path / "trace.json"
    monkeypatch.setenv("UCC_PROFILE_MODE", "log")
    monkeypatch.setenv("UCC_PROFILE_FILE", str(trace))
    importlib.reload(tprof)
    try:
        job = make_torch_job(n=2)
        try:
            reqs = _torch_persistent_rounds(job, hosts_of(2, 16, seed=6))
            assert not reqs[0]._fast or reqs[0].task.cb is not None
            seq = reqs[0].task.seq_num
        finally:
            job.cleanup()
        tprof._fh.flush()
        recs = [json.loads(line) for line in trace.read_text().splitlines()]
    finally:
        monkeypatch.delenv("UCC_PROFILE_MODE")
        monkeypatch.delenv("UCC_PROFILE_FILE")
        if tprof._fh is not None:
            tprof._fh.close()
        importlib.reload(tprof)
    mine = [r for r in recs if r.get("span") == seq]
    req = [r["ph"] for r in mine if r["name"] == "coll_allreduce"]
    task = [r["ph"] for r in mine if r["name"].startswith("task_")]
    assert req == ["B"] + ["E"] * ROUNDS
    assert task == ["B", "E"] * ROUNDS
    assert all(r.get("parent") is None for r in mine)


def test_profiled_requests_pair_up(tmp_path, monkeypatch):
    """Non-persistent requests: one coll_allreduce B/E pair each, with the
    task span of the same id inside it."""
    trace = tmp_path / "trace.json"
    monkeypatch.setenv("UCC_PROFILE_MODE", "log")
    monkeypatch.setenv("UCC_PROFILE_FILE", str(trace))
    importlib.reload(tprof)
    try:
        job = make_torch_job(n=2)
        seqs = []
        try:
            for i in range(4):
                reqs = [job.teams[r].collective_init(ut.CollArgs(
                    coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
                    src=tbuf(torch.ones(8)), dst=tbuf(torch.empty(8))))
                    for r in range(2)]
                seqs.append(reqs[0].task.seq_num)
                for rq in reqs:
                    rq.post()
                job.progress_until(lambda: all(
                    [rq.test() == ut.Status.OK for rq in reqs]))
        finally:
            job.cleanup()
        tprof._fh.flush()
        recs = [json.loads(line) for line in trace.read_text().splitlines()]
    finally:
        monkeypatch.delenv("UCC_PROFILE_MODE")
        monkeypatch.delenv("UCC_PROFILE_FILE")
        if tprof._fh is not None:
            tprof._fh.close()
        importlib.reload(tprof)
    for seq in seqs:
        names = [(r["name"].split("_")[0], r["ph"]) for r in recs
                 if r.get("span") == seq]
        assert names == [("coll", "B"), ("task", "B"), ("task", "E"),
                         ("coll", "E")]
    assert len([r for r in recs if r["name"] == "coll_allreduce"]) == 16


# ---------------------------------------------------------------------------
# coll plugins
# ---------------------------------------------------------------------------

def test_plugin_alg_selectable_via_tune(monkeypatch):
    import dummy_coll_plugin
    import dummy_torch_coll_plugin as plugin
    n, count = 4, 32
    monkeypatch.setenv("UCC_TL_SHM_COLL_PLUGINS", "dummy_coll_plugin")
    monkeypatch.setenv("UCC_TL_SHM_TUNE", "allreduce:@dummy:inf")
    job = UccJob(n)
    try:
        teams = job.create_team()
        jdsts = [np.zeros(count, np.float32) for _ in range(n)]
        job.run_coll(teams, lambda r: ucc_tpu.CollArgs(
            coll_type=ucc_tpu.CollType.ALLREDUCE,
            src=ucc_tpu.BufferInfo(np.full(count, r + 1.0, np.float32),
                                   count, ucc_tpu.DataType.FLOAT32),
            dst=ucc_tpu.BufferInfo(jdsts[r], count,
                                   ucc_tpu.DataType.FLOAT32),
            op=ucc_tpu.ReductionOp.SUM))
        assert dummy_coll_plugin.INIT_CALLS > 0
    finally:
        job.cleanup()
    before = plugin.INIT_CALLS
    tjob = make_torch_job(
        n=n, UCC_TL_TORCH_OPS_COLL_PLUGINS="dummy_torch_coll_plugin",
        UCC_TL_TORCH_OPS_TUNE="allreduce:@dummy:inf")
    try:
        cands = tjob.teams[0].score_map.lookup(ut.CollType.ALLREDUCE, CUDA,
                                               1 << 10)
        assert cands[0].alg_name == "dummy"
        dsts = [torch.zeros(count) for _ in range(n)]
        reqs = [tjob.teams[r].collective_init(ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
            src=tbuf(torch.full((count,), r + 1.0)), dst=tbuf(dsts[r])))
            for r in range(n)]
        assert [rq.task.alg_name for rq in reqs] == ["dummy"] * n
        for rq in reqs:
            rq.post()
        tjob.progress_until(lambda: all(
            [rq.test() == ut.Status.OK for rq in reqs]))
    finally:
        tjob.cleanup()
    assert plugin.INIT_CALLS == before + n
    for r in range(n):
        np.testing.assert_array_equal(to_numpy(dsts[r]), jdsts[r])
        np.testing.assert_array_equal(jdsts[r], 10.0)


def test_plugin_registered_without_tune_keeps_defaults(monkeypatch):
    monkeypatch.setenv("UCC_TL_SHM_COLL_PLUGINS", "dummy_coll_plugin")
    job = UccJob(2)
    try:
        teams = job.create_team()
        jc = teams[0].score_map.lookup(ucc_tpu.CollType.ALLREDUCE,
                                       ucc_tpu.MemoryType.HOST, 64)
        assert jc[0].alg_name != "dummy"
        assert "dummy" in [c.alg_name for c in jc]
    finally:
        job.cleanup()
    plain = make_torch_job(n=2)
    tjob = make_torch_job(
        n=2, UCC_TL_TORCH_OPS_COLL_PLUGINS="dummy_torch_coll_plugin")
    try:
        want = [c.alg_name for c in plain.teams[0].score_map.lookup(
            ut.CollType.ALLREDUCE, CUDA, 64)]
        got = tjob.teams[0].score_map.lookup(ut.CollType.ALLREDUCE, CUDA,
                                             64)
        assert got[0].alg_name == want[0] == "short"
        assert sorted(c.alg_name for c in got) == sorted(want + ["dummy"])
        # without a default_select the plugin's range takes the TL's
        # default score, as in the reference
        assert [c.score for c in got if c.alg_name == "dummy"] == [40]
    finally:
        plain.cleanup()
        tjob.cleanup()


def _team_create_status(n, **env):
    """The team-create statuses of an n-rank job made under `env`."""
    with _env(UCC_TL_RING_CUDA_DEVICE="cpu"):
        world = ut.ThreadOobWorld(n)
        ctxs = [None] * n

        def make(r):
            ctxs[r] = ut.Context(ut.init(),
                                 ut.ContextParams(oob=world.endpoint(r)))
        ts = [threading.Thread(target=make, args=(r,)) for r in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    with _env(**env):
        tworld = ut.ThreadOobWorld(n)
        teams = [c.create_team_post(ut.TeamParams(oob=tworld.endpoint(r)))
                 for r, c in enumerate(ctxs)]
        progress(ctxs, lambda: all([t.create_test() != ut.Status.IN_PROGRESS
                                    for t in teams]))
        sts = [t.create_test() for t in teams]
    for t in teams:
        t.destroy()
    for c in ctxs:
        c.destroy()
    return sts


@pytest.mark.parametrize("tl", ["torch_ops", "ring_cuda", "self"])
def test_broken_plugin_is_a_hard_config_error(monkeypatch, tl):
    var = f"UCC_TL_{tl.upper()}_COLL_PLUGINS"
    monkeypatch.setenv(var, "no_such_module_xyz")
    with pytest.raises(ut.UccError, match="coll plugin") as err:
        load_coll_plugins(tl)
    assert err.value.status == ut.Status.ERR_INVALID_PARAM
    monkeypatch.delenv(var)
    n = 1 if tl == "self" else 2
    sts = _team_create_status(n, **{var: "no_such_module_xyz"})
    assert sts == [ut.Status.ERR_INVALID_PARAM] * n


def test_plugin_that_fails_to_register(monkeypatch):
    import sys
    import types
    mod = types.ModuleType("ucc_test_raising_plugin")

    def ucc_coll_plugin(tl_team):
        raise RuntimeError("no table")
    mod.ucc_coll_plugin = ucc_coll_plugin
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    sts = _team_create_status(
        2, UCC_TL_RING_CUDA_COLL_PLUGINS=mod.__name__)
    assert sts == [ut.Status.ERR_INVALID_PARAM] * 2


# ---------------------------------------------------------------------------
# sub-teams
# ---------------------------------------------------------------------------

def split(parents, ranks, order=None):
    """create_from_parent on every parent rank (in `order`); the members'
    teams in the new team's rank order."""
    subs = {}
    for i in (order or range(len(parents))):
        subs[i] = type(parents[i]).create_from_parent(parents[i], ranks)
    for i, t in subs.items():
        assert (t is None) == (i not in ranks)
    return [subs[r] for r in ranks]


def created(contexts, teams, ok):
    progress(contexts, lambda: all([t.create_test() != ok.IN_PROGRESS
                                    for t in teams]))
    assert all(t.create_test() == ok.OK for t in teams)


def test_create_from_parent_host_and_device():
    """tests/test_regressions.py's TestTeamSplit: ranks [0, 2] of 4 run an
    int32 allreduce (host memory in the reference, device memory on the
    port)."""
    count = 4
    job = UccJob(4)
    try:
        members = split(job.create_team(), [0, 2])
        created(job.contexts, members, ucc_tpu.Status)
        jd = [np.zeros(count, np.int32) for _ in range(2)]
        job.run_coll(members, lambda i: ucc_tpu.CollArgs(
            coll_type=ucc_tpu.CollType.ALLREDUCE, op=ucc_tpu.ReductionOp.SUM,
            src=ucc_tpu.BufferInfo(np.full(count, i + 1, np.int32), count,
                                   ucc_tpu.DataType.INT32),
            dst=ucc_tpu.BufferInfo(jd[i], count, ucc_tpu.DataType.INT32)))
    finally:
        job.cleanup()
    tjob = make_torch_job(n=4)
    try:
        members = split(tjob.teams, [0, 2])
        created(tjob.contexts, members, ut.Status)
        assert [t.size for t in members] == [2, 2]
        assert [t.rank for t in members] == [0, 1]
        d = [torch.zeros(count, dtype=torch.int32) for _ in range(2)]
        reqs = [members[i].collective_init(ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
            src=tbuf(torch.full((count,), i + 1, dtype=torch.int32),
                     dt=ut.DataType.INT32),
            dst=tbuf(d[i], dt=ut.DataType.INT32))) for i in range(2)]
        for rq in reqs:
            rq.post()
        tjob.progress_until(lambda: all(
            [rq.test() == ut.Status.OK for rq in reqs]))
        for i in range(2):
            np.testing.assert_array_equal(to_numpy(d[i]), jd[i])
        for t in members:
            t.destroy()
    finally:
        tjob.cleanup()


def test_create_from_parent_nonmember_skips():
    """tests/test_oob_tree.py: non-members return at once without taking a
    round of the parent's OOB, and the members' create needs nothing of
    them."""
    tjob = make_torch_job(n=4)
    try:
        world = tjob.teams[0].oob.world
        rounds = list(world.next_round)
        members = split(tjob.teams, [0, 2], order=[1, 3, 0, 2])
        assert world.next_round == rounds
        progress([tjob.contexts[0], tjob.contexts[2]], lambda: all(
            [t.create_test() != ut.Status.IN_PROGRESS for t in members]))
        assert [t.create_test() for t in members] == [ut.Status.OK] * 2
        assert members[0].size == 2 and members[1].rank == 1
        for t in members:
            t.destroy()
    finally:
        tjob.cleanup()


def test_create_from_parent_ft_args_not_ported():
    """The fault-tolerant rebuilds (``dead``, ``admit_ctx``) are ported;
    the test's name is historical, from when they were refused with
    ERR_NOT_SUPPORTED. A survivor gets a successor team at the next
    epoch, bootstrapped over the service team's transport, and a dead
    rank gets None."""
    tjob = make_torch_job(n=2)
    try:
        assert ut.Team.create_from_parent(tjob.teams[1], [0],
                                          dead=[1]) is None
        new = ut.Team.create_from_parent(tjob.teams[0], [0], dead=[1])
        assert new.epoch == 1 and new.size == 1
        tjob.progress_until(
            lambda: new.create_test() != ut.Status.IN_PROGRESS)
        assert new.create_test() == ut.Status.OK
        new.destroy()
        grown = ut.Team.create_from_parent(tjob.teams[0], [0],
                                           admit_ctx=[3])
        assert grown.epoch == 1 and grown.size == 2
        grown.destroy()
    finally:
        tjob.cleanup()


def _jax_sub_colls(job, sub, hosts, root):
    """allreduce, bcast from `root` and alltoall on the reference's
    sub-team; each rank's results."""
    n = len(sub)
    count = hosts[0].size
    out = {}
    for coll in ("ALLREDUCE", "BCAST", "ALLTOALL"):
        if coll == "BCAST":
            argses = [ucc_tpu.CollArgs(
                coll_type=ucc_tpu.CollType.BCAST, root=root,
                src=jbuf(job, sub[i], hosts[i], count)) for i in range(n)]
        else:
            argses = [ucc_tpu.CollArgs(
                coll_type=ucc_tpu.CollType[coll], op=ucc_tpu.ReductionOp.SUM,
                src=jbuf(job, sub[i], hosts[i], count),
                dst=jbuf(job, sub[i], None, count)) for i in range(n)]
        reqs = job.run_coll(sub, lambda i: argses[i])
        for rq in reqs:
            rq.finalize()
        out[coll] = [np.asarray((a.src if coll == "BCAST" else a.dst)
                                .buffer) for a in argses]
    return out


def _torch_sub_colls(job, sub, hosts, root):
    n = len(sub)
    out = {}
    for coll in ("ALLREDUCE", "BCAST", "ALLTOALL"):
        srcs = [torch.from_numpy(h.copy()) for h in hosts]
        if coll == "BCAST":
            argses = [ut.CollArgs(coll_type=ut.CollType.BCAST, root=root,
                                  src=tbuf(srcs[i])) for i in range(n)]
            res = srcs
        else:
            res = [torch.full_like(s, 7) for s in srcs]
            argses = [ut.CollArgs(
                coll_type=ut.CollType[coll], op=ut.ReductionOp.SUM,
                src=tbuf(srcs[i]), dst=tbuf(res[i])) for i in range(n)]
        reqs = [sub[i].collective_init(argses[i]) for i in range(n)]
        for rq in reqs:
            rq.post()
        job.progress_until(lambda: all(
            [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]))
        assert [rq.test() for rq in reqs] == [ut.Status.OK] * n
        for rq in reqs:
            rq.finalize()
        out[coll] = [to_numpy(t) for t in res]
    return out


@pytest.mark.parametrize("count", [64, 4096])
def test_device_sub_teams_match_the_reference(count):
    """A 4-rank sub-team of an 8-rank device team, and a 2-rank one split
    from it, run allreduce, bcast and alltoall by the default selection:
    every result is bitwise the reference's sub-team's (tl/xla). Then a
    new team over every context still runs: the team keys stayed in step
    while non-members skipped the subset rounds."""
    hosts = hosts_of(8, count, seed=count)
    job = UccJob(8)
    try:
        top = job.create_team()
        lo, hi = split(top, [0, 1, 2, 3]), None
        created(job.contexts, lo, ucc_tpu.Status)
        hi = split(top, [4, 5, 6, 7])
        created(job.contexts, hi, ucc_tpu.Status)
        pair = split(lo, [0, 2])
        created(job.contexts, pair, ucc_tpu.Status)
        jres = [_jax_sub_colls(job, lo, hosts[:4], 1),
                _jax_sub_colls(job, hi, hosts[4:], 1),
                _jax_sub_colls(job, pair, [hosts[0], hosts[2]], 0)]
        for t in lo + hi + pair:
            t.destroy()
    finally:
        job.cleanup()
    tjob = make_torch_job(n=8)
    try:
        lo = split(tjob.teams, [0, 1, 2, 3])
        hi = split(tjob.teams, [4, 5, 6, 7])
        created(tjob.contexts, lo + hi, ut.Status)
        pair = split(lo, [0, 2])
        created(tjob.contexts, pair, ut.Status)
        got = [_torch_sub_colls(tjob, lo, hosts[:4], 1),
               _torch_sub_colls(tjob, hi, hosts[4:], 1),
               _torch_sub_colls(tjob, pair, [hosts[0], hosts[2]], 0)]
        for g, j in zip(got, jres):
            for coll in g:
                for a, b in zip(g[coll], j[coll]):
                    np.testing.assert_array_equal(bits(a), bits(b),
                                                  err_msg=coll)
        for t in lo + hi + pair:
            t.destroy()
        tworld = ut.ThreadOobWorld(8)
        again = [c.create_team_post(ut.TeamParams(oob=tworld.endpoint(r)))
                 for r, c in enumerate(tjob.contexts)]
        created(tjob.contexts, again, ut.Status)
        res = _torch_sub_colls(tjob, again, hosts, 0)
        want = np.sum(np.stack(hosts), axis=0, dtype=np.float32)
        for a in res["ALLREDUCE"]:
            np.testing.assert_allclose(a, want, rtol=1e-5, atol=1e-5)
        for t in again:
            t.destroy()
    finally:
        tjob.cleanup()


def test_ring_sub_team_runs_the_kernels_at_n4():
    """A 4-rank sub-team pinned to tl/ring_cuda runs the five ring
    collectives (the plain versions on the CPU) and equals the reference's
    tl/ring_dma sub-team bitwise."""
    hosts = hosts_of(8, 64, seed=9)
    tune = "allreduce,reduce_scatter,allgather,bcast,alltoall:@{}:inf"
    job, top = make_jax_job(tune.format("ring_dma"), tl="ring_dma", n=8)
    try:
        with _env(UCC_TL_RING_DMA_TUNE=tune.format("ring_dma")):
            lo = split(top, [0, 1, 2, 3])
            created(job.contexts, lo, ucc_tpu.Status)
        want = {}
        for coll in ("ALLREDUCE", "REDUCE_SCATTER", "ALLGATHER"):
            cin = 64 if coll != "ALLGATHER" else 16
            cout = {"ALLREDUCE": 64, "REDUCE_SCATTER": 16,
                    "ALLGATHER": 64}[coll]
            argses = [ucc_tpu.CollArgs(
                coll_type=ucc_tpu.CollType[coll], op=ucc_tpu.ReductionOp.SUM,
                src=jbuf(job, lo[i], hosts[i][:cin], cin, tl="ring_dma"),
                dst=jbuf(job, lo[i], None, cout, tl="ring_dma"))
                for i in range(4)]
            reqs = job.run_coll(lo, lambda i: argses[i])
            assert reqs[0].task.alg_name == "ring_dma"
            want[coll] = [np.asarray(a.dst.buffer) for a in argses]
        for t in lo:
            t.destroy()
    finally:
        job.cleanup()
    tjob = make_torch_job(tune.format("ring_cuda"), n=8)
    try:
        with _env(UCC_TL_RING_CUDA_TUNE=tune.format("ring_cuda")):
            lo = split(tjob.teams, [0, 1, 2, 3])
            created(tjob.contexts, lo, ut.Status)
        for coll, w in want.items():
            cin = 64 if coll != "ALLGATHER" else 16
            dsts = [torch.full((w[0].size,), 7.0) for _ in range(4)]
            reqs = [lo[i].collective_init(ut.CollArgs(
                coll_type=ut.CollType[coll], op=ut.ReductionOp.SUM,
                src=tbuf(torch.from_numpy(hosts[i][:cin].copy())),
                dst=tbuf(dsts[i]))) for i in range(4)]
            assert reqs[0].task.alg_name == "ring_cuda"
            for rq in reqs:
                rq.post()
            tjob.progress_until(lambda: all(
                [rq.test() == ut.Status.OK for rq in reqs]))
            for d, x in zip(dsts, w):
                np.testing.assert_array_equal(bits(to_numpy(d)), bits(x),
                                              err_msg=coll)
        for t in lo:
            t.destroy()
    finally:
        tjob.cleanup()


# -- SubsetOob (tests/test_oob_tree.py's subset cases) -----------------------

@pytest.mark.parametrize("mod", [joob, toob], ids=["jax", "torch"])
def test_participate_is_noop_on_capable_parent(mod):
    w = mod.ThreadOobWorld(4)
    rq = mod.SubsetOob.participate(w.endpoint(3))
    assert int(rq.test()) == 0 and rq.result == []
    assert w.next_round == [0] * 4


@pytest.mark.parametrize("mod", [joob, toob], ids=["jax", "torch"])
def test_nested_subsets(mod):
    w = mod.ThreadOobWorld(8)
    outer_ranks = [1, 3, 5, 7]
    outers = [mod.SubsetOob(w.endpoint(r), outer_ranks)
              for r in outer_ranks]
    assert all(o.SUBSET_CAPABLE for o in outers)
    inners = [mod.SubsetOob(outers[1], [1, 3]),
              mod.SubsetOob(outers[3], [1, 3])]
    reqs = [i.allgather(f"n{i.oob_ep}".encode()) for i in inners]
    for rq in reqs:
        assert rq.result == [b"n0", b"n1"]
    outer_reqs = [o.allgather(bytes([o.oob_ep])) for o in outers]
    assert [rq.result for rq in outer_reqs] == [[b"\0", b"\1", b"\2",
                                                  b"\3"]] * 4
    assert w.next_round == [0] * 8
    assert not w.sub_rounds


def _legacy(mod, n):
    w = mod.ThreadOobWorld(n)
    eps = w.endpoints()
    for ep in eps:
        ep.SUBSET_CAPABLE = False      # a flat store, as a TCP store is
        ep.subset_allgather = None
    return w, eps


@pytest.mark.parametrize("mod", [joob, toob], ids=["jax", "torch"])
def test_legacy_parent_keeps_full_round_contract(mod):
    w, eps = _legacy(mod, 3)
    sub, sub2 = mod.SubsetOob(eps[1], [1, 2]), mod.SubsetOob(eps[2], [1, 2])
    assert not sub.SUBSET_CAPABLE
    r1, r2 = sub.allgather(b"a"), sub2.allgather(b"b")
    assert int(r1.test()) != 0          # rank 0 has not ridden along
    mod.SubsetOob.participate(eps[0])
    assert r1.result == [b"a", b"b"] == r2.result


def _legacy_split(pkg, ctxs, make_parent_oob):
    """Parents over legacy endpoints, then create_from_parent([0, 2]) on
    every rank; the members' create statuses after 300 passes."""
    parents = [c.create_team_post(pkg.TeamParams(oob=make_parent_oob(r)))
               for r, c in enumerate(ctxs)]
    progress(ctxs, lambda: all([t.create_test() != pkg.Status.IN_PROGRESS
                                for t in parents]))
    members = split(parents, [0, 2])
    for _ in range(300):
        sts = [t.create_test() for t in members]
        for c in ctxs:
            c.progress()
    for t in members + parents:
        t.destroy()
    return sts


def test_split_over_a_legacy_parent_completes():
    """Over an OOB that is not subset-capable, non-members ride along once
    per OOB round of the members' create. The port's create has two such
    rounds (the address exchange and the CL agreement, which the
    reference runs over its service team), so its non-members ride along
    twice."""
    job = UccJob(4)
    try:
        _, eps = _legacy(joob, 4)
        jsts = _legacy_split(ucc_tpu, job.contexts,
                             lambda r: eps[r])
    finally:
        job.cleanup()
    tjob = make_torch_job(n=4)
    try:
        _, teps = _legacy(toob, 4)
        sts = _legacy_split(ut, tjob.contexts, lambda r: teps[r])
    finally:
        tjob.cleanup()
    assert sts == [ut.Status.OK] * 2
    assert jsts == [ucc_tpu.Status.OK] * 2
