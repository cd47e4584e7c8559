"""The port's tl/ipc and its arena (``native.IpcArena``, the port's copy
of the native arena in ``native_src/ucc_tpu_torch_ipc.cc``) across real
processes, held against the JAX package.

- Two processes on one named arena force each match kind (direct,
  eager, rndv, fenced) by ordering their steps with a barrier.
- A 2-process x 2-rank job over ``TcpStoreOob`` under ``UCC_TLS=ipc,self``
  runs a matrix of collectives, bitwise the JAX package's tl/shm on the
  same inputs; the arena's shared counters show the traffic went through
  it. A CUDA-memory allreduce on that team (the device TLs on the
  ``cpu`` device) runs on tl/torch_ops across the two processes and is
  bitwise the library reduction of the four ranks' inputs.
- ``UCC_TL_IPC_ENABLE=y`` attaches the arena within one process, against
  the JAX package doing the same.
- A message above the arena's largest block class raises, as in the JAX
  package; segments carry the port's own prefix, the reaper unlinks a
  dead job's segment and never touches a JAX-package segment.
"""
import multiprocessing as mp
import os
import sys
import time

import numpy as np
import pytest

import ucc_tpu
import ucc_tpu_torch as ut
import torch_procs as tp
from ucc_tpu_torch.tools.perftest import HeldPorts
from torch_host_jobs import Job, assert_same, env, run_cases

pytestmark = pytest.mark.skipif(
    sys.platform != "linux", reason="POSIX shared-memory arenas")


def _native():
    from ucc_tpu_torch import native
    if native.get_lib() is None:
        pytest.skip(f"native core unavailable: {native.build_error()}")
    return native


def _shm_names(prefix):
    return sorted(f for f in os.listdir("/dev/shm") if f.startswith(prefix))


# ---------------------------------------------------------------------------
# the arena across a process boundary
# ---------------------------------------------------------------------------

def test_arena_match_orders_across_processes():
    native = _native()
    name = f"{native.ARENA_PREFIX}probe-{os.getpid()}"
    bar = mp.get_context("spawn").Barrier(2)
    spec = {"name": name, "barrier": bar}
    try:
        res = tp.run_procs(tp.arena_probe_worker, [spec, spec], timeout=120)
    finally:
        try:
            os.unlink("/dev/shm/" + name)
        except OSError:
            pass
    for r in res:
        assert "error" not in r, r.get("error")
        assert not r["jax"]
    snd, rcv = res
    assert snd["pid"] != rcv["pid"]
    assert snd["kinds"] == {"recv_first": "direct", "send_first_small": "eager",
                            "send_first_big": "rndv", "stale_epoch": "fenced"}
    assert snd["rndv_pending"], "rndv send completed before the recv"
    assert rcv["recv_first_ok"] and rcv["send_first_small_ok"] and \
        rcv["send_first_big_ok"]
    ctr = snd["counters"]
    assert ctr["n_direct"] >= 1 and ctr["n_eager"] >= 1
    assert ctr["n_rndv"] >= 1 and ctr["n_fenced"] >= 1
    assert ctr["attaches"] >= 2
    assert ctr["bytes_moved"] >= 512 + 512 + (64 << 10)
    assert snd["peer_pid"] == rcv["pid"] and rcv["peer_pid"] == snd["pid"]
    assert snd["peer_beat_ms"] is not None
    # the counter names and the size classes are the JAX package's
    from ucc_tpu import native as jnative
    assert ut.native.ARENA_COUNTER_NAMES == jnative.ARENA_COUNTER_NAMES
    assert snd["max_msg"] == 8 << 20       # the top block class


# ---------------------------------------------------------------------------
# the collective matrix over 2 processes x 2 ranks
# ---------------------------------------------------------------------------

MATRIX = [
    {"coll": "ALLREDUCE", "dt": "FLOAT32", "c": 1024, "op": "SUM"},
    {"coll": "ALLREDUCE", "dt": "FLOAT32", "c": 65536, "op": "SUM"},
    {"coll": "ALLREDUCE", "dt": "INT32", "c": 333, "op": "MAX"},
    {"coll": "ALLREDUCE", "dt": "BFLOAT16", "c": 1031, "op": "SUM"},
    {"coll": "BCAST", "dt": "FLOAT64", "c": 64, "root": 1},
    {"coll": "BCAST", "dt": "FLOAT32", "c": 40000, "root": 3},
    {"coll": "ALLGATHER", "dt": "FLOAT32", "c": 16},
    {"coll": "ALLGATHERV", "dt": "INT32", "c": 5},
    {"coll": "REDUCE_SCATTER", "dt": "FLOAT32", "c": 4, "op": "SUM"},
    {"coll": "REDUCE", "dt": "FLOAT64", "c": 999, "op": "SUM", "root": 2},
    {"coll": "ALLTOALL", "dt": "INT32", "c": 2},
    {"coll": "ALLTOALLV", "dt": "FLOAT32", "c": 6},
    {"coll": "GATHER", "dt": "INT32", "c": 3, "root": 0},
    {"coll": "SCATTERV", "dt": "FLOAT32", "c": 3, "root": 1},
    {"coll": "ALLREDUCE", "dt": "FLOAT32", "c": 512, "op": "SUM",
     "inplace": True, "rounds": 2},
    {"coll": "BARRIER"},
]


@pytest.fixture(scope="module")
def ref4():
    with env(UCC_GEN_NATIVE="n", UCC_QUANT=None, UCC_GEN=None,
             UCC_TL_SHM_TUNE=None, UCC_TL_SOCKET_BIND_HOST="127.0.0.1"):
        job = Job(ucc_tpu, 4)
        yield job
        job.destroy()


def test_ipc_two_process_matrix(ref4):
    _native()
    n = 4
    cases = [dict(c, seed=40 + i) for i, c in enumerate(MATRIX)]
    cuda = {"coll": "ALLREDUCE", "dt": "FLOAT32", "c": 64, "op": "SUM",
            "mem": "CUDA"}
    phases = [{"cases": cases}, {"cases": [cuda]}]
    before = _shm_names(ut.native.ARENA_PREFIX)
    with HeldPorts(3) as held:
        specs = [{"n": n, "ranks": ranks, "ports": held.ports,
                  "env": {"UCC_TLS": "ipc,self,ring_cuda,torch_ops",
                          "UCC_TL_RING_CUDA_DEVICE": "cpu"},
                  "phases": phases}
                 for ranks in ([0, 1], [2, 3])]
        res = tp.run_procs(tp.job_worker, specs, timeout=150)
    ph = tp.collect(res, n)
    got = [[tuple(ph[0][r]["cases"][i]) for r in range(n)]
           for i in range(len(cases))]
    assert_same(got, run_cases(ref4, cases, n), cases)
    assert {ph[0][r]["tier"] for r in range(n)} == {"ipc"}
    assert {ph[0][r]["svc"] for r in range(n)} == {"ipc"}
    assert len({tuple(ph[0][r]["ids"]) for r in range(n)}) == 1
    # the arena's counters are shared: traffic crossed it
    for x in res:
        ctr = x["arena"]
        assert ctr["n_direct"] > 0 and ctr["attaches"] >= 4
        assert ctr["bytes_moved"] > 0
    # CUDA memory on a team across processes: tl/torch_ops's xla on every
    # rank, bitwise the library reduction of the four ranks' inputs
    assert [ph[1][r]["cases"][0][:2] for r in range(n)] == \
        [("OK", "xla")] * n
    from ucc_tpu_torch.tl.torch_ops import allreduce_ops
    srcs, _, _ = tp.case_buffers(cuda, n, tp.port_buf)
    want = tp.bits(allreduce_ops(srcs, ut.ReductionOp.SUM))
    assert [ph[1][r]["cases"][0][2] for r in range(n)] == [want] * n
    # the creator unlinked the segment (the workers' reaper may also
    # have unlinked a dead run's)
    assert set(_shm_names(ut.native.ARENA_PREFIX)) <= set(before)


# ---------------------------------------------------------------------------
# the arena within one process (UCC_TL_IPC_ENABLE=y)
# ---------------------------------------------------------------------------

def _ipc_job(mod, n):
    with env(UCC_TL_IPC_ENABLE="y", UCC_TL_SOCKET_BIND_HOST="127.0.0.1"):
        return Job(mod, n, tls="ipc,self", tune_var="UCC_TL_IPC_TUNE")


@pytest.fixture(scope="module")
def ipc_jobs():
    _native()
    with env(UCC_GEN_NATIVE="n", UCC_QUANT=None, UCC_GEN=None,
             UCC_TL_IPC_TUNE=None):
        jobs = {"ref": _ipc_job(ucc_tpu, 3), "port": _ipc_job(ut, 3)}
        yield jobs
        for j in jobs.values():
            j.destroy()


@pytest.mark.parametrize("tune", ["", "allreduce:@ring:inf",
                                  "allreduce:@sra_knomial:inf",
                                  "alltoall:@bruck:inf"])
def test_forced_in_process_arena_matches_the_reference(ipc_jobs, tune):
    cases = [dict(c, seed=60 + i) for i, c in enumerate(MATRIX)
             if c.get("root", 0) < 3]
    got = run_cases(ipc_jobs["port"], cases, 3, tune)
    want = run_cases(ipc_jobs["ref"], cases, 3, tune)
    assert_same(got, want, cases)
    team = ipc_jobs["port"].team(3, tune)
    from ucc_tpu_torch.tools.perftest import transport_tier
    assert transport_tier(team[0]) == "ipc"
    assert team[0].service_team.TL_CLS.NAME == "ipc"
    for c in ipc_jobs["port"].contexts:
        name = c.tl_contexts["ipc"].obj.arena.name
        assert name.lstrip("/").startswith("ucc-torch-ipc-")


def test_candidate_lists_and_print_info_match(ipc_jobs):
    """HOST candidate lists and print_info rows of an ipc team equal the
    reference's (the arena is the only host TL of both jobs)."""
    p = ipc_jobs["port"].team(3)[0].score_map
    j = ipc_jobs["ref"].team(3)[0].score_map
    assert p.print_info("t").replace("ucc_tpu_torch score map", "") == \
        j.print_info("t").replace("ucc_tpu score map", "")
    for coll in ut.CollType:
        for size in (0, 4095, 4097, 1 << 20):
            w = [(r.alg_name, r.score) for r in j.lookup(
                ucc_tpu.CollType[coll.name], ucc_tpu.MemoryType.HOST, size)]
            g = [(r.alg_name, r.score) for r in p.lookup(
                coll, ut.MemoryType.HOST, size)]
            assert g == w, (coll, size)


def test_message_above_the_class_cap_raises(ipc_jobs):
    """One message above the arena's largest class raises at push and at
    post_recv, in both packages, with the same cap; a collective that
    sends one fails (no hang, no split)."""
    ar = ipc_jobs["port"].contexts[0].tl_contexts["ipc"].obj.arena
    jar = ipc_jobs["ref"].contexts[0].tl_contexts["ipc"].obj.arena
    assert ar.max_msg == jar.max_msg == 8 << 20
    big = np.zeros(ar.max_msg + 1, np.uint8)
    for a in (ar, jar):
        with pytest.raises(ValueError, match="class cap"):
            a.push(("cap", 0, 1, 0, 0), 1, big)
        with pytest.raises(ValueError, match="class cap"):
            a.post_recv(("cap", 0, 1, 0, 1), 0, big)
    case = {"coll": "BCAST", "dt": "UINT8", "c": (8 << 20) + 64, "root": 0,
            "seed": 3}
    t0 = time.monotonic()
    got = run_cases(ipc_jobs["port"], [case], 3, "bcast:@knomial:inf")
    want = run_cases(ipc_jobs["ref"], [case], 3, "bcast:@knomial:inf")
    assert time.monotonic() - t0 < 60
    assert [g[0] for g in got[0]] == [w[0] for w in want[0]]
    assert all(g[0].startswith("ERR") for g in got[0] if g[0] != "OK")
    assert any(g[0] != "OK" for g in got[0])


# ---------------------------------------------------------------------------
# segments: the port's prefix, the reaper
# ---------------------------------------------------------------------------

def test_the_prefix_is_the_ports_own():
    from ucc_tpu import native as jnative
    assert ut.native.ARENA_PREFIX == "ucc-torch-ipc-"
    assert not ut.native.ARENA_PREFIX.startswith(jnative.ARENA_PREFIX)
    assert not jnative.ARENA_PREFIX.startswith(ut.native.ARENA_PREFIX)


def test_reaper_unlinks_a_dead_jobs_segment_and_no_jax_segment(
        monkeypatch):
    native = _native()
    mine = f"{native.ARENA_PREFIX}leak-{os.getpid()}"
    res = tp.run_procs(tp.arena_leak_worker, [{"name": mine}], timeout=60)
    assert "error" not in res[0], res[0].get("error")
    assert not res[0]["jax"]
    # a JAX-package segment name (a plain file the port's reaper must not
    # even open; fresh, so the JAX package's own reaper, which may run in
    # a concurrent test, leaves it too) and a long-abandoned half-made one
    # of the port's
    theirs = f"/dev/shm/ucc-ipc-untouched-{os.getpid()}"
    stale = f"/dev/shm/{native.ARENA_PREFIX}halfmade-{os.getpid()}"
    for path in (theirs, stale):
        with open(path, "wb") as fh:
            fh.write(b"\0" * 64)
    old = time.time() - 3600
    os.utime(stale, (old, old))
    # every file looks long abandoned to the port's reaper: only its
    # prefix filter can spare the JAX package's
    monkeypatch.setattr(native.os.path, "getmtime", lambda path: old)
    try:
        assert os.path.exists("/dev/shm/" + mine)
        deadline = time.monotonic() + 10
        while native._pid_alive(res[0]["pid"]) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        reaped = native.reap_stale_arenas()
        assert mine in reaped
        assert os.path.basename(stale) in reaped
        assert not os.path.exists("/dev/shm/" + mine)
        assert os.path.exists(theirs)
        assert all(r.startswith(native.ARENA_PREFIX) for r in reaped)
    finally:
        for path in (theirs, stale, "/dev/shm/" + mine):
            try:
                os.unlink(path)
            except OSError:
                pass


def test_a_live_segment_is_not_reaped(ipc_jobs):
    native = _native()
    name = ipc_jobs["port"].contexts[0].tl_contexts["ipc"].obj.arena.name
    assert name.lstrip("/") not in native.reap_stale_arenas()
    assert os.path.exists("/dev/shm" + name)


def test_enable_n_and_thread_jobs_create_no_segment():
    """Without UCC_TL_IPC_ENABLE a job of threads attaches no arena (tl/shm
    serves it); with n the TL is off."""
    before = _shm_names(ut.native.ARENA_PREFIX)
    for val in (None, "n"):
        with env(UCC_TL_IPC_ENABLE=val):
            job = Job(ut, 2, tls="shm,ipc,self")
        try:
            assert all(c.tl_contexts["ipc"].obj.arena is None
                       for c in job.contexts)
            teams = job.team(2)
            assert teams[0].service_team.TL_CLS.NAME == "shm"
        finally:
            job.destroy()
    assert set(_shm_names(ut.native.ARENA_PREFIX)) <= set(before)


# ---------------------------------------------------------------------------
# perftest across processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra,tls,tier", [
    ([], None, "ipc"),
    ([], "socket,self", "socket"),
    (["-O", "-c", "alltoall"], "socket,self", "socket"),
    (["-O", "-c", "alltoall"], None, "ipc")])
def test_perftest_procs(extra, tls, tier):
    """``perftest --procs 2``: two processes of the tool over a TCP store,
    rank 0's JSON records name the tier."""
    import json
    import subprocess
    _native()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    penv = dict(os.environ, UCC_TL_RING_CUDA_DEVICE="cpu", PYTHONPATH=repo)
    penv.pop("UCC_TLS", None)
    if tls:
        penv["UCC_TLS"] = tls
    args = ["-c", "allreduce", *extra] if extra else ["-c", "allreduce"]
    out = subprocess.run(
        [sys.executable, "-m", "ucc_tpu_torch.tools.perftest", "--procs",
         "2", "-m", "host", "--json", "-b", "4K", "-e", "16K", "-n", "3",
         "-w", "1", *args], cwd=repo, env=penv, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    recs = [json.loads(x) for x in out.stdout.splitlines()
            if x.startswith("{")]
    assert len(recs) == 3
    assert {r["detail"]["transport"] for r in recs} == {tier}
    assert {r["ranks"] for r in recs} == {2}
