"""The port's execution engines and triggered collectives against the JAX
package's: the counterparts of tests/test_aux.py's TestTriggeredPost,
TestEeDeviceCollective, TestTpuStreamEe and TestTriggeredAfterFastLane,
with the port's buffers as CPU tensors of CUDA memory on device "cpu".
Each allreduce result is bitwise the JAX job's, and each rank's sequence
of event_out types is the JAX job's. The port's contexts use
ThreadMode.MULTIPLE where a CPU_THREAD EE progresses them from its own
thread."""
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ucc_tpu  # noqa: E402
from ucc_tpu.constants import EeType as JEeType  # noqa: E402
from ucc_tpu.core.ee import Ee as JEe, UccEvent as JUccEvent  # noqa: E402
import ucc_tpu_torch as ut  # noqa: E402
from ucc_tpu_torch.utils.convert import to_numpy  # noqa: E402

from harness import UccJob  # noqa: E402
from torch_stack_cases import bits, make_jax_job, make_torch_job  # noqa: E402

MULTIPLE = ut.LibParams(thread_mode=ut.ThreadMode.MULTIPLE)


def test_ee_type_values():
    """The port's EeType keeps the reference's values; its CUDA_STREAM is
    the reference's TPU_STREAM (UCC's own UCC_EE_CUDA_STREAM)."""
    assert int(ut.EeType.CUDA_STREAM) == int(JEeType.TPU_STREAM) == 0
    assert int(ut.EeType.CPU_THREAD) == int(JEeType.CPU_THREAD) == 1
    assert int(ut.EeType.LAST) == int(JEeType.LAST) == 2


def drain(ees, want, pump=None, timeout=20.0):
    """Each EE's out events' types, popped until each has `want`."""
    got = [[] for _ in ees]
    deadline = time.monotonic() + timeout
    while any(len(g) < want for g in got):
        for g, ee in zip(got, ees):
            ev = ee.get_event()
            if ev is not None:
                g.append(ev.ev_type)
        if pump is not None:
            pump()
        assert time.monotonic() < deadline, got
    return got


def wait_ok(reqs, pump=None, timeout=20.0):
    deadline = time.monotonic() + timeout
    while True:
        sts = [rq.test() for rq in reqs]
        if all(s != ut.Status.IN_PROGRESS and
               s != ut.Status.OPERATION_INITIALIZED for s in sts):
            break
        if pump is not None:
            pump()
        else:
            time.sleep(0.002)
        assert time.monotonic() < deadline, sts
    assert all(s.name == "OK" for s in sts), sts


def jax_args(job, r, host, persistent=False, tl="xla"):
    dev = job.contexts[r].tl_contexts[tl].obj.device
    count = host.size
    return ucc_tpu.CollArgs(
        coll_type=ucc_tpu.CollType.ALLREDUCE,
        src=ucc_tpu.BufferInfo(jax.device_put(jnp.asarray(host), dev), count,
                               ucc_tpu.DataType.FLOAT32,
                               mem_type=ucc_tpu.MemoryType.TPU),
        dst=ucc_tpu.BufferInfo(None, count, ucc_tpu.DataType.FLOAT32,
                               mem_type=ucc_tpu.MemoryType.TPU),
        op=ucc_tpu.ReductionOp.SUM,
        flags=ucc_tpu.CollArgsFlags.PERSISTENT if persistent
        else ucc_tpu.CollArgsFlags(0))


def torch_args(src, dst, persistent=False):
    count = src.numel()
    return ut.CollArgs(
        coll_type=ut.CollType.ALLREDUCE,
        src=ut.BufferInfo(src, count, ut.DataType.FLOAT32,
                          mem_type=ut.MemoryType.CUDA),
        dst=ut.BufferInfo(dst, count, ut.DataType.FLOAT32,
                          mem_type=ut.MemoryType.CUDA),
        op=ut.ReductionOp.SUM,
        flags=ut.CollArgsFlags.PERSISTENT if persistent
        else ut.CollArgsFlags(0))


def hosts_of(n, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(count).astype(np.float32) for _ in range(n)]


# ---------------------------------------------------------------------------
# CPU_THREAD: TestTriggeredPost (host memory there) and
# TestEeDeviceCollective (device memory)
# ---------------------------------------------------------------------------

def jax_cpu_thread(n, hosts, device, tl):
    """The reference's case; with `tl` ring_dma (tl/ring_cuda's
    counterpart) pinned by its TUNE."""
    job, teams = make_jax_job("allreduce:@ring_dma:inf" if tl == "ring_dma"
                              else "", tl=tl, n=n)
    try:
        if device:
            argses = [jax_args(job, r, hosts[r], tl=tl) for r in range(n)]
        else:
            dsts = [np.zeros_like(h) for h in hosts]
            argses = [ucc_tpu.CollArgs(
                coll_type=ucc_tpu.CollType.ALLREDUCE,
                src=ucc_tpu.BufferInfo(hosts[r].copy(), hosts[r].size,
                                       ucc_tpu.DataType.FLOAT32),
                dst=ucc_tpu.BufferInfo(dsts[r], hosts[r].size,
                                       ucc_tpu.DataType.FLOAT32),
                op=ucc_tpu.ReductionOp.SUM) for r in range(n)]
        reqs = [teams[r].collective_init(argses[r]) for r in range(n)]
        ees = [JEe(teams[r], JEeType.CPU_THREAD) for r in range(n)]
        try:
            evs = [JUccEvent() for _ in range(n)]
            for r in range(n):
                ees[r].triggered_post(evs[r], reqs[r])
            time.sleep(0.05)
            held = [rq.test().name for rq in reqs]
            for ev in evs:
                ev.set()
            wait_ok(reqs)
            types = drain(ees, 2)
        finally:
            for ee in ees:
                ee.destroy()
        return held, [np.asarray(a.dst.buffer) for a in argses], types
    finally:
        job.cleanup()


def torch_cpu_thread(n, hosts, tune):
    job = make_torch_job(tune, n=n, lib_params=MULTIPLE)
    try:
        srcs = [torch.from_numpy(h.copy()) for h in hosts]
        dsts = [torch.full_like(s, 7) for s in srcs]
        reqs = [job.teams[r].collective_init(torch_args(srcs[r], dsts[r]))
                for r in range(n)]
        ees = [ut.Ee(job.teams[r], ut.EeType.CPU_THREAD) for r in range(n)]
        try:
            evs = [ut.UccEvent() for _ in range(n)]
            for r in range(n):
                ees[r].triggered_post(evs[r], reqs[r])
            time.sleep(0.05)
            held = [rq.test().name for rq in reqs]
            for ev in evs:
                ev.set()
            wait_ok(reqs)
            types = drain(ees, 2)
        finally:
            for ee in ees:
                ee.destroy()
        return held, [to_numpy(d) for d in dsts], types, \
            reqs[0].task.alg_name
    finally:
        job.cleanup()


@pytest.mark.parametrize("n,device,tune,alg", [
    (2, False, "", "short"),
    (4, True, "", "short"),
    (4, True, "allreduce:@ring_cuda:inf", "ring_cuda")])
def test_cpu_thread_ee(n, device, tune, alg):
    hosts = hosts_of(n, 16, seed=n)
    jheld, jres, jtypes = jax_cpu_thread(
        n, hosts, device, "ring_dma" if alg == "ring_cuda" else "xla")
    held, res, types, chosen = torch_cpu_thread(n, hosts, tune)
    assert chosen == alg
    assert held == jheld == ["OPERATION_INITIALIZED"] * n
    for r in range(n):
        np.testing.assert_array_equal(bits(res[r]), bits(jres[r]))
    assert types == jtypes == [["collective_post",
                                "collective_complete"]] * n


def test_cpu_thread_rendezvous_launches_once(monkeypatch):
    """The device TL's rendezvous launches once when the last rank's
    trigger fires from an EE thread."""
    from ucc_tpu_torch.tl.device import DeviceTeamShared
    calls = []
    real = DeviceTeamShared._launch

    def counted(self, slot):
        calls.append(sorted(slot))
        return real(self, slot)
    monkeypatch.setattr(DeviceTeamShared, "_launch", counted)
    n = 4
    hosts = hosts_of(n, 64, seed=3)
    _, res, _, alg = torch_cpu_thread(n, hosts, "allreduce:@ring_cuda:inf")
    assert alg == "ring_cuda" and calls == [[0, 1, 2, 3]]
    want = np.sum(np.stack(hosts), axis=0, dtype=np.float32)
    for d in res:
        np.testing.assert_allclose(d, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# CUDA_STREAM (the reference's TPU_STREAM): TestTpuStreamEe
# ---------------------------------------------------------------------------

def test_stream_ee_data_readiness():
    n, count = 2, 16
    hosts = hosts_of(n, count, seed=7)
    job = UccJob(n)
    try:
        teams = job.create_team()
        produced = [jax.jit(lambda x: x * 2)(jax.device_put(
            jnp.asarray(hosts[r]), job.contexts[r].tl_contexts["xla"]
            .obj.device)) for r in range(n)]
        argses = [jax_args(job, r, np.asarray(produced[r]))
                  for r in range(n)]
        argses = [ucc_tpu.CollArgs(
            coll_type=a.coll_type, op=a.op, dst=a.dst,
            src=ucc_tpu.BufferInfo(produced[r], count,
                                   ucc_tpu.DataType.FLOAT32,
                                   mem_type=ucc_tpu.MemoryType.TPU))
            for r, a in enumerate(argses)]
        reqs = [teams[r].collective_init(argses[r]) for r in range(n)]
        ees = [JEe(teams[r], JEeType.TPU_STREAM) for r in range(n)]
        try:
            for r in range(n):
                ees[r].triggered_post(JUccEvent(payload=produced[r]),
                                      reqs[r])
            job.progress_until(lambda: all(
                rq.test() == ucc_tpu.Status.OK for rq in reqs), timeout=20)
            jtypes = drain(ees, 2)
            jres = [np.asarray(a.dst.buffer) for a in argses]
        finally:
            for ee in ees:
                ee.destroy()
    finally:
        job.cleanup()

    tjob = make_torch_job(n=n)
    try:
        produced = [torch.from_numpy(h.copy()).mul_(2) for h in hosts]
        dsts = [torch.full_like(p, 7) for p in produced]
        reqs = [tjob.teams[r].collective_init(
            torch_args(produced[r], dsts[r])) for r in range(n)]
        ees = [ut.Ee(tjob.teams[r], ut.EeType.CUDA_STREAM)
               for r in range(n)]
        try:
            for r in range(n):
                ees[r].triggered_post(ut.UccEvent(payload=produced[r]),
                                      reqs[r])
            wait_ok(reqs, pump=lambda: [c.progress()
                                        for c in tjob.contexts])
            types = drain(ees, 2)
        finally:
            for ee in ees:
                ee.destroy()
        for r in range(n):
            np.testing.assert_array_equal(bits(to_numpy(dsts[r])),
                                          bits(jres[r]))
        assert types == jtypes
        # destroy deregisters the EE from its context's progress queue
        assert not tjob.contexts[0].progress_queue._progress_fns
    finally:
        tjob.cleanup()


class _Pending:
    """A stand-in for a torch.cuda.Event whose work has not finished until
    ``done`` is set."""

    def __init__(self):
        self.done = False
        self.queries = 0

    def query(self):
        self.queries += 1
        return self.done


def test_stream_ee_waits_for_payload():
    """A payload that is not ready holds the post back through any number
    of progress passes; the post follows its readiness."""
    n, count = 4, 32
    hosts = hosts_of(n, count, seed=11)
    job = make_torch_job("allreduce:@ring_cuda:inf", n=n)
    try:
        srcs = [torch.from_numpy(h.copy()) for h in hosts]
        dsts = [torch.full_like(s, 7) for s in srcs]
        reqs = [job.teams[r].collective_init(torch_args(srcs[r], dsts[r]))
                for r in range(n)]
        ees = [ut.Ee(job.teams[r], ut.EeType.CUDA_STREAM)
               for r in range(n)]
        pending = [_Pending() for _ in range(n)]
        try:
            for r in range(n):
                ees[r].triggered_post(ut.UccEvent(payload=pending[r]),
                                      reqs[r])
            for _ in range(200):
                for c in job.contexts:
                    c.progress()
            assert [rq.test() for rq in reqs] == \
                [ut.Status.OPERATION_INITIALIZED] * n
            assert all(p.queries >= 2 for p in pending)
            assert all(ee.get_event() is None for ee in ees)
            for p in pending[:-1]:
                p.done = True
            for _ in range(200):
                for c in job.contexts:
                    c.progress()
            # the ranks whose payload is ready have posted; the
            # rendezvous waits for the last
            assert [rq.test().name for rq in reqs] == \
                ["IN_PROGRESS"] * (n - 1) + ["OPERATION_INITIALIZED"]
            pending[-1].done = True
            wait_ok(reqs, pump=lambda: [c.progress() for c in job.contexts])
            types = drain(ees, 2)
        finally:
            for ee in ees:
                ee.destroy()
        want = np.sum(np.stack(hosts), axis=0, dtype=np.float32)
        for d in dsts:
            np.testing.assert_allclose(to_numpy(d), want, rtol=1e-6,
                                       atol=1e-6)
        assert types == [["collective_post", "collective_complete"]] * n
    finally:
        job.cleanup()


def test_set_event_and_cpu_payload():
    """set_event fires an event and lands it on event_in; a CPU tensor's
    event is set when made (its data is ready)."""
    job = make_torch_job(n=1)
    try:
        ee = ut.Ee(job.teams[0], ut.EeType.CUDA_STREAM)
        ev = ut.UccEvent()
        assert not ev.is_set()
        assert ee.set_event(ev) == ut.Status.OK
        assert ev.is_set() and list(ee.event_in) == [ev]
        assert ut.UccEvent(payload=torch.zeros(3)).is_set()
        assert ee.get_event() is None
        ee.destroy()
    finally:
        job.cleanup()


# ---------------------------------------------------------------------------
# TestTriggeredAfterFastLane
# ---------------------------------------------------------------------------

def test_triggered_post_after_warm_reposts():
    n, count = 2, 8
    hosts = hosts_of(n, count, seed=5)
    job = UccJob(n)
    try:
        teams = job.create_team()
        argses = [jax_args(job, r, hosts[r], persistent=True)
                  for r in range(n)]
        reqs = [teams[r].collective_init(argses[r]) for r in range(n)]
        for _ in range(2):
            for rq in reqs:
                rq.post()
            job.progress_until(lambda: all(
                rq.test() == ucc_tpu.Status.OK for rq in reqs))
        ees = [JEe(teams[r], JEeType.CPU_THREAD) for r in range(n)]
        try:
            evs = [JUccEvent() for _ in range(n)]
            for r in range(n):
                ees[r].triggered_post(evs[r], reqs[r])
            for ev in evs:
                ev.set()
            jtypes = drain(ees, 2, pump=lambda: [c.progress()
                                                 for c in job.contexts])
            job.progress_until(lambda: all(
                rq.test() == ucc_tpu.Status.OK for rq in reqs))
            jres = [np.asarray(a.dst.buffer) for a in argses]
        finally:
            for ee in ees:
                ee.destroy()
    finally:
        job.cleanup()

    tjob = make_torch_job("allreduce:@ring_cuda:inf", n=n,
                          lib_params=MULTIPLE)
    try:
        srcs = [torch.from_numpy(h.copy()) for h in hosts]
        dsts = [torch.full_like(s, 7) for s in srcs]
        reqs = [tjob.teams[r].collective_init(
            torch_args(srcs[r], dsts[r], persistent=True)) for r in range(n)]
        pump = lambda: [c.progress() for c in tjob.contexts]  # noqa: E731
        for _ in range(2):
            for rq in reqs:
                rq.post()
            wait_ok(reqs, pump=pump)
        assert reqs[0]._fast       # the lane is armed
        for d in dsts:
            d.fill_(7)
        ees = [ut.Ee(tjob.teams[r], ut.EeType.CPU_THREAD) for r in range(n)]
        try:
            evs = [ut.UccEvent() for _ in range(n)]
            for r in range(n):
                ees[r].triggered_post(evs[r], reqs[r])
            for ev in evs:
                ev.set()
            types = drain(ees, 2, pump=pump)
            wait_ok(reqs, pump=pump)
        finally:
            for ee in ees:
                ee.destroy()
        for r in range(n):
            np.testing.assert_array_equal(bits(to_numpy(dsts[r])),
                                          bits(jres[r]))
        assert types == jtypes == [["collective_post",
                                    "collective_complete"]] * n
    finally:
        tjob.cleanup()


def out_types(ee):
    """The types of the events on an EE's out queue, popped."""
    return [e.ev_type for e in iter(ee.get_event, None)]


def test_triggered_rounds_observe_only_themselves():
    """Three triggered rounds of one persistent request, a plain round
    between each. The port's EE gives the task its callback back once the
    completion event is pushed: every triggered round pushes one post and
    one completion event, and every plain round takes the fast lane. The
    reference leaves each chained callback on the task, so its k-th
    triggered round pushes k completion events and no later round takes
    the lane (ROADMAP §C)."""
    from ucc_tpu.obs import metrics as jm
    from ucc_tpu_torch.obs import metrics as tm
    n, count, rounds = 2, 8, 3
    hosts = hosts_of(n, count, seed=8)
    saved = [(m, m.ENABLED) for m in (jm, tm)]
    for m in (jm, tm):
        m.reset()
        m.ENABLED = True
    try:
        job = UccJob(n)
        try:
            teams = job.create_team()
            argses = [jax_args(job, r, hosts[r], persistent=True)
                      for r in range(n)]
            reqs = [teams[r].collective_init(argses[r]) for r in range(n)]
            ees = [JEe(teams[r], JEeType.TPU_STREAM) for r in range(n)]
            jtypes = []
            for _ in range(rounds):
                for r in range(n):
                    ees[r].triggered_post(JUccEvent(), reqs[r])
                for ee in ees:
                    ee.set_event(ee._pending[0][0])
                job.progress_until(lambda: all(
                    rq.test() == ucc_tpu.Status.OK for rq in reqs))
                jtypes.append(out_types(ees[0]))
                for rq in reqs:
                    rq.post()
                job.progress_until(lambda: all(
                    rq.test() == ucc_tpu.Status.OK for rq in reqs))
                jtypes.append(out_types(ees[0]))
            for ee in ees:
                ee.destroy()
        finally:
            job.cleanup()
        jfast = sum(jm.snapshot()["counters"].get(
            "coll_fast_repost", {}).values())

        tjob = make_torch_job(n=n)
        try:
            srcs = [torch.from_numpy(h.copy()) for h in hosts]
            dsts = [torch.full_like(s, 7) for s in srcs]
            reqs = [tjob.teams[r].collective_init(
                torch_args(srcs[r], dsts[r], persistent=True))
                for r in range(n)]
            pump = lambda: [c.progress() for c in tjob.contexts]  # noqa
            ees = [ut.Ee(tjob.teams[r], ut.EeType.CUDA_STREAM)
                   for r in range(n)]
            types = []
            for _ in range(rounds):
                evs = [ut.UccEvent() for _ in range(n)]
                for r in range(n):
                    ees[r].triggered_post(evs[r], reqs[r])
                for ee, ev in zip(ees, evs):
                    ee.set_event(ev)
                wait_ok(reqs, pump=pump)
                types.append(out_types(ees[0]))
                assert all(rq.task.cb is None for rq in reqs)
                for rq in reqs:
                    rq.post()
                wait_ok(reqs, pump=pump)
                types.append(out_types(ees[0]))
            for ee in ees:
                ee.destroy()
        finally:
            tjob.cleanup()
        tfast = sum(tm.snapshot()["counters"]["coll_fast_repost"].values())
    finally:
        for m, was in saved:
            m.reset()
            m.ENABLED = was
    assert types == [["collective_post", "collective_complete"], []] * rounds
    assert tfast == n * rounds              # every plain round
    want = []
    for k in range(1, rounds + 1):
        want += [["collective_post"] + ["collective_complete"] * k,
                 ["collective_complete"] * k]
    assert jtypes == want
    assert jfast == 0
