"""The port's one-sided host collectives (``tl/host/onesided.py``) and the
context memory map, held against the JAX package.

Each scenario runs in both packages on the same numpy inputs: the JAX
package on tl/shm in threads, the port on tl/shm or on tl/sockets in
threads, and, over tl/sockets, in real processes (spawned workers that
import no JAX, handles exchanged over the team). Results must be equal
bit for bit. The sliding window reduces each window in the order its
gets complete (in both packages), which over TCP need not be the
in-process order, so its inputs are integer-valued (exact sums).
"""
import numpy as np
import pytest
import torch

import ucc_tpu
import ucc_tpu_torch as ut
import torch_procs as tp
from ucc_tpu_torch.tools.perftest import HeldPorts
from torch_host_jobs import Job, assert_same, env, run_cases
from ucc_tpu_torch.tl.host.onesided import REGISTRY

TRANSPORTS = {"shm": ("shm,self", "UCC_TL_SHM_TUNE"),
              "socket": ("socket,self", "UCC_TL_SOCKET_TUNE")}


def _cfg(mod, values):
    """tl/shm's config table of package ``mod`` over ``values``."""
    from importlib import import_module
    table = import_module(f"{mod.__name__}.tl.shm").TL_SHM_CONFIG
    return import_module(f"{mod.__name__}.utils.config").Config(
        table, env=values)


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env_,msg", [
    ({}, 4 << 20), ({}, 16 << 20), ({}, 64 << 20), ({}, 1 << 10),
    ({"UCC_TL_SHM_ALLREDUCE_SW_WINDOW": "512k",
      "UCC_TL_SHM_ALLREDUCE_SW_INFLIGHT": "2"}, 64 << 20),
    ({"UCC_TL_SHM_ALLREDUCE_SW_WINDOW": "inf",
      "UCC_TL_SHM_ALLREDUCE_SW_INFLIGHT": "inf"}, 64 << 20),
    ({"UCC_TL_SHM_ALLREDUCE_SW_WINDOW": "1m",
      "UCC_TL_SHM_ALLREDUCE_SW_INFLIGHT": "2"}, 1 << 20)])
def test_sw_knobs_equal_the_reference(env_, msg):
    import ucc_tpu.tl.host.onesided as jos
    import ucc_tpu_torch.tl.host.onesided as tos
    got = tos.sw_knobs(_cfg(ut, env_), msg)
    assert got == jos.sw_knobs(_cfg(ucc_tpu, env_), msg)
    assert tos.sw_max_work_buffer(_cfg(ut, env_)) == \
        jos.sw_max_work_buffer(_cfg(ucc_tpu, env_))
    assert tos.sw_knobs(None, msg) == jos.sw_knobs(None, msg)


def test_sw_auto_table():
    from ucc_tpu_torch.tl.host.onesided import sw_knobs, sw_max_work_buffer
    assert [sw_knobs(None, m) for m in (4 << 20, 16 << 20, 64 << 20)] == \
        [(256 << 10, 4), (256 << 10, 4), (1 << 20, 4)]
    assert sw_max_work_buffer(None) == (1 << 20) * 4


# ---------------------------------------------------------------------------
# mem_map
# ---------------------------------------------------------------------------

@pytest.fixture()
def job2(monkeypatch):
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    job = Job(ut, 2, tls="shm,socket,self,ring_cuda,torch_ops")
    yield job
    job.destroy()


class TestMemMap:
    @pytest.mark.parametrize("kind", ["numpy", "tensor"])
    def test_export_registers_segment(self, job2, kind):
        ctx = job2.contexts[0]
        buf = np.arange(64, dtype=np.float64)
        if kind == "tensor":
            buf = torch.from_numpy(buf)
        h = ctx.mem_map(buf)
        desc = ctx.mem_import(h)
        assert desc["onesided"] is True
        assert desc["nbytes"] == 64 * 8
        assert desc["buffer"] is buf
        key = (desc["ctx_uid"], desc["seg_id"])
        assert key in REGISTRY.segments
        # the segment is a view: a put lands in the caller's buffer
        assert REGISTRY.apply_put(*key, 8, np.full(8, 0xFF, np.uint8)) \
            is None
        assert np.asarray(buf)[1] != 1.0
        ctx.mem_unmap(h)
        assert key not in REGISTRY.segments

    def test_descriptor_keys_equal_the_reference(self, job2):
        with env(UCC_TL_SOCKET_BIND_HOST="127.0.0.1"):
            ref = Job(ucc_tpu, 1)
        try:
            a = np.zeros(8, np.int32)
            mine = job2.contexts[0].mem_import(job2.contexts[0].mem_map(a))
            theirs = ref.contexts[0].mem_import(ref.contexts[0].mem_map(a))
            assert sorted(mine) == sorted(theirs)
            for k in ("mem_type", "nbytes", "mode", "onesided", "seg_id"):
                assert mine[k] == theirs[k], k
        finally:
            ref.destroy()

    def test_import_remote_handle_is_metadata_only(self, job2):
        h = job2.contexts[1].mem_map(np.zeros(8, dtype=np.int32))
        desc = job2.contexts[0].mem_import(h)
        assert desc["buffer"] is None and desc["seg_id"] >= 1

    def test_context_destroy_unregisters(self):
        job = Job(ut, 2, tls="shm,self")
        uid = job.contexts[0]._ctx_uid
        job.contexts[0].mem_map(np.zeros(16, dtype=np.uint8))
        assert any(k[0] == uid for k in REGISTRY.segments)
        job.destroy()
        assert not any(k[0] == uid for k in REGISTRY.segments)

    def test_readonly_buffer_is_get_only(self, job2):
        ctx = job2.contexts[0]
        desc = ctx.mem_import(ctx.mem_map(b"\x01\x02\x03\x04"))
        got = REGISTRY.read_get(desc["ctx_uid"], desc["seg_id"], 1, 2)
        assert got is not None and bytes(got) == b"\x02\x03"
        err = REGISTRY.apply_put(desc["ctx_uid"], desc["seg_id"], 0,
                                 np.zeros(2, dtype=np.uint8))
        assert err is not None and "read-only" in err

    def test_non_contiguous_buffer_refused(self, job2):
        with pytest.raises(ut.UccError) as ei:
            job2.contexts[0].mem_map(np.zeros((4, 4), np.float32)[:, 1])
        assert ei.value.status == ut.Status.ERR_INVALID_PARAM

    def test_context_attr_work_buffer_size(self, job2):
        attr = job2.contexts[0].get_attr()
        assert attr.ctx_addr_len == len(attr.ctx_addr) > 0
        assert attr.global_work_buffer_size == 4 * (1 << 20)

    def test_cuda_buffer_exports_metadata_only(self, job2, monkeypatch):
        """A CUDA buffer maps as metadata (no registry segment), and a
        one-sided collective on CUDA memory is refused at init."""
        import ucc_tpu_torch.mc.base as mcb
        t = torch.zeros(8)
        monkeypatch.setattr(mcb, "detect_mem_type",
                            lambda obj: ut.MemoryType.CUDA)
        before = len(REGISTRY.segments)
        desc = job2.contexts[0].mem_import(job2.contexts[0].mem_map(t))
        assert desc["onesided"] is False
        assert desc["mem_type"] == int(ut.MemoryType.CUDA)
        assert len(REGISTRY.segments) == before
        monkeypatch.undo()
        monkeypatch.setenv("UCC_TL_SHM_TUNE", "allreduce:@sliding_window")
        monkeypatch.setenv("UCC_TLS", "shm,self")
        job = Job(ut, 2, tls="shm,self")
        try:
            teams = job.team(2)
            with pytest.raises(ut.UccError) as ei:
                teams[0].collective_init(ut.CollArgs(
                    coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
                    src=ut.BufferInfo(t, 8, ut.DataType.FLOAT32,
                                      mem_type=ut.MemoryType.CUDA),
                    dst=ut.BufferInfo(t.clone(), 8, ut.DataType.FLOAT32,
                                      mem_type=ut.MemoryType.CUDA),
                    global_work_buffer=np.zeros(8)))
            assert ei.value.status == ut.Status.ERR_NOT_SUPPORTED
        finally:
            job.destroy()


# ---------------------------------------------------------------------------
# scenarios, run in both packages
# ---------------------------------------------------------------------------

def _data(r, count, nd, seed=11, exact=False):
    rng = np.random.default_rng(seed + r)
    if exact or not np.issubdtype(nd, np.floating):
        return rng.integers(-8, 9, size=count).astype(nd)
    return (rng.random(count) * 4 - 2).astype(nd)


def _conv(mod, a):
    if mod is ucc_tpu:
        return a.copy()
    return torch.from_numpy(a.copy())


def _bits(b):
    return tp.bits(b)


def _run(job, teams, make):
    mod = job.mod
    args = [make(r) for r in range(len(teams))]
    sts, names = job.run(teams, args)
    return sts, names


def a2a_put(mod, job, teams, n, memh=True, count_per=7, get=False):
    count = count_per * n
    srcs = [_conv(mod, _data(r, count, np.float32)) for r in range(n)]
    dsts = [_conv(mod, np.zeros(count, np.float32)) for _ in range(n)]
    mapped = srcs if get else dsts
    handles = [job.contexts[r].mem_map(mapped[r]) for r in range(n)] \
        if memh else None

    def make(r):
        kw = {}
        if memh:
            kw = {"src_memh" if get else "dst_memh": list(handles),
                  "flags": mod.CollArgsFlags.MEM_MAP_SRC_MEMH if get
                  else mod.CollArgsFlags.MEM_MAP_DST_MEMH}
        return mod.CollArgs(
            coll_type=mod.CollType.ALLTOALL,
            src=mod.BufferInfo(srcs[r], count, mod.DataType.FLOAT32),
            dst=mod.BufferInfo(dsts[r], count, mod.DataType.FLOAT32), **kw)
    sts, names = _run(job, teams, make)
    return sts, names, [_bits(d) for d in dsts]


def a2av_target_relative(mod, job, teams, n, memh=True, zero_rank=False):
    m = [[(r + p) % 3 + 1 for p in range(n)] for r in range(n)]
    if zero_rank:
        m = [[0] * n] + [[0 if p == 0 else 2 for p in range(n)]
                         for _ in range(1, n)]
    recv_counts = [[m[q][p] for q in range(n)] for p in range(n)]
    srcs, dsts, s_displ, d_displ = [], [], [], []
    for r in range(n):
        srcs.append(_conv(mod, (np.arange(max(1, sum(m[r])))
                                + 1000 * r).astype(np.int32)))
        dsts.append(_conv(mod, np.full(max(1, sum(recv_counts[r])), -1,
                                       np.int32)))
        s_displ.append([int(x) for x in np.cumsum([0] + m[r][:-1])])
        if memh:   # target-relative: my offset inside peer p's dst
            d_displ.append([sum(m[q][p] for q in range(r))
                            for p in range(n)])
        else:
            d_displ.append(None)
    handles = [job.contexts[r].mem_map(dsts[r]) for r in range(n)] \
        if memh else None

    def make(r):
        kw = {} if not memh else {
            "dst_memh": list(handles),
            "flags": mod.CollArgsFlags.MEM_MAP_DST_MEMH}
        return mod.CollArgs(
            coll_type=mod.CollType.ALLTOALLV,
            src=mod.BufferInfoV(srcs[r], m[r], s_displ[r],
                                mod.DataType.INT32),
            dst=mod.BufferInfoV(dsts[r], recv_counts[r], d_displ[r],
                                mod.DataType.INT32), **kw)
    sts, names = _run(job, teams, make)
    return sts, names, [_bits(d) for d in dsts]


def sliding_window(mod, job, teams, n, memh=True, count=4097,
                   nd=np.float32, op="SUM", inplace=False, gwb=False):
    dt = {np.float32: "FLOAT32", np.float64: "FLOAT64",
          np.int32: "INT32"}[nd]
    srcs = [_conv(mod, _data(r, count, nd, exact=True)) for r in range(n)]
    dsts = srcs if inplace else \
        [_conv(mod, np.zeros(count, nd)) for _ in range(n)]
    sh = dh = None
    if memh:
        sh = [job.contexts[r].mem_map(srcs[r]) for r in range(n)]
        dh = sh if inplace else \
            [job.contexts[r].mem_map(dsts[r]) for r in range(n)]
    wbs = job.contexts[0].get_attr().global_work_buffer_size
    gwbs = [np.zeros(wbs, np.uint8) for _ in range(n)] if gwb else None

    def make(r):
        flags = mod.CollArgsFlags(0)
        kw = {}
        if memh:
            flags |= (mod.CollArgsFlags.MEM_MAP_SRC_MEMH
                      | mod.CollArgsFlags.MEM_MAP_DST_MEMH)
            kw = {"src_memh": list(sh), "dst_memh": list(dh)}
        if inplace:
            flags |= mod.CollArgsFlags.IN_PLACE
        if gwb:
            kw["global_work_buffer"] = gwbs[r]
        return mod.CollArgs(
            coll_type=mod.CollType.ALLREDUCE, op=mod.ReductionOp[op],
            src=mod.BufferInfo(srcs[r], count, mod.DataType[dt]),
            dst=mod.BufferInfo(dsts[r], count, mod.DataType[dt]),
            flags=flags, **kw)
    sts, names = _run(job, teams, make)
    if gwb:
        assert any(g.any() for g in gwbs)
    return sts, names, [_bits(d) for d in dsts]


SCENARIOS = {
    "a2a_put_memh": ("alltoall:@onesided", {}, a2a_put, {}),
    "a2a_put_1": ("alltoall:@onesided", {}, a2a_put, {"count_per": 1}),
    "a2a_put_bootstrap": ("alltoall:@onesided", {}, a2a_put,
                          {"memh": False}),
    "a2a_get_memh": ("alltoall:@onesided",
                     {"ALLTOALL_ONESIDED_ALG": "get"}, a2a_put,
                     {"get": True}),
    "a2a_get_bootstrap": ("alltoall:@onesided",
                          {"ALLTOALL_ONESIDED_ALG": "get"}, a2a_put,
                          {"get": True, "memh": False}),
    "a2av_memh": ("alltoallv:@onesided", {}, a2av_target_relative, {}),
    "a2av_zero_rank": ("alltoallv:@onesided", {}, a2av_target_relative,
                       {"zero_rank": True}),
    "a2av_bootstrap": ("alltoallv:@onesided", {}, a2av_target_relative,
                       {"memh": False}),
    "a2av_get_bootstrap": ("alltoallv:@onesided",
                           {"ALLTOALLV_ONESIDED_ALG": "get"},
                           a2av_target_relative, {"memh": False}),
    "sw_multiwindow": ("allreduce:@sliding_window",
                       {"ALLREDUCE_SW_WINDOW": "256"}, sliding_window, {}),
    "sw_small": ("allreduce:@sliding_window", {}, sliding_window,
                 {"count": 3}),
    "sw_avg_inplace": ("allreduce:@sliding_window", {}, sliding_window,
                       {"nd": np.float64, "op": "AVG", "inplace": True,
                        "count": 1000}),
    "sw_max_int": ("allreduce:@sliding_window", {}, sliding_window,
                   {"nd": np.int32, "op": "MAX", "count": 37}),
    "sw_bootstrap": ("allreduce:@sliding_window",
                     {"ALLREDUCE_SW_WINDOW": "128"}, sliding_window,
                     {"memh": False, "count": 777}),
    "sw_user_scratch": ("allreduce:@sliding_window", {}, sliding_window,
                        {"count": 600, "gwb": True}),
}


def _job(mod, transport, tune, knobs, n=4):
    tls, var = TRANSPORTS[transport]
    prefix = var[:-len("TUNE")]
    extra = {prefix + k: v for k, v in knobs.items()}
    with env(**{var: tune, "UCC_TL_SOCKET_BIND_HOST": "127.0.0.1",
                **extra}):
        job = Job(mod, n, tls=tls, tune_var=var)
        teams = job.team(n, tune)
    return job, teams


@pytest.mark.parametrize("transport", ["shm", "socket"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(name, transport):
    tune, knobs, fn, kw = SCENARIOS[name]
    n = 4
    before = len(REGISTRY.segments)
    out = {}
    for key, mod, tr in (("ref", ucc_tpu, "shm"), ("port", ut, transport)):
        job, teams = _job(mod, tr, tune, knobs, n)
        try:
            out[key] = fn(mod, job, teams, n, **kw)
        finally:
            job.destroy()
    sts, names, bufs = out["port"]
    assert sts == ["OK"] * n
    assert names == out["ref"][1] == [tune.split("@")[1]] * n
    assert bufs == out["ref"][2]
    # bootstrap segments and arrival counters are gone
    assert len(REGISTRY.segments) == before
    assert not any(isinstance(k, tuple) and k and k[0] == "__os_ctr__"
                   for k in REGISTRY.counters)


def test_memh_args_with_default_tune_run_twosided():
    """Global memh without TUNE keeps the default algorithm in both."""
    out = {}
    for key, mod in (("ref", ucc_tpu), ("port", ut)):
        job, teams = _job(mod, "shm", "", {})
        try:
            out[key] = a2a_put(mod, job, teams, 4)
        finally:
            job.destroy()
    assert out["port"] == out["ref"]
    assert out["port"][1] != ["onesided"] * 4


def test_persistent_repost():
    out = {}
    for key, mod in (("ref", ucc_tpu), ("port", ut)):
        job, teams = _job(mod, "socket" if mod is ut else "shm",
                          "allreduce:@sliding_window", {})
        try:
            n, count = 4, 512
            srcs = [_conv(mod, _data(r, count, np.float32, exact=True))
                    for r in range(n)]
            dsts = [_conv(mod, np.zeros(count, np.float32))
                    for _ in range(n)]
            sh = [job.contexts[r].mem_map(srcs[r]) for r in range(n)]
            dh = [job.contexts[r].mem_map(dsts[r]) for r in range(n)]
            reqs = [teams[r].collective_init(mod.CollArgs(
                coll_type=mod.CollType.ALLREDUCE, op=mod.ReductionOp.SUM,
                src=mod.BufferInfo(srcs[r], count, mod.DataType.FLOAT32),
                dst=mod.BufferInfo(dsts[r], count, mod.DataType.FLOAT32),
                src_memh=sh, dst_memh=dh,
                flags=(mod.CollArgsFlags.MEM_MAP_SRC_MEMH
                       | mod.CollArgsFlags.MEM_MAP_DST_MEMH
                       | mod.CollArgsFlags.PERSISTENT))) for r in range(n)]
            res = []
            for rnd in range(2):
                if rnd:
                    for r in range(n):
                        srcs[r] += r + 1
                        dsts[r][:] = 0
                for rq in reqs:
                    rq.post()
                job.until(lambda: all(
                    [rq.test() != mod.Status.IN_PROGRESS for rq in reqs]))
                assert [rq.test().name for rq in reqs] == ["OK"] * n
                res.append([_bits(d) for d in dsts])
            for rq in reqs:
                rq.finalize()
            out[key] = res
        finally:
            job.destroy()
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# across processes, over tl/sockets
# ---------------------------------------------------------------------------

PROC_CASES = [
    ("alltoall:@onesided", {}, {"coll": "ALLTOALL", "dt": "INT32", "c": 4,
                                "memh": ["dst"]}),
    ("alltoall:@onesided", {}, {"coll": "ALLTOALL", "dt": "FLOAT32",
                                "c": 5}),
    ("alltoall:@onesided", {"ALLTOALL_ONESIDED_ALG": "get"},
     {"coll": "ALLTOALL", "dt": "FLOAT64", "c": 3, "memh": ["src"]}),
    ("alltoallv:@onesided", {}, {"coll": "ALLTOALLV", "dt": "INT32",
                                 "c": 4}),
    ("allreduce:@sliding_window", {"ALLREDUCE_SW_WINDOW": "64"},
     {"coll": "ALLREDUCE", "dt": "INT32", "c": 257, "op": "SUM",
      "memh": ["src", "dst"]}),
    ("allreduce:@sliding_window", {},
     {"coll": "ALLREDUCE", "dt": "FLOAT64", "c": 101, "op": "MAX"}),
]


def test_onesided_across_processes_over_sockets():
    n = 4
    phases = []
    for i, (tune, knobs, case) in enumerate(PROC_CASES):
        envs = {"UCC_TL_SOCKET_TUNE": tune}
        envs.update({f"UCC_TL_SOCKET_{k}": v for k, v in knobs.items()})
        phases.append({"env": envs, "cases": [dict(case, seed=70 + i)]})
    with HeldPorts(1 + len(phases)) as held:
        specs = [{"n": n, "ranks": [r], "ports": held.ports,
                  "env": {"UCC_TLS": "socket,self"}, "phases": phases}
                 for r in range(n)]
        res = tp.run_procs(tp.job_worker, specs, timeout=150)
    got = tp.collect(res, n)
    with env(UCC_TL_SOCKET_BIND_HOST="127.0.0.1"):
        for i, (tune, knobs, case) in enumerate(PROC_CASES):
            c = dict(case, seed=70 + i)
            c.pop("memh", None)
            with env(**{f"UCC_TL_SHM_{k}": v for k, v in knobs.items()}):
                ref = Job(ucc_tpu, n, tls="shm,self")
                try:
                    want = run_cases(ref, [c], n, tune)
                finally:
                    ref.destroy()
            g = [[tuple(got[i][r]["cases"][0]) for r in range(n)]]
            assert_same(g, want, [c])
            assert {x[1] for x in g[0]} == {tune.split("@")[1]}


# ---------------------------------------------------------------------------
# failures
# ---------------------------------------------------------------------------

def test_unmapped_segment_fails_not_hangs():
    job, teams = _job(ut, "shm", "alltoall:@onesided", {})
    try:
        n, count = 4, 16
        srcs = [torch.from_numpy(_data(r, count, np.float32))
                for r in range(n)]
        dsts = [torch.zeros(count) for _ in range(n)]
        handles = [job.contexts[r].mem_map(dsts[r]) for r in range(n)]
        job.contexts[2].mem_unmap(handles[2])
        reqs = [teams[r].collective_init(ut.CollArgs(
            coll_type=ut.CollType.ALLTOALL,
            src=ut.BufferInfo(srcs[r], count, ut.DataType.FLOAT32),
            dst=ut.BufferInfo(dsts[r], count, ut.DataType.FLOAT32),
            dst_memh=list(handles), flags=ut.CollArgsFlags.MEM_MAP_DST_MEMH))
            for r in range(n)]
        for rq in reqs:
            rq.post()
        job.until(lambda: all(
            [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]), 20)
        assert any(rq.test().is_error for rq in reqs)
    finally:
        job.destroy()


def test_rejected_put_poisons_notify_counter():
    key = ("__os_ctr__", "test-uid", "tk", 1)
    err = REGISTRY.apply_put("no-such-ctx", 99, 0, np.zeros(4, np.uint8),
                             notify=key)
    assert err is not None
    assert REGISTRY.counter_read(key) == 1
    assert REGISTRY.counter_errs(key) == [err]
    REGISTRY.counter_del(key)
    assert REGISTRY.counter_read(key) == 0 and REGISTRY.counter_errs(key) == []


def test_socket_flush_fence_reports_rejections():
    job = Job(ut, 2, tls="socket,self")
    try:
        ctx0 = job.contexts[0].tl_contexts["socket"].obj
        buf = np.zeros(16, np.uint8)
        desc = job.contexts[1].mem_import(job.contexts[1].mem_map(buf))
        ctx0.os_put(1, desc, 0, np.arange(4, dtype=np.uint8))
        fr = ctx0.os_flush(1)
        job.until(fr.test, 10)
        assert fr.error is None and buf[:4].tolist() == [0, 1, 2, 3]
        ctx0.os_put(1, desc, 1000, np.zeros(64, np.uint8))
        fr2 = ctx0.os_flush(1)
        job.until(fr2.test, 10)
        assert fr2.error is not None and "rejected" in fr2.error
        fr3 = ctx0.os_flush(1)
        job.until(fr3.test, 10)
        assert fr3.error is None
        # a get of a bad range is a short reply
        dst = np.zeros(8, np.uint8)
        rq = ctx0.os_get(1, desc, 12, dst)
        job.until(rq.test, 10)
        assert rq.nbytes == 0
    finally:
        job.destroy()
