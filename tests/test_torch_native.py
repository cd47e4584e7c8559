"""The port's native tag-matching core (ucc_tpu_torch/native.py over its
own copy of the C++ core, native_src/ucc_tpu_torch_core.cc): the
NativeMailbox contract of the JAX package's tests/test_native.py (ABI,
mailbox, truncation, cancel, fence, lifecycle), where the library is
built and that the JAX package's build is never touched, the locked
build under concurrent processes, the UCC_TL_SHM_NATIVE / UCC_NATIVE
knobs (a required core that cannot be built raises), and the transport
and a collective over the native matcher."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ucc_tpu_torch as ut
from ucc_tpu_torch import native
from ucc_tpu_torch.native import ABI_VERSION, NativeMailbox, get_lib

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_LIB = os.path.join(_REPO, "native", "libucc_tpu_core.so")


def _key(tag, epoch=0, slot=0, src=0, team="t"):
    """The host TL's key shape: (team_key, epoch, coll_tag, slot, src)."""
    return (team, epoch, tag, slot, src)


@pytest.fixture
def mb():
    m = NativeMailbox()
    yield m
    m.destroy()


class TestNativeAbi:
    def test_abi_version_symbol(self):
        lib = get_lib()
        assert int(lib.ucc_abi_version()) == ABI_VERSION

    def test_every_bound_symbol_is_there(self):
        lib = get_lib()
        for sym in ("ucc_mailbox_push", "ucc_mailbox_post_recv",
                    "ucc_mailbox_fence", "ucc_mailbox_purge",
                    "ucc_req_poll", "ucc_req_test_many", "ucc_req_cancel",
                    "ucc_req_free_many", "ucc_req_sent_nbytes"):
            assert getattr(lib, sym, None) is not None

    def test_the_port_keeps_the_reference_abi(self):
        src = open(os.path.join(_REPO, "ucc_tpu_torch", "native_src",
                                "ucc_tpu_torch_core.cc")).read()
        ref = open(os.path.join(_REPO, "native", "ucc_tpu_core.cc")).read()
        assert f"constexpr uint64_t kAbiVersion = {ABI_VERSION};" in src
        # the C API is the original's, line for line
        cut = 'extern "C" {'
        assert src[src.index(cut):] == ref[ref.index(cut):]


class TestWhereTheCoreLives:
    def test_library_in_the_port_build_dir(self):
        get_lib()
        path = native.lib_path
        build = os.path.join(_REPO, "ucc_tpu_torch", "build")
        assert os.path.commonpath([path, build]) == build
        assert os.path.basename(path) == "libucc_tpu_torch_core.so"
        assert path == native.library_path()

    def test_the_jax_package_build_is_untouched(self, tmp_path, monkeypatch):
        before = os.stat(_JAX_LIB).st_mtime_ns \
            if os.path.exists(_JAX_LIB) else None
        listing = sorted(os.listdir(os.path.join(_REPO, "native")))
        # a fresh build of the port's core (another build dir) ...
        monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
        out = native.build()
        assert os.path.isfile(out) and out.startswith(str(tmp_path))
        # ... leaves native/ exactly as it was
        after = os.stat(_JAX_LIB).st_mtime_ns \
            if os.path.exists(_JAX_LIB) else None
        assert before == after
        assert sorted(os.listdir(os.path.join(_REPO, "native"))) == listing

    def test_concurrent_builds_share_one_library(self, tmp_path):
        """Three processes build into one empty build dir at once: the
        lock makes one compile, the others load its result."""
        code = ("import sys; from ucc_tpu_torch import native as n; "
                "n._BUILD_DIR = sys.argv[1]; print(n.build())")
        env = dict(os.environ, PYTHONPATH=_REPO)
        procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                                  stdout=subprocess.PIPE, env=env)
                 for _ in range(3)]
        outs = [p.communicate(timeout=240)[0].decode().strip()
                for p in procs]
        assert all(p.returncode == 0 for p in procs)
        assert len(set(outs)) == 1 and os.path.isfile(outs[0])
        leftovers = [f for f in os.listdir(os.path.dirname(outs[0]))
                     if f.endswith(".tmp")]
        assert leftovers == []

    def test_build_key_follows_the_source(self, tmp_path, monkeypatch):
        src = tmp_path / "core.cc"
        src.write_bytes(open(native._SRC_PATH, "rb").read())
        monkeypatch.setattr(native, "_SRC_PATH", str(src))
        k1 = native._build_key()
        src.write_bytes(src.read_bytes() + b"\n// edited\n")
        assert native._build_key() != k1


@pytest.fixture
def broken_core(tmp_path, monkeypatch):
    """Point the build at a source that does not compile."""
    src = tmp_path / "broken.cc"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC_PATH", str(src))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    native._reset()
    yield
    native._reset()


class TestRequiredCore:
    def test_shm_native_y_with_a_broken_build_raises(self, broken_core,
                                                     monkeypatch):
        from ucc_tpu_torch.tl.host.transport import InProcTransport
        monkeypatch.setenv("UCC_TL_SHM_NATIVE", "y")
        with pytest.raises(ut.UccError) as ei:
            InProcTransport()
        assert ei.value.status == ut.Status.ERR_NO_RESOURCE
        monkeypatch.delenv("UCC_TL_SHM_NATIVE")
        with pytest.raises(ut.UccError):
            InProcTransport(use_native=True)

    def test_native_y_with_a_broken_build_raises(self, broken_core,
                                                 monkeypatch):
        monkeypatch.setenv("UCC_NATIVE", "y")
        with pytest.raises(ut.UccError) as ei:
            get_lib()
        assert ei.value.status == ut.Status.ERR_NO_RESOURCE

    def test_context_create_raises_too(self, broken_core, monkeypatch):
        monkeypatch.setenv("UCC_TL_SHM_NATIVE", "y")
        with pytest.raises(ut.UccError):
            ut.Context(ut.init(TLS="shm,self"))

    def test_auto_falls_back_to_the_python_matcher(self, broken_core):
        from ucc_tpu_torch.tl.host.transport import InProcTransport
        t = InProcTransport()
        try:
            assert t.native is None
            assert "failed" in native.build_error()
        finally:
            t.close()

    def test_native_n_turns_the_core_off(self, monkeypatch):
        from ucc_tpu_torch.tl.host.transport import InProcTransport
        native._reset()
        monkeypatch.setenv("UCC_NATIVE", "n")
        try:
            assert get_lib() is None
            t = InProcTransport()
            assert t.native is None
            t.close()
        finally:
            native._reset()

    def test_shm_native_n_is_the_python_matcher(self, monkeypatch):
        from ucc_tpu_torch.tl.host.transport import InProcTransport
        monkeypatch.setenv("UCC_TL_SHM_NATIVE", "n")
        t = InProcTransport()
        assert t.native is None
        t.close()


class TestNativeMailbox:
    def test_recv_then_send_direct(self, mb):
        dst = np.zeros(16, np.float32)
        r = mb.post_recv_native(_key(1), dst)
        assert not r.test()
        s, kind = mb.push_native(_key(1), np.arange(16, dtype=np.float32))
        assert kind == "direct"
        assert s.test() and r.test()
        np.testing.assert_array_equal(dst, np.arange(16, dtype=np.float32))
        assert r.nbytes == 64

    def test_send_then_recv_eager(self, mb):
        src = np.full(4, 7.0, np.float32)
        s, kind = mb.push_native(_key(2), src)
        assert kind == "eager" and s.test()
        src[:] = -1.0   # the sender may reuse its buffer at once
        d = np.zeros(4, np.float32)
        r = mb.post_recv_native(_key(2), d)
        assert r.test() and d[0] == 7.0

    def test_send_then_recv_rndv(self, mb):
        big = np.arange(5000, dtype=np.float64)
        s, kind = mb.push_native(_key(3), big, 8192)
        assert kind == "rndv" and not s.test()
        d = np.zeros(5000, np.float64)
        r = mb.post_recv_native(_key(3), d)
        assert r.test() and s.test()
        np.testing.assert_array_equal(d, big)

    def test_eager_limit_is_respected(self, mb):
        data = np.zeros(100, np.uint8)
        _, kind_small = mb.push_native(_key(4), data, 100)
        _, kind_large = mb.push_native(_key(5), data, 99)
        assert kind_small == "eager" and kind_large == "rndv"

    def test_unexpected_message_queue_fifo(self, mb):
        mb.push_native(_key(6), np.full(4, 1.0, np.float32))
        mb.push_native(_key(6), np.full(4, 2.0, np.float32))
        d1 = np.zeros(4, np.float32)
        d2 = np.zeros(4, np.float32)
        r1 = mb.post_recv_native(_key(6), d1)
        r2 = mb.post_recv_native(_key(6), d2)
        assert r1.test() and r2.test()
        assert d1[0] == 1.0 and d2[0] == 2.0

    def test_key_isolation(self, mb):
        da = np.zeros(2, np.int32)
        ra = mb.post_recv_native(_key(7, slot=1), da)
        mb.push_native(_key(7, slot=2), np.full(2, 9, np.int32))
        assert not ra.test()
        mb.push_native(_key(7, slot=1), np.full(2, 5, np.int32))
        assert ra.test() and da[0] == 5

    def test_tuple_tags_and_generic_keys(self, mb):
        d = np.zeros(2, np.int64)
        r = mb.post_recv_native(("t", 0, ("svc", 3), 0, 1), d)
        mb.push_native(("t", 0, ("svc", 3), 0, 1), np.full(2, 11, np.int64))
        assert r.test() and d[0] == 11
        r2 = mb.post_recv_native(("t", 0, ("svc", 4), 0, 1),
                                 np.zeros(2, np.int64))
        assert not r2.test()
        d3 = np.zeros(2, np.int64)
        r3 = mb.post_recv_native(("odd", "key"), d3)
        mb.push_native(("odd", "key"), np.full(2, 5, np.int64))
        assert r3.test() and d3[0] == 5

    def test_the_port_team_keys_intern_apart(self, mb):
        """Both shapes of the port's team keys intern, and keys of
        different teams (and scopes) never match each other."""
        keys = [(((0, 1, 2), 1, 4242), "svc"), (((0, 1, 2), 1, 4242), "cl"),
                (((0, 1, 2), 2, 4242), "svc"), (("epmap", (0, 1), 0), "svc"),
                (("epmap", (0, 1), 1), "svc")]
        ids = {mb.team_id(k) for k in keys}
        assert len(ids) == len(keys)
        dsts = [np.zeros(1, np.int64) for _ in keys]
        reqs = [mb.post_recv_native(_key(("as", 0, 1, 2, 0), team=k), d)
                for k, d in zip(keys, dsts)]
        for i, k in enumerate(keys):
            mb.push_native(_key(("as", 0, 1, 2, 0), team=k),
                           np.full(1, i + 1, np.int64))
        assert all(r.test() for r in reqs)
        assert [int(d[0]) for d in dsts] == list(range(1, len(keys) + 1))

    def test_zero_length_message(self, mb):
        s, kind = mb.push_native(_key(8), np.empty(0, np.uint8))
        assert kind == "eager" and s.test()
        r = mb.post_recv_native(_key(8), np.empty(0, np.uint8))
        assert r.test() and r.nbytes == 0 and r.error is None

    def test_read_only_recv_buffer_is_refused(self, mb):
        ro = np.zeros(4, np.uint8)
        ro.flags.writeable = False
        with pytest.raises(ValueError):
            mb.post_recv_native(_key(9), ro)


class TestNativeTruncation:
    def test_truncated_send_sets_error(self, mb):
        dst = np.zeros(4, np.uint8)
        rreq = mb.post_recv_native(_key(1), dst)
        sreq, _ = mb.push_native(_key(1), np.arange(10, dtype=np.uint8))
        assert rreq.test() and sreq.test()
        assert rreq.error is not None and "truncated" in rreq.error
        assert "sent 10 bytes" in rreq.error
        assert "4-byte recv buffer" in rreq.error
        assert rreq.nbytes == 4

    def test_truncated_unexpected_order(self, mb):
        mb.push_native(_key(2), np.arange(10, dtype=np.uint8))
        rreq = mb.post_recv_native(_key(2), np.zeros(4, np.uint8))
        assert rreq.test()
        assert rreq.error is not None and "truncated" in rreq.error

    def test_exact_size_no_error(self, mb):
        dst = np.zeros(8, np.uint8)
        rreq = mb.post_recv_native(_key(3), dst)
        mb.push_native(_key(3), np.arange(8, dtype=np.uint8))
        assert rreq.test()
        assert rreq.error is None and rreq.nbytes == 8


class TestNativeCancel:
    def test_cancel_skip_at_match(self, mb):
        dead = np.zeros(4, np.uint8)
        r1 = mb.post_recv_native(_key(1), dead)
        r1.cancel()
        assert r1.test() and r1.cancelled and r1.error == "canceled"
        live = np.zeros(4, np.uint8)
        r2 = mb.post_recv_native(_key(1), live)
        s, kind = mb.push_native(_key(1), np.full(4, 3, np.uint8))
        assert kind == "direct"
        assert r2.test() and live[0] == 3
        assert not dead.any()

    def test_cancel_after_delivery_stays_delivered(self, mb):
        d = np.zeros(4, np.uint8)
        r = mb.post_recv_native(_key(2), d)
        mb.push_native(_key(2), np.full(4, 9, np.uint8))
        r.cancel()
        assert r.test() and r.cancelled
        assert r.error is None and d[0] == 9

    def test_cancel_only_skips_the_cancelled_entry(self, mb):
        d1, d2 = np.zeros(2, np.uint8), np.zeros(2, np.uint8)
        r1 = mb.post_recv_native(_key(3), d1)
        r2 = mb.post_recv_native(_key(3), d2)
        r2.cancel()
        mb.push_native(_key(3), np.full(2, 5, np.uint8))
        assert r1.test() and d1[0] == 5
        assert r2.cancelled and not d2.any()


class TestNativeFence:
    def test_fence_purges_parked_stale_state(self, mb):
        stale = np.zeros(4, np.uint8)
        r = mb.post_recv_native(_key(1, epoch=0), stale)
        mb.push_native(_key(2, epoch=0), np.full(2, 1, np.uint8))
        assert mb.fence("t", 1) == 2
        assert r.test() and "fenced" in r.error and r.cancelled
        r2 = mb.post_recv_native(_key(2, epoch=1), np.zeros(2, np.uint8))
        assert not r2.test()

    def test_stale_send_discarded_at_boundary(self, mb):
        mb.fence("t", 1)
        s, kind = mb.push_native(_key(1, epoch=0), np.full(2, 1, np.uint8))
        assert kind == "fenced" and s.test()
        r = mb.post_recv_native(_key(1, epoch=1), np.zeros(2, np.uint8))
        assert not r.test()

    def test_stale_post_recv_fails_locally(self, mb):
        mb.fence("t", 2)
        r = mb.post_recv_native(_key(1, epoch=1), np.zeros(2, np.uint8))
        assert r.test() and "fenced" in r.error

    def test_fence_purges_rndv_send(self, mb):
        big = np.zeros(100000, np.uint8)
        s, kind = mb.push_native(_key(1, epoch=0), big, 8192)
        assert kind == "rndv" and not s.test()
        assert mb.fence("t", 1) == 1
        assert s.test()

    def test_fence_is_team_scoped(self, mb):
        other = np.zeros(2, np.uint8)
        r = mb.post_recv_native(_key(1, team="other"), other)
        assert mb.fence("t", 5) == 0
        assert not r.test()
        mb.push_native(_key(1, team="other"), np.full(2, 4, np.uint8))
        assert r.test() and other[0] == 4


class TestNativeLifecycle:
    def test_purge_reclaims_abandoned_requests(self, mb):
        reqs = [mb.post_recv_native(_key(i), np.zeros(4, np.uint8))
                for i in range(8)]
        s, _ = mb.push_native(_key(99), np.zeros(100000, np.uint8), 8192)
        assert mb.purge() > 0
        assert all(r.test() for r in reqs)
        assert s.test()
        assert not mb._send_keep

    def test_send_request_freed_at_delivery(self, mb):
        s, _ = mb.push_native(_key(1), np.zeros(100000, np.uint8), 8192)
        assert mb._send_keep
        r = mb.post_recv_native(_key(1), np.zeros(100000, np.uint8))
        assert r.test() and s.test()
        assert not mb._send_keep

    def test_slot_reuse(self, mb):
        for i in range(3000):
            r = mb.post_recv_native(_key(i), np.zeros(4, np.uint8))
            mb.push_native(_key(i), np.full(4, 1, np.uint8))
            assert r.test()
        r = mb.post_recv_native(_key(9999), np.zeros(1, np.uint8))
        assert (r.rid & ((1 << 20) - 1)) < 2048

    def test_poll_pending_mixed(self, mb):
        from ucc_tpu_torch.native import poll_pending

        class FakeReq:
            def __init__(self, done):
                self._d = done

            def test(self):
                return self._d

        r_pend = mb.post_recv_native(_key(1), np.zeros(4, np.uint8))
        r_done = mb.post_recv_native(_key(2), np.zeros(4, np.uint8))
        mb.push_native(_key(2), np.full(4, 1, np.uint8))
        pending = poll_pending([r_pend, r_done, FakeReq(True),
                                FakeReq(False)])
        assert len(pending) == 2
        assert any(p is r_pend for p in pending)
        assert "FakeReq" in {type(p).__name__ for p in pending}

    def test_closed_mailbox_is_safe(self):
        m = NativeMailbox()
        r = m.post_recv_native(_key(1), np.zeros(4, np.uint8))
        m.destroy()
        assert r.test()
        s, kind = m.push_native(_key(1), np.zeros(4, np.uint8))
        assert s.test() and kind == "eager"
        with pytest.raises(RuntimeError):
            m.post_recv_native(_key(1), np.zeros(4, np.uint8))

    def test_destroyed_mailbox_is_parked_and_recycled(self):
        m = NativeMailbox()
        old_ptr = m.ptr
        r = m.post_recv_native(_key(1), np.zeros(4, np.uint8))
        stale_rid = r.rid
        m.destroy()
        m2 = NativeMailbox()
        try:
            assert m2.ptr == old_ptr
            assert int(m2.lib.ucc_req_poll(m2.ptr, stale_rid)) != 0
            d = np.zeros(4, np.uint8)
            r2 = m2.post_recv_native(_key(2), d)
            s2, kind = m2.push_native(_key(2), np.ones(4, np.uint8))
            assert kind == "direct" and s2.test() and r2.test()
            assert d[0] == 1
        finally:
            m2.destroy()

    def test_test_many_batch_poll(self, mb):
        dsts = [np.zeros(4, np.uint8) for _ in range(6)]
        reqs = [mb.post_recv_native(_key(i), d) for i, d in enumerate(dsts)]
        for i in (0, 2, 4):
            mb.push_native(_key(i), np.full(4, i + 1, np.uint8))
        pending = mb.test_many(list(reqs))
        assert {r.rid for r in pending} == {reqs[i].rid for i in (1, 3, 5)}
        for i in (0, 2, 4):
            assert reqs[i].test() and dsts[i][0] == i + 1

    def test_occupancy(self, mb):
        mb.push_native(_key(1), np.zeros(4, np.uint8))
        mb.post_recv_native(_key(2), np.zeros(4, np.uint8))
        unexp, posted, slots = mb.occupancy()
        assert (unexp, posted) == (1, 1) and slots >= 1


# ---------------------------------------------------------------------------
# the transport and a collective over the native matcher
# ---------------------------------------------------------------------------

class TestTransportOverNative:
    def test_native_default_on(self):
        from ucc_tpu_torch.tl.host.transport import InProcTransport
        t = InProcTransport()
        try:
            assert t.native is not None
        finally:
            t.close()

    @pytest.mark.parametrize("use_native", [True, False])
    def test_counters_and_copy_free(self, use_native):
        from ucc_tpu_torch.tl.host.transport import InProcTransport
        a, b = InProcTransport(use_native), InProcTransport(use_native)
        try:
            dst = np.zeros(8, np.float32)
            r = b.recv_nb(_key(1), dst)
            s = a.send_nb(b, _key(1), np.ones(8, np.float32))
            assert s.test() and r.test() and dst[0] == 1
            a.send_nb(b, _key(2), np.ones(8, np.float32))          # eager
            big = np.ones(1 << 14, np.float32)
            sb = a.send_nb(b, _key(3), big)                        # rndv
            assert not sb.test()
            rb = b.recv_nb(_key(3), np.zeros(1 << 14, np.float32))
            assert rb.test() and sb.test()
            assert (a.n_direct, a.n_eager, a.n_rndv) == (1, 1, 1)
            assert b.occupancy()["unexpected"] == 1   # the eager message
            assert b.fence("t", 1) == 1        # the parked eager message
            assert b.occupancy()["unexpected"] == 0
            assert a.send_nb(b, _key(4), np.ones(2, np.float32)).test()
            assert a.n_fenced == 1
        finally:
            a.close()
            b.close()

    def test_eager_limit_knob(self, monkeypatch):
        from ucc_tpu_torch.tl.host.transport import InProcTransport
        monkeypatch.setenv("UCC_HOST_EAGER_LIMIT", "64")
        a, b = InProcTransport(), InProcTransport()
        try:
            assert a.EAGER_THRESHOLD == 64
            assert not a.send_nb(b, _key(1), np.zeros(17, np.float32)).test()
            assert a.send_nb(b, _key(2), np.zeros(16, np.float32)).test()
        finally:
            a.close()
            b.close()


def _job(n, **env):
    import threading
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        world = ut.ThreadOobWorld(n)
        libs = [ut.init(TLS="shm,self") for _ in range(n)]
        ctxs = [None] * n

        def make(r):
            ctxs[r] = ut.Context(libs[r], ut.ContextParams(
                oob=world.endpoint(r)))
        ths = [threading.Thread(target=make, args=(r,)) for r in range(n)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    tw = ut.ThreadOobWorld(n)
    teams = [c.create_team_post(ut.TeamParams(oob=tw.endpoint(r)))
             for r, c in enumerate(ctxs)]
    while not all([t.create_test() != ut.Status.IN_PROGRESS for t in teams]):
        for c in ctxs:
            c.progress()
    return ctxs, teams


@pytest.mark.parametrize("matcher", ["y", "n"])
def test_allreduce_over_each_matcher(matcher):
    n, count = 4, 1 << 15            # 128 KiB a rank: rendezvous sends
    ctxs, teams = _job(n, UCC_TL_SHM_NATIVE=matcher)
    try:
        for c in ctxs:
            tr = c.tl_contexts["shm"].obj.transport
            assert (tr.native is not None) == (matcher == "y")
        srcs = [torch.full((count,), float(r + 1)) for r in range(n)]
        dsts = [torch.zeros(count) for _ in range(n)]
        reqs = [t.collective_init(ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
            src=ut.BufferInfo(s, count, ut.DataType.FLOAT32),
            dst=ut.BufferInfo(d, count, ut.DataType.FLOAT32)))
            for t, s, d in zip(teams, srcs, dsts)]
        for rq in reqs:
            rq.post()
        while not all([rq.test() != ut.Status.IN_PROGRESS for rq in reqs]):
            for c in ctxs:
                c.progress()
        assert all(rq.test() == ut.Status.OK for rq in reqs)
        for d in dsts:
            assert torch.equal(d, torch.full((count,), 10.0))
    finally:
        for t in teams:
            t.destroy()
        for c in ctxs:
            c.destroy()


@pytest.mark.parametrize("use_native", [True, False])
def test_concurrent_senders_and_receivers(use_native):
    """More threads than cores push and post on one endpoint at once,
    sends and recvs of each key racing each other, under a short switch
    interval: every message lands exactly once, in the recv of its key."""
    import threading
    from ucc_tpu_torch.tl.host.transport import InProcTransport
    a, b = InProcTransport(use_native), InProcTransport(use_native)
    threads, per = 2 * (os.cpu_count() or 4), 200
    got = [[None] * per for _ in range(threads)]
    errors = []

    def work(i):
        try:
            reqs = []
            for k in range(per):
                dst = np.zeros(3, np.int64)
                if k % 2:
                    reqs.append((k, dst, b.recv_nb(_key(i, slot=k), dst)))
                    a.send_nb(b, _key(i, slot=k),
                              np.full(3, i * 1000 + k, np.int64))
                else:
                    a.send_nb(b, _key(i, slot=k),
                              np.full(3, i * 1000 + k, np.int64))
                    reqs.append((k, dst, b.recv_nb(_key(i, slot=k), dst)))
            for k, dst, rq in reqs:
                assert rq.test() and rq.error is None
                got[i][k] = dst.copy()
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=work, args=(i,))
               for i in range(threads)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ths)
    finally:
        sys.setswitchinterval(old)
        a.close()
        b.close()
    assert not errors, errors[0]
    for i in range(threads):
        for k in range(per):
            assert (got[i][k] == i * 1000 + k).all()


# ---------------------------------------------------------------------------
# C10: the JAX package's core lost to a torn first load in a worker
# ---------------------------------------------------------------------------

@pytest.fixture
def torn_reference_core():
    """The state ``ucc_tpu.native.get_lib`` leaves behind when dlopen saw
    its library half-linked by another process ("file too short"): the
    attempt is cached, the library is None. Restored after."""
    from ucc_tpu import native as jn
    assert jn.get_lib() is not None, "the reference's core must build here"
    saved = (jn._TRIED, jn._LIB, jn._EXT)
    jn._LIB = None
    yield jn
    if jn._LIB is None:
        jn._TRIED, jn._LIB, jn._EXT = saved


def test_reference_jobs_recover_from_a_torn_first_load(torn_reference_core):
    """C10: a worker whose first load of the JAX package's core failed ran
    every later reference job on the Python matcher, and the port's
    comparisons that read the reference's native features failed (no
    +plan rows). A reference job made through torch_host_jobs.Job loads
    the core again, and its rows are a fresh process's."""
    import ucc_tpu

    from torch_gen_jobs import GenJob
    jobs = [GenJob(ucc_tpu, 4), GenJob(ut, 4)]
    try:
        assert torn_reference_core._LIB is not None
        ref, port = (j.info(4) for j in jobs)
        assert any("+plan" in ln for ln in ref)
        assert ref == port
    finally:
        for j in jobs:
            j.destroy()


def test_port_build_never_exposes_a_half_linked_library(tmp_path,
                                                         monkeypatch):
    """The port's own build links into a temporary name and renames it,
    so a process that finds the library finds it whole (what the JAX
    package's in-place ``make`` does not give, C10)."""
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    seen = []
    real_run = subprocess.run

    def run(cmd, *a, **kw):
        out = cmd[cmd.index("-o") + 1]
        r = real_run(cmd, *a, **kw)
        seen.append((out, os.path.exists(native.library_path())))
        return r
    monkeypatch.setattr(native.subprocess, "run", run)
    path = native.build()
    assert len(seen) == 1
    out, final_existed = seen[0]
    assert out != path and out.endswith(".tmp") and not final_existed
    assert os.path.isfile(path) and not os.path.exists(out)
