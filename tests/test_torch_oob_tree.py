"""The port's OOBs that cross processes (``ucc_tpu_torch/core/oob.py``):
the tree layout, the thread and TCP tree allgathers, the TCP store with
its cookie handshake and bootstrap deadline, subset capability, and
``TransportOob`` over a live service team, held against the JAX
package's ``core/oob.py`` where both compute the same thing.

Ports come from ``tools/perftest.HeldPorts``: held bound until the stores
have bound over them, so no concurrent test is handed one.
"""
import os
import socket
import threading
import time

import pytest

import ucc_tpu.core.oob as joob
import ucc_tpu_torch as ut
import ucc_tpu_torch.core.oob as toob
from ucc_tpu_torch.tools.perftest import HeldPorts


def _run_threads(n, fn, timeout=60):
    errs = []

    def wrap(r):
        try:
            fn(r)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errs.append((r, e))

    ths = [threading.Thread(target=wrap, args=(r,)) for r in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout)
    assert not errs, errs


# ---------------------------------------------------------------------------
# layout: a pure function, equal to the reference's
# ---------------------------------------------------------------------------

LAYOUTS = [(64, 8, 4), (5, "2,1", 2), (1, None, None), (4, 8, None),
           (16, None, 4), (100, "3,1,5", 3), (24, 3, 2), (512, 8, 8),
           (8, 2, 2), (13, [2, 3], 2), (7, "x", 2)]


@pytest.mark.parametrize("size,ppn,radix", LAYOUTS)
def test_layout_order_and_ports_equal_reference(size, ppn, radix):
    lay = toob.tree_layout(size, ppn, radix)
    assert lay == joob.tree_layout(size, ppn, radix)
    assert toob._tree_order(lay) == joob._tree_order(lay)
    assert toob.TcpTreeOob.ports_needed(size, ppn, radix) == \
        joob.TcpTreeOob.ports_needed(size, ppn, radix)


class TestTreeLayout:
    def test_symmetric(self):
        lay = toob.tree_layout(64, ppn=8, radix=4)
        assert [len(groups) for groups in lay] == [8, 2, 1]
        assert lay[1][0] == [0, 8, 16, 24]
        assert lay[2][0] == [0, 32]

    def test_every_level_partitions_leaders(self):
        lay = toob.tree_layout(100, ppn="3,1,5", radix=3)
        assert sorted(r for g in lay[0] for r in g) == list(range(100))
        for lvl in range(1, len(lay)):
            members = sorted(r for g in lay[lvl] for r in g)
            assert members == sorted(g[0] for g in lay[lvl - 1])
        assert len(lay[-1]) == 1


@pytest.mark.parametrize("raw,n,host,want", [
    ("auto", 40, None, True), ("auto", 8, None, False),
    ("auto", 40, "10.0.0.1", False), ("tree", 2, "10.0.0.1", True),
    ("y", 2, None, True), ("n", 64, None, False), ("bogus", 64, None, True)])
def test_tree_mode_knob_equals_reference(monkeypatch, raw, n, host, want):
    monkeypatch.setenv("UCC_OOB_TREE", raw)
    assert toob.tree_mode_enabled(n, host) == want
    assert joob.tree_mode_enabled(n, host) == want


def test_tree_knobs_from_config_file(tmp_path, monkeypatch):
    cfg = tmp_path / "ucc.conf"
    cfg.write_text("UCC_OOB_TREE_RADIX=5\nUCC_OOB_TREE_THRESH=3\n")
    monkeypatch.delenv("UCC_OOB_TREE_RADIX", raising=False)
    monkeypatch.delenv("UCC_OOB_TREE_THRESH", raising=False)
    monkeypatch.setenv("UCC_CONFIG_FILE", str(cfg))
    assert (toob.tree_radix(), toob.tree_thresh()) == \
        (joob.tree_radix(), joob.tree_thresh()) == (5, 3)


# ---------------------------------------------------------------------------
# thread tree
# ---------------------------------------------------------------------------

class TestThreadTreeOob:
    def test_allgather_matches_world(self):
        n = 24
        eps = toob.ThreadTreeOobWorld(n, ppn=3, radix=2).endpoints()
        out = [None] * n

        def run(r):
            out[r] = eps[r].allgather(f"blob-{r}".encode()).result

        _run_threads(n, run)
        assert all(o == [f"blob-{r}".encode() for r in range(n)]
                   for o in out)

    def test_pipelined_rounds_stay_ordered(self):
        n = 12
        eps = toob.ThreadTreeOobWorld(n, ppn=4, radix=2).endpoints()
        out = [None] * n

        def run(r):
            reqs = [eps[r].allgather(f"{r}.{i}".encode()) for i in range(4)]
            out[r] = [rq.result for rq in reqs]

        _run_threads(n, run)
        for r in range(n):
            for i in range(4):
                assert out[r][i] == [f"{x}.{i}".encode() for x in range(n)]

    def test_empty_and_large_payloads(self):
        n = 9
        eps = toob.ThreadTreeOobWorld(n, ppn=3, radix=3).endpoints()
        payloads = [b"" if r % 2 else bytes([r]) * (10_000 + r)
                    for r in range(n)]
        out = [None] * n

        def run(r):
            out[r] = eps[r].allgather(payloads[r]).result

        _run_threads(n, run)
        assert all(o == payloads for o in out)

    @pytest.mark.parametrize("n", [64, 512])
    def test_rounds_and_fanin_equal_reference(self, n):
        """Per-allgather store rounds grow with the tree's depth and the
        fan-in stays max(ppn, radix); the stats equal the reference's."""
        stats = {}
        for name, mod in (("port", toob), ("ref", joob)):
            eps = mod.ThreadTreeOobWorld(n, ppn=8, radix=8).endpoints()
            out = [None] * n

            def run(r):
                out[r] = eps[r].allgather(str(r).encode()).result

            _run_threads(n, run)
            assert all(o == [str(x).encode() for x in range(n)]
                       for o in out)
            stats[name] = [dict(e.stats) for e in eps]
        assert stats["port"] == stats["ref"]
        assert stats["port"][0]["levels"] <= 3
        assert max(s["max_fanin"] for s in stats["port"]) == 8

    def test_single_rank_world(self):
        ep = toob.ThreadTreeOobWorld(1).endpoint(0)
        assert ep.allgather(b"solo").result == [b"solo"]
        assert ep.stats["rounds"] == 0


# ---------------------------------------------------------------------------
# TCP store and TCP tree
# ---------------------------------------------------------------------------

def _fds():
    return len(os.listdir("/proc/self/fd"))


class TestTcpStoreOob:
    def test_allgather_rounds(self):
        n = 4
        with HeldPorts(1) as held:
            ends = [None] * n
            _run_threads(n, lambda r: ends.__setitem__(
                r, ut.TcpStoreOob(r, n, port=held.ports[0], key="s",
                                  timeout_s=20)))
        out = [None] * n

        def ag(r):
            out[r] = [ends[r].allgather(f"{r}:{i}".encode() * (i + 1))
                      .result for i in range(3)]

        try:
            _run_threads(n, ag)
        finally:
            for e in ends:
                e.close()
        for r in range(n):
            for i in range(3):
                assert out[r][i] == [f"{x}:{i}".encode() * (i + 1)
                                     for x in range(n)]

    def test_cookie_and_wire_equal_reference(self):
        """The two packages speak one store protocol: a reference rank
        and a port rank share one store (either side hosting it)."""
        assert toob._store_cookie("k", 3) == joob._store_cookie("k", 3)
        for host_mod, guest_mod in ((joob, toob), (toob, joob)):
            with HeldPorts(1) as held:
                ends = [None] * 2
                mods = (host_mod, guest_mod)
                _run_threads(2, lambda r: ends.__setitem__(
                    r, mods[r].TcpStoreOob(r, 2, port=held.ports[0],
                                           key="mix", timeout_s=20)))
            out = [None] * 2
            try:
                _run_threads(2, lambda r: out.__setitem__(
                    r, ends[r].allgather(f"m{r}".encode()).result))
            finally:
                for e in ends:
                    e.close()
            assert out == [[b"m0", b"m1"]] * 2

    def test_foreign_cookie_refused(self, monkeypatch):
        """A client of another job (other key) reaches the store and is
        refused; the job's own ranks still bootstrap."""
        monkeypatch.setattr(toob, "CONNECT_BACKOFF_BASE", 0.01)
        with HeldPorts(1) as held:
            port = held.ports[0]
            ends = [None] * 2
            th = threading.Thread(target=lambda: ends.__setitem__(
                0, ut.TcpStoreOob(0, 2, port=port, key="mine",
                                  timeout_s=20)))
            th.start()
            with pytest.raises(OSError):
                ut.TcpStoreOob(1, 2, port=port, key="theirs", timeout_s=1.0)
            ends[1] = ut.TcpStoreOob(1, 2, port=port, key="mine",
                                     timeout_s=20)
            th.join(30)
        try:
            out = [None] * 2
            _run_threads(2, lambda r: out.__setitem__(
                r, ends[r].allgather(b"x%d" % r).result))
            assert out == [[b"x0", b"x1"]] * 2
        finally:
            for e in ends:
                e.close()

    def test_bootstrap_deadline_names_absent_ranks(self):
        with HeldPorts(1) as held:
            oob = ut.TcpStoreOob(0, 3, port=held.ports[0], key="late",
                                 timeout_s=10, bootstrap_timeout_s=0.5)
        try:
            with pytest.raises(ut.UccError) as ei:
                oob.allgather(b"a").result
            assert ei.value.status == ut.Status.ERR_TIMED_OUT
            assert "[1, 2]" in str(ei.value)
        finally:
            oob.close()

    def test_close_ends_threads_and_descriptors(self):
        base_threads = threading.active_count()
        base_fds = _fds()
        for _ in range(5):
            with HeldPorts(1) as held:
                ends = [None] * 3
                _run_threads(3, lambda r: ends.__setitem__(
                    r, ut.TcpStoreOob(r, 3, port=held.ports[0],
                                      timeout_s=20)))
            _run_threads(3, lambda r: ends[r].allgather(b"z").result)
            for e in ends:
                e.close()
        deadline = time.monotonic() + 10
        while threading.active_count() > base_threads and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert threading.active_count() == base_threads
        assert _fds() == base_fds


class TestTcpTreeOob:
    def test_allgather_over_sockets(self):
        n = 8
        need = toob.TcpTreeOob.ports_needed(n, ppn=2, radix=2)
        assert need == 7
        with HeldPorts(need, contiguous=True) as held:
            ends = [None] * n
            _run_threads(n, lambda r: ends.__setitem__(
                r, ut.TcpTreeOob(r, n, base_port=held.ports[0], key="t",
                                 ppn=2, radix=2, timeout_s=20)))
        out = [None] * n
        try:
            _run_threads(n, lambda r: out.__setitem__(
                r, ends[r].allgather(f"tcp{r}".encode()).result))
        finally:
            for e in ends:
                e.close()
        assert all(o == [f"tcp{r}".encode() for r in range(n)] for o in out)
        assert ends[0].stats["max_fanin"] == 2


# ---------------------------------------------------------------------------
# subset capability
# ---------------------------------------------------------------------------

class TestSubsetCapability:
    def test_members_only_round(self):
        w = ut.ThreadOobWorld(6)
        subs = [toob.SubsetOob(w.endpoint(r), [1, 2, 4]) for r in (1, 2, 4)]
        reqs = [s.allgather(f"m{s.oob_ep}".encode()) for s in subs]
        for rq in reqs:
            assert rq.result == [b"m0", b"m1", b"m2"]
        assert w.next_round == [0] * 6 and not w.rounds

    def test_participate_is_noop_on_capable_parent(self):
        w = ut.ThreadOobWorld(4)
        rq = toob.SubsetOob.participate(w.endpoint(3))
        assert rq.test() == ut.Status.OK
        assert w.next_round == [0] * 4

    def test_nested_subsets(self):
        w = ut.ThreadOobWorld(8)
        outer_ranks = [1, 3, 5, 7]
        outers = [toob.SubsetOob(w.endpoint(r), outer_ranks)
                  for r in outer_ranks]
        assert all(o.SUBSET_CAPABLE for o in outers)
        inners = [toob.SubsetOob(outers[1], [1, 3]),
                  toob.SubsetOob(outers[3], [1, 3])]
        reqs = [i.allgather(f"n{i.oob_ep}".encode()) for i in inners]
        for rq in reqs:
            assert rq.result == [b"n0", b"n1"]
        assert w.next_round == [0] * 8

    def test_store_parent_keeps_full_round_contract(self):
        """A TcpStoreOob is not subset-capable: a subset round rides a
        whole-store round, and the non-member participates."""
        n = 3
        with HeldPorts(1) as held:
            ends = [None] * n
            _run_threads(n, lambda r: ends.__setitem__(
                r, ut.TcpStoreOob(r, n, port=held.ports[0], timeout_s=20)))
        out = {}
        try:
            def run(r):
                if r == 0:
                    out[r] = toob.SubsetOob.participate(ends[0]).result
                else:
                    sub = toob.SubsetOob(ends[r], [1, 2])
                    assert not sub.SUBSET_CAPABLE
                    out[r] = sub.allgather(f"s{r}".encode()).result
            _run_threads(n, run)
        finally:
            for e in ends:
                e.close()
        assert out[1] == out[2] == [b"s1", b"s2"]


# ---------------------------------------------------------------------------
# TransportOob over a live service team
# ---------------------------------------------------------------------------

class TestTransportOobTree:
    @pytest.mark.parametrize("n", [2, 5, 9])
    def test_allgather(self, n, monkeypatch):
        from test_torch_shm_service import TorchJob
        monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
        job = TorchJob(n, TLS="shm,self")
        try:
            teams = job.create_team()

            def mk(r, epoch=7):
                svc = teams[r].service_team
                members = [int(teams[r].ctx_map.eval(i))
                           for i in range(teams[r].size)]
                return toob.TransportOob(
                    svc.comp_context, svc.transport, members,
                    teams[r].context.rank, ("test", teams[r].team_key),
                    epoch)

            oobs = [mk(r) for r in range(n)]
            payloads = [b"" if r == 1 else f"tp-{r}".encode() * (r + 1)
                        for r in range(n)]
            reqs = [oobs[r].allgather(payloads[r]) for r in range(n)]
            # every member is polled: interior members forward in test()
            job.until(lambda: all(
                [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]))
            for rq in reqs:
                assert rq.result == payloads
            reqs = [oobs[r].allgather(f"r2-{r}".encode()) for r in range(n)]
            job.until(lambda: all(
                [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]))
            for rq in reqs:
                assert rq.result == [f"r2-{x}".encode() for x in range(n)]
            # the tree is the reference's: parent and children per member
            k = toob.tree_radix()
            assert [rq.parent for rq in reqs] == \
                [None] + [(m - 1) // k for m in range(1, n)]
        finally:
            job.cleanup()

    def test_not_a_member_refused(self):
        with pytest.raises(ValueError):
            toob.TransportOob(None, None, [0, 2], 1, "k", 0)


def test_exports_match_reference():
    for name in ("TcpStoreOob", "TcpTreeOob", "ThreadTreeOobWorld",
                 "TreeOob", "tree_layout"):
        assert hasattr(ut, name), name


def test_no_listener_left_on_held_port():
    """HeldPorts: a released port binds again (nothing kept it)."""
    with HeldPorts(2) as held:
        ports = list(held.ports)
    for p in ports:
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", p))
        s.close()


def test_held_ports_block_is_contiguous_and_held():
    with HeldPorts(3, contiguous=True) as held:
        p = held.ports
        assert p == [p[0], p[0] + 1, p[0] + 2]
        s = socket.socket()
        with pytest.raises(OSError):
            s.bind(("127.0.0.1", p[1]))      # held: no plain bind gets it
        s.close()
