"""The port's tl/sockets (``ucc_tpu_torch/tl/sockets.py``) held against
the JAX package.

- Real processes: spawned workers (``torch_procs.job_worker``, which
  imports no JAX) bootstrap over ``TcpStoreOob`` under
  ``UCC_TLS=socket,self`` and run a matrix of collectives; the parent
  runs the same cases on the JAX package's tl/shm in threads, and every
  result must equal it bit for bit (host algorithms order their
  reductions the same whatever the transport), with the same algorithm.
- In one process: every algorithm id of the table pinned through
  ``UCC_TL_SOCKET_TUNE`` at team sizes 2, 3 and 5, bitwise the reference
  tl/shm under ``UCC_TL_SHM_TUNE``.
- A peer that dies ends the survivor's collective in an error, not a
  hang; a corrupt frame stream drops its connection, not the reader;
  preconnect opens the connections at team create; 20 context
  create/destroy cycles leave no thread or descriptor behind.
"""
import os
import pickle
import struct
import threading
import time
import zlib

import numpy as np
import pytest

import ucc_tpu
import ucc_tpu_torch as ut
import torch_procs as tp
from ucc_tpu_torch.tools.perftest import HeldPorts
from torch_host_jobs import Job, assert_same, env, run_cases

SWEEP = [
    {"coll": "ALLREDUCE", "dt": "FLOAT32", "c": 8, "op": "SUM"},
    {"coll": "ALLREDUCE", "dt": "FLOAT64", "c": 32768, "op": "AVG"},
    {"coll": "ALLREDUCE", "dt": "INT32", "c": 1000, "op": "MAX"},
    {"coll": "ALLREDUCE", "dt": "BFLOAT16", "c": 1031, "op": "SUM"},
    {"coll": "ALLREDUCE", "dt": "INT32", "c": 40, "op": "PROD"},
    {"coll": "ALLREDUCE", "dt": "FLOAT32", "c": 64, "op": "SUM",
     "inplace": True},
    {"coll": "BCAST", "dt": "INT32", "c": 8, "root": 1},
    {"coll": "BCAST", "dt": "FLOAT64", "c": 16384, "root": -1},
    {"coll": "REDUCE", "dt": "FLOAT64", "c": 1000, "op": "SUM", "root": 0},
    {"coll": "REDUCE", "dt": "INT64", "c": 50, "op": "MAX", "root": -1},
    {"coll": "ALLGATHER", "dt": "INT64", "c": 5},
    {"coll": "ALLGATHER", "dt": "FLOAT32", "c": 4096},
    {"coll": "ALLGATHERV", "dt": "INT32", "c": 3},
    {"coll": "ALLTOALL", "dt": "INT32", "c": 3},
    {"coll": "ALLTOALL", "dt": "FLOAT64", "c": 8},
    {"coll": "ALLTOALLV", "dt": "INT32", "c": 4},
    {"coll": "REDUCE_SCATTER", "dt": "FLOAT32", "c": 4, "op": "SUM"},
    {"coll": "REDUCE_SCATTERV", "dt": "FLOAT64", "c": 3, "op": "SUM"},
    {"coll": "GATHER", "dt": "INT32", "c": 4, "root": 0},
    {"coll": "GATHERV", "dt": "FLOAT32", "c": 4, "root": 0},
    {"coll": "SCATTER", "dt": "FLOAT32", "c": 3, "root": 2},
    {"coll": "SCATTERV", "dt": "INT32", "c": 3, "root": -1},
    {"coll": "ALLREDUCE", "dt": "FLOAT32", "c": 128, "op": "SUM",
     "rounds": 3},
    {"coll": "BARRIER"}, {"coll": "FANIN", "root": 0},
    {"coll": "FANOUT", "root": 0},
]


def cases_for(n, cases=SWEEP, seed=0):
    out = []
    for i, c in enumerate(cases):
        c = dict(c, seed=seed * 100 + i)
        if "root" in c:
            c["root"] = c["root"] % n
        out.append(c)
    return out


@pytest.fixture(scope="module")
def ref5():
    with env(UCC_GEN_NATIVE="n", UCC_QUANT=None, UCC_GEN=None,
             UCC_TL_SHM_TUNE=None, UCC_TL_SOCKET_BIND_HOST="127.0.0.1"):
        job = Job(ucc_tpu, 5)
        yield job
        job.destroy()


def run_job(n, procs, phases, env_=None, timeout=150, tree=None):
    """n ranks over ``procs`` spawned processes; returns per-phase,
    per-rank results (see torch_procs.collect)."""
    need = 1 + sum(p.get("n_teams", 1) for p in phases)
    with HeldPorts(need) as held:
        specs = [{"n": n, "ranks": ranks, "ports": held.ports,
                  "env": dict(env_ or {}), "phases": phases, "tree": tree}
                 for ranks in tp.split_ranks(n, procs)]
        res = tp.run_procs(tp.job_worker, specs, timeout=timeout)
    return tp.collect(res, n), res


def _by_case(phase, n, k):
    return [[tuple(phase[r]["cases"][i]) for r in range(n)]
            for i in range(k)]


SOCKET_ENV = {"UCC_TLS": "socket,self", "UCC_GEN_NATIVE": "n"}


def test_socket_tl_three_processes(ref5):
    n = 3
    cases = cases_for(n, SWEEP[:1] + SWEEP[6:7] + SWEEP[13:14]
                      + SWEEP[23:24], seed=1)
    phases, res = run_job(n, 3, [{"cases": cases, "n_teams": 2}],
                          SOCKET_ENV)
    ph = phases[0]
    assert_same(_by_case(ph, n, len(cases)), run_cases(ref5, cases, n),
                cases)
    assert {ph[r]["tier"] for r in range(n)} == {"socket"}
    assert {ph[r]["svc"] for r in range(n)} == {"socket"}
    # team ids agree across the processes, and equal the reference's for
    # the same sequence of creates
    ids = {tuple(ph[r]["ids"]) for r in range(n)}
    assert len(ids) == 1
    assert len({x["pid"] for x in res}) == 3


@pytest.mark.parametrize("n", [2, 4])
def test_socket_tl_sweep(ref5, n):
    cases = cases_for(n, seed=n)
    phases, _ = run_job(n, n, [{"cases": cases}], SOCKET_ENV)
    assert_same(_by_case(phases[0], n, len(cases)),
                run_cases(ref5, cases, n), cases)


def test_team_ids_equal_the_reference_sequence():
    """Three teams created in sequence over 3 processes hold one id per
    team on every member, equal to the reference's ids for the same
    sequence of creates in one process."""
    n = 3
    phases, _ = run_job(n, 3, [{"n_teams": 3}], SOCKET_ENV)
    ids = {tuple(phases[0][r]["ids"]) for r in range(n)}
    assert len(ids) == 1
    with env(UCC_TL_SOCKET_BIND_HOST="127.0.0.1"):
        job = Job(ucc_tpu, n)
    try:
        want = []
        for _ in range(3):
            world = ucc_tpu.ThreadOobWorld(n)
            teams = [job.contexts[r].create_team_post(
                ucc_tpu.TeamParams(oob=world.endpoint(r))) for r in range(n)]
            job.until(lambda: all(
                [t.create_test() != ucc_tpu.Status.IN_PROGRESS
                 for t in teams]))
            assert len({t.id for t in teams}) == 1
            want.append(teams[0].id)
            job.teams[len(job.teams)] = teams
        assert ids == {tuple(want)}
    finally:
        job.destroy()


# ---------------------------------------------------------------------------
# every algorithm, in one process, over sockets
# ---------------------------------------------------------------------------

def _table():
    from ucc_tpu_torch.tl.host.team import HostTlTeam
    from ucc_tpu_torch.tl.sockets import TlSocket

    class Stub(HostTlTeam):
        TL_CLS = TlSocket

        def __init__(self):
            self.size = 8
            self.core_team = None

    return {c.name: [(s.id, s.name) for s in specs]
            for c, specs in Stub().alg_table().items()}


ALGS = [(c, i, name) for c, specs in _table().items() for i, name in specs]
ROOTED = ("BCAST", "REDUCE", "GATHER", "SCATTER", "GATHERV", "SCATTERV",
          "FANIN", "FANOUT")


@pytest.fixture(scope="module")
def sock5():
    with env(UCC_TL_SOCKET_TUNE=None):
        job = Job(ut, 5, tls="socket,self", tune_var="UCC_TL_SOCKET_TUNE")
        yield job
        job.destroy()


def _count(coll):
    return {"BCAST": 1031, "ALLREDUCE": 1031, "REDUCE": 1031}.get(coll, 67)


@pytest.mark.parametrize("n", (2, 3, 5))
@pytest.mark.parametrize("coll,alg_id,alg", ALGS)
def test_every_algorithm_id_matches_the_reference(ref5, sock5, coll, alg_id,
                                                  alg, n):
    """Pinned by id (``@<id>``) through UCC_TL_SOCKET_TUNE, the reference
    by the same id through UCC_TL_SHM_TUNE (the tables share ids and
    names): the same algorithm, the same bytes. Both packages name a
    task pinned by id after the id."""
    case = {"coll": coll, "dt": "FLOAT32", "c": _count(coll),
            "seed": n * 7 + alg_id, "root": n - 1 if coll in ROOTED else 0,
            "op": "SUM" if coll in ("ALLREDUCE", "REDUCE", "REDUCE_SCATTER",
                                    "REDUCE_SCATTERV") else None}
    if coll in ("BARRIER", "FANIN", "FANOUT"):
        case.pop("dt")
    if alg == "sliding_window":
        # it reduces each window in get-completion order (both packages),
        # which over TCP is not the in-process order: exact data only
        # (ROADMAP C)
        case["dt"] = "INT32"
    tune = f"{coll.lower()}:@{alg_id}:inf"
    got = run_cases(sock5, [case], n, tune=tune)
    want = run_cases(ref5, [case], n, tune=tune)
    assert_same(got, want, [case])
    assert {g[1] for g in got[0]} <= {str(alg_id), None}


# ---------------------------------------------------------------------------
# failure: a dead peer, a corrupt stream
# ---------------------------------------------------------------------------

def test_peer_death_surfaces_as_error():
    with HeldPorts(2) as held:
        spec = {"n": 2, "ports": held.ports}
        t0 = time.monotonic()
        res = tp.run_procs(tp.death_worker, [spec, spec], timeout=90)
    assert time.monotonic() - t0 < 90
    assert res[1].get("out") == "died", res[1]
    assert res[0].get("out") in ("ERR_TIMED_OUT", "ERR_NO_MESSAGE",
                                 "ERR_NO_RESOURCE"), res[0]
    assert not res[0]["jax"] and not res[1]["jax"]


class TestReaderDesyncHardening:
    @staticmethod
    def _transport():
        from ucc_tpu_torch.tl.sockets import SocketTransport
        return SocketTransport(bind_host="127.0.0.1")

    @staticmethod
    def _capture():
        import logging

        class _ListHandler(logging.Handler):
            def __init__(self):
                super().__init__(level=logging.ERROR)
                self.lines = []

            def emit(self, record):
                self.lines.append(record.getMessage())

        h = _ListHandler()
        logging.getLogger("ucc_tpu_torch").addHandler(h)
        return h

    @staticmethod
    def _uncapture(h):
        import logging
        logging.getLogger("ucc_tpu_torch").removeHandler(h)

    @staticmethod
    def _send_raw(tr, blob):
        import socket as pysock
        c = pysock.create_connection((tr.host, tr.port), timeout=10)
        c.sendall(blob)
        return c

    @staticmethod
    def _wait_for(h, word):
        t0 = time.monotonic()
        while time.monotonic() - t0 < 10:
            if any(word in ln for ln in h.lines):
                return True
            time.sleep(0.02)
        return False

    @staticmethod
    def _eof(c):
        c.settimeout(5)
        try:
            assert c.recv(1) == b""
        except ConnectionError:
            pass
        c.close()

    def test_implausible_header_drops_connection(self):
        h = self._capture()
        tr = self._transport()
        try:
            bad = struct.pack("!IQIQ", 0x912CE0A1, 7, 0, 0) + b"x" * 32
            c = self._send_raw(tr, bad)
            assert self._wait_for(h, "desync"), "no desync log"
            self._eof(c)
        finally:
            tr.close()
            self._uncapture(h)

    def test_key_crc_mismatch_drops_connection(self):
        h = self._capture()
        tr = self._transport()
        try:
            kb = pickle.dumps(("team", 1, 0, 0))
            bad = struct.pack("!IQIQ", len(kb), 0, 12345, 0) + kb
            c = self._send_raw(tr, bad)
            assert self._wait_for(h, "ERR_DATA_CORRUPTED")
            self._eof(c)
        finally:
            tr.close()
            self._uncapture(h)

    def test_garbage_key_drops_connection_not_thread(self):
        from ucc_tpu_torch.tl.host.transport import RecvReq
        h = self._capture()
        tr = self._transport()
        try:
            kb = b"\x00garbage-not-pickle"
            bad = struct.pack("!IQIQ", len(kb), 4,
                              zlib.crc32(kb) & 0xFFFFFFFF, 0) + kb + b"DATA"
            c = self._send_raw(tr, bad)
            assert self._wait_for(h, "desync")
            self._eof(c)
            # a good frame on a new connection is still delivered
            key = ("team", 1, 0, 0)
            kb2 = pickle.dumps(key)
            good = struct.pack("!IQIQ", len(kb2), 4,
                               zlib.crc32(kb2) & 0xFFFFFFFF, 0) + kb2 + \
                b"\x01\x02\x03\x04"
            c2 = self._send_raw(tr, good)
            dst = np.zeros(4, np.uint8)
            req = RecvReq(dst)
            tr.mailbox.post_recv(key, req)
            t0 = time.monotonic()
            while not req.test():
                assert time.monotonic() - t0 < 10, "good frame not delivered"
                time.sleep(0.02)
            np.testing.assert_array_equal(dst, [1, 2, 3, 4])
            c2.close()
        finally:
            tr.close()
            self._uncapture(h)

    def test_oversized_frame_fails_at_the_sender(self, monkeypatch):
        import ucc_tpu_torch.tl.sockets as sk
        monkeypatch.setattr(sk, "_MAX_FRAME_BYTES", 16)
        tr = self._transport()
        try:
            with pytest.raises(ut.UccError) as ei:
                tr.send_to_addr((tr.host, tr.port), ("k", 0, 0, 0, 0),
                                np.zeros(17, np.uint8))
            assert ei.value.status == ut.Status.ERR_INVALID_PARAM
        finally:
            tr.close()

    def test_frame_header_equals_the_reference(self):
        import ucc_tpu.tl.sockets as jsk
        import ucc_tpu_torch.tl.sockets as sk
        assert sk._HDR.format == jsk._HDR.format == "!IQIQ"
        assert (sk._MAX_KEY_BYTES, sk._MAX_FRAME_BYTES) == \
            (jsk._MAX_KEY_BYTES, jsk._MAX_FRAME_BYTES)


class TestPreconnect:
    def _job(self, monkeypatch, preconnect):
        from test_torch_shm_service import TorchJob
        monkeypatch.setenv("UCC_TL_SOCKET_PRECONNECT", str(preconnect))
        return TorchJob(3, TLS="socket,self")

    def test_connections_up_at_team_create(self, monkeypatch):
        job = self._job(monkeypatch, 16)
        try:
            teams = job.create_team()
            for ctx in job.contexts:
                tr = ctx.tl_contexts["socket"].obj.transport
                assert len(tr._conns) >= 2, tr._conns.keys()
            srcs = [np.full(16, r + 1.0, np.float32) for r in range(3)]
            dsts = [np.zeros(16, np.float32) for _ in range(3)]
            reqs = [teams[r].collective_init(ut.CollArgs(
                coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
                src=ut.BufferInfo(srcs[r], 16, ut.DataType.FLOAT32),
                dst=ut.BufferInfo(dsts[r], 16, ut.DataType.FLOAT32)))
                for r in range(3)]
            for rq in reqs:
                rq.post()
            job.until(lambda: all(
                [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]))
            for d in dsts:
                np.testing.assert_array_equal(d, np.full(16, 6.0))
        finally:
            job.cleanup()

    def test_disabled_means_lazy(self, monkeypatch):
        job = self._job(monkeypatch, 0)
        try:
            teams = job.create_team()
            seen = 0
            for t in teams:
                for cl in t.cl_teams:
                    for tlt in getattr(cl, "tl_teams", []):
                        if tlt.NAME == "socket":
                            seen += 1
                            assert not tlt._want_preconnect
                            assert tlt._preconnect_reqs is None
            assert seen == 3
        finally:
            job.cleanup()


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------

def test_context_cycles_leave_no_threads_or_descriptors(monkeypatch):
    """20 create/destroy cycles of 3 socket contexts with a team and a
    collective each: the thread count and /proc/self/fd come back."""
    from test_torch_shm_service import TorchJob

    def cycle():
        job = TorchJob(3, TLS="socket,self")
        teams = job.create_team()
        bufs = [np.full(8, r, np.int32) for r in range(3)]
        reqs = [teams[r].collective_init(ut.CollArgs(
            coll_type=ut.CollType.BCAST, root=2,
            src=ut.BufferInfo(bufs[r], 8, ut.DataType.INT32)))
            for r in range(3)]
        for rq in reqs:
            rq.post()
        job.until(lambda: all(
            [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]))
        assert all(int(b[0]) == 2 for b in bufs)
        job.cleanup()

    cycle()                      # warm: lazily built state of the process
    threads = threading.active_count()
    fds = len(os.listdir("/proc/self/fd"))
    for _ in range(20):
        cycle()
    deadline = time.monotonic() + 10
    while threading.active_count() > threads and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == threads, \
        [t.name for t in threading.enumerate()]
    assert len(os.listdir("/proc/self/fd")) == fds


def test_default_bind_matches_the_reference(monkeypatch):
    """Unset, the listener binds every interface and advertises the one
    the reference advertises (the default route's), which a peer reaches;
    BIND_HOST binds and advertises that address alone."""
    from ucc_tpu.tl.sockets import _default_host as ref_default_host
    from ucc_tpu_torch.tl.sockets import SocketTransport, _default_host
    monkeypatch.delenv("UCC_TL_SOCKET_BIND_HOST", raising=False)
    assert _default_host() == ref_default_host()
    tr = SocketTransport()
    try:
        assert tr.host == _default_host()
        assert tr.lsock.getsockname()[0] == "0.0.0.0"
        peer = SocketTransport()
        try:
            got = np.zeros(4, np.int32)
            req = tr.recv_nb(("bind", 1), got)
            peer.send_to_addr((tr.host, tr.port), ("bind", 1),
                              np.arange(4, dtype=np.int32))
            deadline = time.monotonic() + 10
            while not req.test() and time.monotonic() < deadline:
                time.sleep(0.01)
            np.testing.assert_array_equal(got, np.arange(4))
        finally:
            peer.close()
    finally:
        tr.close()
    tr = SocketTransport("127.0.0.1")
    try:
        assert tr.host == "127.0.0.1"
        assert tr.lsock.getsockname()[0] == "127.0.0.1"
    finally:
        tr.close()


def test_sender_destroys_right_after_a_large_send():
    """A send completes once the kernel holds the frame. A sender that
    destroys its context and exits right after a frame larger than the
    socket buffers still delivers every byte: its connections close
    gracefully, not with a reset."""
    nbytes = 64 << 20
    with HeldPorts(1) as held:
        spec = {"ports": held.ports, "nbytes": nbytes, "seed": 7,
                "timeout": 30}
        res = tp.run_procs(tp.bulk_send_worker, [spec, spec], timeout=90)
    assert res[0].get("out") == "sent", res[0]
    assert res[1].get("out") == "equal", res[1]
    assert not res[0]["jax"] and not res[1]["jax"]


def test_closed_connections_leave_no_port_that_refuses_a_bind():
    """A graceful close leaves the connecting side's ephemeral port in
    TIME_WAIT. Outbound sockets are made with SO_REUSEADDR, so such a port
    still binds for a listener that sets it too (a store handed that
    port), as it would not if the connecting socket lacked the option."""
    import socket as pysock
    from ucc_tpu_torch.tl.sockets import SocketTransport
    a, b = SocketTransport("127.0.0.1"), SocketTransport("127.0.0.1")
    try:
        got = np.zeros(4, np.int32)
        req = b.recv_nb(("tw", 1), got)
        a.send_to_addr((b.host, b.port), ("tw", 1),
                       np.arange(4, dtype=np.int32))
        deadline = time.monotonic() + 10
        while not req.test() and time.monotonic() < deadline:
            time.sleep(0.01)
        np.testing.assert_array_equal(got, np.arange(4))
        ports = [c.getsockname()[1] for c in a._conns.values()]
        assert ports
    finally:
        a.close()
        b.close()
    for port in ports:
        s = pysock.socket()
        s.setsockopt(pysock.SOL_SOCKET, pysock.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
        finally:
            s.close()


def test_empty_tensor_with_stride_zero_is_an_empty_host_buffer():
    """torch.from_numpy of an empty array gives a tensor of stride 0; as a
    host buffer it is empty, not an error (a v-collective's zero count)."""
    import torch
    from ucc_tpu_torch.mc.cpu import _as_u8
    t = torch.from_numpy(np.zeros(0, np.float32)).clone()
    assert t.stride() == (0,)
    assert _as_u8(t).size == 0
    from test_torch_shm_service import TorchJob
    job = TorchJob(4, TLS="socket,self")
    try:
        teams = job.create_team()
        counts = [2, 0, 3, 0]
        displs = [0, 2, 2, 5]
        src = torch.arange(5, dtype=torch.float32)
        dsts = [torch.from_numpy(np.zeros(c, np.float32)).clone()
                for c in counts]
        reqs = [teams[r].collective_init(ut.CollArgs(
            coll_type=ut.CollType.SCATTERV, root=1,
            src=ut.BufferInfoV(src if r == 1 else None, counts, displs,
                               ut.DataType.FLOAT32),
            dst=ut.BufferInfo(dsts[r], counts[r], ut.DataType.FLOAT32)))
            for r in range(4)]
        for rq in reqs:
            rq.post()
        job.until(lambda: all(
            [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]))
        assert [rq.test() for rq in reqs] == [ut.Status.OK] * 4
        assert dsts[0].tolist() == [0.0, 1.0]
        assert dsts[2].tolist() == [2.0, 3.0, 4.0]
    finally:
        job.cleanup()


@pytest.mark.parametrize("tls", ["socket,self", "shm,socket,ipc,self"])
def test_candidate_lists_and_print_info_match(tls):
    """HOST candidate lists and print_info rows of an in-process team
    whose host TLs include tl/sockets (and tl/ipc, which declines a team
    of one process) equal the reference's."""
    n = 3
    with env(UCC_TL_SOCKET_BIND_HOST="127.0.0.1", UCC_TL_SHM_TUNE=None,
             UCC_TL_SOCKET_TUNE=None, UCC_GEN_NATIVE="n"):
        jobs = {"ref": Job(ucc_tpu, n, tls=tls), "port": Job(ut, n, tls=tls)}
    try:
        p = jobs["port"].team(n)[0].score_map
        j = jobs["ref"].team(n)[0].score_map
        assert p.print_info("t").replace("ucc_tpu_torch score map", "") == \
            j.print_info("t").replace("ucc_tpu score map", "")
        for coll in ut.CollType:
            for size in (0, 4095, 4097, 8193, 1 << 20):
                w = [(r.alg_name, r.score) for r in j.lookup(
                    ucc_tpu.CollType[coll.name], ucc_tpu.MemoryType.HOST,
                    size)]
                g = [(r.alg_name, r.score) for r in p.lookup(
                    coll, ut.MemoryType.HOST, size)]
                assert g == w, (coll, size)
    finally:
        for job in jobs.values():
            job.destroy()
