"""ucc_stats in the port (``ucc_tpu_torch.tools.stats``) against the JAX
package's tool: the reference's TestUccStatsTool cases on snapshots the
port's metrics registry writes, and the default, ``--qos`` and
``--integrity`` views printed by both tools on the same snapshot files,
which must agree line for line."""
import io
import os

import numpy as np
import pytest

from ucc_tpu.tools import stats as jstats
from ucc_tpu_torch.obs import metrics
from ucc_tpu_torch.tools import stats as tstats


@pytest.fixture
def stats(tmp_path):
    """Runtime-enabled metrics registry of the port, isolated per test."""
    metrics.reset()
    metrics.enable(file=str(tmp_path / "stats.json"))
    yield metrics
    metrics.disable()
    metrics.reset()


def _both(capsys, argv):
    """(rc, output) of the port's and the JAX package's main on argv."""
    rc_t = tstats.main(argv)
    out_t = capsys.readouterr().out
    rc_j = jstats.main(argv)
    out_j = capsys.readouterr().out
    return (rc_t, out_t), (rc_j, out_j)


def test_print_and_diff(stats, tmp_path, capsys):
    metrics.inc("coll_posted", 3, component="core", coll="allreduce",
                alg="ring")
    metrics.observe("lat_us", 100, component="core")
    p1 = str(tmp_path / "a.json")
    metrics.dump(p1, reason="t0")
    metrics.inc("coll_posted", 2, component="core", coll="allreduce",
                alg="ring")
    p2 = str(tmp_path / "b.json")
    metrics.dump(p2, reason="t1")

    (rc, out), ref = _both(capsys, [p1])
    assert rc == 0
    assert "coll_posted" in out and "core/allreduce/ring" in out
    assert (rc, out) == ref
    (rc, out), ref = _both(capsys, [p1, p2])
    assert rc == 0 and "+2" in out
    assert (rc, out) == ref


def test_self_diff_and_missing(stats, tmp_path, capsys):
    p = str(tmp_path / "s.json")
    metrics.inc("x", 1)
    metrics.dump(p)
    metrics.inc("x", 4)
    metrics.dump(p)
    (rc, out), ref = _both(capsys, [p, "--self-diff"])
    assert rc == 0 and "+4" in out
    assert (rc, out) == ref
    assert tstats.main([str(tmp_path / "nope.json")]) == 1


def test_diff_last_two_of_one_file(stats, tmp_path, capsys):
    p = str(tmp_path / "d.json")
    metrics.inc("x", 1)
    metrics.dump(p)
    metrics.inc("x", 2)
    metrics.dump(p)
    metrics.inc("x", 5)
    metrics.dump(p)
    (rc, out), ref = _both(capsys, [p, "--diff"])
    # last two snapshots: 3 -> 8, delta +5 (not the first's +7)
    assert rc == 0 and "+5" in out
    assert (rc, out) == ref
    p1 = str(tmp_path / "one.json")
    metrics.dump(p1)
    assert tstats.main([p1, "--diff"]) == 1


@pytest.mark.parametrize("slot,q", [
    ({"count": 10, "max": 7.5, "buckets": {"3": 10}}, 0.50),
    ({"count": 100, "max": 600.0, "buckets": {"0": 90, "10": 10}}, 0.50),
    ({"count": 100, "max": 600.0, "buckets": {"0": 90, "10": 10}}, 0.99),
    ({"count": 0, "buckets": {}}, 0.5),
])
def test_percentiles_from_log2_buckets(slot, q):
    got = tstats.hist_percentile(slot, q)
    assert got == jstats.hist_percentile(slot, q)
    if slot["count"] == 10:
        # all ten samples in bucket 3 = [4, 8): p50 interpolates inside
        assert 4.0 <= got <= 7.5
    elif slot["count"] == 0:
        assert got == 0.0
    elif q == 0.50:
        assert got < 1.0
    else:
        # p99 inside the top bucket, clamped to the exact max
        assert 512.0 <= got <= 600.0


def test_percentiles_in_snapshot_output(stats):
    for v in (100, 200, 300, 400, 10000):
        metrics.observe("lat_us", v, component="core")
    snap = metrics.snapshot()
    outs = []
    for mod in (tstats, jstats):
        buf = io.StringIO()
        mod.print_snapshot(snap, buf)
        outs.append(buf.getvalue())
    out = outs[0]
    assert "p50=" in out and "p99=" in out
    # raw buckets only with show_buckets
    assert "13:1" not in out
    assert outs[0] == outs[1]
    buf = io.StringIO()
    tstats.print_snapshot(snap, buf, show_buckets=True)
    assert "14:1" in buf.getvalue()  # 10000 -> bucket 14


def test_watch_mode_prints_delta(stats, tmp_path, capsys):
    p = str(tmp_path / "w.json")
    metrics.inc("x", 3)
    metrics.dump(p)
    assert tstats.watch(p, interval=0.01, count=2) == 0
    out = capsys.readouterr().out
    assert "snapshot(s)" in out and "x" in out


def _qos_snapshot_from_a_storm(tmp_path):
    """A snapshot of a real port run with priority lanes and coalescing:
    two bulk-team bursts and one latency-team probe, metrics on."""
    import time

    import ucc_tpu_torch as ut
    from ucc_tpu_torch.core import coalesce
    from torch_ft_jobs import FtJob

    coalesce.configure(enabled=True, limit=8192, window_us=5e4,
                       max_batch=16)
    job = FtJob(2)
    try:
        teams = []
        for pr in (0, 3):
            world = ut.ThreadOobWorld(2)
            per = [job.contexts[r].create_team_post(
                ut.TeamParams(oob=world.endpoint(r), priority=pr))
                for r in range(2)]
            job.progress_until(lambda: all(
                [t.create_test() == ut.Status.OK for t in per]), 30)
            job.teams.append(per)
            teams.append(per)
        reqs = []
        for k in range(6):
            for r, t in enumerate(teams[0]):
                src = np.full(8, r + k, np.float32)
                rq = t.collective_init(ut.CollArgs(
                    coll_type=ut.CollType.ALLREDUCE,
                    src=ut.BufferInfo(src, 8, ut.DataType.FLOAT32),
                    dst=ut.BufferInfo(np.zeros(8, np.float32), 8,
                                      ut.DataType.FLOAT32),
                    op=ut.ReductionOp.SUM))
                rq.post()
                reqs.append(rq)
        for t in teams[1]:
            rq = t.collective_init(ut.CollArgs(
                coll_type=ut.CollType.BARRIER))
            rq.post()
            reqs.append(rq)
        time.sleep(0.02)
        job.progress_until(lambda: all(
            [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]), 30)
        assert all(rq.test() == ut.Status.OK for rq in reqs)
    finally:
        job.cleanup()
        coalesce.configure(enabled=False)
    p = str(tmp_path / "qos.json")
    metrics.dump(p, reason="storm")
    return p


def test_qos_view_matches_the_jax_tool(stats, tmp_path, capsys,
                                       monkeypatch):
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    p = _qos_snapshot_from_a_storm(tmp_path)
    (rc, out), ref = _both(capsys, [p, "--qos"])
    assert rc == 0
    assert "[queue wait, us]" in out
    assert "[coalesce batch size]" in out
    assert "qos_coalesce_fused" in out
    assert (rc, out) == ref


def test_integrity_view_matches_the_jax_tool(stats, tmp_path, capsys):
    metrics.inc("integrity_wire_mismatch", 2, component="integrity")
    metrics.inc("integrity_digest_checks", 8, component="integrity",
                coll="allreduce")
    metrics.inc("integrity_digest_mismatch", 1, component="integrity")
    metrics.inc("integrity_quarantines", 1, component="integrity")
    p = str(tmp_path / "i.json")
    metrics.dump(p, reason="drill")
    (rc, out), ref = _both(capsys, [p, "--integrity"])
    assert rc == 0
    assert "digest mismatch ratio: 1/8 (12.50%)" in out
    assert (rc, out) == ref
    empty = str(tmp_path / "e.json")
    metrics.reset()
    metrics.dump(empty)
    (rc, out), ref = _both(capsys, [empty, "--integrity"])
    assert "no integrity_* series" in out and (rc, out) == ref


def test_cli_runs_as_a_module(stats, tmp_path):
    import subprocess
    import sys
    metrics.inc("coll_posted", 1, component="core")
    p = str(tmp_path / "m.json")
    metrics.dump(p)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "ucc_tpu_torch.tools.stats",
                        p], cwd=root, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "coll_posted" in r.stdout
