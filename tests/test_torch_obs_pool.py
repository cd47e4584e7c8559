"""The port's metrics registry, profiling trace, object pool, math helpers
and host scratch pool against the JAX package's: the same calls on both
give the same keys, values, trace fields and pool statistics."""
import importlib
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ucc_tpu.mc import pool as jpool  # noqa: E402
from ucc_tpu.obs import metrics as jmetrics  # noqa: E402
from ucc_tpu.utils import mathutils as jmath  # noqa: E402
from ucc_tpu.utils import mpool as jmpool  # noqa: E402
from ucc_tpu.utils import profiling as jprof  # noqa: E402
from ucc_tpu_torch.mc import pool as tpool  # noqa: E402
from ucc_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from ucc_tpu_torch.utils import mathutils as tmath  # noqa: E402
from ucc_tpu_torch.utils import mpool as tmpool  # noqa: E402
from ucc_tpu_torch.utils import profiling as tprof  # noqa: E402


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.fixture
def both_metrics():
    """Both registries enabled and empty; disabled and emptied after. The
    reference's gauge samplers (its host TLs publish their mailboxes at
    snapshot time, once imported) are set aside meanwhile: the port has
    none, and this file compares the series it records itself."""
    saved = [(m, m.ENABLED) for m in (jmetrics, tmetrics)]
    samplers, jmetrics._samplers = jmetrics._samplers, []
    for m in (jmetrics, tmetrics):
        m.reset()
        m.ENABLED = True
    yield jmetrics, tmetrics
    jmetrics._samplers = samplers
    for m, was in saved:
        m.reset()
        m.ENABLED = was


SEQUENCES = {
    "counters": [("inc", "coll_posted", 1, "core", "allreduce", "ring"),
                 ("inc", "coll_posted", 1, "core", "allreduce", "ring"),
                 ("inc", "coll_posted", 3, "core", "bcast", ""),
                 ("inc", "coll_fast_repost", 1, "core", "allreduce", "xla"),
                 ("inc", "mc_pool_miss", 1, "mc", "", "")],
    "gauges": [("gauge", "mc_pool_bytes", 4096, "mc", "", ""),
               ("gauge", "mc_pool_bytes", 1024, "mc", "", ""),
               ("gauge", "depth", 2.5, "schedule", "allgather", "ring")],
    "histograms": [("observe", "lat_us", v, "core", "allreduce", "ring")
                   for v in (0, 0.5, 1, 1.9, 2, 3, 1000, 1 << 20, 7.25)],
    "mixed": [("inc", "coll_failed", 1, "core", "alltoall", "a"),
              ("observe", "bytes", 65536, "tl", "alltoall", "a"),
              ("gauge", "q", -1, "", "", ""),
              ("inc", "coll_failed", 2, "core", "alltoall", "a"),
              ("observe", "bytes", 3, "tl", "alltoall", "b")],
}


def _replay(m, seq):
    for fn, name, value, comp, coll, alg in seq:
        getattr(m, fn)(name, value, component=comp, coll=coll, alg=alg)
    snap = m.snapshot()
    # through JSON, as dumps hold it (histogram buckets become strings)
    return json.loads(json.dumps({k: snap[k] for k in
                                  ("counters", "gauges", "histograms")}))


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_metrics_same_series(both_metrics, name):
    jm, tm = both_metrics
    want = _replay(jm, SEQUENCES[name])
    got = _replay(tm, SEQUENCES[name])
    assert got == want
    assert any(got.values())


def test_metrics_disabled_records_nothing(both_metrics):
    jm, tm = both_metrics
    for m in (jm, tm):
        m.disable()
        m.inc("x")
        m.observe("h", 5)
        m.gauge("g", 1)
    assert _replay(tm, []) == _replay(jm, []) == {
        "counters": {}, "gauges": {}, "histograms": {}}


def test_metrics_dump_lines(both_metrics, tmp_path):
    jm, tm = both_metrics
    lines = []
    for m, f in ((jm, tmp_path / "j.json"), (tm, tmp_path / "t.json")):
        _replay(m, SEQUENCES["mixed"])
        assert m.dump(str(f), reason="test") == str(f)
        rec = json.loads(f.read_text().splitlines()[0])
        assert rec["reason"] == "test" and rec["pid"] > 0
        lines.append({k: rec[k] for k in ("counters", "gauges",
                                          "histograms", "reason")})
    assert lines[0] == lines[1]


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def _trace(prof):
    prof.request_new("allreduce", 1, alg="ring")
    prof.span_begin("task_X", 1, coll="allreduce")
    prof.span_begin("pipeline_frag", 7, parent=1, frag_num=0)
    prof.span_end("pipeline_frag", 7, status="OK")
    prof.event("mark")
    prof.span_end("task_X", 1, status="OK")
    prof.request_complete("allreduce", 1, status="OK")


@pytest.fixture
def reload_profiling(monkeypatch):
    """reload(mode, tmp) -> (reference module, port module) reloaded with
    UCC_PROFILE_MODE=mode, each writing its own file; both reloaded with
    profiling off after the test."""
    mods = (jprof, tprof)

    def reload(mode, tmp):
        monkeypatch.setenv("UCC_PROFILE_MODE", mode)
        files = []
        for i, m in enumerate(mods):
            files.append(tmp / f"trace{i}.json")
            monkeypatch.setenv("UCC_PROFILE_FILE", str(files[-1]))
            importlib.reload(m)
            assert m.ENABLED
        return files

    yield reload
    monkeypatch.delenv("UCC_PROFILE_MODE", raising=False)
    monkeypatch.delenv("UCC_PROFILE_FILE", raising=False)
    for m in mods:
        if m._fh is not None:
            m._fh.close()
        importlib.reload(m)
        assert not m.ENABLED


def test_profile_log_same_records(reload_profiling, tmp_path):
    files = reload_profiling("log", tmp_path)
    recs = []
    for m, f in zip((jprof, tprof), files):
        _trace(m)
        m._fh.flush()
        recs.append([{k: v for k, v in json.loads(line).items()
                      if k not in ("ts", "pid", "tid")}
                     for line in f.read_text().splitlines()])
    assert recs[0] == recs[1]
    assert recs[1][0] == {"name": "coll_allreduce", "ph": "B", "seq": 1,
                          "span": 1, "alg": "ring"}
    assert [r["ph"] for r in recs[1]] == ["B", "B", "B", "E", "i", "E",
                                          "E"]
    assert recs[1][2]["parent"] == 1


def test_profile_accum_same_counts(reload_profiling, tmp_path):
    reload_profiling("accum", tmp_path)
    counts = []
    for m in (jprof, tprof):
        _trace(m)
        m.request_complete("allreduce", 1)    # an E with no B: not counted
        counts.append({k: int(v["count"]) for k, v in m._accum.items()})
    assert counts[0] == counts[1] == {"coll_allreduce": 1, "task_X": 1,
                                      "pipeline_frag": 1, "mark": 1}


# ---------------------------------------------------------------------------
# MPool and the math helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,max_elems,thread_safe", [
    (8, -1, False), (1, -1, True), (4, 2, False), (3, 0, True)])
def test_mpool_same_growth(chunk, max_elems, thread_safe):
    out = []
    for mod in (jmpool, tmpool):
        made = []
        p = mod.MPool(lambda: made.append(1) or len(made),
                      obj_reset=lambda o: None, elems_per_chunk=chunk,
                      max_elems=max_elems, thread_safe=thread_safe)
        trail = []
        held = []
        for step in range(12):
            if step % 4 == 3:
                p.put(held.pop())
            else:
                held.append(p.get())
            trail.append((p.num_allocated, p.num_free, len(made)))
        out.append((trail, held))
    assert out[0] == out[1]


INTS = [0, 1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 63, 64, 65, 1000, 1 << 20,
        (1 << 20) + 1]


@pytest.mark.parametrize("fn", ["ilog2", "is_pow2", "next_pow2"])
def test_math_unary(fn):
    for n in INTS + [-1, -8]:
        try:
            want = getattr(jmath, fn)(n)
        except ValueError:
            with pytest.raises(ValueError):
                getattr(tmath, fn)(n)
            continue
        assert getattr(tmath, fn)(n) == want, (fn, n)


@pytest.mark.parametrize("fn", ["gcd", "lcm", "div_round_up", "align_up"])
def test_math_binary(fn):
    for a in INTS:
        for b in [1, 2, 3, 7, 8, 64, 1000]:
            assert getattr(tmath, fn)(a, b) == getattr(jmath, fn)(a, b), \
                (fn, a, b)


@pytest.mark.parametrize("fn", ["block_count", "block_offset"])
def test_math_blocks(fn):
    for total in [0, 1, 7, 8, 9, 100, 1001]:
        for n in [1, 2, 3, 8]:
            for b in range(n):
                assert getattr(tmath, fn)(total, n, b) == \
                    getattr(jmath, fn)(total, n, b)


@pytest.mark.parametrize("fn", ["block_count_aligned",
                                "block_offset_aligned"])
def test_math_blocks_aligned(fn):
    for total in [0, 1, 7, 8, 9, 100, 1001, 4096 + 3]:
        for n in [1, 2, 3, 8]:
            for align in [1, 4, 16, 64]:
                for b in range(n):
                    assert getattr(tmath, fn)(total, n, b, align) == \
                        getattr(jmath, fn)(total, n, b, align), \
                        (fn, total, n, b, align)


def test_math_default_displs():
    for counts in ([], [3], [1, 0, 4, 2], list(range(9))):
        assert tmath.default_displs(counts) == jmath.default_displs(counts)


# ---------------------------------------------------------------------------
# HostMemPool / ScratchLease: the cases of tests/test_mc_pool.py, replayed
# ---------------------------------------------------------------------------

class _Side:
    """One package's pool module, its buffers' byte size and its dtypes."""

    def __init__(self, mod, nbytes, f32, i64, u8, f64):
        self.mod, self.nbytes = mod, nbytes
        self.f32, self.i64, self.u8, self.f64 = f32, i64, u8, f64


JAX_SIDE = _Side(jpool, lambda b: int(b.nbytes), np.float32, np.int64,
                 np.uint8, np.float64)
TORCH_SIDE = _Side(tpool, lambda b: int(b.numel()), torch.float32,
                   torch.int64, torch.uint8, torch.float64)


def case_miss_then_hit_same_class(s, log):
    p = s.mod.HostMemPool()
    a = p.get(1000)
    log(p, s.nbytes(a))
    p.put(a)
    b = p.get(900)
    log(p, b is a)


def case_distinct_classes_do_not_alias(s, log):
    p = s.mod.HostMemPool()
    a = p.get(100)
    p.put(a)
    b = p.get(100000)
    log(p, b is not a, s.nbytes(b) >= 100000)


def case_max_elems_cap(s, log):
    p = s.mod.HostMemPool(max_elems=1)
    a, b = p.get(512), p.get(512)
    log(p)
    p.put(a)
    p.put(b)
    log(p)


def case_max_bytes_cap(s, log):
    p = s.mod.HostMemPool(max_bytes=2048)
    bufs = [p.get(1024) for _ in range(3)]
    for buf in bufs:
        p.put(buf)
        log(p)


def case_oversize_bypasses_pool(s, log):
    p = s.mod.HostMemPool(max_elem_size=4096)
    a = p.get(10000)
    log(p, s.nbytes(a))
    p.put(a)
    log(p)


def case_disabled_pool_always_misses(s, log):
    p = s.mod.HostMemPool(enable=False)
    a = p.get(512)
    p.put(a)
    p.get(512)
    log(p)


def case_bucket_overflow_of_max_elem_size_goes_direct(s, log):
    p = s.mod.HostMemPool(max_elem_size=100 << 20)
    a = p.get(70 << 20)
    log(p, s.nbytes(a))
    p.put(a)
    b = p.get(50 << 20)
    log(p, s.nbytes(b))
    p.put(b)
    log(p)


def case_trim_and_reset_stats(s, log):
    p = s.mod.HostMemPool()
    for n in (64, 65, 4096, 1):
        p.put(p.get(n))
        log(p)
    p.trim()
    p.reset_stats()
    log(p)


def case_same_key_reuses_without_pool_traffic(s, log):
    p = s.mod.HostMemPool()
    lease = s.mod.ScratchLease(p)
    a = lease.get("x", 100, s.f32)
    log(p)
    b = lease.get("x", 100, s.f32)
    log(p, tuple(b.shape), len(lease))
    b[3] = 5
    log(p, float(a[3]))                 # the same memory


def case_growth_releases_old_and_refits(s, log):
    p = s.mod.HostMemPool()
    lease = s.mod.ScratchLease(p)
    lease.get("x", 100, s.f32)
    big = lease.get("x", 100000, s.f32)
    log(p, int(big.shape[0]))


def case_shape_and_dtype_views(s, log):
    lease = s.mod.ScratchLease(s.mod.HostMemPool())
    m = lease.get("m", (3, 5), s.i64)
    m[2, 4] = 7
    log(lease._pool, tuple(m.shape), int(m[2, 4]), str(m.dtype)[-5:])


def case_release_returns_everything(s, log):
    p = s.mod.HostMemPool()
    lease = s.mod.ScratchLease(p)
    lease.get("a", 128, s.u8)
    lease.get("b", 4096, s.f64)
    log(p)
    lease.release()
    log(p, len(lease))
    lease.release()
    log(p)


POOL_CASES = {f.__name__[5:]: f for f in (
    case_miss_then_hit_same_class, case_distinct_classes_do_not_alias,
    case_max_elems_cap, case_max_bytes_cap, case_oversize_bypasses_pool,
    case_disabled_pool_always_misses,
    case_bucket_overflow_of_max_elem_size_goes_direct,
    case_trim_and_reset_stats, case_same_key_reuses_without_pool_traffic,
    case_growth_releases_old_and_refits, case_shape_and_dtype_views,
    case_release_returns_everything)}


def _run_case(fn, side):
    trail = []
    fn(side, lambda pool, *seen: trail.append((pool.stats(), seen)))
    return trail


@pytest.mark.parametrize("name", sorted(POOL_CASES))
def test_pool_stats_match(name):
    want = _run_case(POOL_CASES[name], JAX_SIDE)
    got = _run_case(POOL_CASES[name], TORCH_SIDE)
    assert got == want
    assert got


def test_pool_buffers_are_flat_uint8_cpu_tensors():
    p = tpool.HostMemPool()
    a = p.get(1000)
    assert a.dtype == torch.uint8 and a.dim() == 1 and a.device.type == "cpu"
    assert not a.is_pinned()
    view = tpool.ScratchLease(p).get("k", (2, 3), torch.bfloat16)
    assert view.dtype == torch.bfloat16 and view.shape == (2, 3)


def test_pool_env_config(monkeypatch):
    monkeypatch.setenv("UCC_MC_POOL_MAX_ELEMS", "3")
    monkeypatch.setenv("UCC_MC_POOL_MAX_ELEM_SIZE", "1M")
    monkeypatch.setenv("UCC_MC_POOL_MAX_BYTES", "3M")
    monkeypatch.setenv("UCC_MC_POOL", "n")
    pools = [m._pool_from_env() for m in (jpool, tpool)]
    attrs = [(p.enable, p.max_elem_size, p.max_elems, p.max_bytes)
             for p in pools]
    assert attrs[0] == attrs[1] == (False, 1 << 20, 3, 3 << 20)
    monkeypatch.delenv("UCC_MC_POOL")
    monkeypatch.setenv("UCC_MC_POOL_ENABLE", "n")
    assert not tpool._pool_from_env().enable


def test_global_pool_swap():
    try:
        tpool.reset_host_pool()
        first = tpool.host_pool()
        assert tpool.host_pool() is first
        mine = tpool.HostMemPool(max_elems=1)
        tpool.reset_host_pool(mine)
        assert tpool.host_pool() is mine
    finally:
        tpool.reset_host_pool()


def test_pool_metrics(both_metrics):
    _, tm = both_metrics
    p = tpool.HostMemPool()
    p.put(p.get(100))
    p.get(100)
    snap = tm.snapshot()
    assert snap["counters"]["mc_pool_miss"] == {"mc||": 1}
    assert snap["counters"]["mc_pool_hit"] == {"mc||": 1}
    assert snap["gauges"]["mc_pool_bytes"] == {"mc||": 128}
