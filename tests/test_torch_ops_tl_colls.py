"""tl/torch_ops's collective types beyond allreduce and bcast, against the
JAX package's tl/xla: the same numpy inputs through ucc_tpu_torch (device
"cpu", CUDA memory, persistent requests posted 3 times) and through
ucc_tpu on the virtual CPU mesh, ``xla`` pinned on both sides by a TUNE
string, at 2, 4 and 8 ranks, on float32, bfloat16, float16, int8, int32
and float64, with totals that n does and does not divide, uneven
v-counts, and roots 0, 3 and 7.

Moves and integer reductions agree bitwise; float32 reductions within
rtol 1e-4 / atol 1e-5 (the two sum in different orders); float16 and
bfloat16 reductions, on inputs 1 + 0.3·N(0, 1), each within rtol 1e-2 of
the float64 reduction of the same inputs, the reference's own tolerance
(tests/test_tl_xla.py). JAX runs with x64 off here, so float64 is held to
the reference run on the same values in float32 (they are float32 values):
moves exactly, reductions to the float64 reduction within rtol 1e-12.
REDUCE and an evenly split REDUCE_SCATTER of MAX or MIN fail in the
reference (its ``ops._gather_reduce`` has neither); the port's, held to
the float64 reduction, are exact.

Then ``ring`` and ``short`` bitwise against tl/xla's, the candidate lists
and score rows of a CUDA-memory team against tl/xla's on TPU memory, the
layouts the reference does not share (in place, gapped displacements),
and the refusals."""
import ml_dtypes
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import ucc_tpu  # noqa: E402
from torch_stack_cases import (Buf, bits, jax_buffer_info,  # noqa: E402
                               jax_coll, make_jax_job, make_torch_job,
                               torch_buffer_info, torch_coll)

import ucc_tpu_torch as ut  # noqa: E402
from ucc_tpu_torch.utils.mathutils import (block_count,  # noqa: E402
                                           block_offset)

PIN = "@xla:inf"
NP = {"FLOAT32": np.float32, "BFLOAT16": ml_dtypes.bfloat16,
      "FLOAT16": np.float16, "INT8": np.int8, "INT32": np.int32,
      "FLOAT64": np.float64}
DTYPES = list(NP)
HALF = ("BFLOAT16", "FLOAT16")
INTS = ("INT8", "INT32")
FLOAT_OPS = ("SUM", "PROD", "AVG", "MAX", "MIN")
INT_OPS = ("SUM", "MAX", "BXOR", "PROD", "MIN", "BAND")
_JOBS = {}


def jobs(n, short=False):
    """(reference job, its teams, port job) of n ranks, ``xla`` pinned
    (``short`` left to the default selection when *short*)."""
    key = (n, short)
    if key not in _JOBS:
        tune = "" if short else PIN
        job, teams = make_jax_job(tune, tl="xla", n=n)
        env = {} if short else {"UCC_TL_TORCH_OPS_TUNE": PIN}
        _JOBS[key] = (job, teams, make_torch_job(n=n, **env))
    return _JOBS[key]


@pytest.fixture(scope="module", autouse=True)
def _cleanup():
    yield
    for job, _, tjob in _JOBS.values():
        job.cleanup()
        tjob.cleanup()
    _JOBS.clear()


def data(dt, count, rng, op="SUM"):
    """One rank's input: small integers (-1..1 for PROD, which the
    reference computes in int32), 1 + 0.3·N(0, 1) for the half types, a
    normal sample in float32 values otherwise."""
    if dt in INTS:
        lo, hi = (-1, 2) if op == "PROD" else \
            ((-5, 6) if dt == "INT8" else (-50, 51))
        return rng.integers(lo, hi, count).astype(NP[dt])
    if dt in HALF:
        return (1 + 0.3 * rng.standard_normal(count)).astype(NP[dt])
    return rng.standard_normal(count).astype(np.float32).astype(NP[dt])


def reduce64(hosts, op):
    """The float64 reduction of the ranks' inputs."""
    st = np.stack([h.astype(np.float64) for h in hosts])
    return {"SUM": st.sum(0), "AVG": st.mean(0), "MAX": st.max(0),
            "MIN": st.min(0), "PROD": st.prod(0)}[op]


def uneven(n, rng, hi=6):
    return [int(c) for c in rng.integers(0, hi, n)]


def build(coll, n, dt, odd, root, op, seed):
    """Every rank's (src Buf, dst Buf), and what each rank's result is
    compared on: ("all", slice) per rank, or None where it has none."""
    rng = np.random.default_rng(seed)
    r_all = range(n)
    if coll == "REDUCE":
        count = 37 if odd else 40
        hosts = [data(dt, count, rng, op) for _ in r_all]
        bufs = [(Buf(h), Buf(size=count) if r == root else None)
                for r, h in enumerate(hosts)]
        return hosts, bufs, [slice(0, count) if r == root else None
                             for r in r_all]
    if coll == "REDUCE_SCATTER":
        total = 5 * n + (3 if odd else 0)
        hosts = [data(dt, total, rng, op) for _ in r_all]
        bufs = [(Buf(h), Buf(size=block_count(total, n, r)))
                for r, h in enumerate(hosts)]
        return hosts, bufs, [slice(block_offset(total, n, r),
                                   block_offset(total, n, r) +
                                   block_count(total, n, r)) for r in r_all]
    if coll == "REDUCE_SCATTERV":
        counts = uneven(n, rng)
        total = sum(counts)
        hosts = [data(dt, total, rng, op) for _ in r_all]
        bufs = [(Buf(h), Buf(size=total, counts=counts)) for h in hosts]
        offs = np.cumsum([0] + counts)
        return hosts, bufs, [slice(offs[r], offs[r + 1]) for r in r_all]
    if coll in ("ALLGATHER", "GATHER"):
        c = 7 if odd else 5
        hosts = [data(dt, c, rng) for _ in r_all]
        bufs = [(Buf(h), Buf(size=n * c)
                 if coll == "ALLGATHER" or r == root else None)
                for r, h in enumerate(hosts)]
    elif coll in ("ALLGATHERV", "GATHERV"):
        counts = uneven(n, rng)
        hosts = [data(dt, counts[r], rng) for r in r_all]
        bufs = [(Buf(h), Buf(size=sum(counts), counts=counts))
                for h in hosts]
    elif coll == "ALLTOALL":
        total = 5 * n + (3 if odd else 0)
        hosts = [data(dt, total, rng) for _ in r_all]
        bufs = [(Buf(h), Buf(size=total)) for h in hosts]
    elif coll == "ALLTOALLV":
        m = rng.integers(0, 5, (n, n))
        hosts = [data(dt, int(m[r].sum()), rng) for r in r_all]
        bufs = [(Buf(hosts[r], counts=[int(x) for x in m[r]]),
                 Buf(size=int(m[:, r].sum()),
                     counts=[int(x) for x in m[:, r]])) for r in r_all]
    elif coll == "SCATTER":
        c = 5
        hosts = [data(dt, n * c + (3 if odd else 0), rng)]
        bufs = [(Buf(hosts[0]) if r == root else None, Buf(size=c))
                for r in r_all]
    else:                                              # SCATTERV
        counts = uneven(n, rng)
        hosts = [data(dt, sum(counts), rng)]
        bufs = [(Buf(hosts[0], counts=counts) if r == root else None,
                 Buf(size=counts[r])) for r in r_all]
    gathers = coll in ("GATHER", "GATHERV")
    return hosts, bufs, [None if gathers and r != root else slice(None)
                         for r in r_all]


def cases():
    out = []
    colls = ["REDUCE", "REDUCE_SCATTER", "REDUCE_SCATTERV", "ALLGATHER",
             "ALLGATHERV", "GATHER", "GATHERV", "ALLTOALL", "ALLTOALLV",
             "SCATTER", "SCATTERV"]
    for ci, coll in enumerate(colls):
        for i, dt in enumerate(DTYPES):
            ops = INT_OPS if dt in INTS else FLOAT_OPS
            op = ops[(i + ci) % len(ops)] if coll.startswith("REDUCE") \
                else None
            out.append((coll, dt, (2, 4, 8)[i % 3], i % 2 == 1,
                        (0, 3, 7)[i % 3], op))
    return out


def _ref_inputs(dt, bufs):
    """float64 runs in the reference as the same values in float32."""
    if dt != "FLOAT64":
        return dt, bufs

    def f32(b):
        if b is None or b.data is None:
            return b
        return Buf(b.data.astype(np.float32), b.size, b.counts, b.displs)
    return "FLOAT32", [(f32(s), f32(d)) for s, d in bufs]


@pytest.mark.parametrize("coll,dt,n,odd,root,op", cases())
def test_collective_matches_tl_xla(coll, dt, n, odd, root, op):
    job, teams, tjob = jobs(n)
    hosts, bufs, parts = build(coll, n, dt, odd, root, op,
                               seed=sum(map(ord, coll + dt)))
    if coll == "SCATTER" and odd:
        # uneven blocks belong to scatterv, in both packages; only the
        # root sees them (the other ranks would take a tag, so they do
        # not post here)
        (src, dst), td = bufs[root], ut.dt_torch(ut.DataType[dt])
        with pytest.raises(ucc_tpu.UccError) as ej:
            teams[root].collective_init(ucc_tpu.CollArgs(
                coll_type=ucc_tpu.CollType.SCATTER, root=root,
                src=jax_buffer_info(job, root, src, ucc_tpu.DataType[dt]),
                dst=jax_buffer_info(job, root, dst, ucc_tpu.DataType[dt])))
        with pytest.raises(ut.UccError) as et:
            tjob.teams[root].collective_init(ut.CollArgs(
                coll_type=ut.CollType.SCATTER, root=root,
                src=torch_buffer_info(src, ut.DataType[dt], td),
                dst=torch_buffer_info(dst, ut.DataType[dt], td)))
        assert ej.value.status == ucc_tpu.Status.ERR_NOT_SUPPORTED
        assert et.value.status == ut.Status.ERR_NOT_SUPPORTED
        return
    got = torch_coll(tjob, coll, bufs, dt, op=op, root=root)
    reduces = op is not None
    ref_fails = op in ("MAX", "MIN") and (
        coll == "REDUCE" or coll == "REDUCE_SCATTER" and not odd)
    if reduces and (dt in HALF + ("FLOAT64",) or ref_fails):
        want64 = reduce64(hosts, op)
        rtol = 0 if ref_fails else 1e-12 if dt == "FLOAT64" else 1e-2
        wants = None
    else:
        rdt, rbufs = _ref_inputs(dt, bufs)
        wants = jax_coll(job, teams, coll, rbufs, rdt, op=op, root=root)
    for rnd in got:
        for r, part in enumerate(parts):
            if part is None:
                continue
            g = rnd[r]
            if coll in ("REDUCE_SCATTER", "REDUCE_SCATTERV"):
                g = g[:part.stop - part.start]
            elif coll == "REDUCE":
                g = g[part]
            if wants is None:
                np.testing.assert_allclose(g.astype(np.float64),
                                           want64[part], rtol=rtol)
                continue
            w = wants[r]
            assert g.shape == w.shape, (g.shape, w.shape)
            if dt == "FLOAT64":
                np.testing.assert_array_equal(g, w.astype(np.float64))
            elif reduces and dt not in INTS:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
            else:
                assert g.dtype == w.dtype or dt in INTS
                np.testing.assert_array_equal(bits(g.astype(w.dtype)),
                                              bits(w))
    if reduces and dt in HALF and not ref_fails:
        # the reference within the same tolerance of the float64 result
        wants = jax_coll(job, teams, coll, bufs, dt, op=op, root=root)
        for r, part in enumerate(parts):
            if part is not None:
                np.testing.assert_allclose(
                    wants[r][:part.stop - part.start].astype(np.float64)
                    if coll.startswith("REDUCE_") else
                    wants[r].astype(np.float64), want64[part], rtol=1e-2)


@pytest.mark.parametrize("coll", ["BARRIER", "FANIN", "FANOUT"])
@pytest.mark.parametrize("n,root", [(2, 0), (4, 3), (8, 7)])
def test_buffer_less_collectives_complete(coll, n, root):
    """Both complete on every rank, 3 rounds in the port (buffers: one
    empty BufferInfo of CUDA (TPU) memory, which selects the device TL)."""
    job, teams, tjob = jobs(n)
    bufs = [(Buf(size=0), None)] * n
    assert jax_coll(job, teams, coll, bufs, "UINT8", root=root) == [None] * n
    got = torch_coll(tjob, coll, bufs, "UINT8", root=root)
    assert all(x.size == 0 for rnd in got for x in rnd)


# ---------------------------------------------------------------------------
# ring and short, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("op", ["SUM", "AVG"])
@pytest.mark.parametrize("count", [37, 4000])
def test_ring_matches_tl_xla_ring_bitwise(n, op, count):
    """The fold order of ops.allreduce_ring (block j from rank j+1 round to
    rank j), padded to a multiple of n, on float32."""
    job, teams = make_jax_job("allreduce:@ring:inf", tl="xla", n=n)
    tjob = make_torch_job(n=n, UCC_TL_TORCH_OPS_TUNE="allreduce:@ring:inf")
    try:
        rng = np.random.default_rng(count + n)
        hosts = [rng.standard_normal(count).astype(np.float32)
                 for _ in range(n)]
        bufs = [(Buf(h), Buf(size=count)) for h in hosts]
        want = jax_coll(job, teams, "ALLREDUCE", bufs, "FLOAT32", op=op,
                        alg="ring")
        got = torch_coll(tjob, "ALLREDUCE", bufs, "FLOAT32", op=op,
                         alg="ring")
        for rnd in got:
            for g, w in zip(rnd, want):
                np.testing.assert_array_equal(bits(g), bits(w))
        exact = np.stack(hosts).astype(np.float64).sum(0)
        np.testing.assert_allclose(got[0][0], exact / (n if op == "AVG"
                                                       else 1),
                                   rtol=1e-4, atol=1e-5)
    finally:
        job.cleanup()
        tjob.cleanup()


SHORT_CASES = [
    ("ALLREDUCE", "FLOAT32", op) for op in ("SUM", "AVG", "MAX", "MIN",
                                            "PROD")] + [
    ("ALLREDUCE", "INT32", op) for op in ("SUM", "BXOR", "BAND", "BOR")] + [
    ("ALLREDUCE", dt, op) for dt in HALF for op in ("SUM", "AVG")] + [
    ("ALLREDUCE", "FLOAT32", "LAND"), ("REDUCE", "FLOAT32", "SUM"),
    ("REDUCE", "INT8", "PROD"), ("BCAST", "FLOAT32", None),
    ("ALLGATHER", "FLOAT32", None), ("ALLTOALL", "FLOAT32", None),
    ("ALLTOALL", "INT32", None)]


@pytest.mark.parametrize("coll,dt,op", SHORT_CASES)
def test_short_matches_tl_xla_short_bitwise(coll, dt, op):
    """Below the threshold both select ``short`` by default: the left fold
    in rank order in the buffers' dtype, AVG as the sum times 1/n, bcast
    the root's bits (-0.0 stays), allgather and alltoall as xla's; LAND,
    AVG of bfloat16 and an uneven alltoall fall through to xla's program
    in both."""
    n, root = 4, 3
    job, teams, tjob = jobs(n, short=True)
    rng = np.random.default_rng(sum(map(ord, f"{coll}{dt}{op}")))
    count = 8 * n + (3 if dt == "INT32" and coll == "ALLTOALL" else 0)
    hosts = [data(dt, count, rng, op or "SUM") for _ in range(n)]
    if op == "LAND":
        hosts = [np.where(h > 0.5, h, 0).astype(np.float32) for h in hosts]
    if coll == "BCAST":
        hosts[root][3] = -0.0
        bufs = [(Buf(h), None) for h in hosts]
    elif coll == "ALLGATHER":
        bufs = [(Buf(h), Buf(size=n * count)) for h in hosts]
    elif coll == "REDUCE":
        bufs = [(Buf(h), Buf(size=count) if r == root else None)
                for r, h in enumerate(hosts)]
    else:
        bufs = [(Buf(h), Buf(size=count)) for h in hosts]
    want = jax_coll(job, teams, coll, bufs, dt, op=op, root=root,
                    alg="short")
    got = torch_coll(tjob, coll, bufs, dt, op=op, root=root, alg="short")
    for rnd in got:
        for r, (g, w) in enumerate(zip(rnd, want)):
            if coll == "REDUCE" and r != root:
                continue
            assert g.dtype == w.dtype
            if (dt, op) == ("BFLOAT16", "AVG"):
                # both take their xla program: another summation order
                np.testing.assert_allclose(g.astype(np.float64),
                                           w.astype(np.float64), rtol=1e-2)
                continue
            np.testing.assert_array_equal(bits(g), bits(w))
    if coll == "BCAST":
        assert bits(got[0][0])[3] == bits(np.array(-0.0, np.float32))


def test_short_threshold_and_its_setting(monkeypatch):
    """auto: 128K on a cpu team (4K on a cuda one); 0 disables it."""
    _, _, tjob = jobs(4, short=True)
    smap = tjob.teams[0].score_map
    for size, alg in ((4, "short"), (131071, "short"), (131072, "xla")):
        best = smap.lookup(ut.CollType.ALLREDUCE, ut.MemoryType.CUDA,
                           size)[0]
        assert (best.team.NAME, best.alg_name) == ("torch_ops", alg)
    job = make_torch_job(n=2, UCC_TL_TORCH_OPS_SHORT_MSG_MAX="0")
    try:
        names = {r.alg_name for r in job.teams[0].score_map.lookup(
            ut.CollType.ALLREDUCE, ut.MemoryType.CUDA, 4)}
        assert names == {"xla", "ring", "ring_cuda"}
    finally:
        job.cleanup()
    job = make_torch_job(n=2, UCC_TL_TORCH_OPS_SHORT_MSG_MAX="1k")
    try:
        smap = job.teams[0].score_map
        assert smap.lookup(ut.CollType.BCAST, ut.MemoryType.CUDA,
                           1023)[0].alg_name == "short"
        assert smap.lookup(ut.CollType.BCAST, ut.MemoryType.CUDA,
                           1024)[0].alg_name == "xla"
    finally:
        job.cleanup()


# ---------------------------------------------------------------------------
# candidate lists and score rows
# ---------------------------------------------------------------------------

def _tl_team(teams, name):
    return next(t for t in teams[0].cl_teams[0].tl_teams if t.NAME == name)


def _rows(score, coll_of, mem):
    return {coll.name: [(r.start, r.end, r.score, r.alg_name, r.origin,
                         r.precision, r.gen)
                        for r in score.ranges.get((coll_of(coll.name), mem),
                                                  [])]
            for coll in ut.CollType}


@pytest.mark.parametrize("n", [2, 8])
def test_candidate_lists_and_score_rows_match_tl_xla(n):
    """Every collective's rows, and the score-map dump, of tl/torch_ops on
    CUDA memory are tl/xla's on TPU memory with the TL name mapped."""
    from ucc_tpu.score.score_map import ScoreMap as JScoreMap
    from ucc_tpu_torch.score.score_map import ScoreMap
    job, teams, tjob = jobs(n, short=True)
    jx = _tl_team(teams, "xla").get_scores()
    to = _tl_team(tjob.teams, "torch_ops").get_scores()
    want = _rows(jx, lambda c: ucc_tpu.CollType[c], ucc_tpu.MemoryType.TPU)
    got = _rows(to, lambda c: ut.CollType[c], ut.MemoryType.CUDA)
    assert got == want
    assert all(got[c.name] for c in ut.CollType)
    for coll in ut.CollType:
        for size in (0, 4095, 131071, 131072, 1 << 30):
            w = [(r.alg_name, r.score) for r in JScoreMap(jx).lookup(
                ucc_tpu.CollType[coll.name], ucc_tpu.MemoryType.TPU, size)]
            g = [(r.alg_name, r.score) for r in ScoreMap(to).lookup(
                coll, ut.MemoryType.CUDA, size)]
            assert g == w
    dump = JScoreMap(jx).print_info("t").replace("ucc_tpu score map", "")
    mine = ScoreMap(to).print_info("t").replace("ucc_tpu_torch score map",
                                                "")
    assert mine == dump.replace("xla/", "torch_ops/").replace(
        "] xla:", "] torch_ops/xla:").replace("/tpu  ", "/cuda ")
    from ucc_tpu.tl.xla import TlXla
    from ucc_tpu_torch.tl.torch_ops import TlTorchOps
    assert int(TlTorchOps.SUPPORTED_COLLS) == int(TlXla.SUPPORTED_COLLS)


def test_cuda_default_is_torch_ops_xla_as_the_reference_selects_tl_xla():
    """reduce_scatter, allgather and alltoall on CUDA memory, above the
    short range, select tl/torch_ops's xla at 40 over tl/ring_cuda's 20,
    as the reference selects tl/xla over tl/ring_dma; every other type of
    the table has torch_ops first too."""
    _, teams, tjob = jobs(8, short=True)
    for coll in ut.CollType:
        for size in (1 << 20, 1 << 30):
            best = tjob.teams[0].score_map.lookup(coll, ut.MemoryType.CUDA,
                                                  size)[0]
            assert (best.team.NAME, best.alg_name, best.score) == \
                ("torch_ops", "xla", 40)
            jbest = teams[0].score_map.lookup(
                ucc_tpu.CollType[coll.name], ucc_tpu.MemoryType.TPU,
                size)[0]
            assert (jbest.team.NAME, jbest.alg_name, jbest.score) == \
                ("xla", "xla", 40)


# ---------------------------------------------------------------------------
# the layouts the reference does not share, held to numpy
# ---------------------------------------------------------------------------

def test_gapped_displacements_are_honoured():
    """allgatherv, gatherv and scatterv at gapped displacements (the
    reference packs the first two), alltoallv with gaps on both sides:
    blocks land where the displacements say, gaps keep their 7s."""
    n, root = 4, 3
    _, _, tjob = jobs(n)
    rng = np.random.default_rng(5)
    counts = [3, 0, 5, 2]
    displs = [1, 4, 6, 13]
    span = 15
    hosts = [rng.standard_normal(counts[r]).astype(np.float32)
             for r in range(n)]
    want = np.full(span, 7, np.float32)
    for r in range(n):
        want[displs[r]:displs[r] + counts[r]] = hosts[r]
    for coll in ("ALLGATHERV", "GATHERV"):
        bufs = [(Buf(h), Buf(size=span, counts=counts, displs=displs))
                for h in hosts]
        got = torch_coll(tjob, coll, bufs, "FLOAT32", root=root)
        for rnd in got:
            for r in range(n):
                if coll == "ALLGATHERV" or r == root:
                    np.testing.assert_array_equal(rnd[r], want)
    src = rng.standard_normal(span).astype(np.float32)
    bufs = [(Buf(src, counts=counts, displs=displs) if r == root else None,
             Buf(size=counts[r])) for r in range(n)]
    for rnd in torch_coll(tjob, "SCATTERV", bufs, "FLOAT32", root=root):
        for r in range(n):
            np.testing.assert_array_equal(
                rnd[r], src[displs[r]:displs[r] + counts[r]])
    m = rng.integers(0, 4, (n, n))
    sd = [[int(2 * p + m[r, :p].sum()) for p in range(n)] for r in range(n)]
    dd = [[int(3 * p + m[:p, r].sum()) for p in range(n)] for r in range(n)]
    hosts = [rng.standard_normal(sd[r][-1] + m[r, -1] + 1).astype(np.float32)
             for r in range(n)]
    bufs = [(Buf(hosts[r], counts=[int(x) for x in m[r]], displs=sd[r]),
             Buf(size=dd[r][-1] + m[-1, r] + 2,
                 counts=[int(x) for x in m[:, r]], displs=dd[r]))
            for r in range(n)]
    for rnd in torch_coll(tjob, "ALLTOALLV", bufs, "FLOAT32"):
        for p in range(n):
            w = np.full(bufs[p][1].size, 7, np.float32)
            for r in range(n):
                c = m[r, p]
                w[dd[p][r]:dd[p][r] + c] = hosts[r][sd[r][p]:sd[r][p] + c]
            np.testing.assert_array_equal(rnd[p], w)


def test_alltoallv_short_sends_arrive_zero_padded():
    """A receive block longer than the block sent is filled with zeros
    (the reference's padded exchange, up to its longest send); a shorter
    one takes a prefix."""
    n = 2
    job, teams, tjob = jobs(n)
    hosts = [np.arange(1, 7, dtype=np.int32) * (r + 1) for r in range(n)]
    bufs = [(Buf(hosts[r], counts=[2, 4] if r == 0 else [4, 2]),
             Buf(size=6, counts=[3, 3])) for r in range(n)]
    want = jax_coll(job, teams, "ALLTOALLV", bufs, "INT32")
    for rnd in torch_coll(tjob, "ALLTOALLV", bufs, "INT32"):
        for g, w in zip(rnd, want):
            np.testing.assert_array_equal(g, w)
    assert list(want[0]) == [1, 2, 0, 2, 4, 6]


@pytest.mark.parametrize("coll,odd", [("ALLGATHER", False),
                                      ("REDUCE_SCATTER", False),
                                      ("REDUCE_SCATTER", True),
                                      ("ALLTOALL", True), ("GATHER", False),
                                      ("ALLGATHERV", False),
                                      ("REDUCE", False)])
def test_in_place(coll, odd):
    """In place (the reference's device TLs rebind dst instead): UCC's
    conventions, as the host ring's; allgather(v) and gather read their
    own block from dst, reduce_scatter reads the whole vector from dst
    and writes its near-equal block where it lies, alltoall's src is its
    dst, reduce's root reads and writes dst."""
    n, root = 4, 1
    _, _, tjob = jobs(n)
    rng = np.random.default_rng(len(coll))
    if coll in ("ALLGATHER", "GATHER", "ALLGATHERV"):
        counts = [2, 5, 0, 3] if coll == "ALLGATHERV" else [5] * n
        offs = np.cumsum([0] + counts)
        blocks = [rng.standard_normal(c).astype(np.float32) for c in counts]
        full = np.concatenate(blocks)
        hosts = [np.full(offs[-1], 7, np.float32) for _ in range(n)]
        for r in range(n):
            hosts[r][offs[r]:offs[r + 1]] = blocks[r]
        bufs = [(None, Buf(h, counts=counts if coll == "ALLGATHERV"
                           else None)) for h in hosts]
        got = torch_coll(tjob, coll, bufs, "FLOAT32", root=root,
                         inplace=True)
        for rnd in got:
            for r in range(n):
                want = full if coll != "GATHER" or r == root else hosts[r]
                np.testing.assert_array_equal(rnd[r], want)
        return
    total = 5 * n + (3 if odd else 0)
    hosts = [rng.integers(-9, 10, total).astype(np.int32)
             for _ in range(n)]
    bufs = [(None, Buf(h)) for h in hosts]
    got = torch_coll(tjob, coll, bufs, "INT32", op="SUM", root=root,
                     inplace=True)
    total_sum = np.stack(hosts).sum(0).astype(np.int32)
    for rnd in got:
        for r in range(n):
            want = hosts[r].copy()
            if coll == "REDUCE_SCATTER":
                o, c = block_offset(total, n, r), block_count(total, n, r)
                want[o:o + c] = total_sum[o:o + c]
            elif coll == "REDUCE":
                want = total_sum if r == root else want
            else:
                b = -(-total // n)
                for p in range(n):
                    seg = np.concatenate([hosts[p], np.zeros(
                        n * b - total, np.int32)])[r * b:(r + 1) * b]
                    part = want[p * b:(p + 1) * b]
                    part[:] = seg[:part.size]
            np.testing.assert_array_equal(rnd[r], want)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _status(tjob, argses):
    with pytest.raises(ut.UccError) as ei:
        for r, a in enumerate(argses):
            tjob.teams[r].collective_init(a)
    return ei.value.status


def _t(count, v=None):
    buf = torch.zeros(max(count, 1))
    mt = ut.MemoryType.CUDA
    if v is not None:
        return ut.BufferInfoV(buf, v, None, ut.DataType.FLOAT32,
                              mem_type=mt)
    return ut.BufferInfo(buf, count, ut.DataType.FLOAT32, mem_type=mt)


@pytest.mark.parametrize("case,status", [
    ("alltoallv without src counts", "ERR_NOT_SUPPORTED"),
    ("scatterv without counts at the root", "ERR_NOT_SUPPORTED"),
    ("gatherv without counts", "ERR_NOT_SUPPORTED"),
    ("allgatherv with too few counts", "ERR_INVALID_PARAM"),
    ("reduce_scatter with a wrong dst count", "ERR_INVALID_PARAM"),
    ("reduce_scatterv in place", "ERR_NOT_SUPPORTED"),
    ("avg of int32", "ERR_NOT_SUPPORTED")])
def test_refusals(case, status):
    """What tl/torch_ops refuses at init, as the reference does (the
    v-collectives' counts), or by UCC's count conventions; the whole stack
    refuses it too (tl/ring_cuda serves none of these)."""
    n = 2
    _, _, tjob = jobs(n)
    C = ut.CollType
    a = {
        "alltoallv without src counts": ut.CollArgs(
            coll_type=C.ALLTOALLV, src=_t(4), dst=_t(4, [2, 2])),
        "scatterv without counts at the root": ut.CollArgs(
            coll_type=C.SCATTERV, root=0, src=_t(4), dst=_t(2)),
        "gatherv without counts": ut.CollArgs(
            coll_type=C.GATHERV, src=_t(2), dst=_t(4)),
        "allgatherv with too few counts": ut.CollArgs(
            coll_type=C.ALLGATHERV, src=_t(2), dst=_t(4, [2])),
        "reduce_scatter with a wrong dst count": ut.CollArgs(
            coll_type=C.REDUCE_SCATTER, op=ut.ReductionOp.SUM, src=_t(7),
            dst=_t(3)),
        "reduce_scatterv in place": ut.CollArgs(
            coll_type=C.REDUCE_SCATTERV, op=ut.ReductionOp.SUM,
            dst=_t(4, [2, 2]), flags=ut.CollArgsFlags.IN_PLACE),
        "avg of int32": ut.CollArgs(
            coll_type=C.REDUCE, op=ut.ReductionOp.AVG,
            src=ut.BufferInfo(torch.zeros(4, dtype=torch.int32), 4,
                              ut.DataType.INT32,
                              mem_type=ut.MemoryType.CUDA)),
    }[case]
    assert _status(tjob, [a]) == ut.Status[status]


@pytest.mark.parametrize("coll", ["allreduce", "reduce_scatter", "allgather",
                                  "bcast", "alltoall"])
def test_perftest_modes_select_what_the_reference_perftest_selects(coll):
    """ucc_perftest's collective modes on device memory: the port's args
    (CUDA memory) select tl/torch_ops's algorithm where the reference's
    (TPU memory) select tl/xla's of the same name, at a short and a long
    message (each request initialised on every rank and not posted)."""
    from ucc_tpu.tools import perftest as jpt
    from ucc_tpu_torch.tools import perftest as pt
    n = 4
    job, teams, tjob = jobs(n, short=True)
    devices = [job.contexts[r].tl_contexts["xla"].obj.device
               for r in range(n)]
    assert coll in pt.COLLS
    for count in (4, 1 << 16):
        jreqs = [teams[r].collective_init(jpt.make_args(
            jpt.COLLS[coll], r, n, count, ucc_tpu.DataType.FLOAT32,
            ucc_tpu.ReductionOp.SUM, ucc_tpu.MemoryType.TPU, False, 0,
            False, devices)) for r in range(n)]
        reqs = [tjob.teams[r].collective_init(pt.make_args(
            pt.COLLS[coll], n, count, ut.DataType.FLOAT32,
            ut.ReductionOp.SUM, ut.MemoryType.CUDA, False, 0, False,
            torch.device("cpu"))) for r in range(n)]
        want = [(rq.task.alg_name, rq.task.team.NAME) for rq in jreqs]
        got = [(rq.task.alg_name, rq.task.team.NAME) for rq in reqs]
        assert got == [(a, "torch_ops" if t == "xla" else t)
                       for a, t in want]
        # reduce_scatter has no short algorithm in either
        assert got[0][0] == ("short" if count == 4 and
                             coll != "reduce_scatter" else "xla")
        for rq in jreqs + reqs:
            rq.finalize()
