"""The port's host collectives (tl/shm and the tl/host algorithms) held
bitwise against the JAX package's on the same numpy inputs.

Both packages run 8 in-process ranks (a Lib and a Context each over a
thread OOB) with TLS=shm,self. Every algorithm of tl/shm's table is pinned
through UCC_TL_SHM_TUNE (read at team create in both packages) at team
sizes 2, 3, 5 and 8; the port runs on its native matcher and on its Python
matcher (UCC_TL_SHM_NATIVE=n at context create). The JAX package runs with
UCC_GEN_NATIVE=n, its classic generators. Every result buffer must equal
the reference's bit for bit, and the selected algorithm must be the same.
bfloat16 travels as ml_dtypes.bfloat16 in the reference and as
torch.bfloat16 in the port; the bits are compared.
"""
import contextlib
import os
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import ucc_tpu
import ucc_tpu_torch as ut

N = 8
SIZES = (2, 3, 5, 8)
DTYPES = ("FLOAT32", "FLOAT64", "INT32", "BFLOAT16", "FLOAT16")
_NP = {"FLOAT32": np.float32, "FLOAT64": np.float64, "INT32": np.int32,
       "BFLOAT16": np.uint16, "FLOAT16": np.float16}
_TD = {"FLOAT32": torch.float32, "FLOAT64": torch.float64,
       "INT32": torch.int32, "BFLOAT16": torch.bfloat16,
       "FLOAT16": torch.float16}
REDUCING = ("ALLREDUCE", "REDUCE", "REDUCE_SCATTER", "REDUCE_SCATTERV")


@contextlib.contextmanager
def env(**values):
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Job:
    """N ranks of one package (`mod`) in this process: contexts made in
    threads (the address exchange blocks), teams cached by (ranks, TUNE),
    everything after driven cooperatively."""

    def __init__(self, mod, n=N, **ctx_env):
        self.mod = mod
        world = mod.ThreadOobWorld(n)
        libs = [mod.init(TLS="shm,self") for _ in range(n)]
        self.contexts = [None] * n
        with env(**ctx_env):
            ths = [threading.Thread(target=self._make,
                                    args=(libs, world, r))
                   for r in range(n)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=60)
        assert all(c is not None for c in self.contexts)
        self.teams = {}

    def _make(self, libs, world, r):
        self.contexts[r] = self.mod.Context(
            libs[r], self.mod.ContextParams(oob=world.endpoint(r)))

    def team(self, n, tune=""):
        key = (n, tune)
        if key not in self.teams:
            world = self.mod.ThreadOobWorld(n)
            with env(UCC_TL_SHM_TUNE=tune or None):
                teams = [self.contexts[r].create_team_post(
                    self.mod.TeamParams(oob=world.endpoint(r)))
                    for r in range(n)]
                self.until(lambda: all(
                    [t.create_test() != self.mod.Status.IN_PROGRESS
                     for t in teams]))
            assert [t.create_test() for t in teams] == \
                [self.mod.Status.OK] * n
            self.teams[key] = teams
        return self.teams[key]

    def until(self, cond, timeout=60.0):
        deadline = time.monotonic() + timeout
        while not cond():
            for c in self.contexts:
                c.progress()
            if time.monotonic() > deadline:
                raise TimeoutError("progress timed out")

    def run(self, teams, args, rounds=1):
        """collective_init on every member, then `rounds` posts; returns
        (statuses, algorithm names)."""
        try:
            reqs = [t.collective_init(a) for t, a in zip(teams, args)]
        except self.mod.UccError as e:
            # an algorithm pinned by TUNE refuses this geometry at init
            # (on the first rank; no rank has posted)
            return [f"init {e.status.name}"] * len(teams), [None]
        for _ in range(rounds):
            for rq in reqs:
                rq.post()
            self.until(lambda: all(
                [rq.test() != self.mod.Status.IN_PROGRESS for rq in reqs]))
        sts = [rq.test() for rq in reqs]
        names = [rq.task.alg_name for rq in reqs]
        for rq in reqs:
            rq.finalize()
        return sts, names

    def destroy(self):
        for teams in self.teams.values():
            for t in teams:
                t.destroy()
        for c in self.contexts:
            c.destroy()


@pytest.fixture(scope="module")
def jobs():
    with env(UCC_GEN_NATIVE="n", UCC_QUANT=None, UCC_GEN=None,
             UCC_TL_SHM_TUNE=None):
        ref = Job(ucc_tpu)
        nat = Job(ut, UCC_TL_SHM_NATIVE="y")
        py = Job(ut, UCC_TL_SHM_NATIVE="n")
        assert all(c.tl_contexts["shm"].obj.transport.native is not None
                   for c in nat.contexts)
        assert all(c.tl_contexts["shm"].obj.transport.native is None
                   for c in py.contexts)
        yield {"ref": ref, "native": nat, "python": py}
        for j in (ref, nat, py):
            j.destroy()


# ---------------------------------------------------------------------------
# buffers: one numpy layout per case, materialised in each package
# ---------------------------------------------------------------------------

def _data(rng, count, dt):
    if dt == "INT32":
        return rng.integers(-50, 50, size=count).astype(np.int32)
    x = (rng.random(count) * 4 - 2).astype(np.float32)
    if dt == "BFLOAT16":
        return torch.from_numpy(x).to(torch.bfloat16).view(
            torch.int16).numpy().view(np.uint16)
    return x.astype(_NP[dt])


def _ref_buf(arr, dt):
    return arr.copy().view(ml_dtypes.bfloat16) if dt == "BFLOAT16" \
        else arr.copy()


def _port_buf(arr, dt, kind):
    if kind == "numpy":
        return arr.copy()
    t = torch.from_numpy(arr.view(np.int16) if dt == "BFLOAT16"
                         else arr).clone()
    return t.view(torch.bfloat16) if dt == "BFLOAT16" else t


def _bits(buf):
    if buf is None:
        return None
    if isinstance(buf, torch.Tensor):
        if buf.numel() == 0:
            return np.zeros(0, np.uint8)
        return buf.reshape(-1).view(torch.uint8).numpy().copy()
    return np.asarray(buf).reshape(-1).view(np.uint8).copy()


def layout(coll, n, c, dt, seed, root=0, inplace=False):
    """Per-rank numpy (src, dst) arrays and v-counts of one case (None
    where a rank passes no buffer). `c` is the per-rank block count."""
    rng = np.random.default_rng(seed)
    srcs, dsts, meta = [None] * n, [None] * n, {}
    if coll in ("ALLREDUCE",):
        for r in range(n):
            srcs[r] = _data(rng, c, dt)
            dsts[r] = np.zeros(c, _NP[dt])
    elif coll == "REDUCE":
        for r in range(n):
            srcs[r] = _data(rng, c, dt)
        dsts[root] = np.zeros(c, _NP[dt])
    elif coll == "BCAST":
        for r in range(n):
            srcs[r] = _data(rng, c, dt) if r == root else np.zeros(c, _NP[dt])
    elif coll == "REDUCE_SCATTER":
        for r in range(n):
            srcs[r] = _data(rng, n * c, dt)
            dsts[r] = np.zeros(c, _NP[dt])
    elif coll in ("ALLGATHER", "ALLTOALL"):
        for r in range(n):
            srcs[r] = _data(rng, c if coll == "ALLGATHER" else n * c, dt)
            dsts[r] = np.zeros(n * c, _NP[dt])
    elif coll == "GATHER":
        for r in range(n):
            srcs[r] = _data(rng, c, dt)
        dsts[root] = np.zeros(n * c, _NP[dt])
    elif coll == "SCATTER":
        srcs[root] = _data(rng, n * c, dt)
        for r in range(n):
            dsts[r] = np.zeros(c, _NP[dt])
    elif coll in ("ALLGATHERV", "GATHERV", "SCATTERV", "REDUCE_SCATTERV"):
        counts = [int(x) for x in rng.integers(0, 2 * c + 1, size=n)]
        counts[0] = max(counts[0], 1)
        displs = [int(x) for x in np.cumsum([0] + counts[:-1])]
        meta = {"counts": counts, "displs": displs}
        total = sum(counts)
        for r in range(n):
            if coll == "ALLGATHERV":
                srcs[r] = _data(rng, counts[r], dt)
                dsts[r] = np.zeros(total, _NP[dt])
            elif coll == "GATHERV":
                srcs[r] = _data(rng, counts[r], dt)
                if r == root:
                    dsts[r] = np.zeros(total, _NP[dt])
            elif coll == "SCATTERV":
                if r == root:
                    srcs[r] = _data(rng, total, dt)
                dsts[r] = np.zeros(counts[r], _NP[dt])
            else:
                srcs[r] = _data(rng, total, dt)
                dsts[r] = np.zeros(counts[r], _NP[dt])
    elif coll == "ALLTOALLV":
        cnt = rng.integers(0, 2 * c + 1, size=(n, n))
        meta = {"matrix": cnt}
        for r in range(n):
            srcs[r] = _data(rng, int(cnt[r].sum()), dt)
            dsts[r] = np.zeros(int(cnt[:, r].sum()), _NP[dt])
    if inplace:
        # the result lands where the contribution sits
        if coll in ("ALLREDUCE",):
            dsts, srcs = srcs, [None] * n
        elif coll == "REDUCE_SCATTER":
            dsts, srcs = srcs, [None] * n
        elif coll == "ALLGATHER":
            for r in range(n):
                dsts[r][r * c:(r + 1) * c] = srcs[r]
            srcs = [None] * n
        elif coll == "ALLTOALL":
            dsts, srcs = srcs, [None] * n
        elif coll == "REDUCE":
            dsts[root], srcs[root] = srcs[root], None
        elif coll == "GATHER":
            dsts[root][root * c:(root + 1) * c] = srcs[root]
            srcs[root] = None
        elif coll == "SCATTER":
            dsts[root] = None
    return srcs, dsts, meta


def make_args(mod, coll, r, n, src, dst, meta, dt, op, root, inplace,
              persistent=False, active_set=None):
    D = mod.DataType[dt]
    ct = mod.CollType[coll]
    flags = mod.CollArgsFlags(0)
    rooted = coll in ("REDUCE", "GATHER", "SCATTER", "GATHERV", "SCATTERV")
    if inplace and (not rooted or r == root):
        flags |= mod.CollArgsFlags.IN_PLACE
    if persistent:
        flags |= mod.CollArgsFlags.PERSISTENT

    def bi(buf, count):
        return None if buf is None else mod.BufferInfo(buf, count, D)

    def biv(buf, counts, displs):
        return mod.BufferInfoV(buf, list(counts), list(displs), D)

    nel = (lambda b: 0 if b is None else
           (b.numel() if isinstance(b, torch.Tensor) else b.size))
    s = d = None
    if coll in ("ALLGATHERV", "GATHERV", "SCATTERV", "REDUCE_SCATTERV"):
        counts, displs = meta["counts"], meta["displs"]
        if coll == "ALLGATHERV":
            s, d = bi(src, counts[r]), biv(dst, counts, displs)
        elif coll == "GATHERV":
            s = bi(src, counts[r])
            d = biv(dst, counts, displs) if dst is not None else None
        elif coll == "SCATTERV":
            s = biv(src, counts, displs) if src is not None else None
            d = bi(dst, counts[r])
        else:
            s, d = bi(src, sum(counts)), biv(dst, counts, displs)
    elif coll == "ALLTOALLV":
        m = meta["matrix"]
        sc = [int(x) for x in m[r]]
        rc = [int(x) for x in m[:, r]]
        s = biv(src, sc, [int(x) for x in np.cumsum([0] + sc[:-1])])
        d = biv(dst, rc, [int(x) for x in np.cumsum([0] + rc[:-1])])
    elif coll not in ("BARRIER", "FANIN", "FANOUT"):
        s, d = bi(src, nel(src)), bi(dst, nel(dst))
    kw = {}
    if active_set is not None:
        kw["active_set"] = mod.ActiveSet(*active_set)
    return mod.CollArgs(coll_type=ct, src=s, dst=d,
                        op=mod.ReductionOp[op] if op else None, root=root,
                        flags=flags, **kw)


def run_case(jobs, coll, n, c, dt="FLOAT32", op="SUM", root=0,
             inplace=False, tune="", matchers=("native",), seed=0,
             rounds=1, kind="tensor", active_set=None, members=None):
    """Run one case in the reference and in each named port job; assert
    bitwise equal buffers, equal statuses and algorithm names."""
    srcs, dsts, meta = layout(coll, n, c, dt, seed, root, inplace)
    if coll in ("BARRIER", "FANIN", "FANOUT"):
        srcs, dsts = [None] * n, [None] * n
    members = members if members is not None else range(n)
    outs = {}
    for name in ("ref",) + tuple(matchers):
        job = jobs[name]
        mod = job.mod
        conv = (lambda a: None if a is None else _ref_buf(a, dt)) \
            if name == "ref" else \
            (lambda a: None if a is None else _port_buf(a, dt, kind))
        s_bufs = [conv(a) for a in srcs]
        d_bufs = [conv(a) for a in dsts]
        teams = job.team(n, tune)
        args = [make_args(mod, coll, r, n, s_bufs[r], d_bufs[r], meta, dt,
                          op if coll in REDUCING else None, root, inplace,
                          persistent=rounds > 1, active_set=active_set)
                for r in range(n)]
        sel = [r for r in range(n) if r in members]
        sts, names = job.run([teams[r] for r in sel], [args[r] for r in sel],
                             rounds)
        outs[name] = ([getattr(s, "name", s) for s in sts], names,
                      [(_bits(s_bufs[r]), _bits(d_bufs[r])) for r in sel])
    want = outs["ref"]
    assert set(want[0]) <= {"OK", "init ERR_NOT_SUPPORTED"}, want[0]
    for name in matchers:
        got = outs[name]
        assert got[0] == want[0], name
        assert got[1] == want[1], name
        for r, ((ws, wd), (gs, gd)) in enumerate(zip(want[2], got[2])):
            for w, g in ((ws, gs), (wd, gd)):
                assert (w is None) == (g is None), (name, r)
                if w is not None:
                    assert np.array_equal(w, g), (name, r, coll, dt, op)
    return want


# ---------------------------------------------------------------------------
# every algorithm of the table, pinned
# ---------------------------------------------------------------------------

def _table():
    from ucc_tpu_torch.tl.shm import TlShm
    from ucc_tpu_torch.tl.host.team import HostTlTeam

    class Stub(HostTlTeam):
        TL_CLS = TlShm

        def __init__(self):
            self.size = 8
            self.core_team = None

    return {c.name: [(s.id, s.name) for s in specs]
            for c, specs in Stub().alg_table().items()}


_ONESIDED = {("ALLREDUCE", "sliding_window"), ("ALLTOALL", "onesided"),
             ("ALLTOALLV", "onesided")}
ALGS = [(c, name) for c, specs in _table().items() for _, name in specs
        if (c, name) not in _ONESIDED]


def _count(coll):
    # odd per-rank counts exercise the near-equal block splits; bcast
    # and allreduce pass 4 KiB-order totals
    return {"BCAST": 1031, "ALLREDUCE": 1031, "REDUCE": 1031}.get(coll, 67)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("coll,alg", ALGS)
def test_every_algorithm_matches_the_reference(jobs, coll, alg, n):
    tune = f"{coll.lower()}:@{alg}:inf"
    root = n - 1 if coll in ("BCAST", "REDUCE", "GATHER", "SCATTER",
                             "GATHERV", "SCATTERV", "FANIN",
                             "FANOUT") else 0
    run_case(jobs, coll, n, _count(coll), tune=tune, root=root, seed=n)


@pytest.mark.parametrize("n", (3, 8))
@pytest.mark.parametrize("coll,alg", ALGS)
def test_every_algorithm_on_the_python_matcher(jobs, coll, alg, n):
    tune = f"{coll.lower()}:@{alg}:inf"
    root = 1 if coll in ("BCAST", "REDUCE", "GATHER", "SCATTER", "GATHERV",
                         "SCATTERV", "FANIN", "FANOUT") else 0
    run_case(jobs, coll, n, _count(coll), tune=tune, root=root, seed=11,
             matchers=("python",))


# ---------------------------------------------------------------------------
# datatypes and ops (default selection)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ("SUM", "PROD", "MAX", "MIN", "AVG"))
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("coll", REDUCING)
def test_reductions_over_dtypes_and_ops(jobs, coll, dt, op):
    run_case(jobs, coll, 5, 67 if coll != "ALLREDUCE" else 1031, dt=dt,
             op=op, root=2, seed=3, matchers=("native", "python"))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("coll", ("BCAST", "ALLGATHER", "ALLTOALL",
                                  "GATHER", "SCATTER", "ALLTOALLV"))
def test_data_movement_over_dtypes(jobs, coll, dt):
    run_case(jobs, coll, 5, 67, dt=dt, root=3, seed=4)


@pytest.mark.parametrize("n", (3, 8))
@pytest.mark.parametrize("coll", ("ALLREDUCE", "REDUCE_SCATTER", "ALLGATHER",
                                  "ALLTOALL", "REDUCE", "GATHER",
                                  "SCATTER"))
def test_in_place(jobs, coll, n):
    run_case(jobs, coll, n, 64 if coll != "ALLREDUCE" else 1031,
             inplace=True, root=n // 2, seed=5,
             matchers=("native", "python"))


@pytest.mark.parametrize("coll", ("ALLREDUCE", "BCAST", "ALLTOALL",
                                  "REDUCE_SCATTER", "ALLGATHERV"))
def test_persistent(jobs, coll):
    run_case(jobs, coll, 5, 129, root=4, seed=6, rounds=3)


@pytest.mark.parametrize("coll", ("ALLREDUCE", "ALLGATHER", "BCAST",
                                  "ALLTOALL"))
def test_zero_size(jobs, coll):
    want = run_case(jobs, coll, 3, 0, seed=7)
    assert set(want[1]) == {"zero_size_stub"}


def test_numpy_buffers(jobs):
    """CPU tensors are the port's usual host buffer; numpy arrays take
    the same path."""
    run_case(jobs, "ALLREDUCE", 8, 4099, kind="numpy", seed=8,
             matchers=("native", "python"))
    run_case(jobs, "ALLTOALLV", 5, 33, kind="numpy", seed=8)


@pytest.mark.parametrize("coll,c", [("ALLREDUCE", 5000), ("ALLREDUCE", 1 << 14),
                                    ("ALLTOALL", 2048), ("ALLGATHER", 4096),
                                    ("BCAST", 1 << 14), ("REDUCE", 1 << 14),
                                    ("REDUCE_SCATTER", 4096)])
def test_above_the_eager_limit(jobs, coll, c):
    """Messages past the 8 KiB eager limit (rendezvous when unexpected)
    and past the 4k/8k select edges."""
    run_case(jobs, coll, 8, c, root=5, seed=9,
             matchers=("native", "python"))


@pytest.mark.parametrize("nbytes", (4092, 4096, 4100, 8188, 8192, 8196))
@pytest.mark.parametrize("coll", ("ALLREDUCE", "BCAST", "ALLGATHER",
                                  "REDUCE"))
def test_select_edges(jobs, coll, nbytes):
    c = nbytes // 4
    if coll == "ALLGATHER":
        c = max(1, c // 5)
    run_case(jobs, coll, 5, c, root=1, seed=10)


def test_active_set_bcast(jobs):
    """Bcast on the active set (start 1, stride 2, size 3) of a 7-rank
    team: only ranks 1, 3 and 5 post; the root is team rank 3."""
    run_case(jobs, "BCAST", 7, 129, root=3, seed=12,
             active_set=(1, 2, 3), members=(1, 3, 5),
             matchers=("native", "python"))


@pytest.mark.parametrize("coll", ("ALLREDUCE", "REDUCE"))
def test_pipelined_sra_and_srg(jobs, coll):
    """ALLREDUCE_SRA_PIPELINE / REDUCE_SRG_PIPELINE fragment the SRA
    allreduce and the SRG reduce through PipelinedSchedule."""
    knob = "allreduce_sra_pipeline" if coll == "ALLREDUCE" \
        else "reduce_srg_pipeline"
    alg = "sra_knomial" if coll == "ALLREDUCE" else "srg_knomial"
    spec = "thresh=1K:fragsize=2K:nfrags=3:pdepth=2:ordered"
    for name in ("ref", "native"):
        for c in jobs[name].contexts:
            c.tl_contexts["shm"].obj.config.modify(knob, spec)
    try:
        for n in (3, 8):
            want = run_case(jobs, coll, n, 4099, root=n - 2, seed=13,
                            tune=f"{coll.lower()}:@{alg}:inf", rounds=2)
            assert set(want[1]) == {alg}
        team = jobs["native"].team(8, f"{coll.lower()}:@{alg}:inf")[0]
        args = make_args(ut, coll, 0, 8, torch.zeros(4099),
                         torch.zeros(4099), {}, "FLOAT32", "SUM", 0, False)
        from ucc_tpu_torch.schedule.pipelined import PipelinedSchedule
        rq = team.collective_init(args)
        assert isinstance(rq.task, PipelinedSchedule)
    finally:
        for name in ("ref", "native"):
            for c in jobs[name].contexts:
                c.tl_contexts["shm"].obj.config.modify(knob, "n")


# ---------------------------------------------------------------------------
# candidate lists and score dumps
# ---------------------------------------------------------------------------

def _shm(teams):
    cl = teams[0].cl_teams[0]
    return [t for t in cl.tl_teams if t.name == "shm"][0]


@pytest.mark.parametrize("tune", ("", "allreduce:@ring:inf",
                                  "alltoall:0-16k:@bruck:90"))
@pytest.mark.parametrize("n", SIZES)
def test_candidate_lists_and_print_info_match(jobs, n, tune):
    from ucc_tpu.score.score_map import ScoreMap as JScoreMap
    from ucc_tpu_torch.score.score_map import ScoreMap
    j = _shm(jobs["ref"].team(n, tune)).get_scores()
    p = _shm(jobs["native"].team(n, tune)).get_scores()
    jm, pm = JScoreMap(j), ScoreMap(p)
    sizes = (0, 1, 4095, 4096, 4097, 8191, 8192, 8193, 129 * n,
             129 * n + 1, 1 << 20, 1 << 40)
    for coll in ut.CollType:
        for size in sizes:
            w = [(r.alg_name, r.score) for r in jm.lookup(
                ucc_tpu.CollType[coll.name], ucc_tpu.MemoryType.HOST, size)]
            g = [(r.alg_name, r.score) for r in pm.lookup(
                coll, ut.MemoryType.HOST, size)]
            assert g == w, (coll, size)
            assert not pm.lookup(coll, ut.MemoryType.CUDA, size)
    assert pm.print_info("t").replace("ucc_tpu_torch score map", "") == \
        jm.print_info("t").replace("ucc_tpu score map", "")
    # the whole team's HOST rows too (tl/shm is the only multi-rank host TL
    # of both jobs)
    assert jobs["native"].team(n, tune)[0].score_map.print_info("t").replace(
        "ucc_tpu_torch score map", "") == \
        jobs["ref"].team(n, tune)[0].score_map.print_info("t").replace(
            "ucc_tpu score map", "")


@pytest.mark.parametrize("coll,alg", sorted(_ONESIDED))
def test_onesided_rows_refuse_at_init(jobs, coll, alg):
    """Registered at score 1 with the reference's ids, so default
    selection never takes them in either package: an unpinned request
    runs another algorithm. (Pinned, they run: the next test. On CUDA
    memory they refuse at init: ``test_torch_onesided.py``.)"""
    srcs, dsts, meta = layout(coll, 4, 64, "FLOAT32", 0)
    op = "SUM" if coll == "ALLREDUCE" else None
    chosen = {}
    for name, conv in (("ref", lambda a: _ref_buf(a, "FLOAT32")),
                       ("native", lambda a: _port_buf(a, "FLOAT32",
                                                      "tensor"))):
        job = jobs[name]
        args = [make_args(job.mod, coll, r, 4, conv(srcs[r]), conv(dsts[r]),
                          meta, "FLOAT32", op, 0, False) for r in range(4)]
        sts, names = job.run(job.team(4), args)
        assert alg not in names and set(s.name for s in sts) == {"OK"}
        chosen[name] = names
    assert chosen["native"] == chosen["ref"]


@pytest.mark.parametrize("coll,alg", sorted(_ONESIDED))
def test_onesided_rows_run_pinned_and_match(jobs, coll, alg):
    """Pinned by TUNE, both packages run the one-sided rows in-process
    (no memh: each rank maps its own buffers and the handles are
    exchanged over the team), bitwise alike."""
    srcs, dsts, meta = layout(coll, 4, 64, "FLOAT32", 0)
    op = "SUM" if coll == "ALLREDUCE" else None
    outs = {}
    for name, conv in (("ref", lambda a: _ref_buf(a, "FLOAT32")),
                       ("native", lambda a: _port_buf(a, "FLOAT32",
                                                      "tensor"))):
        job = jobs[name]
        bufs = [conv(dsts[r]) for r in range(4)]
        args = [make_args(job.mod, coll, r, 4, conv(srcs[r]), bufs[r],
                          meta, "FLOAT32", op, 0, False) for r in range(4)]
        sts, names = job.run(job.team(4, f"{coll.lower()}:@{alg}:inf"),
                             args)
        assert names == [alg] * 4
        assert set(s.name for s in sts) == {"OK"}
        outs[name] = [_bits(b) for b in bufs]
    for a, b in zip(outs["ref"], outs["native"]):
        np.testing.assert_array_equal(a, b)


def test_table_ids_names_and_selects_match_the_reference(jobs):
    j = _shm(jobs["ref"].team(8)).alg_table()
    p = _shm(jobs["native"].team(8)).alg_table()
    assert {c.name: [(s.id, s.name, s.default_select, s.precision, s.origin)
                     for s in v] for c, v in p.items()} == \
        {c.name: [(s.id, s.name, s.default_select, s.precision, s.origin)
                  for s in v] for c, v in j.items()}
