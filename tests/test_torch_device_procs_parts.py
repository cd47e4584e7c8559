"""Device teams across processes, the parts that need no second process.

- The plain versions by part (kernels/ring_common.py ``part=(p, P)``): for
  each of the five direct entry points and P in {1, 2, 3, 4}, the union of
  the P parts is bitwise the single call, at n in {2, 3, 5, 8}, on
  float32, bfloat16 and int32, every op the collective takes, at counts
  that are no multiple of the 16-byte vector and counts below P; and at
  one small shape, the union is bitwise the JAX package's Pallas kernel in
  interpret mode on the same inputs.
- The parts' bounds: cut at multiples of the vector's elements, covering
  the walk once.
- The process layout of a team (tl/device ``team_layout``) from a faked
  address table: processes numbered by their lowest rank, refusals of a
  rank on another host or on another card (compared by UUID, not by the
  device's name), and the refusal of ``expandable_segments``.
- A spanning team's candidate lists (tl/torch_ops) against the JAX
  package's tl/xla for a team that is not all local: no ``short``, no
  SCATTERV, ALLTOALLV served, ``ring`` one point below ``xla``; and
  ``gen_dev_*`` initialized there, writing its peers' dsts on the kernel
  backend and its own on ``xla``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import ucc_tpu  # noqa: E402
import torch_ring_cases as rc  # noqa: E402
from torch_stack_cases import make_jax_job, make_torch_job  # noqa: E402

import ucc_tpu_torch as ut  # noqa: E402
from ucc_tpu_torch.constants import ReductionOp  # noqa: E402
from ucc_tpu_torch.kernels import cuda_ipc  # noqa: E402
from ucc_tpu_torch.kernels import ring_allreduce as kr  # noqa: E402
from ucc_tpu_torch.kernels import ring_bcast_a2a as kba  # noqa: E402
from ucc_tpu_torch.kernels import ring_common as kc  # noqa: E402
from ucc_tpu_torch.kernels import ring_rs_ag as krs  # noqa: E402
from ucc_tpu_torch.status import Status, UccError  # noqa: E402
from ucc_tpu_torch.tl.device import team_layout  # noqa: E402
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy  # noqa: E402

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32}
OPS = (ReductionOp.SUM, ReductionOp.AVG, ReductionOp.MAX, ReductionOp.MIN,
       ReductionOp.PROD)
#: per-rank counts: below any P, no multiple of a vector, a few vectors
COUNTS = (1, 3, 37, 100)

#: collective -> (entry point, src count of c, dst count of c, takes op)
ENTRIES = {
    "allreduce": (kr.ring_allreduce_pass, lambda n, c: c,
                  lambda n, c: c, True),
    "reduce_scatter": (krs.ring_reduce_scatter_pass, lambda n, c: n * c,
                       lambda n, c: c, True),
    "allgather": (krs.ring_allgather_pass, lambda n, c: c,
                  lambda n, c: n * c, False),
    "bcast": (kba.ring_bcast_pass, lambda n, c: c, lambda n, c: c, False),
    "alltoall": (kba.ring_alltoall_pass, lambda n, c: n * c,
                 lambda n, c: n * c, False),
}


def _srcs(n, count, dtype, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if dtype.is_floating_point:
            x = torch.from_numpy(rng.standard_normal(count).astype(
                np.float32)).to(dtype)
        else:
            x = torch.from_numpy(rng.integers(-50, 50, count).astype(
                np.int32))
        out.append(x)
    if dtype.is_floating_point and count > 3:
        out[1][2] = float("nan")         # MAX/MIN keep which NaN survives
    return out


def _call(coll, srcs, dsts, op, part=None):
    fn, _, _, takes_op = ENTRIES[coll]
    kw = {} if part is None else {"part": part}
    if coll == "bcast":
        kw["root"] = len(srcs) - 1
    if takes_op:
        fn(srcs, dsts, op, **kw)
    else:
        fn(srcs, dsts, **kw)


def _bits(ts):
    """Each tensor as integers of its width: a bitwise comparison (NaN
    payloads included)."""
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return [t.view(as_int.get(t.dtype, t.dtype)) for t in ts]


@pytest.mark.parametrize("coll", list(ENTRIES))
@pytest.mark.parametrize("n", [2, 3, 5, 8])
@pytest.mark.parametrize("nparts", [1, 2, 3, 4])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_union_of_parts_is_the_whole(coll, n, nparts, dt):
    _, src_count, dst_count, takes_op = ENTRIES[coll]
    dtype = DTYPES[dt]
    ops = [o for o in OPS if not (o == ReductionOp.AVG and
                                  not dtype.is_floating_point)] \
        if takes_op else [None]
    for i, c in enumerate(COUNTS):
        for op in ops:
            srcs = _srcs(n, src_count(n, c), dtype, 100 * n + i)
            whole = [torch.zeros(dst_count(n, c), dtype=dtype)
                     for _ in range(n)]
            _call(coll, srcs, whole, op)
            parts = [torch.full((dst_count(n, c),), 7, dtype=dtype)
                     for _ in range(n)]
            for p in range(nparts):
                _call(coll, srcs, parts, op, part=(p, nparts))
            for r, (a, b) in enumerate(zip(_bits(whole), _bits(parts))):
                assert torch.equal(a, b), (coll, n, nparts, dt, c, op, r)


@pytest.mark.parametrize("walk", [0, 1, 3, 4, 37, 64, 1000, 4097])
@pytest.mark.parametrize("elem", [1, 2, 4, 8])
def test_part_bounds_cut_at_vectors_and_cover_the_walk(walk, elem):
    w = 16 // elem
    for nparts in (1, 2, 3, 4, 7):
        bounds = [kc.part_bounds(walk, (p, nparts), elem)
                  for p in range(nparts)]
        assert bounds[0][0] == 0 and bounds[-1][1] == walk
        for (a, b), (c, _) in zip(bounds, bounds[1:]):
            assert a <= b == c
        for a, b in bounds:
            assert a % w == 0 or a == walk
    with pytest.raises(UccError):
        kc.part_bounds(10, (3, 3), 4)


# ---------------------------------------------------------------------------
# against the Pallas kernels in interpret mode, one small shape
# ---------------------------------------------------------------------------

N_PALLAS = 4
P_PALLAS = 3


def _union(coll, arrs, dst_count, op=None):
    srcs = [from_numpy(a, "cpu") for a in arrs]
    dsts = [torch.zeros(dst_count, dtype=srcs[0].dtype) for _ in srcs]
    for p in range(P_PALLAS):
        _call(coll, srcs, dsts, op, part=(p, P_PALLAS))
    return [to_numpy(d) for d in dsts]


@pytest.mark.parametrize("coll,dt,op", [
    ("allreduce", "f32", "SUM"), ("reduce_scatter", "bf16", "MAX"),
    ("allgather", "i32", None), ("bcast", "f32", None),
    ("alltoall", "bf16", None)])
def test_union_of_parts_is_the_pallas_kernel(coll, dt, op, monkeypatch):
    n, c = N_PALLAS, 37
    count = ENTRIES[coll][1](n, c)
    arrs = rc.make_inputs(n, count, dt, op or "SUM", 500)
    if coll == "allreduce":
        want = rc.jax_ring("pass", n, op, arrs, monkeypatch)
    elif coll == "reduce_scatter":
        want = rc.jax_reduce_scatter("pass", n, op, arrs, monkeypatch)
    elif coll == "allgather":
        want = rc.jax_allgather("pass", n, arrs, monkeypatch)
    elif coll == "bcast":
        want = rc.jax_bcast("pass", n, n - 1, arrs, monkeypatch)
    else:
        want = rc.jax_alltoall("pass", n, arrs, monkeypatch)
    got = _union(coll, arrs, ENTRIES[coll][2](n, c),
                 ReductionOp[op] if op else None)
    for r in range(n):
        assert rc.bitwise_equal(got[r], np.asarray(want[r]).astype(
            rc.DTYPES[dt])), (coll, r)


# ---------------------------------------------------------------------------
# the process layout
# ---------------------------------------------------------------------------

def _layout(procs, devices, me, size=None):
    """team_layout over a faked table: ``procs[cr]`` and ``devices[cr]``
    of context rank cr, team rank gr = context rank gr."""
    size = len(procs) if size is None else size
    return team_layout(size, lambda gr: gr, lambda cr: procs[cr],
                       lambda cr: devices[cr], me, devices[0], "t")


def test_layout_numbers_processes_by_their_lowest_rank():
    a, b, c = ("h", 30), ("h", 10), ("h", 20)
    procs = [a, b, b, c, a, c]
    dev = [("cuda:0", "GPU-1", "u")] * 6
    lay = _layout(procs, dev, b)
    assert lay.procs == [[0, 4], [1, 2], [3, 5]] and lay.me == 1
    assert _layout(procs, dev, c).me == 2
    one = _layout([a] * 4, dev, a)
    assert one.procs == [[0, 1, 2, 3]] and one.me == 0


def test_layout_refuses_another_host():
    procs = [("h1", 1), ("h1", 1), ("h2", 5), ("h2", 5)]
    dev = [("cuda:0", "GPU-1", "u")] * 4
    with pytest.raises(UccError) as ei:
        _layout(procs, dev, ("h1", 1))
    assert ei.value.status == Status.ERR_NOT_SUPPORTED
    assert "host" in str(ei.value)


def test_layout_compares_cards_by_uuid_not_name():
    procs = [("h", 1), ("h", 1), ("h", 2), ("h", 2)]
    # one card under two names (another CUDA_VISIBLE_DEVICES): accepted
    same = [("cuda:0", "GPU-a", "u")] * 2 + [("cuda:1", "GPU-a", "v")] * 2
    assert len(_layout(procs, same, ("h", 1)).procs) == 2
    # two cards under one name: refused
    other = [("cuda:0", "GPU-a", "u")] * 2 + [("cuda:0", "GPU-b", "v")] * 2
    with pytest.raises(UccError) as ei:
        _layout(procs, other, ("h", 1))
    assert ei.value.status == Status.ERR_NOT_SUPPORTED
    assert "GPU-b" in str(ei.value)


@pytest.mark.parametrize("conf,refused", [
    ("expandable_segments:True", True), ("expandable_segments:true", True),
    ("max_split_size_mb:64,expandable_segments:True", True),
    ("expandable_segments:False", False), ("", False),
    ("max_split_size_mb:64", False)])
def test_expandable_segments_are_refused(monkeypatch, conf, refused):
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", conf)
    if refused:
        with pytest.raises(UccError) as ei:
            cuda_ipc.check_allocator()
        assert ei.value.status == Status.ERR_NOT_SUPPORTED
        assert "expandable_segments" in str(ei.value)
    else:
        cuda_ipc.check_allocator()


# ---------------------------------------------------------------------------
# candidate lists of a spanning team
# ---------------------------------------------------------------------------

def _tl_team(teams, name):
    return next(t for t in teams[0].cl_teams[0].tl_teams if t.NAME == name)


def _rows(score, coll_of, mem):
    return {coll.name: [(r.start, r.end, r.score, r.alg_name)
                        for r in score.ranges.get((coll_of(coll.name), mem),
                                                  [])]
            for coll in ut.CollType}


def test_spanning_candidate_lists_are_tl_xlas():
    job, teams = make_jax_job("", tl="xla", n=4)
    tjob = make_torch_job(n=4)
    try:
        jx = _tl_team(teams, "xla")
        to = _tl_team(tjob.teams, "torch_ops")
        # the reference's team of 2 local ranks of 4; the port's team with
        # a span (its rounds are not run here)
        jx.shared.n_local, saved = 2, jx.shared.n_local
        to.shared.span = object()
        try:
            want = _rows(jx.get_scores(), lambda c: ucc_tpu.CollType[c],
                         ucc_tpu.MemoryType.TPU)
            got = _rows(to.get_scores(), lambda c: ut.CollType[c],
                        ut.MemoryType.CUDA)
        finally:
            jx.shared.n_local = saved
            to.shared.span = None
        assert got == want
        assert not got["SCATTERV"] and got["ALLTOALLV"]
        assert all(r[3] != "short" for rows in got.values() for r in rows)
        ar = {r[3]: r[2] for r in got["ALLREDUCE"]}
        assert ar == {"xla": 40, "ring": 39}
        # the same team in one process keeps short and scatterv
        local = _rows(to.get_scores(), lambda c: ut.CollType[c],
                      ut.MemoryType.CUDA)
        assert local["SCATTERV"] and any(
            r[3] == "short" for r in local["ALLREDUCE"])
    finally:
        job.cleanup()
        tjob.cleanup()


def test_gen_device_initializes_on_a_spanning_team(monkeypatch):
    from ucc_tpu_torch.core.coll import InitArgs
    from ucc_tpu_torch.dsl import lower_device as ld
    from ucc_tpu_torch.tl.torch_ops import GenDeviceCollTask
    tjob = make_torch_job(n=4, UCC_GEN_DEVICE="y")
    try:
        to = _tl_team(tjob.teams, "torch_ops")
        prog = next(iter(ld.registered_device_programs(to)))
        x = torch.ones(64)
        args = ut.CollArgs(
            coll_type=prog.coll, op=ut.ReductionOp.SUM,
            src=ut.BufferInfo(x, 64, ut.DataType.FLOAT32,
                              mem_type=ut.MemoryType.CUDA),
            dst=ut.BufferInfo(torch.empty(64), 64, ut.DataType.FLOAT32,
                              mem_type=ut.MemoryType.CUDA))
        ia = InitArgs(args=args, team=tjob.teams[0],
                      mem_type=ut.MemoryType.CUDA, msgsize=256)
        local = GenDeviceCollTask(ia, to, prog, ld.device_backend(to))
        to.shared.span = object()
        try:
            assert to.spanning
            # the kernels' parts write every process's dsts and read no
            # src from a copy; the xla backend writes its own ranks' dsts
            # from every src, as tl/torch_ops's library ops do
            kernel = GenDeviceCollTask(ia, to, prog, ld.device_backend(to))
            xla = GenDeviceCollTask(ia, to, prog, "xla")
        finally:
            to.shared.span = None
        assert kernel.alg == local.alg == ld.dev_alg_name(prog)
        assert kernel.PEERS_WRITE and not xla.PEERS_WRITE
        assert [kernel.peers_read_src(tr, [0, 1]) for tr in range(4)] == \
            [False] * 4
        assert [xla.peers_read_src(tr, [0, 1]) for tr in range(4)] == \
            [True] * 4
    finally:
        tjob.cleanup()


@pytest.mark.parametrize("coll,root,local,want", [
    ("ALLREDUCE", 0, [0, 1], [True] * 4),
    ("ALLTOALLV", 0, [2, 3], [True] * 4),
    ("BCAST", 3, [0, 1], [False, False, False, True]),
    ("SCATTERV", 1, [0, 1], [False, True, False, False]),
    ("GATHER", 2, [0, 1], [True] * 4),
    ("REDUCE", 2, [2, 3], [False] * 4),
])
def test_which_srcs_peers_read(coll, root, local, want):
    """On a spanning team tl/torch_ops reads from a copy only the srcs that
    another process reads (an src inside a local dst); the kernels' parts
    of tl/ring_cuda read none from a copy."""
    from types import SimpleNamespace

    from ucc_tpu_torch.tl.device import DeviceCollTask
    from ucc_tpu_torch.tl.torch_ops import TorchOpsCollTask
    task = SimpleNamespace(coll=ut.CollType[coll], root=root)
    assert [TorchOpsCollTask.peers_read_src(task, tr, local)
            for tr in range(4)] == want
    assert not any(DeviceCollTask.peers_read_src(task, tr, local)
                   for tr in range(4))
