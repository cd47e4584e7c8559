"""The port's in-graph API (``ucc_tpu_torch.ops`` over a ``RankMesh``)
against the JAX package's ``ops`` under ``shard_map``, on the CPU.

The JAX side runs each function inside ``shard_map_compat`` on the virtual
8-device mesh, as a (8,) mesh with axis ``r`` and a (2, 4) mesh with axes
(``dp``, ``sp``); the port runs it on a ``RankMesh`` of the same axes on
device ``cpu``, where the library's collectives run their plain versions.
Both get the same per-rank shards, made with numpy from a seed; rank r's
shard is row r of the global (8, ...) array, which ``P(axes)`` places on
mesh position r in both packages.

Tolerances: moves (allgather, alltoall, bcast, scatter, ring_shift, the
v-types), MAX, MIN, the logical, bitwise and loc ops, integer sums and the
ring allreduce are bitwise; so is a tuple of axes' numbering (JAX's
axis_index for the collectives, its ppermute's mesh order for
ring_shift). Float32 SUM, AVG and PROD are within rtol 1e-5,
atol 1e-5 (the JAX package's own ops test): both sum 2–8 terms of |x| < 5
in another order, a few ulp of the partial sums. Gradients: the same.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ucc_tpu import ops as jops  # noqa: E402
from ucc_tpu.constants import ReductionOp as JOp  # noqa: E402
from ucc_tpu.utils.jaxshim import shard_map_compat  # noqa: E402
from ucc_tpu_torch import ops  # noqa: E402
from ucc_tpu_torch.constants import ReductionOp  # noqa: E402
from ucc_tpu_torch.core.team import Team  # noqa: E402
from ucc_tpu_torch.mesh import RankMesh  # noqa: E402
from ucc_tpu_torch.status import UccError  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
N = 8
#: (mesh name, axis) pairs every function runs on
AXES = [("r", "r"), ("2d", "dp"), ("2d", "sp"), ("2d", ("sp", "dp"))]
SIZES = {"r": 8, "dp": 2, "sp": 4, ("sp", "dp"): 8}


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < N:
        pytest.skip("needs 8 virtual devices")
    port = {"r": RankMesh({"r": 8}, device="cpu"),
            "2d": RankMesh({"dp": 2, "sp": 4}, device="cpu")}
    yield ({"r": jax.make_mesh((8,), ("r",)),
            "2d": jax.make_mesh((2, 4), ("dp", "sp"))}, port)
    for m in port.values():
        m.destroy()


def jax_run(jmesh, fn, x):
    """fn on each rank's shard x[r] under shard_map; (8, ...) results."""
    spec = P(tuple(jmesh.axis_names))
    f = shard_map_compat(lambda a: fn(a[0])[None], jmesh, spec, spec)
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


def port_run(fn, x):
    out = fn([torch.from_numpy(np.array(v)) for v in x])
    return np.stack([o.numpy() for o in out])


def data(shape, dtype, seed, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(-50, 50, (N, *shape)).astype(dtype)
    if kind == "small":
        return rng.integers(0, 3, (N, *shape)).astype(dtype)
    if kind == "near1":
        return (1 + 0.1 * rng.standard_normal((N, *shape))).astype(dtype)
    return rng.standard_normal((N, *shape)).astype(dtype)


def exact(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        got = got.view(f"i{got.dtype.itemsize}")
        want = want.view(f"i{want.dtype.itemsize}")
    np.testing.assert_array_equal(got, want)


def both(meshes, name, axis, jfn, pfn, x, bitwise):
    jm, pm = meshes[0][name], meshes[1][name]
    want = jax_run(jm, lambda a: jfn(a, axis), x)
    got = port_run(lambda xs: pfn(xs, pm, axis), x)
    if bitwise:
        exact(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)
    return got


# ---------------------------------------------------------------------------
# allreduce: every op on axis r; SUM and MAX on every axis
# ---------------------------------------------------------------------------

OP_CASES = [
    ("SUM", np.float32, "normal", False), ("SUM", np.int32, "int", True),
    ("AVG", np.float32, "normal", False), ("MAX", np.float32, "normal", True),
    ("MIN", np.float32, "normal", True), ("MAX", np.int32, "int", True),
    ("PROD", np.float32, "near1", False), ("LAND", np.int32, "small", True),
    ("LOR", np.float32, "small", True), ("LXOR", np.int32, "small", True),
    ("BAND", np.int32, "int", True), ("BOR", np.int32, "int", True),
    ("BXOR", np.int32, "int", True),
]


@pytest.mark.parametrize("op,dtype,kind,bitwise", OP_CASES)
def test_allreduce_every_op(meshes, op, dtype, kind, bitwise):
    x = data((2, 6), dtype, seed=len(op) + np.dtype(dtype).itemsize, kind=kind)
    both(meshes, "r", "r",
         lambda a, ax: jops.allreduce(a, JOp[op], ax),
         lambda xs, m, ax: ops.allreduce(xs, ReductionOp[op], mesh=m,
                                         axis_name=ax), x, bitwise)


@pytest.mark.parametrize("op", ["MINLOC", "MAXLOC"])
def test_allreduce_loc(meshes, op):
    rng = np.random.default_rng(3)
    x = np.empty((N, 2, 8), np.float32)
    x[..., 0::2] = rng.integers(0, 4, (N, 2, 4))      # ties on purpose
    x[..., 1::2] = np.arange(N)[:, None, None]
    both(meshes, "r", "r", lambda a, ax: jops.allreduce(a, JOp[op], ax),
         lambda xs, m, ax: ops.allreduce(xs, ReductionOp[op], mesh=m,
                                         axis_name=ax), x, True)


def test_allreduce_avg_of_integers_is_float(meshes):
    x = data((5,), np.int32, seed=4, kind="int")
    got = both(meshes, "r", "r",
               lambda a, ax: jops.allreduce(a, JOp.AVG, ax),
               lambda xs, m, ax: ops.allreduce(xs, ReductionOp.AVG, mesh=m,
                                               axis_name=ax), x, False)
    assert got.dtype == np.float32


@pytest.mark.parametrize("shape", [(6,), (2, 3)])
@pytest.mark.parametrize("name,axis", AXES)
def test_allreduce_axes(meshes, name, axis, shape):
    x = data(shape, np.float32, seed=len(shape))
    for op, bitwise in (("SUM", False), ("MAX", True)):
        both(meshes, name, axis,
             lambda a, ax: jops.allreduce(a, JOp[op], ax),
             lambda xs, m, ax: ops.allreduce(xs, ReductionOp[op], mesh=m,
                                             axis_name=ax), x, bitwise)


@pytest.mark.parametrize("op", ["SUM", "AVG"])
@pytest.mark.parametrize("name,axis", [("r", "r"), ("2d", "sp")])
def test_allreduce_ring_bits(meshes, name, axis, op):
    x = data((2, 16), np.float32, seed=11)
    both(meshes, name, axis,
         lambda a, ax: jops.allreduce_ring(a, JOp[op], ax),
         lambda xs, m, ax: ops.allreduce_ring(xs, ReductionOp[op], mesh=m,
                                              axis_name=ax), x, True)


# ---------------------------------------------------------------------------
# reduce_scatter, allgather, alltoall, scatter, bcast, ring_shift
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16,), (2, 8)])
@pytest.mark.parametrize("name,axis", AXES)
def test_reduce_scatter(meshes, name, axis, shape):
    x = data(shape, np.float32, seed=5)
    for op in ("SUM", "AVG"):
        got = both(meshes, name, axis,
                   lambda a, ax: jops.reduce_scatter(a, JOp[op], ax),
                   lambda xs, m, ax: ops.reduce_scatter(
                       xs, ReductionOp[op], mesh=m, axis_name=ax), x, False)
        assert got.shape[-1] == shape[-1] // SIZES[axis]
    # MAX: the reference's reduce_scatter fails at run time for it
    # (ROADMAP §C); the port's is block i of the allreduce, exactly
    pm = meshes[1][name]
    xs = [torch.from_numpy(v.copy()) for v in x]
    full = ops.allreduce(xs, ReductionOp.MAX, mesh=pm, axis_name=axis)
    got = ops.reduce_scatter(xs, ReductionOp.MAX, mesh=pm, axis_name=axis)
    b = shape[-1] // SIZES[axis]
    for r in range(N):
        i = pm.axis_index(r, axis)
        assert torch.equal(got[r], full[r][..., i * b:(i + 1) * b])


@pytest.mark.parametrize("shape", [(3,), (2, 3)])
@pytest.mark.parametrize("name,axis", AXES)
def test_allgather_and_gather(meshes, name, axis, shape):
    x = data(shape, np.float32, seed=6)
    got = both(meshes, name, axis, lambda a, ax: jops.allgather(a, ax),
               lambda xs, m, ax: ops.allgather(xs, mesh=m, axis_name=ax),
               x, True)
    assert got.shape[-1] == 3 * SIZES[axis]
    both(meshes, name, axis, lambda a, ax: jops.gather(a, 0, ax),
         lambda xs, m, ax: ops.gather(xs, 0, mesh=m, axis_name=ax), x, True)


@pytest.mark.parametrize("shape", [(16,), (2, 8)])
@pytest.mark.parametrize("name,axis", AXES)
def test_alltoall(meshes, name, axis, shape):
    x = data(shape, np.int32, seed=7, kind="int")
    both(meshes, name, axis, lambda a, ax: jops.alltoall(a, ax),
         lambda xs, m, ax: ops.alltoall(xs, mesh=m, axis_name=ax), x, True)


def signed_zeros(x):
    """-0.0 at the head of every shard's last axis, the root's included."""
    x = x.copy()
    x[..., 0] = -0.0
    return x


@pytest.mark.parametrize("shape", [(5,), (2, 4)])
@pytest.mark.parametrize("name,axis", AXES)
def test_bcast_is_the_masked_sum(meshes, name, axis, shape):
    root = SIZES[axis] - 1
    x = signed_zeros(data(shape, np.float32, seed=8))
    got = both(meshes, name, axis, lambda a, ax: jops.bcast(a, root, ax),
               lambda xs, m, ax: ops.bcast(xs, root, mesh=m, axis_name=ax),
               x, True)
    assert not np.signbit(got[..., 0]).any()     # -0.0 arrives as +0.0
    xi = data(shape, np.int32, seed=9, kind="int")
    both(meshes, name, axis, lambda a, ax: jops.bcast(a, root, ax),
         lambda xs, m, ax: ops.bcast(xs, root, mesh=m, axis_name=ax), xi,
         True)


@pytest.mark.parametrize("shape", [(16,), (2, 8)])
@pytest.mark.parametrize("name,axis", AXES)
def test_scatter(meshes, name, axis, shape):
    root = 1
    x = signed_zeros(data(shape, np.float32, seed=10))
    both(meshes, name, axis, lambda a, ax: jops.scatter(a, root, ax),
         lambda xs, m, ax: ops.scatter(xs, root, mesh=m, axis_name=ax), x,
         True)


@pytest.mark.parametrize("shape", [(4,), (2, 3)])
@pytest.mark.parametrize("name,axis", AXES)
def test_ring_shift_and_reduce(meshes, name, axis, shape):
    x = data(shape, np.float32, seed=12)
    for shift in (1, -3):
        both(meshes, name, axis,
             lambda a, ax: jops.ring_shift(a, ax, shift),
             lambda xs, m, ax: ops.ring_shift(xs, mesh=m, axis_name=ax,
                                              shift=shift), x, True)
    both(meshes, name, axis, lambda a, ax: jops.reduce(a, 0, JOp.MIN, ax),
         lambda xs, m, ax: ops.reduce(xs, 0, ReductionOp.MIN, mesh=m,
                                      axis_name=ax), x, True)


@pytest.mark.parametrize("name,axis", AXES)
def test_allgatherv(meshes, name, axis):
    k = SIZES[axis]
    counts = [(3 * i + 1) % 4 for i in range(k)]      # zeros included
    x = data((2, 2), np.float32, seed=13)
    got = both(meshes, name, axis,
               lambda a, ax: jops.allgatherv(a, counts, ax),
               lambda xs, m, ax: ops.allgatherv(xs, counts, mesh=m,
                                                axis_name=ax), x, True)
    assert got.shape == (N, sum(counts))


@pytest.mark.parametrize("name,axis", AXES)
def test_alltoallv(meshes, name, axis):
    k = SIZES[axis]
    m = np.random.default_rng(k).integers(0, 4, size=(k, k))
    x = data((int(m.sum(1).max()),), np.float32, seed=14)
    both(meshes, name, axis, lambda a, ax: jops.alltoallv(a, m, ax),
         lambda xs, pm, ax: ops.alltoallv(xs, m, mesh=pm, axis_name=ax), x,
         True)


def test_a2av_exchange_with_gapped_layout(meshes):
    """The shared body over index maps whose receive layout has gaps."""
    k = 4
    srows = [([1, 2, 0, 1], [0, 1, 3, 3]) for _ in range(k)]
    drows = [([srows[p][0][i] for p in range(k)], [0, 2, 5, 6])
             for i in range(k)]
    pidx, uidx, maxblk, max_src, _ = jops.a2av_index_maps(srows, drows)
    got_maps = ops.a2av_index_maps(srows, drows)
    for a, b in zip(got_maps, (pidx, uidx, maxblk, max_src)):
        np.testing.assert_array_equal(a, b)
    x = data((4,), np.float32, seed=15)
    both(meshes, "2d", "sp",
         lambda a, ax: jops.a2av_exchange(a, jnp.asarray(pidx),
                                          jnp.asarray(uidx), k, maxblk,
                                          max_src, ax),
         lambda xs, m, ax: ops.a2av_exchange(xs, pidx, uidx, k, maxblk,
                                             max_src, mesh=m, axis_name=ax),
         x, True)


@pytest.mark.parametrize("name,axis", AXES)
def test_barrier_and_axis_size(meshes, name, axis):
    pm = meshes[1][name]
    want = jax_run(meshes[0][name], lambda a: jops.barrier(axis)[0],
                   np.zeros((N, 1), np.float32))
    got = ops.barrier(mesh=pm, axis_name=axis)
    exact(np.stack([g[0].numpy() for g in got]), want)
    assert ops.axis_size(mesh=pm, axis_name=axis) == SIZES[axis]


# ---------------------------------------------------------------------------
# gradients against jax.grad
# ---------------------------------------------------------------------------

GRAD_CASES = [
    ("allreduce SUM", lambda a, ax: jops.allreduce(a, JOp.SUM, ax),
     lambda xs, m, ax: ops.allreduce(xs, ReductionOp.SUM, mesh=m,
                                     axis_name=ax), (2, 4)),
    ("allreduce AVG", lambda a, ax: jops.allreduce(a, JOp.AVG, ax),
     lambda xs, m, ax: ops.allreduce(xs, ReductionOp.AVG, mesh=m,
                                     axis_name=ax), (2, 4)),
    ("allgather", lambda a, ax: jops.allgather(a, ax),
     lambda xs, m, ax: ops.allgather(xs, mesh=m, axis_name=ax), (2, 3)),
    ("reduce_scatter", lambda a, ax: jops.reduce_scatter(a, JOp.SUM, ax),
     lambda xs, m, ax: ops.reduce_scatter(xs, ReductionOp.SUM, mesh=m,
                                          axis_name=ax), (2, 8)),
    ("alltoall", lambda a, ax: jops.alltoall(a, ax),
     lambda xs, m, ax: ops.alltoall(xs, mesh=m, axis_name=ax), (2, 8)),
    ("ring_shift", lambda a, ax: jops.ring_shift(a, ax, 1),
     lambda xs, m, ax: ops.ring_shift(xs, mesh=m, axis_name=ax), (3,)),
    ("bcast", lambda a, ax: jops.bcast(a, 1, ax),
     lambda xs, m, ax: ops.bcast(xs, 1, mesh=m, axis_name=ax), (2, 3)),
    ("scatter", lambda a, ax: jops.scatter(a, 1, ax),
     lambda xs, m, ax: ops.scatter(xs, 1, mesh=m, axis_name=ax), (2, 8)),
]


@pytest.mark.parametrize("name,axis", [("r", "r"), ("2d", "sp"),
                                       ("2d", ("sp", "dp"))])
@pytest.mark.parametrize("what,jfn,pfn,shape", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_gradients_match_jax_grad(meshes, name, axis, what, jfn, pfn,
                                  shape):
    jm, pm = meshes[0][name], meshes[1][name]
    x = data(shape, np.float32, seed=16)
    spec = P(tuple(jm.axis_names))
    f = shard_map_compat(lambda a: jfn(a[0], axis)[None], jm, spec, spec)
    out_shape = jax.eval_shape(f, jnp.asarray(x)).shape
    cot = np.random.default_rng(17).standard_normal(out_shape) \
        .astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(
        lambda a: jnp.sum(f(a) * cot)))(jnp.asarray(x)))

    xs = [torch.from_numpy(v.copy()).requires_grad_() for v in x]
    outs = pfn(xs, pm, axis)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cot)) \
        .backward()
    got = np.stack([t.grad.numpy() for t in xs])
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# compile, library routing, errors
# ---------------------------------------------------------------------------

def test_compiles_fullgraph_with_eager_bits(meshes):
    pm = meshes[1]["2d"]

    def f(xs):
        a = ops.allreduce(xs, ReductionOp.SUM, mesh=pm, axis_name="sp")
        b = ops.allgather(a, mesh=pm, axis_name="dp")
        c = ops.alltoall(b, mesh=pm, axis_name=("sp", "dp"))
        d = ops.reduce_scatter(c, ReductionOp.AVG, mesh=pm, axis_name="dp")
        return ops.ring_shift(d, mesh=pm, axis_name="sp", shift=-1)

    x = data((2, 8), np.float32, seed=18)

    def run(fn):
        xs = [torch.from_numpy(v.copy()).requires_grad_() for v in x]
        outs = fn(xs)
        sum((o * o).sum() for o in outs).backward()
        return [o.detach() for o in outs], [t.grad for t in xs]

    eager = run(f)
    compiled = run(torch.compile(f, backend="aot_eager", fullgraph=True))
    for a, b in zip(eager[0] + eager[1], compiled[0] + compiled[1]):
        assert torch.equal(a, b)


@pytest.fixture
def selected(monkeypatch):
    """The algorithm each library request selected, in post order."""
    algs = []
    init = Team.collective_init

    def record(self, args):
        rq = init(self, args)
        algs.append(rq.task.alg_name)
        return rq

    monkeypatch.setattr(Team, "collective_init", record)
    return algs


def test_tune_routes_the_ops_through_the_library(selected, monkeypatch):
    """A TUNE string read at team creation changes the algorithm ops'
    allreduce runs: short by default at this size, ring pinned on
    tl/torch_ops (with its bits), ring_cuda pinned on tl/ring_cuda."""
    x = data((16,), np.float32, seed=19)
    xs = [torch.from_numpy(v.copy()) for v in x]
    results = {}
    for tl, tune in (("", ""),
                     ("TORCH_OPS", "allreduce:@ring:inf"),
                     ("RING_CUDA", "allreduce:@ring_cuda:inf")):
        for var in ("UCC_TL_TORCH_OPS_TUNE", "UCC_TL_RING_CUDA_TUNE"):
            monkeypatch.delenv(var, raising=False)
        if tl:
            monkeypatch.setenv(f"UCC_TL_{tl}_TUNE", tune)
        with RankMesh({"r": 8}, device="cpu") as m:
            del selected[:]
            results[tl] = ops.allreduce(xs, mesh=m, axis_name="r")
            assert len(selected) == N
            assert set(selected) == {{"": "short", "TORCH_OPS": "ring",
                                      "RING_CUDA": "ring_cuda"}[tl]}
            ring = ops.allreduce_ring(xs, mesh=m, axis_name="r")
    assert all(torch.equal(a, b) for a, b in zip(results["TORCH_OPS"], ring))


def test_mesh_placement_round_trips():
    with RankMesh({"dp": 2, "sp": 4}, device="cpu") as m:
        assert m.groups("sp") == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert m.groups(("sp", "dp")) == [[0, 4, 1, 5, 2, 6, 3, 7]]
        assert [m.axis_index(r, ("sp", "dp")) for r in range(8)] == \
            [0, 2, 4, 6, 1, 3, 5, 7]
        x = torch.arange(4 * 8 * 3.0).reshape(4, 8, 3)
        for spec in (("dp", "sp"), (None, ("sp", "dp")), ("sp",), ()):
            shards = m.shard(x, spec)
            assert all(s.is_contiguous() for s in shards)
            assert torch.equal(m.unshard(shards, spec), x)
        assert m.shard(x, ("dp", "sp"))[5].equal(x[2:4, 2:4])


def test_bad_calls_raise():
    with RankMesh({"dp": 2, "sp": 4}, device="cpu") as m:
        xs = [torch.zeros(8) for _ in range(8)]
        with pytest.raises(UccError, match="axis"):
            ops.allreduce(xs, mesh=m, axis_name="tp")
        with pytest.raises(UccError, match="one tensor per rank"):
            ops.allgather(xs[:4], mesh=m, axis_name="sp")
        with pytest.raises(UccError, match="divide"):
            ops.alltoall([torch.zeros(6)] * 8, mesh=m, axis_name="sp")
    with pytest.raises(UccError, match="no live RankMesh"):
        ops.allreduce(xs, mesh=m, axis_name="sp")


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default succeeds")
    with pytest.raises(UccError, match="CUDA"):
        RankMesh({"r": 2})
