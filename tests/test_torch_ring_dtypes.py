"""The ring kernels' wider dtype list: int8, uint8, int16 and float64 beside
float32, float16, bfloat16, int32 and int64, as tl/ring_dma takes any
numeric dtype. The wrappers (on CPU tensors, where they run their plain
versions) are held bitwise to the JAX package's Pallas kernels in
interpret mode for the integer types; float64, which the JAX package holds
as float32 with x64 off, is held to numpy. tl/ring_cuda takes the same
list through the stack, and the unsigned 16-, 32- and 64-bit types stay
ERR_NOT_SUPPORTED: torch has no add, maximum or minimum for them on the
CPU, where the plain versions run."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from torch_ring_cases import (bitwise_equal, jax_allgather,  # noqa: E402
                              jax_alltoall, jax_bcast, jax_reduce_scatter,
                              jax_ring, make_inputs)
from torch_stack_cases import make_torch_job  # noqa: E402
import ucc_tpu_torch as ut  # noqa: E402
from ucc_tpu_torch.constants import ReductionOp  # noqa: E402
from ucc_tpu_torch.kernels import ring_allreduce as kr  # noqa: E402
from ucc_tpu_torch.kernels import ring_bcast_a2a as kba  # noqa: E402
from ucc_tpu_torch.kernels import ring_common as kc  # noqa: E402
from ucc_tpu_torch.kernels import ring_rs_ag as krs  # noqa: E402
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy  # noqa: E402


def _call(wrapper, arrs, dst_count, op=None, **kw):
    srcs = [from_numpy(a, "cpu") for a in arrs]
    dsts = [torch.zeros(dst_count, dtype=srcs[0].dtype) for _ in arrs]
    before = wrapper.launches
    wrapper(srcs, dsts, op, **kw).wait()
    assert wrapper.launches == before        # CPU tensors: no launch
    return [to_numpy(d) for d in dsts]


def test_int8_allreduce_sum_matches_pallas(monkeypatch):
    """ALLREDUCE SUM of INT8 at n 2, count 37: sums of two values in
    [-50, 50) stay in range, products would not."""
    arrs = make_inputs(2, 37, "i8", "SUM", seed=37)
    want = jax_ring("pass", 2, "SUM", arrs, monkeypatch)
    got = _call(kr.ring_allreduce_pass, arrs, 37, ReductionOp.SUM)
    for g, w in zip(got, want):
        assert bitwise_equal(g, w)
    np.testing.assert_array_equal(got[0], arrs[0] + arrs[1])


@pytest.mark.parametrize("kernel,n,dt,op", [
    ("pass", 4, "u8", "MAX"), ("pass", 8, "i16", "PROD"),
    ("pass", 4, "i8", "AVG"), ("chunked", 4, "i16", "SUM")])
def test_allreduce_matches_pallas(monkeypatch, kernel, n, dt, op):
    arrs = make_inputs(n, 151, dt, op, seed=n + len(op))
    if kernel == "chunked":
        monkeypatch.setattr(kr, "CHUNK_ELEMS", 64)
    want = jax_ring(kernel, n, op, arrs, monkeypatch)
    wrapper = kr.ring_allreduce_pass if kernel == "pass" \
        else kr.ring_allreduce_chunked
    got = _call(wrapper, arrs, 151, ReductionOp[op])
    for g, w in zip(got, want):
        assert bitwise_equal(g, w), (g, w)


def test_reduce_scatter_matches_pallas(monkeypatch):
    n, c = 4, 37
    arrs = make_inputs(n, n * c, "u8", "SUM", seed=5)
    want = jax_reduce_scatter("pass", n, "SUM", arrs, monkeypatch)
    got = _call(krs.ring_reduce_scatter_pass, arrs, c, ReductionOp.SUM)
    for g, w in zip(got, want):
        assert bitwise_equal(g, w)


def test_allgather_matches_pallas(monkeypatch):
    n, c = 8, 37
    arrs = make_inputs(n, c, "i8", "SUM", seed=6)
    want = jax_allgather("pass", n, arrs, monkeypatch)
    got = _call(krs.ring_allgather_pass, arrs, n * c)
    for g, w in zip(got, want):
        assert bitwise_equal(g, w)
        assert bitwise_equal(g, np.concatenate(arrs))


def test_bcast_matches_pallas(monkeypatch):
    n, root = 4, 3
    arrs = make_inputs(n, 96, "i16", "SUM", seed=7)
    want = jax_bcast("pass", n, root, arrs, monkeypatch)
    got = _call(kba.ring_bcast_pass, arrs, 96, root=root)
    for g, w in zip(got, want):
        assert bitwise_equal(g, w) and bitwise_equal(g, arrs[root])


def test_alltoall_matches_pallas(monkeypatch):
    n, blk = 4, 9
    arrs = make_inputs(n, n * blk, "u8", "SUM", seed=8)
    want = jax_alltoall("pass", n, arrs, monkeypatch)
    got = _call(kba.ring_alltoall_pass, arrs, n * blk)
    for g, w in zip(got, want):
        assert bitwise_equal(g, w)


@pytest.mark.parametrize("op", ["SUM", "AVG", "MAX", "MIN", "PROD"])
def test_float64_allreduce_keeps_float64(op):
    """Integer-valued float64 sums and products are exact in any order;
    AVG divides in float64."""
    rng = np.random.default_rng(9)
    arrs = [rng.integers(-5, 5, 41).astype(np.float64) for _ in range(4)]
    got = _call(kr.ring_allreduce_pass, arrs, 41, ReductionOp[op])
    stack = np.stack(arrs)
    want = {"SUM": stack.sum(0), "AVG": stack.sum(0) / 4,
            "MAX": stack.max(0), "MIN": stack.min(0),
            "PROD": stack.prod(0)}[op]
    for g in got:
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, want)


def test_dtype_codes_name_every_ec_integer_type_torch_can_add():
    assert set(kc.DTYPE_CODES) == {
        torch.float32, torch.float16, torch.bfloat16, torch.float64,
        torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64}
    assert sorted(kc.DTYPE_CODES.values()) == list(range(9))


@pytest.fixture(scope="module")
def torch_job():
    job = make_torch_job("allreduce:@ring_cuda:inf", n=2)
    yield job
    job.cleanup()


@pytest.mark.parametrize("dt", ["INT8", "UINT8", "INT16", "FLOAT64"])
def test_ring_cuda_takes_the_wider_types(torch_job, dt):
    td = ut.dt_torch(ut.DataType[dt])
    hosts = [to_numpy(torch.arange(37).to(td) * (r + 1)) for r in range(2)]
    rounds = torch_job.persistent(ut.CollType.ALLREDUCE, hosts,
                                  ut.ReductionOp.SUM, ut.DataType[dt])
    want = to_numpy(torch.arange(37).to(td) * 3)
    for rnd in rounds:
        for got in rnd:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", ["UINT16", "UINT32", "UINT64"])
def test_ring_cuda_refuses_unsigned_wide_types(torch_job, dt):
    td = ut.dt_torch(ut.DataType[dt])
    buf = torch.zeros(8, dtype=td)
    args = ut.CollArgs(
        coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
        src=ut.BufferInfo(buf, 8, ut.DataType[dt], mem_type=ut.MemoryType.CUDA),
        dst=ut.BufferInfo(buf.clone(), 8, ut.DataType[dt],
                          mem_type=ut.MemoryType.CUDA))
    with pytest.raises(ut.UccError) as ei:
        torch_job.teams[0].collective_init(args)
    assert ei.value.status == ut.Status.ERR_NOT_SUPPORTED
