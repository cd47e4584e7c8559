"""The one-pass ring allreduce kernel's plain version against the JAX
package's Pallas ring kernel, bitwise, and the kernel wrappers on CPU
tensors. (The chunked kernel: tests/test_torch_ring_chunked.py.)

``ucc_tpu_torch.kernels.ring_allreduce`` holds two CUDA kernels and, for
each, a plain PyTorch version that follows the same step schedule over
the same geometry. The Pallas kernels they replace run here in interpret
mode on the virtual CPU mesh, as tests/test_ring_dma.py runs them. Both
sides get the same numpy inputs, made from a seed.

The results must be bitwise equal (NaN positions compared as NaN): both
sides fold ``work[recv] = acc(work[recv], incoming)`` in the same order,
round 16-bit floats after every operation, and divide AVG in float32 at
the end. The kernel runs a covering set of (n, dtype, op) cases (see
``covering_cases``); the elementwise fold and the AVG division of every
dtype and op are held against ucc_tpu's own, which is all of the
computation that depends on dtype and op. The CUDA kernels are held to these plain versions, bitwise, on
the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import ucc_tpu.tl.ring_dma as rd  # noqa: E402
from ucc_tpu.constants import ReductionOp as JReductionOp  # noqa: E402
from torch_ring_cases import (DTYPES, NS, OPS, PASS_COUNT,  # noqa: E402
                              bitwise_equal, covering_cases, jax_ring,
                              make_inputs, torch_ring)
from ucc_tpu_torch.constants import ReductionOp  # noqa: E402
from ucc_tpu_torch.kernels import ring_allreduce as kr  # noqa: E402
from ucc_tpu_torch.status import UccError  # noqa: E402
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy  # noqa: E402


@pytest.mark.parametrize("n,dt,op", covering_cases(0))
def test_pass_matches_pallas_ring_kernel(n, dt, op, monkeypatch):
    arrs = make_inputs(n, PASS_COUNT, dt, op, seed=n * 100 + OPS.index(op))
    want = jax_ring("pass", n, op, arrs, monkeypatch)
    got = torch_ring("pass", op, arrs)
    for r in range(n):
        assert bitwise_equal(got[r], want[r]), (r, got[r], want[r])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_fold_matches_ring_dma_accumulate(dt, op):
    """Eight values folded one by one, as a block is around the ring:
    16-bit floats round after every step, NaN propagates through MAX and
    MIN, and int32 products wrap."""
    arrs = make_inputs(8, 257, dt, op, seed=7 + OPS.index(op))
    jacc, tacc = rd._accum(JReductionOp[op]), kr._accum(ReductionOp[op])
    want, got = jnp.asarray(arrs[0]), from_numpy(arrs[0], "cpu")
    for a in arrs[1:]:
        want = jacc(want, jnp.asarray(a))
        got = tacc(got, from_numpy(a, "cpu"))
    assert bitwise_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n", NS)
def test_avg_division_matches_ring_dma(n, dt):
    """AVG's last step, ``(out / n).astype(out.dtype)`` in ring_dma."""
    x = make_inputs(1, 257, dt, "SUM", seed=n)[0] * 7
    want = (jnp.asarray(x) / n).astype(x.dtype)
    got = kr._divide(from_numpy(x, "cpu"), n)
    assert bitwise_equal(to_numpy(got), np.asarray(want))


# ---------------------------------------------------------------------------
# the wrappers on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wrapper,ref", [
    (kr.ring_allreduce_pass, kr.ring_allreduce_pass_ref),
    (kr.ring_allreduce_chunked, kr.ring_allreduce_chunked_ref)])
@pytest.mark.parametrize("inplace", [False, True])
def test_wrapper_on_cpu_writes_dst_without_a_launch(wrapper, ref, inplace):
    g = torch.Generator().manual_seed(3)
    srcs = [torch.randn(1000, generator=g) for _ in range(4)]
    want = ref(srcs, ReductionOp.SUM)
    before = wrapper.launches
    dsts = srcs if inplace else [torch.zeros(1000) for _ in range(4)]
    wrapper(srcs, dsts, ReductionOp.SUM).wait()
    assert wrapper.launches == before       # the plain version launches nothing
    for d, w in zip(dsts, want):
        assert torch.equal(d, w)


def test_geometry_routes_like_the_tpu_kernels():
    n = 8
    assert kr.pass_elems(n) % n == 0
    assert kr.pass_geometry(37, 8) == (5, 1)
    blk, chunks = kr.chunked_geometry(16 << 20, n)
    assert blk * n == kr.pass_elems(n) and chunks == -(-(16 << 20) //
                                                      kr.pass_elems(n))
    with pytest.raises(ValueError):
        kr.chunked_geometry(100, 8, csize=12)


def test_plain_version_sums_in_ring_order():
    """Block b of the result accumulates from rank b+1 around the ring:
    acc(x_{b-1}, ... acc(x_{b+2}, acc(x_{b+1}, x_b)))."""
    n = 4
    srcs = [torch.tensor([float(10 ** r)] * n) for r in range(n)]
    out = kr.ring_allreduce_pass_ref(srcs, ReductionOp.SUM)
    assert all(torch.equal(o, torch.full((n,), 1111.0)) for o in out)
    # bf16 rounds after every add (256 + 1 -> 256, 2 + 256 -> 258): each
    # block meets its two 1s before its 256 only in ring order
    srcs = [torch.tensor([1.0, 256.0, 1.0], dtype=torch.bfloat16),
            torch.tensor([1.0, 1.0, 256.0], dtype=torch.bfloat16),
            torch.tensor([256.0, 1.0, 1.0], dtype=torch.bfloat16)]
    out = kr.ring_allreduce_pass_ref(srcs, ReductionOp.SUM)
    for o in out:
        assert torch.equal(o, torch.full((3,), 258.0, dtype=torch.bfloat16))


@pytest.mark.parametrize("bad", ["dtype", "count", "op", "ranks"])
def test_wrapper_rejects_bad_arguments(bad):
    srcs = [torch.zeros(8) for _ in range(2)]
    dsts = [torch.zeros(8) for _ in range(2)]
    op = ReductionOp.SUM
    if bad == "dtype":
        dsts[1] = torch.zeros(8, dtype=torch.float64)
    elif bad == "count":
        dsts[1] = torch.zeros(9)
    elif bad == "op":
        op = ReductionOp.BXOR
    else:
        dsts = dsts[:1]
    with pytest.raises(UccError):
        kr.ring_allreduce_pass(srcs, dsts, op)
