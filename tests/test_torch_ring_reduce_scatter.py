"""The ring reduce_scatter kernels' plain versions against the JAX
package's Pallas kernels, bitwise, and their wrappers on CPU tensors.

``ucc_tpu_torch.kernels.ring_rs_ag`` holds two reduce_scatter kernels:
``ring_reduce_scatter_pass`` (for ``_ring_kernel`` in reduce_scatter mode)
and ``ring_reduce_scatter_chunked`` (for ``_hbm_reduce_scatter_kernel``),
each with a plain PyTorch version that runs the same ring schedule. The
Pallas kernels run here in interpret mode on the virtual CPU mesh, the
chunked one on 64-element chunks (``CHUNK_ELEMS`` monkeypatched) with
blocks of 40, which it re-pads per block, as tests/test_ring_dma.py runs
it. Both sides get the same numpy inputs, made from a seed, on a covering
set of (n, dtype, op) cases (see ``covering_cases``).

Both sides fold ``acc(local, incoming)`` with the ring shift c = 1, round
16-bit floats after every operation and divide AVG in float32 at the end,
so the results must be bitwise equal (NaN positions compared as NaN). An
element's fold order depends on its block index alone, so the chunked
version equals the pass version bitwise at any chunk size; one test holds
that without JAX. The CUDA kernels are held to these plain versions,
bitwise, on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from torch_ring_cases import (OPS, RS_CHUNKED_BLOCK,  # noqa: E402
                              RS_PASS_BLOCK, bitwise_equal, covering_cases,
                              jax_reduce_scatter, make_inputs,
                              torch_reduce_scatter)
from ucc_tpu_torch.constants import ReductionOp  # noqa: E402
from ucc_tpu_torch.kernels import ring_rs_ag as krs  # noqa: E402
from ucc_tpu_torch.status import Status, UccError  # noqa: E402
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy  # noqa: E402


@pytest.mark.parametrize("kernel,block,n,dt,op", [
    ("pass", RS_PASS_BLOCK, *case) for case in covering_cases(0)] + [
    ("chunked", RS_CHUNKED_BLOCK, *case) for case in covering_cases(1)])
def test_reduce_scatter_matches_pallas_kernel(kernel, block, n, dt, op,
                                              monkeypatch):
    arrs = make_inputs(n, n * block, dt, op, seed=n * 10 + OPS.index(op))
    want = jax_reduce_scatter(kernel, n, op, arrs, monkeypatch)
    got = torch_reduce_scatter(kernel, n, op, arrs)
    for r in range(n):
        assert bitwise_equal(got[r], want[r]), (r, got[r], want[r])


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("dt,op", [("f32", "SUM"), ("bf16", "AVG"),
                                   ("f32", "MAX"), ("i32", "PROD")])
def test_chunked_equals_pass_at_any_chunk_size(n, dt, op):
    block = 23
    srcs = [from_numpy(a, "cpu")
            for a in make_inputs(n, n * block, dt, op, seed=n)]
    want = krs.ring_reduce_scatter_ref(srcs, ReductionOp[op], cblk=block)
    for cblk in (1, 2, 5, 22, 64):
        got = krs.ring_reduce_scatter_ref(srcs, ReductionOp[op], cblk=cblk)
        for w, g in zip(want, got):
            assert bitwise_equal(to_numpy(g), to_numpy(w)), cblk


def test_plain_version_folds_in_ring_order():
    """Block b accumulates from rank b+1 around the ring to rank b:
    acc(x_b, acc(x_{b-1}, ... acc(x_{b+2}, x_{b+1}))). In bf16 256 + 1
    rounds back to 256, so the order shows in the result."""
    n = 3
    srcs = [torch.tensor([1.0, 256.0, 1.0], dtype=torch.bfloat16),
            torch.tensor([1.0, 1.0, 256.0], dtype=torch.bfloat16),
            torch.tensor([256.0, 1.0, 1.0], dtype=torch.bfloat16)]
    out = krs.ring_reduce_scatter_ref(srcs, ReductionOp.SUM)
    # block 0: acc(x0=1, acc(x2=256, x1=1)) = 1 + 256 = 257 -> 256
    # block 1: acc(x1=1, acc(x0=256, x2=1)) -> 256
    # block 2: acc(x2=1, acc(x1=256, x0=1)) -> 256
    want = [torch.tensor([256.0], dtype=torch.bfloat16)] * n
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    srcs = [torch.tensor([float(10 ** r)] * 4) for r in range(4)]
    out = krs.ring_reduce_scatter_ref(srcs, ReductionOp.SUM)
    assert all(torch.equal(o, torch.tensor([1111.0])) for o in out)


# ---------------------------------------------------------------------------
# the wrappers on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wrapper", [krs.ring_reduce_scatter_pass,
                                     krs.ring_reduce_scatter_chunked])
@pytest.mark.parametrize("inplace", [False, True])
def test_wrapper_on_cpu_writes_dst_without_a_launch(wrapper, inplace):
    n, c = 4, 250
    g = torch.Generator().manual_seed(3)
    srcs = [torch.randn(n * c, generator=g) for _ in range(n)]
    want = krs.ring_reduce_scatter_ref(srcs, ReductionOp.AVG)
    before = wrapper.launches
    if inplace:
        # the host ring's convention: dst holds the n·c input, and the
        # result lands in its block r; the other blocks stay as they were
        full = [s.clone() for s in srcs]
        wrapper(full, [f[r * c:(r + 1) * c] for r, f in enumerate(full)],
                ReductionOp.AVG).wait()
        for r, (f, s) in enumerate(zip(full, srcs)):
            assert torch.equal(f[r * c:(r + 1) * c], want[r])
            assert torch.equal(f[:r * c], s[:r * c])
            assert torch.equal(f[(r + 1) * c:], s[(r + 1) * c:])
    else:
        dsts = [torch.zeros(c) for _ in range(n)]
        wrapper(srcs, dsts, ReductionOp.AVG).wait()
        for d, w in zip(dsts, want):
            assert torch.equal(d, w)
    assert wrapper.launches == before       # the plain version launches nothing


def test_one_rank_is_a_copy_and_avg_divides_by_one():
    src = torch.arange(7, dtype=torch.int32)
    for op in (ReductionOp.SUM, ReductionOp.AVG):
        dst = torch.zeros(7, dtype=torch.int32)
        krs.ring_reduce_scatter_pass([src], [dst], op).wait()
        assert torch.equal(dst, src)
    empty = [torch.zeros(0) for _ in range(4)]
    krs.ring_reduce_scatter_chunked(empty, empty, ReductionOp.SUM).wait()


def test_geometry_routes_like_the_tpu_kernels():
    n = 8
    assert krs.reduce_scatter_pass_elems(n) == (krs.CHUNK_ELEMS // n) * n
    assert krs.allgather_pass_elems(n) == krs.CHUNK_ELEMS // n
    # the main path's bucket: 16 Mi in per rank, blocks of 2 Mi in 16 chunks
    assert krs.chunk_geometry((16 << 20) // n, n) == (krs.CHUNK_ELEMS // n,
                                                      16)
    assert krs.chunk_geometry(40, 4, 16) == (16, 3)
    with pytest.raises(ValueError):
        krs.chunk_geometry(40, 4, 0)


@pytest.mark.parametrize("bad", ["indivisible", "dst_count", "op", "ranks",
                                 "dtype"])
def test_wrapper_rejects_bad_arguments(bad):
    n, c = 2, 4
    srcs = [torch.zeros(n * c) for _ in range(n)]
    dsts = [torch.zeros(c) for _ in range(n)]
    op = ReductionOp.SUM
    status = Status.ERR_INVALID_PARAM
    if bad == "indivisible":
        srcs = [torch.zeros(n * c + 1) for _ in range(n)]
    elif bad == "dst_count":
        dsts[1] = torch.zeros(c + 1)
    elif bad == "op":
        op, status = ReductionOp.BXOR, Status.ERR_NOT_SUPPORTED
    elif bad == "ranks":
        dsts = dsts[:1]
    else:
        srcs = [s.to(torch.uint16) for s in srcs]
        dsts = [d.to(torch.uint16) for d in dsts]
        status = Status.ERR_NOT_SUPPORTED
    with pytest.raises(UccError) as ei:
        krs.ring_reduce_scatter_pass(srcs, dsts, op)
    assert ei.value.status == status
    assert "reduce_scatter" in str(ei.value)


def test_nan_propagates_through_max_and_min():
    n, c = 4, 6
    arrs = make_inputs(n, n * c, "f32", "MAX", seed=1)    # arrs[1][3] is NaN
    srcs = [from_numpy(a, "cpu") for a in arrs]
    for op in (ReductionOp.MAX, ReductionOp.MIN):
        out = krs.ring_reduce_scatter_ref(srcs, op)
        assert np.isnan(out[0][3].item())                  # block 0, elem 3
        assert not torch.isnan(torch.cat(out[1:])).any()
