"""The pairwise alltoall kernels' plain version against the JAX package's
Pallas kernels, bitwise, and their wrappers on CPU tensors.

``ucc_tpu_torch.kernels.ring_bcast_a2a`` holds two alltoall kernels:
``ring_alltoall_pass`` (for ``_alltoall_kernel`` with its all-rank
barrier) and ``ring_alltoall_chunked`` (for ``_hbm_alltoall_kernel``),
with one plain PyTorch version that exchanges the blocks pair by pair and
chunk by chunk. The Pallas kernels run here in interpret mode on the
virtual CPU mesh, the chunked one with ``CHUNK_ELEMS = 64``
(monkeypatched), whose chunk of ``64 // (2(n-1))`` elements splits blocks
of 25 raggedly, so that it re-pads every block, as tests/test_ring_dma.py
runs it. Both sides get the same numpy inputs, made from a seed.

An alltoall only copies, so rank r's result must be bitwise the
concatenation of block r of every rank's input on both sides. The CUDA
kernels are held to this plain version, bitwise, on the card by
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from torch_ring_cases import (COVER_DTYPES, NS, bitwise_equal,  # noqa: E402
                              jax_alltoall, make_inputs, torch_alltoall)
from ucc_tpu_torch.kernels import ring_bcast_a2a as kba  # noqa: E402
from ucc_tpu_torch.status import Status, UccError  # noqa: E402


def covering_cases():
    """(kernel, block, n, dtype): every n runs both kernels at blocks of
    25 and 6, and the dtype turns with them, so every n and every kernel
    meets every dtype. Each case compiles its own Pallas program, about a
    second in interpret mode."""
    dts = list(COVER_DTYPES)
    runs = [("pass", 25), ("pass", 6), ("chunked", 25), ("chunked", 6)]
    return [(kernel, blk, n, dts[(i + j) % 3])
            for i, n in enumerate(NS)
            for j, (kernel, blk) in enumerate(runs)]


def expected(arrs):
    n = len(arrs)
    blk = arrs[0].size // n
    return [np.concatenate([a[r * blk:(r + 1) * blk] for a in arrs])
            for r in range(n)]


@pytest.mark.parametrize("kernel,blk,n,dt", covering_cases())
def test_alltoall_matches_pallas_kernel(kernel, blk, n, dt, monkeypatch):
    # MAX puts a NaN into rank 1's input: it must arrive as it left
    arrs = make_inputs(n, n * blk, dt, "MAX", seed=10 * n + blk)
    want = jax_alltoall(kernel, n, arrs, monkeypatch)
    got = torch_alltoall(kernel, n, arrs)
    for r, e in enumerate(expected(arrs)):
        assert bitwise_equal(got[r], want[r]), (r, got[r], want[r])
        assert bitwise_equal(got[r], e)


# ---------------------------------------------------------------------------
# the plain version and the wrappers on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4, 7])
@pytest.mark.parametrize("cblk", [1, 4, 25, 100])
def test_chunk_size_changes_nothing(n, cblk):
    blk = 25
    srcs = [torch.arange(n * blk, dtype=torch.int64) + 1000 * r
            for r in range(n)]
    want = expected([s.numpy() for s in srcs])
    for out, w in zip(kba.ring_alltoall_ref(srcs, cblk=cblk), want):
        assert np.array_equal(out.numpy(), w)


def test_every_pair_has_one_owner():
    for n in range(1, 10):
        for r in range(n):
            for p in range(n):
                if p != r:
                    assert kba.owns_pair(r, p, n) != kba.owns_pair(p, r, n)


@pytest.mark.parametrize("wrapper", [kba.ring_alltoall_pass,
                                     kba.ring_alltoall_chunked])
@pytest.mark.parametrize("inplace", [False, True])
def test_wrapper_on_cpu_writes_dst_without_a_launch(wrapper, inplace):
    n, blk = 4, 63
    g = torch.Generator().manual_seed(6)
    srcs = [torch.randn(n * blk, generator=g) for _ in range(n)]
    want = expected([s.numpy() for s in srcs])
    before = wrapper.launches
    if inplace:
        dsts = [s.clone() for s in srcs]
        wrapper(dsts, dsts).wait()
    else:
        dsts = [torch.full((n * blk,), 7.0) for _ in range(n)]
        wrapper(srcs, dsts).wait()
    for d, w in zip(dsts, want):
        assert np.array_equal(d.numpy(), w)
    assert wrapper.launches == before       # the plain version launches nothing


def test_one_rank_and_empty_blocks():
    src = torch.arange(5, dtype=torch.float16)
    dst = torch.zeros(5, dtype=torch.float16)
    kba.ring_alltoall_pass([src], [dst]).wait()
    assert torch.equal(dst, src)
    empty = [torch.zeros(0) for _ in range(4)]
    kba.ring_alltoall_chunked(empty, empty).wait()


@pytest.mark.parametrize("bad", ["indivisible", "dst_count", "ranks",
                                 "dtype"])
def test_wrapper_rejects_bad_arguments(bad):
    n, c = 2, 4
    srcs = [torch.zeros(c) for _ in range(n)]
    dsts = [torch.zeros(c) for _ in range(n)]
    status = Status.ERR_INVALID_PARAM
    if bad == "indivisible":
        srcs = [torch.zeros(c + 1) for _ in range(n)]
        dsts = [torch.zeros(c + 1) for _ in range(n)]
    elif bad == "dst_count":
        dsts[1] = torch.zeros(c + 2)
    elif bad == "ranks":
        dsts = dsts[:1]
    else:
        srcs = [s.to(torch.uint16) for s in srcs]
        dsts = [d.to(torch.uint16) for d in dsts]
        status = Status.ERR_NOT_SUPPORTED
    with pytest.raises(UccError) as ei:
        kba.ring_alltoall_pass(srcs, dsts)
    assert ei.value.status == status
    assert "alltoall" in str(ei.value)
