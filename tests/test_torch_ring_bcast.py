"""The ring bcast kernels' plain version against the JAX package's Pallas
kernels, bitwise, and their wrappers on CPU tensors.

``ucc_tpu_torch.kernels.ring_bcast_a2a`` holds two bcast kernels:
``ring_bcast_pass`` (for ``_bcast_kernel``) and ``ring_bcast_chunked``
(for ``_hbm_bcast_kernel``), with one plain PyTorch version that forwards
the root's sub-blocks around the ring. The Pallas kernels run here in
interpret mode on the virtual CPU mesh, the chunked one with 64-element
chunks (``CHUNK_ELEMS`` monkeypatched, sub-blocks of 32) at counts 500
(16 sub-blocks) and 96 (3 sub-blocks, an odd step count that the TPU
kernel pads to an even one), as tests/test_ring_dma.py runs it. Both
sides get the same numpy inputs, made from a seed; only the root's are
read.

A bcast only copies, so every rank's result must be bitwise the root's
input on both sides. The CUDA kernels are held to this plain version,
bitwise, on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from torch_ring_cases import (COVER_DTYPES, NS, bitwise_equal,  # noqa: E402
                              jax_bcast, make_inputs, torch_bcast)
from ucc_tpu_torch.kernels import ring_bcast_a2a as kba  # noqa: E402
from ucc_tpu_torch.status import Status, UccError  # noqa: E402


def covering_cases():
    """(kernel, count, n, root, dtype): every n runs both kernels at both
    counts, and the root (0, 1, n-1) and the dtype turn with them, so every
    n meets every root and dtype, and every kernel every dtype. Each case
    compiles its own Pallas program, about a second in interpret mode."""
    dts = list(COVER_DTYPES)
    runs = [("pass", 500), ("pass", 96), ("chunked", 500), ("chunked", 96)]
    cases = []
    for i, n in enumerate(NS):
        for j, (kernel, count) in enumerate(runs):
            root = [0, 1, n - 1][(i + j) % 3]
            cases.append((kernel, count, n, root, dts[(i + j + 1) % 3]))
    return cases


@pytest.mark.parametrize("kernel,count,n,root,dt", covering_cases())
def test_bcast_matches_pallas_kernel(kernel, count, n, root, dt,
                                     monkeypatch):
    arrs = make_inputs(n, count, dt, "SUM", seed=100 * n + count + root)
    want = jax_bcast(kernel, n, root, arrs, monkeypatch)
    got = torch_bcast(kernel, root, arrs)
    for r in range(n):
        assert bitwise_equal(got[r], want[r]), (r, got[r], want[r])
        assert bitwise_equal(got[r], arrs[root])


# ---------------------------------------------------------------------------
# the plain version and the wrappers on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blk", [1, 7, 32, 64, 1000])
def test_sub_block_size_changes_nothing(blk):
    n, count, root = 5, 250, 3
    srcs = [torch.arange(count, dtype=torch.int64) * (r + 1)
            for r in range(n)]
    for out in kba.ring_bcast_ref(srcs, root, blk=blk):
        assert torch.equal(out, srcs[root])


@pytest.mark.parametrize("wrapper", [kba.ring_bcast_pass,
                                     kba.ring_bcast_chunked])
@pytest.mark.parametrize("inplace", [False, True])
def test_wrapper_on_cpu_writes_dst_without_a_launch(wrapper, inplace):
    """In place each rank's src is its dst, as when UCC's bcast passes src
    alone; the root's buffer keeps its data."""
    n, c, root = 4, 251, 2
    g = torch.Generator().manual_seed(5)
    srcs = [torch.randn(c, generator=g) for _ in range(n)]
    data = srcs[root].clone()
    before = wrapper.launches
    dsts = srcs if inplace else [torch.full((c,), 7.0) for _ in range(n)]
    wrapper(srcs, dsts, root=root).wait()
    for d in dsts:
        assert torch.equal(d, data)
    assert wrapper.launches == before       # the plain version launches nothing


def test_one_rank_and_empty_buffers():
    src = torch.arange(5, dtype=torch.float16)
    dst = torch.zeros(5, dtype=torch.float16)
    kba.ring_bcast_pass([src], [dst]).wait()
    assert torch.equal(dst, src)
    empty = [torch.zeros(0) for _ in range(4)]
    kba.ring_bcast_chunked(empty, empty, root=3).wait()


@pytest.mark.parametrize("bad", ["root", "negative_root", "dst_count",
                                 "dtype"])
def test_wrapper_rejects_bad_arguments(bad):
    n, c = 3, 4
    srcs = [torch.zeros(c) for _ in range(n)]
    dsts = [torch.zeros(c) for _ in range(n)]
    root = 0
    status = Status.ERR_INVALID_PARAM
    if bad == "root":
        root = n
    elif bad == "negative_root":
        root = -1
    elif bad == "dst_count":
        dsts[2] = torch.zeros(c + 1)
    else:
        srcs = [s.to(torch.uint16) for s in srcs]
        dsts = [d.to(torch.uint16) for d in dsts]
        status = Status.ERR_NOT_SUPPORTED
    with pytest.raises(UccError) as ei:
        kba.ring_bcast_pass(srcs, dsts, root=root)
    assert ei.value.status == status
    assert "bcast" in str(ei.value)
