"""The ring allgather kernels' plain versions against the JAX package's
Pallas kernels, bitwise, and their wrappers on CPU tensors.

``ucc_tpu_torch.kernels.ring_rs_ag`` holds two allgather kernels:
``ring_allgather_pass`` (for ``_ring_kernel`` in allgather mode) and
``ring_allgather_chunked`` (for ``_hbm_allgather_kernel``), each with a
plain PyTorch version that runs the same forwarding ring. The Pallas
kernels run here in interpret mode on the virtual CPU mesh, the chunked
one on 64-element chunks (``CHUNK_ELEMS`` monkeypatched) with a block of
150, which it pads per block and slices back, as tests/test_ring_dma.py
runs it. Both sides get the same numpy inputs, made from a seed, for
every n and dtype; allgather has no op.

An allgather only copies, so every rank's result must be bitwise the
concatenation of the inputs on both sides (NaN inputs included). The
CUDA kernels are held to these plain versions, bitwise, on the card by
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from torch_ring_cases import (AG_CHUNKED_BLOCK, AG_PASS_BLOCK,  # noqa: E402
                              COVER_DTYPES, NS, bitwise_equal,
                              jax_allgather,
                              make_inputs, torch_allgather)
from ucc_tpu_torch.constants import ReductionOp  # noqa: E402
from ucc_tpu_torch.kernels import ring_rs_ag as krs  # noqa: E402
from ucc_tpu_torch.status import Status, UccError  # noqa: E402


@pytest.mark.parametrize("kernel,block", [("pass", AG_PASS_BLOCK),
                                          ("chunked", AG_CHUNKED_BLOCK)])
@pytest.mark.parametrize("dt", COVER_DTYPES)
@pytest.mark.parametrize("n", NS)
def test_allgather_matches_pallas_kernel(kernel, block, n, dt, monkeypatch):
    # MAX puts a NaN into rank 1's block: it must arrive as it left
    arrs = make_inputs(n, block, dt, "MAX", seed=n * 10 + len(dt))
    want = jax_allgather(kernel, n, arrs, monkeypatch)
    got = torch_allgather(kernel, arrs)
    cat = np.concatenate(arrs)
    for r in range(n):
        assert bitwise_equal(got[r], want[r]), (r, got[r], want[r])
        assert bitwise_equal(got[r], cat)


# ---------------------------------------------------------------------------
# the wrappers on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wrapper", [krs.ring_allgather_pass,
                                     krs.ring_allgather_chunked])
@pytest.mark.parametrize("inplace", [False, True])
def test_wrapper_on_cpu_writes_dst_without_a_launch(wrapper, inplace):
    n, c = 4, 251
    g = torch.Generator().manual_seed(4)
    srcs = [torch.randn(c, generator=g) for _ in range(n)]
    before = wrapper.launches
    dsts = [torch.full((n * c,), 7.0) for _ in range(n)]
    if inplace:
        # the host ring's convention: rank r's block already sits in
        # dst[r·c:(r+1)·c], and that block is its src
        for r, d in enumerate(dsts):
            d[r * c:(r + 1) * c] = srcs[r]
        wrapper([d[r * c:(r + 1) * c] for r, d in enumerate(dsts)], dsts,
                ReductionOp.SUM).wait()
    else:
        wrapper(srcs, dsts).wait()
    for d in dsts:
        assert torch.equal(d, torch.cat(srcs))
    assert wrapper.launches == before       # the plain version launches nothing


@pytest.mark.parametrize("cblk", [1, 7, 64, 300])
def test_chunk_size_changes_nothing(cblk):
    n, c = 3, 100
    srcs = [torch.arange(c, dtype=torch.int64) * (r + 1) for r in range(n)]
    for out in krs.ring_allgather_ref(srcs, cblk=cblk):
        assert torch.equal(out, torch.cat(srcs))


def test_one_rank_and_empty_blocks():
    src = torch.arange(5, dtype=torch.float16)
    dst = torch.zeros(5, dtype=torch.float16)
    krs.ring_allgather_pass([src], [dst]).wait()
    assert torch.equal(dst, src)
    empty = [torch.zeros(0) for _ in range(4)]
    krs.ring_allgather_chunked(empty, empty).wait()


@pytest.mark.parametrize("bad", ["dst_count", "src_count", "ranks", "dtype"])
def test_wrapper_rejects_bad_arguments(bad):
    n, c = 2, 4
    srcs = [torch.zeros(c) for _ in range(n)]
    dsts = [torch.zeros(n * c) for _ in range(n)]
    status = Status.ERR_INVALID_PARAM
    if bad == "dst_count":
        dsts[1] = torch.zeros(n * c - 1)
    elif bad == "src_count":
        srcs[0] = torch.zeros(c + 1)
    elif bad == "ranks":
        dsts = dsts[:1]
    else:
        srcs = [s.to(torch.uint16) for s in srcs]
        dsts = [d.to(torch.uint16) for d in dsts]
        status = Status.ERR_NOT_SUPPORTED
    with pytest.raises(UccError) as ei:
        krs.ring_allgather_pass(srcs, dsts)
    assert ei.value.status == status
    assert "allgather" in str(ei.value)
