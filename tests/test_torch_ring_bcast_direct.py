"""A CPU model of the bcast kernel's walk (``csrc/bcast.cu``), and the
launch that both bcast wrappers make.

``walk`` repeats the kernel's index arithmetic as the source has it: the
path decided from the n + 1 pointers a bcast touches (the root's src and
the n dsts, never a non-root src: ``stage_bcast_table``), the head before
the root's first 16-byte boundary, the whole vectors after it and the
ragged tail, the vectors walked grid-stride with BCAST_UNROLL of them per
thread and iteration (vectors v, v + stride, ...), and the head and tail
(or, off the vector path, every element) one element at a time,
grid-stride. ``run`` plays each thread in program order on real CPU
tensors (a group's loads, then its stores dst by dst; an element's load,
then its stores) and checks that every element of every dst but an
in-place root's is written exactly once, with the root's src value; that
the root's buffer is never written when it is its dst; that nothing but
the root's src is read, and nothing read is written; and that every
vector is 16-byte aligned at its src and dst addresses. The kernel itself
is held bitwise to the plain version on the card by chip_smoke.py.
"""
import contextlib
import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ucc_tpu_torch.kernels import ring_bcast_a2a as kba
from ucc_tpu_torch.kernels import ring_common as kc

#: csrc/bcast.cu's BCAST_UNROLL
UNROLL = 8


def decide(n, root, count, elem, addr):
    """(aligned, head, skip) of a launch, as stage_bcast_table has them:
    *addr* are the 2n buffers' addresses (n srcs, then n dsts), of which it
    reads the root's src and the dsts only."""
    src = addr[root]
    mis = src % 16
    odd = mis % elem != 0 or any(a % 16 != mis for a in addr[n:])
    head = min(count, ((16 - mis) % 16) // elem)
    skip = root if addr[n + root] == src else -1
    return not odd, head, skip


def walk(n, root, count, elem, addr, ctas, threads, part=None):
    """Each thread's steps in program order: ("vec", [lo, ...]) is one
    iteration's group of vectors (their first elements), loaded together
    and then stored dst by dst; ("elem", i) one element. *part* [lo, hi)
    of the elements: a launch of a team across processes
    (direct_fold.cuh: vector_part)."""
    w = 16 // elem
    aligned, head, _ = decide(n, root, count, elem, addr)
    p_lo, p_hi = (0, count) if part is None else part
    stride = ctas * threads
    out = []
    for tid in range(stride):
        steps = []
        if not aligned:
            steps += [("elem", i) for i in range(p_lo + tid, p_hi, stride)]
        else:
            v0 = head if p_lo <= head else \
                head + -(-(p_lo - head) // w) * w
            v0 = min(v0, p_hi)
            vecs = (p_hi - v0) // w
            tail = v0 + vecs * w
            for v in range(tid, vecs, UNROLL * stride):
                steps.append(("vec", [v0 + (v + k * stride) * w
                                      for k in range(UNROLL)
                                      if v + k * stride < vecs]))
            steps += [("elem", i) for i in range(p_lo + tid, v0, stride)]
            steps += [("elem", i) for i in range(tail + tid, p_hi, stride)]
        out.append(steps)
    return out


def raw(t):
    """An integer view of a tensor's elements: the kernel moves raw bits."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def run(srcs, dsts, root, ctas=2, threads=64, parts=1):
    """Play the kernel's walk on *srcs* and *dsts* (the same tensors in
    place), checking the walk's claims on the way; returns the number of
    vectors moved. *parts* P plays the P launches of a team across
    processes (kernels/ring_common.part_bounds), one after another."""
    n = len(srcs)
    count = srcs[0].numel()
    elem = srcs[0].element_size()
    w = 16 // elem
    addr = [t.data_ptr() for t in srcs] + [t.data_ptr() for t in dsts]
    _, _, skip = decide(n, root, count, elem, addr)
    # one array per distinct buffer: in place, src_r is dst_r
    buf_of, bufs = {}, []
    for t in list(srcs) + list(dsts):
        if t.data_ptr() not in buf_of:
            buf_of[t.data_ptr()] = len(bufs)
            bufs.append(raw(t).numpy())
    src = buf_of[addr[root]]
    dst = [buf_of[a] for a in addr[n:]]
    reads = [np.zeros(len(b), np.int64) for b in bufs]
    writes = [np.zeros(len(b), np.int64) for b in bufs]
    vectors = 0
    plays = [walk(n, root, count, elem, addr, ctas, threads,
                  kc.part_bounds(count, (p, parts), elem))
             for p in range(parts)]
    for steps in (st for play in plays for st in play):
        for kind, at in steps:
            los, width = (at, w) if kind == "vec" else ([at], 1)
            vals = []
            for lo in los:
                if kind == "vec":
                    assert (addr[root] + lo * elem) % 16 == 0
                assert not writes[src][lo:lo + width].any()
                reads[src][lo:lo + width] += 1
                vals.append(bufs[src][lo:lo + width].copy())
            for r in range(n):
                if r == skip:
                    continue
                for lo, v in zip(los, vals):
                    if kind == "vec":
                        assert (addr[n + r] + lo * elem) % 16 == 0
                    assert not reads[dst[r]][lo:lo + width].any()
                    writes[dst[r]][lo:lo + width] += 1
                    bufs[dst[r]][lo:lo + width] = v
            vectors += len(los) if kind == "vec" else 0
    for r in range(n):
        want = 0 if r == skip else 1
        assert (writes[dst[r]] == want).all(), (r, writes[dst[r]])
    assert (reads[src] == 1).all()          # the root's src, once
    for b in range(len(bufs)):
        if b != src:
            assert not reads[b].any(), f"buffer {b} is not the root's src"
    return vectors


def seeded(n, count, dtype, seed):
    """n buffers of *count* elements from a seed, with a NaN and a -0.0 in
    the float ones."""
    rng = np.random.default_rng(seed)
    if dtype.is_floating_point:
        out = [torch.from_numpy(rng.standard_normal(count)).to(dtype)
               for _ in range(n)]
        for t in out:
            if count > 2:
                t[1] = float("nan")
                t[2] = -0.0
        return out
    return [torch.from_numpy(rng.integers(-128, 128, count)).to(dtype)
            for _ in range(n)]


def same_raw(a, b):
    return torch.equal(raw(a), raw(b))


#: dtype -> counts: one element, a head-less count below a vector, and
#: counts ragged against the vectors and the grid's stride
COUNTS = {torch.float32: (1, 3, 1001), torch.bfloat16: (7, 1029),
          torch.int8: (15, 2051)}


def roots(n):
    return sorted({0, n // 2, n - 1})


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("dtype", list(COUNTS))
@pytest.mark.parametrize("n,root", [(n, root) for n in (1, 2, 3, 8, 16, 257)
                                    for root in roots(n)])
def test_kernel_walk_copies_every_element_once(n, root, dtype, inplace):
    for count in COUNTS[dtype] if n < 257 else COUNTS[dtype][:1] + (97,):
        srcs = seeded(n, count, dtype, seed=n * count + root)
        data = srcs[root].clone()
        want = kba.ring_bcast_ref(srcs, root)
        if inplace:
            dsts = [s.clone() for s in srcs]
            run(dsts, dsts, root)
        else:
            dsts = [torch.full_like(s, 7) for s in srcs]
            run(srcs, dsts, root)
            assert same_raw(srcs[root], data)
        for d, ref in zip(dsts, want):
            assert same_raw(d, data) and same_raw(d, ref)


@pytest.mark.parametrize("parts", [2, 3, 4])
@pytest.mark.parametrize("dtype", list(COUNTS))
@pytest.mark.parametrize("n,root", [(2, 1), (3, 0), (8, 3)])
def test_kernel_walk_by_parts(n, root, dtype, parts):
    """The launches of a team across processes, part p of P each: every
    element copied once over all parts, bitwise the single launch, in
    place too; the parts cut at vectors, so as many vectors as one
    launch."""
    for count in COUNTS[dtype]:
        srcs = seeded(n, count, dtype, seed=n * count + root + 11)
        data = srcs[root].clone()
        for inplace in (False, True):
            got = []
            for p in (1, parts):
                dsts = [s.clone() for s in srcs] if inplace else \
                    [torch.full_like(s, 7) for s in srcs]
                vectors = run(dsts if inplace else srcs, dsts, root,
                              parts=p)
                got.append(vectors)
                for d in dsts:
                    assert same_raw(d, data)
            assert got[0] == got[1]


@pytest.mark.parametrize("dtype", list(COUNTS))
@pytest.mark.parametrize("layout", ["all", "mixed", "non_root_srcs"])
def test_kernel_walk_on_views_with_a_storage_offset(dtype, layout):
    """Views one element in: on every buffer (a scalar head, then
    vectors); on odd ranks' srcs and ranks 0 mod 3's dsts (the root's src
    and the dsts disagree mod 16: every element on the scalar path); or on
    the non-root srcs alone, which the kernel never reads and whose
    offsets decide nothing (vectors from the first element)."""
    n, count, root = 5, 203, 2
    bases = seeded(n, count + 1, dtype, seed=17)
    src_at = {"all": [1] * n, "mixed": [r % 2 for r in range(n)],
              "non_root_srcs": [int(r != root) for r in range(n)]}[layout]
    dst_at = {"all": [1] * n, "mixed": [int(r % 3 == 0) for r in range(n)],
              "non_root_srcs": [0] * n}[layout]
    srcs = [b[a:a + count] for b, a in zip(bases, src_at)]
    outs = [torch.full((count + 1,), 7, dtype=dtype) for _ in range(n)]
    dsts = [o[a:a + count] for o, a in zip(outs, dst_at)]
    vectors = run(srcs, dsts, root, ctas=3, threads=32)
    w = 16 // srcs[0].element_size()
    if layout == "mixed":
        assert vectors == 0
    else:
        head = 0 if layout == "non_root_srcs" else w - 1
        assert vectors == (count - head) // w
    for d in dsts:
        assert same_raw(d, srcs[root])
    for o, a in zip(outs, dst_at):
        rest = torch.cat([o[:a], o[a + count:]])
        assert torch.equal(rest, torch.full_like(rest, 7))


@pytest.mark.parametrize("n,count,ctas,threads", [(8, 20003, 1, 32),
                                                  (8, 2003, 4, 64),
                                                  (3, 5000, 2, 32),
                                                  (2, 4, 4, 64),
                                                  (16, 641, 1, 256)])
def test_kernel_walk_on_small_and_large_grids(n, count, ctas, threads):
    """Grids whose stride is far below the vectors (a thread takes several
    groups of UNROLL), near them (a partial group) and above them (threads
    with nothing to do), in place and not."""
    srcs = seeded(n, count, torch.float32, seed=count)
    root = n - 1
    for inplace in (False, True):
        dsts = [s.clone() for s in srcs] if inplace else \
            [torch.empty_like(s) for s in srcs]
        run(dsts if inplace else srcs, dsts, root, ctas=ctas,
            threads=threads)
        for d in dsts:
            assert same_raw(d, srcs[root])


def test_plan_is_the_count():
    assert kba.bcast_plan(1000, 8) == (1000, 1000, 1, 1000, 0, 0)
    assert kba.bcast_plan(7, 1) == (7, 7, 1, 7, 0, 0)


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper goes past
    its plain version to the launch, whose CUDA calls the test replaces."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("root", [0, 3])
@pytest.mark.parametrize("wrapper,kernel", [
    (kba.ring_bcast_pass, kba.K_BCAST_PASS),
    (kba.ring_bcast_chunked, kba.K_BCAST_CHUNKED)])
def test_wrappers_launch_the_one_kernel(wrapper, kernel, root, monkeypatch):
    """Both bcast wrappers reach the C launch of csrc/bcast.cu with op 0,
    no comm, flag or error word, the root, the count and the grid of
    ``launch_ctas(count)``; the workspace is not touched, and the launch
    is counted once."""
    calls = []

    def max_ctas(kernel, code, threads, out):
        ctypes.cast(out, ctypes.POINTER(ctypes.c_int))[0] = 264
        return 0

    lib = SimpleNamespace(ucc_bcast=lambda *a: calls.append(a) or 0,
                          ucc_bcast_max_ctas=max_ctas)
    monkeypatch.setattr(kba._SOURCE, "_lib", lib)
    monkeypatch.setattr(kba._SOURCE, "_max_ctas", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    done = kc.RingLaunch()                    # finished, nothing to wait on
    monkeypatch.setattr(kc, "RingLaunch", lambda *a, **k: done)
    n, count = 4, 100000
    bufs = [torch.zeros(count).as_subclass(_ReportsCuda) for _ in range(n)]
    table = torch.zeros(2 * n, dtype=torch.int64)
    ws = kc.RingWorkspace(torch.device("cpu"))
    before = (kba.ring_bcast_pass.launches, kba.ring_bcast_chunked.launches)
    wrapper(bufs, bufs, root=root, ptr_table=table, workspace=ws).wait()
    after = (kba.ring_bcast_pass.launches, kba.ring_bcast_chunked.launches)
    assert [a - b for a, b in zip(after, before)] == \
        [int(kernel == kba.K_BCAST_PASS), int(kernel == kba.K_BCAST_CHUNKED)]
    assert ws.err is None                     # the workspace was not asked
    (k, code, ptrs, comm, flags, err, a, b, n_chunks, n_, op, root_, ctas,
     threads, lo, hi, stream), = calls
    assert (k, code, ptrs) == (kernel, kc.DTYPE_CODES[torch.float32],
                               table.data_ptr())
    assert (comm, flags, err, op, root_) == (None, None, None, 0, root)
    assert (a, n_, threads) == (count, n, kc.DIRECT_THREADS)
    assert ctas == kc.launch_ctas(count, 4, 264)
    # a team in one process launches the whole walk
    assert (lo, hi) == (0, count)
