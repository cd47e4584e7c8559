"""A CPU model of the allgather kernel's walk (``csrc/allgather.cu``), and
the launch that both allgather wrappers make.

``decide`` and ``walk`` repeat the kernel's index arithmetic as the source
has it: once per CTA, whether the n dsts share one offset mod 16; per unit
b (src_b into block b of every dst), the vector path iff the dsts do,
src_b lies at block b of dst_0's offset mod 16 and at a multiple of the
element width, the head before src_b's first 16-byte boundary, and the
skip of rank b's own block when it is src_b (in place); the slots (the
head, then W-element vectors, the last ragged), the tiles of 32 x depth
slots, and the warps walking (unit, tile) items warp-stride, lane l
taking slots l, l + 32, ... of a tile. ``run`` plays each thread in
program order on real CPU tensors (a tile's vector loads, then their
stores dst by dst; the head's and the ragged last slot's elements, or
every element of a unit off the vector path, each load before its
stores) and checks that
every element of every dst but an in-place own block is written exactly
once, with src_b's value; that an in-place own block is never written;
that nothing but the srcs is read, each src element once, and nothing
read is written; and that every vector is 16-byte aligned at its src and
dst addresses. The kernel itself is held bitwise to the plain version and
to ``torch.cat`` on the card by chip_smoke.py.
"""
import contextlib
import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ucc_tpu_torch.kernels import ring_common as kc
from ucc_tpu_torch.kernels import ring_rs_ag as krs

#: csrc/allgather.cu's AG_UNROLL and its warp width
UNROLL = 8
WARP = 32


def decide(n, count, elem, addr):
    """Per unit b, (aligned, head, skip) as allgather.cu's ``locate`` has
    them: *addr* are the 2n buffers' addresses (n srcs, then n dsts)."""
    mis = addr[n] % 16
    dsts_even = all(a % 16 == mis for a in addr[n:])
    units = []
    for b in range(n):
        s = addr[b]
        skip = b if addr[n + b] + b * count * elem == s else -1
        aligned = dsts_even and (s - addr[n] - b * count * elem) % 16 == 0 \
            and (s % 16) % elem == 0
        head = min(count, ((16 - s % 16) % 16) // elem) if aligned else 0
        units.append((aligned, head, skip))
    return units


def walk(n, count, elem, addr, ctas, threads):
    """Each thread's steps in program order: ("vec", b, [lo, ...]) is one
    tile's vectors of unit b (their first elements), loaded together and
    then stored dst by dst; ("elem", b, i) one element of unit b."""
    w = 16 // elem
    units = decide(n, count, elem, addr)
    slots = 1 + -(-count // w)
    warps = ctas * (threads // WARP)
    depth = max(1, min(UNROLL, n * slots // (WARP * warps)))
    tile_slots = WARP * depth
    tiles = -(-slots // tile_slots)
    step_u, step_t = divmod(warps, tiles)
    out = []
    for tid in range(ctas * threads):
        warp, lane = divmod(tid, WARP)
        u, tile = divmod(warp, tiles)
        steps = []
        while u < n:
            aligned, head, skip = units[u]
            if n > 1 or skip < 0:
                vecs, elems = [], []
                for k in range(UNROLL):
                    j = tile * tile_slots + k * WARP + lane
                    lo = 0 if j == 0 else head + (j - 1) * w
                    hi = head if j == 0 else min(count, head + j * w)
                    length = hi - lo if k < depth and hi > lo else 0
                    if aligned and j > 0 and length == w:
                        vecs.append(lo)
                    elif length:
                        elems += range(lo, lo + length)
                if vecs:
                    steps.append(("vec", u, vecs))
                steps += [("elem", u, i) for i in elems]
            tile += step_t
            if tile >= tiles:
                tile -= tiles
                u += 1
            u += step_u
        out.append(steps)
    return out


def raw(t):
    """An integer view of a tensor's elements: the kernel moves raw bits."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def run(srcs, dsts, ctas=2, threads=64):
    """Play the kernel's walk on *srcs* and *dsts* (in place, src_b a view
    of dst_b's block b), checking the walk's claims on the way; returns
    the vectors each unit moved."""
    n = len(srcs)
    count = srcs[0].numel()
    elem = srcs[0].element_size()
    w = 16 // elem
    addr = [t.data_ptr() for t in srcs] + [t.data_ptr() for t in dsts]
    units = decide(n, count, elem, addr)
    # one array per distinct storage; a buffer is (storage, first element)
    store_of, arrays, loc = {}, [], []
    for t in list(srcs) + list(dsts):
        key = t.untyped_storage().data_ptr()
        if key not in store_of:
            store_of[key] = len(arrays)
            whole = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
            arrays.append(raw(whole).numpy())
        loc.append((store_of[key], t.storage_offset()))
    reads = [np.zeros(len(a), np.int64) for a in arrays]
    writes = [np.zeros(len(a), np.int64) for a in arrays]
    vectors = [0] * n
    for steps in walk(n, count, elem, addr, ctas, threads):
        for kind, b, at in steps:
            los = at if kind == "vec" else [at]
            width = w if kind == "vec" else 1
            idx = (np.asarray(los)[:, None] + np.arange(width)).ravel()
            if kind == "vec":
                assert all((addr[b] + lo * elem) % 16 == 0 for lo in los)
                vectors[b] += len(los)
            s, first = loc[b]
            assert not writes[s][first + idx].any()
            reads[s][first + idx] += 1
            vals = arrays[s][first + idx].copy()
            skip = units[b][2]
            for r in range(n):
                if r == skip:
                    continue
                d, base = loc[n + r]
                at_r = base + b * count + idx
                if kind == "vec":
                    assert all((addr[n + r] + (b * count + lo) * elem) % 16
                               == 0 for lo in los)
                assert not reads[d][at_r].any()
                writes[d][at_r] += 1
                arrays[d][at_r] = vals
    for b in range(n):
        s, first = loc[b]
        live = n > 1 or units[b][2] < 0
        assert (reads[s][first:first + count] == int(live)).all(), b
    for r in range(n):
        d, base = loc[n + r]
        for b in range(n):
            want = 0 if units[b][2] == r else 1
            got = writes[d][base + b * count:base + (b + 1) * count]
            assert (got == want).all(), (r, b, got)
    for s in range(len(arrays)):
        assert not ((reads[s] > 0) & (writes[s] > 0)).any()
        in_src = np.zeros(len(arrays[s]), bool)
        for b in range(n):
            if loc[b][0] == s:
                in_src[loc[b][1]:loc[b][1] + count] = True
        assert not reads[s][~in_src].any(), f"storage {s} read outside a src"
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


def gather(srcs, inplace, ranks=None, ctas=2, threads=64):
    """Run the walk on fresh dsts: not in place, or in place on *ranks*
    (default all), whose srcs become block r of their dst. Returns the
    dsts and the vectors each unit moved."""
    n = len(srcs)
    count = srcs[0].numel()
    dsts = [torch.full((n * count,), 7, dtype=srcs[0].dtype)
            for _ in range(n)]
    ins = list(srcs)
    if inplace:
        for r in range(n) if ranks is None else ranks:
            dsts[r][r * count:(r + 1) * count] = srcs[r]
            ins[r] = dsts[r][r * count:(r + 1) * count]
    vectors = run(ins, dsts, ctas, threads)
    return dsts, vectors


#: dtype -> counts: one element, a count below a vector, counts whose
#: bytes are a multiple of 16 (every unit on the vector path) and counts
#: whose bytes are not (units on both paths once n > 1)
COUNTS = {torch.float32: (1, 3, 64, 1001), torch.bfloat16: (7, 96, 1029),
          torch.int8: (15, 160, 2051)}


@pytest.mark.parametrize("inplace", ["no", "all", "some"])
@pytest.mark.parametrize("dtype", list(COUNTS))
@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8])
def test_kernel_walk_copies_every_element_once(n, dtype, inplace):
    for count in COUNTS[dtype]:
        srcs = seeded(n, count, dtype, seed=n * count)
        want = torch.cat(srcs)
        ranks = range(0, n, 2) if inplace == "some" else None
        dsts, vectors = gather(srcs, inplace != "no", ranks)
        for d, ref in zip(dsts, krs.ring_allgather_ref(srcs)):
            assert same_raw(d, want) and same_raw(d, ref)
        elem = srcs[0].element_size()
        w = 16 // elem
        if n == 1 and inplace != "no":
            assert vectors == [0]          # one rank in place: nothing moves
        elif count * elem % 16 == 0:
            # every unit's block starts at a 16-byte boundary
            assert vectors == [count // w] * n
        elif inplace == "no" and n >= 4 and count >= 4 * w:
            # block b at b·count·B mod 16: some units vector, some scalar
            assert 0 in vectors and any(vectors)


@pytest.mark.parametrize("dtype", list(COUNTS))
@pytest.mark.parametrize("layout", ["all", "mixed", "some_srcs"])
def test_kernel_walk_on_views_with_a_storage_offset(dtype, layout):
    """Views one element in: on every buffer (a scalar head, then vectors
    in every unit, as the count's bytes are a multiple of 16); on odd
    ranks' srcs and ranks 0 mod 3's dsts (the dsts disagree mod 16: every
    element on the scalar path); or on odd ranks' srcs alone (their units
    scalar, the others vectors from the first element)."""
    n = 5
    count = 256 // torch.tensor([], dtype=dtype).element_size()
    bases = seeded(n, count + 1, dtype, seed=17)
    src_at = {"all": [1] * n, "mixed": [r % 2 for r in range(n)],
              "some_srcs": [r % 2 for r in range(n)]}[layout]
    dst_at = {"all": [1] * n, "mixed": [int(r % 3 == 0) for r in range(n)],
              "some_srcs": [0] * n}[layout]
    srcs = [b[a:a + count] for b, a in zip(bases, src_at)]
    outs = [torch.full((n * count + 1,), 7, dtype=dtype) for _ in range(n)]
    dsts = [o[a:a + n * count] for o, a in zip(outs, dst_at)]
    vectors = run(srcs, dsts, ctas=3, threads=32)
    w = 16 // srcs[0].element_size()
    if layout == "all":
        assert vectors == [(count - (w - 1)) // w] * n
    elif layout == "mixed":
        assert vectors == [0] * n
    else:
        assert vectors == [0 if r % 2 else count // w for r in range(n)]
    want = torch.cat(srcs)
    for d in dsts:
        assert same_raw(d, want)
    for o, a in zip(outs, dst_at):
        rest = torch.cat([o[:a], o[a + n * count:]])
        assert torch.equal(rest, torch.full_like(rest, 7))


@pytest.mark.parametrize("n,count,ctas,threads", [(8, 2003, 1, 32),
                                                  (8, 403, 4, 64),
                                                  (3, 5000, 2, 32),
                                                  (2, 4, 4, 64),
                                                  (16, 61, 1, 256),
                                                  (7, 1001, 8, 128)])
def test_kernel_walk_on_small_and_large_grids(n, count, ctas, threads):
    """Grids whose warps are far fewer than the tiles (a warp takes many
    items, a lane 8 slots), about as many, and more (a depth of 1 and
    warps with nothing to do), in place and not."""
    srcs = seeded(n, count, torch.float32, seed=count)
    want = torch.cat(srcs)
    for inplace in (False, True):
        dsts, _ = gather(srcs, inplace, ctas=ctas, threads=threads)
        for d in dsts:
            assert same_raw(d, want)


@pytest.mark.parametrize("ragged_last_tile", [False, True])
@pytest.mark.parametrize("dtype", list(COUNTS))
def test_tiles_of_many_slots(dtype, ragged_last_tile):
    """Units of several tiles of 32 x 8 slots: a lane loads its 8 vectors
    of an inner tile together, and fewer in a unit's first tile (slot 0,
    the head) and last; also when the ragged last slot is the last of a
    tile (511 slots after the head: two tiles of 256). In one walk, in
    place on some ranks and not on the others."""
    elem = torch.tensor([], dtype=dtype).element_size()
    w = 16 // elem
    n = 3
    count = 511 * w - w // 2 if ragged_last_tile else 5000 * w // 4 + 3
    srcs = seeded(n, count, dtype, seed=elem)
    dsts, _ = gather(srcs, True, ranks=[1], ctas=2, threads=32)
    want = torch.cat(srcs)
    for d in dsts:
        assert same_raw(d, want)
    addr = [s.data_ptr() for s in srcs] + [d.data_ptr() for d in dsts]
    groups = {len(at) for steps in walk(n, count, elem, addr, 2, 32)
              for kind, _, at in steps if kind == "vec"}
    assert UNROLL in groups and min(groups) < UNROLL


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("count", [1, 5, 16])
def test_kernel_walk_above_the_staged_ranks(count, inplace):
    """n = 257, above the ranks whose pointers a CTA stages in shared
    memory (csrc/direct_fold.cuh: SMEM_RANKS): the walk is the same."""
    srcs = seeded(257, count, torch.int8, seed=count)
    dsts, _ = gather(srcs, inplace, ctas=2, threads=32)
    want = torch.cat(srcs)
    for d in dsts:
        assert same_raw(d, want)


def test_plan_is_the_count_and_its_units():
    assert krs.allgather_plan(1000, 8) == (1000, 1000, 1, 8000, 0, 0)
    assert krs.allgather_plan(7, 1) == (7, 7, 1, 7, 0, 0)


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper goes past
    its plain version to the launch, whose CUDA calls the test replaces."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("wrapper,kernel", [
    (krs.ring_allgather_pass, krs.K_AG_PASS),
    (krs.ring_allgather_chunked, krs.K_AG_CHUNKED)])
def test_wrappers_launch_the_one_kernel(wrapper, kernel, monkeypatch):
    """Both allgather wrappers reach the C launch of csrc/allgather.cu with
    op 0, no comm, flag or error word, the count, n and the grid of
    ``launch_ctas(n·count)``; the workspace is not touched, and the launch
    is counted once."""
    calls = []

    def max_ctas(kernel, code, threads, out):
        ctypes.cast(out, ctypes.POINTER(ctypes.c_int))[0] = 264
        return 0

    lib = SimpleNamespace(ucc_allgather=lambda *a: calls.append(a) or 0,
                          ucc_allgather_max_ctas=max_ctas)
    monkeypatch.setattr(krs._SOURCE, "_lib", lib)
    monkeypatch.setattr(krs._SOURCE, "_max_ctas", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    done = kc.RingLaunch()                    # finished, nothing to wait on
    monkeypatch.setattr(kc, "RingLaunch", lambda *a, **k: done)
    n, count = 4, 100000
    srcs = [torch.zeros(count).as_subclass(_ReportsCuda) for _ in range(n)]
    dsts = [torch.zeros(n * count).as_subclass(_ReportsCuda)
            for _ in range(n)]
    table = torch.zeros(2 * n, dtype=torch.int64)
    ws = kc.RingWorkspace(torch.device("cpu"))
    before = (krs.ring_allgather_pass.launches,
              krs.ring_allgather_chunked.launches)
    wrapper(srcs, dsts, ptr_table=table, workspace=ws).wait()
    after = (krs.ring_allgather_pass.launches,
             krs.ring_allgather_chunked.launches)
    assert [a - b for a, b in zip(after, before)] == \
        [int(kernel == krs.K_AG_PASS), int(kernel == krs.K_AG_CHUNKED)]
    assert ws.err is None                     # the workspace was not asked
    (k, code, ptrs, comm, flags, err, a, b, n_chunks, n_, op, root, ctas,
     threads, stream), = calls
    assert (k, code, ptrs) == (kernel, kc.DTYPE_CODES[torch.float32],
                               table.data_ptr())
    assert (comm, flags, err, op, root) == (None, None, None, 0, 0)
    assert (a, n_, threads) == (count, n, kc.DIRECT_THREADS)
    assert ctas == kc.launch_ctas(n * count, 4, 264)
