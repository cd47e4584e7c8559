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


# ---------------------------------------------------------------------------
# a model of the kernel's walk (csrc/alltoall.cu)
# ---------------------------------------------------------------------------
#
# ``walk`` repeats the kernel's index arithmetic as the source has it: the
# units in ``alltoall_units``' order (the diagonals skipped when every rank
# is in place), each cut into S = 1 + ceil(blk / W) slots (slot 0 the head
# before the unit's first 16-byte boundary, slot j >= 1 the j-th vector
# after it) in tiles of 32 * depth slots (depth UNROLL, or less when the
# launch has fewer slots than 32 * UNROLL per warp), the alignment decided
# per unit
# from its four (diagonal: two) addresses, the (unit, tile) items walked
# warp-stride and advanced without a division, lane l of a warp taking
# slots l, l + 32, ... of its tile. ``run`` plays each thread in program
# order (the loads of its vector slots of a tile, their stores, then its
# other slots element by element, reads before writes) on real buffers,
# and checks that every dst element is written exactly once, by the thread
# of its pair's owner; that every location a thread writes is read by no
# other thread and, where that thread reads it, before the write; that the
# vectors and single elements of each unit cover its block exactly once;
# and that every vector is 16-byte aligned at all its addresses.

#: csrc/alltoall.cu's A2A_UNROLL and WARP
UNROLL = 8
WARP = 32


def unit_ranks(u, n):
    """The kernel's decode of unit u (unit_ranks in the source)."""
    m = (n - 1) // 2
    if u < n:
        return u, u
    k = u - n
    if k < n * m:
        r = k // m
        q = r + (k - r * m) + 1
        return r, q - n if q >= n else q
    r = k - n * m
    return r, r + n // 2


def locate(n, blk, elem, addr, u):
    """(r, q, head, aligned, live) of unit u, as the kernel's locate()."""
    r, q = unit_ranks(u, n)
    pair = r != q
    a, c = addr[r] + q * blk * elem, addr[n + q] + r * blk * elem
    b, d = addr[q] + r * blk * elem, addr[n + r] + q * blk * elem
    diff = a ^ c
    if pair:
        diff |= (a ^ b) | (a ^ d)
    mis = a % 16
    aligned = diff % 16 == 0 and mis % elem == 0
    head = min(blk, ((16 - mis) % 16) // elem) if aligned else 0
    return r, q, head, aligned, pair or a != c


def walk(n, blk, elem, addr, ctas, threads):
    """Each thread's groups of UNROLL slots, as (r, q, lo, len, vec), in
    the order the kernel takes them; *addr* are the 2n buffers' addresses
    (n srcs, then n dsts)."""
    assert threads % WARP == 0
    w = 16 // elem
    first = 0 if any(addr[i] != addr[n + i] for i in range(n)) else n
    units = n * (n + 1) // 2 - first
    slots = 1 + -(-blk // w)
    warps = ctas * threads // WARP
    depth = max(1, min(UNROLL, units * slots // (WARP * warps)))
    tiles = -(-slots // (WARP * depth))
    step_u, step_t = divmod(warps, tiles)
    out = []
    for tid in range(ctas * threads):
        lane = tid % WARP
        u, tile = divmod(tid // WARP, tiles)
        groups = []
        while u < units:
            r, q, head, aligned, live = locate(n, blk, elem, addr, first + u)
            if live:
                group = []
                for k in range(UNROLL):
                    j = tile * WARP * depth + k * WARP + lane
                    lo = 0 if j == 0 else head + (j - 1) * w
                    hi = head if j == 0 else min(blk, head + j * w)
                    length = max(0, hi - lo) if k < depth else 0
                    group.append((r, q, lo, length,
                                  aligned and j > 0 and length == w))
                groups.append(group)
            u += step_u
            tile += step_t
            if tile >= tiles:
                tile -= tiles
                u += 1
        out.append(groups)
    return out


def raw(t):
    """An integer view of a tensor's elements: moves keep every bit."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def run(srcs, dsts, ctas=2, threads=64):
    """Play the kernel's walk on *srcs* and *dsts* (the same tensors in
    place), checking the walk's claims on the way; returns the number of
    vector slots."""
    n = len(srcs)
    blk = srcs[0].numel() // n
    elem = srcs[0].element_size()
    addr = [t.data_ptr() for t in srcs] + [t.data_ptr() for t in dsts]
    # one location per (buffer, element): in place, src_r is dst_r
    buf_of, bufs = {}, []
    for t in list(srcs) + list(dsts):
        if t.data_ptr() not in buf_of:
            buf_of[t.data_ptr()] = len(bufs)
            bufs.append(raw(t).numpy())
    src_buf = [buf_of[t.data_ptr()] for t in srcs]
    dst_buf = [buf_of[t.data_ptr()] for t in dsts]
    reads, writes = {}, {}          # location -> (thread, time)
    covered = {}                    # (r, q) -> moves of each element
    clock = 0
    vectors = 0

    def sides(it, e0, e1):
        """(read location, write location) of elements e0..e1-1 of a slot:
        a -> c and, for a pair, b -> d."""
        r, q, lo, _, _ = it
        out = [((src_buf[r], q * blk + lo + e), (dst_buf[q], r * blk + lo + e))
               for e in range(e0, e1)]
        if r != q:
            out += [((src_buf[q], r * blk + lo + e),
                     (dst_buf[r], q * blk + lo + e)) for e in range(e0, e1)]
        return out

    def load(tid, moves):
        nonlocal clock
        vals = []
        for src, _ in moves:
            assert src not in writes or writes[src][0] == tid
            reads.setdefault(src, (tid, clock))
            clock += 1
            vals.append(bufs[src[0]][src[1]].copy())
        return vals

    def store(tid, moves, vals):
        nonlocal clock
        for (_, dst), v in zip(moves, vals):
            assert dst not in writes, f"{dst} written twice"
            assert dst not in reads or reads[dst][0] == tid, \
                f"{dst} read by thread {reads[dst][0]}, written by {tid}"
            writes[dst] = (tid, clock)
            clock += 1
            bufs[dst[0]][dst[1]] = v

    for tid, groups in enumerate(walk(n, blk, elem, addr, ctas, threads)):
        for group in groups:
            live = [it for it in group if it[3]]
            for r, q, lo, length, vec in live:
                assert r == q or kba.owns_pair(r, q, n)
                hits = covered.setdefault((r, q), [0] * blk)
                for e in range(lo, lo + length):
                    hits[e] += 1
                if vec:
                    bases = [addr[r] + q * blk * elem,
                             addr[n + q] + r * blk * elem]
                    if r != q:
                        bases += [addr[q] + r * blk * elem,
                                  addr[n + r] + q * blk * elem]
                    assert all((b + lo * elem) % 16 == 0 for b in bases)
            vec = [it for it in live if it[4]]
            vectors += len(vec)
            moves = [sides(it, 0, it[3]) for it in vec]
            loaded = [load(tid, mv) for mv in moves]
            for mv, vals in zip(moves, loaded):
                store(tid, mv, vals)
            for it in live:
                if not it[4]:
                    for e in range(it[3]):
                        mv = sides(it, e, e + 1)
                        store(tid, mv, load(tid, mv))
    for r, q in kba.alltoall_units(n):
        if r == q and addr[r] == addr[n + r]:
            assert (r, q) not in covered        # in place: nothing to move
        else:
            assert covered.get((r, q)) == [1] * blk, (r, q)
    # every dst element written once, except diagonals already in place
    skipped = sum(blk for r in range(n) if addr[r] == addr[n + r])
    assert len(writes) == n * n * blk - skipped
    for loc, (tid, t) in writes.items():
        if loc in reads:
            assert reads[loc][0] == tid and reads[loc][1] < t
    return vectors


#: dtype -> (a block whose bytes are a multiple of 16, one whose are not)
BLOCKS = {torch.float32: (8, 37), torch.bfloat16: (24, 13),
          torch.int8: (32, 37), torch.float64: (6, 5)}


def seeded(n, count, dtype, seed):
    """n buffers of *count* elements from a seed, with a NaN and a -0.0 in
    the float ones."""
    rng = np.random.default_rng(seed)
    if dtype.is_floating_point:
        out = [torch.from_numpy(rng.standard_normal(count)).to(dtype)
               for _ in range(n)]
        if count > 2:
            out[0][1] = float("nan")
            out[-1][2] = -0.0
        return out
    return [torch.from_numpy(rng.integers(-128, 128, count)).to(dtype)
            for _ in range(n)]


def same_raw(a, b):
    return torch.equal(raw(a), raw(b))


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("dtype", list(BLOCKS))
@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8, 16])
def test_kernel_walk_moves_every_element_once(n, dtype, inplace):
    for blk in BLOCKS[dtype]:
        srcs = seeded(n, n * blk, dtype, seed=n * blk)
        want = expected([s.numpy() if dtype != torch.bfloat16 else
                         raw(s).numpy() for s in srcs])
        dsts = [s.clone() for s in srcs] if inplace else \
            [torch.full_like(s, 7) for s in srcs]
        run(dsts if inplace else srcs, dsts, ctas=2, threads=64)
        for d, w in zip(dsts, want):
            got = raw(d).numpy() if dtype == torch.bfloat16 else d.numpy()
            assert got.tobytes() == w.tobytes()
        for d, ref in zip(dsts, kba.ring_alltoall_ref(srcs)):
            assert same_raw(d, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("mixed", [False, True])
def test_kernel_walk_on_views_with_a_storage_offset(dtype, mixed):
    """Views one element in on every buffer (each unit a scalar head, then
    vectors) or on odd ranks' srcs and ranks 0 mod 3's dsts (units whose
    addresses disagree mod 16 go element by element, the others take
    vectors): both paths in one launch, every element once."""
    n, blk = 5, 40
    bases = seeded(n, n * blk + 1, dtype, seed=17)
    src_at = [r % 2 if mixed else 1 for r in range(n)]
    dst_at = [int(r % 3 == 0) if mixed else 1 for r in range(n)]
    srcs = [b[a:a + n * blk] for b, a in zip(bases, src_at)]
    outs = [torch.full((n * blk + 1,), 7, dtype=dtype) for _ in range(n)]
    dsts = [o[a:a + n * blk] for o, a in zip(outs, dst_at)]
    vectors = run(srcs, dsts, ctas=3, threads=32)
    assert vectors > 0
    for d, ref in zip(dsts, kba.ring_alltoall_ref(srcs)):
        assert same_raw(d, ref)
    for o, a in zip(outs, dst_at):
        rest = torch.cat([o[:a], o[a + n * blk:]])
        assert torch.equal(rest, torch.full_like(rest, 7))


@pytest.mark.parametrize("n,blk,ctas,threads", [(8, 2003, 2, 64),
                                                (2, 5000, 1, 32),
                                                (3, 1000, 1, 32),
                                                (5, 1601, 3, 32),
                                                (16, 4, 4, 64)])
def test_kernel_walk_at_other_strides(n, blk, ctas, threads):
    """Warp strides below one unit's tiles (a warp stays in a unit for
    several steps), equal to them, and above them (it skips units), in
    place and not."""
    srcs = seeded(n, n * blk, torch.float32, seed=blk)
    for inplace in (False, True):
        dsts = [s.clone() for s in srcs] if inplace else \
            [torch.empty_like(s) for s in srcs]
        run(dsts if inplace else srcs, dsts, ctas=ctas, threads=threads)
        for d, ref in zip(dsts, kba.ring_alltoall_ref(srcs)):
            assert same_raw(d, ref)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 16, 257])
def test_units_are_the_owned_pairs_in_the_kernel_order(n):
    units = kba.alltoall_units(n)
    assert len(units) == n * (n + 1) // 2
    assert [unit_ranks(u, n) for u in range(len(units))] == units
    assert units[:n] == [(r, r) for r in range(n)]
    pairs = units[n:]
    assert all(kba.owns_pair(r, q, n) for r, q in pairs)
    assert sorted(tuple(sorted(p)) for p in pairs) == \
        [(r, q) for r in range(n) for q in range(r + 1, n)]


@pytest.mark.parametrize("cblk", [None, 3, 7])
def test_plain_version_walks_units(cblk):
    """The plain version is ``expected``'s concatenation, bit for bit,
    NaN and -0.0 included, whatever the chunk it walks a block in."""
    n, blk = 6, 11
    srcs = seeded(n, n * blk, torch.float32, seed=3)
    want = expected([s.numpy() for s in srcs])
    for out, w in zip(kba.ring_alltoall_ref(srcs, cblk=cblk), want):
        assert out.numpy().tobytes() == w.tobytes()


def test_plan_sizes_the_grid_by_the_units():
    assert kba.alltoall_plan(8 * 100, 8) == (100, 100, 1, 36 * 100, 0, 0)
    assert kba.alltoall_plan(7, 1) == (7, 7, 1, 7, 0, 0)
    with pytest.raises(UccError) as ei:
        kba.alltoall_plan(kba.A2A_MAX_RANKS + 1, kba.A2A_MAX_RANKS + 1)
    assert ei.value.status == Status.ERR_NOT_SUPPORTED


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper goes past
    its plain version to the launch, whose CUDA calls the test replaces."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("wrapper,kernel", [
    (kba.ring_alltoall_pass, kba.K_A2A_PASS),
    (kba.ring_alltoall_chunked, kba.K_A2A_CHUNKED)])
def test_wrappers_launch_without_an_op(wrapper, kernel, monkeypatch):
    """Both alltoall wrappers, called without an op (the collective takes
    none), reach the C launch of csrc/alltoall.cu with op 0, no comm, flag
    or error word, the block and the grid of the plan; the workspace is
    not touched, and the launch is counted once."""
    import contextlib
    import ctypes
    from types import SimpleNamespace
    from ucc_tpu_torch.kernels import ring_common as kc
    calls = []

    def max_ctas(kernel, code, threads, out):
        ctypes.cast(out, ctypes.POINTER(ctypes.c_int))[0] = 264
        return 0

    lib = SimpleNamespace(ucc_alltoall=lambda *a: calls.append(a) or 0,
                          ucc_alltoall_max_ctas=max_ctas)
    monkeypatch.setattr(kba._A2A_SOURCE, "_lib", lib)
    monkeypatch.setattr(kba._A2A_SOURCE, "_max_ctas", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    done = kc.RingLaunch()                    # finished, nothing to wait on
    monkeypatch.setattr(kc, "RingLaunch", lambda *a, **k: done)
    n, blk = 4, 1000
    srcs = [torch.zeros(n * blk).as_subclass(_ReportsCuda) for _ in range(n)]
    dsts = [torch.zeros(n * blk).as_subclass(_ReportsCuda) for _ in range(n)]
    table = torch.zeros(2 * n, dtype=torch.int64)
    ws = kc.RingWorkspace(torch.device("cpu"))
    before = wrapper.launches
    wrapper(srcs, dsts, ptr_table=table, workspace=ws).wait()
    assert wrapper.launches == before + 1
    assert ws.err is None                     # the workspace was not asked
    (k, code, ptrs, comm, flags, err, a, b, n_chunks, n_, op, root, ctas,
     threads, stream), = calls
    assert (k, code, ptrs) == (kernel, kc.DTYPE_CODES[torch.float32],
                               table.data_ptr())
    assert (comm, flags, err, op, root) == (None, None, None, 0, 0)
    assert (a, n_, threads) == (blk, n, kc.DIRECT_THREADS)
    assert ctas == kc.launch_ctas(n * (n + 1) // 2 * blk, 4, 264)
