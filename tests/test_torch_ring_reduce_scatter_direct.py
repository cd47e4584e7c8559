"""The reduce_scatter kernel's element order, modelled in plain PyTorch and
held bitwise against the ring's plain version (``ring_reduce_scatter_ref``).

``csrc/reduce_scatter.cu`` runs no ring: grid row r folds element i of
block r from the n srcs, from rank r+1 round the ring to rank r, and
stores it into dst r. Its claim is that this gives the ring's bits,
because rank r's dst ends as acc(x_r, acc(x_{r-1}, ... acc(x_{r+2},
x_{r+1}))) whichever way the partial folds travel. ``walk`` below repeats
the kernel's index arithmetic as the source has it: per row, the
alignment decided from the n + 1 pointers of that block (the srcs' block
r and dst r) by their byte offsets mod 16; when they agree, single
elements up to the first 16-byte boundary, 16-byte vectors, and single
elements after the last whole vector; when they do not, single elements
throughout; each thread's units stepped grid-stride over the row's CTAs,
UNROLL vectors at a time, with no division. ``model`` folds each unit as
the kernel does, with the plain versions' own ``accumulate`` and
``divide``, and writes its dst before the next unit. The tests check that
every output element is visited exactly once, in its own block; that no
vector straddles two blocks and every vector is 16-byte aligned in all
n + 1 buffers; that in place no unit reads what another unit writes; and
that the result is bitwise the ring's (NaN positions compared as NaN),
over n in {1, 2, 3, 5, 7, 8}, the nine dtypes and five ops, ragged blocks
(chip_smoke.py's pass shape among them, divided down), misaligned views
and in place. The kernel itself is held to the same plain version on the
card by chip_smoke.py. Inputs come from numpy, seeded.
"""
import pytest
import torch

# the allreduce model's seeded inputs (NaNs of either sign on several ranks
# for MAX/MIN, wrapping integers) and its NaN-aware bitwise comparison
from test_torch_ring_allreduce_direct import make_inputs, same_bits
from ucc_tpu_torch.constants import ReductionOp
from ucc_tpu_torch.kernels import ring_common as kc
from ucc_tpu_torch.kernels import ring_rs_ag as krs
from ucc_tpu_torch.status import Status, UccError

DTYPES = list(kc.DTYPE_CODES)
OPS = list(krs.OPS)
NS = [1, 2, 3, 5, 7, 8]
#: the kernel's constants (csrc/direct_fold.cuh)
UNROLL = 2
GROUP = 4
#: chip_smoke.py's reduce_scatter pass block at n = 8, 43695 elements,
#: divided down to its residue mod 256 (every vector width divides 256),
#: plus 256
SMOKE_PASS_BLK = 43695 % 256 + 256


def walk(n, blk, elem, offsets, ctas, threads, part=None):
    """The kernel's units in the order one launch takes them, row by row:
    a list of (row r, first element of the block, elements) per fold.
    *offsets* are the 2n pointers' byte offsets mod 16 (n srcs, then n
    dsts); a row of *ctas* CTAs of *threads* threads walks its block.
    *part* [lo, hi) of the n·blk output elements (a launch of a team
    across processes) takes the rows it falls in, each clipped to it."""
    w = 16 // elem
    stride = ctas * threads
    units = []
    p_lo, p_hi = (0, n * blk) if part is None else part
    for r in range(p_lo // blk, (p_hi - 1) // blk + 1):
        mis = offsets[n + r] % 16
        aligned = mis % elem == 0 and all(
            (offsets[q] + r * blk * elem) % 16 == mis for q in range(n))
        head = min(blk, ((16 - mis) % 16) // elem)
        lo, hi = max(p_lo - r * blk, 0), min(p_hi - r * blk, blk)
        # (elements per unit, first element, units, units a thread takes
        # at once): the vector sweep, then single elements (sweep_elements)
        if aligned:
            v0 = head if lo <= head else head + -(-(lo - head) // w) * w
            v0 = min(v0, hi)
            vecs = (hi - v0) // w
            tail = v0 + vecs * w
            sweeps = [(w, v0, vecs, UNROLL), (1, lo, v0 - lo, 1),
                      (1, tail, hi - tail, 1)]
        else:
            sweeps = [(1, lo, hi - lo, 1)]
        for width, lo, n_units, unroll in sweeps:
            for first in range(min(stride, n_units)):
                for u in range(first, n_units, unroll * stride):
                    for k in range(unroll):
                        if u + k * stride < n_units:
                            units.append((r, lo + (u + k * stride) * width,
                                          width))
    return units


def model(srcs, dsts, op, ctas=2, threads=4, offsets=None, parts=1):
    """The kernel on CPU tensors: each unit of ``walk`` reads its elements
    of block r from the n srcs in ring order from rank r+1 (a vector in
    groups of GROUP loads, a single element rank by rank), divides for
    AVG and writes dst r before the next unit (so dst r may be block r of
    src r). *offsets* default to the tensors' own addresses mod 16.
    Asserts every element once, inside its block, every vector aligned in
    all n + 1 buffers, and no unit reading an address another one
    writes. *parts* P plays the P launches of a team across processes,
    one after another; returns the vector units."""
    n = len(srcs)
    blk = dsts[0].numel()
    elem = srcs[0].element_size()
    if offsets is None:
        offsets = [t.data_ptr() % 16 for t in (*srcs, *dsts)]
    acc = krs.accumulate(op)
    seen = torch.zeros((n, blk), dtype=torch.int64)
    reads, writes = {}, {}   # address -> units
    units = [u for p in range(parts)
             for b in [kc.part_bounds(n * blk, (p, parts), elem)]
             if b[0] < b[1]
             for u in walk(n, blk, elem, offsets, ctas, threads, b)]
    for unit in units:
        r, e, width = unit
        assert 0 <= e and e + width <= blk, unit      # inside block r
        if width > 1:
            assert all((offsets[q] + (r * blk + e) * elem) % 16 == 0
                       for q in range(n)), unit
            assert (offsets[n + r] + e * elem) % 16 == 0, unit
        seen[r, e:e + width] += 1
        for q in range(n):
            base = srcs[q].data_ptr() + (r * blk + e) * elem
            for a in range(base, base + width * elem, elem):
                reads.setdefault(a, set()).add(unit)
        base = dsts[r].data_ptr() + e * elem
        for a in range(base, base + width * elem, elem):
            writes.setdefault(a, set()).add(unit)
        group = GROUP if width > 1 else n
        start = (r + 1) % n
        for first in range(0, n, group):
            xs = [srcs[(start + i) % n][r * blk + e:r * blk + e + width]
                  .clone() for i in range(first, min(n, first + group))]
            v = xs[0] if first == 0 else acc(xs[0], v)
            for x in xs[1:]:
                v = acc(x, v)
        if op == ReductionOp.AVG:
            v = krs.divide(v, n)
        dsts[r][e:e + width] = v
    assert torch.equal(seen, torch.ones_like(seen))
    for a, who in writes.items():
        assert len(who) == 1 and reads.get(a, who) <= who, hex(a)
    return sum(1 for _, _, width in units if width > 1)


def check(srcs, op, inplace=False, **kw):
    n = len(srcs)
    blk = srcs[0].numel() // n
    want = krs.ring_reduce_scatter_ref(srcs, op)
    if inplace:
        srcs = [s.clone() for s in srcs]
        dsts = [s[r * blk:(r + 1) * blk] for r, s in enumerate(srcs)]
        before = [s.clone() for s in srcs]
    else:
        dsts = [torch.full((blk,), 7, dtype=srcs[0].dtype)
                for _ in range(n)]
    model(srcs, dsts, op, **kw)
    for r, (d, w) in enumerate(zip(dsts, want)):
        assert same_bits(d, w), (r, d, w)
    if inplace:     # the other blocks of each src stay as they were
        for r, (s, b) in enumerate(zip(srcs, before)):
            keep = torch.ones(s.numel(), dtype=torch.bool)
            keep[r * blk:(r + 1) * blk] = False
            assert same_bits(s[keep], b[keep]), r


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", NS)
def test_ragged_blocks_fold_in_ring_order(n, dtype, op):
    """Blocks of 13 + 2n elements (no multiple of any vector width), so
    the srcs' block r lies at offsets mod 16 that change with r: some rows
    take vectors after a scalar head, others run scalar; grids from one
    thread to more threads than units."""
    blk = 13 + 2 * n
    srcs = make_inputs(n, n * blk, dtype, op, seed=100 * n + OPS.index(op))
    ctas, threads = [(1, 1), (2, 4), (3, 32)][NS.index(n) % 3]
    check(srcs, op, ctas=ctas, threads=threads)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.float64], ids=str)
@pytest.mark.parametrize("n", [3, 8])
def test_chip_smoke_pass_shape_divided_down(n, dtype, op):
    """chip_smoke.py's pass shape keeps its alignment pattern: for f32 at
    n = 8 the srcs' block r sits 12·r bytes mod 16 from dst r, so rows
    0 and 4 take vectors and the others run scalar."""
    assert krs.reduce_scatter_pass_elems(8) // 8 // 3 + 5 == 43695
    blk = SMOKE_PASS_BLK
    srcs = make_inputs(n, n * blk, dtype, op, seed=150 * n + OPS.index(op))
    check(srcs, op, ctas=2, threads=8)


def test_chip_smoke_pass_shape_rows():
    """Which rows of the pass shape take vectors, f32 at n = 8."""
    n, blk, elem = 8, SMOKE_PASS_BLK, 4
    units = walk(n, blk, elem, [0] * (2 * n), 1, 32)
    vector_rows = sorted({r for r, _, width in units if width > 1})
    assert vector_rows == [0, 4]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("n", [2, 8])
def test_main_path_shapes_are_aligned(n, dtype):
    """The main path's blocks (2 Mi and 8 Ki f32, here divided down to
    multiples of 16 elements) run every row as vectors only."""
    blk = 16 * 5
    units = walk(n, blk, dtype.itemsize, [0] * (2 * n), 2, 8)
    assert {width for _, _, width in units} == {16 // dtype.itemsize}
    assert len(units) == n * blk * dtype.itemsize // 16


#: views with a storage offset, as (elements src q starts in, elements
#: dst r starts in) of rank q or r of n
VIEWS = {
    "all +1": (lambda q, n: 1, lambda r, n: 1),
    "some srcs +1": (lambda q, n: q % 2, lambda r, n: 0),
    "dsts +2": (lambda q, n: 0, lambda r, n: 2 * (r % 3 == 0)),
}


@pytest.mark.parametrize("blk", [64, 37])
@pytest.mark.parametrize("kind", list(VIEWS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=str)
@pytest.mark.parametrize("n", [2, 3, 8])
def test_misaligned_views(n, dtype, kind, blk):
    """Real views at an element offset: with 64-element blocks every row
    of "all +1" agrees (a scalar head, then vectors); pointers that differ
    mod 16 run the row scalar."""
    op = ReductionOp.SUM
    src_at, dst_at = VIEWS[kind]
    bases = make_inputs(n, n * blk + 2, dtype, op, seed=300 + n)
    srcs = [b[src_at(q, n):src_at(q, n) + n * blk]
            for q, b in enumerate(bases)]
    outs = [torch.full((blk + 2,), 7, dtype=dtype) for _ in range(n)]
    dsts = [o[dst_at(r, n):dst_at(r, n) + blk] for r, o in enumerate(outs)]
    want = krs.ring_reduce_scatter_ref(srcs, op)
    model(srcs, dsts, op)
    for r, (o, d, w) in enumerate(zip(outs, dsts, want)):
        assert same_bits(d, w), r
        a = dst_at(r, n)
        rest = torch.cat([o[:a], o[a + blk:]])
        assert torch.equal(rest, torch.full_like(rest, 7)), r


def test_misaligned_views_take_both_paths():
    """The "all +1" f32 views at 64-element blocks take a head of three
    single elements then vectors in every row; "some srcs +1" runs every
    row scalar."""
    n, blk, elem = 3, 64, 4
    units = walk(n, blk, elem, [4] * (2 * n), 1, 8)
    for r in range(n):
        mine = [(e, w) for q, e, w in units if q == r]
        assert sorted(e for e, w in mine if w == 1) == [0, 1, 2, 63]
        assert all(e % 4 == 3 for e, w in mine if w > 1)
    units = walk(n, blk, elem, [0, 4, 0] + [0] * n, 1, 8)
    assert {w for _, _, w in units} == {1}


@pytest.mark.parametrize("blk", [96, 53])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32], ids=str)
@pytest.mark.parametrize("n", [2, 5, 8])
def test_in_place(n, dtype, blk):
    """src r is the whole dst vector of rank r and dst r its block r: a
    unit reads all n values before it writes, no unit reads what another
    writes, and the other blocks stay as they were."""
    op = ReductionOp.AVG if dtype.is_floating_point else ReductionOp.SUM
    srcs = make_inputs(n, n * blk, dtype, op, seed=400 + n)
    check(srcs, op, inplace=True)


@pytest.mark.parametrize("parts", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32], ids=str)
@pytest.mark.parametrize("n", [2, 3, 8])
def test_walk_by_parts(n, dtype, parts):
    """The launches of a team across processes, part p of P each: every
    output element folded once, bitwise the plain version, in place too;
    where every block starts on a vector, as many vectors as one
    launch."""
    op = ReductionOp.MAX if dtype.is_floating_point else ReductionOp.SUM
    for blk in (1, 5, 40, 301):
        srcs = make_inputs(n, n * blk, dtype, op, seed=600 + n + blk)
        want = krs.ring_reduce_scatter_ref(srcs, op)
        dsts = [torch.full((blk,), 7, dtype=dtype) for _ in range(n)]
        v1 = model(srcs, dsts, op)
        for inplace in (False, True):
            ins = [s.clone() for s in srcs]
            out = [ins[r][r * blk:(r + 1) * blk] for r in range(n)] \
                if inplace else [torch.full((blk,), 7, dtype=dtype)
                                 for _ in range(n)]
            vp = model(ins, out, op, parts=parts)
            for d, w in zip(out, want):
                assert same_bits(d, w)
            if blk * srcs[0].element_size() % 16 == 0 and not inplace:
                assert vp == v1


def test_more_ranks_than_two_load_groups():
    """n above GROUP folds its ranks in several groups of loads."""
    n = 19
    srcs = make_inputs(n, n * 40, torch.bfloat16, ReductionOp.SUM, seed=19)
    check(srcs, ReductionOp.SUM)


@pytest.mark.parametrize("span,elem,cap,n,want", [
    (2 << 20, 4, 528, 8, 66),      # the chunked entry's main shape
    (8 << 10, 4, 528, 8, 8),       # the pass entry's: 2048 vectors a row
    (1001, 4, 528, 257, 1),        # more ranks than the card holds CTAs
    (1, 8, 528, 1, 1),
])
def test_ctas_per_row(span, elem, cap, n, want):
    """One row of CTAs per rank shares the card's cap; a row never has
    fewer than one CTA, so any n launches."""
    src = kc.DirectSource("reduce_scatter.cu", "ucc_reduce_scatter",
                          per_rank=True)
    assert src.row_ctas(span, elem, cap, n) == want
    whole = kc.DirectSource("ring_allreduce.cu", "ucc_ring_allreduce")
    assert whole.row_ctas(span, elem, cap, n) == kc.launch_ctas(span, elem,
                                                                cap)


def test_wrapper_on_cpu_runs_the_plain_version_for_any_n():
    """Nothing caps n, in place is the same result, and the workspace is
    neither needed nor touched."""
    n, blk = 9, 11
    srcs = make_inputs(n, n * blk, torch.float32, ReductionOp.SUM, seed=9)
    want = krs.ring_reduce_scatter_ref(srcs, ReductionOp.SUM)
    full = [s.clone() for s in srcs]
    dsts = [f[r * blk:(r + 1) * blk] for r, f in enumerate(full)]
    before = (krs.ring_reduce_scatter_pass.launches,
              krs.ring_reduce_scatter_chunked.launches)
    ws = kc.RingWorkspace(torch.device("cpu"))
    krs.ring_reduce_scatter_pass(full, dsts, ReductionOp.SUM,
                                 workspace=ws).wait()
    out = [torch.empty(blk) for _ in range(n)]
    krs.ring_reduce_scatter_chunked(srcs, out, ReductionOp.SUM).wait()
    assert (krs.ring_reduce_scatter_pass.launches,
            krs.ring_reduce_scatter_chunked.launches) == before
    assert ws.err is None
    assert all(same_bits(d, w) for d, w in zip(dsts, want))
    assert all(same_bits(o, w) for o, w in zip(out, want))


def test_wrapper_refuses_a_count_not_divisible_by_n():
    srcs = make_inputs(3, 10, torch.float32, ReductionOp.SUM, seed=3)
    with pytest.raises(UccError) as e:
        krs.ring_reduce_scatter_pass(srcs, [torch.empty(3)] * 3,
                                     ReductionOp.SUM)
    assert e.value.status == Status.ERR_INVALID_PARAM
