"""The allreduce kernel's element order, modelled in plain PyTorch and held
bitwise against the ring's plain version (``ring_allreduce_ref``).

``csrc/ring_allreduce.cu`` runs no ring: one pass folds every element from
its n srcs and stores the result into the n dsts. Its claim is that this
gives the ring's bits, because element g of block b = (g mod csize) / blk
ends as acc(x_{b-1}, ... acc(x_{b+1}, x_b)) whichever way the partial
folds travel. ``walk`` below repeats the kernel's index arithmetic as the
source has it: the 16-byte vectors where every pointer shares one offset
mod 16, single elements at the head, at the tail, and everywhere when the
offsets differ; each thread's units stepped grid-stride with an offset and
a block index advanced without a division; a vector that straddles a
block boundary folded element by element. ``model`` folds each unit as
the kernel does, with the plain versions' own ``accumulate`` and
``divide``. The tests check that every element is visited exactly once
and in its own block, and that the result is bitwise the ring's (NaN
positions compared as NaN), over every n in {1, 2, 3, 5, 7, 8}, the nine
dtypes and five ops, the chunked geometry with odd blk, misaligned
pointer sets and in place. The kernel itself is held to the same plain
version on the card by chip_smoke.py. Inputs come from numpy, seeded.
"""
import numpy as np
import pytest
import torch

from ucc_tpu_torch.constants import ReductionOp
from ucc_tpu_torch.kernels import ring_allreduce as kr
from ucc_tpu_torch.kernels import ring_common as kc
from ucc_tpu_torch.kernels.ring_common import DTYPE_CODES

DTYPES = list(DTYPE_CODES)
OPS = list(kr.OPS)
NS = [1, 2, 3, 5, 7, 8]
#: the kernel's constants (csrc/ring_allreduce.cu)
UNROLL = 2
GROUP = 4


def make_inputs(n, count, dtype, op, seed):
    rng = np.random.default_rng(seed)
    if dtype.is_floating_point:
        srcs = [torch.from_numpy(rng.standard_normal(count)).to(dtype)
                for _ in range(n)]
        if op in (ReductionOp.MAX, ReductionOp.MIN):
            for k in range(0, count, 7):     # NaNs of either sign, on
                srcs[k % n][k] = float("nan") * (-1) ** k  # several ranks
    else:
        lo = 0 if dtype == torch.uint8 else -50
        # sums of 8 such values overflow int8 and products every type:
        # both sides wrap
        srcs = [torch.from_numpy(rng.integers(lo, 50, count)).to(dtype)
                for _ in range(n)]
    return srcs


def same_bits(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    na, nb = torch.isnan(a), torch.isnan(b)
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return bool(torch.equal(na, nb)) and bool(
        torch.equal(a.view(view)[~na], b.view(view)[~nb]))


def walk(count, elem, offsets, blk, n, ctas, threads, part=None):
    """The kernel's units in the order one launch takes them: a list of
    (first element, elements, block) per fold, one entry per element of
    a vector that straddles a block boundary. *offsets* are the 2n
    pointers' byte offsets mod 16; *part* [lo, hi) the elements of a
    launch of a team across processes (direct_fold.cuh: vector_part)."""
    mis = offsets[0] % 16
    aligned = all(o % 16 == mis for o in offsets) and mis % elem == 0
    w = 16 // elem
    head = min(count, ((16 - mis) % 16) // elem)
    p_lo, p_hi = (0, count) if part is None else part
    # (elements per unit, first element, units, units a thread takes at
    # once): the vector sweep, then single elements (sweep_elements)
    if aligned:
        v0 = head if p_lo <= head else head + -(-(p_lo - head) // w) * w
        v0 = min(v0, p_hi)
        vecs = (p_hi - v0) // w
        tail = v0 + vecs * w
        sweeps = [(w, v0, vecs, UNROLL), (1, p_lo, v0 - p_lo, 1),
                  (1, tail, p_hi - tail, 1)]
    else:
        sweeps = [(1, p_lo, p_hi - p_lo, 1)]
    stride = ctas * threads
    units = []
    for width, lo, n_units, unroll in sweeps:
        step = unroll * stride * width
        step_q, step_off = divmod(step, blk)
        step_b = step_q % n
        for first in range(min(stride, n_units)):
            off, b = [], []
            for k in range(unroll):
                q, o = divmod(lo + (first + k * stride) * width, blk)
                off.append(o)
                b.append(q % n)
            for u in range(first, n_units, unroll * stride):
                for k in range(unroll):
                    e = lo + (u + k * stride) * width
                    if u + k * stride < n_units:
                        if off[k] + width <= blk:
                            units.append((e, width, b[k]))
                        else:
                            o, bb = off[k], b[k]
                            for lane in range(width):
                                units.append((e + lane, 1, bb))
                                o += 1
                                if o == blk:
                                    o, bb = 0, (bb + 1) % n
                    off[k] += step_off
                    b[k] += step_b
                    if off[k] >= blk:
                        off[k] -= blk
                        b[k] += 1
                    if b[k] >= n:
                        b[k] -= n
    return units


def model(srcs, dsts, op, blk, offsets=None, ctas=2, threads=4, parts=1):
    """The kernel on CPU tensors: each unit of ``walk`` reads its elements
    from the n srcs in ring order from its block (a vector in groups of
    GROUP loads, a single element rank by rank), divides for AVG and
    writes all n dsts before the next unit (so dsts may be the srcs).
    *parts* P: the P launches of a team across processes, one after
    another. Asserts every element once, in its block; returns the
    vector units."""
    n, count = len(srcs), srcs[0].numel()
    offsets = offsets or [0] * (2 * n)
    acc = kr._accum(op)
    seen = torch.zeros(count, dtype=torch.int64)
    elem = srcs[0].element_size()
    units = [u for p in range(parts) for u in walk(
        count, elem, offsets, blk, n, ctas, threads,
        kc.part_bounds(count, (p, parts), elem))]
    vectors = sum(1 for _, width, _ in units if width > 1)
    for e, width, b in units:
        idx = slice(e, e + width)
        seen[idx] += 1
        want_b = torch.arange(e, e + width) % (n * blk) // blk
        assert torch.equal(want_b, torch.full_like(want_b, b)), (e, b)
        group = GROUP if width > 1 else n
        for base in range(0, n, group):
            xs = [srcs[(b + i) % n][idx].clone()
                  for i in range(base, min(n, base + group))]
            v = xs[0] if base == 0 else acc(xs[0], v)
            for x in xs[1:]:
                v = acc(x, v)
        if op == ReductionOp.AVG:
            v = kr._divide(v, n)
        for d in dsts:
            d[idx] = v
    assert torch.equal(seen, torch.ones(count, dtype=torch.int64))
    return vectors


def check(srcs, op, blk, n_chunks, inplace=False, **kw):
    want = kr.ring_allreduce_ref(srcs, op, blk, n_chunks)
    if inplace:
        dsts = srcs = [s.clone() for s in srcs]
    else:
        dsts = [torch.full_like(s, 7) for s in srcs]
    model(srcs, dsts, op, blk, **kw)
    for r, (d, w) in enumerate(zip(dsts, want)):
        assert same_bits(d, w), (r, d, w)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", NS)
def test_pass_geometry_folds_in_ring_order(n, dtype, op):
    """Ragged counts (not a multiple of n or of any vector width), grids
    from one thread to more threads than units."""
    count = 61 + 2 * n
    srcs = make_inputs(n, count, dtype, op, seed=100 * n + OPS.index(op))
    blk, n_chunks = kr.pass_geometry(count, n)
    ctas, threads = [(1, 1), (2, 4), (3, 32)][NS.index(n) % 3]
    check(srcs, op, blk, n_chunks, ctas=ctas, threads=threads)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.float64], ids=str)
@pytest.mark.parametrize("n", [3, 5, 7])
def test_chunked_geometry_with_odd_blk(n, dtype, op):
    """Small chunks of odd blocks (7 elements: every vector width but
    float64's straddles them), several chunks and a ragged last one."""
    csize = 7 * n
    count = 3 * csize + 5
    srcs = make_inputs(n, count, dtype, op, seed=200 * n + OPS.index(op))
    blk, n_chunks = kr.chunked_geometry(count, n, csize)
    assert blk == 7 and n_chunks == 4
    check(srcs, op, blk, n_chunks)


def test_main_geometry_straddles_vectors_for_odd_n():
    """pass_elems(3) = 1048575: blk = 349525 (odd, as for n = 5), and
    n = 7's 149796 is no multiple of 8, so vectors straddle block
    boundaries at the chunked kernel's own geometry too."""
    assert kr.pass_elems(3) == 1048575
    assert kr.chunked_geometry(1 << 24, 3) == (349525, 17)
    blks = [kr.chunked_geometry(1 << 24, n)[0] for n in (3, 5, 7)]
    assert blks[0] % 2 == blks[1] % 2 == 1 and blks[2] % 8 != 0


#: byte offsets mod 16 of the 2n pointers (n srcs, then n dsts), per rank r
#: of n: views with a storage offset
OFFSETS = {
    "one class": lambda r, n, elem: elem,             # all at +1 element
    "some srcs +1": lambda r, n, elem: elem * (r % 2 if r < n else 0),
    "dsts +2": lambda r, n, elem: 2 * elem * (r >= n),
}


@pytest.mark.parametrize("kind", list(OFFSETS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=str)
@pytest.mark.parametrize("n", [2, 3, 8])
def test_misaligned_pointer_sets(n, dtype, kind):
    """One offset for every pointer: a head of single elements, then
    vectors; offsets that differ: every element one at a time."""
    count = 97
    srcs = make_inputs(n, count, dtype, ReductionOp.SUM, seed=300 + n)
    elem = srcs[0].element_size()
    offsets = [OFFSETS[kind](r, n, elem) % 16 for r in range(2 * n)]
    blk, n_chunks = kr.pass_geometry(count, n)
    check(srcs, ReductionOp.SUM, blk, n_chunks, offsets=offsets)


@pytest.mark.parametrize("geometry", ["pass", "chunked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32], ids=str)
@pytest.mark.parametrize("n", [2, 5, 8])
def test_in_place(n, dtype, geometry):
    """dsts are the srcs: a unit reads all n values before it writes any,
    and units never share an element."""
    count = 150
    op = ReductionOp.AVG if dtype.is_floating_point else ReductionOp.SUM
    srcs = make_inputs(n, count, dtype, op, seed=400 + n)
    blk, n_chunks = kr.pass_geometry(count, n) if geometry == "pass" \
        else kr.chunked_geometry(count, n, 4 * n)
    check(srcs, op, blk, n_chunks, inplace=True)


@pytest.mark.parametrize("parts", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32], ids=str)
@pytest.mark.parametrize("n", [2, 3, 8])
def test_walk_by_parts(n, dtype, parts):
    """The launches of a team across processes, part p of P each
    (kernels/ring_common.part_bounds): every element folded once in its
    block, bitwise the plain version, in place too; the parts cut at
    vectors, so they take as many vectors as one launch."""
    op = ReductionOp.SUM
    for count in (1, 7, 150, 1003):
        srcs = make_inputs(n, count, dtype, op, seed=500 + n + count)
        for geometry in ("pass", "chunked"):
            blk, n_chunks = kr.pass_geometry(count, n) \
                if geometry == "pass" else kr.chunked_geometry(count, n,
                                                               4 * n)
            want = kr.ring_allreduce_ref(srcs, op, blk, n_chunks)
            for inplace in (False, True):
                ins = [s.clone() for s in srcs]
                dsts = ins if inplace else [torch.full_like(s, 7)
                                            for s in srcs]
                v1 = model([s.clone() for s in srcs],
                           [torch.full_like(s, 7) for s in srcs], op, blk)
                vp = model(ins, dsts, op, blk, parts=parts)
                for d, w in zip(dsts, want):
                    assert same_bits(d, w)
                if blk * srcs[0].element_size() % 16 == 0:
                    assert vp == v1


def test_more_ranks_than_two_load_groups():
    """n above GROUP folds its ranks in several groups of loads."""
    n = 19
    srcs = make_inputs(n, 83, torch.bfloat16, ReductionOp.SUM, seed=19)
    blk, n_chunks = kr.pass_geometry(83, n)
    check(srcs, ReductionOp.SUM, blk, n_chunks)


@pytest.mark.parametrize("count,elem,cap,want", [
    (64 << 10, 4, 528, 64),        # the pass kernel's main shape
    (16 << 20, 4, 528, 528),       # the chunked one: the card's cap
    (1, 1, 528, 1), (0, 4, 528, 1),
    (4097, 2, 1056, 3),            # 513 vectors of bf16
])
def test_launch_ctas(count, elem, cap, want):
    assert kr.launch_ctas(count, elem, cap) == want


def test_wrapper_on_cpu_runs_the_plain_version_for_any_n():
    """Nothing caps n on the CPU, and in place is the same result."""
    srcs = make_inputs(7, 50, torch.float32, ReductionOp.SUM, seed=7)
    want = kr.ring_allreduce_pass_ref(srcs, ReductionOp.SUM)
    dsts = [s.clone() for s in srcs]
    before = kr.ring_allreduce_pass.launches
    kr.ring_allreduce_pass(dsts, dsts, ReductionOp.SUM).wait()
    assert kr.ring_allreduce_pass.launches == before
    assert all(same_bits(d, w) for d, w in zip(dsts, want))
