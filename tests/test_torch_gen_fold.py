"""The fold plans of the generated device collectives
(``ucc_tpu_torch/kernels/gen_device.fold_plan``) and the plain version of
the fold kernel (``gen_device_fold_ref``), on the CPU.

``csrc/gen_fold.cu`` runs an exact plan as one pass: element g of unit j
ends, on every rank, as one expression over element g of the srcs, which
the host encodes per unit as a short program (leaf ranks, then steps). The
tests hold:

- every registered device program at n in {2, 3, 4, 5, 8, 16, 32}, under
  int8 and fp8 and from every bcast root in {0, n/2, n-1}, has a fold
  plan: each unit ends as one expression on every rank, whose leaves are
  all that unit of some src, within the kernel's stack (at most
  log2(n) + 1 values at once), and a ring's chain visits every rank once;
- plans with a leaf moved to another unit, or a tree deeper than the
  stack, have none; plans with a wire layer get a wire fold plan or keep
  the layer kernel (``test_torch_gen_wire_fold.py`` holds which);
- ``gen_device_fold_ref`` is bitwise ``gen_device_ref`` (NaN positions
  compared as NaN) on every dtype of ``DTYPE_CODES`` and the five ops,
  with NaNs and signed zeros under MAX/MIN, AVG on floating types, ragged
  counts (nchunks x 37) and in place; and bitwise the JAX package's Pallas
  kernel in interpret mode on the cases of
  ``test_torch_gen_device.PALLAS_CASES``;
- ``walk``/``model`` repeat the kernel's index walk as the source has it
  (16-byte vectors where every pointer shares one offset mod 16, single
  elements at the head, the tail, and everywhere when the offsets differ;
  each thread's unit index stepped grid-stride without a division; a
  vector that straddles two units folded element by element; leaf loads
  issued LEAVES at a time; the stack bounded by its slots; the store into
  an in-place bcast root skipped): every element of every dst is written
  exactly once (or, skipped, keeps the root's value), each unit reads and
  writes only its own elements, and the result is bitwise the plain
  version's.

The kernel itself runs only on the card: chip_smoke.py holds it bitwise to
``gen_device_ref`` there. Inputs come from numpy, seeded."""
import math

import numpy as np
import pytest
import torch

from test_torch_gen_device import (PALLAS_CASES, assert_bitwise, inputs,
                                   progs, run_jax)
from test_torch_ring_allreduce_direct import same_bits

import ucc_tpu_torch as ut
from ucc_tpu_torch.constants import CollType, ReductionOp
from ucc_tpu_torch.dsl import lower_device as ld
from ucc_tpu_torch.dsl.ir import ProgramBuilder
from ucc_tpu_torch.kernels import gen_device as kgd
from ucc_tpu_torch.kernels.ring_common import DTYPE_CODES, OPS
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy

NS = [2, 3, 4, 5, 8, 16, 32]
DTYPES = list(DTYPE_CODES)
#: csrc/gen_fold.cu: leaves whose loads a thread issues together
#: (GROUP x UNROLL, or GROUP for 1-byte types)
GROUP, UNROLL = 4, 2


def registered(n):
    """Every registered device program at n, under int8 and fp8, once."""
    out = {p.name: p for p in ld.device_programs(n, "int8")}
    out.update({p.name: p for p in ld.device_programs(n, "fp8")})
    return list(out.values())


def roots(prog, n):
    return sorted({0, n // 2, n - 1}) if prog.coll == CollType.BCAST else [0]


def make_srcs(n, count, dtype, op, seed, signed_zeros=True):
    """Seeded inputs: integers in [-50, 50) (uint8 [0, 50)), normal floats
    times 3; under MAX/MIN, NaNs of either sign and (*signed_zeros*)
    zeros of both signs spread over the ranks."""
    rng = np.random.default_rng(seed)
    if not dtype.is_floating_point:
        lo = 0 if dtype == torch.uint8 else -50
        return [torch.from_numpy(rng.integers(lo, 50, count)).to(dtype)
                for _ in range(n)]
    srcs = [torch.from_numpy(rng.standard_normal(count) * 3).to(dtype)
            for _ in range(n)]
    if op in (ReductionOp.MAX, ReductionOp.MIN):
        for k in range(0, count, 5):
            srcs[k % n][k] = float("nan") * (-1) ** k
        for k in range(2, count, 11) if signed_zeros else ():
            for r in range(n):
                srcs[r][k] = -0.0 if (r + k) % 2 else 0.0
    return srcs


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_every_registered_program_has_a_fold_plan(n):
    for prog in registered(n):
        for root in roots(prog, n):
            for count in (prog.nchunks * 37, prog.nchunks * 40):
                plan = ld.device_plan(prog, n, count, root)
                fp = kgd.fold_plan(plan)
                what = (prog.name, n, root, count)
                assert fp is not None, what
                assert kgd.fold_plan(plan) is fp           # kept on the plan
                unit, nodes, final = kgd.fold_exprs(plan)
                assert fp.unit == unit and count % unit == 0
                assert len(fp.units) == count // unit
                for j, e in enumerate(final[0]):
                    # one expression on every rank: every rank receives it
                    assert all(final[r][j] == e for r in range(n)), what
                    leaves = []
                    todo = [e]
                    while todo:
                        node = nodes[todo.pop()]
                        if node[0] == 0:
                            leaves.append(node[1:])
                        else:
                            todo += node[1:]
                    # positions are preserved
                    assert all(jj == j for _, jj in leaves), what
                    ranks, kinds = fp.program(j)
                    assert sorted(ranks) == sorted(q for q, _ in leaves)
                    if plan.reducing:
                        assert sorted(ranks) == list(range(n)), what
                        if plan.ring:          # a chain through every rank
                            assert kinds[0] == kgd.S_LOAD and set(
                                kinds[1:]) <= {kgd.S_FOLD_L, kgd.S_FOLD_R}
                    else:
                        assert ranks == [root] and kinds == [kgd.S_LOAD]
                assert 1 <= fp.depth <= math.log2(n) + 1, what
                assert fp.depth <= kgd.FOLD_STACK


def test_halving_doubling_is_a_balanced_tree():
    """rhd_r2 at n = 2^k holds k values at once (a leaf folds straight
    into its sibling); every chain holds one."""
    for n in (4, 8, 16, 32):
        by_name = {p.name: p for p in registered(n)}
        for name, prog in by_name.items():
            fp = kgd.fold_plan(ld.device_plan(prog, n, prog.nchunks * 37))
            assert fp.depth == (int(math.log2(n)) if name == "gen_rhd_r2"
                                else 1), (name, n)


def test_units_share_programs():
    """A ring's units take n programs, rotations of one chain; a bcast's
    units one program."""
    for n in (4, 8):
        p = {q.name: q for q in registered(n)}
        ring = kgd.fold_plan(ld.device_plan(p["gen_ring_c2"], n,
                                            2 * n * 37))
        assert len(set(ring.units.tolist())) == n
        chains = [ring.program(j)[0] for j in range(n)]
        assert all(any(c == [(x + d) % n for x in chains[0]]
                       for d in range(n)) for c in chains)
        bc = kgd.fold_plan(ld.device_plan(p["gen_bc_chain_c2"], n, 2 * 37,
                                          root=n - 1))
        assert len(set(bc.units.tolist())) == 1
        assert bc.program(0) == ([n - 1], [kgd.S_LOAD])


def wire_direct(n, rs_wire, ag_wire):
    """chip_smoke.py's edge-wire direct exchange."""
    b = ProgramBuilder("wdirect", CollType.ALLREDUCE, n, n)
    b.next_round()
    for p in range(n):
        for q in range(n):
            if p != q:
                b.send(p, q, to=q, wire=rs_wire)
    for q in range(n):
        for p in range(n):
            if p != q:
                b.reduce(q, q, frm=p, wire=rs_wire)
    b.next_round()
    for q in range(n):
        for p in range(n):
            if p != q:
                b.send(q, q, to=p, wire=ag_wire)
    for p in range(n):
        for q in range(n):
            if p != q:
                b.recv(p, q, frm=q, wire=ag_wire)
    return b.build("gen_wdirect")


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("qmode", ["int8", "fp8"])
def test_wire_plans_keep_the_layer_kernel(n, qmode):
    """Wire plans keep the layer kernel only where they have no fold plan
    (tests/test_torch_gen_wire_fold.py holds the wire fold): the direct
    exchange with wired edges at qblock 32 gets a wire fold plan at every
    wiring, at qblock 512 it keeps the layer kernel."""
    for rs, ag in ((qmode, qmode), (qmode, ""), ("", qmode)):
        plan = ld.device_plan(wire_direct(n, rs, ag), n, n * 40, 0, 32,
                              qmode)
        assert not plan.ring and plan.arena > 0
        fp = kgd.fold_plan(plan)
        assert fp is not None and fp.qmode == qmode and fp.qblock == 32
        assert kgd.fold_exprs(plan) is not None
        plan = ld.device_plan(wire_direct(n, rs, ag), n, n * 600, 0, 512,
                              qmode)
        assert kgd.fold_plan(plan) is None
    # the same exchange with exact edges folds on gen_fold.cu's route
    plan = ld.device_plan(wire_direct(n, "", ""), n, n * 40)
    fp = kgd.fold_plan(plan)
    assert fp is not None and fp.qmode == ""


def test_a_leaf_in_another_unit_has_no_fold_plan():
    """Rank 1 receives rank 0's unit 0 into both its units and rank 0
    copies its unit 0 into unit 1: every rank ends with one expression per
    unit, but unit 1's leaf is unit 0, which the kernel cannot read at
    the element it writes."""
    n, count = 2, 2
    z = [0, 0]
    tab = np.array([[0, 0], [1, 0], [0, 1], [0, 1], [1, 0], z,
                    [0, 0], [1, 0], [0, 0], [0, 1], [1, 0], z], np.int32)
    prog = np.array([[kgd.I_EXACT, 0, 1, 0, 0, 0, 0, 0],
                     [kgd.I_EXACT, 1, 1, 0, 0, 0, 0, 0],
                     [kgd.I_COPY, 0, 1, 0, 0, 0, 0, 0]], np.int64)
    ctab = np.array([[0, 0], [1, 0], [1, 0]], np.int32)
    plan = kgd.GenPlan(n, count, False, tab, prog, ctab, span=1)
    srcs = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])]
    got = kgd.gen_device_ref(srcs, plan, ReductionOp.SUM)
    assert all(torch.equal(g, torch.tensor([1.0, 1.0])) for g in got)
    unit, nodes, final = kgd.fold_exprs(plan)
    assert unit == 1 and final[0] == final[1]
    assert kgd.fold_plan(plan) is None


def test_a_tree_deeper_than_the_stack_has_no_fold_plan(monkeypatch):
    prog = next(p for p in registered(8) if p.name == "gen_rhd_r2")
    assert kgd.fold_plan(ld.device_plan(prog, 8, 8 * 37)).depth == 3
    monkeypatch.setattr(kgd, "FOLD_STACK", 2)
    assert kgd.fold_plan(ld.device_plan(prog, 8, 8 * 37)) is None


# ---------------------------------------------------------------------------
# the plain version of the fold kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_fold_ref_is_bitwise_the_plain_plan(n, dtype):
    """Every program, the five ops (AVG on floating types), ragged counts
    of nchunks x 37, bcast roots 0, n/2, n-1."""
    for i, prog in enumerate(registered(n)):
        for k, op in enumerate(OPS):
            if op == ReductionOp.AVG and not dtype.is_floating_point:
                continue
            for root in roots(prog, n):
                count = prog.nchunks * 37
                plan = ld.device_plan(prog, n, count, root)
                srcs = make_srcs(n, count, dtype, op, 1000 * n + 10 * i + k)
                want = kgd.gen_device_ref(srcs, plan, op)
                got = kgd.gen_device_fold_ref(srcs, plan, op)
                assert all(same_bits(g, w) for g, w in zip(got, want)), \
                    (prog.name, op, root)
                if not plan.reducing:
                    break                   # the op does not matter


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32], ids=str)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_torch_ops_backend_is_bitwise_the_fold_route(n, dtype):
    """UCC_GEN_DEVICE_BACKEND=xla's entry point, gen_device_torch_ops, and
    the plan run in place on dsts that hold the srcs (what it does on a
    CUDA tensor, on its stream), both bitwise the fold route's plain
    version: every program, the five ops, bcast roots 0, n/2, n-1, out of
    place and in place."""
    for i, prog in enumerate(registered(n)):
        for k, op in enumerate(OPS):
            if op == ReductionOp.AVG and not dtype.is_floating_point:
                continue
            for root in roots(prog, n):
                count = prog.nchunks * 37
                plan = ld.device_plan(prog, n, count, root)
                srcs = make_srcs(n, count, dtype, op, 7000 * n + 10 * i + k)
                want = kgd.gen_device_fold_ref(srcs, plan, op)
                dsts = [torch.full_like(x, 7) for x in srcs]
                kgd.gen_device_torch_ops(srcs, dsts, op, plan=plan,
                                         root=root).done()
                inplace = [x.clone() for x in srcs]
                kgd.gen_device_torch_ops(inplace, inplace, op, plan=plan,
                                         root=root).done()
                work = [x.clone() for x in srcs]
                kgd._run_plan(work, plan, op)
                for got in (dsts, inplace, work):
                    assert all(same_bits(g, w) for g, w in zip(got, want)), \
                        (prog.name, op, root)
                if not plan.reducing:
                    break                   # the op does not matter


@pytest.mark.parametrize("n", [16, 32])
def test_fold_ref_at_the_largest_teams(n):
    for i, prog in enumerate(registered(n)):
        op = OPS[i % len(OPS)]
        count = prog.nchunks * 37
        plan = ld.device_plan(prog, n, count, n // 2)
        srcs = make_srcs(n, count, torch.float32, op, n + i)
        assert all(same_bits(g, w) for g, w in zip(
            kgd.gen_device_fold_ref(srcs, plan, op),
            kgd.gen_device_ref(srcs, plan, op))), prog.name


@pytest.mark.parametrize("family,param,n,dt,op,root,inplace", PALLAS_CASES)
def test_fold_ref_matches_pallas_kernel(family, param, n, dt, op, root,
                                        inplace):
    """The reference's Pallas kernel in interpret mode on the inputs of
    test_torch_gen_device's Pallas cases; in place is the wrapper's
    business, so the fold ref reads the srcs either way."""
    wire = "int8" if family == "qdirect" else ""
    jp, p = progs(family, param, n, wire)
    arrs = inputs(n, p.nchunks * 37, dt, seed=n + param + len(family))
    want = run_jax(jp, n, arrs, op or "SUM", root, "pallas", 256, wire)
    plan = ld.device_plan(p, n, arrs[0].size, root, 256, wire)
    got = kgd.gen_device_fold_ref([from_numpy(a, "cpu") for a in arrs], plan,
                                  ut.ReductionOp[op or "SUM"])
    assert_bitwise([to_numpy(g) for g in got], want)


# ---------------------------------------------------------------------------
# the kernel's walk
# ---------------------------------------------------------------------------

def walk(count, elem, offsets, unit, ctas, threads, part=None):
    """The kernel's folds in the order one launch takes them: a list of
    (first element, elements, unit index), one entry per element of a
    vector that straddles two units. *offsets* are the 2n pointers' byte
    offsets mod 16. *part* (lo, hi): the instance of a launch of one part
    of the elements (direct_fold.cuh's vector_part), else the whole
    walk's."""
    mis = offsets[0] % 16
    aligned = all(o % 16 == mis for o in offsets) and mis % elem == 0
    w = 16 // elem
    head = min(count, ((16 - mis) % 16) // elem)
    lo, hi = part or (0, count)
    if not aligned:
        sweeps = [(1, lo, hi - lo)]
    elif part is None:
        vecs = (count - head) // w
        tail = head + vecs * w
        sweeps = [(w, head, vecs), (1, 0, head), (1, tail, count - tail)]
    else:
        v0 = min(hi, head if lo <= head else head + -(-(lo - head) // w) * w)
        vecs = (hi - v0) // w
        tail = v0 + vecs * w
        sweeps = [(w, v0, vecs), (1, lo, v0 - lo), (1, tail, hi - tail)]
    stride = ctas * threads
    out = []
    for width, lo, n_units in sweeps:
        step_q, step_off = divmod(stride * width, unit)
        for first in range(min(stride, n_units)):
            q, off = divmod(lo + first * width, unit)
            for u in range(first, n_units, stride):
                e = lo + u * width
                if off + width <= unit:
                    out.append((e, width, q))
                else:
                    o, qq = off, q
                    for lane in range(width):
                        out.append((e + lane, 1, qq))
                        o += 1
                        if o == unit:
                            o, qq = 0, qq + 1
                off += step_off
                q += step_q
                if off >= unit:
                    off -= unit
                    q += 1
    return out


def evaluate(fp, q, xs_of, acc):
    """Unit q's program as the kernel runs it: the next LEAVES leaves'
    loads, then the steps that take them (the combines before each leaf's
    step), then the trailing combines; the values below the top in at
    most FOLD_STACK - 1 slots."""
    ranks, kinds = fp.program(q)
    leaves_in_flight = GROUP if xs_of(0).element_size() == 1 \
        else GROUP * UNROLL
    top, below, k = None, [], 0

    def combine(kind):
        nonlocal top
        a = below.pop()
        top = acc(a, top) if kind == kgd.S_COMB else acc(top, a)

    for base in range(0, len(ranks), leaves_in_flight):
        xs = [xs_of(r) for r in ranks[base:base + leaves_in_flight]]
        for x in xs:
            while kinds[k] >= kgd.S_COMB:
                combine(kinds[k])
                k += 1
            kind = kinds[k]
            k += 1
            if kind == kgd.S_LOAD:
                if k > 1:
                    below.append(top)
                    assert len(below) <= kgd.FOLD_STACK - 1
                top = x
            elif kind == kgd.S_FOLD_L:
                top = acc(x, top)
            else:
                top = acc(top, x)
    for kind in kinds[k:]:
        combine(kind)
    assert not below
    return top


def model(srcs, dsts, plan, op, offsets=None, ctas=2, threads=4,
          part=None):
    """The kernel on CPU tensors: each fold of ``walk`` loads its elements
    from its program's leaves, evaluates it, multiplies for AVG and writes
    every dst but an in-place lone leaf's before the next fold (so dsts
    may be the srcs). Returns how often each element of each dst was
    written (once, the skipped store aside, in a whole launch) and asserts
    that each fold stays in its unit. *part*: the launch's (lo, hi)."""
    n, count = len(srcs), srcs[0].numel()
    fp = kgd.fold_plan(plan)
    offsets = offsets or [0] * (2 * n)
    acc = kgd.accumulate(op if op in OPS else ReductionOp.SUM)
    written = torch.zeros(n, count, dtype=torch.int64)
    for e, width, q in walk(count, srcs[0].element_size(), offsets,
                            fp.unit, ctas, threads, part):
        idx = slice(e, e + width)
        units = torch.arange(e, e + width) // fp.unit
        assert torch.equal(units, torch.full_like(units, q)), (e, q)
        v = evaluate(fp, q, lambda r: srcs[r][idx].clone(), acc)
        if plan.reducing and op == ReductionOp.AVG:
            v = v * kgd.avg_factor(v.dtype, n)
        ranks, _ = fp.program(q)
        for r, d in enumerate(dsts):
            if len(ranks) == 1 and ranks[0] == r and d is srcs[r]:
                continue
            d[idx] = v
            written[r, idx] += 1
    return written


def check(prog, n, count, dtype, op, root=0, inplace=False, **kw):
    plan = ld.device_plan(prog, n, count, root)
    # no signed zeros: torch's CPU maximum and minimum return either zero
    # by whether they run vectorized, so on the model's short slices they
    # may pick the other one than on the plain version's whole units
    srcs = make_srcs(n, count, dtype, op, seed=n * 31 + count,
                     signed_zeros=False)
    want = kgd.gen_device_ref(srcs, plan, op)
    if inplace:
        dsts = srcs = [s.clone() for s in srcs]
    else:
        dsts = [torch.full_like(s, 7) for s in srcs]
    written = model(srcs, dsts, plan, op, **kw)
    for r in range(n):
        skipped = inplace and not plan.reducing and r == root
        assert torch.equal(written[r], torch.full_like(
            written[r], 0 if skipped else 1)), (prog.name, r)
    for r, (d, w) in enumerate(zip(dsts, want)):
        assert same_bits(d, w), (prog.name, r)


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_walk_folds_every_unit_bitwise(n):
    """Every program at ragged counts (units of 37 elements: every vector
    width straddles them), f32, bf16, int8 and float64 turning with the
    program, the ops turning too, grids from one thread to more threads
    than vectors."""
    grids = [(1, 1), (2, 4), (3, 32)]
    for i, prog in enumerate(registered(n)):
        dtype = [torch.float32, torch.bfloat16, torch.int8,
                 torch.float64][i % 4]
        op = OPS[(i + n) % len(OPS)]
        if op == ReductionOp.AVG and not dtype.is_floating_point:
            op = ReductionOp.SUM
        ctas, threads = grids[i % 3]
        for root in roots(prog, n):
            check(prog, n, prog.nchunks * 37, dtype, op, root, ctas=ctas,
                  threads=threads)


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
@pytest.mark.parametrize("name", ["gen_ring_c2", "gen_rhd_r2",
                                  "gen_bc_kn_r2"])
def test_walk_on_misaligned_pointer_sets(name, dtype, kind):
    n = 4
    prog = next(p for p in registered(n) if p.name == name)
    elem = torch.empty(0, dtype=dtype).element_size()
    offsets = [OFFSETS[kind](r, n, elem) % 16 for r in range(2 * n)]
    check(prog, n, prog.nchunks * 37, dtype, ReductionOp.SUM,
          root=n - 1, offsets=offsets)


@pytest.mark.parametrize("name", ["gen_ring_c1", "gen_rhd_r2", "gen_rhd_r8",
                                  "gen_bc_kn_r2", "gen_bc_chain_c2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.int32], ids=str)
def test_walk_in_place(name, dtype):
    """dsts are the srcs: a fold reads all its leaves before it writes any
    dst, folds never share an element, and an in-place bcast root keeps
    its buffer unwritten."""
    n = 8
    prog = next(p for p in registered(n) if p.name == name)
    op = ReductionOp.AVG if dtype.is_floating_point else ReductionOp.SUM
    check(prog, n, prog.nchunks * 37, dtype, op, root=3, inplace=True)


def test_wrappers_on_cpu_run_the_plain_version():
    """CPU tensors: the plain plan, no launch on either route."""
    n = 4
    for prog in registered(n):
        plan = ld.device_plan(prog, n, prog.nchunks * 37, 1)
        wrapper = kgd.gen_device_ring if plan.ring else kgd.gen_device_gen
        srcs = make_srcs(n, plan.count, torch.float32, ReductionOp.SUM, 5)
        dsts = [s.clone() for s in srcs]
        before = (wrapper.launches, wrapper.fold_launches)
        wrapper(dsts, dsts, ReductionOp.SUM, plan=plan).wait()
        assert (wrapper.launches, wrapper.fold_launches) == before
        want = kgd.gen_device_fold_ref(srcs, plan, ReductionOp.SUM)
        assert all(same_bits(d, w) for d, w in zip(dsts, want)), prog.name
