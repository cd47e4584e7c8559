"""The wire fold of the generated device collectives
(``ucc_tpu_torch/kernels/gen_device.fold_plan`` on plans with int8/fp8
edges, and ``csrc/gen_device.cu``'s ``gen_wire_fold_kernel``), on the CPU.

A wire plan runs as one pass when its qblock groups lie inside units and
each rank's expression of a unit is a top of one program per unit: the
program evaluates the deepest expression and STOREs into rank r's dst where
the top is rank r's. The tests hold:

- which wire plans get a fold plan (the edge-wired direct exchange at any
  wiring, qblock up to 256, a wire run longer than a unit when the unit is
  a multiple of qblock) and which keep the layer kernel (qblock 512, a wire
  run longer than a unit that is no multiple of qblock, a tree deeper than
  ``FOLD_STACK``);
- the chain property: in every unit, every rank's expression lies on one
  chain R, QDQ(R), QDQ^2(R), ...;
- ``gen_device_fold_ref`` bitwise ``gen_device_ref`` at n in {2, 3, 4, 8},
  int8 and fp8, the three wirings, qblock 8, 32, 37 and 256, counts with
  partial groups, SUM, AVG and MAX (exact combines beside wire adds); and
  bitwise the JAX package's Pallas kernel in interpret mode at n in
  {2, 4, 8};
- ``wire_model`` repeats the kernel's walk as the source has it (one warp
  per qblock group, grid-stride over the groups of every unit; a lane's
  slots 128 s + 4 l + s % 4 on the vector path, 32 s + l on the scalar one;
  lanes past a partial group's end masked out of the absmax and the
  stores; leaf loads issued WIRE_LEAVES at a time; the stack bounded by its
  slots; the vector path only where every pointer shares one offset mod 16
  and the group starts on a 16-byte boundary with whole vectors): every
  element of every dst is written exactly once, a group reads all it reads
  before its first store, and the result is bitwise the plain version's,
  in place too. It reads its constants from the source;
- the kernel's int8 rounding (1.5 x 2^23 added and subtracted, then the
  clip) is bitwise rintf, the clip and the integer it goes through.

The kernel itself runs only on the card: chip_smoke.py holds it bitwise to
``gen_device_ref`` there. Inputs come from numpy, seeded."""
import os
import re

import numpy as np
import pytest
import torch

from test_torch_gen_device import (assert_bitwise, inputs, run_jax,
                                   wire_direct as wire_direct_of)
from test_torch_gen_device import JCollType, JProgramBuilder
from test_torch_gen_fold import wire_direct
from test_torch_ring_allreduce_direct import same_bits

import ucc_tpu_torch as ut
from ucc_tpu_torch.constants import CollType, ReductionOp
from ucc_tpu_torch.dsl import lower_device as ld
from ucc_tpu_torch.dsl.ir import ProgramBuilder
from ucc_tpu_torch.kernels import build
from ucc_tpu_torch.kernels import gen_device as kgd
from ucc_tpu_torch.kernels import ring_common as kc
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy

WIRINGS = ("both", "reduce", "gather")
#: (qblock, elements per chunk): partial last groups but at qblock 8
#: (40 = 5 x 8)
GRIDS = ((8, 40), (32, 40), (37, 100), (256, 785))


def wiring(qmode, which):
    """(reduce round's wire, gather round's wire) of a wiring."""
    return {"both": (qmode, qmode), "reduce": (qmode, ""),
            "gather": ("", qmode)}[which]


def wire_plan(n, qmode, which, qblock, ce):
    rs, ag = wiring(qmode, which)
    return ld.device_plan(wire_direct(n, rs, ag), n, n * ce, 0, qblock,
                          qmode)


def wire_pairs(n, wire):
    """An edge-wired direct exchange over 2n chunks whose reduce round
    moves runs of two chunks (rank q owns chunks 2q and 2q + 1, which merge
    into one run) and whose gather round moves them one at a time, the
    higher first (no merge): its wire runs of the reduce round are two
    units long."""
    b = ProgramBuilder("wpairs", CollType.ALLREDUCE, n, 2 * n)
    b.next_round()
    for p in range(n):
        for q in range(n):
            if p != q:
                for c in (2 * q, 2 * q + 1):
                    b.send(p, c, to=q, wire=wire)
    for q in range(n):
        for p in range(n):
            if p != q:
                for c in (2 * q, 2 * q + 1):
                    b.reduce(q, c, frm=p, wire=wire)
    b.next_round()
    for q in range(n):
        for p in range(n):
            if p != q:
                for c in (2 * q + 1, 2 * q):
                    b.send(q, c, to=p, wire=wire)
    for p in range(n):
        for q in range(n):
            if p != q:
                for c in (2 * q + 1, 2 * q):
                    b.recv(p, c, frm=q, wire=wire)
    return b.build("gen_wpairs")


def make_srcs(n, count, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(count) * 3)
                             .astype(np.float32)) for _ in range(n)]


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("qmode", ["int8", "fp8"])
def test_wire_direct_has_a_wire_fold_plan(n, qmode):
    """Every wiring and qblock up to 256: one unit per chunk, one program
    per unit with a STORE for every rank, after the last leaf."""
    for which in WIRINGS:
        for qblock, ce in GRIDS:
            plan = wire_plan(n, qmode, which, qblock, ce)
            fp = kgd.fold_plan(plan)
            what = (n, qmode, which, qblock)
            assert fp is not None and fp.qmode == qmode, what
            assert fp.qblock == qblock and fp.unit == ce, what
            assert len(fp.units) == n and fp.depth <= 2, what
            for j in range(n):
                leaves, kinds = fp.program(j)
                assert sorted(leaves) == list(range(n)), what
                assert sorted(fp.stores(j)) == list(range(n)), what
                assert kinds.count(kgd.S_STORE) == n
                first = kinds.index(kgd.S_STORE)
                assert not set(kinds[first:]) & {kgd.S_LOAD, kgd.S_FOLD_L,
                                                 kgd.S_FOLD_R}
                # one QDQ per wired send: n - 1 in each wired round
                wired = (which != "gather") + (which != "reduce")
                assert kinds.count(kgd.S_QDQ) == wired * (n - 1), what


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("qmode", ["int8", "fp8"])
def test_plans_without_a_wire_fold_keep_the_layer_kernel(n, qmode):
    """qblock 512 (a group wider than a warp's 8 values a lane); runs of
    two units whose unit is no multiple of qblock (their groups straddle
    units), while a unit that is one folds; a program deeper than the
    stack."""
    for which in WIRINGS:
        plan = wire_plan(n, qmode, which, 512, 600)
        assert kgd.fold_plan(plan) is None and plan.arena > 0
    plan = ld.device_plan(wire_pairs(n, qmode), n, 2 * n * 40, 0, 32, qmode)
    assert kgd.fold_unit(plan) == 40 and plan.prog[0, 2] == 80
    assert kgd.fold_exprs(plan) is None and kgd.fold_plan(plan) is None
    plan = ld.device_plan(wire_pairs(n, qmode), n, 2 * n * 64, 0, 32, qmode)
    fp = kgd.fold_plan(plan)
    assert fp is not None and fp.unit == 64
    srcs = make_srcs(n, plan.count, n)
    assert all(same_bits(g, w) for g, w in zip(
        kgd.gen_device_fold_ref(srcs, plan, ReductionOp.SUM),
        kgd.gen_device_ref(srcs, plan, ReductionOp.SUM)))


def test_a_wire_tree_deeper_than_the_stack_keeps_the_layer_kernel(
        monkeypatch):
    plan = wire_plan(4, "int8", "both", 32, 40)
    assert kgd.fold_plan(plan).depth == 2
    monkeypatch.setattr(kgd, "FOLD_STACK", 1)
    assert kgd.fold_plan(wire_plan(4, "int8", "both", 32, 40)) is None
    # the gather-only wiring reduces exactly: a chain of folds, depth 1
    assert kgd.fold_plan(wire_plan(4, "int8", "gather", 32, 40)) is not None


def test_wire_plans_without_a_wire_type_have_no_fold_plan():
    """A plan with wire layers lowered without its wire type (qmode "")
    cannot quantize: no fold plan."""
    plan = ld.device_plan(wire_direct(4, "int8", "int8"), 4, 4 * 40, 0, 32)
    assert plan.qmode == "" and kgd.fold_plan(plan) is None


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("which", WIRINGS)
def test_the_chain_property(n, which):
    """In every unit, every rank's expression lies on one chain R,
    QDQ(R), QDQ^2(R), ...; with a wired gather round the n ranks hold n
    different links of it (the owner and the last receiver share the
    deepest), else all of them hold R."""
    plan = wire_plan(n, "int8", which, 32, 40)
    unit, nodes, final = kgd.fold_exprs(plan)
    for j in range(n):
        ends = {final[r][j] for r in range(n)}
        top = max(ends)                       # interned last: the deepest
        chain = [top]
        while nodes[chain[-1]][0] == 2:
            chain.append(nodes[chain[-1]][1])
        assert ends <= set(chain), (j, ends, chain)
        root = chain[-1]                      # R: no QDQ on top
        assert nodes[root][0] in (1, 3)
        if which == "reduce":
            assert ends == {root}
        else:
            assert len(ends) == n - 1 and len(chain) == n


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("qmode", ["int8", "fp8"])
def test_wire_fold_ref_is_bitwise_the_plain_plan(n, qmode):
    """Every wiring and grid; SUM, AVG, and MAX (which only the exact
    combines of a one-round wiring take: wire receives add)."""
    for i, which in enumerate(WIRINGS):
        for k, (qblock, ce) in enumerate(GRIDS):
            plan = wire_plan(n, qmode, which, qblock, ce)
            for op in (ReductionOp.SUM, ReductionOp.AVG, ReductionOp.MAX):
                srcs = make_srcs(n, plan.count, 100 * n + 10 * i + k)
                want = kgd.gen_device_ref(srcs, plan, op)
                got = kgd.gen_device_fold_ref(srcs, plan, op)
                assert all(same_bits(g, w) for g, w in zip(got, want)), \
                    (which, qblock, op)


def test_wire_fold_ref_on_special_values():
    """Zero groups (scale 1), a group of one nonzero value, values at the
    clip and ties of the int8 rounding."""
    n, qblock, ce = 4, 32, 40
    for qmode in ("int8", "fp8"):
        plan = wire_plan(n, qmode, "both", qblock, ce)
        srcs = make_srcs(n, n * ce, 3)
        for s in srcs:
            s[:32] = 0.0                          # unit 0's first group
            s[40:72] = 0.0
        srcs[1][40] = 5.0                         # one nonzero value
        srcs[2][80:120] = torch.arange(40, dtype=torch.float32) - 19.5
        want = kgd.gen_device_ref(srcs, plan, ReductionOp.SUM)
        got = kgd.gen_device_fold_ref(srcs, plan, ReductionOp.SUM)
        assert all(same_bits(g, w) for g, w in zip(got, want)), qmode


#: (n, qmode, wiring, qblock, elements per chunk)
PALLAS_WIRE_CASES = [
    (2, "int8", "both", 32, 40), (2, "fp8", "gather", 8, 40),
    (4, "fp8", "both", 37, 100), (4, "int8", "reduce", 32, 40),
    (8, "int8", "both", 32, 40), (8, "fp8", "both", 32, 40),
]


@pytest.mark.parametrize("n,qmode,which,qblock,ce", PALLAS_WIRE_CASES)
def test_wire_fold_ref_matches_pallas_kernel(n, qmode, which, qblock, ce):
    """The reference's Pallas kernel in interpret mode, per rank."""
    rs, ag = wiring(qmode, which)
    jp = wire_direct_of(JProgramBuilder, JCollType, n, rs, ag)
    arrs = inputs(n, n * ce, "f32", seed=n * 11 + qblock)
    want = run_jax(jp, n, arrs, "SUM", 0, "pallas", qblock, qmode)
    plan = wire_plan(n, qmode, which, qblock, ce)
    assert kgd.fold_plan(plan) is not None
    got = kgd.gen_device_fold_ref([from_numpy(a, "cpu") for a in arrs], plan,
                                  ut.ReductionOp.SUM)
    assert_bitwise([to_numpy(g) for g in got], want)


# ---------------------------------------------------------------------------
# the kernel's walk
# ---------------------------------------------------------------------------

def _source():
    with open(os.path.join(build.CSRC, kgd.SOURCE)) as fh:
        return fh.read()


def _constant(text, name):
    hit = re.search(rf"constexpr int {name} = (\d+);", text)
    assert hit, f"{name} is no longer a constexpr of {kgd.SOURCE}"
    return int(hit.group(1))


TEXT = _source()
WARP = _constant(TEXT, "WARP")
WIRE_LEAVES = _constant(TEXT, "WIRE_LEAVES")
STACK = _constant(TEXT, "STACK")


def test_model_constants_are_the_kernels():
    """The step kinds, the header, the widest group and the kernel
    numbers of the source are the host's."""
    assert _constant(TEXT, "WIRE_MAX_QBLOCK") == kgd.WIRE_MAX_QBLOCK
    assert _constant(TEXT, "WIRE_KERNELS") == kgd.WIRE_KERNELS
    assert _constant(TEXT, "HEADER") == kgd.FOLD_HEADER
    assert STACK == kgd.FOLD_STACK
    for name in ("S_LOAD", "S_FOLD_L", "S_COMB", "S_COMB_SWAP", "S_QDQ",
                 "S_WADD", "S_STORE"):
        assert _constant(TEXT, name) == getattr(kgd, name), name
    # select_wire's instances, in wire_kernel's numbering
    inst = re.findall(r"case (\d+): return \(const void\*\)"
                      r"gen_wire_fold_kernel<Q_(INT8|FP8), (\d+)>", TEXT)
    assert len(inst) == 8
    for case, q, vals in inst:
        qblock = 32 * int(vals)
        assert kgd.wire_kernel(q.lower(), qblock) == \
            kgd.WIRE_KERNELS + int(case)
    assert _constant(TEXT, "WIRE_THREADS") == kgd.WIRE_THREADS


def slots(vals, vec):
    """(WARP, vals) element offsets in the group of each lane's slots."""
    lane = torch.arange(WARP)[:, None]
    s = torch.arange(vals)[None, :]
    return 128 * (s // 4) + 4 * lane + s % 4 if vec else WARP * s + lane


def qdq(top, live, qmode):
    """The kernel's QDQ on a warp's (WARP, vals) values: the absmax of the
    live ones, their scale, then every value quantized and decoded."""
    m = top.abs().masked_fill(~live, 0).max()
    inv = torch.ones(()) / torch.full((), kgd.QMAX[qmode])
    scale = m * inv if m > 0 else torch.ones(())
    scaled = top / scale
    if qmode == "int8":
        q = scaled.round().clamp(-127.0, 127.0).to(torch.int8)
    else:
        q = scaled.clamp(-448.0, 448.0).to(torch.float8_e4m3fn)
    return q.float() * scale


def wire_model(srcs, dsts, plan, op, offsets=None, ctas=2, threads=64,
               part=None):
    """The kernel on CPU tensors, group by group in the order each warp
    takes them: loads of up to WIRE_LEAVES leaves, the steps that take
    them, then the trailing steps with the stores. Returns (written per
    element of every dst, groups on the vector path, groups). *part*: the
    launch's groups (glo, ghi), else all of them."""
    fp = kgd.fold_plan(plan)
    n, count = plan.n, plan.count
    vals = next(v for v in (1, 2, 4, 8) if WARP * v >= fp.qblock)
    offsets = offsets or [0] * (2 * n)
    mis = offsets[0] % 16
    aligned = all(o % 16 == mis for o in offsets) and mis % 4 == 0
    head = min(count, (16 - mis) % 16 // 4)
    groups = -(-fp.unit // fp.qblock)
    total = count // fp.unit * groups
    warps = ctas * threads // WARP
    acc = kgd.accumulate(op if op in kc.OPS else ReductionOp.SUM)
    avg = plan.reducing and op == ReductionOp.AVG
    alpha = kgd.avg_factor(torch.float32, n)
    written = torch.zeros(n, count, dtype=torch.int64)
    read = torch.zeros(n, count, dtype=torch.int64)
    on_vectors = 0
    glo, ghi = part or (0, total)
    for w in range(warps):
        for g in range(glo + w, ghi, warps):
            q, k = divmod(g, groups)
            e0 = q * fp.unit + k * fp.qblock
            length = min(fp.qblock, fp.unit - k * fp.qblock)
            vec = vals % 4 == 0 and aligned and (e0 - head) % 4 == 0 and \
                length % 4 == 0
            on_vectors += vec
            idx = slots(vals, vec)
            live = idx < length
            at = e0 + idx[live]

            def load(r):
                assert not written[r, at].any() or dsts[r] is not srcs[r]
                read[r, at] += 1
                x = torch.zeros(WARP, vals)
                x[live] = srcs[r][at]
                return x

            leaves, kinds = fp.program(q)
            stores = iter(fp.stores(q))
            top, below, kk = None, [], 0

            def step(kind):
                nonlocal top
                if kind == kgd.S_QDQ:
                    top = qdq(top, live, fp.qmode)
                elif kind == kgd.S_STORE:
                    r = next(stores)
                    v = top * alpha if avg else top
                    dsts[r][at] = v[live]
                    written[r, at] += 1
                else:
                    b = below.pop()
                    f = acc if kind in (kgd.S_COMB, kgd.S_COMB_SWAP) \
                        else torch.add
                    top = f(b, top) if kind in (kgd.S_COMB, kgd.S_WADD) \
                        else f(top, b)

            for base in range(0, len(leaves), WIRE_LEAVES):
                xs = [load(r) for r in leaves[base:base + WIRE_LEAVES]]
                for x in xs:
                    while kinds[kk] >= kgd.S_COMB:
                        step(kinds[kk])
                        kk += 1
                    kind = kinds[kk]
                    kk += 1
                    if kind == kgd.S_LOAD:
                        if kk > 1:
                            below.append(top)
                            assert len(below) <= STACK - 1
                        top = x
                    elif kind == kgd.S_FOLD_L:
                        top = acc(x, top)
                    else:
                        top = acc(top, x)
            for kind in kinds[kk:]:
                step(kind)
            assert not below
    # each group read only its own elements, each leaf's once
    assert read.max() <= 1
    return written, on_vectors, total


def check_model(plan, op, inplace=False, **kw):
    n = plan.n
    srcs = make_srcs(n, plan.count, plan.count + n)
    want = kgd.gen_device_ref(srcs, plan, op)
    if inplace:
        dsts = srcs = [s.clone() for s in srcs]
    else:
        dsts = [torch.full_like(s, 7) for s in srcs]
    written, vec, total = wire_model(srcs, dsts, plan, op, **kw)
    assert torch.equal(written, torch.ones_like(written))
    for r, (d, w) in enumerate(zip(dsts, want)):
        assert same_bits(d, w), r
    return vec, total


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("qmode", ["int8", "fp8"])
def test_walk_writes_every_element_once_bitwise(n, qmode):
    """Every wiring and grid, grids from one warp to more warps than
    groups, SUM and AVG turning."""
    launch = [(1, 32), (2, 64), (3, 256)]
    for i, which in enumerate(WIRINGS):
        for k, (qblock, ce) in enumerate(GRIDS):
            plan = wire_plan(n, qmode, which, qblock, ce)
            ctas, threads = launch[(i + k) % 3]
            op = (ReductionOp.SUM, ReductionOp.AVG)[(i + k + n) % 2]
            check_model(plan, op, ctas=ctas, threads=threads)


#: byte offsets mod 16 of the 2n pointers (n srcs, then n dsts): views
#: with a storage offset
OFFSETS = {
    "aligned": lambda r, n: 0,
    "all +1": lambda r, n: 4,
    "some srcs +1": lambda r, n: 4 * (r % 2 if r < n else 0),
    "dsts +2": lambda r, n: 8 * (r >= n),
}


@pytest.mark.parametrize("kind", list(OFFSETS))
@pytest.mark.parametrize("qblock,ce", [(256, 785), (128, 512), (128, 516)])
def test_walk_takes_vectors_where_the_pointers_allow(kind, qblock, ce):
    """Aligned pointers: the groups that start on a 16-byte boundary with
    whole vectors (all of them when units and groups are multiples of 4);
    every pointer at +1 element: those whose first element e0 has e0 - 3
    a multiple of 4; mixed offsets: none. Bitwise all the same."""
    n = 4
    plan = wire_plan(n, "int8", "both", qblock, ce)
    offsets = [OFFSETS[kind](r, n) for r in range(2 * n)]
    vec, total = check_model(plan, ReductionOp.SUM, offsets=offsets)
    if kind in ("aligned", "all +1"):
        head = 0 if kind == "aligned" else 3
        starts = [q * ce + k * qblock for q in range(n)
                  for k in range(-(-ce // qblock))
                  if min(qblock, ce - k * qblock) % 4 == 0]
        assert vec == sum((e - head) % 4 == 0 for e in starts)
        if kind == "aligned" and ce % 4 == 0:
            assert vec == total
        if kind == "all +1" and ce == 785:    # units 3 and 7 start at 3 mod 4
            assert vec > 0
    else:
        assert vec == 0


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("which", WIRINGS)
def test_walk_in_place(n, which):
    """dsts are the srcs: a group reads every leaf before its first store
    and groups never share an element, so the result is the plain
    version's."""
    plan = wire_plan(n, "fp8" if n == 4 else "int8", which, 32, 40)
    check_model(plan, ReductionOp.AVG, inplace=True, ctas=1, threads=64)


def test_wrappers_on_cpu_run_the_plain_version():
    """CPU tensors: the plain plan, no launch on any route."""
    n = 4
    for qblock, ce in ((32, 40), (512, 600)):
        plan = wire_plan(n, "int8", "both", qblock, ce)
        srcs = make_srcs(n, plan.count, 9)
        dsts = [torch.empty_like(s) for s in srcs]
        w = kgd.gen_device_gen
        before = (w.launches, w.fold_launches)
        w(srcs, dsts, ReductionOp.SUM, plan=plan).wait()
        assert (w.launches, w.fold_launches) == before
        want = kgd.gen_device_ref(srcs, plan, ReductionOp.SUM)
        assert all(same_bits(d, x) for d, x in zip(dsts, want))


def test_wire_kernel_numbers():
    """Values a lane: 1 up to qblock 32, 2 to 64, 4 to 128, 8 to 256."""
    for qblock, vals in ((1, 1), (32, 1), (33, 2), (64, 2), (65, 4),
                         (128, 4), (129, 8), (256, 8)):
        for qmode in ("int8", "fp8"):
            k = kgd.wire_kernel(qmode, qblock) - kgd.WIRE_KERNELS
            assert k == 4 * (kgd.QMODES[qmode] - 1) + vals.bit_length() - 1


# ---------------------------------------------------------------------------
# the kernel's arithmetic: the int8 rounding
# ---------------------------------------------------------------------------

def test_int8_rounding_is_rintf_through_an_integer():
    """(s + 1.5·2^23) - 1.5·2^23 in float32, clipped by fmaxf/fminf, is
    bitwise the float of the int8 that rintf then the clip give, for halves,
    integers, values around ±2^22 and ±2^23, huge values, infinities, NaN
    and both zeros."""
    rng = np.random.default_rng(7)
    s = np.concatenate([
        np.arange(-300, 300, 0.25), rng.uniform(-130, 130, 20000),
        rng.uniform(-1, 1, 2000),
        np.float32(2.0 ** 22) + np.arange(-8, 8, 0.5),
        -np.float32(2.0 ** 22) + np.arange(-8, 8, 0.5),
        [2.0 ** 23, -2.0 ** 23, 2.0 ** 24 + 2, -2.0 ** 30, 3e38, -3e38,
         np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-45, -1e-45]]).astype(
             np.float32)
    m = np.float32(12582912.0)
    magic = np.fmin(np.fmax((s + m) - m, np.float32(-127)),
                    np.float32(127))
    with np.errstate(invalid="ignore"):
        clipped = np.fmin(np.fmax(np.rint(s), np.float32(-127)),
                          np.float32(127))
        want = clipped.astype(np.int32).astype(np.int8).astype(np.float32)
    assert magic.dtype == np.float32
    assert np.array_equal(magic.view(np.uint32), want.view(np.uint32))
