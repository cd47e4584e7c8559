"""The generated device collectives (kernels/gen_device.py) by part, as
the processes of a device team that spans processes launch them
(``part=(p, P)``, ``part_walk``), in one process on the plain versions.

- For every program family that the device lowering registers (``ring_c*``,
  ``rhd_r*``, ``bc_kn_r2``, ``bc_linear``, ``bc_chain_c2``, the ``qint8``
  and ``qfp8`` direct exchanges) at n in {2, 3, 4, 8}, and for edge-wired
  direct exchanges on the wire fold (qblock 32) and on the layer kernel
  (qblock 512, a unit of 40 elements, no multiple of it): for P in {1, 2,
  3, 4}, at counts that are no multiple of the 16-byte vector and counts
  below P, out of place and in place (the parts applied one after the
  other on the same buffers, as the processes' launches write them), the
  union of the P parts is bitwise the single call, and every element
  outside a part keeps its value (tolerance: none).
- The parts' walks: the fold route cut at multiples of the vector, the
  wire fold at whole qblock groups (a group never split between parts),
  the layer kernel whole in part 0 and empty in the others; each covers
  the walk once.
- At small shapes the union is bitwise the JAX package's
  ``_build_pallas_device_program`` in interpret mode on the same numpy
  inputs, made from a seed.
- The ``xla`` backend (``gen_device_torch_ops``) with the dsts of the
  ranks another process holds left out writes the others whole, bitwise
  the call over every dst.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import torch_gen_span as gs  # noqa: E402
from torch_procs import wire_direct  # noqa: E402
from test_torch_gen_device import inputs, jax_prog, run_jax  # noqa: E402
from ucc_tpu.constants import CollType as JCollType  # noqa: E402
from ucc_tpu.dsl.ir import ProgramBuilder as JProgramBuilder  # noqa: E402

import ucc_tpu_torch as ut  # noqa: E402
from ucc_tpu_torch.dsl import lower_device as ld  # noqa: E402
from ucc_tpu_torch.dsl import registry as reg  # noqa: E402
from ucc_tpu_torch.kernels import gen_device as kgd  # noqa: E402
from ucc_tpu_torch.kernels import ring_common as kc  # noqa: E402
from ucc_tpu_torch.status import UccError  # noqa: E402
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy  # noqa: E402

PARTS = (1, 2, 3, 4)
NS = (2, 3, 4, 8)


def _registered():
    """(n, program name) of every registered device program, the fp8
    direct exchange beside the int8 one."""
    out = []
    for n in NS:
        names = [p.name for p in ld.device_programs(n, "int8")]
        names += [p.name for p in ld.device_programs(n, "fp8")
                  if p.name not in names]
        out += [(n, name) for name in names]
    return out


def _program(n, name):
    return next(p for p in ld.device_programs(
        n, "fp8" if "qfp8" in name else "int8") if p.name == name)


def _case_id(case):
    n, name, mult, inplace = case
    return f"n{n}-{name[4:]}-x{mult}-{'in' if inplace else 'out'}"


#: (n, program, count in chunks, in place): one chunk a rank (a count below
#: P for every one-chunk program) and 37 (no multiple of a vector)
CASES = [(n, name, mult, inplace) for n, name in _registered()
         for mult in (1, 37) for inplace in (False, True)]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_parts_union_is_the_single_call(case):
    n, name, mult, inplace = case
    prog = _program(n, name)
    count = prog.nchunks * mult
    root = n - 1 if prog.coll == ut.CollType.BCAST else 0
    qmode = prog.wire or prog.edge_wire_mode
    plan = ld.device_plan(prog, n, count, root, 256, qmode)
    # 16-bit values put 8 elements in a vector; the quantized programs
    # take float32
    dt = "f32" if qmode or mult == 1 else "bf16"
    op = None if prog.coll == ut.CollType.BCAST else (
        ut.ReductionOp.AVG if inplace else ut.ReductionOp.SUM)
    srcs = [from_numpy(a, "cpu") for a in inputs(n, count, dt, seed=count)]
    checked = gs.check_parts(plan, srcs, op, PARTS, inplace)
    assert checked == sum(PARTS)


#: edge-wired direct exchanges: (n, reduce-round wire, gather-round wire,
#: qblock, the route): qblock 32 on 40-element chunks folds (wire fold,
#: two groups a unit, the second partial); qblock 512 keeps the layer
#: kernel
WIRE_CASES = [(2, "int8", "int8", 32, "wire fold"),
              (4, "fp8", "fp8", 32, "wire fold"),
              (8, "int8", "", 32, "wire fold"),
              (4, "", "int8", 32, "wire fold"),
              (2, "fp8", "fp8", 512, "layer"),
              (4, "int8", "int8", 512, "layer"),
              (8, "int8", "int8", 512, "layer")]


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("n,rs,ag,qblock,route", WIRE_CASES)
def test_wire_parts_union_is_the_single_call(n, rs, ag, qblock, route,
                                             inplace):
    prog = wire_direct(n, rs, ag)
    qmode = rs or ag
    count = n * 40
    plan = ld.device_plan(prog, n, count, 0, qblock, qmode)
    assert gs.route(plan) == route
    srcs = [from_numpy(a, "cpu") for a in inputs(n, count, "f32",
                                                  seed=n + qblock)]
    op = ut.ReductionOp.AVG if inplace else ut.ReductionOp.SUM
    gs.check_parts(plan, srcs, op, PARTS, inplace)


@pytest.mark.parametrize("count", [1, 3, 4, 37, 100, 4096 + 3])
def test_fold_walks_cut_at_vectors(count):
    n = 4
    prog = reg.build_program("bc_kn", 2, n)          # one chunk: any count
    plan = ld.device_plan(prog, n, count, 3)
    assert gs.route(plan) == "fold"
    for nparts in PARTS:
        for elem in (4, 2):
            walks = [kgd.part_walk(plan, (p, nparts), elem)
                     for p in range(nparts)]
            assert [w[:2] for w in walks] == [w[2:] for w in walks]
            assert [w[:2] for w in walks] == [
                kc.part_bounds(count, (p, nparts), elem)
                for p in range(nparts)]
            assert walks[0][0] == 0 and walks[-1][1] == count
            for a, b in zip(walks, walks[1:]):
                assert a[1] == b[0]
            for lo, hi, _, _ in walks:
                assert lo == hi or lo % (16 // elem) == 0 or lo == count


@pytest.mark.parametrize("n,unit_chunks", [(2, 1), (4, 2), (8, 1)])
def test_wire_walks_take_whole_groups(n, unit_chunks):
    """Each part is a range of whole qblock groups in element order: its
    element bounds are group starts, the parts cover the groups once."""
    prog = wire_direct(n, "int8", "int8")
    count = n * 40 * unit_chunks
    plan = ld.device_plan(prog, n, count, 0, 32, "int8")
    fp = kgd.fold_plan(plan)
    assert fp.qmode == "int8" and fp.unit % fp.qblock
    groups = count // fp.unit * -(-fp.unit // fp.qblock)
    starts = {q * fp.unit + k * fp.qblock
              for q in range(count // fp.unit)
              for k in range(-(-fp.unit // fp.qblock))} | {count}
    for nparts in PARTS:
        walks = [kgd.part_walk(plan, (p, nparts), 4) for p in range(nparts)]
        assert walks[0][0] == walks[0][2] == 0
        assert walks[-1][1] == groups and walks[-1][3] == count
        for a, b in zip(walks, walks[1:]):
            assert a[1] == b[0] and a[3] == b[2]
        for glo, ghi, elo, ehi in walks:
            assert elo in starts and ehi in starts
            assert ghi - glo in (groups // nparts, -(-groups // nparts))


def test_layer_walk_is_whole_in_part_0():
    n = 4
    prog = wire_direct(n, "int8", "int8")
    plan = ld.device_plan(prog, n, n * 40, 0, 512, "int8")
    assert kgd.fold_plan(plan) is None
    for nparts in PARTS:
        walks = [kgd.part_walk(plan, (p, nparts), 4) for p in range(nparts)]
        assert walks[0] == (0, n * 40, 0, n * 40)
        assert all(w == (0, 0, 0, 0) for w in walks[1:])
    with pytest.raises(UccError):
        kgd.part_walk(plan, (4, 4), 4)


#: (family, param, n, op, root, in place, P, wire qblock or None): the
#: union of the parts bitwise the Pallas kernel in interpret mode
PALLAS_CASES = [("ring", 2, 4, "SUM", 0, False, 3, None),
                ("rhd", 2, 4, "AVG", 0, True, 4, None),
                ("bc_kn", 2, 4, None, 3, True, 2, None),
                ("wdirect", 0, 4, "SUM", 0, False, 3, 32),
                ("wdirect", 0, 2, "SUM", 0, False, 2, 512)]


@pytest.mark.parametrize("family,param,n,op,root,inplace,nparts,qblock",
                         PALLAS_CASES)
def test_parts_union_matches_the_pallas_kernel(family, param, n, op, root,
                                               inplace, nparts, qblock):
    if family == "wdirect":
        jp = wire_direct(n, "int8", "int8", JProgramBuilder, JCollType)
        p = wire_direct(n, "int8", "int8")
        count, qmode = n * 40, "int8"
    else:
        jp, p = jax_prog(family, param, n), reg.build_program(family,
                                                              param, n)
        count, qmode, qblock = p.nchunks * 37, "", 256
    arrs = inputs(n, count, "f32", seed=7 * n + nparts)
    want = run_jax(jp, n, arrs, op or "SUM", root, "pallas", qblock, qmode)
    plan = ld.device_plan(p, n, count, root, qblock, qmode)
    srcs = [from_numpy(a, "cpu") for a in arrs]
    got = gs.union(plan, srcs, ut.ReductionOp[op or "SUM"], nparts,
                   inplace)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g).view(np.uint32),
                                      np.asarray(w).view(np.uint32))


@pytest.mark.parametrize("family,param,root", [("rhd", 2, 0),
                                               ("bc_chain", 2, 2)])
def test_torch_ops_backend_writes_the_dsts_given(family, param, root):
    """A process of a spanning team on the ``xla`` backend: the dsts of
    its peers' ranks are None, its own get the whole result."""
    n = 4
    prog = reg.build_program(family, param, n)
    count = prog.nchunks * 37
    plan = ld.device_plan(prog, n, count, root)
    srcs = [from_numpy(a, "cpu") for a in inputs(n, count, "f32", seed=5)]
    op = None if prog.coll == ut.CollType.BCAST else ut.ReductionOp.SUM
    full = [torch.empty_like(s) for s in srcs]
    kgd.gen_device_torch_ops(srcs, full, op, plan=plan)
    for mine in ([0, 1], [2, 3]):
        dsts = [torch.full_like(s, 7.0) if r in mine else None
                for r, s in enumerate(srcs)]
        kgd.gen_device_torch_ops(srcs, dsts, op, plan=plan,
                                 part=(mine[0] // 2, 2))
        for r in mine:
            assert torch.equal(dsts[r].view(torch.int32),
                               full[r].view(torch.int32))


# ---------------------------------------------------------------------------
# the kernels' walks by part (the CPU models of gen_fold.cu and of the wire
# fold, tests/test_torch_gen_fold.py and tests/test_torch_gen_wire_fold.py)
# ---------------------------------------------------------------------------

#: byte offsets mod 16 of the 2n pointers: all aligned, or some srcs one
#: element off (the scalar path)
POINTERS = {"aligned": lambda r, n, elem: 0,
            "some srcs +1": lambda r, n, elem: elem * (r % 2 if r < n
                                                       else 0)}


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("pointers", list(POINTERS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("name", ["gen_ring_c2", "gen_rhd_r2",
                                  "gen_bc_kn_r2", "gen_qint8_direct"])
def test_fold_kernel_walk_by_part(name, dtype, pointers, inplace):
    """The fold kernel's part instance (vector_part's vectors, the elements
    before and after them one at a time) over the parts of P in {1, 2, 3,
    4}, one launch after the other on the same buffers: every element of
    every dst written once over the parts (an in-place bcast root's
    never), the result bitwise the plain version."""
    import test_torch_gen_fold as tgf
    n = 4
    prog = _program(n, name)
    count = prog.nchunks * 37
    root = n - 1
    plan = ld.device_plan(prog, n, count, root)
    op = None if prog.coll == ut.CollType.BCAST else ut.ReductionOp.SUM
    srcs = tgf.make_srcs(n, count, dtype, op, seed=count + n)
    want = kgd.gen_device_ref(srcs, plan, op)
    elem = srcs[0].element_size()
    offsets = [POINTERS[pointers](r, n, elem) % 16 for r in range(2 * n)]
    skipped = inplace and not plan.reducing
    for nparts in PARTS:
        ins = [s.clone() for s in srcs]
        dsts = ins if inplace else [torch.full_like(s, 7) for s in srcs]
        written = torch.zeros(n, count, dtype=torch.int64)
        for p in range(nparts):
            lo, hi, _, _ = kgd.part_walk(plan, (p, nparts), elem)
            written += tgf.model(ins, dsts, plan, op, offsets, ctas=2,
                                 threads=3, part=(lo, hi))
        for r in range(n):
            assert torch.equal(written[r], torch.full_like(
                written[r], 0 if skipped and r == root else 1)), (nparts, r)
            assert tgf.same_bits(dsts[r], want[r]), (nparts, r)


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("n,qblock,ce", [(2, 32, 40), (4, 8, 40),
                                         (4, 37, 100), (8, 32, 40)])
def test_wire_kernel_walk_by_part(n, qblock, ce, inplace):
    """The wire fold's walk over the groups [glo, ghi) of each part, one
    launch after the other: every element written once, bitwise the plain
    version."""
    import test_torch_gen_wire_fold as twf
    plan = ld.device_plan(wire_direct(n, "int8", "int8"), n, n * ce, 0,
                          qblock, "int8")
    assert gs.route(plan) == "wire fold"
    srcs = twf.make_srcs(n, plan.count, n * ce + qblock)
    want = kgd.gen_device_ref(srcs, plan, ut.ReductionOp.SUM)
    for nparts in PARTS:
        ins = [s.clone() for s in srcs]
        dsts = ins if inplace else [torch.full_like(s, 7) for s in srcs]
        written = torch.zeros(n, plan.count, dtype=torch.int64)
        for p in range(nparts):
            glo, ghi, _, _ = kgd.part_walk(plan, (p, nparts), 4)
            written += twf.wire_model(ins, dsts, plan, ut.ReductionOp.SUM,
                                      ctas=1, threads=64,
                                      part=(glo, ghi))[0]
        assert torch.equal(written, torch.ones_like(written)), nparts
        for r in range(n):
            assert twf.same_bits(dsts[r], want[r]), (nparts, r)
