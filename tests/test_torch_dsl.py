"""The port's collective-program DSL (ucc_tpu_torch/dsl: ir, verify,
families, registry) against the JAX package's (ucc_tpu/dsl): every family
of the default grids (but ``hier``, which needs the topology tree) at every
grid parameter and team size 2..8 builds the same program, op for op; the
verifier refuses the same bad programs with the same message; the family
grammar accepts and refuses the same strings. Neither side touches a
program cache on disk: the reference's generators are called directly."""
import pytest

from ucc_tpu.constants import CollType as JCollType
from ucc_tpu.dsl import ProgramBuilder as JProgramBuilder
from ucc_tpu.dsl import VerifyError as JVerifyError
from ucc_tpu.dsl import families as jfam
from ucc_tpu.dsl import registry as jreg
from ucc_tpu.dsl import verify as jverify

from ucc_tpu_torch.constants import CollType
from ucc_tpu_torch.dsl import ProgramBuilder, VerifyError, verify
from ucc_tpu_torch.dsl import families as fam
from ucc_tpu_torch.dsl import registry as reg
from ucc_tpu_torch.dsl.ir import DSL_VERSION, OpKind

FAMILIES = [f for f in jfam.DEFAULT_GRIDS if f != "hier"]
NS = list(range(2, 9))


def jax_program(family, param, n, wire=""):
    """The reference's program (None when inapplicable), built as its
    registry builds it but without its disk cache."""
    pk = jreg._GRID_PARAM_KEY.get(family)
    try:
        prog = jreg._construct(family, {pk: param} if pk else {}, n, wire,
                               None)
        jverify(prog)
    except jfam.Inapplicable:
        return None
    return prog


def ops(prog):
    return [[[(int(op.kind), op.chunk, op.peer, op.slot, op.src_chunk,
               op.wire) for op in ops] for ops in rp.rounds]
            for rp in prog.ranks]


def same(got, want):
    if want is None:
        return got is None
    return (got is not None and got.name == want.name
            and got.param_str == want.param_str and got.wire == want.wire
            and got.edge_wire_mode == want.edge_wire_mode
            and int(got.coll) == int(want.coll)
            and got.nchunks == want.nchunks and got.nranks == want.nranks
            and ops(got) == ops(want))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("family", FAMILIES)
def test_family_programs_match_the_reference(family, n):
    wires = ["int8", "fp8"] if family == "qdirect" else [""]
    built = 0
    for param in jfam.DEFAULT_GRIDS[family]:
        for wire in wires:
            want = jax_program(family, param, n, wire)
            got = reg.build_program(family, param, n, wire=wire)
            assert same(got, want), (family, param, n, wire)
            built += want is not None
    assert built or family in ("rhd", "ag_rd", "pooled", "bc_kn")


def test_registry_caches_and_hier_is_inapplicable():
    assert reg.build_program("ring", 2, 4) is reg.build_program("ring", 2, 4)
    assert reg.build_program("hier", 2, 8) is None
    assert list(fam.DEFAULT_GRIDS) == list(jfam.DEFAULT_GRIDS)
    assert {k: int(v) for k, v in fam.FAMILY_COLL.items()} == \
        {k: int(v) for k, v in jfam.FAMILY_COLL.items()}
    assert fam.FAMILY_NAMES == jfam.FAMILY_NAMES
    assert DSL_VERSION == 3


# ---------------------------------------------------------------------------
# the verifier refuses what the reference's refuses, in the same words
# ---------------------------------------------------------------------------

def _bad(builder_cls, coll_ns, case):
    """One bad program per case, built with either package's builder
    (*coll_ns* names its CollType)."""
    AR, BC, AG = coll_ns.ALLREDUCE, coll_ns.BCAST, coll_ns.ALLGATHER
    if case == "unmatched_recv":
        b = builder_cls("x", AR, 2, 1)
        b.next_round()
        b.send(0, 0, to=1)
        b.reduce(1, 0, frm=0)
        b.reduce(0, 0, frm=1)
    elif case == "double_count":
        b = builder_cls("x", AR, 2, 1)
        b.next_round()
        b.send(0, 0, to=1)
        b.reduce(1, 0, frm=0)
        b.next_round()
        b.send(0, 0, to=1)
        b.reduce(1, 0, frm=0)
    elif case == "postcondition":
        b = builder_cls("x", AR, 2, 1)
        b.next_round()
        b.send(0, 0, to=1)
        b.reduce(1, 0, frm=0)
    elif case == "deadlock":
        # each rank first waits for what the other sends only after it
        b = builder_cls("x", AR, 2, 1)
        b.next_round()
        b.reduce(0, 0, frm=1, slot=5)
        b.reduce(1, 0, frm=0, slot=6)
        b.next_round()
        b.send(0, 0, to=1, slot=6)
        b.send(1, 0, to=0, slot=5)
    elif case == "reduce_in_bcast":
        b = builder_cls("x", BC, 2, 1)
        b.next_round()
        b.send(0, 0, to=1)
        b.reduce(1, 0, frm=0)
    elif case == "mixed_wire":
        b = builder_cls("x", AR, 2, 1)
        b.next_round()
        b.send(0, 0, to=1, wire="int8")
        b.reduce(1, 0, frm=0, wire="fp8")
    elif case == "allgather_undefined":
        b = builder_cls("x", AG, 2, 2)
        b.next_round()
    else:                                   # overwriting recv hazard
        b = builder_cls("x", AR, 3, 1)
        b.next_round()
        b.send(0, 0, to=2)
        b.send(1, 0, to=2)
        b.recv(2, 0, frm=0)
        b.recv(2, 0, frm=1)
    return b.build("x")


BAD = ["unmatched_recv", "double_count", "postcondition", "deadlock",
       "reduce_in_bcast", "mixed_wire", "allgather_undefined", "hazard"]


@pytest.mark.parametrize("case", BAD)
def test_verifier_refuses_with_the_reference_message(case):
    with pytest.raises(JVerifyError) as want:
        jverify(_bad(JProgramBuilder, JCollType, case))
    with pytest.raises(VerifyError) as got:
        verify(_bad(ProgramBuilder, CollType, case))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("call", [
    lambda B, C: B("x", C.ALLREDUCE, 0, 1),
    lambda B, C: B("x", C.ALLREDUCE, 2, 0),
    lambda B, C: B("x", C.ALLREDUCE, 2, 1).send(0, 0, to=1),
])
def test_builder_refuses_like_the_reference(call):
    with pytest.raises(ValueError) as want:
        call(JProgramBuilder, JCollType)
    with pytest.raises(ValueError) as got:
        call(ProgramBuilder, CollType)
    assert str(got.value) == str(want.value)


def test_self_send_refused():
    for B, C in ((JProgramBuilder, JCollType), (ProgramBuilder, CollType)):
        b = B("x", C.ALLREDUCE, 2, 1)
        b.next_round()
        with pytest.raises(ValueError, match="self-send"):
            b.send(1, 0, to=1)


# ---------------------------------------------------------------------------
# the family grammar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "", "ring", "ring(1,2,4),rhd(2,8),qdirect", " ring ( 2 ) , bc_kn(0)",
    "sra_pipe(2),ring(4,4)", "hier(2),pooled", "ring()", "nosuch(2)",
    "ring(1", "ring)1(", "ring(a)", "ring(1)x"])
def test_parse_families_matches_the_reference(spec):
    try:
        want = jreg.parse_families(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as ei:
            reg.parse_families(spec)
        assert str(ei.value) == str(e)
        return
    assert reg.parse_families(spec) == want


def test_op_kinds_and_describe_match():
    from ucc_tpu.dsl.ir import Op as JOp
    from ucc_tpu.dsl.ir import OpKind as JOpKind
    from ucc_tpu_torch.dsl.ir import Op
    assert [(k.name, int(k)) for k in OpKind] == \
        [(k.name, int(k)) for k in JOpKind]
    for kind in OpKind:
        assert Op(kind, 3, 1, 7, 2, "int8").describe() == \
            JOp(JOpKind(int(kind)), 3, 1, 7, 2, "int8").describe()
