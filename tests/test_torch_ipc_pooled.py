"""The port's pooled tier (dsl/compile.py's one-sided window puts through
tl/ipc's arena) held against the JAX package's: the cases of its
tests/test_ipc.py:358-508.

``gen_pooled`` builds the reference's programs and the verifier refuses
the same hazards. On 4 in-process ranks over tl/ipc
(``UCC_TL_IPC_ENABLE=y``, one arena) both pooled variants register with
origin ``pooled``, run a SUM allreduce through the arena's windows
(``n_pooled`` and the window counters tick) and give the reference's
result bit for bit (tolerance: none; numpy within rtol 1e-5), also over
persistent re-posts and with a count that leaves a remainder, and
perftest's ``detail.transport`` then names the ``pooled`` tier. Without
an arena the pooled rows refuse with ERR_NOT_SUPPORTED on every rank.
"""
import numpy as np
import pytest

import ucc_tpu
import ucc_tpu_torch as ut
from ucc_tpu.dsl import families as jfam
from ucc_tpu_torch import native
from ucc_tpu_torch.constants import CollType
from ucc_tpu_torch.dsl import families as fam
from ucc_tpu_torch.dsl.ir import ProgramBuilder
from ucc_tpu_torch.dsl.verify import VerifyError, verify

from torch_gen_jobs import GenJob, case_inputs, floats, forced, same_bits

IPC = dict(UCC_TL_IPC_ENABLE="y", UCC_GEN_NATIVE="n")


def program_ops(prog):
    return [[[(int(o.kind), o.chunk, o.peer, o.slot, o.src_chunk, o.wire)
              for o in ops] for ops in rp.rounds] for rp in prog.ranks]


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_pooled_generator_verifies_as_the_reference(n):
    for chunks in (1, 2, 4):
        prog = fam.gen_pooled(n, chunks)
        verify(prog)
        want = jfam.gen_pooled(n, chunks)
        assert (prog.name, prog.param_str, prog.uses_windows) == \
            (want.name, want.param_str, want.uses_windows)
        assert program_ops(prog) == program_ops(want)


def test_pooled_verifier_rejects_hazards():
    b = ProgramBuilder("pooled", CollType.BCAST, nranks=3, nchunks=1)
    b.next_round()
    b.put(0, 0, to=2)
    b.put(1, 0, to=2)
    with pytest.raises(VerifyError):
        verify(b.build("bad_double_put"))
    b = ProgramBuilder("pooled", CollType.BCAST, nranks=3, nchunks=1)
    b.next_round()
    b.put(0, 0, to=2)
    b.send(1, 0, to=2)
    b.recv(2, 0, frm=1)
    with pytest.raises(VerifyError):
        verify(b.build("bad_put_recv_mix"))
    b = ProgramBuilder("pooled", CollType.ALLREDUCE, nranks=2, nchunks=1,
                       wire="f16")
    b.next_round()
    b.put_red(0, 0, to=1)
    b.put_red(1, 0, to=0)
    with pytest.raises(VerifyError):
        verify(b.build("bad_wire_put"))


@pytest.fixture(scope="module")
def ipc_pair():
    if not native.available():
        pytest.skip("native core unavailable (tl/ipc has no Python arena)")
    jj = GenJob(ucc_tpu, 4, tls="ipc,self", **IPC)
    pj = GenJob(ut, 4, tls="ipc,self", **IPC)
    yield jj, pj
    jj.destroy()
    pj.destroy()


def pooled_names(job):
    cands = job.team(4)[0].score_map.lookup(
        job.mod.CollType.ALLREDUCE, job.mod.constants.MemoryType.HOST,
        4096)
    return sorted({c.alg_name for c in cands if c.origin == "pooled"})


@pytest.mark.parametrize("count,seed,rounds", [
    (1024, 100, 1), (1027, 101, 1), (4096, 102, 3)])
def test_pooled_allreduce_forced(ipc_pair, count, seed, rounds):
    jj, pj = ipc_pair
    names = pooled_names(pj)
    assert names == pooled_names(jj) == ["gen_pooled_c1", "gen_pooled_c2"]
    assert pj.info(4) == jj.info(4)
    team = pj.team(4)[0]
    tr = team.score_map.lookup(CollType.ALLREDUCE, ut.MemoryType.HOST,
                               4096)[0].team.transport
    arena = tr.arena
    case = {"coll": "ALLREDUCE", "c": count, "dt": "FLOAT32", "op": "SUM",
            "seed": seed, "rounds": rounds}
    srcs, _, _ = case_inputs(case, 4)
    exact = np.sum(np.stack(srcs).astype(np.float64), axis=0)
    for name in names:
        before, w0 = tr.n_pooled, arena.counters()["windows"]
        got = forced(pj, case, 4, name, comp="ipc")
        same_bits(got, forced(jj, case, 4, name, comp="ipc"), name)
        for rr in got:
            np.testing.assert_allclose(floats(rr), exact, rtol=1e-5,
                                       atol=1e-5)
        # the data path was the window tier
        assert tr.n_pooled > before
        ctr = arena.counters()
        assert ctr["windows"] >= w0 and ctr["windows"] > 0
        assert ctr["window_bytes"] > 0
    # perftest's detail.transport names the tier, as the reference's does
    from ucc_tpu.tools import perftest as jperf
    from ucc_tpu_torch.tools import perftest
    assert perftest.transport_tier(team) == \
        jperf.transport_tier(jj.team(4)[0]) == "pooled"


def test_pooled_rows_go_with_pool_enable_n():
    if not native.available():
        pytest.skip("native core unavailable")
    pj = GenJob(ut, 2, tls="ipc,self", UCC_POOL_ENABLE="n", **IPC)
    jj = GenJob(ucc_tpu, 2, tls="ipc,self", UCC_POOL_ENABLE="n", **IPC)
    try:
        assert pj.info(2) == jj.info(2)
        assert not any("gen_pooled" in ln for ln in pj.info(2))
    finally:
        pj.destroy()
        jj.destroy()


def test_pooled_needs_arena():
    """Without an arena under the team a pooled row refuses at init with
    ERR_NOT_SUPPORTED on every rank (the fallback walk goes on)."""
    pj = GenJob(ut, 2, UCC_GEN_NATIVE="n")
    jj = GenJob(ucc_tpu, 2, UCC_GEN_NATIVE="n")
    try:
        case = {"coll": "ALLREDUCE", "c": 256, "dt": "FLOAT32",
                "op": "SUM", "seed": 1}
        got = forced(pj, case, 2, "gen_pooled_c1")
        assert got == forced(jj, case, 2, "gen_pooled_c1")
        assert {g[0] for g in got} == {"init ERR_NOT_SUPPORTED"}
        # and the team's tag counters stayed in step: the next forced
        # collective completes
        got = forced(pj, case, 2, "gen_ring_c1")
        same_bits(got, forced(jj, case, 2, "gen_ring_c1"), "gen_ring_c1")
    finally:
        pj.destroy()
        jj.destroy()
