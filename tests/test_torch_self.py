"""tl/self, the port's loopback TL for 1-rank teams, against the JAX
package's tl/self: every collective type on a 1-rank team, on HOST memory
(numpy buffers in both) and on device memory (CPU tensors as CUDA memory
in the port, device arrays as TPU memory in the reference, whose tl/self
rebinds dst), in place and out of place, every result bitwise the
reference's. Then the 1-rank team's service team, the scores, and the
README's quick start translated to the port."""
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import ucc_tpu  # noqa: E402
import ucc_tpu_torch as ut  # noqa: E402
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy  # noqa: E402

V_SRC = ("ALLTOALLV", "SCATTERV")
V_DST = ("ALLGATHERV", "GATHERV", "REDUCE_SCATTERV", "ALLTOALLV")
NO_BUFFERS = ("BARRIER", "FANIN", "FANOUT")
COUNT = 6


@pytest.fixture(scope="module")
def teams():
    """(reference 1-rank team, port 1-rank team on device "cpu")."""
    jctx = ucc_tpu.Context(ucc_tpu.init())
    jteam = jctx.create_team(ucc_tpu.TeamParams())
    mp = pytest.MonkeyPatch()
    mp.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    tctx = ut.Context(ut.init())
    tteam = tctx.create_team(ut.TeamParams())
    mp.undo()
    yield jteam, tteam
    tteam.destroy()
    tctx.destroy()
    jteam.destroy()
    jctx.destroy()


def _bi(pkg, coll, side, buf, dt, mem):
    if buf is None:
        return None
    v = coll in (V_SRC if side == "src" else V_DST)
    if v:
        return pkg.BufferInfoV(buf, [COUNT], [0], dt, mem_type=mem)
    return pkg.BufferInfo(buf, COUNT, dt, mem_type=mem)


def run(pkg, team, coll, src, dst, dt, mem, inplace):
    args = pkg.CollArgs(
        coll_type=pkg.CollType[coll], op=pkg.ReductionOp.SUM, root=0,
        src=_bi(pkg, coll, "src", src, dt, mem),
        dst=_bi(pkg, coll, "dst", dst, dt, mem),
        flags=pkg.CollArgsFlags.IN_PLACE if inplace
        else pkg.CollArgsFlags(0))
    req = team.collective_init(args)
    assert req.task.alg_name == "self"
    req.post()
    assert req.wait() == pkg.Status.OK
    req.finalize()
    return args


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("mem", ["HOST", "DEVICE"])
@pytest.mark.parametrize("coll", [c.name for c in ut.CollType])
def test_self_matches_the_reference(teams, coll, mem, inplace):
    jteam, tteam = teams
    rng = np.random.default_rng(sum(map(ord, coll + mem)))
    src = rng.standard_normal(COUNT).astype(np.float32)
    dst = np.full(COUNT, 7, np.float32)
    if coll in NO_BUFFERS:
        srcs = dsts = None
    elif coll == "BCAST" or inplace:
        srcs, dsts = (src, None) if coll == "BCAST" else (None, src)
    else:
        srcs, dsts = src, dst
    if mem == "HOST":
        jargs = run(ucc_tpu, jteam, coll,
                    None if srcs is None else srcs.copy(),
                    None if dsts is None else dsts.copy(),
                    ucc_tpu.DataType.FLOAT32, ucc_tpu.MemoryType.HOST,
                    inplace)
        targs = run(ut, tteam, coll,
                    None if srcs is None else srcs.copy(),
                    None if dsts is None else dsts.copy(),
                    ut.DataType.FLOAT32, ut.MemoryType.HOST, inplace)
        to_np = np.asarray
    else:
        jargs = run(ucc_tpu, jteam, coll,
                    None if srcs is None else jax.numpy.asarray(srcs),
                    None if dsts is None else jax.numpy.asarray(dsts),
                    ucc_tpu.DataType.FLOAT32, ucc_tpu.MemoryType.TPU,
                    inplace)
        targs = run(ut, tteam, coll,
                    None if srcs is None else from_numpy(srcs, "cpu"),
                    None if dsts is None else from_numpy(dsts, "cpu"),
                    ut.DataType.FLOAT32, ut.MemoryType.CUDA, inplace)
        to_np = to_numpy
    for side in ("src", "dst"):
        jbi, tbi = getattr(jargs, side), getattr(targs, side)
        assert (jbi is None) == (tbi is None)
        if jbi is not None:
            w = np.asarray(jbi.buffer)
            g = to_np(tbi.buffer)
            np.testing.assert_array_equal(g.view(np.uint32),
                                          w.view(np.uint32))
    if srcs is not None and dsts is not None and not inplace:
        np.testing.assert_array_equal(to_np(targs.dst.buffer), src)


def test_host_copy_takes_the_shorter_buffer(teams):
    """The bytes of min(src, dst) elements, as the reference's binfo_u8
    copy: a dst of 4 elements takes the first 4 of a 6-element src, a dst
    of 8 keeps its last 2; CPU tensors and numpy arrays mix."""
    _, tteam = teams
    src = np.arange(1, 7, dtype=np.int32)
    for dcount, want in ((4, [1, 2, 3, 4]), (8, [1, 2, 3, 4, 5, 6, 9, 9])):
        dst = torch.full((dcount,), 9, dtype=torch.int32)
        req = tteam.collective_init(ut.CollArgs(
            coll_type=ut.CollType.ALLGATHER,
            src=ut.BufferInfo(src, 6, ut.DataType.INT32),
            dst=ut.BufferInfo(dst, dcount, ut.DataType.INT32)))
        req.post()
        assert req.wait() == ut.Status.OK
        assert dst.tolist() == want
        req.finalize()


def test_self_scores_and_service_team(teams):
    """Score 50 on HOST and CUDA memory for every collective type, above
    every other TL; the 1-rank team's service team is tl/self's, with the
    trivial service collectives, as in the reference."""
    from ucc_tpu.tl.self import TlSelf as JSelf
    from ucc_tpu_torch.tl.self import TlSelf
    jteam, tteam = teams
    assert TlSelf.DEFAULT_SCORE == JSelf.DEFAULT_SCORE == 50
    assert TlSelf.SERVICE_CAPABLE and JSelf.SERVICE_CAPABLE
    assert int(TlSelf.SUPPORTED_COLLS) == int(JSelf.SUPPORTED_COLLS)
    for coll in ut.CollType:
        for mem in (ut.MemoryType.HOST, ut.MemoryType.CUDA):
            best = tteam.score_map.lookup(coll, mem, 64)[0]
            assert (best.team.NAME, best.alg_name, best.score) == \
                ("self", "self", 50)
    svc, jsvc = tteam.service_team, jteam.service_team
    assert svc.NAME == jsvc.NAME == "self"
    assert tteam.id is not None
    arr = np.arange(3)
    for task in (svc.service_allreduce(arr, ut.ReductionOp.SUM),
                 svc.service_allgather(b"ab"), svc.service_bcast(b"cd")):
        task.post()
        assert task.super_status == ut.Status.OK
    assert svc.service_allreduce(arr, ut.ReductionOp.SUM).result.tolist() \
        == [0, 1, 2]
    assert svc.service_allgather(b"ab").result == [b"ab"]
    assert svc.service_bcast(None).result == b""


def test_self_refuses_larger_teams():
    from ucc_tpu_torch.tl.self import TlSelfTeam

    class Two:
        size, rank = 2, 0
    with pytest.raises(ut.UccError) as ei:
        TlSelfTeam(None, Two())
    assert ei.value.status == ut.Status.ERR_NOT_SUPPORTED


QUICK_START = """
import numpy as np, ucc_tpu_torch

lib  = ucc_tpu_torch.init()
ctx  = ucc_tpu_torch.Context(lib)                      # no OOB -> 1-rank world
team = ctx.create_team(ucc_tpu_torch.TeamParams())

src = np.arange(4, dtype=np.float32); dst = np.zeros_like(src)
req = team.collective_init(ucc_tpu_torch.CollArgs(
    coll_type=ucc_tpu_torch.CollType.ALLREDUCE,
    src=ucc_tpu_torch.BufferInfo(src, 4, ucc_tpu_torch.DataType.FLOAT32),
    dst=ucc_tpu_torch.BufferInfo(dst, 4, ucc_tpu_torch.DataType.FLOAT32),
    op=ucc_tpu_torch.ReductionOp.SUM))
req.post(); req.wait()
"""


def test_readme_quick_start_runs_in_the_port():
    """The README's quick start, with ucc_tpu_torch for ucc_tpu (the port's
    README section carries it), in a process that never imports JAX; the
    device TLs' contexts run on "cpu" here (there is no GPU)."""
    import os
    code = ("import sys; sys.modules['jax'] = None\n" + QUICK_START +
            "assert req.test() == ucc_tpu_torch.Status.OK\n"
            "assert req.task.alg_name == 'self'\n"
            "assert (dst == src).all()\nprint('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    readme = open(os.path.join(repo, "README.md")).read()
    assert QUICK_START.strip() in readme
    env = dict(os.environ, UCC_TL_RING_CUDA_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
