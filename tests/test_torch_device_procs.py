"""Device teams across processes (tl/device, tl/device_sync): 2 processes
x 2 ranks over ``TcpStoreOob``, device ``cpu`` (the CPU stand-in of CUDA
IPC: each process stages its ranks' buffers in files its peer maps, and
runs part p of P of every round), CUDA memory, held against the port's
in-process 4-rank team and against the JAX package.

- Mode ``flat`` on tl/torch_ops's default ``xla``: the six collectives of
  tests/test_xla_multiprocess.py, on its inputs, at count 32 (allreduce,
  gather root 1, scatter root 2, allgatherv, bcast root 3, alltoallv of
  uneven counts): each equals that test's expected value, is bitwise the
  in-process team's, and is within the reference's tolerance of tl/xla on
  4 virtual CPU devices in this process.
- Mode ``ring_cuda`` (TUNE-pinned, ``UCC_TL_RING_CUDA_TUNE``): allreduce,
  reduce_scatter, allgather, bcast root 3 and alltoall, each at a size of
  the one-pass kernel and of the chunked one, bitwise the in-process
  team's.
- Persistent rounds on both TLs: 5 rounds, the buffers changed between
  rounds 3 and 4: after the first round, one descriptor send and no open.
- The workers import no JAX.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch_procs as tp  # noqa: E402
from torch_stack_cases import (Buf, jax_coll, make_jax_job,  # noqa: E402
                               make_torch_job, torch_coll)

from ucc_tpu_torch.tools.perftest import HeldPorts  # noqa: E402

N = 4
COUNT = 32
RING_TUNE = ("allreduce,reduce_scatter,allgather,bcast,alltoall:"
             "@ring_cuda:inf")

#: tests/test_xla_multiprocess.py's mode flat
FLAT = [("ALLREDUCE", 0, "SUM"), ("GATHER", 1, None), ("SCATTER", 2, None),
        ("ALLGATHERV", 0, None), ("BCAST", 3, None), ("ALLTOALLV", 0, None)]
FLAT_CASES = [{"coll": c, "dt": "FLOAT32", "c": COUNT, "root": root,
               "op": op, "values": "xla_mp", "mem": "CUDA"}
              for c, root, op in FLAT]
#: per-rank c of the one-pass and of the chunked kernel at n = 4 (the
#: chunked ones just above kernels' pass_elems, ragged against vectors)
RING_SIZES = {"ALLREDUCE": (37, (1 << 20) + 40),
              "REDUCE_SCATTER": (37, (1 << 18) + 9),
              "ALLGATHER": (37, (1 << 18) + 9),
              "BCAST": (37, (1 << 20) + 40),
              "ALLTOALL": (37, (1 << 18) + 9)}
RING_CASES = [{"coll": coll, "dt": "FLOAT32", "c": c, "mem": "CUDA",
               "seed": 70 + i, "root": 3 if coll == "BCAST" else 0,
               "op": "SUM" if coll in ("ALLREDUCE", "REDUCE_SCATTER")
               else None}
              for i, (coll, sizes) in enumerate(RING_SIZES.items())
              for c in sizes]
#: a persistent allreduce whose buffers change between rounds 3 and 4
PERSISTENT = {"coll": "ALLREDUCE", "dt": "FLOAT32", "c": 64, "op": "SUM",
              "mem": "CUDA", "seed": 90, "rounds": 5, "swap_at": 4,
              "counters": True}


@pytest.fixture(scope="module")
def job():
    """The 2 x 2 job's results: phase 0 on tl/torch_ops, phase 1 on
    tl/ring_cuda."""
    phases = [{"cases": FLAT_CASES + [PERSISTENT]},
              {"cases": RING_CASES + [PERSISTENT],
               "env": {"UCC_TL_RING_CUDA_TUNE": RING_TUNE}}]
    with HeldPorts(3) as held:
        specs = [{"n": N, "ranks": ranks, "ports": held.ports,
                  "env": {"UCC_TL_RING_CUDA_DEVICE": "cpu"},
                  "phases": phases}
                 for ranks in ([0, 1], [2, 3])]
        res = tp.run_procs(tp.job_worker, specs, timeout=150)
    return res, tp.collect(res, N)


def _results(ph, i):
    return [ph[r]["cases"][i] for r in range(N)]


def _bufs(case):
    """Each rank's (src Buf, dst Buf) of a case, as torch_stack_cases takes
    them (a rank without a buffer: None)."""
    srcs, dsts, meta = tp.case_buffers(case, N, lambda a, d: a)
    coll = case["coll"]
    out = []
    for r in range(N):
        src = None if srcs[r] is None else Buf(srcs[r])
        dst = None if dsts[r] is None else Buf(size=dsts[r].size)
        if coll == "ALLGATHERV":
            dst = Buf(size=sum(meta["counts"]), counts=meta["counts"],
                      displs=meta["displs"])
        elif coll == "ALLTOALLV":
            m = meta["matrix"]
            src = Buf(srcs[r], counts=[int(x) for x in m[r]])
            dst = Buf(size=int(m[:, r].sum()),
                      counts=[int(x) for x in m[:, r]])
        out.append((src, dst))
    return out


def _expected(coll, root, r):
    """tests/test_xla_multiprocess.py's expected value on rank r (None
    where it checks nothing)."""
    c, n = COUNT, N
    if coll == "ALLREDUCE":
        return np.full(c, n * (n + 1) / 2, np.float32)
    if coll == "GATHER":
        return np.concatenate([np.full(c, g + 1.0, np.float32)
                               for g in range(n)]) if r == root else None
    if coll == "SCATTER":
        return np.arange(n * c, dtype=np.float32)[r * c:(r + 1) * c]
    if coll == "ALLGATHERV":
        return np.concatenate([np.full(k, float(g), np.float32)
                               for g, k in enumerate(tp.XLA_MP_VCOUNTS)])
    if coll == "BCAST":
        return np.arange(c, dtype=np.float32) * 3
    m = [[(q + p) % 3 + 1 for p in range(n)] for q in range(n)]
    return np.concatenate([np.full(m[q][r], 100.0 * q + r, np.float32)
                           for q in range(n)])


def _np(b):
    return None if b is None else np.frombuffer(b, np.float32)


def test_workers_import_no_jax(job):
    res, _ = job
    assert [r["jax"] for r in res] == [False, False]


def test_flat_equals_the_reference_tests_values(job):
    _, ph = job
    for i, (coll, root, _op) in enumerate(FLAT):
        got = _results(ph[0], i)
        assert [g[:2] for g in got] == [("OK", "xla")] * N, coll
        for r in range(N):
            want = _expected(coll, root, r)
            if want is not None:
                np.testing.assert_array_equal(_np(got[r][2]), want)


def test_flat_is_bitwise_the_in_process_team(job):
    _, ph = job
    tjob = make_torch_job(n=N, UCC_TL_TORCH_OPS_TUNE="@xla:inf")
    try:
        for i, case in enumerate(FLAT_CASES):
            want = torch_coll(tjob, case["coll"], _bufs(case), "FLOAT32",
                              case["op"], case["root"], rounds=1)[0]
            for r, g in enumerate(_results(ph[0], i)):
                if g[2] is not None:
                    assert g[2] == want[r].tobytes(), (case["coll"], r)
    finally:
        tjob.cleanup()


def test_flat_is_tl_xla_on_the_same_inputs(job):
    _, ph = job
    rjob, teams = make_jax_job("@xla:inf", tl="xla", n=N)
    try:
        for i, case in enumerate(FLAT_CASES):
            bufs = _bufs(case)
            if case["coll"] == "SCATTER":
                # the reference's test passes zeros on the non-roots
                bufs = [(s or Buf(np.zeros(N * COUNT, np.float32)), d)
                        for s, d in bufs]
            if case["coll"] == "GATHER":
                bufs = [(s, d or Buf(size=N * COUNT)) for s, d in bufs]
            want = jax_coll(rjob, teams, case["coll"], bufs, "FLOAT32",
                            case["op"], case["root"])
            for r, g in enumerate(_results(ph[0], i)):
                if g[2] is not None:
                    np.testing.assert_allclose(_np(g[2]), want[r],
                                               rtol=1e-5, atol=1e-6)
    finally:
        rjob.cleanup()


def test_ring_cuda_is_bitwise_the_in_process_team(job):
    _, ph = job
    tjob = make_torch_job(RING_TUNE, n=N)
    try:
        for i, case in enumerate(RING_CASES):
            got = _results(ph[1], i)
            assert [g[:2] for g in got] == [("OK", "ring_cuda")] * N, case
            want = torch_coll(tjob, case["coll"], _bufs(case), "FLOAT32",
                              case["op"], case["root"], alg="ring_cuda",
                              rounds=1)[0]
            for r, g in enumerate(got):
                assert g[2] == want[r].tobytes(), (case["coll"], case["c"], r)
    finally:
        tjob.cleanup()


@pytest.mark.parametrize("phase,alg", [(0, "xla"), (1, "ring_cuda")])
def test_persistent_rounds_resend_a_changed_descriptor_once(job, phase,
                                                            alg):
    _, ph = job
    got = _results(ph[phase], len(ph[phase][0]["cases"]) - 1)
    assert [g[:2] for g in got] == [("OK", alg)] * N
    srcs, _, _ = tp.case_buffers(PERSISTENT, N, tp.port_buf)
    want = sum(s.double() for s in srcs).float()
    for g in got:
        # four float32 values summed in float32: a few ulp of the partial
        # sums (|x| < 5) from the float64 sum
        np.testing.assert_allclose(_np(g[2]), want.numpy(), rtol=1e-5,
                                   atol=2e-6)
        # every process: 4 more rounds, one more descriptor (round 4's
        # new buffers), no open (its peer's staging files were mapped)
        assert g[3] == {"dev_span_rounds": 4, "dev_desc_sends": 1,
                        "dev_ipc_opens": 0}, g[3]
