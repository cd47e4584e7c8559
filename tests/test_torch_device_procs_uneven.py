"""Device teams across processes (tl/device, tl/device_sync), device
``cpu``: an uneven layout, a peer that dies, and what is left behind.

- 3 processes holding 1, 2 and 1 of 4 ranks: allreduce and alltoallv on
  tl/torch_ops's ``xla`` and the allreduce on tl/ring_cuda
  (TUNE-pinned), bitwise the port's in-process 4-rank team.
- A process that exits after team create (the sync area's creator) ends
  its peer's allreduce with ERR_TIMED_OUT within seconds: the survivor
  finds the creator's process gone.
- No ``ucc-torch-dev-*`` file of these teams' sync areas is left in
  /dev/shm, and no worker is alive; the workers import no JAX.
- Libs made at once in threads of a fresh process (a worker holding
  several ranks) all find the CLs: component discovery is done once,
  behind a lock.
"""
import os
import subprocess
import sys
import time

import pytest

jax = pytest.importorskip("jax")

import torch_procs as tp  # noqa: E402
from torch_stack_cases import Buf, make_torch_job, torch_coll  # noqa: E402

from ucc_tpu_torch.tl.device_sync import SYNC_PREFIX, shm_dir  # noqa: E402
from ucc_tpu_torch.tools.perftest import HeldPorts  # noqa: E402

N = 4
RING_TUNE = "allreduce:@ring_cuda:inf"
CASES = [{"coll": "ALLREDUCE", "dt": "FLOAT32", "c": 101, "op": "SUM",
          "mem": "CUDA", "seed": 31, "rounds": 2},
         {"coll": "ALLTOALLV", "dt": "FLOAT32", "c": 5, "mem": "CUDA",
          "seed": 32}]
RING_CASE = {"coll": "ALLREDUCE", "dt": "FLOAT32", "c": 1001, "op": "MAX",
             "mem": "CUDA", "seed": 33, "rounds": 3}


def _left(names):
    """The files in /dev/shm of the sync areas ``names`` (their staging
    files included); other jobs' areas are not looked at."""
    assert names and all(x.startswith(SYNC_PREFIX) for x in names)
    return sorted(f for f in os.listdir(shm_dir())
                  if any(f.startswith(x) for x in names))


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.fixture(scope="module")
def uneven():
    phases = [{"cases": CASES},
              {"cases": [RING_CASE],
               "env": {"UCC_TL_RING_CUDA_TUNE": RING_TUNE}}]
    with HeldPorts(3) as held:
        specs = [{"n": N, "ranks": ranks, "ports": held.ports,
                  "env": {"UCC_TL_RING_CUDA_DEVICE": "cpu"},
                  "phases": phases}
                 for ranks in ([0], [1, 2], [3])]
        res = tp.run_procs(tp.job_worker, specs, timeout=150)
    return res, tp.collect(res, N)


def _bufs(case):
    srcs, dsts, meta = tp.case_buffers(case, N, lambda a, d: a)
    out = []
    for r in range(N):
        if case["coll"] == "ALLTOALLV":
            m = meta["matrix"]
            out.append((Buf(srcs[r], counts=[int(x) for x in m[r]]),
                        Buf(size=int(m[:, r].sum()),
                            counts=[int(x) for x in m[:, r]])))
        else:
            out.append((Buf(srcs[r]), Buf(size=dsts[r].size)))
    return out


def test_uneven_layout_is_bitwise_the_in_process_team(uneven):
    res, ph = uneven
    assert [r["jax"] for r in res] == [False] * 3
    tjob = make_torch_job(n=N, UCC_TL_TORCH_OPS_TUNE="@xla:inf")
    try:
        for i, case in enumerate(CASES):
            want = torch_coll(tjob, case["coll"], _bufs(case), "FLOAT32",
                              case.get("op"), rounds=1)[0]
            got = [ph[0][r]["cases"][i] for r in range(N)]
            assert [g[:2] for g in got] == [("OK", "xla")] * N
            assert [g[2] for g in got] == [w.tobytes() for w in want]
    finally:
        tjob.cleanup()
    tjob = make_torch_job(RING_TUNE, n=N)
    try:
        want = torch_coll(tjob, "ALLREDUCE", _bufs(RING_CASE), "FLOAT32",
                          "MAX", alg="ring_cuda", rounds=1)[0]
        got = [ph[1][r]["cases"][0] for r in range(N)]
        assert [g[:2] for g in got] == [("OK", "ring_cuda")] * N
        assert [g[2] for g in got] == [w.tobytes() for w in want]
    finally:
        tjob.cleanup()


def test_no_sync_area_or_worker_is_left(uneven):
    res, ph = uneven
    names = {x for r in range(N) for p in ph for x in p[r]["span_names"]}
    assert not _left(names)
    assert not any(_alive(r["pid"]) for r in res)


def test_a_dead_peer_ends_the_request_with_an_error():
    within = 5.0
    with HeldPorts(2) as held:
        spec = {"n": 2, "ports": held.ports}
        t0 = time.monotonic()
        res = tp.run_procs(tp.span_death_worker, [spec, spec], timeout=90)
        took = time.monotonic() - t0
    assert res[0]["out"] == "died"
    assert "error" not in res[1], res[1].get("error")
    assert res[1]["out"] == "ERR_TIMED_OUT", res[1]
    assert res[1]["alg"] == "xla"
    assert res[1]["took"] <= within + 2.0
    assert took < 60
    assert not any(r.get("jax") for r in res)
    # the survivor unlinked the area its dead creator left
    assert not _left(res[1]["span_names"])
    assert not any(_alive(r["pid"]) for r in res)


def test_libs_made_in_threads_of_a_fresh_process():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, threading\n"
        f"sys.path.insert(0, {repo!r})\n"
        "import ucc_tpu_torch as ut\n"
        "errs = []\n"
        "def make():\n"
        "    try:\n"
        "        assert [c.name for c in ut.init().cl_libs] == ['basic', "
        "'hier']\n"
        "    except Exception as e:\n"
        "        errs.append(repr(e))\n"
        "ths = [threading.Thread(target=make) for _ in range(8)]\n"
        "[t.start() for t in ths]\n"
        "[t.join() for t in ths]\n"
        "print('ERRS', errs)\n"
        "sys.exit(1 if errs else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
