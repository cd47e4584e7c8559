"""Hierarchical teams across processes, bootstrapped by
``ucc_tpu_torch.bootstrap.World.from_env`` over held loopback ports, the
port's device TLs on device "cpu":

- 2 processes x 2 ranks under UCC_TOPO_FAKE_PPN=2: every fake node is one
  process (tests/test_xla_multiprocess.py's mode ``hier``); HOST memory
  takes ``rab`` and CUDA memory ``rab_tpu``, whose leaders go over
  tl/sockets between the processes.
- 4 processes x 2 ranks under UCC_TOPO_FAKE_PPN=4: every fake node spans
  two processes, so the NODE unit's torch_ops team is a spanning device
  team (its rounds through the per-team sync area and the processes'
  staged buffers), while the device rendezvous still groups ranks by
  physical process.

Results equal the expected sums and are bitwise the port's in-process
hier team's on the same inputs; no sync area is left in /dev/shm, no
worker is alive and no worker imported JAX.
"""
import os

import numpy as np
import pytest
import torch

import torch_procs as tp
from torch_hier_cases import HierJob

import ucc_tpu_torch as ut
from ucc_tpu_torch.tl.device_sync import SYNC_PREFIX, shm_dir
from ucc_tpu_torch.tools.perftest import HeldPorts

COUNT = 1000
SEED = 5


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _in_process(n, ppn):
    """The same allreduces on an in-process hier team of n ranks: (HOST
    result bytes, CUDA-memory result bytes) per rank."""
    vals = tp.hier_values(n, COUNT, SEED)
    job = HierJob(ut, n, UCC_TOPO_FAKE_PPN=str(ppn))
    try:
        teams = job.team()
        dt = ut.DataType.FLOAT32
        host = [np.zeros(COUNT, np.float32) for _ in range(n)]
        job.run(teams, [ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
            src=ut.BufferInfo(vals[r].copy(), COUNT, dt),
            dst=ut.BufferInfo(host[r], COUNT, dt)) for r in range(n)])
        dev = [torch.zeros(COUNT) for _ in range(n)]
        names = job.run(teams, [ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
            src=ut.BufferInfo(torch.from_numpy(vals[r].copy()), COUNT, dt,
                              mem_type=ut.MemoryType.CUDA),
            dst=ut.BufferInfo(dev[r], COUNT, dt,
                              mem_type=ut.MemoryType.CUDA))
            for r in range(n)])
        assert names == ["rab_tpu"] * n
        return ([h.tobytes() for h in host],
                [d.numpy().tobytes() for d in dev])
    finally:
        job.cleanup()


def _run(nprocs, rpp, ppn, host):
    n = nprocs * rpp
    with HeldPorts(2, contiguous=True) as held:
        env = {"UCC_BOOTSTRAP": f"127.0.0.1:{held.ports[0]}",
               "UCC_NPROCS": str(nprocs), "UCC_RANKS_PER_PROC": str(rpp),
               "UCC_TOPO_FAKE_PPN": str(ppn)}
        spec = {"env": env, "count": COUNT, "seed": SEED, "host": host,
                "rounds": 2}
        res = tp.run_procs(tp.hier_world_worker, [spec] * nprocs,
                           timeout=150)
    for i, pr in enumerate(res):
        assert "error" not in pr, (i, pr.get("error"))
        assert not pr["jax"], f"process {i} imported jax"
        assert pr["world_size"] == n
    ranks = sorted((rr for pr in res for rr in pr["ranks"]),
                   key=lambda rr: rr["rank"])
    assert [rr["rank"] for rr in ranks] == list(range(n))
    return res, ranks


@pytest.fixture(scope="module")
def two_by_two():
    return _run(2, 2, 2, host=True)


@pytest.fixture(scope="module")
def four_by_two():
    return _run(4, 2, 4, host=False)


def test_mode_hier_selects_the_hier_rows(two_by_two):
    _, ranks = two_by_two
    for rr in ranks:
        assert rr["cls"] == ["basic", "hier"]
        assert rr["host"][:2] == ("rab", "OK")
        assert rr["cuda"][0] == "rab_tpu"
        assert rr["node_size"] == 2 and rr["node_torch_ops"]
        # each fake node is one process: no spanning node team
        assert not rr["node_spanning"]
        assert "L0: unit size 2" in rr["topology"]


def test_mode_hier_results(two_by_two):
    _, ranks = two_by_two
    want = np.sum(tp.hier_values(4, COUNT, SEED), axis=0)
    host, dev = _in_process(4, 2)
    for rr in ranks:
        r = rr["rank"]
        got = np.frombuffer(rr["host"][2], np.float32)
        np.testing.assert_array_equal(got, want)
        assert rr["host"][2] == host[r]
        for st, data in rr["cuda"][1]:
            assert st == "OK"
            assert data == dev[r]


def test_nodes_spanning_processes(four_by_two):
    res, ranks = four_by_two
    want = np.sum(tp.hier_values(8, COUNT, SEED), axis=0)
    _, dev = _in_process(8, 4)
    for rr in ranks:
        assert rr["cls"] == ["basic", "hier"]
        assert rr["node_size"] == 4
        assert rr["node_spanning"], rr["rank"]
        assert rr["cuda"][0] == "rab_tpu"
        for st, data in rr["cuda"][1]:
            assert st == "OK"
            np.testing.assert_array_equal(np.frombuffer(data, np.float32),
                                          want)
            assert data == dev[rr["rank"]]
        assert rr["span_names"]


@pytest.mark.parametrize("layout", ["two_by_two", "four_by_two"])
def test_nothing_is_left(layout, request):
    res, ranks = request.getfixturevalue(layout)
    names = sorted({x for rr in ranks for x in rr["span_names"]})
    assert all(x.startswith(SYNC_PREFIX) for x in names)
    left = [f for f in os.listdir(shm_dir())
            if any(f.startswith(x) for x in names)]
    assert not left
    assert not any(_alive(pr["pid"]) for pr in res)
