"""``ucc_tpu_torch.bootstrap.World``: tests/test_bootstrap.py's two-process
job (2 ranks a process) on the port, a HOST and a CUDA-memory allreduce
(device "cpu") on the world team, over the flat TCP stores and over the
tree bootstrap; plus the device each local rank gets and the environment
World.from_env reads. The workers import no JAX.
"""
import os

import numpy as np
import pytest

import torch_procs as tp

from ucc_tpu_torch import bootstrap
from ucc_tpu_torch.tools.perftest import HeldPorts


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.mark.parametrize("tree", ["n", "y"])
def test_world_bootstrap_two_processes(tree):
    nprocs, rpp, count = 2, 2, 64
    n = nprocs * rpp
    # the flat stores take the port and the next; the tree's block starts
    # at the port + 3
    with HeldPorts(3 + 16, contiguous=True) as held:
        env = {"UCC_BOOTSTRAP": f"127.0.0.1:{held.ports[0]}",
               "UCC_NPROCS": str(nprocs), "UCC_RANKS_PER_PROC": str(rpp),
               "UCC_OOB_TREE": tree}
        res = tp.run_procs(tp.hier_world_worker, [{
            "env": env, "count": count, "seed": 2}] * nprocs, timeout=120)
    want = np.sum(tp.hier_values(n, count, 2), axis=0)
    seen = []
    for i, pr in enumerate(res):
        assert "error" not in pr, (i, pr.get("error"))
        assert not pr["jax"]
        assert pr["world_size"] == n
        for rr in pr["ranks"]:
            seen.append(rr["rank"])
            # one node: cl/hier declines, cl/basic serves
            assert rr["cls"] == ["basic"]
            alg, st, data = rr["host"]
            assert st == "OK"
            np.testing.assert_array_equal(np.frombuffer(data, np.float32),
                                          want)
            for st, data in rr["cuda"][1]:
                assert st == "OK"
                np.testing.assert_array_equal(
                    np.frombuffer(data, np.float32), want)
    assert sorted(seen) == list(range(n))
    assert not any(_alive(pr["pid"]) for pr in res)


def test_rank_device_cycles_over_the_cards(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [bootstrap.rank_device("cuda", i) for i in range(5)] == \
        ["cuda:0", "cuda:1", "cuda:0", "cuda:1", "cuda:0"]
    assert bootstrap.rank_device("cpu", 3) == "cpu"


def test_rank_device_without_a_gpu_names_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the device TLs' context then raises ERR_NO_RESOURCE: no fallback
    assert bootstrap.rank_device("cuda", 1) == "cuda"


def test_from_env_reads_the_launcher_variables(monkeypatch):
    got = {}

    def fake_init(self, rank, nprocs, coordinator="", **kw):
        got.update(rank=rank, nprocs=nprocs, coordinator=coordinator, **kw)

    monkeypatch.setattr(bootstrap.World, "__init__", fake_init)
    monkeypatch.setenv("UCC_BOOTSTRAP", "10.0.0.1:4000")
    monkeypatch.setenv("UCC_RANK", "3")
    monkeypatch.setenv("UCC_NPROCS", "4")
    monkeypatch.setenv("UCC_RANKS_PER_PROC", "2")
    bootstrap.World.from_env(device="cpu")
    assert got == {"rank": 3, "nprocs": 4, "coordinator": "10.0.0.1:4000",
                   "ranks_per_proc": 2, "device": "cpu"}
    got.clear()
    bootstrap.World.from_env(ranks_per_proc=1)
    assert got["ranks_per_proc"] == 1


def test_no_jax_distributed_option():
    import inspect
    params = inspect.signature(bootstrap.World.__init__).parameters
    assert "jax_distributed" not in params and params["device"].default == \
        "cuda"
