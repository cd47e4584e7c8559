"""The port's ucc_perftest (ucc_tpu_torch.tools.perftest) on the CPU:
UCC_TL_RING_CUDA_DEVICE=cpu puts -m cuda buffers on the CPU, where the
kernels' plain versions run. Its argument checks and --json records are
held against ucc_tpu's perftest."""
import json
import os
import subprocess
import sys

import pytest
import torch

from ucc_tpu.tools import perftest as jperf

from ucc_tpu_torch.kernels import ec_reduce as ker
from ucc_tpu_torch.kernels import ring_allreduce as kr
from ucc_tpu_torch.tools import perftest as perf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["-b", "64", "-e", "128", "-n", "2", "-w", "1"]


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")


def records(out: str):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("mem", ["host", "cuda"])
@pytest.mark.parametrize("bench,extra", [
    ("memcpy", []), ("memcpy", ["--nbufs", "3"]),
    ("reducedt", ["--nbufs", "4", "-o", "max"]),
    ("reducedt", ["-d", "bfloat16", "--nbufs", "9"]),
    ("reducedt_strided", ["-d", "int32", "--nbufs", "3", "-o", "bxor"]),
])
def test_executor_op_benches(capsys, mem, bench, extra):
    launches = ker.ec_reduce.launches
    assert perf.main(["-c", bench, "-m", mem, *SMALL, "-F", *extra]) == 0
    out = capsys.readouterr().out
    assert f"# ucc_perftest: {bench}" in out and f"mem={mem}" in out
    assert len(out.strip().splitlines()) == 4      # title, header, 2 sizes
    assert ker.ec_reduce.launches == launches      # CPU tensors: no launch


@pytest.mark.parametrize("coll", ["allreduce", "reduce_scatter", "allgather",
                                  "bcast", "alltoall"])
def test_collectives_on_cuda_memory(capsys, coll):
    launches = kr.ring_allreduce_pass.launches
    assert perf.main(["-c", coll, "-m", "cuda", "-p", "4", "--persistent",
                      *SMALL, "--json", "-F", "-r", "1"]) == 0
    recs = records(capsys.readouterr().out)
    assert [r["size_bytes"] for r in recs] == [64, 128]
    for r in recs:
        assert r["coll"] == coll and r["ranks"] == 4 and r["mem"] == "cuda"
        assert r["p50_us"] > 0 and r["busbw_GBps"] >= 0
        assert r["detail"] == {"transport": "unknown"}
    assert kr.ring_allreduce_pass.launches == launches


@pytest.mark.parametrize("mode", [[], ["-S"], ["-i"]])
def test_allreduce_modes(capsys, mode):
    assert perf.main(["-c", "allreduce", "-m", "cuda", "-p", "2", *SMALL,
                      *mode]) == 0
    out = capsys.readouterr().out
    assert "ranks=2 transport=unknown" in out


def test_default_ranks_are_four(capsys):
    """Without -p and -m: four ranks on cuda memory (here the device that
    UCC_TL_RING_CUDA_DEVICE=cpu names), for a collective and an
    executor op."""
    assert perf.main(["-c", "allgather", "-b", "16", "-e", "16", "-n", "1",
                      "-w", "0", "--json"]) == 0
    rec = records(capsys.readouterr().out)[0]
    assert rec["ranks"] == 4 and rec["mem"] == "cuda"
    assert perf.main(["-c", "reducedt", "-b", "16", "-e", "16", "-n", "1",
                      "-w", "0", "--json"]) == 0
    assert records(capsys.readouterr().out)[0]["mem"] == "cuda"


def test_json_keys_match_ucc_tpu(capsys):
    """The same keys as ucc_tpu's perftest on -m host: the executor-op
    record, and the collective record (the port runs it on -m cuda; it has
    no host TL yet)."""
    args = ["-c", "reducedt", "-m", "host", "-b", "8", "-e", "8", "-n", "2",
            "-w", "1", "--json", "-F"]
    assert jperf.main(args) == 0
    want = records(capsys.readouterr().out)
    assert perf.main(args) == 0
    got = records(capsys.readouterr().out)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert got[0]["detail"] == want[0]["detail"] == {"transport": "local"}
    coll = ["-c", "allreduce", "-p", "2", "-b", "64", "-e", "64", "-n", "2",
            "-w", "1", "--json", "-F"]
    assert jperf.main([*coll, "-m", "host"]) == 0
    want = records(capsys.readouterr().out)
    assert perf.main([*coll, "-m", "cuda"]) == 0
    got = records(capsys.readouterr().out)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [sorted(r["detail"]) for r in got] == \
        [sorted(r["detail"]) for r in want]


@pytest.mark.parametrize("bad", [
    ["-c", "reducedt", "--nbufs", "10"], ["-c", "reducedt", "--nbufs", "1"],
    ["-c", "memcpy", "--nbufs", "8"], ["-c", "memcpy", "--nbufs", "-1"],
    ["-c", "memcpy", "-n", "0"], ["-c", "allreduce", "-w", "-1"]])
def test_bad_arguments_exit_as_ucc_tpu(bad):
    with pytest.raises(SystemExit):
        jperf.main(bad)
    with pytest.raises(SystemExit) as ei:
        perf.main(bad)
    assert ei.value.code not in (0, None)


@pytest.mark.parametrize("flag", [
    ["--sweep"], ["--quant"], ["--gen"], ["--gen-device"], ["-O"], ["-T"],
    ["--teams", "2", "--storm"], ["--store", "h:1"], ["--procs", "2"],
    ["--matrix", "moe"], ["-c", "alltoallv"], ["-c", "reduce"],
    ["-m", "cuda_managed"]])
def test_unported_modes_are_refused(flag):
    with pytest.raises(SystemExit) as ei:
        perf.main(["-b", "8", "-e", "8", *flag])
    assert ei.value.code not in (0, None)


def test_host_collective_exits_with_the_init_status(capsys, monkeypatch):
    """A host collective whose init fails exits with that status: here no
    host TL is loaded (tl/shm serves -m host by default)."""
    monkeypatch.setenv("UCC_TLS", "ring_cuda,torch_ops,self")
    with pytest.raises(SystemExit) as ei:
        perf.main(["-c", "allreduce", "-m", "host", "-p", "2", "-b", "64",
                   "-e", "64"])
    assert "ERR_NOT_SUPPORTED" in str(ei.value.code)


def test_cuda_without_a_gpu_fails_loudly(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: -m cuda runs there")
    monkeypatch.delenv("UCC_TL_RING_CUDA_DEVICE")
    for args in (["-c", "reducedt", "-m", "cuda"],
                 ["-c", "allreduce", "-m", "cuda", "-p", "2"],
                 ["-c", "reducedt"], ["-c", "allreduce", "-p", "2"]):
        with pytest.raises(SystemExit) as ei:
            perf.main([*args, "-b", "8", "-e", "8", "-n", "1", "-w", "0"])
        assert "ERR_NO_RESOURCE" in str(ei.value.code)


def test_module_entry_point():
    """python -m ucc_tpu_torch.tools.perftest: runs with the CPU device
    named, and without it fails on a machine with no GPU."""
    args = [sys.executable, "-m", "ucc_tpu_torch.tools.perftest", "-c",
            "reducedt", "-m", "cuda", "-b", "8", "-e", "8", "-n", "1",
            "-w", "0", "--json"]
    env = dict(os.environ, UCC_TL_RING_CUDA_DEVICE="cpu")
    out = subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert records(out.stdout)[0]["op"] == "reducedt"
    if not torch.cuda.is_available():
        env.pop("UCC_TL_RING_CUDA_DEVICE")
        out = subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0 and not records(out.stdout)
        assert "no CUDA device" in out.stderr
