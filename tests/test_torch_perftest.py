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
    ["--teams", "1", "--storm"], ["--store", "h:1", "--procs", "2"],
    ["--procs", "2", "-c", "memcpy"], ["-m", "cuda_managed"]])
def test_unported_modes_are_refused(flag):
    with pytest.raises(SystemExit) as ei:
        perf.main(["-b", "8", "-e", "8", *flag])
    assert ei.value.code not in (0, None)


@pytest.mark.parametrize("flag", [
    ["-O", "-m", "host"], ["-O", "-m", "host", "-c", "alltoallv"],
    ["-T", "-m", "host"], ["--matrix", "moe", "-c", "alltoallv"],
    ["-c", "alltoallv"], ["-c", "reduce"], ["--sweep"], ["--quant"],
    ["--gen", "-m", "host"], ["--gen-device"]])
def test_ported_modes_match_ucc_tpus_records(capsys, monkeypatch, flag):
    """-O (allreduce and the alltoallv row), -T, --matrix moe, --sweep,
    --quant, --gen, --gen-device, and the collective types beyond the
    five: they run, and each
    record has ucc_tpu's perftest's fields for the same arguments (-m
    host; the others on the port's -m cuda, the CPU device here). Both
    perftests' -O set the host TLs' TUNE in the environment and --quant
    sets UCC_QUANT (--gen and --gen-device UCC_GEN and UCC_GEN_DEVICE),
    which are put back after; ucc_tpu's -T leaves its
    execution engines' progress threads running, so that one runs in a
    process of its own. --sweep prints a record per (size, algorithm),
    each package over its own score map's candidates, so its records are
    compared as sets of field lists."""
    for var in ("UCC_TL_SHM_TUNE", "UCC_TL_SOCKET_TUNE", "UCC_QUANT",
                "UCC_GEN", "UCC_GEN_DEVICE"):
        # recorded as unset, so that the undo removes what -O sets
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)
    args = ["-b", "64", "-e", "128", "-n", "2", "-w", "1", "-p", "2",
            "--json", "-F", *flag]
    host = "-m" in flag
    jargs = args if host else [*args, "-m", "host"]
    if "-T" in flag:
        out = subprocess.run(
            [sys.executable, "-m", "ucc_tpu.tools.perftest", *jargs],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        want = records(out.stdout)
    else:
        assert jperf.main(jargs) == 0
        want = records(capsys.readouterr().out)
    assert perf.main(args if host else [*args, "-m", "cuda"]) == 0
    got = records(capsys.readouterr().out)
    if "--sweep" in flag:
        assert sorted({r["size_bytes"] for r in got}) == [64, 128]
        assert {r["bench"] for r in got} == {"sweep"}
        for key in (sorted, lambda r: sorted(r["detail"]),
                    lambda r: (r["coll"], r["ranks"], r["count"])):
            assert {repr(key(r)) for r in got} == \
                {repr(key(r)) for r in want}
        return
    if "--quant" in flag:
        for g, w in zip(got, want):
            assert g["detail"]["quant"]["mode"] == \
                w["detail"]["quant"]["mode"] == "int8"
    assert [r["size_bytes"] for r in got] == [64, 128]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [sorted(r["detail"]) for r in got] == \
        [sorted(r["detail"]) for r in want]
    assert [(r["coll"], r["ranks"], r["count"]) for r in got] == \
        [(r["coll"], r["ranks"], r["count"]) for r in want]


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


@pytest.mark.parametrize("given,want", [(None, "1"), ("3", "3")])
def test_procs_workers_get_one_intra_op_thread(monkeypatch, given, want):
    """``--procs`` starts its workers with OMP_NUM_THREADS=1 unless the
    caller set it: N torch pools that spin after a parallel op would
    oversubscribe the host's cores while the ranks poll."""
    if given is None:
        monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    else:
        monkeypatch.setenv("OMP_NUM_THREADS", given)
    seen = []

    class FakePopen:
        def __init__(self, cmd, env=None, stdout=None):
            seen.append((cmd, env))

        def wait(self):
            return 0

        def poll(self):
            return 0

    monkeypatch.setattr(perf.subprocess, "Popen", FakePopen)
    assert perf.main(["--procs", "3", "-m", "host", "-c", "allreduce",
                      "-b", "8", "-e", "8"]) == 0
    assert [c[c.index("--rank") + 1] for c, _ in seen] == ["0", "1", "2"]
    assert all(env["OMP_NUM_THREADS"] == want for _, env in seen)
