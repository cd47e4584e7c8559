"""Generated device collectives (``gen_dev_*``: dsl/lower_device,
kernels/gen_device, tl/torch_ops) on device teams that span processes:
2 processes x 2 ranks over ``TcpStoreOob``, device ``cpu`` (the CPU
stand-in of CUDA IPC: each process stages its ranks' buffers in files its
peer maps and runs its part of every round, ``part_walk``), CUDA memory,
``UCC_GEN_DEVICE=y`` and a ``UCC_TL_TORCH_OPS_TUNE`` pin per team.

- The kernel backend: allreduce of float32 via ``gen_dev_ring_c2`` (SUM,
  and AVG in place) and ``gen_dev_rhd_r2`` (also at a count below P
  vectors, so process 1's part is empty), bcast via ``gen_dev_bc_kn_r2``
  from roots 3 and 1, the int8 direct exchange under ``UCC_QUANT=int8``,
  and the edge-wired direct exchange at qblock 512 (``gen_dev_wdirect``,
  registered for the test: the layer kernel, whole in process 0). Every
  rank's result is bitwise the port's in-process 4-rank team; the exact
  SUM and bcast programs are bitwise the JAX package's host interpreter
  (GeneratedCollTask, which its device lowering claims bitwise), every
  out-of-place run is within 1e-5 of its tl/xla ``gen_dev_*`` on 4
  virtual CPU devices in this process, and the wired one bitwise its
  Pallas kernel in interpret mode.
- A count no device chunking divides is refused alike in both processes,
  before the tag: every rank falls to the next candidate, tl/ring_cuda
  (the pin leaves tl/torch_ops no other row there), as in one process.
- Persistent rounds (5, the buffers changed between rounds 3 and 4), on
  the fold route and the layer kernel: after the first round, one
  descriptor send and no open.
- The ``xla`` backend (``UCC_GEN_DEVICE_BACKEND=xla``): every process
  runs the plan over every src and writes its own ranks' dsts, bitwise
  the in-process team.
- A device-search winner: a tuner cache written by an in-process device
  search (its measured times stubbed so that a generated program wins)
  and its ``UCC_GEN_DEVICE_FAMILIES`` make a spanning team dispatch the
  winner, bitwise the in-process team under the same cache.
- The workers import no JAX.
"""
import contextlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch_procs as tp  # noqa: E402
from torch_procs import wire_direct  # noqa: E402
from torch_gen_jobs import GenJob, pinned  # noqa: E402
from torch_host_jobs import env  # noqa: E402
from torch_stack_cases import (Buf, jax_coll, make_jax_job,  # noqa: E402
                               make_torch_job, torch_coll)
from test_torch_gen_device import run_jax  # noqa: E402

import ucc_tpu  # noqa: E402
from ucc_tpu.constants import CollType as JCollType  # noqa: E402
from ucc_tpu.dsl.ir import ProgramBuilder as JProgramBuilder  # noqa: E402

from ucc_tpu_torch.dsl import lower_device as ld  # noqa: E402
from ucc_tpu_torch.dsl import search  # noqa: E402
from ucc_tpu_torch.score import tuner  # noqa: E402
from ucc_tpu_torch.tools.perftest import HeldPorts  # noqa: E402

N = 4
#: the libs' settings of the kernel-backend job (read at init)
LIB = {"UCC_GEN_DEVICE": "y", "UCC_QUANT": "int8", "UCC_QUANT_BLOCK": "512"}
#: the edge-wired program registered beside the families (layer kernel)
WIRES = [("int8", "int8")]


def _case(coll, c, seed, op="SUM", root=0, **kw):
    return dict({"coll": coll, "dt": "FLOAT32", "c": c, "seed": seed,
                 "mem": "CUDA", "root": root,
                 "op": op if coll == "ALLREDUCE" else None}, **kw)


PERSISTENT = {"rounds": 5, "swap_at": 4, "counters": True}
#: the kernel-backend job: (TUNE pin, cases), one team each
PHASES = [
    ("allreduce:@gen_dev_ring_c2:inf", [
        _case("ALLREDUCE", 8 * 37, 1),
        _case("ALLREDUCE", 8 * 37, 2, op="AVG", inplace=True),
        _case("ALLREDUCE", 8 * 5 + 1, 3),           # no chunking divides
        _case("ALLREDUCE", 8 * 9, 4, **PERSISTENT)]),
    ("allreduce:@gen_dev_rhd_r2:inf", [
        _case("ALLREDUCE", 4 * 37, 5),
        _case("ALLREDUCE", 4, 6)]),                 # one vector: P=2's 2nd empty
    ("bcast:@gen_dev_bc_kn_r2:inf", [
        _case("BCAST", 37, 7, root=3),
        _case("BCAST", 3, 8, root=1)]),
    ("allreduce:@gen_dev_qint8_direct:inf", [
        _case("ALLREDUCE", 4 * 37, 9)]),
    ("allreduce:@gen_dev_wdirect:inf", [
        _case("ALLREDUCE", 4 * 40, 10),
        _case("ALLREDUCE", 4 * 40, 11, **PERSISTENT)]),
]
#: the cases whose algorithm is not their team's pin
FALLBACK = {(0, 2): "ring_cuda"}
#: the xla-backend job
XLA_PIN = "allreduce:@gen_dev_rhd_r2:inf#bcast:@gen_dev_bc_chain_c2:inf"
XLA_CASES = [_case("ALLREDUCE", 4 * 37, 12),
             _case("BCAST", 2 * 37, 13, root=2),
             _case("ALLREDUCE", 4 * 9, 14, **PERSISTENT)]
#: the device-search job: one allreduce of 64 KiB a rank
SEARCH_COUNT = 16384
SEARCH_CASE = _case("ALLREDUCE", SEARCH_COUNT, 15)


def _pin_alg(tune, coll):
    for sec in tune.split("#"):
        if sec.startswith(coll.lower() + ":"):
            return sec.split("@")[1].split(":")[0]
    raise KeyError(coll)


def _stub_measure(teams, contexts, argses, coll, mem, msgsize, idxs, iters,
                  warmup=1, timeout=60.0):
    """Times that make the generated-device candidate first by name win
    (the library candidates slower), whatever the load."""
    cands = tuner.sweep_candidates(teams[0], coll, mem, msgsize)
    gen = sorted((i for i in idxs if cands[i].origin == "generated-device"),
                 key=lambda i: cands[i].alg_name)
    return {i: 1.0 + gen.index(i) if i in gen else 100.0 + i for i in idxs}


@pytest.fixture(scope="module")
def search_cache(tmp_path_factory):
    """An in-process device search over 4 CPU ranks writing a tuner cache:
    (its report, the cache's path)."""
    path = str(tmp_path_factory.mktemp("gen_span") / "tune.json")
    with pytest.MonkeyPatch.context() as mp, \
            env(UCC_TL_RING_CUDA_DEVICE="cpu", UCC_TUNER=None,
                UCC_TUNER_CACHE=None, UCC_GEN_DEVICE=None,
                UCC_GEN_DEVICE_FAMILIES=None, UCC_QUANT=None,
                UCC_TL_TORCH_OPS_TUNE=None):
        mp.setattr(search, "interleaved_measure", _stub_measure)
        rep = search.run_device_search(N, ["allreduce"],
                                       [SEARCH_COUNT * 4], iters=1,
                                       budget=3, tuner_cache=path,
                                       verbose=False)
    assert rep["winners"], rep
    return rep, path


def _search_env(rep, path):
    return {"UCC_GEN_DEVICE": "y",
            "UCC_GEN_DEVICE_FAMILIES": rep["device_families"],
            "UCC_TUNER": "offline", "UCC_TUNER_CACHE": path}


@pytest.fixture(scope="module")
def jobs(search_cache):
    """The three 2 x 2 jobs, run at once: {"kernel", "xla", "search"}:
    per phase, per rank, per case (status, algorithm, result bytes[,
    span counters])."""
    rep, path = search_cache
    groups = {
        "kernel": ({**LIB}, [{"cases": cases,
                              "env": {"UCC_TL_TORCH_OPS_TUNE": tune}}
                             for tune, cases in PHASES], WIRES),
        "xla": ({"UCC_GEN_DEVICE": "y", "UCC_GEN_DEVICE_BACKEND": "xla"},
                [{"cases": XLA_CASES,
                  "env": {"UCC_TL_TORCH_OPS_TUNE": XLA_PIN}}], None),
        "search": (_search_env(rep, path),
                   [{"cases": [SEARCH_CASE],
                     "env": {"UCC_TL_TORCH_OPS_TUNE": None}}], None),
    }
    specs, owner = [], []
    held = [HeldPorts(1 + len(g[1])) for g in groups.values()]
    try:
        for (name, (lib, phases, wires)), h in zip(groups.items(), held):
            for ranks in ([0, 1], [2, 3]):
                specs.append({"n": N, "ranks": ranks, "ports": h.ports,
                              "env": {"UCC_TL_RING_CUDA_DEVICE": "cpu",
                                      "UCC_TL_TORCH_OPS_TUNE": None,
                                      **lib},
                              "phases": phases, "wire_programs": wires,
                              "phase_timeout": 120})
                owner.append(name)
        res = tp.run_procs(tp.job_worker, specs, timeout=170)
    finally:
        for h in held:
            h.release()
    out = {}
    for name in groups:
        mine = [r for r, o in zip(res, owner) if o == name]
        out[name] = tp.collect(mine, N)
    out["jax"] = [r.get("jax") for r in res]
    return out


def _results(phase, i):
    return [phase[r]["cases"][i] for r in range(N)]


def _bufs(case):
    """Each rank's (src Buf, dst Buf) of a case for torch_stack_cases."""
    srcs, dsts, _ = tp.case_buffers(case, N, lambda a, d: a)
    inplace = case.get("inplace", False)
    out = []
    for r in range(N):
        src = None if srcs[r] is None else Buf(srcs[r])
        dst = None if dsts[r] is None else (
            Buf(dsts[r]) if inplace else Buf(size=dsts[r].size))
        out.append((src, dst))
    return out


@contextlib.contextmanager
def _wires_registered():
    base = tp.register_wire_programs(WIRES)
    try:
        yield
    finally:
        ld.registered_device_programs = base


def _in_process(lib, tune, case, alg):
    """The port's in-process 4-rank team's per-rank result bytes."""
    job = make_torch_job(n=N, UCC_TL_TORCH_OPS_TUNE=tune, **lib)
    try:
        got = torch_coll(job, case["coll"], _bufs(case), "FLOAT32",
                         case["op"], case["root"], alg=alg,
                         inplace=case.get("inplace", False), rounds=1)[0]
    finally:
        job.cleanup()
    return [g.tobytes() for g in got]


def _np(b):
    return np.frombuffer(b, np.float32)


def test_workers_import_no_jax(jobs):
    assert jobs["jax"] == [False] * 6


def test_kernel_backend_is_bitwise_the_in_process_team(jobs):
    with _wires_registered():
        for k, (tune, cases) in enumerate(PHASES):
            for i, case in enumerate(cases):
                alg = FALLBACK.get((k, i), _pin_alg(tune, case["coll"]))
                got = _results(jobs["kernel"][k], i)
                assert [g[:2] for g in got] == [("OK", alg)] * N, \
                    (tune, case)
                want = _in_process(LIB, tune, case, alg)
                assert [g[2] for g in got] == want, (tune, case)


def test_kernel_backend_holds_to_the_reference(jobs):
    """Bitwise the host interpreter of the JAX package where its device
    lowering claims bitwise (the exact SUM and bcast programs), within
    1e-5 of its tl/xla gen_dev_* on 4 virtual CPU devices, and the layer
    route's wired program bitwise its Pallas kernel in interpret mode."""
    host = GenJob(ucc_tpu, N)
    try:
        for k, (tune, cases) in enumerate(PHASES):
            for i, case in enumerate(cases):
                if (k, i) in FALLBACK or case.get("inplace") or \
                        case.get("rounds"):
                    continue
                alg = _pin_alg(tune, case["coll"])
                got = [_np(g[2]) for g in _results(jobs["kernel"][k], i)]
                srcs, _, _ = tp.case_buffers(case, N, lambda a, d: a)
                if alg == "gen_dev_wdirect":
                    prog = wire_direct(N, *WIRES[0], JProgramBuilder,
                                          JCollType)
                    want = run_jax(prog, N, srcs, "SUM", 0, "pallas", 512,
                                   "int8")
                    for g, w in zip(got, want):
                        np.testing.assert_array_equal(g.view(np.uint32),
                                                      w.view(np.uint32))
                    continue
                if "qint8" not in alg:
                    hcase = {kk: v for kk, v in case.items() if kk != "mem"}
                    want = pinned(host, hcase, N, "gen_" + alg[8:])
                    assert [w[:2] for w in want] == \
                        [("OK", "gen_" + alg[8:])] * N
                    assert [w[2] for w in want] == \
                        [g.tobytes() for g in got], (alg, case)
                with env(**LIB):
                    jjob, teams = make_jax_job(tune, tl="xla", n=N)
                try:
                    want = jax_coll(jjob, teams, case["coll"], _bufs(case),
                                    "FLOAT32", case["op"], case["root"],
                                    alg=alg, tl="xla")
                finally:
                    jjob.cleanup()
                for g, w in zip(got, want):
                    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    finally:
        host.destroy()


@pytest.mark.parametrize("phase,case", [(0, 3), (4, 1)],
                         ids=["fold", "layer"])
def test_persistent_rounds_resend_a_changed_descriptor_once(jobs, phase,
                                                            case):
    got = _results(jobs["kernel"][phase], case)
    for g in got:
        # every process: 4 more rounds, one more descriptor (round 4's
        # new buffers), no open (its peer's staging files were mapped)
        assert g[3] == {"dev_span_rounds": 4, "dev_desc_sends": 1,
                        "dev_ipc_opens": 0}, g[3]


def test_xla_backend_is_bitwise_the_in_process_team(jobs):
    lib = {"UCC_GEN_DEVICE": "y", "UCC_GEN_DEVICE_BACKEND": "xla"}
    for i, case in enumerate(XLA_CASES):
        alg = _pin_alg(XLA_PIN, case["coll"])
        got = _results(jobs["xla"][0], i)
        assert [g[:2] for g in got] == [("OK", alg)] * N, case
        assert [g[2] for g in got] == _in_process(lib, XLA_PIN, case, alg)
    assert got[0][3] == {"dev_span_rounds": 4, "dev_desc_sends": 1,
                         "dev_ipc_opens": 0}


def test_a_searched_device_winner_dispatches(jobs, search_cache):
    rep, path = search_cache
    winner = rep["winners"][0]
    assert winner.startswith("gen_dev_")
    got = _results(jobs["search"][0], 0)
    assert [g[:2] for g in got] == [("OK", winner)] * N
    assert [g[2] for g in got] == _in_process(
        _search_env(rep, path), "", SEARCH_CASE, winner)
