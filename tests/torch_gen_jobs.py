"""Jobs of both packages for the compiler tests (not a test file).

``GenJob`` is ``torch_host_jobs.Job`` with an environment held around its
lib, context and team creation: the compiler's switches (UCC_GEN,
UCC_GEN_NATIVE, UCC_QUANT, ...) are read at lib init and at team create
in both packages. Both packages' program caches on disk are off
(UCC_GEN_PROG_CACHE=n) and their search caches point at a file that does
not exist, so that no cache an earlier run left registers a row.
``pinned`` runs one case pinned by TUNE on a job and returns per rank
(status, algorithm, result bytes), as ``torch_host_jobs.run_cases`` does.
"""
import os

import numpy as np

import torch_procs as tp
from torch_host_jobs import Job, env, ref_buf, run_cases

#: the compiler's switches, at their defaults but for UCC_GEN
BASE_ENV = {
    "UCC_GEN": "y", "UCC_GEN_FAMILIES": None, "UCC_GEN_NATIVE": None,
    "UCC_GEN_SEARCH": None, "UCC_GEN_PROG_CACHE": "n",
    "UCC_GEN_SEARCH_CACHE": os.path.join(os.path.dirname(__file__),
                                         "no-such-search-cache.json"),
    "UCC_QUANT": None, "UCC_TUNER": None, "UCC_POOL_ENABLE": None,
    "UCC_POOL_CHUNKS": None, "UCC_TL_SHM_TUNE": None,
    "UCC_TOPO_FAKE_PPN": None, "UCC_TOPO_FAKE_NODES_PER_POD": None,
}


class GenJob(Job):
    """n ranks of package ``mod`` under ``BASE_ENV`` updated by *values*."""

    def __init__(self, mod, n, tls="shm,self", **values):
        self.env_values = dict(BASE_ENV, **values)
        with env(**self.env_values):
            super().__init__(mod, n, tls=tls)

    def team(self, n, tune=""):
        with env(**self.env_values):
            return super().team(n, tune)

    def info(self, n, tune=""):
        """The host rows of rank 0's score dump (lines naming /host)."""
        text = self.team(n, tune)[0].score_map.print_info("t")
        return [ln for ln in text.splitlines()[1:] if "/host" in ln]


def pinned(job, case, n, name):
    """Run *case* with its collective TUNE-pinned to *name*."""
    tune = f"{case['coll'].lower()}:@{name}:inf"
    with env(**job.env_values):
        return run_cases(job, [case], n, tune)[0]


def same_bits(got, want, name):
    """Per rank: OK in both, the pinned algorithm in both, equal bytes."""
    for r, (g, w) in enumerate(zip(got, want)):
        assert w[0] == "OK" and w[1] == name, (name, r, w[:2])
        assert g[:2] == w[:2], (name, r, g[:2], w[:2])
        assert g[2] == w[2], (name, r, "result bytes differ")


def floats(rank_result, dt="FLOAT32"):
    """The result bytes of one rank as numbers."""
    nd = {"FLOAT32": np.float32, "FLOAT64": np.float64}[dt]
    return np.frombuffer(rank_result[2], nd)


def case_inputs(case, n):
    """The numpy inputs ``torch_procs.layout`` gives *case*."""
    return tp.layout(case["coll"], n, case.get("c", 0), case.get("dt"),
                     case.get("seed", 0), case.get("root", 0),
                     case.get("inplace", False))


def forced(job, case, n, name, comp="shm"):
    """Run *case* with candidate *name* (of component *comp*) forced on
    every rank by score-map index (``score.tuner.forced_request``), where a
    TUNE pin cannot reach it (the hier rows exist on the full team's TL
    only, not on CL/HIER's node teams the TUNE also names). Every rank
    attempts its init, so a refusal leaves the tag counters in step."""
    import importlib
    mod = job.mod
    tuner = importlib.import_module(mod.__name__ + ".score.tuner")
    teams = job.team(n)
    ref = mod.__name__ == "ucc_tpu"

    def conv(a, dt):
        return ref_buf(a, dt) if ref else tp.port_buf(a, dt)
    srcs, dsts, meta = tp.case_buffers(case, n, conv)
    args = [tp.make_args(mod, case["coll"], r, n, srcs[r], dsts[r], meta,
                         case.get("dt"), case.get("op"), case.get("root", 0),
                         case.get("inplace", False)) for r in range(n)]
    ct = mod.CollType[case["coll"]]
    mem = mod.constants.MemoryType.HOST
    esz = 2 if case.get("dt") == "BFLOAT16" else \
        np.dtype(tp._NP[case.get("dt")]).itemsize
    msgsize = case.get("c", 0) * esz
    cands = tuner.sweep_candidates(teams[0], ct, mem, msgsize)
    idx = next(i for i, c in enumerate(cands)
               if c.alg_name == name and tuner.cand_label(c)[0] == comp)
    reqs, errs = [], []
    for r in range(n):
        try:
            reqs.append(tuner.forced_request(teams[r], args[r], ct, mem,
                                             msgsize, idx))
        except mod.UccError as e:
            errs.append(e)
    if errs:
        for rq in reqs:
            rq.finalize()
        return [(f"init {errs[0].status.name}", name, None)] * n
    for rq in reqs:
        rq.post()
    job.until(lambda: all([rq.test() != mod.Status.IN_PROGRESS
                           for rq in reqs]))
    sts = [rq.test().name for rq in reqs]
    for rq in reqs:
        rq.finalize()
    return [(sts[r], name, None if sts[r] != "OK" else
             tp.result_of(case, r, srcs, dsts)) for r in range(n)]
