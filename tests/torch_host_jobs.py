"""In-process jobs of either package for the port's host-transport tests
(not a test file): ``Job`` runs n ranks of ``ucc_tpu`` or
``ucc_tpu_torch`` in this process over a thread OOB, with the TLs and
the TUNE variable a test names; ``run_cases`` runs ``torch_procs`` case
dicts on it and returns per-rank result bytes, the same shape the
multi-process workers report, so one can be compared with the other.
"""
import contextlib
import os
import threading
import time

import ml_dtypes
import numpy as np

import torch_procs as tp


@contextlib.contextmanager
def env(**values):
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reference_core():
    """The JAX package's native core, loaded as a fresh process loads it.

    Its build (``ucc_tpu/native.py``: ``make -C native`` when the library
    is missing or stale) takes no lock across processes and links the
    library in place, so a worker of a parallel run that loads it while
    another worker is still linking it gets "file too short" from dlopen
    and, its ``get_lib`` caching the attempt, runs the Python matcher for
    the rest of its life: no ``+plan`` rows, no pooled rows, the drills'
    matcher "python" (ROADMAP C10). The port's comparisons need the
    reference as it runs: retry such a failed load (once the file is
    whole it loads; a build that really fails fails again)."""
    from ucc_tpu import native as jn
    with jn._LOCK:
        if jn._TRIED and jn._LIB is None and jn._native_enabled():
            jn._TRIED = False
    return jn.get_lib()


def ref_buf(arr, dt):
    if arr is None:
        return None
    return arr.copy().view(ml_dtypes.bfloat16) if dt == "BFLOAT16" \
        else arr.copy()


class Job:
    """n ranks of package ``mod`` in this process, contexts made in
    threads (the address exchange blocks); teams cached by (size, TUNE)
    on the first ranks; everything after is driven cooperatively."""

    def __init__(self, mod, n, tls="shm,self", tune_var="UCC_TL_SHM_TUNE",
                 **ctx_env):
        self.mod = mod
        self.n = n
        if mod.__name__ == "ucc_tpu":
            reference_core()
        self.tune_var = tune_var
        world = mod.ThreadOobWorld(n)
        libs = [mod.init(TLS=tls) for _ in range(n)]
        self.contexts = [None] * n
        with env(**ctx_env):
            ths = [threading.Thread(target=self._make, args=(libs, world, r))
                   for r in range(n)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=60)
        assert all(c is not None for c in self.contexts)
        self.teams = {}

    def _make(self, libs, world, r):
        self.contexts[r] = self.mod.Context(
            libs[r], self.mod.ContextParams(oob=world.endpoint(r)))

    def team(self, n, tune=""):
        key = (n, tune)
        if key not in self.teams:
            world = self.mod.ThreadOobWorld(n)
            with env(**{self.tune_var: tune or None}):
                teams = [self.contexts[r].create_team_post(
                    self.mod.TeamParams(oob=world.endpoint(r)))
                    for r in range(n)]
                self.until(lambda: all(
                    [t.create_test() != self.mod.Status.IN_PROGRESS
                     for t in teams]))
            assert [t.create_test() for t in teams] == \
                [self.mod.Status.OK] * n
            self.teams[key] = teams
        return self.teams[key]

    def until(self, cond, timeout=60.0):
        deadline = time.monotonic() + timeout
        while not cond():
            for c in self.contexts:
                c.progress()
            if time.monotonic() > deadline:
                raise TimeoutError("progress timed out")

    def run(self, teams, args, rounds=1):
        """collective_init on every member, then ``rounds`` posts;
        returns (status names, algorithm names)."""
        try:
            reqs = [t.collective_init(a) for t, a in zip(teams, args)]
        except self.mod.UccError as e:
            return [f"init {e.status.name}"] * len(teams), [None]
        for _ in range(rounds):
            for rq in reqs:
                rq.post()
            self.until(lambda: all(
                [rq.test() != self.mod.Status.IN_PROGRESS for rq in reqs]))
        sts = [rq.test().name for rq in reqs]
        names = [rq.task.alg_name for rq in reqs]
        for rq in reqs:
            rq.finalize()
        return sts, names

    def destroy(self):
        for teams in self.teams.values():
            for t in teams:
                t.destroy()
        for c in self.contexts:
            c.destroy()
        self.teams = {}


def run_cases(job, cases, n, tune=""):
    """Run case dicts on the job's first n ranks; returns per case a
    list over ranks of (status, algorithm, result bytes)."""
    ref = job.mod.__name__ == "ucc_tpu"
    out = []
    for case in cases:
        def conv(a, dt):
            if ref:
                return ref_buf(a, dt)
            return tp.port_buf(a, dt, case.get("kind", "tensor"))
        srcs, dsts, meta = tp.case_buffers(case, n, conv)
        teams = job.team(n, tune)
        args = [tp.make_args(job.mod, case["coll"], r, n, srcs[r], dsts[r],
                             meta, case.get("dt"), case.get("op"),
                             case.get("root", 0), case.get("inplace", False),
                             persistent=case.get("rounds", 1) > 1)
                for r in range(n)]
        sts, names = job.run(teams, args, case.get("rounds", 1))
        if len(names) == 1 and n > 1:
            names = names * n
        out.append([(sts[r], names[r],
                     None if sts[r] != "OK" else
                     _bytes(tp.result_of(case, r, srcs, dsts)))
                    for r in range(n)])
    return out


def _bytes(b):
    if b is None:
        return None
    return bytes(b) if not isinstance(b, np.ndarray) else b.tobytes()


def assert_same(got, want, cases):
    """Per case and rank: equal status, algorithm and result bytes."""
    assert len(got) == len(want)
    for case, g, w in zip(cases, got, want):
        for r, (gr, wr) in enumerate(zip(g, w)):
            assert gr[0] == wr[0], (case, r, gr[0], wr[0])
            assert gr[1] == wr[1], (case, r, gr[1], wr[1])
            assert gr[2] == wr[2], (case, r, "result bytes differ")
