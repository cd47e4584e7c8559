"""In-process jobs of the port for the fault-tolerance tests: n ranks,
each with its own lib and context over a thread OOB (contexts made in
threads), teams over subsets, driven cooperatively from one thread. The
shape of the JAX package's ``tests/harness.UccJob``."""
import os
import threading
import time

import numpy as np

import ucc_tpu_torch as ut

#: heartbeat-timeout scale for loaded runs (the JAX package's
#: tests/test_ft_shrink.py factor): under a full xdist suite a survivor's
#: progress loop can stall past a tight timeout and condemn a healthy
#: rank. UCC_TEST_LOAD_FACTOR=1 restores the unscaled timeouts.
try:
    LOAD = float(os.environ.get("UCC_TEST_LOAD_FACTOR", "") or 5.0)
except ValueError:
    LOAD = 5.0


class FtJob:
    def __init__(self, n, **lib):
        self.n = n
        world = ut.ThreadOobWorld(n)
        libs = [ut.init(**lib) for _ in range(n)]
        self.contexts = [None] * n
        errs = []

        def make(r):
            try:
                self.contexts[r] = ut.Context(libs[r], ut.ContextParams(
                    oob=world.endpoint(r)))
            except Exception as e:  # noqa: BLE001 - raised below
                errs.append(e)
        ths = [threading.Thread(target=make, args=(r,)) for r in range(n)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        if errs:
            raise errs[0]
        self.teams = []

    def create_team(self, ranks=None, timeout=30.0):
        ranks = list(ranks) if ranks is not None else list(range(self.n))
        world = ut.ThreadOobWorld(len(ranks))
        teams = [self.contexts[r].create_team_post(
            ut.TeamParams(oob=world.endpoint(i)))
            for i, r in enumerate(ranks)]
        deadline = time.monotonic() + timeout
        while True:
            sts = [t.create_test() for t in teams]
            for r in ranks:
                self.contexts[r].progress()
            if all(s == ut.Status.OK for s in sts):
                break
            bad = [s for s in sts if s.is_error]
            if bad:
                raise ut.UccError(bad[0], "team create failed")
            if time.monotonic() > deadline:
                raise TimeoutError("team create timed out")
        self.teams.append(teams)
        return teams

    def run_coll(self, teams, make_args, timeout=30.0):
        reqs = [t.collective_init(make_args(i)) for i, t in enumerate(teams)]
        for rq in reqs:
            rq.post()
        self.progress_until(lambda: all(
            [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]), timeout)
        for rq in reqs:
            assert rq.test() == ut.Status.OK, rq.test()
        return reqs

    def progress_until(self, cond, timeout=30.0):
        deadline = time.monotonic() + timeout
        while not cond():
            for c in self.contexts:
                c.progress()
            if time.monotonic() > deadline:
                raise TimeoutError("progress_until timed out")

    def cleanup(self):
        for teams in self.teams:
            for t in teams:
                t.destroy()
        for c in self.contexts:
            c.destroy()


def ar_args(rank, count=16, pkg=ut):
    """(allreduce args, dst) of a float64 SUM of rank + 1 in *pkg*'s
    types (the port by default, ``ucc_tpu`` for the JAX package)."""
    dst = np.zeros(count, np.float64)
    args = pkg.CollArgs(coll_type=pkg.CollType.ALLREDUCE,
                        src=pkg.BufferInfo(np.full(count, rank + 1.0), count,
                                           pkg.DataType.FLOAT64),
                        dst=pkg.BufferInfo(dst, count, pkg.DataType.FLOAT64),
                        op=pkg.ReductionOp.SUM)
    return args, dst


def drive(ctxs, cond, timeout=15.0):
    """Progress every context until cond() (True) or the deadline
    (False)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for c in ctxs:
            c.progress()
        if cond():
            return True
    return False


def grow_to_full(job, teams, joiner_idx, timeout=20.0):
    """grow_post on every member of *teams* (index -> team) and join_post
    on the joiner; returns (grows, join request). Every membership
    request is polled each pass (a list, not a short-circuiting all()):
    test() drives the rebuild rounds."""
    joiner_ctx = job.contexts[joiner_idx].rank
    grows = {r: t.grow_post([joiner_ctx]) for r, t in teams.items()}
    jn = ut.Team.join_post(job.contexts[joiner_idx])
    assert drive(job.contexts, lambda: all(
        [g.test() != ut.Status.IN_PROGRESS for g in grows.values()]
        + [jn.test() != ut.Status.IN_PROGRESS]), timeout)
    return grows, jn
