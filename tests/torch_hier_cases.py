"""Shared jobs of the port's hierarchy tests (tests/test_torch_cl_hier*.py,
tests/test_torch_hier_nlevel.py): N in-process ranks of either package
under a simulated topology, contexts and teams made with the knobs set
only while they are read, and the helpers that put the same numpy inputs
through both packages.

The fake-topology knobs (UCC_TOPO_FAKE_PPN, UCC_TOPO_FAKE_NODES_PER_POD)
and the cl/hier context knobs are read at context creation, TUNE strings
at team creation: ``HierJob`` sets them for exactly those calls and
restores the environment after, so that nothing leaks into other test
files of the same worker.
"""
import contextlib
import os
import threading
import time

import numpy as np
import torch

import ucc_tpu
import ucc_tpu_torch as ut
from ucc_tpu_torch.score.score_map import ScoreMap
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy

N = 8


@contextlib.contextmanager
def env(**values):
    """Set (or, with None, unset) environment variables; restore them."""
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


#: every knob either package reads that a test may set
KNOBS = ("UCC_TOPO_FAKE_PPN", "UCC_TOPO_FAKE_NODES_PER_POD", "UCC_TLS",
         "UCC_CL_HIER_TUNE", "UCC_CL_HIER_NODE_TLS",
         "UCC_CL_HIER_ALLREDUCE_RAB_PIPELINE",
         "UCC_CL_HIER_ALLREDUCE_SPLIT_RAIL_PIPELINE", "UCC_TL_SHM_TUNE",
         "UCC_TL_XLA_TUNE", "UCC_TL_TORCH_OPS_TUNE", "UCC_GEN_NATIVE",
         "UCC_TL_RING_CUDA_TUNE")


class HierJob:
    """N ranks of one package (*mod*: ucc_tpu or ucc_tpu_torch) in this
    process, a Lib and a Context each over a thread OOB (contexts made in
    threads: the address exchange blocks), made under *ctx_env*; the
    port's device TLs run on device "cpu"."""

    def __init__(self, mod, n=N, **ctx_env):
        self.mod, self.n = mod, n
        world = mod.ThreadOobWorld(n)
        clean = {k: None for k in KNOBS}
        clean.update(ctx_env)
        if mod is ut:
            clean.setdefault("UCC_TL_RING_CUDA_DEVICE", "cpu")
        else:
            # the JAX package's classic host generators, which the port's
            # host TLs are bitwise
            clean.setdefault("UCC_GEN_NATIVE", "n")
        self.ctx_env = clean
        with env(**clean):
            libs = [mod.init() for _ in range(n)]
            self.contexts = [None] * n
            errs = []

            def make(r):
                try:
                    self.contexts[r] = mod.Context(
                        libs[r], mod.ContextParams(oob=world.endpoint(r)))
                except Exception as e:  # noqa: BLE001 - re-raised below
                    errs.append(e)

            ths = [threading.Thread(target=make, args=(r,))
                   for r in range(n)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=60)
        if errs:
            raise errs[0]
        self.made = []

    def team(self, ranks=None, **team_env):
        """A team over *ranks* (default all), made under the job's
        context environment plus *team_env* (TUNE strings); the
        per-member list in team-rank order."""
        ranks = list(range(self.n)) if ranks is None else list(ranks)
        world = self.mod.ThreadOobWorld(len(ranks))
        values = dict(self.ctx_env)
        values.update(team_env)
        with env(**values):
            teams = [self.contexts[r].create_team_post(
                self.mod.TeamParams(oob=world.endpoint(i)))
                for i, r in enumerate(ranks)]
            self.until(lambda: all(
                [t.create_test() != self.mod.Status.IN_PROGRESS
                 for t in teams]))
        assert [t.create_test() for t in teams] == \
            [self.mod.Status.OK] * len(teams)
        self.made.append(teams)
        return teams

    def until(self, cond, timeout=60.0):
        deadline = time.monotonic() + timeout
        while not cond():
            for c in self.contexts:
                c.progress()
            if time.monotonic() > deadline:
                raise TimeoutError("progress timed out")

    def init(self, teams, argses):
        return [t.collective_init(a) for t, a in zip(teams, argses)]

    def run(self, teams, argses, rounds=1):
        """collective_init on every member, *rounds* posts; returns the
        per-rank algorithm names (each round must end OK)."""
        reqs = self.init(teams, argses)
        for _ in range(rounds):
            self.post_wait(reqs)
        names = [rq.task.alg_name for rq in reqs]
        for rq in reqs:
            rq.finalize()
        return names

    def post_wait(self, reqs):
        for rq in reqs:
            rq.post()
        self.until(lambda: all(
            [rq.test() != self.mod.Status.IN_PROGRESS for rq in reqs]))
        assert [rq.test() for rq in reqs] == \
            [self.mod.Status.OK] * len(reqs)

    def cleanup(self):
        for teams in self.made:
            for t in teams:
                t.destroy()
        for c in self.contexts:
            c.destroy()


def hier_team_of(team):
    for clt in team.cl_teams:
        if clt.name == "hier":
            return clt
    return None


def bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def ints(rng, count, dtype=np.float32, lo=-64, hi=64):
    """Integer-valued data: every summation order gives the same bits."""
    return rng.integers(lo, hi, size=count).astype(dtype)


# ---------------------------------------------------------------------------
# selection: candidate lists and print_info rows under the TL name mapping
# ---------------------------------------------------------------------------

#: reference TL name -> the port's
TL_NAMES = {"xla": "torch_ops", "ring_dma": "ring_cuda"}


def candidates(team, coll, mem, msgsize, comps=None):
    """(component, algorithm, score) of every candidate, the reference's
    TL names mapped to the port's; only *comps* when given."""
    out = []
    for r in team.score_map.lookup(coll, mem, msgsize):
        comp = getattr(r.team, "NAME", None) or getattr(r.team, "name", "?")
        comp = TL_NAMES.get(comp, comp)
        if comps is None or comp in comps:
            out.append((comp, r.alg_name, r.score))
    return out


def hier_rows(team, mod):
    """The hier team's own score map as ``print_info`` prints it, in the
    port's words (memory ``tpu`` -> ``cuda``)."""
    ht = hier_team_of(team)
    if mod is ucc_tpu:
        from ucc_tpu.score.score_map import ScoreMap as JScoreMap
        text = JScoreMap(ht.get_scores()).print_info("t")
        return text.replace("ucc_tpu score map", "score map").replace(
            "/tpu  ", "/cuda ")
    text = ScoreMap(ht.get_scores()).print_info("t")
    return text.replace("ucc_tpu_torch score map", "score map")


# ---------------------------------------------------------------------------
# buffers on both sides
# ---------------------------------------------------------------------------

def port_cuda(arr):
    """A CPU tensor holding *arr*, to pass as CUDA memory (device cpu)."""
    return from_numpy(arr, "cpu")


def ref_tpu(job, r, arr):
    """A jax array holding *arr* on rank r's device (TPU memory)."""
    import jax
    import jax.numpy as jnp
    h = job.contexts[r].tl_contexts.get("xla")
    devs = jax.devices()
    dev = h.obj.device if h is not None else devs[r % len(devs)]
    return jax.device_put(jnp.asarray(arr), dev)


def result(bi):
    """A result buffer as numpy: a tensor, a jax array or numpy."""
    buf = bi.buffer
    if isinstance(buf, torch.Tensor):
        return to_numpy(buf)
    return np.asarray(buf)
