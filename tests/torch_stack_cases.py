"""Shared jobs of the whole-stack tests (tests/test_torch_stack*.py): N
ranks of ucc_tpu_torch on device "cpu" and N ranks of ucc_tpu on the
virtual CPU mesh, each driving persistent collectives through lib ->
contexts -> team -> collective_init -> post/test, ROUNDS posts per
request."""
import contextlib
import os
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import torch

import ucc_tpu
from harness import UccJob

import ucc_tpu_torch as ut
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy

N = 8
ROUNDS = 3


class TorchJob:
    """N ranks of ucc_tpu_torch in one process: a Lib and a Context each,
    bootstrapped by a thread OOB (contexts are created in threads: the
    address exchange blocks), then driven cooperatively."""

    def __init__(self, n: int, lib_params=None):
        self.n = n
        world = ut.ThreadOobWorld(n)
        libs = [ut.init(lib_params) for _ in range(n)]
        self.contexts = [None] * n
        errs = []

        def make(r):
            try:
                self.contexts[r] = ut.Context(
                    libs[r], ut.ContextParams(oob=world.endpoint(r)))
            except Exception as e:  # noqa: BLE001 - re-raised below
                errs.append(e)

        threads = [threading.Thread(target=make, args=(r,))
                   for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        if errs:
            raise errs[0]
        tworld = ut.ThreadOobWorld(n)
        self.teams = [c.create_team_post(ut.TeamParams(oob=tworld.endpoint(r)))
                      for r, c in enumerate(self.contexts)]
        self.progress_until(lambda: all(
            [t.create_test() == ut.Status.OK for t in self.teams]))

    def progress_until(self, cond, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while not cond():
            for c in self.contexts:
                c.progress()
            if time.monotonic() > deadline:
                raise TimeoutError("progress_until timed out")

    def persistent(self, coll, hosts, op, dt, dst_count=None,
                   inplace=False, root=None, alg="ring_cuda"):
        """Post one persistent request per rank ROUNDS times; returns each
        round's per-rank dst as numpy arrays. Out of place, *hosts* are
        the srcs and each dst has *dst_count* elements (default: the src's)
        filled with 7 before every round; in place, *hosts* are each
        rank's dst, restored before every round. With a *root* (bcast),
        each rank passes its host as src alone, restored before every
        round, and the src is the result. *alg* is the algorithm the
        requests must have selected."""
        srcs = [from_numpy(h, "cpu") for h in hosts]
        if inplace or root is not None:
            dsts = [s.clone() for s in srcs]
        else:
            dsts = [torch.empty(dst_count or s.numel(), dtype=s.dtype)
                    for s in srcs]
        mt = ut.MemoryType.CUDA

        def args(r):
            dst = ut.BufferInfo(dsts[r], dsts[r].numel(), dt, mem_type=mt)
            if root is not None:
                return ut.CollArgs(coll_type=coll, root=root, src=dst,
                                   flags=ut.CollArgsFlags.PERSISTENT)
            if inplace:
                return ut.CollArgs(
                    coll_type=coll, op=op, dst=dst,
                    flags=ut.CollArgsFlags.PERSISTENT |
                    ut.CollArgsFlags.IN_PLACE)
            return ut.CollArgs(
                coll_type=coll, op=op, dst=dst,
                src=ut.BufferInfo(srcs[r], srcs[r].numel(), dt, mem_type=mt),
                flags=ut.CollArgsFlags.PERSISTENT)

        reqs = [self.teams[r].collective_init(args(r)) for r in range(self.n)]
        assert reqs[0].task.alg_name == alg
        rounds = []
        for _ in range(ROUNDS):
            for d, s in zip(dsts, srcs):
                if inplace or root is not None:
                    d.copy_(s)
                else:
                    d.fill_(7)           # every round must rewrite dst
            for rq in reqs:
                rq.post()
            self.progress_until(lambda: all(
                [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]))
            assert all(rq.test() == ut.Status.OK for rq in reqs)
            rounds.append([to_numpy(d) for d in dsts])
        assert reqs[0]._fast          # re-posts took the fast lane
        for rq in reqs:
            rq.finalize()
        return rounds

    def persistent_allreduce(self, hosts, op, dt):
        return self.persistent(ut.CollType.ALLREDUCE, hosts, op, dt)

    def cleanup(self) -> None:
        for t in self.teams:
            t.destroy()
        for c in self.contexts:
            c.destroy()


@contextlib.contextmanager
def _env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: v for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def make_jax_job(tune: str, tl: str = "ring_dma", n: int = N):
    """(UccJob, teams) of *n* ranks with tl/<tl> tuned by *tune*."""
    with _env(**{f"UCC_TL_{tl.upper()}_TUNE": tune}):
        job = UccJob(n)
        return job, job.create_team()


def make_torch_job(tune: str = "", n: int = N, lib_params=None, **env):
    """A TorchJob of *n* ranks on device "cpu", its libs made with
    *lib_params*; *tune*, if given, tunes tl/ring_cuda; *env* holds
    further variables, set while the job is made."""
    env["UCC_TL_RING_CUDA_DEVICE"] = "cpu"
    if tune:
        env["UCC_TL_RING_CUDA_TUNE"] = tune
    with _env(**env):
        return TorchJob(n, lib_params)


def jax_persistent(job, teams, coll, hosts, op, dt, dst_count=None,
                   tl="ring_dma"):
    """tl/<tl>'s counterpart of ``TorchJob.persistent`` (out of place
    only: its device TLs rebind ``dst.buffer`` to the result array)."""
    count = hosts[0].size
    argses = []
    for r in range(N):
        dev = job.contexts[r].tl_contexts[tl].obj.device
        argses.append(ucc_tpu.CollArgs(
            coll_type=coll, op=op,
            src=ucc_tpu.BufferInfo(jax.device_put(jnp.asarray(hosts[r]), dev),
                                   count, dt,
                                   mem_type=ucc_tpu.MemoryType.TPU),
            dst=ucc_tpu.BufferInfo(None, dst_count or count, dt,
                                   mem_type=ucc_tpu.MemoryType.TPU),
            flags=ucc_tpu.CollArgsFlags.PERSISTENT))
    reqs = [teams[r].collective_init(argses[r]) for r in range(N)]
    assert reqs[0].task.alg_name == ("ring_dma" if tl == "ring_dma" else "xla")
    rounds = []
    for _ in range(ROUNDS):
        for rq in reqs:
            rq.post()
        job.progress_until(lambda: all(
            [rq.test() != ucc_tpu.Status.IN_PROGRESS for rq in reqs]))
        assert all(rq.test() == ucc_tpu.Status.OK for rq in reqs)
        rounds.append([np.asarray(a.dst.buffer) for a in argses])
    for rq in reqs:
        rq.finalize()
    return rounds


def jax_persistent_bcast(job, teams, hosts, root, dt, tl="ring_dma"):
    """tl/<tl>'s bcast from *root*, each rank passing its host as src
    alone, posted ROUNDS times; each round's per-rank result (the rebound
    ``src.buffer``)."""
    count = hosts[0].size
    argses = []
    for r in range(N):
        dev = job.contexts[r].tl_contexts[tl].obj.device
        argses.append(ucc_tpu.CollArgs(
            coll_type=ucc_tpu.CollType.BCAST, root=root,
            src=ucc_tpu.BufferInfo(jax.device_put(jnp.asarray(hosts[r]), dev),
                                   count, dt,
                                   mem_type=ucc_tpu.MemoryType.TPU),
            flags=ucc_tpu.CollArgsFlags.PERSISTENT))
    reqs = [teams[r].collective_init(argses[r]) for r in range(N)]
    assert reqs[0].task.alg_name == ("ring_dma" if tl == "ring_dma" else "xla")
    rounds = []
    for _ in range(ROUNDS):
        for rq in reqs:
            rq.post()
        job.progress_until(lambda: all(
            [rq.test() != ucc_tpu.Status.IN_PROGRESS for rq in reqs]))
        assert all(rq.test() == ucc_tpu.Status.OK for rq in reqs)
        rounds.append([np.asarray(a.src.buffer) for a in argses])
    for rq in reqs:
        rq.finalize()
    return rounds


def jax_persistent_allreduce(job, teams, hosts, op, dt):
    return jax_persistent(job, teams, ucc_tpu.CollType.ALLREDUCE, hosts, op,
                          dt)


def bits(a):
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


# ---------------------------------------------------------------------------
# any collective on both sides: rooted, v- and buffer-less ones included
# ---------------------------------------------------------------------------

class Buf:
    """One buffer of a rank on both sides: *data* (numpy) or, for a result
    buffer, *size* elements (7s in the port, no buffer in the reference,
    whose device TLs rebind it); with *counts* (and *displs*) a
    BufferInfoV."""

    def __init__(self, data=None, size=None, counts=None, displs=None):
        self.data, self.counts, self.displs = data, counts, displs
        self.size = int(data.size) if size is None else int(size)


def torch_buffer_info(b, dt, td):
    """The port's BufferInfo(V) of *b* on device "cpu", CUDA memory."""
    if b is None:
        return None
    t = from_numpy(b.data, "cpu") if b.data is not None else \
        torch.full((b.size,), 7, dtype=td)
    mt = ut.MemoryType.CUDA
    if b.counts is not None:
        return ut.BufferInfoV(t, b.counts, b.displs, dt, mem_type=mt)
    return ut.BufferInfo(t, b.size, dt, mem_type=mt)


def jax_buffer_info(job, r, b, dt, tl="xla"):
    """The reference's BufferInfo(V) of *b* on rank r's device."""
    if b is None:
        return None
    arr = None
    if b.data is not None:
        dev = job.contexts[r].tl_contexts[tl].obj.device
        arr = jax.device_put(jnp.asarray(b.data), dev)
    mt = ucc_tpu.MemoryType.TPU
    if b.counts is not None:
        return ucc_tpu.BufferInfoV(arr, b.counts, b.displs, dt, mem_type=mt)
    return ucc_tpu.BufferInfo(arr, b.size, dt, mem_type=mt)


def _result(bi, to_np):
    if bi is None or bi.buffer is None:
        return None
    return to_np(bi.buffer)


def torch_coll(job, coll, bufs, dt, op=None, root=0, alg="xla",
               inplace=False, rounds=ROUNDS):
    """*coll* on every rank of a TorchJob, rank r passing ``bufs[r] =
    (src Buf, dst Buf)`` (either None); persistent, posted *rounds* times,
    every result buffer refilled with 7 (or its data) before each round.
    Asserts that every rank selected *alg*; returns each round's per-rank
    result, the dst's tensor (the src's where there is no dst), as numpy
    (None where a rank has neither)."""
    td = ut.dt_torch(ut.DataType[dt])
    flags = ut.CollArgsFlags.PERSISTENT
    if inplace:
        flags |= ut.CollArgsFlags.IN_PLACE
    argses = [ut.CollArgs(coll_type=ut.CollType[coll], root=root,
                          op=None if op is None else ut.ReductionOp[op],
                          src=torch_buffer_info(s, ut.DataType[dt], td),
                          dst=torch_buffer_info(d, ut.DataType[dt], td),
                          flags=flags) for s, d in bufs]
    first = [[None if bi is None else bi.buffer.clone()
              for bi in (a.src, a.dst)] for a in argses]
    reqs = [job.teams[r].collective_init(a) for r, a in enumerate(argses)]
    assert [rq.task.alg_name for rq in reqs] == [alg] * job.n
    out = []
    for _ in range(rounds):
        for a, (s0, d0) in zip(argses, first):
            for bi, t0 in ((a.src, s0), (a.dst, d0)):
                if bi is not None:
                    bi.buffer.copy_(t0)
        for rq in reqs:
            rq.post()
        job.progress_until(lambda: all(
            [rq.test() != ut.Status.IN_PROGRESS for rq in reqs]))
        assert all(rq.test() == ut.Status.OK for rq in reqs)
        out.append([_result(a.dst if a.dst is not None else a.src,
                            to_numpy) for a in argses])
    for rq in reqs:
        rq.finalize()
    return out


def jax_coll(job, teams, coll, bufs, dt, op=None, root=0, alg="xla",
             tl="xla"):
    """The reference's *coll* through tl/<tl>, rank r passing ``bufs[r]``
    (one post); each rank's result, the rebound dst (the src where there
    is no dst), as numpy (None where a rank has neither)."""
    argses = [ucc_tpu.CollArgs(
        coll_type=ucc_tpu.CollType[coll], root=root,
        op=None if op is None else ucc_tpu.ReductionOp[op],
        src=jax_buffer_info(job, r, s, ucc_tpu.DataType[dt], tl),
        dst=jax_buffer_info(job, r, d, ucc_tpu.DataType[dt], tl))
        for r, (s, d) in enumerate(bufs)]
    reqs = [teams[r].collective_init(a) for r, a in enumerate(argses)]
    assert [rq.task.alg_name for rq in reqs] == [alg] * len(teams)
    for rq in reqs:
        rq.post()
    job.progress_until(lambda: all(
        [rq.test() != ucc_tpu.Status.IN_PROGRESS for rq in reqs]))
    assert all(rq.test() == ucc_tpu.Status.OK for rq in reqs)
    out = [_result(a.dst if a.dst is not None else a.src, np.asarray)
           for a in argses]
    for rq in reqs:
        rq.finalize()
    return out
