"""ucc_perftest — collective and executor benchmark CLI of ucc_tpu_torch.

Mirrors UCC's ucc_perftest and the JAX package's tools/perftest.py: an
exponential size sweep ``-b..-e``, warmup + iterations, per-size
avg/min/max/p50/p99 latency and, with ``-F``, bus bandwidth; ``--json``
prints one record per size in the JAX perftest's shape.

Two benchmark paths:
- collectives (``-c allreduce|reduce_scatter|allgather|bcast|alltoall``):
  ``-p N`` in-process ranks (default 4), each a context over a thread OOB,
  one team, collective_init/post/test per round (``--persistent``: init
  once, post many; ``-S``: post every round before waiting). The score map
  selects tl/torch_ops for all five, as the JAX perftest selects tl/xla on
  device memory: ``short`` below its threshold (4 KiB on a GPU, 128 KiB on
  ``cpu``; reduce_scatter has none), ``xla`` above
  (``UCC_TL_RING_CUDA_TUNE=allreduce:@ring_cuda:inf`` pins the ring for
  one). On ``-m cuda``, the default, every rank's buffers go on the
  device that ``UCC_TL_RING_CUDA_DEVICE`` names for every device TL
  (default ``cuda``, which raises without a GPU; ``cpu`` runs on the CPU),
  and the ranks of a team share that one card. On ``-m host`` the
  buffers are CPU tensors and tl/shm serves every collective (its
  ``tl/host`` algorithms over the in-process transport, the native
  matcher when it builds); ``detail.transport`` is then ``shm-thread``,
  the JAX perftest's name of that tier;
- executor ops (``-c memcpy|reducedt|reducedt_strided``, UCC's
  ucc_pt_op_{memcpy,reduce,reduce_strided}): the execution component's
  copy/reduce tasks timed directly, no team; ``--nbufs`` sources (caps 7
  for copy, 9 for reduce). On ``-m cuda`` the reduces launch the kernel of
  ``kernels/ec_reduce.py``; ``-m host`` times the numpy host executor.

Examples::

    python -m ucc_tpu_torch.tools.perftest -c allreduce -p 8 -b 4K -e 64M
    python -m ucc_tpu_torch.tools.perftest -c reducedt -d bfloat16 --nbufs 9 -F
    UCC_TL_RING_CUDA_DEVICE=cpu python -m ucc_tpu_torch.tools.perftest -c bcast -p 4
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

import ucc_tpu_torch
from ucc_tpu_torch import (BufferInfo, CollArgs, CollArgsFlags, CollType,
                           Context, ContextParams, DataType, MemoryType,
                           ReductionOp, Status, TeamParams, ThreadOobWorld,
                           UccError)
from ucc_tpu_torch.constants import coll_type_str, dt_size, dt_torch
from ucc_tpu_torch.utils.config import memunits_str, parse_memunits

#: the collectives the port's device TLs serve
COLLS = {coll_type_str(c): c for c in (
    CollType.ALLREDUCE, CollType.REDUCE_SCATTER, CollType.ALLGATHER,
    CollType.BCAST, CollType.ALLTOALL)}
#: executor-op benchmarks (ucc_pt_config.h MEMCPY/REDUCEDT/
#: REDUCEDT_STRIDED): time the EC component directly, no team involved
OP_BENCHES = ("memcpy", "reducedt", "reducedt_strided")
OPS = {o.name.lower(): o for o in ReductionOp}
DTS = {d.name.lower(): d for d in DataType}


def lat_stats(lats) -> dict:
    """avg/min/max plus p50/p99 (microseconds) from second-samples.
    p99 is linearly interpolated (np.percentile default) — with few
    iterations it converges to max, which is the honest reading."""
    a = np.asarray(lats, dtype=np.float64) * 1e6
    return {"avg_us": float(a.mean()), "min_us": float(a.min()),
            "max_us": float(a.max()),
            "p50_us": float(np.percentile(a, 50)),
            "p99_us": float(np.percentile(a, 99))}


def busbw_factor(coll: CollType, n: int) -> float:
    """Bus-bandwidth factors (ucc_pt_benchmark.cc bus bw computation)."""
    if n <= 1:
        return 1.0
    if coll == CollType.ALLREDUCE:
        return 2.0 * (n - 1) / n
    if coll in (CollType.ALLGATHER, CollType.REDUCE_SCATTER,
                CollType.ALLTOALL):
        return float(n - 1) / n
    return 1.0


def make_args(coll: CollType, n: int, count: int, dt: DataType,
              op: ReductionOp, mem: MemoryType, inplace: bool, root: int,
              persistent: bool, device: torch.device) -> CollArgs:
    """One rank's args: src buffers of ones, dst buffers of zeros, all on
    *device*. bcast passes src alone, as UCC's bcast does."""
    td = dt_torch(dt)
    flags = CollArgsFlags(0)
    if inplace:
        flags |= CollArgsFlags.IN_PLACE
    if persistent:
        flags |= CollArgsFlags.PERSISTENT

    def buf(c):
        return BufferInfo(torch.ones(c, dtype=td, device=device), c, dt,
                          mem_type=mem)

    def out(c):
        return BufferInfo(torch.zeros(c, dtype=td, device=device), c, dt,
                          mem_type=mem)

    if coll == CollType.ALLREDUCE:
        a = CollArgs(coll_type=coll, op=op, flags=flags)
        if inplace:
            a.dst = buf(count)
            a.src = a.dst
        else:
            a.src = buf(count)
            a.dst = out(count)
        return a
    if coll == CollType.ALLGATHER:
        return CollArgs(coll_type=coll, src=buf(count), dst=out(count * n),
                        flags=flags)
    if coll == CollType.ALLTOALL:
        return CollArgs(coll_type=coll, src=buf(count * n),
                        dst=out(count * n), flags=flags)
    if coll == CollType.BCAST:
        return CollArgs(coll_type=coll, root=root, src=buf(count),
                        flags=flags)
    if coll == CollType.REDUCE_SCATTER:
        return CollArgs(coll_type=coll, op=op, src=buf(count * n),
                        dst=out(count), flags=flags)
    raise SystemExit(f"perftest: coll {coll_type_str(coll)} not wired")


def resolve_mem(name: str) -> MemoryType:
    try:
        mem = MemoryType.parse(name)
    except ValueError as e:
        raise SystemExit(f"perftest: {e}") from None
    if mem not in (MemoryType.HOST, MemoryType.CUDA):
        raise SystemExit(f"perftest: -m takes host or cuda, not {name}")
    return mem


def buffer_device(mem: MemoryType) -> torch.device:
    """Where -m's buffers go: the CPU for host; for cuda, the device that
    the device TLs' DEVICE config names (UCC_TL_RING_CUDA_DEVICE), which
    raises when it names CUDA and there is none."""
    if mem == MemoryType.HOST:
        return torch.device("cpu")
    from ..tl.device import DEVICE_CONFIG, resolve_device
    from ..utils.config import Config
    return resolve_device(Config(DEVICE_CONFIG).device)


def run_op_bench(args) -> int:
    """Executor-op benchmark path (ucc_pt_op_{memcpy,reduce,
    reduce_strided}.cc): times the EC component's copy/reduce tasks
    directly — no team, no transport. BW formulas match UCC's: memcpy
    2*S/t (read+write) per vector; reduce (nbufs+1)*S/t (nbufs reads +
    one write)."""
    from ..ec.base import (EXECUTOR_NUM_BUFS, MULTI_OP_NUM_BUFS,
                           create_executor)

    dt = DTS[args.dtype]
    op = OPS[args.op]
    mem = resolve_mem(args.mem)
    esz = dt_size(dt)
    td = dt_torch(dt)
    nbufs = args.nbufs if args.nbufs is not None else \
        (1 if args.coll == "memcpy" else 2)
    if args.coll == "memcpy":
        # copy_multi's vector cap (ucc_ec_base.h) is 7, tighter than the
        # 9-source reduce cap
        if not 1 <= nbufs <= MULTI_OP_NUM_BUFS:
            raise SystemExit("perftest: memcpy needs 1 <= nbufs <= "
                             f"{MULTI_OP_NUM_BUFS}")
    elif not 2 <= nbufs <= EXECUTOR_NUM_BUFS:
        raise SystemExit("perftest: reducedt needs 2 <= nbufs <= "
                         f"{EXECUTOR_NUM_BUFS}")

    device = buffer_device(mem)
    ec = create_executor(mem)

    def alloc(count):
        return torch.ones(count, dtype=td, device=device)

    def block(task):
        while ec.task_test(task) == Status.IN_PROGRESS:
            pass
        if task.status != Status.OK:
            raise SystemExit(f"perftest: {args.coll} task failed: "
                             f"{task.status.name}")

    if not args.json:
        print(f"# ucc_perftest: {args.coll} {args.dtype}"
              + (f" {args.op}" if args.coll != "memcpy" else "")
              + f" mem={args.mem} nbufs={nbufs}")
        hdr = f"{'count':>12} {'size':>10} {'time avg(us)':>14} " \
              f"{'min(us)':>10} {'max(us)':>10} {'p50(us)':>10} " \
              f"{'p99(us)':>10}"
        if args.full:
            hdr += f" {'bw(GB/s)':>10}"
        print(hdr)

    size = max(parse_memunits(args.begin), esz)
    bmax = parse_memunits(args.end)
    while size <= bmax:
        count = max(1, size // esz)
        nbytes = count * esz
        if args.coll == "memcpy":
            srcs = [alloc(count) for _ in range(nbufs)]
            dsts = [alloc(count) for _ in range(nbufs)]

            def round_fn():
                if nbufs == 1:
                    return ec.copy(dsts[0], srcs[0], nbytes)
                return ec.copy_multi(list(zip(dsts, srcs,
                                              [nbytes] * nbufs)))
            # UCC sums ALL copy_multi vectors before the x2 read+write
            # factor (ucc_pt_op_memcpy.cc get_bw)
            factor = 2.0 * nbufs
        elif args.coll == "reducedt":
            srcs = [alloc(count) for _ in range(nbufs)]
            dst = alloc(count)

            def round_fn():
                return ec.reduce(dst, srcs, count, dt, op)
            factor = float(nbufs + 1)
        else:                                    # reducedt_strided
            src1 = alloc(count)
            base = alloc(count * (nbufs - 1))
            dst = alloc(count)

            def round_fn():
                return ec.reduce_strided(dst, src1, base, nbytes,
                                         nbufs - 1, count, dt, op)
            factor = float(nbufs + 1)

        lats = []
        for i in range(args.warmup + args.iters):
            t0 = time.perf_counter()
            block(round_fn())
            t1 = time.perf_counter()
            if i >= args.warmup:
                lats.append(t1 - t0)
        st = lat_stats(lats)
        bw = factor * nbytes / (st["avg_us"] / 1e6) / 1e9
        if args.json:
            rec = {"bench": "op", "op": args.coll, "dtype": args.dtype,
                   "mem": args.mem, "nbufs": nbufs, "count": count,
                   "size_bytes": nbytes,
                   **{k: round(v, 3) for k, v in st.items()},
                   "detail": {"transport": "local"}}
            if args.full:
                rec["bw_GBps"] = round(bw, 3)
            print(json.dumps(rec), flush=True)
        else:
            line = f"{count:>12} {memunits_str(nbytes):>10} " \
                   f"{st['avg_us']:>14.2f} {st['min_us']:>10.2f} " \
                   f"{st['max_us']:>10.2f} {st['p50_us']:>10.2f} " \
                   f"{st['p99_us']:>10.2f}"
            if args.full:
                line += f" {bw:>10.3f}"
            print(line)
        size *= 2
    return 0


#: detail.transport of a collective record on device memory: its data
#: moves through a device TL, not a host transport, so there is no host
#: tier to name
TRANSPORT = "unknown"


def transport_tier(team) -> str:
    """The host transport tier serving a team's host tag spaces, as the
    JAX perftest names it: ``socket`` or ``shm-thread`` (in-process
    mailboxes). The port's only host transport is the in-process one;
    "unknown" when the team has no host tag space."""
    try:
        spaces = team._tl_tag_spaces()
    except Exception:  # noqa: BLE001 - classification must not kill a run
        return "unknown"
    if not spaces:
        return "unknown"
    if any("Socket" in type(tr).__name__ for _key, tr in spaces):
        return "socket"
    return "shm-thread"


class InProcJob:
    """n ranks in this process: a lib and a context each over a thread
    OOB (contexts are created in threads: the address exchange blocks),
    and one team."""

    def __init__(self, n: int, create_timeout: float = 120.0):
        self.n = n
        world = ThreadOobWorld(n)
        self.libs = [ucc_tpu_torch.init() for _ in range(n)]
        self.contexts: List[Optional[Context]] = [None] * n
        self.teams = []
        errs: List[Exception] = []

        def mk(r):
            try:
                self.contexts[r] = Context(
                    self.libs[r], ContextParams(oob=world.endpoint(r)))
            except Exception as e:  # noqa: BLE001 - surfaced below
                errs.append(e)

        ths = [threading.Thread(target=mk, args=(r,)) for r in range(n)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=create_timeout)
        if errs:
            self.destroy()
            raise errs[0]
        if any(c is None for c in self.contexts):
            raise SystemExit("context create timed out")
        tw = ThreadOobWorld(n)
        self.teams = [c.create_team_post(TeamParams(oob=tw.endpoint(i)))
                      for i, c in enumerate(self.contexts)]
        deadline = time.monotonic() + create_timeout
        while True:
            sts = [t.create_test() for t in self.teams]
            if all(s == Status.OK for s in sts):
                break
            if any(s.is_error for s in sts) or \
                    time.monotonic() > deadline:
                self.destroy()
                raise SystemExit("team create failed")
            for c in self.contexts:
                c.progress()

    def destroy(self) -> None:
        for t in self.teams:
            t.destroy()
        for c in self.contexts:
            if c is not None:
                c.destroy()
        self.teams, self.contexts = [], []

    def init_reqs(self, argses):
        return [self.teams[r].collective_init(argses[r])
                for r in range(self.n)]

    def post_and_wait(self, reqs) -> None:
        for rq in reqs:
            rq.post()
        wait_reqs(self, reqs)

    def run_round(self, argses) -> None:
        self.post_and_wait(self.init_reqs(argses))


def wait_reqs(job, reqs) -> None:
    # listified on purpose: a short-circuiting any() would stop testing
    # the later ranks' requests while an earlier one is in progress
    while any([rq.test() == Status.IN_PROGRESS for rq in reqs]):
        for c in job.contexts:
            c.progress()
    for rq in reqs:
        if rq.test().is_error:
            raise SystemExit(f"collective failed: {rq.test()}")


def run_coll_bench(args, job: InProcJob, coll: CollType, mem: MemoryType,
                   device: torch.device) -> int:
    dt = DTS[args.dtype]
    op = OPS[args.op]
    esz = dt_size(dt)
    n = job.n
    transport = transport_tier(job.teams[0]) if mem == MemoryType.HOST \
        else TRANSPORT
    if not args.json:
        hdr = f"{'count':>12} {'size':>10} {'time avg(us)':>14} " \
              f"{'min(us)':>10} {'max(us)':>10} {'p50(us)':>10} " \
              f"{'p99(us)':>10}"
        if args.full:
            hdr += f" {'bus bw(GB/s)':>14}"
        print(f"# ucc_perftest: {args.coll} {args.dtype} {args.op} "
              f"mem={args.mem} ranks={n} "
              f"transport={transport}")
        print(hdr)

    def argses(persistent):
        return [make_args(coll, n, count, dt, op, mem, args.inplace,
                          args.root, persistent, device) for _ in range(n)]

    size = max(parse_memunits(args.begin), esz)
    bmax = parse_memunits(args.end)
    while size <= bmax:
        count = max(1, size // esz)
        lats = []
        rounds = args.warmup + args.iters
        if args.persistent:
            # init once, post many (ucc.h persistent semantics); measured
            # time then excludes collective_init
            reqs = job.init_reqs(argses(True))
            for it in range(rounds):
                t0 = time.perf_counter()
                job.post_and_wait(reqs)
                if it >= args.warmup:
                    lats.append(time.perf_counter() - t0)
            for rq in reqs:
                rq.finalize()
        elif args.streaming:
            # streaming: init+post everything, single wait at the end;
            # the reported number is per-op amortized time
            all_argses = [argses(False) for _ in range(rounds)]
            for a in all_argses[:args.warmup]:
                job.run_round(a)
            t0 = time.perf_counter()
            inflight = [job.init_reqs(a) for a in all_argses[args.warmup:]]
            for reqs_ in inflight:
                for rq in reqs_:
                    rq.post()
            for reqs_ in inflight:
                wait_reqs(job, reqs_)
            lats = [(time.perf_counter() - t0) / args.iters]
        else:
            for it in range(rounds):
                a = argses(False)
                t0 = time.perf_counter()
                job.run_round(a)
                if it >= args.warmup:
                    lats.append(time.perf_counter() - t0)
        lats = np.array(lats)
        st = lat_stats(lats)
        bw = busbw_factor(coll, n) * size / lats.mean() / 1e9
        if args.json:
            rec = {"bench": "coll", "coll": args.coll,
                   "dtype": args.dtype, "op": args.op, "mem": args.mem,
                   "ranks": n, "count": count, "size_bytes": size,
                   "iters": args.iters,
                   **{k: round(v, 3) for k, v in st.items()}}
            if args.full:
                rec["busbw_GBps"] = round(bw, 3)
            rec["detail"] = {"transport": transport}
            print(json.dumps(rec), flush=True)
        else:
            line = f"{count:>12} {memunits_str(size):>10} " \
                   f"{st['avg_us']:>14.2f} {st['min_us']:>10.2f} " \
                   f"{st['max_us']:>10.2f} {st['p50_us']:>10.2f} " \
                   f"{st['p99_us']:>10.2f}"
            if args.full:
                line += f" {bw:>14.3f}"
            print(line, flush=True)
        size *= 2
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ucc_perftest")
    p.add_argument("-c", "--coll", default="allreduce",
                   choices=sorted(COLLS) + list(OP_BENCHES))
    p.add_argument("-b", "--begin", default="8", help="min size (bytes)")
    p.add_argument("-e", "--end", default="1M", help="max size (bytes)")
    p.add_argument("-n", "--iters", type=int, default=20)
    p.add_argument("-w", "--warmup", type=int, default=5)
    p.add_argument("-m", "--mem", default="cuda",
                   help="memory type: cuda (default) or host")
    p.add_argument("-d", "--dtype", default="float32", choices=sorted(DTS))
    p.add_argument("-o", "--op", default="sum", choices=sorted(OPS))
    p.add_argument("-r", "--root", type=int, default=0)
    p.add_argument("-i", "--inplace", action="store_true")
    p.add_argument("-F", "--full", action="store_true",
                   help="print bus bandwidth column")
    p.add_argument("--json", action="store_true",
                   help="one JSON line per size (machine-readable: "
                        "avg/min/max/p50/p99 us + busbw with -F) instead "
                        "of the latency table")
    p.add_argument("-p", "--nprocs", type=int, default=0,
                   help="in-process ranks (default 4; every rank of a "
                        "cuda team shares one GPU)")
    p.add_argument("--persistent", action="store_true",
                   help="persistent collectives (init once, post many)")
    p.add_argument("-S", "--streaming", action="store_true",
                   help="streaming mode: post every iteration before "
                        "waiting (throughput), vs default isolated mode "
                        "(per-op latency)")
    p.add_argument("--nbufs", type=int, default=None,
                   help="buffer count for the executor-op benchmarks "
                        "(memcpy/reducedt/reducedt_strided; default 1 "
                        "copy / 2 reduce sources; caps 7 copy / 9 "
                        "reduce, ucc_ec_base.h)")
    args = p.parse_args(argv)

    # shared across the collective and executor-op paths: negative
    # warmup skews the timed-round bookkeeping silently, zero iters
    # divides by zero
    if args.iters < 1:
        raise SystemExit("perftest: -n must be >= 1")
    if args.warmup < 0:
        raise SystemExit("perftest: -w must be >= 0")
    try:
        dt_torch(DTS[args.dtype])
    except TypeError as e:
        raise SystemExit(f"perftest: {e}") from None
    try:
        if args.coll in OP_BENCHES:
            return run_op_bench(args)
        mem = resolve_mem(args.mem)
        device = buffer_device(mem)
        job = InProcJob(args.nprocs or 4)
        try:
            return run_coll_bench(args, job, COLLS[args.coll], mem, device)
        finally:
            job.destroy()
    except UccError as e:
        raise SystemExit(f"perftest: {args.coll} failed: {e}") from None


if __name__ == "__main__":
    sys.exit(main())
