"""ucc_perftest — collective and executor benchmark CLI of ucc_tpu_torch.

Mirrors UCC's ucc_perftest and the JAX package's tools/perftest.py: an
exponential size sweep ``-b..-e``, warmup + iterations, per-size
avg/min/max/p50/p99 latency and, with ``-F``, bus bandwidth; ``--json``
prints one record per size in the JAX perftest's shape.

Two benchmark paths:
- collectives (``-c`` every collective type of UCC, as the JAX perftest
  has them: allreduce, reduce, bcast, barrier, fanin, fanout, allgather(v),
  gather(v), alltoall(v), reduce_scatter(v), scatter(v)): ``-p N``
  in-process ranks (default 4), each a context over a thread OOB, one
  team, collective_init/post/test per round (``--persistent``: init once,
  post many; ``-S``: post every round before waiting; ``-T``: post
  through an execution engine on an event, a fresh request a round,
  in-process only). The v-collectives take equal blocks of the count;
  alltoallv takes a traffic matrix (``--matrix uniform|moe``, ``--seed``:
  the JAX perftest's ``gen_traffic_matrix``). The score map selects
  tl/torch_ops for every type on device memory, as the JAX perftest
  selects tl/xla: ``short`` below its threshold (4 KiB on a GPU, 128 KiB
  on ``cpu``), ``xla`` above (``UCC_TL_RING_CUDA_TUNE=allreduce:@ring_cuda
  :inf`` pins the ring for one). On ``-m cuda``, the default, every rank's buffers go on the
  device that ``UCC_TL_RING_CUDA_DEVICE`` names for every device TL
  (default ``cuda``, which raises without a GPU; ``cpu`` runs on the CPU),
  and the ranks of a team share that one card. On ``-m host`` the
  buffers are CPU tensors and tl/shm serves every collective (its
  ``tl/host`` algorithms over the in-process transport, the native
  matcher when it builds); ``detail.transport`` is then ``shm-thread``,
  the JAX perftest's name of that tier. Across processes, ``--store
  host:port --rank R --np N`` makes this process rank R of an N-rank job
  (a TcpStoreOob at ``port`` for the contexts and at ``port + 1`` for the
  team), and ``--procs N`` launches N such processes of itself (one rank
  each) and prints rank 0's output: the team is then served by tl/ipc
  (``detail.transport`` ``ipc``, one host's shared-memory arena), or by
  tl/sockets (``socket``) under ``UCC_TLS=socket,self``; each process
  gets ``OMP_NUM_THREADS=1`` unless the caller set it; with ``-m cuda``
  the device TLs serve such a team across the processes. ``-O`` runs the
  one-sided algorithms (allreduce ``sliding_window``, alltoall and
  alltoallv ``onesided``; pinned through the tl/shm and tl/sockets TUNE)
  on buffers mem-mapped once per size, the handles exchanged over the
  team;
- executor ops (``-c memcpy|reducedt|reducedt_strided``, UCC's
  ucc_pt_op_{memcpy,reduce,reduce_strided}): the execution component's
  copy/reduce tasks timed directly, no team; ``--nbufs`` sources (caps 7
  for copy, 9 for reduce). On ``-m cuda`` the reduces launch the kernel of
  ``kernels/ec_reduce.py``; ``-m host`` times the numpy host executor.

Examples::

    python -m ucc_tpu_torch.tools.perftest -c allreduce -p 8 -b 4K -e 64M
    python -m ucc_tpu_torch.tools.perftest -c reducedt -d bfloat16 --nbufs 9 -F
    UCC_TL_RING_CUDA_DEVICE=cpu python -m ucc_tpu_torch.tools.perftest -c bcast -p 4
    python -m ucc_tpu_torch.tools.perftest --procs 4 -m host -c allreduce --json
    python -m ucc_tpu_torch.tools.perftest -m host -c alltoall -O -p 4
    python -m ucc_tpu_torch.tools.perftest -m host -c alltoallv --matrix moe
    python -m ucc_tpu_torch.tools.perftest -m host -c allreduce -T -p 4
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

import ucc_tpu_torch
from ucc_tpu_torch import (BufferInfo, BufferInfoV, CollArgs,
                           CollArgsFlags, CollType, Context, ContextParams,
                           DataType, MemoryType, ReductionOp, Status,
                           TcpStoreOob, TeamParams, ThreadOobWorld, UccError)
from ucc_tpu_torch.constants import coll_type_str, dt_size, dt_torch
from ucc_tpu_torch.utils.config import memunits_str, parse_memunits

#: every collective type (the JAX perftest's list)
COLLS = {coll_type_str(c): c for c in CollType}
#: the alltoallv traffic matrix of the size being run (make_args reads it)
_TRAFFIC_MATRIX = None
#: executor-op benchmarks (ucc_pt_config.h MEMCPY/REDUCEDT/
#: REDUCEDT_STRIDED): time the EC component directly, no team involved
OP_BENCHES = ("memcpy", "reducedt", "reducedt_strided")
OPS = {o.name.lower(): o for o in ReductionOp}
DTS = {d.name.lower(): d for d in DataType}


def gen_traffic_matrix(kind: str, n: int, count: int, seed: int):
    """Per-(src, dst) element counts of alltoallv: 'moe' draws a skewed
    expert-routing distribution (few hot destinations per source),
    'uniform' splits evenly (the JAX perftest's generator, after
    ucc_pt_config.h's)."""
    rng = np.random.default_rng(seed)
    if kind == "moe":
        m = np.zeros((n, n), dtype=np.int64)
        for src in range(n):
            hot = rng.choice(n, size=max(1, n // 4), replace=False)
            weights = rng.dirichlet(np.ones(len(hot)) * 0.5)
            for h, w in zip(hot, weights):
                m[src][h] = int(round(w * count * n))
        return m
    return np.full((n, n), count, dtype=np.int64)


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
    if coll in (CollType.ALLGATHER, CollType.ALLGATHERV,
                CollType.REDUCE_SCATTER, CollType.REDUCE_SCATTERV,
                CollType.ALLTOALL, CollType.ALLTOALLV):
        return float(n - 1) / n
    return 1.0


def make_args(coll: CollType, n: int, count: int, dt: DataType,
              op: ReductionOp, mem: MemoryType, inplace: bool, root: int,
              persistent: bool, device: torch.device,
              rank: int = 0) -> CollArgs:
    """Rank *rank*'s args, as the JAX perftest makes them: src buffers of
    ones, dst buffers of zeros, all on *device*. bcast passes src alone,
    as UCC's bcast does; rooted collectives give the root's side to the
    root alone; the v-collectives take blocks of *count* (alltoallv: the
    traffic matrix's row and column); barrier, fanin and fanout take no
    data (on device memory an empty buffer names the memory type)."""
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

    def bufv(counts, displs=None):
        total = sum(counts) or 1
        return BufferInfoV(torch.ones(total, dtype=td, device=device),
                           list(counts), displs, dt, mem_type=mem)

    def outv(counts, displs=None):
        total = sum(counts) or 1
        return BufferInfoV(torch.zeros(total, dtype=td, device=device),
                           list(counts), displs, dt, mem_type=mem)

    if coll == CollType.ALLTOALLV:
        if inplace:
            raise SystemExit("perftest: -i is not supported for alltoallv")
        m = _TRAFFIC_MATRIX
        scounts = [int(c) for c in m[rank]]
        rcounts = [int(m[p][rank]) for p in range(n)]
        return CollArgs(
            coll_type=coll, flags=flags,
            src=bufv(scounts, [int(x) for x in np.cumsum([0] +
                                                         scounts[:-1])]),
            dst=outv(rcounts, [int(x) for x in np.cumsum([0] +
                                                         rcounts[:-1])]))
    if coll in (CollType.BARRIER, CollType.FANIN, CollType.FANOUT):
        a = CollArgs(coll_type=coll, root=root, flags=flags)
        if mem != MemoryType.HOST:
            # no data: an empty buffer names the memory type, so that a
            # device TL serves it
            a.src = BufferInfo(None, 0, DataType.UINT8, mem_type=mem)
        return a
    is_root = rank == root
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
    if coll == CollType.REDUCE:
        return CollArgs(coll_type=coll, root=root, op=op, src=buf(count),
                        dst=out(count) if is_root else None, flags=flags)
    if coll == CollType.REDUCE_SCATTER:
        return CollArgs(coll_type=coll, op=op, src=buf(count * n),
                        dst=out(count), flags=flags)
    if coll == CollType.GATHER:
        return CollArgs(coll_type=coll, root=root, src=buf(count),
                        dst=out(count * n) if is_root else None,
                        flags=flags)
    if coll == CollType.SCATTER:
        return CollArgs(coll_type=coll, root=root,
                        src=buf(count * n) if is_root else None,
                        dst=out(count), flags=flags)
    # v-collectives: equal per-rank blocks of `count` (the counts vector
    # is what exercises the v machinery, as in ucc_perftest)
    if coll == CollType.ALLGATHERV:
        return CollArgs(coll_type=coll, src=buf(count),
                        dst=outv([count] * n), flags=flags)
    if coll == CollType.GATHERV:
        # the counts on every rank, the buffer at the root alone
        dst = outv([count] * n)
        if not is_root:
            dst.buffer = None
        return CollArgs(coll_type=coll, root=root, src=buf(count), dst=dst,
                        flags=flags)
    if coll == CollType.SCATTERV:
        return CollArgs(coll_type=coll, root=root,
                        src=bufv([count] * n) if is_root else None,
                        dst=out(count), flags=flags)
    if coll == CollType.REDUCE_SCATTERV:
        return CollArgs(coll_type=coll, op=op, src=buf(count * n),
                        dst=outv([count] * n), flags=flags)
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
    JAX perftest names it: ``ipc`` (a cross-process arena) > ``socket`` >
    ``shm-thread`` (in-process mailboxes); "unknown" when the team has no
    host tag space."""
    try:
        spaces = team._tl_tag_spaces()
    except Exception:  # noqa: BLE001 - classification must not kill a run
        return "unknown"
    if not spaces:
        return "unknown"
    tiers = set()
    for _key, tr in spaces:
        if getattr(tr, "arena", None) is not None:
            tiers.add("ipc")
        elif "Socket" in type(tr).__name__:
            tiers.add("socket")
        else:
            tiers.add("shm-thread")
    for t in ("ipc", "socket", "shm-thread"):
        if t in tiers:
            return t
    return "unknown"


class InProcJob:
    """n ranks in this process: a lib and a context each over a thread
    OOB (contexts are created in threads: the address exchange blocks),
    and one team."""

    def __init__(self, n: int, create_timeout: float = 120.0):
        self.n = n
        self.ranks = list(range(n))
        self.lead = True
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
        self.destroy_ees()
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

    def post_and_wait_triggered(self, reqs) -> None:
        """Post through execution engines: each rank's request is
        dispatched by its team's EE on a compute_complete event
        (ucc_collective_triggered_post); the timed region covers the
        event's signal, the EE's dispatch and completion."""
        from ucc_tpu_torch.core.ee import Ee, UccEvent
        if getattr(self, "_ees", None) is None:
            self._ees = [Ee(t) for t in self.teams]
        for ee, rq in zip(self._ees, reqs):
            ev = UccEvent("compute_complete")
            ee.triggered_post(ev, rq)
            ee.set_event(ev)
        while any([rq.test() in (Status.IN_PROGRESS,
                                 Status.OPERATION_INITIALIZED)
                   for rq in reqs]):
            for c in self.contexts:
                c.progress()
        for rq in reqs:
            if rq.test().is_error:
                raise SystemExit(f"collective failed: {rq.test()}")

    def destroy_ees(self) -> None:
        for ee in getattr(self, "_ees", None) or ():
            ee.destroy()
        self._ees = None


class StoreJob:
    """One rank of a multi-process run: a context over a TcpStoreOob at
    *port* and a team over one at *port* + 1."""

    def __init__(self, host: str, port: int, rank: int, n: int):
        self.n = n
        self.ranks = [rank]
        self.lead = rank == 0
        self._oobs = [TcpStoreOob(rank, n, host=host, port=port)]
        self.lib = ucc_tpu_torch.init()
        self.contexts = [Context(self.lib,
                                 ContextParams(oob=self._oobs[0]))]
        self._oobs.append(TcpStoreOob(rank, n, host=host, port=port + 1))
        self.teams = [self.contexts[0].create_team(
            TeamParams(oob=self._oobs[1]))]

    def destroy(self) -> None:
        for t in self.teams:
            t.destroy()
        for c in self.contexts:
            c.destroy()
        for o in self._oobs:
            o.close()
        self.teams, self.contexts, self._oobs = [], [], []

    def init_reqs(self, argses):
        return [self.teams[0].collective_init(argses[0])]

    def post_and_wait(self, reqs) -> None:
        reqs[0].post()
        if reqs[0].wait(timeout=120).is_error:
            raise SystemExit(f"collective failed: {reqs[0].test()}")

    def run_round(self, argses) -> None:
        self.post_and_wait(self.init_reqs(argses))


class HeldPorts:
    """``k`` free loopback ports for TCP stores, each held by a bound
    socket (SO_REUSEADDR, not listening) until ``release()``: a store
    server binds over a held port, and no other process is handed one
    meanwhile (a probe that closes its socket before the server binds
    races every other listener of the machine). ``contiguous``: one block
    of k ports (a TcpTreeOob's, or a store and its team store)."""

    def __init__(self, k: int, contiguous: bool = False,
                 host: str = "127.0.0.1"):
        self._socks: List[socket.socket] = []
        while len(self._socks) < k:
            port = self._socks[-1].getsockname()[1] + 1 \
                if contiguous and self._socks else 0
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind((host, port))
            except OSError:
                s.close()
                self.release()           # the block broke: start over
                continue
            self._socks.append(s)
        self.ports = [s.getsockname()[1] for s in self._socks]

    def release(self) -> None:
        for s in self._socks:
            s.close()
        self._socks = []

    def __enter__(self) -> "HeldPorts":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def run_procs_mode(args, argv) -> int:
    """``--procs N``: run N worker processes of this tool, one rank each,
    joined by a TCP store (``--store``); rank 0 keeps stdout, the others
    are silenced. The transport follows the ambient UCC_TLS: tl/ipc
    across processes of one host, tl/sockets under UCC_TLS=socket,self."""
    # the context store at port, the team store at port + 1, both held
    # until the workers exit
    held = HeldPorts(2, contiguous=True)
    port = held.ports[0]
    base = list(argv) if argv is not None else sys.argv[1:]
    child_argv = []
    skip = False
    for a in base:
        if skip:
            skip = False
            continue
        if a == "--procs":
            skip = True
            continue
        if a.startswith("--procs="):
            continue
        child_argv.append(a)
    # one intra-op thread a process unless the caller chose (torchrun's
    # default for several processes a host): a process's pool spins for a
    # while after a parallel op such as a buffer fill, and N pools
    # oversubscribe the cores while the ranks poll
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = []
    try:
        for r in range(args.procs):
            cmd = [sys.executable, "-m", "ucc_tpu_torch.tools.perftest",
                   *child_argv, "--store", f"127.0.0.1:{port}",
                   "--rank", str(r), "--np", str(args.procs)]
            procs.append(subprocess.Popen(
                cmd, env=env,
                stdout=None if r == 0 else subprocess.DEVNULL))
        rc = 0
        for pr in procs:
            rc = max(rc, pr.wait())
        return rc
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        held.release()


#: TUNE of the one-sided mode, set for tl/shm and tl/sockets
ONESIDED_TUNE = {
    CollType.ALLREDUCE: "allreduce:@sliding_window",
    CollType.ALLTOALL: "alltoall:@onesided",
    CollType.ALLTOALLV: "alltoallv:@onesided",
}


def _allgather_handles(team, handle: bytes, n: int, pad: int = 2048):
    """Distribute exported memh handles over a multi-process team by a
    fixed-size padded allgather."""
    assert len(handle) <= pad - 8
    blob = np.zeros(pad, np.uint8)
    blob[:8] = np.frombuffer(np.int64(len(handle)).tobytes(), np.uint8)
    blob[8:8 + len(handle)] = np.frombuffer(handle, np.uint8)
    out = np.zeros(pad * n, np.uint8)
    req = team.collective_init(CollArgs(
        coll_type=CollType.ALLGATHER,
        src=BufferInfo(blob, pad, DataType.UINT8),
        dst=BufferInfo(out, pad * n, DataType.UINT8)))
    req.post()
    req.wait(timeout=120)
    req.finalize()
    hs = []
    for p in range(n):
        seg = out[p * pad:(p + 1) * pad]
        ln = int(np.frombuffer(seg[:8].tobytes(), np.int64)[0])
        hs.append(seg[8:8 + ln].tobytes())
    return hs


def attach_onesided(job, argses, coll: CollType, n: int):
    """mem_map each local rank's buffers, exchange the handles, and fill
    the global-memh args. Returns the (context, handle) pairs to unmap."""
    to_unmap = []

    def map_exchange(get_bi):
        local = []
        for i, ctx in enumerate(job.contexts):
            h = ctx.mem_map(get_bi(argses[i]).buffer)
            local.append(h)
            to_unmap.append((ctx, h))
        if len(job.contexts) == n:
            return local                       # in-process: all of them
        return _allgather_handles(job.teams[0], local[0], n)

    dst_handles = map_exchange(lambda a: a.dst)
    for a in argses:
        a.dst_memh = list(dst_handles)
        a.flags |= CollArgsFlags.MEM_MAP_DST_MEMH
    if coll == CollType.ALLREDUCE:
        if argses[0].src is argses[0].dst:     # in place: one mapping
            src_handles = dst_handles
        else:
            src_handles = map_exchange(lambda a: a.src)
        for a in argses:
            a.src_memh = list(src_handles)
            a.flags |= CollArgsFlags.MEM_MAP_SRC_MEMH
    if coll == CollType.ALLTOALLV:
        # one-sided alltoallv's dst displacements name where this rank's
        # block lands in each peer's dst (tl/host/onesided.py)
        m = _TRAFFIC_MATRIX
        for a, r in zip(argses, job.ranks):
            a.dst.displacements = [int(sum(m[q][p] for q in range(r)))
                                   for p in range(n)]
    return to_unmap


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
    if job.lead and not args.json:
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
                          args.root, persistent, device, rank=r)
                for r in job.ranks]

    global _TRAFFIC_MATRIX
    size = max(parse_memunits(args.begin), esz)
    bmax = parse_memunits(args.end)
    while size <= bmax:
        count = max(1, size // esz)
        if coll == CollType.ALLTOALLV:
            _TRAFFIC_MATRIX = gen_traffic_matrix(args.matrix or "uniform",
                                                 n, count, args.seed)
        lats = []
        rounds = args.warmup + args.iters
        if args.triggered:
            # a fresh request a round, dispatched by an execution engine
            # on an event (ucc_pt_benchmark.cc's triggered post)
            for it in range(rounds):
                reqs = job.init_reqs(argses(False))
                t0 = time.perf_counter()
                job.post_and_wait_triggered(reqs)
                if it >= args.warmup:
                    lats.append(time.perf_counter() - t0)
        elif args.onesided:
            # buffers mapped and handles exchanged once per size, outside
            # the timed rounds
            os_argses = argses(False)
            os_unmap = attach_onesided(job, os_argses, coll, n)
            for it in range(rounds):
                t0 = time.perf_counter()
                job.run_round(os_argses)
                if it >= args.warmup:
                    lats.append(time.perf_counter() - t0)
            for ctx, h in os_unmap:
                ctx.mem_unmap(h)
        elif args.persistent:
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
        if not job.lead:
            size *= 2
            continue
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
    p.add_argument("-O", "--onesided", action="store_true",
                   help="one-sided mode (-m host): allreduce -> "
                        "sliding_window, alltoall(v) -> onesided, over "
                        "mem-mapped buffers")
    p.add_argument("-T", "--triggered", action="store_true",
                   help="post through execution engines (triggered post, "
                        "a fresh request a round; in-process only)")
    p.add_argument("--matrix", default="", choices=["", "uniform", "moe"],
                   help="alltoallv traffic matrix (uniform, or moe: a "
                        "skewed expert-routing distribution)")
    p.add_argument("--seed", type=int, default=7,
                   help="seed of the --matrix moe generator")
    p.add_argument("--store", default="",
                   help="host:port of a multi-process job's TCP store "
                        "(the team's store is port + 1)")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--np", type=int, dest="world", default=1)
    p.add_argument("--procs", type=int, default=0,
                   help="launch N worker processes of this tool (one "
                        "rank each) joined by a TCP store; rank 0's "
                        "output is printed")
    args = p.parse_args(argv)

    if args.procs:
        if args.store:
            raise SystemExit("perftest: --procs and --store are exclusive "
                             "(--procs launches --store workers itself)")
        if args.coll in OP_BENCHES:
            raise SystemExit("perftest: --procs runs collectives only")
        return run_procs_mode(args, argv)
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
        coll = COLLS[args.coll]
        if args.triggered and (args.store or args.streaming or
                               args.persistent):
            raise SystemExit("perftest: -T runs in-process, without -S "
                             "and --persistent")
        if args.onesided:
            if mem != MemoryType.HOST:
                raise SystemExit("perftest: -O/--onesided requires -m host")
            if coll not in ONESIDED_TUNE:
                raise SystemExit("perftest: -O supports " + "/".join(
                    coll_type_str(c) for c in ONESIDED_TUNE))
            if args.inplace and coll != CollType.ALLREDUCE:
                raise SystemExit("perftest: -O -i only for allreduce")
            if args.streaming or args.persistent or args.triggered:
                raise SystemExit("perftest: -O is incompatible with -S, "
                                 "-T and --persistent")
            for tl in ("SHM", "SOCKET"):
                os.environ.setdefault(f"UCC_TL_{tl}_TUNE",
                                      ONESIDED_TUNE[coll])
        device = buffer_device(mem)
        if args.store:
            host, port_s = args.store.rsplit(":", 1)
            job = StoreJob(host, int(port_s), args.rank, args.world)
        else:
            job = InProcJob(args.nprocs or 4)
        try:
            return run_coll_bench(args, job, coll, mem, device)
        finally:
            job.destroy()
    except UccError as e:
        raise SystemExit(f"perftest: {args.coll} failed: {e}") from None


if __name__ == "__main__":
    sys.exit(main())
