"""Soak drills: the collective matrix under fault injection.

``run_soak`` runs an in-process multi-rank job (thread OOB) through
``iterations`` collectives drawn round-robin from the matrix while
``fault.inject`` drops / delays / errors / kills, and asserts the
**no-hang invariant**: every rank's request reaches a terminal status
within ``iter_deadline_s`` of posting, whatever was injected. Success of
the collective is not asserted (a drilled fault is meant to fail
things); a rank left IN_PROGRESS is the bug.

Per-collective timeouts (CollArgs TIMEOUT flag) are the first rung: the
progress queue cancels timed-out tasks, unwinding their posted transport
ops. A team whose iteration faulted is re-created before the next one:
cancellation is local, so the team's tag space is undefined afterwards
(abort, then re-init).

``run_kill_shrink_soak`` and ``run_procs_kill_shrink`` drill recovery:
one rank (or one whole OS process) dies, every survivor must end
ERR_RANK_FAILED naming it, agree, shrink, and run a checked matrix on
the shrunk team.

``run_churn_soak`` drills elastic membership: kill -> shrink ->
grow(rejoin) cycles with collectives in flight on every epoch, a
false-suspicion round, and checked collectives on the final team; with
``device`` its collectives are allreduces on device memory.

``run_corrupt_soak`` drills integrity: one rank corrupts every payload it
sends; wire checksums must detect and attribute every round, the strike
ledger must quarantine the corruptor, and the shrunk team must run a
checked matrix. ``run_multi_tenant_soak`` drills the multi-tenant service:
teams of mixed priority (bulk tenants coalescing) share one progress
engine while a rank is killed mid-traffic; every tenant shrinks, grows
the rank back and runs checked mixed traffic.

``collect`` runs the telemetry collector (obs/collector.py) beside the
probabilistic soak and the churn; their reports gain a ``collector``
section.

Runnable standalone::

    python -m ucc_tpu_torch.fault.soak --ranks 4 --iterations 200 \
        --spec 'drop=0.01,delay=0.05:0.003,error=0.02,post_error=0.01'
    python -m ucc_tpu_torch.fault.soak --kill-shrink [--plans]
    python -m ucc_tpu_torch.fault.soak --procs 2 --ranks 4
    python -m ucc_tpu_torch.fault.soak --corrupt [--corrupt-rank R]
    python -m ucc_tpu_torch.fault.soak --multi
    python -m ucc_tpu_torch.fault.soak --churn --cycles 2 [--plans] \
        [--collect]
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from . import inject


_DEFAULT_SPEC = "drop=0.01,delay=0.05:0.003,error=0.02,post_error=0.01"


def _make_job(n: int):
    """N contexts bootstrapped by a thread OOB; returns (contexts, libs)."""
    import ucc_tpu_torch
    from ucc_tpu_torch import Context, ContextParams, ThreadOobWorld
    world = ThreadOobWorld(n)
    libs = [ucc_tpu_torch.init() for _ in range(n)]
    ctxs: List = [None] * n
    errs: List = []

    def mk(r):
        try:
            ctxs[r] = Context(libs[r], ContextParams(oob=world.endpoint(r)))
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append((r, e))

    ths = [threading.Thread(target=mk, args=(r,)) for r in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=60)
    if errs:
        raise RuntimeError(f"soak context create failed: {errs}")
    return ctxs


def _make_team(ctxs, deadline_s: float = 30.0):
    from ucc_tpu_torch import Status, TeamParams, ThreadOobWorld, UccError
    world = ThreadOobWorld(len(ctxs))
    teams = [c.create_team_post(TeamParams(oob=world.endpoint(i)))
             for i, c in enumerate(ctxs)]
    deadline = time.monotonic() + deadline_s
    while True:
        sts = [t.create_test() for t in teams]
        for c in ctxs:
            c.progress()
        if all(s == Status.OK for s in sts):
            return teams
        bad = [s for s in sts if s.is_error]
        if bad:
            raise UccError(bad[0], "soak team create failed")
        if time.monotonic() > deadline:
            raise TimeoutError("soak team create timed out")


def _device_allreduce_args(rank: int, count: int, bufs: Dict, device):
    """The device form of the matrix: a SUM allreduce of *count* f32 of
    value rank + 1 in tensors on *device*, passed as CUDA memory (a CPU
    tensor runs the device TLs' plain versions)."""
    import torch

    from ucc_tpu_torch import (BufferInfo, CollArgs, CollType, DataType,
                               MemoryType, ReductionOp)
    src = torch.full((count,), rank + 1.0, dtype=torch.float32,
                     device=device)
    dst = bufs.setdefault(rank, {}).setdefault(
        "ar", torch.zeros(count, dtype=torch.float32, device=device))
    return CollArgs(coll_type=CollType.ALLREDUCE,
                    src=BufferInfo(src, count, DataType.FLOAT32,
                                   mem_type=MemoryType.CUDA),
                    dst=BufferInfo(dst, count, DataType.FLOAT32,
                                   mem_type=MemoryType.CUDA),
                    op=ReductionOp.SUM)


def _coll_args(coll: str, rank: int, n: int, count: int, bufs: Dict,
               timeout_s: float, device=None):
    from ucc_tpu_torch import (BufferInfo, CollArgs, CollArgsFlags, CollType,
                        DataType, ReductionOp)
    flags = CollArgsFlags.TIMEOUT
    if coll == "barrier":
        return CollArgs(coll_type=CollType.BARRIER, flags=flags,
                        timeout=timeout_s)
    if device is not None:
        return _device_allreduce_args(rank, count, bufs, device)
    src = np.full(count, rank + 1.0, np.float64)
    if coll == "allreduce":
        dst = bufs.setdefault(rank, {}).setdefault(
            "ar", np.zeros(count, np.float64))
        return CollArgs(coll_type=CollType.ALLREDUCE,
                        src=BufferInfo(src, count, DataType.FLOAT64),
                        dst=BufferInfo(dst, count, DataType.FLOAT64),
                        op=ReductionOp.SUM, flags=flags, timeout=timeout_s)
    if coll == "bcast":
        buf = bufs.setdefault(rank, {}).setdefault(
            "bc", np.zeros(count, np.float64))
        if rank == 0:
            buf[:] = 42.0
        return CollArgs(coll_type=CollType.BCAST,
                        src=BufferInfo(buf, count, DataType.FLOAT64),
                        root=0, flags=flags, timeout=timeout_s)
    if coll == "reduce":
        dst = bufs.setdefault(rank, {}).setdefault(
            "rd", np.zeros(count, np.float64))
        return CollArgs(coll_type=CollType.REDUCE,
                        src=BufferInfo(src, count, DataType.FLOAT64),
                        dst=BufferInfo(dst, count, DataType.FLOAT64),
                        op=ReductionOp.SUM, root=0, flags=flags,
                        timeout=timeout_s)
    if coll == "allgather":
        dst = bufs.setdefault(rank, {}).setdefault(
            "ag", np.zeros(count * n, np.float64))
        return CollArgs(coll_type=CollType.ALLGATHER,
                        src=BufferInfo(src, count, DataType.FLOAT64),
                        dst=BufferInfo(dst, count * n, DataType.FLOAT64),
                        flags=flags, timeout=timeout_s)
    if coll == "alltoall":
        src_a = np.arange(count * n, dtype=np.float64) + rank
        dst = bufs.setdefault(rank, {}).setdefault(
            "a2a", np.zeros(count * n, np.float64))
        return CollArgs(coll_type=CollType.ALLTOALL,
                        src=BufferInfo(src_a, count * n, DataType.FLOAT64),
                        dst=BufferInfo(dst, count * n, DataType.FLOAT64),
                        flags=flags, timeout=timeout_s)
    raise ValueError(f"unknown soak collective {coll!r}")


DEFAULT_MATRIX = ("allreduce", "bcast", "allgather", "reduce", "alltoall",
                  "barrier")


def run_soak(n_ranks: int = 4, iterations: int = 200,
             spec: str = _DEFAULT_SPEC, seed: int = 0,
             coll_timeout_s: float = 0.5, iter_deadline_s: float = 10.0,
             count: int = 64,
             matrix=DEFAULT_MATRIX, collect: bool = False) -> Dict:
    """Run the drill; returns a report dict:

    ``iterations`` run, per-outcome ``outcomes`` counts (terminal
    statuses by name), ``hangs`` (iterations where some rank was still
    IN_PROGRESS at the deadline — MUST be empty), ``injected`` decision
    counts, ``teams_recreated``. With ``collect`` the telemetry
    collector runs beside the drill (its window exchanges soak under the
    same injected drops, delays and errors) and the report gains a
    ``collector`` section: the windows that closed and the union of the
    context ranks the straggler scorer flagged.
    """
    from ucc_tpu_torch import Status

    inject.reset()
    prev_knobs = _collect_on() if collect else None
    ctxs = _make_job(n_ranks)
    teams = _make_team(ctxs)
    report: Dict = {"iterations": 0, "outcomes": {}, "hangs": [],
                    "teams_recreated": 0, "spec": spec, "seed": seed}
    bufs: Dict = {}
    inject.configure(spec, seed)
    try:
        for it in range(iterations):
            coll = matrix[it % len(matrix)]
            try:
                reqs = [t.collective_init(
                    _coll_args(coll, r, n_ranks, count, bufs,
                               coll_timeout_s))
                        for r, t in enumerate(teams)]
                for rq in reqs:
                    rq.post()
            except Exception as e:  # noqa: BLE001 - init/post-time faults
                # (post_error on a killed rank, fallback exhaustion) are
                # a terminal outcome for the iteration, not a hang
                key = f"init_error({type(e).__name__})"
                report["outcomes"][key] = report["outcomes"].get(key, 0) + 1
                report["iterations"] += 1
                prev = inject.pause()
                teams = _recreate(teams, ctxs, report)
                inject.restore(prev)
                continue
            deadline = time.monotonic() + iter_deadline_s
            while time.monotonic() < deadline:
                for c in ctxs:
                    c.progress()
                if all(rq.test() != Status.IN_PROGRESS for rq in reqs):
                    break
            sts = [rq.test() for rq in reqs]
            stuck = [r for r, s in enumerate(sts)
                     if s == Status.IN_PROGRESS]
            if stuck:
                # invariant violation: record, then cancel so the soak
                # itself can continue past the broken iteration
                report["hangs"].append(
                    {"iteration": it, "coll": coll, "ranks": stuck,
                     "statuses": [s.name for s in sts]})
                for r in stuck:
                    reqs[r].task.cancel(Status.ERR_TIMED_OUT)
            for s in sts:
                report["outcomes"][s.name] = \
                    report["outcomes"].get(s.name, 0) + 1
            for rq in reqs:
                try:
                    rq.finalize()
                except Exception:  # noqa: BLE001
                    pass
            report["iterations"] += 1
            if any(s != Status.OK for s in sts):
                # the faulted team's tag space is poisoned (peers may
                # hold stale unexpected messages under tags a future
                # collective will reuse) — re-create it, injection
                # paused, mirroring abort→re-init
                prev = inject.pause()
                teams = _recreate(teams, ctxs, report)
                inject.restore(prev)
    finally:
        report["injected"] = dict(inject.COUNTS)   # before reset zeroes it
        inject.reset()
        if collect:
            report["collector"] = _collector_section(ctxs)
        for t in teams:
            try:
                t.destroy()
            except Exception:  # noqa: BLE001
                pass
        for c in ctxs:
            try:
                c.destroy()
            except Exception:  # noqa: BLE001
                pass
        if prev_knobs is not None:
            _collect_off(prev_knobs)
    return report


def _collect_on():
    """Arm the telemetry collector and the flight recorder BEFORE the
    contexts (the service is made in Context.__init__), with no store on
    disk: the drills want the scorer and the bias under fire. Returns
    the knobs to restore."""
    from ..obs import collector as _collector
    from ..obs import flight as _flight
    prev = (_collector.KNOBS.enabled, _collector.KNOBS.interval,
            _collector.KNOBS.dir, _flight.ENABLED)
    _flight.configure(enabled=True)
    _collector.configure(enabled=True, interval=0.25, dir="")
    return prev


def _collect_off(prev) -> None:
    from ..obs import collector as _collector
    from ..obs import flight as _flight
    _collector.configure(enabled=prev[0], interval=prev[1], dir=prev[2])
    _flight.configure(enabled=prev[3])


def _collector_section(ctxs) -> Dict:
    """The report's ``collector`` section: windows closed (the most of
    any context) and the flagged context ranks of every context."""
    flagged: set = set()
    windows = 0
    for c in ctxs:
        col = c.collector
        if col is None:
            continue
        try:
            flagged |= set(col.flagged_ctx())
            windows = max(windows, col.windows_run())
        except Exception:  # noqa: BLE001 - reporting only
            pass
    return {"windows": windows, "flagged_ctx": sorted(flagged)}


def _recreate(teams, ctxs, report):
    for t in teams:
        try:
            t.destroy()
        except Exception:  # noqa: BLE001
            pass
    report["teams_recreated"] += 1
    return _make_team(ctxs)


# ---------------------------------------------------------------------------
# kill + shrink scenario (UCC_FT=shrink acceptance drill)
# ---------------------------------------------------------------------------

def run_kill_shrink_soak(n_ranks: int = 4, kill_rank: int = 2,
                         pre_iters: int = 6, post_iters: int = 60,
                         hb_interval: float = 0.02,
                         hb_timeout: float = 0.3,
                         iter_deadline_s: float = 15.0,
                         count: int = 64,
                         matrix=DEFAULT_MATRIX,
                         plans: bool = False) -> Dict:
    """The full recovery pipeline under drill: run the matrix healthy,
    kill one rank mid-run (``UCC_FAULT=kill``), assert every survivor
    observes ``ERR_RANK_FAILED`` naming it, shrink, then complete
    *post_iters* more matrix collectives on the shrunk team — with zero
    ranks left IN_PROGRESS anywhere (the no-hang invariant, upgraded to
    a *resume* guarantee).

    Returns a report dict; ``report["violations"]`` MUST be empty.
    """
    from ucc_tpu_torch import Status
    from . import health

    inject.reset()
    prev_mode, prev_int, prev_to = (health.MODE, health.HEARTBEAT_INTERVAL,
                                    health.HEARTBEAT_TIMEOUT)
    health.configure("shrink", interval=hb_interval, timeout=hb_timeout)
    # plan-mode drill: force the allreduces onto the native
    # execution-plan path (ring bridge) so the kill->shrink pipeline is
    # exercised with Python off the data path — ucc_plan_cancel must
    # withdraw posted recvs and a pre-shrink plan's sends must be fenced
    import os
    plan_env = None
    if plans:
        plan_env = {k: os.environ.get(k)
                    for k in ("UCC_GEN_NATIVE", "UCC_TL_SHM_TUNE")}
        os.environ["UCC_GEN_NATIVE"] = "y"
        os.environ["UCC_TL_SHM_TUNE"] = "allreduce:@ring:inf"
    ctxs = _make_job(n_ranks)
    teams = _make_team(ctxs)
    # matcher/stale_send_fenced defaults: _probe_stale_send_fence may
    # find no probeable transport and return without setting either key
    report: Dict = {"pre_iters": 0, "post_iters": 0, "violations": [],
                    "outcomes": {}, "detected": {}, "agreed": {},
                    "matcher": None, "stale_send_fenced": None}
    if plans:
        report["plan_mode"] = False
        report["plan_recvs_withdrawn"] = 0
        report["plan_stale_fenced"] = None
    bufs: Dict = {}
    new_teams = None
    try:
        # -- healthy warm-up ------------------------------------------
        for it in range(pre_iters):
            coll = matrix[it % len(matrix)]
            _drive_iter(ctxs, teams, coll, n_ranks, count, bufs,
                        iter_deadline_s, report, "pre", range(n_ranks))
            report["pre_iters"] += 1

        # -- kill one rank --------------------------------------------
        killed_ctx = ctxs[kill_rank].rank
        inject.configure(f"kill={killed_ctx}", seed=0)
        survivors = [r for r in range(n_ranks) if r != kill_rank]
        report["killed"] = {"team_rank": kill_rank, "ctx_rank": killed_ctx}

        # post one matrix iteration across the kill: survivors must
        # reach ERR_RANK_FAILED naming the dead rank (fail-fast or
        # health-cancel), nobody may park IN_PROGRESS
        reqs = {}
        for r in survivors:
            try:
                reqs[r] = teams[r].collective_init(
                    _coll_args("allreduce", r, n_ranks, count, bufs, 0.0))
                reqs[r].post()
            except Exception as e:  # noqa: BLE001
                report["violations"].append(
                    f"survivor {r} post raised {type(e).__name__}: {e}")
        deadline = time.monotonic() + iter_deadline_s
        while time.monotonic() < deadline:
            for c in ctxs:
                c.progress()
            if all(rq.test() != Status.IN_PROGRESS for rq in reqs.values()):
                break
        if plans:
            # BEFORE finalize (which releases the plan): the drilled
            # invariant is that cancellation withdrew the stalled plans'
            # posted recvs natively (cancel-skip), so no late send from
            # the dead epoch can scribble into reclaimed buffers
            for r, rq in reqs.items():
                t = getattr(rq, "task", None)
                p = getattr(t, "_plan", None)
                if p is not None:
                    report["plan_mode"] = True
                    try:
                        report["plan_recvs_withdrawn"] += \
                            p.counters()["withdrawn"]
                    except Exception:  # noqa: BLE001
                        pass
        for r, rq in reqs.items():
            st = rq.test()
            named = rq.failed_ranks or []
            report["detected"][r] = {"status": st.name, "ranks": named}
            if st == Status.IN_PROGRESS:
                report["violations"].append(
                    f"survivor {r} still IN_PROGRESS after kill")
                rq.task.cancel(Status.ERR_TIMED_OUT)
            elif st != Status.ERR_RANK_FAILED:
                report["violations"].append(
                    f"survivor {r} saw {st.name}, not ERR_RANK_FAILED")
            elif killed_ctx not in named:
                report["violations"].append(
                    f"survivor {r} attribution {named} misses ctx rank "
                    f"{killed_ctx}")
            try:
                rq.finalize()
            except Exception:  # noqa: BLE001
                pass

        # -- agree + shrink -------------------------------------------
        shrinks = {r: teams[r].shrink_post() for r in survivors}
        deadline = time.monotonic() + iter_deadline_s
        while time.monotonic() < deadline:
            for c in ctxs:
                c.progress()
            # NOTE: every request must be polled each pass (list, not a
            # short-circuiting all()): ShrinkRequest.test() is what
            # drives the rebuild's OOB rounds, like create_test
            sts = [s.test() for s in shrinks.values()]
            if all(st != Status.IN_PROGRESS for st in sts):
                break
        for r, s in shrinks.items():
            st = s.test()
            report["agreed"][r] = {"status": st.name,
                                   "dead": s.failed_ranks,
                                   "epoch": s.epoch}
            if st != Status.OK:
                report["violations"].append(
                    f"survivor {r} shrink failed: {st.name}")
        views = {(tuple(v["dead"] or ()), v["epoch"])
                 for v in report["agreed"].values()}
        if len(views) > 1:
            report["violations"].append(
                f"survivors diverged on (dead set, epoch): {views}")
        if not report["violations"]:
            new_teams = [shrinks[r].new_team for r in survivors]
            # regression probe: a STALE pre-shrink send posted after the
            # fence must be discarded at the match boundary (n_fenced),
            # never parked where a recycled buffer could meet it. Runs on
            # whichever matcher the endpoint actually uses — the native
            # v2 core fences too, so UCC_FT=shrink no longer pins the
            # python matcher.
            _probe_stale_send_fence(teams[survivors[0]], report)
            if plans:
                _probe_stale_plan_fence(teams[survivors[0]], report)

        # -- resume on the shrunk team --------------------------------
        if new_teams:
            nbufs: Dict = {}
            nn = len(survivors)
            for it in range(post_iters):
                coll = matrix[it % len(matrix)]
                _drive_iter([ctxs[r] for r in survivors], new_teams, coll,
                            nn, count, nbufs, iter_deadline_s, report,
                            "post", survivors, check=True)
                report["post_iters"] += 1
    finally:
        report["injected"] = dict(inject.COUNTS)
        inject.reset()
        health.configure(prev_mode, interval=prev_int, timeout=prev_to)
        if plan_env is not None:
            for k, v in plan_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if plans:
            if not report.get("plan_mode"):
                report["violations"].append(
                    "plan drill: native execution plans did not engage "
                    "(native core unavailable?)")
            elif not report.get("plan_recvs_withdrawn"):
                report["violations"].append(
                    "plan drill: cancellation withdrew no plan-posted "
                    "recvs")
            elif report.get("plan_stale_fenced") is False:
                report["violations"].append(
                    "plan drill: a pre-shrink plan send was NOT fenced")
        for t in list(teams) + list(new_teams or ()):
            try:
                t.destroy()
            except Exception:  # noqa: BLE001
                pass
        for c in ctxs:
            try:
                c.destroy()
            except Exception:  # noqa: BLE001
                pass
    return report


# ---------------------------------------------------------------------------
# cross-process scenario: one WHOLE OS process killed (ipc arena drill)
# ---------------------------------------------------------------------------

def _free_port_pair() -> int:
    """Adjacent free port pair held simultaneously (the TcpStoreOob
    bootstrap binds *port* for the context world and *port+1* for the
    team world; probing them separately races other listeners)."""
    import socket as _s
    while True:
        a = _s.socket()
        a.bind(("127.0.0.1", 0))
        port = a.getsockname()[1]
        b = _s.socket()
        try:
            b.bind(("127.0.0.1", port + 1))
        except OSError:
            a.close()
            b.close()
            continue
        a.close()
        b.close()
        return port


def _device_srcs(ctx_ranks, count, device):
    """The device drill's inputs: ctx rank c's src is seeded by c, so any
    process can make every rank's."""
    import torch
    out = []
    for c in ctx_ranks:
        g = torch.Generator(device=device).manual_seed(1000 + int(c))
        out.append(torch.randn(count, generator=g, device=device))
    return out


def _device_args(src, dst, count):
    """The device drill's collective: a SUM allreduce of *count* f32 in
    CUDA memory."""
    import ucc_tpu_torch as ucc
    f32, cuda = ucc.DataType.FLOAT32, ucc.MemoryType.CUDA
    return ucc.CollArgs(
        coll_type=ucc.CollType.ALLREDUCE, op=ucc.ReductionOp.SUM,
        src=ucc.BufferInfo(src, count, f32, mem_type=cuda),
        dst=ucc.BufferInfo(dst, count, f32, mem_type=cuda))


def _device_expected(ctx_ranks, count, device):
    """The device drill's check: the same inputs through the plain
    version of the ring kernel tl/ring_cuda would pick (each kernel is
    bitwise its plain version, and the plain version leaves the launch
    counts alone)."""
    from ..constants import ReductionOp
    from ..kernels import ring_allreduce as kr
    srcs = _device_srcs(ctx_ranks, count, device)
    ref = kr.ring_allreduce_pass_ref if count <= kr.pass_elems(len(srcs)) \
        else kr.ring_allreduce_chunked_ref
    return ref(srcs, ReductionOp.SUM)[0]


def _device_launches():
    """The ring allreduce kernels' launch counts in this process."""
    from ..kernels import ring_allreduce as kr
    return {"ring_allreduce_pass": kr.ring_allreduce_pass.launches,
            "ring_allreduce_chunked": kr.ring_allreduce_chunked.launches}


def _wait(ctx, rq, deadline_s, what, rep):
    """Progress *ctx* until *rq* leaves IN_PROGRESS or *deadline_s*
    passes; a request still in progress then is a violation and is
    cancelled. Returns the status."""
    from ucc_tpu_torch import Status
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        ctx.progress()
        if rq.test() != Status.IN_PROGRESS:
            break
    st = rq.test()
    if st == Status.IN_PROGRESS:
        rep["violations"].append(f"{what} IN_PROGRESS past deadline")
        rq.task.cancel(Status.ERR_TIMED_OUT)
    return st


def _procs_rank_main(rank, size, port, lib, killed_ev, victim, pre_iters,
                     post_iters, count, deadline_s, q, device=None,
                     gate=None):
    """One rank of the cross-process drill (a thread inside its hosting
    worker process). Victim ranks park on progress until the parent
    SIGKILLs their process; survivors cross the kill, shrink, resume.
    With *device* every collective is an allreduce of torch tensors on
    that device (CUDA memory: a device team that spans processes), each
    result held bitwise against the plain version of the kernel. *gate*
    (a barrier of the process's rank threads) is passed once the rank
    has shrunk, just before its resumed rounds."""
    import ucc_tpu_torch
    from ucc_tpu_torch import ContextParams, Status, TcpStoreOob, TeamParams

    rep: Dict = {"rank": rank, "violations": [], "pre": 0, "post": 0}
    ctx = None
    try:
        oob = TcpStoreOob(rank, size, port=port)
        ctx = ucc_tpu_torch.Context(lib, ContextParams(oob=oob))
        team = ctx.create_team(TeamParams(oob=TcpStoreOob(rank, size,
                                                          port=port + 1)))
        bufs: Dict = {}

        def args_for(coll, n, my_rank, b):
            """(args, dst): the host matrix's, or the device drill's
            allreduce of this context rank's seeded tensor."""
            if device is None:
                return _coll_args(coll, my_rank, n, count, b, 0.0), None
            import torch
            src = _device_srcs([ctx.rank], count, device)[0]
            dst = torch.empty_like(src)
            return _device_args(src, dst, count), dst

        def drive(t, coll, n, my_rank, b, check=False):
            if device is not None:
                coll = "allreduce"
            args, dst = args_for(coll, n, my_rank, b)
            rq = t.collective_init(args)
            if device is not None:
                rep.setdefault("algs", []).append(rq.task.alg_name)
            rq.post()
            st = _wait(ctx, rq, deadline_s, coll, rep)
            if check and st not in (Status.OK, Status.IN_PROGRESS):
                rep["violations"].append(f"{coll} failed: {st.name}")
            elif check and st == Status.OK and device is not None:
                import torch
                members = [int(t.ctx_map.eval(i)) for i in range(t.size)]
                want = _device_expected(members, count, device)
                if not torch.equal(dst, want):
                    rep["violations"].append(
                        f"allreduce of {t.size} ranks differs from the "
                        f"plain version by "
                        f"{(dst - want).abs().max().item()}")
                else:
                    rep["bitwise"] = rep.get("bitwise", 0) + 1
            elif check and st == Status.OK and coll == "allreduce":
                expected = sum(g + 1.0 for g in range(n))
                if not np.allclose(b[my_rank]["ar"], expected):
                    rep["violations"].append(
                        f"{coll} wrong result {b[my_rank]['ar'][0]} != "
                        f"{expected}")
            try:
                rq.finalize()
            except Exception:  # noqa: BLE001
                pass
            return st

        # -- healthy matrix on the full cross-process team -------------
        n_pre = pre_iters * len(DEFAULT_MATRIX) if device is None \
            else pre_iters
        for it in range(n_pre):
            drive(team, DEFAULT_MATRIX[it % len(DEFAULT_MATRIX)], size,
                  rank, bufs, check=True)
            rep["pre"] += 1
        q.put(("ready", rank))
        if victim:
            while True:            # parked until the parent's SIGKILL
                ctx.progress()
                time.sleep(0.001)
        killed_ev.wait(timeout=120)

        # -- collective across the kill: detect + attribute ------------
        args, _ = args_for("allreduce", size, rank, bufs)
        rq = team.collective_init(args)
        t_kill = time.monotonic()
        rq.post()
        st = _wait(ctx, rq, deadline_s, "allreduce across the process kill",
                   rep)
        rep["detected"] = {"status": st.name,
                           "ranks": sorted(rq.failed_ranks or []),
                           "ms": (time.monotonic() - t_kill) * 1e3}
        if st not in (Status.IN_PROGRESS, Status.ERR_RANK_FAILED):
            rep["violations"].append(
                f"saw {st.name} after process kill, not ERR_RANK_FAILED")
        try:
            rq.finalize()
        except Exception:  # noqa: BLE001
            pass

        # -- agree + shrink among the survivors ------------------------
        t_shrink = time.monotonic()
        s = team.shrink_post()
        end = time.monotonic() + 60
        while time.monotonic() < end:
            ctx.progress()
            if s.test() != Status.IN_PROGRESS:
                break
        if s.test() != Status.OK:
            rep["violations"].append(f"shrink failed: {s.test().name}")
            if gate is not None:
                gate.abort()
            q.put(("report", rank, rep))
            return
        rep["agreed"] = {"epoch": s.epoch,
                         "dead": sorted(s.failed_ranks or []),
                         "ms": (time.monotonic() - t_shrink) * 1e3}
        new_team = s.new_team

        # -- resume: checked matrix on the shrunk team -----------------
        nn = new_team.size
        my = getattr(new_team, "rank", rank)
        nbufs: Dict = {}
        if gate is not None:
            gate.wait(timeout=deadline_s)
        for it in range(post_iters):
            drive(new_team, DEFAULT_MATRIX[it % len(DEFAULT_MATRIX)], nn,
                  my, nbufs, check=True)
            rep["post"] += 1
        q.put(("report", rank, rep))
        try:
            new_team.destroy()
            team.destroy()
        except Exception:  # noqa: BLE001
            pass
    except Exception as e:  # noqa: BLE001
        import traceback
        if gate is not None:
            gate.abort()
        rep["violations"].append(
            f"rank raised {type(e).__name__}: {e}\n"
            f"{traceback.format_exc()}")
        q.put(("report", rank, rep))
    finally:
        if ctx is not None:
            try:
                ctx.destroy()
            except Exception:  # noqa: BLE001
                pass


def _procs_worker(ranks, size, port, q, killed_ev, victim, pre_iters,
                  post_iters, count, deadline_s, device=None,
                  flight_file=None):
    """One OS process hosting *ranks* (a thread per rank) of the
    cross-process drill. Host memory is forced onto the ipc TL: every
    payload between the processes rides the shared arena. With *device*
    the device TLs run the collectives (tl/ring_cuda pinned) and tl/ipc
    is the service team and the liveness source; the process then
    reports its kernel launches over the resumed rounds, once for all
    its ranks (a spanning round is one launch per process). Its flight
    dumps go to *flight_file*, the parent's."""
    try:
        if device is None:
            os.environ.setdefault("UCC_TLS", "ipc,self")
        else:
            os.environ["UCC_TL_RING_CUDA_DEVICE"] = device
            os.environ["UCC_TL_RING_CUDA_TUNE"] = "allreduce:@ring_cuda:inf"
        import ucc_tpu_torch
        from ..obs import flight
        from . import health
        if flight_file is not None:
            flight.configure(file=flight_file)
        health.configure("shrink", interval=0.05, timeout=2.0)
        # component discovery is not re-entrant: init libs on the main
        # thread, the rank threads only drive the data path
        libs = {r: ucc_tpu_torch.init() for r in ranks}
        marks: Dict = {}
        gate = None if device is None else threading.Barrier(
            len(ranks), action=lambda: marks.update(before=_device_launches()))
        ths = [threading.Thread(
            target=_procs_rank_main,
            args=(r, size, port, libs[r], killed_ev, victim, pre_iters,
                  post_iters, count, deadline_s, q, device, gate),
            daemon=True)
            for r in ranks]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=600)
        if device is not None:
            after = _device_launches()
            before = marks.get("before")
            q.put(("launches", ranks[0], None if before is None else
                   {k: after[k] - before[k] for k in after}))
    except Exception as e:  # noqa: BLE001
        import traceback
        for r in ranks:
            q.put(("report", r, {"rank": r, "violations": [
                f"worker crashed: {e}\n{traceback.format_exc()}"]}))


def run_procs_kill_shrink(n_procs: int = 2, ranks_per: int = 2,
                          pre_iters: int = 1, post_iters: int = 12,
                          count: int = 64,
                          iter_deadline_s: float = 20.0,
                          device: Optional[str] = None) -> Dict:
    """The cross-process recovery drill: *n_procs* OS processes host
    ``ranks_per`` ranks each over one shared-memory arena
    (``UCC_TLS=ipc,self``); after a healthy matrix the LAST process is
    SIGKILLed whole — no goodbye, exactly a crashed node. Survivors
    must detect via the arena pid board (heartbeats stop AND the pid is
    conclusively gone), agree on the dead set, shrink, and run a
    checked matrix on the shrunk team.

    With *device* (``"cuda"``, or ``"cpu"`` for the CPU stand-in) the
    ranks' buffers are torch tensors of *count* f32 in CUDA memory and
    every collective is an allreduce on a device team that spans the
    processes; each result must be bitwise the plain version of the
    kernel over the same inputs. ``report["launches"]`` then sums the
    surviving processes' kernel launches over the resumed rounds
    (``report["proc_launches"]``, by process).

    Returns a report dict; ``report["violations"]`` MUST be empty.
    """
    import multiprocessing as mp
    import queue as _q
    from ..obs import flight

    size = n_procs * ranks_per
    victim = n_procs - 1
    splits = [tuple(range(p * ranks_per, (p + 1) * ranks_per))
              for p in range(n_procs)]
    port = _free_port_pair()
    mctx = mp.get_context("spawn")
    # one queue PER process, never shared across the kill boundary: a
    # shared mp.Queue's write lock is a plain semaphore, and SIGKILLing
    # the victim while its feeder thread holds it (it was just
    # descheduled between send_bytes and release — routine on one core)
    # orphans the lock and wedges every survivor's feeder forever
    qs = [mctx.Queue() for _ in range(n_procs)]
    killed_ev = mctx.Event()
    procs = [mctx.Process(target=_procs_worker,
                          args=(splits[p], size, port, qs[p], killed_ev,
                                p == victim, pre_iters, post_iters,
                                count, iter_deadline_s, device,
                                flight._file))
             for p in range(n_procs)]
    survivors = [r for p in range(n_procs) if p != victim
                 for r in splits[p]]
    report: Dict = {"procs": n_procs, "ranks": size, "violations": [],
                    "killed": {"proc": victim,
                               "ctx_ranks": sorted(splits[victim])},
                    "per_rank": {}}
    for p in procs:
        p.start()
    def drain(sources, done, timeout_s):
        deadline = time.monotonic() + timeout_s
        while not done() and time.monotonic() < deadline:
            got = False
            for qq in sources:
                try:
                    msg = qq.get_nowait()
                except _q.Empty:
                    continue
                except (EOFError, OSError):
                    continue               # writer died mid-frame
                got = True
                if msg[0] == "ready":
                    ready.add(msg[1])
                elif msg[0] == "launches":
                    proc_launches[msg[1] // ranks_per] = msg[2]
                else:
                    report["per_rank"][msg[1]] = msg[2]
            if not got:
                time.sleep(0.05)

    proc_launches: Dict = {}
    try:
        ready: set = set()
        drain(qs, lambda: len(ready) >= size, 240)
        if len(ready) < size:
            report["violations"].append(
                f"only ranks {sorted(ready)} of {size} reached the kill "
                f"point")
            return report

        procs[victim].kill()                       # SIGKILL, whole process
        procs[victim].join(timeout=30)
        killed_ev.set()

        # only survivor queues from here: the victim's pipe may hold a
        # truncated frame
        live_qs = [qs[p] for p in range(n_procs) if p != victim]
        drain(live_qs, lambda: len(report["per_rank"]) >= len(survivors),
              300)
        if device is not None:
            # a worker counts its launches once its rank threads end
            drain(live_qs, lambda: len(proc_launches) >= n_procs - 1, 60)
            report["proc_launches"] = dict(proc_launches)
            report["launches"] = {}
            for p in range(n_procs):
                if p == victim:
                    continue
                got = proc_launches.get(p)
                if got is None:
                    report["violations"].append(
                        f"process {p} reported no launch count")
                    continue
                for k, v in got.items():
                    report["launches"][k] = report["launches"].get(k, 0) + v

        dead_expect = set(splits[victim])
        views = set()
        for r in survivors:
            rep = report["per_rank"].get(r)
            if rep is None:
                report["violations"].append(f"rank {r} never reported")
                continue
            for v in rep.get("violations", ()):
                report["violations"].append(f"rank {r}: {v}")
            det = rep.get("detected") or {}
            if not dead_expect & set(det.get("ranks", ())):
                report["violations"].append(
                    f"rank {r} attribution {det.get('ranks')} misses the "
                    f"killed process ranks {sorted(dead_expect)}")
            agreed = rep.get("agreed")
            if agreed is not None:
                views.add((tuple(agreed["dead"]), agreed["epoch"]))
                if not dead_expect <= set(agreed["dead"]):
                    report["violations"].append(
                        f"rank {r} shrank without the whole killed "
                        f"process: {agreed['dead']}")
            if rep.get("post", 0) < post_iters:
                report["violations"].append(
                    f"rank {r} resumed only {rep.get('post', 0)}/"
                    f"{post_iters} post-shrink iterations")
        if len(views) > 1:
            report["violations"].append(
                f"survivors diverged on (dead set, epoch): {views}")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        # the killed process may have created the arena: once every
        # registered pid is gone, unlink it as any crashed run's
        try:
            from .. import native
            if native.get_lib() is not None:
                native.reap_stale_arenas()
        except Exception:  # noqa: BLE001 - hygiene only
            pass
    return report


def _probe_stale_plan_fence(old_team, report) -> None:
    """Native-plan twin of ``_probe_stale_send_fence``: build a one-op
    plan keyed to the OLD (fenced) epoch and post it — the C executor's
    push must be discarded at the match boundary with the plan counting
    the fenced send (no hang, ``n_fenced`` ticks)."""
    from ..tl.host.transport import InProcTransport
    for team_key, tr in old_team._tl_tag_spaces():
        if not isinstance(tr, InProcTransport):
            continue
        try:
            from ..dsl.plan import stale_fence_probe
            before = tr.n_fenced
            ok = stale_fence_probe(tr, team_key)
        except Exception as e:  # noqa: BLE001 - the probe itself failing
            # is a violation (it means plans cannot run on this matcher)
            report["plan_stale_fenced"] = False
            report["violations"].append(f"plan fence probe raised: {e}")
            return
        report["plan_stale_fenced"] = ok
        if ok:
            report["plan_fenced_counter"] = tr.n_fenced - before
        return
    report["plan_stale_fenced"] = None


def _probe_stale_send_fence(old_team, report) -> None:
    """Post a send into the OLD (fenced) epoch of a shrunk team and
    assert it is discarded at the matching boundary: the send completes
    (the sender must not wait forever) and the endpoint's ``n_fenced``
    counter ticks. Records which matcher handled it."""
    import numpy as np
    from ..tl.host.transport import InProcTransport
    for team_key, tr in old_team._tl_tag_spaces():
        # select loopback-capable endpoints BY TYPE: catching TypeError
        # around the send itself would also swallow a TypeError from the
        # native key-packing/push path this probe exists to regression-
        # test (socket TL endpoints have a different send_nb signature)
        if not isinstance(tr, InProcTransport):
            continue
        before = tr.n_fenced
        # epoch 0 is the pre-shrink tag space; any coll tag/slot works
        key = (team_key, 0, (1 << 20) + 1, 999, 0)
        req = tr.send_nb(tr, key, np.ones(8, np.uint8))
        ok = bool(req.test()) and tr.n_fenced == before + 1
        report["stale_send_fenced"] = ok
        report["matcher"] = ("native"
                             if getattr(tr, "native", None) is not None
                             else "python")
        if not ok:
            report["violations"].append(
                "stale pre-shrink send was not fenced "
                f"(n_fenced {before} -> {tr.n_fenced})")
        return
    report["stale_send_fenced"] = None


def _drive_iter(ctxs, teams, coll, n, count, bufs, deadline_s, report,
                phase, rank_labels, check=False, device=None):
    """Post one matrix collective on every team member, drive to
    terminal, record outcomes; flags hangs and (optionally) failures as
    violations. With *device* the collective is the device allreduce
    (``_device_allreduce_args``), its result checked the same way."""
    import numpy as np
    from ucc_tpu_torch import Status
    reqs = [t.collective_init(_coll_args(coll, r, n, count, bufs, 0.0,
                                         device=device))
            for r, t in enumerate(teams)]
    for rq in reqs:
        rq.post()
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        for c in ctxs:
            c.progress()
        # poll EVERY request each pass (list, not a short-circuiting
        # all()): in UCC_INTEGRITY=verify the sampled attestation digest
        # exchange is driven from each request's own test(), so skipping
        # the tail would starve the exchange until its abandon timeout
        sts = [rq.test() for rq in reqs]
        if all(st != Status.IN_PROGRESS for st in sts):
            break
    sts = [rq.test() for rq in reqs]
    for s in sts:
        key = f"{phase}:{s.name}"
        report["outcomes"][key] = report["outcomes"].get(key, 0) + 1
    stuck = [r for r, s in zip(rank_labels, sts) if s == Status.IN_PROGRESS]
    if stuck:
        report["violations"].append(
            f"{phase} iter {coll}: ranks {stuck} IN_PROGRESS past deadline")
        for r, rq in zip(rank_labels, reqs):
            if rq.test() == Status.IN_PROGRESS:
                rq.task.cancel(Status.ERR_TIMED_OUT)
    elif check:
        bad = [r for r, s in zip(rank_labels, sts) if s != Status.OK]
        if bad:
            report["violations"].append(
                f"{phase} iter {coll}: ranks {bad} failed "
                f"({[s.name for s in sts]})")
        elif coll == "allreduce":
            expected = sum(g + 1.0 for g in range(n))
            for g in range(n):
                got = bufs[g]["ar"]
                if device is not None:
                    got = got.double().cpu().numpy()
                if not np.allclose(got, expected):
                    report["violations"].append(
                        f"{phase} iter {coll}: rank {g} wrong result "
                        f"{got[0]} != {expected}")
    for rq in reqs:
        try:
            rq.finalize()
        except Exception:  # noqa: BLE001
            pass


# ---------------------------------------------------------------------------
# corruption storm (UCC_INTEGRITY=verify acceptance drill)
# ---------------------------------------------------------------------------

def run_corrupt_soak(n_ranks: int = 4, corrupt_rank: int = 1,
                     strikes: int = 3, pre_iters: int = 4,
                     post_iters: int = 60, storm_rounds_max: int = 10,
                     count: int = 256, coll_timeout_s: float = 2.0,
                     iter_deadline_s: float = 15.0,
                     matrix=DEFAULT_MATRIX) -> Dict:
    """Integrity acceptance drill: one rank corrupts EVERY payload it
    sends (``UCC_FAULT=corrupt=1.0,corrupt_rank=R``, in-flight model:
    the frame still carries the clean payload's crc32), integrity runs
    in ``verify`` mode, and the pipeline under test is

        wire crc mismatch at delivery -> ERR_DATA_CORRUPTED naming the
        sender -> strike ledger -> quarantine (HealthRegistry) ->
        shrink excludes the corruptor -> checked matrix on the survivors

    The storm runs allreduce only: on the forced ring the corruptor's
    downstream neighbour is the sole direct receiver, so it accumulates
    exactly one strike per round and quarantine must trip in exactly
    ``strikes`` detected rounds (more is a violation: detection that
    does not escalate).  Allreduces are forced onto NATIVE EXECUTION
    PLANS; the pinned corruptor interprets (rank-variant plan engage)
    while its peers keep the C matcher's crc verify on the data path,
    which is precisely the deployment shape the drill certifies.

    Non-detecting ranks are starved of contributions each round; they
    carry a per-collective TIMEOUT so they cancel instead of parking
    (timeouts are acceptable collateral, hangs are violations; an
    all-OK round with a wrong result is the cardinal sin: silent
    corruption).  ``report["violations"]`` MUST be empty.
    """
    import os
    from ucc_tpu_torch import Status
    from .. import integrity
    from ..status import DataCorruptedError
    from . import health

    inject.reset()
    prev_hb = (health.MODE, health.HEARTBEAT_INTERVAL,
               health.HEARTBEAT_TIMEOUT)
    # all three BEFORE context create: health registries and the native
    # mailboxes' integrity arming are wired up in Context.__init__
    health.configure("shrink", interval=0.05, timeout=2.0)
    integrity.configure(mode="verify", sample=1, strikes=strikes)
    plan_env = {k: os.environ.get(k)
                for k in ("UCC_GEN_NATIVE", "UCC_TL_SHM_TUNE")}
    os.environ["UCC_GEN_NATIVE"] = "y"
    os.environ["UCC_TL_SHM_TUNE"] = "allreduce:@ring:inf"
    ctxs = _make_job(n_ranks)
    teams = _make_team(ctxs)
    corrupt_ctx = ctxs[corrupt_rank].rank
    report: Dict = {"pre_iters": 0, "storm_rounds": 0, "post_iters": 0,
                    "violations": [], "outcomes": {}, "detections": 0,
                    "quarantined": False, "rounds_to_quarantine": None,
                    "corruptor": {"team_rank": corrupt_rank,
                                  "ctx_rank": corrupt_ctx},
                    "mode": "verify", "strikes": strikes,
                    "teams_recreated": 0,
                    "plan_mode": False, "agreed": {},
                    "matcher": None, "stale_send_fenced": None}
    bufs: Dict = {}
    new_teams = None
    try:
        # -- healthy warm-up (no injection, results checked) -----------
        for it in range(pre_iters):
            coll = matrix[it % len(matrix)]
            _drive_iter(ctxs, teams, coll, n_ranks, count, bufs,
                        iter_deadline_s, report, "pre", range(n_ranks))
            report["pre_iters"] += 1

        # -- the storm -------------------------------------------------
        # armed only now: team create's service collectives stay clean
        inject.configure(f"corrupt=1.0,corrupt_rank={corrupt_ctx}", seed=0)
        expected = sum(g + 1.0 for g in range(n_ranks))
        for rnd in range(storm_rounds_max):
            injected_before = inject.COUNTS.get("corrupt", 0)
            reqs = [t.collective_init(
                _coll_args("allreduce", r, n_ranks, count, bufs,
                           coll_timeout_s))
                    for r, t in enumerate(teams)]
            for rq in reqs:
                rq.post()
            done: List = [None] * n_ranks
            deadline = time.monotonic() + iter_deadline_s
            while time.monotonic() < deadline and any(d is None
                                                      for d in done):
                for c in ctxs:
                    c.progress()
                for i, rq in enumerate(reqs):
                    if done[i] is not None:
                        continue
                    try:
                        st = rq.test()
                    except DataCorruptedError as e:
                        # the attestation hook raises; wire-path
                        # corruption instead RETURNS the error status
                        done[i] = (Status.ERR_DATA_CORRUPTED,
                                   sorted(e.ranks))
                        continue
                    if st != Status.IN_PROGRESS:
                        done[i] = (st, sorted(getattr(
                            rq.task, "corrupt_ranks", ()) or ()))
            report["storm_rounds"] += 1
            # native plans must carry the peers' data path (the pinned
            # corruptor itself interprets, by design): probe BEFORE
            # finalize releases the plan
            if any(getattr(rq.task, "_plan", None) is not None
                   for r, rq in enumerate(reqs) if r != corrupt_rank):
                report["plan_mode"] = True
            hung = [r for r, d in enumerate(done) if d is None]
            for r in hung:
                report["violations"].append(
                    f"storm round {rnd}: rank {r} IN_PROGRESS past "
                    f"deadline")
                reqs[r].task.cancel(Status.ERR_TIMED_OUT)
                done[r] = (Status.ERR_TIMED_OUT, [])
            detectors = [r for r, (st, _) in enumerate(done)
                         if st == Status.ERR_DATA_CORRUPTED]
            for r, (st, _) in enumerate(done):
                key = f"storm:{st.name}"
                report["outcomes"][key] = report["outcomes"].get(key, 0) + 1
            injected = inject.COUNTS.get("corrupt", 0) - injected_before
            if detectors:
                report["detections"] += 1
                for r in detectors:
                    named = done[r][1]
                    if corrupt_ctx not in named:
                        report["violations"].append(
                            f"storm round {rnd}: rank {r} attribution "
                            f"{named} misses ctx rank {corrupt_ctx}")
            elif all(st == Status.OK for st, _ in done):
                for g in range(n_ranks):
                    if not np.allclose(bufs[g]["ar"], expected):
                        report["violations"].append(
                            f"storm round {rnd}: SILENT CORRUPTION: "
                            f"rank {g} result {bufs[g]['ar'][0]} != "
                            f"{expected} with no rank reporting "
                            f"ERR_DATA_CORRUPTED")
                        break
            elif injected:
                report["violations"].append(
                    f"storm round {rnd}: {injected} corrupted sends "
                    f"went undetected (outcomes "
                    f"{[st.name for st, _ in done]})")
            for rq in reqs:
                try:
                    rq.finalize()
                except Exception:  # noqa: BLE001
                    pass
            quarantined = any(
                corrupt_ctx in (ctxs[r].health.dead_set()
                                if ctxs[r].health else ())
                for r in range(n_ranks) if r != corrupt_rank)
            if quarantined:
                report["quarantined"] = True
                report["rounds_to_quarantine"] = rnd + 1
                break
            # the faulted team's tag space is poisoned (run_soak
            # contract); strike ledgers and health live on the CONTEXT,
            # so they survive the re-create
            prev = inject.pause()
            teams = _recreate(teams, ctxs, report)
            inject.restore(prev)

        if not report["quarantined"]:
            report["violations"].append(
                f"corruptor not quarantined after {report['storm_rounds']}"
                f" storm rounds ({report['detections']} detected)")
        elif report["detections"] > strikes:
            report["violations"].append(
                f"quarantine took {report['detections']} detected rounds;"
                f" strike threshold is {strikes}")
        if not report["plan_mode"]:
            report["violations"].append(
                "storm ran without native execution plans on the "
                "peers (native core unavailable?)")

        # -- shrink the corruptor out ---------------------------------
        # injection stays armed: the quarantined rank no longer sends,
        # so nothing fires: exactly the production posture
        if report["quarantined"]:
            survivors = [r for r in range(n_ranks) if r != corrupt_rank]
            sctxs = [ctxs[r] for r in survivors]
            shrinks = {r: teams[r].shrink_post() for r in survivors}
            deadline = time.monotonic() + iter_deadline_s
            while time.monotonic() < deadline:
                for c in sctxs:
                    c.progress()
                # poll every request each pass: test() drives the OOB
                # rebuild rounds (a short-circuiting all() deadlocks)
                sts = [s.test() for s in shrinks.values()]
                if all(st != Status.IN_PROGRESS for st in sts):
                    break
            for r, s in shrinks.items():
                st = s.test()
                report["agreed"][r] = {"status": st.name,
                                       "dead": s.failed_ranks,
                                       "epoch": s.epoch}
                if st != Status.OK:
                    report["violations"].append(
                        f"survivor {r} shrink failed: {st.name}")
                elif corrupt_ctx not in (s.failed_ranks or ()):
                    report["violations"].append(
                        f"survivor {r} shrank without the corruptor: "
                        f"{s.failed_ranks}")
            views = {(tuple(v["dead"] or ()), v["epoch"])
                     for v in report["agreed"].values()}
            if len(views) > 1:
                report["violations"].append(
                    f"survivors diverged on (dead set, epoch): {views}")
            if not report["violations"]:
                new_teams = [shrinks[r].new_team for r in survivors]
                _probe_stale_send_fence(teams[survivors[0]], report)

            # -- checked matrix on the shrunk team --------------------
            if new_teams:
                nbufs: Dict = {}
                nn = len(survivors)
                for it in range(post_iters):
                    coll = matrix[it % len(matrix)]
                    _drive_iter(sctxs, new_teams, coll, nn, count, nbufs,
                                iter_deadline_s, report, "post",
                                survivors, check=True)
                    report["post_iters"] += 1
    finally:
        report["injected"] = dict(inject.COUNTS)
        inject.reset()
        integrity.reset()
        health.configure(prev_hb[0], interval=prev_hb[1],
                         timeout=prev_hb[2])
        for k, v in plan_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for t in list(teams) + list(new_teams or ()):
            try:
                t.destroy()
            except Exception:  # noqa: BLE001
                pass
        for c in ctxs:
            try:
                c.destroy()
            except Exception:  # noqa: BLE001
                pass
    return report


# ---------------------------------------------------------------------------
# multi-tenant service drill (priority lanes + coalescing under failure)
# ---------------------------------------------------------------------------

def _drive_requests(ctxs, reqs, deadline_s: float) -> bool:
    """Poll *reqs* (membership requests: shrink/grow/join) to terminal.
    Every request is polled each pass: their ``test()`` is what drives
    the OOB rebuild rounds, so a short-circuiting ``all()`` deadlocks."""
    from ucc_tpu_torch import Status
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        for c in ctxs:
            c.progress()
        sts = [rq.test() for rq in reqs]
        if all(st != Status.IN_PROGRESS for st in sts):
            return True
    return False


# ---------------------------------------------------------------------------
# churn: kill -> shrink -> grow(rejoin) cycles (elastic membership drill)
# ---------------------------------------------------------------------------

def run_churn_soak(n_ranks: int = 4, cycles: int = 2,
                   iters_per_epoch: int = 4, post_iters: int = 60,
                   hb_interval: float = 0.02, hb_timeout: float = 0.3,
                   iter_deadline_s: float = 15.0,
                   membership_deadline_s: float = 30.0,
                   count: int = 64, matrix=DEFAULT_MATRIX,
                   plans: bool = False, collect: bool = False,
                   device: Optional[str] = None) -> Dict:
    """The elastic-membership drill: *cycles* interleaved
    kill -> detect -> shrink -> grow(rejoin) rounds with matrix
    collectives in flight on EVERY epoch, then a false-suspicion round (a
    live rank is excluded by hint and re-admitted through the join path)
    and *post_iters* checked collectives on the final team.

    Checked invariants (anything else lands in ``violations``):

    - no rank is ever left IN_PROGRESS past a deadline (no hang);
    - every survivor observes ERR_RANK_FAILED naming the killed rank;
    - shrink and grow converge to one (membership, epoch) view;
    - the epoch fence discards stale traffic in BOTH directions
      (``fenced`` counts a pre-shrink send killed by the shrink fence and
      a pre-grow send killed by the grow fence, per cycle);
    - the falsely suspected rank is re-admitted: revived out of the
      survivors' dead sets and serving checked collectives on the new
      epoch (``readmitted``);
    - the final membership is the initial one and *post_iters*
      collectives complete correctly on it (``post_churn_ok``).

    *device* (``"cuda"``, or ``"cpu"`` for the device TLs' plain
    versions) makes every collective an allreduce of f32 tensors on that
    device in CUDA memory (the matrix is then allreduce alone), checked
    against the exact sum; its teams are set up under
    ``_SETUP_HB_TIMEOUT`` and *hb_timeout* is armed once every context
    has beaten (a card's first work can hold one progress pass longer
    than the drill's timeout, as in the multi-tenant drill).
    """
    from ucc_tpu_torch import Status
    from ucc_tpu_torch.core.team import Team

    from . import health

    if device is not None:
        matrix = ("allreduce",)
    inject.reset()
    prev_mode, prev_int, prev_to = (health.MODE, health.HEARTBEAT_INTERVAL,
                                    health.HEARTBEAT_TIMEOUT)
    health.configure("shrink", interval=hb_interval,
                     timeout=_SETUP_HB_TIMEOUT if device else hb_timeout)
    plan_env = None
    if plans:
        # native-matcher mode: the allreduces ride the generated native
        # plans, so both fence directions are drilled against the C
        # matcher rather than the Python mailbox
        plan_env = {k: os.environ.get(k)
                    for k in ("UCC_GEN_NATIVE", "UCC_TL_SHM_TUNE")}
        os.environ["UCC_GEN_NATIVE"] = "y"
        os.environ["UCC_TL_SHM_TUNE"] = "allreduce:@ring:inf"
    prev_knobs = _collect_on() if collect else None
    ctxs = _make_job(n_ranks)
    teams = _make_team(ctxs)
    if device is not None:
        for c in ctxs:
            c.progress()
        health.configure("shrink", interval=hb_interval, timeout=hb_timeout)
    report: Dict = {"cycles": 0, "violations": [], "outcomes": {},
                    "fenced": {"shrink": 0, "grow": 0},
                    "epochs": [], "post_churn_ok": 0,
                    "readmitted": False, "matcher": None,
                    "injected": {}}
    bufs: Dict = {}
    all_teams: List = list(teams)    # every team ever built, for teardown

    def _note_injected():
        for k, v in dict(inject.COUNTS).items():
            report["injected"][k] = report["injected"].get(k, 0) + v

    def _probe(old_team, direction: str):
        # the shrink probe posts into epoch 0, the tag space before any
        # change, so it tests the fence whichever change retired the team
        sub: Dict = {"violations": [], "stale_send_fenced": None,
                     "matcher": None}
        _probe_stale_send_fence(old_team, sub)
        if sub["matcher"] is not None:
            report["matcher"] = sub["matcher"]
        if sub["stale_send_fenced"]:
            report["fenced"][direction] += 1
        for v in sub["violations"]:
            report["violations"].append(f"{direction} fence: {v}")

    def _iters(cs, ts, n, bufs_, phase, labels, k, check=False):
        for it in range(k):
            before = len(report["violations"])
            _drive_iter(cs, ts, matrix[it % len(matrix)], n, count, bufs_,
                        iter_deadline_s, report, phase, labels,
                        check=check, device=device)
            if check and len(report["violations"]) == before:
                report["post_churn_ok"] += 1

    def _membership_change(cur, dead_team_rank, dead_ctx, hint=False):
        """One shrink(+probe) -> iters -> grow(rejoin)(+probe) -> iters
        round. *cur* maps ctx index -> its current Team; returns the
        next such map (full membership again) or None on failure."""
        survivors = sorted(i for i in cur if i != dead_team_rank)
        shrinks = {}
        for i in survivors:
            try:
                # dead_hint is in TEAM ranks; after the first grow the
                # joiner sits at the tail, so team rank != ctx rank
                t = cur[i]
                hint_ranks = [r for r in range(t.size)
                              if int(t.ctx_map.eval(r)) == dead_ctx] \
                    if hint else None
                shrinks[i] = t.shrink_post(dead_hint=hint_ranks)
            except Exception as e:  # noqa: BLE001
                report["violations"].append(
                    f"ctx {i} shrink_post raised {type(e).__name__}: {e}")
                return None
        sctxs = [ctxs[i] for i in survivors]
        if not _drive_requests(sctxs, list(shrinks.values()),
                               membership_deadline_s):
            report["violations"].append(
                f"shrink (dead ctx {dead_ctx}) hung past "
                f"{membership_deadline_s}s")
            return None
        views = set()
        for i, sr in shrinks.items():
            st = sr.test()
            if st != Status.OK:
                report["violations"].append(
                    f"ctx {i} shrink failed: {st.name}")
                return None
            views.add((tuple(sr.failed_ranks or ()), sr.epoch))
        if len(views) > 1:
            report["violations"].append(f"shrink views diverged: {views}")
            return None
        report["epochs"].append(next(iter(views))[1])
        _probe(cur[survivors[0]], "shrink")
        shrunk = {i: shrinks[i].new_team for i in survivors}
        _iters(sctxs, [shrunk[i] for i in survivors], len(survivors), {},
               f"shrunk-e{report['epochs'][-1]}", survivors,
               iters_per_epoch)
        all_teams.extend(shrunk.values())
        # the excluded rank comes back: clear the drill fault, retire its
        # stale pre-shrink team, and re-admit it through the join path
        _note_injected()
        inject.reset()
        try:
            cur[dead_team_rank].destroy()
        except Exception:  # noqa: BLE001
            pass
        grows = {}
        for i in survivors:
            try:
                grows[i] = shrunk[i].grow_post([dead_ctx])
            except Exception as e:  # noqa: BLE001
                report["violations"].append(
                    f"ctx {i} grow_post raised {type(e).__name__}: {e}")
                return None
        try:
            join = Team.join_post(ctxs[dead_team_rank])
        except Exception as e:  # noqa: BLE001
            report["violations"].append(
                f"ctx {dead_team_rank} join_post raised "
                f"{type(e).__name__}: {e}")
            return None
        if not _drive_requests(ctxs, list(grows.values()) + [join],
                               membership_deadline_s):
            report["violations"].append(
                f"grow (rejoin ctx {dead_ctx}) hung past "
                f"{membership_deadline_s}s")
            return None
        gviews = set()
        for i, g in grows.items():
            st = g.test()
            if st != Status.OK:
                report["violations"].append(
                    f"ctx {i} grow failed: {st.name}")
                return None
            gviews.add(g.epoch)
        if join.test() != Status.OK:
            report["violations"].append(
                f"ctx {dead_team_rank} join failed: {join.test().name}")
            return None
        gviews.add(join.epoch)
        if len(gviews) > 1:
            report["violations"].append(f"grow epochs diverged: {gviews}")
            return None
        report["epochs"].append(next(iter(gviews)))
        _probe(shrunk[survivors[0]], "grow")
        nxt = {i: grows[i].new_team for i in survivors}
        nxt[dead_team_rank] = join.new_team
        all_teams.extend(nxt.values())
        order = sorted(nxt)
        _iters([ctxs[i] for i in order], [nxt[i] for i in order],
               len(order), {}, f"grown-e{report['epochs'][-1]}", order,
               iters_per_epoch)
        return nxt

    cur = {i: teams[i] for i in range(n_ranks)}
    try:
        # -- kill -> shrink -> grow cycles ----------------------------
        for cyc in range(cycles):
            kill_team_rank = 1 + (cyc % (n_ranks - 1))
            killed_ctx = ctxs[kill_team_rank].rank
            inject.configure(f"kill={killed_ctx}", seed=cyc)
            survivors = sorted(i for i in cur if i != kill_team_rank)
            # a collective across the kill: every survivor must reach
            # ERR_RANK_FAILED naming the dead rank, nobody parks
            reqs = {}
            for i in survivors:
                try:
                    reqs[i] = cur[i].collective_init(
                        _coll_args("allreduce", i, n_ranks, count, bufs,
                                   0.0, device=device))
                    reqs[i].post()
                except Exception as e:  # noqa: BLE001
                    report["violations"].append(
                        f"cycle {cyc}: survivor {i} post raised "
                        f"{type(e).__name__}: {e}")
            deadline = time.monotonic() + iter_deadline_s
            while time.monotonic() < deadline:
                for i in survivors:
                    ctxs[i].progress()
                if all([rq.test() != Status.IN_PROGRESS
                        for rq in reqs.values()]):
                    break
            for i, rq in reqs.items():
                st = rq.test()
                if st == Status.IN_PROGRESS:
                    report["violations"].append(
                        f"cycle {cyc}: survivor {i} IN_PROGRESS after "
                        "kill")
                    rq.task.cancel(Status.ERR_TIMED_OUT)
                elif st != Status.ERR_RANK_FAILED:
                    report["violations"].append(
                        f"cycle {cyc}: survivor {i} saw {st.name}, not "
                        "ERR_RANK_FAILED")
                elif killed_ctx not in (rq.failed_ranks or []):
                    report["violations"].append(
                        f"cycle {cyc}: survivor {i} attribution "
                        f"{rq.failed_ranks} misses ctx {killed_ctx}")
                try:
                    rq.finalize()
                except Exception:  # noqa: BLE001
                    pass
            nxt = _membership_change(cur, kill_team_rank, killed_ctx)
            if nxt is None:
                return report
            cur = nxt
            report["cycles"] += 1

        # -- false suspicion: exclude a LIVE rank, re-admit it --------
        victim = n_ranks - 1
        victim_ctx = ctxs[victim].rank
        nxt = _membership_change(cur, victim, victim_ctx, hint=True)
        if nxt is None:
            return report
        cur = nxt
        readmitted = True
        for i in cur:
            if i == victim:
                continue
            reg = getattr(ctxs[i], "health", None)
            if reg is not None and victim_ctx in reg.dead_set():
                readmitted = False
        if not readmitted:
            report["violations"].append(
                f"falsely-suspected ctx {victim_ctx} still in a "
                "survivor dead set after rejoin")
        report["readmitted"] = readmitted

        # -- post-churn: checked collectives on the final epoch -------
        if sorted(cur) != list(range(n_ranks)):
            report["violations"].append(
                f"post-churn membership {sorted(cur)} != full "
                f"{list(range(n_ranks))}")
            return report
        order = sorted(cur)
        _iters([ctxs[i] for i in order], [cur[i] for i in order], n_ranks,
               {}, "post-churn", order, post_iters, check=True)
    finally:
        _note_injected()
        inject.reset()
        health.configure(prev_mode, interval=prev_int, timeout=prev_to)
        if plan_env is not None:
            for k, v in plan_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if collect:
            report["collector"] = _collector_section(ctxs)
        if report["fenced"]["shrink"] == 0 and report["cycles"]:
            report["violations"].append(
                "no pre-shrink send was fenced across the whole churn")
        if report["fenced"]["grow"] == 0 and report["cycles"]:
            report["violations"].append(
                "no pre-grow send was fenced across the whole churn")
        for t in all_teams:
            try:
                t.destroy()
            except Exception:  # noqa: BLE001
                pass
        for c in ctxs:
            try:
                c.destroy()
            except Exception:  # noqa: BLE001
                pass
        if prev_knobs is not None:
            _collect_off(prev_knobs)
    return report


#: the heartbeat timeout (seconds) the multi-tenant drill sets up under
_SETUP_HB_TIMEOUT = 60.0


def _make_teams_mt(ctxs, priority=None, deadline_s: float = 60.0):
    """One team across *ctxs* with an explicit priority class."""
    from ucc_tpu_torch import Status, TeamParams, ThreadOobWorld, UccError
    world = ThreadOobWorld(len(ctxs))
    teams = [c.create_team_post(TeamParams(oob=world.endpoint(i),
                                           priority=priority))
             for i, c in enumerate(ctxs)]
    deadline = time.monotonic() + deadline_s
    while True:
        # list comp, not a generator: every rank's create state machine
        # must step each pass or the OOB exchange deadlocks
        sts = [t.create_test() for t in teams]
        for c in ctxs:
            c.progress()
        if all(s == Status.OK for s in sts):
            return teams
        bad = [s for s in sts if s.is_error]
        if bad:
            raise UccError(bad[0], "mt soak team create failed")
        if time.monotonic() > deadline:
            raise TimeoutError("mt soak team create timed out")


def run_multi_tenant_soak(n_ranks: int = 4, n_teams: int = 3,
                          rounds: int = 5, burst: int = 6,
                          post_rounds: int = 5, kill_rank: int = 2,
                          hb_interval: float = 0.02,
                          hb_timeout: float = 0.3,
                          iter_deadline_s: float = 15.0,
                          membership_deadline_s: float = 30.0,
                          count: int = 32) -> Dict:
    """The multi-tenant service drill: *n_teams* teams share one
    progress engine per rank: team 0 is the latency class (priority 3),
    the rest are bulk (priority 0) with small-collective coalescing ON.
    Phases:

    1. mixed traffic: every round the bulk teams post a *burst* of
       coalesce-eligible allreduces, then the latency team posts a
       probe per rank (completion-callback timed);
    2. kill one rank mid-traffic: every surviving tenant's in-flight
       work: including members HELD by a coalescer and batches already
       sealed into fused carriers: must reach a terminal status within
       the deadline (the no-hang invariant extended to the batching
       layer), with the failure attributed;
    3. recovery: every team shrinks among the survivors, then grows the
       revived rank back in (sequential join per team);
    4. post-recovery mixed traffic with checked statuses, and the
       priority-inversion probe: per-context ``qos_snapshot`` counters
       (inversions, starvation gauge) recorded in the report :
       starvation past 1s is a violation.

    Returns a report dict; ``report["violations"]`` MUST be empty.
    """
    from ucc_tpu_torch import BufferInfo, CollArgs, CollType, DataType, Status
    from ucc_tpu_torch.constants import ReductionOp
    from ucc_tpu_torch.core import coalesce as _coal
    from ucc_tpu_torch.core.team import Team

    from . import health

    inject.reset()
    prev_mode, prev_int, prev_to = (health.MODE, health.HEARTBEAT_INTERVAL,
                                    health.HEARTBEAT_TIMEOUT)
    # set up under a lenient heartbeat timeout: on a GPU host the first
    # device work of the process (the device TLs' contexts and teams) can
    # hold one progress pass past the drill's timeout, and every context
    # would be declared dead; the drill's timeout is armed once every
    # context has beaten after the set-up
    health.configure("shrink", interval=hb_interval,
                     timeout=max(hb_timeout, _SETUP_HB_TIMEOUT))
    prev_coal = (_coal.ENABLED, _coal.LIMIT_BYTES,
                 round(_coal.WINDOW_S * 1e6), _coal.MAX_BATCH)
    _coal.configure(enabled=True)
    report: Dict = {"teams": n_teams, "ranks": n_ranks, "rounds": 0,
                    "post_rounds_ok": 0, "violations": [], "outcomes": {},
                    "detected": {}, "shrunk_epochs": {}, "grown_epochs": {},
                    "hi_probe_ms": {}, "qos": {}, "fused_batches": 0}
    ctxs = _make_job(n_ranks)
    # team 0 = latency class; teams 1.. = bulk tenants (coalesced)
    cur: List[Dict] = []
    for t in range(n_teams):
        per = _make_teams_mt(ctxs, priority=(3 if t == 0 else 0))
        cur.append({i: per[i] for i in range(n_ranks)})
    all_teams: List = [tm for per in cur for tm in per.values()]
    for c in ctxs:                      # every context beats afresh
        c.progress()
    health.configure("shrink", timeout=hb_timeout)

    def _ar_args(cb=None):
        a = CollArgs(coll_type=CollType.ALLREDUCE, op=ReductionOp.SUM,
                     src=BufferInfo(np.ones(count, np.float32), count,
                                    DataType.FLOAT32),
                     dst=BufferInfo(np.zeros(count, np.float32), count,
                                    DataType.FLOAT32))
        a.cb = cb
        return a

    def _mixed_round(members, phase, check=False):
        """One bulk-burst + latency-probe round over *members* (ctx
        index -> per-team Team maps). Returns hi-probe latencies (ms)."""
        order = sorted(members[0])
        reqs, lats = [], []
        for per in members[1:]:
            for _ in range(burst):
                for i in order:
                    rq = per[i].collective_init(_ar_args())
                    rq.post()
                    reqs.append(rq)
        done = {}

        def _stamp(i):
            def _cb(_t, _st):
                done[i] = time.perf_counter()
            return _cb

        t0 = {}
        hi = []
        for i in order:
            t0[i] = time.perf_counter()
            rq = members[0][i].collective_init(_ar_args(cb=_stamp(i)))
            rq.post()
            hi.append(rq)
            reqs.append(rq)
        deadline = time.monotonic() + iter_deadline_s
        while time.monotonic() < deadline:
            for i in order:
                ctxs[i].progress()
            if all(rq.test() != Status.IN_PROGRESS for rq in reqs):
                break
        sts = [rq.test() for rq in reqs]
        for s in sts:
            key = f"{phase}:{s.name}"
            report["outcomes"][key] = report["outcomes"].get(key, 0) + 1
        stuck = sum(1 for s in sts if s == Status.IN_PROGRESS)
        if stuck:
            report["violations"].append(
                f"{phase}: {stuck} request(s) IN_PROGRESS past deadline")
            for rq in reqs:
                if rq.test() == Status.IN_PROGRESS:
                    rq.task.cancel(Status.ERR_TIMED_OUT)
        elif check and any(s != Status.OK for s in sts):
            bad = sorted({s.name for s in sts if s != Status.OK})
            report["violations"].append(f"{phase}: failures {bad}")
        for i in order:
            if i in done:
                lats.append((done[i] - t0[i]) * 1e3)
        for rq in reqs:
            try:
                rq.finalize()
            except Exception:  # noqa: BLE001
                pass
        return lats

    try:
        # -- phase 1: healthy mixed traffic ---------------------------
        hi_lats: List[float] = []
        for _ in range(rounds):
            hi_lats.extend(_mixed_round(cur, "mixed", check=True))
            report["rounds"] += 1

        # -- phase 2: kill one rank mid-traffic -----------------------
        killed_ctx = ctxs[kill_rank].rank
        survivors = [i for i in range(n_ranks) if i != kill_rank]
        report["killed"] = {"team_rank": kill_rank, "ctx_rank": killed_ctx}
        inject.configure(f"kill={killed_ctx}", seed=0)
        reqs = {}
        for t, per in enumerate(cur):
            for i in survivors:
                try:
                    rq = per[i].collective_init(_ar_args())
                    rq.post()
                    reqs[(t, i)] = rq
                except Exception as e:  # noqa: BLE001
                    report["violations"].append(
                        f"kill: team {t} rank {i} post raised "
                        f"{type(e).__name__}: {e}")
        deadline = time.monotonic() + iter_deadline_s
        while time.monotonic() < deadline:
            for i in survivors:
                ctxs[i].progress()
            if all(rq.test() != Status.IN_PROGRESS
                   for rq in reqs.values()):
                break
        attributed = 0
        for (t, i), rq in reqs.items():
            st = rq.test()
            report["detected"][f"t{t}r{i}"] = st.name
            if st == Status.IN_PROGRESS:
                report["violations"].append(
                    f"kill: team {t} rank {i} IN_PROGRESS after kill "
                    "(held/fused member not aborted?)")
                rq.task.cancel(Status.ERR_TIMED_OUT)
            elif not st.is_error:
                report["violations"].append(
                    f"kill: team {t} rank {i} saw {st.name}, expected "
                    "an error")
            if killed_ctx in (rq.failed_ranks or []):
                attributed += 1
            try:
                rq.finalize()
            except Exception:  # noqa: BLE001
                pass
        if reqs and not attributed:
            report["violations"].append(
                f"kill: no survivor attributed the failure to ctx "
                f"{killed_ctx}")

        # -- phase 3: shrink every tenant among the survivors ---------
        shrunk: List[Dict] = []
        for t, per in enumerate(cur):
            shrinks = {}
            for i in survivors:
                try:
                    shrinks[i] = per[i].shrink_post()
                except Exception as e:  # noqa: BLE001
                    report["violations"].append(
                        f"shrink: team {t} rank {i} raised "
                        f"{type(e).__name__}: {e}")
                    return report
            if not _drive_requests([ctxs[i] for i in survivors],
                                   list(shrinks.values()),
                                   membership_deadline_s):
                report["violations"].append(f"shrink: team {t} hung")
                return report
            views = set()
            for i, s in shrinks.items():
                if s.test() != Status.OK:
                    report["violations"].append(
                        f"shrink: team {t} rank {i} failed "
                        f"{s.test().name}")
                    return report
                views.add((tuple(s.failed_ranks or ()), s.epoch))
            if len(views) > 1:
                report["violations"].append(
                    f"shrink: team {t} views diverged {views}")
                return report
            report["shrunk_epochs"][f"t{t}"] = next(iter(views))[1]
            shrunk.append({i: shrinks[i].new_team for i in survivors})
            all_teams.extend(shrunk[-1].values())
        # traffic must flow for every tenant on the shrunk epoch
        _mixed_round(shrunk, "shrunk", check=True)

        # -- phase 4: grow the revived rank back into every team ------
        inject.reset()
        for per in cur:
            try:
                per[kill_rank].destroy()
            except Exception:  # noqa: BLE001
                pass
        grown: List[Dict] = []
        for t, per in enumerate(shrunk):
            grows = {}
            for i in survivors:
                try:
                    grows[i] = per[i].grow_post([killed_ctx])
                except Exception as e:  # noqa: BLE001
                    report["violations"].append(
                        f"grow: team {t} rank {i} raised "
                        f"{type(e).__name__}: {e}")
                    return report
            try:
                join = Team.join_post(ctxs[kill_rank])
            except Exception as e:  # noqa: BLE001
                report["violations"].append(
                    f"grow: team {t} join raised {type(e).__name__}: {e}")
                return report
            if not _drive_requests(ctxs, list(grows.values()) + [join],
                                   membership_deadline_s):
                report["violations"].append(f"grow: team {t} hung")
                return report
            epochs = set()
            for i, g in grows.items():
                if g.test() != Status.OK:
                    report["violations"].append(
                        f"grow: team {t} rank {i} failed {g.test().name}")
                    return report
                epochs.add(g.epoch)
            if join.test() != Status.OK:
                report["violations"].append(
                    f"grow: team {t} join failed {join.test().name}")
                return report
            epochs.add(join.epoch)
            if len(epochs) > 1:
                report["violations"].append(
                    f"grow: team {t} epochs diverged {epochs}")
                return report
            report["grown_epochs"][f"t{t}"] = next(iter(epochs))
            nxt = {i: grows[i].new_team for i in survivors}
            nxt[kill_rank] = join.new_team
            grown.append(nxt)
            all_teams.extend(nxt.values())

        # -- phase 5: post-recovery traffic + inversion probe ---------
        for _ in range(post_rounds):
            before = len(report["violations"])
            hi_lats.extend(_mixed_round(grown, "post", check=True))
            if len(report["violations"]) == before:
                report["post_rounds_ok"] += 1
        if hi_lats:
            arr = sorted(hi_lats)
            report["hi_probe_ms"] = {
                "n": len(arr),
                "p50": round(arr[len(arr) // 2], 3),
                "max": round(arr[-1], 3)}
        report["fused_batches"] = sum(
            getattr(tm.coalescer, "_fused_seq", 0)
            for per in grown for tm in per.values()
            if getattr(tm, "coalescer", None) is not None)
        # priority-inversion probe: the lanes' own counters. Inversions
        # are recorded (timing-dependent, not a hard failure); actual
        # starvation: a queued task aged past 1s: is a violation.
        inv, starve = 0, 0.0
        for i, c in enumerate(ctxs):
            try:
                snap = c.progress_queue.qos_snapshot()
            except Exception:  # noqa: BLE001 - probe is observational
                continue
            report["qos"][f"ctx{i}"] = snap
            inv += snap.get("inversions", 0)
            starve = max(starve, snap.get("starvation_max_ms", 0.0))
        report["priority_inversions"] = inv
        report["starvation_max_ms"] = round(starve, 3)
        if starve > 1000.0:
            report["violations"].append(
                f"priority lanes starved a task for {starve:.0f}ms")
    finally:
        report["injected"] = dict(inject.COUNTS)
        inject.reset()
        health.configure(prev_mode, interval=prev_int, timeout=prev_to)
        _coal.configure(enabled=prev_coal[0], limit=prev_coal[1],
                        window_us=prev_coal[2], max_batch=prev_coal[3])
        for tm in all_teams:
            try:
                tm.destroy()
            except Exception:  # noqa: BLE001
                pass
        for c in ctxs:
            try:
                c.destroy()
            except Exception:  # noqa: BLE001
                pass
    return report


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    ap = argparse.ArgumentParser(prog="python -m ucc_tpu_torch.fault.soak")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--spec", default=_DEFAULT_SPEC)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--coll-timeout", type=float, default=0.5)
    ap.add_argument("--iter-deadline", type=float, default=10.0)
    ap.add_argument("--collect", action="store_true",
                    help="run the continuous telemetry collector during "
                    "the soak; the report gains a 'collector' section "
                    "(windows closed, flagged context ranks)")
    ap.add_argument("--kill-shrink", action="store_true",
                    help="run the kill+shrink recovery drill instead of "
                    "the probabilistic soak (UCC_FT=shrink pipeline)")
    ap.add_argument("--kill-rank", type=int, default=2)
    ap.add_argument("--post-iters", type=int, default=60)
    ap.add_argument("--churn", action="store_true",
                    help="run the elastic-membership churn drill: "
                    "interleaved kill->shrink->grow(rejoin) cycles with "
                    "collectives in flight on every epoch, a false-"
                    "suspicion re-admission round, and checked post-"
                    "churn collectives (UCC_FT=shrink + Team.grow)")
    ap.add_argument("--cycles", type=int, default=2,
                    help="with --churn: kill->shrink->grow cycles to run")
    ap.add_argument("--procs", type=int, default=0,
                    help="run the cross-process kill+shrink drill: N OS "
                    "processes host --ranks ranks over one shared-memory "
                    "arena (UCC_TLS=ipc,self), the last process is "
                    "SIGKILLed whole, survivors must detect via the "
                    "arena pid board, agree, shrink and resume a "
                    "checked matrix")
    ap.add_argument("--plans", action="store_true",
                    help="with --kill-shrink: force the allreduces onto "
                    "native execution plans (UCC_GEN_NATIVE=y, ring) and "
                    "check that cancellation withdrew their posted recvs "
                    "and that a pre-shrink plan send is fenced")
    ap.add_argument("--multi", action="store_true",
                    help="run the multi-tenant drill: N teams of mixed "
                    "priority share one progress engine (bulk tenants "
                    "coalescing), a rank is killed mid-traffic, every "
                    "team shrinks and grows the rank back, and the "
                    "priority-inversion/starvation counters are probed")
    ap.add_argument("--mt-teams", type=int, default=3,
                    help="with --multi: tenant teams (first is the "
                    "latency class)")
    ap.add_argument("--mt-rounds", type=int, default=5,
                    help="with --multi: mixed-traffic rounds per phase")
    ap.add_argument("--mt-burst", type=int, default=6,
                    help="with --multi: bulk posts per team-rank per "
                    "round")
    ap.add_argument("--corrupt", action="store_true",
                    help="run the corruption-storm integrity drill: one "
                    "rank corrupts every send (clean crc on the frame), "
                    "wire checksums must detect+attribute 100%% of "
                    "rounds, the strike ledger must quarantine the "
                    "corruptor within --strikes detections, and the "
                    "shrunk team must run a checked matrix "
                    "(UCC_INTEGRITY=verify + UCC_FT=shrink + native "
                    "plans)")
    ap.add_argument("--corrupt-rank", type=int, default=1,
                    help="with --corrupt: team rank that corrupts")
    ap.add_argument("--strikes", type=int, default=3,
                    help="with --corrupt: quarantine threshold "
                    "(UCC_INTEGRITY_STRIKES)")
    args = ap.parse_args(argv)
    if args.procs:
        report = run_procs_kill_shrink(
            n_procs=args.procs,
            ranks_per=max(1, args.ranks // args.procs),
            post_iters=args.post_iters)
        print(json.dumps(report, indent=1))
        return 1 if report["violations"] else 0
    if args.corrupt:
        report = run_corrupt_soak(args.ranks,
                                  corrupt_rank=args.corrupt_rank,
                                  strikes=args.strikes,
                                  post_iters=args.post_iters)
        print(json.dumps(report, indent=1))
        return 1 if report["violations"] else 0
    if args.multi:
        report = run_multi_tenant_soak(args.ranks, n_teams=args.mt_teams,
                                       rounds=args.mt_rounds,
                                       burst=args.mt_burst,
                                       post_rounds=args.mt_rounds,
                                       kill_rank=args.kill_rank)
        print(json.dumps(report, indent=1))
        return 1 if report["violations"] else 0
    if args.churn:
        report = run_churn_soak(args.ranks, cycles=args.cycles,
                                post_iters=args.post_iters,
                                plans=args.plans, collect=args.collect)
        print(json.dumps(report, indent=1))
        return 1 if report["violations"] else 0
    if args.kill_shrink:
        report = run_kill_shrink_soak(args.ranks, args.kill_rank,
                                      post_iters=args.post_iters,
                                      plans=args.plans)
        print(json.dumps(report, indent=1))
        return 1 if report["violations"] else 0
    report = run_soak(args.ranks, args.iterations, args.spec, args.seed,
                      args.coll_timeout, args.iter_deadline,
                      collect=args.collect)
    print(json.dumps(report, indent=1))
    return 1 if report["hangs"] else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
