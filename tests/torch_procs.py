"""Helpers of the port's multi-process tests (not a test file).

Spawned workers import this module, so it imports only the standard
library, numpy, torch and ``ucc_tpu_torch``: never JAX, never the JAX
package. Every worker reports whether ``jax`` is in its ``sys.modules``,
and the tests assert it is not.

- ``layout`` / ``make_args``: one collective case as per-rank numpy
  buffers from a seed, and its CollArgs in either package.
- ``run_procs``: run a worker in spawned processes with a time limit.
- ``job_worker``: a process holding one or more ranks of a job over
  ``TcpStoreOob`` (or ``TcpTreeOob``), running phases of collectives on
  teams created under a phase's environment.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import sys
import threading
import time
import traceback

import numpy as np
import torch

_NP = {"FLOAT32": np.float32, "FLOAT64": np.float64, "INT32": np.int32,
       "INT64": np.int64, "BFLOAT16": np.uint16, "FLOAT16": np.float16,
       "UINT8": np.uint8}
ROOTED = ("REDUCE", "GATHER", "SCATTER", "GATHERV", "SCATTERV")


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def data(rng, count, dt):
    if dt in ("INT32", "INT64"):
        return rng.integers(-50, 50, size=count).astype(_NP[dt])
    if dt == "UINT8":
        return rng.integers(0, 255, size=count).astype(np.uint8)
    x = (rng.random(count) * 4 - 2).astype(np.float32)
    if dt == "BFLOAT16":
        return torch.from_numpy(x).to(torch.bfloat16).view(
            torch.int16).numpy().view(np.uint16)
    return x.astype(_NP[dt])


def layout(coll, n, c, dt, seed, root=0, inplace=False):
    """Per-rank numpy (src, dst) arrays and v-counts of one case (None
    where a rank passes no buffer); ``c`` is the per-rank block count."""
    rng = np.random.default_rng(seed)
    srcs, dsts, meta = [None] * n, [None] * n, {}
    z = (lambda k: np.zeros(k, _NP[dt])) if dt else None
    if coll == "ALLREDUCE":
        for r in range(n):
            srcs[r], dsts[r] = data(rng, c, dt), z(c)
    elif coll == "REDUCE":
        for r in range(n):
            srcs[r] = data(rng, c, dt)
        dsts[root] = z(c)
    elif coll == "BCAST":
        for r in range(n):
            srcs[r] = data(rng, c, dt) if r == root else z(c)
    elif coll == "REDUCE_SCATTER":
        for r in range(n):
            srcs[r], dsts[r] = data(rng, n * c, dt), z(c)
    elif coll in ("ALLGATHER", "ALLTOALL"):
        for r in range(n):
            srcs[r] = data(rng, c if coll == "ALLGATHER" else n * c, dt)
            dsts[r] = z(n * c)
    elif coll == "GATHER":
        for r in range(n):
            srcs[r] = data(rng, c, dt)
        dsts[root] = z(n * c)
    elif coll == "SCATTER":
        srcs[root] = data(rng, n * c, dt)
        for r in range(n):
            dsts[r] = z(c)
    elif coll in ("ALLGATHERV", "GATHERV", "SCATTERV", "REDUCE_SCATTERV"):
        counts = [int(x) for x in rng.integers(0, 2 * c + 1, size=n)]
        counts[0] = max(counts[0], 1)
        displs = [int(x) for x in np.cumsum([0] + counts[:-1])]
        meta = {"counts": counts, "displs": displs}
        total = sum(counts)
        for r in range(n):
            if coll == "ALLGATHERV":
                srcs[r], dsts[r] = data(rng, counts[r], dt), z(total)
            elif coll == "GATHERV":
                srcs[r] = data(rng, counts[r], dt)
                if r == root:
                    dsts[r] = z(total)
            elif coll == "SCATTERV":
                if r == root:
                    srcs[r] = data(rng, total, dt)
                dsts[r] = z(counts[r])
            else:
                srcs[r], dsts[r] = data(rng, total, dt), z(counts[r])
    elif coll == "ALLTOALLV":
        cnt = rng.integers(0, 2 * c + 1, size=(n, n))
        meta = {"matrix": cnt}
        for r in range(n):
            srcs[r] = data(rng, int(cnt[r].sum()), dt)
            dsts[r] = z(int(cnt[:, r].sum()))
    if inplace:
        if coll in ("ALLREDUCE", "REDUCE_SCATTER", "ALLTOALL"):
            dsts, srcs = srcs, [None] * n
        elif coll == "ALLGATHER":
            for r in range(n):
                dsts[r][r * c:(r + 1) * c] = srcs[r]
            srcs = [None] * n
        elif coll == "REDUCE":
            dsts[root], srcs[root] = srcs[root], None
    return srcs, dsts, meta


#: the per-rank counts of tests/test_xla_multiprocess.py's allgatherv
XLA_MP_VCOUNTS = (8, 16, 24, 32)


def xla_mp_layout(coll, n, c, root):
    """The inputs of tests/test_xla_multiprocess.py's mode ``flat`` (float32,
    count c): allreduce of r + 1, gather of r + 1, scatter of arange from
    the root, allgatherv of r in ``XLA_MP_VCOUNTS[r]`` elements, bcast of
    3·arange from the root, alltoallv of 100·q + p in (q + p) % 3 + 1
    elements from q to p. (srcs, dsts, meta) as ``layout`` gives them."""
    f32 = np.float32
    srcs, dsts, meta = [None] * n, [None] * n, {}
    if coll in ("ALLREDUCE", "GATHER"):
        for r in range(n):
            srcs[r] = np.full(c, r + 1.0, f32)
        if coll == "ALLREDUCE":
            dsts = [np.zeros(c, f32) for _ in range(n)]
        else:
            dsts[root] = np.zeros(n * c, f32)
    elif coll == "SCATTER":
        srcs[root] = np.arange(n * c, dtype=f32)
        dsts = [np.zeros(c, f32) for _ in range(n)]
    elif coll == "ALLGATHERV":
        counts = list(XLA_MP_VCOUNTS[:n])
        meta = {"counts": counts,
                "displs": [int(x) for x in np.cumsum([0] + counts[:-1])]}
        for r in range(n):
            srcs[r] = np.full(counts[r], float(r), f32)
            dsts[r] = np.zeros(sum(counts), f32)
    elif coll == "BCAST":
        for r in range(n):
            srcs[r] = np.arange(c, dtype=f32) * 3 if r == root \
                else np.zeros(c, f32)
    elif coll == "ALLTOALLV":
        m = np.array([[(q + p) % 3 + 1 for p in range(n)] for q in range(n)])
        meta = {"matrix": m}
        for q in range(n):
            srcs[q] = np.concatenate([np.full(m[q][p], 100.0 * q + p, f32)
                                      for p in range(n)])
            dsts[q] = np.zeros(int(m[:, q].sum()), f32)
    else:
        raise ValueError(coll)
    return srcs, dsts, meta


def port_buf(arr, dt, kind="tensor"):
    """A numpy case buffer as the port takes it: a CPU tensor
    (bfloat16 as torch.bfloat16) or a numpy copy."""
    if arr is None:
        return None
    if kind == "numpy":
        return arr.copy()
    t = torch.from_numpy(arr.view(np.int16) if dt == "BFLOAT16"
                         else arr).clone()
    return t.view(torch.bfloat16) if dt == "BFLOAT16" else t


def bits(buf):
    if buf is None:
        return None
    if isinstance(buf, torch.Tensor):
        if buf.numel() == 0:
            return b""
        return buf.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(buf).reshape(-1).view(np.uint8).tobytes()


def make_args(mod, coll, r, n, src, dst, meta, dt, op=None, root=0,
              inplace=False, persistent=False, mem_type=None):
    """CollArgs of rank ``r`` for one case in package ``mod``."""
    flags = mod.CollArgsFlags(0)
    if inplace and (coll not in ROOTED or r == root):
        flags |= mod.CollArgsFlags.IN_PLACE
    if persistent:
        flags |= mod.CollArgsFlags.PERSISTENT
    D = mod.DataType[dt] if dt else None
    kw = {} if mem_type is None else {"mem_type": mem_type}

    def bi(buf, count):
        return None if buf is None else mod.BufferInfo(buf, count, D, **kw)

    def biv(buf, counts, displs):
        return mod.BufferInfoV(buf, list(counts), list(displs), D, **kw)

    def nel(b):
        if b is None:
            return 0
        return b.numel() if isinstance(b, torch.Tensor) else b.size

    s = d = None
    if coll in ("ALLGATHERV", "GATHERV", "SCATTERV", "REDUCE_SCATTERV"):
        counts, displs = meta["counts"], meta["displs"]
        if coll == "ALLGATHERV":
            s, d = bi(src, counts[r]), biv(dst, counts, displs)
        elif coll == "GATHERV":
            s = bi(src, counts[r])
            d = biv(dst, counts, displs) if dst is not None else None
        elif coll == "SCATTERV":
            s = biv(src, counts, displs) if src is not None else None
            d = bi(dst, counts[r])
        else:
            s, d = bi(src, sum(counts)), biv(dst, counts, displs)
    elif coll == "ALLTOALLV":
        m = meta["matrix"]
        sc = [int(x) for x in m[r]]
        rc = [int(x) for x in m[:, r]]
        s = biv(src, sc, [int(x) for x in np.cumsum([0] + sc[:-1])])
        d = biv(dst, rc, [int(x) for x in np.cumsum([0] + rc[:-1])])
    elif coll not in ("BARRIER", "FANIN", "FANOUT"):
        s, d = bi(src, nel(src)), bi(dst, nel(dst))
    return mod.CollArgs(coll_type=mod.CollType[coll], src=s, dst=d,
                        op=mod.ReductionOp[op] if op else None, root=root,
                        flags=flags)


def case_buffers(case, n, conv):
    """(srcs, dsts, meta) of a case dict, converted by ``conv``."""
    coll = case["coll"]
    dt = case.get("dt")
    if case.get("values") == "xla_mp":
        srcs, dsts, meta = xla_mp_layout(coll, n, case.get("c", 0),
                                         case.get("root", 0))
    else:
        srcs, dsts, meta = ([None] * n, [None] * n, {}) \
            if coll in ("BARRIER", "FANIN", "FANOUT") else \
            layout(coll, n, case.get("c", 0), dt, case.get("seed", 0),
                   case.get("root", 0), case.get("inplace", False))
    return ([conv(a, dt) for a in srcs], [conv(a, dt) for a in dsts], meta)


def result_of(case, r, srcs, dsts):
    """The bytes a case leaves on rank r: bcast's src, else the dst (the
    in-place dst included)."""
    if case["coll"] == "BCAST":
        return bits(srcs[r])
    return bits(dsts[r])


# ---------------------------------------------------------------------------
# spawned processes
# ---------------------------------------------------------------------------

def run_procs(target, specs, timeout=120.0):
    """Run ``target(idx, spec, queue)`` in one spawned process per spec;
    each puts ``(idx, result)``. Returns the results by index (a dict with
    "error" for a process that failed or did not report in time); every
    process is gone when this returns."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(i, s, q))
             for i, s in enumerate(specs)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < len(specs):
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                i, res = q.get(timeout=min(left, 1.0))
            except Exception:  # noqa: BLE001 - queue.Empty
                if not any(p.is_alive() for p in procs) and q.empty():
                    break
                continue
            out[i] = res
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        q.close()
    return [out.get(i, {"error": f"process {i} did not report"})
            for i in range(len(specs))]


def _set_env(values):
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    return old


#: a worker's pause between progress passes: the workers share the
#: machine's CPUs with the other tests of the run, and a pass that finds
#: nothing to do gives its core back for this long
_POLL_S = 1e-4


def wait_req(ut, req, timeout=120.0):
    """req.wait, progressing the team's context with a short pause when a
    pass leaves the request in progress; raises on the timeout."""
    ctx = req.team.context
    deadline = time.monotonic() + timeout
    while req.test() == ut.Status.IN_PROGRESS:
        ctx.progress()
        if time.monotonic() > deadline:
            req.task.cancel(ut.Status.ERR_TIMED_OUT)
            raise ut.UccError(ut.Status.ERR_TIMED_OUT, "request timed out")
        time.sleep(_POLL_S)
    return req.test()


def create_team(ut, ctx, oob, timeout=120.0):
    """ctx.create_team with the same pause between passes."""
    team = ctx.create_team_post(ut.TeamParams(oob=oob))
    deadline = time.monotonic() + timeout
    while team.create_test() == ut.Status.IN_PROGRESS:
        ctx.progress()
        if time.monotonic() > deadline:
            raise ut.UccError(ut.Status.ERR_TIMED_OUT, "team create timed "
                              "out")
        time.sleep(_POLL_S)
    st = team.create_test()
    if st != ut.Status.OK:
        raise ut.UccError(st, "team create failed")
    return team


def _exchange_handles(ut, team, handle, n):
    """Allgather the exported memh handles over the team (a padded uint8
    allgather)."""
    pad = 2048
    blob = np.zeros(pad, np.uint8)
    blob[:8] = np.frombuffer(np.int64(len(handle)).tobytes(), np.uint8)
    blob[8:8 + len(handle)] = np.frombuffer(handle, np.uint8)
    out = np.zeros(pad * n, np.uint8)
    req = team.collective_init(ut.CollArgs(
        coll_type=ut.CollType.ALLGATHER,
        src=ut.BufferInfo(blob, pad, ut.DataType.UINT8),
        dst=ut.BufferInfo(out, pad * n, ut.DataType.UINT8)))
    req.post()
    wait_req(ut, req)
    req.finalize()
    hs = []
    for p in range(n):
        seg = out[p * pad:(p + 1) * pad]
        ln = int(np.frombuffer(seg[:8].tobytes(), np.int64)[0])
        hs.append(seg[8:8 + ln].tobytes())
    return hs


def run_case_rank(ut, team, case, r, n):
    """Run one case on rank r of ``team``; returns (status name, algorithm
    name, result bytes). ``swap_at`` k: before round k (from 1) the rank's
    buffers are replaced by fresh copies (a persistent request's buffers
    changed between rounds); ``counters``: a fourth element, the device
    span counters (obs/metrics) gained after the first round."""
    coll = case["coll"]
    dt = case.get("dt")
    srcs, dsts, meta = case_buffers(
        case, n, lambda a, d: port_buf(a, d, case.get("kind", "tensor")))
    mem = case.get("mem")
    args = make_args(ut, coll, r, n, srcs[r], dsts[r], meta, dt,
                     case.get("op"), case.get("root", 0),
                     case.get("inplace", False),
                     persistent=case.get("rounds", 1) > 1,
                     mem_type=ut.MemoryType[mem] if mem else None)
    memh = case.get("memh")
    handles = []
    if memh:
        ctx = team.context
        for which in memh:
            buf = dsts[r] if which == "dst" else srcs[r]
            h = ctx.mem_map(buf)
            handles.append(h)
            hs = _exchange_handles(ut, team, h, n)
            setattr(args, f"{which}_memh", hs)
            args.flags |= (ut.CollArgsFlags.MEM_MAP_DST_MEMH
                           if which == "dst"
                           else ut.CollArgsFlags.MEM_MAP_SRC_MEMH)
    try:
        req = team.collective_init(args)
    except ut.UccError as e:
        return f"init {e.status.name}", None, None
    st = None
    from ucc_tpu_torch.obs import metrics
    after_first = None
    for k in range(case.get("rounds", 1)):
        if k + 1 == case.get("swap_at"):
            for side, bufs in (("src", srcs), ("dst", dsts)):
                bi = getattr(args, side)
                if bi is not None:
                    bufs[r] = bi.buffer = bi.buffer.clone()
        req.post()
        st = wait_req(ut, req, case.get("timeout", 120))
        if k == 0:
            after_first = dict(metrics.span_counts)
    alg = req.task.alg_name
    req.finalize()
    for h in handles:
        team.context.mem_unmap(h)
    out = (st.name, alg,
           result_of(case, r, srcs, dsts) if st.name == "OK" else None)
    if case.get("counters"):
        out += ({k: v - after_first[k]
                 for k, v in metrics.span_counts.items()},)
    return out


def span_names():
    """The sync-area names of this process's spanning device teams: each
    team's area and its staging files in /dev/shm start with it."""
    from ucc_tpu_torch.tl import device
    with device._SHARED_LOCK:
        return sorted(s.span.name for s in device._SHARED.values()
                      if s.span is not None)


def _rank_phase(ut, ctx, r, n, phase, oob_for, out, errs):
    try:
        from ucc_tpu_torch.tools.perftest import transport_tier
        res = {"cases": [], "ids": []}
        teams = []
        for k in range(phase.get("n_teams", 1)):
            team = create_team(ut, ctx, oob_for(r, k))
            teams.append(team)
            res["ids"].append(int(team.id))
        res["span_names"] = span_names()
        team = teams[0]
        res["tier"] = transport_tier(team)
        svc = team.service_team
        res["svc"] = None if svc is None else svc.TL_CLS.NAME
        for case in phase.get("cases", []):
            res["cases"].append(run_case_rank(ut, team, case, r, n))
        for t in teams:
            t.destroy()
        out[r] = res
    except Exception:  # noqa: BLE001
        errs.append((r, traceback.format_exc()))


def job_worker(idx, spec, q):
    """One process of a job: ranks ``spec["ranks"]`` of ``spec["n"]``,
    contexts over a TcpStoreOob (``spec["ports"]``: context store, then
    one store per team), or over a TcpTreeOob when ``spec["tree"]`` gives
    (base_port, ppn, radix). ``spec["phases"]`` run in order: each sets
    its environment, creates ``n_teams`` teams on every local rank (in a
    thread per rank) and runs its cases on the first."""
    try:
        _set_env(spec.get("env", {}))
        import ucc_tpu_torch as ut
        n = spec["n"]
        ranks = spec["ranks"]
        ports = spec.get("ports")
        tree = spec.get("tree")
        libs = {r: ut.init() for r in ranks}
        ctxs, errs = {}, []
        oobs = []

        def ctx_oob(r):
            if tree:
                base, ppn, radix = tree
                o = ut.TcpTreeOob(r, n, base_port=base, ppn=ppn,
                                  radix=radix, key="ctx")
            else:
                o = ut.TcpStoreOob(r, n, port=ports[0])
            oobs.append(o)
            return o

        team_oobs = {}

        def oob_for(r, k):
            key = (r, k)
            if key not in team_oobs:
                if tree:
                    base, ppn, radix = tree
                    span = ut.TcpTreeOob.ports_needed(n, ppn, radix)
                    o = ut.TcpTreeOob(r, n, base_port=base + span * (k + 1),
                                      ppn=ppn, radix=radix, key=f"t{k}")
                else:
                    o = ut.TcpStoreOob(r, n, port=ports[1 + k])
                team_oobs[key] = o
                oobs.append(o)
            return team_oobs[key]

        def make(r):
            try:
                ctxs[r] = ut.Context(libs[r],
                                     ut.ContextParams(oob=ctx_oob(r)))
            except Exception:  # noqa: BLE001
                errs.append((r, traceback.format_exc()))

        ths = [threading.Thread(target=make, args=(r,)) for r in ranks]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
        result = {"jax": "jax" in sys.modules, "pid": os.getpid(),
                  "phases": []}
        if errs or len(ctxs) != len(ranks):
            raise RuntimeError(f"context create failed: {errs}")
        team_k = 0
        for phase in spec.get("phases", []):
            old = _set_env(phase.get("env", {}))
            out, perrs = {}, []
            base_k = team_k
            team_k += phase.get("n_teams", 1)
            ths = [threading.Thread(
                target=_rank_phase,
                args=(ut, ctxs[r], r, n, phase,
                      lambda rr, k, b=base_k: oob_for(rr, b + k), out,
                      perrs))
                for r in ranks]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=spec.get("phase_timeout", 150))
            _set_env(old)
            if perrs or len(out) != len(ranks):
                raise RuntimeError(f"phase failed: {perrs}")
            result["phases"].append(out)
        arena = None
        for r in ranks:
            tl = ctxs[r].tl_contexts.get("ipc")
            if tl is not None and tl.obj.arena is not None:
                arena = tl.obj.arena.counters()
        result["arena"] = arena
        for r in ranks:
            ctxs[r].destroy()
        for o in oobs:
            o.close()
        result["jax"] = result["jax"] or "jax" in sys.modules
        q.put((idx, result))
    except Exception:  # noqa: BLE001
        q.put((idx, {"error": traceback.format_exc(),
                     "jax": "jax" in sys.modules}))


def death_worker(idx, spec, q):
    """Two ranks over sockets: rank 1 dies abruptly after team create,
    rank 0 then runs an allreduce with a 3 s collective timeout and
    reports how it ended."""
    try:
        os.environ.update({"UCC_TLS": "socket,self"})
        import ucc_tpu_torch as ut_
        n, port = spec["n"], spec["ports"]
        oobs = [ut_.TcpStoreOob(idx, n, port=port[0])]
        ctx = ut_.Context(ut_.init(), ut_.ContextParams(oob=oobs[0]))
        oobs.append(ut_.TcpStoreOob(idx, n, port=port[1]))
        team = create_team(ut_, ctx, oobs[1])
        if idx == 1:
            q.put((idx, {"out": "died", "jax": "jax" in sys.modules}))
            q.close()
            q.join_thread()
            os._exit(1)       # abrupt death: no finalize, sockets reset
        src = np.full(16, 1.0, np.float32)
        dst = np.zeros(16, np.float32)
        req = team.collective_init(ut_.CollArgs(
            coll_type=ut_.CollType.ALLREDUCE,
            src=ut_.BufferInfo(src, 16, ut_.DataType.FLOAT32),
            dst=ut_.BufferInfo(dst, 16, ut_.DataType.FLOAT32),
            op=ut_.ReductionOp.SUM, flags=ut_.CollArgsFlags.TIMEOUT,
            timeout=3.0))
        req.post()
        try:
            out = wait_req(ut_, req, 30).name
        except Exception as e:  # noqa: BLE001 - wait's own deadline
            out = f"WAIT_RAISED:{e}"
        q.put((idx, {"out": out, "jax": "jax" in sys.modules}))
    except Exception:  # noqa: BLE001
        import traceback
        q.put((idx, {"error": traceback.format_exc()}))


def span_death_worker(idx, spec, q):
    """Two processes of one rank each, a device team across them (device
    ``cpu``): process 0 exits abruptly after team create; process 1 then
    posts an allreduce and reports how it ended and how long it took."""
    try:
        os.environ.update({"UCC_TL_RING_CUDA_DEVICE": "cpu"})
        import ucc_tpu_torch as ut_
        n, port = spec["n"], spec["ports"]
        oobs = [ut_.TcpStoreOob(idx, n, port=port[0])]
        ctx = ut_.Context(ut_.init(), ut_.ContextParams(oob=oobs[0]))
        oobs.append(ut_.TcpStoreOob(idx, n, port=port[1]))
        team = create_team(ut_, ctx, oobs[1])
        names = span_names()
        if idx == 0:
            q.put((idx, {"out": "died", "pid": os.getpid(),
                         "jax": "jax" in sys.modules}))
            q.close()
            q.join_thread()
            os._exit(1)       # abrupt death: the sync area's creator
        src = torch.ones(16)
        dst = torch.zeros(16)
        cuda = ut_.MemoryType.CUDA
        req = team.collective_init(ut_.CollArgs(
            coll_type=ut_.CollType.ALLREDUCE,
            src=ut_.BufferInfo(src, 16, ut_.DataType.FLOAT32, mem_type=cuda),
            dst=ut_.BufferInfo(dst, 16, ut_.DataType.FLOAT32, mem_type=cuda),
            op=ut_.ReductionOp.SUM))
        t0 = time.monotonic()
        req.post()
        try:
            out = wait_req(ut_, req, 60).name
        except Exception as e:  # noqa: BLE001 - wait's own deadline
            out = f"WAIT_RAISED:{e}"
        took = time.monotonic() - t0
        alg = req.task.alg_name
        team.destroy()
        ctx.destroy()
        for o in oobs:
            o.close()
        q.put((idx, {"out": out, "took": took, "alg": alg,
                     "span_names": names, "pid": os.getpid(),
                     "jax": "jax" in sys.modules}))
    except Exception:  # noqa: BLE001
        import traceback
        q.put((idx, {"error": traceback.format_exc()}))


def bulk_send_worker(idx, spec, q):
    """Two ranks over sockets: rank 0 sends one frame of ``nbytes``
    through its tl/sockets transport to rank 1 and destroys its context
    the moment the send completes (the kernel may still hold most of the
    frame), then exits; rank 1 reports whether it received every byte.
    Rank 1's listener gets a small receive buffer before the connection
    opens, so the sender's kernel still holds megabytes when it closes."""
    try:
        import socket
        os.environ.update({"UCC_TLS": "socket,self"})
        import ucc_tpu_torch as ut_
        oob = ut_.TcpStoreOob(idx, 2, port=spec["ports"][0])
        ctx = ut_.Context(ut_.init(), ut_.ContextParams(oob=oob))
        tl = ctx.tl_contexts["socket"].obj
        if idx == 1:
            tl.transport.lsock.setsockopt(socket.SOL_SOCKET,
                                          socket.SO_RCVBUF, 1 << 12)
        oob.allgather(b"").wait()      # rank 1's buffer is set
        data = np.random.default_rng(spec["seed"]).integers(
            0, 256, spec["nbytes"], dtype=np.uint8)
        key = ("bulk", spec["seed"])
        if idx == 0:
            tl.transport.send_to_addr(tl.peer_addrs[1], key, data)
            ctx.destroy()
            q.put((idx, {"out": "sent", "jax": "jax" in sys.modules}))
            oob.close()
            return
        dst = np.zeros_like(data)
        req = tl.transport.recv_nb(key, dst)
        deadline = time.monotonic() + spec["timeout"]
        while not req.test() and time.monotonic() < deadline:
            time.sleep(0.01)
        out = ("timeout" if not req.test() else
               "equal" if np.array_equal(dst, data) else "differs")
        ctx.destroy()
        oob.close()
        q.put((idx, {"out": out, "jax": "jax" in sys.modules}))
    except Exception:  # noqa: BLE001
        q.put((idx, {"error": traceback.format_exc()}))


_PROBE_EAGER = 1024
_PROBE_TEAM = ("ipc-probe", 0)


def _probe_key(tag, epoch=1):
    return (_PROBE_TEAM, epoch, tag, 0, 0)


def arena_probe_worker(idx, spec, q):
    """Two processes on one named arena: role 0 pushes (ctx rank 0),
    role 1 receives (ctx rank 1). A barrier orders who acts first, so
    each match kind (direct, eager, rndv, fenced) is forced."""
    try:
        from ucc_tpu_torch import native
        role, bar = idx, spec["barrier"]
        ar = native.IpcArena(spec["name"], heap_bytes=8 << 20,
                             win_bytes=1 << 20)
        ar.register(role)
        ar.beat(role)
        out = {"created": ar.created, "pid": os.getpid(), "kinds": {},
               "max_msg": ar.max_msg}

        def spin(req, what):
            deadline = time.monotonic() + 30
            while not req.test():
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{what} never completed")
                time.sleep(0.0005)

        small = (np.arange(512) % 251).astype(np.uint8)
        big = (np.arange(64 << 10) % 249).astype(np.uint8)
        if role == 1:                          # A: recv posted first
            dst_a = np.zeros(512, np.uint8)
            req_a = ar.post_recv(_probe_key(1), 1, dst_a)
        bar.wait(timeout=60)
        if role == 0:
            req, kind = ar.push(_probe_key(1), 1, small, _PROBE_EAGER)
            out["kinds"]["recv_first"] = kind
            spin(req, "direct send")
        bar.wait(timeout=60)
        if role == 1:
            spin(req_a, "direct recv")
            out["recv_first_ok"] = bool(np.array_equal(dst_a, small))
        if role == 0:                          # B: small send first
            req, kind = ar.push(_probe_key(2), 1, small, _PROBE_EAGER)
            out["kinds"]["send_first_small"] = kind
            spin(req, "eager send")
        bar.wait(timeout=60)
        if role == 1:
            dst_b = np.zeros(512, np.uint8)
            req_b = ar.post_recv(_probe_key(2), 1, dst_b)
            spin(req_b, "eager recv")
            out["send_first_small_ok"] = bool(np.array_equal(dst_b, small))
        bar.wait(timeout=60)
        if role == 0:                          # C: big send first
            req_c, kind = ar.push(_probe_key(3), 1, big, _PROBE_EAGER)
            out["kinds"]["send_first_big"] = kind
            out["rndv_pending"] = not req_c.test()
        bar.wait(timeout=60)
        if role == 1:
            dst_c = np.zeros(64 << 10, np.uint8)
            req_cr = ar.post_recv(_probe_key(3), 1, dst_c)
            spin(req_cr, "rndv recv")
            out["send_first_big_ok"] = bool(np.array_equal(dst_c, big))
        bar.wait(timeout=60)
        if role == 0:
            spin(req_c, "rndv send completion")
        if role == 1:                          # D: a fenced epoch
            ar.fence(_PROBE_TEAM, 2)
        bar.wait(timeout=60)
        if role == 0:
            _, kind = ar.push(_probe_key(4, epoch=1), 1, small, _PROBE_EAGER)
            out["kinds"]["stale_epoch"] = kind
        bar.wait(timeout=60)
        out["peer_pid"] = ar.peer_pid(1 - role)
        out["peer_beat_ms"] = ar.beat_age_ms(1 - role)
        out["counters"] = ar.counters()
        bar.wait(timeout=60)
        ar.detach(unlink=bool(ar.created))
        out["jax"] = "jax" in sys.modules
        q.put((idx, out))
    except Exception:  # noqa: BLE001
        q.put((idx, {"error": traceback.format_exc()}))


def arena_leak_worker(idx, spec, q):
    """Create an arena, register, and die without detaching: the segment
    a crashed job leaves behind."""
    try:
        from ucc_tpu_torch import native
        ar = native.IpcArena(spec["name"], heap_bytes=8 << 20,
                             win_bytes=1 << 20)
        ar.register(0)
        q.put((idx, {"created": ar.created, "pid": os.getpid(),
                     "jax": "jax" in sys.modules}))
        q.close()
        q.join_thread()
        os._exit(0)
    except Exception:  # noqa: BLE001
        q.put((idx, {"error": traceback.format_exc()}))


def split_ranks(n, procs):
    """Contiguous rank blocks, one per process."""
    per = [n // procs + (1 if i < n % procs else 0) for i in range(procs)]
    out, r = [], 0
    for k in per:
        out.append(list(range(r, r + k)))
        r += k
    return out


def collect(results, n):
    """Merge per-process results into per-phase, per-rank dicts; raises
    on a failed process or a worker that imported JAX."""
    for i, res in enumerate(results):
        if "error" in res:
            raise AssertionError(f"process {i}: {res['error']}")
        assert not res["jax"], f"process {i} imported jax"
    phases = []
    for k in range(len(results[0]["phases"])):
        merged = {}
        for res in results:
            merged.update(res["phases"][k])
        assert sorted(merged) == list(range(n))
        phases.append(merged)
    return phases
