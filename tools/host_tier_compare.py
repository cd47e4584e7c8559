"""Host allreduce across processes: the port's perftest against the JAX
package's, interleaved, on the ipc and the socket tier.

Each package runs ``python -m <pkg>.tools.perftest --procs N -m host -c
allreduce --json -b B -e E`` (both launch N processes of themselves over
TCP stores) in the order reference, port, port, reference, ``--reps``
times, so drift of the machine falls on both alike. Per tier and size it
prints the median over runs of each package's p50 and the ratio port /
reference; ``--persistent`` times init-once rounds instead.

``--calls`` splits a round instead (ipc tier, persistent rounds): this
tool launches N processes of itself per run, one rank each, which time
every round's ``post()``, its ``test()`` and context ``progress()``
calls, and the arena calls beneath them (``IpcArena.push`` and
``post_recv``, the send and recv requests' ``test``), by wrapping those
methods of the package at run time; per size it prints the median over
runs of each part's median per round, and how many calls a round made.

Run on the CPU::

    JAX_PLATFORMS=cpu UCC_TL_RING_CUDA_DEVICE=cpu \\
        python tools/host_tier_compare.py --procs 4 --reps 2
    JAX_PLATFORMS=cpu python tools/host_tier_compare.py --calls -e 128K

The last line is one JSON object with every run's p50s (with --calls,
every run's per-round parts).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

TIERS = {"ipc": {}, "socket": {"UCC_TLS": "socket,self"}}
PKGS = {"ref": "ucc_tpu", "port": "ucc_tpu_torch"}


def run_once(pkg: str, tier_env: dict, args) -> dict:
    cmd = [sys.executable, "-m", f"{PKGS[pkg]}.tools.perftest", "--procs",
           str(args.procs), "-m", "host", "-c", "allreduce", "--json", "-b",
           args.begin, "-e", args.end]
    if args.persistent:
        cmd.append("--persistent")
    env = {**os.environ, **tier_env}
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=args.timeout)
    if out.returncode != 0:
        raise SystemExit(f"{pkg} perftest failed ({out.returncode}): "
                         f"{out.stderr[-2000:]}")
    recs = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]
    return {r["size_bytes"]: (r["p50_us"], r["detail"]["transport"])
            for r in recs}


# ---------------------------------------------------------------------------
# --calls: where a round's time goes, call by call
# ---------------------------------------------------------------------------

#: the parts of a round: (name, module, class, method); "arena" sums the
#: four arena methods
PARTS = (("post", "core.coll", "CollRequest", "post"),
         ("test", "core.coll", "CollRequest", "test"),
         ("progress", "core.context", "Context", "progress"),
         ("arena", "native", "IpcArena", "push"),
         ("arena", "native", "IpcArena", "post_recv"),
         ("arena", "native", "IpcSendReq", "test"),
         ("arena", "native", "IpcRecvReq", "test"))


def _wrap(pkg, acc):
    """Time every call of PARTS' methods of *pkg* into acc[part] = [calls,
    seconds]; a call made inside another timed call counts in both (the
    arena's calls inside progress())."""
    import importlib
    import time
    for part, mod, cls, meth in PARTS:
        klass = getattr(importlib.import_module(f"{pkg}.{mod}"), cls)
        fn = getattr(klass, meth)
        slot = acc.setdefault(part, [0, 0.0])

        def timed(*a, _fn=fn, _slot=slot, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                _slot[0] += 1
                _slot[1] += time.perf_counter() - t0
        setattr(klass, meth, timed)


def calls_child(pkg: str, rank: int, n: int, port: int, begin: int,
                end: int, warmup: int, iters: int) -> int:
    """One rank: a context and a team over TCP stores at port and port +
    1, a persistent float32 allreduce per size on numpy buffers, each
    round split into PARTS. Rank 0 prints one JSON line."""
    import time

    import numpy as np
    mod = __import__(pkg)
    acc: dict = {}
    _wrap(pkg, acc)
    oob = mod.TcpStoreOob(rank, n, port=port)
    ctx = mod.Context(mod.init(), mod.ContextParams(oob=oob))
    team_oob = mod.TcpStoreOob(rank, n, port=port + 1)
    team = ctx.create_team(mod.TeamParams(oob=team_oob))
    out = {}
    size = begin
    while size <= end:
        count = size // 4
        src = np.ones(count, np.float32)
        dst = np.zeros(count, np.float32)
        req = team.collective_init(mod.CollArgs(
            coll_type=mod.CollType.ALLREDUCE, op=mod.ReductionOp.SUM,
            src=mod.BufferInfo(src, count, mod.DataType.FLOAT32),
            dst=mod.BufferInfo(dst, count, mod.DataType.FLOAT32),
            flags=mod.CollArgsFlags.PERSISTENT))
        rounds = []
        for it in range(warmup + iters):
            for v in acc.values():
                v[0], v[1] = 0, 0.0
            t0 = time.perf_counter()
            req.post()
            req.wait(timeout=120)
            total = time.perf_counter() - t0
            if it >= warmup:
                rounds.append({"round": total,
                               **{p: tuple(v) for p, v in acc.items()}})
        req.finalize()
        med = {"round_us": statistics.median(r["round"] for r in rounds)
               * 1e6}
        for part in acc:
            med[f"{part}_us"] = statistics.median(
                r[part][1] for r in rounds) * 1e6
            med[f"{part}_calls"] = statistics.median(
                r[part][0] for r in rounds)
        out[size] = med
        size *= 2
    team.destroy()
    ctx.destroy()
    oob.close()
    team_oob.close()
    if rank == 0:
        print(json.dumps(out), flush=True)
    return 0


def calls_run(pkg: str, args) -> dict:
    """One run of --calls: args.procs processes of this tool, one rank
    each; rank 0's table."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from ucc_tpu_torch.tools.perftest import HeldPorts, parse_memunits
    held = HeldPorts(2, contiguous=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = []
    try:
        for r in range(args.procs):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--calls-child",
                 pkg, str(r), str(args.procs), str(held.ports[0]),
                 str(parse_memunits(args.begin)),
                 str(parse_memunits(args.end))],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        outs = [p.communicate(timeout=args.timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        held.release()
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            raise SystemExit(f"{pkg} --calls worker failed "
                             f"({p.returncode}): {se[-2000:]}")
    return {int(k): v for k, v in
            json.loads(outs[0][0].strip().splitlines()[-1]).items()}


def calls_main(args) -> int:
    runs = {"ref": [], "port": []}
    for _ in range(args.reps):
        for pkg in ("ref", "port", "port", "ref"):
            runs[pkg].append(calls_run(PKGS[pkg], args))
    keys = [k for k in runs["port"][0][min(runs["port"][0])]]
    summary = {}
    print(f"# ipc tier, persistent allreduce, {args.procs} processes: "
          f"median over {len(runs['ref'])} runs of each part's median "
          f"per round (us; calls a round)")
    for size in sorted(runs["ref"][0]):
        summary[size] = {}
        for key in keys:
            ref = statistics.median(r[size].get(key, 0.0)
                                    for r in runs["ref"])
            port = statistics.median(r[size].get(key, 0.0)
                                     for r in runs["port"])
            summary[size][key] = {"ref": ref, "port": port}
        line = " ".join(
            f"{k[:-3]} {v['ref']:.1f}/{v['port']:.1f}"
            for k, v in summary[size].items() if k.endswith("_us"))
        calls = " ".join(
            f"{k[:-6]} {v['ref']:g}/{v['port']:g}"
            for k, v in summary[size].items() if k.endswith("_calls"))
        print(f"{size:>8} B ref/port: {line} | calls {calls}")
    print(json.dumps({"procs": args.procs, "calls": True,
                      "summary": summary, "runs": runs}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("-b", "--begin", default="4K")
    ap.add_argument("-e", "--end", default="1M")
    ap.add_argument("--persistent", action="store_true")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--calls", action="store_true",
                    help="split persistent ipc rounds into post, test, "
                         "progress and arena calls")
    args = ap.parse_args(argv)
    if args.calls:
        return calls_main(args)
    runs = {t: {"ref": [], "port": []} for t in TIERS}
    for _ in range(args.reps):
        for tier, tier_env in TIERS.items():
            for pkg in ("ref", "port", "port", "ref"):
                got = run_once(pkg, tier_env, args)
                tiers = {tr for _, tr in got.values()}
                if tiers != {tier}:
                    raise SystemExit(f"{pkg}: tier {tiers}, wanted {tier}")
                runs[tier][pkg].append({s: p for s, (p, _) in got.items()})
    summary = {}
    for tier, by in runs.items():
        print(f"# tier {tier}: median p50 (us) over "
              f"{len(by['ref'])} runs each")
        print(f"{'size':>10} {'reference':>12} {'port':>12} {'port/ref':>9}")
        summary[tier] = {}
        for size in sorted(by["ref"][0]):
            ref = statistics.median(r[size] for r in by["ref"])
            port = statistics.median(r[size] for r in by["port"])
            summary[tier][size] = {"ref_us": ref, "port_us": port,
                                   "ratio": port / ref}
            print(f"{size:>10} {ref:>12.1f} {port:>12.1f} "
                  f"{port / ref:>9.3f}")
    print(json.dumps({"procs": args.procs, "persistent": args.persistent,
                      "summary": summary, "runs": runs}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--calls-child"]:
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        a = sys.argv[2:]
        sys.exit(calls_child(a[0], *map(int, a[1:6]), warmup=20, iters=100))
    sys.exit(main())
