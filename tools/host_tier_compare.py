"""Host allreduce across processes: the port's perftest against the JAX
package's, interleaved, on the ipc and the socket tier.

Each package runs ``python -m <pkg>.tools.perftest --procs N -m host -c
allreduce --json -b B -e E`` (both launch N processes of themselves over
TCP stores) in the order reference, port, port, reference, ``--reps``
times, so drift of the machine falls on both alike. Per tier and size it
prints the median over runs of each package's p50 and the ratio port /
reference; ``--persistent`` times init-once rounds instead.

Run on the CPU::

    JAX_PLATFORMS=cpu UCC_TL_RING_CUDA_DEVICE=cpu \\
        python tools/host_tier_compare.py --procs 4 --reps 2

The last line is one JSON object with every run's p50s.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("-b", "--begin", default="4K")
    ap.add_argument("-e", "--end", default="1M")
    ap.add_argument("--persistent", action="store_true")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
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
    sys.exit(main())
