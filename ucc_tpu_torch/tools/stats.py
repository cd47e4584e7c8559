"""ucc_stats: pretty-print, diff, and watch UCC_STATS metric dumps (the
port of the JAX package's ``tools/stats.py``; ``python -m
ucc_tpu_torch.tools.stats``).

``obs.metrics`` appends one JSON snapshot per line to ``UCC_STATS_FILE``;
this tool renders them:

    ucc_stats dump.json                  # latest snapshot, pretty
    ucc_stats dump.json --first          # earliest snapshot instead
    ucc_stats a.json b.json              # diff: latest(a) -> latest(b)
    ucc_stats dump.json --diff           # diff last two snapshots
    ucc_stats dump.json --self-diff      # diff first -> last of one file
    ucc_stats dump.json --watch 2        # live: re-read every 2s and
                                         # print the delta per interval
                                         # (pair with UCC_STATS_INTERVAL)
    ucc_stats dump.json --qos            # queue waits, coalesce batches
    ucc_stats dump.json --integrity      # wire/attestation/quarantine

Histograms are rendered as derived p50/p99 estimates (log-interpolated
inside the log2 buckets) rather than raw bucket counts; pass
``--buckets`` for the raw distribution. Counter diffs print deltas;
gauges print (old -> new); histograms print count/sum deltas. Exit
status 1 on unreadable/empty input. The output is the JAX package's,
line for line, on the same snapshot.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional


def load_snapshots(path: str) -> List[Dict[str, Any]]:
    snaps = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "counters" in rec:
                snaps.append(rec)
    return snaps


def _fmt_key(k: str) -> str:
    component, coll, alg = (k.split("|") + ["", "", ""])[:3]
    parts = [p for p in (component, coll, alg) if p]
    return "/".join(parts) if parts else "(total)"


def _fmt_val(v: float) -> str:
    if isinstance(v, float) and not v.is_integer():
        return f"{v:.3f}"
    return f"{int(v):,}"


def _fmt_signed(v: float) -> str:
    if isinstance(v, float) and not v.is_integer():
        return f"{v:+.3f}"
    return f"{int(v):+,}"


def hist_percentile(slot: Dict[str, Any], q: float) -> float:
    """Estimate the q-quantile (0..1) of a log2-bucket histogram slot.
    Bucket b counts samples in [2^(b-1), 2^b) (bucket 0: [0, 1)); the
    position inside the winning bucket is linearly interpolated, and the
    top estimate is clamped to the recorded exact max."""
    count = slot.get("count", 0)
    buckets = slot.get("buckets") or {}
    if not count or not buckets:
        return 0.0
    target = max(1e-9, q * count)
    cum = 0.0
    mx = float(slot.get("max", 0) or 0)
    for b, c in sorted(buckets.items(), key=lambda kv: int(kv[0])):
        b = int(b)
        if cum + c >= target:
            lo = 0.0 if b == 0 else float(1 << (b - 1))
            hi = 1.0 if b == 0 else float(1 << b)
            if mx:
                hi = min(hi, mx)
            frac = (target - cum) / c
            return lo + frac * max(0.0, hi - lo)
        cum += c
    return mx


def print_snapshot(snap: Dict[str, Any], out=None,
                   show_buckets: bool = False) -> None:
    w = (out or sys.stdout).write
    w(f"# pid {snap.get('pid')} uptime {snap.get('uptime_s')}s "
      f"reason={snap.get('reason', '?')}\n")
    for section in ("counters", "gauges"):
        table = snap.get(section) or {}
        if not table:
            continue
        w(f"\n[{section}]\n")
        for name in sorted(table):
            for k, v in sorted(table[name].items()):
                w(f"  {name:<28} {_fmt_key(k):<40} {_fmt_val(v)}\n")
    hists = snap.get("histograms") or {}
    if hists:
        w("\n[histograms]  (p50/p99 interpolated from log2 buckets"
          + ("" if show_buckets else "; --buckets for raw counts")
          + ")\n")
        for name in sorted(hists):
            for k, slot in sorted(hists[name].items()):
                count = slot.get("count", 0)
                avg = (slot.get("sum", 0) / count) if count else 0
                p50 = hist_percentile(slot, 0.50)
                p99 = hist_percentile(slot, 0.99)
                w(f"  {name:<28} {_fmt_key(k):<40} "
                  f"count={count} avg={avg:.1f} p50={p50:.1f} "
                  f"p99={p99:.1f} max={slot.get('max', 0)}\n")
                buckets = slot.get("buckets") or {}
                if show_buckets and buckets:
                    bs = " ".join(
                        f"{b}:{c}" for b, c in
                        sorted(buckets.items(), key=lambda kv: int(kv[0])))
                    w(f"  {'':<28} {'':<40} {bs}\n")


def print_qos(snap: Dict[str, Any], out=None) -> None:
    """Focused multi-tenant QoS view (``--qos``): per-team/lane
    queue-wait percentiles, coalesce batch sizes per flush reason, and
    the inversion/starvation counters: the ``qos_*`` series the
    priority-lane progress queue and the coalescer emit."""
    w = (out or sys.stdout).write
    w(f"# qos view: pid {snap.get('pid')} uptime "
      f"{snap.get('uptime_s')}s\n")
    hists = snap.get("histograms") or {}
    waits = hists.get("qos_queue_wait_us") or {}
    if waits:
        w("\n[queue wait, us]  (per team/lane; enqueue -> first "
          "service)\n")
        for k, slot in sorted(waits.items()):
            count = slot.get("count", 0)
            avg = (slot.get("sum", 0) / count) if count else 0
            w(f"  {_fmt_key(k):<40} count={count} avg={avg:.1f} "
              f"p50={hist_percentile(slot, 0.50):.1f} "
              f"p99={hist_percentile(slot, 0.99):.1f} "
              f"max={float(slot.get('max', 0)):.1f}\n")
    batches = hists.get("qos_coalesce_batch") or {}
    if batches:
        w("\n[coalesce batch size]  (per flush reason)\n")
        for k, slot in sorted(batches.items()):
            count = slot.get("count", 0)
            avg = (slot.get("sum", 0) / count) if count else 0
            w(f"  {_fmt_key(k):<40} flushes={count} avg={avg:.1f} "
              f"max={slot.get('max', 0)}\n")
    counters = snap.get("counters") or {}
    gauges = snap.get("gauges") or {}
    rows = []
    for name in ("qos_priority_inversions", "qos_coalesce_fused"):
        for k, v in sorted((counters.get(name) or {}).items()):
            rows.append((name, k, v))
    for name in ("progress_starvation_max_ms", "qos_lane_depth"):
        for k, v in sorted((gauges.get(name) or {}).items()):
            rows.append((name, k, v))
    if rows:
        w("\n[contention]\n")
        for name, k, v in rows:
            w(f"  {name:<28} {_fmt_key(k):<40} {_fmt_val(v)}\n")
    if not (waits or batches or rows):
        w("  no qos_* series in this snapshot (priority lanes idle "
          "and coalescing off?)\n")


def print_integrity(snap: Dict[str, Any], out=None) -> None:
    """Focused data-integrity view (``--integrity``): the
    ``integrity_*`` counter family the wire-checksum / attestation /
    quarantine machinery emits, plus a derived detection ratio."""
    w = (out or sys.stdout).write
    w(f"# integrity view: pid {snap.get('pid')} uptime "
      f"{snap.get('uptime_s')}s\n")
    counters = snap.get("counters") or {}
    rows = []
    for name in ("integrity_wire_mismatch", "integrity_digest_checks",
                 "integrity_digest_mismatch", "integrity_quarantines",
                 "rank_failures_detected"):
        for k, v in sorted((counters.get(name) or {}).items()):
            rows.append((name, k, v))
    if rows:
        w("\n[integrity]\n")
        for name, k, v in rows:
            w(f"  {name:<28} {_fmt_key(k):<40} {_fmt_val(v)}\n")
        checks = sum((counters.get("integrity_digest_checks") or {})
                     .values())
        hits = sum((counters.get("integrity_digest_mismatch") or {})
                   .values())
        if checks:
            w(f"\n  digest mismatch ratio: {hits}/{int(checks)} "
              f"({100.0 * hits / checks:.2f}%)\n")
    else:
        w("  no integrity_* series in this snapshot "
          "(UCC_INTEGRITY off or no traffic)\n")


def diff_snapshots(old: Dict[str, Any], new: Dict[str, Any],
                   out=None) -> None:
    w = (out or sys.stdout).write
    w(f"# diff: uptime {old.get('uptime_s')}s -> {new.get('uptime_s')}s\n")
    for name in sorted(set(old.get("counters", {}))
                       | set(new.get("counters", {}))):
        o = old.get("counters", {}).get(name, {})
        n = new.get("counters", {}).get(name, {})
        for k in sorted(set(o) | set(n)):
            d = n.get(k, 0) - o.get(k, 0)
            if d:
                w(f"  {name:<28} {_fmt_key(k):<40} {_fmt_signed(d)}\n")
    for name in sorted(set(old.get("gauges", {})) | set(new.get("gauges", {}))):
        o = old.get("gauges", {}).get(name, {})
        n = new.get("gauges", {}).get(name, {})
        for k in sorted(set(o) | set(n)):
            if o.get(k) != n.get(k):
                w(f"  {name:<28} {_fmt_key(k):<40} "
                  f"{_fmt_val(o.get(k, 0))} -> {_fmt_val(n.get(k, 0))}\n")
    for name in sorted(set(old.get("histograms", {}))
                       | set(new.get("histograms", {}))):
        o = old.get("histograms", {}).get(name, {})
        n = new.get("histograms", {}).get(name, {})
        for k in sorted(set(o) | set(n)):
            oc = o.get(k, {}).get("count", 0)
            nc = n.get(k, {}).get("count", 0)
            if nc != oc:
                osum = o.get(k, {}).get("sum", 0)
                nsum = n.get(k, {}).get("sum", 0)
                w(f"  {name:<28} {_fmt_key(k):<40} "
                  f"{nc - oc:+} samples ({nsum - osum:+.1f})\n")


def watch(path: str, interval: float, count: int = 0, out=None) -> int:
    """Live mode: poll *path* and print the delta whenever a new
    snapshot line lands (pair with UCC_STATS_INTERVAL so the producer
    keeps appending). *count* > 0 bounds the number of polls (tests);
    0 polls until interrupted."""
    out = out or sys.stdout
    prev: Optional[Dict[str, Any]] = None
    seen = 0
    polls = 0
    try:
        while True:
            try:
                snaps = load_snapshots(path)
            except OSError:
                snaps = []
            if len(snaps) > seen:
                cur = snaps[-1]
                out.write(f"\n=== {time.strftime('%H:%M:%S')} "
                          f"({len(snaps)} snapshot(s)) ===\n")
                if prev is None:
                    print_snapshot(cur, out)
                else:
                    diff_snapshots(prev, cur, out)
                out.flush()
                prev = cur
                seen = len(snaps)
            polls += 1
            if count and polls >= count:
                return 0
            time.sleep(max(0.05, interval))
    except KeyboardInterrupt:
        return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ucc_stats",
        description="pretty-print / diff / watch UCC_STATS JSON dumps")
    ap.add_argument("files", nargs="+",
                    help="one dump file (print) or two (diff latest of "
                         "each)")
    ap.add_argument("--first", action="store_true",
                    help="use the earliest snapshot instead of the latest")
    ap.add_argument("--diff", action="store_true",
                    help="diff the last two snapshots of a single file "
                         "(two files always diff, with or without this)")
    ap.add_argument("--self-diff", action="store_true",
                    help="diff first -> last snapshot of a single file")
    ap.add_argument("--buckets", action="store_true",
                    help="also print raw log2 bucket counts under each "
                         "histogram (default shows derived p50/p99 only)")
    ap.add_argument("--qos", action="store_true",
                    help="print only the multi-tenant QoS view: queue-"
                         "wait histogram, coalesce batch sizes, "
                         "contention counters")
    ap.add_argument("--integrity", action="store_true",
                    help="print only the data-integrity view: wire crc "
                         "mismatches, attestation digest checks, "
                         "quarantines")
    ap.add_argument("--watch", type=float, metavar="SECS", default=None,
                    help="live mode: re-read the file every SECS seconds "
                         "and print the per-interval delta")
    ap.add_argument("--watch-count", type=int, default=0,
                    help="stop --watch after N polls (0 = until ^C)")
    args = ap.parse_args(argv)

    if args.watch is not None:
        if len(args.files) != 1:
            ap.error("--watch takes exactly one file")
        return watch(args.files[0], args.watch, args.watch_count)

    snapsets = []
    for path in args.files:
        try:
            snaps = load_snapshots(path)
        except OSError as e:
            print(f"ucc_stats: {e}", file=sys.stderr)
            return 1
        if not snaps:
            print(f"ucc_stats: no snapshots in {path}", file=sys.stderr)
            return 1
        snapsets.append(snaps)

    try:
        if args.qos:
            print_qos(snapsets[0][0 if args.first else -1])
        elif args.integrity:
            print_integrity(snapsets[0][0 if args.first else -1])
        elif len(snapsets) == 2:
            diff_snapshots(snapsets[0][-1], snapsets[1][-1])
        elif args.self_diff:
            diff_snapshots(snapsets[0][0], snapsets[0][-1])
        elif args.diff:
            if len(snapsets[0]) < 2:
                print("ucc_stats: --diff needs at least two snapshots",
                      file=sys.stderr)
                return 1
            diff_snapshots(snapsets[0][-2], snapsets[0][-1])
        else:
            print_snapshot(snapsets[0][0 if args.first else -1],
                           show_buckets=args.buckets)
    except BrokenPipeError:
        # `ucc_stats dump | head` closes the pipe early: that is not an
        # error worth a traceback
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


if __name__ == "__main__":
    sys.exit(main())
