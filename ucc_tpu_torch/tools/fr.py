"""ucc_fr: flight-recorder collection, diagnosis and Perfetto export.

The console of the flight recorder (obs/flight.py, obs/diagnose.py)::

    python -m ucc_tpu_torch.tools.fr dump.json            # merge + diagnose
    python -m ucc_tpu_torch.tools.fr dump.json --json     # findings as JSON
    python -m ucc_tpu_torch.tools.fr dump.json --perfetto t.json
    python -m ucc_tpu_torch.tools.fr --pid 12345          # SIGUSR2: every
                                     # rank of that process appends its
                                     # ring to its UCC_FLIGHT_FILE
    python -m ucc_tpu_torch.tools.fr --smoke              # diagnosis drill

Input files hold one JSON record per line: ``flight_local`` (one rank's
ring, written on SIGUSR2 or by embedders) and/or ``flight_merged`` (a
cross-rank collection, written by watchdog escalation, rank-failure
detection or ``flight.collect_team``). Only records with this package's
schema tag are read. The freshest merged record wins; otherwise local
lines are merged latest-per-rank (obs/diagnose.merge_records).

A directory argument is a collector trace store (``UCC_COLLECT_DIR``,
obs/collector.py): its segments are merged, oldest first, and ``--tail
N`` keeps the N freshest segments::

    python -m ucc_tpu_torch.tools.fr ucc_traces/ --tail 50

``--smoke`` is the acceptance probe of the diagnosis: a 4-rank
in-process host job runs allreduces under ``UCC_FAULT=delay`` pinned to
one rank, collects the rings across ranks, and reports whether the
diagnosis named that rank and the collectives it was slow in.

``--feedback-smoke`` is the closed-loop probe of the collector: an
8-rank host job pins the ring allreduce at a high but finite score,
delays every send of one rank, and runs allreduces while the collector
windows the rings; it passes when the collector flags that rank within
two windows, selection moves off the ring, and the p99 falls.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
from typing import Any, Dict, List, Optional


def load_records(path: str) -> List[Dict[str, Any]]:
    """The flight records of a JSON-lines dump file that carry this
    package's schema tag (``diagnose.DUMP_VERSION``); records of another
    schema (the JAX package's dumps share the default file name and the
    ``flight_*`` kinds) are skipped with one warning on stderr."""
    from ucc_tpu_torch.obs.diagnose import DUMP_VERSION
    recs = []
    other = 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and str(rec.get("kind", "")).startswith(
                    "flight"):
                if rec.get("version") == DUMP_VERSION:
                    recs.append(rec)
                else:
                    other += 1
    if other:
        print(f"ucc_fr: {path}: skipped {other} flight record(s) of "
              f"another schema (version != {DUMP_VERSION!r})",
              file=sys.stderr)
    return recs


def print_report(merged: Dict[str, Any], diag: Dict[str, Any],
                 out=None) -> None:
    w = (out or sys.stdout).write
    ranks = merged.get("ranks") or {}
    w(f"# flight dump: {len(ranks)} rank(s), reason="
      f"{merged.get('reason', '?')}")
    absent = merged.get("absent_ranks") or []
    if absent:
        w(f", ABSENT ranks {','.join(str(r) for r in absent)}")
    w("\n")
    for r in sorted(ranks, key=int):
        snap = ranks[r]
        ev = snap.get("events") or []
        w(f"#   rank {r}: {len(ev)} events, "
          f"{len(snap.get('wire') or [])} wire, "
          f"dropped {snap.get('dropped', 0)}\n")
    # bootstrap spans (core/team.py state dwells, core/context.py OOB
    # exchange): the create-time wall, attributed per phase
    boot: Dict[str, List] = {}
    for r in ranks:
        for ev in ranks[r].get("events") or []:
            if ev.get("coll") == "bootstrap" and ev.get("stage"):
                boot.setdefault(ev["stage"], []).append(
                    (r, float(ev.get("dur_s") or 0.0)))
    if boot:
        w("# bootstrap spans:\n")
        for stage in sorted(boot):
            per = boot[stage]
            r_max, d_max = max(per, key=lambda x: x[1])
            w(f"#   {stage}: n={len(per)} max={d_max:.3f}s "
              f"(rank {r_max}) total={sum(d for _, d in per):.3f}s\n")
    summary = diag.get("summary") or []
    if not summary:
        w("clean: no desync, stragglers, missing participants, or "
          "failures detected\n")
        return
    for line in summary:
        w(line + "\n")


def _smoke_job(n: int):
    """*n* in-process ranks on host memory (tl/shm), one team over all of
    them: (contexts, teams)."""
    from ucc_tpu_torch.fault.soak import _make_job, _make_team
    ctxs = _make_job(n)
    return ctxs, _make_team(ctxs)


def _smoke(args) -> int:
    """Self-contained diagnosis drill (see module doc). Prints one JSON
    record: ``{"metric": "fr_smoke", "pinned_rank": R,
    "culprit_ranks": [...], "stuck_seqs": [...], "ok": bool}``."""
    rec: Dict[str, Any] = {"metric": "fr_smoke",
                           "pinned_rank": args.smoke_rank}
    try:
        import time

        import numpy as np

        from ucc_tpu_torch import (BufferInfo, CollArgs, CollType, DataType,
                                   ReductionOp, Status)
        from ucc_tpu_torch.fault import inject as fault
        from ucc_tpu_torch.obs import diagnose, flight

        flight.configure(enabled=True)
        n, count = 4, 4096
        ctxs, teams = _smoke_job(n)

        def drive(reqs, timeout):
            deadline = time.monotonic() + timeout
            while any([r.test() == Status.IN_PROGRESS for r in reqs]):
                for c in ctxs:
                    c.progress()
                if time.monotonic() > deadline:
                    raise TimeoutError("fr smoke: progress timed out")
        try:
            # pin send delays to ONE rank: every send it posts is held
            # for delay_s, the straggler the diagnosis must name from
            # the merged rings alone
            fault.configure(
                f"delay=1.0:{args.smoke_delay},"
                f"delay_rank={args.smoke_rank}", seed=0)
            try:
                srcs = [np.full(count, r + 1.0) for r in range(n)]
                dsts = [np.zeros(count) for _ in range(n)]
                for _ in range(args.smoke_iters):
                    reqs = [t.collective_init(CollArgs(
                        coll_type=CollType.ALLREDUCE,
                        src=BufferInfo(srcs[r], count, DataType.FLOAT64),
                        dst=BufferInfo(dsts[r], count, DataType.FLOAT64),
                        op=ReductionOp.SUM)) for r, t in enumerate(teams)]
                    for rq in reqs:
                        rq.post()
                    drive(reqs, 120)
                    for rq in reqs:
                        if rq.test() != Status.OK:
                            raise RuntimeError(
                                f"fr smoke allreduce: {rq.test().name}")
                        rq.finalize()
            finally:
                fault.reset()
            reqs = [flight.collect_team_post(t, reason="fr_smoke")
                    for t in teams]
            drive(reqs, 60)
            merged = reqs[0].result
        finally:
            for t in teams:
                t.destroy()
            for c in ctxs:
                c.destroy()
        diag = diagnose.diagnose(merged)
        lag = [f for f in diag.get("stragglers", ())
               if f.get("signal") == "wire_lag"]
        rec["culprit_ranks"] = sorted({f["rank"] for f in lag})
        rec["stuck_seqs"] = sorted({
            s.get("fseq") for f in lag for s in f.get("seqs", ())
            if s.get("fseq") is not None})
        rec["summary"] = diag.get("summary", [])[:6]
        rec["ok"] = rec["culprit_ranks"] == [args.smoke_rank] and \
            bool(rec["stuck_seqs"])
    except Exception as e:  # noqa: BLE001 - the probe reports, not raises
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["ok"] = False
    print(json.dumps(rec))
    return 0 if rec.get("ok") else 1


def _feedback_smoke(args) -> int:
    """Closed-loop telemetry drill (see the module doc). An 8-rank flat
    host job pins the ring allreduce by a TUNE string at a high but
    finite score (2e9 < SCORE_MAX, so the bias can demote it; ``inf``
    would be exempt), delays every send of ONE rank, and runs allreduces
    while the collector (obs/collector.py) windows the rings, scores the
    ranks and publishes the RankBias. Prints one JSON record:
    ``{"metric": "feedback_smoke", "pinned_rank": R, "flagged": [...],
    "windows_to_flag": W, "pre_alg": "...", "post_alg": "...",
    "pre_p99_ms": ..., "post_p99_ms": ..., "ok": bool}``."""
    rec: Dict[str, Any] = {"metric": "feedback_smoke",
                           "pinned_rank": args.smoke_rank}
    try:
        import time

        import numpy as np

        from ucc_tpu_torch import (BufferInfo, CollArgs, CollType, DataType,
                                   MemoryType, ReductionOp, Status)
        from ucc_tpu_torch.fault import inject as fault
        from ucc_tpu_torch.obs import collector, flight

        flight.configure(enabled=True)
        # the interval is well above one delayed ring iteration
        # (~2 (n - 1) delay), so every window holds at least one
        # collective start, where the wire-lag signal isolates the
        # delayed sender
        collector.configure(enabled=True, interval=2.5, slack=2,
                            dir="", windows=2)
        n, count = 8, 4096
        # TUNE is read at team create: set it around the job's creation
        # only, so nothing outlives the drill
        prev_tune = os.environ.get("UCC_TL_SHM_TUNE")
        os.environ["UCC_TL_SHM_TUNE"] = "allreduce:@ring:2000000000"
        try:
            ctxs, teams = _smoke_job(n)
        finally:
            if prev_tune is None:
                os.environ.pop("UCC_TL_SHM_TUNE", None)
            else:
                os.environ["UCC_TL_SHM_TUNE"] = prev_tune
        try:
            fault.configure(
                f"delay=1.0:{args.smoke_delay},"
                f"delay_rank={args.smoke_rank}", seed=0)
            try:
                srcs = [np.full(count, r + 1.0) for r in range(n)]
                dsts = [np.zeros(count) for _ in range(n)]

                def one_iter():
                    t0 = time.monotonic()
                    reqs = [t.collective_init(CollArgs(
                        coll_type=CollType.ALLREDUCE,
                        src=BufferInfo(srcs[r], count, DataType.FLOAT64),
                        dst=BufferInfo(dsts[r], count, DataType.FLOAT64),
                        op=ReductionOp.SUM)) for r, t in enumerate(teams)]
                    for rq in reqs:
                        rq.post()
                    deadline = t0 + 120
                    while any([rq.test() == Status.IN_PROGRESS
                               for rq in reqs]):
                        for c in ctxs:
                            c.progress()
                        if time.monotonic() > deadline:
                            raise TimeoutError(
                                "feedback smoke: progress timed out")
                    for rq in reqs:
                        if rq.test() != Status.OK:
                            raise RuntimeError(
                                f"feedback smoke allreduce: "
                                f"{rq.test().name}")
                        rq.finalize()
                    return time.monotonic() - t0

                mem, nbytes = MemoryType.HOST, count * 8
                pre_alg = teams[0].score_map.lookup(
                    CollType.ALLREDUCE, mem, nbytes)[0].alg_name
                rec["pre_alg"] = pre_alg
                pre, post = [], []
                for _ in range(args.smoke_iters * 10):
                    pre.append(one_iter())
                    if teams[0].rank_bias is not None and \
                            teams[0].rank_bias.flagged:
                        break
                bias = teams[0].rank_bias
                rec["flagged"] = sorted(bias.flagged) if bias else []
                # the budget counts from the first window that SAW the
                # straggler's traffic: windows that passed during team
                # create or before the fault was armed are not charged
                rec["windows_to_flag"] = None
                col = getattr(ctxs[0], "collector", None)
                watch = col.watch_for(teams[0]) if col else None
                sc = watch.scorer if watch is not None else None
                if sc is not None and sc.first_flag_index is not None \
                        and sc.first_sev_index is not None:
                    rec["windows_to_flag"] = \
                        sc.first_flag_index - sc.first_sev_index + 1
                elif bias is not None and \
                        bias.first_flag_window is not None:
                    rec["windows_to_flag"] = bias.first_flag_window + 1
                post_alg = teams[0].score_map.lookup(
                    CollType.ALLREDUCE, mem, nbytes,
                    bias=bias)[0].alg_name
                rec["post_alg"] = post_alg
                for _ in range(max(4, args.smoke_iters)):
                    post.append(one_iter())
            finally:
                fault.reset()
        finally:
            for t in teams:
                t.destroy()
            for c in ctxs:
                c.destroy()

        def p99(xs):
            xs = sorted(xs)
            return xs[min(len(xs) - 1, int(0.99 * len(xs)))]

        rec["pre_iters"], rec["post_iters"] = len(pre), len(post)
        rec["pre_p99_ms"] = round(p99(pre) * 1e3, 1)
        rec["post_p99_ms"] = round(p99(post) * 1e3, 1)
        rec["ok"] = args.smoke_rank in set(rec["flagged"]) and \
            rec["windows_to_flag"] is not None and \
            rec["windows_to_flag"] <= 2 and \
            pre_alg == "ring" and post_alg != "ring" and \
            rec["post_p99_ms"] < rec["pre_p99_ms"]
    except Exception as e:  # noqa: BLE001 - the probe reports, not raises
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["ok"] = False
    print(json.dumps(rec))
    return 0 if rec.get("ok") else 1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ucc_fr",
        description="flight-recorder merge / diagnose / export")
    ap.add_argument("files", nargs="*",
                    help="flight dump file(s) (JSON lines; "
                         "UCC_FLIGHT_FILE) and/or collector trace-store "
                         "directories (UCC_COLLECT_DIR)")
    ap.add_argument("--tail", type=int, metavar="N",
                    help="with a trace-store directory: merge only the "
                         "N freshest records")
    ap.add_argument("--json", action="store_true",
                    help="print the merged diagnosis as JSON")
    ap.add_argument("--perfetto", metavar="OUT",
                    help="write a Chrome-trace/Perfetto JSON export of "
                         "the merged timeline (one track per rank and "
                         "per hier level)")
    ap.add_argument("--pid", type=int,
                    help="send SIGUSR2 to a live process: every rank in "
                         "it appends its ring to its UCC_FLIGHT_FILE")
    ap.add_argument("--smoke", action="store_true",
                    help="run the self-contained diagnosis drill "
                         "(4-rank job, delay pinned to one rank; exit 0 "
                         "iff the diagnosis names it)")
    ap.add_argument("--feedback-smoke", action="store_true",
                    help="run the closed-loop collector drill (8-rank "
                         "job, ring pinned, delay on one rank; exit 0 "
                         "iff the collector flags it within 2 windows, "
                         "selection moves off the ring, and p99 "
                         "improves)")
    ap.add_argument("--smoke-rank", type=int, default=1,
                    help="ctx rank the smoke pins the delay to")
    ap.add_argument("--smoke-delay", type=float, default=0.05,
                    help="per-send delay (s) injected on the pinned rank")
    ap.add_argument("--smoke-iters", type=int, default=6,
                    help="collectives the smoke runs under delay")
    args = ap.parse_args(argv)

    if args.smoke:
        return _smoke(args)
    if args.feedback_smoke:
        return _feedback_smoke(args)
    if args.pid is not None:
        try:
            os.kill(args.pid, signal.SIGUSR2)
        except OSError as e:
            print(f"ucc_fr: cannot signal pid {args.pid}: {e}",
                  file=sys.stderr)
            return 1
        print(f"ucc_fr: SIGUSR2 sent to {args.pid}; rings will append "
              f"to that process's UCC_FLIGHT_FILE")
        return 0
    if not args.files:
        ap.error("no dump files given (and neither --pid nor --smoke)")

    from ucc_tpu_torch.obs import diagnose
    records: List[Dict[str, Any]] = []
    for path in args.files:
        try:
            if os.path.isdir(path):
                from ucc_tpu_torch.obs import collector
                records.extend(
                    r for r in collector.load_dir_records(
                        path, tail=args.tail)
                    if str(r.get("kind", "")).startswith("flight"))
            else:
                records.extend(load_records(path))
        except OSError as e:
            print(f"ucc_fr: {e}", file=sys.stderr)
            return 1
    if not records:
        print("ucc_fr: no flight records found", file=sys.stderr)
        return 1
    merged = diagnose.merge_records(records)
    diag = merged.get("diagnosis") or diagnose.diagnose(merged)

    if args.perfetto:
        trace = diagnose.to_chrome_trace(merged)
        with open(args.perfetto, "w") as fh:
            json.dump(trace, fh)
        print(f"# wrote {len(trace['traceEvents'])} trace events -> "
              f"{args.perfetto}")
    if args.json:
        print(json.dumps({"reason": merged.get("reason"),
                          "ranks": sorted(merged.get("ranks") or {},
                                          key=int),
                          "absent_ranks": merged.get("absent_ranks"),
                          "diagnosis": diag}))
    else:
        print_report(merged, diag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
