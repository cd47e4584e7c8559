"""ucc_tune — the offline tuning sweep CLI of ucc_tpu_torch (the port of
``ucc_tpu/tools/tune.py``).

Sweeps every candidate of the score map over a message-size grid per
(coll, mem) on a live in-process team, picks the measured winner per grid
point, and compiles the winners into the topology-keyed tuning cache that
``UCC_TUNER=offline|online`` loads at team activation (score/tuner.py).
A later run on a same-shaped machine then starts tuned.

On ``-m cuda`` (the default of the port's tools is the GPU; ``-m host``
sweeps tl/shm's algorithms) every rank's buffers lie on the device that
``UCC_TL_RING_CUDA_DEVICE`` names (``cpu`` runs on the CPU).

Examples::

    # measure and write ~/.cache/ucc_tpu_torch/tune.json for 8 ranks
    python -m ucc_tpu_torch.tools.tune -m cuda -p 8 -c allreduce,allgather \\
        -b 4K -e 16M

    # keep the raw measurements, write the cache somewhere explicit
    python -m ucc_tpu_torch.tools.tune -p 4 -m host -c allreduce \\
        --measurements sweep.jsonl -o /tmp/tune.json

    # compile a cache from a perftest sweep instead of measuring here
    python -m ucc_tpu_torch.tools.perftest -c allreduce --sweep > sweep.jsonl
    python -m ucc_tpu_torch.tools.tune --from sweep.jsonl -p 4

    # one-point probe: sweep, reload through the cache, report tuned
    # against default (host memory, 4 ranks, 64 KiB allreduce)
    python -m ucc_tpu_torch.tools.tune --gate-smoke

Generated programs (``dsl/``)::

    # sweep the generated host candidates too (UCC_GEN=y for the probes)
    python -m ucc_tpu_torch.tools.tune -m host -p 4 --gen 'ring(1,2),rhd(2)'

    # cost-model-guided program search over host programs: winners land in
    # the search cache and the tuning cache with origin "searched"
    python -m ucc_tpu_torch.tools.tune --gen-search -p 8 -c allreduce \
        -b 64K -e 1M

    # the same over device programs (tl/torch_ops' gen_dev_* rows on
    # CUDA memory), refined against the library candidates
    python -m ucc_tpu_torch.tools.tune --gen-search --device -p 8 \
        -c allreduce,bcast -b 64K -e 16M --quant int8
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

from ucc_tpu_torch import Status
from ucc_tpu_torch.api.types import coll_args_msgsize
from ucc_tpu_torch.constants import (CollType, DataType, MemoryType,
                                     ReductionOp, dt_size)
from ucc_tpu_torch.score import cost as _cost
from ucc_tpu_torch.score.tuner import (cand_label, compile_measurements,
                                       measure_candidate, measurement_record,
                                       resolve_cache_path, store_entries,
                                       sweep_candidates, topo_signature)
from ucc_tpu_torch.utils.config import memunits_str, parse_memunits

from . import perftest as _pt
from .perftest import COLLS, InProcJob, buffer_device, lat_stats, make_args


class _Job(InProcJob):
    """perftest's in-process job with lib config overrides (the sweep runs
    with the tuner OFF, so measurements see the static map) and a bounded
    wait for full-dispatch measurement loops."""

    def __init__(self, n: int, overrides: Optional[dict] = None,
                 create_timeout: float = 120.0):
        super().__init__(n, create_timeout=create_timeout,
                         lib_overrides=overrides)

    def wait(self, reqs, timeout: float = 120.0) -> bool:
        deadline = time.monotonic() + timeout
        while any([rq.test() == Status.IN_PROGRESS for rq in reqs]):
            for c in self.contexts:
                c.progress()
            if time.monotonic() > deadline:
                for rq in reqs:
                    rq.task.cancel(Status.ERR_TIMED_OUT)
                return False
        return all(rq.test() == Status.OK for rq in reqs)


def _finalize_all(reqs) -> None:
    for rq in reqs:
        try:
            rq.finalize()
        except Exception:  # noqa: BLE001 - sweep cleanup is best-effort
            pass


def _argses(coll: CollType, n: int, count: int, dt: DataType,
            op: ReductionOp, mem: MemoryType, persistent: bool):
    if coll == CollType.ALLTOALLV:
        _pt._TRAFFIC_MATRIX = _pt.gen_traffic_matrix("uniform", n, count, 7)
    device = buffer_device(mem)
    return [make_args(coll, n, count, dt, op, mem, False, 0, persistent,
                      device, rank=r) for r in range(n)]


def run_sweep(job: _Job, colls: List[str], sizes: List[int], iters: int,
              warmup: int, mem: MemoryType = MemoryType.HOST,
              dt: DataType = DataType.FLOAT32,
              op: ReductionOp = ReductionOp.SUM,
              verbose: bool = True) -> List[dict]:
    """Measure every candidate at every grid point; one measurement record
    per (coll, size, algorithm), the format ``ucc_perftest --sweep``
    prints."""
    records: List[dict] = []
    n = job.n
    esz = dt_size(dt)
    cost_model = _cost.load_model()
    for cname in colls:
        ct = COLLS[cname]
        for size in sizes:
            count = max(1, size // esz)
            argses = _argses(ct, n, count, dt, op, mem, True)
            msgsize = coll_args_msgsize(argses[0], n, 0)
            cands = sweep_candidates(job.teams[0], ct, mem, msgsize)
            for idx in range(len(cands)):
                comp, alg = cand_label(cands[idx])
                lats = measure_candidate(job.teams, job.contexts, argses, ct,
                                         mem, msgsize, idx, iters, warmup)
                if lats is None:
                    if verbose:
                        print(f"# ucc_tune: {cname} {memunits_str(size)} "
                              f"{comp}/{alg}: unsupported/failed, skipped",
                              file=sys.stderr, flush=True)
                    continue
                st = lat_stats(lats)
                records.append(measurement_record(
                    cname, mem, n, (comp, alg), size, count, iters, st,
                    precision=cands[idx].precision, gen=cands[idx].gen,
                    predicted_us=_cost.predict_for_record(
                        cost_model, cands[idx].gen, n, size)))
                if verbose:
                    print(f"# {cname:>12} {memunits_str(size):>8} "
                          f"{comp}/{alg:<20} p50 {st['p50_us']:>10.2f}us",
                          flush=True)
    return records


def _summary(job: _Job, records: List[dict], entries: List[dict]) -> None:
    """Measured winner vs what the static map would have picked."""
    by_point = {}
    for r in records:
        key = (r["coll"], r["mem"], r["size_bytes"])
        cur = by_point.get(key)
        if cur is None or r["p50_us"] < cur["p50_us"]:
            by_point[key] = r
    print("# grid winners (measured) vs static defaults:")
    for (coll, mem, size), win in sorted(by_point.items()):
        ct = COLLS[coll]
        mt = MemoryType.parse(mem)
        count = max(1, size // 4)
        args = _argses(ct, job.n, count, DataType.FLOAT32, ReductionOp.SUM,
                       mt, False)[0]
        msgsize = coll_args_msgsize(args, job.n, 0)
        cands = sweep_candidates(job.teams[0], ct, mt, msgsize)
        static = "/".join(cand_label(cands[0])) if cands else "?"
        mark = "" if static == f"{win['comp']}/{win['alg']}" \
            else "   <- learned"
        print(f"#   {coll:>12} {memunits_str(size):>8}: "
              f"{win['comp']}/{win['alg']} ({win['p50_us']}us) "
              f"vs static {static}{mark}")
    print(f"# compiled {len(entries)} cache entries")


def _measure_default(job: _Job, size: int, iters: int, warmup: int,
                     mem: MemoryType = MemoryType.HOST,
                     coll: CollType = CollType.ALLREDUCE) -> float:
    """p50 (us) of the collective the score map actually selects (full
    dispatch, persistent): the tuned-vs-default probe."""
    n = job.n
    argses = _argses(coll, n, max(1, size // 4), DataType.FLOAT32,
                     ReductionOp.SUM, mem, True)
    reqs = [job.teams[r].collective_init(argses[r]) for r in range(n)]
    lats = []
    for it in range(warmup + iters):
        t0 = time.perf_counter()
        for rq in reqs:
            rq.post()
        if not job.wait(reqs):
            _finalize_all(reqs)
            return float("inf")
        if it >= warmup:
            lats.append(time.perf_counter() - t0)
    _finalize_all(reqs)
    return lat_stats(lats)["p50_us"]


def run_gate_smoke(iters: int = 10) -> int:
    """One-point probe: sweep a 4-rank 64 KiB host allreduce, write a
    throwaway cache, reload it in a second job with UCC_TUNER=offline,
    and print tuned vs default latency and whether the learned selection
    engaged. Always exits 0: the probe only records the delta."""
    size = 64 << 10
    cache = os.path.join(tempfile.mkdtemp(prefix="ucc_tune_gate_"),
                         "tune.json")
    job = _Job(4, {"TUNER": "off"})
    try:
        records = run_sweep(job, ["allreduce"], [size], iters, 3,
                            verbose=False)
        sig = topo_signature(job.teams[0])
        entries = compile_measurements(records)
        default_us = _measure_default(job, size, iters, 3)
    finally:
        job.destroy()
    if not records or not entries:
        print(json.dumps({"metric": "tuner_gate_smoke",
                          "error": "sweep produced no measurements"}))
        return 0
    store_entries(cache, sig, entries, source="offline")
    job2 = _Job(4, {"TUNER": "offline", "TUNER_CACHE": cache})
    try:
        cands = sweep_candidates(job2.teams[0], CollType.ALLREDUCE,
                                 MemoryType.HOST, size)
        learned = bool(cands) and cands[0].origin == "learned"
        winner = "/".join(cand_label(cands[0])) if cands else "?"
        tuned_us = _measure_default(job2, size, iters, 3)
    finally:
        job2.destroy()
    rec = {"metric": "tuner_gate_smoke", "size_bytes": size,
           "default_us": round(default_us, 2),
           "tuned_us": round(tuned_us, 2), "winner": winner,
           "learned_selection": learned,
           "ratio": round(tuned_us / default_us, 4) if default_us else 0.0}
    print(json.dumps(rec), flush=True)
    return 0


def _grid(begin: str, end: str) -> List[int]:
    sizes = []
    size = max(parse_memunits(begin), 4)
    bmax = parse_memunits(end)
    while size <= bmax:
        sizes.append(size)
        size *= 2
    return sizes


def _gen_search(args, colls: List[str], cache_path: str) -> int:
    """``--gen-search [--device]``: run the program search and print each
    grid point's finalists (measured and predicted) and the winners."""
    from ucc_tpu_torch.dsl.search import run_device_search, run_search
    model = None
    if args.from_file:
        with open(args.from_file) as fh:
            records = [json.loads(ln) for ln in fh
                       if ln.strip().startswith("{")]
        model = _cost.fit_records([r for r in records if r.get("gen")],
                                  link="ici" if args.device else "shm")
        if model is not None:
            _cost.save_model(model)
            print(f"# cost model fitted from {args.from_file}: "
                  f"{model.source}")
    search_fn = run_device_search if args.device else run_search
    rep = search_fn(
        # iters is the FIRST successive-halving rung; rungs double, so
        # the finalists' confirmation lands near the user's -n
        args.nprocs, colls, _grid(args.begin, args.end),
        iters=max(3, args.iters // 4), budget=args.search_budget or None,
        quant_mode=os.environ.get("UCC_QUANT", "") if args.quant else "",
        tuner_cache=cache_path, model=model, verbose=True)
    for res in rep.get("results") or []:
        for f in res.get("finalists") or []:
            print(f"#   {res['coll']:>10} "
                  f"{memunits_str(res['size_bytes']):>8} "
                  f"{f['alg']:<24} measured {f['measured_us']}us"
                  + (f" predicted {f['predicted_us']}us"
                     if f.get("predicted_us") is not None else ""))
    label = "device-search" if args.device else "search"
    print(f"# {label} winners: {rep.get('winners')} "
          f"({rep.get('tuner_entries', 0)} tuning-cache entries -> "
          f"{cache_path})")
    if rep.get("error"):
        print(f"# ucc_tune: {label}: {rep['error']}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="ucc_tune",
        description="offline tuning sweep: measure every score-map "
                    "candidate over a msg-size grid and compile the "
                    "winners into the UCC_TUNER tuning cache")
    p.add_argument("-c", "--colls", default="allreduce",
                   help="comma-separated collectives to sweep")
    p.add_argument("-b", "--begin", default="8", help="min size (bytes)")
    p.add_argument("-e", "--end", default="1M", help="max size (bytes)")
    p.add_argument("-n", "--iters", type=int, default=20)
    p.add_argument("-w", "--warmup", type=int, default=3)
    p.add_argument("-p", "--nprocs", type=int, default=4,
                   help="in-process ranks of the live team")
    p.add_argument("-m", "--mem", default="cuda",
                   help="memory type: cuda (default) or host")
    p.add_argument("-o", "--output", default="",
                   help="cache path (default: UCC_TUNER_CACHE or "
                        "~/.cache/ucc_tpu_torch/tune.json)")
    p.add_argument("--measurements", default="",
                   help="also write the raw measurement records (JSONL)")
    p.add_argument("--from", dest="from_file", default="",
                   help="compile the cache from an existing measurement "
                        "file (e.g. `ucc_perftest --sweep` output) "
                        "instead of measuring here")
    p.add_argument("--signature", default="",
                   help="topology signature for --from (default: probe "
                        "a live team of the file's rank count for it)")
    p.add_argument("--dry-run", action="store_true",
                   help="print the compiled entries, write nothing")
    p.add_argument("--gate-smoke", action="store_true",
                   help="one-point sweep + cache round trip on host "
                        "memory; prints a tuned-vs-default JSON record, "
                        "always exits 0")
    p.add_argument("--quant", nargs="?", const="env", default="",
                   choices=["env", "int8", "fp8"],
                   help="include quantized candidates in the sweep: sets "
                        "UCC_QUANT for the probe jobs (bare --quant keeps "
                        "the ambient value, defaulting to int8)")
    p.add_argument("--gen", nargs="?", const="all", default="",
                   metavar="FAMILIES",
                   help="include GENERATED candidates (dsl/) in the sweep: "
                        "sets UCC_GEN=y for the probe jobs; an optional "
                        "value restricts the family grids (UCC_GEN_FAMILIES "
                        "syntax, e.g. 'ring(1,2,4),rhd(2,8)'). Winners "
                        "compile into the tuning cache with their "
                        "family/parameter string")
    p.add_argument("--gen-search", action="store_true",
                   help="cost-model-guided program SEARCH instead of grid "
                        "enumeration: fit the alpha-beta model (from "
                        "--from records when given, else a live probe), "
                        "propose the joint family x radix x chunking x "
                        "depth x quantization (x hierarchy, on multi-node "
                        "topologies) space, prune to the "
                        "UCC_GEN_SEARCH_BUDGET predicted-cheapest per "
                        "grid point, refine by successive halving with "
                        "interleaved measurement, and persist winners into "
                        "the search cache AND the tuning cache with origin "
                        "'searched' and predicted-vs-measured provenance")
    p.add_argument("--search-budget", type=int, default=0,
                   help="override UCC_GEN_SEARCH_BUDGET for --gen-search")
    p.add_argument("--device", action="store_true",
                   help="with --gen-search: search DEVICE programs "
                        "(dsl/lower_device) instead of host ones — the "
                        "device-lowerable space priced over the device "
                        "link class, the predicted-cheapest shortlist "
                        "registered as tl/torch_ops gen_dev_* rows on a "
                        "CUDA-memory team (UCC_GEN_DEVICE_FAMILIES), "
                        "refined by successive halving against the library "
                        "candidates; winning generated-device selections "
                        "land in the tuning cache with mem 'cuda' and "
                        "origin 'searched'")
    args = p.parse_args(argv)

    if args.quant:
        if args.quant in ("int8", "fp8"):
            os.environ["UCC_QUANT"] = args.quant
        elif not os.environ.get("UCC_QUANT"):
            os.environ["UCC_QUANT"] = "int8"
    if args.gen:
        os.environ["UCC_GEN"] = "y"
        if args.gen != "all":
            os.environ["UCC_GEN_FAMILIES"] = args.gen

    if args.gate_smoke:
        return run_gate_smoke(args.iters if args.iters != 20 else 10)

    cache_path = resolve_cache_path(
        args.output or os.environ.get("UCC_TUNER_CACHE", ""))
    mem = _pt.resolve_mem(args.mem)
    colls = [c.strip() for c in args.colls.split(",") if c.strip()]
    for c in colls:
        if c not in COLLS:
            p.error(f"unknown collective '{c}'")

    if args.gen_search:
        return _gen_search(args, colls, cache_path)

    if args.from_file:
        with open(args.from_file) as fh:
            records = [json.loads(ln) for ln in fh
                       if ln.strip().startswith("{")]
        entries = compile_measurements(records)
        if args.signature:
            sig = args.signature
        else:
            # key the cache to the team shape the measurements came from:
            # a record's `ranks` wins over -p
            ranks_in = {int(r["ranks"]) for r in records
                        if isinstance(r, dict) and r.get("ranks")}
            if len(ranks_in) > 1:
                p.error("--from file mixes team sizes "
                        f"({sorted(ranks_in)}); pass --signature")
            nprobe = args.nprocs
            if ranks_in and next(iter(ranks_in)) != nprobe:
                nprobe = next(iter(ranks_in))
                print(f"# ucc_tune: measurement file is {nprobe}-rank; "
                      f"probing a {nprobe}-rank team for the signature")
            job = _Job(nprobe, {"TUNER": "off"})
            try:
                sig = topo_signature(job.teams[0])
            finally:
                job.destroy()
    else:
        job = _Job(args.nprocs, {"TUNER": "off"})
        try:
            sig = topo_signature(job.teams[0])
            records = run_sweep(job, colls, _grid(args.begin, args.end),
                                args.iters, args.warmup, mem)
            entries = compile_measurements(records)
            _summary(job, records, entries)
        finally:
            job.destroy()
        if args.measurements:
            with open(args.measurements, "w") as fh:
                for r in records:
                    fh.write(json.dumps(r) + "\n")
            print(f"# measurements -> {args.measurements}")

    if not entries:
        print("# ucc_tune: no usable measurements; nothing written",
              file=sys.stderr)
        return 1
    if args.dry_run:
        print(json.dumps({"signature": sig, "entries": entries}, indent=1))
        return 0
    store_entries(cache_path, sig, entries, source="offline")
    print(f"# tuning cache -> {cache_path} (signature {sig}, "
          f"{len(entries)} entries)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
