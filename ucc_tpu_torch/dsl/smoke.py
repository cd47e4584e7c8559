"""Warn-only probes of the collective compiler (the port of
``ucc_tpu/dsl/smoke.py``).

``python -m ucc_tpu_torch.dsl.smoke [MODE]`` prints one JSON record and
always exits 0: a caller reads the record (``chip_smoke.py``'s phase 12
raises on an ``error`` key or a failed check). Modes: none (metric
``gen_gate_smoke``), ``--plans`` (``plan_gate_smoke``), ``--plans-digest
[N]``, ``--device`` (``devgen_gate_smoke``), ``--device-bench [N]``
(``devgen_bench``) and ``--search`` (``search_gate_smoke``). The device
modes run on CUDA memory: on a machine without a GPU set
``UCC_TL_RING_CUDA_DEVICE=cpu`` first (the plain versions run then).
The default mode's three claims:

1. **compile+verify**: every built-in family compiles and passes the
   static verifier at the probe team size (a generator regression that
   starts failing verification shows up as a dropped program count);
2. **matrix**: with a generated allreduce PINNED via the TUNE string,
   the full collective matrix completes and allreduce actually ran the
   generated algorithm (task provenance checked);
3. **tuner end-to-end**: a one-point sweep of the generated candidates
   compiles into the persistent tuning cache, a second job reloads it
   with ``UCC_TUNER=offline``, the learned selection engages with
   origin ``learned`` on the generated winner, and a posted allreduce
   runs it — the full sweep -> cache -> reload -> tuned activation
   loop with generated algorithms in every stage.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import List, Optional


def _run_matrix(job, count: int = 4096) -> List[str]:
    """Run the collective matrix; returns the list of colls that
    completed OK. Allreduce is expected to run pinned to the generated
    candidate (caller set the TUNE string). ``job`` is a tune._Job,
    whose ``wait`` cancels timed-out requests (a hung collective must
    not wedge teardown)."""
    from ucc_tpu_torch.constants import CollType, MemoryType, coll_type_str

    matrix = [CollType.ALLREDUCE, CollType.ALLGATHER, CollType.BCAST,
              CollType.REDUCE, CollType.ALLTOALL, CollType.BARRIER]
    ok: List[str] = []
    n = job.n
    for ct in matrix:
        argses = [_args(ct, r, n, count, MemoryType.HOST)
                  for r in range(n)]
        reqs = [job.teams[r].collective_init(argses[r]) for r in range(n)]
        for rq in reqs:
            rq.post()
        if job.wait(reqs, timeout=60):
            ok.append(coll_type_str(ct))
        for rq in reqs:
            try:
                rq.finalize()
            except Exception:  # noqa: BLE001 - smoke cleanup
                pass
    return ok


def _args(coll, r: int, n: int, count: int, mem, persistent: bool = False):
    """Rank *r*'s float32 SUM args (perftest's ``make_args``: ones in,
    zeros out) on the device *mem* names."""
    from ucc_tpu_torch.constants import DataType, ReductionOp
    from ucc_tpu_torch.tools.perftest import buffer_device, make_args
    return make_args(coll, n, count, DataType.FLOAT32, ReductionOp.SUM,
                     mem, False, 0, persistent, buffer_device(mem), rank=r)


def run_smoke(n: int = 4, size: int = 65536, iters: int = 8) -> dict:
    from ucc_tpu_torch.constants import CollType, MemoryType
    from ucc_tpu_torch.dsl.registry import built_in_programs
    from ucc_tpu_torch.score.tuner import (cand_label, compile_measurements,
                                           store_entries, sweep_candidates,
                                           topo_signature)
    from ucc_tpu_torch.tools.tune import _Job, run_sweep

    rec: dict = {"metric": "gen_gate_smoke", "ranks": n,
                 "size_bytes": size}

    # 1. compile + verify every built-in family (incl. the fused
    # quantized program)
    progs = built_in_programs(n, quant_mode="int8")
    rec["programs_verified"] = len(progs)
    rec["programs"] = sorted(p.name for p in progs)
    if not progs:
        rec["error"] = "no generated program survived verification"
        return rec

    # 2. collective matrix with a generated allreduce pinned
    pin = next((p.name for p in progs if p.family == "rhd"),
               progs[0].name)
    os.environ["UCC_TL_SHM_TUNE"] = f"allreduce:@{pin}:inf"
    try:
        job = _Job(n, {"GEN": "y", "TUNER": "off"})
        try:
            rec["matrix"] = _run_matrix(job)
            # provenance check: the pinned allreduce really ran the
            # generated algorithm
            cands = sweep_candidates(job.teams[0], CollType.ALLREDUCE,
                                     MemoryType.HOST, size)
            rec["pinned_alg"] = cands[0].alg_name if cands else "?"
            rec["pinned_engaged"] = bool(cands) and \
                cands[0].alg_name == pin
        finally:
            job.destroy()
    finally:
        os.environ.pop("UCC_TL_SHM_TUNE", None)

    # 3. sweep -> cache -> reload -> tuned activation, generated-only
    cache = os.path.join(tempfile.mkdtemp(prefix="ucc_gen_gate_"),
                         "tune.json")
    job = _Job(n, {"GEN": "y", "TUNER": "off"})
    try:
        records = run_sweep(job, ["allreduce"], [size], iters, 2,
                            verbose=False)
        sig = topo_signature(job.teams[0])
    finally:
        job.destroy()
    gen_records = [r for r in records if r.get("gen")]
    rec["sweep_rows"] = len(records)
    rec["sweep_gen_rows"] = len(gen_records)
    if not gen_records:
        rec["error"] = "sweep produced no generated-candidate rows"
        return rec
    entries = compile_measurements(gen_records)
    store_entries(cache, sig, entries, source="offline")
    rec["cache_entries"] = entries
    job2 = _Job(n, {"GEN": "y", "TUNER": "offline", "TUNER_CACHE": cache})
    try:
        cands = sweep_candidates(job2.teams[0], CollType.ALLREDUCE,
                                 MemoryType.HOST, size)
        top = cands[0] if cands else None
        rec["tuned_winner"] = "/".join(cand_label(top)) if top else "?"
        rec["tuned_origin"] = top.origin if top else "?"
        rec["tuned_gen"] = top.gen if top else ""
        rec["learned_generated_selection"] = bool(
            top is not None and top.origin == "learned" and top.gen)
        # and the tuned activation actually dispatches it
        argses = [_args(CollType.ALLREDUCE, r, n, size // 4,
                        MemoryType.HOST) for r in range(n)]
        reqs = [job2.teams[r].collective_init(argses[r])
                for r in range(n)]
        rec["tuned_dispatch_alg"] = reqs[0].task.alg_name
        for rq in reqs:
            rq.post()
        rec["tuned_dispatch_ok"] = bool(job2.wait(reqs, timeout=60))
        for rq in reqs:
            try:
                rq.finalize()
            except Exception:  # noqa: BLE001 - smoke cleanup
                pass
    finally:
        job2.destroy()
    return rec


def _digest_matrix(n: int) -> dict:
    """One allreduce per case (dtype x op x inplace) under the CALLER's
    env (UCC_GEN_NATIVE etc.); returns {case: result-bytes-digest}, so
    that the native-plan and interpreted executions of the same verified
    program can be held bitwise-identical."""
    import hashlib

    import numpy as np
    import torch

    from ucc_tpu_torch.api.types import BufferInfo, CollArgs
    from ucc_tpu_torch.constants import (CollArgsFlags, CollType, DataType,
                                         ReductionOp)
    from ucc_tpu_torch.tools.tune import _Job

    cases = [("f32_sum", 999, DataType.FLOAT32, torch.float32,
              ReductionOp.SUM, False),
             ("f32_avg_inplace", 1024, DataType.FLOAT32, torch.float32,
              ReductionOp.AVG, True),
             ("f64_max", 517, DataType.FLOAT64, torch.float64,
              ReductionOp.MAX, False),
             ("bf16_sum_assist", 333, DataType.BFLOAT16, torch.bfloat16,
              ReductionOp.SUM, False)]
    out: dict = {}
    plan_engaged = False
    job = _Job(n, {"GEN": "y", "TUNER": "off"})
    try:
        rng = np.random.default_rng(12)
        for name, count, dt, td, op, inplace in cases:
            srcs = [torch.from_numpy(rng.standard_normal(count) * 3).to(td)
                    for _ in range(n)]
            dsts = []
            reqs = []
            for r in range(n):
                if inplace:
                    buf = srcs[r].clone()
                    dsts.append(buf)
                    args = CollArgs(coll_type=CollType.ALLREDUCE,
                                    src=BufferInfo(buf, count, dt),
                                    dst=BufferInfo(buf, count, dt),
                                    op=op, flags=CollArgsFlags.IN_PLACE)
                else:
                    dst = torch.zeros(count, dtype=td)
                    dsts.append(dst)
                    args = CollArgs(coll_type=CollType.ALLREDUCE,
                                    src=BufferInfo(srcs[r].clone(), count,
                                                   dt),
                                    dst=BufferInfo(dst, count, dt), op=op)
                reqs.append(job.teams[r].collective_init(args))
            for rq in reqs:
                rq.post()
            ok = job.wait(reqs, timeout=60)
            for rq in reqs:
                if getattr(getattr(rq, "task", None), "_plan", None) \
                        is not None:
                    plan_engaged = True
                try:
                    rq.finalize()
                except Exception:  # noqa: BLE001 - smoke cleanup
                    pass
            h = hashlib.sha256()
            for d in dsts:
                h.update(d.view(torch.uint8).numpy().tobytes())
            # a timed-out case yields None, which the bitwise gate
            # treats as a mismatch — two timeouts must not compare
            # equal and pass as "identical"
            out[name] = h.hexdigest() if ok else None
    finally:
        job.destroy()
    out["_plan_engaged"] = plan_engaged
    return out


def run_plan_smoke(n: int = 4, count: int = 4096) -> dict:
    """Native-plan probe (metric ``plan_gate_smoke``): build + run ONE
    generated allreduce as a native plan, assert (1) bitwise agreement
    with the interpreted path, (2) data-path ffi crossings per
    collective == 1 (the C debug counter), (3) plans actually engaged.
    Skips cleanly when the native core is unavailable."""
    import numpy as np
    import torch

    from ucc_tpu_torch import native

    rec: dict = {"metric": "plan_gate_smoke", "ranks": n,
                 "size_bytes": count * 4,
                 "native_available": native.available()}
    if not rec["native_available"]:
        rec["skipped"] = "native core unavailable"
        return rec
    from ucc_tpu_torch.api.types import BufferInfo, CollArgs
    from ucc_tpu_torch.constants import CollType, DataType, ReductionOp
    from ucc_tpu_torch.tools.tune import _Job

    saved = {k: os.environ.get(k)
             for k in ("UCC_TL_SHM_TUNE", "UCC_GEN_FAMILIES",
                       "UCC_GEN_NATIVE")}
    os.environ["UCC_TL_SHM_TUNE"] = "allreduce:@gen_ring_c1:inf"
    os.environ["UCC_GEN_FAMILIES"] = "ring(1)"
    digests = {}
    try:
        for mode in ("n", "y"):
            os.environ["UCC_GEN_NATIVE"] = mode
            job = _Job(n, {"GEN": "y", "TUNER": "off"})
            try:
                rng = np.random.default_rng(5)
                srcs = [torch.from_numpy(
                    rng.standard_normal(count).astype(np.float32))
                    for _ in range(n)]
                dsts = [torch.zeros(count) for _ in range(n)]
                reqs = [job.teams[r].collective_init(CollArgs(
                    coll_type=CollType.ALLREDUCE,
                    src=BufferInfo(srcs[r], count, DataType.FLOAT32),
                    dst=BufferInfo(dsts[r], count, DataType.FLOAT32),
                    op=ReductionOp.SUM)) for r in range(n)]
                ffi0 = native.plan_ffi_calls()
                for rq in reqs:
                    rq.post()
                ok = job.wait(reqs, timeout=60)
                ffi1 = native.plan_ffi_calls()
                engaged = all(
                    getattr(getattr(rq, "task", None), "_plan", None)
                    is not None for rq in reqs)
                for rq in reqs:
                    try:
                        rq.finalize()
                    except Exception:  # noqa: BLE001
                        pass
                digests[mode] = [d.numpy().tobytes() for d in dsts] \
                    if ok else None
                if mode == "y":
                    rec["plan_engaged"] = engaged
                    rec["ffi_crossings"] = ffi1 - ffi0
                    rec["ffi_per_collective"] = (ffi1 - ffi0) / n
            finally:
                job.destroy()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    a, b = digests.get("n"), digests.get("y")
    rec["completed"] = bool(a) and bool(b)
    rec["bitwise_identical"] = bool(a) and bool(b) and a == b
    return rec


def _allreduce_digest(job, n: int, count: int, mem, srcs):
    """One allreduce over *srcs* on *job*; returns (sha256 of the
    concatenated result bytes or None on failure, dispatched alg name).
    The alg matters: a TUNE-pinned candidate refusing in THIS job's
    environment would silently fall back to a library candidate, whose
    digest could pass a bitwise gate the lowered program never ran.
    ``mem`` picks HOST (CPU tensors) or CUDA (tensors on the device the
    device TLs' DEVICE config names) buffers."""
    import hashlib

    import torch

    from ucc_tpu_torch.api.types import BufferInfo, CollArgs
    from ucc_tpu_torch.constants import (CollType, DataType, MemoryType,
                                         ReductionOp)
    from ucc_tpu_torch.tools.perftest import buffer_device

    dev = buffer_device(mem)
    argses = []
    for r in range(n):
        mt = MemoryType.CUDA if mem == MemoryType.CUDA else MemoryType.HOST
        src = BufferInfo(torch.as_tensor(srcs[r]).to(dev).clone(), count,
                         DataType.FLOAT32, mem_type=mt)
        dst = BufferInfo(torch.zeros(count, device=dev), count,
                         DataType.FLOAT32, mem_type=mt)
        argses.append(CollArgs(coll_type=CollType.ALLREDUCE, src=src,
                               dst=dst, op=ReductionOp.SUM))
    reqs = [job.teams[r].collective_init(argses[r]) for r in range(n)]
    alg = str(getattr(reqs[0].task, "alg_name", "") or "?")
    for rq in reqs:
        rq.post()
    ok = job.wait(reqs, timeout=60)
    for rq in reqs:
        try:
            rq.finalize()
        except Exception:  # noqa: BLE001 - smoke cleanup
            pass
    if not ok:
        return None, alg
    h = hashlib.sha256()
    for a in argses:
        h.update(a.dst.buffer.cpu().numpy().tobytes())
    return h.hexdigest(), alg


def run_device_smoke(n: int = 4, count: int = 4096) -> dict:
    """Device-program probe (metric ``devgen_gate_smoke``): (1) lower +
    verify every device family (incl. the fused quantized direct
    exchange), (2) run the CUDA-memory collective matrix with a
    generated-device allreduce TUNE-pinned on tl/torch_ops and check it
    actually dispatched, (3) assert the device-lowered program's result
    is BITWISE-identical to the host interpreter running the SAME
    verified IR on the same inputs — the cross-backend contract the
    lowering's receiver-ordered schedule exists to keep. On the GPU step
    (3) runs the generated-collective kernel; a CPU team its plain
    version."""
    import numpy as np

    from ucc_tpu_torch.constants import CollType, MemoryType, coll_type_str
    from ucc_tpu_torch.dsl.lower_device import dev_alg_name, device_programs
    from ucc_tpu_torch.score.tuner import sweep_candidates
    from ucc_tpu_torch.tools.tune import _Job

    rec: dict = {"metric": "devgen_gate_smoke", "ranks": n,
                 "size_bytes": count * 4}

    progs = device_programs(n, quant_mode="int8")
    rec["programs_lowered"] = len(progs)
    rec["programs"] = sorted(p.name for p in progs)
    if not progs:
        rec["error"] = "no device program survived lower+verify"
        return rec
    ring = next((p for p in progs if p.family == "ring"), progs[0])
    pin = dev_alg_name(ring)

    saved = {k: os.environ.get(k)
             for k in ("UCC_TL_TORCH_OPS_TUNE", "UCC_TL_SHM_TUNE")}
    os.environ["UCC_TL_TORCH_OPS_TUNE"] = f"allreduce:@{pin}:inf"
    try:
        job = _Job(n, {"GEN_DEVICE": "y", "TUNER": "off",
                       "QUANT": "int8"})
        try:
            matrix = [CollType.ALLREDUCE, CollType.ALLGATHER,
                      CollType.BCAST, CollType.BARRIER]
            ok = []
            for ct in matrix:
                argses = [_args(ct, r, n, count, MemoryType.CUDA)
                          for r in range(n)]
                reqs = [job.teams[r].collective_init(argses[r])
                        for r in range(n)]
                if ct == CollType.ALLREDUCE:
                    rec["pinned_dispatch_alg"] = \
                        getattr(reqs[0].task, "alg_name", "?")
                for rq in reqs:
                    rq.post()
                if job.wait(reqs, timeout=60):
                    ok.append(coll_type_str(ct))
                for rq in reqs:
                    try:
                        rq.finalize()
                    except Exception:  # noqa: BLE001 - smoke cleanup
                        pass
            rec["matrix"] = ok
            cands = sweep_candidates(job.teams[0], CollType.ALLREDUCE,
                                     MemoryType.CUDA, count * 4)
            rec["pinned_alg"] = cands[0].alg_name if cands else "?"
            rec["pinned_origin"] = cands[0].origin if cands else "?"
            rec["pinned_engaged"] = bool(cands) and \
                cands[0].alg_name == pin and \
                rec.get("pinned_dispatch_alg") == pin
        finally:
            job.destroy()

        # bitwise: device backend vs the host interpreter on the SAME
        # verified IR and inputs
        rng = np.random.default_rng(17)
        srcs = [(rng.standard_normal(count) * 3).astype(np.float32)
                for _ in range(n)]
        dev_job = _Job(n, {"GEN_DEVICE": "y", "TUNER": "off"})
        try:
            d_dev, dev_alg = _allreduce_digest(dev_job, n, count,
                                               MemoryType.CUDA, srcs)
        finally:
            dev_job.destroy()
        os.environ.pop("UCC_TL_TORCH_OPS_TUNE", None)
        os.environ["UCC_TL_SHM_TUNE"] = f"allreduce:@{ring.name}:inf"
        host_job = _Job(n, {"GEN": "y", "TUNER": "off"})
        try:
            d_host, host_alg = _allreduce_digest(host_job, n, count,
                                                 MemoryType.HOST, srcs)
        finally:
            host_job.destroy()
        rec["device_digest"] = d_dev
        rec["device_digest_alg"] = dev_alg
        rec["host_digest"] = d_host
        rec["host_digest_alg"] = host_alg
        # a timed-out side yields None (two Nones must not pass), and
        # BOTH sides must actually have run the verified IR — a
        # fallback to a library candidate would produce the right sum
        # while exercising nothing this gate exists for
        rec["bitwise_identical"] = bool(d_dev) and d_dev == d_host \
            and dev_alg == pin and host_alg == ring.name
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rec


def run_device_bench(n: int = 8, sizes: Optional[List[int]] = None,
                     iters: int = 12) -> dict:
    """Device sweep (``python -m ucc_tpu_torch.dsl.smoke --device-bench``):
    sweep every CUDA-memory allreduce candidate — the library candidates
    AND the generated-device variants — through the tuner sweep engine,
    and report the per-cell winners and the cells a generated-device
    variant won."""
    from ucc_tpu_torch.constants import MemoryType
    from ucc_tpu_torch.tools.tune import _Job, run_sweep

    sizes = sizes or [1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22]
    rec: dict = {"metric": "devgen_bench", "ranks": n,
                 "sizes": sizes, "iters": iters}
    job = _Job(n, {"GEN_DEVICE": "y", "TUNER": "off"})
    try:
        records = run_sweep(job, ["allreduce"], sizes, iters, 3,
                            mem=MemoryType.CUDA, verbose=False)
    finally:
        job.destroy()
    rec["rows"] = len(records)
    cells = {}
    for r in records:
        key = r["size_bytes"]
        cur = cells.get(key)
        if cur is None or r["p50_us"] < cur["p50_us"]:
            cells[key] = r
    rec["cells"] = [{
        "size_bytes": k, "winner": v["alg"], "gen": v.get("gen", ""),
        "p50_us": v["p50_us"],
        "runner_up": sorted(
            ({"alg": r["alg"], "p50_us": r["p50_us"]}
             for r in records if r["size_bytes"] == k
             and r["alg"] != v["alg"]),
            key=lambda d: d["p50_us"])[:3],
    } for k, v in sorted(cells.items())]
    rec["gen_device_cells"] = [c["size_bytes"] for c in rec["cells"]
                               if c["winner"].startswith("gen_dev_")]
    rec["records"] = records
    return rec


def run_search_smoke(n: int = 4, size: int = 65536,
                     budget: int = 6) -> dict:
    """Search probe (metric ``search_gate_smoke``): fit the cost model
    from a ONE-POINT generated sweep, run a budgeted search on a small
    mesh, and assert the whole loop:

    1. the search produces a measured winner with predicted cost
       provenance;
    2. a searched program REGISTERS (origin "searched") on a fresh
       team reading the search cache, and the tuner-cache round trip
       DISPATCHES the winner when a searched program won the point;
    3. predicted-cost ordering is sane: the best-PREDICTED finalist
       lands in the measured top half (the pruning contract — the
       model may not pick the winner, but it must not prune it).
    """
    tmp = tempfile.mkdtemp(prefix="ucc_search_gate_")
    search_cache = os.path.join(tmp, "search.json")
    tuner_cache = os.path.join(tmp, "tune.json")
    # throwaway caches for the probe, saved and restored: the probe must
    # not repoint the process env for good
    saved = {k: os.environ.get(k)
             for k in ("UCC_GEN_COST_CACHE", "UCC_GEN_SEARCH_CACHE")}
    os.environ["UCC_GEN_COST_CACHE"] = os.path.join(tmp, "cost.json")
    os.environ["UCC_GEN_SEARCH_CACHE"] = search_cache
    rec: dict = {"metric": "search_gate_smoke", "ranks": n,
                 "size_bytes": size, "budget": budget}
    try:
        return _run_search_smoke_body(rec, n, size, budget,
                                      search_cache, tuner_cache)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_search_smoke_body(rec: dict, n: int, size: int, budget: int,
                           search_cache: str, tuner_cache: str) -> dict:
    from ucc_tpu_torch.constants import CollType, MemoryType
    from ucc_tpu_torch.dsl.search import run_search
    from ucc_tpu_torch.score.tuner import sweep_candidates
    from ucc_tpu_torch.tools.tune import _Job

    rep = run_search(n, ["allreduce"], [size], iters=4, budget=budget,
                     search_cache=search_cache, tuner_cache=tuner_cache,
                     verbose=False)
    rec["cost_model"] = rep.get("cost_model")
    res = (rep.get("results") or [{}])[0]
    finalists = res.get("finalists") or []
    rec["finalists"] = len(finalists)
    rec["winner"] = res.get("winner")
    rec["winner_predicted_us"] = res.get("winner_predicted_us")
    rec["winner_measured_us"] = res.get("winner_measured_us")
    if not res.get("winner"):
        rec["error"] = "search produced no measured winner"
        return rec
    # prediction-sanity: best-predicted finalist within measured top
    # half (finalists are already sorted by measured latency)
    priced = [(f["predicted_us"], i) for i, f in enumerate(finalists)
              if f.get("predicted_us") is not None]
    if priced:
        best_pred_rank = min(priced)[1]
        rec["best_predicted_rank"] = best_pred_rank
        rec["prediction_sane"] = \
            best_pred_rank <= max(1, len(finalists) // 2)
    searched_won = bool(rep.get("winners"))
    rec["searched_won"] = searched_won
    # registration + dispatch round trip on a FRESH job
    job = _Job(n, {"GEN": "y", "GEN_SEARCH": "y", "TUNER": "offline",
                   "TUNER_CACHE": tuner_cache})
    try:
        cands = sweep_candidates(job.teams[0], CollType.ALLREDUCE,
                                 MemoryType.HOST, size)
        rec["searched_registered"] = any(
            c.origin == "searched" for c in cands)
        argses = [_args(CollType.ALLREDUCE, r, n, size // 4,
                        MemoryType.HOST) for r in range(n)]
        reqs = [job.teams[r].collective_init(argses[r])
                for r in range(n)]
        rec["dispatch_alg"] = reqs[0].task.alg_name
        for rq in reqs:
            rq.post()
        rec["dispatch_ok"] = bool(job.wait(reqs, timeout=60))
        for rq in reqs:
            try:
                rq.finalize()
            except Exception:  # noqa: BLE001 - smoke cleanup
                pass
        if searched_won:
            rec["winner_dispatched"] = \
                rec["dispatch_alg"] == res.get("winner")
    finally:
        job.destroy()
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--search":
        try:
            rec = run_search_smoke()
        except Exception as e:  # noqa: BLE001 - the caller wants a record
            rec = {"metric": "search_gate_smoke",
                   "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(rec), flush=True)
        return 0
    if argv and argv[0] == "--plans-digest":
        n = int(argv[1]) if len(argv) > 1 else 4
        try:
            out = _digest_matrix(n)
        except Exception as e:  # noqa: BLE001 - caller reads the record
            out = {"error": f"{type(e).__name__}: {e}"}
        print(json.dumps(out), flush=True)
        return 0
    if argv and argv[0] == "--device":
        try:
            rec = run_device_smoke()
        except Exception as e:  # noqa: BLE001 - the caller wants a record
            rec = {"metric": "devgen_gate_smoke",
                   "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(rec), flush=True)
        return 0
    if argv and argv[0] == "--device-bench":
        n = int(argv[1]) if len(argv) > 1 else 8
        try:
            rec = run_device_bench(n)
        except Exception as e:  # noqa: BLE001 - caller reads the record
            rec = {"metric": "devgen_bench",
                   "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(rec), flush=True)
        return 0
    if argv and argv[0] == "--plans":
        try:
            rec = run_plan_smoke()
        except Exception as e:  # noqa: BLE001 - the caller wants a record
            rec = {"metric": "plan_gate_smoke",
                   "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(rec), flush=True)
        return 0
    try:
        rec = run_smoke()
    except Exception as e:  # noqa: BLE001 - the caller wants a record
        rec = {"metric": "gen_gate_smoke", "error": f"{type(e).__name__}: {e}"}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
