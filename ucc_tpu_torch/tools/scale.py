"""ucc_scale: a pod-scale simulation of the host stack.

Builds a simulated N-rank (512–2048) host-TL mesh inside one process:
thread endpoints bootstrapped through the TREE-structured OOB exchange
(``ThreadTreeOobWorld``: the round structure and metrics of the TCP
``TcpTreeOob``), with a synthetic multi-node, multi-pod layout from the
``UCC_TOPO_FAKE_*`` knobs, so that cl/hier resolves the whole rank ->
node -> pod tree. The simulation creates the team (the service-team
paths, agreement, id allocation and tuner sync, at sizes the flat
bootstrap cannot reach), runs the collective matrix, and measures the
N-level hier allreduce against the best flat candidate on a size grid.
It is host work alone: no device TL is loaded.

CLI (one JSON record on stdout)::

    python -m ucc_tpu_torch.tools.scale -n 512 --ppn 8 --npp 8 --json
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np


def _set_env(n: int, ppn: str, npp: int) -> Dict[str, Optional[str]]:
    """Arm the simulated-topology knobs; returns the previous values so
    tests can run several layouts in one process."""
    old = {}
    want = {
        # host-TL mesh with a two-speed fabric: the in-process shm
        # transport stands in for the node's fabric, loopback sockets
        # for the network. cl/hier keeps node units on the first and
        # leader units on the second (the real pod shape: process-shared
        # memory cannot span hosts), so the hier-vs-flat cells measure
        # the traffic-locality effect the hierarchy exists for. No
        # device TL: 512 contexts must not claim the card.
        "UCC_TLS": os.environ.get("UCC_TLS") or "shm,socket,self",
        "UCC_CL_HIER_NODE_TLS":
            os.environ.get("UCC_CL_HIER_NODE_TLS") or "shm,self",
        "UCC_CL_HIER_NODE_LEADERS_TLS":
            os.environ.get("UCC_CL_HIER_NODE_LEADERS_TLS") or "socket,self",
        "UCC_TOPO_FAKE_PPN": ppn,
        "UCC_TOPO_FAKE_NODES_PER_POD": str(npp) if npp else "",
    }
    for k, v in want.items():
        old[k] = os.environ.get(k)
        if v:
            os.environ[k] = v
        else:
            os.environ.pop(k, None)
    return old


def _restore_env(old: Dict[str, Optional[str]]) -> None:
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _oob_stats(endpoints) -> dict:
    """Aggregate bootstrap-tree metrics across a world's endpoints: the
    O(log n) evidence of the tree bootstrap."""
    levels = max(e.stats["levels"] for e in endpoints)
    fanin = max(e.stats["max_fanin"] for e in endpoints)
    rounds_per_ag = 0.0
    for e in endpoints:
        if e.stats["allgathers"]:
            rounds_per_ag = max(rounds_per_ag,
                                e.stats["rounds"] / e.stats["allgathers"])
    return {"levels": levels, "max_fanin": fanin,
            "rounds_per_allgather_max": round(rounds_per_ag, 2),
            "allgathers_max": max(e.stats["allgathers"]
                                  for e in endpoints)}


def _phase(msg: str) -> None:
    """Progress marker on stderr (the JSON record owns stdout): a killed
    or wedged 512-rank run must show WHICH phase died."""
    print(f"[scale] {msg}", file=sys.stderr, flush=True)


class ScaleSim:
    """One simulated mesh: contexts + world team over tree OOB."""

    def __init__(self, n: int, ppn: str = "8", npp: int = 8,
                 radix: Optional[int] = None, timeout: float = 300.0):
        self._env = _set_env(n, ppn, npp)
        self.teams: List = []
        self.contexts: List = []
        # a constructor failure (context/team timeout) must not leak the
        # fake-topology env into the process — destroy() restores it and
        # tears down whatever was created, so "several layouts in one
        # process" stays true even when one layout fails
        try:
            self._build(n, ppn, npp, radix, timeout)
        except BaseException:
            self.destroy()
            raise

    def _build(self, n: int, ppn: str, npp: int,
               radix: Optional[int], timeout: float) -> None:
        import ucc_tpu_torch
        from ucc_tpu_torch import ContextParams, Status, TeamParams
        from ucc_tpu_torch.core.oob import (ThreadTreeOobWorld,
                                            parse_node_sizes)

        self.n = n
        node_sizes = parse_node_sizes(ppn)
        _phase(f"creating {n} contexts (tree OOB)")
        t0 = time.monotonic()
        self.ctx_world = ThreadTreeOobWorld(n, ppn=node_sizes, radix=radix)
        self.ctx_eps = [self.ctx_world.endpoint(r) for r in range(n)]
        self.libs = [ucc_tpu_torch.init() for _ in range(n)]
        self.contexts: List = [None] * n
        errs: List[Exception] = []

        def mk(r):
            try:
                self.contexts[r] = ucc_tpu_torch.Context(
                    self.libs[r], ContextParams(oob=self.ctx_eps[r]))
            except Exception as e:  # noqa: BLE001 - surfaced below
                errs.append(e)

        ths = [threading.Thread(target=mk, args=(r,), daemon=True)
               for r in range(n)]
        for t in ths:
            t.start()
        # ONE shared deadline across all joins: per-thread timeouts
        # would let a wedged bootstrap block n*timeout before surfacing
        deadline = time.monotonic() + timeout
        for t in ths:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        if errs:
            raise errs[0]
        if any(c is None for c in self.contexts):
            raise TimeoutError("scale sim: context create timed out")
        self.ctx_create_s = time.monotonic() - t0
        _phase(f"contexts up in {self.ctx_create_s:.1f}s; creating team")

        t1 = time.monotonic()
        self.team_world = ThreadTreeOobWorld(n, ppn=node_sizes, radix=radix)
        self.team_eps = [self.team_world.endpoint(r) for r in range(n)]
        self.teams = [c.create_team_post(TeamParams(oob=self.team_eps[i]))
                      for i, c in enumerate(self.contexts)]
        deadline = time.monotonic() + timeout
        while True:
            sts = [t.create_test() for t in self.teams]
            if all(s == Status.OK for s in sts):
                break
            bad = [s for s in sts if s.is_error]
            if bad:
                raise RuntimeError(f"scale sim: team create failed: {bad}")
            if time.monotonic() > deadline:
                raise TimeoutError("scale sim: team create timed out")
            for c in self.contexts:
                c.progress()
        self.team_create_s = time.monotonic() - t1
        _phase(f"team active in {self.team_create_s:.1f}s")

    # ------------------------------------------------------------------
    def hier_team(self):
        for cl in self.teams[0].cl_teams:
            if cl.name == "hier":
                return cl
        return None

    def run_coll(self, make_args, timeout: float = 120.0) -> None:
        from ucc_tpu_torch import Status
        reqs = [t.collective_init(make_args(i))
                for i, t in enumerate(self.teams)]
        for rq in reqs:
            rq.post()
        deadline = time.monotonic() + timeout
        while any(rq.test() == Status.IN_PROGRESS for rq in reqs):
            for c in self.contexts:
                c.progress()
            if time.monotonic() > deadline:
                raise TimeoutError("scale sim: collective timed out")
        for rq in reqs:
            st = rq.test()
            if st != Status.OK:
                raise RuntimeError(f"scale sim: collective failed: {st}")
            rq.finalize()

    def matrix(self) -> List[str]:
        """Small-payload collective matrix across all ranks; returns the
        list of cells run (raises on the first failure)."""
        from ucc_tpu_torch import BufferInfo, CollArgs
        from ucc_tpu_torch.constants import (CollArgsFlags, CollType,
                                             DataType, ReductionOp)
        n = self.n
        ran = []
        cnt = 64

        srcs = [np.full(cnt, i + 1.0, np.float32) for i in range(n)]
        dsts = [np.zeros(cnt, np.float32) for _ in range(n)]
        self.run_coll(lambda i: CollArgs(
            coll_type=CollType.ALLREDUCE,
            src=BufferInfo(srcs[i], cnt, DataType.FLOAT32),
            dst=BufferInfo(dsts[i], cnt, DataType.FLOAT32),
            op=ReductionOp.SUM))
        exp = n * (n + 1) / 2.0
        for r in range(n):
            np.testing.assert_allclose(dsts[r], exp, rtol=1e-4)
        ran.append("allreduce")

        root = n // 3
        bufs = [(np.arange(cnt, dtype=np.float32) if i == root
                 else np.zeros(cnt, np.float32)) for i in range(n)]
        self.run_coll(lambda i: CollArgs(
            coll_type=CollType.BCAST, root=root,
            src=BufferInfo(bufs[i], cnt, DataType.FLOAT32)))
        for r in range(n):
            np.testing.assert_allclose(bufs[r],
                                       np.arange(cnt, dtype=np.float32))
        ran.append("bcast")

        rsrcs = [np.full(cnt, float(i), np.float32) for i in range(n)]
        rdst = np.zeros(cnt, np.float32)
        self.run_coll(lambda i: CollArgs(
            coll_type=CollType.REDUCE, root=root, op=ReductionOp.SUM,
            src=BufferInfo(rsrcs[i], cnt, DataType.FLOAT32),
            dst=BufferInfo(rdst, cnt, DataType.FLOAT32)
            if i == root else None))
        np.testing.assert_allclose(rdst, n * (n - 1) / 2.0, rtol=1e-4)
        ran.append("reduce")

        self.run_coll(lambda i: CollArgs(coll_type=CollType.BARRIER))
        ran.append("barrier")

        blk = 2
        asrcs = [np.full(blk, i + 1.0, np.float32) for i in range(n)]
        adsts = [np.zeros(blk * n, np.float32) for _ in range(n)]
        self.run_coll(lambda i: CollArgs(
            coll_type=CollType.ALLGATHER,
            src=BufferInfo(asrcs[i], blk, DataType.FLOAT32),
            dst=BufferInfo(adsts[i], blk * n, DataType.FLOAT32)))
        aexp = np.repeat(np.arange(1, n + 1, dtype=np.float32), blk)
        for r in range(n):
            np.testing.assert_allclose(adsts[r], aexp)
        ran.append("allgather")

        # in-place AVG keeps the nrab scale/in-place paths honest at size
        bufs = [np.full(cnt, i + 1.0, np.float32) for i in range(n)]
        self.run_coll(lambda i: CollArgs(
            coll_type=CollType.ALLREDUCE, op=ReductionOp.AVG,
            src=None, dst=BufferInfo(bufs[i], cnt, DataType.FLOAT32),
            flags=CollArgsFlags.IN_PLACE))
        for r in range(n):
            np.testing.assert_allclose(bufs[r], (n + 1) / 2.0, rtol=1e-4)
        ran.append("allreduce_avg_inplace")
        return ran

    # ------------------------------------------------------------------
    def measure_cells(self, sizes_bytes: List[int], iters: int = 8,
                      warmup: int = 2) -> List[dict]:
        """hier-vs-flat allreduce cells: pin the N-level tree candidate
        and the best flat (cl/basic TL) candidate at each size through
        the tuner's sweep engine; one record per (size) cell."""
        from ucc_tpu_torch import BufferInfo, CollArgs
        from ucc_tpu_torch.api.types import coll_args_msgsize
        from ucc_tpu_torch.constants import (CollArgsFlags, CollType,
                                             DataType, MemoryType,
                                             ReductionOp)
        from ucc_tpu_torch.score.score_map import comp_name
        from ucc_tpu_torch.score.tuner import (cand_label,
                                               measure_candidate,
                                               sweep_candidates)

        cells = []
        for size in sizes_bytes:
            count = max(1, size // 4)
            # perftest's buffers on host memory: src ones, dst zeros,
            # persistent (as the JAX package's cells make them)
            argses = [CollArgs(
                coll_type=CollType.ALLREDUCE, op=ReductionOp.SUM,
                src=BufferInfo(np.ones(count, np.float32), count,
                               DataType.FLOAT32, mem_type=MemoryType.HOST),
                dst=BufferInfo(np.zeros(count, np.float32), count,
                               DataType.FLOAT32, mem_type=MemoryType.HOST),
                flags=CollArgsFlags.PERSISTENT)
                for _ in range(self.n)]
            msgsize = coll_args_msgsize(argses[0], self.n, 0)
            cands = sweep_candidates(self.teams[0], CollType.ALLREDUCE,
                                     MemoryType.HOST, msgsize)
            hier_idx = next((i for i, c in enumerate(cands)
                             if c.alg_name == "nrab"), None)
            # the flat DEFAULT on this simulated topology: on a real pod
            # shm cannot span hosts, so a flat multi-node algorithm runs
            # on the network transport, its best socket candidate.
            # flat_ici (the best in-process candidate whatever its
            # transport) is recorded too, as the floor no real pod has.
            flat_idx = next((i for i, c in enumerate(cands)
                             if comp_name(c) == "socket"), None)
            ici_idx = next((i for i, c in enumerate(cands)
                            if comp_name(c) not in ("hier", "socket")),
                           None)
            if hier_idx is None or flat_idx is None:
                cells.append({"size_bytes": size,
                              "error": "candidates missing"})
                continue
            rec = {"size_bytes": size, "coll": "allreduce"}
            pins = [("hier", hier_idx), ("flat", flat_idx)]
            if ici_idx is not None:
                pins.append(("flat_ici", ici_idx))
            for tag, idx in pins:
                lats = measure_candidate(self.teams, self.contexts, argses,
                                         CollType.ALLREDUCE,
                                         MemoryType.HOST, msgsize, idx,
                                         iters, warmup)
                comp, alg = cand_label(cands[idx])
                rec[f"{tag}_alg"] = f"{comp}/{alg}"
                rec[f"{tag}_p50_us"] = round(float(np.percentile(
                    np.asarray(lats) * 1e6, 50)), 1) if lats else None
            if rec.get("hier_p50_us") and rec.get("flat_p50_us"):
                rec["hier_speedup"] = round(
                    rec["flat_p50_us"] / rec["hier_p50_us"], 3)
            cells.append(rec)
        return cells

    def oob_report(self) -> dict:
        rep = {"ctx": _oob_stats(self.ctx_eps),
               "team": _oob_stats(self.team_eps),
               "flat_equiv_fanin": self.n}
        # the logarithmic claim, precomputed: rounds per allgather are
        # bounded by 2*levels and fan-in by max(ppn, radix)
        rep["log2_n"] = round(math.log2(max(2, self.n)), 2)
        return rep

    def destroy(self) -> None:
        for t in self.teams:
            try:
                t.destroy()
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
        for c in self.contexts:
            try:
                c.destroy()
            except Exception:  # noqa: BLE001
                pass
        _restore_env(self._env)


def run_sim(n: int, ppn: str = "8", npp: int = 8,
            radix: Optional[int] = None, cells: bool = True,
            cell_sizes: Optional[List[int]] = None, cell_iters: int = 8,
            cells_n: Optional[int] = None,
            timeout: float = 300.0) -> dict:
    """Full scale-proof pass; returns the JSON-able record.

    The bootstrap/activation/matrix proof runs at the full *n*; the
    hier-vs-flat measurement cells run on a SECOND mesh of at most
    *cells_n* ranks (default 128, same node/pod shape), created after
    the big one is torn down. Rationale: the flat candidate the cells
    pin is the socket TL, whose per-connection reader threads are fine
    across real hosts but explode inside ONE simulating process at
    512 ranks (~n·log n connections → thousands of threads → the sim
    gets OOM-killed measuring the strawman, not the subject). 128
    in-process ranks keep the flat measurement honest and survivable;
    the 512-rank claims (tree bootstrap, activation, matrix, service
    teams) never depended on the flat candidate at all."""
    t_all = time.monotonic()
    cn = min(n, cells_n or 128) if cells else 0
    sim = ScaleSim(n, ppn=ppn, npp=npp, radix=radix, timeout=timeout)
    try:
        hier = sim.hier_team()
        rec = {
            "metric": "scale_sim",
            "ranks": n,
            "layout": {"ppn": ppn, "nodes_per_pod": npp},
            "ctx_create_s": round(sim.ctx_create_s, 2),
            "team_create_s": round(sim.team_create_s, 2),
            "oob": sim.oob_report(),
            "hier_levels": hier.n_levels if hier is not None else 0,
        }
        _phase("running collective matrix")
        rec["matrix"] = sim.matrix()
        _phase(f"matrix ok: {rec['matrix']}")
        if cells and cn == n:
            _phase(f"measuring hier-vs-flat cells ({cn} ranks)")
            rec["cells_ranks"] = cn
            try:
                rec["cells"] = sim.measure_cells(
                    cell_sizes or [16 << 10, 256 << 10], iters=cell_iters,
                    warmup=max(1, cell_iters // 4))
            except Exception as e:  # noqa: BLE001 - cells are optional
                # the bootstrap/matrix proof above already succeeded; a
                # cells failure must degrade the record, not discard it
                rec["cells_error"] = f"{type(e).__name__}: {e}"
                _phase(f"cells failed (record kept): {rec['cells_error']}")
    finally:
        sim.destroy()
    if cells and cn != n:
        _phase(f"measuring hier-vs-flat cells on a fresh {cn}-rank mesh")
        rec["cells_ranks"] = cn
        csim = None
        try:
            csim = ScaleSim(cn, ppn=ppn, npp=npp, radix=radix,
                            timeout=timeout)
            rec["cells"] = csim.measure_cells(
                cell_sizes or [16 << 10, 256 << 10], iters=cell_iters,
                warmup=max(1, cell_iters // 4))
        except Exception as e:  # noqa: BLE001 - cells are optional
            rec["cells_error"] = f"{type(e).__name__}: {e}"
            _phase(f"cells failed (record kept): {rec['cells_error']}")
        finally:
            if csim is not None:
                csim.destroy()
    rec["wall_s"] = round(time.monotonic() - t_all, 2)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ucc_scale")
    p.add_argument("-n", type=int, default=512, help="simulated ranks")
    p.add_argument("--ppn", default="8",
                   help="ranks per virtual node (int or cyclic comma "
                        "list, e.g. 2,1,3)")
    p.add_argument("--npp", type=int, default=8,
                   help="virtual nodes per DCN pod (0 = no pods)")
    p.add_argument("--radix", type=int, default=None,
                   help="bootstrap-tree radix override")
    p.add_argument("--no-cells", action="store_true",
                   help="skip the hier-vs-flat measurement cells")
    p.add_argument("--cell-sizes", default="",
                   help="comma list of cell sizes in bytes "
                        "(default 16K,256K)")
    p.add_argument("--cell-iters", type=int, default=8)
    p.add_argument("--cells-n", type=int, default=None,
                   help="rank count for the hier-vs-flat cells (default "
                        "min(n, 128): the flat socket candidate's "
                        "per-connection threads don't survive 512 ranks "
                        "in one process)")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--json", action="store_true",
                   help="machine-readable single-line record")
    args = p.parse_args(argv)
    sizes = [int(s) for s in args.cell_sizes.split(",") if s.strip()] \
        or None
    try:
        rec = run_sim(args.n, ppn=args.ppn, npp=args.npp, radix=args.radix,
                      cells=not args.no_cells, cell_sizes=sizes,
                      cell_iters=args.cell_iters, cells_n=args.cells_n,
                      timeout=args.timeout)
    except Exception as e:  # noqa: BLE001 - one parseable failure record
        print(json.dumps({"metric": "scale_sim", "ranks": args.n,
                          "error": f"{type(e).__name__}: {e}"}))
        return 1
    if args.json:
        print(json.dumps(rec))
    else:
        print(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
