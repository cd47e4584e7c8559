"""The port's cost-model-guided program search (ucc_tpu_torch/dsl/search.py)
and the compiler's probes (dsl/smoke.py, ``ucc_tune --gen-search``) held
against the JAX package's dsl/search.py and tests/test_search.py.

``propose`` gives the reference's candidates — names, ``param_str``s,
families, parameters, grid marks and order — for every collective at team
sizes 4 and 8, with and without topology paths and a wire precision, for
the host and the device target; ``shortlist`` the same order and prices
(rtol 1e-12). The search cache stores, replaces and reloads as the
reference's, carries the port's name in its version tag, and neither
package reads the other's file. Searched programs register with origin
``searched`` and dispatch; stale entries are skipped and stale tuner
entries dropped. The hierarchical programs on a fake two-pod topology
register as the reference's and run bitwise as its (tolerance: none;
numpy within 1e-5 of the peak, the int8 budget for the quantized DCN
edges). The budgeted host search and the device search run end to end on
CPU teams and persist their winners; a fresh team under
``UCC_TUNER=offline`` dispatches a searched device winner, bitwise the
host interpreter's result.
"""
import json
import os
import zlib

import numpy as np
import pytest

import ucc_tpu
import ucc_tpu_torch as ut
from ucc_tpu.constants import CollType as JCollType
from ucc_tpu.dsl import families as jfam
from ucc_tpu.dsl import search as jsearch
from ucc_tpu.score import cost as jcost
from ucc_tpu_torch.constants import CollType, MemoryType
from ucc_tpu_torch.dsl import families as fam
from ucc_tpu_torch.dsl import registry as reg
from ucc_tpu_torch.dsl import search as search
from ucc_tpu_torch.dsl.ir import OpKind
from ucc_tpu_torch.dsl.verify import verify
from ucc_tpu_torch.score import cost
from ucc_tpu_torch.score.tuner import apply_entries, sweep_candidates

from torch_gen_jobs import GenJob, case_inputs, floats, forced, same_bits
from torch_host_jobs import env


def _paths(node_of, pod_of=None):
    out = []
    for nd in node_of:
        hh = zlib.crc32(f"n{nd}".encode())
        if pod_of is None:
            out.append((hh,))
        else:
            out.append((zlib.crc32(f"p{pod_of[nd]}".encode()), hh))
    return out


#: asymmetric 3-level pod layout: nodes of 2, 1, 3 and 2 ranks over 2 pods
ASYM_PATHS = _paths([0, 0, 1, 2, 2, 2, 3, 3], [0, 0, 1, 1])
PATHS = {4: _paths([0, 0, 1, 1]), 8: ASYM_PATHS}
COLLS = ("allreduce", "allgather", "reduce_scatter", "bcast")


def cand_view(c):
    return (c.name, c.prog.param_str, c.family, sorted(c.params.items()),
            c.wire, c.hier, c.from_grid)


# ---------------------------------------------------------------------------
# the candidate space
# ---------------------------------------------------------------------------

class TestPropose:
    @pytest.mark.parametrize("quant", ["", "int8"])
    @pytest.mark.parametrize("topo", [False, True])
    @pytest.mark.parametrize("n", [4, 8])
    @pytest.mark.parametrize("coll", COLLS)
    def test_host_space_matches_the_reference(self, coll, n, topo, quant):
        paths = PATHS[n] if topo else None
        ct, jct = CollType[coll.upper()], JCollType[coll.upper()]
        grid = search.grid_program_names(ct, n, paths, quant)
        assert grid == jsearch.grid_program_names(jct, n, paths, quant)
        got = search.propose(ct, n, paths, quant, grid_names=grid)
        want = jsearch.propose(jct, n, paths, quant, grid_names=grid)
        assert [cand_view(c) for c in got] == [cand_view(c) for c in want]
        assert got

    @pytest.mark.parametrize("quant", ["", "int8", "fp8"])
    @pytest.mark.parametrize("n", [4, 8])
    @pytest.mark.parametrize("coll", COLLS)
    def test_device_space_matches_the_reference(self, coll, n, quant):
        ct, jct = CollType[coll.upper()], JCollType[coll.upper()]
        got = search.propose(ct, n, quant_mode=quant, target="device")
        want = jsearch.propose(jct, n, quant_mode=quant, target="device")
        assert [cand_view(c) for c in got] == [cand_view(c) for c in want]
        assert bool(got) == (coll in ("allreduce", "bcast"))
        assert search._device_family_spec(got, n) == \
            jsearch._device_family_spec(want, n)

    def test_space_exceeds_the_fixed_grids(self):
        grid = search.grid_program_names(CollType.ALLREDUCE, 8)
        space = search.propose(CollType.ALLREDUCE, 8, grid_names=grid)
        beyond = {c.name for c in space if not c.from_grid}
        assert {"gen_ring_c3", "gen_sra_pipe_d3"} <= beyond
        assert any(c.family == "sra_pipe" and c.params.get("radix")
                   for c in space)
        assert grid <= {c.name for c in space}

    @pytest.mark.parametrize("n", [2, 3, 4, 8, 9, 16, 27])
    def test_helpers_match(self, n):
        assert search._radix_grid(n) == jsearch._radix_grid(n)
        for coll in COLLS:
            for size in (4, 4096, 1 << 20):
                assert search._coll_count(CollType[coll.upper()], size, n) \
                    == jsearch._coll_count(JCollType[coll.upper()], size, n)

    @pytest.mark.parametrize("target", ["host", "device"])
    @pytest.mark.parametrize("n", [4, 8])
    def test_shortlists_match_the_reference(self, n, target):
        paths = PATHS[n] if target == "host" else None
        link = cost.link_of_paths(paths) if target == "host" \
            else cost.link_of_device()
        jlink = jcost.link_of_paths(paths) if target == "host" \
            else jcost.link_of_device()
        for coll in ("allreduce", "bcast"):
            got = search.propose(CollType[coll.upper()], n, paths, "int8",
                                 target=target)
            want = jsearch.propose(JCollType[coll.upper()], n, paths,
                                   "int8", target=target)
            for size in (256, 65536, 16 << 20):
                g = search.shortlist(got, cost.CostModel(), size, 5, link)
                w = jsearch.shortlist(want, jcost.CostModel(), size, 5,
                                      jlink)
                assert [c.name for c in g] == [c.name for c in w]
                np.testing.assert_allclose(
                    [c.predicted_us for c in g],
                    [c.predicted_us for c in w], rtol=1e-12)

    def test_entries_match_the_reference(self):
        got = search.propose(CollType.ALLREDUCE, 8, ASYM_PATHS, "int8")
        want = jsearch.propose(JCollType.ALLREDUCE, 8, ASYM_PATHS, "int8")
        digest = reg.paths_digest(ASYM_PATHS)
        for g, w in zip(got, want):
            g.predicted_us = w.predicted_us = 12.345
            ge = g.entry(CollType.ALLREDUCE, 8, digest if g.hier else "")
            we = w.entry(JCollType.ALLREDUCE, 8, digest if w.hier else "")
            ge.pop("created")
            we.pop("created")
            assert ge == we


# ---------------------------------------------------------------------------
# the search cache and registration
# ---------------------------------------------------------------------------

E1 = {"coll": "allreduce", "n": 4, "family": "ring", "params": {"chunks": 3},
      "wire": "", "name": "gen_ring_c3", "gen": "ring(chunks=3)",
      "paths_digest": ""}


class TestSearchCache:
    def test_store_replace_scope_and_load(self, tmp_path):
        p = str(tmp_path / "search.json")
        e2 = dict(E1, name="gen_ring_c6", params={"chunks": 6},
                  gen="ring(chunks=6)")
        search.store_search_entries(p, [E1, e2])
        assert len(search.load_search_cache(p)["entries"]) == 2
        search.store_search_entries(p, [E1],
                                    replace_scopes=[("allreduce", 4, "")])
        assert [e["name"] for e in search.load_search_cache(p)["entries"]] \
            == ["gen_ring_c3"]
        search.store_search_entries(p, [dict(E1, n=8)])
        search.store_search_entries(p, [],
                                    replace_scopes=[("allreduce", 4, "")])
        assert [e["n"] for e in search.load_search_cache(p)["entries"]] \
            == [8]

    def test_neither_package_reads_the_others_file(self, tmp_path):
        jp, pp = str(tmp_path / "j.json"), str(tmp_path / "p.json")
        jsearch.store_search_entries(jp, [E1])
        search.store_search_entries(pp, [E1])
        assert search.load_search_cache(jp)["entries"] == []
        assert jsearch.load_search_cache(pp)["entries"] == []
        assert json.load(open(pp))["version"] == search.SEARCH_TAG == \
            "ucc_tpu_torch/1"
        assert search.load_search_cache(pp)["entries"][0]["name"] == \
            "gen_ring_c3"
        with env(UCC_GEN_SEARCH_CACHE=jp):
            assert search.searched_programs(None, 4) == []
        with env(UCC_GEN_SEARCH_CACHE=None):
            assert search.resolve_search_cache_path() == \
                os.path.expanduser("~/.cache/ucc_tpu_torch/search.json")
            assert search.resolve_search_cache_path() != \
                jsearch.resolve_search_cache_path()

    def test_searched_programs_rebuild_and_skip_stale(self, tmp_path):
        p = str(tmp_path / "search.json")
        search.store_search_entries(p, [
            E1,
            dict(E1, family="warp", params={}, name="gen_warp",
                 gen="warp()"),
            dict(E1, n=8, params={"chunks": 6}, name="gen_ring_c6",
                 gen="ring(chunks=6)")])
        with env(UCC_GEN_SEARCH_CACHE=p):
            progs = search.searched_programs(None, 4)
        assert [pr.name for pr in progs] == ["gen_ring_c3"]
        for pr in progs:
            verify(pr)

    def test_searched_candidate_registers_and_dispatches(self, tmp_path):
        p = str(tmp_path / "search.json")
        search.store_search_entries(p, [dict(
            E1, n=2, predicted_us=42.0, measured_us=40.0)])
        job = GenJob(ut, 2, UCC_GEN_SEARCH_CACHE=p, UCC_GEN_NATIVE="n")
        try:
            teams = job.team(2)
            cands = sweep_candidates(teams[0], CollType.ALLREDUCE,
                                     MemoryType.HOST, 65536)
            searched = [c for c in cands if c.origin == "searched"]
            assert [(c.alg_name, c.gen) for c in searched][:1] == \
                [("gen_ring_c3", "ring(chunks=3)")]
            for t in teams:
                assert t.score_map.apply_learned(
                    CollType.ALLREDUCE, MemoryType.HOST, 0, 1 << 20,
                    "gen_ring_c3", origin="searched")
            assert "searched gen:ring(chunks=3)" in \
                teams[0].score_map.print_info("t")
            case = {"coll": "ALLREDUCE", "c": 999, "dt": "FLOAT32",
                    "op": "SUM", "seed": 4}
            from torch_host_jobs import run_cases
            got = run_cases(job, [case], 2)[0]
            assert {g[1] for g in got} == {"gen_ring_c3"}
            srcs, _, _ = case_inputs(case, 2)
            np.testing.assert_allclose(floats(got[0]), srcs[0] + srcs[1],
                                       rtol=1e-6)
        finally:
            job.destroy()

    def test_gen_search_off_keeps_candidates_clean(self, tmp_path):
        p = str(tmp_path / "search.json")
        search.store_search_entries(p, [dict(E1, n=2)])
        job = GenJob(ut, 2, UCC_GEN_SEARCH_CACHE=p, UCC_GEN_SEARCH="n")
        try:
            cands = sweep_candidates(job.team(2)[0], CollType.ALLREDUCE,
                                     MemoryType.HOST, 65536)
            assert not any(c.origin == "searched" for c in cands)
        finally:
            job.destroy()

    def test_stale_generated_entry_dropped(self, monkeypatch):
        from ucc_tpu_torch.obs import metrics
        monkeypatch.setattr(metrics, "ENABLED", True)
        key = metrics._key("tuner_stale_entries_dropped", "tuner",
                           "allreduce", "gen_ring_c3")
        job = GenJob(ut, 2, UCC_GEN=None)
        try:
            sm = job.team(2)[0].score_map
            before = sm.lookup(CollType.ALLREDUCE, MemoryType.HOST, 4096)
            n0 = metrics._counters.get(key, 0)
            covered = apply_entries(sm, [
                {"coll": "allreduce", "mem": "host", "start": 0,
                 "end": 1 << 20, "alg": "gen_ring_c3",
                 "gen": "ring(chunks=3)", "origin": "searched"},
                {"coll": "allreduce", "mem": "host", "start": 0,
                 "end": 4096, "alg": "sra_knomial"}])
            assert covered == [(CollType.ALLREDUCE, MemoryType.HOST, 0,
                                4096)]
            after = sm.lookup(CollType.ALLREDUCE, MemoryType.HOST, 8192)
            assert not any(c.alg_name == "gen_ring_c3" for c in after)
            assert len(after) == len(before)
            assert metrics._counters.get(key, 0) == n0 + 1
        finally:
            job.destroy()


class TestProgramDiskCache:
    @pytest.fixture(autouse=True)
    def fresh(self):
        saved = (dict(reg._DISK), dict(reg._CACHE))

        def reset(path):
            reg._CACHE.clear()
            reg._PENDING.clear()
            reg._DISK.update({"path": False, "programs": None})
            os.environ["UCC_GEN_PROG_CACHE"] = path
        old = os.environ.get("UCC_GEN_PROG_CACHE")
        yield reset
        reset("0")
        reg._DISK.clear()
        reg._DISK.update(saved[0])
        reg._CACHE.update(saved[1])
        if old is None:
            os.environ.pop("UCC_GEN_PROG_CACHE", None)
        else:
            os.environ["UCC_GEN_PROG_CACHE"] = old

    def test_roundtrip_skips_verification(self, tmp_path, monkeypatch,
                                          fresh):
        path = str(tmp_path / "programs.pkl")
        fresh(path)
        p1 = reg.build_program("ring", 2, 6)
        reg.flush_program_cache()
        assert os.path.exists(path)
        fresh(path)

        def boom(prog):
            raise AssertionError("a disk hit must skip verification")
        monkeypatch.setattr(reg, "verify", boom)
        p2 = reg.build_program("ring", 2, 6)
        assert p2.name == p1.name and p2.n_rounds == p1.n_rounds

    def test_version_bump_invalidates(self, tmp_path, monkeypatch, fresh):
        import pickle
        path = str(tmp_path / "programs.pkl")
        fresh(path)
        assert reg.build_program("ring", 1, 4) is not None
        reg.flush_program_cache()
        with open(path, "rb") as fh:
            data = pickle.load(fh)
        data["version"] = "ucc_tpu_torch/-1"
        with open(path, "wb") as fh:
            pickle.dump(data, fh)
        fresh(path)
        calls = []
        real = reg.verify
        monkeypatch.setattr(reg, "verify",
                            lambda p: (calls.append(p.name), real(p)))
        assert reg.build_program("ring", 1, 4) is not None
        assert calls

    def test_disabled_by_knob(self, tmp_path, fresh):
        fresh("0")
        assert reg.build_program("ring", 1, 4) is not None
        reg.flush_program_cache()
        assert not os.path.exists(str(tmp_path / "programs.pkl"))

    def test_corrupt_cache_rebuilds(self, tmp_path, fresh):
        path = str(tmp_path / "programs.pkl")
        with open(path, "wb") as fh:
            fh.write(b"not a pickle")
        fresh(path)
        assert reg.build_program("ring", 1, 4) is not None


# ---------------------------------------------------------------------------
# hierarchical programs
# ---------------------------------------------------------------------------

class TestHierPrograms:
    def test_three_level_asymmetric_verifies_with_quant_dcn(self):
        for top in (0, 1, 2, 4):
            for wire in ("", "int8", "fp8"):
                prog = fam.gen_hier(ASYM_PATHS, top=top, wire=wire)
                verify(prog)
                assert prog.nranks == 8 and prog.edge_wire_mode == wire
                if not wire:
                    continue
                for r, rp in enumerate(prog.ranks):
                    for ops in rp.rounds:
                        for op in ops:
                            if op.kind != OpKind.COPY:
                                crosses = ASYM_PATHS[r][0] != \
                                    ASYM_PATHS[op.peer][0]
                                assert bool(op.wire) == crosses

    def test_cost_prices_dcn_edges_as_the_reference(self):
        link, jlink = cost.link_of_paths(ASYM_PATHS), \
            jcost.link_of_paths(ASYM_PATHS)
        for wire in ("", "int8"):
            got = cost.CostModel().features(
                fam.gen_hier(ASYM_PATHS, top=0, wire=wire), 64 << 10, link)
            want = jcost.CostModel().features(
                jfam.gen_hier(ASYM_PATHS, top=0, wire=wire), 64 << 10,
                jlink)
            assert got == want and "dcn" in got

    def test_hier_matches_the_reference_on_a_fake_pod(self):
        """UCC_TOPO_FAKE_PPN=2,1,3 in pods of 2 nodes, UCC_QUANT=int8: the
        hier rows (exact and with quantized DCN edges) register as the
        reference's and every one runs bitwise as the reference's."""
        topo = dict(UCC_TOPO_FAKE_PPN="2,1,3", UCC_TOPO_FAKE_NODES_PER_POD="2",
                    UCC_QUANT="int8", UCC_GEN_NATIVE="n")
        n = 8
        jj = GenJob(ucc_tpu, n, **topo)
        pj = GenJob(ut, n, **topo)
        try:
            assert pj.info(n) == jj.info(n)
            names = sorted({c.alg_name for c in sweep_candidates(
                pj.team(n)[0], CollType.ALLREDUCE, MemoryType.HOST, 32768)
                if c.alg_name.startswith("gen_hier")})
            assert any("qint8" in x for x in names)
            assert any("qint8" not in x for x in names)
            case = {"coll": "ALLREDUCE", "c": 8 << 10, "dt": "FLOAT32",
                    "op": "SUM", "seed": 3}
            srcs, _, _ = case_inputs(case, n)
            exact = np.sum(np.stack(srcs).astype(np.float64), axis=0)
            peak = np.max(np.abs(exact))
            for name in names:
                got = forced(pj, case, n, name)
                same_bits(got, forced(jj, case, n, name), name)
                tol = 0.1 if "qint8" in name else 1e-5
                for rr in got:
                    assert np.max(np.abs(floats(rr) - exact)) / peak <= tol
                    assert rr[2] == got[0][2]
            # the cost model rebuilds the hier rows from the paths
            paths = reg.team_paths(pj.team(n)[0].score_map.lookup(
                CollType.ALLREDUCE, MemoryType.HOST, 4096)[0].team)
            assert paths
            for gen in ("hier(top=0)", "hier(top=2,wire=int8)"):
                got = cost.predict_for_record(cost.CostModel(), gen, n,
                                              65536, paths=paths)
                want = jcost.predict_for_record(jcost.CostModel(), gen, n,
                                                65536, paths=paths)
                assert got is not None and got == pytest.approx(want,
                                                                rel=1e-12)
        finally:
            jj.destroy()
            pj.destroy()


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.fixture
def caches(tmp_path):
    # no tl/sockets: its listeners take ephemeral ports that tests of
    # other workers probe and then bind
    values = dict(UCC_TLS="shm,self,torch_ops,ring_cuda",
                  UCC_GEN_SEARCH_CACHE=str(tmp_path / "search.json"),
                  UCC_GEN_COST_CACHE=str(tmp_path / "cost.json"),
                  UCC_TUNER_CACHE=str(tmp_path / "tune.json"),
                  UCC_GEN_PROG_CACHE="n", UCC_TL_RING_CUDA_DEVICE="cpu",
                  UCC_GEN=None, UCC_QUANT=None, UCC_GEN_NATIVE=None,
                  UCC_TL_SHM_TUNE=None, UCC_TL_TORCH_OPS_TUNE=None)
    with env(**values):
        yield tmp_path


class TestSearchEndToEnd:
    def test_budgeted_search_persists_its_winner(self, caches):
        search_cache = str(caches / "search.json")
        tuner_cache = str(caches / "tune.json")
        rep = search.run_search(2, ["allreduce"], [8192], iters=2,
                                budget=4, search_cache=search_cache,
                                tuner_cache=tuner_cache,
                                model=cost.CostModel(), verbose=False)
        res = rep["results"][0]
        assert res.get("winner"), rep
        finalists = res["finalists"]
        assert all("measured_us" in f for f in finalists)
        assert any(f.get("predicted_us") is not None for f in finalists)
        names = {e["name"] for e in
                 search.load_search_cache(search_cache)["entries"]}
        assert set(rep["winners"]) <= names
        if rep.get("tuner_entries"):
            tc = json.load(open(tuner_cache))
            entries = next(iter(tc["signatures"].values()))["entries"]
            assert all(e["origin"] == "searched" and
                       e.get("measured_us") is not None for e in entries)

    def test_device_search_on_cpu_teams(self, caches):
        tuner_cache = str(caches / "tune.json")
        rep = search.run_device_search(
            4, ["allreduce", "bcast"], [65536], iters=2, budget=3,
            quant_mode="int8", tuner_cache=tuner_cache,
            model=cost.CostModel(), verbose=False)
        assert rep["space"] == {"allreduce": 7, "bcast": 7}
        assert rep["device_families"]
        for res in rep["results"]:
            algs = {f["alg"] for f in res["finalists"]}
            assert any(a.startswith("gen_dev_") for a in algs), res
            assert "xla" in algs
        for e in rep["winners"]:
            assert e.startswith("gen_dev_")
        if rep.get("tuner_entries"):
            tc = json.load(open(tuner_cache))
            entries = next(iter(tc["signatures"].values()))["entries"]
            assert all(e["mem"] == "cuda" and e["origin"] == "searched" and
                       e["comp"] == "torch_ops" for e in entries)

    def test_a_searched_device_winner_dispatches(self, caches):
        """The tuner entry a device search writes, read by a fresh team
        under UCC_TUNER=offline: the generated program dispatches with
        origin 'searched', bitwise the host interpreter's result."""
        from ucc_tpu_torch.dsl import smoke
        from ucc_tpu_torch.score.tuner import (bucket_range, size_bucket,
                                               store_entries,
                                               topo_signature)
        from ucc_tpu_torch.tools.tune import _Job
        n, count = 4, 4096
        tuner_cache = str(caches / "tune.json")
        job = _Job(n, {"TUNER": "off", "GEN_DEVICE": "y"})
        try:
            sig = topo_signature(job.teams[0])
        finally:
            job.destroy()
        start, end = bucket_range(size_bucket(count * 4))
        store_entries(tuner_cache, sig, [
            {"coll": "allreduce", "mem": "cuda", "start": start,
             "end": end, "alg": "gen_dev_ring_c2", "comp": "torch_ops",
             "origin": "searched", "gen": "ring(chunks=2)",
             "measured_us": 1.0}], source="searched")
        rng = np.random.default_rng(17)
        srcs = [(rng.standard_normal(count) * 3).astype(np.float32)
                for _ in range(n)]
        job = _Job(n, {"TUNER": "offline", "TUNER_CACHE": tuner_cache,
                       "GEN_DEVICE": "y"})
        try:
            top = sweep_candidates(job.teams[0], CollType.ALLREDUCE,
                                   MemoryType.CUDA, count * 4)[0]
            assert (top.alg_name, top.origin) == ("gen_dev_ring_c2",
                                                  "searched")
            d_dev, alg = smoke._allreduce_digest(job, n, count,
                                                 MemoryType.CUDA, srcs)
        finally:
            job.destroy()
        assert alg == "gen_dev_ring_c2"
        with env(UCC_TL_SHM_TUNE="allreduce:@gen_ring_c2:inf"):
            job = _Job(n, {"TUNER": "off", "GEN": "y"})
            try:
                d_host, host_alg = smoke._allreduce_digest(
                    job, n, count, MemoryType.HOST, srcs)
            finally:
                job.destroy()
        assert host_alg == "gen_ring_c2"
        assert d_dev is not None and d_dev == d_host


def _check_search_record(rec):
    """What dsl/smoke.run_search_smoke's record holds whichever
    candidate won: the round trip dispatched the measured winner (the
    tuner cache learned a searched one; a hand-written one is the
    static default), and a program registers with origin "searched"
    exactly when the search wrote a winner to its cache."""
    assert "error" not in rec, rec
    assert rec["dispatch_ok"], rec
    assert rec["dispatch_alg"] == rec["winner"], rec
    assert rec["searched_registered"] == rec["searched_won"], rec
    if rec["searched_won"]:
        assert rec["winner_dispatched"], rec


def _stub_measure(tuner_mod, branch):
    """An ``interleaved_measure`` whose times make a hand-written
    candidate (``branch`` "handwritten") or the first searched program
    by name ("searched"; a generated one where none was registered)
    win, every other candidate slower in index order."""
    def measure(teams, contexts, argses, coll, mem, msgsize, idxs, iters,
                warmup=1, timeout=60.0):
        cands = tuner_mod.sweep_candidates(teams[0], coll, mem, msgsize)
        origins = {cands[i].origin for i in idxs}
        want = {"handwritten": None,
                "searched": "searched" if "searched" in origins
                else "generated"}[branch]
        best = [i for i in idxs if (cands[i].origin == want if want else
                                    cands[i].origin not in
                                    ("generated", "searched"))]
        best.sort(key=lambda i: cands[i].alg_name)
        return {i: (1.0 + best.index(i) if i in best else 100.0 + i)
                for i in idxs}
    return measure


class TestProbes:
    """dsl/smoke.py's records on CPU teams (the device one runs the plain
    versions of the generated-collective kernels)."""

    def test_run_smoke(self, caches):
        from ucc_tpu_torch.dsl import smoke
        rec = smoke.run_smoke(n=4, iters=3)
        assert "error" not in rec, rec
        assert rec["programs_verified"] >= 15
        assert rec["matrix"] == ["allreduce", "allgather", "bcast",
                                 "reduce", "alltoall", "barrier"]
        assert rec["pinned_engaged"] and rec["tuned_dispatch_ok"]
        assert rec["learned_generated_selection"]

    def test_run_plan_smoke(self, caches):
        from ucc_tpu_torch.dsl import smoke
        rec = smoke.run_plan_smoke()
        assert rec["plan_engaged"] and rec["bitwise_identical"], rec
        assert rec["ffi_per_collective"] == 1.0

    def test_run_device_smoke(self, caches):
        from ucc_tpu_torch.dsl import smoke
        rec = smoke.run_device_smoke()
        assert "error" not in rec, rec
        assert rec["programs_lowered"] == 9
        assert rec["pinned_engaged"] and rec["bitwise_identical"], rec
        assert rec["matrix"] == ["allreduce", "allgather", "bcast",
                                 "barrier"]

    def test_run_search_smoke(self, caches):
        # which candidate wins is measured, so either branch may come
        # up: hold what the record guarantees on both
        from ucc_tpu_torch.dsl import smoke
        rec = smoke.run_search_smoke(n=4, size=16384, budget=4)
        _check_search_record(rec)

    @pytest.mark.parametrize("branch", ["handwritten", "searched"])
    def test_run_search_smoke_branches(self, caches, monkeypatch, branch):
        """Each branch of the probe's record, decided by stubbed search
        times, and the reference's record under the same stub and the
        same (seed) cost model."""
        from ucc_tpu.dsl import smoke as jsmoke
        from ucc_tpu.score import tuner as jtuner
        from ucc_tpu_torch.dsl import smoke
        from ucc_tpu_torch.score import tuner

        monkeypatch.setattr(search, "interleaved_measure",
                            _stub_measure(tuner, branch))
        monkeypatch.setattr(jsearch, "interleaved_measure",
                            _stub_measure(jtuner, branch))
        monkeypatch.setattr(cost, "load_model",
                            lambda *_a, **_k: cost.CostModel())
        monkeypatch.setattr(jcost, "load_model",
                            lambda *_a, **_k: jcost.CostModel())
        recs = {}
        for name, mod, tls in (("port", smoke, None),
                               ("ref", jsmoke, "shm,self")):
            sc = str(caches / f"{name}-search.json")
            with env(UCC_GEN_SEARCH_CACHE=sc, UCC_TLS=tls):
                recs[name] = mod._run_search_smoke_body(
                    {}, 4, 16384, 4, sc, str(caches / f"{name}-tune.json"))
        rec = recs["port"]
        _check_search_record(rec)
        assert rec["searched_won"] is (branch == "searched")
        if branch == "handwritten":
            assert not rec["winner"].startswith("gen_")
        keys = ("searched_won", "searched_registered", "winner")
        assert {k: rec[k] for k in keys} == \
            {k: recs["ref"][k] for k in keys}

    def test_digest_matrix_plans_against_the_interpreter(self, caches):
        from ucc_tpu_torch.dsl import smoke
        out = {}
        for mode in ("n", "y"):
            with env(UCC_GEN_NATIVE=mode,
                     UCC_TL_SHM_TUNE="allreduce:@gen_ring_c1:inf"):
                out[mode] = smoke._digest_matrix(4)
        assert out["y"].pop("_plan_engaged") is True
        assert out["n"].pop("_plan_engaged") is False
        assert out["n"] == out["y"] and None not in out["n"].values()

    def test_main_prints_one_record_and_exits_0(self, caches, capsys):
        from ucc_tpu_torch.dsl import smoke
        assert smoke.main(["--plans"]) == 0
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["metric"] == "plan_gate_smoke"

    def test_tune_gen_search_cli(self, caches, capsys):
        from ucc_tpu_torch.tools.tune import main as tune_main
        out = str(caches / "tune-cli.json")
        assert tune_main(["--gen-search", "-p", "2", "-m", "host", "-c",
                          "allreduce", "-b", "8K", "-e", "8K", "-n", "8",
                          "--search-budget", "3", "-o", out]) == 0
        text = capsys.readouterr().out
        assert "# search winners:" in text and "measured" in text
        assert tune_main(["--gen-search", "--device", "-p", "2", "-c",
                          "bcast", "-b", "64K", "-e", "64K", "-n", "8",
                          "--search-budget", "2", "-o", out]) == 0
        assert "# device-search winners:" in capsys.readouterr().out
