"""The port's generated host programs (ucc_tpu_torch/dsl/compile.py and
dsl/registry.py's UCC_GEN gate) held against the JAX package's.

Both packages run the same team sizes in this process over tl/shm with
UCC_GEN=y. The generated rows of the host TLs must equal the reference's
in the score dump: names, ranges and scores, origins, ``gen`` strings and
``+plan`` marks, with and without UCC_QUANT; with UCC_GEN off the rows are
the ones of a build without the compiler. Every generated candidate,
pinned by TUNE in both packages on the same seeded inputs
(``torch_procs.layout``), must give the reference's result bit for bit
(tolerance: none) for every collective it serves, and the reference's
results stand against numpy too (float32 SUM: rtol 1e-5, atol 1e-5; AVG
the same on the averages; bfloat16 SUM: 2^-6 of the peak times n; int8
wire: the int8 error budget, 0.1 of the peak). The cases of the
reference's tests/test_dsl.py (TestRegistry, TestGeneratedCorrectness,
TestNewCollectiveCorrectness, TestProvenance, TestPoolKnobs) are here in
that form. The program cache on disk refuses a file the JAX package
wrote.
"""
import os
import pickle
import re

import numpy as np
import pytest

import ucc_tpu
import ucc_tpu_torch as ut
from ucc_tpu.dsl import families as jfam
from ucc_tpu.dsl import registry as jreg
from ucc_tpu_torch.constants import CollType, MemoryType
from ucc_tpu_torch.dsl import families as fam
from ucc_tpu_torch.dsl import registry as reg
from ucc_tpu_torch.score.score import MsgRange
from ucc_tpu_torch.score.score_map import _cand_order
from ucc_tpu_torch.score.tuner import cand_label, sweep_candidates

from torch_gen_jobs import GenJob, case_inputs, floats, pinned, same_bits
from torch_host_jobs import env

SIZES = (2, 4, 5, 8)


@pytest.fixture(scope="module")
def pairs():
    """(reference job, port job) per team size, UCC_GEN=y, made once."""
    made = {}

    def get(n):
        if n not in made:
            made[n] = (GenJob(ucc_tpu, n), GenJob(ut, n))
        return made[n]
    yield get
    for jj, pj in made.values():
        jj.destroy()
        pj.destroy()


def segments(lines):
    """The (collective, row) pairs of score-dump lines."""
    return {(ln.split()[0], seg) for ln in lines
            for seg in re.findall(r"\[[^\]]+\] \S+ \([^)]*\)", ln)}


def gen_names(job, n, coll, msgsize=4096):
    """Names of the generated (and pooled) rows of tl/shm for *coll*."""
    teams = job.team(n)
    mod = job.mod
    mem = mod.constants.MemoryType.HOST
    ct = mod.constants.CollType[coll]
    cands = teams[0].score_map.lookup(ct, mem, msgsize)
    return sorted({c.alg_name for c in cands
                   if c.origin in ("generated", "pooled")
                   and cand_label(c)[0] == "shm"})


# ---------------------------------------------------------------------------
# the registry and the rows
# ---------------------------------------------------------------------------

class TestRegistry:
    @pytest.mark.parametrize("spec", [
        "", "ring(1,8),rhd(2)", "qdirect", "ring(1,2,2),sra_pipe(3)",
        " rhd ( 2 , 4 ) ", "pooled(1,2),hier(0,2)", "bc_kn,bc_chain(8)"])
    def test_parse_families_matches(self, spec):
        assert reg.parse_families(spec) == jreg.parse_families(spec)

    @pytest.mark.parametrize("spec,match", [
        ("warp(3)", "unknown generated family"),
        ("ring(1,2", "unbalanced"), ("ring)1(", "unbalanced"),
        ("ring()", "empty parameter list"), ("ring(1)x", "malformed")])
    def test_parse_families_rejects_junk_as_the_reference(self, spec, match):
        with pytest.raises(ValueError, match=match):
            jreg.parse_families(spec)
        with pytest.raises(ValueError, match=match):
            reg.parse_families(spec)

    def test_constants_match(self):
        assert reg.GEN_ALG_ID_BASE == jreg.GEN_ALG_ID_BASE == 100
        assert reg.MAX_GEN_RANKS == jreg.MAX_GEN_RANKS
        assert reg._GRID_PARAM_KEY == jreg._GRID_PARAM_KEY
        assert reg.paths_digest([(1, 2), (1, 3)]) == \
            jreg.paths_digest([(1, 2), (1, 3)])
        assert reg.paths_digest(None) == jreg.paths_digest(None) == ""

    @pytest.mark.parametrize("n", SIZES)
    def test_built_in_programs_match(self, n):
        got = reg.built_in_programs(n, quant_mode="int8")
        want = jreg.built_in_programs(n, quant_mode="int8")
        assert [(p.name, p.param_str, p.n_rounds) for p in got] == \
            [(p.name, p.param_str, p.n_rounds) for p in want]

    def test_off_keeps_candidate_lists_identical(self):
        jj = GenJob(ucc_tpu, 4, UCC_GEN=None)
        pj = GenJob(ut, 4, UCC_GEN=None)
        on = GenJob(ut, 4)
        try:
            assert pj.info(4) == jj.info(4)
            assert not any("gen_" in ln for ln in pj.info(4))
            # the rows that UCC_GEN adds are generated ones only
            off_rows, on_rows = segments(pj.info(4)), segments(on.info(4))
            assert off_rows <= on_rows
            assert on_rows - off_rows
            assert all("/gen_" in r[1] for r in on_rows - off_rows)
        finally:
            jj.destroy()
            pj.destroy()
            on.destroy()

    @pytest.mark.parametrize("n", SIZES)
    def test_rows_match_the_reference(self, pairs, n):
        jj, pj = pairs(n)
        assert pj.info(n) == jj.info(n)
        assert any(" gen:ring(chunks=" in ln
                   for ln in pj.info(n))

    @pytest.mark.parametrize("mode", ["int8", "fp8"])
    def test_quant_rows_match_the_reference(self, mode):
        jj = GenJob(ucc_tpu, 4, UCC_QUANT=mode)
        pj = GenJob(ut, 4, UCC_QUANT=mode)
        try:
            assert pj.info(4) == jj.info(4)
            assert any(f"gen_q{mode}_direct" in ln for ln in pj.info(4))
        finally:
            jj.destroy()
            pj.destroy()

    @pytest.mark.parametrize("native", ["y", "auto", "n"])
    def test_plan_marks_match_the_reference(self, native):
        jj = GenJob(ucc_tpu, 4, UCC_GEN_NATIVE=native)
        pj = GenJob(ut, 4, UCC_GEN_NATIVE=native)
        try:
            assert pj.info(4) == jj.info(4)
            marked = any("+plan" in ln for ln in pj.info(4))
            assert marked == (native != "n")
        finally:
            jj.destroy()
            pj.destroy()

    def test_numeric_tune_addresses_the_same_rows(self, pairs):
        """Generated ids start at GEN_ALG_ID_BASE in both packages: @100
        and @101 pin the same programs."""
        jj, pj = pairs(4)
        case = {"coll": "ALLREDUCE", "c": 96, "dt": "FLOAT32",
                "op": "SUM", "seed": 1}
        for idx in (100, 101, 102):
            want = pinned(jj, case, 4, str(idx))
            got = pinned(pj, case, 4, str(idx))
            assert want[0][:2] == ("OK", str(idx))
            assert got == want


# ---------------------------------------------------------------------------
# allreduce programs, bitwise against the reference
# ---------------------------------------------------------------------------

class TestGeneratedCorrectness:
    @pytest.mark.parametrize("n", SIZES)
    def test_every_family_matches_the_reference(self, pairs, n):
        jj, pj = pairs(n)
        names = gen_names(pj, n, "ALLREDUCE")
        assert names == [x for x in gen_names(jj, n, "ALLREDUCE")]
        fams = {x.split("_")[1] for x in names}
        assert {"ring", "sra", "pooled"} <= fams or n == 2
        cases = [
            {"coll": "ALLREDUCE", "c": 1024, "dt": "FLOAT32", "op": "SUM",
             "seed": n},
            {"coll": "ALLREDUCE", "c": 1024, "dt": "FLOAT32", "op": "AVG",
             "seed": n + 1, "inplace": True},
            {"coll": "ALLREDUCE", "c": 1024, "dt": "BFLOAT16", "op": "SUM",
             "seed": n + 2},
            {"coll": "ALLREDUCE", "c": 517, "dt": "FLOAT64", "op": "MAX",
             "seed": n + 3}]
        ran = 0
        for name in names:
            if name.startswith("gen_pooled"):
                continue          # needs an arena: test_torch_ipc_pooled
            for case in cases:
                want = pinned(jj, case, n, name)
                got = pinned(pj, case, n, name)
                same_bits(got, want, name)
                ran += 1
            # the reference's own result against numpy (float32 SUM)
            srcs, _, _ = case_inputs(cases[0], n)
            exact = np.sum(np.stack(srcs).astype(np.float64), axis=0)
            for rr in want_sum(jj, cases[0], n, name):
                np.testing.assert_allclose(floats(rr), exact, rtol=1e-5,
                                           atol=1e-5, err_msg=name)
        assert ran >= 4

    def test_tiny_count_refuses_in_both(self, pairs):
        """A count below the chunk count is NOT_SUPPORTED: the pinned
        TUNE's fallback walk lands on an exact algorithm in both."""
        jj, pj = pairs(4)
        case = {"coll": "ALLREDUCE", "c": 2, "dt": "FLOAT32", "op": "SUM",
                "seed": 5}
        want = pinned(jj, case, 4, "gen_ring_c4")
        got = pinned(pj, case, 4, "gen_ring_c4")
        assert want[0][1] != "gen_ring_c4"
        assert [g[:2] for g in got] == [w[:2] for w in want]
        assert [g[2] for g in got] == [w[2] for w in want]

    def test_unsupported_op_refuses_in_both(self, pairs):
        jj, pj = pairs(4)
        case = {"coll": "ALLREDUCE", "c": 64, "dt": "INT32", "op": "BAND",
                "seed": 5}
        want = pinned(jj, case, 4, "gen_rhd_r2")
        got = pinned(pj, case, 4, "gen_rhd_r2")
        assert want[0][1] != "gen_rhd_r2"
        assert [g[:2] for g in got] == [w[:2] for w in want]
        assert [g[2] for g in got] == [w[2] for w in want]

    @pytest.mark.parametrize("mode", ["int8", "fp8"])
    def test_fused_quant_program_matches_the_reference(self, mode):
        n = 4
        jj = GenJob(ucc_tpu, n, UCC_QUANT=mode)
        pj = GenJob(ut, n, UCC_QUANT=mode)
        try:
            name = f"gen_q{mode}_direct"
            case = {"coll": "ALLREDUCE", "c": 8 << 10, "dt": "FLOAT32",
                    "op": "SUM", "seed": 7}
            want = pinned(jj, case, n, name)
            got = pinned(pj, case, n, name)
            same_bits(got, want, name)
            srcs, _, _ = case_inputs(case, n)
            exact = np.sum(np.stack(srcs).astype(np.float64), axis=0)
            peak = np.max(np.abs(exact))
            from ucc_tpu_torch.quant import default_budget
            for rr in got:
                assert np.max(np.abs(floats(rr) - exact)) / peak <= \
                    default_budget(mode)
                assert rr[2] == got[0][2]     # every rank the same bits
            # the AVG end scale and a bfloat16 payload ride the codec too
            for case2 in ({**case, "op": "AVG", "seed": 8},
                          {**case, "dt": "BFLOAT16", "seed": 9}):
                same_bits(pinned(pj, case2, n, name),
                          pinned(jj, case2, n, name), name)
        finally:
            jj.destroy()
            pj.destroy()

    def test_persistent_reposts_match_the_reference(self, pairs):
        jj, pj = pairs(4)
        case = {"coll": "ALLREDUCE", "c": 1000, "dt": "FLOAT32",
                "op": "SUM", "seed": 11, "rounds": 3}
        for name in ("gen_ring_c2", "gen_sra_pipe_d2"):
            same_bits(pinned(pj, case, 4, name), pinned(jj, case, 4, name),
                      name)


def want_sum(job, case, n, name):
    return pinned(job, case, n, name)


# ---------------------------------------------------------------------------
# allgather, reduce_scatter and bcast programs
# ---------------------------------------------------------------------------

class TestNewCollectiveCorrectness:
    COUNT = 120         # a per-rank block; n * COUNT divides every chunking

    @pytest.mark.parametrize("n", SIZES)
    def test_allgather_variants_match(self, pairs, n):
        jj, pj = pairs(n)
        names = gen_names(pj, n, "ALLGATHER")
        assert names == gen_names(jj, n, "ALLGATHER")
        assert any(x.startswith("gen_ag_ring") for x in names)
        case = {"coll": "ALLGATHER", "c": self.COUNT, "dt": "FLOAT32",
                "seed": n}
        srcs, _, _ = case_inputs(case, n)
        for name in names:
            got = pinned(pj, case, n, name)
            same_bits(got, pinned(jj, case, n, name), name)
            for rr in got:
                np.testing.assert_array_equal(floats(rr),
                                              np.concatenate(srcs))

    @pytest.mark.parametrize("op", ["SUM", "AVG", "MIN"])
    @pytest.mark.parametrize("n", SIZES)
    def test_reduce_scatter_variants_match(self, pairs, n, op):
        jj, pj = pairs(n)
        names = gen_names(pj, n, "REDUCE_SCATTER")
        assert names == gen_names(jj, n, "REDUCE_SCATTER")
        assert names
        case = {"coll": "REDUCE_SCATTER", "c": self.COUNT,
                "dt": "FLOAT32", "op": op, "seed": n + 20}
        for name in names:
            same_bits(pinned(pj, case, n, name),
                      pinned(jj, case, n, name), name)
        # in place: the result lands in the caller's block of dst
        case = dict(case, inplace=True, seed=n + 21)
        for name in names:
            same_bits(pinned(pj, case, n, name),
                      pinned(jj, case, n, name), name)

    @pytest.mark.parametrize("n", SIZES)
    def test_bcast_variants_match_every_root(self, pairs, n):
        jj, pj = pairs(n)
        names = gen_names(pj, n, "BCAST")
        assert names == gen_names(jj, n, "BCAST")
        assert any(x.startswith("gen_bc_chain") for x in names)
        for root in range(n):
            case = {"coll": "BCAST", "c": self.COUNT, "dt": "FLOAT32",
                    "seed": root, "root": root}
            srcs, _, _ = case_inputs(case, n)
            for name in names:
                got = pinned(pj, case, n, name)
                same_bits(got, pinned(jj, case, n, name), name)
                for rr in got:
                    np.testing.assert_array_equal(floats(rr), srcs[root])

    def test_chunked_variants_refuse_non_divisible_counts(self, pairs):
        """A chunked block-addressed program refuses a total its chunks
        do not divide; the fallback walk lands on the same exact
        algorithm in both, and the 1-chunk ring serves it."""
        jj, pj = pairs(4)
        case = {"coll": "ALLGATHER", "c": 251, "dt": "FLOAT32", "seed": 3}
        want = pinned(jj, case, 4, "gen_ag_ring_c2")
        got = pinned(pj, case, 4, "gen_ag_ring_c2")
        assert want[0][1] != "gen_ag_ring_c2"
        assert [g[:2] for g in got] == [w[:2] for w in want]
        assert [g[2] for g in got] == [w[2] for w in want]
        same_bits(pinned(pj, case, 4, "gen_ag_ring_c1"),
                  pinned(jj, case, 4, "gen_ag_ring_c1"), "gen_ag_ring_c1")


# ---------------------------------------------------------------------------
# provenance and tie-break determinism
# ---------------------------------------------------------------------------

class TestProvenance:
    def test_score_dump_shows_generated_and_learned_gen(self):
        # UCC_GEN_NATIVE=n: no "+plan" beside the origins
        pj = GenJob(ut, 2, UCC_GEN_NATIVE="n")
        try:
            teams = pj.team(2)
            info = teams[0].score_map.print_info("t")
            assert "generated gen:ring(chunks=1)" in info
            assert "generated gen:rhd(radix=2)" in info
            assert teams[0].score_map.apply_learned(
                CollType.ALLREDUCE, MemoryType.HOST, 0, 1 << 20,
                "gen_ring_c1")
            info = teams[0].score_map.print_info("t")
            assert "learned gen:ring(chunks=1)" in info
            top = teams[0].score_map.lookup(CollType.ALLREDUCE,
                                            MemoryType.HOST, 4096)[0]
            assert (top.alg_name, top.origin, top.gen) == \
                ("gen_ring_c1", "learned", "ring(chunks=1)")
        finally:
            pj.destroy()

    def test_cand_order_ties_break_on_gen_param(self):
        def mk(gen):
            return MsgRange(0, 1 << 30, 2, init=lambda *a: None, team=None,
                            alg_name="gen_x", origin="generated", gen=gen)
        a, b, c = mk("ring(chunks=1)"), mk("ring(chunks=2)"), \
            mk("ring(chunks=4)")
        fwd, rev = _cand_order([a, b, c]), _cand_order([c, b, a])
        assert [r.gen for r in fwd] == [r.gen for r in rev] == \
            ["ring(chunks=1)", "ring(chunks=2)", "ring(chunks=4)"]

    def test_rotation_order_rank_invariant_with_generated(self, pairs):
        jj, pj = pairs(4)
        orders = [[cand_label(c) + (c.gen,) for c in
                   sweep_candidates(t, CollType.ALLREDUCE, MemoryType.HOST,
                                    65536)] for t in pj.team(4)]
        assert all(o == orders[0] for o in orders[1:])
        assert any(lbl[1].startswith("gen_") for lbl in orders[0])
        jorders = [cand_label(c) + (c.gen,) for c in
                   jj.team(4)[0].score_map.lookup(
                       ucc_tpu.CollType.ALLREDUCE,
                       ucc_tpu.constants.MemoryType.HOST, 65536)]
        assert orders[0] == jorders


# ---------------------------------------------------------------------------
# the pooled tier's gates (UCC_POOL_ENABLE / UCC_POOL_CHUNKS)
# ---------------------------------------------------------------------------

class TestPoolKnobs:
    @pytest.mark.parametrize("enable,chunks,spec", [
        ("n", None, "pooled(1,2),ring(2)"), ("y", None, "ring(2)"),
        (None, "4,2,4", "pooled(1)"), (None, None, "pooled(1,2)"),
        ("auto", "3", "pooled(1),rhd(2)"), ("y", "1,8", "")])
    def test_knobs_match_the_reference(self, enable, chunks, spec):
        with env(UCC_POOL_ENABLE=enable, UCC_POOL_CHUNKS=chunks):
            want = jreg._apply_pool_knobs(None, jreg.parse_families(spec))
            got = reg._apply_pool_knobs(None, reg.parse_families(spec))
        assert got == want

    def test_bad_chunks_raises(self):
        from ucc_tpu_torch.status import Status, UccError
        for bad in ("1,zero", "0"):
            with env(UCC_POOL_CHUNKS=bad):
                with pytest.raises(UccError) as ei:
                    reg._apply_pool_knobs(None, reg.parse_families("pooled"))
            assert ei.value.status == Status.ERR_INVALID_PARAM


# ---------------------------------------------------------------------------
# the verified-program cache on disk
# ---------------------------------------------------------------------------

class TestProgramCache:
    def _fresh(self, mod, path):
        mod._DISK.update({"path": False, "programs": None})
        mod._PENDING.clear()
        mod._CACHE.clear()

    def test_round_trip_and_the_reference_file_is_refused(self, tmp_path):
        path = str(tmp_path / "programs.pkl")
        saved_j = (dict(jreg._DISK), dict(jreg._CACHE))
        saved_p = (dict(reg._DISK), dict(reg._CACHE))
        try:
            with env(UCC_GEN_PROG_CACHE=path):
                # the JAX package writes its cache first
                self._fresh(jreg, path)
                jp = jreg.build_named("ring", {"chunks": 2}, 4)
                jreg.flush_program_cache()
                with open(path, "rb") as fh:
                    raw = fh.read()
                assert b"ucc_tpu.dsl.ir" in raw
                # the port refuses it (no foreign class is resolved) and
                # starts fresh: the program it returns is its own
                self._fresh(reg, path)
                with pytest.raises(pickle.UnpicklingError):
                    reg._load_cache_file(path)
                pp = reg.build_named("ring", {"chunks": 2}, 4)
                assert type(pp).__module__ == "ucc_tpu_torch.dsl.ir"
                assert pp.name == jp.name
                reg.flush_program_cache()
                progs = reg._load_cache_file(path)
                assert all(type(p).__module__ == "ucc_tpu_torch.dsl.ir"
                           for p in progs.values())
                # a second process of the port loads it from disk
                self._fresh(reg, path)
                key = next(iter(progs))
                assert reg.build_named("ring", {"chunks": 2}, 4).name == \
                    progs[key].name
                # and the JAX package reads the port's file as a version
                # mismatch, never as its own programs
                self._fresh(jreg, path)
                assert jreg._disk_load() == {}
        finally:
            for mod, (disk, cache) in ((jreg, saved_j), (reg, saved_p)):
                mod._DISK.clear()
                mod._DISK.update(disk)
                mod._PENDING.clear()
                mod._CACHE.clear()
                mod._CACHE.update(cache)

    def test_a_tag_of_another_version_starts_fresh(self, tmp_path):
        path = str(tmp_path / "programs.pkl")
        with open(path, "wb") as fh:
            pickle.dump({"version": "ucc_tpu_torch/0", "programs": {}}, fh)
        assert reg._load_cache_file(path) == {}
        with open(path, "wb") as fh:
            fh.write(b"not a pickle")
        with pytest.raises(Exception):
            reg._load_cache_file(path)

    def test_default_path_is_the_ports_own(self):
        with env(UCC_GEN_PROG_CACHE=None):
            assert reg._prog_cache_path() == os.path.expanduser(
                "~/.cache/ucc_tpu_torch/programs.pkl")
            assert reg._prog_cache_path() != jreg._prog_cache_path()
        with env(UCC_GEN_PROG_CACHE="off"):
            assert reg._prog_cache_path() is None


def test_gen_hier_programs_match_the_reference():
    """gen_hier over topology paths: the same program, op for op."""
    layouts = [
        [("h0",)] * 2 + [("h1",)] * 2,
        [("h0",)] * 4 + [("h1",)] * 4,
        [("h0",)] * 3 + [("h1",)] * 2 + [("h2",)] * 3,
        [("p0", "h0")] * 2 + [("p0", "h1")] * 2 + [("p1", "h2")] * 2
        + [("p1", "h3")] * 2,
        [("h0",), ("h1",), ("h0",), ("h1",), ("h2",)],
    ]
    built = 0
    for paths in layouts:
        for top in (0, 1, 2, 4, 8):
            for chunks in (1, 2):
                for wire in ("", "int8", "fp8"):
                    try:
                        want = jfam.gen_hier(paths, top=top, wire=wire,
                                             chunks=chunks)
                    except jfam.Inapplicable:
                        with pytest.raises(fam.Inapplicable):
                            fam.gen_hier(paths, top=top, wire=wire,
                                         chunks=chunks)
                        continue
                    got = fam.gen_hier(paths, top=top, wire=wire,
                                       chunks=chunks)
                    assert got.name == want.name
                    assert got.param_str == want.param_str
                    assert got.edge_wire_mode == want.edge_wire_mode
                    assert [[[(int(o.kind), o.chunk, o.peer, o.slot,
                                o.src_chunk, o.wire) for o in ops]
                              for ops in rp.rounds] for rp in got.ranks] == \
                        [[[(int(o.kind), o.chunk, o.peer, o.slot,
                           o.src_chunk, o.wire) for o in ops]
                          for ops in rp.rounds] for rp in want.ranks]
                    built += 1
    assert built > 20
    with pytest.raises(fam.Inapplicable):
        fam.gen_hier([("h0",)] * 4)        # one node: the flat families
