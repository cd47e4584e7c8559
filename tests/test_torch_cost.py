"""The port's alpha-beta cost model (ucc_tpu_torch/score/cost.py) held
against the JAX package's: from the same sweep records, ``fit_records``
gives the same coefficients (rtol 1e-12), ``predict_for_record`` the same
prices (the hier programs rebuilt from topology paths too),
``parse_param_str`` the same parse; a fitted model survives a
``save_model``/``load_model`` round trip, under the port's own default
path."""
import json
import os

import numpy as np
import pytest

from ucc_tpu.dsl import registry as jreg
from ucc_tpu.score import cost as jcost

from ucc_tpu_torch.dsl import registry as preg
from ucc_tpu_torch.score import cost as pcost

#: (family, params, wire) of the programs the records name: flat families
#: that both registries build at these team sizes
PROGRAMS = (("ring", {"chunks": 1}, ""), ("ring", {"chunks": 2}, ""),
            ("ring", {"chunks": 4}, ""), ("rhd", {"radix": 2}, ""),
            ("rhd", {"radix": 4}, ""), ("sra", {"radix": 2}, ""),
            ("sra_pipe", {"depth": 2}, ""), ("qdirect", {}, "int8"),
            ("ag_ring", {"chunks": 2}, ""), ("bc_kn", {"radix": 2}, ""))
SIZES = (4096, 65536, 1 << 20)


def sweep_records(n, seed):
    """Sweep rows of generated candidates with measured-looking p50s (a
    seeded linear price plus noise), gen strings from the reference's
    programs."""
    rng = np.random.default_rng(seed)
    recs = []
    for fam, params, wire in PROGRAMS:
        prog = jreg.build_named(fam, params, n, wire=wire)
        if prog is None:
            continue
        for size in SIZES:
            us = 3.0 + 7e-4 * size * (1 + 0.2 * rng.random()) + \
                5 * rng.random()
            recs.append({"bench": "sweep", "coll": "allreduce",
                         "mem": "host", "ranks": n, "comp": "shm",
                         "alg": prog.name, "gen": prog.param_str,
                         "size_bytes": size, "count": size // 4,
                         "p50_us": round(us, 3)})
    return recs


def coeffs(model):
    return {k: (c.alpha_us, c.beta_us_per_byte, c.fitted)
            for k, c in model.links.items()}


@pytest.mark.parametrize("uniform", (False, True))
@pytest.mark.parametrize("link", ("shm", "socket", "ici"))
@pytest.mark.parametrize("n", (4, 8))
def test_fit_records_matches_the_reference(n, link, uniform):
    recs = sweep_records(n, seed=n)
    want = jcost.fit_records(recs, link=link, uniform=uniform)
    got = pcost.fit_records(recs, link=link, uniform=uniform)
    assert want is not None and got is not None
    assert got.source == want.source
    g, w = coeffs(got), coeffs(want)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(g[k][:2], w[k][:2], rtol=1e-12)
        assert g[k][2] == w[k][2]


def test_fit_needs_two_usable_rows():
    recs = sweep_records(4, seed=1)
    assert pcost.fit_records(recs[:1]) is None is jcost.fit_records(recs[:1])
    plain = [dict(r, gen="") for r in recs]
    assert pcost.fit_records(plain) is None is jcost.fit_records(plain)


@pytest.mark.parametrize("n", (4, 8))
def test_predict_for_record_matches(n):
    recs = sweep_records(n, seed=2)
    jm = jcost.fit_records(recs)
    pm = pcost.fit_records(recs)
    for r in recs:
        want = jcost.predict_for_record(jm, r["gen"], n, r["size_bytes"])
        got = pcost.predict_for_record(pm, r["gen"], n, r["size_bytes"])
        assert got == pytest.approx(want, rel=1e-12)
    # the seed model prices the same, program for program
    for fam, params, wire in PROGRAMS:
        jp = jreg.build_named(fam, params, n, wire=wire)
        pp = preg.build_named(fam, params, n, wire=wire)
        if jp is None:
            assert pp is None
            continue
        for size in SIZES:
            assert pcost.CostModel().predict_us(pp, size) == \
                pytest.approx(jcost.CostModel().predict_us(jp, size),
                              rel=1e-12)
    assert pcost.predict_for_record(None, "ring(chunks=2)", n, 64) is None
    assert pcost.predict_for_record(pm, "", n, 64) is None
    assert pcost.predict_for_record(pm, "nosuch(x=1)", n, 64) is None


#: two-pod topology paths: nodes of 2, 1, 3 and 2 ranks (the reference's
#: tests/test_search.py layout, by its hashes)
HIER_PATHS = [(1, 10), (1, 10), (1, 11), (2, 12), (2, 12), (2, 12),
              (2, 13), (2, 13)]


@pytest.mark.parametrize("gen", ("hier(top=0)", "hier(top=2)",
                                 "hier(top=1,chunks=2)",
                                 "hier(top=0,wire=int8)",
                                 "hier(top=4,wire=fp8)"))
def test_predict_for_record_rebuilds_hier_programs(gen):
    """A hier row rebuilds from the topology paths and prices as the
    reference's (rtol 1e-12), on the seed model and on a fitted one;
    without paths it does not rebuild, in both."""
    n = len(HIER_PATHS)
    pm, jm = pcost.fit_records(sweep_records(8, seed=9)), \
        jcost.fit_records(sweep_records(8, seed=9))
    for p, j in ((pcost.CostModel(), jcost.CostModel()), (pm, jm)):
        for size in SIZES:
            want = jcost.predict_for_record(j, gen, n, size,
                                            paths=HIER_PATHS)
            got = pcost.predict_for_record(p, gen, n, size,
                                           paths=HIER_PATHS)
            assert want is not None
            assert got == pytest.approx(want, rel=1e-12)
    assert pcost.predict_for_record(pm, gen, n, 64) is None is \
        jcost.predict_for_record(jm, gen, n, 64)


@pytest.mark.parametrize("s", ("ring(chunks=4)", "rhd(radix=2)", "qdirect(int8)",
                               "hier(top=2,wire=int8)", "sra(radix=x)",
                               "plain", "", "ring()", "bc_kn(radix=2,fp8)"))
def test_parse_param_str_matches(s):
    assert pcost.parse_param_str(s) == jcost.parse_param_str(s)


def test_link_classifiers_match():
    paths = [("p0", "h0"), ("p0", "h0"), ("p0", "h1"), ("p1", "h2")]
    for a in range(4):
        for b in range(4):
            assert pcost.link_of_paths(paths)(a, b) == \
                jcost.link_of_paths(paths)(a, b)
    assert pcost.link_of_paths(None)(0, 1) == "shm"
    assert pcost.link_of_device()(0, 1) == jcost.link_of_device()(0, 1)
    assert pcost.SEED_LINKS == jcost.SEED_LINKS


def test_save_and_load_round_trip(tmp_path):
    model = pcost.fit_records(sweep_records(4, seed=3))
    path = str(tmp_path / "cost.json")
    assert pcost.save_model(model, path) == path
    back = pcost.load_model(path)
    assert back is not None and back.source == model.source
    assert coeffs(back) == coeffs(model)
    # the reference reads the same file format
    assert coeffs(jcost.load_model(path)) == coeffs(back)
    # an unfitted (seed) model, a wrong version and garbage load as None
    pcost.save_model(pcost.CostModel(), path)
    assert pcost.load_model(path) is None
    with open(path, "w") as fh:
        json.dump({"version": 99, "links": {}}, fh)
    assert pcost.load_model(path) is None
    with open(path, "w") as fh:
        fh.write("{not json")
    assert pcost.load_model(path) is None


def test_default_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("UCC_GEN_COST_CACHE", raising=False)
    assert pcost.resolve_cost_path() == \
        os.path.expanduser("~/.cache/ucc_tpu_torch/cost.json")
    assert pcost.resolve_cost_path() != jcost.resolve_cost_path()
