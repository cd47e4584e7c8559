"""ucc_scale in the port (ucc_tpu_torch/tools/scale.py) against the JAX
package's (ucc_tpu/tools/scale.py).

No JAX-package test imports ucc_scale, so it is held by its JSON record:
both packages simulate the same 16-rank mesh (``-n 16 --ppn 4 --npp 2``,
the tree bootstrap over ThreadTreeOobWorld, fake nodes and pods) and
their records must agree on everything but timings: the bootstrap trees'
shapes and rounds, the hier levels, the collective matrix (every cell
checked against numpy inside the simulation), and each cell's candidate
names (the N-level hier allreduce, the best flat candidate and the best
in-process one). Timings are not compared.
"""
import json
import os

import pytest

from ucc_tpu.tools import scale as jscale
from ucc_tpu_torch.tools import scale

ARGS = dict(n=16, ppn="4", npp=2, cell_iters=2)
KNOBS = ("UCC_TLS", "UCC_CL_HIER_NODE_TLS", "UCC_CL_HIER_NODE_LEADERS_TLS",
         "UCC_TOPO_FAKE_PPN", "UCC_TOPO_FAKE_NODES_PER_POD")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in KNOBS + ("UCC_TL_SHM_TUNE", "UCC_TL_SOCKET_TUNE", "UCC_GEN"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)


def _untimed(rec):
    """The record less its timings."""
    out = {k: v for k, v in rec.items()
           if k not in ("ctx_create_s", "team_create_s", "wall_s", "cells")}
    out["cells"] = [{k: v for k, v in c.items()
                     if not k.endswith("_p50_us") and k != "hier_speedup"}
                    for c in rec.get("cells", ())]
    return out


@pytest.fixture(scope="module")
def records():
    return scale.run_sim(**ARGS), jscale.run_sim(**ARGS)


def test_record_matches_the_reference(records):
    got, want = records
    assert "error" not in got and "cells_error" not in got
    assert _untimed(got) == _untimed(want)


def test_record_shape(records):
    got, _ = records
    assert got["metric"] == "scale_sim" and got["ranks"] == 16
    assert got["layout"] == {"ppn": "4", "nodes_per_pod": 2}
    assert got["hier_levels"] == 3
    assert got["matrix"] == ["allreduce", "bcast", "reduce", "barrier",
                             "allgather", "allreduce_avg_inplace"]
    assert got["oob"]["ctx"]["levels"] == 2
    assert got["oob"]["ctx"]["max_fanin"] == 4
    cells = got["cells"]
    assert [c["size_bytes"] for c in cells] == [16 << 10, 256 << 10]
    for c in cells:
        assert c["hier_alg"] == "hier/nrab"
        assert c["flat_alg"].startswith("socket/")
        assert c["hier_p50_us"] > 0 and c["flat_p50_us"] > 0
    assert got["wall_s"] > 0


def test_environment_restored_after_a_run(records):
    """The simulated topology's knobs are set around the run only."""
    for k in KNOBS:
        assert k not in os.environ, k


def test_cli_prints_one_record(capsys):
    assert scale.main(["-n", "8", "--ppn", "4", "--npp", "0", "--no-cells",
                       "--json"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["ranks"] == 8 and rec["layout"]["nodes_per_pod"] == 0
    assert "cells" not in rec and len(rec["matrix"]) == 6


@pytest.mark.parametrize("mod", [scale, jscale], ids=["port", "ref"])
def test_cli_failure_is_one_record(capsys, monkeypatch, mod):
    """A simulation that fails while it builds prints one parseable
    record and exits 1, and restores the environment, in both
    packages."""
    def boom(self, *a):
        raise RuntimeError("boom")
    monkeypatch.setattr(mod.ScaleSim, "_build", boom)
    assert mod.main(["-n", "4", "--no-cells", "--json"]) == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == {"metric": "scale_sim", "ranks": 4,
                   "error": "RuntimeError: boom"}
    for k in KNOBS:
        assert k not in os.environ, k
