"""ucc_info in the port (ucc_tpu_torch/tools/info.py) against the JAX
package's (ucc_tpu/tools/info.py).

The cases of tests/test_aux.py::TestInfoAlgorithmListing, the
``tools.info`` uses of tests/test_utils.py (TestInfoScoreMapRows) and
tests/test_ring_dma.py (``test_info_lists_tl``) run on the port. The
host TLs' algorithm lists equal the reference's; the device TLs' equal
it under the TL name map of test_torch_tuner.py (torch_ops for xla,
ring_cuda for ring_dma, whose one algorithm carries the TL's name). The
``-cf`` variables equal the reference's but for the differences listed
in ``CF_DIFFERENCES``. Without a card the device TLs are shown as
unavailable and left out of the probe team; no CPU device stands in
unless ``UCC_TL_RING_CUDA_DEVICE`` asks for ``cpu``.
"""
import re

import pytest

from ucc_tpu.tools import info as jinfo
from ucc_tpu_torch.tools import info

#: the port's TL and algorithm names -> the JAX package's
TL_NAMES = {"torch_ops": "xla", "ring_cuda": "ring_dma"}

#: variables of one package's `ucc_info -cf` that the other has not, and
#: why: the device TLs' tables (one DEVICE for both of the port's device
#: TLs, named after tl/ring_cuda; the JAX package's kinds and probe
#: timeouts name JAX backends, and tl/xla's launch cache bound is a
#: constant of tl/device in the port), tl/torch_ops's short-message bound
#: under its own name, and the profiler's file and log size (the port's
#: profiler writes ucc_profile.json when unset and keeps no log buffer)
CF_DIFFERENCES = {
    "port": {"UCC_TL_RING_CUDA_DEVICE", "UCC_TL_TORCH_OPS_SHORT_MSG_MAX"},
    "ref": {"UCC_TL_RING_DMA_DEVICE_KIND", "UCC_TL_RING_DMA_DEVICE_TIMEOUT",
            "UCC_TL_XLA_DEVICE_KIND", "UCC_TL_XLA_DEVICE_TIMEOUT",
            "UCC_TL_XLA_LAUNCH_CACHE_MAX", "UCC_TL_XLA_SHORT_MSG_MAX",
            "UCC_PROFILE_FILE", "UCC_PROFILE_LOG_SIZE"},
}


#: shared variables whose defaults differ (port, JAX package): the port
#: builds its C core when it can and falls back, and cl/hier's node TLs
#: name the port's default device TL
DEFAULT_DIFFERENCES = {
    "UCC_NATIVE": ("auto", "y"),
    "UCC_CL_HIER_NODE_TLS": ("shm,torch_ops,self", "shm,xla,self"),
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("UCC_TLS", "UCC_TOPO_FAKE_PPN", "UCC_TOPO_FAKE_NODES_PER_POD",
              "UCC_TL_SHM_TUNE", "UCC_GEN", "UCC_QUANT"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def device_cpu(monkeypatch):
    """The device TLs on the CPU, asked for by the variable."""
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")


@pytest.fixture
def no_card(monkeypatch):
    """The default device (cuda) on a machine without one."""
    import torch
    monkeypatch.delenv("UCC_TL_RING_CUDA_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _blocks(text, names=None):
    """{tl name: [lines]} of a ``-A`` listing, TL and algorithm names
    mapped through *names*."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.match(r"cl/basic tl/(\S+):", ln)
        if m:
            cur = (names or {}).get(m.group(1), m.group(1))
            out[cur] = []
        elif cur is not None and ln.strip():
            for a, b in (names or {}).items():
                ln = ln.replace(f":{a}", f":{b}")
            out[cur].append(ln)
    return out


# ---------------------------------------------------------------------------
# -A (tests/test_aux.py::TestInfoAlgorithmListing, test_ring_dma.py:56)
# ---------------------------------------------------------------------------

def test_host_tl_algs_listed(capsys):
    info.print_algorithms()
    out = capsys.readouterr().out
    for needle in ("sra_knomial", "sliding_window", "linear_batched",
                   "sag_knomial", "bruck"):
        assert needle in out, f"missing {needle} in -A output"
    assert "tl/shm" in out and "tl/socket" in out
    assert out.count("(runtime)") < out.count(":")


@pytest.mark.parametrize("tl", ["shm", "socket", "ipc", "self"])
def test_host_tl_lists_match_the_reference(capsys, tl):
    info.print_algorithms()
    got = _blocks(capsys.readouterr().out)
    jinfo.print_algorithms()
    want = _blocks(capsys.readouterr().out)
    assert got[tl] == want[tl] and got[tl]


@pytest.mark.parametrize("tl", ["torch_ops", "ring_cuda"])
def test_device_tl_lists_match_under_the_name_map(capsys, tl):
    info.print_algorithms()
    got = _blocks(capsys.readouterr().out, TL_NAMES)
    jinfo.print_algorithms()
    want = _blocks(capsys.readouterr().out)
    assert got[TL_NAMES[tl]] == want[TL_NAMES[tl]]
    assert sorted(got) == sorted(want)


def test_info_lists_tl(capsys):
    info.print_algorithms()
    out = capsys.readouterr().out
    assert "tl/ring_cuda" in out and "0:ring_cuda" in out


def test_onesided_algs_listed(capsys):
    info.print_algorithms()
    out = capsys.readouterr().out
    assert "sliding_window" in out
    assert "onesided" in out


# ---------------------------------------------------------------------------
# -s (tests/test_utils.py::TestInfoScoreMapRows)
# ---------------------------------------------------------------------------

def _row(out, key):
    return next(ln for ln in out.splitlines() if ln.strip().startswith(key))


def test_device_rows_present(capsys, device_cpu):
    """The rows of the reference's test_round3_rows_present, on CUDA
    memory: scatterv on the default TL, `short` below its bound, the ring
    kernels' TL on bcast and alltoall."""
    info.print_scores()
    out = capsys.readouterr().out
    assert "xla" in _row(out, "scatterv/cuda")
    assert "short" in _row(out, "allreduce/cuda")
    assert "ring_cuda" in _row(out, "bcast/cuda")
    assert "ring_cuda" in _row(out, "alltoall/cuda")


def test_rows_name_serving_component(capsys, device_cpu):
    info.print_scores()
    out = capsys.readouterr().out
    ar = _row(out, "allreduce/host")
    assert "shm/sliding_window:1" in ar
    assert "socket/sliding_window:1" in ar
    entries = _row(out, "allreduce/cuda").split("] ")[1:]
    assert len(entries) == len(set(entries))


def test_host_rows_match_the_reference(capsys, device_cpu):
    """The host rows of a one-rank probe team are the reference's."""
    info.print_scores()
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if "/host" in ln]
    jinfo.print_scores()
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if "/host" in ln]
    assert got == want and got


def test_multirank_probe_shows_hier_rows(capsys, monkeypatch, device_cpu):
    """``ucc_info -s 4`` under UCC_TOPO_FAKE_PPN=2 shows cl/hier's rows,
    the device ones included, and the resolved hierarchy."""
    monkeypatch.setenv("UCC_TOPO_FAKE_PPN", "2")
    info.print_scores(4)
    out = capsys.readouterr().out
    ar = _row(out, "allreduce/cuda")
    assert "hier/rab_tpu" in ar
    assert "hier/split_rail_tpu" in ar
    assert "# resolved hier hierarchy:" in out


def test_probe_without_a_card_leaves_the_device_tls_out(capsys, no_card):
    """No card and the default device: the device TLs are named
    unavailable and the probe team is made without them, so CUDA memory
    has tl/self alone; no CPU device stands in."""
    info.print_scores()
    out = capsys.readouterr().out
    assert "unavailable" in out.splitlines()[0]
    assert "ring_cuda" in out.splitlines()[0]
    ar = _row(out, "allreduce/cuda")
    assert "torch_ops" not in ar and "ring_cuda" not in ar
    assert "self:50" in ar


def test_scores_rejects_team_size_zero():
    with pytest.raises(SystemExit):
        info.main(["-s", "0"])


# ---------------------------------------------------------------------------
# -cf, -v, -c
# ---------------------------------------------------------------------------

def _cf_names(mod, capsys):
    mod.print_config()
    return {ln.split("=", 1)[0] for ln in capsys.readouterr().out.splitlines()
            if ln and not ln.startswith("#")}


def test_config_names_match_the_reference(capsys):
    got, want = _cf_names(info, capsys), _cf_names(jinfo, capsys)
    assert got - want == CF_DIFFERENCES["port"]
    assert want - got == CF_DIFFERENCES["ref"]


@pytest.mark.parametrize("var", [
    "UCC_COLLECT", "UCC_COLLECT_INTERVAL", "UCC_RANK_BIAS_SLOW_MULT",
    "UCC_INTEGRITY", "UCC_FLIGHT", "UCC_NATIVE", "UCC_STATS",
    "UCC_HEARTBEAT_TIMEOUT", "UCC_COALESCE", "UCC_TL_RING_CUDA_DEVICE"])
def test_config_lists_every_table(capsys, var):
    assert var in _cf_names(info, capsys)


def test_config_defaults_match_the_reference(capsys):
    def pairs(mod):
        mod.print_config()
        return dict(ln.split("=", 1) for ln in
                    capsys.readouterr().out.splitlines()
                    if ln and not ln.startswith("#"))
    got, want = pairs(info), pairs(jinfo)
    shared = set(got) & set(want)
    differ = {k: (got[k], want[k]) for k in shared if got[k] != want[k]}
    assert differ == DEFAULT_DIFFERENCES


def test_version_names_components_and_the_device(capsys, no_card):
    assert info.main([]) == 0
    out = capsys.readouterr().out
    assert out.startswith("# UCC-TPU-torch version ")
    assert "CLs: basic, hier" in out
    assert "TLs: ipc, ring_cuda, self, shm, socket, torch_ops" in out
    assert "device TLs (ring_cuda, torch_ops): unavailable" in out


def test_caps_list_cuda_memory(capsys, no_card):
    assert info.main(["-c"]) == 0
    out = capsys.readouterr().out
    assert "# memory types: host, cuda" in out
    assert "# cuda memory device: unavailable" in out
    jinfo.print_caps()
    ref = capsys.readouterr().out
    for key in ("collective types", "datatypes", "reduction ops"):
        assert _row(out, f"# {key}:") == _row(ref, f"# {key}:")


def test_caps_with_the_device_asked_for_cpu(capsys, device_cpu):
    info.print_caps()
    assert "# cuda memory device: cpu" in capsys.readouterr().out
