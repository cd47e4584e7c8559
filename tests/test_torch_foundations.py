"""Foundations of ucc_tpu_torch held against ucc_tpu: enum values, config
defaults, the ring TL's score-map rows, and the rules of the port (no
JAX, nothing of ucc_tpu, no silent fall back to the CPU)."""
import ast
import pathlib
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import ucc_tpu.constants as jc
import ucc_tpu.status as js
from ucc_tpu.cl.basic import CL_BASIC_CONFIG as J_CL_BASIC_CONFIG
from ucc_tpu.core.lib import GLOBAL_CONFIG as J_GLOBAL_CONFIG
from ucc_tpu.tl.ring_dma import TL_RING_DMA_CONFIG, TlRingDma, TlRingDmaTeam
from ucc_tpu.tl.xla import TL_XLA_CONFIG

import ucc_tpu_torch as ut
import ucc_tpu_torch.constants as tc
from ucc_tpu_torch.cl.basic import CL_BASIC_CONFIG
from ucc_tpu_torch.core.lib import GLOBAL_CONFIG
from ucc_tpu_torch.mc.base import detect_mem_type
from ucc_tpu_torch.schedule.schedule import Schedule
from ucc_tpu_torch.schedule.task import CollTask
from ucc_tpu_torch.tl import device as tdev
from ucc_tpu_torch.tl.ring_cuda import (TL_RING_CUDA_CONFIG, TlRingCuda,
                                        TlRingCudaTeam)
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy

PKG = pathlib.Path(ut.__file__).parent
REPO = PKG.parent


# ---------------------------------------------------------------------------
# enums and config tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["CollType", "ReductionOp", "DataType",
                                  "ThreadMode", "CollArgsFlags", "EventType",
                                  "CollSyncType"])
def test_enum_values_match(name):
    want = {m.name: int(m) for m in getattr(jc, name)}
    got = {m.name: int(m) for m in getattr(tc, name)}
    assert got == want


def test_ee_type_values_match_with_the_stream_renamed():
    """EeType keeps the reference's values; the reference's TPU_STREAM is
    UCC's own UCC_EE_CUDA_STREAM in the port."""
    rename = {"TPU_STREAM": "CUDA_STREAM"}
    want = {rename.get(m.name, m.name): int(m) for m in jc.EeType}
    got = {m.name: int(m) for m in tc.EeType}
    assert got == want == {"CUDA_STREAM": 0, "CPU_THREAD": 1, "LAST": 2}


def test_status_values_match():
    want = {m.name: int(m) for m in js.Status}
    got = {m.name: int(m) for m in ut.Status}
    assert got == want


def test_memory_types_keep_the_integer_values():
    M, J = tc.MemoryType, jc.MemoryType
    assert (M.HOST, M.CUDA, M.CUDA_MANAGED, M.UNKNOWN) == \
        (J.HOST, J.TPU, J.TPU_PINNED, J.UNKNOWN)


def test_dtypes_map_to_torch():
    for dt in tc.DataType:
        try:
            nd = jc.dt_numpy(jc.DataType(int(dt)))
        except TypeError:
            continue
        td = tc.dt_torch(dt)
        assert torch.empty(0, dtype=td).element_size() == nd.itemsize
        assert tc.dt_size(dt) == jc.dt_size(jc.DataType(int(dt)))


@pytest.mark.parametrize("port,ref", [
    (GLOBAL_CONFIG, J_GLOBAL_CONFIG),
    (CL_BASIC_CONFIG, J_CL_BASIC_CONFIG),
    (TL_RING_CUDA_CONFIG, TL_RING_DMA_CONFIG),
])
def test_config_defaults_match(port, ref):
    ref_fields = {f.name: f.default for f in ref.fields}
    alias = {"DEVICE": "DEVICE_KIND"}      # port name -> ucc_tpu name
    shared = [f for f in port.fields if alias.get(f.name, f.name) in ref_fields]
    assert shared
    for f in shared:
        if port is TL_RING_CUDA_CONFIG and f.name == "DEVICE":
            # ucc_tpu's empty kind takes JAX's default backend; the port
            # names CUDA, so that it never runs on the CPU unasked
            assert f.default == "cuda" and ref_fields["DEVICE_KIND"] == ""
            continue
        assert f.default == ref_fields[f.name], f.name


def test_launch_cache_bound_matches_tl_xla():
    default = {f.name: f.default for f in TL_XLA_CONFIG.fields}
    assert tdev.LAUNCH_CACHE_MAX == int(default["LAUNCH_CACHE_MAX"])


def test_launch_cache_evicts_oldest_and_replaces_in_place():
    shared = tdev.DeviceTeamShared(("cache-test",), torch.device("cpu"), 2)
    for tag in range(tdev.LAUNCH_CACHE_MAX + 5):
        shared._cache_insert(tag, tag)
    assert len(shared.launch_cache) == tdev.LAUNCH_CACHE_MAX
    assert min(shared.launch_cache) == 5        # the oldest went first
    shared._cache_insert(5, "new")              # a replacement evicts nothing
    assert len(shared.launch_cache) == tdev.LAUNCH_CACHE_MAX
    assert shared.launch_cache[5] == "new" and 6 in shared.launch_cache


# ---------------------------------------------------------------------------
# the ring TL's score-map rows
# ---------------------------------------------------------------------------

def _rows(team_cls, mem, coll):
    team = object.__new__(team_cls)      # scores need no device or mesh
    score = team_cls.get_scores(team)
    ct = (jc if team_cls is TlRingDmaTeam else tc).CollType[coll]
    return [(r.start, r.end, r.score, r.alg_name, r.origin)
            for r in score.ranges[(ct, mem)]]


@pytest.mark.parametrize("coll", ["ALLREDUCE", "REDUCE_SCATTER",
                                  "ALLGATHER", "BCAST", "ALLTOALL"])
@pytest.mark.parametrize("tune", [
    None, "{c}:@{a}:inf", "{c}:0-4k:@{a}:30", "{c}:4k-1m:55#{c}:1m-inf:0"])
def test_ring_tl_score_rows_match(monkeypatch, tune, coll):
    if tune is not None:
        c = coll.lower()
        monkeypatch.setenv("UCC_TL_RING_DMA_TUNE",
                           tune.format(c=c, a="ring_dma"))
        monkeypatch.setenv("UCC_TL_RING_CUDA_TUNE",
                           tune.format(c=c, a="ring_cuda"))
    want = [(s, e, sc, alg.replace("ring_dma", "ring_cuda"), o)
            for s, e, sc, alg, o in _rows(TlRingDmaTeam, jc.MemoryType.TPU,
                                          coll)]
    got = _rows(TlRingCudaTeam, tc.MemoryType.CUDA, coll)
    assert got == want and got
    assert TlRingCuda.DEFAULT_SCORE == TlRingDma.DEFAULT_SCORE == 20


def test_tl_allreduce_selected_on_device_memory():
    assert TlRingCuda.SUPPORTED_MEM_TYPES == (tc.MemoryType.CUDA,)
    assert int(TlRingCuda.SUPPORTED_COLLS) == int(TlRingDma.SUPPORTED_COLLS)


# ---------------------------------------------------------------------------
# small building blocks
# ---------------------------------------------------------------------------

def test_mem_type_detection_by_device():
    assert detect_mem_type(torch.zeros(2)) == tc.MemoryType.HOST
    assert detect_mem_type(np.zeros(2)) == tc.MemoryType.HOST
    assert detect_mem_type(object()) == tc.MemoryType.UNKNOWN


@pytest.mark.parametrize("kind", ["cpu", "cuda"])
def test_memory_component_copies_match_the_reference(kind):
    """memcpy/memset byte semantics of mc/cpu (numpy) and mc/cuda (tensor
    byte views; run on CPU tensors here) against ucc_tpu's mc/cpu."""
    from ucc_tpu.mc.cpu import McCpu as JMcCpu
    from ucc_tpu_torch.mc.base import get_mc
    rng = np.random.default_rng(1)
    src = rng.standard_normal(10).astype(np.float32)
    want = np.zeros(10, np.float32)
    JMcCpu().memcpy(want, src, 22)
    JMcCpu().memset(want, 0xAB, 3)
    mc = get_mc(tc.MemoryType.HOST if kind == "cpu" else tc.MemoryType.CUDA)
    got = np.zeros(10, np.float32) if kind == "cpu" else torch.zeros(10)
    mc.memcpy(got, src if kind == "cpu" else torch.from_numpy(src), 22)
    mc.memset(got, 0xAB, 3)
    got = got if kind == "cpu" else got.numpy()
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, np.int32,
                                   np.float16])
def test_convert_round_trip(dtype):
    arr = (np.arange(11) - 5).astype(dtype)
    t = from_numpy(arr, "cpu")
    back = to_numpy(t)
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back.view(np.uint8), arr.view(np.uint8))


def test_schedule_runs_tasks_in_dependency_order():
    order = []

    class Step(CollTask):
        def __init__(self, name):
            super().__init__()
            self.name = name

        def post_fn(self):
            order.append(self.name)
            self.status = ut.Status.OK
            return ut.Status.OK

    sched = Schedule()
    a, b = Step("a"), Step("b")
    sched.add_task(a)
    sched.add_dep_on_schedule_start(a)
    sched.add_task(b)
    b.subscribe_dep(a, tc.EventType.EVENT_COMPLETED)
    sched.post()
    assert order == ["a", "b"] and sched.super_status == ut.Status.OK


# ---------------------------------------------------------------------------
# rules of the port
# ---------------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_ucc_tpu():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "ucc_tpu"), (path, mod)


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['ucc_tpu'] = None; import ucc_tpu_torch; "
            "from ucc_tpu_torch.tl import ring_cuda, device; "
            "from ucc_tpu_torch.kernels import ring_allreduce, build; "
            "from ucc_tpu_torch.kernels import ring_common, ring_rs_ag; "
            "from ucc_tpu_torch.kernels import ring_bcast_a2a, ec_reduce; "
            "from ucc_tpu_torch.kernels import ring_attention; "
            "from ucc_tpu_torch import fused_attention; "
            "from ucc_tpu_torch.examples import long_context; "
            "from ucc_tpu_torch.ec import base, cpu, cuda; "
            "from ucc_tpu_torch.tools import perftest; "
            "from ucc_tpu_torch.tl import torch_ops; "
            "from ucc_tpu_torch.kernels import gen_device; "
            "from ucc_tpu_torch.dsl import ir, verify, families, registry; "
            "from ucc_tpu_torch.dsl import lower_device; "
            "from ucc_tpu_torch import quant; "
            "from ucc_tpu_torch.core import ee; "
            "from ucc_tpu_torch.obs import metrics; "
            "from ucc_tpu_torch.mc import pool; "
            "from ucc_tpu_torch.schedule import pipelined; "
            "from ucc_tpu_torch.utils import mpool, profiling, mathutils; "
            "from ucc_tpu_torch import native; "
            "from ucc_tpu_torch.tl import shm; "
            "from ucc_tpu_torch.tl.host import (transport, task, team, "
            "config_fields, knomial, knomial2, ring, sra, dbt, allgather, "
            "alltoall, onesided); "
            "from ucc_tpu_torch.tl import sockets, ipc; "
            "from ucc_tpu_torch.core import oob, context; "
            "base.create_executor(ucc_tpu_torch.MemoryType.CUDA); "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


HOST_MODULES = ["tl/shm.py", "native.py", "tl/sockets.py", "tl/ipc.py",
                "core/oob.py", "core/context.py", "tools/perftest.py"] + [
    f"tl/host/{m}.py" for m in ("transport", "task", "config_fields", "team",
                                "knomial", "knomial2", "ring", "sra", "dbt",
                                "allgather", "alltoall", "onesided")] + [
    "../tests/torch_procs.py"]


@pytest.mark.parametrize("rel", HOST_MODULES)
def test_host_modules_stand_alone(rel):
    """The host transports import neither JAX nor the JAX package, and the
    native core is the port's own copy: no module reaches the JAX
    package's native/ directory or its library."""
    path = PKG / rel
    for mod in _imports(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "ucc_tpu"), mod
    text = path.read_text()
    assert "libucc_tpu_core" not in text and "ucc_tpu_core.cc" not in text
    assert "ucc_tpu_ipc.cc" not in text


def test_worker_helper_imports_only_the_port():
    """The spawned workers of the multi-process tests import
    tests/torch_procs.py: the standard library, numpy, torch and the
    port, nothing else of the repo."""
    mods = {m.split(".")[0] for m in _imports(REPO / "tests" /
                                              "torch_procs.py")}
    allowed = {"__future__", "multiprocessing", "os", "socket", "sys",
               "threading", "time", "traceback", "numpy", "torch",
               "ucc_tpu_torch"}
    assert mods <= allowed, mods - allowed


def test_the_arena_builds_into_the_core_library():
    from ucc_tpu_torch import native
    assert pathlib.Path(native._IPC_SRC_PATH) == \
        PKG / "native_src" / "ucc_tpu_torch_ipc.cc"
    assert native._sources() == [native._SRC_PATH, native._IPC_SRC_PATH]
    assert "-lrt" in native.LDLIBS
    assert native.ARENA_PREFIX == "ucc-torch-ipc-"
    # the C surface and ABI are those of the JAX package's arena
    mine = (PKG / "native_src" / "ucc_tpu_torch_ipc.cc").read_text()
    theirs = (REPO / "native" / "ucc_tpu_ipc.cc").read_text()
    body = mine[mine.index("#include <errno.h>"):].replace(
        "ucc_tpu_torch/native.py", "ucc_tpu/native.py")
    assert body == theirs[theirs.index("#include <errno.h>"):]


def test_the_native_core_builds_from_the_port_only():
    from ucc_tpu_torch import native
    assert pathlib.Path(native._SRC_PATH) == \
        PKG / "native_src" / "ucc_tpu_torch_core.cc"
    assert pathlib.Path(native._BUILD_DIR) == PKG / "build"


def test_the_native_source_ships_with_the_package():
    assert (PKG / "native_src" / "ucc_tpu_torch_core.cc").is_file()
    assert (PKG / "native_src" / "ucc_tpu_torch_ipc.cc").is_file()
    assert "ucc_tpu_torch/native_src/*.cc" in \
        (REPO / "MANIFEST.in").read_text().replace("include ", "")
    assert "native_src/*.cc" in (REPO / "pyproject.toml").read_text()


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.delenv("UCC_TL_RING_CUDA_DEVICE", raising=False)
    lib = ut.init()
    if torch.cuda.is_available():
        ctx = ut.Context(lib)
        for tl in ("ring_cuda", "torch_ops"):
            assert ctx.tl_contexts[tl].obj.device == torch.device("cuda", 0)
        ctx.destroy()
    else:
        with pytest.raises(ut.UccError) as ei:
            ut.Context(lib)
        assert ei.value.status == ut.Status.ERR_NO_RESOURCE
        assert "cuda" in str(ei.value)


def test_device_tls_read_one_device_setting(monkeypatch):
    """The ranks of a team hand every device TL the same tensors, so one
    variable places them all."""
    from ucc_tpu_torch.tl.torch_ops import TlTorchOps
    assert TlTorchOps.CONTEXT_CONFIG is TlRingCuda.CONTEXT_CONFIG \
        is tdev.DEVICE_CONFIG
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    ctx = ut.Context(ut.init())
    for tl in ("ring_cuda", "torch_ops"):
        assert ctx.tl_contexts[tl].obj.device == torch.device("cpu")
    ctx.destroy()


def test_cpu_device_runs_a_one_rank_allreduce(monkeypatch):
    """Through a device TL: tl/self, which takes any 1-rank collective, is
    left out."""
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    ctx = ut.Context(ut.init(TLS="ring_cuda,torch_ops"))
    team = ctx.create_team(ut.TeamParams())
    src = torch.arange(5, dtype=torch.float32)
    dst = torch.zeros(5)
    req = team.collective_init(ut.CollArgs(
        coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.SUM,
        src=ut.BufferInfo(src, 5, ut.DataType.FLOAT32,
                          mem_type=ut.MemoryType.CUDA),
        dst=ut.BufferInfo(dst, 5, ut.DataType.FLOAT32,
                          mem_type=ut.MemoryType.CUDA)))
    req.post()
    assert req.wait() == ut.Status.OK
    assert torch.equal(dst, src)
    req.finalize()
    team.destroy()
    ctx.destroy()


def test_unsupported_collectives_have_no_candidate(monkeypatch):
    """Without tl/self, which takes every 1-rank collective: HOST memory
    (no host TL is ported) and a bitwise op on floats (tl/torch_ops
    refuses it, tl/ring_cuda takes no such op)."""
    monkeypatch.setenv("UCC_TL_RING_CUDA_DEVICE", "cpu")
    ctx = ut.Context(ut.init(TLS="ring_cuda,torch_ops"))
    team = ctx.create_team(ut.TeamParams())
    buf = torch.zeros(4)
    with pytest.raises(ut.UccError) as ei:
        team.collective_init(ut.CollArgs(
            coll_type=ut.CollType.REDUCE, op=ut.ReductionOp.SUM,
            src=ut.BufferInfo(buf, 4, ut.DataType.FLOAT32,
                              mem_type=ut.MemoryType.HOST),
            dst=ut.BufferInfo(buf.clone(), 4, ut.DataType.FLOAT32,
                              mem_type=ut.MemoryType.HOST)))
    assert ei.value.status == ut.Status.ERR_NOT_SUPPORTED
    with pytest.raises(ut.UccError) as ei:
        team.collective_init(ut.CollArgs(
            coll_type=ut.CollType.ALLREDUCE, op=ut.ReductionOp.BXOR,
            src=ut.BufferInfo(buf, 4, ut.DataType.FLOAT32,
                              mem_type=ut.MemoryType.CUDA),
            dst=ut.BufferInfo(buf.clone(), 4, ut.DataType.FLOAT32,
                              mem_type=ut.MemoryType.CUDA)))
    assert ei.value.status == ut.Status.ERR_NOT_SUPPORTED
    team.destroy()
    ctx.destroy()
