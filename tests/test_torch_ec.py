"""The port's execution components held against ucc_tpu's: the reduce
kernel's plain version ``ec_reduce_ref`` and ``EcCuda`` (on CPU tensors,
where it runs that plain version) bitwise against ``EcTpu`` in Pallas
interpret mode; the 64-bit types, which EcTpu cannot run, bitwise against
``ucc_tpu.ec.cpu.reduce_arrays``; the port's ``EcCpu`` against
``ucc_tpu.ec.cpu.EcCpu``. Inputs come from numpy with a seed."""
import itertools

import ml_dtypes
import numpy as np
import pytest
import torch

import ucc_tpu.constants as jc
from ucc_tpu.ec.base import create_executor as j_create_executor
from ucc_tpu.ec.cpu import EcCpu as JEcCpu
from ucc_tpu.ec.cpu import reduce_arrays as j_reduce_arrays
from ucc_tpu.status import Status as JStatus

from ucc_tpu_torch import DataType, MemoryType, ReductionOp, Status, UccError
from ucc_tpu_torch.constants import GenericDataType
from ucc_tpu_torch.ec import base as ec_base
from ucc_tpu_torch.ec.cpu import EcCpu, reduce_arrays
from ucc_tpu_torch.ec.cuda import EcCuda
from ucc_tpu_torch.kernels import ec_reduce as ker
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy

NP = {"INT8": np.int8, "UINT8": np.uint8, "INT16": np.int16,
      "UINT16": np.uint16, "INT32": np.int32, "UINT32": np.uint32,
      "INT64": np.int64, "UINT64": np.uint64, "FLOAT16": np.float16,
      "BFLOAT16": ml_dtypes.bfloat16, "FLOAT32": np.float32,
      "FLOAT64": np.float64}
#: the types EcTpu computes (tier-1 runs JAX with x64 off)
DTYPES = ["INT8", "UINT8", "INT16", "UINT16", "INT32", "UINT32", "FLOAT16",
          "BFLOAT16", "FLOAT32"]
WIDE = ["INT64", "UINT64", "FLOAT64"]
FLOATS = ("FLOAT16", "BFLOAT16", "FLOAT32", "FLOAT64")
OPS = ["SUM", "PROD", "MAX", "MIN", "LAND", "LOR", "LXOR", "BAND", "BOR",
       "BXOR", "AVG"]
BITWISE = ("BAND", "BOR", "BXOR")
KS = (1, 2, 5, 9)
#: 65541 elements are 520 rows of 128 in EcTpu: two grid tiles of 512 rows,
#: the last one ragged
COUNTS = (7, 1000, 65541)
ALPHAS = (None, 0.25)


def _valid(dt, op):
    return not (dt in FLOATS and op in BITWISE)


def covering_cases():
    """(dtype, op, k, count, alpha) cases in which every pair of values of
    two factors meets, but for dtype and op (test_every_dtype_and_op runs
    those): greedy, deterministic, 44 cases. Each case compiles one Pallas
    program, 0.05-0.3 s in interpret mode."""
    cands = [c for c in itertools.product(DTYPES, OPS, KS, COUNTS, ALPHAS)
             if _valid(c[0], c[1])]
    factor_pairs = [(i, j) for i, j in itertools.combinations(range(5), 2)
                    if (i, j) != (0, 1)]

    def pairs(c):
        return {(i, j, c[i], c[j]) for i, j in factor_pairs}

    need = set().union(*(pairs(c) for c in cands))
    out = []
    while need:
        best = max(cands, key=lambda c: len(pairs(c) & need))
        out.append(best)
        need -= pairs(best)
    return out


COVERING = covering_cases()


def make_inputs(dt, op, k, count, seed):
    """k sources: integers in a range that overflows on SUM/PROD (both
    sides wrap), normal floats with a NaN for MAX/MIN, a third zeros for
    the logical ops. No -0.0 anywhere: which zero MAX/MIN keep is not
    pinned by the reference."""
    rng = np.random.default_rng(seed)
    nd = np.dtype(NP[dt])
    srcs = []
    for _ in range(k):
        if dt in FLOATS:
            a = rng.standard_normal(count).astype(nd)
        elif dt in ("INT64", "UINT64"):
            a = rng.integers(0, 1 << 64, count, dtype=np.uint64).view(nd)
        else:
            info = np.iinfo(nd)
            a = rng.integers(info.min, int(info.max) + 1, count).astype(nd)
        if op in ("LAND", "LOR", "LXOR"):
            a[rng.random(count) < 0.3] = 0
        srcs.append(a)
    if op in ("MAX", "MIN") and dt in FLOATS and count > 3:
        srcs[-1][3] = np.nan        # must propagate, not be dropped
        srcs[0][2] = np.nan
    return srcs


def bits_equal(got: np.ndarray, want: np.ndarray) -> bool:
    """Bitwise equality, NaN positions compared as NaN (the NaN payload a
    cast produces is not pinned)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype.itemsize != want.dtype.itemsize:
        return False
    if got.dtype.kind == "f" or got.dtype == ml_dtypes.bfloat16:
        gn = np.isnan(got.astype(np.float32))
        wn = np.isnan(want.astype(np.float32))
        if not np.array_equal(gn, wn):
            return False
        got, want = got[~gn], want[~wn]
    return np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.fixture(scope="module")
def jec():
    return j_create_executor(jc.MemoryType.TPU)


def j_reduce(jec, srcs, count, dt, op, alpha):
    t = jec.reduce(None, srcs, count, jc.DataType[dt], jc.ReductionOp[op],
                   alpha)
    while jec.task_test(t) == JStatus.IN_PROGRESS:
        pass
    assert t.status == JStatus.OK
    return np.asarray(t.array)


def port_results(srcs, count, dt, op, alpha):
    """(plain version, EcCuda on CPU tensors) as numpy arrays."""
    ts = [from_numpy(s, "cpu") for s in srcs]
    ref = ker.ec_reduce_ref(ts, count, DataType[dt], ReductionOp[op], alpha)
    dst = torch.full((count,), 7, dtype=ref.dtype)
    launches = ker.ec_reduce.launches
    ec = EcCuda()
    t = ec.reduce(dst, ts, count, DataType[dt], ReductionOp[op], alpha)
    assert ec.task_test(t) == Status.OK and t.array is dst
    assert ker.ec_reduce.launches == launches     # a CPU call is no launch
    return to_numpy(ref), to_numpy(dst)


# ---------------------------------------------------------------------------
# the kernel's plain version and EcCuda against EcTpu (Pallas, interpret)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt,op,k,count,alpha", COVERING)
def test_matches_pallas_ec(jec, dt, op, k, count, alpha):
    srcs = make_inputs(dt, op, k, count,
                       seed=100 * DTYPES.index(dt) + 10 * OPS.index(op) + k)
    want = j_reduce(jec, srcs, count, dt, op, alpha)
    ref, got = port_results(srcs, count, dt, op, alpha)
    assert bits_equal(ref, want)
    assert bits_equal(got, want)


@pytest.mark.parametrize("dt,op", [(d, o) for d in DTYPES for o in OPS
                                   if _valid(d, o)])
def test_every_dtype_and_op(jec, dt, op):
    srcs = make_inputs(dt, op, 3, 300, seed=len(dt) * 31 + OPS.index(op))
    want = j_reduce(jec, srcs, 300, dt, op, None)
    ref, got = port_results(srcs, 300, dt, op, None)
    assert bits_equal(ref, want) and bits_equal(got, want)


def test_covering_set_meets_every_pair():
    assert len(COVERING) <= 50
    factors = (DTYPES, OPS, KS, COUNTS, ALPHAS)
    for i, j in itertools.combinations(range(5), 2):
        if (i, j) != (0, 1):
            seen = {(c[i], c[j]) for c in COVERING}
            assert seen == set(itertools.product(factors[i], factors[j]))


def test_reference_quirks(jec):
    """What the JAX executor computes, pinned as literals: MAX propagates
    NaN, LAND over one source returns it unchanged, an integer reduce with
    alpha computes in float32 and truncates toward zero."""
    cases = [
        ("FLOAT32", "MAX", [np.array([np.nan, 1, 2, 3], np.float32),
                            np.array([1, np.nan, 1, 1], np.float32)], None,
         np.array([np.nan, np.nan, 2, 3], np.float32)),
        ("FLOAT32", "MIN", [np.array([np.nan, 1, 2, 3], np.float32),
                            np.array([1, np.nan, 1, 1], np.float32)], None,
         np.array([np.nan, np.nan, 1, 1], np.float32)),
        ("INT32", "LAND", [np.array([3, 0, 5, 7], np.int32)], None,
         np.array([3, 0, 5, 7], np.int32)),
        ("INT32", "LAND", [np.array([3, 0, 5, 7], np.int32),
                           np.array([1, 1, 0, 2], np.int32)], None,
         np.array([1, 0, 0, 1], np.int32)),
        ("INT32", "SUM", [np.array([21, 27, 33, 39], np.int32)], 0.5,
         np.array([10, 13, 16, 19], np.int32)),
        ("INT32", "SUM", [np.array([-21, 27, -33, 39], np.int32)], 0.5,
         np.array([-10, 13, -16, 19], np.int32)),
    ]
    for dt, op, srcs, alpha, literal in cases:
        want = j_reduce(jec, srcs, 4, dt, op, alpha)
        ref, got = port_results(srcs, 4, dt, op, alpha)
        for x in (want, ref, got):
            assert bits_equal(x, literal), (dt, op, x)


def test_bf16_accumulates_in_f32(jec):
    srcs = [np.full(256, 0.1, dtype=ml_dtypes.bfloat16) for _ in range(8)]
    want = j_reduce(jec, srcs, 256, "BFLOAT16", "SUM", None)
    ref, got = port_results(srcs, 256, "BFLOAT16", "SUM", None)
    assert bits_equal(ref, want) and bits_equal(got, want)
    np.testing.assert_allclose(got.astype(np.float32), 0.80078, rtol=3e-3)


# ---------------------------------------------------------------------------
# 64-bit types against reduce_arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt,op", [(d, o) for d in WIDE for o in OPS
                                   if _valid(d, o)])
def test_64bit_matches_reduce_arrays(dt, op):
    """EcTpu raises for 64-bit types with x64 off (its _pad_stack casts to
    32 bits); the port computes them natively and holds them bitwise to
    ucc_tpu's host reduce, float64 included (source order, as np.sum
    along axis 0). 0.75 sends uint64 results past 2^63."""
    for k, alpha in itertools.product((1, 2, 9), (None, 0.75)):
        srcs = make_inputs(dt, op, k, 513, seed=k * 7 + len(op))
        want = j_reduce_arrays([s.copy() for s in srcs], jc.ReductionOp[op],
                               jc.DataType[dt], alpha)
        ref, got = port_results(srcs, 513, dt, op, alpha)
        assert bits_equal(ref, want), (k, alpha)
        assert bits_equal(got, want), (k, alpha)


def test_ec_tpu_refuses_64bit(jec):
    with pytest.raises(ValueError, match="Invalid dtype"):
        j_reduce(jec, [np.ones(8, np.float64)] * 2, 8, "FLOAT64", "SUM",
                 None)


# ---------------------------------------------------------------------------
# the other task types against EcTpu
# ---------------------------------------------------------------------------

def _poll(ec, t, status):
    while ec.task_test(t) == status.IN_PROGRESS:
        pass
    return t


@pytest.mark.parametrize("dt", ["FLOAT32", "INT32"])
@pytest.mark.parametrize("op", ["MINLOC", "MAXLOC"])
def test_loc_ops_match(jec, dt, op):
    rng = np.random.default_rng(5)
    pairs = 64
    srcs = []
    for r in range(4):
        a = np.empty(2 * pairs, NP[dt])
        a[0::2] = rng.integers(0, 6, pairs)       # many ties
        a[1::2] = rng.integers(0, 50, pairs)
        srcs.append(a)
    want = j_reduce(jec, srcs, 2 * pairs, dt, op, None)
    ec = EcCuda()
    t = _poll(ec, ec.reduce(None, [from_numpy(s, "cpu") for s in srcs],
                            2 * pairs, DataType[dt], ReductionOp[op]),
              Status)
    assert bits_equal(to_numpy(t.array), want)
    dst = torch.zeros(2 * pairs, dtype=t.array.dtype)
    _poll(ec, ec.reduce(dst, [from_numpy(s, "cpu") for s in srcs],
                        2 * pairs, DataType[dt], ReductionOp[op]), Status)
    assert bits_equal(to_numpy(dst), want)


@pytest.mark.parametrize("dt", ["FLOAT32", "BFLOAT16", "INT16"])
def test_reduce_strided_at_an_odd_offset(jec, dt):
    """Sources at base + i*stride, the base itself one element into its
    buffer: EcCuda hands the kernel these views, with no copies."""
    count, n_src2, stride = 1001, 4, 1003
    rng = np.random.default_rng(9)
    big = rng.standard_normal(1 + stride * n_src2).astype(NP[dt])
    src1 = rng.standard_normal(count).astype(NP[dt])
    esz = np.dtype(NP[dt]).itemsize
    jt = _poll(jec, jec.reduce_strided(None, src1, big[1:], stride * esz,
                                       n_src2, count, jc.DataType[dt],
                                       jc.ReductionOp.SUM, 0.25), JStatus)
    base = from_numpy(big, "cpu")[1:]
    assert base.storage_offset() == 1
    dst = torch.empty(count, dtype=base.dtype)
    ec = EcCuda()
    t = _poll(ec, ec.reduce_strided(dst, from_numpy(src1, "cpu"), base,
                                    stride * esz, n_src2, count,
                                    DataType[dt], ReductionOp.SUM, 0.25),
              Status)
    assert t.array is dst
    assert bits_equal(to_numpy(dst), np.asarray(jt.array))
    with pytest.raises(UccError) as ei:
        ec.reduce_strided(dst, from_numpy(src1, "cpu"), base,
                          stride * esz + 1, n_src2, count, DataType[dt],
                          ReductionOp.SUM)
    assert ei.value.status == Status.ERR_INVALID_PARAM


def test_reduce_multi_dst_matches(jec):
    rng = np.random.default_rng(11)
    jobs_np = [dict(src1=rng.standard_normal(100 + 9 * i).astype(np.float32),
                    src2=rng.standard_normal(100 + 9 * i).astype(np.float32),
                    count=100 + 9 * i, op=("SUM", "MAX", "PROD")[i % 3],
                    alpha=0.5 if i == 3 else None) for i in range(7)]
    jt = _poll(jec, jec.reduce_multi_dst([
        dict(dst=None, src1=j["src1"], src2=j["src2"], count=j["count"],
             dt=jc.DataType.FLOAT32, op=jc.ReductionOp[j["op"]],
             alpha=j["alpha"]) for j in jobs_np]), JStatus)
    dsts = [torch.zeros(j["count"]) for j in jobs_np]
    ec = EcCuda()
    t = _poll(ec, ec.reduce_multi_dst([
        dict(dst=d, src1=from_numpy(j["src1"], "cpu"),
             src2=from_numpy(j["src2"], "cpu"), count=j["count"],
             dt=DataType.FLOAT32, op=ReductionOp[j["op"]], alpha=j["alpha"])
        for d, j in zip(dsts, jobs_np)]), Status)
    assert t.array == dsts
    for d, w in zip(dsts, jt.array):
        assert bits_equal(to_numpy(d), np.asarray(w))
    eight = [dict(dst=None, src1=torch.ones(4), src2=torch.ones(4), count=4,
                  dt=DataType.FLOAT32, op=ReductionOp.SUM)] * 8
    with pytest.raises(UccError) as ei:
        ec.reduce_multi_dst(eight)
    assert ei.value.status == Status.ERR_INVALID_PARAM
    with pytest.raises(Exception):
        jec.reduce_multi_dst([dict(j, dt=jc.DataType.FLOAT32,
                                   op=jc.ReductionOp.SUM) for j in eight])


def test_copy_and_copy_multi_match(jec):
    src = np.arange(32, dtype=np.int32)
    jt = _poll(jec, jec.copy(None, src, src.nbytes), JStatus)
    ec = EcCuda()
    t = _poll(ec, ec.copy(None, from_numpy(src, "cpu"), src.nbytes), Status)
    assert bits_equal(to_numpy(t.array), np.asarray(jt.array))
    dst = torch.zeros(32, dtype=torch.int32)
    t = _poll(ec, ec.copy(dst, from_numpy(src, "cpu"), 40), Status)
    assert t.array is dst
    assert to_numpy(dst)[:10].tolist() == list(range(10))
    assert not to_numpy(dst)[10:].any()
    srcs = [np.arange(8, dtype=np.float32) * i for i in range(7)]
    jt = _poll(jec, jec.copy_multi([(None, s, s.nbytes) for s in srcs]),
               JStatus)
    dsts = [torch.zeros(8) for _ in srcs]
    t = _poll(ec, ec.copy_multi([(d, from_numpy(s, "cpu"), s.nbytes)
                                 for d, s in zip(dsts, srcs)]), Status)
    assert t.array == dsts
    for d, w in zip(dsts, jt.array):
        assert bits_equal(to_numpy(d), np.asarray(w))


def test_copy_capacity_and_multi_caps(jec):
    """More bytes than dst holds is ERR_INVALID_PARAM in both executors;
    so are 8 copy_multi pairs."""
    with pytest.raises(Exception) as je:
        jec.copy(np.zeros(4, np.float32), np.zeros(8, np.float32), 32)
    assert je.value.status == JStatus.ERR_INVALID_PARAM
    ec = EcCuda()
    with pytest.raises(UccError) as ei:
        ec.copy(torch.zeros(4), torch.zeros(8), 32)
    assert ei.value.status == Status.ERR_INVALID_PARAM
    pairs = [(torch.zeros(2), torch.ones(2), 8)] * 8
    with pytest.raises(UccError) as ei:
        ec.copy_multi(pairs)
    assert ei.value.status == Status.ERR_INVALID_PARAM
    with pytest.raises(Exception) as je:
        jec.copy_multi([(None, np.ones(2, np.float32), 8)] * 8)
    assert je.value.status == JStatus.ERR_INVALID_PARAM


def test_caps_and_refusals(jec):
    """10 sources are ERR_INVALID_PARAM (the wrapper, EcCuda and EcTpu);
    a bitwise op on a float, a complex or 128-bit type, ERR_NOT_SUPPORTED
    (EcTpu's jnp raises a TypeError for the bitwise float op)."""
    ten = [torch.ones(4)] * 10
    ec = EcCuda()
    for call in (lambda: ec.reduce(None, ten, 4, DataType.FLOAT32,
                                   ReductionOp.SUM),
                 lambda: ker.ec_reduce(torch.ones(4), ten, 4,
                                       DataType.FLOAT32, ReductionOp.SUM)):
        with pytest.raises(UccError) as ei:
            call()
        assert ei.value.status == Status.ERR_INVALID_PARAM
    with pytest.raises(Exception) as je:
        jec.reduce(None, [np.ones(4, np.float32)] * 10, 4,
                   jc.DataType.FLOAT32, jc.ReductionOp.SUM)
    assert je.value.status == JStatus.ERR_INVALID_PARAM
    for dt, op in ((DataType.FLOAT32, ReductionOp.BAND),
                   (DataType.BFLOAT16, ReductionOp.BXOR),
                   (DataType.FLOAT32_COMPLEX, ReductionOp.SUM),
                   (DataType.FLOAT128, ReductionOp.SUM)):
        with pytest.raises(UccError) as ei:
            ec.reduce(None, [torch.ones(4)] * 2, 4, dt, op)
        assert ei.value.status == Status.ERR_NOT_SUPPORTED
    with pytest.raises(TypeError):
        j_reduce(jec, [np.ones(8, np.float32)] * 2, 8, "FLOAT32", "BAND",
                 None)


def test_other_devices_raise():
    """No silent fallback: a tensor on a device other than cuda or cpu
    raises, in the wrapper and the executor."""
    meta = [torch.empty(8, device="meta") for _ in range(3)]
    with pytest.raises(UccError) as ei:
        ker.ec_reduce(meta[0], meta[1:], 8, DataType.FLOAT32,
                      ReductionOp.SUM)
    assert ei.value.status == Status.ERR_NOT_SUPPORTED
    with pytest.raises(UccError) as ei:
        EcCuda().reduce(meta[0], meta[1:], 8, DataType.FLOAT32,
                        ReductionOp.SUM)
    assert ei.value.status == Status.ERR_NOT_SUPPORTED
    with pytest.raises(UccError):
        ker.ec_reduce(torch.ones(8), [torch.ones(8, dtype=torch.float64)],
                      8, DataType.FLOAT32, ReductionOp.SUM)


def test_in_place_reduce():
    srcs = [torch.arange(10, dtype=torch.float32) * (i + 1) for i in range(3)]
    want = ker.ec_reduce_ref(srcs, 10, DataType.FLOAT32, ReductionOp.SUM)
    ker.ec_reduce(srcs[0], srcs, 10, DataType.FLOAT32, ReductionOp.SUM)
    assert torch.equal(srcs[0], want)


def test_create_executor_by_memory_type():
    assert type(ec_base.create_executor(MemoryType.HOST)) is EcCpu
    assert type(ec_base.create_executor(MemoryType.CUDA)) is EcCuda
    assert EcCuda.EC_NAME == "cuda"
    with pytest.raises(UccError) as ei:
        ec_base.create_executor(MemoryType.CUDA_MANAGED)
    assert ei.value.status == Status.ERR_NOT_FOUND
    assert (ec_base.EXECUTOR_NUM_BUFS, ec_base.MULTI_OP_NUM_BUFS) == (9, 7)


# ---------------------------------------------------------------------------
# the port's EcCpu against ucc_tpu's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["SUM", "PROD", "MAX", "MIN", "BAND", "BXOR",
                                "LAND"])
def test_ec_cpu_reduce_int(op):
    srcs = [np.arange(1, 33, dtype=np.int32) + i for i in range(3)]
    want = np.zeros(32, np.int32)
    JEcCpu().reduce(want, srcs, 32, jc.DataType.INT32, jc.ReductionOp[op])
    got = np.zeros(32, np.int32)
    EcCpu().reduce(got, srcs, 32, DataType.INT32, ReductionOp[op])
    assert bits_equal(got, want)
    tensor_dst = torch.zeros(32, dtype=torch.int32)
    EcCpu().reduce(tensor_dst, [torch.from_numpy(s) for s in srcs], 32,
                   DataType.INT32, ReductionOp[op])
    assert bits_equal(tensor_dst.numpy(), want)


@pytest.mark.parametrize("dt", ["FLOAT32", "FLOAT16", "BFLOAT16", "INT32",
                                "UINT64", "FLOAT64"])
@pytest.mark.parametrize("op", ["SUM", "AVG", "MAX", "LOR", "LXOR",
                                "MINLOC"])
def test_ec_cpu_matches_reference(dt, op):
    """reduce_arrays and EcCpu.reduce with alpha, over the half types
    (bfloat16 as its uint16 bit pattern here) and the wide ones."""
    srcs = make_inputs(dt, op, 3, 64, seed=3)
    alpha = 0.25 if op == "AVG" else None
    want = np.zeros(64, NP[dt])
    JEcCpu().reduce(want, srcs, 64, jc.DataType[dt], jc.ReductionOp[op],
                    alpha)
    storage = [s.view(np.uint16) if dt == "BFLOAT16" else s for s in srcs]
    got = reduce_arrays(storage, ReductionOp[op], DataType[dt], alpha)
    assert bits_equal(got.view(want.dtype), want)
    dst = torch.zeros(64, dtype=from_numpy(srcs[0], "cpu").dtype)
    EcCpu().reduce(dst, [from_numpy(s, "cpu") for s in srcs], 64,
                   DataType[dt], ReductionOp[op], alpha)
    assert bits_equal(to_numpy(dst), want)


def test_ec_cpu_avg_strided_caps():
    srcs = [np.ones(8, np.float32) * (i + 1) for i in range(4)]
    dst = np.zeros(8, np.float32)
    EcCpu().reduce(dst, srcs, 8, DataType.FLOAT32, ReductionOp.AVG,
                   alpha=0.25)
    np.testing.assert_allclose(dst, 2.5)
    src1 = np.ones(4, np.float32)
    base = np.arange(12, dtype=np.float32)
    want, got = np.zeros(4, np.float32), np.zeros(4, np.float32)
    JEcCpu().reduce_strided(want, src1, base, 16, 3, 4, jc.DataType.FLOAT32,
                            jc.ReductionOp.SUM)
    EcCpu().reduce_strided(got, src1, base, 16, 3, 4, DataType.FLOAT32,
                           ReductionOp.SUM)
    assert bits_equal(got, want)
    with pytest.raises(UccError):
        EcCpu().reduce(np.zeros(2, np.float32), [np.ones(2, np.float32)] * 10,
                       2, DataType.FLOAT32, ReductionOp.SUM)
    with pytest.raises(UccError) as ei:
        EcCpu().reduce(np.zeros(2, np.float32), [np.ones(2, np.float32)] * 2,
                       2, DataType.FLOAT32, ReductionOp.BAND)
    assert ei.value.status == Status.ERR_NOT_SUPPORTED


def test_ec_cpu_out_path_matches():
    """reduce_arrays(out=): the result lands in out, a wider f32 out keeps
    full precision, as ucc_tpu's does."""
    rng = np.random.default_rng(4)
    srcs = [rng.standard_normal(50).astype(np.float32) for _ in range(3)]
    for op in ("SUM", "MAX"):
        want, got = np.empty(50, np.float32), np.empty(50, np.float32)
        j_reduce_arrays(srcs, jc.ReductionOp[op], jc.DataType.FLOAT32,
                        out=want)
        assert reduce_arrays(srcs, ReductionOp[op], DataType.FLOAT32,
                             out=got) is got
        assert bits_equal(got, want)
    halves = [s.astype(np.float16) for s in srcs]
    want, got = np.empty(50, np.float32), np.empty(50, np.float32)
    j_reduce_arrays(halves, jc.ReductionOp.SUM, jc.DataType.FLOAT16,
                    out=want)
    reduce_arrays(halves, ReductionOp.SUM, DataType.FLOAT16, out=got)
    assert bits_equal(got, want)


def test_ec_cpu_generic_datatype():
    from ucc_tpu.constants import GenericDataType as JGeneric

    def reduce_cb(a: bytes, b: bytes, count: int) -> bytes:
        return (np.frombuffer(a, np.float32) +
                np.frombuffer(b, np.float32)).tobytes()

    srcs = [np.full(4, float(i + 1), np.float32) for i in range(3)]
    want, got = np.zeros(4, np.float32), np.zeros(4, np.float32)
    JEcCpu().reduce(want, srcs, 2, JGeneric(8, reduce_cb=reduce_cb),
                    jc.ReductionOp.SUM)
    EcCpu().reduce(got, srcs, 2, GenericDataType(8, reduce_cb=reduce_cb),
                   ReductionOp.SUM)
    assert bits_equal(got, want)
    with pytest.raises(UccError):
        EcCpu().reduce(np.zeros(8, np.uint8), [np.zeros(8, np.uint8)] * 2,
                       1, GenericDataType(8), ReductionOp.SUM)


def test_ec_cpu_copies():
    src = np.arange(16, dtype=np.int64)
    dst = torch.zeros(16, dtype=torch.int64)
    t = EcCpu().copy(dst, src, 64)
    assert t.status == Status.OK
    assert dst[:8].tolist() == list(range(8)) and not dst[8:].any()
    with pytest.raises(UccError):
        EcCpu().copy_multi([(np.zeros(2), np.ones(2), 16)] * 8)


# ---------------------------------------------------------------------------
# the kernel's walk (csrc/ec_reduce.cu)
# ---------------------------------------------------------------------------

def _ec_source():
    import os
    from ucc_tpu_torch.kernels import build
    with open(os.path.join(build.CSRC, ker.SOURCE)) as fh:
        return fh.read()


def _ec_constant(text, name):
    import re
    hit = re.search(rf"constexpr int {name} = (\d+);", text)
    assert hit, f"{name} is no longer a constexpr of {ker.SOURCE}"
    return int(hit.group(1))


EC_TEXT = _ec_source()
#: vectors of each source a thread loads before it folds them, the sources
#: the k loop is unrolled to, threads per block
EC_DEPTH = _ec_constant(EC_TEXT, "kDepth")
EC_MAX_SRCS = _ec_constant(EC_TEXT, "kMaxSrcs")
EC_THREADS = _ec_constant(EC_TEXT, "kThreads")


def ec_walk(count, esz, addrs, cap_blocks, threads=EC_THREADS,
            depth=EC_DEPTH):
    """A launch's path and each thread's steps in program order, as the
    source has them: *addrs* are the byte addresses (mod 16 is what
    counts) of dst, then the k sources. Returns (vector path, steps),
    a step ("vec", [first elements of its vectors]) loaded together and
    then folded and stored, or ("elem", i)."""
    mis = addrs[0] % 16
    vec = mis % esz == 0 and all(a % 16 == mis for a in addrs[1:])
    w = 16 // esz
    if vec:
        head = min(count, (16 - mis) % 16 // esz)
        vecs = (count - head) // w
        items = max(1, -(-vecs // depth))
    else:
        head = vecs = 0
        items = count
    stride = min(cap_blocks, -(-items // threads)) * threads
    tail = head + vecs * w
    steps = []
    for first in range(stride):
        if not vec:
            steps += [("elem", i) for i in range(first, count, stride)]
            continue
        for u in range(first, vecs, depth * stride):
            steps.append(("vec", [head + (u + d * stride) * w
                                  for d in range(depth)
                                  if u + d * stride < vecs]))
        steps += [("elem", i) for i in range(first, head, stride)]
        steps += [("elem", i) for i in range(tail + first, count, stride)]
    return vec, steps


def ec_model(dst, srcs, count, dt, op, alpha, addrs, cap_blocks=3,
             threads=32):
    """The kernel on CPU tensors: each step reads its elements of every
    source, folds them with the plain version's rules (elementwise, so a
    slice folds as the whole does) and only then writes dst, which may be a
    source. Returns (vector path, writes per element)."""
    td = ker.check_args(count, dt, op, len(srcs))
    esz = torch.empty(0, dtype=td).element_size()
    vec, steps = ec_walk(count, esz, addrs, cap_blocks, threads)
    written = torch.zeros(count, dtype=torch.int64)
    flat = [s.reshape(-1) for s in srcs]
    # torch writes unsigned 16-64 bit tensors through their signed view
    signed = ker._SIGNED.get(td, td)
    out = dst.reshape(-1).view(signed)
    for kind, at in steps:
        idx = torch.tensor([at]) if kind == "elem" else torch.cat(
            [torch.arange(e, e + 16 // esz) for e in at])
        got = ker._reduce_ref([f[idx] for f in flat], len(idx), td, op,
                              alpha)
        out[idx] = got.view(signed)
        written[idx] += 1
    return vec, written


def check_ec_model(dt, op, k, count, alpha, offsets, seed, inplace=False,
                   **kw):
    """Sources (and dst) as views at *offsets* elements into buffers of
    their own; the model bitwise ec_reduce_ref, every element written
    once. Returns whether the launch took the vector path."""
    base = make_inputs(dt, op, k + 1, count + 16, seed)
    ts = [from_numpy(b, "cpu") for b in base]
    srcs = [t[o:o + count] for t, o in zip(ts[1:], offsets[1:])]
    esz = ts[0].element_size()
    want = ker.ec_reduce_ref(srcs, count, DataType[dt], ReductionOp[op],
                             alpha)
    dst = srcs[0] if inplace else ts[0][offsets[0]:offsets[0] + count]
    addrs = [esz * o for o in offsets]
    vec, written = ec_model(dst, srcs, count, DataType[dt], ReductionOp[op],
                            alpha, addrs, **kw)
    assert torch.equal(written, torch.ones_like(written))
    assert bits_equal(to_numpy(dst), to_numpy(want))
    return vec


@pytest.mark.parametrize("dt,op,alpha", [
    ("FLOAT32", "SUM", None), ("BFLOAT16", "AVG", 0.25),
    ("FLOAT16", "MAX", None), ("INT8", "LXOR", None),
    ("UINT16", "MIN", None), ("FLOAT64", "PROD", 0.25),
    ("INT64", "BXOR", None), ("INT32", "LAND", None)])
def test_walk_heads_and_tails_across_alignment_classes(dt, op, alpha):
    """Every offset mod 16 that an element of the type can take, shared by
    dst and every source: a scalar head up to the first 16-byte boundary,
    whole vectors, a scalar tail; counts shorter than the head, than one
    vector and than one round of the grid, and several rounds."""
    esz = np.dtype(NP[dt]).itemsize
    for c, count in enumerate((1, 3, 17, 16 // esz * 37 + 5, 1000)):
        for off in range(16 // esz):
            k = 1 + (c + off) % EC_MAX_SRCS
            vec = check_ec_model(dt, op, k, count, alpha, [off] * (k + 1),
                                 seed=7 * c + off)
            assert vec


@pytest.mark.parametrize("k", range(1, 10))
def test_walk_at_every_source_count(k):
    """k = 1..9: aligned sources on the vector path, in place (dst the
    first source) too; one source a single element off takes the scalar
    path for the whole launch."""
    for i, (dt, op) in enumerate((("FLOAT32", "SUM"), ("BFLOAT16", "MAX"),
                                  ("UINT8", "LOR"))):
        assert check_ec_model(dt, op, k, 777, None, [0] * (k + 1),
                              seed=k + i, inplace=k % 2 == 1)
        offsets = [0] * (k + 1)
        offsets[k] = 1
        assert not check_ec_model(dt, op, k, 777, None, offsets,
                                  seed=k + i)


@pytest.mark.parametrize("dt", ["FLOAT32", "BFLOAT16", "INT8", "FLOAT64"])
def test_walk_on_strided_sources_at_odd_offsets(dt):
    """reduce_strided's sources: base + i·stride elements, the base one
    element in, stride 1003: offsets mod 16 differ, so the scalar path;
    a stride that keeps every source at one offset mod 16 (and the dst
    there too) takes the vector path."""
    esz = np.dtype(NP[dt]).itemsize
    count, k = 300, 5
    stride = 1003
    offsets = [0, 0] + [1 + i * stride for i in range(k - 1)]
    assert not check_ec_model_strided(dt, count, offsets, seed=3)
    stride = 16 // esz * 70
    offsets = [1, 1] + [1 + i * stride for i in range(k - 1)]
    assert check_ec_model_strided(dt, count, offsets, seed=4)


def check_ec_model_strided(dt, count, offsets, seed):
    """check_ec_model with the sources but the first as views into one
    base buffer at the given element offsets."""
    rng = np.random.default_rng(seed)
    big = from_numpy(rng.standard_normal(max(offsets) + count + 1)
                     .astype(NP[dt]), "cpu")
    first = from_numpy(rng.standard_normal(count + 16).astype(NP[dt]),
                       "cpu")
    dst_buf = torch.zeros(count + 16, dtype=big.dtype)
    srcs = [first[offsets[1]:offsets[1] + count]] + [
        big[o:o + count] for o in offsets[2:]]
    want = ker.ec_reduce_ref(srcs, count, DataType[dt], ReductionOp.SUM,
                             0.25)
    dst = dst_buf[offsets[0]:offsets[0] + count]
    esz = big.element_size()
    vec, written = ec_model(dst, srcs, count, DataType[dt], ReductionOp.SUM,
                            0.25, [esz * o for o in offsets])
    assert torch.equal(written, torch.ones_like(written))
    assert bits_equal(to_numpy(dst), to_numpy(want))
    return vec


def test_walk_grid_is_the_sources():
    """The model's launch constants are the source's: a grid from the
    occupancy query over ceil(vectors / kDepth) threads, and the k loop
    unrolled to the executor's cap of sources."""
    assert EC_MAX_SRCS == ec_base.EXECUTOR_NUM_BUFS
    assert EC_DEPTH >= 1 and EC_THREADS % 32 == 0
    assert "items = (vecs + kDepth - 1) / kDepth;" in EC_TEXT
