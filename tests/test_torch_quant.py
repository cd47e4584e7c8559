"""The port's quantization policy and host codec (ucc_tpu_torch/quant)
held against the JAX package's on the same seeded numpy inputs: the wire
bytes byte for byte (int8 and fp8, blocks 32 and 256, counts that are no
multiple of the block, bfloat16 payloads, stochastic rounding under one
seed), the decoded values bit for bit, the widened accumulate of
``reduce_arrays(out=)``, and the predicates and records of the policy
layer (``admits``, ``predicted_error``, ``wire_ratio``, quant.verify)."""
import ml_dtypes
import numpy as np
import pytest

from ucc_tpu import quant as jq
from ucc_tpu.constants import CollType as JCollType
from ucc_tpu.constants import DataType as JDataType
from ucc_tpu.constants import ReductionOp as JReductionOp
from ucc_tpu.ec.cpu import reduce_arrays as j_reduce_arrays
from ucc_tpu.quant import codec as jcodec
from ucc_tpu.quant import verify as jverify

from ucc_tpu_torch import quant as pq
from ucc_tpu_torch.constants import CollType, DataType, ReductionOp
from ucc_tpu_torch.ec.cpu import reduce_arrays
from ucc_tpu_torch.quant import codec as pcodec
from ucc_tpu_torch.quant import verify as pverify

BF16 = np.dtype(ml_dtypes.bfloat16)
MODES = ("int8", "fp8")
BLOCKS = (32, 256)
COUNTS = (1, 31, 256, 257, 1000, 4096 + 5)


def payload(count, seed, dtype=np.float32, scale=4.0):
    rng = np.random.default_rng(seed)
    x = ((rng.random(count, dtype=np.float32) - 0.5) * scale)
    if count > 8:
        x[3] = 0.0
        x[5] = -x[5]
    return x.astype(dtype)


def encode_both(mode, x, block, stochastic=False, seed=None):
    """(reference wire, port wire) of payload x (bfloat16 as ml_dtypes in
    the reference, its uint16 bits in the port)."""
    wc = jcodec.wire_count(x.size, block)
    wj = np.zeros(wc, np.uint8)
    wp = np.zeros(wc, np.uint8)
    rj = np.random.default_rng(seed) if stochastic else None
    rp = np.random.default_rng(seed) if stochastic else None
    jcodec.get_codec(mode).encode(x, wj, block, stochastic=stochastic,
                                  rng=rj)
    xp = x.view(np.uint16) if x.dtype == BF16 else x
    pcodec.get_codec(mode).encode(xp, wp, block, stochastic=stochastic,
                                  rng=rp)
    return wj, wp


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("mode", MODES)
def test_wire_bytes_and_decode_are_the_references(mode, block, count):
    x = payload(count, seed=count + block)
    wj, wp = encode_both(mode, x, block)
    np.testing.assert_array_equal(wp, wj)
    oj = np.empty(count, np.float32)
    op = np.empty(count, np.float32)
    jcodec.get_codec(mode).decode(wj, count, block, oj)
    pcodec.get_codec(mode).decode(wp, count, block, op)
    np.testing.assert_array_equal(op.view(np.uint32), oj.view(np.uint32))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("mode", MODES)
def test_bf16_payload_encodes_and_decodes_as_the_reference(mode, block):
    count = 1000
    x = payload(count, seed=7, dtype=BF16)
    wj, wp = encode_both(mode, x, block)
    np.testing.assert_array_equal(wp, wj)
    oj = np.empty(count, BF16)
    op = np.empty(count, np.uint16)          # the port's bfloat16 bits
    jcodec.get_codec(mode).decode(wj, count, block, oj)
    pcodec.get_codec(mode).decode(wp, count, block, op)
    np.testing.assert_array_equal(op, oj.view(np.uint16))


@pytest.mark.parametrize("count", (257, 4096))
@pytest.mark.parametrize("block", BLOCKS)
def test_stochastic_rounding_matches_under_one_seed(block, count):
    x = payload(count, seed=3)
    wj, wp = encode_both("int8", x, block, stochastic=True, seed=11)
    np.testing.assert_array_equal(wp, wj)


def test_stochastic_absmax_never_wraps():
    """The reference's own probe: an amax whose scaled value sits an ulp
    past 127 must clip, not wrap to -128."""
    c = pcodec.get_codec("int8")
    count, block = 4096, 256
    amax = 0.16527634859085083
    x = np.full(count, amax, np.float32)
    x[1::2] = -amax
    wire = np.zeros(pcodec.wire_count(count, block), np.uint8)
    out = np.empty(count, np.float32)
    rng = np.random.default_rng(0)
    for _ in range(50):
        c.encode(x, wire, block, stochastic=True, rng=rng)
        c.decode(wire, count, block, out)
        assert np.max(np.abs(x - out)) <= 2 * c.half_step * amax * 1.05


def test_zero_block_encodes_exactly():
    for mode in MODES:
        x = np.zeros(300, np.float32)
        wj, wp = encode_both(mode, x, 256)
        np.testing.assert_array_equal(wp, wj)
        out = np.ones(300, np.float32)
        pcodec.get_codec(mode).decode(wp, 300, 256, out)
        assert not out.any()


def test_fp8_tables_are_the_references():
    """Every row of the port's 64K-entry encode table and of its 256-entry
    decode table equals the JAX package's (NaN rows as NaN)."""
    np.testing.assert_array_equal(pcodec._f8_from_f32hi_lut(),
                                  jcodec._f8_from_f32hi_lut())
    dp, dj = pcodec._f8_to_f32_lut(), jcodec._f8_to_f32_lut()
    assert np.array_equal(np.isnan(dp), np.isnan(dj))
    ok = ~np.isnan(dj)
    np.testing.assert_array_equal(dp[ok].view(np.uint32),
                                  dj[ok].view(np.uint32))


@pytest.mark.parametrize("mode", MODES)
def test_roundtrip_error_probe_matches(mode):
    x = payload(777, seed=5)
    wj, wp = encode_both(mode, x, 256)
    assert pcodec.get_codec(mode).roundtrip_max_err(x, wp, 256) == \
        jcodec.get_codec(mode).roundtrip_max_err(x, wj, 256)


def test_codec_constants_match():
    for mode in MODES:
        p, j = pq.get_codec(mode), jq.get_codec(mode)
        assert (p.name, p.qmax, p.half_step) == (j.name, j.qmax, j.half_step)
        assert p.np_qdtype.itemsize == j.qdtype.itemsize == 1
    for count in (0, 1, 255, 256, 257, 65536):
        for block in BLOCKS:
            assert pq.wire_count(count, block) == jq.wire_count(count, block)
            assert pq.n_blocks(count, block) == jq.n_blocks(count, block)


# ---------------------------------------------------------------------------
# reduce_arrays(out=): the widened float32 accumulate of a bf16 payload
# ---------------------------------------------------------------------------

def test_f32_accumulate_of_bf16_payload_keeps_f32_precision():
    a = np.array([1.0, 1.0], np.float32)
    b = np.array([0.001953125, 0.001953125], np.float32)  # 2^-9
    out = np.zeros(2, np.float32)
    res = reduce_arrays([a, b], ReductionOp.SUM, DataType.BFLOAT16, out=out)
    assert res is out
    want = np.zeros(2, np.float32)
    j_reduce_arrays([a, b], JReductionOp.SUM, JDataType.BFLOAT16, out=want)
    np.testing.assert_array_equal(out, want)
    assert out[0] == np.float32(1.0 + 0.001953125)


def test_slow_path_targets_out_dtype():
    a = np.array([1.0, 3.0], np.float32)
    b = np.array([0.001953125, 0.0], np.float32)
    out = np.zeros(2, np.float32)
    want = np.zeros(2, np.float32)
    reduce_arrays([a, b], ReductionOp.AVG, DataType.BFLOAT16, alpha=0.5,
                  out=out)
    j_reduce_arrays([a, b], JReductionOp.AVG, JDataType.BFLOAT16,
                    alpha=0.5, out=want)
    np.testing.assert_array_equal(out, want)
    assert out[0] == np.float32((1.0 + 0.001953125) * 0.5)


def test_same_dtype_fast_path_unchanged():
    a = np.arange(8, dtype=np.float64)
    b = np.ones(8, np.float64)
    out = np.empty(8, np.float64)
    res = reduce_arrays([a, b], ReductionOp.SUM, DataType.FLOAT64, out=out)
    assert res is out
    np.testing.assert_array_equal(out, a + b)


def test_bf16_bits_still_reduce_as_bf16():
    """uint16 bit patterns under BFLOAT16 keep their path: the sum in
    float32, rounded once, as the reference's bfloat16 sum."""
    xs = [payload(64, seed=s, dtype=BF16) for s in (1, 2, 3)]
    got = reduce_arrays([x.view(np.uint16) for x in xs], ReductionOp.SUM,
                        DataType.BFLOAT16)
    want = j_reduce_arrays(xs, JReductionOp.SUM, JDataType.BFLOAT16)
    np.testing.assert_array_equal(got, want.view(np.uint16))


# ---------------------------------------------------------------------------
# the policy layer and quant.verify's records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ("direct", "ring"))
@pytest.mark.parametrize("coll", ("ALLREDUCE", "ALLGATHER"))
@pytest.mark.parametrize("mode", MODES)
def test_predicted_error_and_admits_match(mode, coll, variant):
    for n in (1, 2, 3, 5, 8, 64):
        got = pq.predicted_error(pq.get_codec(mode), CollType[coll], n,
                                 variant)
        want = jq.predicted_error(jq.get_codec(mode), JCollType[coll], n,
                                  variant)
        assert got == want
        for budget in (1e-6, 0.01, 0.1, 1.0):
            p = pq.QuantParams(pq.get_codec(mode), 256, budget, False)
            j = jq.QuantParams(jq.get_codec(mode), 256, budget, False)
            assert pq.admits(p, CollType[coll], n, variant) == \
                jq.admits(j, JCollType[coll], n, variant)


def test_wire_ratio_and_tables_match():
    for count in (0, 1, 100, 65536, 1 << 20):
        for esz in (2, 4):
            for block in BLOCKS:
                assert pq.wire_ratio(count, esz, block) == \
                    jq.wire_ratio(count, esz, block)
    assert [c.name for c in pq.QUANT_COLLS] == \
        [c.name for c in jq.QUANT_COLLS]
    assert [d.name for d in pq.QUANT_DTS] == [d.name for d in jq.QUANT_DTS]
    assert pq.default_budget("int8") == jq.default_budget("int8")
    assert pq.default_budget("fp8") == jq.default_budget("fp8")


@pytest.mark.parametrize("coll", ("ALLREDUCE", "ALLGATHER", "BCAST"))
def test_verify_records_match(coll):
    for n in (1, 2, 4, 8):
        assert pverify.exact_wire_floor(CollType[coll], 1000, 4, n) == \
            jverify.exact_wire_floor(JCollType[coll], 1000, 4, n)
    p = pq.QuantParams(pq.get_codec("int8"), 256, 0.1, False)
    j = jq.QuantParams(jq.get_codec("int8"), 256, 0.1, False)
    assert pverify.base_detail(p, CollType[coll], 65536, 4, 1.5, 4) == \
        jverify.base_detail(j, JCollType[coll], 65536, 4, 1.5, 4)
    exact = payload(512, seed=9).astype(np.float64)
    results = [exact + 1e-3, exact - 2e-3]
    assert pverify.error_stats(exact, results, 0.01) == \
        jverify.error_stats(exact, results, 0.01)


def test_measured_bytes_counts_host_sends():
    from ucc_tpu_torch.obs import metrics
    was = metrics.ENABLED
    with pverify.MeasuredBytes() as mb:
        assert metrics.ENABLED
        metrics.inc("bytes_sent", 4096, component="tl/host", coll="x",
                    alg="y")
    assert mb.total == 4096 and metrics.ENABLED == was
