"""Shared cases of the ring kernel tests (tests/test_torch_ring_*.py):
seeded numpy inputs, a NaN-aware bitwise comparison, and runners for the
JAX package's Pallas kernels (interpret mode) and the port's plain
versions on the same inputs, for allreduce, reduce_scatter, allgather,
bcast and alltoall."""
import ml_dtypes
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import ucc_tpu.tl.ring_dma as rd
from ucc_tpu.constants import CollType as JCollType
from ucc_tpu.constants import ReductionOp as JReductionOp

from ucc_tpu_torch.constants import ReductionOp
from ucc_tpu_torch.kernels import ring_allreduce as kr
from ucc_tpu_torch.kernels import ring_bcast_a2a as kba
from ucc_tpu_torch.kernels import ring_rs_ag as krs
from ucc_tpu_torch.utils.convert import from_numpy, to_numpy

DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16, "i32": np.int32,
          "i8": np.int8, "u8": np.uint8, "i16": np.int16}
#: the dtypes of the covering cases (each case a Pallas compile): the
#: integer types added later meet the Pallas kernels in
#: tests/test_torch_ring_dtypes.py
COVER_DTYPES = ("f32", "bf16", "i32")
OPS = ["SUM", "AVG", "MAX", "MIN", "PROD"]
NS = [2, 4, 8]


def covering_cases(shift):
    """(n, dtype, op) cases of a kernel against its Pallas kernel: every n
    runs every op, and the dtype turns with n and op, so every pair of
    values (n and dtype, n and op, dtype and op) meets in some case. Each
    case compiles its own Pallas program, about a second in interpret
    mode, so the full product (45 per kernel) is not run. The two kernels
    take different shifts and so run 30 distinct triples together; the
    elementwise part of every dtype and op is held against ucc_tpu's own
    functions in tests/test_torch_ring_allreduce.py."""
    dts = list(COVER_DTYPES)
    return [(n, dts[(i + j + shift) % len(dts)], op)
            for i, n in enumerate(NS) for j, op in enumerate(OPS)]
#: a small chunk, so the chunked kernel runs several chunks cheaply
CHUNK = 64
#: ragged counts: not a multiple of n (2, 4, 8) nor of the chunk size
PASS_COUNT = 37
CHUNKED_COUNT = 151
#: reduce_scatter blocks: 37 (ragged against every lane and chunk), and 40,
#: which the JAX package's chunked kernel re-pads per block (its cblk is
#: CHUNK // n: 32, 16 and 8)
RS_PASS_BLOCK = 37
RS_CHUNKED_BLOCK = 40
#: allgather blocks: ragged, and 3 chunks of CHUNK, the last one ragged
AG_PASS_BLOCK = 37
AG_CHUNKED_BLOCK = 150


def make_inputs(n, count, dt, op, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(DTYPES[dt]).kind in "iu":
        # products of 8 such values overflow every integer type, and sums
        # overflow int8: both sides wrap
        lo = 0 if np.dtype(DTYPES[dt]).kind == "u" else -50
        arrs = [rng.integers(lo, 50, count).astype(DTYPES[dt])
                for _ in range(n)]
    else:
        arrs = [rng.standard_normal(count).astype(DTYPES[dt])
                for _ in range(n)]
        if op in ("MAX", "MIN"):
            arrs[1][3] = np.nan          # must propagate, not be dropped
    return arrs


def bitwise_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind in "iu":
        return np.array_equal(a, b)
    na, nb = np.isnan(a.astype(np.float32)), np.isnan(b.astype(np.float32))
    bits = {2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize]
    return np.array_equal(na, nb) and np.array_equal(
        a.view(bits)[~na], b.view(bits)[~nb])


def jax_ring(kernel, n, op, arrs, monkeypatch):
    """Run the Pallas kernel in interpret mode; per-rank results."""
    count = arrs[0].size
    nd = arrs[0].dtype
    mesh = jax.make_mesh((n,), ("r",), devices=jax.devices()[:n])
    jop = JReductionOp[op]
    if kernel == "pass":
        prog, padded = rd.build_ring_program(mesh, n, JCollType.ALLREDUCE,
                                             jop, nd, count)
    else:
        monkeypatch.setattr(rd, "CHUNK_ELEMS", CHUNK)
        prog, padded = rd.build_hbm_allreduce_program(mesh, n, jop, nd,
                                                      count)
    shards = [jax.device_put(jnp.pad(jnp.asarray(a), (0, padded - count)),
                             jax.devices()[r]) for r, a in enumerate(arrs)]
    garr = jax.make_array_from_single_device_arrays(
        (n * padded,), NamedSharding(mesh, P("r")), shards)
    out = np.asarray(jax.block_until_ready(prog(garr)))
    return [row[:count] for row in out.reshape(n, padded)]


def torch_ring(kernel, op, arrs):
    srcs = [from_numpy(a, "cpu") for a in arrs]
    if kernel == "pass":
        outs = kr.ring_allreduce_pass_ref(srcs, ReductionOp[op])
    else:
        outs = kr.ring_allreduce_chunked_ref(srcs, ReductionOp[op],
                                             csize=CHUNK)
    return [to_numpy(o) for o in outs]


def _global(mesh, n, arrs, padded):
    """The per-rank arrays, end-padded to *padded*, as one array sharded
    over the mesh, as the launch path of tl/ring_dma builds it."""
    count = arrs[0].size
    shards = [jax.device_put(jnp.pad(jnp.asarray(a), (0, padded - count)),
                             jax.devices()[r]) for r, a in enumerate(arrs)]
    return jax.make_array_from_single_device_arrays(
        (n * padded,), NamedSharding(mesh, P("r")), shards)


def jax_reduce_scatter(kernel, n, op, arrs, monkeypatch):
    """The Pallas reduce_scatter kernel in interpret mode on n ranks of
    n·c elements each; per-rank results (c elements each)."""
    count = arrs[0].size
    mesh = jax.make_mesh((n,), ("r",), devices=jax.devices()[:n])
    jop = JReductionOp[op]
    if kernel == "pass":
        prog, padded = rd.build_ring_program(
            mesh, n, JCollType.REDUCE_SCATTER, jop, arrs[0].dtype, count)
    else:
        monkeypatch.setattr(rd, "CHUNK_ELEMS", CHUNK)
        prog, padded = rd.build_hbm_reduce_scatter_program(
            mesh, n, jop, arrs[0].dtype, count)
    out = np.asarray(jax.block_until_ready(
        prog(_global(mesh, n, arrs, padded))))
    return [row[:count // n] for row in out.reshape(n, -1)]


def jax_allgather(kernel, n, arrs, monkeypatch):
    """The Pallas allgather kernel in interpret mode on n ranks of c
    elements each; each rank's own copy of the n·c result."""
    count = arrs[0].size
    mesh = jax.make_mesh((n,), ("r",), devices=jax.devices()[:n])
    if kernel == "pass":
        prog, padded = rd.build_ring_program(
            mesh, n, JCollType.ALLGATHER, None, arrs[0].dtype, count)
    else:
        monkeypatch.setattr(rd, "CHUNK_ELEMS", CHUNK)
        prog, padded = rd.build_hbm_allgather_program(
            mesh, n, arrs[0].dtype, count)
    out = jax.block_until_ready(prog(_global(mesh, n, arrs, padded)))
    by_dev = {s.device: np.asarray(s.data) for s in out.addressable_shards}
    return [by_dev[d] for d in jax.devices()[:n]]


def torch_reduce_scatter(kernel, n, op, arrs):
    """The port's plain version at the kernel's geometry: one chunk for
    the pass kernel, the JAX package's chunk for the chunked one (CHUNK //
    n elements per block, at most the block)."""
    srcs = [from_numpy(a, "cpu") for a in arrs]
    blk = arrs[0].size // n
    cblk = blk if kernel == "pass" else min(CHUNK // n, blk)
    outs = krs.ring_reduce_scatter_ref(srcs, ReductionOp[op], cblk=cblk)
    return [to_numpy(o) for o in outs]


def torch_allgather(kernel, arrs):
    """The port's plain version at the kernel's geometry: one chunk for
    the pass kernel, the JAX package's chunk for the chunked one (CHUNK
    elements per block, at most the block)."""
    srcs = [from_numpy(a, "cpu") for a in arrs]
    blk = arrs[0].size
    outs = krs.ring_allgather_ref(
        srcs, cblk=blk if kernel == "pass" else min(CHUNK, blk))
    return [to_numpy(o) for o in outs]


def _per_device(out, n):
    """Each device's own copy of a replicated (P(None)) result."""
    by_dev = {s.device: np.asarray(s.data) for s in out.addressable_shards}
    return [by_dev[d] for d in jax.devices()[:n]]


def jax_bcast(kernel, n, root, arrs, monkeypatch):
    """The Pallas bcast kernel in interpret mode on n ranks of c elements
    each (only the root's are read); each rank's own result."""
    count = arrs[0].size
    mesh = jax.make_mesh((n,), ("r",), devices=jax.devices()[:n])
    if kernel == "pass":
        prog, padded = rd.build_bcast_program(mesh, n, root, arrs[0].dtype,
                                              count)
    else:
        monkeypatch.setattr(rd, "CHUNK_ELEMS", CHUNK)
        prog, padded = rd.build_hbm_bcast_program(mesh, n, root,
                                                  arrs[0].dtype, count)
    out = jax.block_until_ready(prog(_global(mesh, n, arrs, padded)))
    return [o[:count] for o in _per_device(out, n)]


def jax_alltoall(kernel, n, arrs, monkeypatch):
    """The Pallas alltoall kernel in interpret mode on n ranks of n blocks
    each; per-rank results."""
    count = arrs[0].size
    mesh = jax.make_mesh((n,), ("r",), devices=jax.devices()[:n])
    if kernel == "pass":
        prog, padded = rd.build_alltoall_program(mesh, n, arrs[0].dtype,
                                                 count)
    else:
        monkeypatch.setattr(rd, "CHUNK_ELEMS", CHUNK)
        prog, padded = rd.build_hbm_alltoall_program(mesh, n, arrs[0].dtype,
                                                     count)
    out = np.asarray(jax.block_until_ready(
        prog(_global(mesh, n, arrs, padded))))
    return [row[:count] for row in out.reshape(n, -1)]


def torch_bcast(kernel, root, arrs):
    """The port's plain version at the Pallas kernel's sub-block: the whole
    vector for the pass kernel (its CHUNK_ELEMS // 2 is far above these
    counts), CHUNK // 2 for the chunked one."""
    srcs = [from_numpy(a, "cpu") for a in arrs]
    blk = arrs[0].size if kernel == "pass" else CHUNK // 2
    return [to_numpy(o) for o in kba.ring_bcast_ref(srcs, root, blk=blk)]


def torch_alltoall(kernel, n, arrs):
    """The port's plain version at the Pallas kernel's chunk: the whole
    block for the pass kernel, CHUNK // (2(n-1)) elements of every block
    for the chunked one."""
    srcs = [from_numpy(a, "cpu") for a in arrs]
    blk = arrs[0].size // n
    cblk = blk if kernel == "pass" else min(blk, CHUNK // (2 * (n - 1)))
    return [to_numpy(o) for o in kba.ring_alltoall_ref(srcs, cblk=cblk)]
