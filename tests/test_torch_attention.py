"""Ring flash-attention: the port's plain version against the JAX
package's Pallas kernel, and the wrapper and autograd.Function on the CPU.

``ucc_tpu_torch.kernels.ring_attention`` holds the CUDA kernel that
replaces ``ucc_tpu/fused_attention.py:_kernel`` and its plain PyTorch
version, a step-by-step port of ``_xla_ring_shard``. On CPU tensors the
port's ``make_ring_flash_attention`` runs that plain version; the JAX side
runs the Pallas kernel in interpret mode on a 1-axis sub-mesh of the
virtual CPU devices. Both get the same numpy inputs, made from a seed.

Tolerances: float32 rtol 2e-4 / atol 2e-5, the reference's own
(tests/test_ring_attention.py); both sides sum the same products in
another order. bfloat16 is compared in float32 within one bf16 ulp (rtol
2^-7, atol 1e-3): both accumulate in float32 and differ only where the
final rounding to bfloat16 does. The CUDA kernel is held to the plain
version on the card by chip_smoke.py.
"""
import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ucc_tpu import fused_attention as jfa  # noqa: E402
from ucc_tpu.utils.jaxshim import shard_map_compat  # noqa: E402
from ucc_tpu_torch.fused_attention import (  # noqa: E402
    make_ring_flash_attention, ring_flash_attention, ring_shard)
from ucc_tpu_torch.kernels import ring_attention as ka  # noqa: E402
from ucc_tpu_torch.status import Status, UccError  # noqa: E402

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)


def inputs(h, h_kv, seq, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32).astype(dtype)
                 for shape in ((h, seq, d), (h_kv, seq, d), (h_kv, seq, d)))


def sp_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


def jax_attention(n, causal, q, k, v):
    mesh = sp_mesh(n)
    sh = NamedSharding(mesh, P(None, "sp", None))
    fn = jfa.make_ring_flash_attention(mesh, causal=causal, axis="sp")
    out = fn(*(jax.device_put(jnp.asarray(x), sh) for x in (q, k, v)))
    return np.asarray(jax.device_get(out).astype(jnp.float32))


def torch_attention(n, causal, q, k, v):
    fn = make_ring_flash_attention(n, causal=causal, device="cpu")
    return fn(*(torch.from_numpy(np.asarray(x)) for x in (q, k, v)))


def dense_attention(q, k, v, causal, scale=None):
    """softmax(scale · q kᵀ) v in float64, K/V heads repeated per group."""
    h, seq, d = q.shape
    g = h // k.shape[0]
    kr = np.repeat(np.asarray(k, np.float64), g, axis=0)
    vr = np.repeat(np.asarray(v, np.float64), g, axis=0)
    scale = 1.0 / np.sqrt(d) if scale is None else scale
    s = np.einsum("hqd,hkd->hqk", np.asarray(q, np.float64), kr) * scale
    if causal:
        s = np.where(np.tril(np.ones((seq, seq), bool))[None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("hqk,hkd->hqd", p / p.sum(-1, keepdims=True), vr)


# ---------------------------------------------------------------------------
# the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

#: (n, causal, h, h_kv, seq, d): every n with both maskings, every head
#: layout with both maskings; seq 24 over 8 ranks is 3 rows a rank
PALLAS_CASES = [
    (2, False, 4, 2, 40, 8),
    (2, True, 8, 2, 64, 16),
    (4, False, 6, 6, 48, 4),
    (4, True, 4, 2, 32, 16),
    (8, False, 8, 2, 64, 8),
    (8, True, 6, 6, 24, 4),
]


@pytest.mark.parametrize("n,causal,h,h_kv,seq,d", PALLAS_CASES)
def test_plain_version_matches_pallas_kernel(n, causal, h, h_kv, seq, d):
    q, k, v = inputs(h, h_kv, seq, d, seed=100 * n + h + int(causal))
    want = jax_attention(n, causal, q, k, v)
    got = torch_attention(n, causal, q, k, v)
    assert got.dtype == torch.float32 and got.shape == (h, seq, d)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_bf16_matches_pallas_kernel():
    import ml_dtypes
    q, k, v = inputs(8, 2, 64, 8, seed=7, dtype=ml_dtypes.bfloat16)
    want = jax_attention(4, True, q, k, v)
    tq, tk, tv = (torch.from_numpy(x.astype(np.float32)).bfloat16()
                  for x in (q, k, v))
    got = make_ring_flash_attention(4, causal=True, device="cpu")(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,h,h_kv", [(4, 4, 4), (8, 4, 2)])
def test_gradients_match_jax_custom_vjp(n, h, h_kv, causal):
    """d sum(out²) / d(q, k, v) through the port's autograd.Function
    (``ring_shard`` recomputed one query rank at a time and differentiated)
    against jax.grad through
    the JAX package's custom_vjp (its lax ring schedule differentiated)."""
    seq, d = 24, 4
    q, k, v = inputs(h, h_kv, seq, d, seed=30 + h_kv + int(causal))
    mesh = sp_mesh(n)
    sh = NamedSharding(mesh, P(None, "sp", None))
    f = shard_map_compat(
        lambda a, b, c: jfa.ring_flash_attention(a, b, c, axis_name="sp",
                                                 causal=causal),
        mesh, (P(None, "sp", None),) * 3, P(None, "sp", None))

    @jax.jit
    def loss(a, b, c):
        return jnp.sum(f(a, b, c) ** 2)

    ctx = jax.set_mesh(mesh) if hasattr(jax, "set_mesh") \
        else contextlib.nullcontext()
    with ctx:
        want = jax.grad(loss, argnums=(0, 1, 2))(
            *(jax.device_put(jnp.asarray(x), sh) for x in (q, k, v)))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    fn = make_ring_flash_attention(n, causal=causal, device="cpu")
    (fn(tq, tk, tv) ** 2).sum().backward()
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **F32_TOL)


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,causal,h,h_kv,seq,d", [
    (1, True, 2, 1, 5, 3),           # one rank: one step
    (3, True, 4, 2, 3, 8),           # one row a rank
    (5, False, 6, 3, 35, 16),
    (8, True, 8, 8, 56, 1),          # head dim 1
])
def test_plain_version_matches_dense_attention(n, causal, h, h_kv, seq, d):
    q, k, v = inputs(h, h_kv, seq, d, seed=n + seq)
    got = torch_attention(n, causal, q, k, v)
    np.testing.assert_allclose(got.numpy(), dense_attention(q, k, v, causal),
                               **F32_TOL)


def test_explicit_scale_and_default():
    q, k, v = inputs(4, 2, 16, 8, seed=3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    default = make_ring_flash_attention(2, device="cpu")(tq, tk, tv)
    explicit = make_ring_flash_attention(2, scale=8 ** -0.5,
                                         device="cpu")(tq, tk, tv)
    assert torch.equal(default, explicit)
    halved = make_ring_flash_attention(2, scale=0.5, device="cpu")(tq, tk, tv)
    np.testing.assert_allclose(halved.numpy(),
                               dense_attention(q, k, v, False, scale=0.5),
                               **F32_TOL)


def test_causal_first_row_sees_only_itself():
    """Rank 0's row 0 has one key, at every step but the first a fully
    masked block: its output is v[0], with no NaN anywhere."""
    q, k, v = inputs(2, 2, 8, 4, seed=5)
    out = torch_attention(4, True, q, k, v)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out[:, 0].numpy(), v[:, 0], rtol=1e-6)


def test_backward_is_the_gradient_of_the_plain_version():
    n, scale = 4, 0.3
    blocks = [[torch.randn(shape, generator=torch.Generator().manual_seed(
        10 * r + i)).requires_grad_() for r in range(n)]
        for i, shape in enumerate(((4, 6, 8), (2, 6, 8), (2, 6, 8)))]
    outs = ring_flash_attention(*blocks, scale=scale, causal=True)
    torch.autograd.backward(outs, [o * 3 for o in outs])
    got = [t.grad.clone() for b in blocks for t in b]
    for b in blocks:
        for t in b:
            t.grad = None
    # the backward is the gradient of ring_shard, one query rank at a
    # time, each rank's dk/dv added in rank order: bitwise
    qs, ks, vs = blocks
    for me in range(n):
        out = ring_shard(qs[me], ks, vs, me, scale, True)
        torch.autograd.backward(out, outs[me].detach() * 3)
    for g, t in zip(got, [t for b in blocks for t in b]):
        assert torch.equal(g, t.grad)
        t.grad = None
    # and the gradient of the plain version, whose sums over ranks run in
    # another order: within float32 rounding of the sums
    refs = ka.ring_flash_attention_ref(*blocks, scale, True)
    torch.autograd.backward(refs, [o * 3 for o in refs])
    for g, t in zip(got, [t for b in blocks for t in b]):
        torch.testing.assert_close(g, t.grad, rtol=1e-5, atol=1e-6)


def test_wrapper_on_cpu_runs_the_plain_version_without_a_launch():
    q, k, v = (torch.from_numpy(x) for x in inputs(4, 2, 12, 8, seed=9))
    qs, ks, vs = (list(x.split(3, dim=1)) for x in (q, k, v))
    qs, ks, vs = ([t.contiguous() for t in b] for b in (qs, ks, vs))
    before = ka.ring_flash_attention_fwd.launches
    got = ka.ring_flash_attention_fwd(qs, ks, vs, 0.25, True)
    assert ka.ring_flash_attention_fwd.launches == before
    want = ka.ring_flash_attention_ref(qs, ks, vs, 0.25, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_mismatched_heads_raise_value_error():
    q, k, v = (torch.from_numpy(x) for x in inputs(5, 2, 16, 4, seed=1))
    with pytest.raises(ValueError, match="GQA"):
        make_ring_flash_attention(2, device="cpu")(q, k, v)
    with pytest.raises(ValueError, match="GQA"):
        ring_flash_attention([torch.zeros(4, 2, 4)], [torch.zeros(2, 2, 4)],
                             [torch.zeros(1, 2, 4)])


def test_seq_not_divisible_by_ranks_raises():
    q, k, v = (torch.from_numpy(x) for x in inputs(2, 2, 10, 4, seed=1))
    with pytest.raises(ValueError, match="divide"):
        make_ring_flash_attention(4, device="cpu")(q, k, v)


def _blocks(n=2, h=4, h_kv=2, s=3, d=8, dtype=torch.float32):
    return ([torch.zeros(h, s, d, dtype=dtype) for _ in range(n)],
            [torch.zeros(h_kv, s, d, dtype=dtype) for _ in range(n)],
            [torch.zeros(h_kv, s, d, dtype=dtype) for _ in range(n)])


@pytest.mark.parametrize("bad,status", [
    ("dtype", Status.ERR_NOT_SUPPORTED),
    ("head_dim", Status.ERR_NOT_SUPPORTED),
    ("ranks", Status.ERR_NOT_SUPPORTED),
    ("query_heads", Status.ERR_NOT_SUPPORTED),
    ("lists", Status.ERR_INVALID_PARAM),
    ("shape", Status.ERR_INVALID_PARAM),
    ("heads", Status.ERR_INVALID_PARAM),
    ("mixed_dtype", Status.ERR_INVALID_PARAM),
    ("strided", Status.ERR_INVALID_PARAM),
    ("empty", Status.ERR_INVALID_PARAM),
    ("rank_2", Status.ERR_INVALID_PARAM),
    ("device", Status.ERR_NOT_SUPPORTED),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, status):
    qs, ks, vs = _blocks()
    if bad == "dtype":
        qs, ks, vs = _blocks(dtype=torch.float64)
    elif bad == "head_dim":
        qs, ks, vs = _blocks(d=ka.MAX_HEAD_DIM + 1)
    elif bad == "ranks":
        qs, ks, vs = _blocks(n=ka.MAX_RANKS + 1, s=1, d=1)
    elif bad == "query_heads":
        # past the grid's y extent, which a CUDA launch refuses
        qs, ks, vs = _blocks(n=2, h=ka.MAX_HEADS + 1, h_kv=1, s=1, d=1)
    elif bad == "lists":
        vs = vs[:1]
    elif bad == "shape":
        ks[1] = torch.zeros(2, 4, 8)
    elif bad == "heads":
        qs, ks, vs = _blocks(h=3, h_kv=2)
    elif bad == "mixed_dtype":
        vs[0] = vs[0].half()
    elif bad == "strided":
        qs[1] = torch.zeros(4, 8, 3).transpose(1, 2)
    elif bad == "empty":
        qs, ks, vs = _blocks(s=0)
    elif bad == "device":
        qs, ks, vs = ([t.to("meta") for t in b] for b in (qs, ks, vs))
    else:
        qs[0] = torch.zeros(12, 8)
    with pytest.raises(UccError) as ei:
        ka.ring_flash_attention_fwd(qs, ks, vs, 0.5, False)
    assert ei.value.status == status


def test_check_args_takes_up_to_65535_query_heads():
    qs, ks, vs = _blocks(n=2, h=ka.MAX_HEADS, h_kv=1, s=1, d=1)
    assert ka.check_args(qs, ks, vs) == (2, 65535, 1, 1, 1)


def test_head_dim_256_is_the_largest_taken():
    qs, ks, vs = _blocks(n=2, h=2, h_kv=1, s=2, d=ka.MAX_HEAD_DIM)
    outs = ka.ring_flash_attention_fwd(qs, ks, vs, 0.1, True)
    assert [o.shape for o in outs] == [(2, 2, ka.MAX_HEAD_DIM)] * 2


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        fn = make_ring_flash_attention(2)
        q, k, v = (torch.from_numpy(x) for x in inputs(2, 2, 8, 4, seed=2))
        assert fn(q, k, v).device.type == "cuda"
    else:
        with pytest.raises(UccError) as ei:
            make_ring_flash_attention(2)
        assert ei.value.status == Status.ERR_NO_RESOURCE
        assert "cuda" in str(ei.value)
