"""The port's other examples against the JAX package's, on the CPU: the
DP×TP train step, the pipeline, the MoE layer, and the ring and Ulysses
attentions, each on a ``RankMesh(device="cpu")`` of the JAX test's axes and
sizes, from the same numpy inputs, and each against its own reference
function.

Tolerances: float32 rtol 2e-4 / atol 2e-5, the JAX tests' own
(tests/test_pipeline_parallel.py, test_moe_ep.py, test_ring_attention.py):
the same products summed in another order, and gelu's tanh and the
softmax's exp evaluated by another library. The DP×TP step's new weights
and loss within rtol 1e-5 / atol 1e-6 (one step of lr·grad from the same
weights: the differences stay at the weights' ulp).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ucc_tpu.examples import dp_tp_training as jdt  # noqa: E402
from ucc_tpu.examples import moe_ep as jmoe  # noqa: E402
from ucc_tpu.examples import pipeline_parallel as jpp  # noqa: E402
from ucc_tpu.examples import ring_attention as jra  # noqa: E402
from ucc_tpu_torch.examples import dp_tp_training as dt  # noqa: E402
from ucc_tpu_torch.examples import moe_ep  # noqa: E402
from ucc_tpu_torch.examples import pipeline_parallel as pp  # noqa: E402
from ucc_tpu_torch.examples import ring_attention as ra  # noqa: E402
from ucc_tpu_torch.mesh import RankMesh  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def enough_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def rng_normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# DP × TP
# ---------------------------------------------------------------------------

def test_dp_tp_step_matches_jax(enough_devices):
    b, dm, dh, lr = 8, 16, 32, 0.05
    w1, w2, x, y = rng_normal(1, (dm, dh), (dh, dm), (b, dm), (b, dm))
    w1, w2 = w1 * 0.02, w2 * 0.02
    jmesh = jax.make_mesh((2, 4), ("dp", "tp"))

    def put(a, *spec):
        return jax.device_put(jnp.asarray(a), NamedSharding(jmesh, P(*spec)))

    jw1, jw2, jloss = jdt.make_train_step(jmesh, lr=lr)(
        put(w1, None, "tp"), put(w2, "tp", None), put(x, "dp", None),
        put(y, "dp", None))

    with RankMesh({"dp": 2, "tp": 4}, device="cpu") as m:
        step = dt.make_train_step(m, lr=lr)
        w1s, w2s = m.shard(t(w1), dt.W1_SPEC), m.shard(t(w2), dt.W2_SPEC)
        xs, ys = m.shard(t(x), dt.X_SPEC), m.shard(t(y), dt.X_SPEC)
        nw1, nw2, losses = step(w1s, w2s, xs, ys)
        for r in range(8):
            # replicas over dp are bitwise equal, shards over tp differ
            other = (r + 4) % 8
            assert torch.equal(nw1[r], nw1[other])
            assert torch.equal(losses[r], losses[0])
        np.testing.assert_allclose(m.unshard(nw1, dt.W1_SPEC).numpy(),
                                   np.asarray(jw1), **STEP_TOL)
        np.testing.assert_allclose(m.unshard(nw2, dt.W2_SPEC).numpy(),
                                   np.asarray(jw2), **STEP_TOL)
        np.testing.assert_allclose(losses[0].numpy(),
                                   np.asarray(jloss), **STEP_TOL)
        assert np.isfinite(dt.run_one_step(m))


def test_gelu_grad_is_the_derivative_of_tanh_gelu():
    x = torch.linspace(-4, 4, 101, dtype=torch.float64, requires_grad=True)
    torch.nn.functional.gelu(x, approximate="tanh").sum().backward()
    np.testing.assert_allclose(dt._gelu_grad(x.detach()).numpy(),
                               x.grad.numpy(), rtol=1e-12, atol=1e-12)
    # XLA's float32 tanh is an approximation a few ulp from torch's: the
    # derivative's terms are <= 1.2, so 5e-6 is ~40 ulp of them
    np.testing.assert_allclose(
        dt._gelu_grad(x.detach().float()).numpy(),
        np.asarray(jdt._gelu_grad(jnp.asarray(x.detach().float().numpy()))),
        rtol=0, atol=5e-6)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_micro", [1, 3, 6])
def test_pipeline_matches_jax_and_reference(enough_devices, n_micro):
    n, b, d = 4, 2, 8
    x, w = rng_normal(n_micro, (n_micro, b, d), (n, d, d))
    w *= 0.3
    jmesh = jax.make_mesh((n,), ("pp",))
    want = np.asarray(jpp.make_pipeline(jmesh, n_micro)(
        jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P(None))),
        jax.device_put(jnp.asarray(w), NamedSharding(jmesh, P("pp")))))
    with RankMesh({"pp": n}, device="cpu") as m:
        got = pp.make_pipeline(m, n_micro)(t(x), t(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(),
                               pp.reference_pipeline(t(x), t(w)).numpy(),
                               **TOL)
    np.testing.assert_allclose(
        pp.reference_pipeline(t(x), t(w)).numpy(),
        jpp.reference_pipeline(x, w), **TOL)


def test_pipeline_on_a_two_axis_mesh(enough_devices):
    """Each dp group runs its own pipeline over pp."""
    x, w = rng_normal(2, (3, 2, 8), (4, 8, 8))
    with RankMesh({"dp": 2, "pp": 4}, device="cpu") as m:
        got = pp.make_pipeline(m, 3)(t(x), t(w))
    np.testing.assert_allclose(got.numpy(),
                               pp.reference_pipeline(t(x), t(w)).numpy(),
                               **TOL)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_both(x, w_up, w_dn, assign, cap):
    n = w_up.shape[0]
    jmesh = jax.make_mesh((n,), ("ep",))
    sh = NamedSharding(jmesh, P("ep"))
    want = np.asarray(jmoe.make_moe_layer(jmesh, x.shape[1], cap)(
        *(jax.device_put(jnp.asarray(a), sh)
          for a in (x, w_up, w_dn, assign))))
    with RankMesh({"ep": n}, device="cpu") as m:
        got = moe_ep.make_moe_layer(m, x.shape[1], cap)(
            t(x), t(w_up), t(w_dn), t(assign))
    return got, want


def test_moe_matches_jax_and_reference(enough_devices):
    n, d, cap, per = 4, 8, 3, 6
    x, w_up, w_dn = rng_normal(1, (n * per, d), (n, d, 16), (n, 16, d))
    w_up, w_dn = w_up * 0.3, w_dn * 0.3
    assign = np.random.default_rng(2).integers(0, n, n * per).astype(
        np.int32)
    got, want = moe_both(x, w_up, w_dn, assign, cap)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ref = moe_ep.reference_moe(t(x), t(w_up), t(w_dn), t(assign), cap)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    np.testing.assert_allclose(
        ref.numpy(), jmoe.reference_moe(x, w_up, w_dn, assign, cap), **TOL)


def test_moe_capacity_drop(enough_devices):
    """Tokens beyond a (source, expert) capacity give zeros: every token
    to expert 0, capacity 1, so each rank's first token alone is kept."""
    n, d, cap, per = 4, 4, 1, 4
    x = np.ones((n * per, d), np.float32)
    w_up = np.full((n, d, 8), 0.1, np.float32)
    w_dn = np.full((n, 8, d), 0.1, np.float32)
    assign = np.zeros(n * per, np.int32)
    got, want = moe_both(x, w_up, w_dn, assign, cap)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for dev in range(n):
        blk = got[dev * per:(dev + 1) * per]
        assert blk[0].abs().sum() > 0
        assert torch.equal(blk[1:], torch.zeros_like(blk[1:]))


# ---------------------------------------------------------------------------
# ring and Ulysses attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sequence_parallel_attention(enough_devices, kind):
    h, seq, d, n = 8, 64, 16, 4
    q, k, v = rng_normal(5, *[(h, seq, d)] * 3)
    jmesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    sh = NamedSharding(jmesh, P(None, "sp", None))
    jmake = jra.make_ring_attention if kind == "ring" \
        else jra.make_ulysses_attention
    want = np.asarray(jmake(jmesh)(*(jax.device_put(jnp.asarray(a), sh)
                                     for a in (q, k, v))))
    make = ra.make_ring_attention if kind == "ring" \
        else ra.make_ulysses_attention
    with RankMesh({"sp": n}, device="cpu") as m:
        got = make(m)(t(q), t(k), t(v))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ref = ra.reference_attention(t(q), t(k), t(v))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(jra.reference_attention(q, k, v)), **TOL)


def test_ulysses_needs_heads_divisible_by_ranks():
    q = torch.zeros(6, 16, 4)
    with RankMesh({"sp": 4}, device="cpu") as m:
        with pytest.raises(ValueError, match="heads"):
            ra.make_ulysses_attention(m)(q, q, q)
