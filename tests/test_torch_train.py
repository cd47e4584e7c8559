"""The port's long-context train steps against the JAX package's, on the
CPU.

``ucc_tpu_torch.examples.long_context`` runs the MHA and GQA train steps
over a ``RankMesh({"dp": 2, "sp": 4}, device="cpu")``: per-rank loss, its
``ops.allreduce(AVG)`` over ("sp", "dp"), backward through the ring
attention (the plain version forward on CPU tensors, the per-query-rank
recompute of ``fused_attention.ring_shard`` backward), one library
allreduce(AVG) per weight, SGD. The JAX side runs ``make_train_step`` and
``make_gqa_train_step`` on the virtual (2, 4) mesh at the sizes of
tests/test_ring_attention.py, from the same weights (``init_params`` /
``init_gqa_params``, carried across by ``params_from_jax``) and the same
numpy tokens.

Tolerances: loss and new weights within rtol 1e-5, atol 1e-6 of JAX's
step (float32: both sum the same products in another order, and the
update moves the weights by lr·grad, so their rounding stays at the
weights' ulp); the replicas bitwise equal; the update within rtol 1e-4,
atol 1e-6 of -lr times the dense single-rank gradient of the global mean
loss (the JAX test's own), and the averaged gradients within the same of
that gradient; the recompute's gradients within float32
rtol 2e-4 / atol 2e-5 of jax.vjp of ``_xla_ring_shard`` (the reference's
attention tolerance).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ucc_tpu import fused_attention as jfa  # noqa: E402
from ucc_tpu.examples import long_context as jlc  # noqa: E402
from ucc_tpu.utils.jaxshim import shard_map_compat  # noqa: E402
from ucc_tpu_torch.examples import long_context as lc  # noqa: E402
from ucc_tpu_torch.fused_attention import (  # noqa: E402
    ring_flash_attention, ring_shard)
from ucc_tpu_torch.mesh import RankMesh  # noqa: E402

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
F32_TOL = dict(rtol=2e-4, atol=2e-5)
LR = 0.05
MHA = dict(heads=2, d=4, batch=4, seq=32)
GQA = dict(heads=8, kv_heads=2, e=4, dm=16, batch=4, seq=32)
MHA_SPEC, GQA_SPEC = ("dp", None, "sp"), ("dp", "sp")


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    port = RankMesh({"dp": 2, "sp": 4}, device="cpu")
    yield jax.make_mesh((2, 4), ("dp", "sp")), port
    port.destroy()


def tokens(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32) * 0.1)


def mha_case(seed):
    jparams = jlc.init_params(MHA["heads"], MHA["d"])
    x, y = tokens((MHA["batch"], MHA["heads"], MHA["seq"], MHA["d"]), seed)
    return jparams, x, y


def gqa_case(seed):
    jparams = jlc.init_gqa_params(GQA["dm"], GQA["heads"], GQA["kv_heads"],
                                  GQA["e"])
    x, y = tokens((GQA["batch"], GQA["seq"], GQA["dm"]), seed)
    return jparams, x, y


def jax_steps(jmesh, kind, jparams, x, y, n_steps):
    if kind == "mha":
        step = jlc.make_train_step(jmesh, lr=LR)
        spec = P("dp", None, "sp", None)
    else:
        step = jlc.make_gqa_train_step(jmesh, GQA["heads"], GQA["kv_heads"],
                                       GQA["e"], lr=LR)
        spec = P("dp", "sp", None)
    sh = NamedSharding(jmesh, spec)
    x, y = jax.device_put(x, sh), jax.device_put(y, sh)
    w = [jparams[k] for k in lc.WEIGHTS]
    out = []
    for _ in range(n_steps):
        res = step(*w, x, y)
        w = list(res[1:])
        out.append((float(jax.device_get(res[0])),
                    [np.asarray(jax.device_get(a)) for a in w]))
    return out


def port_step(pmesh, kind):
    if kind == "mha":
        return lc.make_train_step(pmesh, lr=LR), MHA_SPEC
    return lc.make_gqa_train_step(pmesh, GQA["heads"], GQA["kv_heads"],
                                  GQA["e"], lr=LR), GQA_SPEC


def assert_replicated(params):
    for name, reps in params.items():
        for r in reps[1:]:
            assert torch.equal(r, reps[0]), name


@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_steps_match_jax(meshes, kind):
    """Two steps from the JAX package's weights: loss and new weights of
    each step within STEP_TOL of JAX's, the replicas bitwise equal."""
    jmesh, pmesh = meshes
    jparams, x, y = (mha_case if kind == "mha" else gqa_case)(seed=3)
    want = jax_steps(jmesh, kind, jparams, x, y, 2)
    step, spec = port_step(pmesh, kind)
    params = lc.replicate(lc.params_from_jax(jparams, device="cpu"), pmesh)
    xs = pmesh.shard(torch.from_numpy(x), spec)
    ys = pmesh.shard(torch.from_numpy(y), spec)
    for wloss, wweights in want:
        losses, params = step(params, xs, ys)
        assert all(torch.equal(v, losses[0]) for v in losses)
        np.testing.assert_allclose(losses[0].item(), wloss, **STEP_TOL)
        assert_replicated(params)
        for name, w in zip(lc.WEIGHTS, wweights):
            np.testing.assert_allclose(params[name][0].numpy(), w,
                                       err_msg=name, **STEP_TOL)


@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_loss_falls_over_six_steps(meshes, kind):
    _, pmesh = meshes
    jparams, x, y = (mha_case if kind == "mha" else gqa_case)(seed=5)
    step, spec = port_step(pmesh, kind)
    params = lc.replicate(lc.params_from_jax(jparams, device="cpu"), pmesh)
    xs = pmesh.shard(torch.from_numpy(x), spec)
    ys = pmesh.shard(torch.from_numpy(y), spec)
    losses = []
    for _ in range(6):
        out, params = step(params, xs, ys)
        losses.append(out[0].item())
        assert_replicated(params)
    assert losses[-1] < losses[0], losses


def test_mha_update_is_the_dense_gradient(meshes):
    """The applied update equals -lr · the gradient of the global mean
    loss computed densely on one rank (tests/test_ring_attention.py's
    test_grads_match_dense, for the port)."""
    _, pmesh = meshes
    jparams, x, y = mha_case(seed=7)
    params = lc.params_from_jax(jparams, device="cpu")
    d, seq = MHA["d"], MHA["seq"]
    w = {k: v.clone().requires_grad_() for k, v in params.items()}
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    q, k, v = (torch.einsum("bhsd,hde->bhse", tx, w[n])
               for n in ("wq", "wk", "wv"))
    s = torch.einsum("bhse,bhte->bhst", q, k) / d ** 0.5
    s = s.masked_fill(~torch.ones(seq, seq, dtype=torch.bool).tril(),
                      float("-inf"))
    out = torch.einsum("bhse,hed->bhsd", torch.einsum(
        "bhst,bhte->bhse", s.softmax(-1), v), w["wo"])
    ((out - ty) ** 2).mean().backward()

    step, spec = port_step(pmesh, "mha")
    step.keep_grads = True
    _, new = step(lc.replicate(params, pmesh), pmesh.shard(tx, spec),
                  pmesh.shard(ty, spec))
    for name in lc.WEIGHTS:
        want = (params[name] - LR * w[name].grad).numpy()
        np.testing.assert_allclose(new[name][0].numpy(), want, rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        # the averaged gradient the update used, on every rank
        for g in step.grads[name]:
            np.testing.assert_allclose(g.numpy(), w[name].grad.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("h,h_kv", [(4, 4), (8, 2)])
def test_recompute_matches_jax_vjp_of_xla_ring_shard(h, h_kv, causal):
    """The backward's query-rank recompute (ring_shard, one rank at a
    time) against jax.vjp of _xla_ring_shard under shard_map, with the
    same cotangents."""
    n, s, d, scale = 4, 6, 8, 0.3
    rng = np.random.default_rng(h + int(causal))
    q = rng.standard_normal((h, n * s, d), dtype=np.float32)
    k, v = (rng.standard_normal((h_kv, n * s, d), dtype=np.float32)
            for _ in range(2))
    cot = rng.standard_normal((h, n * s, d), dtype=np.float32)
    jmesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    spec = P(None, "sp", None)
    f = shard_map_compat(
        lambda a, b, c: jfa._xla_ring_shard(a, b, c, n, scale, causal, "sp"),
        jmesh, (spec,) * 3, spec)
    sh = NamedSharding(jmesh, spec)

    @jax.jit
    def out_and_vjp(a, b, c, g):
        out, vjp = jax.vjp(f, a, b, c)
        return out, vjp(g)

    out, want = out_and_vjp(*(jax.device_put(jnp.asarray(t), sh)
                              for t in (q, k, v, cot)))
    want = [np.asarray(g) for g in want]

    def blocks(a):
        return [t.contiguous().requires_grad_()
                for t in torch.from_numpy(a).split(s, dim=1)]

    qs, ks, vs = blocks(q), blocks(k), blocks(v)
    outs = ring_flash_attention(qs, ks, vs, scale=scale, causal=causal)
    np.testing.assert_allclose(torch.cat(outs, 1).detach().numpy(),
                               np.asarray(out), **F32_TOL)
    torch.autograd.backward(outs, list(torch.from_numpy(cot).split(s, 1)))
    for got, w in zip((qs, ks, vs), want):
        np.testing.assert_allclose(
            torch.cat([t.grad for t in got], 1).numpy(), w, **F32_TOL)
    # ring_shard alone is rank me's forward of the plain ring
    for me in range(n):
        torch.testing.assert_close(
            ring_shard(qs[me], ks, vs, me, scale, causal), outs[me],
            rtol=0, atol=0)


def test_run_one_step_and_helpers(meshes):
    _, pmesh = meshes
    loss = lc.run_one_step(pmesh, 4, 2, 32, 4)
    assert np.isfinite(loss) and loss > 0
    p = lc.init_params(2, 4, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: (2, 4, 4) for k in lc.WEIGHTS}
    reps = lc.replicate(p, pmesh)
    assert all(len(r) == 8 for r in reps.values())
    assert reps["wq"][0].data_ptr() != reps["wq"][1].data_ptr()
    with pytest.raises(ValueError, match="divide"):
        lc.make_gqa_train_step(pmesh, 6, 4, 4)


def test_timed_step_splits_its_time(meshes):
    _, pmesh = meshes
    jparams, x, y = gqa_case(seed=9)
    step, spec = port_step(pmesh, "gqa")
    step.timed = True
    step(lc.replicate(lc.params_from_jax(jparams, device="cpu"), pmesh),
         pmesh.shard(torch.from_numpy(x), spec),
         pmesh.shard(torch.from_numpy(y), spec))
    assert set(step.last) == {"forward", "backward", "grad_avg", "update"}
    assert all(t >= 0 for t in step.last.values())
