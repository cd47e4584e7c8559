"""The long-context GQA block of the port against the JAX package's
``examples/long_context.py``, on the CPU.

``ucc_tpu_torch.examples.long_context.GqaRingAttentionBlock`` runs the
forward of ``make_gqa_train_step``'s loss over a ring of ranks. With the
JAX package's weights (``init_gqa_params``, carried across by
``params_from_jax``) and the same numpy tokens, its ``gqa_loss`` must equal
the loss the JAX train step returns on a (dp 2, sp 4) mesh, and its output
must equal dense attention computed with numpy. Tolerance: float32 rtol
2e-4 / atol 2e-5, the reference's own (tests/test_ring_attention.py).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ucc_tpu.examples import long_context as jlc  # noqa: E402
from ucc_tpu_torch.examples.long_context import (  # noqa: E402
    GqaRingAttentionBlock, gqa_loss, init_gqa_params, params_from_jax)
from ucc_tpu_torch.status import Status, UccError  # noqa: E402

F32_TOL = dict(rtol=2e-4, atol=2e-5)
HEADS, KV_HEADS, E, DM = 8, 2, 4, 16


def tokens(batch, seq, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, seq, DM), dtype=np.float32)
    y = rng.standard_normal((batch, seq, DM), dtype=np.float32) * 0.1
    return x, y


def per_rank(a, n):
    """A (batch, seq, dm) array as n contiguous sequence blocks."""
    return [t.contiguous() for t in torch.from_numpy(a).split(
        a.shape[1] // n, dim=1)]


def dense_block(params, x, causal):
    """The block over the whole sequence, in float64 with numpy."""
    w = {k: np.asarray(v, np.float64) for k, v in params.items()}
    b, seq, _ = x.shape
    g = HEADS // KV_HEADS
    q = (x @ w["wq"]).reshape(b, seq, HEADS, E).transpose(0, 2, 1, 3)
    k = (x @ w["wk"]).reshape(b, seq, KV_HEADS, E).transpose(0, 2, 1, 3)
    v = (x @ w["wv"]).reshape(b, seq, KV_HEADS, E).transpose(0, 2, 1, 3)
    k, v = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    s = np.einsum("bhqe,bhke->bhqk", q, k) / np.sqrt(E)
    if causal:
        s = np.where(np.tril(np.ones((seq, seq), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    attn = np.einsum("bhqk,bhke->bhqe", p, v)
    return attn.transpose(0, 2, 1, 3).reshape(b, seq, HEADS * E) @ w["wo"]


def test_gqa_loss_matches_make_gqa_train_step():
    mesh = jax.make_mesh((2, 4), ("dp", "sp"))
    jparams = jlc.init_gqa_params(DM, HEADS, KV_HEADS, E)
    x, y = tokens(4, 32, seed=5)
    sh = NamedSharding(mesh, P("dp", "sp", None))
    step = jlc.make_gqa_train_step(mesh, HEADS, KV_HEADS, E, lr=0.05)
    out = step(jparams["wq"], jparams["wk"], jparams["wv"], jparams["wo"],
               jax.device_put(x, sh), jax.device_put(y, sh))
    want = float(jax.device_get(out[0]))

    block = GqaRingAttentionBlock(params_from_jax(jparams, device="cpu"),
                                  HEADS, KV_HEADS, E, causal=True)
    got = gqa_loss(block, per_rank(x, 4), per_rank(y, 4))
    np.testing.assert_allclose(got.item(), want, **F32_TOL)


def random_params(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape, dtype=np.float32) * 0.1
            for k, shape in (("wq", (DM, HEADS * E)),
                             ("wk", (DM, KV_HEADS * E)),
                             ("wv", (DM, KV_HEADS * E)),
                             ("wo", (HEADS * E, DM)))}


@pytest.mark.parametrize("n,causal", [(1, True), (4, True), (8, False)])
def test_block_matches_dense_attention(n, causal):
    params = random_params(n)
    x, _ = tokens(2, 24, seed=10 + n)
    block = GqaRingAttentionBlock(params_from_jax(params, device="cpu"),
                                  HEADS, KV_HEADS, E, causal=causal)
    with torch.no_grad():
        outs = block(per_rank(x, n))
    assert len(outs) == n and all(o.shape == (2, 24 // n, DM) for o in outs)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(),
                               dense_block(params, x, causal), **F32_TOL)


def test_weight_gradients_match_dense_attention():
    """The loss's weight gradients flow through the ring attention's
    backward (the plain version differentiated) and equal those of the
    same loss written densely in torch."""
    x, y = tokens(2, 16, seed=4)
    params = params_from_jax(random_params(3), device="cpu")
    block = GqaRingAttentionBlock(params, HEADS, KV_HEADS, E, causal=True)
    gqa_loss(block, per_rank(x, 4), per_rank(y, 4)).backward()

    w = {k: v.clone().requires_grad_() for k, v in params.items()}
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    g = HEADS // KV_HEADS

    def heads_of(t, h):
        return t.reshape(2, 16, h, E).transpose(1, 2)

    q = heads_of(tx @ w["wq"], HEADS)
    k = heads_of(tx @ w["wk"], KV_HEADS).repeat_interleave(g, dim=1)
    v = heads_of(tx @ w["wv"], KV_HEADS).repeat_interleave(g, dim=1)
    s = q @ k.transpose(-1, -2) / E ** 0.5
    s = s.masked_fill(~torch.ones(16, 16, dtype=torch.bool).tril(),
                      float("-inf"))
    attn = (s.softmax(-1) @ v).transpose(1, 2).reshape(2, 16, HEADS * E)
    ((attn @ w["wo"] - ty) ** 2).mean().backward()
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_allclose(getattr(block, name).grad.numpy(),
                                   w[name].grad.numpy(), rtol=2e-4,
                                   atol=2e-6, err_msg=name)


def test_init_gqa_params_shapes_and_seed():
    p1 = init_gqa_params(32, 8, 2, 16, device="cpu")
    p2 = init_gqa_params(32, 8, 2, 16, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p1.items()} == {
        "wq": (32, 128), "wk": (32, 32), "wv": (32, 32), "wo": (128, 32)}
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert 0.08 < p1["wq"].std().item() < 0.12
    bf = init_gqa_params(32, 8, 2, 16, device="cpu", dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in bf.values())
    assert torch.equal(bf["wo"], p1["wo"].bfloat16())


def test_params_from_jax_carries_the_weights():
    jparams = jlc.init_gqa_params(DM, HEADS, KV_HEADS, E)
    params = params_from_jax(jparams, device="cpu")
    for name, w in jparams.items():
        assert params[name].dtype == torch.float32
        np.testing.assert_array_equal(params[name].numpy(), np.asarray(w))


def test_mismatched_heads_raise():
    params = init_gqa_params(DM, 6, 4, E, device="cpu")
    with pytest.raises(ValueError):
        GqaRingAttentionBlock(params, 6, 4, E)


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert init_gqa_params(8, 2, 1, 4)["wq"].device.type == "cuda"
    else:
        with pytest.raises(UccError) as ei:
            init_gqa_params(8, 2, 1, 4)
        assert ei.value.status == Status.ERR_NO_RESOURCE
