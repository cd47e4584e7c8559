"""The float32 route of the ring flash-attention kernel: its schedule,
modelled in torch on the CPU, against the plain version and the JAX
package's Pallas kernel.

``csrc/ring_flash_attn.cu`` runs float32 inputs on the CUDA cores
(``ring_flash_attn_kernel``). A CUDA kernel cannot run here, so
``f32_model`` below repeats its schedule step by step:

- a CTA takes the query rows [q0, q0 + BQ) of one head of one rank, and
  folds key tiles of BK keys, at the kernel's constants for the head-dim
  instance d falls in (kF32BQ/kF32BK up to DT 128, kF32BQ256/kF32BK256 at
  DT 256);
- its key tiles come in the ring's order, src = me, me - 1, ..., with the
  exact skips: under causal no block with src > me, and in the diagonal
  block no tile after the CTA's last query row;
- q is multiplied by scale·log2 e (rounded to float32) before the dot, and
  p = exp2(S - m): the kernel's exp2f with log2 e folded into the scale;
- within a tile the update order is m_new, safe_m, p, corr, l, acc, and o
  = acc / (l == 0 ? 1 : l).

The model is held to ``ring_flash_attention_ref`` and to the Pallas kernel
(interpret mode, as tests/test_torch_attention.py runs it) within the f32
tolerance the kernel is held to on the card (chip_smoke.py): rtol 2e-4,
atol 2e-5. The cases are adversarial: n in 1, 3 and 8; GQA 32 over 8 and
4 over 4; head dims 1, 8, 37 (no multiple of 4: the kernel's 4-byte
copies), 128 and 256; s_local 3, 37 and 100, ragged against every tile;
both maskings; a negative and a zero scale; a peaked softmax (q x 8) and
|v| up to 30. Under a peaked softmax two float32 evaluations of the same
function differ by about the tolerance, so there the model is held to the
float64 result instead: within the tolerance or, where the plain version
misses it too, within twice the plain version's distance; run as a script (`PYTHONPATH=. python
tests/test_torch_attention_f32.py` from the root of the repo), the module
prints those margins.
"""
import math
import os
import re

import numpy as np
import pytest
import torch

from ucc_tpu_torch.kernels import build
from ucc_tpu_torch.kernels import ring_attention as ka

F32_TOL = dict(rtol=2e-4, atol=2e-5)
#: the kernel's kLog2e
LOG2E = 1.4426950408889634
#: the f32 kernel's head-dim instances (by_dim)
HEAD_DIMS = (16, 32, 64, 128, 256)
#: the f32 kernel's tiles (csrc/ring_flash_attn.cu): query rows of a CTA
#: and keys of a tile up to DT 128, and at DT 256
TILES = {"kF32BQ": 128, "kF32BK": 64, "kF32BQ256": 64, "kF32BK256": 64}
#: threads of a CTA, 16 x 16
THREADS = 256
#: the shared memory a block can use on the H100
SMEM_LIMIT = 232448


def instance_dim(d):
    """The head-dim instance (DT) the kernel runs head dim d in."""
    return next(dt for dt in HEAD_DIMS if d <= dt)


def tiles(d):
    """(query rows of a CTA, keys of a tile) at head dim d."""
    if instance_dim(d) == 256:
        return TILES["kF32BQ256"], TILES["kF32BK256"]
    return TILES["kF32BQ"], TILES["kF32BK"]


def tile_walk(me, n, q0, s, causal, bq, bk):
    """The kernel's key tiles of the CTA of rank me at query row q0, in
    order: (src, j0) pairs, with the exact causal skips."""
    end = min(s, q0 + bq) if causal else s
    count = -(-end // bk) + (me if causal else n - 1) * -(-s // bk)
    src, j0, out = me, 0, []
    for _ in range(count):
        out.append((src, j0))
        j0 += bk
        if j0 >= end:
            j0, end, src = 0, s, (n - 1 if src == 0 else src - 1)
    return out


def every_tile(me, n, s, bk):
    """Every key tile of the ring in the kernel's order, none skipped."""
    return [((me - t) % n, j0) for t in range(n) for j0 in range(0, s, bk)]


def f32_model(qs, ks, vs, scale, causal, skip=True):
    """The f32 kernel's schedule on per-rank blocks, in torch. skip=False
    visits every tile of every block, masked by global position."""
    n = len(qs)
    h, s, d = qs[0].shape
    g = h // ks[0].shape[0]
    bq, bk = tiles(d)
    sl = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    neg_inf = torch.tensor(float("-inf"))
    outs = []
    for me in range(n):
        q = qs[me].float() * sl
        o = torch.empty(h, s, d)
        for q0 in range(0, s, bq):
            qt = q[:, q0:q0 + bq]
            rows = q0 + torch.arange(qt.shape[1])[:, None]
            m = torch.full(qt.shape[:2], float("-inf"))
            l = torch.zeros(qt.shape[:2])
            acc = torch.zeros(qt.shape)
            walk = (tile_walk(me, n, q0, s, causal, bq, bk) if skip
                    else every_tile(me, n, s, bk))
            for src, j0 in walk:
                k = ks[src][:, j0:j0 + bk].float().repeat_interleave(g, 0)
                v = vs[src][:, j0:j0 + bk].float().repeat_interleave(g, 0)
                sc = torch.einsum("hqd,hkd->hqk", qt, k)
                keys = j0 + torch.arange(k.shape[1])[None, :]
                if causal:
                    hidden = me * s + rows < src * s + keys
                    sc = torch.where(hidden[None], neg_inf, sc)
                m_new = torch.maximum(m, sc.amax(dim=-1))
                safe = torch.where(torch.isfinite(m_new), m_new,
                                   torch.zeros(()))
                p = torch.where(torch.isfinite(sc),
                                torch.exp2(sc - safe[..., None]),
                                torch.zeros(()))
                corr = torch.where(torch.isfinite(m), torch.exp2(m - safe),
                                   torch.zeros(()))
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + torch.einsum("hqk,hkd->hqd",
                                                           p, v)
                m = m_new
            den = torch.where(l == 0.0, torch.ones(()), l)
            o[:, q0:q0 + bq] = acc / den[..., None]
        outs.append(o)
    return outs


def case_inputs(n, h, h_kv, s, d, seed, q_mul=1.0, v_max=None):
    """Per-rank float32 blocks from a seed, q times q_mul, v normal or
    uniform in [-v_max, v_max]."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, h, s, d), dtype=np.float32) * q_mul
    k = rng.standard_normal((n, h_kv, s, d), dtype=np.float32)
    if v_max is None:
        v = rng.standard_normal((n, h_kv, s, d), dtype=np.float32)
    else:
        v = rng.uniform(-v_max, v_max, (n, h_kv, s, d)).astype(np.float32)
    return tuple([torch.from_numpy(x[r]) for r in range(n)]
                 for x in (q, k, v))


def assert_close(got, want):
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        torch.testing.assert_close(a, b.float(), **F32_TOL)


# ---------------------------------------------------------------------------
# the model against the plain version
# ---------------------------------------------------------------------------

#: every head dim x s_local x masking; n and the head layout rotate
SHAPES = [(d, s, causal) for d in (1, 8, 37, 128, 256) for s in (3, 37, 100)
          for causal in (False, True)]
RANKS = (1, 3, 8)
HEADS = ((32, 8), (4, 4))


@pytest.mark.parametrize("d,s,causal", SHAPES)
def test_model_holds_to_the_plain_version(d, s, causal):
    i = SHAPES.index((d, s, causal))
    n = RANKS[i % 3]
    h, h_kv = HEADS[i // 3 % 2]
    qs, ks, vs = case_inputs(n, h, h_kv, s, d, seed=i)
    scale = ka.default_scale(d)
    assert_close(f32_model(qs, ks, vs, scale, causal),
                 ka.ring_flash_attention_ref(qs, ks, vs, scale, causal))


#: name -> (n, h, h_kv, s_local, d, causal, q multiplier, max |v|)
ADVERSARIAL = {
    "peaked": (3, 32, 8, 100, 128, True, 8.0, None),
    "peaked_d256": (3, 4, 4, 37, 256, True, 8.0, None),
    "v_up_to_30": (8, 4, 4, 37, 37, False, 1.0, 30.0),
    "peaked_v_up_to_30": (8, 32, 8, 37, 128, True, 8.0, 30.0),
    "peaked_v_up_to_30_d1": (3, 4, 4, 100, 1, True, 8.0, 30.0),
    "peaked_v_up_to_30_d8": (1, 32, 8, 100, 8, False, 8.0, 30.0),
}


def adversarial_inputs(name):
    n, h, h_kv, s, d, causal, q_mul, v_max = ADVERSARIAL[name]
    qs, ks, vs = case_inputs(n, h, h_kv, s, d, sorted(ADVERSARIAL).index(
        name) + 100, q_mul, v_max)
    return qs, ks, vs, ka.default_scale(d), causal


def exact_attention(qs, ks, vs, scale, causal):
    """softmax(scale · q kᵀ) v of the whole sequence in float64, K/V heads
    repeated per group, split back into per-rank blocks."""
    n, s = len(qs), qs[0].shape[1]
    q, k, v = (torch.cat(b, dim=1).double() for b in (qs, ks, vs))
    g = q.shape[0] // k.shape[0]
    k, v = k.repeat_interleave(g, 0), v.repeat_interleave(g, 0)
    sc = torch.einsum("hqd,hkd->hqk", q * scale, k)
    if causal:
        seq = sc.shape[-1]
        later = torch.ones(seq, seq, dtype=torch.bool).triu(1)
        sc = sc.masked_fill(later[None], float("-inf"))
    return list(torch.einsum("hqk,hkd->hqd", sc.softmax(-1), v).split(s, 1))


def exact_margin(got, exact):
    """max |got - exact| / (atol + rtol·|exact|) at the f32 tolerance:
    above 1 misses it."""
    return max(((a.double() - b).abs() /
                (F32_TOL["atol"] + F32_TOL["rtol"] * b.abs())).max().item()
               for a, b in zip(got, exact))


#: how much further from the float64 result than the plain version the
#: model may be, where the plain version itself misses the tolerance
PLAIN_FACTOR = 2.0


@pytest.mark.parametrize("name", sorted(ADVERSARIAL))
def test_model_holds_on_adversarial_inputs(name):
    """A peaked softmax puts float32's rounding of S at the tolerance: the
    plain version itself is up to 6.9 tolerances from the float64 result
    when |v| reaches 30 (run this file as a script for the margins). So
    the model is held to the float64 result, within the tolerance or, where
    the plain version (the JAX package's arithmetic) misses it too, within
    PLAIN_FACTOR times the plain version's margin; chip_smoke.py holds the
    kernel so at the main widths with q x 8."""
    qs, ks, vs, scale, causal = adversarial_inputs(name)
    exact = exact_attention(qs, ks, vs, scale, causal)
    got = f32_model(qs, ks, vs, scale, causal)
    assert all(torch.isfinite(a).all() for a in got)
    plain = exact_margin(ka.ring_flash_attention_ref(qs, ks, vs, scale,
                                                     causal), exact)
    assert exact_margin(got, exact) <= max(1.0, PLAIN_FACTOR * plain)


@pytest.mark.parametrize("scale", [-0.125, 0.0])
@pytest.mark.parametrize("n,d,s", [(3, 37, 100), (8, 128, 37), (1, 256, 3)])
def test_model_holds_for_a_negative_and_a_zero_scale(n, d, s, scale):
    """The kernel scales q before the row max, so any sign of scale is the
    plain version's softmax; a zero scale averages v."""
    qs, ks, vs = case_inputs(n, 4, 4, s, d, seed=n + d + s)
    got = f32_model(qs, ks, vs, scale, True)
    assert_close(got, ka.ring_flash_attention_ref(qs, ks, vs, scale, True))


def test_causal_first_row_is_its_own_value():
    """Rank 0's row 0 sees one key: the model gives v[0] exactly, with
    nothing of the masked keys leaking in."""
    qs, ks, vs = case_inputs(3, 4, 4, 37, 37, seed=7)
    got = f32_model(qs, ks, vs, ka.default_scale(37), True)
    assert torch.equal(got[0][:, 0], vs[0][:, 0])


# ---------------------------------------------------------------------------
# the schedule: tiles, skips and constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,s,d", [(1, 3, 8), (3, 37, 37), (8, 100, 128),
                                   (3, 300, 256), (2, 129, 64)])
def test_skips_are_exact(n, s, d, causal):
    """Skipping the wholly masked blocks and diagonal tiles gives the same
    o, bit for bit, as folding every tile of every block masked."""
    qs, ks, vs = case_inputs(n, 4, 2, s, d, seed=s + d)
    scale = ka.default_scale(d)
    got = f32_model(qs, ks, vs, scale, causal)
    want = f32_model(qs, ks, vs, scale, causal, skip=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("d", [8, 256])
@pytest.mark.parametrize("n,s", [(1, 3), (3, 37), (8, 100), (2, 300),
                                 (4, 129)])
def test_walk_keeps_exactly_the_tiles_with_a_visible_key(n, s, d):
    """Under causal a CTA's kept tiles are those where one of its rows
    sees one key; without masking, every tile of every block. Each once,
    blocks in the ring's order."""
    bq, bk = tiles(d)
    for me in range(n):
        for q0 in range(0, s, bq):
            rows = range(q0, min(q0 + bq, s))
            visible = [(src, j0) for src, j0 in every_tile(me, n, s, bk)
                       if any(me * s + r >= src * s + j0 for r in rows)]
            assert tile_walk(me, n, q0, s, True, bq, bk) == visible
            assert tile_walk(me, n, q0, s, False, bq, bk) == \
                every_tile(me, n, s, bk)


def _source():
    with open(os.path.join(build.CSRC, ka.SOURCE)) as fh:
        return fh.read()


def test_model_tiles_are_the_kernels():
    """The model's tile constants are those of csrc/ring_flash_attn.cu,
    and so are its instances and thread count."""
    text = _source()
    for name, value in TILES.items():
        hit = re.search(rf"constexpr int {name} = (\d+);", text)
        assert hit, f"{name} is no longer a constexpr of the source"
        assert int(hit.group(1)) == value, name
    assert re.search(rf"constexpr int kF32Threads = {THREADS};", text)
    dims = [int(x) for x in re.findall(r"return launch<(\d+), VEC>", text)]
    assert dims == list(HEAD_DIMS)


@pytest.mark.parametrize("dt", HEAD_DIMS)
def test_tiles_fit_a_block_and_the_register_plan(dt):
    """Each instance's Q, K, V and P tiles fit the 227 KB a block may use,
    and at DT 128 a thread holds at least 8 x 4 scores and 8 x 8 outputs,
    read at 8 FFMA or more a 128-bit load in both inner loops."""
    bq, bk = tiles(dt)
    assert bq % 16 == 0 and bk % 16 == 0
    smem = 4 * ((bq + 2 * bk) * (dt + 4) + bq * (bk + 16))
    assert smem <= SMEM_LIMIT
    rows, keys, cols = bq // 16, bk // 16, dt // 16
    assert rows * 16 * keys * 16 == bq * bk
    assert rows * 16 * cols * 16 == bq * dt
    if dt >= 128:
        # S: rows Q loads and keys K loads for rows·keys·4 FFMA; P·V: rows
        # P loads and 4·cols/4 V loads for rows·cols·4 FFMA
        assert rows * keys * 4 >= 8 * (rows + keys)
        assert rows * cols * 4 >= 8 * (rows + cols)
    if dt == 128:
        assert rows >= 8 and keys >= 4 and cols >= 8


# ---------------------------------------------------------------------------
# the model against the Pallas kernel
# ---------------------------------------------------------------------------

def jax_attention(n, causal, q, k, v, scale=None):
    """The JAX package's ring attention (the Pallas kernel in interpret
    mode) on a 1-axis mesh of n virtual CPU devices; float32 numpy out."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from ucc_tpu import fused_attention as jfa
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    sh = NamedSharding(mesh, P(None, "sp", None))
    fn = jfa.make_ring_flash_attention(mesh, causal=causal, scale=scale,
                                       axis="sp")
    out = fn(*(jax.device_put(jnp.asarray(x), sh) for x in (q, k, v)))
    return np.asarray(jax.device_get(out).astype(jnp.float32))


@pytest.mark.parametrize("n,h,h_kv,s,d,causal,scale", [
    (1, 4, 4, 100, 1, True, None),
    (3, 4, 4, 37, 37, True, None),
    (3, 8, 2, 3, 256, False, -0.125),
    (8, 32, 8, 3, 8, True, None),
])
def test_model_holds_to_the_pallas_kernel(n, h, h_kv, s, d, causal, scale):
    rng = np.random.default_rng(n * 1000 + d)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32)
               for shape in ((h, n * s, d), (h_kv, n * s, d),
                             (h_kv, n * s, d)))
    want = jax_attention(n, causal, q, k, v, scale)
    blocks = [[torch.from_numpy(np.ascontiguousarray(x[:, r * s:(r + 1) * s]))
               for r in range(n)] for x in (q, k, v)]
    got = torch.cat(f32_model(*blocks, ka.default_scale(d) if scale is None
                              else scale, causal), dim=1)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_model_is_the_kernel_arithmetic_not_the_plain_version():
    """The model differs from the plain version somewhere (exp2 with the
    folded scale, tiles), so the tolerance tests test the schedule and
    not an identity."""
    qs, ks, vs = case_inputs(3, 4, 4, 100, 128, seed=3, q_mul=8.0)
    scale = ka.default_scale(128)
    got = f32_model(qs, ks, vs, scale, True)
    want = ka.ring_flash_attention_ref(qs, ks, vs, scale, True)
    assert any(not torch.equal(a, b) for a, b in zip(got, want))
    assert math.isclose(float(torch.tensor(scale) * torch.tensor(LOG2E)),
                        scale * LOG2E, rel_tol=1e-6)


if __name__ == "__main__":
    # each adversarial case's margins at the f32 tolerance (above 1 misses
    # it): model and plain version against float64, and model against the
    # plain version
    for name in sorted(ADVERSARIAL):
        qs, ks, vs, scale, causal = adversarial_inputs(name)
        exact = exact_attention(qs, ks, vs, scale, causal)
        got = f32_model(qs, ks, vs, scale, causal)
        ref = ka.ring_flash_attention_ref(qs, ks, vs, scale, causal)
        print(f"{name:22s} vs float64: model {exact_margin(got, exact):.4f}"
              f", plain {exact_margin(ref, exact):.4f}; model vs plain "
              f"{exact_margin(got, [r.double() for r in ref]):.4f}")
