"""The tensor-core route of the ring flash-attention kernel: its precision
scheme, modelled in torch on the CPU, against the plain version.

``csrc/ring_flash_attn.cu`` runs float16 and bfloat16 inputs on the tensor
cores (``ring_flash_attn_tc_kernel``). A CUDA kernel cannot run here, so
``tc_model`` below repeats its roundings step by step:

- q, k and v stay in their 16-bit type; their products are exact in
  float32 and sum in float32;
- ``scale`` (folded with log2 e, for exp2) multiplies the scores after the
  product;
- keys come in tiles of the kernel's width, 64, each folded into the
  running max, normalizer and accumulator;
- p enters the P·V product as two halves of the input's type, hi = rn(p)
  and lo = rn(p - hi); for float16, p is computed times 2^15 (and l too)
  so that lo stays clear of the subnormals.

The model must hold to ``ring_flash_attention_ref`` within the same
tolerances the kernel is held to on the card (chip_smoke.py): one ulp of
the type, bfloat16 rtol 2^-7 and float16 rtol 2^-10, atol 1e-3. The
inputs are adversarial: a peaked softmax (q x 8), |v| up to 30, the causal
first rows, a ragged 37 rows, head dims 1 and 256, GQA 32 over 8.

Run as a script (`PYTHONPATH=. python tests/test_torch_attention_tc.py`
from the root of the repo), the module prints each case's margin, the largest
|model - plain| over atol + rtol·|plain|, for the split and for one
rounding of p: a margin above 1 fails the tolerance.
"""
import math

import numpy as np
import pytest
import torch

from ucc_tpu_torch.kernels import ring_attention as ka

#: (rtol, atol) of the 16-bit types, as chip_smoke.attention_tolerance
TOL = {torch.bfloat16: (2.0 ** -7, 1e-3), torch.float16: (2.0 ** -10, 1e-3)}
#: the tensor-core kernel's key tile (kTcBK)
KEY_TILE = 64


def tc_model(qs, ks, vs, scale, causal, split=True, key_tile=KEY_TILE):
    """The tensor-core kernel's arithmetic on per-rank blocks, in torch."""
    n = len(qs)
    h, s, d = qs[0].shape
    h_kv = ks[0].shape[0]
    g = h // h_kv
    dt = qs[0].dtype
    plog2 = 15.0 if dt == torch.float16 else 0.0
    sl2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    iq = torch.arange(g * s).remainder(s)[:, None]
    outs = []
    for me in range(n):
        q = qs[me].float().reshape(h_kv, g * s, d)
        m = torch.full((h_kv, g * s), float("-inf"))
        l = torch.zeros(h_kv, g * s)
        acc = torch.zeros(h_kv, g * s, d)
        for t in range(n):
            src = (me - t) % n
            if causal and src > me:
                continue
            for j0 in range(0, s, key_tile):
                k = ks[src][:, j0:j0 + key_tile].float()
                v = vs[src][:, j0:j0 + key_tile].float()
                sc = torch.einsum("hqd,hkd->hqk", q, k) * sl2
                if causal and src == me:
                    ik = j0 + torch.arange(k.shape[1])[None, :]
                    sc = sc.masked_fill((ik > iq)[None], float("-inf"))
                m_new = torch.maximum(m, sc.amax(dim=-1))
                safe = torch.where(m_new == float("-inf"),
                                   torch.zeros(()), m_new)
                corr = torch.exp2(m - safe)
                p = torch.exp2(sc - (safe - plog2)[..., None])
                l = l * corr + p.sum(dim=-1)
                hi = p.to(dt)
                pv = torch.einsum("hqk,hkd->hqd", hi.float(), v)
                if split:
                    lo = (p - hi.float()).to(dt)
                    pv = pv + torch.einsum("hqk,hkd->hqd", lo.float(), v)
                acc = acc * corr[..., None] + pv
                m = m_new
        den = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append((acc / den[..., None]).reshape(h, s, d).to(dt))
    return outs


#: name -> (n, h, h_kv, s_local, d, causal, q multiplier, max |v|)
CASES = {
    "peaked": (2, 4, 2, 64, 64, True, 8.0, None),
    "v_up_to_30": (2, 4, 2, 64, 64, False, 1.0, 30.0),
    "peaked_v_up_to_30": (2, 4, 2, 128, 64, True, 8.0, 30.0),
    "causal_first_rows": (4, 2, 2, 16, 16, True, 1.0, None),
    "ragged_37": (2, 4, 4, 37, 32, True, 1.0, None),
    "head_dim_1": (2, 4, 4, 40, 1, True, 1.0, None),
    "head_dim_256": (2, 2, 1, 70, 256, True, 1.0, None),
    "gqa_32_8": (2, 32, 8, 24, 16, True, 1.0, None),
}


def case_inputs(name, dtype):
    n, h, h_kv, s, d, causal, qmul, vmax = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.standard_normal((n, h, s, d), dtype=np.float32) * qmul
    k = rng.standard_normal((n, h_kv, s, d), dtype=np.float32)
    if vmax is None:
        v = rng.standard_normal((n, h_kv, s, d), dtype=np.float32)
    else:
        v = rng.uniform(-vmax, vmax, (n, h_kv, s, d)).astype(np.float32)
    qs, ks, vs = ([torch.from_numpy(x[r]).to(dtype) for r in range(n)]
                  for x in (q, k, v))
    return qs, ks, vs, ka.default_scale(d), causal


def margin(got, want):
    """max |got - want| / (atol + rtol·|want|) over every rank's block."""
    rtol, atol = TOL[want[0].dtype]
    return max(((a.float() - b.float()).abs() /
                (atol + rtol * b.float().abs())).max().item()
               for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_p_holds_to_the_plain_version(name, dtype):
    qs, ks, vs, scale, causal = case_inputs(name, dtype)
    got = tc_model(qs, ks, vs, scale, causal)
    want = ka.ring_flash_attention_ref(qs, ks, vs, scale, causal)
    rtol, atol = TOL[dtype]
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("dtype,scale", [(torch.bfloat16, -0.125),
                                         (torch.float16, 0.0)])
def test_split_p_holds_for_a_negative_and_a_zero_scale(dtype, scale):
    """The kernel scales S before its row max, so any sign of scale is the
    plain version's softmax."""
    qs, ks, vs, _, causal = case_inputs("ragged_37", dtype)
    got = tc_model(qs, ks, vs, scale, causal)
    want = ka.ring_flash_attention_ref(qs, ks, vs, scale, causal)
    rtol, atol = TOL[dtype]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=atol)


def test_causal_first_row_is_its_own_value():
    """Rank 0's row 0 sees one key: the model gives v[0] rounded, as the
    plain version does, with nothing of the masked keys leaking in."""
    qs, ks, vs, scale, causal = case_inputs("causal_first_rows",
                                            torch.bfloat16)
    got = tc_model(qs, ks, vs, scale, causal)
    assert torch.equal(got[0][:, 0], vs[0][:, 0])


def test_the_model_is_the_kernel_arithmetic_not_the_plain_version():
    """The model differs from the plain version somewhere (it rounds p), so
    the tolerance tests above test the scheme and not an identity."""
    qs, ks, vs, scale, causal = case_inputs("peaked_v_up_to_30",
                                            torch.bfloat16)
    got = tc_model(qs, ks, vs, scale, causal, split=False)
    want = ka.ring_flash_attention_ref(qs, ks, vs, scale, causal)
    assert any(not torch.equal(a, b) for a, b in zip(got, want))


def test_tensor_core_route_is_chosen_by_dtype():
    """float16 and bfloat16 count as tensor-core launches, float32 does
    not; on the card chip_smoke.py holds the counts of the GQA block's run
    and the HGMMA instructions of each kernel instance."""
    assert set(ka.TENSOR_CORE_DTYPES) == {torch.float16, torch.bfloat16}
    assert set(ka.TENSOR_CORE_DTYPES) < set(ka.DTYPE_CODES)
    assert torch.float32 not in ka.TENSOR_CORE_DTYPES


def test_cpu_tensors_count_no_tensor_core_launch():
    qs, ks, vs, scale, causal = case_inputs("ragged_37", torch.bfloat16)
    before = (ka.ring_flash_attention_fwd.launches,
              ka.ring_flash_attention_fwd.tc_launches)
    got = ka.ring_flash_attention_fwd(qs, ks, vs, scale, causal)
    assert (ka.ring_flash_attention_fwd.launches,
            ka.ring_flash_attention_fwd.tc_launches) == before
    want = ka.ring_flash_attention_ref(qs, ks, vs, scale, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_model_holds_to_the_pallas_kernel():
    """The model against the JAX package's Pallas kernel (interpret mode)
    on the same bfloat16 inputs, within one bf16 ulp."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import ml_dtypes
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from ucc_tpu import fused_attention as jfa
    n, h, h_kv, seq, d = 4, 8, 2, 64, 8
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32)
               .astype(ml_dtypes.bfloat16)
               for shape in ((h, seq, d), (h_kv, seq, d), (h_kv, seq, d)))
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    sh = NamedSharding(mesh, P(None, "sp", None))
    fn = jfa.make_ring_flash_attention(mesh, causal=True, axis="sp")
    want = np.asarray(jax.device_get(fn(*(jax.device_put(jnp.asarray(x), sh)
                                          for x in (q, k, v))))
                      .astype(jnp.float32))
    blocks = [[torch.from_numpy(x.astype(np.float32)).bfloat16()
               [:, r * seq // n:(r + 1) * seq // n].contiguous()
               for r in range(n)] for x in (q, k, v)]
    got = torch.cat(tc_model(*blocks, ka.default_scale(d), True), dim=1)
    rtol, atol = TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)


if __name__ == "__main__":
    for dtype in (torch.bfloat16, torch.float16):
        for name in sorted(CASES):
            qs, ks, vs, scale, causal = case_inputs(name, dtype)
            want = ka.ring_flash_attention_ref(qs, ks, vs, scale, causal)
            split = margin(tc_model(qs, ks, vs, scale, causal), want)
            one = margin(tc_model(qs, ks, vs, scale, causal, split=False),
                         want)
            print(f"{str(dtype):15s} {name:18s} margin split {split:.4f} "
                  f"one rounding {one:.4f}")
