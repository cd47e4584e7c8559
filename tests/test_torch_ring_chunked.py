"""The chunked ring allreduce kernel's plain version against the JAX
package's HBM-resident Pallas kernel (``_hbm_allreduce_kernel``),
bitwise, on 64-element chunks so several chunks run cheaply in interpret
mode. The cases and the comparison are those of
tests/test_torch_ring_allreduce.py (shared in torch_ring_cases.py)."""
import pytest

pytest.importorskip("jax")

from torch_ring_cases import (CHUNKED_COUNT, OPS,  # noqa: E402
                              bitwise_equal, covering_cases, jax_ring,
                              make_inputs, torch_ring)


@pytest.mark.parametrize("n,dt,op", covering_cases(1))
def test_chunked_matches_pallas_hbm_kernel(n, dt, op, monkeypatch):
    arrs = make_inputs(n, CHUNKED_COUNT, dt, op,
                       seed=n * 1000 + OPS.index(op))
    want = jax_ring("chunked", n, op, arrs, monkeypatch)
    got = torch_ring("chunked", op, arrs)
    for r in range(n):
        assert bitwise_equal(got[r], want[r]), (r, got[r], want[r])
