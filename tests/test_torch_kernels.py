"""K1 and K2 of the port against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
functions run their Pallas kernels in interpret mode, as tests/test_pallas.py
runs them. Same inputs from numpy seeds, the tolerances of test_pallas.py
(both sides compute in f32, with sums in different orders). The CUDA
kernels are held to the same plain versions on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from clp_tpu.ops.pallas_pivot import fused_pivot_update as jax_pivot
from clp_tpu.ops.pallas_price import (
    price_and_ratios as jax_price,
    price_and_ratios_reference as jax_price_ref,
)
from clp_tpu_torch.ops.pivot import fused_pivot_update, fused_pivot_update_reference
from clp_tpu_torch.ops.price import price_and_ratios, price_and_ratios_reference

from test_torch_cuda import assert_price_close, pivot_inputs, price_inputs

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["G32", "G64"])
def test_price_twin_matches_jax_kernel(dtype):
    x = price_inputs(dtype)
    rel, ptol = 5e-8, 1e-9
    a_j, r_j = jax_price(jnp.asarray(x["rho"]), jnp.asarray(x["G"]),
                         jnp.asarray(x["dj"]), jnp.asarray(x["elig"]),
                         jnp.asarray(x["sgn"]), jnp.asarray(1.0), jnp.asarray(rel),
                         ptol, block_n=256, interpret=True)
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    a_t, r_t = price_and_ratios(t["rho"], t["G"], t["dj"], t["elig"], t["sgn"],
                                1.0, rel, ptol)
    # output dtype follows rho and G, as in the JAX function
    assert str(a_t.dtype).replace("torch.", "") == str(np.asarray(a_j).dtype)
    assert_price_close(a_t.numpy(), r_t.numpy(), np.asarray(a_j), np.asarray(r_j))


@pytest.mark.parametrize("sigma", [1.0, -1.0])
def test_price_twin_matches_jax_reference(sigma):
    x = price_inputs(np.float64)
    rel, ptol = 5e-8, 1e-9
    a_j, r_j = jax_price_ref(*(jnp.asarray(x[k]) for k in ("rho", "G", "dj", "elig", "sgn")),
                             sigma, rel, ptol)
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    # the reference pair agrees exactly in f64 ...
    a_r, r_r = price_and_ratios_reference(t["rho"], t["G"], t["dj"], t["elig"],
                                          t["sgn"], sigma, rel, ptol)
    np.testing.assert_allclose(a_r.numpy(), np.asarray(a_j), rtol=1e-13, atol=1e-13)
    np.testing.assert_array_equal(np.isfinite(r_r.numpy()), np.isfinite(np.asarray(r_j)))
    # ... and the f32 wrapper is held to the f64 reference at f32 tolerance
    a_t, r_t = price_and_ratios(t["rho"], t["G"], t["dj"], t["elig"], t["sgn"],
                                torch.tensor(sigma), rel, ptol)
    assert_price_close(a_t.numpy(), r_t.numpy(), np.asarray(a_j), np.asarray(r_j))


@pytest.mark.parametrize("gate", [1.0, 0.0])
def test_pivot_twin_matches_jax_kernel(gate):
    binv, triple, rho, abar_r, r = pivot_inputs()
    bj, rj = jax_pivot(jnp.asarray(binv), jnp.asarray(triple), jnp.asarray(rho),
                       jnp.asarray(abar_r), jnp.asarray(gate), jnp.asarray(r),
                       interpret=True)
    bt, rt = fused_pivot_update(torch.as_tensor(binv), torch.as_tensor(triple),
                                torch.as_tensor(rho), torch.as_tensor(abar_r),
                                torch.tensor(gate), torch.tensor(r))
    assert bt.dtype == torch.float32 and rt.shape == (96, 3)
    assert np.abs(bt.numpy() - np.asarray(bj)).max() < 1e-5
    # R = binv @ triple reaches |20| here, where f32 spacing is 1.9e-6: two
    # summation orders of 96 products differ by a few spacings
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=2e-6, atol=1e-5)
    if gate == 0.0:
        # a gated pivot passes binv through bit-exact, on both sides
        assert np.abs(bt.numpy() - binv).max() == 0.0
        assert np.abs(np.asarray(bj) - binv).max() == 0.0
    else:
        # and a real one is the product-form update of the separate ops
        abar = binv @ triple[:, 0]
        factor = abar / abar_r
        factor[r] = 1.0 - 1.0 / abar_r
        assert np.abs(bt.numpy() - (binv - np.outer(factor, rho))).max() < 1e-5


def test_pivot_wrapper_is_its_reference_on_cpu():
    binv, triple, rho, abar_r, r = pivot_inputs()
    args = [torch.as_tensor(a) for a in (binv, triple, rho, abar_r)] + [
        torch.tensor(1.0), torch.tensor(r)]
    b1, r1 = fused_pivot_update(*args)
    b2, r2 = fused_pivot_update_reference(*args)
    assert torch.equal(b1, b2) and torch.equal(r1, r2)
    with pytest.raises(ValueError):
        fused_pivot_update(args[0].double(), *args[1:])
