"""The port's CUDA kernels on the card: each against its plain version, the
wrappers' no-fallback rule, and small solves through the kernels.

Every test here needs an NVIDIA card and skips without one. The file
imports nothing of JAX, so on a machine with a card and no JAX it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q

(`--noconftest` skips tests/conftest.py, which imports JAX).
"""

import numpy as np
import pytest
import torch

from clp_tpu_torch.ops import pivot, price
from clp_tpu_torch.ops.pivot import fused_pivot_update, fused_pivot_update_reference
from clp_tpu_torch.ops.price import (
    price_and_ratios,
    price_and_ratios_block,
    price_and_ratios_block_reference,
    price_and_ratios_reference,
)

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


def price_inputs(dtype, m=24, nt=700):
    """K1 inputs from a numpy seed; nt = 700 is no multiple of any block."""
    rng = np.random.default_rng(0)
    return dict(
        rho=rng.standard_normal(m).astype(dtype),
        G=rng.standard_normal((m, nt)).astype(dtype),
        dj=np.abs(rng.standard_normal(nt)).astype(dtype),
        elig=rng.uniform(size=nt) < 0.7,
        sgn=np.where(rng.uniform(size=nt) < 0.5, 1.0, -1.0).astype(dtype),
    )


def assert_price_close(a_ker, r_ker, a_ref, r_ref):
    """The tolerances of tests/test_pallas.py: both sides compute in f32,
    with the m-sums in different orders."""
    np.testing.assert_allclose(a_ker, a_ref, rtol=2e-5, atol=2e-5)
    assert (np.isfinite(r_ref) == np.isfinite(r_ker)).mean() > 0.99
    both = np.isfinite(r_ref) & np.isfinite(r_ker)
    np.testing.assert_allclose(r_ker[both], r_ref[both], rtol=2e-4, atol=2e-4)


def block_price_inputs(H, nb=3, CB=100):
    """K3 inputs from a numpy seed: windows at 8-aligned starts inside a
    padded row of m8 = H + 24 rows; CB = 100 is no multiple of a warp.
    rho and W hold multiples of 1/8 in [-1/2, 1/2], so every product and
    partial sum is exact in f32 (|alpha| * 64 < 2^24 for H < 2^18): the two
    summation orders cannot differ, and a ratio near a tiny alpha, which
    amplifies last-bit differences of random normal inputs, stays exact."""
    rng = np.random.default_rng(4)
    m8, ntp = H + 24, nb * CB
    return dict(
        rho_p=(rng.integers(-4, 5, size=m8) / 8).astype(np.float32),
        starts=(rng.integers(0, 4, size=nb) * 8).astype(np.int32),
        W=(rng.integers(-4, 5, size=(nb, H, CB)) / 8).astype(np.float32),
        dj=np.abs(rng.standard_normal(ntp)).astype(np.float32),
        elig=rng.uniform(size=ntp) < 0.7,
        sgn=np.where(rng.uniform(size=ntp) < 0.5, 1.0, -1.0).astype(np.float32),
    )


def pivot_inputs(m=96, r=41):
    rng = np.random.default_rng(3)
    binv = rng.standard_normal((m, m)).astype(np.float32)
    gq = rng.standard_normal(m).astype(np.float32)
    fd = rng.standard_normal(m).astype(np.float32)
    rho = binv[r].copy()
    triple = np.stack([gq, rho, fd], axis=1)
    abar_r = np.float32(rho @ gq)
    return binv, triple, rho, abar_r, r


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["G32", "G64"])
def test_price_kernel_on_card(cuda_device, dtype):
    x = price_inputs(dtype)
    t = {k: torch.as_tensor(v, device=cuda_device) for k, v in x.items()}
    sigma = torch.tensor(-1.0, device=cuda_device)
    a_k, r_k = price_and_ratios(t["rho"], t["G"], t["dj"], t["elig"], t["sgn"],
                                sigma, 5e-8, 1e-9)
    assert a_k.dtype == t["G"].dtype
    a_p, r_p = price_and_ratios_reference(t["rho"], t["G"], t["dj"], t["elig"],
                                          t["sgn"], sigma, 5e-8, 1e-9)
    assert_price_close(a_k.cpu().numpy(), r_k.cpu().numpy(),
                       a_p.cpu().numpy(), r_p.cpu().numpy())


# a ragged H (no multiple of the 16 row slices), H > 256, and H beyond the
# kernel's 2048-row shared-memory chunk of the rho window
@pytest.mark.parametrize("H", [37, 300, 2100])
@pytest.mark.parametrize("sigma", [1.0, -1.0])
def test_block_price_kernel_on_card(cuda_device, H, sigma):
    t = {k: torch.as_tensor(v, device=cuda_device) for k, v in block_price_inputs(H).items()}
    args = [t[k] for k in ("rho_p", "starts", "W", "dj", "elig", "sgn")]
    sig = torch.tensor(sigma, device=cuda_device)
    a_k, r_k = price_and_ratios_block(*args, sig, 5e-8, 1e-9)
    a_p, r_p = price_and_ratios_block_reference(*args, sig, 5e-8, 1e-9)
    assert a_k.shape == (300,) and a_k.dtype == torch.float32
    assert torch.equal(a_k, a_p)  # exact sums: see block_price_inputs
    assert_price_close(a_k.cpu().numpy(), r_k.cpu().numpy(),
                       a_p.cpu().numpy(), r_p.cpu().numpy())


@pytest.mark.parametrize("gate", [1.0, 0.0])
def test_pivot_kernel_on_card(cuda_device, gate):
    binv, triple, rho, abar_r, r = pivot_inputs()
    args = [torch.as_tensor(a, device=cuda_device) for a in (binv, triple, rho, abar_r)]
    args += [torch.tensor(gate, device=cuda_device), torch.tensor(r, device=cuda_device)]
    bk, rk = fused_pivot_update(*args)
    bp, rp = fused_pivot_update_reference(*args)
    assert float((bk - bp).abs().max()) < 1e-5
    # R reaches |20| here, where f32 spacing is 1.9e-6: two summation
    # orders of 96 products differ by a few spacings
    np.testing.assert_allclose(rk.cpu().numpy(), rp.cpu().numpy(), rtol=2e-6, atol=1e-5)
    if gate == 0.0:
        assert float((bk - args[0]).abs().max()) == 0.0


def test_wrappers_launch_and_never_run_plain_on_card(cuda_device, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran for CUDA tensors")

    monkeypatch.setattr(price, "price_and_ratios_reference", refuse)
    monkeypatch.setattr(price, "price_and_ratios_block_reference", refuse)
    monkeypatch.setattr(pivot, "fused_pivot_update_reference", refuse)
    x = price_inputs(np.float32)
    t = {k: torch.as_tensor(v, device=cuda_device) for k, v in x.items()}
    n1 = price_and_ratios.launches
    price_and_ratios(t["rho"], t["G"], t["dj"], t["elig"], t["sgn"], 1.0, 5e-8, 1e-9)
    assert price_and_ratios.launches == n1 + 1
    args = [torch.as_tensor(a, device=cuda_device) for a in pivot_inputs()]
    n2 = fused_pivot_update.launches
    fused_pivot_update(*args[:4], torch.tensor(1.0, device=cuda_device), args[4])
    assert fused_pivot_update.launches == n2 + 1
    t = {k: torch.as_tensor(v, device=cuda_device) for k, v in block_price_inputs(40).items()}
    n3 = price_and_ratios_block.launches
    price_and_ratios_block(*(t[k] for k in ("rho_p", "starts", "W", "dj", "elig", "sgn")),
                           1.0, 5e-8, 1e-9)
    assert price_and_ratios_block.launches == n3 + 1
    torch.cuda.synchronize()


def test_dual_simplex_through_both_kernels_on_card(cuda_device):
    """A small LP solved on the card with K1 and K2 forced on agrees with
    the same solve on the CPU, where the wrappers run their plain versions."""
    from clp_tpu_torch import SolveOptions, check_kkt, initial_solve
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.utils.generators import random_lp

    kw = dict(method=SolveMethod.DUAL_SIMPLEX, use_pallas_price=True,
              use_pallas_pivot=True, inverse_dtype="float32")
    cpu = initial_solve(random_lp(64, 96, seed=9, density=0.15),
                        SolveOptions(device="cpu", **kw))
    model = random_lp(64, 96, seed=9, density=0.15)
    n1, n2 = price_and_ratios.launches, fused_pivot_update.launches
    card = initial_solve(model, SolveOptions(device="cuda", **kw))
    assert cpu.status == card.status == ProblemStatus.OPTIMAL
    assert price_and_ratios.launches > n1 and fused_pivot_update.launches > n2
    assert abs(card.objective_value - cpu.objective_value) <= 1e-9 * (
        1 + abs(cpu.objective_value))
    assert check_kkt(model, x=card.primal, y=card.duals, tol=1e-6).ok


@pytest.mark.parametrize("k2", [False, True], ids=["K3", "K3+K2"])
def test_block_route_through_k3_on_card(cuda_device, k2):
    """price_mode="block" on a small staircase, on the card with K3 (and
    K2), agrees with the same solve on the CPU, where the wrappers run
    their plain versions; K1 never launches on the block route."""
    from clp_tpu_torch import SolveOptions, check_kkt, initial_solve
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.utils.generators import staircase_lp

    kw = dict(method=SolveMethod.DUAL_SIMPLEX, price_mode="block", use_pallas_price=True,
              use_pallas_pivot=k2, inverse_dtype="float32")
    cpu = initial_solve(staircase_lp(8, 32, 72, seed=0), SolveOptions(device="cpu", **kw))
    model = staircase_lp(8, 32, 72, seed=0)
    n1, n2, n3 = (price_and_ratios.launches, fused_pivot_update.launches,
                  price_and_ratios_block.launches)
    card = initial_solve(model, SolveOptions(device="cuda", **kw))
    assert cpu.status == card.status == ProblemStatus.OPTIMAL
    assert price_and_ratios_block.launches > n3 and price_and_ratios.launches == n1
    assert (fused_pivot_update.launches > n2) == k2
    assert abs(card.objective_value - cpu.objective_value) <= 1e-9 * (
        1 + abs(cpu.objective_value))
    assert check_kkt(model, x=card.primal, y=card.duals, tol=1e-6).ok
