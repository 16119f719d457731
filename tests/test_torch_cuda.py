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


def exact_price_inputs(m, nt, seed=6):
    """K1 inputs whose f32 sums are exact (multiples of 1/8 in [-1/2, 1/2],
    as in block_price_inputs), so any split of the m-sum gives the same
    alpha; dj, sgn and sigma in f64 and the mask as bool, as the engine
    holds them."""
    rng = np.random.default_rng(seed)
    return dict(
        rho=(rng.integers(-4, 5, size=m) / 8).astype(np.float32),
        G=(rng.integers(-4, 5, size=(m, nt)) / 8).astype(np.float32),
        dj=np.abs(rng.standard_normal(nt)),
        elig=rng.uniform(size=nt) < 0.7,
        sgn=np.where(rng.uniform(size=nt) < 0.5, 1.0, -1.0),
    )


# nt % 4 != 0 (scalar loads), nt < 128 (one partial tile), m split over
# blocks or not, and the main path's shape
@pytest.mark.parametrize("m, nt", [(1, 1), (24, 3), (7, 127), (2048, 6657), (2048, 6656),
                                   (14464, 130)])
def test_price_kernel_ragged_on_card(cuda_device, m, nt):
    t = {k: torch.as_tensor(v, device=cuda_device) for k, v in exact_price_inputs(m, nt).items()}
    sigma = torch.tensor(-1.0, dtype=torch.float64, device=cuda_device)
    args = [t[k] for k in ("rho", "G", "dj", "elig", "sgn")]
    a_k, r_k = price_and_ratios(*args, sigma, 5e-8, 1e-9)
    f32 = [args[0], args[1], args[2].float(), args[3].int(), args[4].float()]
    a_p, r_p = price_and_ratios_reference(*f32, sigma.float(), 5e-8, 1e-9)
    assert torch.equal(a_k, a_p)  # exact sums
    assert_price_close(a_k.cpu().numpy(), r_k.cpu().numpy(),
                       a_p.cpu().numpy(), r_p.cpu().numpy())


def test_price_kernel_on_misaligned_g(cuda_device):
    """A G that starts 4 bytes past a 16-byte boundary takes the scalar
    loads, with the same sums."""
    m, nt = 40, 256
    x = exact_price_inputs(m, nt)
    flat = torch.empty(m * nt + 1, device=cuda_device)
    G = flat[1:].view(m, nt)
    G.copy_(torch.as_tensor(x["G"]))
    assert G.data_ptr() % 16 != 0 and G.is_contiguous()
    t = {k: torch.as_tensor(v, device=cuda_device) for k, v in x.items()}
    a_k, _ = price_and_ratios(t["rho"], G, t["dj"], t["elig"], t["sgn"], 1.0, 5e-8, 1e-9)
    assert torch.equal(a_k, t["rho"] @ t["G"])


@pytest.mark.parametrize("nb, H, CB", [(1, 8, 1), (7, 37, 100), (52, 264, 128),
                                       (3, 2100, 200), (2, 61, 130)])
def test_block_price_kernel_ragged_on_card(cuda_device, nb, H, CB):
    """Any (nb, H, CB), with dj, the mask and sgn unpadded (the last three
    columns left out) and stored as the engine holds them."""
    x = block_price_inputs(H, nb=nb, CB=CB)
    t = {k: torch.as_tensor(v, device=cuda_device) for k, v in x.items()}
    n = max(1, nb * CB - 3)
    vecs = [t["dj"][:n].double(), t["elig"][:n], t["sgn"][:n].double()]
    sig = torch.tensor(1.0, dtype=torch.float64, device=cuda_device)
    a_k, r_k = price_and_ratios_block(t["rho_p"], t["starts"], t["W"], *vecs, sig, 5e-8, 1e-9)
    pad = nb * CB - n
    padded = [torch.nn.functional.pad(t["dj"][:n], (0, pad)),
              torch.nn.functional.pad(t["elig"][:n].int(), (0, pad)),
              torch.nn.functional.pad(t["sgn"][:n], (0, pad), value=1.0)]
    a_p, r_p = price_and_ratios_block_reference(t["rho_p"], t["starts"], t["W"], *padded,
                                                sig.float(), 5e-8, 1e-9)
    assert torch.equal(a_k, a_p)  # exact sums
    assert torch.isinf(r_k[n:]).all()
    assert_price_close(a_k.cpu().numpy(), r_k.cpu().numpy(),
                       a_p.cpu().numpy(), r_p.cpu().numpy())


def main_path_k1_inputs(dev):
    """K1 at the staircase's standard-form shape, N(0, 1) entries: sums
    whose f32 value depends on their order."""
    rng = np.random.default_rng(7)
    m, nt = 2048, 6656
    return [torch.as_tensor(rng.standard_normal(m), dtype=torch.float32, device=dev),
            torch.as_tensor(rng.standard_normal((m, nt)), dtype=torch.float32, device=dev),
            torch.as_tensor(np.abs(rng.standard_normal(nt)), device=dev),
            torch.as_tensor(rng.uniform(size=nt) < 0.7, device=dev),
            torch.as_tensor(np.where(rng.uniform(size=nt) < 0.5, 1.0, -1.0), device=dev)]


def main_path_k3_inputs(dev):
    rng = np.random.default_rng(8)
    nb, H, CB = 52, 264, 128
    m8 = 2048
    return [torch.as_tensor(rng.standard_normal(m8), dtype=torch.float32, device=dev),
            torch.as_tensor(np.linspace(0, m8 - H, nb).astype(np.int32) // 8 * 8, device=dev),
            torch.as_tensor(rng.standard_normal((nb, H, CB)), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(np.abs(rng.standard_normal(nb * CB)), device=dev),
            torch.as_tensor(rng.uniform(size=nb * CB) < 0.7, device=dev),
            torch.as_tensor(np.where(rng.uniform(size=nb * CB) < 0.5, 1.0, -1.0), device=dev)]


def bits(pair):
    return torch.stack(pair).view(torch.int32).clone()


@pytest.mark.parametrize("reps", [2, 10])
def test_kernels_are_bit_deterministic_on_card(cuda_device, reps):
    """Consecutive launches on the same inputs give the same bits: the
    splits are summed in a fixed order, and the last block of each tile
    leaves its counter at zero for the next launch."""
    k1 = main_path_k1_inputs(cuda_device)
    k3 = main_path_k3_inputs(cuda_device)
    one = torch.ones((), dtype=torch.float64, device=cuda_device)
    first1 = bits(price_and_ratios(*k1, one, 5e-8, 1e-9))
    first3 = bits(price_and_ratios_block(*k3, one, 5e-8, 1e-9))
    for _ in range(reps - 1):
        assert torch.equal(bits(price_and_ratios(*k1, one, 5e-8, 1e-9)), first1)
        assert torch.equal(bits(price_and_ratios_block(*k3, one, 5e-8, 1e-9)), first3)
    torch.cuda.synchronize()
    # K1's counters are back at zero (K3 keeps none)
    assert not price._workspaces[torch.device("cuda", torch.cuda.current_device())][1].any()


def test_k1_and_k3_back_to_back_on_card(cuda_device):
    """K1 then K3 and K3 then K1, back to back on one stream, give each
    kernel's result alone: nothing one leaves behind reaches the other."""
    k1 = main_path_k1_inputs(cuda_device)
    k3 = main_path_k3_inputs(cuda_device)
    one = torch.ones((), dtype=torch.float64, device=cuda_device)
    alone1 = bits(price_and_ratios(*k1, one, 5e-8, 1e-9))
    torch.cuda.synchronize()
    alone3 = bits(price_and_ratios_block(*k3, one, 5e-8, 1e-9))
    torch.cuda.synchronize()
    for order in (("k1", "k3"), ("k3", "k1")):
        got = {}
        for kind in order:
            got[kind] = (price_and_ratios(*k1, one, 5e-8, 1e-9) if kind == "k1"
                         else price_and_ratios_block(*k3, one, 5e-8, 1e-9))
        assert torch.equal(bits(got["k1"]), alone1)
        assert torch.equal(bits(got["k3"]), alone3)
    # and the dense alpha agrees with a plain product at f32 tolerance
    np.testing.assert_allclose(price_and_ratios(*k1, one, 5e-8, 1e-9)[0].cpu().numpy(),
                               (k1[0] @ k1[1]).cpu().numpy(), rtol=1e-4, atol=2e-4)


def unit_pivot_inputs(m, r, seed=3):
    """binv with unit-norm rows, g_q near rho (abar_r near 1), an N(0, 1)
    flip flow: the scales of chip_smoke's K2 checks."""
    rng = np.random.default_rng(seed)
    binv = (rng.standard_normal((m, m)) / np.sqrt(m)).astype(np.float32)
    rho = binv[r].copy()
    gq = (rho + rng.standard_normal(m) / np.sqrt(m)).astype(np.float32)
    triple = np.stack([gq, rho, rng.standard_normal(m).astype(np.float32)], axis=1)
    return binv, triple, rho, np.float32(rho @ gq), r


@pytest.mark.parametrize("gate", [1.0, 0.0])
@pytest.mark.parametrize("m", [1, 5, 96, 2048, 2049])
def test_pivot_kernel_on_card(cuda_device, m, gate):
    """One cluster of one CTA (m = 1, 5, 96), 4 CTAs with aligned rows
    (2048) and 8 CTAs with odd rows (2049), r in a middle tile: against the
    plain version, gate 0 bit for bit, the same bits over 10 launches."""
    inputs = pivot_inputs() if m == 96 else unit_pivot_inputs(m, (2 * m) // 5)
    binv, triple, rho, abar_r, r = inputs
    args = [torch.as_tensor(a, device=cuda_device) for a in (binv, triple, rho, abar_r)]
    args += [torch.tensor(gate, device=cuda_device), torch.tensor(r, device=cuda_device)]
    bk, rk = fused_pivot_update(*args)
    bp, rp = fused_pivot_update_reference(*args)
    assert float((bk - bp).abs().max()) < 1e-5
    # at m = 96, R reaches |20|, where f32 spacing is 1.9e-6; elsewhere the
    # rows have unit norm and R reaches |4|: two summation orders of m
    # products differ by a few spacings
    np.testing.assert_allclose(rk.cpu().numpy(), rp.cpu().numpy(), rtol=2e-6, atol=1e-5)
    if gate == 0.0:
        assert float((bk - args[0]).abs().max()) == 0.0
    for _ in range(9):
        b2, r2 = fused_pivot_update(*args)
        assert torch.equal(b2.view(torch.int32), bk.view(torch.int32))
        assert torch.equal(r2.view(torch.int32), rk.view(torch.int32))


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


def _window_G(m=640, ncols=1280, win=32, k=8, seed=5):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(m):
        base = int(i * (ncols - win) / m)
        for j in base + rng.choice(win, k, replace=False):
            rows.append(i), cols.append(int(j)), vals.append(rng.normal())
    return sp.csr_matrix((vals, (rows, cols)), shape=(m, ncols))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_device_multifrontal_on_card(cuda_device, dtype):
    """The device multifrontal numeric on the card against the host plan,
    with the same bits over two factorizations (no atomics)."""
    import scipy.sparse as sp

    from clp_tpu_torch.ops.sparse_chol_device import make_device_normal_solver

    G = _window_G()
    m = G.shape[0]
    solver = make_device_normal_solver(G, reg=1e-9, dtype=dtype, device="cuda")
    assert solver is not None
    rng = np.random.default_rng(6)
    d = rng.random(G.shape[1]) + 0.01
    rhs = rng.normal(size=m)
    S = (G.multiply(d) @ G.T + 1e-9 * sp.eye(m)).tocsc()
    assert solver.plan.factor(S)
    x_host = solver.plan.solve(rhs)
    dt = torch.as_tensor(d, device=cuda_device)
    (f1, s1), ok1 = solver.factor(dt)
    (f2, s2), ok2 = solver.factor(dt)
    assert bool(ok1) and bool(ok2)
    assert torch.equal(s1, s2) and all(torch.equal(a, b) for a, b in zip(f1, f2))
    rt = torch.as_tensor(rhs, device=cuda_device)
    x = solver.solve_with((f1, s1), rt)
    assert torch.equal(x, solver.solve_with((f2, s2), rt))
    for _ in range(3 if dtype == torch.float32 else 0):
        x = x + solver.solve_with((f1, s1), rt - torch.as_tensor(S @ x.cpu().numpy(),
                                                                  device=cuda_device))
    x = x.cpu().numpy()
    assert np.linalg.norm(S @ x - rhs) <= 1e-8 * np.linalg.norm(rhs)
    np.testing.assert_allclose(x, x_host, rtol=1e-6, atol=1e-6 * np.abs(x_host).max())


def test_block_tridiag_cholesky_on_card(cuda_device):
    """The banded Cholesky and solve on the card against the CPU."""
    from clp_tpu_torch.ops.linalg import block_tridiag_cholesky, block_tridiag_solve

    rng = np.random.default_rng(1)
    k, nb = 6, 64
    m = k * nb
    B = np.zeros((m, m + 8))
    for i in range(m):
        lo = max(0, i - 40)
        B[i, lo:i + 3] = rng.standard_normal(i + 3 - lo)
    M = B @ B.T + np.eye(m)
    A = np.stack([M[i * nb:(i + 1) * nb, i * nb:(i + 1) * nb] for i in range(k)])
    E = np.stack([M[(i + 1) * nb:(i + 2) * nb, i * nb:(i + 1) * nb] for i in range(k - 1)])
    rhs = rng.standard_normal((k, nb))
    out = {}
    for dev in ("cpu", "cuda"):
        L, C, delta = block_tridiag_cholesky(torch.as_tensor(A, device=dev),
                                             torch.as_tensor(E, device=dev))
        x = block_tridiag_solve(L, C, torch.as_tensor(rhs, device=dev))
        out[dev] = (L.cpu().numpy(), x.cpu().numpy(), float(delta))
    assert out["cuda"][2] == out["cpu"][2] == 0.0
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(M @ out["cuda"][1].ravel(), rhs.ravel(), atol=1e-8)


def test_barrier_solve_on_card(cuda_device):
    """A small BARRIER solve on the card (dense mixed32 normal equations,
    then the crossover) agrees with the same solve on the CPU (f64)."""
    from clp_tpu_torch import SolveOptions, check_kkt, initial_solve
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.utils.generators import random_lp

    cpu = initial_solve(random_lp(40, 70, seed=3, density=0.3),
                        SolveOptions(method=SolveMethod.BARRIER, device="cpu"))
    model = random_lp(40, 70, seed=3, density=0.3)
    card = initial_solve(model, SolveOptions(method=SolveMethod.BARRIER, device="cuda"))
    assert cpu.status == card.status == ProblemStatus.OPTIMAL
    assert card.timings["barrier_stats"]["branch"] == "dense mixed32"
    assert abs(card.objective_value - cpu.objective_value) <= 1e-9 * (
        1 + abs(cpu.objective_value))
    assert check_kkt(model, x=card.primal, y=card.duals, tol=1e-6).ok


@pytest.mark.parametrize("gate", [1.0, 0.0])
def test_pivot_kernel_above_the_shared_memory_limit_on_card(cuda_device, gate):
    """m = 14,465: past 4 rows of binv in one block's shared memory, and
    odd, so no row but the first starts 16-byte aligned. One counted
    launch, against the plain version; gate 0 passes binv through bit for
    bit."""
    m, r = 14465, 9000
    g = torch.Generator(device="cpu").manual_seed(5)
    binv = (torch.randn(m, m, generator=g) / m ** 0.5).to(cuda_device)
    rho = binv[r].clone()
    gq = torch.randn(m, generator=g).to(cuda_device)
    triple = torch.stack([gq, rho, torch.randn(m, generator=g).to(cuda_device)], 1).contiguous()
    args = [binv, triple, rho, torch.dot(rho, gq), torch.tensor(gate, device=cuda_device),
            torch.tensor(r, device=cuda_device)]
    n = fused_pivot_update.launches
    bk, rk = fused_pivot_update(*args)
    assert fused_pivot_update.launches == n + 1
    bp, rp = fused_pivot_update_reference(*args)
    torch.cuda.synchronize()
    # unit-norm rows: sums of 14,465 products differ by a few f32 spacings
    assert float((rk - rp).abs().max()) < 1e-4
    assert float((bk - bp).abs().max()) < 1e-4
    if gate == 0.0:
        assert torch.equal(bk, binv)


def test_pdhg_on_card_matches_cpu(cuda_device):
    """The PDHG loop on one ELL matrix, on the card and on the CPU: the same
    iteration count at tol 1e-4, iterates within 1e-9 relative (f64 sums
    in another order)."""
    import scipy.sparse as sp

    from clp_tpu_torch import pdlp

    rng = np.random.default_rng(1)
    m, n = 200, 400
    A = sp.random(m, n, density=0.05, random_state=1, data_rvs=rng.standard_normal).tocsr()
    b = A @ rng.uniform(0, 2, n) + 0.5
    vecs = (np.linspace(-1, 1, n), np.full(m, -np.inf), b, np.zeros(n), np.full(n, 10.0))
    out = {}
    for dev in ("cpu", "cuda"):
        E = pdlp.ell_from_scipy(A, dev)
        t = [torch.as_tensor(v, device=dev) for v in vecs]
        x, y, k, done = pdlp._pdhg(E, *t, 1e-4, max_iter=20000)
        out[dev] = (x.cpu().numpy(), y.cpu().numpy(), int(k), bool(done))
    assert out["cuda"][2] == out["cpu"][2] and out["cuda"][3] == out["cpu"][3]
    for a, b_ in zip(out["cuda"][:2], out["cpu"][:2]):
        np.testing.assert_allclose(a, b_, rtol=1e-9, atol=1e-9 * np.abs(b_).max())


def test_idiot_descend_on_card_matches_cpu(cuda_device):
    from clp_tpu_torch import crash

    rng = np.random.default_rng(2)
    m, n = 64, 300
    A = (rng.random((m, n)) < 0.05) * 1.0
    args = (A, rng.integers(1, 5, n).astype(float), np.ones(m), np.full(m, np.inf),
            np.zeros(n), np.ones(n), np.zeros(n))
    xs = [crash._idiot_descend(*(torch.as_tensor(a, device=dev) for a in args), 0.5, 12, 25)
          .cpu().numpy() for dev in ("cpu", "cuda")]
    np.testing.assert_allclose(xs[1], xs[0], rtol=1e-9, atol=1e-9 * np.abs(xs[0]).max())


def _port_random_qp(seed, n=8, mr=5, box=2.0):
    """tests/test_qp.py's `_random_qp`, built as a port Model."""
    import scipy.sparse as sp

    from clp_tpu_torch import Model

    rng = np.random.default_rng(seed)
    A = sp.csc_matrix(rng.standard_normal((mr, n)))
    L = rng.standard_normal((n, n)) * 0.4
    m = Model()
    m.load_problem(A, col_lower=np.full(n, -box), col_upper=np.full(n, box),
                   objective=rng.standard_normal(n),
                   row_lower=np.full(mr, -3.0), row_upper=np.full(mr, 3.0))
    m.quadratic_objective = sp.csc_matrix(L @ L.T + np.eye(n))
    return m


@pytest.mark.parametrize("method", ["PRIMAL_SIMPLEX", "BARRIER_NO_CROSS"])
def test_qp_on_card_matches_cpu(cuda_device, method):
    """The QP simplex (gated blocks of reduced-gradient iterations) and the
    dense-Q barrier on the card: the CPU's status, iterations and objective
    (f64 sums in another order)."""
    from clp_tpu_torch import SolveOptions, check_kkt, initial_solve
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod

    out = {}
    for dev in ("cpu", "cuda"):
        model = _port_random_qp(3)
        out[dev] = initial_solve(model, SolveOptions(method=SolveMethod[method], device=dev))
        assert check_kkt(model, x=out[dev].primal, y=out[dev].duals, tol=1e-6).ok
    cpu, card = out["cpu"], out["cuda"]
    assert cpu.status == card.status == ProblemStatus.OPTIMAL
    assert card.iterations == cpu.iterations
    assert abs(card.objective_value - cpu.objective_value) <= 1e-9 * (
        1 + abs(cpu.objective_value))


def test_separable_qp_barrier_on_card(cuda_device):
    """A diagonal-Q staircase QP on the card: q_diag on the banded branch in
    mixed32, the CPU's objective within 1e-8."""
    import scipy.sparse as sp

    from clp_tpu_torch import SolveOptions, initial_solve
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.utils.generators import staircase_lp

    out = {}
    for dev in ("cpu", "cuda"):
        model = staircase_lp(nblocks=16, bm=24, bn=36, seed=4)
        rng = np.random.default_rng(0)
        model.load_quadratic_objective(sp.diags(rng.uniform(0.1, 2.0, model.num_cols)).tocsc())
        out[dev] = initial_solve(model, SolveOptions(method=SolveMethod.BARRIER_NO_CROSS,
                                                     device=dev))
    assert out["cpu"].status == out["cuda"].status == ProblemStatus.OPTIMAL
    assert out["cuda"].timings["barrier_stats"]["branch"].endswith("q_diag")
    assert out["cuda"].timings["barrier_stats"]["branch"].startswith("banded")
    assert abs(out["cuda"].objective_value - out["cpu"].objective_value) <= 1e-8 * (
        1 + abs(out["cpu"].objective_value))


def test_dynamic_swaps_on_card_match_cpu(cuda_device):
    """`dynamic_simplex_solve` with its slot swaps and the grow path on the
    card: the CPU's rounds, swaps, working set and objective."""
    from clp_tpu_torch import SolveOptions
    from clp_tpu_torch.dynamic import ExplicitColumnSource, dynamic_simplex_solve
    from clp_tpu_torch.utils.generators import random_lp

    model = random_lp(8, 120, seed=11, density=0.4)
    model.col_lower = np.zeros(model.num_cols)
    model.col_upper = np.full(model.num_cols, 50.0)
    out = {}
    for dev in ("cpu", "cuda"):
        src = ExplicitColumnSource(model.matrix, model.objective, model.col_lower,
                                   model.col_upper)
        out[dev] = dynamic_simplex_solve(model.row_lower, model.row_upper, src,
                                         working_set=30, options=SolveOptions(device=dev))
    (sc, ic), (sg, ig) = out["cpu"], out["cuda"]
    assert sc.status == sg.status
    assert ig["swaps"] > 0 and ig["working_set"] > 30
    for k in ("rounds", "swaps", "working_set"):
        assert ig[k] == ic[k], k
    assert abs(sg.objective_value - sc.objective_value) <= 1e-9 * (1 + abs(sc.objective_value))


def _lane_models(B=8, m=40, n=70):
    """B perturbed-RHS copies of random_lp(m, n)."""
    from clp_tpu_torch.utils.generators import random_lp

    base = random_lp(m, n, seed=5)
    models = []
    for k in range(B):
        mdl = base.copy()
        mdl.row_upper = np.where(np.isfinite(mdl.row_upper),
                                 mdl.row_upper * (1 + 0.02 * k), mdl.row_upper)
        models.append(mdl)
    return models


def _batch_lanes(dev, B=8, m=40, n=70):
    """B perturbed-RHS copies of random_lp(m, n) as one batch on `dev`."""
    from clp_tpu_torch.parallel import batch as pb

    lp, _ = pb.stack_models_simplex(_lane_models(B, m, n), dev)
    return pb._lpd(lp)


def test_batched_form_built_on_card_is_the_cpu_build(cuda_device):
    """forms.to_standard_form_batch on the card against the same build on
    the CPU, which tests/test_torch_batch.py holds bit for bit to the
    lanes' own forms: the card's zero-fill, scatter and slack block give
    the same bits, for LP lanes with a repeated entry and a maximised lane
    and for a QP batch."""
    import scipy.sparse as sp

    from clp_tpu_torch.forms import to_standard_form_batch

    models = _lane_models(B=6)
    models[1].set_maximize()
    mdl = models[2]
    A = mdl.matrix
    # one more entry at the front of column 0, on its first entry's row
    rep = sp.csc_matrix((np.r_[0.5, A.data], np.r_[A.indices[0], A.indices],
                         np.r_[0, A.indptr[1:] + 1]), shape=A.shape)
    mdl.load_problem(rep, mdl.col_lower, mdl.col_upper, mdl.objective, mdl.row_lower,
                     mdl.row_upper)
    assert not mdl.matrix.has_canonical_format
    qps = [m.copy() for m in models[:4]]
    for k, q in enumerate(qps):
        q.load_quadratic_objective(sp.diags(np.linspace(1.0, 2.0 + k, q.num_cols), format="csc"))
    for batch in (models, qps):
        cpu, _ = to_standard_form_batch(batch, device="cpu")
        card, _ = to_standard_form_batch(batch, device=cuda_device)
        for k in ("G", "b", "c", "l", "u", "Q"):
            a, b = getattr(cpu, k), getattr(card, k)
            if a is None:
                assert b is None and batch is models
                continue
            assert b.device.type == "cuda", k
            assert torch.equal(b.cpu().view(torch.int64), a.view(torch.int64)), k


def test_vmapped_dual_pivots_on_card_match_cpu(cuda_device):
    """200 vmapped dual pivots on B = 8 lanes, on the card and on the CPU:
    a lane frozen from the start keeps its state bit for bit while the
    others pivot. Each lane then runs to its end: the same status and
    objective on both (the pivot paths may part where the two sum in other
    orders; on the H100 two of the eight did within 200 pivots)."""
    from clp_tpu_torch.parallel import batch as pb
    from clp_tpu_torch.utils.lockstep import run as run_alone
    from clp_tpu_torch.simplex import engine

    opts = engine.SimplexOptions()
    out = {}
    for dev in ("cpu", "cuda"):
        E = pb._Lanes(_batch_lanes(dev), opts)
        S = pb._bprep(E, E.initial_state())
        frozen = {k: v[3].clone() for k, v in S.items()}
        run = torch.ones(8, dtype=torch.bool, device=dev)
        run[3] = False
        for _ in range(200):
            S = pb.gate(run & (S["status"] == engine.CONTINUE), E.dual_step(S), S)
        for k, v in S.items():
            assert torch.equal(v[3], frozen[k]), k
        S, _ = run_alone(pb._lanes_prog(S, E.recompute, E.verify_dual, E.dual_step, opts))
        out[dev] = (S["status"].cpu(), E.objective(S).cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert (out["cpu"][0] == engine.OPTIMAL).all()
    assert torch.allclose(out["cuda"][1], out["cpu"][1], rtol=1e-9, atol=1e-9)


def test_batched_lanes_on_card_match_their_single_solves(cuda_device):
    """The compacting batched dual loop on the card against engine.dual_solve
    on each lane alone, also on the card: the same status and objective for
    every lane. Where a lane took its single solve's number of pivots it
    took its path: the same final basis and x_B. (The CPU test holds them
    bit for bit; on the card the batched and the single products may sum
    in other orders.)"""
    from clp_tpu_torch.forms import to_standard_form
    from clp_tpu_torch.parallel import batch as pb
    from clp_tpu_torch.utils.lockstep import run as run_alone
    from clp_tpu_torch.simplex import engine

    opts = engine.SimplexOptions()
    models = _lane_models()
    E = pb._Lanes(_batch_lanes(cuda_device), opts)
    S = run_alone(pb._compacting_prog(E, E.initial_state()))
    obj = E.objective(S).cpu()
    for i, mdl in enumerate(models):
        lp, _ = to_standard_form(mdl, device=cuda_device)
        st = engine.initial_state(lp, opts)
        st = engine.recompute(lp, st, opts.dual_bound)
        st = engine.make_dual_feasible(lp, st, opts)
        st = engine.dual_solve(lp, st, opts)
        assert int(S["status"][i]) == int(st.status) == engine.OPTIMAL, i
        xn = engine.nonbasic_values(lp, st.vstat, opts.dual_bound)
        single = float(lp.c.index_select(0, st.basis) @ st.xb + lp.c @ xn)
        assert abs(float(obj[i]) - single) <= 1e-9 * (1 + abs(single)), i
        if int(S["iterations"][i]) == int(st.iterations):
            assert torch.equal(torch.sort(S["basis"][i]).values,
                               torch.sort(st.basis).values), i
            assert torch.allclose(S["xb"][i], st.xb, rtol=1e-9, atol=1e-9), i


def test_batched_ipm_on_card_matches_cpu(cuda_device):
    """The lane-wise batched IPM on the card and on the CPU: every lane the
    same iteration count and its objective within 1e-9 relative."""
    from clp_tpu_torch import SolveOptions
    from clp_tpu_torch.parallel.batch import solve_batch_ipm
    from clp_tpu_torch.utils.generators import random_lp

    rng = np.random.default_rng(1)
    base = random_lp(48, 72, seed=0)
    models = []
    for _ in range(6):
        mdl = base.copy()
        shift = np.abs(rng.uniform(0, 0.05, mdl.num_rows))
        mdl.row_lower = np.where(mdl.row_lower > -1e29, mdl.row_lower - shift, mdl.row_lower)
        mdl.row_upper = np.where(mdl.row_upper < 1e29, mdl.row_upper + shift, mdl.row_upper)
        models.append(mdl)
    out = {dev: solve_batch_ipm([m.copy() for m in models], SolveOptions(device=dev))
           for dev in ("cpu", "cuda")}
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.status == b.status
        assert a.iterations == b.iterations
        assert abs(a.objective_value - b.objective_value) <= 1e-9 * (1 + abs(b.objective_value))


def test_pe_signs_on_card_match_cpu(cuda_device):
    from clp_tpu_torch.utils.prng import rademacher

    for seed in (20210, 777):
        for it in (0, 1, 12345):
            for n in (1, 7, 6656):
                d = torch.tensor(it, dtype=torch.int32)
                assert torch.equal(rademacher(seed, d.to(cuda_device), n).cpu(),
                                   rademacher(seed, d, n))


def test_ranging_on_card_matches_cpu(cuda_device):
    """Ranging's tensor ops on the card against the same ops on the CPU, on
    one solved basis: the LU's last bits apart, within 1e-9."""
    from clp_tpu_torch import SolveOptions, ranging
    from clp_tpu_torch.constants import SolveMethod
    from clp_tpu_torch.utils.generators import staircase_lp

    model = staircase_lp(4, 32, 72, seed=2)
    opts = SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device="cpu")
    model.initial_solve(opts)
    on_cpu = ranging(model, device="cpu")
    on_card = ranging(model, device="cuda")
    for f in ("cost_down", "cost_up", "rhs_down", "rhs_up"):
        a, b = getattr(on_card, f), getattr(on_cpu, f)
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=f)
        fin = np.isfinite(b)
        assert np.all(np.abs(a[fin] - b[fin]) <= 1e-9 * (1 + np.abs(b[fin]))), f


def test_cli_solve_on_card_launches_k1(cuda_device, tmp_path, monkeypatch):
    """The in-process `clp` solve of a 512-row LP on the card (the default
    device) runs the dual simplex through K1."""
    from clp_tpu_torch.cli import CLI
    from clp_tpu_torch.constants import ProblemStatus
    from clp_tpu_torch.utils.generators import random_lp

    monkeypatch.delenv("CLPTPU_PLATFORM", raising=False)
    model = random_lp(512, 1024, seed=3, density=0.05)
    path = str(tmp_path / "m.mps")
    model.write_mps(path)
    n1 = price_and_ratios.launches
    cli = CLI()
    assert cli.options.device == "cuda"
    assert cli.run_args([path, "-dualsimplex"]) == 0
    assert cli.model.solution.status == ProblemStatus.OPTIMAL
    assert price_and_ratios.launches > n1
    cpu = CLI()
    cpu.options.device = "cpu"
    assert cpu.run_args([path, "-dualsimplex"]) == 0
    a, b = cli.model.solution.objective_value, cpu.model.solution.objective_value
    assert abs(a - b) <= 1e-9 * (1 + abs(b))


def test_c_api_client_on_card(cuda_device, tmp_path):
    """The C client test_capi.c against the port's C API, with
    CLPTPU_PLATFORM unset: its solves run on the card."""
    import os
    import pathlib
    import subprocess
    import sys

    from clp_tpu_torch.io import native

    lib = native.build_capi()
    exe = str(tmp_path / "test_capi")
    r = subprocess.run(["gcc", str(native.NATIVE_DIR / "test_capi.c"), "-I",
                        str(native.NATIVE_DIR), str(lib), "-lm", "-o", exe],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    env = {k: v for k, v in os.environ.items() if k != "CLPTPU_PLATFORM"}
    env["CLPTPU_ROOT"] = root
    env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in sys.path if p])
    r = subprocess.run([exe], cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr[-2000:])
    assert "C API test OK" in r.stdout


def test_bucketed_solve_on_card_matches_cpu(cuda_device):
    """shape_bucket on the card: the padded dual simplex (K1 on every pivot
    of its f32 engine) against the same bucketed solve on the CPU, both
    stripped back to the model's sizes."""
    from clp_tpu_torch import SolveOptions, check_kkt, initial_solve
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.utils.generators import random_lp

    kw = dict(method=SolveMethod.DUAL_SIMPLEX, shape_bucket=128)
    cpu = initial_solve(random_lp(500, 900, seed=4, density=0.05),
                        SolveOptions(device="cpu", **kw))
    model = random_lp(500, 900, seed=4, density=0.05)
    n1 = price_and_ratios.launches
    card = initial_solve(model, SolveOptions(device="cuda", **kw))
    assert cpu.status == card.status == ProblemStatus.OPTIMAL
    assert price_and_ratios.launches > n1  # 512 x 1536 after padding: K1 on
    assert card.primal.shape == (900,) and card.duals.shape == (500,)
    assert abs(card.objective_value - cpu.objective_value) <= 1e-9 * (
        1 + abs(cpu.objective_value))
    assert check_kkt(model, x=card.primal, y=card.duals, tol=1e-6).ok


def test_colsharded_solve_on_card_matches_single_device(cuda_device):
    """The column-sharded dual engine over ["cuda:0"] * 4 against the
    single-device engine on the card, with the card's settings."""
    from clp_tpu_torch.forms import to_standard_form
    from clp_tpu_torch.parallel.colshard import dual_solve_colsharded, make_block_mesh
    from clp_tpu_torch.simplex import engine
    from clp_tpu_torch.utils.generators import random_lp

    lp, _ = to_standard_form(random_lp(256, 448, seed=1, density=0.05), device="cuda")
    opts = engine.SimplexOptions(inverse_dtype="float32", inner_unroll=8,
                                 refactor_frequency=400, dual_ratio="bfrt")
    st = engine.initial_state(lp, opts)
    st = engine.make_dual_feasible(lp, engine.recompute(lp, st, opts.dual_bound), opts)
    ref = engine.dual_solve(lp, st, opts)
    stats = {}
    out, slp, nt0 = dual_solve_colsharded(lp, opts, make_block_mesh(["cuda:0"] * 4),
                                          stats=stats)
    assert int(ref.status) == int(out.status) == engine.OPTIMAL
    assert out.vstat.device.type == "cuda" and stats["pivots"] > 0

    def objective(lp_, s):
        xn = engine.nonbasic_values(lp_, s.vstat, opts.dual_bound)
        return float(lp_.c.index_select(0, s.basis) @ s.xb + lp_.c @ xn)

    a, b = objective(slp, out), objective(lp, ref)
    assert abs(a - b) <= 1e-9 * (1 + abs(b))
