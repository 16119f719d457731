"""Port parity for the sparse normal equations: the host plan
(ops/sparse_chol.py, the port's own copy), the device multifrontal numeric
(ops/sparse_chol_device.py) in f64 and f32 on the CPU, and the barrier on
its host multifrontal branch (clp_tpu_torch vs clp_tpu on the same inputs)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import clp_tpu
from clp_tpu.ops import sparse_chol as jsc
from clp_tpu.ops import sparse_chol_device as jscd

import clp_tpu_torch
from clp_tpu_torch.ops import sparse_chol as tsc
from clp_tpu_torch.ops import sparse_chol_device as tscd
from tests.test_sparse_chol import window_lp
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _window_G(m=512, ncols=1024, win=30, k=8, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(m):
        base = int(i * (ncols - win) / m)
        for j in base + rng.choice(win, k, replace=False):
            rows.append(i), cols.append(int(j)), vals.append(rng.normal())
    return sp.csr_matrix((vals, (rows, cols)), shape=(m, ncols))


def _grid(k=14):
    n = k * k
    rows, cols = [], []
    for i in range(k):
        for j in range(k):
            for di, dj in ((0, 1), (1, 0)):
                if i + di < k and j + dj < k:
                    rows.append(i * k + j)
                    cols.append((i + di) * k + (j + dj))
    S = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    return (S + S.T + sp.eye(n) * 4).tocsc()


def _spd(n, dens, seed):
    rng = np.random.default_rng(seed)
    B = sp.random(n, n, density=dens, random_state=seed,
                  data_rvs=lambda s: rng.normal(size=s))
    return (B @ B.T + sp.eye(n)).tocsc(), rng


def test_minimum_degree_and_plan_match_jax():
    S = _grid()
    perm_t = tsc.minimum_degree(S)
    np.testing.assert_array_equal(perm_t, jsc.minimum_degree(S))
    pj, pt = jsc.SparseCholesky(S), tsc.SparseCholesky(S)
    np.testing.assert_array_equal(pt.perm, pj.perm)
    np.testing.assert_array_equal(pt.sn_start, pj.sn_start)
    assert pt.nnz_L == pj.nnz_L and pt.flops == pj.flops
    assert pt.nnz_L < 0.6 * tsc.SparseCholesky(S, perm=np.arange(S.shape[0])).nnz_L


@pytest.mark.parametrize("n,dens,seed", [(60, 0.1, 0), (300, 0.03, 2)])
def test_multifrontal_factor_solve_matches_jax(n, dens, seed):
    S, rng = _spd(n, dens, seed)
    pj, pt = jsc.SparseCholesky(S), tsc.SparseCholesky(S)
    assert pj.factor(S) and pt.factor(S)
    rhs = rng.normal(size=n)
    xt = pt.solve(rhs)
    np.testing.assert_allclose(xt, pj.solve(rhs), rtol=0, atol=1e-12 * np.abs(xt).max())
    np.testing.assert_allclose(S @ xt, rhs, rtol=0, atol=1e-9)


def test_make_normal_solver_window_pattern_and_declines():
    mj = window_lp(768, 1536, 30, 5)
    G = sp.hstack([mj.matrix, sp.eye(768)]).tocsr()
    sj, st = jsc.make_normal_solver(G, reg=1e-10), tsc.make_normal_solver(G, reg=1e-10)
    assert sj is not None and st is not None
    rng = np.random.default_rng(1)
    d = rng.random(G.shape[1]) + 0.1
    rhs = rng.normal(size=768)
    dy = st(d, rhs)
    np.testing.assert_allclose(dy, sj(d, rhs), rtol=0, atol=1e-10 * np.abs(dy).max())
    S = (G.multiply(d) @ G.T + 1e-10 * sp.eye(768)).tocsc()
    assert np.linalg.norm(S @ dy - rhs) < 1e-8 * np.linalg.norm(rhs)
    np.testing.assert_array_equal(st(d, rhs), dy)  # the cached factor
    # declines where the JAX package's plan declines: fewer than 512 rows,
    # a dense pattern, too many dense columns
    small = _window_G(m=256, ncols=512)
    dense = sp.csr_matrix(np.random.default_rng(2).normal(size=(600, 700)))
    arrow = sp.hstack([_window_G(m=600, ncols=1200), sp.csr_matrix(np.ones((600, 70)))]).tocsr()
    for G_ in (small, dense, arrow):
        assert jsc.make_normal_solver(G_, reg=1e-10) is None
        assert tsc.make_normal_solver(G_, reg=1e-10) is None


def test_make_normal_solver_woodbury_dense_columns():
    """A few dense coupling columns are split off and solved through the
    Woodbury identity, in both packages alike."""
    rng = np.random.default_rng(3)
    G = sp.hstack([_window_G(m=600, ncols=1200, seed=3),
                   sp.csr_matrix(rng.normal(size=(600, 3)))]).tocsr()
    sj, st = jsc.make_normal_solver(G, reg=1e-9), tsc.make_normal_solver(G, reg=1e-9)
    assert sj is not None and st is not None
    d = rng.random(G.shape[1]) + 0.1
    rhs = rng.normal(size=600)
    dy = st(d, rhs)
    np.testing.assert_allclose(dy, sj(d, rhs), rtol=0, atol=1e-10 * np.abs(dy).max())


def test_device_multifrontal_f64_matches_jax():
    """The port's DeviceSparseCholesky in f64 against the JAX package's, as
    tests/test_sparse_chol_device.py runs it on the CPU: factors and solve
    to 1e-9, and the same bits over two factorizations."""
    G = _window_G()
    m = G.shape[0]
    rng = np.random.default_rng(1)
    d = rng.random(G.shape[1]) + 0.1
    S = (G.multiply(d) @ G.T + 1e-8 * sp.eye(m)).tocsc()
    plan = tsc.SparseCholesky(S)
    jplan = jsc.SparseCholesky(S)
    data = plan._permuted_data(S)
    rhs = rng.normal(size=m)

    jdev = jscd.DeviceSparseCholesky(jplan, dtype=jnp.float64)
    jf, jok = jax.jit(jdev.factor)(jnp.asarray(data))
    xj = np.asarray(jax.jit(jdev.solve)(jf, jnp.asarray(rhs)))

    tdev = tscd.DeviceSparseCholesky(plan, dtype=torch.float64, device="cpu")
    assert [(b["nr_p"], b["w_p"], b["B"]) for b in tdev.buckets()] == [
        (b["nr_p"], b["w_p"], b["B"]) for lv in jdev.schedule for b in lv]
    tf, tok = tdev.factor(torch.as_tensor(data))
    assert bool(tok) and bool(jok)
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9)
    xt = tdev.solve(tf, torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-9)
    assert np.linalg.norm(S @ xt - rhs) <= 1e-7 * np.linalg.norm(rhs)
    tf2, _ = tdev.factor(torch.as_tensor(data))
    assert all(torch.equal(a, b) for a, b in zip(tf, tf2))
    assert torch.equal(tdev.solve(tf2, torch.as_tensor(rhs)), tdev.solve(tf, torch.as_tensor(rhs)))


def test_device_factor_reports_breakdown_like_jax():
    """An indefinite input fails the factor in both packages; the shifted
    refactor the IPM falls back to then succeeds in both."""
    S, _ = _spd(80, 0.08, 4)
    S = (S - 3.0 * sp.eye(80)).tocsc()
    plan = tsc.SparseCholesky(S)
    data = plan._permuted_data(S)
    jdev = jscd.DeviceSparseCholesky(jsc.SparseCholesky(S), dtype=jnp.float64)
    tdev = tscd.DeviceSparseCholesky(plan, dtype=torch.float64, device="cpu")
    _, jok = jax.jit(jdev.factor)(jnp.asarray(data))
    _, tok = tdev.factor(torch.as_tensor(data))
    assert not bool(jok) and not bool(tok)
    _, jok = jax.jit(lambda v: jdev.factor(v, shift=10.0))(jnp.asarray(data))
    _, tok = tdev.factor(torch.as_tensor(data), shift=10.0)
    assert bool(jok) and bool(tok)


def test_normal_equations_values_match_jax():
    G = _window_G(m=256, ncols=512, win=20, k=6, seed=3)
    rng = np.random.default_rng(4)
    d = rng.random(G.shape[1]) + 0.05
    Gp = sp.csr_matrix(G, copy=True)
    Gp.data[:] = 1.0
    S_pat = (Gp @ Gp.T + sp.eye(256, format="csr")).tocsc()
    plan = tsc.SparseCholesky(S_pat)
    vals = tscd.NormalEquationsDevice(G, plan, 1e-9, device="cpu").values(torch.as_tensor(d))
    jvals = jscd.NormalEquationsDevice(G, jsc.SparseCholesky(S_pat), 1e-9).values(jnp.asarray(d))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-12, atol=1e-12)
    S = (G.multiply(d) @ G.T + 1e-9 * sp.eye(256)).tocsc()
    np.testing.assert_allclose(vals.numpy(), plan._permuted_data(S), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_device_normal_solver_matches_jax(dtype):
    """make_device_normal_solver takes the JAX package's decisions, and its
    Jacobi-scaled solve (f32 with three f64 refinements, as the IPM runs
    it) reaches f64-class accuracy."""
    G = _window_G(m=640, ncols=1280, win=32, k=8, seed=5)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    st = tscd.make_device_normal_solver(G, reg=1e-9, dtype=tdt, device="cpu")
    sj = jscd.make_device_normal_solver(G, reg=1e-9, dtype=jdt)
    assert st is not None and sj is not None
    rng = np.random.default_rng(6)
    d = rng.random(G.shape[1]) + 0.01
    rhs = rng.normal(size=G.shape[0])
    S = (G.multiply(d) @ G.T + 1e-9 * sp.eye(G.shape[0])).tocsc()
    fstate, ok = st.factor(torch.as_tensor(d))
    assert bool(ok)
    x = st.solve_with(fstate, torch.as_tensor(rhs))
    for _ in range(3 if dtype == "float32" else 0):
        x = x + st.solve_with(fstate, torch.as_tensor(rhs - S @ x.numpy()))
    assert np.linalg.norm(S @ x.numpy() - rhs) <= 1e-8 * np.linalg.norm(rhs)
    if dtype == "float64":
        xj = np.asarray(jax.jit(sj.solve)(jnp.asarray(d), jnp.asarray(rhs)))
        np.testing.assert_allclose(x.numpy(), xj, rtol=1e-9, atol=1e-9)
    for G_ in (_window_G(m=256, ncols=512),
               sp.hstack([_window_G(m=600, ncols=1200), sp.csr_matrix(np.ones((600, 2)))])):
        assert tscd.make_device_normal_solver(G_, reg=1e-9, device="cpu") is None
        assert jscd.make_device_normal_solver(G_, reg=1e-9) is None


def test_barrier_on_host_multifrontal_branch_matches_jax():
    """A 512-row window LP: BARRIER_NO_CROSS takes the host multifrontal
    branch on the CPU in both packages, with the same IPM iterations and
    objective; default AUTOMATIC agrees too."""
    mj = window_lp(512, 1024, 30, 7)
    mt = clp_tpu_torch.Model()
    mt.load_problem(mj.matrix, mj.col_lower, mj.col_upper, mj.objective,
                    mj.row_lower, mj.row_upper)
    for method in ("BARRIER_NO_CROSS", "AUTOMATIC"):
        oj = clp_tpu.SolveOptions(method=clp_tpu.SolveMethod[method])
        oj.presolve.enabled = False
        ot = clp_tpu_torch.SolveOptions(method=clp_tpu_torch.SolveMethod[method], device="cpu")
        ot.presolve.enabled = False
        sj, st = clp_tpu.initial_solve(mj, oj), clp_tpu_torch.initial_solve(mt, ot)
        assert st.status.name == sj.status.name == "OPTIMAL"
        assert abs(st.objective_value - sj.objective_value) <= 1e-9 * (1 + abs(sj.objective_value))
        assert st.timings["barrier_stats"]["branch"] == "host multifrontal"
        if method == "BARRIER_NO_CROSS":
            assert st.iterations == sj.iterations
            assert clp_tpu_torch.check_kkt(mt, x=st.primal, y=st.duals, tol=1e-5).ok
