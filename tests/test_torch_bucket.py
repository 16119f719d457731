"""Port parity of shape bucketing: the simplex driver's `_bucketed_solve`
and the barrier's `_pad_ipm_lp` (clp_tpu_torch vs clp_tpu, CPU, f64).

The JAX tests also assert that a second shape in the same bucket solves
at least 3x (simplex) or 2x (barrier) faster than the first, because it
reuses the first one's compiled program. The port compiles nothing, so
there is no such cache to show; what it keeps of bucketing is that the
padded solve gives the unpadded answer, which these tests hold to the
JAX package's padded solve: status, objective, iterations, shapes."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clp_tpu
from clp_tpu.simplex.driver import simplex_solve as jax_simplex_solve
from clp_tpu.solve import _pad_ipm_lp as jax_pad_ipm_lp, _solve_barrier as jax_solve_barrier
from clp_tpu.forms import to_ipm_form as jax_to_ipm_form
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch import check_kkt
from clp_tpu_torch.forms import to_ipm_form
from clp_tpu_torch.simplex.driver import _bucket_shape, simplex_solve
from clp_tpu_torch.solve import _barrier_plan, _pad_ipm_lp, _solve_barrier
from tests.test_torch_qp import port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _opts(pkg, **kw):
    o = pkg.SolveOptions(method=pkg.SolveMethod.DUAL_SIMPLEX, **kw)
    o.presolve.enabled = False
    return o


def test_bucket_shape():
    assert _bucket_shape(37, 61, 64) == (64, 64) == _bucket_shape(41, 59, 64)
    assert _bucket_shape(64, 128, 64) == (64, 128)


@pytest.mark.parametrize("shape", [(37, 61), (41, 59)], ids=["37x61", "41x59"])
def test_bucketed_simplex_matches_jax(shape):
    m_, n_ = shape
    mj = jgen.random_lp(m_, n_, seed=5)
    mt = port_model(mj)
    js = jax_simplex_solve(mj, _opts(clp_tpu, shape_bucket=64), dual=True)
    ts = simplex_solve(mt, _opts(clp_tpu_torch, shape_bucket=64, device="cpu"), dual=True)
    assert int(ts.status) == int(js.status) == int(clp_tpu.ProblemStatus.OPTIMAL)
    assert abs(ts.objective_value - js.objective_value) <= 1e-9 * (1 + abs(js.objective_value))
    assert ts.iterations == js.iterations
    for name, size in (("primal", n_), ("reduced_costs", n_), ("column_status", n_),
                       ("duals", m_), ("row_activity", m_), ("row_status", m_)):
        assert getattr(ts, name).shape == getattr(js, name).shape == (size,), name
    assert mt.solution is ts
    # the padded solve gives the unpadded answer
    ref = simplex_solve(port_model(mj), _opts(clp_tpu_torch, device="cpu"), dual=True)
    assert abs(ts.objective_value - ref.objective_value) <= 1e-9 * (1 + abs(ref.objective_value))
    assert check_kkt(mt, x=ts.primal, y=ts.duals, tol=1e-7).ok


def test_bucketed_warm_start_matches_jax():
    """A warm Solution is padded with FIXED column and BASIC row statuses:
    the warm re-solve of the optimal basis takes the JAX package's pivots."""
    mj = jgen.random_lp(37, 61, seed=6)
    mt = port_model(mj)
    js = jax_simplex_solve(mj, _opts(clp_tpu), dual=True)
    ts = simplex_solve(mt, _opts(clp_tpu_torch, device="cpu"), dual=True)
    j2 = jax_simplex_solve(mj, _opts(clp_tpu, shape_bucket=64), dual=True, warm=js)
    t2 = simplex_solve(mt, _opts(clp_tpu_torch, shape_bucket=64, device="cpu"), dual=True,
                       warm=ts)
    assert int(t2.status) == int(j2.status) == int(clp_tpu.ProblemStatus.OPTIMAL)
    assert t2.iterations == j2.iterations
    assert abs(t2.objective_value - j2.objective_value) <= 1e-9 * (1 + abs(j2.objective_value))
    assert ts.column_status.shape == (61,)  # the warm start was not padded in place


def test_bucketed_certificates_match_jax():
    for make, status, ray, size in (
            (jgen.infeasible_lp, clp_tpu.ProblemStatus.PRIMAL_INFEASIBLE,
             "infeasibility_ray", "num_rows"),
            (jgen.unbounded_lp, clp_tpu.ProblemStatus.DUAL_INFEASIBLE,
             "unbounded_ray", "num_cols")):
        mj = make()
        mt = port_model(mj)
        js = jax_simplex_solve(mj, _opts(clp_tpu, shape_bucket=64), dual=True)
        ts = simplex_solve(mt, _opts(clp_tpu_torch, shape_bucket=64, device="cpu"),
                           dual=True)
        assert int(ts.status) == int(js.status) == int(status)
        jr, tr = getattr(js, ray), getattr(ts, ray)
        assert (jr is None) == (tr is None)
        if tr is not None:
            assert tr.shape == jr.shape == (getattr(mt, size),)


def _fixed_col_model():
    """tests/test_interior.py's padding case: a model with a FIXED column."""
    mfix = jgen.random_lp(13, 21, seed=9)
    mfix.col_lower = mfix.col_lower.copy()
    mfix.col_upper = mfix.col_upper.copy()
    mfix.col_lower[3] = mfix.col_upper[3] = 0.5
    return mfix


@pytest.mark.parametrize("quadratic", [False, True], ids=["lp", "qp"])
def test_pad_ipm_lp_matches_jax_exactly(quadratic):
    mj = _fixed_col_model()
    if quadratic:
        mj.load_quadratic_objective(sp.diags(np.linspace(0.5, 2.0, 21)).tocsc())
    jlp, _ = jax_to_ipm_form(mj)
    tlp, _ = to_ipm_form(port_model(mj), device="cpu")
    jp, jd = jax_pad_ipm_lp(jlp, 64)
    tp, td = _pad_ipm_lp(tlp, 64)
    assert td == jd == tuple(tlp.G.shape)
    assert tp.G.shape[0] % 64 == 0 and tp.G.shape[1] % 64 == 0
    for k in ("G", "b", "c", "l", "u") + (("Q",) if quadratic else ()):
        assert np.array_equal(getattr(tp, k).numpy(), np.asarray(getattr(jp, k))), k
    assert (tp.Q is None) == (jp.Q is None)
    # pad rows are satisfied strictly interior at x_pad = 0
    assert bool((tp.l[tlp.G.shape[1]:] < 0).all() and (tp.u[tlp.G.shape[1]:] > 0).all())
    aligned, dims = _pad_ipm_lp(tp, 64)
    assert aligned is tp and dims is None


@pytest.mark.parametrize("shape", [(37, 61), (41, 59)], ids=["37x61", "41x59"])
def test_bucketed_barrier_matches_jax(shape):
    m_, n_ = shape
    mj = jgen.random_lp(m_, n_, seed=5)
    mt = port_model(mj)
    js = jax_solve_barrier(mj, clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.BARRIER,
                                                    shape_bucket=64))
    ts = _solve_barrier(mt, clp_tpu_torch.SolveOptions(
        method=clp_tpu_torch.SolveMethod.BARRIER, shape_bucket=64, device="cpu"))
    assert int(ts.status) == int(js.status) == int(clp_tpu.ProblemStatus.OPTIMAL)
    assert ts.iterations == js.iterations
    assert abs(ts.objective_value - js.objective_value) <= 1e-9 * (1 + abs(js.objective_value))
    assert ts.primal.shape == (n_,) and ts.duals.shape == (m_,)
    assert check_kkt(mt, x=ts.primal, y=ts.duals, tol=1e-5).ok


def test_bucketed_barrier_qp_matches_jax():
    """A separable QP at bucket 32: the padded Q stays diagonal, so the
    q_diag branch still runs."""
    mj = jgen.random_lp(11, 17, seed=31)
    mj.load_quadratic_objective(sp.diags(np.linspace(0.5, 2.0, 17)).tocsc())
    mt = port_model(mj)
    js = jax_solve_barrier(mj, clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.BARRIER,
                                                    shape_bucket=32))
    ts = _solve_barrier(mt, clp_tpu_torch.SolveOptions(
        method=clp_tpu_torch.SolveMethod.BARRIER, shape_bucket=32, device="cpu"))
    assert int(ts.status) == int(js.status) == int(clp_tpu.ProblemStatus.OPTIMAL)
    assert ts.iterations == js.iterations
    assert abs(ts.objective_value - js.objective_value) <= 1e-9 * (1 + abs(js.objective_value))
    assert ts.timings["barrier_stats"]["branch"].endswith("q_diag")


def test_bucketed_barrier_keeps_off_the_multifrontal():
    """A bucketed form plans the banded and dense branches only, as the
    JAX package's (`bucket == 0 and ...`); unbucketed, the same sparse
    512-row form takes the host multifrontal."""
    from clp_tpu_torch.interior.mehrotra import IPMOptions

    rng = np.random.default_rng(0)
    G = sp.random(512, 1024, density=0.004, random_state=rng).toarray()
    G[np.arange(512), np.arange(512)] = 1.0
    _, plain = _barrier_plan(G, IPMOptions(), torch.device("cpu"))
    _, bucketed = _barrier_plan(G, IPMOptions(), torch.device("cpu"), sparse=False)
    assert plain.band_nb == bucketed.band_nb == 0
    assert plain.sparse_chol is not None
    assert bucketed.sparse_chol is None and bucketed.sparse_chol_device is None
