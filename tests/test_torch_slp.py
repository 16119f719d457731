"""Port parity of slp.py: `nonlinear_slp` and `nonlinear_slp_constrained`
with a gradient callable both packages share, and with the gradient left
out (torch.autograd in the port, jax.grad in the JAX package, on the same
function written twice), on the cases of tests/test_slp.py. The LP
sub-solves run with device="cpu"."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clp_tpu
from clp_tpu.slp import Constraint as JaxConstraint
from clp_tpu.slp import nonlinear_slp as jax_slp
from clp_tpu.slp import nonlinear_slp_constrained as jax_slp_constrained

import clp_tpu_torch
from clp_tpu_torch.constants import INF, ProblemStatus, SolveMethod
from clp_tpu_torch.slp import Constraint, nonlinear_slp, nonlinear_slp_constrained
from tests.test_torch_qp import port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _assert_same(got, want, tol=1e-9):
    assert int(got.status) == int(want.status) == int(ProblemStatus.OPTIMAL)
    assert got.iterations == want.iterations
    assert abs(got.objective_value - want.objective_value) <= tol * (
        1 + abs(want.objective_value))
    np.testing.assert_allclose(got.primal, want.primal, rtol=tol, atol=tol)


def _quadratic_case():
    """tests/test_slp.py's convex quadratic: rows, bounds, Q and c."""
    rng = np.random.default_rng(2)
    n, m = 5, 3
    A = rng.uniform(0, 1, (m, n))
    Q = np.diag(rng.uniform(1.0, 2.0, n))
    c = rng.uniform(-3, -1, n)
    mod = clp_tpu.Model()
    mod.load_problem(sp.csc_matrix(A), col_lower=np.zeros(n), col_upper=np.full(n, 2.0),
                     objective=c, row_lower=np.full(m, -INF),
                     row_upper=rng.uniform(2.0, 4.0, m))
    return mod, Q, c


def test_shared_gradient_matches_jax_and_the_qp_barrier():
    mj, Q, c = _quadratic_case()

    def f(x):
        return float(c @ x + 0.5 * x @ (Q @ x))

    def g(x):
        return c + Q @ x

    want = jax_slp(mj.copy(), f, g, max_passes=80)
    got = nonlinear_slp(port_model(mj), f, g, max_passes=80, device="cpu")
    _assert_same(got, want)
    # and the quadratic twin through the port's QP barrier
    mq = port_model(mj)
    mq.load_quadratic_objective(sp.csc_matrix(Q))
    ref = clp_tpu_torch.initial_solve(mq, clp_tpu_torch.SolveOptions(
        method=SolveMethod.BARRIER, crossover=False, device="cpu"))
    assert abs(got.objective_value - ref.objective_value) < 1e-4 * (
        1 + abs(ref.objective_value))
    np.testing.assert_allclose(got.primal, ref.primal, atol=1e-3)


def _log_model(lib):
    m = lib.Model()
    m.load_problem(sp.csc_matrix(np.array([[1.0, 1.0]])), col_lower=[0.1, 0.1],
                   col_upper=[5.0, 5.0], objective=[0.0, 0.0], row_lower=[-INF],
                   row_upper=[4.0])
    return m


def test_autograd_matches_jax_grad():
    """-log x1 - log x2 + x1 + x2, written once for jax.grad and once for
    torch.autograd: the same passes and point, the known optimum (1, 1)."""
    def fj(x):
        return -jnp.log(x[0]) - jnp.log(x[1]) + x[0] + x[1]

    def ft(x):
        return -torch.log(x[0]) - torch.log(x[1]) + x[0] + x[1]

    want = jax_slp(_log_model(clp_tpu), fj, max_passes=60)
    got = nonlinear_slp(_log_model(clp_tpu_torch), ft, max_passes=60, device="cpu")
    _assert_same(got, want)
    np.testing.assert_allclose(got.primal, [1.0, 1.0], atol=5e-3)


def _circle_model(lib):
    m = lib.Model()
    m.load_problem(sp.csc_matrix(np.array([[1.0, 1.0]])), col_lower=[-2.0, -2.0],
                   col_upper=[2.0, 2.0], objective=[-1.0, -1.0], row_lower=[-10.0],
                   row_upper=[10.0])
    return m


@pytest.mark.parametrize("gradient", ["shared", "autograd"])
def test_constrained_circle_matches_jax(gradient):
    """min -x-y s.t. x^2 + y^2 <= 1: (r2/2, r2/2), as in the JAX package."""
    if gradient == "shared":
        def val(x):
            return float(np.sum(np.asarray(x) ** 2))

        def grad(x):
            return 2.0 * np.asarray(x)

        cj = JaxConstraint(val, lower=-np.inf, upper=1.0, gradient=grad)
        ct = Constraint(val, lower=-np.inf, upper=1.0, gradient=grad)
    else:
        cj = JaxConstraint(lambda x: jnp.sum(x * x), lower=-np.inf, upper=1.0)
        ct = Constraint(lambda x: torch.sum(x * x), lower=-np.inf, upper=1.0)
    want = jax_slp_constrained(_circle_model(clp_tpu), [cj], max_passes=100)
    got = nonlinear_slp_constrained(_circle_model(clp_tpu_torch), [ct], max_passes=100,
                                    device="cpu")
    _assert_same(got, want)
    r2 = np.sqrt(2) / 2
    np.testing.assert_allclose(got.primal, [r2, r2], atol=1e-4)


def test_constrained_nonlinear_objective_matches_jax():
    """min (x-2)^2 + (y-2)^2 s.t. x + y <= 2 and xy >= 0.5, autograd on
    both sides: the symmetric optimum (1, 1)."""
    def build(lib):
        m = lib.Model()
        m.load_problem(sp.csc_matrix(np.array([[1.0, 1.0]])), col_lower=[0.0, 0.0],
                       col_upper=[5.0, 5.0], objective=[0.0, 0.0], row_lower=[-INF],
                       row_upper=[2.0])
        return m

    want = jax_slp_constrained(
        build(clp_tpu), [JaxConstraint(lambda x: x[0] * x[1], lower=0.5, upper=np.inf)],
        objective=lambda x: jnp.sum((x - 2.0) ** 2), max_passes=150)
    got = nonlinear_slp_constrained(
        build(clp_tpu_torch), [Constraint(lambda x: x[0] * x[1], lower=0.5, upper=np.inf)],
        objective=lambda x: torch.sum((x - 2.0) ** 2), max_passes=150, device="cpu")
    _assert_same(got, want, tol=1e-7)
    np.testing.assert_allclose(got.primal, [1.0, 1.0], atol=1e-3)


def test_autograd_gradient_is_f64_numpy():
    from clp_tpu_torch.slp import _autograd

    g = _autograd(lambda x: torch.sum(x ** 3))(np.array([1.0, -2.0]))
    assert isinstance(g, np.ndarray) and g.dtype == np.float64
    np.testing.assert_array_equal(g, [3.0, 12.0])
