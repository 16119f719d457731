"""Port parity of piecewise.py (a numpy copy on the host): the in-engine
kink-aware primal `solve_piecewise` gives the JAX package's status,
iterations, objective and point on the cases of tests/test_piecewise.py;
the reformulation `set_piecewise_linear_cost` builds the same model and,
solved through `initial_solve`, the same answer; a model with attached
piecewise costs routes through `initial_solve` as in the JAX package."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clp_tpu
from clp_tpu.piecewise import (
    recover_piecewise_value as jax_recover,
    set_piecewise_linear_cost as jax_set_pwl,
    solve_piecewise as jax_solve_piecewise,
)

import clp_tpu_torch
from clp_tpu_torch.constants import INF, ProblemStatus, SolveMethod
from clp_tpu_torch.piecewise import (
    recover_piecewise_value,
    set_piecewise_linear_cost,
    solve_piecewise,
)
from tests.test_piecewise import _rand_lp
from tests.test_torch_qp import port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _random_case(seed, sense, lo):
    """tests/test_piecewise.py::test_inengine_matches_reformulation's LP and
    costs."""
    m, rng = _rand_lp(7, 12, seed, lo=lo)
    m.optimization_direction = sense
    pw = {}
    for j in rng.choice(12, 4, replace=False):
        k = int(rng.integers(2, 9))
        bps = np.concatenate([[lo], np.sort(rng.uniform(lo + 0.1, 2.9, k - 1)), [3.0]])
        pw[int(j)] = (bps, np.sort(rng.normal(size=k)) * sense)
    return m, pw


def _one_col(lo, up, obj, rl, ru, A=np.array([[1.0]])):
    m = clp_tpu.Model()
    m.load_problem(sp.csc_matrix(A), np.asarray(lo, float), np.asarray(up, float),
                   np.asarray(obj, float), np.asarray(rl, float), np.asarray(ru, float))
    return m


SMALL_CASES = {
    "rests-at-kink": lambda: (_one_col([0.0], [10.0], [0.0], [-INF], [INF]),
                              {0: ([0.0, 4.0, 10.0], [-2.0, 3.0])}),
    "unbounded-last-piece": lambda: (
        _one_col(np.zeros(2), [INF, 2.0], [0.0, 1.0], np.full(2, -INF), [INF, 2.0],
                 A=np.eye(2)),
        {0: ([0.0, 1.0, np.inf], [-1.0, -0.5])}),
    "infinite-domain": lambda: (_one_col([0.0], [INF], [0.0], [-INF], [INF]),
                                {0: ([0.0, 2.0, np.inf], [-1.5, 0.25])}),
}


def _assert_same(got, want):
    assert int(got.status) == int(want.status)
    assert got.iterations == want.iterations
    assert abs(got.objective_value - want.objective_value) <= 1e-9 * (
        1 + abs(want.objective_value))
    np.testing.assert_allclose(got.primal, want.primal, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(got.column_status, want.column_status)
    assert (got.unbounded_ray is None) == (want.unbounded_ray is None)
    if want.unbounded_ray is not None:
        np.testing.assert_allclose(got.unbounded_ray, want.unbounded_ray, atol=1e-12)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("sense,lo", [(1.0, 0.0), (-1.0, 0.0), (1.0, 0.4)])
def test_solve_piecewise_matches_jax(seed, sense, lo):
    mj, pw = _random_case(seed, sense, lo)
    want = jax_solve_piecewise(mj.copy(), pw)
    mt = port_model(mj)
    got = solve_piecewise(mt, pw)
    assert mt.num_cols == 12  # no columns added
    _assert_same(got, want)


@pytest.mark.parametrize("case", sorted(SMALL_CASES))
def test_solve_piecewise_small_cases_match_jax(case):
    mj, pw = SMALL_CASES[case]()
    _assert_same(solve_piecewise(port_model(mj), pw), jax_solve_piecewise(mj.copy(), pw))


def test_solve_piecewise_rejects_breakpoint_bound_mismatch():
    mj = _one_col([2.0], [10.0], [0.0], [-INF], [INF])
    with pytest.raises(ValueError, match="lower"):
        solve_piecewise(port_model(mj), {0: ([0.0, 4.0, 10.0], [-2.0, 3.0])})


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("sense", [1.0, -1.0])
def test_reformulation_matches_jax(seed, sense):
    """`set_piecewise_linear_cost` builds the JAX package's segment model;
    the dual simplex on it gives the same objective (1e-9) and recovered
    values, and matches the in-engine path (1e-7, across methods)."""
    mj, pw = _random_case(seed, sense, 0.0)
    mt = port_model(mj)
    infos_j = [jax_set_pwl(mj, j, *pw[j]) for j in pw]
    infos_t = [set_piecewise_linear_cost(mt, j, *pw[j]) for j in pw]
    for a in ("col_lower", "col_upper", "objective", "row_lower", "row_upper"):
        np.testing.assert_array_equal(getattr(mt, a), getattr(mj, a))
    assert (mt.matrix != mj.matrix).nnz == 0
    oj = clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.DUAL_SIMPLEX)
    oj.presolve.enabled = False
    ot = clp_tpu_torch.SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device="cpu")
    ot.presolve.enabled = False
    want = mj.initial_solve(oj)
    got = clp_tpu_torch.initial_solve(mt, ot)
    assert int(got.status) == int(want.status) == int(ProblemStatus.OPTIMAL)
    assert abs(got.objective_value - want.objective_value) <= 1e-9 * (
        1 + abs(want.objective_value))
    for it, ij in zip(infos_t, infos_j):
        assert it.segment_columns == ij.segment_columns
        assert abs(recover_piecewise_value(mt, it) - jax_recover(mj, ij)) <= 1e-7
    mi, _ = _random_case(seed, sense, 0.0)
    inengine = solve_piecewise(port_model(mi), pw)
    assert abs(inengine.objective_value - got.objective_value) <= 1e-7 * (
        1 + abs(got.objective_value))


def test_model_level_attachment_routes_like_jax():
    """`Model.set_piecewise_cost` + `initial_solve`: the in-engine route,
    presolve skipped, the JAX package's answer."""
    def build(lib):
        m = lib.Model()
        m.load_problem(sp.csc_matrix(np.array([[1.0, 1.0]])), np.zeros(2),
                       np.full(2, 10.0), np.array([0.0, 1.0]),
                       np.array([-INF]), np.array([6.0]))
        m.set_piecewise_cost(0, [0.0, 4.0, 10.0], [-2.0, 3.0])
        return m

    want = build(clp_tpu).initial_solve()
    got = clp_tpu_torch.initial_solve(build(clp_tpu_torch),
                                      clp_tpu_torch.SolveOptions(device="cpu"))
    _assert_same(got, want)
    assert abs(got.primal[0] - 4.0) < 1e-8
    assert set(got.timings) == {"solve"}


@pytest.mark.parametrize("seed", range(3))
def test_total_value_is_the_per_column_sum_bit_for_bit(seed):
    """The port's vectorized merit against the JAX package's per-column
    `value` loop, at points on both sides of the anchor and on kinks."""
    from clp_tpu.piecewise import _PwCosts as JaxCosts

    from clp_tpu_torch.piecewise import _PwCosts

    rng = np.random.default_rng(seed)
    nt = 40
    pw = {}
    for j in rng.choice(nt, 25, replace=False):
        k = int(rng.integers(1, 6))
        b = np.concatenate([[rng.uniform(-2, 0)], np.sort(rng.uniform(0, 5, k - 1)),
                            [np.inf if rng.random() < 0.3 else 6.0]])
        pw[int(j)] = (b, np.sort(rng.normal(size=k)))
    c = rng.normal(size=nt)
    costs, jcosts = _PwCosts(nt, c, pw), JaxCosts(nt, c, pw)
    cols = np.flatnonzero(costs.is_pw)
    x = rng.uniform(-3, 7, nt)
    x[cols[::4]] = costs.base[cols[::4]]
    for j in cols[1::4]:
        x[j] = pw[int(j)][0][-2]  # an interior kink, or the anchor
    want = sum(jcosts.value(v, x[v]) for v in cols)
    assert costs.total_value(cols, x[cols]) == want
