"""Port parity of ranging and parametrics (clp_tpu_torch vs clp_tpu, CPU).

Both packages get the same model and the same optimal basis (the JAX
package's solve, copied into the port's model), so the ranges and the
parametric walk must agree to the last bits of their LU: within
1e-8 * (1 + |v|), with the same infinities.

Ranging parity holds on LPs without fixed nonbasic variables: the port
leaves a variable with equal bounds (an equality row's slack, a fixed
column) out of the cost-ranging ratios, where the JAX package's loops
count it; `test_ranging_leaves_fixed_variables_out` pins that difference
and checks the port's ranges by re-solving."""

import numpy as np
import pytest
import torch

import clp_tpu
from clp_tpu.analysis import (
    _parametrics_bisect as jax_bisect,
    parametrics_exact as jax_parametrics_exact,
    ranging as jax_ranging,
)
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch import analysis
from clp_tpu_torch.constants import ProblemStatus, SolveMethod, VariableStatus
from tests.test_torch_qp import port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()

TOL = 1e-8


def _jax_solve(mj):
    o = clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.DUAL_SIMPLEX)
    o.presolve.enabled = False
    sol = mj.initial_solve(o)
    assert sol.status == clp_tpu.ProblemStatus.OPTIMAL
    return mj


def _with_jax_basis(mj):
    """The port's model carrying the JAX package's optimal solution."""
    mt = port_model(mj)
    s = mj.solution
    mt.solution = clp_tpu_torch.Solution(
        status=ProblemStatus(int(s.status)), objective_value=s.objective_value,
        primal=np.asarray(s.primal).copy(), duals=np.asarray(s.duals).copy(),
        reduced_costs=np.asarray(s.reduced_costs).copy(),
        row_activity=np.asarray(s.row_activity).copy(), iterations=s.iterations,
        column_status=np.asarray(s.column_status).copy(),
        row_status=np.asarray(s.row_status).copy())
    return mt


def _no_equalities(mj):
    """Equality rows widened to ranges: no slack is fixed."""
    eq = mj.row_lower == mj.row_upper
    mj.row_lower = np.where(eq, mj.row_lower - 0.25, mj.row_lower)
    mj.row_upper = np.where(eq, mj.row_upper + 0.25, mj.row_upper)
    return mj


def _boxed_max(seed=0):
    """Maximization with tight boxes: columns end at their upper bounds."""
    mj = jgen.random_lp(14, 22, seed=seed, equality_frac=0.0)
    mj.col_upper = np.full(22, 1.2)
    mj.optimization_direction = -1.0
    return mj


def _free_cols(seed=1):
    """Two free columns: they end basic or nonbasic free."""
    mj = jgen.random_lp(12, 20, seed=seed, equality_frac=0.0)
    mj.col_lower = mj.col_lower.copy()
    mj.col_upper = mj.col_upper.copy()
    mj.col_lower[[0, 5]] = -clp_tpu.INF
    mj.col_upper[[0, 5]] = clp_tpu.INF
    return mj


def _degenerate(seed=2):
    """A staircase whose right-hand sides are rounded: ties and zero
    basics (degenerate vertices)."""
    mj = jgen.staircase_lp(3, 8, 14, seed=seed)
    mj.row_lower = np.floor(mj.row_lower)
    mj.row_upper = np.ceil(mj.row_upper)
    return _no_equalities(mj)


CASES = {"boxed_max": _boxed_max, "free": _free_cols, "degenerate": _degenerate,
         "staircase": lambda: _no_equalities(jgen.staircase_lp(4, 10, 16, seed=3))}


def assert_close_with_infinities(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isposinf(a), np.isposinf(b), err_msg=what)
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b), err_msg=what)
    fin = np.isfinite(a)
    assert np.all(np.abs(a[fin] - b[fin]) <= TOL * (1 + np.abs(a[fin]))), what


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranging_matches_jax(case):
    mj = _jax_solve(CASES[case]())
    rj = jax_ranging(mj)
    rt = analysis.ranging(_with_jax_basis(mj), device="cpu")
    for f in ("cost_down", "cost_up", "rhs_down", "rhs_up"):
        assert_close_with_infinities(getattr(rt, f), getattr(rj, f), f"{case} {f}")


def test_ranging_cases_are_covered():
    """The cases above reach every branch of the ranging loops: basic and
    nonbasic structurals, at-upper columns, free columns, basic and
    nonbasic slacks, and finite and infinite ends."""
    seen = set()
    for case in CASES:
        mj = _jax_solve(CASES[case]())
        cs, rs = mj.solution.column_status, mj.solution.row_status
        seen |= {f"col{int(v)}" for v in np.unique(cs)} | {f"row{int(v)}" for v in np.unique(rs)}
        r = jax_ranging(mj)
        if np.isfinite(r.cost_up).any() and np.isinf(r.cost_up).any():
            seen.add("cost_up finite and infinite")
    for want in (f"col{int(VariableStatus.BASIC)}", f"col{int(VariableStatus.AT_UPPER)}",
                 f"col{int(VariableStatus.AT_LOWER)}", f"row{int(VariableStatus.BASIC)}",
                 "cost_up finite and infinite"):
        assert want in seen, (want, seen)
    # a free column in the free case's solution
    mj = _jax_solve(_free_cols())
    assert mj.solution.column_status[0] in (int(VariableStatus.BASIC), int(VariableStatus.FREE))


def test_ranging_on_the_ports_own_solve():
    """End to end on the CPU: the port solves, then ranges its own basis."""
    mj = _jax_solve(jgen.random_lp(10, 16, seed=4, equality_frac=0.0))
    mt = port_model(jgen.random_lp(10, 16, seed=4, equality_frac=0.0))
    o = clp_tpu_torch.SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device="cpu")
    o.presolve.enabled = False
    mt.initial_solve(o)
    np.testing.assert_array_equal(mt.solution.column_status, mj.solution.column_status)
    rj, rt = jax_ranging(mj), analysis.ranging(mt, device="cpu")
    for f in ("cost_down", "cost_up", "rhs_down", "rhs_up"):
        assert_close_with_infinities(getattr(rt, f), getattr(rj, f), f)


def test_ranging_leaves_fixed_variables_out():
    """On a staircase with equality rows and a fixed column, the JAX loops
    count the fixed nonbasic slacks and give basic columns inverted ranges
    (cost_up below the cost); the port leaves them out. Each of the port's
    finite range ends is checked by moving the cost 99% of the way there:
    the warm re-solve keeps the basis with no pivot, and the objective moves
    by dc * x_j. The two packages agree on every basic column whose tableau
    row has no nonbasic fixed variable in it, and on every nonbasic column
    that can move."""
    from clp_tpu_torch.simplex.driver import simplex_solve

    mj = jgen.staircase_lp(4, 16, 24, seed=0)
    mj.col_upper = mj.col_upper.copy()
    mj.col_lower = mj.col_lower.copy()
    mj.col_lower[5] = mj.col_upper[5] = 0.0
    mj = _jax_solve(mj)
    mt = _with_jax_basis(mj)
    rj = jax_ranging(mj)
    rt = analysis.ranging(mt, device="cpu")
    c = mt.objective
    s = mt.solution
    basic = s.column_status == int(VariableStatus.BASIC)
    inverted = (rj.cost_up < c - 1e-9) | (rj.cost_down > c + 1e-9)
    assert inverted[basic].any()  # the JAX loops' inversion
    assert np.all(rt.cost_up >= c - 1e-9) and np.all(rt.cost_down <= c + 1e-9)
    assert rt.cost_down[5] == -np.inf and rt.cost_up[5] == np.inf
    # where the fixed variables take no part, the ranges are the JAX loops'
    m, n = mt.num_rows, mt.num_cols
    G = np.hstack([mt.matrix.toarray(), -np.eye(m)])
    stat = np.concatenate([s.column_status, s.row_status])
    fixed_nb = ((stat != int(VariableStatus.BASIC))
                & (np.concatenate([mt.col_lower, mt.row_lower])
                   == np.concatenate([mt.col_upper, mt.row_upper])))
    basis = np.flatnonzero(stat == int(VariableStatus.BASIC))
    tableau = np.linalg.solve(G[:, basis], G)  # row r: basic variable basis[r]
    untouched = [basis[r] for r in range(m) if basis[r] < n
                 and not (np.abs(tableau[r, fixed_nb]) >= 1e-11).any()]
    movable_nb = np.flatnonzero(~basic & (mt.col_lower != mt.col_upper))
    assert untouched and movable_nb.size
    for js in (untouched, movable_nb):
        assert_close_with_infinities(rt.cost_down[js], rj.cost_down[js], "cost_down")
        assert_close_with_infinities(rt.cost_up[js], rj.cost_up[js], "cost_up")
    assert_close_with_infinities(rt.rhs_down, rj.rhs_down, "rhs_down")
    assert_close_with_infinities(rt.rhs_up, rj.rhs_up, "rhs_up")
    opts = clp_tpu_torch.SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device="cpu")
    opts.presolve.enabled = False
    warm = clp_tpu_torch.Solution(column_status=s.column_status, row_status=s.row_status)
    for j in range(mt.num_cols):
        for end in (rt.cost_up[j], rt.cost_down[j]):
            if not np.isfinite(end) or abs(end - c[j]) < 1e-4:
                continue
            mm = mt.copy()
            mm.objective = c.copy()
            mm.objective[j] += 0.99 * (end - c[j])
            sj = simplex_solve(mm, opts, dual=True, warm=warm)
            assert sj.status == ProblemStatus.OPTIMAL and sj.iterations == 0, j
            # the same basis; the fixed column may be relabelled at its other bound
            movable = mt.col_lower != mt.col_upper
            np.testing.assert_array_equal(sj.column_status[movable], s.column_status[movable])
            want = s.objective_value + 0.99 * (end - c[j]) * s.primal[j]
            assert abs(sj.objective_value - want) <= 1e-9 * (1 + abs(want)), j


def _directions(mj, kind, seed):
    rng = np.random.default_rng(seed)
    m, n = mj.num_rows, mj.num_cols
    if kind == "cost":
        return dict(dc=rng.standard_normal(n))
    if kind == "rhs":
        d = rng.standard_normal(m)
        return dict(d_row_lower=d, d_row_upper=d)
    return dict(d_col_lower=-rng.uniform(0, 0.2, n), d_col_upper=rng.uniform(-1, 0.1, n))


@pytest.mark.parametrize("case,kind,theta_end", [
    ("staircase", "cost", 4.0), ("boxed_max", "cost", 3.0), ("free", "rhs", 2.0),
    ("degenerate", "rhs", 3.0), ("staircase", "bounds", 2.0), ("boxed_max", "rhs", 50.0),
])
def test_parametrics_exact_matches_jax(case, kind, theta_end):
    mj = _jax_solve(CASES[case]())
    kw = _directions(mj, kind, seed=7)
    mt = _with_jax_basis(mj)
    pj = jax_parametrics_exact(mj, theta_end, **kw)
    pt = analysis.parametrics_exact(mt, theta_end, device="cpu", **kw)
    assert pt.status == pj.status
    assert pt.pivots == pj.pivots
    assert len(pt.thetas) == len(pj.thetas) > 1
    assert_close_with_infinities(pt.thetas, pj.thetas, "thetas")
    assert_close_with_infinities(pt.objectives, pj.objectives, "objectives")
    assert abs(pt.theta_reached - pj.theta_reached) <= TOL * (1 + abs(pj.theta_reached))
    sj, st = pj.solution, pt.solution
    assert st.status == ProblemStatus(int(sj.status))
    np.testing.assert_array_equal(st.column_status, sj.column_status)
    np.testing.assert_array_equal(st.row_status, sj.row_status)
    np.testing.assert_allclose(st.primal, sj.primal, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(st.duals, sj.duals, rtol=TOL, atol=TOL)
    # the model's own solution is left at theta = 0
    np.testing.assert_array_equal(mt.solution.column_status, mj.solution.column_status)


def test_parametrics_hits_the_primal_wall_like_jax():
    """A right-hand side pushed until the LP turns infeasible: both walks
    stop at the same theta with PRIMAL_INFEASIBLE."""
    mj = _jax_solve(jgen.random_lp(10, 14, seed=6))
    d = np.zeros(10)
    eq = np.flatnonzero(mj.row_lower == mj.row_upper)
    d[eq[0] if eq.size else 0] = 10.0
    kw = dict(d_row_lower=d, d_row_upper=d)
    pj = jax_parametrics_exact(mj, 1e4, **kw)
    pt = analysis.parametrics_exact(_with_jax_basis(mj), 1e4, device="cpu", **kw)
    assert pj.status == pt.status
    assert pj.status != clp_tpu.ProblemStatus.OPTIMAL
    assert len(pt.thetas) == len(pj.thetas)
    assert_close_with_infinities(pt.thetas, pj.thetas, "thetas")
    assert_close_with_infinities(pt.objectives, pj.objectives, "objectives")


def test_parametrics_solves_first_when_unsolved():
    mj = jgen.random_lp(8, 12, seed=9)
    dc = np.random.default_rng(1).standard_normal(12)
    pj = jax_parametrics_exact(mj, 2.0, dc=dc)
    mt = port_model(jgen.random_lp(8, 12, seed=9))
    mt.solution = None
    pt = analysis.parametrics_exact(mt, 2.0, dc=dc, device="cpu")
    assert len(pt.thetas) == len(pj.thetas)
    assert_close_with_infinities(pt.objectives, pj.objectives, "objectives")


@pytest.mark.parametrize("kind", ["cost", "rhs"])
def test_bisection_fallback_matches_jax(kind):
    mj = _jax_solve(jgen.random_lp(9, 13, seed=5))
    kw = _directions(mj, kind, seed=3)
    pj = jax_bisect(mj, 2.0, max_points=16, **kw)
    pt = analysis._parametrics_bisect(_with_jax_basis(mj), 2.0, max_points=16,
                                      device="cpu", **kw)
    assert len(pt) == len(pj)
    for (tt, ot), (tj, oj) in zip(pt, pj):
        assert tt == tj
        assert abs(ot - oj) <= TOL * (1 + abs(oj))


def test_parametrics_falls_back_on_a_singular_basis_only(monkeypatch):
    mj = _jax_solve(jgen.random_lp(8, 12, seed=2))
    mt = _with_jax_basis(mj)
    dc = np.random.default_rng(0).standard_normal(12)
    calls = []

    def singular(*a, **k):
        raise torch.linalg.LinAlgError("singular basis")

    def bisect(*a, **k):
        calls.append(k.get("device"))
        return [(0.0, 1.0)]

    monkeypatch.setattr(analysis, "parametrics_exact", singular)
    monkeypatch.setattr(analysis, "_parametrics_bisect", bisect)
    assert analysis.parametrics(mt, 1.0, dc=dc, device="cpu") == [(0.0, 1.0)]
    assert calls == ["cpu"]

    def device_error(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(analysis, "parametrics_exact", device_error)
    with pytest.raises(RuntimeError, match="CUDA error"):
        analysis.parametrics(mt, 1.0, dc=dc, device="cpu")


def test_parametrics_points_match_jax():
    mj = _jax_solve(jgen.staircase_lp(4, 10, 16, seed=3))
    dc = np.random.default_rng(4).standard_normal(mj.num_cols)
    pj = clp_tpu.parametrics(mj, 3.0, dc=dc, max_points=8)
    pt = clp_tpu_torch.parametrics(_with_jax_basis(mj), 3.0, dc=dc, max_points=8,
                                   device="cpu")
    assert len(pt) == len(pj) <= 8
    for (tt, ot), (tj, oj) in zip(pt, pj):
        assert abs(tt - tj) <= TOL * (1 + abs(tj))
        assert abs(ot - oj) <= TOL * (1 + abs(oj))
