"""Port parity of the branch-and-bound hooks: hot start, crunch, strong
branching, `fathom` and the OSI adapter with its tableau accessors
(clp_tpu_torch vs clp_tpu, CPU)."""

import numpy as np
import pytest
import scipy.sparse as sp

import clp_tpu
from clp_tpu.branching import crunch_solve as jax_crunch
from clp_tpu.branching import mark_hot_start as jax_mark
from clp_tpu.branching import solve_from_hot_start as jax_hot
from clp_tpu.branching import strong_branch as jax_strong
from clp_tpu.mip import fathom as jax_fathom
from clp_tpu.osi import OsiClpTpuSolverInterface as JaxOsi
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch.branching import (
    crunch_solve,
    mark_hot_start,
    solve_from_hot_start,
    strong_branch,
)
from clp_tpu_torch.constants import ProblemStatus, SolveMethod
from clp_tpu_torch.mip import fathom
from clp_tpu_torch.osi import OsiClpTpuSolverInterface
from tests.test_torch_qp import port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _dual_opts(pkg):
    if pkg is clp_tpu:
        o = clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.DUAL_SIMPLEX)
    else:
        o = clp_tpu_torch.SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device="cpu")
    o.presolve.enabled = False
    return o


def _pair(mj):
    mt = port_model(mj)
    if mj.integer_mask is not None:
        mt.integer_mask = mj.integer_mask.copy()
    mj.initial_solve(_dual_opts(clp_tpu))
    mt.initial_solve(_dual_opts(clp_tpu_torch))
    assert mj.solution.status == clp_tpu.ProblemStatus.OPTIMAL
    assert mt.solution.status == ProblemStatus.OPTIMAL
    np.testing.assert_array_equal(mt.solution.column_status, mj.solution.column_status)
    return mj, mt


def _close(a, b, tol=1e-9):
    return abs(a - b) <= tol * (1 + abs(b))


def _knapsack(n=14, seed=0):
    """A 0-1 knapsack with two weight rows (multi-dimensional)."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(1, 8, (2, n))
    m = clp_tpu.Model()
    m.load_problem(sp.csc_matrix(w), np.zeros(n), np.ones(n), rng.uniform(1, 10, n),
                   [-clp_tpu.INF] * 2, 0.4 * w.sum(axis=1))
    m.set_maximize()
    for j in range(n):
        m.set_integer(j)
    return m


@pytest.mark.parametrize("col,lo,up", [(0, None, 0.0), (3, 1.5, None), (7, None, 0.2)])
def test_hot_start_matches_jax(col, lo, up):
    mj, mt = _pair(jgen.random_lp(14, 22, seed=1))
    hj, ht = jax_mark(mj), mark_hot_start(mt)
    sj = jax_hot(mj, hj, col, new_lower=lo, new_upper=up)
    st = solve_from_hot_start(mt, ht, col, new_lower=lo, new_upper=up, device="cpu")
    assert st.status == ProblemStatus(int(sj.status))
    assert _close(st.objective_value, sj.objective_value)
    assert st.iterations == sj.iterations
    assert mt.col_upper[col] == mj.col_upper[col]  # bounds restored


def test_hot_start_needs_a_basis():
    mt = port_model(jgen.random_lp(4, 6, seed=0))
    with pytest.raises(ValueError):
        mark_hot_start(mt)


def test_crunch_matches_jax():
    mj, mt = _pair(jgen.random_lp(30, 45, seed=9))
    for m in (mj, mt):
        m.col_upper = m.col_upper.copy()
        m.col_upper[0] = max(m.col_lower[0], mj.solution.primal[0] * 0.5)
    sj = jax_crunch(mj, mj.solution)
    st = crunch_solve(mt, mt.solution, options=_dual_opts(clp_tpu_torch))
    assert st.status == ProblemStatus(int(sj.status)) == ProblemStatus.OPTIMAL
    assert _close(st.objective_value, sj.objective_value)
    np.testing.assert_allclose(st.primal, sj.primal, atol=1e-8)
    assert clp_tpu_torch.check_kkt(mt, x=st.primal, y=st.duals).ok


@pytest.mark.parametrize("seed", [0, 3])
def test_strong_branch_matches_jax(seed):
    mj, mt = _pair(_knapsack(seed=seed))
    x = mj.solution.primal
    cols = [j for j in range(mj.num_cols) if 1e-6 < x[j] < 1 - 1e-6] or [0]
    rj = jax_strong(mj, cols)
    rt = strong_branch(mt, cols, device="cpu")
    assert [(r.column, r.direction) for r in rt] == [(r.column, r.direction) for r in rj]
    for a, b in zip(rt, rj):
        assert a.status == ProblemStatus(int(b.status))
        assert _close(a.objective, b.objective)
    # each lane agrees with its single warm solve
    ht = mark_hot_start(mt)
    for r in (rt[0], rt[-1]):
        v = x[r.column]
        kw = dict(new_upper=np.floor(v)) if r.direction == "down" else dict(new_lower=np.ceil(v))
        s = solve_from_hot_start(mt, ht, r.column, device="cpu", **kw)
        assert s.status == r.status
        assert _close(s.objective_value, r.objective, 1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_fathom_matches_jax(seed):
    mj = _knapsack(n=12, seed=seed)
    mt = port_model(mj)
    mt.integer_mask = mj.integer_mask.copy()
    rj = jax_fathom(mj, max_nodes=500)
    rt = fathom(mt, max_nodes=500, options=_dual_opts(clp_tpu_torch))
    assert rt.status == ProblemStatus(int(rj.status)) == ProblemStatus.OPTIMAL
    assert _close(rt.objective_value, rj.objective_value)
    np.testing.assert_allclose(rt.primal, rj.primal, atol=1e-6)
    # the same tree: every node's relaxation ends on the same vertex
    assert rt.nodes == rj.nodes


def test_fathom_infeasible_like_jax():
    mj = clp_tpu.Model()
    mj.load_problem(sp.csc_matrix(np.array([[1.0, 1.0]])), [0, 0], [1, 1], [1.0, 1.0],
                    [0.5], [0.5])
    mj.set_integer(0)
    mj.set_integer(1)
    mt = port_model(mj)
    mt.integer_mask = mj.integer_mask.copy()
    rj = jax_fathom(mj, max_nodes=100)
    rt = fathom(mt, max_nodes=100, options=_dual_opts(clp_tpu_torch))
    assert rt.status == ProblemStatus(int(rj.status)) == ProblemStatus.PRIMAL_INFEASIBLE
    assert rt.nodes == rj.nodes
    with pytest.raises(ValueError):
        fathom(port_model(jgen.random_lp(3, 4, seed=0)), options=_dual_opts(clp_tpu_torch))


def _osi_pair(mj):
    sj = JaxOsi(mj)
    sj.options.presolve.enabled = False
    st = OsiClpTpuSolverInterface(port_model(mj), device="cpu")
    st.options.presolve.enabled = False
    return sj, st


def test_osi_solves_and_hot_starts_like_jax():
    sj, st = _osi_pair(jgen.random_lp(10, 16, seed=31))
    assert st.options.device == "cpu"
    for s in (sj, st):
        s.initialSolve()
    assert st.isProvenOptimal() and _close(st.getObjValue(), sj.getObjValue())
    for s in (sj, st):
        s.markHotStart()
    for j, (lo, up) in enumerate([(0.0, 0.3), (0.5, 10.0), (0.0, 0.0)]):
        for s in (sj, st):
            cl, cu = s.getColLower()[j], s.getColUpper()[j]
            s.setColBounds(j, lo, up)
            s.solveFromHotStart()
            s.setColBounds(j, cl, cu)
        assert st.isProvenOptimal() == sj.isProvenOptimal()
        assert _close(st.getObjValue(), sj.getObjValue())
        np.testing.assert_allclose(st.getColSolution(), sj.getColSolution(), atol=1e-8)
    for s in (sj, st):
        s.unmarkHotStart()
        s.resolve()
    assert _close(st.getObjValue(), sj.getObjValue())
    assert st.getIterationCount() == sj.getIterationCount()


def test_osi_branch_and_bound_like_jax():
    mj = _knapsack(n=10, seed=2)
    sj, st = _osi_pair(mj)
    st.model.integer_mask = mj.integer_mask.copy()
    rj, rt = sj.branchAndBound(), st.branchAndBound()
    assert rt.status == ProblemStatus(int(rj.status))
    assert _close(rt.objective_value, rj.objective_value)
    assert st.isProvenOptimal()


def test_osi_tableau_accessors_match_jax():
    sj, st = _osi_pair(jgen.random_lp(8, 12, seed=31))
    for s in (sj, st):
        s.initialSolve()
        s.enableFactorization()
    m, n = st.getNumRows(), st.getNumCols()
    basics = st.getBasics()
    np.testing.assert_array_equal(basics, sj.getBasics())
    for k in range(m):
        col = st.getBInvACol(int(basics[k]))
        np.testing.assert_allclose(col, np.eye(m)[k], atol=1e-9)
    for i in range(m):
        np.testing.assert_allclose(st.getBInvRow(i), sj.getBInvRow(i), atol=1e-9)
        np.testing.assert_allclose(st.getBInvCol(i), sj.getBInvCol(i), atol=1e-9)
        for a, b in zip(st.getBInvARow(i), sj.getBInvARow(i)):
            np.testing.assert_allclose(a, b, atol=1e-9)
    for j in range(n + m):
        np.testing.assert_allclose(st.getBInvACol(j), sj.getBInvACol(j), atol=1e-9)
    st.disableFactorization()
    with pytest.raises(RuntimeError):
        st.getBInvRow(0)


def test_osi_pivot_like_jax():
    sj, st = _osi_pair(jgen.random_lp(6, 10, seed=32))
    for s in (sj, st):
        s.initialSolve()
        s.enableFactorization()
    m, n = st.getNumRows(), st.getNumCols()
    basics = set(int(b) for b in st.getBasics())
    nonbasic = [j for j in range(n + m) if j not in basics]
    done = 0
    for colIn in nonbasic[:4]:
        colOut = min(int(b) for b in st.getBasics())
        rj, rt = sj.pivot(colIn, colOut, -1), st.pivot(colIn, colOut, -1)
        assert rt == rj
        np.testing.assert_array_equal(st.getBasics(), sj.getBasics())
        np.testing.assert_allclose(st.getColSolution(), sj.getColSolution(), atol=1e-9)
        assert _close(st.getObjValue(), sj.getObjValue())
        done += rt == 0
    assert done
    with pytest.raises(ValueError):
        now = [j for j in range(n + m) if j not in set(int(b) for b in st.getBasics())]
        st.pivot(now[0], now[1], -1)


def test_osi_pivot_refuses_a_singular_basis():
    """Two parallel columns: swapping one for the other's partner in the
    basis makes B singular, and pivot keeps the old basis (-1)."""
    A = sp.csc_matrix(np.array([[1.0, 2.0, 0.0], [1.0, 2.0, 1.0]]))
    mj = clp_tpu.Model()
    mj.load_problem(A, [0, 0, 0], [4, 4, 4], [-1.0, -1.5, -0.5], [-clp_tpu.INF] * 2,
                    [4.0, 5.0])
    sj, st = _osi_pair(mj)
    for s in (sj, st):
        s.initialSolve()
        s.enableFactorization()
    basics = [int(b) for b in st.getBasics()]
    np.testing.assert_array_equal(basics, sj.getBasics())
    if 0 in basics and 1 not in basics:
        out_col = next(b for b in basics if b != 0)
        assert st.pivot(1, out_col, -1) == sj.pivot(1, out_col, -1) == -1
    elif 1 in basics and 0 not in basics:
        out_col = next(b for b in basics if b != 1)
        assert st.pivot(0, out_col, -1) == sj.pivot(0, out_col, -1) == -1
    else:
        pytest.fail(f"basis {basics} holds both or neither parallel column")
