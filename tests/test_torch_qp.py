"""Port parity of the solve-level QP: the reduced-gradient QP simplex
(simplex/qp.py) from a shared mid-solve state and whole, and the QP routes
of `initial_solve` (the barrier with diagonal-Q detection and the f64
retry, the QP simplex, the box QP of an empty model, presolve, maximize),
clp_tpu_torch against clp_tpu on the CPU."""

import dataclasses

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clp_tpu
from clp_tpu.forms import to_standard_form as jax_standard_form
from clp_tpu.simplex import engine as je
from clp_tpu.simplex import qp as jqp
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch import convert
from clp_tpu_torch.constants import INF, ProblemStatus, SolveMethod
from clp_tpu_torch.simplex import engine as te
from clp_tpu_torch.simplex import qp as tqp
from tests.test_qp import _random_qp
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _fields(x) -> dict:
    return {k: (None if v is None else np.asarray(v)) for k, v in vars(x).items()}


def port_model(mj) -> clp_tpu_torch.Model:
    """The JAX package's model, Q included, as a port Model."""
    mt = clp_tpu_torch.Model()
    mt.load_problem(mj.matrix, mj.col_lower, mj.col_upper, mj.objective,
                    mj.row_lower, mj.row_upper)
    mt.optimization_direction = mj.optimization_direction
    mt.objective_offset = mj.objective_offset
    if mj.quadratic_objective is not None:
        mt.quadratic_objective = sp.csc_matrix(mj.quadratic_objective)
    return mt


def _semidefinite():
    """tests/test_qp.py's rank-1 Q case."""
    n = 4
    q = np.array([1.0, -1.0, 0.5, 0.0])
    m = clp_tpu.Model()
    m.load_problem(sp.csc_matrix(np.ones((1, n))), col_lower=np.zeros(n),
                   col_upper=np.full(n, 2.0), objective=[-1.0, -0.5, 0.25, -0.1],
                   row_lower=[-INF], row_upper=[4.0])
    m.quadratic_objective = sp.csc_matrix(np.outer(q, q) + 1e-10 * np.eye(n))
    return m


def _simple_qp(lib):
    """tests/test_qp.py::test_simple_qp's model: optimum (0.5, 0.5), -0.75."""
    m = lib.Model()
    m.load_problem(sp.csc_matrix(np.array([[1.0, 1.0]])), col_lower=[0, 0],
                   col_upper=[INF, INF], objective=[-1.0, -1.0], row_lower=[-INF],
                   row_upper=[1.0])
    m.load_quadratic_objective(sp.eye(2, format="csc"))
    return m


QP_CASES = {f"random{s}": (lambda s=s: _random_qp(s)) for s in range(5)}
QP_CASES["semidefinite"] = _semidefinite


def _jax_phase1(mj):
    """The JAX QP simplex's set-up: its standard form, options and the
    QPState after the zero-cost dual phase 1 (clp_tpu/simplex/qp.py:452-497)."""
    lp, _ = jax_standard_form(mj)
    m, nt = lp.G.shape
    opts = je.SimplexOptions(
        primal_tolerance=mj.primal_tolerance, dual_tolerance=mj.dual_tolerance,
        refactor_frequency=100, max_iterations=int(50 * nt + 10000))
    lp0 = dataclasses.replace(lp, c=jax.numpy.zeros_like(lp.c), Q=None)
    st0 = je.initial_state(lp0, opts)
    st0 = je.recompute(lp0, st0, opts.dual_bound)
    st0 = je.make_dual_feasible(lp0, st0, opts)
    st0 = je.dual_solve(lp0, st0, opts)
    assert int(st0.status) == je.OPTIMAL
    xn = je.nonbasic_values(lp0, st0.vstat, opts.dual_bound)
    qs = jqp.QPState(basis=st0.basis, vstat=st0.vstat, binv=st0.binv,
                     x=jax.numpy.asarray(xn).at[st0.basis].set(st0.xb),
                     iterations=jax.numpy.asarray(0, jax.numpy.int32),
                     status=jax.numpy.asarray(je.CONTINUE, jax.numpy.int32),
                     refactor_now=jax.numpy.asarray(False))
    return lp, opts, qs


def _carry(lp, opts, qs):
    """The JAX form, options and state as the port's."""
    topts = te.SimplexOptions(**{f.name: getattr(opts, f.name)
                                 for f in dataclasses.fields(te.SimplexOptions)})
    return (convert.standard_lp_from_numpy(_fields(lp), "cpu"), topts,
            convert.qp_state_from_numpy(_fields(qs), "cpu"))


def _assert_states_close(a: dict, b: dict, tol: float):
    for k in ("basis", "vstat", "iterations", "status", "refactor_now"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("x", "binv"):
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("step", ["iteration", "sweep"])
@pytest.mark.parametrize("walk", [0, 2, 5])
def test_one_qp_step_from_shared_state(step, walk):
    """One `qp_iteration` or `qp_sweep_iteration` from a state the JAX
    package walked `walk` iterations into the solve: the same iterate at
    1e-12."""
    lp, opts, qs = _jax_phase1(_random_qp(1))
    qs = jqp.qp_recompute(lp, qs)
    for _ in range(walk):
        qs = jqp.qp_sweep_iteration(lp, jqp.qp_iteration(lp, qs, opts), opts)
    assert int(qs.status) == je.CONTINUE
    tlp, topts, tqs = _carry(lp, opts, qs)
    jfn = {"iteration": jqp.qp_iteration, "sweep": jqp.qp_sweep_iteration}[step]
    tfn = {"iteration": tqp.qp_iteration, "sweep": tqp.qp_sweep_iteration}[step]
    want = jfn(lp, qs, opts)
    got = convert.qp_state_to_numpy(tfn(tlp, tqs, topts))
    _assert_states_close(got, _fields(want), 1e-12)
    assert int(got["iterations"]) == int(want.iterations)


def test_qp_recompute_from_shared_state():
    lp, opts, qs = _jax_phase1(_random_qp(3))
    for _ in range(3):
        qs = jqp.qp_sweep_iteration(lp, jqp.qp_iteration(lp, qs, opts), opts)
    tlp, _, tqs = _carry(lp, opts, qs)
    _assert_states_close(convert.qp_state_to_numpy(tqp.qp_recompute(tlp, tqs)),
                         _fields(jqp.qp_recompute(lp, qs)), 1e-12)


@pytest.mark.parametrize("block", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(QP_CASES))
def test_qp_solve_matches_jax(case, block, monkeypatch):
    """The whole QP loop from the shared phase-1 state: the same status,
    iteration count and objective (1e-9 relative), for any length of the
    gated blocks."""
    monkeypatch.setattr(tqp, "QP_BLOCK", block)
    mj = QP_CASES[case]()
    lp, opts, qs = _jax_phase1(mj)
    tlp, topts, tqs = _carry(lp, opts, qs)
    want = jqp.qp_solve(lp, qs, opts)
    got = tqp.qp_solve(tlp, tqs, topts)
    assert int(got.status) == int(want.status) == je.OPTIMAL
    assert int(got.iterations) == int(want.iterations)

    def obj(x, c, Q):
        return float(c @ x + 0.5 * x @ (Q @ x))

    oj = obj(np.asarray(want.x), np.asarray(lp.c), np.asarray(lp.Q))
    ot = obj(got.x.numpy(), tlp.c.numpy(), tlp.Q.numpy())
    assert abs(ot - oj) <= 1e-9 * (1 + abs(oj))


@pytest.mark.parametrize("case", sorted(QP_CASES))
def test_qp_simplex_solve_matches_jax(case):
    """`qp_simplex_solve` end to end: phase-1 pivots plus QP iterations,
    status, objective and primal as the JAX package's."""
    mj = QP_CASES[case]()
    want = jqp.qp_simplex_solve(mj.copy(), clp_tpu.SolveOptions())
    got = tqp.qp_simplex_solve(port_model(mj), clp_tpu_torch.SolveOptions(device="cpu"))
    assert int(got.status) == int(want.status) == int(ProblemStatus.OPTIMAL)
    assert got.iterations == want.iterations
    assert abs(got.objective_value - want.objective_value) <= 1e-9 * (
        1 + abs(want.objective_value))
    np.testing.assert_allclose(got.primal, want.primal, atol=1e-9)
    np.testing.assert_array_equal(got.column_status, want.column_status)
    assert got.timings["qp_stats"]["qp_iterations"] + \
        got.timings["qp_stats"]["phase1_iterations"] == got.iterations


@pytest.mark.parametrize("method", ["BARRIER_NO_CROSS", "AUTOMATIC", "PRIMAL_SIMPLEX",
                                    "DUAL_SIMPLEX"])
@pytest.mark.parametrize("seed, scaling", [(0, "AUTO"), (2, "AUTO"), (2, "OFF")])
def test_initial_solve_qp_matches_jax(method, seed, scaling):
    """A QP through `initial_solve` on each method the JAX package accepts
    it on, scaled (Q scaled with the columns) and not: the same status,
    objective (1e-9 relative), duals and reduced costs (whose Qx term
    postsolve reads), and a KKT point."""
    mj = _random_qp(seed)
    oj = clp_tpu.SolveOptions(method=clp_tpu.SolveMethod[method],
                              scaling=clp_tpu.ScalingMode[scaling])
    want = mj.copy().initial_solve(oj)
    mt = port_model(mj)
    got = clp_tpu_torch.initial_solve(mt, clp_tpu_torch.SolveOptions(
        method=SolveMethod[method], scaling=clp_tpu_torch.ScalingMode[scaling], device="cpu"))
    assert int(got.status) == int(want.status) == int(ProblemStatus.OPTIMAL)
    assert abs(got.objective_value - want.objective_value) <= 1e-9 * (
        1 + abs(want.objective_value))
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.duals, want.duals, rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(got.reduced_costs, want.reduced_costs, rtol=1e-7, atol=1e-7)
    rep = clp_tpu_torch.check_kkt(mt, x=got.primal, y=got.duals, tol=1e-6)
    assert rep.ok, str(rep)


def test_qp_simplex_and_barrier_agree():
    """The reference's own simplex-QP against barrier-QP check
    (unitTest.cpp:2530-2690) in the port: within 1e-7 across methods."""
    mt = port_model(_random_qp(4))
    s = clp_tpu_torch.initial_solve(mt.copy(), clp_tpu_torch.SolveOptions(
        method=SolveMethod.PRIMAL_SIMPLEX, device="cpu"))
    b = clp_tpu_torch.initial_solve(mt.copy(), clp_tpu_torch.SolveOptions(
        method=SolveMethod.BARRIER_NO_CROSS, device="cpu"))
    assert s.status == b.status == ProblemStatus.OPTIMAL
    assert abs(s.objective_value - b.objective_value) <= 1e-7 * (1 + abs(b.objective_value))


@pytest.mark.parametrize("method", ["PRIMAL_SIMPLEX", "BARRIER_NO_CROSS"])
def test_qp_maximize_with_presolve_matches_jax(method):
    """tests/test_qp.py's maximize case, presolve on (its Q-aware
    transforms), through both packages."""
    mj = _random_qp(7)
    mj.set_maximize()
    mj.quadratic_objective = -mj.quadratic_objective  # convex in min form
    want = mj.copy().initial_solve(clp_tpu.SolveOptions(method=clp_tpu.SolveMethod[method]))
    got = clp_tpu_torch.initial_solve(port_model(mj), clp_tpu_torch.SolveOptions(
        method=SolveMethod[method], device="cpu"))
    assert int(got.status) == int(want.status) == int(ProblemStatus.OPTIMAL)
    assert abs(got.objective_value - want.objective_value) <= 1e-9 * (
        1 + abs(want.objective_value))


def test_box_qp_of_an_empty_model_matches_jax():
    """No rows: `_empty_solution`'s projected-gradient box QP."""
    rng = np.random.default_rng(5)
    n = 6
    L = rng.standard_normal((n, n))
    mj = clp_tpu.Model()
    mj.load_problem(sp.csc_matrix((0, n)), np.full(n, -1.0), np.full(n, 1.0),
                    rng.standard_normal(n) * 3, np.zeros(0), np.zeros(0))
    mj.quadratic_objective = sp.csc_matrix(L @ L.T + np.eye(n))
    want = mj.copy().initial_solve(clp_tpu.SolveOptions())
    got = clp_tpu_torch.initial_solve(port_model(mj), clp_tpu_torch.SolveOptions(device="cpu"))
    assert int(got.status) == int(want.status) == int(ProblemStatus.OPTIMAL)
    np.testing.assert_array_equal(got.primal, want.primal)
    np.testing.assert_array_equal(got.reduced_costs, want.reduced_costs)
    assert got.objective_value == want.objective_value


def _diagonal_qp(nblocks=16):
    """tests/test_scale.py's separable QP recipe: a staircase LP with
    Q = diag(uniform(0.1, 2.0)), cut to `nblocks` blocks."""
    m = jgen.staircase_lp(nblocks=nblocks, bm=24, bn=36, seed=4)
    rng = np.random.default_rng(0)
    m.load_quadratic_objective(sp.diags(rng.uniform(0.1, 2.0, m.num_cols)).tocsc())
    return m


def test_diagonal_q_takes_q_diag_in_both(monkeypatch):
    """A diagonal Q sets q_diag in both packages (and with 192+ rows the
    banded plan); the same objective within 1e-9."""
    import clp_tpu.interior.mehrotra as jm

    seen = []
    orig = jm.ipm_solve_jit

    def spy(lp, opts):
        seen.append(opts)
        return orig(lp, opts)

    monkeypatch.setattr(jm, "ipm_solve_jit", spy)
    mj = _diagonal_qp()
    o = clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.BARRIER_NO_CROSS)
    o.presolve.enabled = False
    want = mj.copy().initial_solve(o)
    assert len(seen) == 1 and seen[0].q_diag and seen[0].band_nb > 0
    ot = clp_tpu_torch.SolveOptions(method=SolveMethod.BARRIER_NO_CROSS, device="cpu")
    ot.presolve.enabled = False
    got = clp_tpu_torch.initial_solve(port_model(mj), ot)
    stats = got.timings["barrier_stats"]
    assert stats["branch"] == f"banded nb={seen[0].band_nb} q_diag"
    assert stats["iterations"] == int(want.iterations)
    assert int(got.status) == int(want.status) == int(ProblemStatus.OPTIMAL)
    assert abs(got.objective_value - want.objective_value) <= 1e-9 * (
        1 + abs(want.objective_value))
    np.testing.assert_allclose(got.duals, want.duals, rtol=1e-7, atol=1e-7)


def test_separable_qp_with_presolve_is_a_kkt_point_as_in_jax():
    """AUTOMATIC with presolve on the separable staircase QP: postsolve
    rebuilds row duals from reduced costs that carry Qx; both packages
    reach a KKT point with the same duals."""
    mj = _diagonal_qp()
    want = mj.copy().initial_solve(clp_tpu.SolveOptions())
    mt = port_model(mj)
    got = clp_tpu_torch.initial_solve(mt, clp_tpu_torch.SolveOptions(device="cpu"))
    assert int(got.status) == int(want.status) == int(ProblemStatus.OPTIMAL)
    np.testing.assert_allclose(got.duals, want.duals, rtol=1e-7, atol=1e-7)
    assert clp_tpu_torch.check_kkt(mt, x=got.primal, y=got.duals, tol=1e-6).ok


def test_dense_q_barrier_branch_name():
    got = clp_tpu_torch.initial_solve(port_model(_random_qp(0)), clp_tpu_torch.SolveOptions(
        method=SolveMethod.BARRIER_NO_CROSS, device="cpu"))
    assert got.timings["barrier_stats"]["branch"] == "dense QP (nt, nt)"
    assert got.timings["barrier_stats"]["f64_retry"] is None


def test_f64_retry_of_an_unconverged_mixed32_ipm(monkeypatch):
    """barrier_mixed32="auto" on the accelerator branch with a mixed32 IPM
    that does not converge: both packages retry once in f64 without the
    device multifrontal, and adopt the converged retry."""
    import clp_tpu.interior.mehrotra as jm
    import clp_tpu_torch.interior.mehrotra as tm
    import clp_tpu_torch.solve as tsolve

    def stalling(orig, seen):
        def ipm(lp, opts):
            seen.append(opts)
            res = orig(lp, opts)
            if opts.mixed32:  # a mixed32 IPM that stalls
                res = dataclasses.replace(res, converged=res.converged & False)
            return res
        return ipm

    jseen, tseen = [], []
    monkeypatch.setattr(jm, "ipm_solve_jit", stalling(jm.ipm_solve_jit, jseen))
    monkeypatch.setattr(tm, "ipm_solve", stalling(tm.ipm_solve, tseen))
    # the accelerator branch of "auto": the JAX package's TPU test, the
    # port's card test
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(tsolve, "_mixed32_auto", lambda device: True)
    mj = _diagonal_qp(nblocks=4)
    o = clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.BARRIER_NO_CROSS)
    o.presolve.enabled = False
    want = mj.copy().initial_solve(o)
    ot = clp_tpu_torch.SolveOptions(method=SolveMethod.BARRIER_NO_CROSS, device="cpu")
    ot.presolve.enabled = False
    got = clp_tpu_torch.initial_solve(port_model(mj), ot)
    for seen in (jseen, tseen):
        assert [o.mixed32 for o in seen] == [True, False]
        assert seen[1].sparse_chol_device is None and seen[1].q_diag
    assert got.timings["barrier_stats"]["f64_retry"] == "converged"
    assert int(got.status) == int(want.status) == int(ProblemStatus.OPTIMAL)
    assert abs(got.objective_value - want.objective_value) <= 1e-9 * (
        1 + abs(want.objective_value))


def test_qp_crossover_lands_on_the_lp_vertex_as_in_jax():
    """The reference's fault, copied: BARRIER with crossover runs the LP
    dual simplex, which ignores Q, and ends on the LP vertex (-0.5), where
    BARRIER_NO_CROSS finds the QP optimum (-0.75). Both packages agree on
    both (ROADMAP.md queue 3)."""
    for method, obj in (("BARRIER", -0.5), ("BARRIER_NO_CROSS", -0.75)):
        want = _simple_qp(clp_tpu).initial_solve(
            clp_tpu.SolveOptions(method=clp_tpu.SolveMethod[method], crossover=True))
        got = clp_tpu_torch.initial_solve(_simple_qp(clp_tpu_torch), clp_tpu_torch.SolveOptions(
            method=SolveMethod[method], crossover=True, device="cpu"))
        assert int(got.status) == int(want.status) == int(ProblemStatus.OPTIMAL)
        assert abs(want.objective_value - obj) < 1e-6
        assert abs(got.objective_value - want.objective_value) <= 1e-9


def test_engine_chunks_match_jax():
    """`dual_chunk` / `primal_chunk`: one refactorization plus a chunk of
    pivots from the same start, the same state and objective."""
    model = jgen.random_lp(12, 20, seed=5)
    jlp, _ = jax_standard_form(model)
    tlp = convert.standard_lp_from_numpy(_fields(jlp), "cpu")
    for jfn, tfn, dual in ((je.dual_chunk, te.dual_chunk, True),
                           (je.primal_chunk, te.primal_chunk, False)):
        jo = je.SimplexOptions(refactor_frequency=5)
        to = te.SimplexOptions(refactor_frequency=5)
        js = je.initial_state(jlp, jo)
        ts = te.initial_state(tlp, to)
        if dual:
            js = je.make_dual_feasible(jlp, je.recompute(jlp, js, jo.dual_bound), jo)
            ts = te.make_dual_feasible(tlp, te.recompute(tlp, ts, to.dual_bound), to)
        for _ in range(3):
            js, jv, jobj = jfn(jlp, js, jo)
            ts, tv, tobj = tfn(tlp, ts, to)
            assert int(ts.status) == int(js.status) and bool(tv) == bool(jv)
            assert int(ts.iterations) == int(js.iterations)
            np.testing.assert_allclose(float(tobj), float(jobj), rtol=1e-12, atol=1e-12)
