"""Port parity for the solver half of gub.py (a numpy copy): the GUB form,
the key-variable simplex and `solve_gub` give the JAX package's statuses,
pivot counts, objectives and rays on the same LPs; the basis export and
import round-trips; and the GUB route through `initial_solve` (AUTOMATIC,
explicit, and the dense fall-back) gives the JAX package's answer."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clp_tpu
from clp_tpu.constants import INF
from clp_tpu.gub import (
    build_gub_form as jax_build_gub_form,
    detect_gub as jax_detect_gub,
    gub_crash_status as jax_gub_crash_status,
    solve_gub as jax_solve_gub,
)
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch import gub
from tests.test_gub import make_gub_lp
from tests.test_torch_auto import _port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _unbounded():
    """A pure-sets LP plus a free column of cost -1 in no row."""
    mj = make_gub_lp(K=5, per=4, mg=0, seed=1)
    A = sp.hstack([mj.matrix, sp.csc_matrix((mj.num_rows, 1))]).tocsc()
    m2 = clp_tpu.Model()
    m2.load_problem(A, np.concatenate([mj.col_lower, [-INF]]),
                    np.concatenate([mj.col_upper, [INF]]),
                    np.concatenate([mj.objective, [-1.0]]), mj.row_lower, mj.row_upper)
    return m2


def _infeasible():
    mj = make_gub_lp(K=6, per=3, mg=2, seed=5)
    mj.row_lower[-1] = mj.row_upper[-1] = 3 * 2.0 + 1.0  # > per * up
    return mj


CASES = {
    "ranged-onesided": lambda: make_gub_lp(K=10, per=5, mg=4, seed=0, onesided=0.2),
    "phase1": lambda: make_gub_lp(K=10, per=5, mg=4, seed=1, lo_shift=0.05),
    "maximize": lambda: make_gub_lp(K=10, per=5, mg=4, seed=2, sense=-1.0, onesided=0.2),
    "pure-sets": lambda: make_gub_lp(K=12, per=5, mg=0, seed=3),
    "unbounded": _unbounded,
    "infeasible": _infeasible,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_gub_matches_jax(name):
    """The same numpy arithmetic: identical status, pivots, x, duals and ray."""
    mj = CASES[name]()
    mt = _port_model(mj)
    sj, st = jax_solve_gub(mj), gub.solve_gub(mt)
    assert int(st.status) == int(sj.status) and st.iterations == sj.iterations
    assert st.objective_value == sj.objective_value
    if sj.primal is not None:
        np.testing.assert_array_equal(st.primal, sj.primal)
        np.testing.assert_array_equal(st.duals, sj.duals)
        np.testing.assert_array_equal(st.column_status, sj.column_status)
        np.testing.assert_array_equal(st.row_status, sj.row_status)
    assert (st.unbounded_ray is None) == (sj.unbounded_ray is None)
    if sj.unbounded_ray is not None:
        np.testing.assert_array_equal(st.unbounded_ray, sj.unbounded_ray)
        assert mt.objective @ st.unbounded_ray < 0


def test_gub_form_and_crash_match_jax():
    mj = make_gub_lp(K=15, per=4, mg=5, seed=9)
    mt = _port_model(mj)
    fj = jax_build_gub_form(mj, jax_detect_gub(mj))
    ft = gub.build_gub_form(mt, gub.detect_gub(mt))
    for f in dataclasses.fields(fj):
        np.testing.assert_array_equal(getattr(ft, f.name), getattr(fj, f.name))
    for a, b in zip(gub.gub_crash_status(mt, gub.detect_gub(mt)),
                    jax_gub_crash_status(mj, jax_detect_gub(mj))):
        np.testing.assert_array_equal(a, b)


def test_gub_statuses_round_trip():
    """Exported statuses import back into the same implicit basis, which
    warm-starts the solver to optimality in zero pivots."""
    mt = _port_model(make_gub_lp(K=15, per=4, mg=5, seed=9))
    form = gub.build_gub_form(mt, gub.detect_gub(mt))
    sol = gub.solve_gub(mt)
    st = gub.gub_state_from_statuses(form, sol.column_status, sol.row_status)
    assert st is not None
    cstat, rstat = gub.gub_statuses(form, st)
    np.testing.assert_array_equal(cstat, sol.column_status)
    np.testing.assert_array_equal(rstat, sol.row_status)
    again = gub.solve_gub(_port_model(make_gub_lp(K=15, per=4, mg=5, seed=9)), warm=sol)
    assert again.status == clp_tpu_torch.ProblemStatus.OPTIMAL and again.iterations == 0
    assert abs(again.objective_value - sol.objective_value) <= 1e-9 * abs(sol.objective_value)


def test_solve_gub_without_sets_raises():
    with pytest.raises(ValueError, match="GUB"):
        gub.solve_gub(_port_model(jgen.random_lp(6, 9, seed=2)))


@pytest.mark.parametrize("method, make", [
    ("AUTOMATIC", lambda: make_gub_lp(K=100, per=8, mg=20, seed=7)),
    ("GUB", _infeasible),
    ("GUB", lambda: jgen.random_lp(20, 30, seed=5, density=0.3)),
], ids=["auto", "explicit-infeasible", "no-sets-dense-fallback"])
def test_gub_route_matches_jax(method, make):
    """AUTOMATIC lands on GUB as in the JAX package; an LP without GUB rows
    falls back to the dense dual."""
    mj = make()
    mt = _port_model(mj)
    sj = clp_tpu.initial_solve(mj, clp_tpu.SolveOptions(method=clp_tpu.SolveMethod[method]))
    st = clp_tpu_torch.initial_solve(mt, clp_tpu_torch.SolveOptions(
        method=clp_tpu_torch.SolveMethod[method], device="cpu"))
    assert int(st.status) == int(sj.status)
    if sj.status == clp_tpu.ProblemStatus.OPTIMAL:
        assert abs(st.objective_value - sj.objective_value) <= 1e-9 * (
            1 + abs(sj.objective_value))
