"""End-to-end port parity: `initial_solve` (presolve -> scaling -> simplex ->
postsolve) and `Model.dual()` on every generator family, in the port on the
CPU against the JAX package on the CPU."""

import numpy as np
import pytest
import torch

import clp_tpu
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch.utils import generators as tgen

torch.set_num_threads(2)

FAMILIES = {
    "random": ("random_lp", (12, 20), {"seed": 3}),
    "staircase": ("staircase_lp", (), {}),
    "transport": ("transport_lp", (4, 6), {"seed": 1}),
    "nqueens": ("nqueens_lp", (4,), {}),
    "infeasible": ("infeasible_lp", (), {}),
    "unbounded": ("unbounded_lp", (), {}),
}


def _models(family):
    name, args, kw = FAMILIES[family]
    return getattr(jgen, name)(*args, **kw), getattr(tgen, name)(*args, **kw)


def _assert_same_solution(sj, st):
    assert st.status.name == sj.status.name
    if sj.status.name != "OPTIMAL":
        return
    oj = sj.objective_value
    assert abs(st.objective_value - oj) <= 1e-9 * (1 + abs(oj))
    for f in ("primal", "duals", "reduced_costs"):
        a, b = getattr(st, f), getattr(sj, f)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7, err_msg=f)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_initial_solve_dual_simplex_parity(family):
    mj, mt = _models(family)
    sj = clp_tpu.initial_solve(mj, clp_tpu.SolveOptions(
        method=clp_tpu.SolveMethod.DUAL_SIMPLEX))
    st = clp_tpu_torch.initial_solve(mt, clp_tpu_torch.SolveOptions(
        method=clp_tpu_torch.SolveMethod.DUAL_SIMPLEX, device="cpu"))
    assert mt.solution is st
    _assert_same_solution(sj, st)
    if st.status.name == "OPTIMAL":
        rep = clp_tpu_torch.check_kkt(mt, x=st.primal, y=st.duals, tol=1e-6)
        assert rep.ok, rep


@pytest.mark.parametrize("family", ["random", "transport", "infeasible"])
def test_model_dual_parity(family):
    mj, mt = _models(family)
    _assert_same_solution(mj.dual(), mt.dual(device="cpu"))


def test_primal_simplex_parity():
    mj, mt = _models("staircase")
    _assert_same_solution(mj.primal(), mt.primal(device="cpu"))


def test_presolve_off_certificates_parity():
    """With presolve off the simplex itself must prove infeasibility and
    unboundedness, and the port's exact certificate checks accept it."""
    for family in ("infeasible", "unbounded"):
        mj, mt = _models(family)
        sj = clp_tpu.initial_solve(mj, clp_tpu.SolveOptions(
            method=clp_tpu.SolveMethod.DUAL_SIMPLEX,
            presolve=clp_tpu.PresolveOptions(enabled=False)))
        st = clp_tpu_torch.initial_solve(mt, clp_tpu_torch.SolveOptions(
            method=clp_tpu_torch.SolveMethod.DUAL_SIMPLEX, device="cpu",
            presolve=clp_tpu_torch.PresolveOptions(enabled=False)))
        assert st.status.name == sj.status.name, family
        assert st.status.name in ("PRIMAL_INFEASIBLE", "DUAL_INFEASIBLE"), family
