"""Port parity of `analysis.find_iis`: the Farkas-ray seed and the deletion
filter, its trials as one batched dual simplex or one at a time
(clp_tpu_torch vs clp_tpu, CPU)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clp_tpu
from clp_tpu.analysis import find_iis as jax_find_iis
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch.analysis import find_iis
from clp_tpu_torch.constants import INF, ProblemStatus, SolveMethod
from tests.test_torch_qp import port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _opts():
    return clp_tpu_torch.SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device="cpu")


def _known_conflict():
    """tests/test_analysis.py::test_find_iis_known_conflict's model."""
    A = sp.csc_matrix(np.array([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                                [0.0, 0.0, 1.0], [1.0, 0.0, 1.0]]))
    m = clp_tpu.Model()
    m.load_problem(A, col_lower=[0, 0, 0], col_upper=[clp_tpu.INF] * 3, objective=[1.0] * 3,
                   row_lower=[4.0, -clp_tpu.INF, -clp_tpu.INF, -clp_tpu.INF, -clp_tpu.INF],
                   row_upper=[clp_tpu.INF, 1.0, 1.0, 10.0, 20.0])
    return m


def _with_conflict(m, n, seed=0):
    """random_lp(m, n) with the three conflicting rows over columns 0 and 1
    appended (x0 + x1 >= 4, x0 <= 1, x1 <= 1)."""
    model = jgen.random_lp(m, n, seed=seed)
    rows = np.zeros((3, n))
    rows[0, :2] = 1.0
    rows[1, 0] = 1.0
    rows[2, 1] = 1.0
    model.add_rows(sp.csc_matrix(rows), lower=[4.0, -clp_tpu.INF, -clp_tpu.INF],
                   upper=[clp_tpu.INF, 1.0, 1.0])
    return model


@pytest.mark.parametrize("batch", [True, False], ids=["batched", "one-by-one"])
@pytest.mark.parametrize("make", [_known_conflict, lambda: _with_conflict(40, 70),
                                  jgen.infeasible_lp],
                         ids=["known", "random+conflict", "infeasible_lp"])
def test_find_iis_matches_jax(make, batch):
    jm = make()
    ref = jax_find_iis(jm, batch=batch)
    got = find_iis(port_model(jm), _opts(), batch=batch)
    assert got == ref
    if make is _known_conflict:
        assert got == [0, 1, 2]


def test_iis_is_irreducible():
    """tests/test_analysis.py::test_find_iis_irreducible_property: every
    returned row is necessary, freeing any one restores feasibility."""
    m = port_model(_with_conflict(40, 70))
    iis = find_iis(m, _opts())
    assert iis == [40, 41, 42]
    opts = _opts()
    opts.presolve.enabled = False
    for r in iis:
        t = m.copy()
        t.row_lower, t.row_upper = t.row_lower.copy(), t.row_upper.copy()
        t.row_lower[r], t.row_upper[r] = -INF, INF
        assert t.initial_solve(opts).status != ProblemStatus.PRIMAL_INFEASIBLE


def test_feasible_model_raises_and_options_stay():
    opts = _opts()
    with pytest.raises(ValueError, match="not primal infeasible"):
        find_iis(port_model(jgen.random_lp(10, 16, seed=1)), opts)
    assert opts.presolve.enabled  # the caller's options are not changed
