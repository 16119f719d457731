"""Post-optimal analysis: the explicit LP dual.

Port of `dualize` and `restore_from_dual` of the JAX package's
analysis.py (reference: ClpSimplexOther::dualOfModel / restoreFromDual,
ClpSimplexOther.cpp:1681 / :1397), host-side numpy, a copy. AUTOMATIC
solves very tall LPs through their dual (solve.initial_solve). Ranging,
parametrics and the IIS are not ported yet (ROADMAP.md queue 1:
analysis/API/CLI).
"""

from __future__ import annotations

import numpy as np

from .constants import INF, ProblemStatus
from .model import Model, Solution


def dualize(model: Model) -> tuple[Model, dict]:
    """Build the explicit LP dual (ClpSimplexOther::dualize, :1681).

    Primal: min c'x s.t. bL <= Ax <= bU, l <= x <= u (minimization form).
    Dual variables: lamL_i >= 0 (rows with finite bL), lamU_i >= 0 (finite
    bU), muL_j >= 0 (finite l), muU_j >= 0 (finite u), with
        A'(lamL - lamU) + muL - muU = c
        max bL'lamL - bU'lamU + l'muL - u'muU
    Returned as a *minimization* model (negated objective). The mapping dict
    lists the column index of each dual variable so `restore_from_dual` can
    rebuild the primal solution.
    """
    import scipy.sparse as sp

    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0
    A = model.matrix
    m, n = A.shape
    c = model.objective * sense
    bL, bU = model.row_lower, model.row_upper
    l, u = model.col_lower, model.col_upper

    cols = []
    obj = []
    names = []
    mapping = {"lamL": {}, "lamU": {}, "muL": {}, "muU": {}, "n": n, "m": m}
    k = 0
    for i in range(m):
        if bL[i] > -INF:
            cols.append(A[i, :].T)
            obj.append(-bL[i])  # min of negated max objective
            mapping["lamL"][i] = k
            names.append(f"lamL{i}")
            k += 1
        if bU[i] < INF:  # equality rows get BOTH parts (free dual, split)
            cols.append(-A[i, :].T)
            obj.append(bU[i])
            mapping["lamU"][i] = k
            names.append(f"lamU{i}")
            k += 1
    eye = sp.eye(n, format="csc")
    for j in range(n):
        if l[j] > -INF:
            cols.append(eye[:, j])
            obj.append(-l[j])
            mapping["muL"][j] = k
            names.append(f"muL{j}")
            k += 1
        if u[j] < INF:  # fixed columns get BOTH parts (free dual, split)
            cols.append(-eye[:, j])
            obj.append(u[j])
            mapping["muU"][j] = k
            names.append(f"muU{j}")
            k += 1
    D = sp.hstack([sp.csc_matrix(col.reshape(n, 1)) for col in cols], format="csc")
    dual = Model()
    dual.load_problem(
        D,
        col_lower=np.zeros(k),
        col_upper=np.full(k, INF),
        objective=np.array(obj),
        row_lower=c,
        row_upper=c,
    )
    dual.col_names = names
    dual.problem_name = f"dual_{model.problem_name or 'model'}"
    return dual, mapping


def restore_from_dual(model: Model, dual: Model, mapping: dict) -> None:
    """Map the solved dual back onto the primal model's Solution."""
    dsol = dual.solution
    if dsol.status != ProblemStatus.OPTIMAL:
        model.solution.status = dsol.status
        return
    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0
    n, m = mapping["n"], mapping["m"]
    # primal x = NEGATED duals of the dual's equality rows: the dual model
    # minimizes the negated dual objective, flipping its multipliers
    x = -np.asarray(dsol.duals)
    lam = np.zeros(m)
    dv = np.asarray(dsol.primal)
    for i, k in mapping["lamL"].items():
        lam[i] += dv[k]
    for i, k in mapping["lamU"].items():
        lam[i] -= dv[k]
    obj = float(model.objective @ x) + model.objective_offset
    model.solution = Solution(
        status=ProblemStatus.OPTIMAL,
        objective_value=obj,
        primal=x,
        duals=lam * sense,
        reduced_costs=model.objective - model.matrix.T @ (lam * sense),
        row_activity=model.matrix @ x,
        iterations=dsol.iterations,
    )
