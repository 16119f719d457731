"""Post-optimal analysis: the explicit LP dual and the IIS.

Port of `dualize`, `restore_from_dual` and `find_iis` of the JAX package's
analysis.py (reference: ClpSimplexOther::dualOfModel / restoreFromDual,
ClpSimplexOther.cpp:1681 / :1397; examples/iis.cpp), host-side numpy
around the solvers. AUTOMATIC solves very tall LPs through their dual
(solve.initial_solve); the IIS deletion filter runs its trials through the
batched dual simplex. Ranging and parametrics are not ported yet (ROADMAP.md
queue 1: analysis/API/CLI).
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


def find_iis(model: Model, options=None, batch: bool = True) -> list[int]:
    """Irreducible infeasible subsystem of rows (reference role:
    examples/iis.cpp — explain WHY a model is infeasible).

    The Farkas ray's support seeds the candidate set; a deletion filter
    shrinks it to irreducibility (every remaining row necessary). With
    `batch=True` each filter round tests EVERY candidate deletion in one
    batched dual simplex (the trials differ only in row bounds, so they
    stack on the scenario axis) and drops all simultaneously-redundant rows
    when a re-verification confirms the reduced set is still infeasible:
    typically 2-3 solves in all instead of one per candidate. The caller's
    options are copied, not changed (the JAX package turns their presolve
    off in place).
    """
    import copy

    from .constants import SolveMethod
    from .options import SolveOptions

    opts = copy.deepcopy(options) if options is not None else SolveOptions(
        method=SolveMethod.DUAL_SIMPLEX)
    opts.presolve.enabled = False  # rays + stable row indexing

    def _free_rows(m, rows):
        t = m.copy()
        t.row_lower = t.row_lower.copy()
        t.row_upper = t.row_upper.copy()
        for q in rows:
            t.row_lower[q] = -INF
            t.row_upper[q] = INF
        return t

    def _infeasible(m) -> bool:
        return m.initial_solve(opts).status == ProblemStatus.PRIMAL_INFEASIBLE

    sol = model.initial_solve(opts)
    if sol.status != ProblemStatus.PRIMAL_INFEASIBLE:
        raise ValueError(f"model is not primal infeasible: {sol.status}")
    ray = model.infeasibility_ray()
    all_rows = set(range(model.num_rows))
    cand = (
        [int(r) for r in np.flatnonzero(np.abs(ray) > 1e-9)]
        if ray is not None and np.any(np.abs(ray) > 1e-9)
        else sorted(all_rows)
    )
    # rows outside the candidate set play no part: free them once
    base = _free_rows(model, sorted(all_rows - set(cand)))
    if not _infeasible(base):  # ray support insufficient -> use all rows
        cand = sorted(all_rows)
        base = model

    iis = list(cand)
    while len(iis) > 1:
        trials = [_free_rows(base, sorted((all_rows - set(iis)) | {r})) for r in iis]
        if batch and len(trials) > 1:
            from .parallel.batch import solve_batch_dual_simplex

            sols = solve_batch_dual_simplex(trials, opts)
            redundant = [r for r, s in zip(iis, sols)
                         if s.status == ProblemStatus.PRIMAL_INFEASIBLE]
        else:
            redundant = [r for r, t in zip(iis, trials) if _infeasible(t)]
        if not redundant:
            break  # every row necessary -> irreducible
        if len(redundant) > 1:
            # try dropping all redundant rows at once; accept if the reduced
            # set still proves infeasibility
            shrunk = [r for r in iis if r not in redundant]
            if shrunk and _infeasible(_free_rows(base, sorted(all_rows - set(shrunk)))):
                iis = shrunk
                continue
        iis.remove(redundant[0])
    return iis
