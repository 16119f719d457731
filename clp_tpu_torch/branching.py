"""Branch-and-bound support: hot starts and batched strong branching.

Reference surface: OsiClp's markHotStart/solveFromHotStart
(OsiClpSolverInterface.hpp:321-325 -> ClpSimplexDual::strongBranching,
ClpSimplexDual.cpp:6965) and the ClpNode fathom machinery
(ClpSimplex.hpp:589). Strong branching evaluates ALL candidate bound
changes as one batch of warm dual solves (parallel/batch.py, the pivot
body under torch.func.vmap) — the reference loops candidates serially on
one core. Every solve runs on the caller's device: `device` where a
function takes no options, else `options.device`; the default is
`device.default_device()`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .constants import INF, ProblemStatus, SolveMethod, VariableStatus
from .model import Model, Solution
from .options import SolveOptions


@dataclasses.dataclass
class HotStart:
    """Saved basis + bounds snapshot (markHotStart equivalent)."""

    column_status: np.ndarray
    row_status: np.ndarray
    col_lower: np.ndarray
    col_upper: np.ndarray
    objective_value: float


def mark_hot_start(model: Model) -> HotStart:
    sol = model.solution
    if sol.column_status is None:
        raise ValueError("hot start requires a solved basis")
    return HotStart(
        column_status=sol.column_status.copy(),
        row_status=sol.row_status.copy(),
        col_lower=model.col_lower.copy(),
        col_upper=model.col_upper.copy(),
        objective_value=sol.objective_value,
    )


def solve_from_hot_start(
    model: Model,
    hot: HotStart,
    column: int,
    new_lower: Optional[float] = None,
    new_upper: Optional[float] = None,
    max_iterations: int = 1000,
    device: Optional[str] = None,
) -> Solution:
    """Warm dual re-solve after one bound change; model state restored."""
    from .simplex.driver import simplex_solve

    saved_l = model.col_lower.copy()
    saved_u = model.col_upper.copy()
    try:
        if new_lower is not None:
            model.col_lower = model.col_lower.copy()
            model.col_lower[column] = new_lower
        if new_upper is not None:
            model.col_upper = model.col_upper.copy()
            model.col_upper[column] = new_upper
        opts = SolveOptions(method=SolveMethod.DUAL_SIMPLEX, max_iterations=max_iterations)
        if device is not None:
            opts.device = device
        opts.presolve.enabled = False
        warm = Solution(column_status=hot.column_status, row_status=hot.row_status)
        return simplex_solve(model, opts, dual=True, warm=warm)
    finally:
        model.col_lower = saved_l
        model.col_upper = saved_u


def crunch_solve(
    model: Model,
    warm: Solution,
    options: Optional[SolveOptions] = None,
    slack_margin: float = 1e-4,
    max_rounds: int = 4,
) -> Solution:
    """Row-subset fast re-solve (ClpSimplexOther::crunch, :2312 afterCrunch).

    Keeps rows that look binding at the warm solution (nonbasic slack or
    activity near a bound) plus all equality rows; solves the reduced LP
    warm; re-adds any dropped row the solution violates and repeats. Dropped
    rows return with zero dual and a basic slack.
    """
    from .simplex.driver import simplex_solve

    options = options or SolveOptions(method=SolveMethod.DUAL_SIMPLEX)
    options.presolve.enabled = False
    m = model.num_rows
    act = np.asarray(warm.row_activity) if warm.row_activity is not None else None
    rl, ru = model.row_lower, model.row_upper
    keep = np.zeros(m, dtype=bool)
    keep |= rl == ru  # equalities always stay
    if warm.row_status is not None:
        keep |= np.asarray(warm.row_status) != int(VariableStatus.BASIC)
    if act is not None:
        scale = 1.0 + np.abs(act)
        keep |= (rl > -INF) & (act - rl <= slack_margin * scale)
        keep |= (ru < INF) & (ru - act <= slack_margin * scale)

    for _ in range(max_rounds):
        idx = np.flatnonzero(keep)
        sub = Model()
        sub.load_problem(
            model.matrix.tocsr()[idx, :].tocsc(),
            col_lower=model.col_lower,
            col_upper=model.col_upper,
            objective=model.objective,
            row_lower=rl[idx],
            row_upper=ru[idx],
        )
        sub.optimization_direction = model.optimization_direction
        w = Solution(
            column_status=warm.column_status,
            row_status=None
            if warm.row_status is None
            else np.asarray(warm.row_status)[idx],
        ) if warm.column_status is not None else None
        sol = simplex_solve(sub, options, dual=True, warm=w)
        if sol.status != ProblemStatus.OPTIMAL:
            break
        x = np.asarray(sol.primal)
        full_act = model.matrix @ x
        tol = model.primal_tolerance * (1.0 + np.abs(full_act))
        viol = (~keep) & (
            ((rl > -INF) & (full_act < rl - tol))
            | ((ru < INF) & (full_act > ru + tol))
        )
        if not viol.any():
            # expand to the full frame
            y = np.zeros(m)
            y[idx] = np.asarray(sol.duals)
            rstat = np.full(m, int(VariableStatus.BASIC), dtype=np.int8)
            if sol.row_status is not None:
                rstat[idx] = sol.row_status
            out = Solution(
                status=ProblemStatus.OPTIMAL,
                objective_value=sol.objective_value,
                primal=x,
                duals=y,
                reduced_costs=model.objective - model.matrix.T @ y,
                row_activity=full_act,
                iterations=sol.iterations,
                column_status=sol.column_status,
                row_status=rstat,
            )
            model.solution = out
            return out
        keep |= viol
    # fall back to the full solve
    return simplex_solve(model, options, dual=True, warm=warm)


@dataclasses.dataclass
class BranchResult:
    column: int
    direction: str  # "down" | "up"
    status: ProblemStatus
    objective: float
    iterations: int


def strong_branch(
    model: Model,
    columns: Sequence[int],
    values: Optional[Sequence[float]] = None,
    max_iterations: int = 500,
    device: Optional[str] = None,
) -> list[BranchResult]:
    """Evaluate floor/ceil branches for each candidate column, batched.

    Builds 2*len(columns) same-shape bound-modified models and solves them
    as one batch of dual simplex lanes on `device`
    (parallel.batch.solve_batch_dual_simplex).
    """
    from .parallel.batch import solve_batch_dual_simplex

    x = model.solution.primal
    if x is None:
        raise ValueError("strong branching requires a solved relaxation")
    vals = list(values) if values is not None else [float(x[j]) for j in columns]

    branch_models: list[Model] = []
    descr: list[tuple[int, str]] = []
    for j, v in zip(columns, vals):
        down = model.copy()
        down.col_upper = down.col_upper.copy()
        down.col_upper[j] = np.floor(v)
        branch_models.append(down)
        descr.append((j, "down"))
        up = model.copy()
        up.col_lower = up.col_lower.copy()
        up.col_lower[j] = np.ceil(v)
        branch_models.append(up)
        descr.append((j, "up"))

    opts = SolveOptions(
        method=SolveMethod.DUAL_SIMPLEX, max_iterations=max_iterations
    )
    if device is not None:
        opts.device = device
    opts.presolve.enabled = False
    # all branches warm-start from the parent relaxation's basis
    sols = solve_batch_dual_simplex(branch_models, opts, warm=model.solution)
    return [
        BranchResult(j, d, s.status, s.objective_value, s.iterations)
        for (j, d), s in zip(descr, sols)
    ]
