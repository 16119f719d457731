"""Sequential LP for smooth nonlinear objectives.

Reference: ClpSimplex::nonlinearSLP (ClpSimplex.hpp:357-371,
ClpSimplexNonlinear::primalSLP :2929) — minimize a smooth nonlinear
objective over the LP feasible region by iterating: linearize at x_k, add a
trust region, solve the LP warm, accept/shrink. The objective is a Python
callable; gradients come from the caller, or, when the caller gives none,
from torch.autograd: the callable must then be torch-traceable, and it is
evaluated in f64 on a CPU tensor built from the numpy point. The LP
sub-solves run on `device` ("cuda" unless the caller asks for the CPU).

Port of the JAX package's slp.py, where jax.grad of a jax-traceable
callable takes autograd's place.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .constants import INF, ProblemStatus, SolveMethod
from .device import resolve_device
from .model import Model, Solution
from .options import SolveOptions


def _on_tensor(f: Callable) -> Callable[[np.ndarray], float]:
    """f, a torch-traceable callable, evaluated at a numpy point."""
    return lambda x: float(f(torch.as_tensor(np.asarray(x, dtype=np.float64))))


def _autograd(f: Callable) -> Callable[[np.ndarray], np.ndarray]:
    """The gradient of a torch-traceable f at a numpy point: f64 autograd
    on a CPU tensor, handed back as numpy."""
    def grad(x):
        t = torch.tensor(np.asarray(x, dtype=np.float64), requires_grad=True)
        (g,) = torch.autograd.grad(f(t), t)
        return g.detach().numpy()
    return grad


def nonlinear_slp(
    model: Model,
    objective: Callable[[np.ndarray], float],
    gradient: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    max_passes: int = 50,
    initial_trust: float = 1.0,
    tol: float = 1e-7,
    device: str = "cuda",
) -> Solution:
    """Minimize `objective(x)` subject to the model's constraints/bounds.

    The model's linear objective is ignored; its rows and bounds define the
    feasible region. Returns a Solution with the nonlinear objective value.
    """
    resolve_device(device)
    if gradient is None:
        gradient = _autograd(objective)
        objective = _on_tensor(objective)

    from .simplex.driver import simplex_solve

    opts = SolveOptions(method=SolveMethod.PRIMAL_SIMPLEX, device=device)
    opts.presolve.enabled = False

    # feasible starting point: solve with zero objective
    work = model.copy()
    work.objective = np.zeros(model.num_cols)
    sol = simplex_solve(work, opts, dual=False)
    if sol.status != ProblemStatus.OPTIMAL:
        return sol
    x = np.asarray(sol.primal, dtype=np.float64)
    fx = float(objective(x))
    trust = initial_trust
    warm = sol

    for it in range(max_passes):
        g = np.asarray(gradient(x), dtype=np.float64)
        lin = model.copy()
        lin.objective = g
        lin.optimization_direction = 1.0
        # trust region: intersect bounds with a box around x
        lin.col_lower = np.maximum(model.col_lower, x - trust)
        lin.col_upper = np.minimum(model.col_upper, x + trust)
        s = simplex_solve(lin, opts, dual=False, warm=warm)
        if s.status != ProblemStatus.OPTIMAL:
            break
        x_new = np.asarray(s.primal)
        f_new = float(objective(x_new))
        pred = float(g @ (x_new - x))  # predicted (linear) decrease, <= 0
        if f_new < fx - 1e-12 * (1 + abs(fx)):
            # accept; expand trust if the linear model predicted well
            step = float(np.max(np.abs(x_new - x), initial=0.0))
            x, fx = x_new, f_new
            warm = s
            if step >= 0.9 * trust:
                trust *= 2.0
        else:
            trust *= 0.25
        if trust < tol * (1.0 + float(np.abs(x).max(initial=0.0))) or abs(pred) < tol * (
            1 + abs(fx)
        ):
            break

    out = Solution(
        status=ProblemStatus.OPTIMAL,
        objective_value=fx,
        primal=x,
        duals=warm.duals,
        reduced_costs=warm.reduced_costs,
        row_activity=model.matrix @ x,
        iterations=it + 1,
    )
    model.solution = out
    return out


class Constraint:
    """Smooth nonlinear constraint  lo <= g(x) <= up.

    The ClpConstraint analogue (ClpConstraint.hpp:17-40: functionValue +
    gradient fill). `gradient` defaults to torch.autograd of `value`,
    which must then be torch-traceable (and is evaluated on a tensor).
    """

    def __init__(self, value: Callable[[np.ndarray], float],
                 lower: float = -np.inf, upper: float = 0.0,
                 gradient: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        self.lower = float(lower)
        self.upper = float(upper)
        if gradient is None:
            gradient = _autograd(value)
            value = _on_tensor(value)
        self.value = value
        self.gradient = gradient


def nonlinear_slp_constrained(
    model: Model,
    constraints: list,
    objective: Optional[Callable[[np.ndarray], float]] = None,
    gradient: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    max_passes: int = 60,
    initial_trust: float = 1.0,
    penalty: float = 100.0,
    tol: float = 1e-7,
    device: str = "cuda",
) -> Solution:
    """SLP with nonlinear constraints (primalSLP with ClpConstraints,
    ClpSimplexNonlinear.cpp:3659).

    Each pass linearizes every constraint at x_k and appends it as an LP
    row; a trust region bounds the step; acceptance uses the L1 merit
    function  f(x) + penalty * sum(violations).  `objective=None` uses the
    model's linear objective.
    """
    import scipy.sparse as sp

    from .simplex.driver import simplex_solve

    resolve_device(device)
    n = model.num_cols
    if objective is None:
        c_lin = model.objective.copy()
        objective = lambda x: float(c_lin @ x)  # noqa: E731
        gradient = lambda x: c_lin  # noqa: E731
    elif gradient is None:
        gradient = _autograd(objective)
        objective = _on_tensor(objective)

    opts = SolveOptions(method=SolveMethod.PRIMAL_SIMPLEX, device=device)
    opts.presolve.enabled = False

    def violation(x):
        v = 0.0
        for con in constraints:
            gv = float(con.value(x))
            v += max(con.lower - gv, 0.0) + max(gv - con.upper, 0.0)
        return v

    def merit(x):
        return float(objective(x)) + penalty * violation(x)

    # start: solve the linear part feasibly (zero objective)
    work = model.copy()
    work.objective = np.zeros(n)
    sol = simplex_solve(work, opts, dual=False)
    if sol.status != ProblemStatus.OPTIMAL:
        return sol
    x = np.asarray(sol.primal, dtype=np.float64)
    mx = merit(x)
    trust = initial_trust
    warm = None
    it = 0

    for it in range(max_passes):
        gobj = np.asarray(gradient(x), dtype=np.float64)
        rows = []
        rl, ru = [], []
        for con in constraints:
            gc = np.asarray(con.gradient(x), dtype=np.float64)
            gv = float(con.value(x))
            rows.append(gc)
            shift = gc @ x - gv  # g(x) ~ gv + gc'(x - x_k)
            rl.append(con.lower + shift if np.isfinite(con.lower) else -INF)
            ru.append(con.upper + shift if np.isfinite(con.upper) else INF)
        lin = model.copy()
        lin.objective = gobj
        lin.optimization_direction = 1.0
        k = len(rows)
        if rows:
            lin.add_rows(sp.csc_matrix(np.vstack(rows)), lower=rl, upper=ru)
            # elastic slacks on the linearized rows: the LP stays feasible
            # even when a gradient degenerates (e.g. bilinear at the origin)
            # and the LP objective matches the L1 merit function exactly
            mr0 = model.num_rows
            E = sp.lil_matrix((mr0 + k, 2 * k))
            for i in range(k):
                E[mr0 + i, i] = 1.0
                E[mr0 + i, k + i] = -1.0
            lin.add_columns(
                E.tocsc(),
                lower=np.zeros(2 * k),
                upper=np.full(2 * k, INF),
                objective=np.full(2 * k, penalty),
            )
        lin.col_lower[:n] = np.maximum(model.col_lower, x - trust)
        lin.col_upper[:n] = np.minimum(model.col_upper, x + trust)
        s = simplex_solve(lin, opts, dual=False)
        if s.status != ProblemStatus.OPTIMAL:
            break
        x_new = np.asarray(s.primal)[:n]
        m_new = merit(x_new)
        step = float(np.max(np.abs(x_new - x), initial=0.0))
        if m_new < mx - 1e-12 * (1 + abs(mx)):
            x, mx = x_new, m_new
            warm = s
            if step >= 0.9 * trust:
                trust *= 2.0
        else:
            trust *= 0.25
        if trust < tol * (1.0 + float(np.abs(x).max(initial=0.0))):
            break

    feas = violation(x) <= 1e-6 * (1 + float(np.abs(x).max(initial=0.0)))
    out = Solution(
        status=ProblemStatus.OPTIMAL if feas else ProblemStatus.PRIMAL_INFEASIBLE,
        objective_value=float(objective(x)),
        primal=x,
        duals=warm.duals[: model.num_rows] if warm is not None and warm.duals is not None else None,
        row_activity=model.matrix @ x,
        iterations=it + 1,
    )
    model.solution = out
    return out
