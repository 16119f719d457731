"""Independent KKT-condition verifier — the universal solution oracle.

Pattern taken from the reference's test strategy (test/test_racing_lp.cpp:36-100):
verify primal feasibility, dual feasibility, and complementary slackness
directly from problem data, independent of any solver internals.

For   minimize c'x  s.t.  rl <= Ax <= ru,  cl <= x <= cu
with row duals y and reduced costs d = c - A'y, optimality requires:
  1. primal feasibility:   rl - tol <= Ax <= ru + tol,  cl - tol <= x <= cu + tol
  2. dual feasibility:     y_i > 0 only if rl_i finite; y_i < 0 only if ru_i
                           finite; d_j < 0 only if cu_j finite; d_j > 0 only
                           if cl_j finite
  3. complementary slackness: y_i > 0 => Ax_i ~= rl_i; y_i < 0 => Ax_i ~= ru_i;
                           d_j > 0 => x_j ~= cl_j; d_j < 0 => x_j ~= cu_j.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import INF


@dataclasses.dataclass
class KKTReport:
    primal_infeasibility: float
    dual_infeasibility: float
    complementarity: float
    objective: float
    ok: bool

    def __str__(self):
        return (
            f"KKT(pinf={self.primal_infeasibility:.3e}, "
            f"dinf={self.dual_infeasibility:.3e}, "
            f"compl={self.complementarity:.3e}, obj={self.objective:.10g}, "
            f"ok={self.ok})"
        )


def check_kkt(model, x=None, y=None, tol: float = 1e-6) -> KKTReport:
    """Verify the model's solution (or the given x, y) satisfies KKT.

    Works in the *minimization* convention internally: a maximization model's
    data is sign-flipped the same way the solvers do it.
    """
    sol = model.solution
    x = np.asarray(x if x is not None else sol.primal, dtype=np.float64)
    y = np.asarray(y if y is not None else sol.duals, dtype=np.float64)
    A = model.matrix
    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0
    c = model.objective * sense
    rl, ru = model.row_lower, model.row_upper
    cl, cu = model.col_lower, model.col_upper
    if sense < 0:
        y = y * -1.0

    ax = A @ x

    pinf = max(
        float(np.max(rl - ax, initial=0.0)),
        float(np.max(ax - ru, initial=0.0)),
        float(np.max(cl - x, initial=0.0)),
        float(np.max(x - cu, initial=0.0)),
        0.0,
    )

    d = c - (A.T @ y if y.size else np.zeros_like(c))
    if model.quadratic_objective is not None:
        d = d + sense * (model.quadratic_objective @ x)

    # dual feasibility: positive multipliers require the corresponding finite
    # bound to exist.
    dinf = 0.0
    if y.size:
        dinf = max(
            dinf,
            float(np.max(np.where(rl <= -INF, np.maximum(y, 0.0), 0.0), initial=0.0)),
            float(np.max(np.where(ru >= INF, np.maximum(-y, 0.0), 0.0), initial=0.0)),
        )
    if d.size:
        dinf = max(
            dinf,
            float(np.max(np.where(cl <= -INF, np.maximum(d, 0.0), 0.0), initial=0.0)),
            float(np.max(np.where(cu >= INF, np.maximum(-d, 0.0), 0.0), initial=0.0)),
        )

    # complementary slackness, scaled by the multiplier magnitude
    compl = 0.0
    if y.size:
        gap_l = np.where(rl > -INF, np.abs(ax - rl), 0.0)
        gap_u = np.where(ru < INF, np.abs(ru - ax), 0.0)
        compl = max(
            compl,
            float(np.max(np.where(y > tol, y * gap_l, 0.0), initial=0.0)),
            float(np.max(np.where(y < -tol, -y * gap_u, 0.0), initial=0.0)),
        )
    if d.size:
        gap_l = np.where(cl > -INF, np.abs(x - cl), 0.0)
        gap_u = np.where(cu < INF, np.abs(cu - x), 0.0)
        compl = max(
            compl,
            float(np.max(np.where(d > tol, d * gap_l, 0.0), initial=0.0)),
            float(np.max(np.where(d < -tol, -d * gap_u, 0.0), initial=0.0)),
        )

    obj = float(c @ x)
    if model.quadratic_objective is not None:
        obj += 0.5 * float(x @ (model.quadratic_objective @ x)) * sense
    obj += model.objective_offset * sense

    xscale = 1.0 + float(np.abs(x).max(initial=0.0))
    dscale = 1.0 + float(np.abs(c).max(initial=0.0)) + float(np.abs(y).max(initial=0.0))
    ok = (
        pinf <= tol * xscale
        and dinf <= tol * dscale
        and compl <= tol * 100 * xscale * dscale
    )
    return KKTReport(pinf, dinf, compl, obj * (1.0 if sense > 0 else -1.0), ok)


def check_objective(model, expected: float, rel_tol: float = 1e-7) -> bool:
    """Golden-objective comparison (reference: unitTest.cpp:395-1074 style)."""
    got = model.solution.objective_value
    return abs(got - expected) <= rel_tol * (1.0 + abs(expected))
