"""Crash-basis construction — the Idiot equivalent.

The reference's Idiot crash (Idiot.hpp:70-90, IdiSolve.cpp, Idiot.cpp:399,
1324) is a mu-scheduled quadratic-penalty descent: repeated "major"
iterations of approximate minimization of  mu*c'x + (1/2)||viol(Ax)||^2
with mu dropped whenever infeasibility progress stalls, producing an
approximate primal point that warm-starts the simplex.

Port of the JAX package's crash.py. The descent keeps its schedule (8
power steps for the step size, then `majors` x 25 accelerated projected-
gradient minors) as Python loops over f64 device tensors on
`options.device`; every scalar of the schedule (the objective weight, the
best infeasibility) stays a 0-dim tensor, so the loop reads nothing on the
host. A is dense, as in the JAX package. The triangular crash is host-side
numpy, a copy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .constants import INF, VariableStatus
from .device import resolve_device
from .model import Model, Solution
from .options import SolveOptions


def _idiot_descend(A, c, rl, ru, cl, cu, x0, w0, majors: int, minors: int):
    """The penalty descent; every argument a tensor on one device (w0 may be
    a float). Bounds are ±inf where absent."""
    # spectral Lipschitz estimate ||A||_2^2 via a few power iterations —
    # a valid global step for the full-gradient FISTA sweep (a diagonal
    # estimate is only valid coordinate-wise and diverges here)
    n = A.shape[1]
    v = torch.ones(n, dtype=A.dtype, device=A.device) / np.sqrt(n)
    for _ in range(8):
        v = A.T @ (A @ v)
        v = v / (torch.linalg.vector_norm(v) + 1e-30)
    lip = torch.linalg.vector_norm(A @ v) ** 2 * 1.05 + 1e-12

    x = x0
    w = torch.as_tensor(w0, dtype=A.dtype, device=A.device)
    best = torch.tensor(float("inf"), dtype=A.dtype, device=A.device)
    for _ in range(majors):
        mom = x  # momentum (look-ahead) point
        for k in range(minors):
            ax = A @ mom
            viol = ax - torch.clamp(ax, rl, ru)
            grad = w * c + viol @ A
            x_new = torch.clamp(mom - grad / lip, cl, cu)
            beta = k / (k + 3.0)  # FISTA-style momentum
            mom = x_new + beta * (x_new - x)
            x = x_new
        ax = A @ x
        infeas = torch.linalg.vector_norm(ax - torch.clamp(ax, rl, ru))
        # mu schedule (Idiot drop logic): infeasibility stalled -> shrink
        # the objective weight so the penalty dominates and feasibility
        # improves; otherwise keep pressing the objective
        w = torch.where(infeas > 0.9 * best, w * 0.25, w)
        best = torch.minimum(best, infeas)
    return x


def idiot_crash(model: Model, options: SolveOptions) -> Solution:
    """Mu-scheduled penalty descent -> approximate point for warm start."""
    dev = resolve_device(options.device)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    A = t(model.matrix.todense())
    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0
    c = t(model.objective * sense)
    rl = t(np.where(model.row_lower <= -INF, -np.inf, model.row_lower))
    ru = t(np.where(model.row_upper >= INF, np.inf, model.row_upper))
    cl = t(np.where(model.col_lower <= -INF, -np.inf, model.col_lower))
    cu = t(np.where(model.col_upper >= INF, np.inf, model.col_upper))
    x0 = torch.clamp(torch.zeros_like(cl), cl, cu)
    # idiot_passes plays the reference's majorIterations role
    majors = max(10, options.idiot_passes or 30)
    minors = 25
    cscale = 1.0 + float(np.max(np.abs(model.objective * sense), initial=0.0))
    x = _idiot_descend(A, c, rl, ru, cl, cu, x0, 10.0 / cscale, majors, minors)
    return Solution(primal=x.cpu().numpy())


def triangular_crash(model: Model, options: SolveOptions = None) -> Solution:
    """Structural triangular crash basis (reference: ClpSimplex::crash,
    ClpSimplex.hpp:562 / ClpSimplex.cpp — Bixby-style column selection).

    Greedily assigns columns to pivot rows so that, ordered by assignment
    time, each selected column has its pivot as the ONLY nonzero in
    not-yet-assigned rows. The selected columns plus the remaining slacks
    then form a permuted-triangular basis: guaranteed nonsingular, no
    factorization risk. Host-side and O(passes * nnz), as the reference
    runs it (before startup()). Returns a status-only warm Solution
    consumed by simplex_solve. Opt-in (`crash="triangular"`), never chosen
    by AUTOMATIC.
    """
    A = model.matrix.tocsc()
    m, n = A.shape
    cl = np.asarray(model.col_lower, dtype=np.float64)
    cu = np.asarray(model.col_upper, dtype=np.float64)
    rl = np.asarray(model.row_lower, dtype=np.float64)
    ru = np.asarray(model.row_upper, dtype=np.float64)
    obj = np.asarray(model.objective, dtype=np.float64)
    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0

    counts = np.diff(A.indptr)
    has_lo = cl > -INF
    has_up = cu < INF
    fixed = has_lo & has_up & (cu - cl < 1e-12)
    # preference: free columns first (they should be basic in any optimal
    # basis), then single-bound, then boxed; fewer nonzeros break ties
    type_score = np.where(~has_lo & ~has_up, 0,
                          np.where(has_lo ^ has_up, 1, 2))
    type_score = np.where(fixed | (counts == 0), 9, type_score)
    order = np.lexsort((counts, type_score))
    order = order[type_score[order] < 9]

    indptr, indices, data = A.indptr, A.indices, A.data
    row_done = np.zeros(m, dtype=bool)
    col_row = np.full(n, -1, dtype=np.int64)
    # rows whose slack has no finite bound must keep it basic
    row_eligible = (rl > -INF) | (ru < INF)
    changed = True
    while changed:
        changed = False
        for j in order:
            if col_row[j] >= 0:
                continue
            s, e = indptr[j], indptr[j + 1]
            rows = indices[s:e]
            vals = data[s:e]
            live = ~row_done[rows] & row_eligible[rows]
            if np.count_nonzero(live) != 1:
                continue
            k = np.flatnonzero(live)[0]
            if abs(vals[k]) < 1e-2 * np.max(np.abs(vals)):
                continue  # pivot too small relative to its column
            row_done[rows[k]] = True
            col_row[j] = rows[k]
            changed = True

    col_status = np.empty(n, dtype=np.int8)
    csense = obj * sense
    for j in range(n):
        if col_row[j] >= 0:
            col_status[j] = int(VariableStatus.BASIC)
        elif fixed[j]:
            col_status[j] = int(VariableStatus.FIXED)
        elif has_lo[j] and (csense[j] >= 0 or not has_up[j]):
            col_status[j] = int(VariableStatus.AT_LOWER)
        elif has_up[j]:
            col_status[j] = int(VariableStatus.AT_UPPER)
        else:
            col_status[j] = int(VariableStatus.FREE)
    row_status = np.empty(m, dtype=np.int8)
    for i in range(m):
        if not row_done[i]:
            row_status[i] = int(VariableStatus.BASIC)
        elif rl[i] > -INF:
            row_status[i] = int(VariableStatus.AT_LOWER)
        else:
            row_status[i] = int(VariableStatus.AT_UPPER)
    return Solution(column_status=col_status, row_status=row_status)


def apply_idiot_crash(model: Model, passes: int = 30, device: Optional[str] = None) -> int:
    """C-API/CLI helper (Clp_idiot role, Clp_C_Interface.h): run the
    idiot descent on `device` (default: `device.default_device()`) and
    leave the point on model.solution so a values-pass solve
    (dual(1)/primal(1)) starts from it."""
    opts = SolveOptions(idiot_passes=int(passes))
    if device is not None:
        opts.device = device
    sol = idiot_crash(model, opts)
    model.solution.primal = np.asarray(sol.primal, dtype=np.float64)
    model.solution.row_activity = np.asarray(
        model.matrix @ model.solution.primal, dtype=np.float64)
    return 0


def apply_triangular_crash(model: Model) -> int:
    """C-API helper (Clp_crash with pivot != 0): build the structural
    triangular basis and load it as the pending warm start."""
    w = triangular_crash(model)
    model.set_basis_status(w.column_status, w.row_status)
    return 0
