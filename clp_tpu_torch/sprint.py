"""Sprint / sifting — column-subset working-set solve.

Reference: the sprint loop inline in initialSolve (ClpSolve.cpp:2486-2779,
description :2488-2501): iteratively solve a sub-LP over a few-times-rows
chosen columns plus artificials, price the full column set with the sub-LP
duals, add attractive columns, drop unattractive nonbasic ones, repeat
(<= maxSprintPass).

For many-more-columns-than-rows LPs this keeps the dense working set small;
the full pricing step is one sparse matvec on the host.

Port of the JAX package's sprint.py: each sub-LP runs the port's
`simplex_solve` on the caller's `options.device`. A `mesh` argument, or an
`options.devices` that is a port Mesh with a "block" axis, turns on the
column-sharded repricing over that mesh (parallel/block.py); a plain list
of devices is ignored there, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .constants import INF, ProblemStatus, SolveMethod, VariableStatus
from .model import Model, Solution
from .options import SolveOptions


def sprint_solve(model: Model, options: SolveOptions, max_passes: int = 100,
                 mesh=None) -> Solution:
    import time as _time

    deadline = (
        None if options.max_seconds is None else _time.monotonic() + options.max_seconds
    )
    m, n = model.num_rows, model.num_cols
    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0
    A = model.matrix.tocsc()
    c = model.objective * sense

    # column-sharded device repricing over the `block` mesh axis
    sharded_cols = None
    if mesh is None and options.devices is not None:
        from .parallel.mesh import Mesh

        if isinstance(options.devices, Mesh) and "block" in options.devices.axis_names:
            mesh = options.devices
    if mesh is not None:
        from .parallel.block import BlockShardedColumns

        sharded_cols = BlockShardedColumns(A, c, mesh)

    target = min(n, max(3 * m, 500))  # working-set size (~3x rows, ref heuristic)
    order = np.argsort(np.abs(c))
    active = np.zeros(n, dtype=bool)
    active[order[:target]] = True

    # artificial columns +-e_i with big cost keep every sub-LP feasible
    # (the reference's sprint adds artificials the same way)
    big = 1e5 * (1.0 + float(np.abs(c).max(initial=0.0)))
    art = sp.hstack([sp.eye(m, format="csc"), -sp.eye(m, format="csc")], format="csc")
    art_cost = np.full(2 * m, big)

    from .simplex.driver import simplex_solve

    sub_opts = SolveOptions(method=SolveMethod.PRIMAL_SIMPLEX, device=options.device)
    sub_opts.presolve.enabled = False

    best: Solution | None = None
    warm_map: Solution | None = None
    # artificial columns are the same in every pass: carry their statuses
    # so a warm basis keeps any still-basic artificials (dropping them made
    # the warm basis singular — wrong-OPTIMAL-with-violations bug)
    warm_art = np.full(2 * m, int(VariableStatus.AT_LOWER), dtype=np.int8)
    total_iters = 0
    art_use = np.inf
    new_cols = np.zeros(0, dtype=np.int64)

    for pass_no in range(max_passes):
        if deadline is not None and _time.monotonic() > deadline:
            break
        idx = np.flatnonzero(active)
        k = idx.size
        sub = Model()
        sub.load_problem(
            sp.hstack([A[:, idx], art], format="csc"),
            col_lower=np.concatenate([model.col_lower[idx], np.zeros(2 * m)]),
            col_upper=np.concatenate([model.col_upper[idx], np.full(2 * m, INF)]),
            objective=np.concatenate([model.objective[idx], art_cost * sense]),
            row_lower=model.row_lower,
            row_upper=model.row_upper,
        )
        sub.optimization_direction = model.optimization_direction
        warm = None
        if warm_map is not None and warm_map.column_status is not None:
            warm = Solution(
                column_status=np.concatenate(
                    [warm_map.column_status[idx], warm_art]
                ),
                row_status=warm_map.row_status,
            )
        sol = simplex_solve(sub, sub_opts, dual=False, warm=warm)
        if sol.status != ProblemStatus.OPTIMAL and warm is not None:
            # a degraded warm basis must not end the sprint: retry cold
            sol = simplex_solve(sub, sub_opts, dual=False, warm=None)
        total_iters += sol.iterations
        if sol.status != ProblemStatus.OPTIMAL:
            if sol.status == ProblemStatus.DUAL_INFEASIBLE:
                # an improving ray of the column restriction is a ray of
                # the full problem (inactive columns sit at their bounds):
                # unboundedness is proven, not a failure
                best = Solution(status=ProblemStatus.DUAL_INFEASIBLE,
                                iterations=total_iters)
            break

        art_use = float(np.abs(sol.primal[k:]).max(initial=0.0))
        warm_art = np.asarray(sol.column_status[k:], dtype=np.int8)

        # full pricing with sub-LP duals
        y = np.asarray(sol.duals) * sense
        if sharded_cols is not None:
            dj, _, _ = sharded_cols.reprice(y)
        else:
            dj = c - A.T @ y
        lo_attr = (~active) & (dj < -model.dual_tolerance)
        up_attr = (
            (~active)
            & (dj > model.dual_tolerance)
            & (model.col_upper < INF)
            & (model.col_lower <= -INF)
        )
        new_cols = np.flatnonzero(lo_attr | up_attr)

        # map sub solution back onto the full frame
        full = Solution(
            status=sol.status,
            objective_value=0.0,
            primal=np.zeros(n),
            duals=np.asarray(sol.duals),
            reduced_costs=dj * sense,
            row_activity=np.asarray(sol.row_activity),
            iterations=total_iters,
            column_status=np.full(n, int(VariableStatus.AT_LOWER), dtype=np.int8),
            row_status=np.asarray(sol.row_status),
        )
        full.primal[idx] = sol.primal[:k]
        inact = ~active
        full.primal[inact] = np.where(
            model.col_lower[inact] > -INF, model.col_lower[inact], 0.0
        )
        full.column_status[idx] = sol.column_status[:k]
        best = full
        warm_map = full

        if new_cols.size == 0:
            if art_use > 10 * model.primal_tolerance:
                best.status = ProblemStatus.PRIMAL_INFEASIBLE
            break  # full optimality (or infeasibility) proven

        # grow working set; shrink if oversized by dropping unattractive
        # nonbasic columns
        active[new_cols[: max(m, 200)]] = True
        if active.sum() > 2 * target and full.column_status is not None:
            droppable = (
                active
                & (full.column_status != int(VariableStatus.BASIC))
                & (dj > 10 * model.dual_tolerance)  # comfortably at lower
                & ~np.isin(np.arange(n), new_cols)
            )
            if active.sum() - droppable.sum() >= target:
                active[droppable] = False

    if best is None:
        best = Solution(status=ProblemStatus.ERRORS)
    elif best.status == ProblemStatus.OPTIMAL and art_use > 10 * model.primal_tolerance:
        # artificials still carry row violations: optimality is NOT proven
        # (loop ended early by pass/time limit or a failed sub-solve)
        best.status = (
            ProblemStatus.PRIMAL_INFEASIBLE if new_cols.size == 0
            else ProblemStatus.STOPPED
        )
    if best.primal is not None:
        best.objective_value = float(model.objective @ best.primal) + model.objective_offset
        best.row_activity = A @ best.primal
    model.solution = best
    return best
