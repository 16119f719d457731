"""Solve orchestration — the ClpSimplex::initialSolve equivalent.

Mirrors the reference's dispatcher flow (ClpSolve.cpp:845-4070):
  1. empty-problem short-circuit (:877-906)
  2. presolve (:955-1076)
  3. run the chosen method (dual / primal simplex)
  4. postsolve + cleanup solve if residual infeasibilities remain
  5. final status, timing

The port runs the DUAL_SIMPLEX and PRIMAL_SIMPLEX methods. Every other
route raises NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from .constants import INF, ProblemStatus, ScalingMode, SecondaryStatus, SolveMethod
from .device import resolve_device
from .model import Model, Solution
from .options import SolveOptions


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1: {item})")


def _empty_solution(model: Model) -> Solution:
    """Reference: empty-problem short-circuit (ClpSolve.cpp:877-906).

    With no rows the problem separates per column: minimize each c_j x_j
    over [l_j, u_j]. A pure clip-to-bounds of x = 0 would be feasible but
    NOT optimal.
    """
    n, m = model.num_cols, model.num_rows
    c = model.objective
    l, u = model.col_lower, model.col_upper
    if model.quadratic_objective is not None:
        raise _not_ported("a quadratic objective", "the other solvers (simplex/qp.py)")
    unbounded = False
    if n == 0:
        x = np.zeros(0)
    else:
        x = np.where(c > 0, l, np.where(c < 0, u, np.clip(0.0, l, u)))
        unbounded = bool(np.any((c > 0) & (l <= -INF)) or np.any((c < 0) & (u >= INF)))
        x = np.clip(x, np.maximum(l, -INF), np.minimum(u, INF))
    obj = float(c @ x) + model.objective_offset
    sol = Solution(
        status=ProblemStatus.DUAL_INFEASIBLE if unbounded else ProblemStatus.OPTIMAL,
        objective_value=obj,
        primal=x,
        duals=np.zeros(m),
        reduced_costs=c.copy(),
        row_activity=np.zeros(m) if n == 0 else model.matrix @ x,
    )
    infeas_col = np.any(model.col_lower > model.col_upper + 1e-12)
    infeas_row = np.any(
        (model.row_lower > model.row_upper + 1e-12)
        | ((model.row_lower > 1e-12) & (model.num_cols == 0))
        | ((model.row_upper < -1e-12) & (model.num_cols == 0))
    ) if m else False
    if infeas_col or infeas_row:
        sol.status = ProblemStatus.PRIMAL_INFEASIBLE
    return sol


def _solve_simplex(model: Model, options: SolveOptions, dual: bool,
                   warm: Optional[Solution] = None) -> Solution:
    from .simplex.driver import simplex_solve

    return simplex_solve(model, options, dual=dual, warm=warm)


def _fire(model: Model, which, **info) -> bool:
    """Fire an event hook; True means the handler requested an abort
    (reference: event handler return >= 0 -> status 5, ClpModel.hpp:435)."""
    from .events import fire_event

    return fire_event(model, which, **info)


def initial_solve(model: Model, options: Optional[SolveOptions] = None) -> Solution:
    """Presolve -> method -> solve -> postsolve -> cleanup; sets model.solution."""
    from .events import Event

    options = options or SolveOptions()
    # a CUDA device with no card raises here, before any work
    resolve_device(options.device)
    t0 = time.time()
    if _fire(model, Event.START_SOLVE):
        sol = Solution(status=ProblemStatus.USER_STOPPED)
        model.solution = sol
        return sol

    if model.num_cols == 0 or model.num_rows == 0:
        sol = _empty_solution(model)
        sol.solve_time = time.time() - t0
        model.solution = sol
        return sol

    # sanity check (reference: ClpModel data validation + ClpSimplex
    # sanityCheck — non-finite matrix entries or NaN rim data are
    # rejected with CLP_BAD_MATRIX/CLP_BAD_BOUNDS, status ERRORS)
    bad = None
    if not np.isfinite(model.matrix.data).all():
        bad = ("CLP_BAD_MATRIX",
               {"n": int((~np.isfinite(model.matrix.data)).sum())})
    else:
        for a in (model.objective, model.col_lower, model.col_upper,
                  model.row_lower, model.row_upper):
            if np.isnan(np.asarray(a, dtype=np.float64)).any():
                bad = ("CLP_BAD_BOUNDS",
                       {"n": int(np.isnan(np.asarray(a)).sum())})
                break
    if bad is not None:
        from .events import get_handler

        mh = get_handler(model, options)
        if mh is not None:
            mh.message(bad[0], **bad[1])
        sol = Solution(status=ProblemStatus.ERRORS)
        sol.solve_time = time.time() - t0
        model.solution = sol
        return sol

    # A pending warm basis is consumed by THIS solve, whatever route it
    # takes: capture the flag and clear it now, so an early-return route
    # that cannot use the basis drops it explicitly instead of leaving it
    # set for a LATER solve to misinterpret.
    warm_basis_pending = bool(getattr(model, "warm_start_pending", False))
    model.warm_start_pending = False

    if getattr(model, "piecewise_costs", None):
        raise _not_ported("piecewise-linear costs", "the other solvers (piecewise.py)")
    if options.dualize or (
        options.method == SolveMethod.AUTOMATIC
        and model.num_rows > 6 * model.num_cols
        and model.num_rows > 2000
    ):
        raise _not_ported("dualize", "analysis/API/CLI (analysis.dualize)")
    if model.quadratic_objective is not None:
        raise _not_ported("a quadratic objective", "the other solvers (simplex/qp.py)")

    # --- rim scale factors (objScale / rhsScale dblParams,
    # ClpModel.hpp:1124-1161): scale in, unscale out ---
    if options.objective_scale != 1.0 or options.rhs_scale != 1.0:
        os_, rs_ = float(options.objective_scale), float(options.rhs_scale)
        work0 = model.copy()
        work0.objective = work0.objective * os_
        if rs_ != 1.0:
            for attr in ("row_lower", "row_upper", "col_lower", "col_upper"):
                a = getattr(work0, attr)
                setattr(work0, attr, np.where(np.abs(a) < 1e29, a * rs_, a))
        inner = dataclasses.replace(options, objective_scale=1.0, rhs_scale=1.0)
        sol = initial_solve(work0, inner)
        if sol.primal is not None:
            sol.primal = sol.primal / rs_
            sol.row_activity = None if sol.row_activity is None else sol.row_activity / rs_
            sol.objective_value = float(model.objective @ sol.primal) + model.objective_offset
        if sol.duals is not None:
            sol.duals = sol.duals / os_
        if sol.reduced_costs is not None:
            sol.reduced_costs = sol.reduced_costs / os_
        model.solution = sol
        return sol

    # --- values pass (reference: ClpSimplex::dual(1)/primal(1),
    # ClpSimplexDual.cpp:637 ifValuesPass — start the simplex from the
    # CURRENT solution values; the crossover machinery builds the starting
    # basis from the point). Like the reference's direct method call this
    # bypasses presolve; the point is taken as-is.
    if (
        getattr(options, "values_pass", 0)
        and options.method in (SolveMethod.DUAL_SIMPLEX, SolveMethod.PRIMAL_SIMPLEX)
        and model.solution.primal is not None
        and model.solution.primal.size == model.num_cols
    ):
        warm = Solution(
            primal=np.asarray(model.solution.primal, dtype=np.float64).copy(),
            row_activity=(
                None
                if model.solution.row_activity is None
                else np.asarray(model.solution.row_activity, dtype=np.float64).copy()
            ),
        )
        sol = _solve_simplex(
            model, options, dual=options.method == SolveMethod.DUAL_SIMPLEX,
            warm=warm,
        )
        from .events import get_handler

        mh = get_handler(model, options)
        if mh is not None:
            mh.message("CLP_END_VALUES_PASS", it=sol.iterations)
        sol.solve_time = time.time() - t0
        model.solution = sol
        _fire(model, Event.END_SOLVE, status=sol.status, time=sol.solve_time)
        return sol

    # --- pending warm basis (reference: a basis loaded via readBasis /
    # setBasisStatus is the simplex starting basis, ClpModel statusCopy).
    # Presolve would invalidate the status arrays (sizes change) and is
    # worth far less than the basis on a re-solve, so it is skipped;
    # scaling still applies (basis STATUSES are scale-invariant).
    pending_warm = None
    if (
        warm_basis_pending
        and options.method in (SolveMethod.DUAL_SIMPLEX,
                               SolveMethod.PRIMAL_SIMPLEX,
                               SolveMethod.PRIMAL_IDIOT,
                               SolveMethod.AUTOMATIC)
        and model.solution.column_status is not None
        and model.solution.row_status is not None
        and np.asarray(model.solution.column_status).size == model.num_cols
        and np.asarray(model.solution.row_status).size == model.num_rows
    ):
        pending_warm = Solution(
            column_status=np.asarray(model.solution.column_status).copy(),
            row_status=np.asarray(model.solution.row_status).copy(),
        )

    method = options.method
    if pending_warm is not None:
        # a loaded basis pins the engine; a PRIMAL_IDIOT request keeps the
        # primal engine (the basis replaces the idiot point)
        method = (SolveMethod.PRIMAL_SIMPLEX
                  if method in (SolveMethod.PRIMAL_SIMPLEX,
                                SolveMethod.PRIMAL_IDIOT)
                  else SolveMethod.DUAL_SIMPLEX)
    elif method == SolveMethod.AUTOMATIC:
        raise _not_ported(
            "AUTOMATIC method choice", "AUTOMATIC routing; pass "
            "method=DUAL_SIMPLEX or PRIMAL_SIMPLEX")
    elif method in (SolveMethod.BARRIER, SolveMethod.BARRIER_NO_CROSS):
        raise _not_ported(f"method {method.name}", "barrier")
    elif method not in (SolveMethod.DUAL_SIMPLEX, SolveMethod.PRIMAL_SIMPLEX):
        raise _not_ported(f"method {method.name}", "the other solvers")
    if pending_warm is None and options.crash in ("idiot", "triangular"):
        raise _not_ported(f"the {options.crash} crash start",
                          "the other solvers (crash.py)")

    # --- presolve ---
    presolved = None
    pinfo = None
    work = model

    def _stop_now():
        sol = Solution(status=ProblemStatus.USER_STOPPED)
        sol.solve_time = time.time() - t0
        model.solution = sol
        return sol

    if options.presolve.enabled and pending_warm is None:
        from .presolve import presolve as run_presolve

        if _fire(model, Event.PRESOLVE_START):
            return _stop_now()
        t_phase = time.time()
        presolved, pinfo = run_presolve(model, options.presolve)
        # the inner solve runs on the presolved model: carry the handler so
        # phase messages still reach the user's interceptor
        presolved.message_handler = model.message_handler
        presolved.log_level = model.log_level
        timings = {"presolve": time.time() - t_phase}
        if _fire(
            model,
            Event.PRESOLVE_SIZE,
            rows=presolved.num_rows,
            cols=presolved.num_cols,
        ) | _fire(
            model,
            Event.PRESOLVE_END,
            rows_dropped=model.num_rows - presolved.num_rows,
            cols_dropped=model.num_cols - presolved.num_cols,
        ):
            return _stop_now()
        if pinfo.status in (ProblemStatus.PRIMAL_INFEASIBLE, ProblemStatus.DUAL_INFEASIBLE):
            _fire(model, Event.PRESOLVE_INFEASIBLE, status=pinfo.status)
            sol = Solution(
                status=pinfo.status,
                secondary_status=SecondaryStatus.INFEAS_OR_UNBOUNDED_IN_PRESOLVE,
            )
            sol.solve_time = time.time() - t0
            model.solution = sol
            return sol
        work = presolved
        if _fire(model, Event.PRESOLVE_BEFORE_SOLVE):
            return _stop_now()

    if presolved is None:
        timings = {}

    t_phase = time.time()
    # --- scaling (reference: ClpModel::scaling modes, applied pre-solve) ---
    factors = None
    if options.scaling != ScalingMode.OFF and work.num_cols and work.num_rows:
        from .scaling import compute_scaling, scale_model_arrays

        factors = compute_scaling(work.matrix, options.scaling)
        if np.allclose(factors.row, 1.0) and np.allclose(factors.col, 1.0):
            factors = None
        else:
            A, cl, cu, obj, rl, ru = scale_model_arrays(work, factors)
            scaled = work.copy()
            scaled.load_problem(A, cl, cu, obj, rl, ru)
            scaled.objective_offset = work.objective_offset
            scaled.optimization_direction = work.optimization_direction
            unscaled_work = work
            work = scaled

    timings["scaling"] = time.time() - t_phase
    t_phase = time.time()
    if work.num_cols == 0 or work.num_rows == 0:
        sol = _empty_solution(work)
    else:
        sol = _solve_simplex(work, options, dual=method == SolveMethod.DUAL_SIMPLEX,
                             warm=pending_warm)

    timings["solve"] = time.time() - t_phase
    t_phase = time.time()
    # --- unscale ---
    if factors is not None:
        from .scaling import unscale_solution

        x, y, dj = unscale_solution(
            factors, sol.primal, sol.duals, sol.reduced_costs
        )
        sol.primal, sol.duals, sol.reduced_costs = x, y, dj
        work = unscaled_work
        if x is not None:
            sol.row_activity = work.matrix @ x
            sol.objective_value = (
                float(work.objective @ x) + work.objective_offset
            )

    work.solution = sol

    # --- postsolve ---
    if presolved is not None:
        from .presolve import postsolve as run_postsolve

        _fire(model, Event.PRESOLVE_AFTER_FIRST_SOLVE, status=sol.status)
        sol = run_postsolve(model, pinfo, sol)
        # cleanup solve on the original model if needed (reference:
        # ClpSolve.cpp cleanup semantics, secondaryStatus 2/3/4)
        if options.cleanup and sol.status == ProblemStatus.OPTIMAL:
            from .validate import check_kkt

            rep = check_kkt(model, x=sol.primal, y=sol.duals, tol=1e-6)
            if not rep.ok:
                _fire(model, Event.SLIGHTLY_INFEASIBLE,
                      pinf=rep.primal_infeasibility,
                      dinf=rep.dual_infeasibility)
                sol2 = _solve_simplex(model, options, dual=True, warm=sol)
                if sol2.status == ProblemStatus.OPTIMAL:
                    sol = sol2
        _fire(model, Event.PRESOLVE_AFTER_SOLVE, status=sol.status)

    timings["postsolve"] = time.time() - t_phase
    sol.solve_time = time.time() - t0
    # keep engine-attached statistics (factorization counts) alongside the
    # per-phase wall timings
    timings.update(sol.timings or {})
    sol.timings = timings
    from .events import get_handler

    mh = get_handler(model, options)
    if mh is not None:
        mh.message(6, rows=model.num_rows, cols=model.num_cols, elems=model.num_elements)
        if "presolve" in timings and presolved is not None:
            mh.message(14, drows=model.num_rows - presolved.num_rows,
                       dcols=model.num_cols - presolved.num_cols)
        for phase, secs in timings.items():
            mh.message("CLP_INTERVAL_TIMING", phase=phase, time=secs,
                       total=sol.solve_time)
        mh.message("CLP_TIMING", phase=method.name, obj=sol.objective_value,
                   it=sol.iterations, time=sol.solve_time)
        mh.message(29, status=sol.status.name, time=sol.solve_time)
    model.solution = sol
    if sol.status == ProblemStatus.OPTIMAL:
        _fire(model, Event.SOLUTION, objective=sol.objective_value)
    _fire(model, Event.END_SOLVE, status=sol.status, time=sol.solve_time)
    return sol
