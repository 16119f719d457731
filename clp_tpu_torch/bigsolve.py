"""Simplex-accuracy finishing for beyond-dense-scale sparse LPs.

The dense engine carries an explicit m x m basis inverse, so a sparse
100k x 200k LP can never run through it whole. The reference reaches for
its sparse LU + hypersparse FTRAN at this scale (ClpFactorization.hpp:483
goSparse, CoinAbcBaseFactorization.hpp:418-554); the answer here is a
*working-set* method instead: crunch the LP down to the rows and columns
that matter at the (first-order-accurate) PDHG point, solve the small
dense sub-LP to 1e-9 on the dense engine, and verify/grow against
the FULL sparse data with O(nnz) host matvecs until the full KKT system is
satisfied. The reference's own crunch (ClpSimplexOther::crunch,
ClpSimplexOther.cpp:4242) and sprint loop (ClpSolve.cpp:2486-2779) are the
two halves of this idea — crunch drops rows, sprint drops columns; this
does both at once, seeded by the PDLP solution.

Soundness does not depend on the seed: a candidate is only ever reported
OPTIMAL after (a) every dropped row verifies primally feasible, (b) every
fixed column verifies dual feasible, both against the full sparse matrix,
and (c) an independent full KKT check passes at simplex tolerances.
Violated rows/columns are added to the working set and the sub-LP re-solves
warm; each pass strictly grows the working set, so termination is finite.

Port of the JAX package's bigsolve.py: the working-set logic is host-side
numpy, a copy; each sub-LP runs the port's dual simplex on the caller's
`options.device`.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import scipy.sparse as sp

from .constants import INF, ProblemStatus, SolveMethod, VariableStatus
from .model import Model, Solution
from .options import SolveOptions


def _nearest_bound(x, cl, cu):
    """Snap x to its nearest finite bound; NaN marks no finite bound."""
    lo = np.where(cl > -INF, cl, np.nan)
    hi = np.where(cu < INF, cu, np.nan)
    d_lo = np.abs(x - lo)
    d_hi = np.abs(x - hi)
    pick_lo = np.where(np.isnan(d_hi), True, d_lo <= d_hi)
    snapped = np.where(pick_lo, lo, hi)
    return snapped  # NaN where both bounds infinite


def crunch_polish(
    model: Model,
    options: SolveOptions,
    warm: Solution,
    max_passes: int = 12,
    kkt_tol: float = 1e-7,
) -> Optional[Solution]:
    """Polish a near-optimal (x, y) to verified simplex accuracy.

    Returns a fully verified OPTIMAL Solution on the model's frame, or None
    when the working-set iteration fails to close (caller keeps the seed
    solution, marked REDUCED_ACCURACY). Never returns an unverified OPTIMAL.
    """
    m, n = model.num_rows, model.num_cols
    if warm.primal is None or warm.duals is None:
        return None
    A = model.matrix.tocsr()
    AT = A.T.tocsr()
    Ac = model.matrix.tocsc()
    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0
    c = model.objective * sense
    rl, ru = model.row_lower, model.row_upper
    cl, cu = model.col_lower, model.col_upper

    x0 = np.asarray(warm.primal, dtype=np.float64)
    y0 = np.asarray(warm.duals, dtype=np.float64) * sense
    x0 = np.clip(x0, np.where(cl > -INF, cl, -np.inf), np.where(cu < INF, cu, np.inf))
    ax0 = A @ x0
    dj0 = c - AT @ y0

    # --- seed working sets from the first-order point ---
    # rows: keep if the activity is near a finite bound or the dual is
    # non-negligible (complementarity says the rest have slack, y = 0)
    row_scale = 1.0 + np.abs(ax0)
    near_lo = (rl > -INF) & (ax0 - rl < 1e-3 * row_scale)
    near_hi = (ru < INF) & (ru - ax0 < 1e-3 * row_scale)
    row_keep = near_lo | near_hi | (np.abs(y0) > 1e-7) | (rl == ru)

    # columns: keep if interior by margin, reduced cost ambiguous, or no
    # finite bound to fix at
    col_scale = 1.0 + np.abs(x0)
    at_lo = (cl > -INF) & (x0 - cl < 1e-3 * col_scale)
    at_hi = (cu < INF) & (cu - x0 < 1e-3 * col_scale)
    snap = _nearest_bound(x0, cl, cu)
    fixable = (at_lo | at_hi) & ~np.isnan(snap)
    # a fixed column must be comfortably dual feasible at its bound
    ok_lo = at_lo & (dj0 > 1e-6)
    ok_hi = at_hi & (dj0 < -1e-6)
    col_fix = fixable & (ok_lo | ok_hi) & (cl != cu)
    col_keep = ~col_fix
    # equalities with both bounds: keep fixed cols out (their x is the bound)
    xfix_val = np.where(col_fix, np.where(ok_lo, cl, cu), 0.0)

    from .simplex.driver import simplex_solve

    sub_opts = SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device=options.device)
    sub_opts.presolve.enabled = False
    sub_opts.max_seconds = options.max_seconds

    deadline = None
    if options.max_seconds is not None:
        deadline = time.monotonic() + options.max_seconds

    prev: Optional[Solution] = None
    prev_rows: Optional[np.ndarray] = None
    prev_cols: Optional[np.ndarray] = None
    total_iters = 0

    for _ in range(max_passes):
        if deadline is not None and time.monotonic() > deadline:
            return None
        R = np.flatnonzero(row_keep)
        C = np.flatnonzero(col_keep)
        if R.size == 0 or C.size == 0:
            # degenerate seed; grow from scratch
            row_keep[:] = True
            col_keep[:] = True
            continue
        F = np.flatnonzero(col_fix)
        shift = (Ac[:, F] @ xfix_val[F])[R] if F.size else np.zeros(R.size)
        sub = Model()
        sub.load_problem(
            Ac[:, C].tocsr()[R].tocsc(),
            col_lower=cl[C],
            col_upper=cu[C],
            objective=model.objective[C],
            row_lower=np.where(rl[R] > -INF, rl[R] - shift, rl[R]),
            row_upper=np.where(ru[R] < INF, ru[R] - shift, ru[R]),
        )
        sub.optimization_direction = model.optimization_direction

        sub_warm = None
        if prev is not None and prev_rows is not None:
            # extend the previous optimal basis: carried rows/cols keep
            # their status, NEW rows enter with a basic slack and NEW
            # columns at a bound — still a valid square basis
            cs = np.full(C.size, int(VariableStatus.AT_LOWER), dtype=np.int8)
            cs[cl[C] <= -INF] = int(VariableStatus.FREE)
            up_only = (cl[C] <= -INF) & (cu[C] < INF)
            cs[up_only] = int(VariableStatus.AT_UPPER)
            rs = np.full(R.size, int(VariableStatus.BASIC), dtype=np.int8)
            cmap = {int(j): k for k, j in enumerate(prev_cols)}
            rmap = {int(i): k for k, i in enumerate(prev_rows)}
            for k, j in enumerate(C):
                p = cmap.get(int(j))
                if p is not None:
                    cs[k] = prev.column_status[p]
            for k, i in enumerate(R):
                p = rmap.get(int(i))
                if p is not None:
                    rs[k] = prev.row_status[p]
            sub_warm = Solution(column_status=cs, row_status=rs)
        else:
            # values pass: the PDHG primal point seeds the first basis
            sub_warm = Solution(primal=x0[C].copy())

        sol = simplex_solve(sub, sub_opts, dual=True, warm=sub_warm)
        if sol.status != ProblemStatus.OPTIMAL and sub_warm is not None:
            sol = simplex_solve(sub, sub_opts, dual=True, warm=None)
        total_iters += sol.iterations

        if sol.status == ProblemStatus.PRIMAL_INFEASIBLE:
            # over-fixing can manufacture infeasibility: release the fixed
            # columns most able to relax the violated rows (Farkas-weighted
            # when the ray is available, else widest-influence columns)
            if F.size == 0:
                return None  # genuinely infeasible sub on full columns
            ray = sol.infeasibility_ray
            if ray is not None and np.asarray(ray).size == R.size:
                w = AT[:, R] @ np.asarray(ray, dtype=np.float64)
                score = np.abs(w)
            else:
                score = np.abs(AT[:, R]) @ np.ones(R.size)
            score = np.where(col_fix, score, -np.inf)
            k = min(F.size, max(256, F.size // 4))
            rel = np.argpartition(-score, k - 1)[:k]
            col_fix[rel] = False
            col_keep[rel] = True
            prev = None  # basis frame changed too much
            continue
        if sol.status != ProblemStatus.OPTIMAL:
            return None

        # --- assemble the full-frame candidate and verify against the
        # FULL sparse data (O(nnz) matvecs) ---
        x = xfix_val.copy()
        x[~col_fix] = 0.0
        x[C] = sol.primal
        y = np.zeros(m)
        y[R] = np.asarray(sol.duals) * sense
        ax = A @ x
        d = c - AT @ y

        ptol = max(model.primal_tolerance, 1e-9) * (1.0 + np.abs(ax))
        vrow = ((rl - ax > ptol) | (ax - ru > ptol)) & ~row_keep
        dtol = max(model.dual_tolerance, 1e-9)
        bad_lo = col_fix & ok_lo & (d < -dtol)
        bad_hi = col_fix & ok_hi & (d > dtol)
        vcol = bad_lo | bad_hi

        if not vrow.any() and not vcol.any():
            from .validate import check_kkt

            # build the full basis frame for warm restarts downstream
            col_status = np.where(
                col_fix & ok_lo, int(VariableStatus.AT_LOWER),
                np.where(col_fix, int(VariableStatus.AT_UPPER),
                         int(VariableStatus.AT_LOWER)),
            ).astype(np.int8)
            col_status[C] = sol.column_status
            row_status = np.full(m, int(VariableStatus.BASIC), dtype=np.int8)
            row_status[R] = sol.row_status
            full = Solution(
                status=ProblemStatus.OPTIMAL,
                objective_value=float(model.objective @ x) + model.objective_offset,
                primal=x,
                duals=y * sense,
                reduced_costs=d * sense,
                row_activity=ax,
                iterations=total_iters,
                column_status=col_status,
                row_status=row_status,
            )
            rep = check_kkt(model, x=x, y=full.duals, tol=kkt_tol)
            if not rep.ok:
                return None  # never report an unverified OPTIMAL
            return full

        # grow the working set with every violation (capped per pass so the
        # sub-LP stays dense-engine sized) and re-solve warm
        vr = np.flatnonzero(vrow)
        if vr.size:
            viol = np.maximum(rl[vr] - ax[vr], ax[vr] - ru[vr])
            keep_n = min(vr.size, max(1024, m // 8))
            row_keep[vr[np.argsort(-viol)[:keep_n]]] = True
        vc = np.flatnonzero(vcol)
        if vc.size:
            keep_n = min(vc.size, max(1024, n // 8))
            worst = vc[np.argsort(-np.abs(d[vc]))[:keep_n]]
            col_fix[worst] = False
            col_keep[worst] = True
        prev, prev_rows, prev_cols = sol, R, C

    return None
