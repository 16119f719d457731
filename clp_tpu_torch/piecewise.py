"""Piecewise-linear convex objective costs.

The reference supports convex piecewise-linear costs per variable through
ClpNonLinearCost (ClpNonLinearCost.hpp:8-28) with through-bound
mini-iterations in primalRow (ClpSimplexPrimal.cpp:1874-1877: "we may need
a bucket approach when many variables go through bounds; on exit rhsArray
has changes in costs of basic variables").

Port of the JAX package's piecewise.py, a copy: both halves are numpy on
the host in the JAX package too, and a reformulated model solves through
`initial_solve` on `options.device`. Two implementations here:

  1. `set_piecewise_linear_cost` — the classical exact reformulation
     (one bounded segment variable per piece), which keeps the device
     kernels oblivious to cost shapes (fixed-shape friendly).
  2. `solve_piecewise` — the IN-ENGINE path (reference parity, no column
     expansion): a primal simplex whose pricing knows left/right slopes at
     kinks and whose ratio walk continues THROUGH breakpoints, updating
     basic costs mid-step (the mini-iteration), paying zero extra columns.
     Nonbasic variables may rest AT a kink (subgradient optimality
     slope_left <= y'a_j <= slope_right), exactly ClpNonLinearCost's
     state model.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp

from .constants import INF, ProblemStatus, VariableStatus
from .model import Model, Solution


@dataclasses.dataclass
class PiecewiseInfo:
    """Mapping to recover original-variable values after a solve."""

    column: int  # original column index
    segment_columns: list  # column indices of the segments (post-reform)
    breakpoints: np.ndarray
    slopes: np.ndarray


def set_piecewise_linear_cost(
    model: Model, column: int, breakpoints, slopes
) -> PiecewiseInfo:
    """Replace column's linear cost with a convex piecewise-linear one.

    breakpoints: ascending values b_0 < b_1 < ... < b_k covering the
      variable's domain (b_0 must equal the lower bound; b_k the upper, or
      +inf for an unbounded last piece).
    slopes: k slopes, one per piece [b_i, b_i+1], nondecreasing (convex).

    The column is rewritten in place: x_col is replaced by
      x = b_0 + sum_i s_i,  s_i in [0, b_{i+1} - b_i],  cost slope_i s_i.
    The first segment reuses the original column; extra segments are
    appended (same matrix column). Returns the mapping (original value =
    b_0 + sum of segment values).
    """
    b = np.asarray(breakpoints, dtype=np.float64)
    s = np.asarray(slopes, dtype=np.float64)
    if b.ndim != 1 or s.ndim != 1 or b.size != s.size + 1:
        raise ValueError("need k+1 breakpoints for k slopes")
    if np.any(np.diff(b) <= 0):
        raise ValueError("breakpoints must be strictly increasing")
    # the reformulation fills segments in order only when later segments
    # are less attractive: convex for minimization, concave for
    # maximization (= convex in the minimization sense)
    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0
    if np.any(np.diff(s * sense) < -1e-12):
        raise ValueError(
            "slopes must be nondecreasing in the minimization sense "
            "(convex cost; concave for a maximization model)")
    j = column
    lo, up = model.col_lower[j], model.col_upper[j]
    if abs(b[0] - lo) > 1e-9 * (1 + abs(lo)):
        raise ValueError("first breakpoint must equal the column lower bound")
    k = s.size

    col = model.matrix[:, j]
    # shift: x = b0 + sum s_i  =>  A x contributes A[:,j]*b0 to activities
    shift = np.asarray((col * b[0]).todense()).ravel()
    model.row_lower = np.where(model.row_lower > -INF, model.row_lower - shift, model.row_lower)
    model.row_upper = np.where(model.row_upper < INF, model.row_upper - shift, model.row_upper)
    model.objective_offset += 0.0  # cost measured from b0 with segment slopes

    # first segment reuses column j
    model.col_lower = model.col_lower.copy()
    model.col_upper = model.col_upper.copy()
    model.objective = model.objective.copy()
    model.col_lower[j] = 0.0
    model.col_upper[j] = b[1] - b[0]
    model.objective[j] = s[0]

    seg_cols = [j]
    if k > 1:
        extra = sp.hstack([col] * (k - 1), format="csc")
        widths = np.diff(b)[1:]
        uppers = np.where(np.isfinite(widths), widths, INF)
        start = model.num_cols
        model.add_columns(extra, lower=np.zeros(k - 1), upper=uppers, objective=s[1:])
        seg_cols += list(range(start, start + k - 1))
    return PiecewiseInfo(j, seg_cols, b, s)


def recover_piecewise_value(model: Model, info: PiecewiseInfo) -> float:
    """Original variable value = b_0 + sum of segment values."""
    x = model.solution.primal
    return float(info.breakpoints[0] + sum(x[c] for c in info.segment_columns))


# ---------------------------------------------------------------------------
# In-engine piecewise-linear costs (no column expansion)
# ---------------------------------------------------------------------------

_EPS = 1e-9
_PTOL = 1e-9
_DTOL2 = 1e-9

_PW_LO, _PW_UP, _PW_BASIC, _PW_KINK, _PW_FREE = 0, 1, 2, 3, 4


class _PwCosts:
    """Padded (nt, kmax) breakpoint/slope tables for ALL standard-form
    variables; linear variables have zero interior breakpoints."""

    def __init__(self, nt: int, c_lin: np.ndarray, pw: dict):
        kmax = max((len(s) - 1 for _, s in
                    ((np.asarray(b), np.asarray(s)) for b, s in pw.values())),
                   default=0)
        kmax = max(kmax, 1)
        self.brk = np.full((nt, kmax), np.inf)
        self.slp = np.tile(c_lin[:, None], (1, kmax + 1))
        self.base = np.zeros(nt)  # f(base_point) = 0 anchor per variable
        self.is_pw = np.zeros(nt, dtype=bool)
        for j, (b, s) in pw.items():
            b = np.asarray(b, dtype=float)
            s = np.asarray(s, dtype=float)
            inner = b[1:-1]  # b[0]/b[-1] are the domain bounds, not kinks
            self.brk[j, :inner.size] = inner
            self.slp[j, :s.size] = s
            self.slp[j, s.size:] = s[-1]
            self.base[j] = b[0]
            self.is_pw[j] = True

    def right_idx(self, v, t):
        return int(np.sum(self.brk[v] <= t + _EPS))

    def slope_right(self, v, t):
        return float(self.slp[v, self.right_idx(v, t)])

    def slope_left(self, v, t):
        return float(self.slp[v, int(np.sum(self.brk[v] < t - _EPS))])

    def slopes_at(self, x):
        """Vectorized (slope_left, slope_right) at the given values."""
        idx_r = np.sum(self.brk <= x[:, None] + _EPS, axis=1)
        idx_l = np.sum(self.brk < x[:, None] - _EPS, axis=1)
        rows = np.arange(x.size)
        return self.slp[rows, idx_l], self.slp[rows, idx_r]

    def next_break(self, v, t, up: bool):
        """Nearest interior breakpoint strictly beyond t in the direction."""
        b = self.brk[v]
        if up:
            cand = b[b > t + _EPS]
            return float(cand[0]) if cand.size else np.inf
        cand = b[np.isfinite(b) & (b < t - _EPS)]
        return float(cand[-1]) if cand.size else -np.inf

    def value(self, v, t):
        """Piecewise cost integrated from the anchor: f(anchor) = 0."""
        b = self.brk[v]
        fin = b[np.isfinite(b)]
        pts = np.concatenate([[self.base[v]], fin, [t]])
        pts = np.clip(pts, min(self.base[v], t), max(self.base[v], t))
        pts.sort()
        if t < self.base[v]:
            pts = pts[::-1]
        total = 0.0
        for a, bb in zip(pts[:-1], pts[1:]):
            mid = 0.5 * (a + bb)
            total += self.slp[v, int(np.sum(self.brk[v] <= mid))] * (bb - a)
        return total

    def total_value(self, cols, t) -> float:
        """sum(value(v, t_v) for v in cols), bit for bit: `value`'s
        arithmetic on all columns at once, each column's pieces and then
        the columns added in the same order. A padded (infinite) kink
        clips onto the end of the range and adds a zero-width piece,
        which adds +-0.0 to that column's total and leaves it unchanged.
        The JAX package calls `value` per column, which dominated the
        host solve."""
        if len(cols) == 0:
            return 0.0
        base, brk, slp = self.base[cols], self.brk[cols], self.slp[cols]
        t = np.asarray(t, dtype=np.float64)
        lo, hi = np.minimum(base, t), np.maximum(base, t)
        pts = np.clip(np.concatenate([base[:, None], brk, t[:, None]], axis=1),
                      lo[:, None], hi[:, None])
        pts.sort(axis=1)
        pts = np.where((t < base)[:, None], pts[:, ::-1], pts)
        a, bb = pts[:, :-1], pts[:, 1:]
        mid = 0.5 * (a + bb)
        idx = np.sum(brk[:, None, :] <= mid[:, :, None], axis=2)
        piece = np.take_along_axis(slp, idx, axis=1) * (bb - a)
        total = np.zeros(len(cols))
        for k in range(piece.shape[1]):
            total = total + piece[:, k]
        # plain left-to-right adds: Python's sum() of floats compensates
        return np.add.accumulate(total)[-1]


def solve_piecewise(
    model: Model,
    piecewise: dict,
    options=None,
) -> Solution:
    """Primal simplex with in-engine convex piecewise-linear costs.

    `piecewise` maps column index -> (breakpoints, slopes) with the same
    convention as `set_piecewise_linear_cost`: k+1 ascending breakpoints
    (first = domain lower bound), k nondecreasing slopes; the cost is
    measured from the first breakpoint (f(b0) = 0).  No columns are added:
    the engine's ratio walk continues through breakpoints, updating basic
    costs mid-step (ClpSimplexPrimal.cpp:1874 mini-iterations), and
    nonbasic variables may rest at kinks (ClpNonLinearCost state model).
    """
    from .events import Event, fire_event

    t0 = time.time()
    fire_event(model, Event.BEFORE_CREATE_NON_LINEAR,
               columns=sorted(piecewise))
    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0
    A = np.asarray(model.matrix.todense())
    m, n = A.shape
    nt = n + m
    G = np.concatenate([A, -np.eye(m)], axis=1)
    lo = np.concatenate([model.col_lower, model.row_lower]).astype(float)
    up = np.concatenate([model.col_upper, model.row_upper]).astype(float)
    lo = np.where(lo <= -INF, -np.inf, lo)
    up = np.where(up >= INF, np.inf, up)
    c_lin = np.concatenate([model.objective * sense, np.zeros(m)])

    pw = {}
    for j, (b, s) in piecewise.items():
        b = np.asarray(b, dtype=float)
        s = np.asarray(s, dtype=float) * sense
        if np.any(np.diff(b) <= 0):
            raise ValueError("breakpoints must be strictly increasing")
        if np.any(np.diff(s) < -1e-12):
            raise ValueError("slopes must be nondecreasing in the "
                             "minimization sense (convex cost)")
        # same contract as set_piecewise_linear_cost: the first breakpoint
        # IS the column's lower bound — silently relaxing a tighter model
        # bound would let the engine violate the stated domain
        if abs(b[0] - lo[j]) > 1e-9 * (1.0 + abs(b[0])):
            raise ValueError(
                f"first breakpoint {b[0]} must equal column {j}'s lower "
                f"bound {lo[j]}")
        lo[j] = b[0]
        if np.isfinite(b[-1]):
            up[j] = min(up[j], b[-1])
        pw[j] = (b, s)
        c_lin[j] = 0.0
    costs = _PwCosts(nt, c_lin, pw)
    pw_cols = np.flatnonzero(costs.is_pw)

    if np.any(lo > up + 1e-12):
        sol = Solution(status=ProblemStatus.PRIMAL_INFEASIBLE)
        model.solution = sol
        return sol

    # cold all-slack start
    stat = np.where(np.isfinite(lo), _PW_LO,
                    np.where(np.isfinite(up), _PW_UP, _PW_FREE)).astype(np.int8)
    x = np.where(stat == _PW_LO, lo, np.where(stat == _PW_UP, up, 0.0))
    basic = np.arange(n, nt)
    stat[basic] = _PW_BASIC
    in_basis = np.zeros(nt, dtype=bool)
    in_basis[basic] = True
    Binv = np.linalg.inv(G[:, basic])

    def recompute_basics():
        xnb = x.copy()
        xnb[basic] = 0.0
        x[basic] = Binv @ (-G @ xnb)

    recompute_basics()
    c_eff = c_lin.copy()
    sl_l, sl_r = costs.slopes_at(x)
    c_eff[:] = np.where(costs.is_pw, sl_r, c_eff)

    max_iterations = 200 * nt + 20000
    if options is not None and getattr(options, "max_iterations", None):
        max_iterations = int(options.max_iterations)

    status = ProblemStatus.UNKNOWN
    iters = 0
    ray = None
    stall = 0
    last_merit = np.inf
    bland = False

    while iters < max_iterations:
        infeas = float(
            np.sum(np.maximum(lo - x, 0.0), where=np.isfinite(lo))
            + np.sum(np.maximum(x - up, 0.0), where=np.isfinite(up)))
        phase1 = infeas > _PTOL * (1.0 + np.abs(x).max(initial=0.0))
        if phase1:
            cb = np.where(x < lo - _PTOL, -1.0,
                          np.where(x > up + _PTOL, 1.0, 0.0))[basic]
        else:
            # basic effective costs: slope of the CURRENT segment
            sl_l, sl_r = costs.slopes_at(x)
            c_eff = np.where(costs.is_pw, sl_r, c_lin)
            cb = c_eff[basic]
        y = Binv.T @ cb
        w = G.T @ y

        # pricing with left/right slopes (kinks included)
        if phase1:
            d_r = -w
            d_l = -w
        else:
            d_l = sl_l - w  # gain of decreasing = -d_l
            d_r = sl_r - w  # gain of increasing = d_r
            d_l = np.where(costs.is_pw, d_l, c_lin - w)
            d_r = np.where(costs.is_pw, d_r, c_lin - w)
        can_up = ~in_basis & (x < up - _PTOL)
        can_dn = ~in_basis & (x > lo + _PTOL)
        gain = np.maximum(np.where(can_up, -d_r, 0.0),
                          np.where(can_dn, d_l, 0.0))
        dtol = _DTOL2 * (1.0 + np.abs(cb).max(initial=0.0))
        if bland:
            elig = np.flatnonzero(gain > dtol)
            q = int(elig[0]) if elig.size else -1
        else:
            q = int(np.argmax(gain))
            if gain[q] <= dtol:
                q = -1
        if q < 0:
            status = (ProblemStatus.PRIMAL_INFEASIBLE if phase1
                      else ProblemStatus.OPTIMAL)
            break
        sigma = 1.0 if (can_up[q] and -d_r[q] >= (d_l[q] if can_dn[q] else -np.inf)) else -1.0
        D = d_r[q] if sigma > 0 else -d_l[q]  # directional dj, < 0

        abar = Binv @ G[:, q]
        dxb = -sigma * abar

        # --- ratio walk with through-breakpoint mini-iterations ---
        t_done = 0.0
        xq = float(x[q])
        pivoted = False
        walk_guard = 4 * (costs.brk.shape[1] + 1) * (m + 1) + 16
        for _walk in range(walk_guard):
            # next event per moving basic: breakpoint (phase 2) or bound
            t_best = np.inf
            r_best, ev = -1, None
            moving = np.abs(dxb) > 1e-11
            for r in np.flatnonzero(moving):
                v = int(basic[r])
                d = dxb[r]
                if d > 0:
                    bnd = up[v]
                    brk_pt = costs.next_break(v, x[v], True) if (
                        not phase1 and costs.is_pw[v]) else np.inf
                    pt = min(bnd, brk_pt)
                    tt = (pt - x[v]) / d if np.isfinite(pt) else np.inf
                else:
                    bnd = lo[v]
                    brk_pt = costs.next_break(v, x[v], False) if (
                        not phase1 and costs.is_pw[v]) else -np.inf
                    pt = max(bnd, brk_pt)
                    tt = (x[v] - pt) / (-d) if np.isfinite(pt) else np.inf
                if phase1:
                    # infeasible basics block at the violated bound only
                    # when moving toward it; never when moving away
                    if x[v] < lo[v] - _PTOL:
                        tt = (lo[v] - x[v]) / d if d > 0 else np.inf
                        pt = lo[v]
                    elif x[v] > up[v] + _PTOL:
                        tt = (x[v] - up[v]) / (-d) if d < 0 else np.inf
                        pt = up[v]
                tt = max(tt, 0.0)
                if tt < t_best - 1e-12 or (
                        tt <= t_best + 1e-12 and r_best >= 0
                        and abs(abar[r]) > abs(abar[r_best])):
                    t_best, r_best = tt, r
                    is_brk = (not phase1 and costs.is_pw[v]
                              and np.isfinite(pt)
                              and (abs(pt - up[v]) > _EPS if d > 0
                                   else abs(pt - lo[v]) > _EPS))
                    ev = ("basic_brk" if is_brk else "basic_bnd", pt)
            # entering's own next breakpoint / bound
            if sigma > 0:
                own_bnd = up[q]
                own_brk = costs.next_break(q, xq, True) if (
                    not phase1 and costs.is_pw[q]) else np.inf
                own_pt = min(own_bnd, own_brk)
                t_own = own_pt - xq if np.isfinite(own_pt) else np.inf
                own_is_brk = own_brk < own_bnd - _EPS
            else:
                own_bnd = lo[q]
                own_brk = costs.next_break(q, xq, False) if (
                    not phase1 and costs.is_pw[q]) else -np.inf
                own_pt = max(own_bnd, own_brk)
                t_own = xq - own_pt if np.isfinite(own_pt) else np.inf
                own_is_brk = own_brk > own_bnd + _EPS
            t_own = max(t_own, 0.0)

            t_step = min(t_best, t_own)
            if not np.isfinite(t_step):
                status = ProblemStatus.DUAL_INFEASIBLE
                ray = np.zeros(nt)
                ray[q] = sigma
                ray[basic] = dxb
                break
            # advance
            xq += sigma * t_step
            x[basic] += t_step * dxb
            t_done += t_step

            if t_own <= t_best + 1e-12:
                if own_is_brk:
                    # entering crosses ITS OWN kink: directional slope grows
                    new_slope = (costs.slope_right(q, xq + _EPS) if sigma > 0
                                 else costs.slope_left(q, xq - _EPS))
                    D = sigma * new_slope - sigma * w[q]
                    if D < -dtol:
                        continue  # still profitable: walk on
                    stat[q] = _PW_KINK  # rest at the kink: subgradient opt
                    x[q] = xq
                    break
                # own bound: flip, no basis change
                x[q] = own_pt
                stat[q] = _PW_UP if sigma > 0 else _PW_LO
                break
            # a basic blocks
            v = int(basic[r_best])
            pt = ev[1]
            if ev[0] == "basic_brk":
                # mini-iteration: crossing changes c_B[r]; dj_q degrades by
                # delta * dxb_r (convexity: always toward 0)
                going_up = dxb[r_best] > 0
                old_s = c_eff[v]
                new_s = (costs.slope_right(v, pt + _EPS) if going_up
                         else costs.slope_left(v, pt - _EPS))
                delta = new_s - old_s
                D_new = D + delta * dxb[r_best] * 1.0
                x[v] = pt  # exact landing
                if D_new < -dtol:
                    c_eff[v] = new_s
                    w[q] += delta * abar[r_best]
                    D = D_new
                    continue  # keep walking through the kink
                # pivot: v leaves resting AT its kink
                stat[v] = _PW_KINK
            else:
                # status by WHICH bound was reached, not by direction: a
                # phase-1 basic can reach its lower bound moving UP (from
                # below) or its upper bound moving DOWN (from above)
                x[v] = pt
                stat[v] = (_PW_UP if (np.isfinite(up[v]) and pt == up[v])
                           else _PW_LO)
            piv = abar[r_best]
            if abs(piv) < 1e-11:
                Binv = np.linalg.inv(G[:, basic])
                break
            in_basis[v] = False
            basic[r_best] = q
            in_basis[q] = True
            stat[q] = _PW_BASIC
            x[q] = xq
            er = np.zeros(m)
            er[r_best] = 1.0
            Binv -= np.outer((abar - er) / piv, Binv[r_best])
            pivoted = True
            break
        else:
            status = ProblemStatus.STOPPED
            break
        if status in (ProblemStatus.DUAL_INFEASIBLE, ProblemStatus.STOPPED):
            break

        iters += 1
        if pivoted and iters % 60 == 0:
            Binv = np.linalg.inv(G[:, basic])
            recompute_basics()

        merit = infeas if phase1 else float(
            costs.total_value(pw_cols, x[pw_cols])
            + c_lin @ np.where(costs.is_pw, 0.0, x))
        if merit < last_merit - 1e-12 * (1.0 + abs(last_merit)):
            stall = 0
            bland = False
        else:
            stall += 1
            if stall > 2 * nt + 100:
                bland = True
        last_merit = merit
    else:
        status = ProblemStatus.STOPPED

    # final objective: piecewise values + linear part, user sense
    obj_min = float(costs.total_value(pw_cols, x[pw_cols]))
    lin_mask = ~costs.is_pw[:n]
    obj_min += float(c_lin[:n][lin_mask] @ x[:n][lin_mask])
    obj = obj_min * (1.0 if sense > 0 else -1.0) + model.objective_offset

    sl_l, sl_r = costs.slopes_at(x)
    cb = np.where(costs.is_pw, sl_r, c_lin)[basic]
    y = Binv.T @ cb
    dj = np.where(costs.is_pw, sl_r, c_lin) - G.T @ y
    smap = {_PW_LO: VariableStatus.AT_LOWER, _PW_UP: VariableStatus.AT_UPPER,
            _PW_BASIC: VariableStatus.BASIC,
            _PW_KINK: VariableStatus.SUPER_BASIC,
            _PW_FREE: VariableStatus.FREE}
    sol = Solution(
        status=status,
        objective_value=obj,
        primal=x[:n].copy(),
        duals=y * sense,
        reduced_costs=dj[:n] * sense,
        row_activity=model.matrix @ x[:n],
        iterations=iters,
        column_status=np.array([int(smap[s]) for s in stat[:n]], dtype=np.int8),
        row_status=np.array([int(smap[s]) for s in stat[n:]], dtype=np.int8),
    )
    if ray is not None:
        sol.unbounded_ray = ray[:n]
    sol.solve_time = time.time() - t0
    model.solution = sol
    fire_event(model, Event.AFTER_CREATE_NON_LINEAR, status=status)
    return sol
