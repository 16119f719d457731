"""Post-optimal analysis: ranging, parametrics, the explicit LP dual and
the IIS.

Port of the JAX package's analysis.py (reference: ClpSimplexOther
dualRanging / primalRanging (:50 / :770), parametrics (:2554+),
dualOfModel / restoreFromDual (:1681 / :1397); examples/iis.cpp).
Ranging and the parametric walker run as f64 tensor ops on the caller's
device; `dualize`, `restore_from_dual` and the IIS's bookkeeping are
host-side numpy around the solvers. AUTOMATIC solves very tall LPs through
their dual (solve.initial_solve); the IIS deletion filter runs its trials
through the batched dual simplex.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .constants import INF, ProblemStatus, VariableStatus
from .device import default_device, resolve_device
from .model import Model, Solution

_F64 = torch.float64
# f64 elements of one (block, nt) slab of B^-1 G in `ranging` (128 MiB)
_RANGING_BLOCK_ELEMS = 1 << 24


def _basis_data(model: Model, dev: torch.device):
    """Standard-form arrays and the basis partition of the solution, on
    `dev`: G = [A | -I], c, l, u (tensors), the statuses and the basic
    indices (host numpy), one LU of B, x and the reduced costs."""
    sol = model.solution
    if sol.column_status is None:
        raise ValueError("ranging needs a basic solution (solve with simplex first)")
    m, n = model.matrix.shape
    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0
    A = torch.as_tensor(model.matrix.toarray(), dtype=_F64, device=dev)
    G = torch.cat([A, -torch.eye(m, dtype=_F64, device=dev)], dim=1)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    c = t(np.concatenate([model.objective * sense, np.zeros(m)]))
    l = t(np.concatenate([model.col_lower, model.row_lower]))
    u = t(np.concatenate([model.col_upper, model.row_upper]))
    stat = np.concatenate([sol.column_status, sol.row_status]).astype(np.int64)
    basic = np.flatnonzero(stat == int(VariableStatus.BASIC))
    if basic.size != m:
        raise ValueError(f"basis has {basic.size} != {m} members")
    basic_t = torch.as_tensor(basic, device=dev)
    # like scipy's lu_factor, a singular B is not an error here: its
    # solves carry the infinities
    LU, piv, _ = torch.linalg.lu_factor_ex(G.index_select(1, basic_t))
    x = t(np.concatenate([sol.primal, sol.row_activity]))
    y = torch.linalg.lu_solve(LU, piv, c[basic_t][:, None], adjoint=True)[:, 0]
    dj = c - y @ G
    return G, c, l, u, stat, basic, (LU, piv), x, dj, sense


@dataclasses.dataclass
class RangingResult:
    """Per-column cost ranges and per-row RHS ranges preserving the basis."""

    cost_down: np.ndarray  # (n,) lowest c_j keeping basis optimal
    cost_up: np.ndarray  # (n,)
    rhs_down: np.ndarray  # (m,) lowest rhs keeping basis feasible
    rhs_up: np.ndarray  # (m,)


def _unit_columns(rows: np.ndarray, m: int, dev) -> torch.Tensor:
    E = torch.zeros(m, rows.size, dtype=_F64, device=dev)
    E[torch.as_tensor(rows, device=dev), torch.arange(rows.size, device=dev)] = 1.0
    return E


def ranging(model: Model, dual_tol: float = 1e-9,
            device: Optional[str] = None) -> RangingResult:
    """Cost (dual) and RHS (primal) ranging at the optimal basis.

    Reference behavior: ClpSimplexOther::dualRanging/primalRanging with
    exact expected values tested in unitTest.cpp:1609-1698. The JAX
    package's loops (one BTRAN and one tableau row per basic structural,
    one FTRAN per nonbasic slack, then a scan per row) run here as f64
    tensor ops on `device` (default `device.default_device()`): one LU of
    B, the tableau rows B^-1 G of the basic structurals and the columns
    B^-1 e_i of the nonbasic slacks in blocks of rows, and masked min / max
    reductions with the loops' cases. Min and max are exact, so the ranges
    differ from the loops' only by the LU's last bits.

    One difference from the JAX package is kept on purpose: a nonbasic
    variable with equal bounds (a fixed column, or the slack of an equality
    row) cannot move, so the sign of its reduced cost never decides
    optimality. It takes no part in the ratios of the basic columns' cost
    ranges, and a fixed nonbasic column's cost may move without limit. The
    JAX loops count it (clp_tpu/analysis.py:78-93), which on an LP with
    equality rows gives basic columns inverted ranges (cost_up < c_j); the
    parametric walker of both packages already leaves it out (`lo != up`).
    """
    dev = resolve_device(device if device is not None else default_device())
    G, c, l, u, stat, basic, (LU, piv), x, dj, sense = _basis_data(model, dev)
    m, nt = G.shape
    n = model.num_cols
    BASIC = int(VariableStatus.BASIC)
    stat_t = torch.as_tensor(stat, device=dev)
    # nonbasic and able to move: a variable with equal bounds cannot
    nonbasic = (stat_t != BASIC) & (l != u)
    at_lo = nonbasic & ((stat_t == int(VariableStatus.AT_LOWER))
                        | (stat_t == int(VariableStatus.FIXED)))
    at_up = nonbasic & (stat_t == int(VariableStatus.AT_UPPER))
    block = max(1, _RANGING_BLOCK_ELEMS // max(nt, m))
    inf = torch.tensor(np.inf, dtype=_F64, device=dev)

    # cost ranging of basic structurals: row r of B^-1 G over the nonbasics;
    # a move delta of c_j shifts dj_k by -delta * alpha_k
    rows = np.flatnonzero(basic < n)
    down_b = torch.empty(rows.size, dtype=_F64, device=dev)
    up_b = torch.empty(rows.size, dtype=_F64, device=dev)
    for s in range(0, rows.size, block):
        blk = rows[s:s + block]
        rho = torch.linalg.lu_solve(LU, piv, _unit_columns(blk, m, dev), adjoint=True)
        alpha = rho.mT @ G  # (b, nt)
        ok = alpha.abs() >= 1e-11
        bound = dj / alpha
        pos, neg = ok & (alpha > 0), ok & (alpha < 0)
        up_b[s:s + blk.size] = torch.where((at_lo & pos) | (at_up & neg),
                                           bound, inf).amin(dim=1)
        down_b[s:s + blk.size] = torch.where((at_lo & neg) | (at_up & pos),
                                             bound, -inf).amax(dim=1)
    js = torch.as_tensor(basic[rows], device=dev)
    cost_down_b = (c[js] + down_b).cpu().numpy()
    cost_up_b = (c[js] + up_b).cpu().numpy()

    # RHS ranging: how far both row bounds can shift together keeping the
    # basis primal feasible. A nonbasic slack moves with the shift:
    # xB' = xB + delta * w, w = B^-1 e_i (the slack column is -e_i)
    slack_nb = np.flatnonzero(stat[n:] != BASIC)
    basic_t = torch.as_tensor(basic, device=dev)
    xb, lb, ub = x[basic_t], l[basic_t], u[basic_t]
    gap_up = torch.where(ub < INF, ub - xb, inf)[:, None]
    gap_dn = torch.where(lb > -INF, xb - lb, inf)[:, None]
    rdown_nb = torch.empty(slack_nb.size, dtype=_F64, device=dev)
    rup_nb = torch.empty(slack_nb.size, dtype=_F64, device=dev)
    block_r = max(1, _RANGING_BLOCK_ELEMS // max(m, 1))
    for s in range(0, slack_nb.size, block_r):
        blk = slack_nb[s:s + block_r]
        W = torch.linalg.lu_solve(LU, piv, _unit_columns(blk, m, dev))  # (m, b)
        ok = W.abs() >= 1e-11
        pos, neg = ok & (W > 0), ok & (W < 0)
        up_c = torch.where(pos, gap_up / W, torch.where(neg, gap_dn / -W, inf))
        dn_c = torch.where(pos, -gap_dn / W, torch.where(neg, -gap_up / -W, -inf))
        rup_nb[s:s + blk.size] = up_c.amin(dim=0)
        rdown_nb[s:s + blk.size] = dn_c.amax(dim=0)

    # the host half: nonbasic structurals, basic slacks, the user's sense
    djh = dj.cpu().numpy()
    ch = c.cpu().numpy()
    cost_down = np.full(n, -np.inf)
    cost_up = np.full(n, np.inf)
    cost_down[basic[rows]] = cost_down_b
    cost_up[basic[rows]] = cost_up_b
    nbs = np.flatnonzero((stat[:n] != BASIC) & (model.col_lower != model.col_upper))
    at_upper = stat[nbs] == int(VariableStatus.AT_UPPER)
    # at upper (dj <= 0): c_j may rise by -dj, fall without limit; at
    # lower (dj >= 0): c_j may fall by dj, rise without limit; a fixed
    # nonbasic column's cost moves without limit (the defaults above)
    cost_down[nbs] = np.where(at_upper, -np.inf, ch[nbs] - djh[nbs])
    cost_up[nbs] = np.where(at_upper, ch[nbs] - djh[nbs], np.inf)
    if sense < 0:
        cost_down, cost_up = -cost_up, -cost_down

    rhs_down = np.full(m, -np.inf)
    rhs_up = np.full(m, np.inf)
    rhs_down[slack_nb] = rdown_nb.cpu().numpy()
    rhs_up[slack_nb] = rup_nb.cpu().numpy()
    # non-binding rows: bounds can move until they reach the activity
    bs = np.flatnonzero(stat[n:] == BASIC)
    s_act = np.asarray(model.solution.row_activity, dtype=np.float64)
    rl, ru = model.row_lower, model.row_upper
    rhs_down[bs] = np.where(ru[bs] < INF, s_act[bs] - ru[bs], -np.inf)
    rhs_up[bs] = np.where(rl[bs] > -INF, s_act[bs] - rl[bs], np.inf)
    return RangingResult(cost_down, cost_up, rhs_down, rhs_up)


@dataclasses.dataclass
class ParametricsResult:
    """Exact homotopy output: every basis-change breakpoint in theta."""

    thetas: list  # breakpoint thetas (0 and theta_reached included)
    objectives: list  # objective value at each theta
    pivots: int  # total basis changes walked
    theta_reached: float  # == theta_end unless the LP left the feasible/
    #                        bounded region earlier
    status: ProblemStatus  # OPTIMAL if theta_end reached; PRIMAL_INFEASIBLE
    #                        / DUAL_INFEASIBLE if the homotopy hit the wall
    solution: object = None  # Solution at theta_reached (model.solution is
    #                          left at theta=0 — the model data is theta=0)

    def points(self) -> list[tuple[float, float]]:
        return list(zip(self.thetas, self.objectives))


def parametrics_exact(
    model: Model,
    theta_end: float,
    dc: Optional[np.ndarray] = None,
    d_row_lower: Optional[np.ndarray] = None,
    d_row_upper: Optional[np.ndarray] = None,
    d_col_lower: Optional[np.ndarray] = None,
    d_col_upper: Optional[np.ndarray] = None,
    tol: float = 1e-9,
    max_pivots: int = 0,
    device: Optional[str] = None,
) -> ParametricsResult:
    """Pivot-level parametric simplex — the nextTheta semantics
    (ClpSimplexOther::nextTheta, ClpSimplexOther.cpp:5148).

    From the optimal basis at theta=0, primal values and reduced costs are
    LINEAR in theta within a basis: the exact next breakpoint is the
    smallest theta where either a basic variable meets a (possibly moving)
    bound (then one DUAL pivot restores feasibility) or a nonbasic reduced
    cost crosses zero (then one PRIMAL pivot restores optimality).  Cost
    O(#basis changes) pivots total — no re-solves, no bisection — and the
    breakpoint list is exact.

    Row-bound changes are slack-bound changes in the standard form
    [A | -I]v = 0, so rhs parametrics and bound parametrics share one code
    path.  Stops early (status reports which wall) when the LP goes primal
    infeasible (no dual-eligible entering column) or unbounded (no primal
    blocker) at some theta < theta_end.

    The walker is the JAX package's, step for step; its vectors, B^-1 and
    the m x m update of each pivot are f64 tensors on `device` (default
    `device.default_device()`), and each step reads its few scalars from
    the device in one or two transfers. The objective at each breakpoint
    is read once, at the end.
    """
    from .constants import SolveMethod
    from .events import Event, fire_event
    from .options import SolveOptions

    dev = resolve_device(device if device is not None else default_device())
    if model.solution is None or model.solution.column_status is None:
        opts = SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device=str(dev))
        opts.presolve.enabled = False
        model.initial_solve(opts)
    G, c0, l0, u0, stat_h, basic, _lu, x, dj, sense = _basis_data(model, dev)
    m, nt = G.shape
    n = model.num_cols
    x = x.clone()
    l0h = np.concatenate([model.col_lower, model.row_lower])
    u0h = np.concatenate([model.col_upper, model.row_upper])

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    # per-unit-theta changes in standard form (only finite bounds move)
    dcost = np.zeros(nt)
    if dc is not None:
        dcost[:n] = np.asarray(dc, dtype=float) * sense
    dl = np.zeros(nt)
    du = np.zeros(nt)
    if d_col_lower is not None:
        dl[:n] = np.where(l0h[:n] > -INF, np.asarray(d_col_lower, float), 0.0)
    if d_col_upper is not None:
        du[:n] = np.where(u0h[:n] < INF, np.asarray(d_col_upper, float), 0.0)
    if d_row_lower is not None:
        dl[n:] = np.where(l0h[n:] > -INF, np.asarray(d_row_lower, float), 0.0)
    if d_row_upper is not None:
        du[n:] = np.where(u0h[n:] < INF, np.asarray(d_row_upper, float), 0.0)
    dcost, dl, du = t(dcost), t(dl), t(du)
    lo = torch.where(l0 <= -INF, -np.inf, l0)
    up = torch.where(u0 >= INF, np.inf, u0)
    fixed_range = lo == up

    basic = basic.copy()
    basic_t = torch.as_tensor(basic, device=dev)
    Binv = torch.linalg.inv(G.index_select(1, basic_t))
    BASIC, AT_LO, AT_UP = (int(VariableStatus.BASIC),
                           int(VariableStatus.AT_LOWER),
                           int(VariableStatus.AT_UPPER))
    FIXED, FREE = int(VariableStatus.FIXED), int(VariableStatus.SUPER_BASIC)
    FREE0 = int(VariableStatus.FREE)
    at_lo_codes = (AT_LO, FIXED)
    stat_h = stat_h.copy()
    stat = torch.as_tensor(stat_h, device=dev)
    in_basis = torch.zeros(nt, dtype=torch.bool, device=dev)
    in_basis[basic_t] = True

    def set_stat(j: int, code: int) -> None:
        stat_h[j] = code
        stat[j] = code

    if max_pivots <= 0:
        max_pivots = 50 * (m + nt) + 10000

    theta = 0.0
    pivots = 0
    zero_steps = 0
    status = ProblemStatus.OPTIMAL
    thetas: list[float] = []
    objs: list = []  # 0-dim device tensors until the end
    offset = model.objective_offset * sense
    sign = 1.0 if sense > 0 else -1.0

    def objective():
        return (((c0 + theta * dcost) @ x) + offset) * sign

    def record():
        thetas.append(theta)
        objs.append(objective())

    def refresh_basics():
        """Recompute basic values/duals/djs exactly at the current theta."""
        nonlocal x, dj
        xnb = x.clone()
        xnb[basic_t] = 0.0
        x[basic_t] = Binv @ (-(G @ xnb))
        c_now = c0 + theta * dcost
        y = Binv.mT @ c_now[basic_t]
        dj = c_now - G.mT @ y

    def is_lo(s):
        return (s == AT_LO) | (s == FIXED)

    def is_free(s):
        return (s == FREE) | (s == FREE0)

    def at_bound(j: int, to_upper: bool):
        # a leaving variable's value at its (moving) bound
        return up[j] + theta * du[j] if to_upper else lo[j] + theta * dl[j]

    def rank1(Binv, abar, r: int, piv: float):
        v = abar.clone()
        v[r] -= 1.0
        return Binv - torch.outer(v / piv, Binv[r])

    inf = float("inf")
    refresh_basics()
    record()

    while theta < theta_end - 1e-15 and pivots < max_pivots:
        # --- linear rates within the current basis ---
        nb = ~in_basis
        vel = torch.where(nb & is_lo(stat), dl,
                          torch.where(nb & (stat == AT_UP), du, 0.0))
        w = -(Binv @ (G @ vel))  # d x_B / d theta
        y_rate = Binv.mT @ dcost[basic_t]
        dj_rate = dcost - G.mT @ y_rate

        # primal wall: basic i meets its (moving) bound
        xb = x[basic_t]
        lb = lo[basic_t] + theta * dl[basic_t]
        ub_ = up[basic_t] + theta * du[basic_t]
        rate_lo = w - dl[basic_t]  # d(x - l)/d theta
        rate_up = w - du[basic_t]  # d(x - u)/d theta
        gap_lo = xb - lb
        gap_up = ub_ - xb
        t_lo = torch.where((rate_lo < -tol) & torch.isfinite(gap_lo),
                           gap_lo.clamp_min(0.0) / (-rate_lo), inf)
        t_up = torch.where((rate_up > tol) & torch.isfinite(gap_up),
                           gap_up.clamp_min(0.0) / rate_up, inf)
        t_primal = torch.minimum(t_lo, t_up)

        # dual wall: nonbasic k's dj crosses zero against its status
        lo_cross = torch.where(nb & is_lo(stat) & ~fixed_range & (dj_rate < -tol),
                               dj.clamp_min(0.0) / (-dj_rate), inf)
        up_cross = torch.where(nb & (stat == AT_UP) & ~fixed_range & (dj_rate > tol),
                               (-dj).clamp_min(0.0) / dj_rate, inf)
        fr_cross = torch.where(nb & is_free(stat) & (dj_rate.abs() > tol),
                               dj.abs() / dj_rate.abs().clamp_min(tol), inf)
        t_dual = torch.minimum(torch.minimum(lo_cross, up_cross), fr_cross)
        kq_t = torch.argmin(t_dual)
        if m:
            rp_t = torch.argmin(t_primal)
            head = torch.stack([rp_t.to(_F64), t_primal[rp_t], t_lo[rp_t],
                                t_up[rp_t], kq_t.to(_F64), t_dual[kq_t]])
            rp_f, tp, tlo_rp, tup_rp, kq_f, td = head.tolist()
            rp = int(rp_f)
        else:
            rp, tp, tlo_rp, tup_rp = -1, inf, inf, inf
            kq_f, td = torch.stack([kq_t.to(_F64), t_dual[kq_t]]).tolist()
        kq = int(kq_f)

        t_star = min(tp, td, theta_end - theta)
        if t_star > 0:
            zero_steps = 0
            theta += t_star
            x[basic_t] = x[basic_t] + t_star * w
            x = x + t_star * (vel * nb)  # nonbasics ride their moving bounds
            dj = dj + t_star * dj_rate
        else:
            zero_steps += 1
            if zero_steps > m + nt + 100:
                status = ProblemStatus.STOPPED  # degenerate cycling guard
                break
        if theta >= theta_end - 1e-15:
            break

        if tp <= min(td, theta_end):  # includes tie: prefer the dual pivot
            # --- basic leaves at a bound: one dual pivot ---
            to_lower = tlo_rp <= tup_rp
            leave = int(basic[rp])
            alpha = Binv[rp] @ G
            alpha[basic_t] = 0.0
            direction = 1.0 if to_lower else -1.0
            # entering must keep dual feasibility: standard dual ratio test
            aa = direction * alpha
            elig = ((nb & is_lo(stat) & ~fixed_range & (aa < -tol))
                    | (nb & (stat == AT_UP) & ~fixed_range & (aa > tol))
                    | (nb & is_free(stat) & (aa.abs() > tol)))
            ratio = torch.where(elig, dj.abs() / alpha.abs(), inf)
            # largest |alpha| among near-ties for stability
            near = elig & (ratio <= ratio.min() + 1e-10)
            q_t = torch.argmax(torch.where(near, alpha.abs(), -inf))
            abar = Binv @ G.index_select(1, q_t.reshape(1))[:, 0]
            any_f, q_f, piv = torch.stack(
                [elig.any().to(_F64), q_t.to(_F64), abar[rp]]).tolist()
            if not any_f:
                status = ProblemStatus.PRIMAL_INFEASIBLE
                break
            q = int(q_f)
            if abs(piv) < 1e-11:
                status = ProblemStatus.STOPPED
                break
            set_stat(leave, AT_LO if to_lower else AT_UP)
            in_basis[leave] = False
            x[leave] = at_bound(leave, not to_lower)
            basic[rp] = q
            basic_t[rp] = q
            in_basis[q] = True
            set_stat(q, BASIC)
            Binv = rank1(Binv, abar, rp, piv)
            pivots += 1
        else:
            # --- nonbasic dj hits zero: one primal pivot ---
            q = kq
            sq = int(stat_h[q])
            if sq in (FREE, FREE0):
                sigma_t = torch.where(dj[q] < 0, 1.0, -1.0).to(_F64)
            else:
                sigma_t = torch.tensor(1.0 if sq in at_lo_codes else -1.0,
                                       dtype=_F64, device=dev)
            abar = Binv @ G[:, q]
            dxb = -sigma_t * abar
            lb = lo[basic_t] + theta * dl[basic_t]
            ub_ = up[basic_t] + theta * du[basic_t]
            xb = x[basic_t]
            r_up = torch.where(dxb > tol, (ub_ - xb) / dxb, inf)
            r_dn = torch.where(dxb < -tol, (xb - lb) / (-dxb), inf)
            r_all = torch.minimum(r_up.clamp_min(0.0), r_dn.clamp_min(0.0))
            t_own_t = up[q] - lo[q] + theta * (du[q] - dl[q])
            if m:
                rr_t = torch.argmin(r_all)
                rr_f, t_blk, t_own, piv, dxb_rr, sigma = torch.stack(
                    [rr_t.to(_F64), r_all[rr_t], t_own_t, abar[rr_t], dxb[rr_t],
                     sigma_t]).tolist()
                rr = int(rr_f)
            else:
                rr, t_blk, piv, dxb_rr = -1, inf, 0.0, 0.0
                t_own, sigma = torch.stack([t_own_t, sigma_t]).tolist()
            if not np.isfinite(min(t_blk, t_own)):
                status = ProblemStatus.DUAL_INFEASIBLE
                break
            if t_own <= t_blk:  # bound flip
                x[q] += sigma * t_own
                x[basic_t] = x[basic_t] + t_own * dxb
                set_stat(q, AT_UP if sigma > 0 else AT_LO)
            else:
                if abs(piv) < 1e-11:
                    # bail BEFORE mutating statuses/values: the current
                    # basis stays internally consistent for the report
                    status = ProblemStatus.STOPPED
                    break
                leave = int(basic[rr])
                went_up = dxb_rr > 0
                x[q] += sigma * t_blk
                x[basic_t] = x[basic_t] + t_blk * dxb
                set_stat(leave, AT_UP if went_up else AT_LO)
                in_basis[leave] = False
                x[leave] = at_bound(leave, went_up)
                basic[rr] = q
                basic_t[rr] = q
                in_basis[q] = True
                set_stat(q, BASIC)
                Binv = rank1(Binv, abar, rr, piv)
            pivots += 1

        if pivots % 50 == 0:
            Binv = torch.linalg.inv(G.index_select(1, basic_t))
        refresh_basics()
        record()
        fire_event(model, Event.THETA, theta=theta, pivots=pivots)

    # exact values at the final theta
    refresh_basics()
    if not thetas or abs(thetas[-1] - theta) > 1e-15:
        record()
    else:
        objs[-1] = objective()
    objs = torch.stack(objs).tolist()

    c_now = c0 + theta * dcost
    xh = x[:n].cpu().numpy()
    sol = Solution(
        # optimal AT theta_reached — except when the walk stalled
        # (degenerate cycling guard / tiny pivot), where optimality at
        # the final theta is NOT established
        status=(ProblemStatus.STOPPED if status == ProblemStatus.STOPPED
                else ProblemStatus.OPTIMAL),
        objective_value=objs[-1],
        primal=xh * 1.0,
        duals=(Binv.mT @ c_now[basic_t]).cpu().numpy() * sense,
        reduced_costs=dj[:n].cpu().numpy() * sense,
        row_activity=model.matrix @ xh,
        iterations=pivots,
        column_status=stat_h[:n].astype(np.int8),
        row_status=stat_h[n:].astype(np.int8),
    )
    if status == ProblemStatus.OPTIMAL:
        fire_event(model, Event.NO_THETA, theta=theta)  # end: no more pivots
    return ParametricsResult(
        thetas=thetas, objectives=objs, pivots=pivots,
        theta_reached=theta, status=status, solution=sol,
    )


def parametrics(
    model: Model,
    theta_end: float,
    dc: Optional[np.ndarray] = None,
    d_row_lower: Optional[np.ndarray] = None,
    d_row_upper: Optional[np.ndarray] = None,
    d_col_lower: Optional[np.ndarray] = None,
    d_col_upper: Optional[np.ndarray] = None,
    max_points: int = 64,
    tol: float = 1e-9,
    device: Optional[str] = None,
) -> list[tuple[float, float]]:
    """Objective/rhs/bound homotopy in theta over [0, theta_end].

    Returns the EXACT (theta, objective) breakpoint list (endpoint
    included) from the pivot-level walker `parametrics_exact` — the
    nextTheta semantics of ClpSimplexOther::parametrics (:2554, :5148).
    Falls back to adaptive-bisection re-solves if the walker stalls
    numerically (degenerate cycling guard) or meets a singular basis
    (`torch.linalg.LinAlgError`) or a bad one (`ValueError`). Any other
    error, a CUDA one included, propagates.
    """
    try:
        res = parametrics_exact(
            model, theta_end, dc=dc,
            d_row_lower=d_row_lower, d_row_upper=d_row_upper,
            d_col_lower=d_col_lower, d_col_upper=d_col_upper, tol=tol,
            device=device,
        )
        if res.status in (ProblemStatus.OPTIMAL,
                          ProblemStatus.PRIMAL_INFEASIBLE,
                          ProblemStatus.DUAL_INFEASIBLE):
            pts = res.points()
            if len(pts) > max_points:  # keep ends, thin the middle
                idx = np.unique(np.linspace(0, len(pts) - 1, max_points)
                                .astype(int))
                pts = [pts[i] for i in idx]
            return pts
    except (torch.linalg.LinAlgError, ValueError):
        pass
    return _parametrics_bisect(
        model, theta_end, dc, d_row_lower, d_row_upper,
        d_col_lower, d_col_upper, max_points, tol, device=device,
    )


def _parametrics_bisect(
    model: Model,
    theta_end: float,
    dc: Optional[np.ndarray] = None,
    d_row_lower: Optional[np.ndarray] = None,
    d_row_upper: Optional[np.ndarray] = None,
    d_col_lower: Optional[np.ndarray] = None,
    d_col_upper: Optional[np.ndarray] = None,
    max_points: int = 64,
    tol: float = 1e-9,
    device: Optional[str] = None,
) -> list[tuple[float, float]]:
    """Bisection-with-warm-re-solves fallback (round-2 implementation);
    the re-solves run on `device` (default `device.default_device()`)."""
    from .options import SolveOptions
    from .constants import SolveMethod
    from .simplex.driver import simplex_solve

    base = model.copy()

    def at(theta: float):
        mm = base.copy()
        if dc is not None:
            mm.objective = mm.objective + theta * np.asarray(dc)
        if d_row_lower is not None:
            mm.row_lower = np.where(
                mm.row_lower > -INF, mm.row_lower + theta * np.asarray(d_row_lower), mm.row_lower
            )
        if d_row_upper is not None:
            mm.row_upper = np.where(
                mm.row_upper < INF, mm.row_upper + theta * np.asarray(d_row_upper), mm.row_upper
            )
        if d_col_lower is not None:
            mm.col_lower = np.where(
                mm.col_lower > -INF, mm.col_lower + theta * np.asarray(d_col_lower), mm.col_lower
            )
        if d_col_upper is not None:
            mm.col_upper = np.where(
                mm.col_upper < INF, mm.col_upper + theta * np.asarray(d_col_upper), mm.col_upper
            )
        opts = SolveOptions(method=SolveMethod.DUAL_SIMPLEX)
        if device is not None:
            opts.device = device
        opts.presolve.enabled = False
        warm = model.solution if model.solution.column_status is not None else None
        sol = simplex_solve(mm, opts, dual=True, warm=warm)
        basis_sig = (
            tuple(np.flatnonzero(sol.column_status == int(VariableStatus.BASIC)))
            if sol.column_status is not None
            else ()
        )
        return sol, basis_sig

    points: list[tuple[float, float]] = []
    s0, b0 = at(0.0)
    s1, b1 = at(theta_end)
    points.append((0.0, s0.objective_value))

    def refine(t0, b_0, t1, b_1, depth):
        if depth <= 0 or b_0 == b_1 or (t1 - t0) < 1e-9 * max(1.0, abs(theta_end)):
            return
        tm = 0.5 * (t0 + t1)
        sm, bm = at(tm)
        refine(t0, b_0, tm, bm, depth - 1)
        points.append((tm, sm.objective_value))
        refine(tm, bm, t1, b_1, depth - 1)

    refine(0.0, b0, theta_end, b1, depth=int(np.ceil(np.log2(max_points))))
    points.append((theta_end, s1.objective_value))
    return points


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
