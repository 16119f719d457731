"""QP primal simplex — reduced-gradient active-set method, in PyTorch.

The counterpart of ClpSimplexNonlinear's primal QP (ClpSimplexNonlinear.cpp:33
primal, :773 directionVector): minimize c'x + 0.5 x'Qx over Gx = b,
l <= x <= u from a primal-feasible basis.

Per iteration (no host sync inside; every scalar stays a 0-dim tensor):
  gradient   g  = c + Qx
  duals      y  = g_B @ binv          (B' y = g_B)
  reduced    dj = g - y @ G
  choose a driving variable q: nonbasic-at-bound with wrong-sign dj, or a
  superbasic (FREE status) with |dj| > tol
  direction  d_B = -+ binv @ G[:, q]  (one driving variable at a time — the
  coordinate reduced-gradient strategy; Clp builds the same one-column
  direction in its default mode)
  curvature  kappa = d'Qd ; unconstrained step t* = |dj_q| / kappa
  ratio test over basic bounds and q's own opposite bound
  - curvature-limited: x moves, q becomes SUPERBASIC (no basis change)
  - basic-blocked:     q enters the basis, blocker leaves (LP pivot)
  - own-bound-limited: status flip

The JAX package runs `qp_solve` as two nested `lax.while_loop`s. Here the
outer refactorization loop is Python, and the inner loop runs blocks of
gated iterations: each iteration is applied only while the status is
CONTINUE, `refactor_now` is clear and the iteration limit is not reached,
exactly the inner loop's condition, so the block length changes no count.
The host reads the state's flags once per block.

Status protocol matches the LP engines (engine.py).
"""

from __future__ import annotations

import dataclasses

import torch

from ..forms import StandardLP
from ..ops.linalg import lu_refactor
from .engine import (
    AT_LOWER,
    AT_UPPER,
    BASIC,
    CONTINUE,
    DUAL_INFEASIBLE,
    FREE,
    ITER_LIMIT,
    NUMERICAL,
    OPTIMAL,
    SimplexOptions,
    _at,
    _code,
    _flags,
)

_INF = float("inf")
# gated iterations per host read in the inner loop (any length gives the
# same iterates: the gate freezes the state where the JAX loop stops)
QP_BLOCK = 8


@dataclasses.dataclass
class QPState:
    basis: torch.Tensor  # int64[m]
    vstat: torch.Tensor  # int32[nt] (FREE = superbasic)
    binv: torch.Tensor  # f64[m, m]
    x: torch.Tensor  # f64[nt] — full primal iterate (the authority)
    iterations: torch.Tensor  # int32, 0-dim
    status: torch.Tensor  # int32, 0-dim
    refactor_now: torch.Tensor  # bool, 0-dim


def _scatter(v: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """v.at[idx].set(src), out of place."""
    return v.index_copy(0, idx.reshape(-1), src.reshape(-1).to(v.dtype))


def qp_recompute(lp: StandardLP, state: QPState) -> QPState:
    """Refactorize and project x_B to satisfy Gx = b exactly."""
    G, b = lp.G, lp.b
    B = G.index_select(1, state.basis)
    binv, ok = lu_refactor(B)
    is_basic = _scatter(torch.zeros_like(state.x), state.basis,
                        torch.ones_like(state.basis, dtype=state.x.dtype))
    xn = torch.where(is_basic > 0, 0.0, state.x)
    xb = binv @ (b - G @ xn)
    x = _scatter(xn, state.basis, xb)
    status = torch.where(ok, state.status, NUMERICAL).to(state.status.dtype)
    return dataclasses.replace(
        state, binv=binv, x=x, status=status,
        refactor_now=torch.zeros((), dtype=torch.bool, device=G.device))


def _gradient(lp: StandardLP, x):
    g = lp.c
    if lp.Q is not None:
        g = g + lp.Q @ x
    return g


def _reduced_gradient(lp: StandardLP, state: QPState, g):
    y = g.index_select(0, state.basis) @ state.binv
    dj = g - y @ lp.G
    # basic dj exactly 0 by construction
    return _scatter(dj, state.basis, torch.zeros_like(y))


def qp_iteration(lp: StandardLP, state: QPState, opts: SimplexOptions) -> QPState:
    G = lp.G
    nt = G.shape[1]
    dtol = opts.dual_tolerance
    dt = G.dtype

    x = state.x
    g = _gradient(lp, x)
    dj = _reduced_gradient(lp, state, g)

    at_lo = state.vstat == AT_LOWER
    at_up = state.vstat == AT_UPPER
    at_fr = state.vstat == FREE
    fixed = lp.l == lp.u
    elig = (
        (at_lo & (dj < -dtol)) | (at_up & (dj > dtol)) | (at_fr & (dj.abs() > dtol))
    ) & ~fixed
    score = torch.where(elig, dj.abs(), -_INF)
    q = torch.argmax(score)
    any_elig = elig.any()

    dj_q = _at(dj, q)
    direction = torch.where(dj_q > 0, -1.0, 1.0).to(dt)  # descent for x_q

    # direction on basics: d_B = -direction * binv @ G[:, q]
    abar = state.binv @ G.index_select(1, q.reshape(1))[:, 0]
    dB = -direction * abar

    # curvature kappa = d'Qd with d = direction*e_q + scatter(dB)
    if lp.Q is not None:
        dfull = _scatter(_scatter(torch.zeros(nt, dtype=dt, device=G.device),
                                  state.basis, dB), q, direction)
        kappa = dfull @ (lp.Q @ dfull)
        gd = g @ dfull  # = direction * dj[q] (+ rounding)
        t_star = torch.where(kappa > 1e-12, -gd / torch.clamp_min(kappa, 1e-300), _INF)
        t_star = torch.clamp_min(t_star, 0.0)
    else:
        t_star = torch.full((), _INF, dtype=dt, device=G.device)

    # ratio test on basics
    xb = x.index_select(0, state.basis)
    lb = lp.l.index_select(0, state.basis)
    ub = lp.u.index_select(0, state.basis)
    dec = dB < -opts.pivot_tolerance
    inc = dB > opts.pivot_tolerance
    safe_d = torch.where(dec | inc, dB, 1.0)
    t_cand = torch.where(
        dec & torch.isfinite(lb), (lb - xb) / safe_d,
        torch.where(inc & torch.isfinite(ub), (ub - xb) / safe_d, _INF))
    t_cand = torch.clamp_min(t_cand, 0.0)
    r = torch.argmin(t_cand)
    t_basic = _at(t_cand, r)

    # q's own opposite bound
    x_q = _at(x, q)
    width_q = torch.where(direction > 0, _at(lp.u, q) - x_q, x_q - _at(lp.l, q))
    t_own = torch.where(torch.isfinite(width_q), torch.clamp_min(width_q, 0.0), _INF)

    theta = torch.minimum(torch.minimum(t_star, t_basic), t_own)
    unbounded = ~torch.isfinite(theta) & any_elig

    # --- apply step ---
    x_new = x.index_add(0, state.basis, theta * dB)
    x_new = x_new.index_add(0, q.reshape(1), (direction * theta).reshape(1))

    curvature_limited = (t_star <= t_basic) & (t_star <= t_own)
    own_limited = (t_own < t_star) & (t_own <= t_basic)

    # basis pivot (blocker r leaves)
    abar_r = _at(abar, r)
    piv_small = abar_r.abs() < opts.pivot_tolerance
    p_leave = _at(state.basis, r)
    hit_lower = _at(dB, r) < 0
    vdt = state.vstat.dtype
    basis_piv = _scatter(state.basis, r, q)
    vstat_piv = _scatter(state.vstat, p_leave,
                         torch.where(hit_lower, AT_LOWER, AT_UPPER).to(vdt))
    vstat_piv = _scatter(vstat_piv, q, _code(BASIC, state.vstat))
    factor = abar / abar_r
    factor = _scatter(factor, r, 1.0 - 1.0 / abar_r)
    binv_r = state.binv.index_select(0, r.reshape(1))[0]
    binv_piv = state.binv - torch.outer(factor, binv_r)

    # superbasic landing (curvature-limited): q parks interior
    vstat_q = _at(state.vstat, q)
    vstat_super = _scatter(state.vstat, q,
                           torch.where(_at(fixed, q), vstat_q, FREE).to(vdt))
    # own-bound flip
    flip_stat = torch.where(direction > 0, AT_UPPER, AT_LOWER).to(vdt)
    vstat_flip = _scatter(state.vstat, q, flip_stat)

    do_any = any_elig & ~unbounded
    do_pivot = do_any & ~curvature_limited & ~own_limited & ~piv_small
    do_super = do_any & curvature_limited
    do_flip = do_any & own_limited
    bad = do_any & ~curvature_limited & ~own_limited & piv_small

    vstat_new = torch.where(
        do_pivot, vstat_piv,
        torch.where(do_super, vstat_super, torch.where(do_flip, vstat_flip, state.vstat)),
    ).to(vdt)
    basis_new = torch.where(do_pivot, basis_piv, state.basis)
    binv_new = torch.where(do_pivot, binv_piv, state.binv)
    x_out = torch.where(do_any & ~bad, x_new, x)

    status = torch.where(
        ~any_elig, OPTIMAL, torch.where(unbounded, DUAL_INFEASIBLE, state.status),
    ).to(state.status.dtype)
    # a degenerate (zero) step that isn't a pivot/flip makes no progress
    progressed = do_pivot | do_flip | (do_super & (theta > 0))
    refactor_now = state.refactor_now | bad | (do_super & (theta <= 0))

    return QPState(
        basis=basis_new,
        vstat=vstat_new,
        binv=binv_new,
        x=x_out,
        iterations=state.iterations + progressed.to(state.iterations.dtype),
        status=status,
        refactor_now=refactor_now,
    )


def qp_sweep_iteration(lp: StandardLP, state: QPState, opts: SimplexOptions) -> QPState:
    """Reduced-gradient descent over ALL superbasics at once.

    One-variable pivots alone are coordinate descent and zigzag on coupled
    Q; this is the directionVector analogue (ClpSimplexNonlinear.cpp:773):
    move every superbasic along -dj with exact line search, keeping basics
    feasible. No basis change; superbasics landing on a bound leave the
    superbasic set. No-op when fewer than one superbasic is active.
    """
    G = lp.G
    dtol = opts.dual_tolerance

    x = state.x
    g = _gradient(lp, x)
    dj = _reduced_gradient(lp, state, g)

    fixed = lp.l == lp.u
    sup = (state.vstat == FREE) & ~fixed
    rhs = torch.where(sup & (dj.abs() > dtol), -dj, 0.0)
    active = (rhs.abs() > 0).sum() >= 1

    # reduced-Newton direction in the superbasic space by masked CG on
    # Z'QZ w = -dj_S  (Z: supers free, basics follow, others 0), with a
    # fixed count of 25 steps as in the JAX package; steepest descent is
    # the k=0 case.
    def Zmul(w):
        wm = torch.where(sup, w, 0.0)
        dB_ = -(state.binv @ (G @ wm))
        return _scatter(wm, state.basis, dB_)

    if lp.Q is not None:
        def Hmul(w):
            d = Zmul(w)
            u = lp.Q @ d
            t = u.index_select(0, state.basis) @ state.binv
            red = u - t @ G
            return torch.where(sup, red + 1e-10 * w, 0.0)

        w = torch.zeros_like(rhs)
        rcg, p, rs = rhs, rhs, rhs @ rhs
        for _ in range(25):
            Hp = Hmul(p)
            denom = p @ Hp
            alpha = torch.where(denom > 1e-300, rs / denom, 0.0)
            w = w + alpha * p
            rcg = rcg - alpha * Hp
            rs_new = rcg @ rcg
            beta = torch.where(rs > 1e-300, rs_new / rs, 0.0)
            p = rcg + beta * p
            rs = rs_new
        # fall back to steepest descent if CG went bad (non-descent/NaN)
        ok = torch.isfinite(w).all() & ((torch.where(sup, dj, 0.0) @ w) < 0)
        dN = torch.where(ok, w, rhs)
    else:
        dN = rhs
    dN = torch.where(sup, dN, 0.0)
    dB = -(state.binv @ (G @ dN))
    dfull = _scatter(dN, state.basis, dB)

    if lp.Q is not None:
        kappa = dfull @ (lp.Q @ dfull)
    else:
        kappa = torch.zeros((), dtype=x.dtype, device=x.device)
    gd = g @ dfull  # <= 0 by construction
    t_star = torch.where(kappa > 1e-12, -gd / torch.clamp_min(kappa, 1e-300), _INF)
    t_star = torch.clamp_min(t_star, 0.0)

    mov_dec = dfull < -opts.pivot_tolerance
    mov_inc = dfull > opts.pivot_tolerance
    safe_d = torch.where(mov_dec | mov_inc, dfull, 1.0)
    lo_f = torch.isfinite(lp.l)
    up_f = torch.isfinite(lp.u)
    t_bnd = torch.where(
        mov_dec & lo_f, (lp.l - x) / safe_d,
        torch.where(mov_inc & up_f, (lp.u - x) / safe_d, _INF))
    t_bound = torch.clamp_min(t_bnd, 0.0).amin()
    theta = torch.minimum(t_star, t_bound)
    unbounded = active & ~torch.isfinite(theta) & (gd < -dtol)

    x_new = x + theta * dfull
    # exact landing: clip movers onto the bound they hit
    x_new = torch.minimum(torch.maximum(x_new, torch.where(lo_f, lp.l, -_INF)),
                          torch.where(up_f, lp.u, _INF))
    ptol = opts.primal_tolerance
    land_lo = sup & mov_dec & lo_f & (x_new <= lp.l + ptol * (1 + lp.l.abs()))
    land_up = sup & mov_inc & up_f & (x_new >= lp.u - ptol * (1 + lp.u.abs()))
    vstat_new = torch.where(
        land_lo, AT_LOWER, torch.where(land_up, AT_UPPER, state.vstat)
    ).to(state.vstat.dtype)

    do = active & ~unbounded & torch.isfinite(theta) & (theta > 0)
    status = torch.where(unbounded, DUAL_INFEASIBLE, state.status).to(state.status.dtype)
    return QPState(
        basis=state.basis,
        vstat=torch.where(do, vstat_new, state.vstat),
        binv=state.binv,
        x=torch.where(do, x_new, x),
        iterations=state.iterations + do.to(state.iterations.dtype),
        status=status,
        refactor_now=state.refactor_now,
    )


def _qp_feasible(lp: StandardLP, state: QPState, opts: SimplexOptions):
    viol = torch.clamp_min(torch.maximum(lp.l - state.x, state.x - lp.u), 0.0)
    return torch.clamp_min(viol.amax(), 0.0) <= opts.primal_tolerance * 10


def _qp_optimal(lp: StandardLP, state: QPState, opts: SimplexOptions):
    dj = _reduced_gradient(lp, state, _gradient(lp, state.x))
    at_lo = state.vstat == AT_LOWER
    at_up = state.vstat == AT_UPPER
    at_fr = state.vstat == FREE
    fixed = lp.l == lp.u
    viol = torch.where(
        at_lo & ~fixed, torch.clamp_min(-dj, 0.0),
        torch.where(at_up & ~fixed, torch.clamp_min(dj, 0.0),
                    torch.where(at_fr, dj.abs(), 0.0)))
    return ((torch.clamp_min(viol.amax(), 0.0) <= 10 * opts.dual_tolerance)
            & _qp_feasible(lp, state, opts))


def _gate(run: torch.Tensor, new: QPState, old: QPState) -> QPState:
    return QPState(**{f.name: torch.where(run, getattr(new, f.name), getattr(old, f.name))
                      for f in dataclasses.fields(QPState)})


def _qp_chunk(lp: StandardLP, st: QPState, opts: SimplexOptions) -> QPState:
    """The JAX inner while_loop: up to refactor_frequency iterations, each
    a pivot step followed by a joint superbasic sweep, in blocks of gated
    iterations with one host read per block."""
    chunk = opts.refactor_frequency
    block = QP_BLOCK
    k = 0
    while True:
        status, iters, refactor_now = _flags(st)
        if not (status == CONTINUE and k < chunk and not refactor_now
                and iters < opts.max_iterations):
            return st
        for _ in range(min(block, chunk - k)):
            run = ((st.status == CONTINUE) & ~st.refactor_now
                   & (st.iterations < opts.max_iterations))
            new = qp_sweep_iteration(lp, qp_iteration(lp, st, opts), opts)
            st = _gate(run, new, st)
        k += min(block, chunk - k)


def qp_solve(lp: StandardLP, state: QPState, opts: SimplexOptions) -> QPState:
    """Outer refactorize loop + inner pivot loop with verified optimality."""
    st = state
    stalls = 0
    verified = False
    while True:
        status, iters, _ = _flags(st)
        running = status == CONTINUE or (status == OPTIMAL and not verified)
        if not (running and iters < opts.max_iterations and stalls < 3):
            break
        iters_before = iters
        claimed = status == OPTIMAL
        st = qp_recompute(lp, st)
        ok, fresh = torch.stack([_qp_optimal(lp, st, opts).to(torch.int64),
                                 st.status.to(torch.int64)]).tolist()
        verified = claimed and bool(ok) and fresh != NUMERICAL
        st = dataclasses.replace(st, status=_code(
            NUMERICAL if fresh == NUMERICAL else (OPTIMAL if verified else CONTINUE),
            st.status))
        if not verified:
            st = _qp_chunk(lp, st, opts)
        _, new_iters, _ = _flags(st)
        made = new_iters > iters_before or verified
        stalls = 0 if made else stalls + 1
    status, iters, _ = _flags(st)
    if status == CONTINUE and stalls >= 3:
        st = dataclasses.replace(st, status=_code(NUMERICAL, st.status))
    if not verified:
        st = qp_recompute(lp, st)
    status, iters, _ = _flags(st)
    if status == CONTINUE and iters >= opts.max_iterations:
        st = dataclasses.replace(st, status=_code(ITER_LIMIT, st.status))
    return st


def qp_simplex_solve(model, options):
    """Host driver: phase-1 feasibility via the LP engine (zero objective),
    then the reduced-gradient QP loop, on `options.device`. Returns a
    Solution.

    Reference pattern: ClpSimplexNonlinear::primal on a model with a
    ClpQuadraticObjective (unitTest.cpp:2530-2690 checks simplex-QP and
    barrier-QP agree; tests/test_torch_qp.py does the same here).
    """
    import time

    import numpy as np

    from ..constants import ProblemStatus
    from ..device import resolve_device
    from ..forms import to_standard_form
    from ..model import Solution
    from . import engine as eng
    from .driver import _ENGINE_TO_VS

    lp, info = to_standard_form(model, device=resolve_device(options.device))
    m, nt = lp.G.shape
    n = nt - m
    opts = eng.SimplexOptions(
        primal_tolerance=model.primal_tolerance,
        dual_tolerance=model.dual_tolerance,
        refactor_frequency=options.refactor_frequency or 100,
        max_iterations=int(min(options.max_iterations or 10**9, 50 * (m + n) + 10000)),
    )

    # phase 1: zero-cost LP for a feasible vertex
    t0 = time.perf_counter()
    lp0 = dataclasses.replace(lp, c=torch.zeros_like(lp.c), Q=None)
    st0 = eng.initial_state(lp0, opts)
    st0 = eng.recompute(lp0, st0, opts.dual_bound)
    st0 = eng.make_dual_feasible(lp0, st0, opts)
    st0 = eng.dual_solve(lp0, st0, opts)
    st0_status = int(st0.status)
    t1 = time.perf_counter()
    if st0_status == eng.PRIMAL_INFEASIBLE:
        return Solution(status=ProblemStatus.PRIMAL_INFEASIBLE)
    if st0_status != eng.OPTIMAL:
        return Solution(status=ProblemStatus.ERRORS)

    xn = eng.nonbasic_values(lp0, st0.vstat, opts.dual_bound)
    dev = lp.G.device
    qstate = QPState(
        basis=st0.basis,
        vstat=st0.vstat,
        binv=st0.binv,
        x=_scatter(xn, st0.basis, st0.xb),
        iterations=torch.zeros((), dtype=torch.int32, device=dev),
        status=torch.full((), CONTINUE, dtype=torch.int32, device=dev),
        refactor_now=torch.zeros((), dtype=torch.bool, device=dev),
    )
    qstate = qp_solve(lp, qstate, opts)
    st = int(qstate.status)
    t2 = time.perf_counter()

    x = qstate.x.cpu().numpy()
    g = _gradient(lp, qstate.x).cpu().numpy()
    y = g[qstate.basis.cpu().numpy()] @ qstate.binv.cpu().numpy()
    sense = info.sense
    status_map = {
        OPTIMAL: ProblemStatus.OPTIMAL,
        DUAL_INFEASIBLE: ProblemStatus.DUAL_INFEASIBLE,
        ITER_LIMIT: ProblemStatus.STOPPED,
        NUMERICAL: ProblemStatus.ERRORS,
        CONTINUE: ProblemStatus.ERRORS,
    }
    xs = x[:n]
    obj = float(model.objective @ xs) + model.objective_offset
    if model.quadratic_objective is not None:
        obj += 0.5 * float(xs @ (model.quadratic_objective @ xs))
    vstat = qstate.vstat.cpu().numpy()
    col_status = np.array([_ENGINE_TO_VS[int(s)] for s in vstat[:n]], dtype=np.int8)
    row_status = np.array([_ENGINE_TO_VS[int(s)] for s in vstat[n:]], dtype=np.int8)
    duals = y * sense
    dj_user = (
        model.objective
        + (model.quadratic_objective @ xs if model.quadratic_objective is not None else 0.0)
        - model.matrix.T @ duals
    )
    sol = Solution(
        status=status_map.get(st, ProblemStatus.ERRORS),
        objective_value=obj,
        primal=xs,
        duals=duals,
        reduced_costs=np.asarray(dj_user),
        row_activity=np.asarray(model.matrix @ xs),
        iterations=int(qstate.iterations) + int(st0.iterations),
        column_status=col_status,
        row_status=row_status,
    )
    # the two phases' own counts and walls (host clock; each ends in a
    # status read), for callers that report them apart
    sol.timings = {"qp_stats": {"phase1_iterations": int(st0.iterations),
                                "phase1_seconds": t1 - t0,
                                "qp_iterations": int(qstate.iterations),
                                "qp_seconds": t2 - t1}}
    model.solution = sol
    return sol
