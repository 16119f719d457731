"""Host-side simplex driver: setup, warm starts, retries, result mapping.

The thin orchestration shell around the engines — the equivalent of
ClpSimplex::dual()/primal() entry plumbing plus the statusOfProblemInDual
fake-bound escalation policy (ClpSimplexDual.cpp:4996, resetFakeBounds
:8303):

  - dual solve that ends OPTIMAL with nonbasics still parked at fake bounds
    re-runs with a 100x larger dual bound, then falls back to a primal
    finish (the reference does the same dance with dualBound_).
  - NUMERICAL failures retry once with the other algorithm, then on the
    full-f64 engine, then with perturbed costs (reference: perturb +
    saferTolerances policy, ClpSimplexDual.cpp:6533).

Accelerator settings (K1, the f32 inverse, blocks of gated pivots, the
refactor cadence) follow `device.on_accelerator`: on the CPU the JAX
package's non-TPU branch, on a CUDA device its TPU branch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..constants import (
    DUAL_BOUND_DEFAULT,
    ProblemStatus,
    VariableStatus,
)
from ..device import on_accelerator, resolve_device
from ..forms import to_standard_form
from ..model import Model, Solution
from ..options import SolveOptions
from . import engine
from .engine import (
    AT_LOWER,
    AT_UPPER,
    BASIC,
    FREE,
    SimplexOptions,
    SimplexState,
    dual_solve,
    primal_solve,
    initial_state,
    make_dual_feasible,
    recompute,
)

# VariableStatus -> engine status code
_VS_TO_ENGINE = {
    int(VariableStatus.FREE): FREE,
    int(VariableStatus.BASIC): BASIC,
    int(VariableStatus.AT_UPPER): AT_UPPER,
    int(VariableStatus.AT_LOWER): AT_LOWER,
    int(VariableStatus.SUPER_BASIC): FREE,
    int(VariableStatus.FIXED): AT_LOWER,
}
_ENGINE_TO_VS = {
    FREE: int(VariableStatus.FREE),
    BASIC: int(VariableStatus.BASIC),
    AT_UPPER: int(VariableStatus.AT_UPPER),
    AT_LOWER: int(VariableStatus.AT_LOWER),
}


def _np(x) -> np.ndarray:
    """Host copy of a device tensor (or pass through numpy data)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _with_status(state: SimplexState, code: int) -> SimplexState:
    return dataclasses.replace(state, status=engine._code(code, state.status))


def _repair_basis(vstat: np.ndarray, m: int, nt: int, l, u) -> tuple[np.ndarray, np.ndarray]:
    """Force exactly m basic variables; return (vstat, basis index vector).

    Mirrors the intent of the reference's basis repair when a warm start
    doesn't match (ClpSimplex internalFactorize throw-out path).
    """
    n = nt - m
    basic = np.flatnonzero(vstat == BASIC)
    if basic.size > m:
        # demote surplus structurals (prefer keeping slacks for stability)
        surplus = [j for j in basic if j < n][: basic.size - m]
        if len(surplus) < basic.size - m:
            surplus += [j for j in basic if j >= n][: basic.size - m - len(surplus)]
        for j in surplus:
            vstat[j] = AT_LOWER if np.isfinite(l[j]) else (AT_UPPER if np.isfinite(u[j]) else FREE)
        basic = np.flatnonzero(vstat == BASIC)
    if basic.size < m:
        # promote slacks of rows without a basic variable
        deficit = m - basic.size
        nonbasic_slacks = [n + i for i in range(m) if vstat[n + i] != BASIC]
        for j in nonbasic_slacks[:deficit]:
            vstat[j] = BASIC
        basic = np.flatnonzero(vstat == BASIC)
    if basic.size != m:
        raise RuntimeError(f"basis repair left {basic.size} basics for {m} rows")
    return vstat, basic.astype(np.int64)


def _lu_row_permutation(pivots: np.ndarray, rows: int) -> np.ndarray:
    """Row permutation `perm` with A[perm] = L @ U from LAPACK's 1-based
    sequential row swaps."""
    perm = np.arange(rows)
    for i, p in enumerate(pivots - 1):
        perm[i], perm[p] = perm[p], perm[i]
    return perm


def _warm_state(lp, opts: SimplexOptions, warm: Solution, n: int, m: int) -> SimplexState:
    nt = n + m
    l = _np(lp.l)
    u = _np(lp.u)
    vstat = np.full(nt, AT_LOWER, dtype=np.int32)
    if warm.column_status is not None and warm.row_status is not None:
        for j in range(n):
            vstat[j] = _VS_TO_ENGINE.get(int(warm.column_status[j]), AT_LOWER)
        for i in range(m):
            vstat[n + i] = _VS_TO_ENGINE.get(int(warm.row_status[i]), BASIC)
    elif warm.primal is not None:
        # crossover from an interior point (ClpSolve.cpp:3585+ equivalent):
        # pick the most-interior variables as basis candidates and select m
        # independent columns by a pivoted LU; everything else parks at its
        # nearest bound. The dual simplex then only repairs the few
        # fractional leftovers instead of walking in from an all-slack basis.
        x_struct = np.asarray(warm.primal)
        G = _np(lp.G)
        x = np.concatenate([x_struct, np.asarray(G[:, :n] @ x_struct)])[:nt] \
            if warm.row_activity is None else np.concatenate(
                [x_struct, np.asarray(warm.row_activity)]
            )
        dist_lo = np.where(np.isfinite(l), x - l, np.inf)
        dist_up = np.where(np.isfinite(u), u - x, np.inf)
        interior = np.minimum(dist_lo, dist_up)  # inf for free vars
        order = np.argsort(-np.minimum(interior, 1e20))
        # candidate pool: clearly-interior variables first, then slacks
        pool = order[: min(nt, 4 * m)]
        try:
            # device-side independent-column selection: row-pivoted LU on
            # the TRANSPOSED candidate block — partial pivoting permutes
            # rows of Gp^T (= columns of Gp), and scaling each column by an
            # interiority weight makes the pivoting follow our preference
            # except where columns are (near-)dependent. f32: it only
            # *selects*; the basis itself is refactorized in f64 afterwards.
            Gp = lp.G[:, torch.as_tensor(pool, device=lp.G.device)]
            norms = torch.linalg.vector_norm(Gp, dim=0)
            norms = torch.where(norms > 1e-12, norms, 1.0)
            weights = torch.exp(-torch.arange(pool.size, dtype=Gp.dtype,
                                              device=Gp.device) / max(m, 1))
            A32 = ((Gp / norms) * weights).T.to(torch.float32)
            lu, piv, _ = torch.linalg.lu_factor_ex(A32)
            d = np.abs(_np(torch.diagonal(lu)))
            sel = _lu_row_permutation(_np(piv), pool.size)[:m]
            dmax = float(d.max(initial=1.0))
            rank_cols = [
                int(pool[s]) for s, dv in zip(sel, d) if dv > 1e-6 * dmax
            ]
        except RuntimeError:
            rank_cols = list(range(n, nt))  # fall back to slack basis
        chosen = set()
        for j in rank_cols:
            if len(chosen) < m:
                chosen.add(j)
        # top up with slacks if the LU returned dependent picks
        for i in range(m):
            if len(chosen) >= m:
                break
            chosen.add(n + i)
        for j in range(nt):
            if j in chosen:
                vstat[j] = BASIC
            else:
                dl = x[j] - l[j] if np.isfinite(l[j]) else np.inf
                du = u[j] - x[j] if np.isfinite(u[j]) else np.inf
                if dl <= du and np.isfinite(l[j]):
                    vstat[j] = AT_LOWER
                elif np.isfinite(u[j]):
                    vstat[j] = AT_UPPER
                else:
                    vstat[j] = FREE
    else:
        vstat[n:] = BASIC
    # fixed variables always nonbasic at the bound
    fixed = l == u
    vstat = np.where(fixed & (vstat != BASIC), AT_LOWER, vstat).astype(np.int32)
    vstat, basis = _repair_basis(vstat, m, nt, l, u)
    dev = lp.G.device
    return initial_state(lp, opts, vstat=torch.as_tensor(vstat, device=dev),
                         basis=torch.as_tensor(basis, device=dev))


def _extract(model: Model, lp, state: SimplexState, opts: SimplexOptions,
             engine_status: int) -> Solution:
    m, nt = lp.G.shape
    n = nt - m
    vstat = _np(state.vstat)
    basis = _np(state.basis)
    # nonbasic values in HOST numpy (engine.nonbasic_values semantics)
    l_np = _np(lp.l)
    u_np = _np(lp.u)
    vlo = np.where(np.isfinite(l_np), l_np, -opts.dual_bound)
    vup = np.where(np.isfinite(u_np), u_np, opts.dual_bound)
    xfull = np.where(
        vstat == engine.AT_LOWER, vlo,
        np.where(vstat == engine.AT_UPPER, vup, 0.0),
    )
    xfull = np.where(vstat == engine.BASIC, 0.0, xfull)
    xfull[basis] = _np(state.xb)
    x = xfull[:n]
    row_act = xfull[n:]
    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0
    y = _np(state.y) * sense
    d = model.objective - model.matrix.T @ y
    obj = float(model.objective @ x) + model.objective_offset

    status_map = {
        engine.OPTIMAL: ProblemStatus.OPTIMAL,
        engine.PRIMAL_INFEASIBLE: ProblemStatus.PRIMAL_INFEASIBLE,
        engine.DUAL_INFEASIBLE: ProblemStatus.DUAL_INFEASIBLE,
        engine.ITER_LIMIT: ProblemStatus.STOPPED,
        engine.NUMERICAL: ProblemStatus.ERRORS,
        engine.CONTINUE: ProblemStatus.ERRORS,
    }
    col_status = np.array([_ENGINE_TO_VS[int(s)] for s in vstat[:n]], dtype=np.int8)
    row_status = np.array([_ENGINE_TO_VS[int(s)] for s in vstat[n:]], dtype=np.int8)

    # certificate rays (reference: ClpModel::infeasibilityRay/unboundedRay,
    # ClpModel.hpp:875-899), reconstructed from the final state
    infeas_ray = None
    unbounded_ray = None
    if engine_status == engine.PRIMAL_INFEASIBLE:
        infeas_ray = _farkas_ray(lp, state, sense)
    elif engine_status == engine.DUAL_INFEASIBLE:
        unbounded_ray = _primal_ray(lp, state, n)
    # factorization statistics (reference: ClpFactorization statistics
    # mode, ClpFactorization.hpp:486): counts + mean pivots per factor
    nref = int(state.refactors)
    iters = int(state.iterations)
    stats = {
        "factorizations": nref,
        "pivots_per_factorization": round(iters / nref, 2) if nref else 0.0,
        "inverse_dtype": str(state.binv.dtype).replace("torch.", ""),
    }
    return Solution(
        status=status_map[engine_status],
        objective_value=obj,
        primal=x,
        duals=y,
        reduced_costs=d,
        row_activity=row_act,
        iterations=iters,
        column_status=col_status,
        row_status=row_status,
        infeasibility_ray=infeas_ray,
        unbounded_ray=unbounded_ray,
        timings={"factorization_stats": stats},
    )


def _farkas_ray(lp, state: SimplexState, sense: float) -> Optional[np.ndarray]:
    """Dual (Farkas) ray from the most-infeasible basic's BTRAN row.

    At dual termination with an infeasible basic row r and no eligible
    entering column, sigma * Binv[r,:] certifies infeasibility.
    """
    l = _np(lp.l)
    u = _np(lp.u)
    basis = _np(state.basis)
    xb = _np(state.xb)
    lb, ub = l[basis], u[basis]
    below = lb - xb
    above = xb - ub
    infeas = np.maximum(np.maximum(below, above), 0.0)
    if infeas.max(initial=0.0) <= 0:
        return None
    r = int(np.argmax(infeas))
    sigma = 1.0 if above[r] > below[r] else -1.0
    rho = sigma * _np(state.binv[r, :])
    return rho * sense


def _primal_ray(lp, state: SimplexState, n: int) -> Optional[np.ndarray]:
    """Unbounded primal direction: entering column with no blocking basic."""
    G = _np(lp.G)
    l = _np(lp.l)
    u = _np(lp.u)
    vstat = _np(state.vstat)
    dj = _np(state.dj)
    binv = _np(state.binv)
    basis = _np(state.basis)
    lb, ub = l[basis], u[basis]
    nt = G.shape[1]
    cand = [
        (abs(dj[j]), j)
        for j in range(nt)
        if vstat[j] != BASIC
        and l[j] != u[j]
        and (
            (vstat[j] == AT_LOWER and dj[j] < -1e-9)
            or (vstat[j] == AT_UPPER and dj[j] > 1e-9)
            or (vstat[j] == FREE and abs(dj[j]) > 1e-9)
        )
    ]
    for _, q in sorted(cand, reverse=True):
        direction = -1.0 if (vstat[q] == AT_UPPER or (vstat[q] == FREE and dj[q] > 0)) else 1.0
        abar = binv @ G[:, q]
        d = direction * abar
        blocked = np.any((d > 1e-9) & np.isfinite(lb)) or np.any(
            (d < -1e-9) & np.isfinite(ub)
        )
        if not blocked and (not np.isfinite(u[q] if direction > 0 else l[q])):
            ray = np.zeros(n)
            if q < n:
                ray[q] = direction
            for i, b in enumerate(basis):
                if b < n:
                    ray[b] = -d[i]
            return ray
    return None


def _infeasibility_certificate_ok(lp, state: SimplexState, tol: float = 1e-7) -> bool:
    """True iff SOME infeasible basic row yields an exact Farkas certificate.

    For Gx = 0, l <= x <= u, a row y of B^-T (signed toward the violated
    bound) certifies infeasibility iff  sup_{l<=x<=u} y'Gx < 0, i.e. the
    bound-support sum of z = G'y is strictly negative with no infinite
    terms. Solved on fresh f64 factors — the engine's running inverse may
    be f32 and the claim a refinement artifact.
    """
    import scipy.linalg as sla

    G = _np(lp.G).astype(np.float64)
    l = _np(lp.l)
    u = _np(lp.u)
    basis = _np(state.basis)
    xb = _np(state.xb)
    lb, ub = l[basis], u[basis]
    below = lb - xb
    above = xb - ub
    infeas = np.maximum(np.maximum(below, above), 0.0)
    if infeas.max(initial=0.0) <= 0:
        return False
    try:
        B_lu = sla.lu_factor(G[:, basis])
    except (ValueError, np.linalg.LinAlgError):
        return True  # cannot adjudicate: keep the engine's claim
    m = basis.size
    order = np.argsort(-infeas)[: min(16, m)]
    for r in order:
        if infeas[r] <= 0:
            break
        sigma = 1.0 if above[r] > below[r] else -1.0
        e = np.zeros(m)
        e[int(r)] = 1.0
        y = sigma * sla.lu_solve(B_lu, e, trans=1)
        z = y @ G
        pos, neg = z > tol, z < -tol
        if np.any(pos & ~np.isfinite(u)) or np.any(neg & ~np.isfinite(l)):
            continue  # support is +inf: not a certificate
        sup = float(np.sum(z[pos] * u[pos]) + np.sum(z[neg] * l[neg]))
        scale = float(np.abs(z[pos] * u[pos]).sum() + np.abs(z[neg] * l[neg]).sum()) + 1.0
        if sup < -tol * scale:
            return True
    return False


def _unbounded_certificate_ok(lp, state: SimplexState, tol: float = 1e-7) -> bool:
    """True iff SOME nonbasic column yields an exact improving ray.

    Candidate selection mirrors _primal_ray, but the basic direction is
    re-solved in fresh f64 on the basis columns and the cost improvement is
    checked against the ORIGINAL costs — immune to dj noise from the
    engine's running (possibly f32) inverse.
    """
    import scipy.linalg as sla

    G = _np(lp.G).astype(np.float64)
    c = _np(lp.c).astype(np.float64)
    l = _np(lp.l)
    u = _np(lp.u)
    vstat = _np(state.vstat)
    dj = _np(state.dj)
    basis = _np(state.basis)
    nt = G.shape[1]
    try:
        B_lu = sla.lu_factor(G[:, basis])
    except (ValueError, np.linalg.LinAlgError):
        return True  # cannot adjudicate: keep the engine's claim
    cand = sorted(
        (
            (abs(dj[j]), j)
            for j in range(nt)
            if vstat[j] != BASIC
            and l[j] != u[j]
            and (
                (vstat[j] == AT_LOWER and dj[j] < -1e-9)
                or (vstat[j] == AT_UPPER and dj[j] > 1e-9)
                or (vstat[j] == FREE and abs(dj[j]) > 1e-9)
            )
        ),
        reverse=True,
    )
    lb, ub = l[basis], u[basis]
    cb = c[basis]
    for _, q in cand[:64]:
        direction = -1.0 if (vstat[q] == AT_UPPER or (vstat[q] == FREE and dj[q] > 0)) else 1.0
        if not np.isfinite(u[q] if direction > 0 else l[q]):
            d = -direction * sla.lu_solve(B_lu, G[:, q])
            blocked = np.any((d > tol) & np.isfinite(ub)) or np.any(
                (d < -tol) & np.isfinite(lb)
            )
            if blocked:
                continue
            cost = direction * c[q] + cb @ d
            scale = abs(c[q]) + float(np.abs(cb * d).sum()) + 1.0
            if cost < -tol * scale:
                return True
    return False


def _fake_bound_mask(lp, state: SimplexState) -> np.ndarray:
    l = _np(lp.l)
    u = _np(lp.u)
    vstat = _np(state.vstat)
    fake_lo = (vstat == AT_LOWER) & ~np.isfinite(l)
    fake_up = (vstat == AT_UPPER) & ~np.isfinite(u)
    return fake_lo | fake_up


def _at_fake_bound(lp, state: SimplexState) -> bool:
    return bool(np.any(_fake_bound_mask(lp, state)))


def _pressed_fake(lp, state: SimplexState, dual_tol: float) -> bool:
    """A fake-bound nonbasic with a real escape direction (nonzero dj):
    the dangerous case — the 'optimum' leans on the fake bound. Degenerate
    parks (dj ~ 0) are harmless and stay."""
    mask = _fake_bound_mask(lp, state)
    return bool(np.any(mask & (np.abs(_np(state.dj)) > 10 * dual_tol)))


def _demote_fakes_to_free(lp, state: SimplexState) -> SimplexState:
    """Park fake-bound nonbasics at value 0 as FREE.

    A nonbasic left on a fake bound at dual optimality sits at +-dualBound
    (1e10+), which poisons the extracted solution with catastrophic
    cancellation. Demoting to FREE (value 0) keeps dj unchanged; the primal
    finish restores feasibility, or proves unboundedness if the variable
    genuinely needs to run away (reference: resetFakeBounds + primal
    cleanup, ClpSimplexDual.cpp:8303).
    """
    mask = torch.as_tensor(_fake_bound_mask(lp, state), device=state.vstat.device)
    vstat = torch.where(mask, FREE, state.vstat).to(state.vstat.dtype)
    return dataclasses.replace(state, vstat=vstat)


class _EventAbort(Exception):
    """An event handler returned >= 0: stop and report USER_STOPPED."""

    def __init__(self, state):
        self.state = state


def _run_chunked(lp, state, opts: SimplexOptions, dual: bool,
                 max_seconds: Optional[float], progress=None, mh=None,
                 fire=None):
    """Host-driven chunk loop: wall-clock limits + per-chunk progress.

    Same protocol as the whole-solve loop (verified-optimality, stall
    escalation) with the outer iteration here. Event hooks fire at chunk
    boundaries (endOfIteration/endOfFactorization granularity — each chunk
    contains >= 1 refactorization); a handler abort raises _EventAbort with
    the current state.
    """
    import time as _time

    from ..events import Event

    from .engine import dual_chunk_packed, primal_chunk_packed

    step = dual_chunk_packed if dual else primal_chunk_packed
    deadline = None if max_seconds is None else _time.monotonic() + max_seconds
    stalls = 0
    # Clp-style anti-cycling progress (ClpSimplexProgress::looping, 5-deep
    # objective history, ClpSolve.hpp:336-345): a chunk that pivots but
    # returns to a previously seen objective value is counted as a cycle.
    obj_history: list[float] = []
    cycles = 0
    pending_claim = None
    iters_before = int(state.iterations)
    while True:
        # ONE packed device fetch per chunk (status, iterations, verified,
        # objective)
        state, info = step(lp, state, opts)
        ih = _np(info)
        st = int(ih[0])
        iters_now = int(ih[1])
        verified = bool(ih[2])
        obj_f = float(ih[3])
        if progress is not None:
            progress(iters_now, obj_f)
        if fire is not None:
            abort = fire(Event.END_OF_ITERATION,
                         iterations=iters_now, objective=obj_f)
            abort |= fire(Event.END_OF_FACTORIZATION,
                          iterations=iters_now)
            if st == engine.OPTIMAL and not verified:
                # the engine found no entering candidate; the next chunk
                # re-derives the claim on fresh factors
                abort |= fire(Event.NO_CANDIDATE_IN_DUAL if dual
                              else Event.NO_CANDIDATE_IN_PRIMAL,
                              iterations=iters_now)
            if abort:
                raise _EventAbort(state)
        if verified:
            break
        if st in (engine.PRIMAL_INFEASIBLE, engine.DUAL_INFEASIBLE):
            # same protocol as the whole-solve loop: accept an infeasible /
            # unbounded claim only when the NEXT chunk (which starts on
            # fresh factors) re-derives it without managing a pivot
            if pending_claim == st and iters_now == iters_before:
                break
            pending_claim = st
            iters_before = iters_now
            continue
        pending_claim = None
        if st not in (engine.CONTINUE, engine.OPTIMAL):
            break  # NUMERICAL / ITER_LIMIT
        if st == engine.OPTIMAL:
            iters_before = iters_now
            continue  # claim made inside the chunk; next call verifies it
        if iters_now >= opts.max_iterations:
            state = _with_status(state, engine.ITER_LIMIT)
            break
        made_pivots = iters_now > iters_before
        if made_pivots and any(
            abs(obj_f - o) <= 1e-12 * (1.0 + abs(o)) for o in obj_history
        ):
            cycles += 1
            if mh is not None:
                mh.message("CLP_POSSIBLELOOP", it=iters_now)
        else:
            cycles = 0
        obj_history = (obj_history + [obj_f])[-5:]
        iters_before = iters_now
        stalls = 0 if made_pivots else stalls + 1
        if stalls >= 3 or cycles >= 3:
            if mh is not None and cycles >= 3:
                mh.message("CLP_LOOP")
            state = _with_status(state, engine.NUMERICAL)
            break
        if deadline is not None and _time.monotonic() > deadline:
            state = _with_status(state, engine.ITER_LIMIT)
            break
    return state


# CLI spellings (ClpParam dualPivot/primalPivot keywords) -> engine modes
_DUAL_PIVOT_MAP = {
    "dantzig": "dantzig",
    "steepest": "steepest",
    "pesteepest": "pe",
    "pe": "pe",
}
_PRIMAL_PIVOT_MAP = {
    "dantzig": "dantzig",
    "devex": "devex",
    "steepest": "steepest",
    "exact": "steepest",
    "partial": "partial",
    "pesteepest": "pe",
    "pe": "pe",
}


def _pm1_eligible(model: Model) -> bool:
    """True when every column has at most one +1 and at most one -1 and no
    other entries — the shape the engines' multiply-free kernels assume
    (ClpPlusMinusOneMatrix.hpp / ClpNetworkMatrix.hpp:12-16)."""
    A = model.matrix.tocsc()
    if A.nnz == 0:
        return False
    d = A.data
    if not np.all(np.abs(d) == 1.0):
        return False
    counts = np.diff(A.indptr)
    if np.any(counts > 2):
        return False
    npos = np.asarray((A > 0).sum(axis=0)).ravel()
    nneg = counts - npos
    return bool(np.all(npos <= 1) and np.all(nneg <= 1))


def block_geometry(model: Model):
    """The block-banded PRICE geometry of `model`'s standard form, or None.

    Groups the standard-form columns (structurals + slacks) by row-support
    window, picks the block width CB minimizing total tile area nb*H*CB,
    and accepts it only with coverage H <= m/2 and an area of at most 0.6
    of the dense m*nt (the JAX package's gate for price_mode="block"). Returns
    (nb, H, CB, perm): perm sorts the columns by window position, so each
    block's columns are contiguous. None means the LP is not block-banded
    enough, and the JAX package then runs the dense route.
    """
    A = model.matrix.tocsc()
    A.sort_indices()
    m, n = A.shape
    nt = n + m
    lo_c = np.zeros(nt, dtype=np.int64)
    hi_c = np.ones(nt, dtype=np.int64)
    nzc = np.flatnonzero(np.diff(A.indptr))
    lo_c[nzc] = A.indices[A.indptr[nzc]]
    hi_c[nzc] = A.indices[A.indptr[nzc + 1] - 1] + 1
    lo_c[n:] = np.arange(m)
    hi_c[n:] = np.arange(m) + 1
    order = np.argsort(lo_c + hi_c, kind="stable")
    best = None
    for cb in (128, 256, 384, 512):
        nb_try = -(-nt // cb)
        if nb_try < 2:
            continue
        pad = nb_try * cb - nt
        lo_s = np.concatenate([lo_c[order], np.full(pad, lo_c[order[-1]])])
        hi_s = np.concatenate([hi_c[order], np.full(pad, hi_c[order[-1]])])
        spans = (hi_s.reshape(nb_try, cb).max(axis=1)
                 - lo_s.reshape(nb_try, cb).min(axis=1))
        # +8 slack: block_forms floors window starts to multiples of 8
        H = int(-(-int(spans.max()) // 8) * 8) + 8
        H = min(H, -(-m // 8) * 8)
        cost = nb_try * H * cb
        if best is None or cost < best[0]:
            best = (cost, nb_try, H, cb)
    if best is None or best[2] > m // 2 or best[0] > 0.6 * m * nt:
        return None
    return best[1], best[2], best[3], np.ascontiguousarray(order)


def _sorted_state(st: SimplexState, perm, inv) -> SimplexState:
    """A state of the original column order relabelled to the sorted one
    (binv, xb and the weights are row-space and stay)."""
    return dataclasses.replace(st, vstat=st.vstat.index_select(0, perm),
                               dj=st.dj.index_select(0, perm),
                               basis=inv.index_select(0, st.basis))


def _orig_state(st: SimplexState, perm, inv) -> SimplexState:
    """The inverse of `_sorted_state`."""
    return dataclasses.replace(st, vstat=st.vstat.index_select(0, inv),
                               dj=st.dj.index_select(0, inv),
                               basis=perm.index_select(0, st.basis))


def simplex_solve(
    model: Model,
    options: SolveOptions,
    dual: bool,
    warm: Optional[Solution] = None,
) -> Solution:
    bucket = int(getattr(options, "shape_bucket", 0) or 0)
    if bucket > 0:
        raise NotImplementedError(
            "shape_bucket > 0 is not ported yet (ROADMAP.md queue 1: shape_bucket)")
    if options.price_mode == "ell":
        raise NotImplementedError(
            "price_mode='ell' is not ported yet (ROADMAP.md queue 1: `ell` and `pe`)")
    device = resolve_device(getattr(options, "device", "cuda"))
    lp, info = to_standard_form(model, device=device)
    m, nt = lp.G.shape
    n = nt - m
    accel = on_accelerator(lp.G)

    from ..events import Event, fire_event, get_handler

    mh = get_handler(model, options)

    def _msg(name, **kw):
        if mh is not None:
            mh.message(name, **kw)

    have_handler = getattr(model, "event_handler", None) is not None
    aborted = {"flag": False}

    def ev(which, **info_kw) -> bool:
        ab = have_handler and fire_event(model, which, **info_kw)
        if ab:
            # any hook may abort (ClpEventHandler contract: return >= 0);
            # dsolve/psolve short-circuit once the flag is set and the
            # final status becomes USER_STOPPED
            aborted["flag"] = True
        return ab

    ev(Event.END_OF_CREATE_RIM, rows=m, cols=n)

    # pluggable catastrophic-recovery callback (ClpDisasterHandler,
    # ClpSimplex.hpp:992-1001): announce the takeover; the recovery hook
    # itself fires at the terminal-failure exit below
    disaster = getattr(model, "disaster_handler", None)
    if disaster is not None:
        disaster.into_simplex(model)

    # chunked host loop when wall-clock limits or a progress table are
    # wanted (reference -progress/-progressIter; log level >= 3 implies a
    # live table at every chunk)
    prog_mode = getattr(options, "progress", -1)
    if options.log_level >= 3 and prog_mode < 0:
        prog_mode = 1
    use_chunked = options.max_seconds is not None or prog_mode >= 0
    progress = None
    if prog_mode >= 0:
        from ..events import ProgressDisplay

        disp = ProgressDisplay(
            deterministic=prog_mode == 0,
            every=1 if options.log_level >= 3
            else getattr(options, "progress_iter", 100) or 100,
        )
        phase = "dual" if dual else "primal"
        progress = lambda it, obj: disp.line(phase, it, obj)  # noqa: E731

    # a user-set limit (options or model) is respected verbatim; only the
    # open default gets the shape-scaled safety cap, and generously — a cap
    # that bites on hard degenerate problems would masquerade as STOPPED
    max_iter = options.max_iterations or (
        model.maximum_iterations
        if model.maximum_iterations != 2 ** 31 - 1
        else min(model.maximum_iterations, 200 * (m + n) + 10000)
    )
    max_iter = int(max_iter)

    if options.use_pallas_price == "auto":
        # K1 on CUDA solves at scale, mirroring the JAX package's TPU branch
        # (kernel launch overhead beats the plain PRICE only at real scale)
        use_pallas = accel and m * nt >= 512 * 1024
    else:
        use_pallas = bool(options.use_pallas_price)

    price_mode = options.price_mode
    blk_nb = blk_h = blk_cb = 0
    blk_perm = None
    # "block" is opt-in, as in the JAX package
    if price_mode == "block":
        geom = block_geometry(model)
        if geom is not None:
            blk_nb, blk_h, blk_cb, blk_perm = geom
        else:
            price_mode = "dense"  # structure not block-banded enough
    if price_mode == "auto":
        if not use_pallas and _pm1_eligible(model):
            price_mode = "pm1"
        else:
            price_mode = "dense"
            # the JAX package switches to sparse ELL pricing when the dense
            # f32 pricing copy of G would not fit beside the inverse
            A = model.matrix
            dens = A.nnz / max(1, A.shape[0] * A.shape[1])
            if 4 * m * nt > 6 << 30 and dens <= 0.02:
                kc = (max(int(np.diff(A.tocsc().indptr).max(initial=1)), 1) + 7) // 8 * 8
                kr = (int(np.diff(A.tocsr().indptr).max(initial=0)) + 1 + 7) // 8 * 8
                if kc <= m // 4 and kr <= nt // 4:
                    raise NotImplementedError(
                        "this LP needs the sparse `ell` pricing, which is not "
                        "ported yet (ROADMAP.md queue 1: `ell` and `pe`)")
    if price_mode == "pm1":
        use_pallas = False  # the gathers replace the dense contraction
    # "block" KEEPS the K1 flag: K3 replaces K1 on the block route

    inv_dtype = getattr(options, "inverse_dtype", "auto")
    if inv_dtype == "auto":
        # the f32 pivot loop, as on the JAX package's TPU branch
        inv_dtype = "float32" if accel and m >= 512 else "float64"

    dual_ratio = getattr(options, "dual_ratio", "auto")
    if dual_ratio == "auto":
        # the long step only ever passes boxed breakpoints; it pays when a
        # meaningful share of variables (columns + slacks) is boxed
        boxed_frac = float(np.mean(np.isfinite(_np(lp.l)) & np.isfinite(_np(lp.u))))
        dual_ratio = "bfrt" if boxed_frac >= 0.2 else "harris"

    refreq = options.refactor_frequency
    if refreq is None:
        # cost-model auto cadence (timeToRefactorize analogue): the mixed
        # engine refactors every 400/800 pivots, the JAX package's TPU
        # choice (on the TPU v5e, 2048x3584 BFRT solved ~11% faster at 800
        # than at 400); which cadence is best on the H100 is still open
        if inv_dtype == "float32":
            refreq = 400 if m <= 1024 else 800
        else:
            refreq = 100

    def make_opts(dual_bound: float) -> SimplexOptions:
        return SimplexOptions(
            primal_tolerance=model.primal_tolerance,
            dual_tolerance=model.dual_tolerance,
            dual_bound=dual_bound,
            refactor_frequency=refreq,
            max_iterations=max_iter,
            dual_pivot=_DUAL_PIVOT_MAP.get(options.dual_pivot, "steepest"),
            primal_pivot=_PRIMAL_PIVOT_MAP.get(options.primal_pivot, "devex"),
            use_pallas_price=use_pallas,
            # fused FTRAN+update kernel K2: opt-in, as in the JAX package
            use_pallas_pivot=getattr(options, "use_pallas_pivot", False),
            price_mode=price_mode,
            price_block_nb=blk_nb,
            price_block_h=blk_h,
            price_block_cb=blk_cb,
            inverse_dtype=inv_dtype,
            dual_ratio=dual_ratio,
            # blocks of 8 gated pivots per host status check on the mixed
            # CUDA engine (the JAX package's TPU choice: there the loop
            # boundary measured ~39 us/pivot on the TPU v5e). Both pivot
            # bodies freeze themselves at every stop condition, so
            # over-running a block is a gated no-op.
            inner_unroll=8 if (inv_dtype == "float32" and accel) else 1,
        )

    opts = make_opts(getattr(options, "dual_bound", DUAL_BOUND_DEFAULT))
    # block price mode: sort the standard-form columns by window position
    # once; the engines run entirely in sorted space and every state built
    # in the original order (initial_state assumes slacks last) or handed
    # back to the caller passes through _to_sorted / _to_orig
    lp0 = lp
    if blk_perm is not None:
        perm = torch.as_tensor(blk_perm, device=lp.G.device)
        inv = torch.argsort(perm)
        lp = dataclasses.replace(
            lp, G=lp.G.index_select(1, perm), c=lp.c.index_select(0, perm),
            l=lp.l.index_select(0, perm), u=lp.u.index_select(0, perm))

    def _to_sorted(st):
        return st if blk_perm is None else _sorted_state(st, perm, inv)

    def _to_orig(st):
        return st if blk_perm is None else _orig_state(st, perm, inv)

    if warm is not None:
        if warm.column_status is None and warm.primal is not None:
            # values-only warm point: the crossover basis construction
            ev(Event.START_OF_CROSSOVER)
        state = _to_sorted(_warm_state(lp0, opts, warm, n, m))
    else:
        state = _to_sorted(initial_state(lp0, opts))

    def dsolve(lp_, state_, opts_):
        if aborted["flag"]:
            return state_
        if use_chunked or have_handler:
            try:
                return _run_chunked(lp_, state_, opts_, True,
                                    options.max_seconds, progress, mh,
                                    fire=ev if have_handler else None)
            except _EventAbort as e:
                aborted["flag"] = True
                return e.state
        return dual_solve(lp_, state_, opts_)

    def psolve(lp_, state_, opts_):
        if aborted["flag"]:
            return state_
        if use_chunked or have_handler:
            try:
                return _run_chunked(lp_, state_, opts_, False,
                                    options.max_seconds, progress, mh,
                                    fire=ev if have_handler else None)
            except _EventAbort as e:
                aborted["flag"] = True
                return e.state
        return primal_solve(lp_, state_, opts_)

    if dual:
        ev(Event.GOOD_FACTORIZATION)
        ev(Event.BEFORE_STATUS_OF_PROBLEM_IN_DUAL)
        state = recompute(lp, state, opts.dual_bound)
        ev(Event.START_OF_STATUS_OF_PROBLEM_IN_DUAL)
        state = make_dual_feasible(lp, state, opts)
        state = dsolve(lp, state, opts)
        st = int(state.status)
        if warm is not None and warm.column_status is None \
                and warm.primal is not None:
            ev(Event.END_OF_VALUES_PASS, iterations=int(state.iterations))
        if st == engine.OPTIMAL:
            ev(Event.LOOKS_END_IN_DUAL, iterations=int(state.iterations))
        # fake-bound escalation (resetFakeBounds analogue) — only worthwhile
        # when a fake-bounded variable is actually pressed against its fake
        # bound (nonzero dj); degenerate parks go straight to the primal
        # finish below
        attempts = 0
        while (st == engine.OPTIMAL and _at_fake_bound(lp, state)
               and _pressed_fake(lp, state, model.dual_tolerance) and attempts < 2):
            attempts += 1
            opts = make_opts(opts.dual_bound * 100.0)
            _msg("CLP_DUAL_BOUNDS", bound=opts.dual_bound)
            state = _with_status(state, engine.CONTINUE)
            state = recompute(lp, state, opts.dual_bound)
            state = make_dual_feasible(lp, state, opts)
            state = dsolve(lp, state, opts)
            st = int(state.status)
        if st == engine.OPTIMAL and _at_fake_bound(lp, state):
            # finish with primal from this basis using true bounds, with
            # fake-bound nonbasics demoted to FREE at value 0
            state = _demote_fakes_to_free(lp, state)
            state = _with_status(state, engine.CONTINUE)
            state = psolve(lp, state, opts)
            st = int(state.status)
        if st == engine.PRIMAL_INFEASIBLE and _at_fake_bound(lp, state):
            # an infeasibility claim with fake bounds active is suspect: a
            # genuinely-free nonbasic folded to a fake bound only prices in
            # one direction, so "no eligible entering column" proves nothing.
            # Adjudicate with the primal from true bounds (reference:
            # changeBounds/resetFakeBounds re-check before declaring
            # infeasible, ClpSimplexDual.cpp:143-158,8303).
            state = _demote_fakes_to_free(lp, state)
            state = _with_status(state, engine.CONTINUE)
            state = psolve(lp, state, opts)
            st = int(state.status)
    else:
        ev(Event.BEFORE_STATUS_OF_PROBLEM_IN_PRIMAL)
        ev(Event.START_OF_STATUS_OF_PROBLEM_IN_PRIMAL)
        state = psolve(lp, state, opts)
        st = int(state.status)
        if warm is not None and warm.column_status is None \
                and warm.primal is not None:
            ev(Event.END_OF_VALUES_PASS, iterations=int(state.iterations))
        if st == engine.OPTIMAL:
            ev(Event.LOOKS_END_IN_PRIMAL, iterations=int(state.iterations))
        attempts = 0
        while (
            st == engine.OPTIMAL
            and _pressed_fake(lp, state, model.dual_tolerance)
            and attempts < 3
        ):
            # the primal engine parks infinite-bound entries at the fake
            # bound magnitude too: an "optimum" leaning on a fake bound is
            # not an optimum. Demote the fakes to FREE and continue on true
            # bounds; a real ray then surfaces as DUAL_INFEASIBLE. Loop: the
            # re-solve can park ANOTHER infinite-bound variable the same way.
            attempts += 1
            state = _demote_fakes_to_free(lp, state)
            state = _with_status(state, engine.CONTINUE)
            state = psolve(lp, state, opts)
            st = int(state.status)

    # an unbounded claim must be backed by an exact certificate: a ray d
    # with B d_B = -a_q solved in fresh f64 (not the engine's running
    # inverse), strictly improving cost, and only-infinite bounds in the
    # movement direction. A fabricated claim funnels into the escalation
    # chain below instead of being reported.
    if st == engine.DUAL_INFEASIBLE and not _unbounded_certificate_ok(lp, state):
        state = _with_status(state, engine.NUMERICAL)
        st = engine.NUMERICAL
    # the symmetric exact check for infeasibility claims (Farkas ray
    # re-derived on fresh f64 factors, support-function strictly negative)
    if st == engine.PRIMAL_INFEASIBLE and not _infeasibility_certificate_ok(lp, state):
        state = _with_status(state, engine.NUMERICAL)
        st = engine.NUMERICAL

    # numerical failure: retry once with the other algorithm
    if st in (engine.NUMERICAL, engine.CONTINUE):
        state2 = _with_status(state, engine.CONTINUE)
        if dual:
            state2 = psolve(lp, state2, opts)
        else:
            state2 = recompute(lp, state2, opts.dual_bound)
            state2 = make_dual_feasible(lp, state2, opts)
            state2 = dsolve(lp, state2, opts)
        if int(state2.status) in (engine.OPTIMAL, engine.PRIMAL_INFEASIBLE, engine.DUAL_INFEASIBLE):
            state, st = state2, int(state2.status)

    # mixed-precision escalation: an LP the f32 pivot loop cannot finish
    # (refinement-gate NUMERICAL on every basis, graded/ill-conditioned
    # columns) retries on the full-f64 engine before the perturbation
    # fallback — precision trouble is not degeneracy trouble
    if st in (engine.NUMERICAL, engine.CONTINUE) and opts.inverse_dtype == "float32":
        opts64 = dataclasses.replace(
            opts, inverse_dtype="float64", refactor_frequency=100,
            use_pallas_price=False,
        )
        # continue WARM from the f32 attempt's basis: its pivots are real
        # progress; only a basis the f64 refactor also rejects falls back
        # to cold
        state64 = dataclasses.replace(
            state,
            binv=state.binv.to(lp.G.dtype),
            status=engine._code(engine.CONTINUE, state.status),
        )
        state64 = recompute(lp, state64, opts64.dual_bound)
        if int(state64.status) == engine.NUMERICAL:
            # singular carried basis: cold f64 restart (built in the
            # original column order, then mapped)
            state64 = _to_sorted(initial_state(lp0, opts64) if warm is None
                                 else _warm_state(lp0, opts64, warm, n, m))
            state64 = recompute(lp, state64, opts64.dual_bound)
        if dual:
            state64 = make_dual_feasible(lp, state64, opts64)
            state64 = dsolve(lp, state64, opts64)
        else:
            state64 = psolve(lp, state64, opts64)
        if int(state64.status) in (engine.OPTIMAL, engine.PRIMAL_INFEASIBLE, engine.DUAL_INFEASIBLE):
            state, st, opts = state64, int(state64.status), opts64

    # still stuck: cost-perturbation retry (anti-degeneracy escalation,
    # reference: ClpSimplexDual::perturb, ClpSimplexDual.cpp:6533 — perturb,
    # re-solve, restore true costs, clean up from the perturbed basis)
    if st in (engine.NUMERICAL, engine.CONTINUE, engine.ITER_LIMIT):
        _msg("CLP_SIMPLEX_PERTURB", pct=1e-4)
        rng = np.random.default_rng(model.random_seed)
        c = _np(lp.c)
        scale = 1e-6 * (1.0 + np.abs(c))
        lp_pert = dataclasses.replace(
            lp, c=torch.as_tensor(c + rng.uniform(0.5, 1.0, c.size) * scale,
                                  dtype=lp.c.dtype, device=lp.c.device)
        )
        state3 = _to_sorted(initial_state(lp0, opts) if warm is None
                            else _warm_state(lp0, opts, warm, n, m))
        state3 = recompute(lp_pert, state3, opts.dual_bound)
        state3 = make_dual_feasible(lp_pert, state3, opts)
        state3 = dsolve(lp_pert, state3, opts)
        if int(state3.status) == engine.OPTIMAL:
            # restore true costs, clean up with the primal from this basis
            _msg("CLP_PRIMAL_ORIGINAL")
            state3 = _with_status(state3, engine.CONTINUE)
            state3 = recompute(lp, state3, opts.dual_bound)
            state3 = psolve(lp, state3, opts)
            if int(state3.status) in (engine.OPTIMAL, engine.DUAL_INFEASIBLE):
                state, st = state3, int(state3.status)

    # final guard: NO path may report an OPTIMAL that leans on a fake
    # bound (a nonbasic parked at +-dualBound on an infinite bound). The
    # escalation retries above (algorithm switch / f64 / perturbation)
    # accept their result directly, so re-apply the demote-to-free finish
    # here; a genuine ray surfaces as DUAL_INFEASIBLE.
    attempts = 0
    while (
        st == engine.OPTIMAL
        and _pressed_fake(lp, state, model.dual_tolerance)
        and attempts < 3
    ):
        attempts += 1
        state = _demote_fakes_to_free(lp, state)
        state = _with_status(state, engine.CONTINUE)
        state = psolve(lp, state, opts)
        st = int(state.status)
        # this re-solve runs AFTER the certificate checks above: any claim
        # it produces must be certified here too
        if st == engine.DUAL_INFEASIBLE and not _unbounded_certificate_ok(lp, state):
            state = _with_status(state, engine.NUMERICAL)
            st = engine.NUMERICAL
        if st == engine.PRIMAL_INFEASIBLE and not _infeasibility_certificate_ok(lp, state):
            state = _with_status(state, engine.NUMERICAL)
            st = engine.NUMERICAL

    # disaster handler: pluggable last-resort recovery, fired only after
    # EVERY built-in escalation (algorithm switch -> full-f64 ->
    # perturbation) failed (ClpDisasterHandler contract: check() then
    # typeOfDisaster() 0 = can fix, 1 = abort; ClpEventHandler.hpp:154-167)
    if disaster is not None and st in (engine.NUMERICAL, engine.CONTINUE):
        from ..events import DisasterSnapshot

        snap = DisasterSnapshot(
            model=model,
            algorithm="dual" if dual else "primal",
            status=st,
            iterations=int(state.iterations),
            vstat=_np(_to_orig(state).vstat).copy(),
        )
        disaster.save_info(snap)
        if disaster.check(snap) and disaster.type_of_disaster() == 0:
            _msg("CLP_SINGULAR_FACTOR", n=1)
            allowed = {
                "primal_tolerance", "dual_tolerance", "pivot_tolerance",
                "dual_bound", "refactor_frequency", "max_iterations",
            }
            adj = {k: v for k, v in snap.retry_options.items() if k in allowed}
            opts_r = dataclasses.replace(
                opts, inverse_dtype="float64", use_pallas_price=False,
                use_pallas_pivot=False, **adj,
            )
            state_r = _to_sorted(initial_state(lp0, opts_r))
            state_r = recompute(lp, state_r, opts_r.dual_bound)
            if dual:
                state_r = make_dual_feasible(lp, state_r, opts_r)
                state_r = dsolve(lp, state_r, opts_r)
            else:
                state_r = psolve(lp, state_r, opts_r)
            st_r = int(state_r.status)
            # the recovery claim passes the same exact-certificate gates
            # as every other path
            if st_r == engine.DUAL_INFEASIBLE and not _unbounded_certificate_ok(
                lp, state_r
            ):
                st_r = engine.NUMERICAL
            if st_r == engine.PRIMAL_INFEASIBLE and not _infeasibility_certificate_ok(
                lp, state_r
            ):
                st_r = engine.NUMERICAL
            if st_r in (engine.OPTIMAL, engine.PRIMAL_INFEASIBLE,
                        engine.DUAL_INFEASIBLE):
                state, st, opts = state_r, st_r, opts_r

    ev(Event.END_IN_DUAL if dual else Event.END_IN_PRIMAL, status=st)
    ev(Event.BEFORE_DELETE_RIM)
    sol = _extract(model, lp0, _to_orig(state), opts, st)
    if aborted["flag"]:
        sol.status = ProblemStatus.USER_STOPPED
        _msg("CLP_SIMPLEX_INTERRUPT")
        return sol
    if st == engine.OPTIMAL:
        _msg(
            "CLP_SIMPLEX_FINISHED" if dual else "CLP_PRIMAL_OPTIMAL",
            obj=sol.objective_value,
        )
    elif st == engine.PRIMAL_INFEASIBLE:
        _msg("CLP_SIMPLEX_INFEASIBLE", pinf=float(sol.objective_value))
    elif st == engine.DUAL_INFEASIBLE:
        _msg("CLP_SIMPLEX_UNBOUNDED")
    elif st == engine.ITER_LIMIT:
        _msg("CLP_SIMPLEX_STOPPED", obj=sol.objective_value)
    else:
        _msg("CLP_SIMPLEX_ERROR")
    return sol
