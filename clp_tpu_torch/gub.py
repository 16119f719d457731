"""GUB (generalized upper bound) structure detection.

Reference: ClpGubMatrix (ClpGubMatrix.hpp:12-20) keeps GUB rows implicit:
the factorized "working" basis covers only the general rows, while each
GUB set carries one basic "key" variable whose value is implied by the
set's convexity row.

Port of the JAX package's gub.py: the detection that routes models here
(SolveMethod.GUB via solve._auto_method), the GUB crash, and the
key-variable GUB primal simplex with basis import/export
(setGubBasis / getGubBasis, ClpSimplexOther.cpp:6719 / 7121). The solver
pivots on a working basis of the general rows only (m_general x
m_general), with one implicit key per set; it is host-side numpy, a copy,
as the JAX package runs it on the host too.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from .constants import INF, ProblemStatus, VariableStatus
from .model import Model, Solution

_FTOL = 1e-9  # primal feasibility tolerance (internal)
_DTOL = 1e-9  # dual tolerance (internal, scaled by cost magnitude)
_PIVTOL = 1e-8

# internal statuses
_AT_LO = 0
_AT_UP = 1
_BASIC = 2  # in the working basis
_KEY = 3  # the set's implicit basic variable
_FREE = 4  # nonbasic free (at 0)


@dataclasses.dataclass
class GubSet:
    row: int  # the GUB row index
    cols: np.ndarray  # member columns (unit coefficients in that row)
    lower: float  # row bounds (sum of members)
    upper: float


def detect_gub(model: Model, min_size: int = 2) -> list[GubSet]:
    """Find disjoint GUB rows: all-unit coefficient rows with at least one
    finite bound whose columns appear in no other GUB row (first-come
    keeps the row).  A free all-unit row is not a constraint and must NOT
    become a set (its convexity equality would have no rhs).

    Memoized on the identity of the model's matrix + bound arrays: the
    automatic dispatcher and solve_gub both detect, so one solve would
    otherwise pay the row scan twice.
    """
    key = (id(model.matrix), id(model.row_lower), id(model.row_upper),
           min_size)
    cached = getattr(model, "_gub_detect_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    A = model.matrix.tocsr()
    taken = np.zeros(model.num_cols, dtype=bool)
    sets: list[GubSet] = []
    for i in range(model.num_rows):
        s, e = A.indptr[i], A.indptr[i + 1]
        if e - s < min_size:
            continue
        if model.row_lower[i] <= -INF and model.row_upper[i] >= INF:
            continue  # free row: no convexity constraint to exploit
        if not np.allclose(A.data[s:e], 1.0):
            continue
        cols = A.indices[s:e]
        if taken[cols].any():
            continue
        sets.append(
            GubSet(
                row=i,
                cols=cols.copy(),
                lower=float(model.row_lower[i]),
                upper=float(model.row_upper[i]),
            )
        )
        taken[cols] = True
    model._gub_detect_cache = (key, sets)
    return sets


def gub_crash_status(model: Model, sets: list[GubSet]):
    """Build (column_status, row_status) with one key variable per set
    basic (cheapest objective member — ClpGubMatrix's key choice) and the
    GUB-row slacks nonbasic at the binding bound; all other rows' slacks
    basic. Feed as a warm Solution to simplex_solve."""
    n, m = model.num_cols, model.num_rows
    cstat = np.full(n, int(VariableStatus.AT_LOWER), dtype=np.int8)
    rstat = np.full(m, int(VariableStatus.BASIC), dtype=np.int8)
    c = model.objective * (model.optimization_direction or 1.0)
    for gs in sets:
        key = int(gs.cols[np.argmin(c[gs.cols])])
        cstat[key] = int(VariableStatus.BASIC)
        # the key variable replaces the GUB slack in the basis; park the
        # slack at whichever bound exists (equality rows: FIXED)
        if gs.lower == gs.upper:
            rstat[gs.row] = int(VariableStatus.FIXED)
        elif gs.lower > -INF:
            rstat[gs.row] = int(VariableStatus.AT_LOWER)
        else:
            rstat[gs.row] = int(VariableStatus.AT_UPPER)
    return cstat, rstat


# ---------------------------------------------------------------------------
# In-engine GUB primal simplex
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GubForm:
    """Internal min-form of a GUB LP.

    Column layout: [0, n_struct) structural columns of the model,
    [n_struct, n_struct+K) one slack member per GUB row (turns every GUB
    row into an equality with all-unit members), then one slack per
    general row (general rows become  a_i'x - s_i = 0, s in [rl, ru]).
    """

    Ag: np.ndarray  # f64[m_g, N] general-row matrix of all columns
    b: np.ndarray  # f64[m_g] general-row rhs (0 for slack-converted rows)
    c: np.ndarray  # f64[N] costs (min sense; slacks 0)
    lo: np.ndarray  # f64[N] (np.inf convention)
    up: np.ndarray
    set_id: np.ndarray  # int32[N], -1 = not in a set
    set_rhs: np.ndarray  # f64[K] equality rhs per set
    n_struct: int
    n_sets: int
    gub_rows: np.ndarray  # int[K] model row index per set
    gen_rows: np.ndarray  # int[m_g] model row index per general row
    sense: float


def build_gub_form(model: Model, sets: list[GubSet]) -> GubForm:
    """Split the model into GUB convexity rows + general rows.

    Every GUB row gains one slack member so the convexity row is an exact
    equality ``sum_{j in S_k} x_j + s_k = rhs_k`` regardless of its
    original sense; general rows get standard slacks.
    """
    A = model.matrix.tocsr()
    m, n = model.num_rows, model.num_cols
    K = len(sets)
    gub_rows = np.array([gs.row for gs in sets], dtype=np.int64)
    is_gub_row = np.zeros(m, dtype=bool)
    is_gub_row[gub_rows] = True
    gen_rows = np.flatnonzero(~is_gub_row)
    m_g = gen_rows.size

    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0
    Ag = np.zeros((m_g, n + K + m_g))
    Ag[:, :n] = A[gen_rows].toarray()
    Ag[:, n + K:] = -np.eye(m_g)
    b = np.zeros(m_g)

    lo = np.empty(n + K + m_g)
    up = np.empty(n + K + m_g)
    lo[:n] = np.where(model.col_lower <= -INF, -np.inf, model.col_lower)
    up[:n] = np.where(model.col_upper >= INF, np.inf, model.col_upper)
    c = np.zeros(n + K + m_g)
    c[:n] = model.objective * sense

    set_id = np.full(n + K + m_g, -1, dtype=np.int32)
    set_rhs = np.empty(K)
    for k, gs in enumerate(sets):
        set_id[gs.cols] = k
        set_id[n + k] = k
        ru = gs.upper if gs.upper < INF else np.inf
        rl = gs.lower if gs.lower > -INF else -np.inf
        rhs = ru if np.isfinite(ru) else rl
        # slack s = rhs - sum(members): bounds [rhs-ru, rhs-rl]
        set_rhs[k] = rhs
        lo[n + k] = rhs - ru if np.isfinite(ru) else -np.inf
        up[n + k] = rhs - rl if np.isfinite(rl) else np.inf

    rl_g = np.where(model.row_lower[gen_rows] <= -INF, -np.inf, model.row_lower[gen_rows])
    ru_g = np.where(model.row_upper[gen_rows] >= INF, np.inf, model.row_upper[gen_rows])
    lo[n + K:] = rl_g
    up[n + K:] = ru_g
    return GubForm(
        Ag=Ag, b=b, c=c, lo=lo, up=up, set_id=set_id, set_rhs=set_rhs,
        n_struct=n, n_sets=K, gub_rows=gub_rows, gen_rows=gen_rows,
        sense=sense,
    )


class _GubState:
    """Mutable engine state: statuses, values, keys, working basis."""

    def __init__(self, form: GubForm):
        self.form = form
        N = form.c.size
        self.stat = np.full(N, _AT_LO, dtype=np.int8)
        self.x = np.zeros(N)
        self.key = np.zeros(form.n_sets, dtype=np.int64)
        self.wpos = np.zeros(form.Ag.shape[0], dtype=np.int64)
        self.Binv = np.zeros((form.Ag.shape[0],) * 2)
        self.iterations = 0
        self.refactors = 0

    @property
    def wset(self) -> np.ndarray:
        return self.form.set_id[self.wpos].astype(np.int64)

    def nonbasic_to_bounds(self):
        """Park every nonbasic at its recorded bound value."""
        f = self.form
        at_lo, at_up = self.stat == _AT_LO, self.stat == _AT_UP
        self.x[at_lo] = f.lo[at_lo]
        self.x[at_up] = f.up[at_up]
        self.x[self.stat == _FREE] = 0.0

    def refactor(self) -> bool:
        """Rebuild the working-basis inverse and recompute all basic values
        from the nonbasic bounds (the GUB analogue of a refactorization).

        Solving  W w = b - Ag x_N - sum_k Ag[:,key_k] (rhs_k - nbsum_k)
        gives the working values w; keys follow from their convexity rows.
        Returns False if W is numerically singular.
        """
        f = self.form
        m_g = f.Ag.shape[0]
        self.nonbasic_to_bounds()
        W = f.Ag[:, self.wpos].copy()
        ws = self.wset
        in_set = ws >= 0
        if in_set.any():
            W[:, in_set] -= f.Ag[:, self.key[ws[in_set]]]
        if m_g:
            try:
                self.Binv = np.linalg.inv(W)
            except np.linalg.LinAlgError:
                return False
            if not np.all(np.isfinite(self.Binv)):
                return False
        # nonbasic member sums per set + nonbasic general contribution
        xnb = self.x.copy()
        basicish = (self.stat == _BASIC) | (self.stat == _KEY)
        xnb[basicish] = 0.0
        nbsum = np.zeros(f.n_sets)
        np.add.at(nbsum, f.set_id[~basicish & (f.set_id >= 0)],
                  xnb[~basicish & (f.set_id >= 0)])
        key_load = f.set_rhs - nbsum
        rhs = f.b - f.Ag @ xnb - f.Ag[:, self.key] @ key_load
        w = self.Binv @ rhs if m_g else rhs[:0]
        self.x[self.wpos] = w
        wsum = np.zeros(f.n_sets)
        np.add.at(wsum, ws[in_set], w[in_set])
        self.x[self.key] = key_load - wsum
        if not np.all(np.isfinite(self.x[self.wpos])) or not np.all(
                np.isfinite(self.x[self.key])):
            return False  # NaN/inf basics: callers escalate, never report
        self.refactors += 1
        return True


def _cold_state(form: GubForm) -> _GubState:
    """All-slack start: general slacks form the working basis, the GUB
    slack member is every set's key, structurals at the nearest bound."""
    st = _GubState(form)
    N = form.c.size
    n, K = form.n_struct, form.n_sets
    m_g = form.Ag.shape[0]
    lo, up = form.lo, form.up
    prefer_up = np.isfinite(up) & (~np.isfinite(lo) | (np.abs(up) < np.abs(lo)))
    st.stat[:] = np.where(
        prefer_up, _AT_UP, np.where(np.isfinite(lo), _AT_LO, _FREE)
    )
    st.key[:] = n + np.arange(K)
    st.stat[st.key] = _KEY
    st.wpos[:] = n + K + np.arange(m_g)
    st.stat[st.wpos] = _BASIC
    st.refactor()
    return st


def _infeasibility(st: _GubState) -> float:
    f = st.form
    return float(
        np.sum(np.maximum(f.lo - st.x, 0.0), where=np.isfinite(f.lo))
        + np.sum(np.maximum(st.x - f.up, 0.0), where=np.isfinite(f.up))
    )


def gub_simplex(
    form: GubForm,
    warm: Optional[_GubState] = None,
    max_iterations: int = 0,
    refactor_frequency: int = 100,
    max_seconds: Optional[float] = None,
):
    """Primal simplex over the reduced working basis with key accounting.

    Two-phase (composite infeasibility gradient in phase 1, the repo's
    primal-engine convention), Dantzig pricing with a Bland anti-cycling
    fallback.  Per pivot: one BLAS PRICE over all columns, one m_g-sized
    FTRAN, one segment reduction for the key directions, and a rank-1
    inverse update (Sherman-Morrison when the key of the entering set
    leaves; full refactor on cross-set key swaps, which are rare).

    Returns (state, status, extras) where extras carries duals/reduced
    costs/ray of the final iteration.
    """
    f = form
    st = warm if warm is not None else _cold_state(form)
    N = f.c.size
    m_g = f.Ag.shape[0]
    K = f.n_sets
    if max_iterations <= 0:
        max_iterations = 200 * (N + m_g + K) + 20000

    deadline = None if max_seconds is None else time.time() + max_seconds
    fixed = f.lo == f.up
    status = ProblemStatus.UNKNOWN
    y = np.zeros(m_g)
    mu = np.zeros(K)
    d = np.zeros(N)
    ray = None
    since_refactor = 0
    bland = False
    stall = 0
    last_merit = np.inf

    while st.iterations < max_iterations:
        if deadline is not None and st.iterations % 32 == 0 \
                and time.time() > deadline:
            status = ProblemStatus.STOPPED
            break
        phase1 = _infeasibility(st) > _FTOL * (1.0 + np.abs(st.x).max(initial=0.0))
        if phase1:
            cc = np.where(st.x < f.lo - _FTOL, -1.0,
                          np.where(st.x > f.up + _FTOL, 1.0, 0.0))
        else:
            cc = f.c

        # --- PRICE: duals from the working basis, set multipliers from keys
        cw = cc[st.wpos].copy()
        ws = st.wset
        in_set_w = ws >= 0
        if in_set_w.any():
            cw[in_set_w] -= cc[st.key[ws[in_set_w]]]
        y = st.Binv.T @ cw if m_g else cw[:0]
        Agkey = f.Ag[:, st.key]
        mu = cc[st.key] - (y @ Agkey if m_g else np.zeros(K))
        d = cc - (f.Ag.T @ y if m_g else 0.0)
        has_set = f.set_id >= 0
        d[has_set] -= mu[f.set_id[has_set]]

        # --- candidate selection (Dantzig; Bland after stalls)
        dtol = _DTOL * (1.0 + np.abs(cc).max(initial=0.0))
        nb_lo = (st.stat == _AT_LO) & ~fixed
        nb_up = (st.stat == _AT_UP) & ~fixed
        nb_fr = st.stat == _FREE
        viol = np.where(nb_lo, np.maximum(-d, 0.0),
                        np.where(nb_up, np.maximum(d, 0.0),
                                 np.where(nb_fr, np.abs(d), 0.0)))
        if bland:
            elig = np.flatnonzero(viol > dtol)
            if elig.size == 0:
                status = (ProblemStatus.PRIMAL_INFEASIBLE if phase1
                          else ProblemStatus.OPTIMAL)
                break
            q = int(elig[0])
        else:
            q = int(np.argmax(viol))
            if viol[q] <= dtol:
                status = (ProblemStatus.PRIMAL_INFEASIBLE if phase1
                          else ProblemStatus.OPTIMAL)
                break
        sigma = 1.0 if (nb_lo[q] or (nb_fr[q] and d[q] < 0)) else -1.0
        sq = int(f.set_id[q])

        # --- FTRAN + key directions (per unit step t >= 0)
        colq = f.Ag[:, q].copy()
        if sq >= 0:
            colq -= f.Ag[:, st.key[sq]]
        abar = st.Binv @ colq if m_g else colq[:0]
        dw = -sigma * abar
        segsum = np.zeros(K)
        if in_set_w.any():
            np.add.at(segsum, ws[in_set_w], abar[in_set_w])
        dkey = sigma * segsum
        if sq >= 0:
            dkey[sq] -= sigma

        # --- ratio test over working basics, keys, and the entering column
        vals = np.concatenate([st.x[st.wpos], st.x[st.key]])
        delt = np.concatenate([dw, dkey])
        los = np.concatenate([f.lo[st.wpos], f.lo[st.key]])
        ups = np.concatenate([f.up[st.wpos], f.up[st.key]])
        t_all = np.full(m_g + K, np.inf)
        to_up = np.zeros(m_g + K, dtype=bool)
        up_mv = delt > _PIVTOL
        dn_mv = delt < -_PIVTOL
        if phase1:
            # infeasible basics block when they REACH feasibility (at the
            # violated bound); moving AWAY from feasibility never blocks
            # (the composite cost prices that); feasible ones block at
            # their bounds as usual
            below = vals < los - _FTOL
            above = vals > ups + _FTOL
            inside = ~below & ~above
            dd_up = np.where(up_mv, delt, 1.0)
            dd_dn = np.where(dn_mv, -delt, 1.0)
            with np.errstate(invalid="ignore"):
                t_up = np.where(
                    up_mv & below, (los - vals) / dd_up,
                    np.where(up_mv & inside & np.isfinite(ups),
                             np.maximum(ups - vals, 0.0) / dd_up, np.inf))
                t_dn = np.where(
                    dn_mv & above, (vals - ups) / dd_dn,
                    np.where(dn_mv & inside & np.isfinite(los),
                             np.maximum(vals - los, 0.0) / dd_dn, np.inf))
            t_all = np.where(up_mv, t_up, np.where(dn_mv, t_dn, np.inf))
            to_up = (up_mv & inside & np.isfinite(ups)) | (dn_mv & above)
        else:
            with np.errstate(invalid="ignore"):
                t_all = np.where(
                    up_mv & np.isfinite(ups),
                    np.maximum(ups - vals, 0.0) / np.where(up_mv, delt, 1.0),
                    np.where(dn_mv & np.isfinite(los),
                             np.maximum(vals - los, 0.0) / np.where(dn_mv, -delt, 1.0),
                             np.inf))
            to_up = up_mv & np.isfinite(ups)

        t_ent = f.up[q] - f.lo[q] if np.isfinite(f.up[q] - f.lo[q]) else np.inf
        t_min = float(np.min(t_all, initial=np.inf))
        if t_ent <= t_min + 1e-12:
            t = t_ent
            leave = -1  # bound flip
        else:
            t = t_min
            # tie-break on the largest pivot magnitude for stability
            near = np.flatnonzero(t_all <= t_min + 1e-12)
            leave = int(near[np.argmax(np.abs(delt[near]))])
        if not np.isfinite(t):
            if phase1:
                status = ProblemStatus.ERRORS  # cannot happen: phase-1 bounded
                break
            status = ProblemStatus.DUAL_INFEASIBLE
            ray = np.zeros(N)
            ray[q] = sigma
            ray[st.wpos] = dw
            ray[st.key] = dkey
            break

        # --- apply the step
        st.x[q] += sigma * t
        st.x[st.wpos] += t * dw
        st.x[st.key] += t * dkey
        st.iterations += 1
        since_refactor += 1

        if leave < 0:
            st.stat[q] = _AT_UP if sigma > 0 else _AT_LO
        elif leave < m_g:
            # (a) a working basic leaves: product-form rank-1 update
            r = leave
            if np.abs(abar[r]) < _PIVTOL:
                if not st.refactor():
                    status = ProblemStatus.ERRORS
                    break
                since_refactor = 0
                continue
            out = int(st.wpos[r])
            st.stat[out] = _AT_UP if to_up[r] else _AT_LO
            st.x[out] = f.up[out] if to_up[r] else f.lo[out]
            st.wpos[r] = q
            st.stat[q] = _BASIC
            if m_g:
                er = np.zeros(m_g)
                er[r] = 1.0
                st.Binv -= np.outer((abar - er) / abar[r], st.Binv[r])
        else:
            # (b) a key leaves its set
            k = leave - m_g
            old_key = int(st.key[k])
            st.stat[old_key] = _AT_UP if to_up[leave] else _AT_LO
            st.x[old_key] = f.up[old_key] if to_up[leave] else f.lo[old_key]
            if k == sq:
                # the entering column becomes the new key: the set's working
                # columns shift by -colq_adj => Sherman-Morrison on Binv
                denom = 1.0 - segsum[k]
                st.key[k] = q
                st.stat[q] = _KEY
                if m_g and np.abs(denom) > _PIVTOL and in_set_w.any():
                    mask = ws == k
                    if mask.any():
                        vBinv = st.Binv[mask].sum(axis=0)
                        st.Binv += np.outer(abar, vBinv) / denom
                elif m_g and np.abs(denom) <= _PIVTOL:
                    st.refactor()
                    since_refactor = 0
            else:
                # cross-set: promote a working basic of set k to key, free
                # its slot for the entering column, then refactor exactly
                slots = np.flatnonzero(ws == k)
                if slots.size == 0:
                    status = ProblemStatus.ERRORS  # dkey[k] was 0: unreachable
                    break
                r = int(slots[np.argmax(np.abs(abar[slots]))])
                st.key[k] = int(st.wpos[r])
                st.stat[st.key[k]] = _KEY
                st.wpos[r] = q
                st.stat[q] = _BASIC
                if not st.refactor():
                    status = ProblemStatus.ERRORS
                    break
                since_refactor = 0

        if since_refactor >= refactor_frequency:
            if not st.refactor():
                status = ProblemStatus.ERRORS
                break
            since_refactor = 0

        merit = _infeasibility(st) if phase1 else float(cc @ st.x)
        if merit < last_merit - 1e-12 * (1.0 + abs(last_merit)):
            stall = 0
            bland = False
        else:
            stall += 1
            if stall > 2 * (m_g + K) + 50:
                bland = True
        last_merit = merit
    else:
        status = ProblemStatus.STOPPED

    if status == ProblemStatus.OPTIMAL:
        if not st.refactor():  # exact basic values for the claim
            status = ProblemStatus.ERRORS
        elif _infeasibility(st) > 1e-6 * (1.0 + np.abs(st.x).max(initial=0.0)):
            status = ProblemStatus.ERRORS
    return st, status, {"y": y, "mu": mu, "d": d, "ray": ray}


def _gub_solution(model: Model, form: GubForm, st: _GubState, status,
                  extras: dict) -> Solution:
    """Map the internal GUB state back to a model-space Solution."""
    f = form
    n, K = f.n_struct, f.n_sets
    x = st.x[:n].copy()
    m = model.num_rows
    y_full = np.zeros(m)
    y_full[f.gen_rows] = extras["y"]
    y_full[f.gub_rows] = extras["mu"]
    d = f.c[:n] - model.matrix.T @ y_full
    sense = f.sense
    cstat, rstat = gub_statuses(form, st)
    sol = Solution(
        status=status,
        objective_value=float(model.objective @ x) + model.objective_offset,
        primal=x,
        duals=y_full * sense,
        reduced_costs=d * sense,
        row_activity=model.matrix @ x,
        iterations=st.iterations,
        column_status=cstat,
        row_status=rstat,
    )
    if extras.get("ray") is not None:
        sol.unbounded_ray = extras["ray"][:n]
    return sol


def gub_statuses(form: GubForm, st: _GubState):
    """Export the implicit GUB basis as explicit model statuses — the
    getGubBasis analogue (ClpSimplexOther.cpp:7121).

    Keys and working basics are BASIC; the per-set slack member's status
    becomes the GUB row's status (with the bound flip implied by
    ``s = rhs - sum``); general-row statuses come from their slacks.
    """
    f = form
    n, K = f.n_struct, f.n_sets
    m_g = f.Ag.shape[0]
    imap = {_AT_LO: VariableStatus.AT_LOWER, _AT_UP: VariableStatus.AT_UPPER,
            _BASIC: VariableStatus.BASIC, _KEY: VariableStatus.BASIC,
            _FREE: VariableStatus.FREE}
    cstat = np.array([int(imap[s]) for s in st.stat[:n]], dtype=np.int8)
    nrows = (f.gub_rows.size + f.gen_rows.size)
    rstat = np.zeros(nrows, dtype=np.int8)
    for k in range(K):
        s = st.stat[n + k]
        if s in (_BASIC, _KEY):
            r = VariableStatus.BASIC
        elif f.lo[n + k] == f.up[n + k]:
            r = VariableStatus.FIXED
        elif s == _AT_LO:
            r = VariableStatus.AT_UPPER  # s at lower => sum at row upper
        else:
            r = VariableStatus.AT_LOWER
        rstat[f.gub_rows[k]] = int(r)
    for i in range(m_g):
        s = st.stat[n + K + i]
        if s in (_BASIC, _KEY):
            r = VariableStatus.BASIC
        elif f.lo[n + K + i] == f.up[n + K + i]:
            r = VariableStatus.FIXED
        elif s == _AT_LO:
            r = VariableStatus.AT_LOWER  # s IS the activity here: no flip
        elif s == _AT_UP:
            r = VariableStatus.AT_UPPER
        else:
            r = VariableStatus.FREE
        rstat[f.gen_rows[i]] = int(r)
    return cstat, rstat


def gub_state_from_statuses(form: GubForm, cstat: np.ndarray,
                            rstat: np.ndarray) -> Optional[_GubState]:
    """Import explicit model statuses into an implicit GUB state — the
    setGubBasis analogue (ClpSimplexOther.cpp:6719).

    The first basic member of each set becomes its key; remaining basics
    fill the working basis.  Returns None when the statuses cannot be
    repaired into a nonsingular working basis (caller falls back cold).
    """
    f = form
    n, K = f.n_struct, f.n_sets
    m_g = f.Ag.shape[0]
    st = _GubState(form)
    # start everything at a bound, then overlay
    lo_fin = np.isfinite(f.lo)
    st.stat[:] = np.where(lo_fin, _AT_LO,
                          np.where(np.isfinite(f.up), _AT_UP, _FREE))

    basic_cols = [j for j in range(n) if cstat[j] == int(VariableStatus.BASIC)]
    for j in range(n):
        s = int(cstat[j])
        if s == int(VariableStatus.AT_UPPER):
            st.stat[j] = _AT_UP
        elif s in (int(VariableStatus.AT_LOWER), int(VariableStatus.FIXED)):
            st.stat[j] = _AT_LO
        elif s == int(VariableStatus.FREE):
            st.stat[j] = _FREE
    # GUB slack members from row statuses (flip: s = rhs - sum)
    for k in range(K):
        rs = int(rstat[f.gub_rows[k]])
        if rs == int(VariableStatus.BASIC):
            basic_cols.append(n + k)
            continue
        if rs == int(VariableStatus.AT_UPPER):
            st.stat[n + k] = _AT_LO if np.isfinite(f.lo[n + k]) else _FREE
        else:
            st.stat[n + k] = _AT_UP if np.isfinite(f.up[n + k]) else _FREE
    gen_slack_basic = []
    for i in range(m_g):
        rs = int(rstat[f.gen_rows[i]])
        j = n + K + i
        if rs == int(VariableStatus.BASIC):
            gen_slack_basic.append(j)
        elif rs == int(VariableStatus.AT_UPPER):
            st.stat[j] = _AT_UP
        else:
            st.stat[j] = _AT_LO if np.isfinite(f.lo[j]) else _FREE

    # one key per set (first basic member); leftover basics -> working list
    key = np.full(K, -1, dtype=np.int64)
    working: list[int] = []
    for j in basic_cols:
        k = int(f.set_id[j])
        if k >= 0 and key[k] < 0:
            key[k] = j
        else:
            working.append(j)
    working.extend(gen_slack_basic)
    for k in range(K):
        if key[k] < 0:
            key[k] = n + k  # default key: the set's slack member
    st.key[:] = key
    st.stat[key] = _KEY

    # exactly m_g working columns: trim extras, pad with nonbasic general
    # slacks of rows not already represented
    if len(working) > m_g:
        for j in working[m_g:]:
            st.stat[j] = _AT_LO if np.isfinite(f.lo[j]) else (
                _AT_UP if np.isfinite(f.up[j]) else _FREE)
        working = working[:m_g]
    while len(working) < m_g:
        for i in range(m_g):
            j = n + K + i
            if st.stat[j] != _BASIC and j not in working and j not in key:
                working.append(j)
                break
        else:
            return None
    st.wpos[:] = np.array(working, dtype=np.int64)
    st.stat[st.wpos] = _BASIC
    if not st.refactor():
        return None
    return st


def solve_gub(model: Model, options=None,
              warm: Optional[Solution] = None) -> Solution:
    """Solve a GUB-heavy Model with the key-variable GUB simplex.

    Verifies full KKT on the original data before reporting OPTIMAL; any
    failure (numerics, unverifiable claim) raises ValueError so the caller
    can fall back to the dense engine.
    """
    t0 = time.time()
    sets = detect_gub(model)
    if not sets:
        raise ValueError("model has no GUB rows (detect_gub found none)")
    form = build_gub_form(model, sets)
    if np.any(form.lo > form.up + 1e-12):
        sol = Solution(status=ProblemStatus.PRIMAL_INFEASIBLE)
        sol.solve_time = time.time() - t0
        model.solution = sol
        return sol
    state = None
    if warm is not None and warm.column_status is not None:
        state = gub_state_from_statuses(
            form, warm.column_status, warm.row_status)
    max_it = 0
    freq = 100
    max_sec = None
    if options is not None:
        if getattr(options, "max_iterations", None):
            max_it = int(options.max_iterations)
        if getattr(options, "refactor_frequency", None):
            freq = int(options.refactor_frequency)
        max_sec = getattr(options, "max_seconds", None)
    st, status, extras = gub_simplex(
        form, warm=state, max_iterations=max_it, refactor_frequency=freq,
        max_seconds=max_sec)
    sol = _gub_solution(model, form, st, status, extras)
    if status == ProblemStatus.OPTIMAL:
        from .validate import check_kkt

        rep = check_kkt(model, sol.primal, sol.duals, tol=1e-6)
        if not rep.ok:
            raise ValueError(f"GUB engine could not verify KKT: {rep}")
    sol.solve_time = time.time() - t0
    model.solution = sol
    return sol
