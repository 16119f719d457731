"""Presolve / postsolve — LP reductions with a reversible tape.

Equivalent of ClpPresolve driving the CoinPresolve actions
(ClpPresolve.cpp:966-1443). Implemented as vectorized numpy passes over the
host model with a tape of transform records; `postsolve` replays the tape in
reverse to recover the full primal/dual solution (and basis statuses).

Transform order per pass (mirroring the reference's loop):
    empty columns -> fixed columns -> empty rows -> singleton rows (bound
    tightening) -> redundant rows -> doubleton-equality substitution ->
    duplicate rows -> duplicate columns

Statuses: infeasibility detected during presolve reports
PRIMAL_INFEASIBLE with secondary INFEAS_OR_UNBOUNDED_IN_PRESOLVE
(reference: ClpSolve.cpp:1013-1027 semantics).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from .constants import INF, ProblemStatus, VariableStatus
from .model import Model, Solution
from .options import PresolveOptions


@dataclasses.dataclass
class _FixedCols:
    idx: np.ndarray  # original column indices (in the pre-transform frame)
    values: np.ndarray
    costs: np.ndarray
    cols: object  # sparse matrix slice A[:, idx] in the pre-transform frame
    qcols: object = None  # Q[:, idx] (pre-frame) when the objective is QP


@dataclasses.dataclass
class _ForcingRow:
    """Row whose implied activity range touches a bound: every variable in
    the row is forced to its extreme bound (reference: CoinPresolve
    forcing_constraint_action, invoked from ClpPresolve.cpp:966-1443).

    This record only fixes bounds; the fixed-column and empty-row transforms
    do the removals. Postsolve (processed after those reinsertions, i.e. in
    this record's own frame) repairs the duals: picks y_i so every forced
    column's reduced cost has the sign its bound requires.
    """

    row: int
    cols: np.ndarray  # columns in the row (this frame)
    coefs: np.ndarray
    at_lower: np.ndarray  # bool: fixed at its lower bound
    row_at_lower: bool  # activity forced to row_lower (else row_upper)
    costs: np.ndarray  # c[cols] in this frame
    cols_matrix: object  # A[:, cols] in this frame (for dj reconstruction)
    old_lower: np.ndarray  # column bounds before fixing
    old_upper: np.ndarray


@dataclasses.dataclass
class _FreeSingleton:
    """Implied-free singleton column on an equality row: x_j and the row are
    removed; costs of the row's other columns absorb c_j (reference:
    CoinPresolve slack_doubleton / free column singleton).
    """

    row: int  # row index in the pre-transform frame
    col: int  # column index in the pre-transform frame
    a: float  # A[row, col]
    rhs: float
    c_out: float
    row_full: object  # sparse 1 x n row (pre-frame, INCLUDING col)


@dataclasses.dataclass
class _Tripleton:
    """Equality row with 3 entries: an implied-free variable substituted out
    (reference: CoinPresolve tripleton_action). Like _Doubleton but with two
    surviving columns and no bound folding (implied-free makes it safe).
    """

    row: int
    col_out: int
    col_keep: np.ndarray  # two surviving columns (pre-frame indices)
    a: float  # coefficient of col_out in the row
    b_keep: np.ndarray  # coefficients of the survivors
    rhs: float
    c_out: float
    col_j: object  # sparse column A[:, col_out] (pre-frame, row removed)


@dataclasses.dataclass
class _EmptyRows:
    idx: np.ndarray


@dataclasses.dataclass
class _SingletonRows:
    idx: np.ndarray  # removed row indices (pre-transform frame)
    col: np.ndarray  # the column each row constrained
    coef: np.ndarray  # its coefficient
    old_lower: np.ndarray  # column bounds before tightening
    old_upper: np.ndarray
    new_lower: np.ndarray
    new_upper: np.ndarray


@dataclasses.dataclass
class _RedundantRows:
    """Rows whose activity range can never bind: dropped with zero dual."""

    idx: np.ndarray


@dataclasses.dataclass
class _DuplicateRows:
    """Identical rows: bounds intersect onto the kept row; postsolve moves
    the dual to whichever row's ORIGINAL bound is actually binding
    (reference: CoinPresolve dupN_action attribution)."""

    idx: np.ndarray  # dropped row indices (pre-transform frame)
    kept: np.ndarray  # the surviving duplicate for each dropped row
    drop_lower: np.ndarray  # dropped rows' own bounds (pre-transform)
    drop_upper: np.ndarray
    kept_lower: np.ndarray  # kept rows' bounds BEFORE intersection
    kept_upper: np.ndarray
    rows: object = None  # sparse A[kept, :] in the pre-frame (columns match)


@dataclasses.dataclass
class _DuplicateCols:
    """Identical equal-cost columns merged: kept gets summed bounds.

    Postsolve splits the merged value back greedily within each original
    column's bounds (any split is optimal — the columns are identical).
    """

    drop: np.ndarray  # dropped column indices (pre-transform frame)
    kept: np.ndarray  # merge target for each dropped column
    drop_lower: np.ndarray
    drop_upper: np.ndarray
    kept_lower: np.ndarray  # kept column's ORIGINAL bounds
    kept_upper: np.ndarray


@dataclasses.dataclass
class _Doubleton:
    """Equality row a*x_j + b*x_k = rhs: x_j substituted out.

    Frame note: `row` and columns refer to the model state just before THIS
    substitution (one record per eliminated variable).
    """

    row: int
    col_out: int  # j, eliminated
    col_keep: int  # k (index in the pre-substitution frame)
    a: float
    b: float
    rhs: float
    c_out: float  # objective coefficient of x_j before elimination
    col_j: object  # sparse column A[:, j] (pre-frame, row `row` removed)
    old_keep_lower: float
    old_keep_upper: float


@dataclasses.dataclass
class PresolveInfo:
    status: ProblemStatus = ProblemStatus.UNKNOWN
    tape: list = dataclasses.field(default_factory=list)
    original: Optional[Model] = None


def _remove_fixed_columns(model: Model, tape: list, tol: float) -> bool:
    fixed = np.flatnonzero(
        (model.col_upper - model.col_lower) <= tol * (1 + np.abs(model.col_lower))
    )
    if fixed.size == 0:
        return False
    vals = 0.5 * (model.col_lower[fixed] + model.col_upper[fixed])
    A = model.matrix
    cols = A[:, fixed]
    contrib = cols @ vals
    Q = model.quadratic_objective
    qcols = None if Q is None else sp.csc_matrix(Q)[:, fixed].copy()
    tape.append(_FixedCols(fixed, vals, model.objective[fixed].copy(), cols,
                           qcols=qcols))
    model.objective_offset += float(model.objective[fixed] @ vals)
    keep = np.setdiff1d(np.arange(model.num_cols), fixed)
    if Q is not None:
        # min c'x + .5 x'Qx with x_f = v: kept gradient gains Q_kf v,
        # offset gains .5 v'Q_ff v
        Qc = sp.csc_matrix(Q)
        model.objective = model.objective + np.asarray(qcols @ vals).ravel()
        model.objective_offset += 0.5 * float(vals @ (qcols[fixed, :] @ vals))
        model.quadratic_objective = Qc[keep, :][:, keep].tocsc()
    model._A = A[:, keep].tocsc()
    model.col_lower = model.col_lower[keep]
    model.col_upper = model.col_upper[keep]
    model.objective = model.objective[keep]
    if model.col_names is not None:
        model.col_names = [model.col_names[j] for j in keep]
    if model.integer_mask is not None:
        model.integer_mask = model.integer_mask[keep]
    model.row_lower = np.where(model.row_lower > -INF, model.row_lower - contrib, model.row_lower)
    model.row_upper = np.where(model.row_upper < INF, model.row_upper - contrib, model.row_upper)
    return True


def _remove_empty_rows(model: Model, tape: list, tol: float) -> Optional[bool]:
    counts = np.diff(model.matrix.tocsr().indptr)
    empty = np.flatnonzero(counts == 0)
    if empty.size == 0:
        return False
    if np.any(model.row_lower[empty] > tol) or np.any(model.row_upper[empty] < -tol):
        return None  # infeasible
    tape.append(_EmptyRows(empty))
    keep = np.setdiff1d(np.arange(model.num_rows), empty)
    model._A = model.matrix[keep, :].tocsc()
    model.row_lower = model.row_lower[keep]
    model.row_upper = model.row_upper[keep]
    if model.row_names is not None:
        model.row_names = [model.row_names[i] for i in keep]
    return True


def _singleton_rows(model: Model, tape: list, tol: float) -> Optional[bool]:
    """Rows with one entry become column-bound tightenings and vanish."""
    Ar = model.matrix.tocsr()
    counts = np.diff(Ar.indptr)
    singles = np.flatnonzero(counts == 1)
    if singles.size == 0:
        return False
    cols = np.empty(singles.size, dtype=np.int64)
    coefs = np.empty(singles.size)
    for k, i in enumerate(singles):
        p = Ar.indptr[i]
        cols[k] = Ar.indices[p]
        coefs[k] = Ar.data[p]
    old_lo = model.col_lower[cols].copy()
    old_up = model.col_upper[cols].copy()
    # implied bounds per row: rl/a <= x <= ru/a (order by sign of a).
    # Bounds are +-1e30-coded: dividing the code by a coefficient would
    # produce spurious "finite" bounds, so mask the infinite sides first.
    rl_s = model.row_lower[singles]
    ru_s = model.row_upper[singles]
    rl_ok = rl_s > -INF
    ru_ok = ru_s < INF
    with np.errstate(divide="ignore", invalid="ignore"):
        lo_i = np.where(
            coefs > 0,
            np.where(rl_ok, rl_s / coefs, -INF),
            np.where(ru_ok, ru_s / coefs, -INF),
        )
        up_i = np.where(
            coefs > 0,
            np.where(ru_ok, ru_s / coefs, INF),
            np.where(rl_ok, rl_s / coefs, INF),
        )
    # combine duplicates targeting the same column
    new_lo = model.col_lower.copy()
    new_up = model.col_upper.copy()
    np.maximum.at(new_lo, cols, lo_i)
    np.minimum.at(new_up, cols, up_i)
    if np.any(new_lo > new_up + tol * (1 + np.abs(new_lo))):
        return None  # infeasible
    tape.append(
        _SingletonRows(
            singles, cols, coefs, old_lo, old_up,
            new_lo[cols].copy(), new_up[cols].copy(),
        )
    )
    model.col_lower = new_lo
    model.col_upper = new_up
    keep = np.setdiff1d(np.arange(model.num_rows), singles)
    model._A = model.matrix[keep, :].tocsc() if keep.size else sp.csc_matrix((0, model.num_cols))
    model.row_lower = model.row_lower[keep]
    model.row_upper = model.row_upper[keep]
    if model.row_names is not None:
        model.row_names = [model.row_names[i] for i in keep]
    return True


def _fix_empty_columns(model: Model, tape: list, tol: float) -> Optional[bool]:
    """Columns with no matrix entries: pin at the cost-preferred bound.

    c_j > 0 -> lower, c_j < 0 -> upper, c_j = 0 -> any finite bound (or 0).
    An empty column pushed toward an infinite bound is dual infeasible
    (unbounded); returns None for that (distinct from False = no change).
    """
    counts = np.diff(model.matrix.indptr)
    empty = np.flatnonzero(counts == 0)
    empty = empty[model.col_lower[empty] != model.col_upper[empty]]
    if model.quadratic_objective is not None and empty.size:
        # a column with Q terms is not "empty" in effect: its optimum can be
        # interior (gradient c_j + (Qx)_j), so leave it to the barrier
        Q = sp.csc_matrix(model.quadratic_objective)
        qcounts = np.diff(Q.indptr)
        empty = empty[qcounts[empty] == 0]
    if empty.size == 0:
        return False
    c = model.objective[empty]
    lo = model.col_lower[empty]
    up = model.col_upper[empty]
    target = np.where(
        c > tol, lo, np.where(c < -tol, up, np.where(lo > -INF, lo, np.minimum(up, 0.0)))
    )
    if np.any((c > tol) & (lo <= -INF)) or np.any((c < -tol) & (up >= INF)):
        return None  # unbounded
    model.col_lower = model.col_lower.copy()
    model.col_upper = model.col_upper.copy()
    model.col_lower[empty] = target
    model.col_upper[empty] = target
    return True  # the fixed-column transform removes them next


def _redundant_rows(model: Model, tape: list, tol: float) -> Optional[bool]:
    """Drop rows that can never bind given the column bounds.

    Implied activity range [min_act, max_act] from column bounds; a row with
    min_act >= rl and max_act <= ru is redundant (dual 0, slack basic). Also
    detects infeasibility when the implied range misses [rl, ru] entirely.
    """
    A = model.matrix.tocsr()
    m, n = A.shape
    if m == 0:
        return False
    pos = A.maximum(0)
    neg = A.minimum(0)
    cl = np.where(model.col_lower <= -INF, -np.inf, model.col_lower)
    cu = np.where(model.col_upper >= INF, np.inf, model.col_upper)
    with np.errstate(invalid="ignore"):
        max_act = pos @ cu + neg @ cl
        min_act = pos @ cl + neg @ cu
    max_act = np.where(np.isnan(max_act), np.inf, max_act)
    min_act = np.where(np.isnan(min_act), -np.inf, min_act)
    # map the +-1e30 coding to true infinities; the tolerance scale must
    # only see FINITE bound magnitudes (a 1e30-coded bound would otherwise
    # blow feas_tol up to ~1e23 and mark infeasible rows redundant)
    rl = np.where(model.row_lower <= -INF, -np.inf, model.row_lower)
    ru = np.where(model.row_upper >= INF, np.inf, model.row_upper)
    fin_mag = np.maximum(
        np.where(np.isfinite(rl), np.abs(rl), 0.0),
        np.where(np.isfinite(ru), np.abs(ru), 0.0),
    )
    feas_tol = tol * (1.0 + fin_mag)
    if np.any(min_act > ru + feas_tol) or np.any(max_act < rl - feas_tol):
        return None  # infeasible
    redundant = (min_act >= rl - feas_tol) & (max_act <= ru + feas_tol) & (
        np.diff(A.indptr) > 0
    )
    idx = np.flatnonzero(redundant)
    if idx.size == 0:
        return False
    tape.append(_RedundantRows(idx))
    keep = np.setdiff1d(np.arange(m), idx)
    model._A = model.matrix.tocsc()[keep, :].tocsc()
    model.row_lower = model.row_lower[keep]
    model.row_upper = model.row_upper[keep]
    if model.row_names is not None:
        model.row_names = [model.row_names[i] for i in keep]
    return True


def _forcing_rows(model: Model, tape: list, tol: float) -> bool:
    """Fix every variable of a row whose activity range touches a row bound.

    max_act == row_lower  => activity must sit at its maximum: every column
    in the row goes to its max-contributing bound (cu if a>0 else cl).
    min_act == row_upper  => symmetric. The row then empties out via the
    fixed-column + empty-row transforms; the tape record repairs duals.
    Reference: CoinPresolve forcing_constraint_action.
    """
    A = model.matrix.tocsr()
    m, n = A.shape
    if m == 0:
        return False
    pos = A.maximum(0)
    neg = A.minimum(0)
    cl = np.where(model.col_lower <= -INF, -np.inf, model.col_lower)
    cu = np.where(model.col_upper >= INF, np.inf, model.col_upper)
    with np.errstate(invalid="ignore"):
        max_act = pos @ cu + neg @ cl
        min_act = pos @ cl + neg @ cu
    max_act = np.where(np.isnan(max_act), np.inf, max_act)
    min_act = np.where(np.isnan(min_act), -np.inf, min_act)
    rl = np.where(model.row_lower <= -INF, -np.inf, model.row_lower)
    ru = np.where(model.row_upper >= INF, np.inf, model.row_upper)
    counts = np.diff(A.indptr)
    feas = tol * (1.0 + np.where(np.isfinite(rl), np.abs(rl), 0.0)
                  + np.where(np.isfinite(ru), np.abs(ru), 0.0))
    force_lo = np.isfinite(rl) & np.isfinite(max_act) & (max_act <= rl + feas) & (counts > 1)
    force_up = np.isfinite(ru) & np.isfinite(min_act) & (min_act >= ru - feas) & (counts > 1)
    idx = np.flatnonzero(force_lo | force_up)
    if idx.size == 0:
        return False
    model.col_lower = model.col_lower.copy()
    model.col_upper = model.col_upper.copy()
    done_cols: set = set()
    changed = False
    for i in idx:
        s, e = A.indptr[i], A.indptr[i + 1]
        cols = A.indices[s:e].astype(np.int64)
        if any(int(j) in done_cols for j in cols):
            continue  # one forcing decision per column per pass
        coefs = A.data[s:e].astype(np.float64)
        at_lo_row = bool(force_lo[i])
        # activity at max: a>0 -> upper, a<0 -> lower; at min: flipped
        to_upper = (coefs > 0) == at_lo_row
        tgt = np.where(to_upper, model.col_upper[cols], model.col_lower[cols])
        if np.any(np.abs(tgt) >= INF):
            continue  # would fix at infinity — numerical guard
        tape.append(_ForcingRow(
            row=int(i), cols=cols, coefs=coefs,
            at_lower=~to_upper, row_at_lower=at_lo_row,
            costs=model.objective[cols].copy(),
            cols_matrix=model.matrix[:, cols].copy(),
            old_lower=model.col_lower[cols].copy(),
            old_upper=model.col_upper[cols].copy(),
        ))
        model.col_lower[cols] = tgt
        model.col_upper[cols] = tgt
        done_cols.update(int(j) for j in cols)
        changed = True
    return changed


def _implied_range(row_cols, row_coefs, skip_pos, rhs_lo, rhs_ru, cl, cu):
    """Implied value range for the variable at position skip_pos of a row."""
    a = row_coefs[skip_pos]
    rest_lo = rest_up = 0.0
    for t in range(row_cols.size):
        if t == skip_pos:
            continue
        ak = row_coefs[t]
        k = row_cols[t]
        lo_k = cl[k] if cl[k] > -INF else -np.inf
        up_k = cu[k] if cu[k] < INF else np.inf
        if ak > 0:
            rest_lo += ak * lo_k
            rest_up += ak * up_k
        else:
            rest_lo += ak * up_k
            rest_up += ak * lo_k
    # a * x + rest in [rhs_lo, rhs_ru]
    with np.errstate(invalid="ignore"):
        c1 = (rhs_lo - rest_up) / a
        c2 = (rhs_ru - rest_lo) / a
    lo, up = (c1, c2) if a > 0 else (c2, c1)
    if np.isnan(lo):
        lo = -np.inf
    if np.isnan(up):
        up = np.inf
    return lo, up


def _free_col_singletons(model: Model, tape: list, tol: float) -> bool:
    """Remove implied-free singleton columns on equality rows.

    x_j appears only in equality row i: substitute x_j = (b - rest)/a.
    No fill anywhere — the row is dropped and c_j folds into the row's other
    columns. Reference: CoinPresolve free/implied-free column singletons.
    """
    Ac = model.matrix.tocsc()
    colcounts = np.diff(Ac.indptr)
    singles = np.flatnonzero(colcounts == 1)
    if singles.size == 0:
        return False
    Ar = model.matrix.tocsr()
    used_rows: set = set()
    changed = False
    # collect removals first (all records share one pre-frame only if rows
    # and cols are disjoint — enforce via used sets, then apply one by one)
    for j in singles:
        p = Ac.indptr[j]
        i = int(Ac.indices[p])
        a = float(Ac.data[p])
        if i in used_rows or abs(a) < 1e-11:
            continue
        if abs(model.row_upper[i] - model.row_lower[i]) > tol * (1 + abs(model.row_lower[i])):
            continue  # only equality rows
        if model.row_lower[i] <= -INF or model.row_upper[i] >= INF:
            continue
        b = float(model.row_lower[i])
        s, e = Ar.indptr[i], Ar.indptr[i + 1]
        row_cols = Ar.indices[s:e].astype(np.int64)
        row_coefs = Ar.data[s:e].astype(np.float64)
        pos_j = int(np.flatnonzero(row_cols == j)[0])
        lo_i, up_i = _implied_range(row_cols, row_coefs, pos_j, b, b,
                                    model.col_lower, model.col_upper)
        l_j, u_j = model.col_lower[j], model.col_upper[j]
        # tolerance scales must stay FINITE: an infinite implied bound would
        # otherwise make the containment test vacuously true
        ok_lo = (l_j <= -INF) or (
            np.isfinite(lo_i) and lo_i >= l_j - tol * (1 + abs(lo_i))
        )
        ok_up = (u_j >= INF) or (
            np.isfinite(up_i) and up_i <= u_j + tol * (1 + abs(up_i))
        )
        if not (ok_lo and ok_up):
            continue
        c_j = float(model.objective[j])
        tape.append(_FreeSingleton(
            row=i, col=int(j), a=a, rhs=b, c_out=c_j,
            row_full=Ar[i, :].copy(),
        ))
        # fold objective: c_k -= (c_j/a) * a_ik for the row's other columns
        if c_j != 0.0:
            model.objective = model.objective.copy()
            for t in range(row_cols.size):
                if row_cols[t] != j:
                    model.objective[row_cols[t]] -= (c_j / a) * row_coefs[t]
            model.objective_offset += c_j * b / a
        model.delete_columns([int(j)])
        model.delete_rows([i])
        return True  # frames shift: one elimination per call, loop re-enters
    return changed


def _tripleton_rows(model: Model, tape: list, tol: float, limit: int = 50) -> Optional[bool]:
    """Substitute an implied-free variable out of 3-entry equality rows.

    Reference: CoinPresolve tripleton_action. Bound folding is impossible
    with two survivors, so the eliminated variable must be implied free.
    """
    return _subst_eq_rows(model, tape, tol, nent_lo=3, nent_hi=3, limit=limit)


def _implied_free_subst(model: Model, tape: list, tol: float,
                        limit: int = 50) -> Optional[bool]:
    """Substitute implied-free variables out of general equality rows.

    The general-row extension of the tripleton transform (reference:
    CoinPresolve implied_free_action + subst_constraint_action, invoked via
    ClpPresolve.cpp:966-1443 at substitution level 3). Rows of 4-6 entries
    qualify; the eliminated column's fill-in is capped by its nnz.
    """
    return _subst_eq_rows(model, tape, tol, nent_lo=4, nent_hi=6,
                          limit=limit, max_col_nnz=5)


def _subst_eq_rows(model: Model, tape: list, tol: float, nent_lo: int,
                   nent_hi: int, limit: int = 50,
                   max_col_nnz: int = 10 ** 9) -> Optional[bool]:
    """Eliminate one implied-free variable per qualifying equality row.

    Shared engine for tripleton (3-entry) and implied-free (general) row
    substitution; the _Tripleton record/postsolve handles any survivor count.
    """
    changed = False
    for _ in range(limit):
        Ar = model.matrix.tocsr()
        counts = np.diff(Ar.indptr)
        eq = (model.row_lower == model.row_upper) & (counts >= nent_lo) & (
            counts <= nent_hi
        ) & (model.row_lower > -INF)
        rows = np.flatnonzero(eq)
        colcounts = np.diff(model.matrix.tocsc().indptr)
        hit = False
        for i in rows:
            i = int(i)
            s, e = Ar.indptr[i], Ar.indptr[i + 1]
            row_cols = Ar.indices[s:e].astype(np.int64)
            row_coefs = Ar.data[s:e].astype(np.float64)
            nent = row_cols.size
            b = float(model.row_lower[i])
            # pick the implied-free candidate with the largest |coef|
            order = np.argsort(-np.abs(row_coefs))
            pick = -1
            for t in order:
                if abs(row_coefs[t]) < 1e-7:
                    break
                if colcounts[row_cols[t]] - 1 > max_col_nnz:
                    continue  # fill-in cap (substitution level analogue)
                lo_i, up_i = _implied_range(row_cols, row_coefs, int(t), b, b,
                                            model.col_lower, model.col_upper)
                l_j = model.col_lower[row_cols[t]]
                u_j = model.col_upper[row_cols[t]]
                ok_lo = l_j <= -INF or (
                    np.isfinite(lo_i) and lo_i >= l_j - tol * (1 + abs(lo_i))
                )
                ok_up = u_j >= INF or (
                    np.isfinite(up_i) and up_i <= u_j + tol * (1 + abs(up_i))
                )
                if ok_lo and ok_up:
                    pick = int(t)
                    break
            if pick < 0:
                continue
            j = int(row_cols[pick])
            a = float(row_coefs[pick])
            keep_pos = [t for t in range(nent) if t != pick]
            kcols = row_cols[keep_pos]
            kcoefs = row_coefs[keep_pos]

            A = model.matrix.tocsc()
            col_j = A[:, j].copy()
            keep_rows = np.setdiff1d(np.arange(model.num_rows), [i])
            tape.append(_Tripleton(
                row=i, col_out=j, col_keep=kcols.copy(), a=a,
                b_keep=kcoefs.copy(), rhs=b,
                c_out=float(model.objective[j]),
                col_j=col_j[keep_rows],
            ))
            # substitute x_j = (b - sum_k kcoef*x_k)/a into every other row
            shift = np.asarray((col_j * (b / a)).todense()).ravel()
            colj = np.asarray(col_j.todense()).ravel()
            Anew = A.tolil()
            for kk, bk in zip(kcols, kcoefs):
                colk = np.asarray(A[:, int(kk)].todense()).ravel()
                newk = colk - colj * (bk / a)
                for r in np.flatnonzero(colj):
                    Anew[int(r), int(kk)] = newk[int(r)]
            model._A = Anew.tocsc()
            model.objective = model.objective.copy()
            for kk, bk in zip(kcols, kcoefs):
                model.objective[int(kk)] -= model.objective[j] * (bk / a)
            model.objective_offset += model.objective[j] * (b / a)
            model.row_lower = np.where(model.row_lower > -INF, model.row_lower - shift, model.row_lower)
            model.row_upper = np.where(model.row_upper < INF, model.row_upper - shift, model.row_upper)
            model.delete_columns([j])
            model.delete_rows([i])
            changed = True
            hit = True
            break
        if not hit:
            return changed
    return changed


def _row_signature(A: sp.csr_matrix):
    """Hashable signature per row (pattern + values, rounded)."""
    sigs = []
    for i in range(A.shape[0]):
        s, e = A.indptr[i], A.indptr[i + 1]
        sigs.append((tuple(A.indices[s:e]), tuple(np.round(A.data[s:e], 12))))
    return sigs


def _duplicate_rows(model: Model, tape: list, tol: float) -> Optional[bool]:
    A = model.matrix.tocsr()
    m = A.shape[0]
    if m < 2:
        return False
    seen: dict = {}
    drop, kept = [], []
    drop_lo, drop_up, kept_lo, kept_up = [], [], [], []
    orig_lo = np.asarray(model.row_lower).copy()
    orig_up = np.asarray(model.row_upper).copy()
    for i, sig in enumerate(_row_signature(A)):
        if not sig[0]:
            continue  # empty rows handled elsewhere
        if sig in seen:
            k = seen[sig]
            # record pre-intersection bounds for dual attribution at postsolve
            drop_lo.append(orig_lo[i])
            drop_up.append(orig_up[i])
            kept_lo.append(orig_lo[k])
            kept_up.append(orig_up[k])
            # intersect bounds onto the kept row
            model.row_lower = model.row_lower.copy()
            model.row_upper = model.row_upper.copy()
            model.row_lower[k] = max(model.row_lower[k], model.row_lower[i])
            model.row_upper[k] = min(model.row_upper[k], model.row_upper[i])
            if model.row_lower[k] > model.row_upper[k] + tol * (1 + abs(model.row_lower[k])):
                return None  # infeasible
            drop.append(i)
            kept.append(k)
        else:
            seen[sig] = i
    if not drop:
        return False
    tape.append(_DuplicateRows(
        np.asarray(drop), np.asarray(kept),
        np.asarray(drop_lo), np.asarray(drop_up),
        np.asarray(kept_lo), np.asarray(kept_up),
        rows=A[np.asarray(kept), :].copy(),
    ))
    keep_rows = np.setdiff1d(np.arange(m), np.asarray(drop))
    model._A = A[keep_rows, :].tocsc()
    model.row_lower = model.row_lower[keep_rows]
    model.row_upper = model.row_upper[keep_rows]
    if model.row_names is not None:
        model.row_names = [model.row_names[i] for i in keep_rows]
    return True


def _dual_fix_columns(model: Model, tape: list, tol: float) -> Optional[bool]:
    """Fix monotone (weakly dominated) columns at their cost-preferred bound.

    A column is monotone-down when decreasing it can never violate any row:
    every a_ij > 0 entry sits in a row with no finite lower bound and every
    a_ij < 0 entry in a row with no finite upper bound. With c_j >= 0 an
    optimal solution exists with x_j at its lower bound; symmetric for
    monotone-up / c_j <= 0. If the preferred bound is infinite the LP is
    dual infeasible (returns None). Reference: CoinPresolve
    remove_dual_action's weak-domination fixes (ClpPresolve.cpp:966-1443).
    """
    if model.integer_mask is not None and model.integer_mask.any():
        return False
    A = model.matrix.tocsc()
    if A.shape[1] == 0 or A.nnz == 0:
        return False
    # dual sign cone per row (min convention, dj = c - A'y, y>0 at lower):
    # y_hi = +inf iff row_lower finite, else 0; y_lo = -inf iff row_upper
    # finite, else 0.
    hi_inf = model.row_lower > -INF
    lo_inf = model.row_upper < INF
    B = A.copy()
    B.data = np.ones_like(B.data)
    pos = A.maximum(0).astype(bool).astype(np.float64)
    neg = (-A).maximum(0).astype(bool).astype(np.float64)
    # sup over the cone of A_j'y is +inf iff the column touches a
    # (a>0, y_hi=+inf) or (a<0, y_lo=-inf) entry — otherwise it is 0
    sup_inf = (pos.T @ hi_inf.astype(np.float64)
               + neg.T @ lo_inf.astype(np.float64)) > 0.5
    inf_neg = (pos.T @ lo_inf.astype(np.float64)
               + neg.T @ hi_inf.astype(np.float64)) > 0.5
    c = model.objective
    unfixed = model.col_upper - model.col_lower > tol * (1 + np.abs(model.col_lower))
    down = (~sup_inf) & (c >= 0.0) & unfixed
    up = (~inf_neg) & (c <= 0.0) & unfixed & ~down
    if np.any(down & (c > tol) & (model.col_lower <= -INF)):
        return None  # strictly improving toward -inf: unbounded
    if np.any(up & (c < -tol) & (model.col_upper >= INF)):
        return None
    down &= model.col_lower > -INF
    up &= model.col_upper < INF
    if not (down.any() or up.any()):
        return False
    model.col_lower = model.col_lower.copy()
    model.col_upper = model.col_upper.copy()
    model.col_upper[down] = model.col_lower[down]
    model.col_lower[up] = model.col_upper[up]
    return True  # the fixed-column transform removes them next


def _duplicate_cols(model: Model, tape: list, tol: float,
                    dominated: bool = False) -> bool:
    A = model.matrix.tocsc()
    n = A.shape[1]
    if n < 2 or (model.integer_mask is not None and model.integer_mask.any()):
        return False
    seen: dict = {}
    drop, kept, dl, du, kl, ku = [], [], [], [], [], []
    c = model.objective
    if dominated:
        # identical columns with DIFFERENT costs: all mass belongs on the
        # cheaper one when it has unlimited headroom — fix the costlier at
        # its lower bound (reference: dupcol_action's dominated case).
        seen_nc: dict = {}
        fixed_any = False
        for j in range(n):
            s, e = A.indptr[j], A.indptr[j + 1]
            if s == e:
                continue
            sig = (tuple(A.indices[s:e]), tuple(np.round(A.data[s:e], 12)))
            k = seen_nc.get(sig)
            if k is None:
                seen_nc[sig] = j
                continue
            cheap, costly = (k, j) if c[k] <= c[j] else (j, k)
            if (
                abs(c[cheap] - c[costly]) > tol
                and model.col_upper[cheap] >= INF
                and model.col_lower[costly] > -INF
                and model.col_upper[costly] > model.col_lower[costly]
            ):
                model.col_lower = model.col_lower.copy()
                model.col_upper = model.col_upper.copy()
                model.col_upper[costly] = model.col_lower[costly]
                fixed_any = True  # swept by the fixed-column transform
            seen_nc[sig] = cheap
        return fixed_any
    for j in range(n):
        s, e = A.indptr[j], A.indptr[j + 1]
        if s == e:
            continue  # empty columns handled elsewhere
        sig = (tuple(A.indices[s:e]), tuple(np.round(A.data[s:e], 12)),
               round(float(c[j]), 12))
        if sig in seen:
            k = seen[sig]
            if k in drop:
                continue
            if model.col_lower[j] <= -INF or model.col_lower[k] <= -INF:
                continue
            drop.append(j)
            kept.append(k)
            dl.append(model.col_lower[j])
            du.append(model.col_upper[j])
            kl.append(model.col_lower[k])
            ku.append(model.col_upper[k])
        else:
            seen[sig] = j
    if not drop:
        return False
    model.col_lower = model.col_lower.copy()
    model.col_upper = model.col_upper.copy()
    for jj, kk in zip(drop, kept):
        # summed-interval bounds (INF-coded: saturate)
        lo = model.col_lower[kk]
        lo2 = model.col_lower[jj]
        model.col_lower[kk] = -INF if (lo <= -INF or lo2 <= -INF) else lo + lo2
        up = model.col_upper[kk]
        up2 = model.col_upper[jj]
        model.col_upper[kk] = INF if (up >= INF or up2 >= INF) else up + up2
    tape.append(
        _DuplicateCols(
            np.asarray(drop), np.asarray(kept),
            np.asarray(dl), np.asarray(du), np.asarray(kl), np.asarray(ku),
        )
    )
    model.delete_columns(drop)
    return True


def _doubleton_rows(model: Model, tape: list, tol: float, limit: int = 200) -> Optional[bool]:
    """Substitute out one variable per 2-entry EQUALITY row.

    a*x_j + b*x_k = rhs  =>  x_j = (rhs - b*x_k)/a; x_j's bounds fold onto
    x_k; column j merges into column k. Processes up to `limit` rows per
    pass, one at a time (each substitution changes the frame).
    """
    changed = False
    for _ in range(limit):
        Ar = model.matrix.tocsr()
        counts = np.diff(Ar.indptr)
        eq = (model.row_lower == model.row_upper) & (counts == 2)
        rows = np.flatnonzero(eq)
        if rows.size == 0:
            return changed
        i = int(rows[0])
        p = Ar.indptr[i]
        j, k = int(Ar.indices[p]), int(Ar.indices[p + 1])
        a, b = float(Ar.data[p]), float(Ar.data[p + 1])
        # eliminate the variable with the larger |coef| for stability
        if abs(a) < abs(b):
            j, k = k, j
            a, b = b, a
        if abs(a) < 1e-12:
            return changed  # degenerate coefficient; leave to the solver
        rhs = float(model.row_lower[i])

        # fold x_j's bounds onto x_k: x_j = (rhs - b*x_k)/a in [l_j, u_j]
        l_j, u_j = model.col_lower[j], model.col_upper[j]
        cands = []
        for bound in (l_j, u_j):
            if -INF < bound < INF:
                cands.append((rhs - a * bound) / b)
        # NOTE: host bounds are +-1e30-coded, so test against INF, never
        # np.isfinite (1e30 IS float-finite)
        has_l = l_j > -INF
        has_u = u_j < INF
        if abs(b) > 1e-12 and cands:
            lo_i, up_i = min(cands), max(cands)
            if not (has_l and has_u):
                # one-sided: only one implied bound applies
                if has_l != has_u:
                    implied = cands[0]
                    sign = (b / a > 0)
                    # x_j >= l_j <=> x_k <= (rhs - a l_j)/b when b/a > 0
                    if has_l:
                        lo_i, up_i = (-INF, implied) if sign else (implied, INF)
                    else:
                        lo_i, up_i = (implied, INF) if sign else (-INF, implied)
        else:
            lo_i, up_i = -INF, INF

        old_kl, old_ku = float(model.col_lower[k]), float(model.col_upper[k])
        new_kl = max(old_kl, lo_i)
        new_ku = min(old_ku, up_i)
        if new_kl > new_ku + tol * (1 + abs(new_kl)):
            return None  # infeasible

        A = model.matrix.tocsc()
        col_j = A[:, j].copy()
        keep_rows = np.setdiff1d(np.arange(model.num_rows), [i])
        col_j_reduced = col_j[keep_rows]
        tape.append(
            _Doubleton(
                row=i, col_out=j, col_keep=k, a=a, b=b, rhs=rhs,
                c_out=float(model.objective[j]),
                col_j=col_j_reduced,
                old_keep_lower=old_kl, old_keep_upper=old_ku,
            )
        )

        # substitution: A[:,k] += A[:,j]*(-b/a); row-bound shift by A[:,j]*rhs/a
        shift = np.asarray((col_j * (rhs / a)).todense()).ravel()
        Anew = A.tolil()
        colk = np.asarray(A[:, k].todense()).ravel()
        colj = np.asarray(col_j.todense()).ravel()
        newk = colk - colj * (b / a)
        for r in range(model.num_rows):
            Anew[r, k] = newk[r]
        model._A = Anew.tocsc()
        model.objective = model.objective.copy()
        model.objective[k] -= model.objective[j] * (b / a)
        model.objective_offset += model.objective[j] * (rhs / a)
        model.row_lower = np.where(model.row_lower > -INF, model.row_lower - shift, model.row_lower)
        model.row_upper = np.where(model.row_upper < INF, model.row_upper - shift, model.row_upper)
        model.col_lower = model.col_lower.copy()
        model.col_upper = model.col_upper.copy()
        model.col_lower[k] = new_kl
        model.col_upper[k] = new_ku
        model.delete_columns([j])
        model.delete_rows([i])
        changed = True
    return changed


def presolve(model: Model, options: PresolveOptions) -> tuple[Model, PresolveInfo]:
    """Return (reduced model, tape info). The input model is untouched."""
    info = PresolveInfo(original=model)
    work = model.copy()
    tol = getattr(options, "tolerance", 1e-10)
    # drop sub-zeroTolerance coefficients (reference: small-element cleanup)
    ztol = getattr(options, "zero_coefficient_tol", 0.0)
    if ztol > 0 and work.num_elements:
        A = work.matrix.tocsc().copy()
        mask = np.abs(A.data) < ztol
        if mask.any():
            A.data[mask] = 0.0
            A.eliminate_zeros()
            work._A = A
    # crossed bounds are infeasible, not fixed (check before any transform)
    if np.any(model.col_lower > model.col_upper + 1e-9) or np.any(
        model.row_lower > model.row_upper + 1e-9
    ):
        info.status = ProblemStatus.PRIMAL_INFEASIBLE
        return work, info
    for _ in range(max(1, options.passes)):
        changed = False
        if options.empty_rows_cols:
            r = _fix_empty_columns(work, info.tape, tol)
            if r is None:
                info.status = ProblemStatus.DUAL_INFEASIBLE
                return work, info
            changed |= r
        if options.dual_fixing and work.quadratic_objective is None:
            r = _dual_fix_columns(work, info.tape, tol)
            if r is None:
                info.status = ProblemStatus.DUAL_INFEASIBLE
                return work, info
            changed |= r
        if options.fixed_variables:
            changed |= _remove_fixed_columns(work, info.tape, tol)
        if options.empty_rows_cols:
            r = _remove_empty_rows(work, info.tape, tol)
            if r is None:
                info.status = ProblemStatus.PRIMAL_INFEASIBLE
                return work, info
            changed |= r
        if options.singleton_rows:
            r = _singleton_rows(work, info.tape, tol)
            if r is None:
                info.status = ProblemStatus.PRIMAL_INFEASIBLE
                return work, info
            changed |= r
        if options.forcing:
            r = _redundant_rows(work, info.tape, tol)
            if r is None:
                info.status = ProblemStatus.PRIMAL_INFEASIBLE
                return work, info
            changed |= r
        is_qp = work.quadratic_objective is not None
        if options.forcing and not is_qp:
            changed |= _forcing_rows(work, info.tape, tol)
        if options.singleton_cols and not is_qp:
            for _k in range(200):
                if not _free_col_singletons(work, info.tape, tol):
                    break
                changed = True
        if options.doubleton and not is_qp:
            r = _doubleton_rows(work, info.tape, tol)
            if r is None:
                info.status = ProblemStatus.PRIMAL_INFEASIBLE
                return work, info
            changed |= r
        if options.tripleton and not is_qp:
            r = _tripleton_rows(work, info.tape, tol)
            if r is None:
                info.status = ProblemStatus.PRIMAL_INFEASIBLE
                return work, info
            changed |= r
        if options.implied_free and not is_qp:
            r = _implied_free_subst(work, info.tape, tol)
            if r is None:
                info.status = ProblemStatus.PRIMAL_INFEASIBLE
                return work, info
            changed |= r
        if options.duplicate_rows:
            r = _duplicate_rows(work, info.tape, tol)
            if r is None:
                info.status = ProblemStatus.PRIMAL_INFEASIBLE
                return work, info
            changed |= r
        if options.duplicate_cols and not is_qp:
            changed |= _duplicate_cols(work, info.tape, tol)
        if options.dominated_cols and not is_qp:
            changed |= _duplicate_cols(work, info.tape, tol, dominated=True)
        if not changed:
            break
    # quick infeasibility screens
    if np.any(work.col_lower > work.col_upper + tol) or np.any(
        work.row_lower > work.row_upper + tol
    ):
        info.status = ProblemStatus.PRIMAL_INFEASIBLE
        return work, info
    info.status = ProblemStatus.UNKNOWN
    return work, info


def postsolve(model: Model, info: PresolveInfo, sol: Solution) -> Solution:
    """Replay the tape backwards, rebuilding x, y, dj, and statuses.

    Each record is interpreted in its OWN frame (the model state at the time
    the transform ran); a running (x, y, dj) triple is maintained through the
    reversal — the standard presolve-postsolve contract (CoinPresolve's
    *_action::postsolve works the same way).
    """
    x = None if sol.primal is None else np.asarray(sol.primal, dtype=np.float64).copy()
    y = None if sol.duals is None else np.asarray(sol.duals, dtype=np.float64).copy()
    dj = (
        None
        if sol.reduced_costs is None
        else np.asarray(sol.reduced_costs, dtype=np.float64).copy()
    )
    cstat = None if sol.column_status is None else np.asarray(sol.column_status).copy()
    rstat = None if sol.row_status is None else np.asarray(sol.row_status).copy()

    if x is None:
        out = dataclasses.replace(sol)
        model.solution = out
        return out

    for rec in reversed(info.tape):
        if isinstance(rec, _FixedCols):
            n_after = x.size
            n_before = n_after + rec.idx.size
            keep = np.setdiff1d(np.arange(n_before), rec.idx)
            xs = np.empty(n_before)
            xs[keep] = x
            xs[rec.idx] = rec.values
            x = xs
            if dj is not None:
                djs = np.empty(n_before)
                djs[keep] = dj
                # reduced cost of a re-inserted fixed column in this frame
                yv = y if y is not None else np.zeros(rec.cols.shape[0])
                djs[rec.idx] = rec.costs - np.asarray(rec.cols.T @ yv).ravel()
                if rec.qcols is not None:
                    # QP gradient: c + Qx (x in this frame, post-reinsertion)
                    djs[rec.idx] += np.asarray(rec.qcols.T @ xs).ravel()
                dj = djs
            if cstat is not None:
                cs = np.empty(n_before, dtype=cstat.dtype)
                cs[keep] = cstat
                cs[rec.idx] = int(VariableStatus.FIXED)
                cstat = cs
        elif isinstance(rec, _DuplicateRows):
            m_before = (0 if y is None else y.size) + rec.idx.size
            keep = np.setdiff1d(np.arange(m_before), rec.idx)
            ys = np.zeros(m_before)
            if y is not None:
                ys[keep] = y
            if rstat is not None:
                rs = np.full(m_before, int(VariableStatus.BASIC), dtype=rstat.dtype)
                rs[keep] = rstat
            else:
                rs = None
            # dual attribution: presolve intersected bounds onto the kept
            # row, so a binding bound may belong to a DROPPED duplicate.
            # Move the dual to the row whose own original bound is binding
            # (CoinPresolve dupN_action semantics).
            sense = model.optimization_direction or 1.0
            for t_i in range(rec.idx.size):
                kk = int(rec.kept[t_i])
                ii = int(rec.idx[t_i])
                yk = ys[kk]
                if abs(yk) <= 1e-11 or rec.rows is None:
                    continue
                act = float((rec.rows[t_i] @ x)[0])
                at_lower = yk * sense > 0  # min: y>0 <=> lower bound active
                own_bnd = rec.kept_lower[t_i] if at_lower else rec.kept_upper[t_i]
                dup_bnd = rec.drop_lower[t_i] if at_lower else rec.drop_upper[t_i]
                tol_b = 1e-7 * (1.0 + abs(act))
                if abs(act - own_bnd) <= tol_b:
                    continue  # kept row's own bound is binding: dual stays
                if abs(act - dup_bnd) <= tol_b:
                    ys[ii] = yk
                    ys[kk] = 0.0
                    if rs is not None:
                        rs[ii] = rs[kk]
                        rs[kk] = int(VariableStatus.BASIC)
            y = ys
            if rs is not None:
                rstat = rs
        elif isinstance(rec, _DuplicateCols):
            n_before = x.size + rec.drop.size
            keep = np.setdiff1d(np.arange(n_before), rec.drop)
            xs = np.empty(n_before)
            xs[keep] = x
            djs = None
            if dj is not None:
                djs = np.empty(n_before)
                djs[keep] = dj
            cs = None
            if cstat is not None:
                cs = np.empty(n_before, dtype=cstat.dtype)
                cs[keep] = cstat
            # split each merged value greedily from the lower corner
            # (identical columns and costs: any feasible split is optimal)
            for t_i in range(rec.drop.size):
                jj = int(rec.drop[t_i])
                kk = int(rec.kept[t_i])
                v = xs[kk]
                lo_k, up_k = rec.kept_lower[t_i], rec.kept_upper[t_i]
                lo_j, up_j = rec.drop_lower[t_i], rec.drop_upper[t_i]
                xk = min(max(v - lo_j, lo_k), up_k if up_k < INF else v - lo_j)
                xj = v - xk
                xj = min(max(xj, lo_j), up_j if up_j < INF else xj)
                xk = v - xj
                xs[kk] = xk
                xs[jj] = xj
                if djs is not None:
                    djs[jj] = djs[kk]
                if cs is not None:
                    tol_j = 1e-7 * (1 + abs(xj))
                    if abs(xj - lo_j) <= tol_j:
                        cs[jj] = int(VariableStatus.AT_LOWER)
                    elif up_j < INF and abs(xj - up_j) <= tol_j:
                        cs[jj] = int(VariableStatus.AT_UPPER)
                    else:
                        cs[jj] = int(VariableStatus.BASIC)
            x = xs
            dj = djs
            cstat = cs
        elif isinstance(rec, _Doubleton):
            # current frame: col j and row i are absent
            j, k_pre, i = rec.col_out, rec.col_keep, rec.row
            k_cur = k_pre - (1 if k_pre > j else 0)
            xk = x[k_cur]
            xj = (rec.rhs - rec.b * xk) / rec.a
            # reinsert column j
            n_before = x.size + 1
            keepc = np.setdiff1d(np.arange(n_before), [j])
            xs = np.empty(n_before)
            xs[keepc] = x
            xs[j] = xj
            x = xs
            # reinsert row i with the dual that zeroes dj_j
            m_before = (0 if y is None else y.size) + 1
            keepr = np.setdiff1d(np.arange(m_before), [i])
            ys = np.zeros(m_before)
            if y is not None:
                ys[keepr] = y
            colj_dot = float(rec.col_j.T.dot(ys[keepr])[0]) if y is not None else 0.0
            ys[i] = (rec.c_out - colj_dot) / rec.a
            y = ys
            dj = None  # recomputed wholesale at the end
            if cstat is not None:
                cs = np.empty(n_before, dtype=cstat.dtype)
                cs[keepc] = cstat
                cs[j] = int(VariableStatus.BASIC)
                cstat = cs
            if rstat is not None:
                rs = np.empty(m_before, dtype=rstat.dtype)
                rs[keepr] = rstat
                rs[i] = int(VariableStatus.FIXED)
                rstat = rs
        elif isinstance(rec, _ForcingRow):
            # frame: row + columns all present (later removals already
            # unwound). Repair the forcing row's dual so each fixed column's
            # reduced cost has the sign its bound requires.
            i = rec.row
            sense = model.optimization_direction or 1.0
            if y is None:
                y = np.zeros(rec.cols_matrix.shape[0])
            dj_loc = rec.costs - np.asarray(rec.cols_matrix.T @ y).ravel()
            ylo, yup = -np.inf, np.inf
            for t in range(rec.cols.size):
                a = rec.coefs[t]
                ratio = dj_loc[t] / a
                # at lower needs sense*dj>=0 after dj -= a*y_i; at upper <=0
                wants_le = (rec.at_lower[t] == (a * sense > 0))
                if wants_le:
                    yup = min(yup, ratio)
                else:
                    ylo = max(ylo, ratio)
            # row-bound dual sign: min problem, active lower => y>=0
            if rec.row_at_lower:
                ylo = max(ylo, 0.0) if sense > 0 else ylo
                yup = min(yup, 0.0) if sense < 0 else yup
            else:
                yup = min(yup, 0.0) if sense > 0 else yup
                ylo = max(ylo, 0.0) if sense < 0 else ylo
            if ylo > yup:  # numerically empty window: least-violation point
                ylo = yup = 0.5 * (ylo + yup)
            yi = min(max(0.0, ylo), yup)
            y[i] = yi
            new_dj = dj_loc - rec.coefs * yi
            if dj is not None:
                dj[rec.cols] = new_dj
            if cstat is not None:
                cstat[rec.cols] = np.where(
                    rec.at_lower, int(VariableStatus.AT_LOWER),
                    int(VariableStatus.AT_UPPER),
                )
                # the column whose dj was zeroed becomes basic for the row
                if abs(yi) > 1e-11:
                    t_star = int(np.argmin(np.abs(new_dj)))
                    cstat[rec.cols[t_star]] = int(VariableStatus.BASIC)
                    if rstat is not None:
                        rstat[i] = int(
                            VariableStatus.AT_LOWER if rec.row_at_lower
                            else VariableStatus.AT_UPPER
                        )
        elif isinstance(rec, _FreeSingleton):
            i, j, a = rec.row, rec.col, rec.a
            n_before = x.size + 1
            keepc = np.setdiff1d(np.arange(n_before), [j])
            xs = np.zeros(n_before)
            xs[keepc] = x
            rest = float((rec.row_full @ xs)[0])
            xs[j] = (rec.rhs - rest) / a
            x = xs
            m_before = (0 if y is None else y.size) + 1
            keepr = np.setdiff1d(np.arange(m_before), [i])
            ys = np.zeros(m_before)
            if y is not None:
                ys[keepr] = y
            ys[i] = rec.c_out / a  # zeroes dj_j (x_j basic on row i)
            y = ys
            dj = None
            if cstat is not None:
                cs = np.empty(n_before, dtype=cstat.dtype)
                cs[keepc] = cstat
                cs[j] = int(VariableStatus.BASIC)
                cstat = cs
            if rstat is not None:
                rs = np.empty(m_before, dtype=rstat.dtype)
                rs[keepr] = rstat
                rs[i] = int(VariableStatus.FIXED)
                rstat = rs
        elif isinstance(rec, _Tripleton):
            j, i = rec.col_out, rec.row
            k_cur = rec.col_keep - (rec.col_keep > j)
            xk = x[k_cur]
            xj = (rec.rhs - float(rec.b_keep @ xk)) / rec.a
            n_before = x.size + 1
            keepc = np.setdiff1d(np.arange(n_before), [j])
            xs = np.empty(n_before)
            xs[keepc] = x
            xs[j] = xj
            x = xs
            m_before = (0 if y is None else y.size) + 1
            keepr = np.setdiff1d(np.arange(m_before), [i])
            ys = np.zeros(m_before)
            if y is not None:
                ys[keepr] = y
            colj_dot = float(rec.col_j.T.dot(ys[keepr])[0]) if y is not None else 0.0
            ys[i] = (rec.c_out - colj_dot) / rec.a
            y = ys
            dj = None
            if cstat is not None:
                cs = np.empty(n_before, dtype=cstat.dtype)
                cs[keepc] = cstat
                cs[j] = int(VariableStatus.BASIC)
                cstat = cs
            if rstat is not None:
                rs = np.empty(m_before, dtype=rstat.dtype)
                rs[keepr] = rstat
                rs[i] = int(VariableStatus.FIXED)
                rstat = rs
        elif isinstance(rec, (_EmptyRows, _RedundantRows)):
            m_after = 0 if y is None else y.size
            m_before = m_after + rec.idx.size
            keep = np.setdiff1d(np.arange(m_before), rec.idx)
            ys = np.zeros(m_before)
            if y is not None:
                ys[keep] = y
            y = ys
            if rstat is not None:
                rs = np.empty(m_before, dtype=rstat.dtype)
                rs[keep] = rstat
                rs[rec.idx] = int(VariableStatus.BASIC)
                rstat = rs
        elif isinstance(rec, _SingletonRows):
            m_after = 0 if y is None else y.size
            m_before = m_after + rec.idx.size
            keep = np.setdiff1d(np.arange(m_before), rec.idx)
            ys = np.zeros(m_before)
            if y is not None:
                ys[keep] = y
            if rstat is not None:
                rs = np.full(m_before, int(VariableStatus.BASIC), dtype=rstat.dtype)
                rs[keep] = rstat
            else:
                rs = None
            for k in range(rec.idx.size):
                i, j, a = rec.idx[k], rec.col[k], rec.coef[k]
                # if x_j sits strictly inside its PRE-TIGHTENING bounds but
                # has a nonzero reduced cost, that cost belongs to the
                # removed row: transfer it (y_i = dj_j / a -> dj_j = 0)
                tol = 1e-7 * (1.0 + abs(x[j]))
                strict_inside = (x[j] > rec.old_lower[k] + tol) and (
                    x[j] < rec.old_upper[k] - tol
                )
                if dj is not None and strict_inside and abs(dj[j]) > 1e-9:
                    ys[i] = dj[j] / a
                    dj[j] = 0.0
                    if rs is not None:
                        sense = model.optimization_direction or 1.0
                        if ys[i] * sense > 0:  # min: y>0 <=> active at lower
                            rs[i] = int(VariableStatus.AT_LOWER)
                        else:
                            rs[i] = int(VariableStatus.AT_UPPER)
                        if cstat is not None:
                            cstat[j] = int(VariableStatus.BASIC)
            y = ys
            rstat = rs

    A = model.matrix
    if y is None or y.size != model.num_rows:
        y = np.zeros(model.num_rows)
    if dj is None or dj.size != model.num_cols:
        dj = model.objective - A.T @ y
        if model.quadratic_objective is not None:
            dj = dj + model.quadratic_objective @ x
    row_act = A @ x

    # certificate rays: extend through the tape with zeros for removed rows
    # and drop the certificate if the zero-extension is no longer valid
    # (e.g. the infeasibility involved a singleton-tightened bound)
    infeas_ray = sol.infeasibility_ray
    if infeas_ray is not None and infeas_ray.size != model.num_rows:
        ray = np.asarray(infeas_ray, dtype=np.float64)
        for rec in reversed(info.tape):
            if isinstance(rec, (_EmptyRows, _RedundantRows, _SingletonRows)):
                m_before = ray.size + rec.idx.size
                keep = np.setdiff1d(np.arange(m_before), rec.idx)
                rr = np.zeros(m_before)
                rr[keep] = ray
                ray = rr
            elif isinstance(rec, _DuplicateRows):
                m_before = ray.size + rec.idx.size
                keep = np.setdiff1d(np.arange(m_before), rec.idx)
                rr = np.zeros(m_before)
                rr[keep] = ray
                ray = rr
            elif isinstance(rec, (_Doubleton, _Tripleton, _FreeSingleton)):
                m_before = ray.size + 1
                keep = np.setdiff1d(np.arange(m_before), [rec.row])
                rr = np.zeros(m_before)
                rr[keep] = ray
                ray = rr
        if ray.size == model.num_rows:
            # Farkas validity on the original data: ray'A has the certifying
            # sign pattern; keep only if it still certifies
            combo = A.T @ ray
            rl = np.where(model.row_lower <= -INF, 0.0, model.row_lower)
            ru = np.where(model.row_upper >= INF, 0.0, model.row_upper)
            rhs = float(np.sum(np.where(ray > 0, ray * rl, ray * ru)))
            cl = model.col_lower
            cu = model.col_upper
            lhs_max = float(
                np.sum(
                    np.where(combo > 0, combo * np.where(cu < INF, cu, 0.0),
                             combo * np.where(cl > -INF, cl, 0.0))
                )
            )
            bad = (np.any((combo > 1e-9) & (cu >= INF))
                   or np.any((combo < -1e-9) & (cl <= -INF))
                   or lhs_max >= rhs - 1e-9)
            infeas_ray = None if bad else ray
        else:
            infeas_ray = None
    obj = float(model.objective @ x) + model.objective_offset
    if model.quadratic_objective is not None:
        obj += 0.5 * float(x @ (model.quadratic_objective @ x))
    if cstat is not None:
        # FIXED is reserved for columns whose ORIGINAL bounds coincide
        # (Clp Status::isFixed). Columns fixed by presolve itself (dual
        # fixing, forcing rows) on a genuine range revert to the bound
        # status their value matches.
        was_fixed = cstat == int(VariableStatus.FIXED)
        rng = model.col_upper - model.col_lower > 1e-12 * (
            1.0 + np.abs(model.col_lower)
        )
        at_up = was_fixed & rng & (
            np.abs(x - model.col_upper) <= np.abs(x - model.col_lower)
        )
        cstat = np.where(
            was_fixed & rng,
            np.where(
                at_up,
                int(VariableStatus.AT_UPPER),
                int(VariableStatus.AT_LOWER),
            ),
            cstat,
        ).astype(cstat.dtype)
    out = Solution(
        status=sol.status,
        secondary_status=sol.secondary_status,
        objective_value=obj,
        primal=x,
        duals=y,
        reduced_costs=dj,
        row_activity=row_act,
        iterations=sol.iterations,
        column_status=cstat,
        row_status=rstat,
        infeasibility_ray=infeas_ray,
        unbounded_ray=sol.unbounded_ray
        if sol.unbounded_ray is not None and sol.unbounded_ray.size == model.num_cols
        else None,
        timings=dict(sol.timings or {}),
    )
    model.solution = out
    return out
