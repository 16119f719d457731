"""Block-structure detection on FLAT models.

The reference solves structured models via ClpSimplex::solve(
CoinStructuredModel*), which inspects the block layout and dispatches
dual / Dantzig-Wolfe / Benders (ClpSolve.cpp:4910-4924; master block
identification :5323-5352) — but the caller must hand it the blocks.
Here the two-stage (Benders) shape is DETECTED from a flat Model: a small
set of LINKING COLUMNS whose removal splits the rows into many
identically-shaped scenario blocks, plus first-stage rows touching only
the linking columns:

    [ A   0   0  ... ]   <- first-stage rows  (x only)
    [ T_1 W_1 0  ... ]   <- scenario 1 rows   (x + y_1)
    [ T_2 0  W_2 ... ]   <- scenario 2 rows   (x + y_2)

Detection is a connected-components pass over the sparsity pattern after
removing the highest-degree columns at a few trial thresholds — O(nnz)
per trial, run only from the AUTOMATIC method chooser, which routes a
detected model to `auto_decompose_solve` (Benders over the batched IPM).
The block-angular (Dantzig-Wolfe) shape is detected the same way over rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from .constants import INF, ProblemStatus, SolveMethod
from .model import Model, Solution
from .options import SolveOptions


# ---------------------------------------------------------------------------
# connectivity (vectorized; replaces the round-4 Python union-find, which
# cost ~15 s of host latency at the 500k-nnz probe cap — ADVICE r4 #1)
# ---------------------------------------------------------------------------


def _bipartite_components(primary_of_nnz: np.ndarray,
                          secondary_of_nnz: np.ndarray,
                          keep_nnz: np.ndarray,
                          n_primary: int,
                          n_secondary: int) -> np.ndarray:
    """Labels over the PRIMARY nodes of the bipartite nnz graph restricted
    to keep_nnz entries — C-speed scipy connected_components, O(nnz).

    Primary nodes with no surviving entry get their own singleton label
    (isolated graph nodes are their own component)."""
    from scipy.sparse.csgraph import connected_components

    r = primary_of_nnz[keep_nnz]
    c = secondary_of_nnz[keep_nnz] + n_primary
    size = n_primary + n_secondary
    G = sp.csr_matrix(
        (np.ones(r.size, dtype=np.int8), (r, c)), shape=(size, size)
    )
    _, labels = connected_components(G, directed=False)
    return labels[:n_primary].astype(np.int64)


def _row_components(row_of_nnz, col_of_nnz, removed_cols, m, n):
    """Join rows sharing a surviving column. Rows touching ONLY removed
    columns keep their own singleton label (first-stage candidates)."""
    return _bipartite_components(
        row_of_nnz, col_of_nnz, ~removed_cols[col_of_nnz], m, n
    )


def _col_components(row_of_nnz, col_of_nnz, removed_rows, m, n):
    return _bipartite_components(
        col_of_nnz, row_of_nnz, ~removed_rows[row_of_nnz], n, m
    )


# ---------------------------------------------------------------------------
# two-stage (Benders) detection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TwoStageDetection:
    """Mapping from a flat model onto the TwoStageLP scenario form."""

    x_cols: np.ndarray  # linking (first-stage) column indices
    stage1_rows: np.ndarray  # rows touching only x columns
    scenario_rows: list  # per scenario: row indices (sorted)
    scenario_cols: list  # per scenario: column indices (sorted)


def detect_two_stage(
    model: Model,
    min_scenarios: int = 4,
    max_link_frac: float = 0.25,
    max_bytes: int = 1 << 30,
) -> Optional[TwoStageDetection]:
    """Detect the two-stage scenario shape on a flat model.

    Tries removing the k highest-degree columns at a few thresholds; a
    hit must produce >= min_scenarios identically-shaped row components
    covering every non-first-stage row, with scenario rows equalities
    and scenario columns bounded [0, inf) (the TwoStageLP contract,
    decompose.py). Returns None when no clean split exists.
    """
    m, n = model.num_rows, model.num_cols
    if m < 64 or n < 8 or model.num_elements == 0:
        return None
    # every pass below is a vectorized O(nnz) scan (scipy csgraph / numpy
    # ufunc.at) — a 5M-nnz probe costs ~1 s total, so the round-4 500k
    # probe cap is gone; the residual cap only bounds pathological inputs
    # (the Benders route's dense per-scenario blocks are budgeted by
    # max_bytes below regardless)
    if model.num_elements > 50_000_000:
        return None
    if model.quadratic_objective is not None:
        return None
    A = model.matrix.tocsc()
    A.sort_indices()
    degree = np.diff(A.indptr)
    order = np.argsort(degree, kind="stable")[::-1]  # high degree first

    indptr, indices = A.indptr, A.indices
    col_of_nnz = np.repeat(np.arange(n, dtype=np.int64), degree)
    # trial removal sizes: whole DEGREE CLASSES first (removing part of a
    # class shatters scenarios in ways the refinement cannot repair —
    # true first-stage columns usually form the top class), then count
    # fractions for degree profiles without a clean class boundary
    deg_sorted = degree[order]
    class_ks = []
    prev = None
    for pos, dv in enumerate(deg_sorted):
        if dv != prev:
            if pos > 0:
                class_ks.append(pos)
            prev = dv
        if len(class_ks) >= 8:
            break
    frac_ks = [max(1, int(n * f))
               for f in (1 / 64, 1 / 32, 1 / 16, 1 / 8, max_link_frac)]
    trial_ks = sorted(set(class_ks + frac_ks))
    for k in trial_ks:
        if k > n * max_link_frac:
            break
        removed = np.zeros(n, dtype=bool)
        removed[order[:k]] = True
        labels = _row_components(indices, col_of_nnz, removed, m, n)
        # refinement: an over-removed column whose rows all share one
        # label is not really linking — return it to that component.
        # (Over-removal happens because k is a trial threshold, not the
        # true first-stage width; true x columns span several scenario
        # components and stay linking.) Each refinement pass recomputes
        # the components with the shrunken linking set: over-removal can
        # SHATTER a scenario into pieces whose columns then look
        # multi-label until their siblings are returned first.
        # Vectorized: per linking column, its rows share one label iff
        # segment max == segment min of labels over its nnz.
        linking = removed.copy()
        for _ in range(3):
            js = np.flatnonzero(linking)
            in_linking = linking[col_of_nnz]
            pos = np.full(n, -1, dtype=np.int64)
            pos[js] = np.arange(js.size)
            p = pos[col_of_nnz[in_linking]]
            lab = labels[indices[in_linking]]
            mx = np.full(js.size, -1, dtype=np.int64)
            mn = np.full(js.size, np.iinfo(np.int64).max, dtype=np.int64)
            np.maximum.at(mx, p, lab)
            np.minimum.at(mn, p, lab)
            single = (mx >= 0) & (mx == mn)  # empty columns stay linking
            if not bool(single.any()):
                break
            linking[js[single]] = False
            labels = _row_components(indices, col_of_nnz, linking, m, n)
        # rows whose every entry is in a linking column = first stage
        row_nnz_surviving = np.bincount(
            indices[~linking[col_of_nnz]], minlength=m
        )
        stage1 = row_nnz_surviving == 0
        comp_ids, counts = np.unique(labels[~stage1], return_counts=True)
        S = comp_ids.size
        if S < min_scenarios or np.unique(counts).size != 1:
            continue
        m2 = int(counts[0])
        # map columns to components: a non-linking column's rows all share
        # one label (the union pass + refinement guarantee it)
        col_label = np.full(n, -1, dtype=np.int64)
        surv = np.flatnonzero(~linking)
        first_row = np.full(n, -1, dtype=np.int64)
        nz = np.flatnonzero(np.diff(A.indptr) > 0)
        first_row[nz] = A.indices[A.indptr[nz]]
        # empty (no-row) columns can't be scenario columns
        if np.any(first_row[surv] < 0):
            continue
        col_label[surv] = labels[first_row[surv]]
        # every component must have identical column counts
        cc_ids, cc_counts = np.unique(col_label[surv], return_counts=True)
        if cc_ids.size != S or np.unique(cc_counts).size != 1:
            continue
        n2 = int(cc_counts[0])
        n1 = int(np.count_nonzero(linking))
        # the TwoStageLP form is dense per scenario: budget the memory
        if S * m2 * (n1 + n2) * 8 > max_bytes:
            continue
        # contract checks: scenario rows are equalities, scenario columns
        # are [0, inf)
        rl, ru = model.row_lower, model.row_upper
        cl, cu = model.col_lower, model.col_upper
        scen_rows_mask = ~stage1
        if not np.all(
            np.abs(rl[scen_rows_mask] - ru[scen_rows_mask]) <= 1e-12
        ):
            continue
        if not (
            np.all(np.abs(cl[surv]) <= 1e-12) and np.all(cu[surv] >= INF)
        ):
            continue
        scenario_rows = []
        scenario_cols = []
        ok = True
        for cid in comp_ids:
            r_idx = np.flatnonzero((labels == cid) & ~stage1)
            c_idx = surv[col_label[surv] == cid]
            if r_idx.size != m2 or c_idx.size != n2:
                ok = False
                break
            scenario_rows.append(r_idx)
            scenario_cols.append(c_idx)
        if not ok:
            continue
        return TwoStageDetection(
            x_cols=np.flatnonzero(linking),
            stage1_rows=np.flatnonzero(stage1),
            scenario_rows=scenario_rows,
            scenario_cols=scenario_cols,
        )
    return None


def build_two_stage(model: Model, det: TwoStageDetection):
    """Materialize the TwoStageLP from the flat model + detection map."""
    from .decompose import TwoStageLP

    A = model.matrix.tocsc()
    x = det.x_cols
    S = len(det.scenario_rows)
    m2 = det.scenario_rows[0].size
    n1 = x.size
    n2 = det.scenario_cols[0].size
    T = np.zeros((S, m2, n1))
    W = np.zeros((S, m2, n2))
    h = np.zeros((S, m2))
    q = np.zeros((S, n2))
    for s in range(S):
        r, c = det.scenario_rows[s], det.scenario_cols[s]
        T[s] = A[r][:, x].toarray()
        W[s] = A[r][:, c].toarray()
        h[s] = model.row_lower[r]
        q[s] = model.objective[c]
    return TwoStageLP(
        c=model.objective[x],
        A=sp.csc_matrix(A[det.stage1_rows][:, x]),
        row_lower=model.row_lower[det.stage1_rows],
        row_upper=model.row_upper[det.stage1_rows],
        col_lower=model.col_lower[x],
        col_upper=model.col_upper[x],
        T=T,
        W=W,
        h=h,
        q=q,
        prob=np.ones(S),  # the flat objective already carries p_s * q_s
    )


# ---------------------------------------------------------------------------
# block-angular (Dantzig-Wolfe) detection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockAngularDetection:
    linking_rows: np.ndarray
    block_rows: list  # per block: row indices
    block_cols: list  # per block: column indices


def detect_block_angular(
    model: Model,
    min_blocks: int = 2,
    max_link_frac: float = 0.25,
) -> Optional[BlockAngularDetection]:
    """Detect linking rows whose removal splits the columns into
    independent blocks (the solveDW shape: one master row block touching
    every column block, ClpSolve.cpp:5323-5352)."""
    m, n = model.num_rows, model.num_cols
    if m < 16 or n < 16 or model.num_elements == 0:
        return None
    if model.quadratic_objective is not None:
        return None
    A_csr = model.matrix.tocsr()
    A_csr.sort_indices()
    degree = np.asarray(A_csr.getnnz(axis=1)).ravel()
    order = np.argsort(degree, kind="stable")[::-1]
    row_of_nnz = np.repeat(np.arange(m, dtype=np.int64), degree)
    cols_nnz = A_csr.indices.astype(np.int64)

    for frac in (1 / 64, 1 / 32, 1 / 16, 1 / 8, max_link_frac):
        k = max(1, int(m * frac))
        if k > m * max_link_frac:
            break
        removed = np.zeros(m, dtype=bool)
        removed[order[:k]] = True
        labels = _col_components(row_of_nnz, cols_nnz, removed, m, n)
        col_nnz_surv = np.bincount(cols_nnz[~removed[row_of_nnz]], minlength=n)
        # columns appearing only in linking rows break the block form
        if np.any(col_nnz_surv == 0):
            continue
        comp_ids = np.unique(labels)
        if comp_ids.size < min_blocks:
            continue
        # rows (non-removed) belong to the component of their columns
        first_col = np.full(m, -1, dtype=np.int64)
        nzr = np.flatnonzero(np.diff(A_csr.indptr) > 0)
        first_col[nzr] = A_csr.indices[A_csr.indptr[nzr]]
        row_label = np.where(first_col >= 0, labels[first_col], -1)
        block_rows, block_cols = [], []
        ok = True
        for cid in comp_ids:
            r_idx = np.flatnonzero(~removed & (row_label == cid))
            if r_idx.size == 0:
                ok = False
                break
            block_rows.append(r_idx)
            block_cols.append(np.flatnonzero(labels == cid))
        if not ok:
            continue
        return BlockAngularDetection(
            linking_rows=np.sort(order[:k]),
            block_rows=block_rows,
            block_cols=block_cols,
        )
    return None


# ---------------------------------------------------------------------------
# auto-decomposition solve
# ---------------------------------------------------------------------------


def auto_decompose_solve(model: Model, options: SolveOptions) -> Optional[Solution]:
    """Detect structure, run the matching decomposition, assemble a full
    flat-model point, and FINISH it with the engines' verified path.

    Returns None whenever detection, the decomposition, or the verified
    finish does not pan out; the caller then takes the standard method
    (decomposeType == 0 -> dual(), ClpSolve.cpp:4914-4916). Only the
    decomposition's own failures (DecompositionError, a non-OPTIMAL
    result) fall back: the JAX package catches every RuntimeError here,
    which in torch would also catch CUDA errors, so those propagate.
    """
    from .decompose import DecompositionError, benders_solve, solve_scenarios

    det = detect_two_stage(model)
    if det is None:
        return None
    try:
        ts = build_two_stage(model, det)
        bsol, x = benders_solve(ts, options)
        if bsol.status != ProblemStatus.OPTIMAL or x is None:
            return None
        # the scenario recourse at the final x, in one batched call
        ys = solve_scenarios(ts, x, options).x.numpy()  # (S, n2)
    except DecompositionError:
        return None

    # assemble the flat primal point
    primal = np.zeros(model.num_cols)
    primal[det.x_cols] = x
    for s in range(len(det.scenario_rows)):
        primal[det.scenario_cols[s]] = ys[s]

    # verified finish from the assembled point (the PDLP-polish pattern):
    # a values-pass dual at dense scale, the crunch polish beyond
    warm = Solution(primal=primal, row_activity=model.matrix @ primal)
    dense_fits = 4 * model.num_rows * (model.num_rows + model.num_cols) <= 4 << 30
    inner = dataclasses.replace(options, method=SolveMethod.DUAL_SIMPLEX)
    if model.num_rows < 2048 and dense_fits:
        from .simplex.driver import simplex_solve

        fin = simplex_solve(model, inner, dual=True, warm=warm)
        return fin if fin.status == ProblemStatus.OPTIMAL else None
    from .bigsolve import crunch_polish

    approx = Solution(
        status=ProblemStatus.OPTIMAL,
        objective_value=float(model.objective @ primal) + model.objective_offset,
        primal=primal,
        row_activity=np.asarray(model.matrix @ primal),
    )
    fin = crunch_polish(model, inner, approx)
    if fin is not None and fin.status == ProblemStatus.OPTIMAL:
        return fin
    return None
