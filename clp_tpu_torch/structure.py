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
per trial, run only from the AUTOMATIC method chooser. The decomposition
solve the detection routes to is not ported yet (ROADMAP.md queue 1:
AUTOMATIC destinations, DECOMPOSE).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from .constants import INF
from .model import Model


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
