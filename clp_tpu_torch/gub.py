"""GUB (generalized upper bound) structure detection.

Reference: ClpGubMatrix (ClpGubMatrix.hpp:12-20) keeps GUB rows implicit:
the factorized "working" basis covers only the general rows, while each
GUB set carries one basic "key" variable whose value is implied by the
set's convexity row. The port has the detection that routes models to
that solver (SolveMethod.GUB via solve._auto_method); the GUB solver
itself is not ported yet (ROADMAP.md queue 1: the other solvers).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import INF
from .model import Model


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
