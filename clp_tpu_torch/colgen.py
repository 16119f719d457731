"""Generic column generation — the dynamic-matrix working-set capability.

Reference: ClpDynamicMatrix / ClpDynamicExampleMatrix
(ClpDynamicMatrix.hpp:8-16) let the simplex price columns created on the
fly from a generator. Port of the JAX package's colgen.py: the master is a
dense dual-simplex solve per round on `options.device` ("cuda" unless the
caller asks for the CPU); the user's pricer sees the master duals on the
host and returns new columns until none price out.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import scipy.sparse as sp

from .constants import ProblemStatus, SolveMethod, VariableStatus
from .model import Model, Solution
from .options import SolveOptions

# pricer(duals: np.ndarray) -> sequence of
#   (column: array-like (m,), cost: float, lower: float, upper: float)
Pricer = Callable[[np.ndarray], Sequence[tuple]]


def column_generation(
    master: Model,
    pricer: Pricer,
    options: Optional[SolveOptions] = None,
    max_rounds: int = 200,
) -> Solution:
    """Alternate master solves with user pricing until nothing prices out."""
    options = options or SolveOptions(method=SolveMethod.DUAL_SIMPLEX)
    options.presolve.enabled = False
    from .simplex.driver import simplex_solve

    warm = None
    sol = None
    for _ in range(max_rounds):
        sol = simplex_solve(master, options, dual=True, warm=warm)
        if sol.status != ProblemStatus.OPTIMAL:
            return sol
        sense = master.optimization_direction or 1.0
        new_cols = list(pricer(np.asarray(sol.duals) * sense))
        if not new_cols:
            break
        cols = sp.hstack(
            [sp.csc_matrix(np.asarray(c, dtype=np.float64).reshape(-1, 1))
             for c, *_ in new_cols],
            format="csc",
        )
        master.add_columns(
            cols,
            lower=[lo for _, _, lo, _ in new_cols],
            upper=[up for _, _, _, up in new_cols],
            objective=[cost for _, cost, _, _ in new_cols],
        )
        # warm start: new columns enter nonbasic at lower
        warm = None
        if sol.column_status is not None:
            cs = np.concatenate(
                [sol.column_status,
                 np.full(len(new_cols), int(VariableStatus.AT_LOWER), dtype=np.int8)]
            )
            warm = Solution(column_status=cs, row_status=sol.row_status)
    master.solution = sol
    return sol
