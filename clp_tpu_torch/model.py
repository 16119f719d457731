"""Problem container — the ClpModel equivalent.

Holds the LP/QP data on the host (numpy + scipy.sparse CSC):

    minimize    c'x + (1/2) x'Qx + obj_offset
    subject to  row_lower <= A x <= row_upper
                col_lower <=   x <= col_upper

Reference surface covered (ClpModel.hpp): load_problem (:87-120),
read/write MPS (:131,:326), add/delete rows & columns (:160-244), bound and
objective setters, scaling control (:724), status + solution accessors
(:437-552), int/double parameters (:1124-1161), optimization direction,
quadratic objective (:122-127), integer markers, ray accessors (:875-899).

Unlike the reference there is no class hierarchy of matrix kinds
(ClpMatrixBase + 6 subclasses, ClpMatrixBase.hpp:38): the TPU build keeps one
CSC host container plus *structure annotations* (detected ±1 / network
structure drives kernel selection downstream, per SURVEY.md §7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp

from .constants import (
    INF,
    PRIMAL_TOLERANCE,
    DUAL_TOLERANCE,
    ProblemStatus,
    SecondaryStatus,
    ScalingMode,
    VariableStatus,
)


def _as_f64(x, n: int, default: float) -> np.ndarray:
    if x is None:
        return np.full(n, default, dtype=np.float64)
    a = np.asarray(x, dtype=np.float64).reshape(-1).copy()
    if a.size != n:
        raise ValueError(f"expected length {n}, got {a.size}")
    return a


@dataclasses.dataclass
class Solution:
    """Solve results attached to a Model."""

    status: ProblemStatus = ProblemStatus.UNKNOWN
    secondary_status: SecondaryStatus = SecondaryStatus.NONE
    objective_value: float = 0.0
    # primal values per column; duals per row; reduced costs per column;
    # row activity = A x.
    primal: Optional[np.ndarray] = None
    duals: Optional[np.ndarray] = None
    reduced_costs: Optional[np.ndarray] = None
    row_activity: Optional[np.ndarray] = None
    iterations: int = 0
    # basis status per column then per row slack (VariableStatus codes)
    column_status: Optional[np.ndarray] = None
    row_status: Optional[np.ndarray] = None
    # certificate rays (reference: ClpModel.hpp:875-899)
    infeasibility_ray: Optional[np.ndarray] = None
    unbounded_ray: Optional[np.ndarray] = None
    solve_time: float = 0.0
    # per-phase wall timings (reference: CLP_INTERVAL_TIMING messages,
    # ClpSolve.cpp:858-866) — keys like presolve/scaling/solve/postsolve
    timings: dict = dataclasses.field(default_factory=dict)


class Model:
    """LP/QP problem data + parameters + last solution.

    The default objective sense is minimize (optimization_direction=1.0,
    reference: ClpModel.hpp:285).
    """

    def __init__(self):
        self._A = sp.csc_matrix((0, 0), dtype=np.float64)
        self.col_lower = np.zeros(0)
        self.col_upper = np.zeros(0)
        self.row_lower = np.zeros(0)
        self.row_upper = np.zeros(0)
        self.objective = np.zeros(0)
        self.objective_offset = 0.0
        self.optimization_direction = 1.0  # 1 min, -1 max, 0 ignore
        self.quadratic_objective: Optional[sp.csc_matrix] = None  # Q (sym.)
        # convex piecewise-linear cost specs: {col: (breakpoints, slopes)}
        # (ClpNonLinearCost attachment; consumed by initial_solve via
        # piecewise.solve_piecewise — zero column expansion)
        self.piecewise_costs: Optional[dict] = None
        self.integer_mask: Optional[np.ndarray] = None  # bool per column
        self.row_names: Optional[list] = None
        self.col_names: Optional[list] = None
        self.problem_name: str = ""
        # parameters (reference ClpModelParameters.hpp keys, as attributes)
        self.primal_tolerance = PRIMAL_TOLERANCE
        self.dual_tolerance = DUAL_TOLERANCE
        self.maximum_iterations = 2 ** 31 - 1
        self.maximum_seconds = float("inf")
        self.dual_objective_limit = INF
        self.primal_objective_limit = -INF
        self.infeasibility_cost = 1e10
        self.scaling_mode = ScalingMode.AUTO
        self.log_level = 1
        self.random_seed = 1234567  # reference: RANDOMSEED param
        self.perturbation = 100  # reference: ClpSimplex.hpp:705-716
        self.solution = Solution()
        self.event_handler = None  # callable(event_name, model) -> int
        # CoinMessageHandler analogue: when set, every solver phase emits
        # its CLP_* catalog messages through it (passMessageHandler parity)
        self.message_handler = None

    # --- shape accessors (reference: ClpModel.hpp:410-421) ---
    @property
    def num_rows(self) -> int:
        return self._A.shape[0]

    @property
    def num_cols(self) -> int:
        return self._A.shape[1]

    @property
    def num_elements(self) -> int:
        return self._A.nnz

    @property
    def matrix(self) -> sp.csc_matrix:
        return self._A

    # --- loading (reference: ClpModel.hpp:87-120 loadProblem) ---
    def load_problem(
        self,
        matrix,
        col_lower=None,
        col_upper=None,
        objective=None,
        row_lower=None,
        row_upper=None,
        row_objective=None,
    ) -> "Model":
        A = sp.csc_matrix(matrix, dtype=np.float64)
        m, n = A.shape
        self._A = A
        self.col_lower = _as_f64(col_lower, n, 0.0)
        self.col_upper = _as_f64(col_upper, n, INF)
        self.objective = _as_f64(objective, n, 0.0)
        self.row_lower = _as_f64(row_lower, m, -INF)
        self.row_upper = _as_f64(row_upper, m, INF)
        if row_objective is not None:
            # reference rowObjective_ (ClpModel.hpp loadProblem overloads):
            # r'(Ax) folds exactly into the column objective as (A'r)'x
            r = _as_f64(row_objective, m, 0.0)
            self.objective = self.objective + np.asarray(A.T @ r)
        self.solution = Solution()
        return self

    def load_quadratic_objective(self, Q) -> None:
        """Set (1/2) x'Qx term; Q symmetric (ClpModel.hpp:122-127)."""
        Q = sp.csc_matrix(Q, dtype=np.float64)
        n = self.num_cols
        if Q.shape != (n, n):
            raise ValueError(f"Q must be {n}x{n}")
        self.quadratic_objective = Q

    # --- modification (reference: ClpModel.hpp:160-244) ---
    def add_columns(self, cols, lower=None, upper=None, objective=None) -> None:
        C = sp.csc_matrix(cols, dtype=np.float64)
        if C.shape[0] != self.num_rows and self.num_rows:
            raise ValueError("row dimension mismatch")
        k = C.shape[1]
        self._A = sp.hstack([self._A, C], format="csc") if self.num_cols else C
        self.col_lower = np.concatenate([self.col_lower, _as_f64(lower, k, 0.0)])
        self.col_upper = np.concatenate([self.col_upper, _as_f64(upper, k, INF)])
        self.objective = np.concatenate([self.objective, _as_f64(objective, k, 0.0)])
        if self.col_names is not None:
            self.col_names += [f"C{self.num_cols - k + i}" for i in range(k)]

    def add_rows(self, rows, lower=None, upper=None) -> None:
        R = sp.csc_matrix(rows, dtype=np.float64)
        if R.shape[1] != self.num_cols and self.num_cols:
            raise ValueError("column dimension mismatch")
        k = R.shape[0]
        self._A = sp.vstack([self._A, R], format="csc") if self.num_rows else R
        self.row_lower = np.concatenate([self.row_lower, _as_f64(lower, k, -INF)])
        self.row_upper = np.concatenate([self.row_upper, _as_f64(upper, k, INF)])
        if self.row_names is not None:
            self.row_names += [f"R{self.num_rows - k + i}" for i in range(k)]

    def delete_columns(self, which: Sequence[int]) -> None:
        keep = np.setdiff1d(np.arange(self.num_cols), np.asarray(which))
        self._A = self._A[:, keep].tocsc()
        self.col_lower = self.col_lower[keep]
        self.col_upper = self.col_upper[keep]
        self.objective = self.objective[keep]
        if self.integer_mask is not None:
            self.integer_mask = self.integer_mask[keep]
        if self.col_names is not None:
            self.col_names = [self.col_names[i] for i in keep]

    def delete_rows(self, which: Sequence[int]) -> None:
        keep = np.setdiff1d(np.arange(self.num_rows), np.asarray(which))
        self._A = self._A[keep, :].tocsc()
        self.row_lower = self.row_lower[keep]
        self.row_upper = self.row_upper[keep]
        if self.row_names is not None:
            self.row_names = [self.row_names[i] for i in keep]

    def resize(self, new_rows: int, new_cols: int) -> None:
        """Grow/shrink the model (reference: ClpModel::resize)."""
        m, n = self.num_rows, self.num_cols
        if new_cols < n:
            self.delete_columns(list(range(new_cols, n)))
        elif new_cols > n:
            self.add_columns(
                sp.csc_matrix((m, new_cols - n)),
                lower=np.zeros(new_cols - n),
                upper=np.full(new_cols - n, INF),
                objective=np.zeros(new_cols - n),
            )
        m = self.num_rows
        if new_rows < m:
            self.delete_rows(list(range(new_rows, m)))
        elif new_rows > m:
            self.add_rows(
                sp.csc_matrix((new_rows - m, self.num_cols)),
                lower=np.full(new_rows - m, -INF),
                upper=np.full(new_rows - m, INF),
            )

    def modify_coefficient(self, row: int, col: int, value: float,
                           keep_zero: bool = False) -> None:
        """Set one matrix element (reference: ClpModel::modifyCoefficient)."""
        A = self._A.tolil()
        A[row, col] = value
        self._A = A.tocsc()
        if not keep_zero and value == 0.0:
            self._A.eliminate_zeros()

    # --- objective sense (reference: ClpModel.hpp:285) ---
    def set_maximize(self) -> None:
        self.optimization_direction = -1.0

    def set_minimize(self) -> None:
        self.optimization_direction = 1.0

    # --- integers (reference: ClpModel.hpp copyInIntegerInformation) ---
    def set_piecewise_cost(self, column: int, breakpoints, slopes) -> None:
        """Attach a convex piecewise-linear cost to a column
        (ClpNonLinearCost role).  initial_solve routes models with
        piecewise costs through the in-engine kink-aware primal simplex
        (piecewise.solve_piecewise) — no columns are added."""
        if self.piecewise_costs is None:
            self.piecewise_costs = {}
        self.piecewise_costs[int(column)] = (
            np.asarray(breakpoints, dtype=np.float64),
            np.asarray(slopes, dtype=np.float64),
        )

    def set_integer(self, j) -> None:
        if self.integer_mask is None:
            self.integer_mask = np.zeros(self.num_cols, dtype=bool)
        self.integer_mask[j] = True

    def is_integer(self, j: int) -> bool:
        return bool(self.integer_mask is not None and self.integer_mask[j])

    # --- IO (implemented in clp_tpu_torch.io) ---
    def read_mps(self, filename: str, keep_names: bool = True) -> int:
        from .io.mps import read_mps

        try:
            read_mps(filename, into=self, keep_names=keep_names)
            return 0
        except FileNotFoundError:
            return -1

    def write_mps(self, filename: str) -> int:
        from .io.mps import write_mps

        write_mps(self, filename)
        return 0

    def read_lp(self, filename: str) -> int:
        from .io.lp_format import read_lp

        try:
            read_lp(filename, into=self)
            return 0
        except FileNotFoundError:
            return -1

    # --- solve front door (dispatches to clp_tpu_torch.solve) ---
    def initial_solve(self, options=None):
        from .solve import initial_solve

        return initial_solve(self, options)

    def dual(self, **kw):
        from .solve import initial_solve
        from .options import SolveOptions
        from .constants import SolveMethod

        return initial_solve(self, SolveOptions(method=SolveMethod.DUAL_SIMPLEX, **kw))

    def primal(self, **kw):
        from .solve import initial_solve
        from .options import SolveOptions
        from .constants import SolveMethod

        return initial_solve(self, SolveOptions(method=SolveMethod.PRIMAL_SIMPLEX, **kw))

    def barrier(self, crossover: bool = True, **kw):
        from .solve import initial_solve
        from .options import SolveOptions
        from .constants import SolveMethod

        m = SolveMethod.BARRIER if crossover else SolveMethod.BARRIER_NO_CROSS
        return initial_solve(self, SolveOptions(method=m, **kw))

    # --- solution accessors (reference: ClpModel.hpp:437-552) ---
    @property
    def status(self) -> ProblemStatus:
        return self.solution.status

    def is_proven_optimal(self) -> bool:
        return self.solution.status == ProblemStatus.OPTIMAL

    def is_proven_primal_infeasible(self) -> bool:
        return self.solution.status == ProblemStatus.PRIMAL_INFEASIBLE

    def is_proven_dual_infeasible(self) -> bool:
        return self.solution.status == ProblemStatus.DUAL_INFEASIBLE

    def objective_value(self) -> float:
        return self.solution.objective_value

    def primal_column_solution(self) -> Optional[np.ndarray]:
        return self.solution.primal

    def dual_row_solution(self) -> Optional[np.ndarray]:
        return self.solution.duals

    def dual_column_solution(self) -> Optional[np.ndarray]:
        return self.solution.reduced_costs

    def primal_row_solution(self) -> Optional[np.ndarray]:
        return self.solution.row_activity

    def infeasibility_ray(self) -> Optional[np.ndarray]:
        return self.solution.infeasibility_ray

    def unbounded_ray(self) -> Optional[np.ndarray]:
        return self.solution.unbounded_ray

    # --- infeasibility accounting (reference: ClpModel.hpp:1009-1027) ---
    def _primal_violations(self) -> np.ndarray:
        sol = self.solution
        if sol is None or sol.primal is None:
            return np.zeros(0)
        x = np.asarray(sol.primal)
        act = self.matrix @ x if sol.row_activity is None else np.asarray(sol.row_activity)
        v = np.concatenate([
            np.maximum(self.col_lower - x, 0.0) + np.maximum(x - self.col_upper, 0.0),
            np.maximum(self.row_lower - act, 0.0) + np.maximum(act - self.row_upper, 0.0),
        ])
        return v[np.isfinite(v)]

    def _dual_violations(self) -> np.ndarray:
        sol = self.solution
        if sol is None or sol.primal is None or sol.reduced_costs is None:
            return np.zeros(0)
        x = np.asarray(sol.primal)
        dj = np.asarray(sol.reduced_costs) * (self.optimization_direction or 1.0)
        tol = self.primal_tolerance
        at_lo = x <= self.col_lower + tol * (1 + np.abs(self.col_lower))
        at_up = x >= self.col_upper - tol * (1 + np.abs(self.col_upper))
        v = np.where(at_lo & ~at_up, np.maximum(-dj, 0.0),
                     np.where(at_up & ~at_lo, np.maximum(dj, 0.0), np.abs(
                         np.where(at_lo | at_up, 0.0, dj))))
        return v

    def sum_primal_infeasibilities(self) -> float:
        return float(np.sum(self._primal_violations()))

    def number_primal_infeasibilities(self) -> int:
        return int(np.sum(self._primal_violations() > self.primal_tolerance))

    def sum_dual_infeasibilities(self) -> float:
        return float(np.sum(self._dual_violations()))

    def number_dual_infeasibilities(self) -> int:
        return int(np.sum(self._dual_violations() > self.dual_tolerance))

    def primal_feasible(self) -> bool:
        return self.number_primal_infeasibilities() == 0

    def dual_feasible(self) -> bool:
        return self.number_dual_infeasibilities() == 0

    def check_solution(self) -> None:
        """Recompute row activity / objective from the primal values
        (reference: Clp_checkSolution)."""
        sol = self.solution
        if sol is None or sol.primal is None:
            return
        sol.row_activity = self.matrix @ np.asarray(sol.primal)
        sol.objective_value = float(self.objective @ sol.primal) + self.objective_offset
        if self.quadratic_objective is not None:
            sol.objective_value += 0.5 * float(
                sol.primal @ (self.quadratic_objective @ sol.primal)
            )

    def generate_python(self, filename: str) -> int:
        """Emit a runnable Python script that rebuilds this model
        (reference: generateCpp, ClpModel.hpp:1164)."""
        import scipy.sparse as _sp

        A = self.matrix.tocoo()
        lines = [
            "import numpy as np",
            "import scipy.sparse as sp",
            "from clp_tpu_torch import Model",
            "",
            f"rows = {A.row.tolist()}",
            f"cols = {A.col.tolist()}",
            f"vals = {A.data.tolist()}",
            f"A = sp.coo_matrix((vals, (rows, cols)), shape=({self.num_rows}, {self.num_cols})).tocsc()",
            "model = Model()",
            "model.load_problem(",
            "    A,",
            f"    col_lower={self.col_lower.tolist()},",
            f"    col_upper={self.col_upper.tolist()},",
            f"    objective={self.objective.tolist()},",
            f"    row_lower={self.row_lower.tolist()},",
            f"    row_upper={self.row_upper.tolist()},",
            ")",
            f"model.objective_offset = {self.objective_offset!r}",
            f"model.optimization_direction = {self.optimization_direction!r}",
            f"model.primal_tolerance = {self.primal_tolerance!r}",
            f"model.dual_tolerance = {self.dual_tolerance!r}",
        ]
        if self.integer_mask is not None and self.integer_mask.any():
            idx = [int(j) for j in self.integer_mask.nonzero()[0]]
            lines.append(f"for j in {idx}: model.set_integer(j)")
        lines += [
            "",
            "if __name__ == '__main__':",
            "    sol = model.initial_solve()",
            "    print(sol.status.name, sol.objective_value)",
        ]
        try:
            with open(filename, "w") as f:
                f.write("\n".join(lines) + "\n")
            return 0
        except OSError:
            return -1

    # --- whole-model checkpoint (reference: saveModel/restoreModel,
    #     ClpSimplex.hpp:805-808) ---
    def save_model(self, filename: str) -> int:
        """Binary whole-model save including the last solution."""
        import pickle

        state = dict(self.__dict__)
        state.pop("event_handler", None)
        state.pop("message_handler", None)
        try:
            with open(filename, "wb") as f:
                pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
            return 0
        except OSError:
            return -1

    def restore_model(self, filename: str) -> int:
        import pickle

        try:
            with open(filename, "rb") as f:
                state = pickle.load(f)
        except (OSError, pickle.UnpicklingError):
            return -1
        handler = self.event_handler
        self.__dict__.update(state)
        self.event_handler = handler
        return 0

    # --- basis warm start (reference: ClpModel.hpp:910-914, statusCopy) ---
    def get_basis_status(self):
        return self.solution.column_status, self.solution.row_status

    def set_basis_status(self, column_status, row_status) -> None:
        self.solution.column_status = np.asarray(column_status, dtype=np.int8)
        self.solution.row_status = np.asarray(row_status, dtype=np.int8)
        # an explicitly loaded basis (readBasis / C setBasisStatus / crash)
        # warm-starts the NEXT simplex solve (reference: statusCopy is the
        # starting basis of dual()/primal(), ClpModel.hpp:910-914);
        # consumed once by initial_solve
        self.warm_start_pending = True

    # --- structure detection (replaces ClpPlusMinusOneMatrix / Network classes) ---
    def detect_structure(self) -> dict:
        """Classify the matrix; downstream kernels specialize on this.

        Returns flags equivalent to what the reference encodes as matrix
        subclasses (ClpPlusMinusOneMatrix.hpp, ClpNetworkMatrix.hpp:12-16).
        """
        A = self._A
        data = A.data
        is_pm1 = bool(data.size and np.all(np.abs(data) == 1.0))
        is_network = False
        if is_pm1:
            counts = np.diff(A.indptr)
            if np.all(counts <= 2):
                col_sums = np.abs(A).T @ np.ones(A.shape[0])
                sums = A.T @ np.ones(A.shape[0])
                is_network = bool(np.all((counts < 2) | (np.abs(sums) < 1e-12)))
                is_network = is_network and bool(np.all(col_sums <= 2))
        return {
            "plus_minus_one": is_pm1,
            "network": is_network,
            "nnz": int(A.nnz),
            "density": float(A.nnz) / max(1, A.shape[0] * A.shape[1]),
        }

    def copy(self) -> "Model":
        import copy as _copy

        m = Model()
        # handlers are shared by reference, not deep-copied: they can hold
        # streams/closures (reference: handlers are pointers on ClpModel)
        shared = ("event_handler", "message_handler", "disaster_handler")
        m.__dict__ = {
            k: (
                v
                if k in shared
                else (_copy.deepcopy(v) if not sp.issparse(v) else v.copy())
            )
            for k, v in self.__dict__.items()
        }
        m._A = self._A.copy()
        return m

    def __repr__(self) -> str:
        return (
            f"Model({self.num_rows}x{self.num_cols}, nnz={self.num_elements}, "
            f"status={self.solution.status.name})"
        )
