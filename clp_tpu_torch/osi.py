"""Osi-shaped solver interface adapter.

Mirrors the method surface Cbc consumes from OsiClpSolverInterface
(src/OsiClp/OsiClpSolverInterface.hpp: initialSolve/resolve :72/:974,
markHotStart/solveFromHotStart :321-325, standard Osi accessors) so a
branch-and-bound framework written against Osi conventions can drive this
solver with a mechanical rename. Names intentionally keep Osi's camelCase.

Every solve and the tableau accessors' LU of B run on the interface's
device (`device`, default `device.default_device()`); the accessors return
host numpy arrays, as the JAX package's do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .branching import HotStart, mark_hot_start
from .constants import ProblemStatus, SolveMethod, VariableStatus
from .device import resolve_device
from .model import Model, Solution
from .options import SolveOptions


class OsiClpTpuSolverInterface:
    def __init__(self, model: Optional[Model] = None, device: Optional[str] = None):
        self.model = model or Model()
        self.options = SolveOptions()
        if device is not None:
            self.options.device = device
        self._hot: Optional[HotStart] = None

    def _dual_options(self, **kw) -> SolveOptions:
        o = SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device=self.options.device, **kw)
        o.presolve.enabled = False
        return o

    # --- problem building ---
    def loadProblem(self, matrix, collb, colub, obj, rowlb, rowub):
        self.model.load_problem(matrix, collb, colub, obj, rowlb, rowub)

    def readMps(self, filename: str) -> int:
        return self.model.read_mps(filename)

    def writeMps(self, filename: str) -> int:
        return self.model.write_mps(filename)

    def setObjSense(self, sense: float) -> None:
        self.model.optimization_direction = sense

    def getObjSense(self) -> float:
        return self.model.optimization_direction

    def addRow(self, row, lb: float, ub: float) -> None:
        self.model.add_rows(row, [lb], [ub])

    def addCol(self, col, lb: float, ub: float, obj: float) -> None:
        self.model.add_columns(col, [lb], [ub], [obj])

    def setColBounds(self, j: int, lb: float, ub: float) -> None:
        self.model.col_lower = self.model.col_lower.copy()
        self.model.col_upper = self.model.col_upper.copy()
        self.model.col_lower[j] = lb
        self.model.col_upper[j] = ub

    def setInteger(self, j: int) -> None:
        self.model.set_integer(j)

    # --- solves ---
    def initialSolve(self) -> None:
        self.model.initial_solve(self.options)

    def resolve(self) -> None:
        """Warm re-solve from the current basis (Osi's dual-first contract)."""
        from .simplex.driver import simplex_solve

        warm = self.model.solution if self.model.solution.column_status is not None else None
        self.model.solution = simplex_solve(self.model, self._dual_options(), dual=True,
                                            warm=warm)

    def branchAndBound(self, max_nodes: int = 10000):
        from .mip import fathom

        res = fathom(self.model, max_nodes=max_nodes, options=self._dual_options())
        self.model.solution = Solution(
            status=res.status,
            objective_value=res.objective_value,
            primal=res.primal,
            iterations=res.iterations,
        )
        return res

    # --- hot starts (strong branching support) ---
    def markHotStart(self) -> None:
        self._hot = mark_hot_start(self.model)

    def solveFromHotStart(self) -> None:
        if self._hot is None:
            self.resolve()
            return
        from .simplex.driver import simplex_solve

        o = self._dual_options(max_iterations=2000)
        warm = Solution(
            column_status=self._hot.column_status, row_status=self._hot.row_status
        )
        self.model.solution = simplex_solve(self.model, o, dual=True, warm=warm)

    def unmarkHotStart(self) -> None:
        self._hot = None

    # --- status ---
    def isProvenOptimal(self) -> bool:
        return self.model.is_proven_optimal()

    def isProvenPrimalInfeasible(self) -> bool:
        return self.model.is_proven_primal_infeasible()

    def isProvenDualInfeasible(self) -> bool:
        return self.model.is_proven_dual_infeasible()

    def isIterationLimitReached(self) -> bool:
        return self.model.status == ProblemStatus.STOPPED

    # --- accessors ---
    def getNumRows(self) -> int:
        return self.model.num_rows

    def getNumCols(self) -> int:
        return self.model.num_cols

    def getObjValue(self) -> float:
        return self.model.objective_value()

    def getColSolution(self):
        return self.model.primal_column_solution()

    def getRowPrice(self):
        return self.model.dual_row_solution()

    def getReducedCost(self):
        return self.model.dual_column_solution()

    def getRowActivity(self):
        return self.model.primal_row_solution()

    def getColLower(self):
        return self.model.col_lower

    def getColUpper(self):
        return self.model.col_upper

    def getObjCoefficients(self):
        return self.model.objective

    def getIterationCount(self) -> int:
        return self.model.solution.iterations

    # --- warm start objects (CoinWarmStartBasis analogue) ---
    def getWarmStart(self):
        return self.model.get_basis_status()

    def setWarmStart(self, warm) -> None:
        cs, rs = warm
        self.model.set_basis_status(cs, rs)

    # --- tableau access (OsiSimplexInterface group; reference:
    # OsiClpSolverInterface.hpp enableFactorization/getBasics/getBInvRow/
    # getBInvARow/getBInvCol/getBInvACol — what Cbc's cut generators,
    # e.g. CglGomory, consume after a solve) ---
    #
    # Convention: the tableau is over the standard form [A | -I] (slack
    # columns carry coefficient -1, matching this framework's simplex
    # engine). getBInvARow returns (structural part, slack part).

    def enableFactorization(self) -> None:
        """Factorize the current basis for tableau queries (one LU of B in
        f64 on the interface's device)."""
        sol = self.model.solution
        if sol.column_status is None or sol.row_status is None:
            raise RuntimeError("no basis: solve first (simplex with basis out)")
        m = self.model.num_rows
        status = np.concatenate([sol.column_status, sol.row_status])
        basics = np.flatnonzero(status == VariableStatus.BASIC)
        if basics.size != m:
            raise RuntimeError(
                f"basis has {basics.size} basic variables, need {m}"
            )
        dev = resolve_device(self.options.device)
        A = torch.as_tensor(self.model.matrix.toarray(), dtype=torch.float64, device=dev)
        G = torch.cat([A, -torch.eye(m, dtype=torch.float64, device=dev)], dim=1)
        self._basics = basics
        self._G = G
        # like scipy's lu_factor, a singular B is not an error here
        LU, piv, _ = torch.linalg.lu_factor_ex(
            G.index_select(1, torch.as_tensor(basics, device=dev)))
        self._lu = (LU, piv)

    def disableFactorization(self) -> None:
        self._basics = self._lu = self._G = None

    def getBasics(self):
        """Indices of basic variables (columns then slacks n..n+m-1)."""
        self._need_factorization()
        return self._basics.copy()

    def _solve(self, rhs: torch.Tensor, adjoint: bool = False) -> torch.Tensor:
        LU, piv = self._lu
        return torch.linalg.lu_solve(LU, piv, rhs[:, None], adjoint=adjoint)[:, 0]

    def _unit(self, i: int) -> torch.Tensor:
        e = torch.zeros(self.model.num_rows, dtype=torch.float64, device=self._G.device)
        e[i] = 1.0
        return e

    def getBInvRow(self, row: int):
        """Row `row` of B^-1 (via a BTRAN solve)."""
        self._need_factorization()
        return self._solve(self._unit(row), adjoint=True).cpu().numpy()

    def getBInvCol(self, col: int):
        """Column `col` of B^-1 (via an FTRAN solve)."""
        self._need_factorization()
        return self._solve(self._unit(col)).cpu().numpy()

    def getBInvARow(self, row: int):
        """Row `row` of B^-1 [A | -I] -> (structural part, slack part)."""
        self._need_factorization()
        r = (self._solve(self._unit(row), adjoint=True) @ self._G).cpu().numpy()
        n = self.model.num_cols
        return r[:n], r[n:]

    def getBInvACol(self, col: int):
        """Column `col` of B^-1 [A | -I] (col may index a slack)."""
        self._need_factorization()
        return self._solve(self._G[:, col]).cpu().numpy()

    def _need_factorization(self) -> None:
        if getattr(self, "_lu", None) is None:
            raise RuntimeError("call enableFactorization() first")

    def pivot(self, colIn: int, colOut: int, outStatus: int) -> int:
        """Execute ONE basis change and recompute the basic solution
        (OsiSimplexInterface::pivot). colIn/colOut index the [A | -I]
        columns (slack j = ncols + j); outStatus: -1 -> colOut leaves to
        its lower bound, 1 -> upper. Returns 0 on success, -1 if the new
        basis is singular (the old basis is kept)."""
        self._need_factorization()
        m, n = self.model.num_rows, self.model.num_cols
        sol = self.model.solution
        basics = self._basics
        k = int(np.flatnonzero(basics == colOut).squeeze()) if colOut in basics else -1
        if k < 0:
            raise ValueError(f"colOut {colOut} is not basic")
        if colIn in basics:
            raise ValueError(f"colIn {colIn} is already basic")
        new_basics = basics.copy()
        new_basics[k] = colIn
        G = self._G
        LU, piv, _ = torch.linalg.lu_factor_ex(
            G.index_select(1, torch.as_tensor(new_basics, device=G.device)))
        ok = torch.isfinite(LU).all() & (LU.diagonal().abs().min() >= 1e-11)
        if not bool(ok):
            return -1
        status = np.concatenate([sol.column_status, sol.row_status])
        status[colIn] = VariableStatus.BASIC
        status[colOut] = (
            VariableStatus.AT_UPPER if outStatus > 0 else VariableStatus.AT_LOWER
        )
        # nonbasic values at their bounds; basics from B x_B = -N x_N
        l = np.concatenate([self.model.col_lower, self.model.row_lower])
        u = np.concatenate([self.model.col_upper, self.model.row_upper])
        x = np.zeros(n + m)
        nonbasic = np.setdiff1d(np.arange(n + m), new_basics)
        at_up = status[nonbasic] == VariableStatus.AT_UPPER
        x[nonbasic] = np.where(
            at_up,
            np.minimum(u[nonbasic], 1e30),
            np.where(np.abs(l[nonbasic]) < 1e30, l[nonbasic], 0.0),
        )
        nb_t = torch.as_tensor(nonbasic, device=G.device)
        rhs = -(G.index_select(1, nb_t) @ torch.as_tensor(x[nonbasic], device=G.device))
        self._lu = (LU, piv)
        x[new_basics] = self._solve(rhs).cpu().numpy()
        sol.column_status = status[:n].astype(np.int8)
        sol.row_status = status[n:].astype(np.int8)
        sol.primal = x[:n]
        sol.row_activity = np.asarray(self.model.matrix @ x[:n])
        sol.objective_value = float(self.model.objective @ x[:n]) + (
            self.model.objective_offset
        )
        self._basics = new_basics
        return 0
