"""Solver-wide constants, status codes, and default tolerances.

Mirrors the behavioral contract of the reference (coin-or/Clp):
  - problem status codes: ClpModel.hpp:431-436 (-1 unknown, 0 optimal,
    1 primal infeasible, 2 dual infeasible, 3 stopped on iterations/time,
    4 errors, 5 user stopped)
  - secondary status codes: ClpModel.hpp:450-465
  - default tolerances: ClpModel.hpp:350-361 (primal/dual 1e-7),
    ClpFactorization.hpp:409-417 (LU zero tol 1e-13, pivot tol 1e-8)

The numeric *policies* (tolerances, perturbation defaults, refactorization
frequency) follow the reference because they are the hard-won part of a
working LP code; the implementation below them is TPU-native.
"""

from __future__ import annotations

import enum

# "Infinity" for bounds, matching COIN_DBL_MAX semantics (treated as +-inf).
INF = 1e30

# --- Default tolerances (reference: ClpModel.hpp:350-361) ---
PRIMAL_TOLERANCE = 1e-7
DUAL_TOLERANCE = 1e-7
# LU / factorization numerics (reference: ClpFactorization.hpp:345,409-417)
ZERO_TOLERANCE = 1e-13
PIVOT_TOLERANCE = 1e-8
# Dual bound used for "fake bounds" in the dual simplex phase-1
# (reference: ClpSimplexDual.cpp:143-158, dualBound_ default 1e10).
DUAL_BOUND_DEFAULT = 1e10
# Refactorization cadence (reference: ClpSimplex.hpp:657).
REFACTOR_FREQUENCY = 100


class ProblemStatus(enum.IntEnum):
    """Final status of a solve (reference: ClpModel.hpp:431-436)."""

    UNKNOWN = -1
    OPTIMAL = 0
    PRIMAL_INFEASIBLE = 1
    DUAL_INFEASIBLE = 2  # i.e. unbounded for a feasible problem
    STOPPED = 3  # iteration / time limit
    ERRORS = 4
    USER_STOPPED = 5


class SecondaryStatus(enum.IntEnum):
    """Secondary status (reference: ClpModel.hpp:450-465)."""

    NONE = 0
    PRIMAL_INFEASIBLE_AT_DUAL_LIMIT = 1
    SCALED_OPTIMAL_UNSCALED_PRIMAL_INFEAS = 2
    SCALED_OPTIMAL_UNSCALED_DUAL_INFEAS = 3
    SCALED_OPTIMAL_UNSCALED_BOTH_INFEAS = 4
    GAVE_UP = 5
    FAILED_EMPTY_CHECK = 6
    POSTSOLVE_INFEAS = 7
    FAILED_TO_CONVERGE = 8
    STOPPED_ON_TIME = 9
    STOPPED_PRIMAL_FEASIBLE = 10
    INFEAS_OR_UNBOUNDED_IN_PRESOLVE = 11
    # TPU-build extension (no reference analogue): the solution is OPTIMAL
    # only to a first-order tolerance (>= ~1e-4, PDHG) — NOT simplex 1e-7
    # accuracy. Cleared when a sprint/crunch polish verifies full KKT.
    REDUCED_ACCURACY = 12


class VariableStatus(enum.IntEnum):
    """Per-variable basis status (reference: ClpSimplex.hpp:119-126).

    Values chosen to match Clp's enum so basis files and warm starts can
    round-trip against reference-produced artifacts.
    """

    FREE = 0  # nonbasic, no bound active (superbasic at 0)
    BASIC = 1
    AT_UPPER = 2
    AT_LOWER = 3
    SUPER_BASIC = 4  # nonbasic but not at a bound
    FIXED = 5  # nonbasic, lower == upper


class SolveMethod(enum.IntEnum):
    """Solve algorithm selector (reference: ClpSolve.hpp SolveType)."""

    DUAL_SIMPLEX = 0
    PRIMAL_SIMPLEX = 1
    BARRIER = 2  # interior point, with crossover
    BARRIER_NO_CROSS = 3
    AUTOMATIC = 4
    PRIMAL_IDIOT = 5  # primal with idiot crash warm start
    SPRINT = 6  # column-subset sifting
    PDLP = 7  # first-order primal-dual hybrid gradient (TPU-native extra)
    NETWORK = 8  # spanning-tree-basis network simplex (ClpNetworkBasis)
    GUB = 9  # key-variable GUB simplex over the general-row working basis
    #         (ClpGubMatrix analogue, clp_tpu/gub.py)
    DECOMPOSE = 10  # auto-detected block structure -> Benders/DW
    #               (reference: ClpSimplex::solve(CoinStructuredModel*)
    #               decomposeType dispatch, ClpSolve.cpp:4910-4924 — here
    #               the blocks are DETECTED from the flat model first,
    #               clp_tpu/structure.py)


class ScalingMode(enum.IntEnum):
    """Scaling modes (reference: ClpModel.hpp:724,1314-1316)."""

    OFF = 0
    EQUILIBRIUM = 1
    GEOMETRIC = 2
    AUTO = 3
    DYNAMIC = 4  # treated as GEOMETRIC here
    GEOMETRIC_ROWS_ONLY = 5
