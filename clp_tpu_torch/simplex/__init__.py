"""Revised simplex engines (dual and primal) on torch tensors.

Explicit dense basis inverse with rank-1 product-form updates and periodic
LU refactorization; Harris and bound-flipping ratio tests; dual phase 1
through fake bounds (ClpSimplexDual.cpp:143-158 dualBound_ semantics).
"""

from .driver import simplex_solve  # noqa: F401
