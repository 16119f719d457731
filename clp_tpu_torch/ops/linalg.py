"""Dense basis refactorization for the simplex engine.

The refactor half of the JAX package's ops/linalg.py: `lu_refactor` (f64)
and `lu_refactor32` (f32 with power-of-2 equilibration). Both return an
explicit inverse, which the engine then updates by rank-1 product-form
transforms between refactorizations (reference: CoinFactorization /
CoinAbc LU replaced by blocked-dense + rank-1 updates, SURVEY.md §7).

The JAX package's blocked-panel LU, Gauss-Jordan inverse and banded
Cholesky exist because the TPU lacks an f64 LU kernel; here both dtypes go
through `torch.linalg.lu_factor_ex` / `lu_solve` on any device.
`lu_factor_ex` is `lu_factor` without the error check: a singular basis
must come back as a non-finite inverse (the `ok` flag), as XLA's LU does,
not as an exception — and on the card the check would sync every
refactorization.
"""

from __future__ import annotations

import torch


def _inverse_from_lu(B: torch.Tensor) -> torch.Tensor:
    LU, piv, _ = torch.linalg.lu_factor_ex(B)
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    return torch.linalg.lu_solve(LU, piv, eye).contiguous()


def lu_refactor(B: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense factorization of a basis matrix, returning (Binv, ok_flag).

    The periodic from-scratch refactorization (reference cadence:
    ClpFactorization::timeToRefactorize, ClpFactorization.cpp:1524).
    `ok` is a 0-dim bool tensor on B's device.
    """
    Binv = _inverse_from_lu(B)
    return Binv, torch.isfinite(Binv).all()


def lu_refactor32(B: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 explicit inverse of an f64 basis, returning (Binv32, ok_flag).

    Used by the mixed-precision simplex: the f32 inverse drives the pivot
    loop and preconditions the f64 iterative-refinement solves at
    refactorization time.
    """
    # power-of-2 row/col equilibration (exact in fp): shrinks the condition
    # number the f32 factor sees; binv = Dc X Dr undoes it exactly
    absB = B.abs()
    r_max = absB.amax(dim=1, keepdim=True)
    dr = torch.exp2(-torch.round(torch.log2(torch.where(r_max > 0, r_max, 1.0))))
    absB = absB * dr
    c_max = absB.amax(dim=0, keepdim=True)
    dc = torch.exp2(-torch.round(torch.log2(torch.where(c_max > 0, c_max, 1.0))))
    B32 = (B * dr * dc).to(torch.float32)
    X = _inverse_from_lu(B32)
    X = (X * dc.reshape(-1, 1).to(torch.float32)
         * dr.reshape(1, -1).to(torch.float32)).contiguous()
    return X, torch.isfinite(X).all()
