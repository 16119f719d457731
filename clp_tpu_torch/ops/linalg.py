"""Dense factorizations for the simplex engine and the barrier.

The refactor half of the JAX package's ops/linalg.py: `lu_refactor` (f64)
and `lu_refactor32` (f32 with power-of-2 equilibration). Both return an
explicit inverse, which the engine then updates by rank-1 product-form
transforms between refactorizations (reference: CoinFactorization /
CoinAbc LU replaced by blocked-dense + rank-1 updates, SURVEY.md §7).
Both dtypes go through `torch.linalg.lu_factor_ex` / `lu_solve` on any
device. `lu_factor_ex` is `lu_factor` without the error check: a singular
basis must come back as a non-finite inverse (the `ok` flag), as XLA's LU
does, not as an exception — and on the card the check would sync every
refactorization. The JAX package's own LU and inverses (`blocked_lu`,
`blocked_inverse`, `gauss_jordan_inverse`) stand in for an f64 LU that
the TPU lacks; they are here in plain torch for the same public names,
and no path of the port calls them.

The Cholesky half serves the barrier: `chol_factor_reg` (Cholesky with an
escalating diagonal shift), `chol_blocked`, `chol_solve`, `solve_refined`,
and the block-tridiagonal `block_tridiag_cholesky` / `block_tridiag_solve`,
which factor an RCM-banded normal matrix in O(m·nb²) work instead of the
dense O(m³). XLA's Cholesky returns NaN for a matrix that is not positive
definite; LAPACK and cuSOLVER return a partial factor and `info > 0`. So
the failure test here is `info`, read on the host once per factorization
attempt, and a failed factor is filled with NaN as XLA's is, so what the
callers see on failure is the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch



def _inverse_from_lu(B: torch.Tensor) -> torch.Tensor:
    LU, piv, _ = torch.linalg.lu_factor_ex(B)
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    return torch.linalg.lu_solve(LU, piv, eye).contiguous()


def lu_refactor(B: torch.Tensor, block: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense factorization of a basis matrix, returning (Binv, ok_flag).

    The periodic from-scratch refactorization (reference cadence:
    ClpFactorization::timeToRefactorize, ClpFactorization.cpp:1524).
    `ok` is a 0-dim bool tensor on B's device. `block` is the JAX
    package's panel width for its TPU LU; `lu_factor_ex` needs none, and
    it is unused.
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


def gauss_jordan_inverse(B: torch.Tensor) -> torch.Tensor:
    """Explicit inverse via Gauss-Jordan with partial pivoting: m rank-1
    row-operation steps on [B | I] (the JAX package's fori_loop)."""
    m = B.shape[-1]
    aug = torch.cat([B, torch.eye(m, dtype=B.dtype, device=B.device)], dim=-1)
    idx = torch.arange(m, device=B.device)
    for k in range(m):
        col = aug[:, k]
        p = torch.argmax(torch.where(idx >= k, col.abs(), -torch.inf))
        # swap rows k and p
        perm = idx.clone()
        perm[k], perm[p] = p, k
        aug = aug[perm]
        newk = aug[k] / aug[k, k]
        factors = aug[:, k].clone()
        factors[k] = 0.0
        aug = aug - torch.outer(factors, newk)
        aug[k] = newk
    return aug[:, m:]


def blocked_lu(A: torch.Tensor, block: int = 128):
    """Right-looking blocked LU with partial pivoting (LAPACK getrf's
    structure): b sequential panel steps, then a unit-lower triangular solve
    for the block row and one product for the trailing update per panel.
    The JAX package's TPU LU, in plain torch.

    Returns (LU, perm) where LU packs unit-lower L below the diagonal and U
    on/above it, and perm is the row permutation such that A[perm] = L @ U.
    """
    m = A.shape[-1]
    b = min(block, m)
    nb = -(-m // b)  # ceil
    M = nb * b
    # pad with identity so every panel has width b
    Ap = torch.eye(M, dtype=A.dtype, device=A.device)
    Ap[:m, :m] = A
    A = Ap
    rows = torch.arange(M, device=A.device)
    perm = rows.clone()
    for k in range(nb):
        pb = k * b
        for j in range(b):
            r = pb + j
            # partial pivot among rows >= r
            p = int(torch.argmax(torch.where(rows >= r, A[:, r].abs(), -torch.inf)))
            A[[r, p]] = A[[p, r]]
            perm[[r, p]] = perm[[p, r]]
            # multipliers below the diagonal, stored in place
            A[r + 1:, r] /= A[r, r]
            # eliminate within the remaining panel columns only
            A[r + 1:, r + 1:pb + b] -= torch.outer(A[r + 1:, r], A[r, r + 1:pb + b])
        # block row: U12 = L11^{-1} A12 (unit-lower L11)
        L11 = torch.tril(A[pb:pb + b, pb:pb + b], -1) + torch.eye(
            b, dtype=A.dtype, device=A.device)
        A[pb:pb + b, pb + b:] = torch.linalg.solve_triangular(
            L11, A[pb:pb + b, pb + b:], upper=False, unitriangular=True)
        # trailing update: A22 -= L21 @ U12
        A[pb + b:, pb + b:] -= A[pb + b:, pb:pb + b] @ A[pb:pb + b, pb + b:]
    return A[:m, :m], perm[:m]


def blocked_inverse(B: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Explicit inverse via blocked LU + two triangular solves:
    B^{-1} = U^{-1} L^{-1} P."""
    m = B.shape[-1]
    LU, perm = blocked_lu(B, block)
    eye = torch.eye(m, dtype=B.dtype, device=B.device)
    L = torch.tril(LU, -1) + eye
    U = torch.triu(LU)
    Pm = eye[perm]
    Y = torch.linalg.solve_triangular(L, Pm, upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(U, Y, upper=True)


# --------------------------------------------------------------------------
# Cholesky with regularization (the barrier's dense normal equations)
# --------------------------------------------------------------------------


def _cholesky(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Lower Cholesky of M's lower triangle and a per-matrix failure mask;
    a failed factor is NaN on and below its diagonal, as XLA returns it."""
    L, info = torch.linalg.cholesky_ex(M)
    bad = info > 0
    n = M.shape[-1]
    lower = torch.ones((n, n), dtype=torch.bool, device=M.device).tril()
    L = torch.where(bad[..., None, None] & lower, torch.nan, L)
    return L, bad


def chol_factor_reg(M: torch.Tensor, base_reg: float = 0.0, max_bumps: int = 6):
    """Cholesky of M + delta*I, escalating delta x100 until it succeeds.

    `base_reg` is an ABSOLUTE first-attempt shift — IPM normal-equation
    diagonals grow without bound near convergence, so scaling the default
    shift by the diagonal would swamp the well-conditioned block and corrupt
    the Newton direction. Only the escalation (after a failed factorization)
    is diagonal-scaled. Every matrix of a batch takes the same shift.

    Returns (L, delta_used): L is NaN where the last attempt failed.
    """
    scale = torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1).abs().amax(), min=1.0)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)

    def attempt(delta):
        L, bad = _cholesky(M + delta * eye)
        return L, bool(~bad.any() & torch.isfinite(L).all())

    delta = torch.tensor(base_reg, dtype=M.dtype, device=M.device)
    L, ok = attempt(delta)
    bumps = 0
    while not ok and bumps < max_bumps:
        delta = torch.maximum(1e-14 * scale, delta * 100.0)
        L, ok = attempt(delta)
        bumps += 1
    return L, delta


def chol_factor_reg_lanes_prog(M: torch.Tensor, base_reg: float = 0.0,
                               max_bumps: int = 6):
    """chol_factor_reg over a batch (B, n, n), lane by lane: each matrix
    escalates its own shift, x100 from base_reg, scaled by its own largest
    diagonal entry, as it would alone (the JAX package's while_loop under
    vmap). Only the lanes that failed are factored again; the failure flags
    (cholesky_ex's per-matrix info) are read on the host once per attempt.
    A lockstep program (utils/lockstep.py): it yields its failure reads.

    Returns (L, delta (B,)): L is NaN in a lane whose last attempt failed.
    """
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    scale = torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1).abs().amax(dim=-1), min=1.0)
    delta = torch.full(M.shape[:1], base_reg, dtype=M.dtype, device=M.device)

    def attempt(idx):
        L, bad = _cholesky(M.index_select(0, idx) + delta[idx, None, None] * eye)
        return L, ~bad & torch.isfinite(L).flatten(1).all(dim=1)

    L, ok = attempt(torch.arange(M.shape[0], device=M.device))
    for _ in range(max_bumps):
        fail = torch.as_tensor(np.flatnonzero((yield ~ok)), device=M.device)
        if fail.numel() == 0:
            break
        delta[fail] = torch.maximum(1e-14 * scale[fail], delta[fail] * 100.0)
        L[fail], ok[fail] = attempt(fail)
    return L, delta


def chol_blocked(A: torch.Tensor, nb: int = 256) -> torch.Tensor:
    """Right-looking blocked Cholesky: a Cholesky of each nb-diagonal block,
    the panel below it through the block's explicit triangular inverse, and
    the trailing update as one product per block step. Supports leading
    batch dims; NaN where the dense Cholesky would fail."""
    m = A.shape[-1]
    if m <= nb:
        return _cholesky(A)[0]
    A = A.clone()
    L = torch.zeros_like(A)
    for k in range(0, m, nb):
        e = min(k + nb, m)
        L11 = _cholesky(A[..., k:e, k:e])[0]
        L[..., k:e, k:e] = L11
        if e < m:
            eye = torch.eye(e - k, dtype=A.dtype, device=A.device)
            Li = torch.linalg.solve_triangular(L11, eye, upper=False)
            L21 = A[..., e:, k:e] @ Li.mT
            L[..., e:, k:e] = L21
            A[..., e:, e:] -= L21 @ L21.mT
    return L


def chol_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (L L') x = rhs given lower-triangular L. rhs: (..., m) or (..., m, k)."""
    vec = rhs.ndim == L.ndim - 1
    r = rhs[..., None] if vec else rhs
    z = torch.linalg.solve_triangular(L, r, upper=False)
    x = torch.linalg.solve_triangular(L.mT, z, upper=True)
    return x[..., 0] if vec else x


def solve_refined(M: torch.Tensor, L: torch.Tensor, rhs: torch.Tensor,
                  iters: int = 1) -> torch.Tensor:
    """chol_solve plus `iters` steps of iterative refinement against M."""
    x = chol_solve(L, rhs)
    for _ in range(iters):
        if rhs.ndim == M.ndim - 1:
            r = rhs - (M @ x[..., None])[..., 0]
        else:
            r = rhs - M @ x
        x = x + chol_solve(L, r)
    return x


# --------------------------------------------------------------------------
# Block-tridiagonal (banded) Cholesky
# --------------------------------------------------------------------------


def block_tridiag_cholesky(A: torch.Tensor, E: torch.Tensor,
                           base_reg: float = 0.0, max_bumps: int = 6):
    """Cholesky of a block-tridiagonal SPD matrix, k sequential block steps.

    A: (k, nb, nb) diagonal blocks; E: (k-1, nb, nb) sub-diagonal blocks
    (E[i] = M[block i+1, block i]). Returns (L, C, delta): L (k, nb, nb)
    lower-triangular diagonal factors, C (k-1, nb, nb) sub-diagonal factors
    with M = LL' in block form, and the diagonal shift used.

    The numeric phase of the reference's sparse Cholesky
    (ClpCholeskyBase.cpp:638 AMD ordering + :1982 numeric) for a banded
    pattern: a host-side RCM ordering makes the normal matrix banded, and
    the band factors as k = m/nb dense block steps — O(m·nb²) work instead
    of O(m³). A failed block continues the sweep from an identity factor
    (the JAX package's `L_safe`) and the whole sweep is retried with a
    larger diagonal shift, as chol_factor_reg does.
    """
    k, nb, _ = A.shape
    eye = torch.eye(nb, dtype=A.dtype, device=A.device)
    scale = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1).abs().amax(), min=1.0)

    def attempt(delta):
        Ls, Cs, bads = [], [], []
        prevL = eye
        for i in range(k):
            S_i = A[i] + delta * eye
            if i > 0:
                # C_i = E_i L_{i-1}^{-T}
                C_i = torch.linalg.solve_triangular(prevL, E[i - 1].mT, upper=False).mT
                S_i = S_i - C_i @ C_i.mT
                Cs.append(C_i)
            L_i, bad = _cholesky(S_i)
            prevL = torch.where(torch.isfinite(L_i), L_i, eye)
            Ls.append(L_i)
            bads.append(bad)
        L = torch.stack(Ls)
        C = torch.stack(Cs) if Cs else A.new_zeros((0, nb, nb))
        ok = bool(~torch.stack(bads).any() & torch.isfinite(L).all())
        return L, C, ok

    delta = torch.tensor(base_reg, dtype=A.dtype, device=A.device)
    L, C, ok = attempt(delta)
    bumps = 0
    while not ok and bumps < max_bumps:
        delta = torch.maximum(1e-14 * scale, delta * 100.0)
        L, C, ok = attempt(delta)
        bumps += 1
    return L, C, delta


def block_tridiag_cholesky_lanes_prog(A: torch.Tensor, E: torch.Tensor,
                                      base_reg: float = 0.0, max_bumps: int = 6):
    """block_tridiag_cholesky over a batch, lane by lane, as a lockstep
    program.

    A: (B, k, nb, nb), E: (B, k-1, nb, nb). Each lane's sweep is retried
    with its own escalating shift, as it would be alone; only the lanes
    that failed sweep again. Returns (L, C, delta (B,)).
    """
    Bn, k, nb, _ = A.shape
    eye = torch.eye(nb, dtype=A.dtype, device=A.device)
    scale = torch.clamp(
        torch.diagonal(A, dim1=-2, dim2=-1).abs().flatten(1).amax(dim=1), min=1.0)
    delta = torch.full((Bn,), base_reg, dtype=A.dtype, device=A.device)

    def attempt(idx):
        Ai, Ei = A.index_select(0, idx), E.index_select(0, idx)
        dl = delta[idx, None, None]
        Ls, Cs, bads = [], [], []
        prevL = eye.expand(idx.numel(), nb, nb)
        for i in range(k):
            S_i = Ai[:, i] + dl * eye
            if i > 0:
                C_i = torch.linalg.solve_triangular(
                    prevL, Ei[:, i - 1].mT, upper=False).mT
                S_i = S_i - C_i @ C_i.mT
                Cs.append(C_i)
            L_i, bad = _cholesky(S_i)
            prevL = torch.where(torch.isfinite(L_i), L_i, eye)
            Ls.append(L_i)
            bads.append(bad)
        L = torch.stack(Ls, dim=1)
        C = torch.stack(Cs, dim=1) if Cs else A.new_zeros((idx.numel(), 0, nb, nb))
        ok = ~torch.stack(bads, dim=1).any(dim=1) & torch.isfinite(L).flatten(1).all(dim=1)
        return L, C, ok

    L, C, ok = attempt(torch.arange(Bn, device=A.device))
    for _ in range(max_bumps):
        fail = torch.as_tensor(np.flatnonzero((yield ~ok)), device=A.device)
        if fail.numel() == 0:
            break
        delta[fail] = torch.maximum(1e-14 * scale[fail], delta[fail] * 100.0)
        L[fail], C[fail], ok[fail] = attempt(fail)
    return L, C, delta


def block_tridiag_solve(L: torch.Tensor, C: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (LL') x = rhs for the block-tridiagonal factors above.

    rhs: (k, nb) blocked right-hand side. Forward then backward block
    substitution, each a loop of dense triangular solves.
    """
    k = L.shape[0]
    ys = []
    for i in range(k):
        b_i = rhs[i] if i == 0 else rhs[i] - C[i - 1] @ ys[-1]
        ys.append(torch.linalg.solve_triangular(L[i], b_i[:, None], upper=False)[:, 0])
    xs = [None] * k
    for i in range(k - 1, -1, -1):
        y_i = ys[i] if i == k - 1 else ys[i] - C[i].mT @ xs[i + 1]
        xs[i] = torch.linalg.solve_triangular(L[i].mT, y_i[:, None], upper=True)[:, 0]
    return torch.stack(xs)
