"""PDLP-style first-order LP solver (primal-dual hybrid gradient).

Restarted PDHG in the style of PDLP/cuPDLP (see PAPERS.md) — pure matvec
iterations, for very large instances where factorizations don't fit.
Solves

    min c'x  s.t.  rl <= Ax <= ru,  cl <= x <= cu

with Chambolle-Pock updates and Moreau projection for the two-sided row
bounds. Moderate-accuracy tool (1e-4..1e-6); finishing to simplex accuracy
is the orchestrator's job.

Port of the JAX package's pdlp.py, in f64 on `options.device`. Two matrix
backends share one loop:
  * a dense tensor — `torch.matmul`, when the matrix fits dense;
  * sparse ELL (padded rows) — memory O(nnz) matvecs built from a gather,
    a multiply and a row sum only, with a second padded copy for the
    transpose product. No scatter and no `index_add_`: on the card those
    are atomics, and two runs would not give the same bits.

The JAX package runs the iterations in one `while_loop`. Here they run in
blocks of `check_every`, and the host reads (done, iterations) once per
block. Inside a block every iteration is gated on `done` with
`torch.where`, so an iteration after convergence changes nothing (the
freeze the simplex engine's gated pivots use): the iterates and the
iteration count are the `while_loop`'s.

Ruiz equilibration (a few host-side passes on the scipy matrix) scales the
problem before the iterations — the PDLP papers' standard preconditioning —
and the solution is unscaled on the way out.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .constants import INF, ProblemStatus, SecondaryStatus
from .device import resolve_device
from .model import Model, Solution
from .options import SolveOptions


class EllMatrix(NamedTuple):
    """Row-padded sparse matrix with both orientations materialized.

    `val[i, k] * x[idx[i, k]]` summed over k is row i of A @ x; the T
    fields hold the same matrix padded by columns for A.T @ y. Padding
    entries carry val 0 / idx 0, contributing nothing. Indices are int64,
    as torch indexes.
    """

    val: torch.Tensor   # (m, k)
    idx: torch.Tensor   # (m, k) int64 column indices
    valT: torch.Tensor  # (n, kT)
    idxT: torch.Tensor  # (n, kT) int64 row indices

    def __matmul__(self, x):
        return (self.val * x[self.idx]).sum(dim=1)

    @property
    def T(self) -> "EllMatrix":
        return EllMatrix(self.valT, self.idxT, self.val, self.idx)


def _pad_rows(A_csr):
    """CSR -> (val, idx) padded to the max row length."""
    m = A_csr.shape[0]
    counts = np.diff(A_csr.indptr)
    k = max(int(counts.max(initial=1)), 1) if counts.size else 1
    val = np.zeros((m, k))
    idx = np.zeros((m, k), dtype=np.int32)
    rows = np.repeat(np.arange(m), counts)
    pos = np.arange(A_csr.nnz) - np.repeat(A_csr.indptr[:-1], counts)
    val[rows, pos] = A_csr.data
    idx[rows, pos] = A_csr.indices
    return val, idx


def ell_from_scipy(A_sp, device="cuda") -> EllMatrix:
    import scipy.sparse as sp

    from .convert import ell_from_numpy

    csr = sp.csr_matrix(A_sp)
    val, idx = _pad_rows(csr)
    valT, idxT = _pad_rows(csr.T.tocsr())
    return ell_from_numpy({"val": val, "idx": idx, "valT": valT, "idxT": idxT}, device)


def _max0(t: torch.Tensor) -> torch.Tensor:
    """max(0, max(t)) as a 0-dim tensor (jnp.max(..., initial=0.0))."""
    if t.numel() == 0:
        return torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.clamp_min(t.amax(), 0.0)


def _pdhg(A, c, rl, ru, cl, cu, tol, max_iter: int, check_every: int = 100):
    """Restarted PDHG; A a dense tensor or an EllMatrix, the vectors f64
    tensors on A's device. Returns (x, y, iterations, done) as tensors, y
    in the user dual convention."""
    m = rl.shape[0]
    n = c.shape[0]
    dev, f64 = c.device, c.dtype
    AT = A.T
    # power iteration for ||A||_2
    v = torch.ones(n, dtype=f64, device=dev) / np.sqrt(n)
    for _ in range(30):
        w = AT @ (A @ v)
        v = w / torch.clamp_min(torch.linalg.vector_norm(w), 1e-30)
    # after the power loop v is (approximately) the top right singular
    # vector, so ||A v|| estimates sigma_max directly
    nrm = torch.clamp_min(torch.linalg.vector_norm(A @ v), 1e-30)
    eta = 0.9 / nrm  # tau = eta / omega, sig = eta * omega (PDLP weights)
    fin_rl, fin_ru = torch.isfinite(rl), torch.isfinite(ru)
    fin_cl, fin_cu = torch.isfinite(cl), torch.isfinite(cu)
    c_scale = 1.0 + _max0(c.abs())

    def residuals(x, y_int):
        # internal convention pairs L = c'x + y_int'(Ax) - SF(y_int);
        # user-convention duals are y = -y_int
        y = -y_int
        ax = A @ x
        pinf = _max0(torch.maximum(torch.maximum(rl - ax, ax - ru), torch.zeros_like(ax))) \
            / (1.0 + _max0(ax.abs()))
        d = c - AT @ y
        dviol = torch.maximum(
            torch.where(fin_cu, 0.0, torch.clamp_min(-d, 0.0)),
            torch.where(fin_cl, 0.0, torch.clamp_min(d, 0.0)),
        )
        dinf = _max0(dviol) / c_scale
        pobj = c @ x
        yb = torch.where(y > 0, torch.where(fin_rl, rl, 0.0) * y,
                         torch.where(fin_ru, ru, 0.0) * y)
        db = torch.where(d > 0, torch.where(fin_cl, cl, 0.0) * d,
                         torch.where(fin_cu, cu, 0.0) * d)
        dobj = yb.sum() + db.sum()
        gap = (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())
        return pinf, dinf, gap

    def body(x, y, xa, ya, xr, yr, w, k, kt, r0, done):
        tau = eta / w
        sig = eta * w
        # primal: gradient step on c + A'y_int, project to [cl, cu]
        x1 = torch.clamp(x - tau * (c + AT @ y), cl, cu)
        # dual: Moreau projection for the box support function
        yh = y + sig * (A @ (2.0 * x1 - x))
        y1 = yh - sig * torch.clamp(yh / sig, rl, ru)
        xa1 = (xa * k + x1) / (k + 1)
        ya1 = (ya * k + y1) / (k + 1)
        pinf, dinf, gap = residuals(xa1, ya1)
        resid = torch.maximum(torch.maximum(pinf, dinf), gap)
        done1 = resid < tol
        # adaptive restart (PDLP/cuPDLP-style): once the averaged iterate
        # halves the residual since the last restart, restart the averages
        # from it — accelerates the sublinear tail dramatically
        restart = (~done1) & (k >= 20) & (resid < 0.5 * r0)
        # primal-weight balancing at restarts (PDLP): rebalance tau/sig
        # toward equal primal/dual movement since the last restart,
        # damped in log space
        dx = torch.linalg.vector_norm(xa1 - xr)
        dy = torch.linalg.vector_norm(ya1 - yr)
        ratio = dy / torch.clamp_min(dx, 1e-30)
        # only intervene on strong imbalance (>=10x): on well-balanced
        # instances the fixed weight converges faster (measured)
        use = restart & (dx > 1e-12) & (dy > 1e-12) & ((ratio > 10.0) | (ratio < 0.1))
        w1 = torch.where(use, torch.exp(0.5 * torch.log(ratio) + 0.5 * torch.log(w)), w)
        w1 = torch.clamp(w1, 1e-4, 1e4)
        x1 = torch.where(restart, xa1, x1)
        y1 = torch.where(restart, ya1, y1)
        xr = torch.where(restart, xa1, xr)
        yr = torch.where(restart, ya1, yr)
        k1 = torch.where(restart, 0, k + 1)
        r0 = torch.where(restart, resid, r0)
        new = (x1, y1, xa1, ya1, xr, yr, w1, k1, kt + 1, r0, done1)
        # an iteration after convergence changes nothing (the while_loop's
        # cond would not have run it)
        return tuple(torch.where(done, old, nw) for old, nw in zip(
            (x, y, xa, ya, xr, yr, w, k, kt, r0, done), new))

    x0 = torch.clamp(torch.zeros(n, dtype=f64, device=dev), cl, cu)
    y0 = torch.zeros(m, dtype=f64, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    state = (x0, y0, x0, y0, x0, y0, torch.ones((), dtype=f64, device=dev),
             torch.zeros((), **i64), torch.zeros((), **i64),
             torch.tensor(float("inf"), dtype=f64, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev))
    kt_host = 0
    while kt_host < max_iter:
        for _ in range(min(check_every, max_iter - kt_host)):
            state = body(*state)
        # the one host read of the block
        done_host, kt_host = (int(v) for v in torch.stack(
            [state[10].to(torch.int64), state[8]]).tolist())
        if done_host:
            break
    xa, ya, kt, done = state[2], state[3], state[8], state[10]
    return xa, -ya, kt, done  # flip to the user dual convention


def _ruiz_equilibrate(A_sp, passes: int = 10):
    """Ruiz scaling: D_r A D_c with rows/cols pulled toward unit inf-norm.

    Host-side on the scipy matrix (cheap, O(passes * nnz)); returns
    (dr, dc) with entries 1/sqrt(max |row|), iterated.
    """
    import scipy.sparse as sp

    A = sp.csr_matrix(A_sp, copy=True).astype(np.float64)
    m, n = A.shape
    dr = np.ones(m)
    dc = np.ones(n)
    for _ in range(passes):
        absA = abs(A)
        r = np.sqrt(absA.max(axis=1).toarray().ravel())
        c = np.sqrt(absA.max(axis=0).toarray().ravel())
        r[r == 0] = 1.0
        c[c == 0] = 1.0
        A = sp.diags(1.0 / r) @ A @ sp.diags(1.0 / c)
        dr /= r
        dc /= c
        if np.max(np.abs(r - 1)) < 1e-3 and np.max(np.abs(c - 1)) < 1e-3:
            break
    return dr, dc


def pdlp_solve(model: Model, options: SolveOptions) -> Solution:
    """PDHG solve on options.device; sparse ELL matvecs when the matrix is
    large and sparse (or `options.pdlp_sparse` forces a backend)."""
    dev = resolve_device(options.device)
    A_sp = model.matrix.tocsr()
    m, n = A_sp.shape
    nnz = A_sp.nnz
    force = getattr(options, "pdlp_sparse", None)
    use_sparse = (
        bool(force) if force is not None
        else (m * n >= 1 << 22 and nnz < 0.05 * m * n)
    )
    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0

    # Ruiz equilibration: solve min (Dc c)'x~ s.t. Dr rl <= (Dr A Dc) x~
    # with x~ = Dc^-1 x, bounds scaled by Dc^-1
    dr, dc = _ruiz_equilibrate(A_sp)
    As = (A_sp.multiply(dr[:, None])).tocsr().multiply(dc[None, :]).tocsr()

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    c = t(model.objective * sense * dc)
    rl = t(np.where(model.row_lower <= -INF, -np.inf, model.row_lower * dr))
    ru = t(np.where(model.row_upper >= INF, np.inf, model.row_upper * dr))
    cl = t(np.where(model.col_lower <= -INF, -np.inf, model.col_lower / dc))
    cu = t(np.where(model.col_upper >= INF, np.inf, model.col_upper / dc))

    A = ell_from_scipy(As, dev) if use_sparse else t(As.todense())

    # first-order methods earn their keep at moderate accuracy; the
    # orchestrator's simplex/IPM finishes when tighter tolerances matter
    tol = max(options.barrier_tolerance, 1e-4)
    x, y, iters, done = _pdhg(A, c, rl, ru, cl, cu, tol, max_iter=200000)
    # unscale: x = Dc x~, y = Dr y~ (then sense)
    x = x.cpu().numpy() * dc
    y = y.cpu().numpy() * dr * sense
    d = model.objective - model.matrix.T @ y
    # a first-order OPTIMAL at tol >= 1e-4 is NOT simplex accuracy: carry
    # REDUCED_ACCURACY so callers can tell (cleared by the orchestrator's
    # polish once a simplex finish verifies full KKT)
    sec = SecondaryStatus.FAILED_TO_CONVERGE
    if bool(done):
        sec = (SecondaryStatus.REDUCED_ACCURACY if tol > 1e-7
               else SecondaryStatus.NONE)
    return Solution(
        status=ProblemStatus.OPTIMAL if bool(done) else ProblemStatus.STOPPED,
        secondary_status=sec,
        objective_value=float(model.objective @ x) + model.objective_offset,
        primal=x,
        duals=y,
        reduced_costs=np.asarray(d),
        row_activity=np.asarray(model.matrix @ x),
        iterations=int(iters),
    )
