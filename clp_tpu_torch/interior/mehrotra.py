"""Mehrotra predictor-corrector interior-point method on torch tensors.

Behavioral model: ClpPredictorCorrector::solve (ClpPredictorCorrector.cpp:75)
— per-iteration flow complementarityGap -> affine direction -> step length ->
corrector -> update (cpp:227+,:1016,:1564,:2366,:3070):

  * the Newton solve uses the normal equations M = G D G' + delta_d I:
    dense Cholesky (f64, or f32 with f64 refinement), a block-tridiagonal
    Cholesky on an RCM-banded pattern, a multifrontal sparse Cholesky on
    the device or on the host, or matrix-free CG / LSQR;
  * primal-dual regularization replaces the reference's dropped-row
    handling (ClpCholeskyBase::factorize rowsDropped);
  * all bound handling (lower/upper/free) is mask-based.

The iteration runs as a Python loop on the tensors' device; it reads one
flag on the host per iteration (converged or a non-finite step), and the
factorizations read their success flag once each.

Problem form: min c'x  s.t.  G x = b,  l <= x <= u  (StandardLP; fixed
variables must already be substituted out, see forms.to_ipm_form).

KKT system (z = duals of x-l >= 0, w = duals of u-x >= 0):
    G x = b;   G'y + z - w = c;   (x-l) o z = mu e;   (u-x) o w = mu e.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..forms import StandardLP
from ..ops.linalg import (
    block_tridiag_cholesky,
    block_tridiag_cholesky_lanes_prog,
    block_tridiag_solve,
    chol_factor_reg,
    chol_factor_reg_lanes_prog,
    chol_solve,
)
from ..utils.lockstep import run


@dataclasses.dataclass(frozen=True)
class IPMOptions:
    tol: float = 1e-8
    max_iter: int = 100
    step_factor: float = 0.9995  # Mehrotra step-to-boundary factor
    reg_primal: float = 1e-9  # relative primal regularization (on D^-1)
    reg_dual: float = 1e-10  # relative dual regularization (on M diagonal)
    free_var_cap: float = 1e10  # cap on D entries for free variables
    refine_steps: int = 1  # iterative refinement on each Newton solve
    # "cholesky" (dense, default), "cg", or "lsqr" — the latter two solve
    # the normal equations WITHOUT materializing G D G'. "cg" is Jacobi-
    # (or user-) preconditioned conjugate gradient; "lsqr" runs damped
    # Golub-Kahan bidiagonalization directly on D^{1/2}G', avoiding the
    # squared conditioning of the normal matrix. Together these are the
    # PDCO/ClpLsqr capability (reference: ClpPdco + ClpLsqr, ClpLsqr.cpp:8,
    # ClpPdcoBase.hpp:28-40).
    linear_solver: str = "cholesky"
    cg_maxiter: int = 200
    # user preconditioner hook for the cg path (ClpPdcoBase::matPrecon
    # parity): callable r -> M^{-1} r on tensors, replacing the Jacobi
    # default.
    precond: object = None
    # separable convex objective hooks (ClpPdcoBase::getObj/getGrad/
    # getHessian parity): phi(x) = sum_j phi_j(x_j) ADDED to c'x. obj_fn
    # x->scalar, grad_fn x->vector, hess_fn x->diagonal vector (phi_j''),
    # all on tensors; supply together. Convergence then checks residuals +
    # complementarity (the Fenchel dual gap is not computed for general phi).
    obj_fn: object = None
    grad_fn: object = None
    hess_fn: object = None
    # banded normal equations (the sparse-Cholesky capability,
    # ClpCholeskyBase.cpp:638 AMD ordering + :1982 numeric): when > 0, the
    # LP's rows must already be permuted (host-side RCM) so that the
    # pattern of G G' has bandwidth < band_nb; the Newton solve then runs
    # block-tridiagonal assembly + Cholesky in O(m*nb*nt) / O(m*nb^2)
    # instead of O(m^2*nt) / O(m^3). solve.py detects and permutes.
    band_nb: int = 0
    # separable (diagonal-Hessian) QP: the caller certifies lp.Q is
    # diagonal, so H = Q + D^-1 stays diagonal and every LP Newton branch
    # (dense, banded, cg, lsqr) applies unchanged with dinv += diag(Q) —
    # no (nt, nt) Cholesky.
    q_diag: bool = False
    # general sparse normal equations on the HOST (the unstructured
    # complement of the banded plan — ClpCholeskyBase.cpp:792 orderAMD +
    # :1982 symbolic): a callable (d, rhs) -> dy on numpy arrays backed by
    # ops/sparse_chol.py's supernodal multifrontal factorization with a
    # cached symbolic plan. Set by solve.py on the CPU when the
    # minimum-degree fill estimate beats the dense O(m^3) by a wide margin.
    sparse_chol: object = None
    # DEVICE multifrontal sparse Cholesky: an
    # ops/sparse_chol_device.DeviceNormalSolver whose factor/solve are
    # batched POTRF/TRSM/SYRK tile ops on the tensors' device. The factor
    # dtype may be float32; the Newton solve wraps it in f64 matvec
    # refinement. Takes precedence over sparse_chol when both are set.
    sparse_chol_device: object = None
    # mixed-precision dense normal equations: assemble + factor in f32
    # with symmetric Jacobi scaling and f64 matvec refinement. Set by
    # solve.py on the card, mirroring the JAX package's TPU branch.
    mixed32: bool = False


@dataclasses.dataclass
class IPMResult:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    w: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    primal_infeas: torch.Tensor  # relative ||Gx-b||_inf
    dual_infeas: torch.Tensor  # relative ||c-G'y-z+w||_inf
    rel_gap: torch.Tensor
    pobj: torch.Tensor
    dobj: torch.Tensor
    # divergence diagnostics for infeasibility heuristics
    blowup: torch.Tensor


def _amax0(x: torch.Tensor) -> torch.Tensor:
    """max over x, 0 for an empty x (jnp.max(..., initial=0.0) on |x|)."""
    if x.numel() == 0:
        return x.new_zeros(())
    return torch.clamp(x.amax(), min=0.0)


def _amin_inf(x: torch.Tensor) -> torch.Tensor:
    """min over x, +inf for an empty x (jnp.min(..., initial=inf))."""
    if x.numel() == 0:
        return x.new_full((), torch.inf)
    return x.amin()


def _starting_point(lp: StandardLP, hl, hu, opts: IPMOptions,
                    G_blk=None, pad_eye=None):
    """Least-squares start (LIPSOL-flavored), clamped into the bounds.

    With a banded plan (G_blk/pad_eye from ipm_solve), the G G' solve runs
    block-tridiagonal instead of dense."""
    G, b = lp.G, lp.b
    m, nt = G.shape
    if G_blk is not None:
        nb = G_blk.shape[1]
        mpad = G_blk.shape[0] * nb
        A0 = (torch.bmm(G_blk, G_blk.mT) + pad_eye
              + 1e-12 * torch.eye(nb, dtype=G.dtype, device=G.device))
        E0 = torch.bmm(G_blk[1:], G_blk[:-1].mT)
        Lb, Cb, _ = block_tridiag_cholesky(A0, E0)
        bp = torch.zeros(mpad, dtype=b.dtype, device=b.device)
        bp[:m] = b
        yls = block_tridiag_solve(Lb, Cb, bp.reshape(-1, nb)).reshape(-1)[:m]
        x_ls = G.T @ yls
    else:
        M0 = G @ G.T
        L0, _ = chol_factor_reg(M0, base_reg=1e-12)
        x_ls = G.T @ chol_solve(L0, b)

    both = hl & hu
    width = torch.where(both, lp.u - lp.l, torch.inf)
    margin = torch.minimum(1.0 + 0.1 * x_ls.abs(), 0.25 * width)
    lo = torch.where(hl, lp.l + torch.where(both, margin, 1.0 + 0.1 * lp.l.abs()), -torch.inf)
    hi = torch.where(hu, lp.u - torch.where(both, margin, 1.0 + 0.1 * lp.u.abs()), torch.inf)
    # make sure lo <= hi even for narrow ranges
    mid = 0.5 * (torch.where(torch.isfinite(lo), lo, 0.0)
                 + torch.where(torch.isfinite(hi), hi, 0.0))
    lo_ok = lo <= hi
    x0 = torch.clamp(x_ls, torch.where(lo_ok, lo, mid), torch.where(lo_ok, hi, mid))

    cscale = 1.0 + torch.sqrt(torch.sum(lp.c * lp.c) / nt)
    z0 = torch.where(hl, cscale, 0.0)
    w0 = torch.where(hu, cscale, 0.0)
    y0 = torch.zeros(m, dtype=G.dtype, device=G.device)
    return x0, y0, z0, w0


def _cg(matvec, b: torch.Tensor, M, tol: float, maxiter: int) -> torch.Tensor:
    """Preconditioned conjugate gradient from x0 = 0 with the stop rule of
    jax.scipy.sparse.linalg.cg: stop once ||r||^2 <= max(tol^2 ||b||^2,
    atol^2) (atol = 0), or after maxiter steps. One host read per step."""
    atol2 = tol * tol * torch.dot(b, b)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = z = M(r)
    gamma = torch.dot(r, z)
    k = 0
    while k < maxiter and bool(torch.dot(r, r) > atol2):
        Ap = matvec(p)
        alpha = gamma / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_ = torch.dot(r, z)
        p = z + (gamma_ / gamma) * p
        gamma = gamma_
        k += 1
    return x


def _lsqr_damped(G, sqd, sqreg, rhs, maxiter: int):
    """Damped LSQR (Paige-Saunders) for (G D G' + reg) dy = rhs.

    Operates on the stacked operator A v = [sqd * (G'v); sqreg * v] with
    b = [0; rhs/sqreg] — never materializing G D G'. Golub-Kahan
    bidiagonalization with early exit (ClpLsqr.cpp:8), one host read per
    step. All vectors stay in two blocks (nt and m) to avoid a
    concatenated temporary.
    """
    tiny = 1e-300

    def A_fwd(v):  # m -> (nt, m)
        return sqd * (G.T @ v), sqreg * v

    def A_adj(u1, u2):  # (nt, m) -> m
        return G @ (sqd * u1) + sqreg * u2

    sqreg_c = torch.clamp(torch.as_tensor(sqreg, dtype=rhs.dtype, device=rhs.device), min=tiny)
    bnorm = torch.linalg.vector_norm(rhs) / sqreg_c
    beta = bnorm
    u1 = torch.zeros(G.shape[1], dtype=rhs.dtype, device=rhs.device)
    u2 = (rhs / sqreg_c) / torch.clamp(beta, min=tiny)
    v = A_adj(u1, u2)
    alpha = torch.linalg.vector_norm(v)
    v = v / torch.clamp(alpha, min=tiny)
    w = v
    x = torch.zeros(G.shape[0], dtype=rhs.dtype, device=rhs.device)
    phibar = beta
    rhobar = alpha
    stop = 1e-12 * torch.clamp(bnorm, min=tiny)
    it = 0
    while it < maxiter and bool(phibar.abs() > stop):
        a1, a2 = A_fwd(v)
        u1n = a1 - alpha * u1
        u2n = a2 - alpha * u2
        beta_n = torch.sqrt(torch.sum(u1n * u1n) + torch.sum(u2n * u2n))
        u1n = u1n / torch.clamp(beta_n, min=tiny)
        u2n = u2n / torch.clamp(beta_n, min=tiny)
        vn = A_adj(u1n, u2n) - beta_n * v
        alpha_n = torch.linalg.vector_norm(vn)
        vn = vn / torch.clamp(alpha_n, min=tiny)
        rho = torch.sqrt(rhobar * rhobar + beta_n * beta_n)
        cth = rhobar / torch.clamp(rho, min=tiny)
        sth = beta_n / torch.clamp(rho, min=tiny)
        theta = sth * alpha_n
        rhobar = -cth * alpha_n
        phi = cth * phibar
        phibar = sth * phibar
        x = x + (phi / torch.clamp(rho, min=tiny)) * w
        w = vn - (theta / torch.clamp(rho, min=tiny)) * w
        u1, u2, v, alpha = u1n, u2n, vn, alpha_n
        it += 1
    return x


def _max_step(v, dv, mask):
    """max alpha in [0, 1e20] with v + alpha*dv >= 0 over masked entries."""
    bad = mask & (dv < 0)
    ratios = torch.where(bad, -v / torch.where(bad, dv, -1.0), torch.inf)
    return torch.clamp(_amin_inf(ratios), max=1e20)


def _diag_solve(d):
    def hsolve(r):  # (Q + D^-1)^{-1} r for the LP case: just d * r
        return d * r if r.ndim == 1 else d[:, None] * r
    return hsolve


def ipm_solve(lp: StandardLP, opts: IPMOptions = IPMOptions()) -> IPMResult:
    """Single-instance Mehrotra IPM on the tensors' device."""
    G, b, c, l, u = lp.G, lp.b, lp.c, lp.l, lp.u
    Q = lp.Q  # None for pure LP; (nt, nt) PSD for QP
    # separable QP (caller-certified diagonal Q): the Hessian joins the
    # D^-1 diagonal and every LP Newton branch applies unchanged
    qdiag = torch.diagonal(Q) if (Q is not None and opts.q_diag) else None
    separable = Q is None or qdiag is not None
    m, nt = G.shape
    dtype, device = G.dtype, G.device
    hl = torch.isfinite(l)
    hu = torch.isfinite(u)
    n_active = torch.clamp(hl.sum() + hu.sum(), min=1).to(dtype)
    bnorm = 1.0 + _amax0(b.abs())
    cnorm = 1.0 + _amax0(c.abs())

    if opts.band_nb > 0 and separable:
        # loop-invariant blocked view of G for the banded Newton solve
        nb_ = opts.band_nb
        _k = -(-m // nb_)
        _mpad = _k * nb_
        Gp = torch.zeros((_mpad, nt), dtype=dtype, device=device)
        Gp[:m] = G
        _G_blk = Gp.reshape(_k, nb_, nt)
        padm = (torch.arange(_mpad, device=device) >= m).to(dtype).reshape(_k, nb_)
        _pad_eye = torch.diag_embed(padm)
    else:
        _G_blk = _pad_eye = None
        _mpad = 0

    x0, y0, z0, w0 = _starting_point(lp, hl, hu, opts, _G_blk, _pad_eye)

    nonlinear = opts.grad_fn is not None  # PDCO separable-objective mode

    def grad(x):
        if Q is None:
            g0 = c
        elif qdiag is not None:
            g0 = c + qdiag * x
        else:
            g0 = c + Q @ x
        return g0 + opts.grad_fn(x) if nonlinear else g0

    def residuals(x, y, z, w):
        rb = b - G @ x
        rc = grad(x) - G.T @ y - z + w
        return rb, rc

    def mu_of(g, t, z, w):
        return (torch.sum(torch.where(hl, g * z, 0.0))
                + torch.sum(torch.where(hu, t * w, 0.0))) / n_active

    def metrics(x, y, z, w):
        rb, rc = residuals(x, y, z, w)
        pinf = _amax0(rb.abs()) / bnorm
        dinf = _amax0(rc.abs()) / cnorm
        if Q is None:
            quad = 0.0
        elif qdiag is not None:
            quad = 0.5 * torch.sum(qdiag * x * x)
        else:
            quad = 0.5 * (x @ (Q @ x))
        pobj = c @ x + quad
        if nonlinear and opts.obj_fn is not None:
            pobj = pobj + opts.obj_fn(x)
        dobj = (b @ y
                + torch.sum(torch.where(hl, l * z, 0.0))
                - torch.sum(torch.where(hu, u * w, 0.0))
                - quad)
        relgap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj))
        return pinf, dinf, relgap, pobj, dobj

    def converged(x, y, z, w):
        pinf, dinf, relgap, pobj, _ = metrics(x, y, z, w)
        if nonlinear:
            # the Fenchel dual value is not computed for general phi:
            # residuals + complementarity replace the gap (PDCO criterion)
            gg = torch.where(hl, x - l, 1.0)
            tt = torch.where(hu, u - x, 1.0)
            comp = (torch.sum(torch.where(hl, torch.abs(gg * z), 0.0))
                    + torch.sum(torch.where(hu, torch.abs(tt * w), 0.0))) / n_active
            gap_ok = comp <= opts.tol * (1.0 + torch.abs(pobj))
        else:
            gap_ok = relgap <= opts.tol
        return (pinf <= opts.tol) & (dinf <= opts.tol) & gap_ok

    def newton_system(dinv):
        """(nsolve, hsolve) for this iteration's normal equations."""
        if separable and opts.linear_solver == "cg":
            # matrix-free normal equations: Mv = G(d*(G'v)) + reg*v
            d = torch.clamp(1.0 / dinv, max=opts.free_var_cap)
            reg = opts.reg_dual + 1e-12
            diag_m = (G * G) @ d + reg
            # matPrecon parity: user hook replaces the Jacobi default
            M_apply = opts.precond or (lambda r: r / diag_m)

            def matvec(v):
                return G @ (d * (G.T @ v)) + reg * v

            def nsolve(rhs):
                return _cg(matvec, rhs, M_apply, tol=1e-12, maxiter=opts.cg_maxiter)

            return nsolve, _diag_solve(d)

        if separable and opts.band_nb > 0:
            # block-tridiagonal normal equations on the (host-permuted)
            # banded pattern: O(m*nb*nt) assembly via batched products +
            # O(m*nb^2) factorization, refined matrix-free in f64
            d = torch.clamp(1.0 / dinv, max=opts.free_var_cap)
            reg = opts.reg_dual + 1e-12
            nb = opts.band_nb
            Gd_blk = _G_blk * d  # (k, nb, nt)
            A_blk = (torch.bmm(Gd_blk, _G_blk.mT)
                     + _pad_eye  # identity on padded rows keeps blocks SPD
                     + reg * torch.eye(nb, dtype=dtype, device=device))
            E_blk = torch.bmm(Gd_blk[1:], _G_blk[:-1].mT)
            Lb, Cb, _ = block_tridiag_cholesky(A_blk, E_blk, base_reg=0.0)

            def matvec(v):
                return G @ (d * (G.T @ v)) + reg * v

            def band_solve(r):
                rp = torch.zeros(_mpad, dtype=r.dtype, device=device)
                rp[:m] = r
                return block_tridiag_solve(Lb, Cb, rp.reshape(-1, nb)).reshape(-1)[:m]

            def nsolve(rhs):
                x = band_solve(rhs)
                for _ in range(opts.refine_steps + 1):
                    x = x + band_solve(rhs - matvec(x))
                return x

            return nsolve, _diag_solve(d)

        if separable and opts.sparse_chol_device is not None:
            # general sparse G D G': DEVICE multifrontal Cholesky — the
            # same symbolic plan as the host path, the numeric as batched
            # POTRF/TRSM/SYRK tiles (ClpCholeskyBase.cpp:2767 factorize
            # role). Factor once per IPM iteration; f32 factors are
            # wrapped in f64 matvec refinement.
            d = torch.clamp(1.0 / dinv, max=opts.free_var_cap)
            reg = opts.reg_dual + 1e-12
            dev = opts.sparse_chol_device
            f32 = dev.dev.dtype == torch.float32
            fstate, f_ok = dev.factor(d)
            if not bool(f_ok):
                # breakdown: one diagonal-shifted refactor (the host
                # path's escalating-shift loop, single step)
                fstate = dev.factor_shifted(d, 1e-6)[0]

            def matvec(v):
                return G @ (d * (G.T @ v)) + reg * v

            def nsolve(rhs):
                x = dev.solve_with(fstate, rhs)
                for _ in range(opts.refine_steps + (3 if f32 else 0)):
                    x = x + dev.solve_with(fstate, rhs - matvec(x))
                return x

            return nsolve, _diag_solve(d)

        if separable and opts.sparse_chol is not None:
            # general sparse G D G': host supernodal multifrontal Cholesky
            # with a fixed symbolic plan (minimum degree + etree postorder
            # + relaxed supernodes), re-factored each iteration with the
            # new D; matvec refinement on the tensors' device restores any
            # accuracy the host f64 factor left behind
            d = torch.clamp(1.0 / dinv, max=opts.free_var_cap)
            reg = opts.reg_dual + 1e-12
            d_host = d.cpu().numpy()

            def matvec(v):
                return G @ (d * (G.T @ v)) + reg * v

            def host(rhs):
                dy = opts.sparse_chol(d_host, rhs.cpu().numpy())
                return torch.as_tensor(dy, dtype=rhs.dtype, device=device)

            def nsolve(rhs):
                dy = host(rhs)
                for _ in range(opts.refine_steps):
                    dy = dy + host(rhs - matvec(dy))
                return dy

            return nsolve, _diag_solve(d)

        if separable and opts.linear_solver == "lsqr":
            # damped LSQR on A = [D^{1/2} G' ; sqrt(reg) I], b = [0;
            # rhs/sqrt(reg)]: the normal equations of this least-squares
            # problem are exactly (G D G' + reg) dy = rhs, but the Krylov
            # process sees A (condition sqrt(kappa(M))) — ClpLsqr's reason
            # for existing (ClpLsqr.cpp:8)
            d = torch.clamp(1.0 / dinv, max=opts.free_var_cap)
            reg = opts.reg_dual + 1e-10
            sqd = torch.sqrt(d)
            sqreg = float(np.sqrt(reg))

            def nsolve(rhs):
                return _lsqr_damped(G, sqd, sqreg, rhs, opts.cg_maxiter)

            return nsolve, _diag_solve(d)

        if separable and opts.mixed32:
            # mixed-precision dense normal equations (the card): assembly
            # and Cholesky run in f32, symmetric Jacobi scaling tames the
            # IPM's late-iteration diagonal spread, and f64 matvec
            # refinement recovers f64-class Newton directions (the same
            # contract as the f32 simplex inverse and the device
            # multifrontal path). TF32 is refused by check_fp32_precision.
            d = torch.clamp(1.0 / dinv, max=opts.free_var_cap)
            reg = opts.reg_dual + 1e-12
            G32 = G.to(torch.float32)
            d32 = d.to(torch.float32)
            M32 = (G32 * d32) @ G32.T
            diag = torch.diagonal(M32) + reg
            s32 = torch.rsqrt(torch.clamp(diag, min=1e-30))
            Ms = M32 * s32[:, None] * s32[None, :]
            Ms = Ms + torch.diag_embed(reg * s32 * s32 + 1e-7)
            L32, _ = chol_factor_reg(Ms, base_reg=0.0)
            s64 = s32.to(dtype)

            def matvec(v):
                return G @ (d * (G.T @ v)) + reg * v

            def f32_solve(r):
                return s64 * chol_solve(L32, (s64 * r).to(torch.float32)).to(r.dtype)

            def nsolve(rhs):
                x = f32_solve(rhs)
                for _ in range(opts.refine_steps + 3):
                    x = x + f32_solve(rhs - matvec(x))
                return x

            return nsolve, _diag_solve(d)

        if separable:
            d = torch.clamp(1.0 / dinv, max=opts.free_var_cap)
            M = (G * d) @ G.T
            L, _ = chol_factor_reg(M, base_reg=opts.reg_dual)

            def nsolve(rhs):
                dy = chol_solve(L, rhs)
                for _ in range(opts.refine_steps):
                    dy = dy + chol_solve(L, rhs - M @ dy)
                return dy

            return nsolve, _diag_solve(d)

        # QP: H = Q + D^-1 is SPD (Q PSD, D^-1 > 0); reduce through it
        # (the reference requires KKT mode for QP barriers,
        # ClpPredictorCorrector.cpp:114-124 — this is the same algebra
        # folded into two SPD solves)
        H = Q + torch.diag_embed(torch.clamp(dinv, min=1.0 / opts.free_var_cap))
        Lh, _ = chol_factor_reg(H, base_reg=opts.reg_dual)

        def hsolve(r):
            return chol_solve(Lh, r)

        M = G @ hsolve(G.T)
        L, _ = chol_factor_reg(M, base_reg=opts.reg_dual)

        def nsolve(rhs):
            dy = chol_solve(L, rhs)
            for _ in range(opts.refine_steps):
                dy = dy + chol_solve(L, rhs - M @ dy)
            return dy

        return nsolve, hsolve

    def body(x, y, z, w, g, t):
        # g and t are carried (updated by alpha*dx), NOT recomputed as x-l:
        # recomputation rounds to exactly zero once x converges onto a bound,
        # which poisons the z/g divisions — carrying slacks keeps them
        # strictly positive (standard primal-dual implementation practice)
        rb, rc = residuals(x, y, z, w)
        mu = mu_of(g, t, z, w)

        zg = torch.where(hl, z / g, 0.0)
        wt = torch.where(hu, w / t, 0.0)
        # regularization decays with mu: a static shift biases the optimum
        # by O(reg) and floors the attainable duality gap just above tol
        reg_p = torch.clamp(1e-2 * mu + 1e-14, max=opts.reg_primal)
        dinv = zg + wt + reg_p * (1.0 + c.abs())
        if nonlinear and opts.hess_fn is not None:
            # separable phi'' joins the diagonal of the Newton system
            # (getHessian parity): H = diag(phi'') + D^-1
            dinv = dinv + torch.clamp(opts.hess_fn(x), min=0.0)
        if qdiag is not None:
            # separable QP: H = Q + D^-1 stays diagonal
            dinv = dinv + torch.clamp(qdiag, min=0.0)

        nsolve, hsolve = newton_system(dinv)

        def newton(rgz, rtw):
            h = rc - torch.where(hl, rgz / g, 0.0) + torch.where(hu, rtw / t, 0.0)
            rhs = rb + G @ hsolve(h)
            dy = nsolve(rhs)
            dx = hsolve(G.T @ dy - h)
            dz = torch.where(hl, (rgz - z * dx) / g, 0.0)
            dw = torch.where(hu, (rtw + w * dx) / t, 0.0)
            return dx, dy, dz, dw

        # --- predictor (affine scaling) ---
        rgz_aff = -g * z
        rtw_aff = -t * w
        dxa, dya, dza, dwa = newton(rgz_aff, rtw_aff)
        ap_aff = torch.clamp(torch.minimum(_max_step(g, dxa, hl), _max_step(t, -dxa, hu)),
                             max=1.0)
        ad_aff = torch.clamp(torch.minimum(_max_step(z, dza, hl), _max_step(w, dwa, hu)),
                             max=1.0)
        mu_aff = (torch.sum(torch.where(hl, (g + ap_aff * dxa) * (z + ad_aff * dza), 0.0))
                  + torch.sum(torch.where(hu, (t - ap_aff * dxa) * (w + ad_aff * dwa), 0.0))
                  ) / n_active
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-300)) ** 3, 1e-8, 1.0)

        # --- corrector ---
        rgz = sigma * mu - g * z - dxa * dza
        rtw = sigma * mu - t * w + dxa * dwa
        dx, dy, dz, dw = newton(rgz, rtw)

        ap_max = torch.minimum(_max_step(g, dx, hl), _max_step(t, -dx, hu))
        ad_max = torch.minimum(_max_step(z, dz, hl), _max_step(w, dw, hu))
        eta = torch.clamp(1.0 - 0.1 * mu, min=opts.step_factor)
        ap = torch.clamp(eta * ap_max, max=1.0)
        ad = torch.clamp(eta * ad_max, max=1.0)

        x1 = x + ap * dx
        # x and the carried slacks drift apart in float; x escaping its
        # bounds makes pobj undercut dobj and the duality gap unattainable.
        # Projecting back is absorbed by the infeasible-start Newton (rb).
        x1 = torch.clamp(x1, l, u)
        y1 = y + ad * dy
        z1 = torch.where(hl, z + ad * dz, 0.0)
        w1 = torch.where(hu, w + ad * dw, 0.0)
        g1 = torch.where(hl, g + ap * dx, 1.0)
        t1 = torch.where(hu, t - ap * dx, 1.0)
        # a step of at most eta*alpha_max guarantees g1 >= (1-eta)*g
        # mathematically; enforce it against floating-point cancellation
        slack_keep = 0.1 * (1.0 - opts.step_factor)
        g1 = torch.where(hl, torch.maximum(g1, slack_keep * g), 1.0)
        t1 = torch.where(hu, torch.maximum(t1, slack_keep * t), 1.0)

        # centrality safeguard (Gondzio-style): keep every complementarity
        # product within a band around mu so no multiplier collapses to zero
        # prematurely (the dual-residual perturbation this introduces is
        # absorbed by the infeasible-start Newton steps)
        mu1 = mu_of(g1, t1, z1, w1)
        lo_band = 1e-5
        z1 = torch.where(hl & (g1 * z1 < lo_band * mu1), lo_band * mu1 / g1, z1)
        w1 = torch.where(hu & (t1 * w1 < lo_band * mu1), lo_band * mu1 / t1, w1)

        # reject steps that produced non-finite values (keep previous iterate,
        # convergence check will stop us; mirrors the reference's disaster
        # handling, ClpSimplex.hpp:993)
        finite = (torch.isfinite(x1).all() & torch.isfinite(y1).all()
                  & torch.isfinite(z1).all() & torch.isfinite(w1).all())
        x1 = torch.where(finite, x1, x)
        y1 = torch.where(finite, y1, y)
        z1 = torch.where(finite, z1, z)
        w1 = torch.where(finite, w1, w)
        g1 = torch.where(finite, g1, g)
        t1 = torch.where(finite, t1, t)

        done = converged(x1, y1, z1, w1) | ~finite
        return (x1, y1, z1, w1, g1, t1), done

    g0 = torch.where(hl, x0 - l, 1.0)
    t0 = torch.where(hu, u - x0, 1.0)
    state = (x0, y0, z0, w0, g0, t0)
    it = 0
    done = bool(converged(x0, y0, z0, w0))
    while not done and it < opts.max_iter:
        state, done_t = body(*state)
        it += 1
        done = bool(done_t)
    x, y, z, w, _, _ = state

    pinf, dinf, relgap, pobj, dobj = metrics(x, y, z, w)
    conv = converged(x, y, z, w)
    blowup = torch.maximum(_amax0(z.abs()), _amax0(w.abs()))
    return IPMResult(
        x=x,
        y=y,
        z=z,
        w=w,
        iterations=torch.tensor(it),
        converged=conv,
        primal_infeas=pinf,
        dual_infeas=dinf,
        rel_gap=relgap,
        pobj=pobj,
        dobj=dobj,
        blowup=blowup,
    )


# --------------------------------------------------------------------------
# the batched IPM: many same-shape LPs (or QPs), lane by lane
# --------------------------------------------------------------------------


def _lane_metrics(G, b, c, l, u, Q, hl, hu, bnorm, cnorm, x, y, z, w):
    """ipm_solve's metrics for one lane (vmapped)."""
    rb = b - G @ x
    rc = (c if Q is None else c + Q @ x) - G.T @ y - z + w
    pinf = torch.clamp(rb.abs().amax(), min=0.0) / bnorm
    dinf = torch.clamp(rc.abs().amax(), min=0.0) / cnorm
    quad = 0.0 if Q is None else 0.5 * (x @ (Q @ x))
    pobj = c @ x + quad
    dobj = (b @ y + torch.sum(torch.where(hl, l * z, 0.0))
            - torch.sum(torch.where(hu, u * w, 0.0)) - quad)
    relgap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj))
    return rb, rc, pinf, dinf, relgap, pobj, dobj


def ipm_solve_batched(lp: StandardLP, opts: IPMOptions = IPMOptions()) -> IPMResult:
    """Mehrotra IPM over a batch of same-shape problems on a leading axis B
    (`ipm_batched_prog` run alone)."""
    return run(ipm_batched_prog(lp, opts))


def ipm_batched_prog(lp: StandardLP, opts: IPMOptions = IPMOptions()):
    """Mehrotra IPM over a batch of same-shape problems on a leading axis B,
    as a lockstep program (utils/lockstep.py): it yields its host reads,
    so the lane blocks of a device mesh iterate together.

    The JAX package runs ipm_solve under jax.vmap, where its while_loop
    becomes one loop with a per-lane frozen carry and its factorizations'
    escalation loops run per lane. Here: one Python loop over IPM
    iterations, a per-lane `done` mask read on the host once per iteration
    for the whole batch, each iteration computed for the lanes still
    running only, and the Newton factorizations escalating their shifts
    lane by lane (chol_factor_reg_lanes_prog /
    block_tridiag_cholesky_lanes_prog). So every lane takes the iterations it would take alone. The lane
    arithmetic is ipm_solve's, vmapped. The branches are the batch's:
    dense and banded (opts.band_nb, rows already permuted) normal equations
    for LPs, the H = Q + D^-1 reduction for QPs.
    """
    if (opts.linear_solver != "cholesky" or opts.sparse_chol is not None
            or opts.sparse_chol_device is not None or opts.mixed32
            or opts.q_diag or opts.grad_fn is not None):
        raise ValueError("ipm_solve_batched runs the dense, banded and QP "
                         "Newton branches only")
    from torch.func import vmap

    G, b, c, l, u, Q = lp.G, lp.b, lp.c, lp.l, lp.u, lp.Q
    Bn, m, nt = G.shape
    dtype, device = G.dtype, G.device
    hl, hu = torch.isfinite(l), torch.isfinite(u)
    n_active = torch.clamp(hl.sum(dim=1) + hu.sum(dim=1), min=1).to(dtype)
    bnorm = 1.0 + torch.clamp(b.abs().amax(dim=1), min=0.0) if m else G.new_ones(Bn)
    cnorm = 1.0 + torch.clamp(c.abs().amax(dim=1), min=0.0)
    banded = opts.band_nb > 0 and Q is None
    reg = opts.reg_dual + 1e-12
    eye_m = torch.eye(m, dtype=dtype, device=device)

    if banded:
        nb = opts.band_nb
        kb = -(-m // nb)
        Gp = torch.zeros((Bn, kb * nb, nt), dtype=dtype, device=device)
        Gp[:, :m] = G
        G_blk = Gp.reshape(Bn, kb, nb, nt)
        padm = (torch.arange(kb * nb, device=device) >= m).to(dtype).reshape(kb, nb)
        pad_eye = torch.diag_embed(padm)
        eye_nb = torch.eye(nb, dtype=dtype, device=device)

        def band_factor(idx, d, shift, base_reg):
            Gb = G_blk.index_select(0, idx)
            Gd = Gb if d is None else Gb * d[:, None, None, :]
            A = Gd @ Gb.mT + pad_eye + shift * eye_nb
            E = Gd[:, 1:] @ Gb[:, :-1].mT
            Lb, Cb, _ = yield from block_tridiag_cholesky_lanes_prog(A, E, base_reg=base_reg)
            return Lb, Cb

        def band_solve(Lb, Cb, r):  # one lane
            rp = torch.nn.functional.pad(r, (0, kb * nb - m))
            return block_tridiag_solve(Lb, Cb, rp.reshape(kb, nb)).reshape(-1)[:m]

        all_ = torch.arange(Bn, device=device)
        Lb0, Cb0 = yield from band_factor(all_, None, 1e-12, 0.0)
        yls = vmap(band_solve)(Lb0, Cb0, b)
    else:
        L0, _ = yield from chol_factor_reg_lanes_prog(G @ G.mT, base_reg=1e-12)
        yls = vmap(chol_solve)(L0, b)
    x_ls = (yls[:, None, :] @ G)[:, 0]

    def start(l1, u1, c1, hl1, hu1, x_ls1):  # _starting_point after x_ls
        both = hl1 & hu1
        width = torch.where(both, u1 - l1, torch.inf)
        margin = torch.minimum(1.0 + 0.1 * x_ls1.abs(), 0.25 * width)
        lo = torch.where(hl1, l1 + torch.where(both, margin, 1.0 + 0.1 * l1.abs()), -torch.inf)
        hi = torch.where(hu1, u1 - torch.where(both, margin, 1.0 + 0.1 * u1.abs()), torch.inf)
        mid = 0.5 * (torch.where(torch.isfinite(lo), lo, 0.0)
                     + torch.where(torch.isfinite(hi), hi, 0.0))
        lo_ok = lo <= hi
        x0 = torch.clamp(x_ls1, torch.where(lo_ok, lo, mid), torch.where(lo_ok, hi, mid))
        cscale = 1.0 + torch.sqrt(torch.sum(c1 * c1) / nt)
        z0 = torch.where(hl1, cscale, 0.0)
        w0 = torch.where(hu1, cscale, 0.0)
        g0 = torch.where(hl1, x0 - l1, 1.0)
        t0 = torch.where(hu1, u1 - x0, 1.0)
        return x0, torch.zeros(m, dtype=dtype, device=device), z0, w0, g0, t0

    st = [a.clone() for a in vmap(start)(l, u, c, hl, hu, x_ls)]

    def lane(i, t):
        """Lane subset i of the per-lane problem data (Q may be None)."""
        return [None if a is None else a.index_select(0, i) for a in t]

    data = (G, b, c, l, u, Q, hl, hu, bnorm, cnorm)
    qd = Q is not None

    def metrics(*a):
        G1, b1, c1, l1, u1, *rest = a
        Q1 = rest[0] if qd else None
        rest = rest[1:] if qd else rest
        return _lane_metrics(G1, b1, c1, l1, u1, Q1, *rest)

    def conv_of(pinf, dinf, relgap):
        return (pinf <= opts.tol) & (dinf <= opts.tol) & (relgap <= opts.tol)

    def packed(t):  # the data tuple without a None Q, for vmap
        return [a for a in t if a is not None]

    _, _, pinf, dinf, relgap, _, _ = vmap(metrics)(*packed(data), *st[:4])
    done = conv_of(pinf, dinf, relgap)
    it = torch.zeros(Bn, dtype=torch.int64, device=device)

    def pre(G1, b1, c1, l1, u1, *rest):
        Q1 = rest[0] if qd else None
        hl1, hu1, bn1, cn1, na1, x, y, z, w, g, t = rest[1:] if qd else rest
        rb, rc, *_ = _lane_metrics(G1, b1, c1, l1, u1, Q1, hl1, hu1, bn1, cn1, x, y, z, w)
        mu = (torch.sum(torch.where(hl1, g * z, 0.0))
              + torch.sum(torch.where(hu1, t * w, 0.0))) / na1
        zg = torch.where(hl1, z / g, 0.0)
        wt = torch.where(hu1, w / t, 0.0)
        reg_p = torch.clamp(1e-2 * mu + 1e-14, max=opts.reg_primal)
        dinv = zg + wt + reg_p * (1.0 + c1.abs())
        return rb, rc, mu, dinv

    def post(G1, b1, c1, l1, u1, *rest):
        """One lane's predictor-corrector step; `fac` is the lane's Newton
        factors: (M, L) dense, (Lb, Cb) banded, (Lh, M, L) for a QP."""
        Q1 = rest[0] if qd else None
        hl1, hu1, bn1, cn1, na1, x, y, z, w, g, t, rb, rc, mu, dinv = rest[1 if qd else 0:][:15]
        fac = rest[(1 if qd else 0) + 15:]
        d = torch.clamp(1.0 / dinv, max=opts.free_var_cap)
        if qd:
            Lh, M, L = fac

            def hsolve(r):
                return chol_solve(Lh, r)
        else:
            def hsolve(r):
                return d * r
        if banded:
            Lb, Cb = fac

            def nsolve(rhs):
                x_ = band_solve(Lb, Cb, rhs)
                for _ in range(opts.refine_steps + 1):
                    x_ = x_ + band_solve(Lb, Cb, rhs - (G1 @ (d * (G1.T @ x_)) + reg * x_))
                return x_
        else:
            M, L = fac[-2:]

            def nsolve(rhs):
                dy = chol_solve(L, rhs)
                for _ in range(opts.refine_steps):
                    dy = dy + chol_solve(L, rhs - M @ dy)
                return dy

        def newton(rgz, rtw):
            h = rc - torch.where(hl1, rgz / g, 0.0) + torch.where(hu1, rtw / t, 0.0)
            dy = nsolve(rb + G1 @ hsolve(h))
            dx = hsolve(G1.T @ dy - h)
            dz = torch.where(hl1, (rgz - z * dx) / g, 0.0)
            dw = torch.where(hu1, (rtw + w * dx) / t, 0.0)
            return dx, dy, dz, dw

        dxa, dya, dza, dwa = newton(-g * z, -t * w)
        ap_aff = torch.clamp(torch.minimum(_max_step(g, dxa, hl1), _max_step(t, -dxa, hu1)),
                             max=1.0)
        ad_aff = torch.clamp(torch.minimum(_max_step(z, dza, hl1), _max_step(w, dwa, hu1)),
                             max=1.0)
        mu_aff = (torch.sum(torch.where(hl1, (g + ap_aff * dxa) * (z + ad_aff * dza), 0.0))
                  + torch.sum(torch.where(hu1, (t - ap_aff * dxa) * (w + ad_aff * dwa), 0.0))
                  ) / na1
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-300)) ** 3, 1e-8, 1.0)
        dx, dy, dz, dw = newton(sigma * mu - g * z - dxa * dza,
                                sigma * mu - t * w + dxa * dwa)
        ap_max = torch.minimum(_max_step(g, dx, hl1), _max_step(t, -dx, hu1))
        ad_max = torch.minimum(_max_step(z, dz, hl1), _max_step(w, dw, hu1))
        eta = torch.clamp(1.0 - 0.1 * mu, min=opts.step_factor)
        ap = torch.clamp(eta * ap_max, max=1.0)
        ad = torch.clamp(eta * ad_max, max=1.0)
        x1 = torch.clamp(x + ap * dx, l1, u1)
        y1 = y + ad * dy
        z1 = torch.where(hl1, z + ad * dz, 0.0)
        w1 = torch.where(hu1, w + ad * dw, 0.0)
        g1 = torch.where(hl1, g + ap * dx, 1.0)
        t1 = torch.where(hu1, t - ap * dx, 1.0)
        slack_keep = 0.1 * (1.0 - opts.step_factor)
        g1 = torch.where(hl1, torch.maximum(g1, slack_keep * g), 1.0)
        t1 = torch.where(hu1, torch.maximum(t1, slack_keep * t), 1.0)
        mu1 = (torch.sum(torch.where(hl1, g1 * z1, 0.0))
               + torch.sum(torch.where(hu1, t1 * w1, 0.0))) / na1
        lo_band = 1e-5
        z1 = torch.where(hl1 & (g1 * z1 < lo_band * mu1), lo_band * mu1 / g1, z1)
        w1 = torch.where(hu1 & (t1 * w1 < lo_band * mu1), lo_band * mu1 / t1, w1)
        finite = (torch.isfinite(x1).all() & torch.isfinite(y1).all()
                  & torch.isfinite(z1).all() & torch.isfinite(w1).all())
        new = [torch.where(finite, a1, a0)
               for a1, a0 in ((x1, x), (y1, y), (z1, z), (w1, w), (g1, g), (t1, t))]
        _, _, pinf, dinf, relgap, _, _ = _lane_metrics(
            G1, b1, c1, l1, u1, Q1, hl1, hu1, bn1, cn1, *new[:4])
        return (*new, conv_of(pinf, dinf, relgap) | ~finite)

    full = data + (n_active,)
    while True:
        run = torch.as_tensor(np.flatnonzero((yield ~done & (it < opts.max_iter))),
                              device=device)  # one host read
        if run.numel() == 0:
            break
        d_run = lane(run, full)
        s_run = lane(run, st)
        rb, rc, mu, dinv = vmap(pre)(*packed(d_run), *s_run)
        d = torch.clamp(1.0 / dinv, max=opts.free_var_cap)
        G_run = d_run[0]
        if qd:
            H = d_run[5] + torch.diag_embed(torch.clamp(dinv, min=1.0 / opts.free_var_cap))
            Lh, _ = yield from chol_factor_reg_lanes_prog(H, base_reg=opts.reg_dual)
            M = G_run @ vmap(chol_solve)(Lh, G_run.mT)
            L, _ = yield from chol_factor_reg_lanes_prog(M, base_reg=opts.reg_dual)
            fac = (Lh, M, L)
        elif banded:
            fac = yield from band_factor(run, d, reg, 0.0)
        else:
            M = (G_run * d[:, None, :]) @ G_run.mT
            L, _ = yield from chol_factor_reg_lanes_prog(M, base_reg=opts.reg_dual)
            fac = (M, L)
        out = vmap(post)(*packed(d_run), *s_run, rb, rc, mu, dinv, *fac)
        for a, v in zip(st, out[:6]):
            a[run] = v
        done[run] = out[6]
        it[run] += 1

    x, y, z, w = st[:4]
    _, _, pinf, dinf, relgap, pobj, dobj = vmap(metrics)(*packed(data), x, y, z, w)
    blowup = torch.maximum(z.abs().amax(dim=1), w.abs().amax(dim=1))
    return IPMResult(
        x=x, y=y, z=z, w=w, iterations=it,
        converged=conv_of(pinf, dinf, relgap),
        primal_infeas=pinf, dual_infeas=dinf, rel_gap=relgap,
        pobj=pobj, dobj=dobj, blowup=blowup,
    )


def ipm_solve_jit(lp: StandardLP, opts: IPMOptions = IPMOptions()) -> IPMResult:
    """The JAX package's jitted entry point; here the same as ipm_solve."""
    return ipm_solve(lp, opts)
