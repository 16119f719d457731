"""Solve orchestration — the ClpSimplex::initialSolve equivalent.

Mirrors the reference's dispatcher flow (ClpSolve.cpp:845-4070):
  1. empty-problem short-circuit (:877-906)
  2. presolve (:955-1076)
  3. problem analysis & automatic method choice (:1276-1760)
  4. run the chosen method (dual / primal simplex, barrier + crossover)
  5. postsolve + cleanup solve if residual infeasibilities remain
  6. final status, timing

The port runs DUAL_SIMPLEX, PRIMAL_SIMPLEX (with the idiot or triangular
crash start), PRIMAL_IDIOT, BARRIER, BARRIER_NO_CROSS, SPRINT, PDLP (with
its simplex polish), NETWORK, GUB, DECOMPOSE (Benders over the batched
IPM) and the dualize of tall LPs, and AUTOMATIC wherever it lands; a
quadratic objective on the barrier or on the reduced-gradient QP simplex
(simplex/qp.py), and piecewise-linear costs on the in-engine primal
(piecewise.py). `solve_batch` solves many same-shape models as one batch,
over a device mesh when given one. `shape_bucket` pads the simplex's and
the barrier's forms to bucket multiples and strips the answer back.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .constants import INF, ProblemStatus, ScalingMode, SecondaryStatus, SolveMethod
from .device import on_accelerator, resolve_device
from .forms import expand_ipm_solution, to_ipm_form
from .model import Model, Solution
from .options import SolveOptions


def _empty_solution(model: Model) -> Solution:
    """Reference: empty-problem short-circuit (ClpSolve.cpp:877-906).

    With no rows the problem separates per column: minimize each c_j x_j
    over [l_j, u_j]. A pure clip-to-bounds of x = 0 would be feasible but
    NOT optimal.
    """
    n, m = model.num_cols, model.num_rows
    c = model.objective
    l, u = model.col_lower, model.col_upper
    Q = model.quadratic_objective
    unbounded = False
    if n == 0:
        x = np.zeros(0)
    elif Q is None:
        x = np.where(c > 0, l, np.where(c < 0, u, np.clip(0.0, l, u)))
        unbounded = bool(np.any((c > 0) & (l <= -INF)) or np.any((c < 0) & (u >= INF)))
        x = np.clip(x, np.maximum(l, -INF), np.minimum(u, INF))
    else:
        # box QP: projected gradient (convex; small after presolve)
        Qd = np.asarray(Q.todense()) if hasattr(Q, "todense") else np.asarray(Q)
        lam = float(np.linalg.norm(Qd, 2)) if n else 1.0
        step = 1.0 / max(lam, 1e-12)
        lo = np.maximum(l, -1e18)
        hi = np.minimum(u, 1e18)
        x = np.clip(np.zeros(n), lo, hi)
        for _ in range(2000):
            g = c + Qd @ x
            x_new = np.clip(x - step * g, lo, hi)
            if np.max(np.abs(x_new - x)) < 1e-12 * (1 + np.max(np.abs(x))):
                x = x_new
                break
            x = x_new
    obj = float(c @ x) + model.objective_offset
    if Q is not None:
        obj += 0.5 * float(x @ (Q @ x))
    dj = c.copy() if Q is None else c + np.asarray(Q @ x).ravel()
    sol = Solution(
        status=ProblemStatus.DUAL_INFEASIBLE if unbounded else ProblemStatus.OPTIMAL,
        objective_value=obj,
        primal=x,
        duals=np.zeros(m),
        reduced_costs=dj,
        row_activity=np.zeros(m) if n == 0 else model.matrix @ x,
    )
    infeas_col = np.any(model.col_lower > model.col_upper + 1e-12)
    infeas_row = np.any(
        (model.row_lower > model.row_upper + 1e-12)
        | ((model.row_lower > 1e-12) & (model.num_cols == 0))
        | ((model.row_upper < -1e-12) & (model.num_cols == 0))
    ) if m else False
    if infeas_col or infeas_row:
        sol.status = ProblemStatus.PRIMAL_INFEASIBLE
    return sol


def _auto_idiot(model: Model) -> bool:
    """doIdiot analogue, built from the reference's decision surface
    (ClpSolve.cpp:1276-1726):

      * tryIt gate (:1663): rows > 200, cols > 2000-ish, cols > 2*rows
        — wide enough that the descent point pays for itself;
      * free columns kill it (:1622-1623 ``if (nFree) doIdiot = 0``);
      * rhs statistics (:1628-1670): every finite nonzero rhs entry must
        be (near-)integral, and the magnitude range must be tame
        (ratio <= 10, and <= 2 when values exceed 50);
      * element structure (:1530-1568, :1684 ``numberElements <= 3 *
        numberColumns``): mostly-unit entries OR very sparse columns.

    As in the JAX package, the idiot point feeds the DUAL's values pass.
    """
    m, n = model.num_rows, model.num_cols
    # tryIt gate, with the JAX package's measured upper width cap (beyond
    # ~8*m the sprint working-set route wins)
    if m <= 200 or n <= 1500 or n <= 2 * m or n > 8 * m:
        return False
    A = model.matrix
    if A.nnz == 0:
        return False
    # free columns switch idiot off (:1622-1623)
    cl, cu = model.col_lower, model.col_upper
    if bool(np.any((cl < -1e10) & (cu > 1e10))):
        return False
    # rhs statistics: integrality + magnitude range (:1628-1670)
    vals = []
    for a in (model.row_lower, model.row_upper):
        a = np.asarray(a, dtype=np.float64)
        vals.append(a[(a != 0.0) & (np.abs(a) < 1e30)])
    rhs = np.abs(np.concatenate(vals)) if vals else np.zeros(0)
    if rhs.size:
        if bool(np.any(np.abs(rhs - np.round(rhs)) > 1e-8)):
            return False
        largest = float(rhs.max())
        smallest = float(rhs.min())
        if largest / smallest > 10.0 or (largest / smallest > 2.0 and largest > 50.0):
            return False
    # element structure: unit-heavy or very sparse columns
    unit_frac = float(np.mean(np.abs(A.data) == 1.0))
    return unit_frac >= 0.8 or A.nnz <= 3 * n


def _matrix_fingerprint(model: Model) -> tuple:
    """Content key for per-matrix probe caches (id() can be reused after
    free AND survives in-place edits — a stale hit would silently flip
    routing). crc32 over the pattern arrays + a data sample is O(nnz)."""
    import zlib

    A = model.matrix
    crc = zlib.crc32(np.ascontiguousarray(A.indptr).tobytes())
    crc = zlib.crc32(np.ascontiguousarray(A.indices).tobytes(), crc)
    d = np.ascontiguousarray(A.data)
    sample = d if d.size <= 65536 else np.concatenate([d[:32768], d[-32768:]])
    crc = zlib.crc32(sample.tobytes(), crc)
    return (A.shape, A.nnz, crc)


def _auto_method(model: Model, options: SolveOptions,
                 idiot_hint: Optional[bool] = None) -> SolveMethod:
    """Automatic method choice from shape statistics.

    The JAX package's policy, modeled on the reference's doIdiot/doSprint
    heuristics (ClpSolve.cpp:1276-1760). Its one backend test (the TPU
    takes the mixed-precision dual simplex from m >= 512) asks here
    whether the solve runs on the card.
    """
    m, n = model.num_rows, model.num_cols
    if model.quadratic_objective is not None:
        return SolveMethod.BARRIER_NO_CROSS
    if m == 0 or n == 0:
        return SolveMethod.DUAL_SIMPLEX
    # pure networks: spanning-tree basis, no factorization at all
    if model.detect_structure()["network"]:
        return SolveMethod.NETWORK
    # GUB-dominated LPs: the key-variable engine pivots on the small
    # general-row working basis (ClpGubMatrix role)
    if m <= 20000 and n <= 200000:
        from .gub import detect_gub

        sets = detect_gub(model)
        K = len(sets)
        m_g = m - K
        covered = sum(int(gs.cols.size) for gs in sets)
        if (K >= 8 and K >= m // 2 and covered >= n // 2
                and m_g * (n + K + m_g) * 8 <= 1 << 30):
            return SolveMethod.GUB
    # detected two-stage scenario structure routes to Benders (the
    # CoinStructuredModel decomposeType dispatch, ClpSolve.cpp:4910-4924);
    # probed only where the decomposition can win, cached per matrix
    if m >= 192 and n >= 192 and model.num_elements >= 512:
        from .structure import detect_two_stage

        key = _matrix_fingerprint(model)
        cached = getattr(model, "_two_stage_probe_cache", None)
        if cached is not None and cached[0] == key:
            det = cached[1]
        else:
            det = detect_two_stage(model)
            model._two_stage_probe_cache = (key, det)
        if det is not None:
            return SolveMethod.DECOMPOSE
    wants_idiot = _auto_idiot(model) if idiot_hint is None else idiot_hint
    if wants_idiot:
        # wide + unit-heavy: idiot-crash values-pass dual (doIdiot role)
        return SolveMethod.DUAL_SIMPLEX
    if n > 6 * m and n > 2000:
        return SolveMethod.SPRINT  # wide LPs: column-subset working sets
    # beyond-dense-scale sparse instances go to the first-order PDLP ...
    nnz = model.num_elements
    dense_bytes = m * (n + m) * 8
    if (dense_bytes > 4 << 30 and nnz < 0.02 * m * n) or (
        m >= 4096 and nnz < 0.01 * m * n
    ):
        # ... unless the sparse NORMAL EQUATIONS factor in O(fill): then
        # the multifrontal barrier reaches full accuracy directly, without
        # the crossover's dense dual at this scale
        if 4096 <= m <= 8192 and dense_bytes <= 4 << 30:
            import scipy.sparse as sp

            from .ops.sparse_chol import make_normal_solver

            key = _matrix_fingerprint(model)
            cached = getattr(model, "_normal_probe_cache", None)
            if cached is not None and cached[0] == key:
                probe = cached[1]
            else:
                # routing probe only: _solve_barrier rebuilds the solver
                # from the actual IPM form (fixed columns may be dropped)
                probe = make_normal_solver(
                    sp.hstack([model.matrix, sp.eye(m)]).tocsr(), reg=1e-10)
                model._normal_probe_cache = (key, probe)
            if probe is not None:
                return SolveMethod.BARRIER_NO_CROSS
        return SolveMethod.PDLP
    # the JAX package's TPU branch: the mixed-precision dual simplex from
    # m >= 512 on the accelerator, the barrier elsewhere. Whether the
    # card, with its native f64, wants the barrier instead is open
    # (ROADMAP.md queue 4).
    if m >= 512 and resolve_device(options.device).type == "cuda":
        return SolveMethod.DUAL_SIMPLEX
    return SolveMethod.BARRIER


def _ipm_to_solution(model: Model, res, info, options: SolveOptions) -> Solution:
    n, m = info.n, info.m
    sense = info.sense
    v = expand_ipm_solution(info, res.x.cpu().numpy())
    x = v[:n]
    # reduced costs in user sense: d_user = c_user - A'y_user
    y = res.y.cpu().numpy() * sense
    A = model.matrix
    d = model.objective - A.T @ y
    if model.quadratic_objective is not None:
        d = d + sense * (model.quadratic_objective @ x)
    row_act = A @ x
    obj = float(model.objective @ x) + model.objective_offset
    if model.quadratic_objective is not None:
        obj += 0.5 * float(x @ (model.quadratic_objective @ x))

    converged = bool(res.converged)
    status = ProblemStatus.OPTIMAL if converged else ProblemStatus.STOPPED
    secondary = SecondaryStatus.NONE
    if not converged:
        # crude divergence-based certificates; the simplex cleanup refines
        if float(res.blowup) > 1e11 and float(res.primal_infeas) > options.barrier_tolerance:
            status = ProblemStatus.PRIMAL_INFEASIBLE
        elif float(np.max(np.abs(x), initial=0.0)) > 1e12:
            status = ProblemStatus.DUAL_INFEASIBLE
        else:
            secondary = SecondaryStatus.FAILED_TO_CONVERGE
    return Solution(
        status=status,
        secondary_status=secondary,
        objective_value=obj,
        primal=x,
        duals=y,
        reduced_costs=np.asarray(d),
        row_activity=np.asarray(row_act),
        iterations=int(res.iterations),
    )


def _rcm_band_plan(G: np.ndarray):
    """RCM row ordering + bandwidth of pattern(G G') — the symbolic phase
    of the sparse-Cholesky capability (ClpCholeskyBase.cpp:638 ordering).

    Returns (perm, nb) with nb > 0 only when the banded block-tridiagonal
    path is worthwhile (band narrow relative to m).
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m = G.shape[0]
    if m < 192:
        return None, 0
    Gs = sp.csr_matrix((np.abs(G) > 0).astype(np.int8))
    S = (Gs @ Gs.T).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(S, symmetric_mode=True))
    inv = np.empty(m, dtype=np.int64)
    inv[perm] = np.arange(m)
    Sp = S.tocoo()
    band = int(np.max(np.abs(inv[Sp.row] - inv[Sp.col]), initial=0))
    nb = max(64, band + 1)
    nb = ((nb + 63) // 64) * 64  # blocks in multiples of 64
    if nb * 3 > m:
        return None, 0  # too wide: dense is better
    return perm, nb


def _pad_ipm_lp(lp, bucket: int):
    """Pad the IPM standard form (m, nt) up to shape-bucket multiples, the
    barrier's counterpart of the simplex driver's _bucketed_solve (in the
    JAX package: one compiled barrier program for nearby shapes; here: the
    same answer from the padded form).

    to_ipm_form substitutes fixed variables out, so the padding must be
    strictly interior-feasible rather than fixed (a [0, 0] pad column
    would be stripped and a bare zero row would make the normal
    equations lean on regularization):
      - each pad ROW i carries a singleton +1 entry on its own pad
        column with [-1, 1] bounds: the row reads x_pad = 0 (strictly
        interior) and contributes a strictly positive diagonal to GDG';
      - remaining pad COLUMNS are all-zero with cost 0 and [-1, 1]
        bounds: reduced cost identically 0, no coupling to the LP.
    Returns (padded_lp, (m, nt)) or (lp, None) when already aligned. The
    form is on the host.
    """
    from .forms import StandardLP

    G = lp.G
    m, nt = G.shape
    m2 = -(-m // bucket) * bucket
    k = m2 - m
    nt2 = -(-(nt + k) // bucket) * bucket
    p = nt2 - nt
    if k == 0 and p == 0:
        return lp, None
    G2 = G.new_zeros((m2, nt2))
    G2[:m, :nt] = G
    if k:
        G2[m + torch.arange(k), nt + torch.arange(k)] = 1.0
    pad1 = G.new_ones(p)
    Q2 = None
    if lp.Q is not None:
        Q2 = G.new_zeros((nt2, nt2))
        Q2[:nt, :nt] = lp.Q
    lp2 = StandardLP(
        G=G2,
        b=torch.cat([lp.b, lp.b.new_zeros(k)]),
        c=torch.cat([lp.c, lp.c.new_zeros(p)]),
        l=torch.cat([lp.l, -pad1]),
        u=torch.cat([lp.u, pad1]),
        Q=Q2,
    )
    return lp2, (m, nt)


def _barrier_plan(G: np.ndarray, opts, device: torch.device, sparse: bool = True):
    """The Newton branch for this IPM form: RCM-banded when its band is
    narrow, else the sparse multifrontal normal equations when the
    minimum-degree fill beats the dense O(m^3) (on the card the device
    numeric in f32, on the CPU the host numeric), else dense. Returns
    (row permutation or None, opts). `sparse=False` (a bucketed form)
    keeps to the banded and dense branches, as the JAX package does: its
    bucket shares one compiled program, which a per-pattern multifrontal
    plan would defeat, and the port takes the same route."""
    import scipy.sparse as sp

    perm, nb = _rcm_band_plan(G)
    if perm is not None:
        return perm, dataclasses.replace(opts, band_nb=nb)
    m = G.shape[0]
    if sparse and m >= 512 and np.count_nonzero(G) < 0.02 * G.size:
        G_csr = sp.csr_matrix(G)
        reg = float(opts.reg_dual) + 1e-12
        if device.type == "cuda":
            from .ops.sparse_chol_device import make_device_normal_solver

            solver = make_device_normal_solver(G_csr, reg=reg, dtype=torch.float32,
                                               device=device)
            if solver is not None:
                return None, dataclasses.replace(opts, sparse_chol_device=solver)
        else:
            # the host numeric runs only off the card, as in the JAX
            # package: a card model the device plan declines (dense
            # columns) takes the dense mixed32 normal equations
            from .ops.sparse_chol import make_normal_solver

            solver = make_normal_solver(G_csr, reg=reg)
            if solver is not None:
                return None, dataclasses.replace(opts, sparse_chol=solver)
    return None, opts


def _mixed32_auto(device: torch.device) -> bool:
    """barrier_mixed32="auto": on the card f32 assembly and factor + f64
    refinement, the JAX package's TPU setting (ROADMAP.md queue 4 asks
    whether Hopper's native f64 wants otherwise); f64 elsewhere."""
    return device.type == "cuda"


def _solve_barrier(model: Model, options: SolveOptions) -> Solution:
    """The barrier on the model's IPM form, on options.device: plan the
    Newton branch on the host, run the IPM, map its point back."""
    from .interior.mehrotra import IPMOptions, ipm_solve

    device = resolve_device(options.device)
    # the form is built, padded and planned on the host, then moved once
    lp, info = to_ipm_form(model, device="cpu")
    pad_dims = None
    bucket = int(getattr(options, "shape_bucket", 0) or 0)
    if bucket > 0:
        lp, pad_dims = _pad_ipm_lp(lp, bucket)
    boost = 100.0 if options.barrier_regularize else 1.0
    mixed32 = getattr(options, "barrier_mixed32", "auto")
    if mixed32 == "auto":
        mixed32 = _mixed32_auto(device)
    opts = IPMOptions(
        tol=options.barrier_tolerance,
        max_iter=options.barrier_max_iterations,
        reg_primal=1e-9 * boost,
        reg_dual=1e-10 * boost,
        mixed32=bool(mixed32),
    )
    perm = None
    if lp.Q is not None:
        # separable QP: a diagonal Q keeps H = Q + D^-1 diagonal, so the
        # barrier takes the LP Newton branches (incl. banded) with
        # dinv += diag(Q) instead of the (nt, nt) Cholesky. The form is on
        # the host: one view of Q, no per-entry read.
        Qh = lp.Q.numpy()
        if np.count_nonzero(Qh - np.diag(np.diagonal(Qh))) == 0:
            opts = dataclasses.replace(opts, q_diag=True)
    if lp.Q is None or opts.q_diag:
        perm, opts = _barrier_plan(lp.G.numpy(), opts, device, sparse=bucket == 0)
    if perm is not None:
        # permute ROWS so the normal matrix is banded; x and columns are
        # untouched, so only y needs unpermuting afterwards
        perm = torch.as_tensor(np.ascontiguousarray(perm, dtype=np.int64))
        lp = dataclasses.replace(lp, G=lp.G[perm], b=lp.b[perm])
    lp = dataclasses.replace(lp, **{k: getattr(lp, k).to(device)
                                    for k in ("G", "b", "c", "l", "u", "Q")
                                    if getattr(lp, k) is not None})
    t0 = time.perf_counter()
    res = ipm_solve(lp, opts)
    retry = None
    if (
        not bool(res.converged)
        and opts.mixed32
        and getattr(options, "barrier_mixed32", "auto") == "auto"
        and (not on_accelerator(lp.G) or lp.Q is not None)
    ):
        # f64 escalation: when Jacobi scaling + refinement cannot recover
        # the Newton direction, one full-f64 retry. On the card, as on the
        # JAX package's TPU branch, only a QP retries: an LP goes to the
        # simplex adjudication in initial_solve instead.
        res64 = ipm_solve(lp, dataclasses.replace(opts, mixed32=False,
                                                  sparse_chol_device=None))
        retry = "converged" if bool(res64.converged) else "not converged"
        if bool(res64.converged):
            res = res64
    from .events import get_handler

    mh = get_handler(model, options)
    if mh is not None:
        if bool(res.converged):
            mh.message("CLP_BARRIER_END", obj=float(res.pobj), it=int(res.iterations))
        else:
            mh.message(
                "CLP_BARRIER_EXIT2",
                why=f"not converged: gap {float(res.rel_gap):.3e} "
                    f"pinf {float(res.primal_infeas):.3e}",
            )
    if perm is not None:
        y_full = torch.empty_like(res.y)
        y_full[perm.to(res.y.device)] = res.y
        res = dataclasses.replace(res, y=y_full)
    if pad_dims is not None:
        m0, nt0 = pad_dims
        res = dataclasses.replace(res, x=res.x[:nt0], y=res.y[:m0], z=res.z[:nt0],
                                  w=res.w[:nt0])
    seconds = time.perf_counter() - t0
    sol = _ipm_to_solution(model, res, info, options)
    # the Newton branch taken and the IPM's own count and wall (the
    # crossover's simplex keeps these beside its own statistics)
    sol.timings = {"barrier_stats": {
        "branch": _branch_name(opts, lp.Q is not None), "iterations": int(res.iterations),
        "converged": bool(res.converged), "seconds": seconds, "f64_retry": retry}}
    return sol


def _branch_name(opts, quadratic: bool = False) -> str:
    """The Newton branch the IPM ran; a separable QP's name ends in q_diag."""
    if quadratic and not opts.q_diag:
        return "dense QP (nt, nt)"
    if opts.band_nb > 0:
        name = f"banded nb={opts.band_nb}"
    elif opts.sparse_chol_device is not None:
        name = "device multifrontal"
    elif opts.sparse_chol is not None:
        name = "host multifrontal"
    else:
        name = "dense mixed32" if opts.mixed32 else "dense f64"
    return f"{name} q_diag" if opts.q_diag else name


def _solve_simplex(model: Model, options: SolveOptions, dual: bool,
                   warm: Optional[Solution] = None) -> Solution:
    from .simplex.driver import simplex_solve

    return simplex_solve(model, options, dual=dual, warm=warm)


def _solve_pdlp(work: Model, options: SolveOptions) -> Solution:
    """PDHG, then its polish to simplex accuracy, or the simplex's verdict
    where PDHG stops short."""
    from .pdlp import pdlp_solve

    sol = pdlp_solve(work, options)
    m, n = work.num_rows, work.num_cols
    dense_fits = 4 * m * (m + n) <= 4 << 30
    # first-order solutions are moderate-accuracy by design (they carry
    # SecondaryStatus.REDUCED_ACCURACY); polish to simplex accuracy:
    #   * dense-engine scale: values-pass dual solve on the whole LP
    #   * beyond that: crunch_polish — row+column working-set finish
    #     against the full sparse data (bigsolve.py)
    if options.crossover and sol.status == ProblemStatus.OPTIMAL:
        polished = None
        if m >= 2048 or not dense_fits:
            # the working-set finish is strictly cheaper than a full
            # dense values pass at scale; try it first
            from .bigsolve import crunch_polish

            polished = crunch_polish(work, options, sol)
            if polished is not None:
                sol = polished
        if polished is None and dense_fits:
            polish = _solve_simplex(
                work, options, dual=True,
                warm=Solution(primal=sol.primal.copy(),
                              row_activity=None if sol.row_activity is None
                              else np.asarray(sol.row_activity).copy()),
            )
            if polish.status == ProblemStatus.OPTIMAL:
                sol = polish
    if (sol.status == ProblemStatus.STOPPED
            and sol.secondary_status == SecondaryStatus.FAILED_TO_CONVERGE
            and dense_fits):
        # PDHG cannot certify infeasible/unbounded: adjudicate the
        # status with the simplex when the dense engine fits
        adj = _solve_simplex(work, options, dual=True)
        if adj.status in (ProblemStatus.OPTIMAL, ProblemStatus.PRIMAL_INFEASIBLE,
                          ProblemStatus.DUAL_INFEASIBLE):
            sol = adj
    return sol


def _fire(model: Model, which, **info) -> bool:
    """Fire an event hook; True means the handler requested an abort
    (reference: event handler return >= 0 -> status 5, ClpModel.hpp:435)."""
    from .events import fire_event

    return fire_event(model, which, **info)


def initial_solve(model: Model, options: Optional[SolveOptions] = None) -> Solution:
    """Presolve -> method -> solve -> postsolve -> cleanup; sets model.solution."""
    from .events import Event

    options = options or SolveOptions()
    # a CUDA device with no card raises here, before any work
    resolve_device(options.device)
    t0 = time.time()
    if _fire(model, Event.START_SOLVE):
        sol = Solution(status=ProblemStatus.USER_STOPPED)
        model.solution = sol
        return sol

    if model.num_cols == 0 or model.num_rows == 0:
        sol = _empty_solution(model)
        sol.solve_time = time.time() - t0
        model.solution = sol
        return sol

    # sanity check (reference: ClpModel data validation + ClpSimplex
    # sanityCheck — non-finite matrix entries or NaN rim data are
    # rejected with CLP_BAD_MATRIX/CLP_BAD_BOUNDS, status ERRORS)
    bad = None
    if not np.isfinite(model.matrix.data).all():
        bad = ("CLP_BAD_MATRIX",
               {"n": int((~np.isfinite(model.matrix.data)).sum())})
    else:
        for a in (model.objective, model.col_lower, model.col_upper,
                  model.row_lower, model.row_upper):
            if np.isnan(np.asarray(a, dtype=np.float64)).any():
                bad = ("CLP_BAD_BOUNDS",
                       {"n": int(np.isnan(np.asarray(a)).sum())})
                break
    if bad is not None:
        from .events import get_handler

        mh = get_handler(model, options)
        if mh is not None:
            mh.message(bad[0], **bad[1])
        sol = Solution(status=ProblemStatus.ERRORS)
        sol.solve_time = time.time() - t0
        model.solution = sol
        return sol

    # A pending warm basis is consumed by THIS solve, whatever route it
    # takes: capture the flag and clear it now, so an early-return route
    # that cannot use the basis drops it explicitly instead of leaving it
    # set for a LATER solve to misinterpret.
    warm_basis_pending = bool(getattr(model, "warm_start_pending", False))
    model.warm_start_pending = False

    # --- piecewise-linear costs (ClpNonLinearCost attachment): route to
    # the in-engine kink-aware primal simplex; presolve/scaling would
    # invalidate the per-column breakpoint specs, so this path owns the
    # whole solve (the reference's nonlinear-cost solves skip presolve
    # the same way)
    if getattr(model, "piecewise_costs", None):
        from .piecewise import solve_piecewise

        sol = solve_piecewise(model, model.piecewise_costs, options)
        sol.timings = {"solve": sol.solve_time}
        _fire(model, Event.END_SOLVE, status=sol.status, time=sol.solve_time)
        return sol
    # --- dualize: solve the transposed model and map back (reference:
    # ClpSimplexOther::dualOfModel/restoreFromDual, ClpSimplexOther.cpp:1681).
    # Auto: very tall LPs transpose to wide ones the engines handle better
    # (per-pivot work scales with the row count; reference tryDualize hint)
    if options.dualize or (
        options.method == SolveMethod.AUTOMATIC
        and model.num_rows > 6 * model.num_cols
        and model.num_rows > 2000
    ):
        from .analysis import dualize, restore_from_dual

        dm, mapping = dualize(model)
        initial_solve(dm, dataclasses.replace(options, dualize=0))
        restore_from_dual(model, dm, mapping)
        return model.solution

    # --- rim scale factors (objScale / rhsScale dblParams,
    # ClpModel.hpp:1124-1161): scale in, unscale out ---
    if options.objective_scale != 1.0 or options.rhs_scale != 1.0:
        os_, rs_ = float(options.objective_scale), float(options.rhs_scale)
        work0 = model.copy()
        work0.objective = work0.objective * os_
        if rs_ != 1.0:
            for attr in ("row_lower", "row_upper", "col_lower", "col_upper"):
                a = getattr(work0, attr)
                setattr(work0, attr, np.where(np.abs(a) < 1e29, a * rs_, a))
        inner = dataclasses.replace(options, objective_scale=1.0, rhs_scale=1.0)
        sol = initial_solve(work0, inner)
        if sol.primal is not None:
            sol.primal = sol.primal / rs_
            sol.row_activity = None if sol.row_activity is None else sol.row_activity / rs_
            sol.objective_value = float(model.objective @ sol.primal) + model.objective_offset
        if sol.duals is not None:
            sol.duals = sol.duals / os_
        if sol.reduced_costs is not None:
            sol.reduced_costs = sol.reduced_costs / os_
        model.solution = sol
        return sol

    # --- values pass (reference: ClpSimplex::dual(1)/primal(1),
    # ClpSimplexDual.cpp:637 ifValuesPass — start the simplex from the
    # CURRENT solution values; the crossover machinery builds the starting
    # basis from the point). Like the reference's direct method call this
    # bypasses presolve; the point is taken as-is.
    if (
        getattr(options, "values_pass", 0)
        and options.method in (SolveMethod.DUAL_SIMPLEX, SolveMethod.PRIMAL_SIMPLEX)
        and model.solution.primal is not None
        and model.solution.primal.size == model.num_cols
    ):
        warm = Solution(
            primal=np.asarray(model.solution.primal, dtype=np.float64).copy(),
            row_activity=(
                None
                if model.solution.row_activity is None
                else np.asarray(model.solution.row_activity, dtype=np.float64).copy()
            ),
        )
        sol = _solve_simplex(
            model, options, dual=options.method == SolveMethod.DUAL_SIMPLEX,
            warm=warm,
        )
        from .events import get_handler

        mh = get_handler(model, options)
        if mh is not None:
            mh.message("CLP_END_VALUES_PASS", it=sol.iterations)
        sol.solve_time = time.time() - t0
        model.solution = sol
        _fire(model, Event.END_SOLVE, status=sol.status, time=sol.solve_time)
        return sol

    # --- pending warm basis (reference: a basis loaded via readBasis /
    # setBasisStatus is the simplex starting basis, ClpModel statusCopy).
    # Presolve would invalidate the status arrays (sizes change) and is
    # worth far less than the basis on a re-solve, so it is skipped;
    # scaling still applies (basis STATUSES are scale-invariant).
    pending_warm = None
    if (
        warm_basis_pending
        and options.method in (SolveMethod.DUAL_SIMPLEX,
                               SolveMethod.PRIMAL_SIMPLEX,
                               SolveMethod.PRIMAL_IDIOT,
                               SolveMethod.AUTOMATIC)
        and model.quadratic_objective is None
        and model.solution.column_status is not None
        and model.solution.row_status is not None
        and np.asarray(model.solution.column_status).size == model.num_cols
        and np.asarray(model.solution.row_status).size == model.num_rows
    ):
        pending_warm = Solution(
            column_status=np.asarray(model.solution.column_status).copy(),
            row_status=np.asarray(model.solution.row_status).copy(),
        )

    method = options.method
    if pending_warm is not None:
        # a loaded basis pins the engine; a PRIMAL_IDIOT request keeps the
        # primal engine (the basis replaces the idiot point)
        method = (SolveMethod.PRIMAL_SIMPLEX
                  if method in (SolveMethod.PRIMAL_SIMPLEX,
                                SolveMethod.PRIMAL_IDIOT)
                  else SolveMethod.DUAL_SIMPLEX)

    # --- presolve ---
    # QP: Q-aware transforms only (fixed columns fold Q terms into the rim;
    # variable-eliminating transforms are gated off inside presolve() —
    # reference analogy: ClpPresolve handles QP via the same action list
    # with substitutions disabled)
    is_qp = model.quadratic_objective is not None
    presolved = None
    pinfo = None
    work = model

    def _stop_now():
        sol = Solution(status=ProblemStatus.USER_STOPPED)
        sol.solve_time = time.time() - t0
        model.solution = sol
        return sol

    if options.presolve.enabled and pending_warm is None:
        from .presolve import presolve as run_presolve

        if _fire(model, Event.PRESOLVE_START):
            return _stop_now()
        t_phase = time.time()
        presolved, pinfo = run_presolve(model, options.presolve)
        # the inner solve runs on the presolved model: carry the handler so
        # phase messages still reach the user's interceptor
        presolved.message_handler = model.message_handler
        presolved.log_level = model.log_level
        timings = {"presolve": time.time() - t_phase}
        if _fire(
            model,
            Event.PRESOLVE_SIZE,
            rows=presolved.num_rows,
            cols=presolved.num_cols,
        ) | _fire(
            model,
            Event.PRESOLVE_END,
            rows_dropped=model.num_rows - presolved.num_rows,
            cols_dropped=model.num_cols - presolved.num_cols,
        ):
            return _stop_now()
        if pinfo.status in (ProblemStatus.PRIMAL_INFEASIBLE, ProblemStatus.DUAL_INFEASIBLE):
            _fire(model, Event.PRESOLVE_INFEASIBLE, status=pinfo.status)
            sol = Solution(
                status=pinfo.status,
                secondary_status=SecondaryStatus.INFEAS_OR_UNBOUNDED_IN_PRESOLVE,
            )
            sol.solve_time = time.time() - t0
            model.solution = sol
            return sol
        work = presolved
        if _fire(model, Event.PRESOLVE_BEFORE_SOLVE):
            return _stop_now()

    if presolved is None:
        timings = {}
    auto_idiot_dual = False
    if method == SolveMethod.AUTOMATIC:
        ai = _auto_idiot(work)
        method = _auto_method(work, options, idiot_hint=ai)
        auto_idiot_dual = method == SolveMethod.DUAL_SIMPLEX and ai

    t_phase = time.time()
    # --- scaling (reference: ClpModel::scaling modes, applied pre-solve) ---
    factors = None
    if (options.scaling != ScalingMode.OFF and work.num_cols and work.num_rows
            # scaling destroys +-1 / unit-coefficient structure
            and method not in (SolveMethod.NETWORK, SolveMethod.GUB)):
        from .scaling import compute_scaling, scale_model_arrays

        factors = compute_scaling(work.matrix, options.scaling)
        if np.allclose(factors.row, 1.0) and np.allclose(factors.col, 1.0):
            factors = None
        else:
            A, cl, cu, obj, rl, ru = scale_model_arrays(work, factors)
            scaled = work.copy()
            scaled.load_problem(A, cl, cu, obj, rl, ru)
            scaled.objective_offset = work.objective_offset
            scaled.optimization_direction = work.optimization_direction
            if work.quadratic_objective is not None:
                import scipy.sparse as sp

                C = sp.diags(factors.col)
                scaled.quadratic_objective = (C @ work.quadratic_objective @ C).tocsc()
            unscaled_work = work
            work = scaled

    timings["scaling"] = time.time() - t_phase
    t_phase = time.time()
    if work.num_cols == 0 or work.num_rows == 0:
        sol = _empty_solution(work)
    elif method in (SolveMethod.BARRIER, SolveMethod.BARRIER_NO_CROSS):
        sol = _solve_barrier(work, options)
        ipm_stats = sol.timings
        if (
            method == SolveMethod.BARRIER
            and options.crossover
            and sol.status in (ProblemStatus.OPTIMAL, ProblemStatus.STOPPED)
        ):
            # crossover: finish with a simplex from the interior solution
            # (reference: ClpSolve.cpp:3585-3786 values-pass cleanup);
            # dual finish — the IPM's duals are near-feasible
            # (on a QP this LP simplex ignores Q and lands on a vertex, as
            # the JAX package's crossover does: ROADMAP.md queue 3)
            sol = _solve_simplex(work, options, dual=True, warm=sol)
        elif (
            sol.status == ProblemStatus.STOPPED
            and sol.secondary_status == SecondaryStatus.FAILED_TO_CONVERGE
            and work.quadratic_objective is None
        ):
            # the raw IPM cannot certify infeasible/unbounded; when it
            # fails to converge, adjudicate the STATUS with the simplex
            # (reference: initialSolve falls back to a cleanup solve on
            # barrier failure regardless of crossover settings)
            adj = _solve_simplex(work, options, dual=True)
            if adj.status in (
                ProblemStatus.OPTIMAL,
                ProblemStatus.PRIMAL_INFEASIBLE,
                ProblemStatus.DUAL_INFEASIBLE,
            ):
                sol = adj
        sol.timings = {**ipm_stats, **(sol.timings or {})}
    elif (
        work.quadratic_objective is not None
        and method in (SolveMethod.DUAL_SIMPLEX, SolveMethod.PRIMAL_SIMPLEX,
                       SolveMethod.PRIMAL_IDIOT)
    ):
        # QP by simplex: reduced-gradient active-set primal
        # (ClpSimplexNonlinear::primal analogue)
        from .simplex.qp import qp_simplex_solve

        sol = qp_simplex_solve(work, options)
    elif method in (SolveMethod.DUAL_SIMPLEX, SolveMethod.PRIMAL_SIMPLEX,
                    SolveMethod.PRIMAL_IDIOT):
        dual = method == SolveMethod.DUAL_SIMPLEX
        warm = pending_warm
        # the idiot point feeds the values pass (the auto idiot dual,
        # PRIMAL_IDIOT, or crash="idiot"); the triangular crash a basis
        if warm is None and (auto_idiot_dual or method == SolveMethod.PRIMAL_IDIOT
                             or options.crash == "idiot"):
            from .crash import idiot_crash

            warm = idiot_crash(work, options)
        elif warm is None and options.crash == "triangular":
            from .crash import triangular_crash

            warm = triangular_crash(work, options)
        sol = _solve_simplex(work, options, dual=dual, warm=warm)
    elif method == SolveMethod.SPRINT:
        from .sprint import sprint_solve

        sol = sprint_solve(work, options, max_passes=options.sprint_passes)
    elif method == SolveMethod.PDLP:
        sol = _solve_pdlp(work, options)
    elif method == SolveMethod.NETWORK:
        from .network import network_form, solve_network

        if network_form(work) is not None:
            sol = solve_network(work, options)
        else:
            # presolve/user edits broke the +-1 structure: general dual path
            sol = _solve_simplex(work, options, dual=True)
    elif method == SolveMethod.DECOMPOSE:
        from .structure import auto_decompose_solve

        sol = auto_decompose_solve(work, options)
        if sol is None:
            # detection mis-fire / decomposition failure: standard route
            # (decomposeType == 0 -> dual(), ClpSolve.cpp:4914-4916)
            sol = _solve_simplex(work, options, dual=True)
    elif method == SolveMethod.GUB:
        from .gub import solve_gub

        try:
            sol = solve_gub(work, options)
        except ValueError:
            sol = None  # no GUB rows / unverifiable claim: dense path
        # ERRORS falls back to the dense engine; STOPPED does NOT — it
        # means a user limit was hit, and a from-scratch dense re-solve
        # would double the spent budget
        if sol is None or sol.status == ProblemStatus.ERRORS:
            sol = _solve_simplex(work, options, dual=True)
    else:
        raise NotImplementedError(f"method {method}")

    timings["solve"] = time.time() - t_phase
    t_phase = time.time()
    # --- unscale ---
    if factors is not None:
        from .scaling import unscale_solution

        x, y, dj = unscale_solution(
            factors, sol.primal, sol.duals, sol.reduced_costs
        )
        sol.primal, sol.duals, sol.reduced_costs = x, y, dj
        work = unscaled_work
        if x is not None:
            sol.row_activity = work.matrix @ x
            sol.objective_value = (
                float(work.objective @ x) + work.objective_offset
            )
            if work.quadratic_objective is not None:
                sol.objective_value += 0.5 * float(x @ (work.quadratic_objective @ x))

    work.solution = sol

    # --- postsolve ---
    if presolved is not None:
        from .presolve import postsolve as run_postsolve

        _fire(model, Event.PRESOLVE_AFTER_FIRST_SOLVE, status=sol.status)
        sol = run_postsolve(model, pinfo, sol)
        # cleanup solve on the original model if needed (reference:
        # ClpSolve.cpp cleanup semantics, secondaryStatus 2/3/4)
        if options.cleanup and sol.status == ProblemStatus.OPTIMAL and not is_qp:
            from .validate import check_kkt

            rep = check_kkt(model, x=sol.primal, y=sol.duals, tol=1e-6)
            if not rep.ok:
                _fire(model, Event.SLIGHTLY_INFEASIBLE,
                      pinf=rep.primal_infeasibility,
                      dinf=rep.dual_infeasibility)
                sol2 = _solve_simplex(model, options, dual=True, warm=sol)
                if sol2.status == ProblemStatus.OPTIMAL:
                    sol = sol2
        _fire(model, Event.PRESOLVE_AFTER_SOLVE, status=sol.status)

    timings["postsolve"] = time.time() - t_phase
    sol.solve_time = time.time() - t0
    # keep engine-attached statistics (factorization counts) alongside the
    # per-phase wall timings
    timings.update(sol.timings or {})
    sol.timings = timings
    from .events import get_handler

    mh = get_handler(model, options)
    if mh is not None:
        mh.message(6, rows=model.num_rows, cols=model.num_cols, elems=model.num_elements)
        if "presolve" in timings and presolved is not None:
            mh.message(14, drows=model.num_rows - presolved.num_rows,
                       dcols=model.num_cols - presolved.num_cols)
        for phase, secs in timings.items():
            mh.message("CLP_INTERVAL_TIMING", phase=phase, time=secs,
                       total=sol.solve_time)
        mh.message("CLP_TIMING", phase=method.name, obj=sol.objective_value,
                   it=sol.iterations, time=sol.solve_time)
        mh.message(29, status=sol.status.name, time=sol.solve_time)
    model.solution = sol
    if sol.status == ProblemStatus.OPTIMAL:
        _fire(model, Event.SOLUTION, objective=sol.objective_value)
    _fire(model, Event.END_SOLVE, status=sol.status, time=sol.solve_time)
    return sol


def solve_batch(
    models: Sequence[Model],
    options: Optional[SolveOptions] = None,
    mesh=None,
) -> list[Solution]:
    """Solve many same-shape LPs (or QPs) as one batch.

    All models must share (m, n); they are stacked on a leading scenario
    axis and run through the lane-wise batched IPM (parallel/batch.py),
    with that axis split over `mesh` (axis options.mesh_axis) when given.
    """
    from .parallel.batch import solve_batch_ipm

    options = options or SolveOptions()
    return solve_batch_ipm(models, options, mesh)
