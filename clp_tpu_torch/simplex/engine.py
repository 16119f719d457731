"""Dense revised-simplex engines (dual + primal) in PyTorch.

The iteration protocol mirrors the reference's status codes
(ClpSimplexDual.cpp:462-470):

    CONTINUE(-1) -> keep iterating;  OPTIMAL(0);  PRIMAL_INFEASIBLE(1);
    DUAL_INFEASIBLE(2) (= unbounded);  ITER_LIMIT(3);  NUMERICAL(4)

Structure per solve (gutsOfDual / gutsOfPrimal equivalent):

    outer loop:                           # statusOfProblemInDual :4996
        refactorize basis (dense LU -> explicit inverse)
        recompute x_B, duals y, reduced costs dj   # gutsOfSolution
        inner loop (<= chunk pivots):              # whileIterating :973
            price -> BTRAN row -> ratio test -> FTRAN -> rank-1 updates

The loops are eager Python. A pivot body issues no host sync: every scalar
it needs (the leaving row r, the entering column q, sigma, the pivot
element, the gate) stays a 0-dim device tensor, gathered with
`index_select` rather than `x[r]`, and branches on device values are
computed unconditionally and selected with `torch.where`. The inner loop
reads the status once per block of `inner_unroll` pivots; that is safe
because the pivot body freezes itself (the do_pivot gate) once any stop
condition holds.

Variable status codes (cf. ClpSimplex::Status, ClpSimplex.hpp:119-126):
    0 = nonbasic at lower, 1 = nonbasic at upper, 2 = basic,
    3 = nonbasic free (primal only; dual folds free vars into fake bounds).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from ..forms import StandardLP
from ..ops.linalg import lu_refactor, lu_refactor32
from ..ops.pivot import fused_pivot_update
from ..ops.price import price_and_ratios, price_and_ratios_block

# status codes (match ProblemStatus where >= 0)
CONTINUE = -1
OPTIMAL = 0
PRIMAL_INFEASIBLE = 1
DUAL_INFEASIBLE = 2
ITER_LIMIT = 3
NUMERICAL = 4

AT_LOWER = 0
AT_UPPER = 1
BASIC = 2
FREE = 3

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class SimplexOptions:
    primal_tolerance: float = 1e-7
    dual_tolerance: float = 1e-7
    pivot_tolerance: float = 1e-9
    harris_tolerance_frac: float = 0.5  # fraction of tolerance used in pass 1
    dual_bound: float = 1e10  # fake bound magnitude (ClpSimplexDual dualBound_)
    refactor_frequency: int = 100
    max_iterations: int = 200000
    # perturbation magnitude applied by the driver (0 = off)
    perturbation: float = 0.0
    # pivot rules (reference: pluggable strategy classes ClpDualRowSteepest /
    # ClpPrimalColumnSteepest — here a static branch in the body). Primal
    # modes mirror ClpPrimalColumnSteepest's mode family: devex, dantzig,
    # exact steepest edge (Forrest-Goldfarb update), partial (rotating-window
    # candidate selection with full-pricing fallback). "pe" (Positive Edge)
    # is not ported yet (ROADMAP.md queue 1: `ell` and `pe`).
    dual_pivot: str = "steepest"  # "steepest" | "dantzig"
    primal_pivot: str = "devex"  # "devex" | "dantzig" | "steepest" | "partial"
    partial_window: int = 0  # 0 = auto (max(64, nt // 8))
    # fused PRICE kernel K1 (f32 pricing + f64 pivot verification;
    # ops/price.py; reference hot path: ClpPackedMatrix::transposeTimesByRow,
    # ClpPackedMatrix.cpp:706-1307). Off by default: the driver turns it on
    # for CUDA solves at scale; the CPU path uses the plain f64 contraction.
    use_pallas_price: bool = False
    # fused FTRAN + rank-1 inverse update kernel K2 (mixed engine only):
    # one read + one write of binv per pivot instead of three passes
    # (ops/pivot.py). Off by default, and the driver leaves it opt-in.
    use_pallas_pivot: bool = False
    # basis-inverse storage/update dtype for the pivot loop. "float32" turns
    # on the mixed-precision engine: refactorization, x_B/y/dj recomputation
    # and claim verification stay f64 (every refactor_frequency pivots), but
    # the O(m^2)-per-pivot work — FTRAN/BTRAN against binv and the rank-1
    # product-form update — runs in f32. The verified-optimality protocol
    # re-derives every claim on fresh f64 factors, so drift costs at most
    # extra pivots, never a wrong answer.
    inverse_dtype: str = "float64"  # "float64" | "float32"
    # multiply-free kernels for +-1 matrices with <= 2 entries per column
    # (networks + their slacks). PRICE becomes two gathers (O(n) vs O(mn))
    # and the FTRAN column two binv column reads (reference:
    # ClpPlusMinusOneMatrix.hpp, ClpNetworkMatrix.hpp:12-16). The caller must
    # have verified the structure. "ell" is not ported yet (ROADMAP.md
    # queue 1: `ell` and `pe`).
    price_mode: str = "dense"  # "dense" | "pm1" | "block"
    # "block" geometry (block-banded LPs: staircase/multi-period): nb
    # column groups, each covered by an H-row window — PRICE/FTRAN/matvec
    # become batched dense-tile ops (block_forms). Chosen by the driver
    # from the host matrix so every column's support fits its window.
    price_block_nb: int = 0  # 0 = mode unavailable
    price_block_h: int = 0
    price_block_cb: int = 0  # columns per block (multiple of 128)
    # dual ratio test. "harris" = two-pass Harris stopping at the first
    # breakpoint window. "bfrt" = long-step bound-flipping ratio test
    # (reference: dualColumn's candidate/flip accounting,
    # ClpSimplexDual.cpp:2216+): walk PAST boxed breakpoints while the
    # leaving row's infeasibility slope stays positive — each passed boxed
    # variable flips to its opposite bound — and enter at the breakpoint
    # that exhausts the slope.
    dual_ratio: str = "harris"  # "harris" | "bfrt"
    # BFRT breakpoint-selection budget: only the K smallest dual ratios
    # can be walked in one long step; truncation is a valid shorter step.
    bfrt_topk: int = 256
    # timing-only component gates of the JAX package's pivot microbench;
    # not ported yet (ROADMAP.md queue 1: analysis/API/CLI). Must be empty.
    ablate: tuple = ()
    # pivots per inner-loop step: the inner loop checks the device status
    # once per block of this many pivots (one host sync per block). The
    # pivot body is no-op-safe — once a terminal status, the accuracy flag,
    # or the iteration limit is reached, do_pivot gates every state write —
    # so over-running a block past the stopping condition wastes at most
    # unroll-1 gated body evaluations per chunk. When refactor_frequency is
    # not a multiple of it, a chunk over-runs its frequency by up to
    # unroll-1 pivots, as in the JAX package (ROADMAP.md queue 3).
    inner_unroll: int = 1


@dataclasses.dataclass
class SimplexState:
    basis: torch.Tensor  # int64[m] variable index basic in row i
    vstat: torch.Tensor  # int32[nt]
    binv: torch.Tensor  # f64 or f32 [m, m]
    xb: torch.Tensor  # f64[m] values of basic variables
    dj: torch.Tensor  # f64[nt] reduced costs (0 at basic)
    y: torch.Tensor  # f64[m] simplex multipliers
    weights: torch.Tensor  # f64[m] DSE weights (dual) — primal keeps devex in wcol
    wcol: torch.Tensor  # f64[nt] devex reference weights (primal)
    iterations: torch.Tensor  # int32, 0-dim
    status: torch.Tensor  # int32, 0-dim, CONTINUE while running
    refactor_now: torch.Tensor  # bool, 0-dim — accuracy trigger
    refactors: torch.Tensor  # int32, 0-dim — factorization count


def _check_supported(opts: SimplexOptions) -> None:
    if opts.dual_pivot == "pe" or opts.primal_pivot == "pe":
        raise NotImplementedError(
            "Positive Edge pivot rules are not ported yet (ROADMAP.md queue 1: "
            "`ell` and `pe`): they draw jax.random streams torch cannot reproduce")
    if opts.price_mode not in ("dense", "pm1", "block"):
        raise NotImplementedError(
            f"price_mode={opts.price_mode!r} is not ported yet (ROADMAP.md queue 1: "
            "`ell` and `pe`)")
    if opts.ablate:
        raise NotImplementedError(
            "the timing-only ablate gates are not ported (ROADMAP.md queue 1: "
            "analysis/API/CLI)")


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-dim device index, without a host sync."""
    return x.index_select(0, i.reshape(1)).reshape(())


def _code(value: int, like: torch.Tensor) -> torch.Tensor:
    """A status code as a 0-dim tensor shaped like `like`."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def nonbasic_values(lp: StandardLP, vstat, dual_bound):
    """Values taken by nonbasic variables (with fake bounds where infinite).

    Fake-bound semantics per ClpSimplexDual.cpp:143-158: a nonbasic variable
    whose relevant bound is infinite sits at +-dual_bound instead.
    """
    vlo = torch.where(torch.isfinite(lp.l), lp.l, -dual_bound)
    vup = torch.where(torch.isfinite(lp.u), lp.u, dual_bound)
    val = torch.where(vstat == AT_LOWER, vlo, torch.where(vstat == AT_UPPER, vup, 0.0))
    return torch.where(vstat == BASIC, 0.0, val)


def recompute(lp: StandardLP, state: SimplexState, dual_bound) -> SimplexState:
    """Refactorize + recompute primals/duals (gutsOfSolution equivalent).

    f64 state: factor and recompute everything in f64.
    Mixed-precision state (f32 binv): factor in f32 and recover full f64
    accuracy for x_B/y/dj by iterative refinement — each step does one f64
    residual matvec against B and one f32 preconditioner application,
    converging to ~1e-13 in 3 steps for any basis the f32 factor can
    represent; a basis it cannot (refinement residual stays large) is
    flagged NUMERICAL exactly like a singular f64 factorization would be.
    """
    G, b, c = lp.G, lp.b, lp.c
    B = G.index_select(1, state.basis)
    xn = nonbasic_values(lp, state.vstat, dual_bound)
    rhs = b - G @ xn
    cb = c.index_select(0, state.basis)
    if state.binv.dtype != G.dtype:
        binv32, ok = lu_refactor32(B)
        f32 = binv32.dtype

        # trouble spot: torch lets a 0-dim or f32 operand yield to the other
        # dtype, so every f32 <-> f64 crossing here is an explicit cast
        def prec(v):  # f32 preconditioner application, f64 in/out
            return (binv32 @ v.to(f32)).to(G.dtype)

        def prec_t(v):
            return (v.to(f32) @ binv32).to(G.dtype)

        xb = prec(rhs)
        y = prec_t(cb)
        for _ in range(3):
            xb = xb + prec(rhs - B @ xb)
            y = y + prec_t(cb - y @ B)
        resid = (rhs - B @ xb).abs().amax() / (
            1.0 + torch.clamp_min(rhs.abs().amax(), 0.0))
        ok = ok & torch.isfinite(resid) & (resid < 1e-9)
        binv_store = binv32
        # devex reference-framework restart (primal weights): bounded drift
        # under the f32 pivot loop, same lesson as the DSE reset below
        wcol = torch.ones_like(state.wcol)
    else:
        binv, ok = lu_refactor(B)
        xb = binv @ rhs
        y = cb @ binv
        binv_store = binv
        wcol = state.wcol
    dj = c - y @ G
    dj = torch.where(state.vstat == BASIC, 0.0, dj)
    status = torch.where(ok, state.status, NUMERICAL).to(state.status.dtype)
    # reset DSE weights to exact steepest-edge norms ||e_r'B^-1||^2 on the
    # fresh factors (ClpDualRowSteepest full-mode reset). The incremental
    # Forrest-Goldfarb update drifts — harmlessly in f64 over one solve,
    # but under the f32 pivot loop unbounded drift was observed to starve
    # the most-infeasible rows of selection and stall convergence.
    bs = binv_store.to(G.dtype)
    weights = torch.clamp_min((bs * bs).sum(dim=1), 1e-8)
    return dataclasses.replace(
        state,
        binv=binv_store,
        xb=xb,
        y=y,
        dj=dj,
        weights=weights,
        wcol=wcol,
        status=status,
        refactor_now=torch.zeros((), dtype=torch.bool, device=G.device),
        refactors=state.refactors + 1,
    )


def _basic_bounds(lp: StandardLP, basis):
    return lp.l.index_select(0, basis), lp.u.index_select(0, basis)


# --------------------------------------------------------------------------
# +-1 multiply-free kernels (ClpPlusMinusOneMatrix / ClpNetworkMatrix)
# --------------------------------------------------------------------------


def pm1_indices(G):
    """Per-column (+1-row, -1-row) indices; m encodes "no such entry".

    Valid for matrices whose columns each hold at most one +1 and one -1
    (networks and their [A | -I] slacks). The caller verifies structure;
    here we only extract indices.
    """
    m = G.shape[0]
    pos = torch.where((G > 0.5).any(dim=0), torch.argmax(G, dim=0), m)
    neg = torch.where((G < -0.5).any(dim=0), torch.argmin(G, dim=0), m)
    return pos, neg


def _pm1_price(rho, pm1):
    """alpha = rho @ G as two gathers — O(n), no multiplies."""
    pos, neg = pm1
    rho_pad = torch.cat([rho, rho.new_zeros(1)])
    return rho_pad.index_select(0, pos) - rho_pad.index_select(0, neg)


def _pm1_ftran_col(binv, q, pm1):
    """binv @ G[:, q] = binv[:, pos_q] - binv[:, neg_q]."""
    pos, neg = pm1
    m = binv.shape[0]

    def col(ix):  # column ix of binv, or 0 where ix == m ("no entry")
        c = binv.index_select(1, ix.clamp(max=m - 1).reshape(1))[:, 0]
        return torch.where(ix < m, c, 0.0)

    return col(_at(pos, q)) - col(_at(neg, q))


def _pm1_matvec(delta, pm1, m):
    """G @ delta as a scatter-add — O(n)."""
    pos, neg = pm1
    out = delta.new_zeros(m + 1)
    out.index_add_(0, pos, delta)
    out.index_add_(0, neg, -delta)
    return out[:m]


# --------------------------------------------------------------------------
# block-banded forms (staircase / multi-period LPs)
# --------------------------------------------------------------------------


def block_forms(G, nb: int, H: int, CB: int = 0):
    """Column-window block forms over a PRE-SORTED G: contiguous runs of
    CB columns share one (H, CB) dense tile covering their row window.

    alpha = rho @ G becomes one batched product over (nb, H, CB) tiles,
    whose work and memory traffic are the covered windows, not m*nt. The
    driver permutes the standard form's columns by window position once
    per solve (and un-permutes the final state), so block results land
    contiguously. The caller chooses nb/H so every column's support fits
    its block window: starts_b = min(min_lo_b, m8-H) covers [min_lo_b,
    max_hi_b) whenever the block span <= H. Returns (starts int32 (nb,),
    W (nb, H, CB) in G's dtype, m8).
    """
    m, nt = G.shape
    if CB <= 0:
        CB = -(-nt // nb)
    # rows pad to a multiple of 8 and window starts round DOWN to multiples
    # of 8, as the JAX package's TPU kernel wants them; the driver's H
    # carries +8 slack so flooring never uncovers a column's support
    m8 = -(-m // 8) * 8
    G = torch.nn.functional.pad(G, (0, nb * CB - nt, 0, m8 - m))
    nz = G.abs() > 0
    # trouble spot: torch.argmax refuses bool; on uint8 it returns the first
    # maximum, as jnp.argmax does. Pad / empty columns must not drag a
    # block's window start to 0.
    lo = torch.where(nz.any(dim=0), torch.argmax(nz.to(torch.uint8), dim=0), m)
    starts = torch.clamp_max(lo.reshape(nb, CB).amin(dim=1), m8 - H)
    starts = torch.div(starts, 8, rounding_mode="floor") * 8
    rows = starts[:, None, None] + torch.arange(H, device=G.device)[None, :, None]
    cols = torch.arange(nb * CB, device=G.device).reshape(nb, 1, CB)
    return starts.to(torch.int32), G[rows, cols].contiguous(), m8


def _pad(v, n: int, fill=0.0):
    """v with n trailing `fill`s; v itself when n == 0 (no copy launched)."""
    return torch.nn.functional.pad(v, (0, n), value=fill) if n else v


def _blk_rows(starts, H):
    """(nb, H) row indices of every block's window."""
    return starts.to(torch.int64)[:, None] + torch.arange(H, device=starts.device)


def _blk_price(rho, blk, dtype, nt):
    """alpha = rho @ G over block tiles: one (nb,H)x(nb,H,CB) batched
    product; output is already in (sorted) column order."""
    starts, W, m8 = blk
    rho_p = _pad(rho, m8 - rho.shape[0])
    rho_w = rho_p[_blk_rows(starts, W.shape[1])].to(W.dtype)
    return torch.bmm(rho_w[:, None, :], W).reshape(-1)[:nt].to(dtype)


def _blk_col(q, blk, m):
    """Dense G[:, q] scattered from its block window. q is a 0-dim device
    index: block and column come from tensor arithmetic, never .item()."""
    starts, W, m8 = blk
    nb, H, CB = W.shape
    b = torch.div(q, CB, rounding_mode="floor").reshape(1)
    ar = torch.arange(H, device=W.device)
    # column c of tile b: W.flat[b*H*CB + h*CB + c] for h < H
    win = W.reshape(-1).index_select(0, b * (H * CB) + q.reshape(1) % CB + ar * CB)
    rows = starts.index_select(0, b).to(torch.int64) + ar
    return W.new_zeros(m8).index_copy_(0, rows, win)[:m]


def _blk_matvec(x, blk, m):
    """G @ x: per-block (H, CB) @ (CB,), then the overlapping windows summed.

    The JAX package scatters the windows with an add; on CUDA an
    index_add_ uses atomics, whose order changes from run to run. Here each
    block's window goes to its own row of an (nb, m8) buffer (no index
    repeats within a row) and the rows are summed by a reduction of fixed
    order, so the flow, and the pivot path after it, is deterministic.
    """
    starts, W, m8 = blk
    nb, H, CB = W.shape
    xp = _pad(x, nb * CB - x.shape[0]).reshape(nb, CB, 1)
    contrib = torch.bmm(W, xp.to(W.dtype))[:, :, 0]
    buf = W.new_zeros(nb, m8).scatter_(1, _blk_rows(starts, H), contrib)
    return buf.sum(dim=0)[:m]


def _smallest_k(t32: torch.Tensor, K: int) -> torch.Tensor:
    """Indices of the K smallest entries, ascending, ties by lower index.

    The JAX package takes them with lax.top_k(-t, K), which orders ties by
    index and compares floats in IEEE total order (-0.0 before +0.0).
    torch.topk does neither (on [1,0,0,0,2], K=3 it gave [1,3,2]), so this
    is a stable sort over a total-order integer key of the f32 bits.
    """
    bits = t32.view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.sort(key, stable=True).indices[:K]


# --------------------------------------------------------------------------
# Dual simplex
# --------------------------------------------------------------------------


def pivot_invariants(lp: StandardLP, opts: SimplexOptions):
    """Loop-invariant vectors of the dual pivot body, computed once per
    solve; recomputed inline when the caller passes pre=None (direct
    single-iteration callers, tests)."""
    fixed = lp.l == lp.u
    width = lp.u - lp.l
    width32 = width.to(torch.float32)
    finl = torch.isfinite(lp.l)
    finu = torch.isfinite(lp.u)
    m, nt = lp.G.shape
    dev = lp.G.device
    return {
        "fixed": fixed, "width": width, "width32": width32,
        "both_fin": finl & finu & ~fixed,
        "boxed": torch.isfinite(width32) & ~fixed,
        "vlo": torch.where(finl, lp.l, -opts.dual_bound),
        "vup": torch.where(finu, lp.u, opts.dual_bound),
        "idx_nt": torch.arange(nt, device=dev),
        "idx_m": torch.arange(m, device=dev),
        "one": torch.ones((), dtype=lp.G.dtype, device=dev),
    }


def dual_iteration(lp: StandardLP, state: SimplexState, opts: SimplexOptions,
                   G32=None, pm1=None, blk=None, pre=None):
    """One dual pivot: price row -> BTRAN -> ratio test -> FTRAN -> update.

    When opts.use_pallas_price, PRICE + the Harris pass-1 scan run fused in
    f32 (K1, ops/price.py) against a loop-invariant f32 copy of G (`G32`),
    or, given the block forms `blk` of a block-banded G (block_forms), in
    K3 against its f32 tiles; the chosen pivot is verified against the
    FTRAN value so pricing precision never affects correctness — only, at
    worst, the pivot choice (an extra iteration).

    When opts.inverse_dtype == "float32", binv arrives in f32 and all
    O(m^2) work against it (PRICE source row, FTRAN triple, rank-1 update)
    stays f32; scalars feeding the f64 solution updates are upcast.
    """
    _check_supported(opts)
    G = lp.G
    m, nt = G.shape
    dt = G.dtype
    f32 = torch.float32
    ptol = opts.primal_tolerance
    dtol = opts.dual_tolerance
    pt = opts.pivot_tolerance
    mixed = opts.inverse_dtype == "float32"
    if pre is None:
        pre = pivot_invariants(lp, opts)
    one = pre["one"]
    idx = pre["idx_nt"]
    im = pre["idx_m"]

    lb, ub = _basic_bounds(lp, state.basis)
    below = lb - state.xb
    above = state.xb - ub
    infeas = torch.clamp_min(torch.maximum(below, above), 0.0)
    cand = infeas > ptol

    # --- row choice: steepest edge (ClpDualRowSteepest) or Dantzig ---
    if opts.dual_pivot == "dantzig":
        score = torch.where(cand, infeas, -_INF)
    else:
        score = torch.where(
            cand, infeas * infeas / torch.clamp_min(state.weights, 1e-50), -_INF)
    r = torch.argmax(score)
    # ONE gather for every row-r scalar this pivot needs; r stays on the
    # device (x[r] with a tensor index would sync the host every pivot)
    row_stack = torch.stack([above, below, infeas, state.weights,
                             state.xb, lb, ub])
    above_r, below_r, infeas_r, w_r, xb_r, lb_r, ub_r = (
        row_stack.index_select(1, r.reshape(1))[:, 0].unbind(0))
    sigma = torch.where(above_r > below_r, one, -one)  # +1: leaves at upper
    # argmax r maximizes score, which is -inf only where ~cand: the
    # gathered row decides any_infeas without a second m-reduction
    any_infeas = infeas_r > ptol

    # --- BTRAN row + PRICE (+ fused Harris pass 1 in K1) ---
    # index_select copies: rho is never a view of binv, so the rank-1
    # update below (or K2) cannot change it under the pivot
    rho = state.binv.index_select(0, r.reshape(1))[0]
    at_lo = state.vstat == AT_LOWER
    at_up = state.vstat == AT_UPPER
    # fixed variables (l == u) can never usefully enter
    fixed = pre["fixed"]
    sgn = torch.where(at_lo, one, -one)
    rel = opts.harris_tolerance_frac * dtol

    if opts.use_pallas_price and blk is not None:
        # fused BLOCK PRICE + Harris pass-1 (K3): reads the window-compacted
        # (nb, H, CB) tiles instead of the full (m, nt) G
        starts_b, W_b, m8_b = blk
        padc = W_b.shape[0] * W_b.shape[2] - nt
        cand_dir = (at_lo | at_up) & ~fixed
        al_b, th_b = price_and_ratios_block(
            _pad(rho, m8_b - m), starts_b, W_b, _pad(state.dj, padc),
            _pad(cand_dir.to(torch.int32), padc), _pad(sgn, padc, 1.0),
            sigma, rel, pt)
        alpha = al_b[:nt].to(dt)
        a = sigma * alpha
        elig = ((at_lo & (a > pt)) | (at_up & (a < -pt))) & ~fixed
        theta_relaxed = torch.where(elig, th_b[:nt].to(dt), _INF)
    elif opts.use_pallas_price:
        cand_dir = (at_lo | at_up) & ~fixed
        alpha, theta_relaxed = price_and_ratios(
            rho, G if G32 is None else G32, state.dj, cand_dir, sgn,
            sigma, rel, pt)
        alpha = alpha.to(dt)
        a = sigma * alpha
        elig = ((at_lo & (a > pt)) | (at_up & (a < -pt))) & ~fixed
        theta_relaxed = torch.where(elig, theta_relaxed.to(dt), _INF)
    else:
        if pm1 is not None:
            alpha = _pm1_price(rho, pm1).to(dt)  # gathers only
        elif blk is not None:
            # block-banded PRICE: one batched (nb,H)x(nb,H,CB) product
            alpha = _blk_price(rho, blk, dt, nt)
        elif G32 is not None and mixed:
            alpha = (rho @ G32).to(dt)
        else:
            alpha = rho.to(dt) @ G  # tableau row r, full precision
        a = sigma * alpha
        elig = ((at_lo & (a > pt)) | (at_up & (a < -pt))) & ~fixed
        safe_a0 = torch.where(elig, a, 1.0)
        theta_relaxed = torch.where(elig, (state.dj + sgn * rel) / safe_a0, _INF)

    # --- Harris two-pass dual ratio test (dualColumn0 equivalent) ---
    safe_a = torch.where(elig, a, 1.0)
    theta_true = torch.where(elig, state.dj / safe_a, _INF)
    # the relaxed minimum is clamped by the true minimum because under f32
    # pricing it can undershoot and empty the window (exact-mode no-op)
    mins2 = torch.stack([theta_relaxed, theta_true]).amin(dim=1)
    theta_max = torch.maximum(mins2[0], mins2[1])
    in_window = elig & (theta_true <= theta_max)
    pivot_mag = torch.where(in_window, a.abs(), -_INF)
    # theta_true is +inf exactly where ~elig, so the min over it decides
    # any_elig without another nt-reduction
    any_elig = torch.isfinite(mins2[1])

    if opts.dual_ratio != "bfrt":
        q = torch.argmax(pivot_mag)
    else:
        # long-step BFRT: sort breakpoints by dual ratio and walk past the
        # boxed ones while the leaving row's infeasibility slope stays
        # positive. Passing boxed j (it will flip by width_j) reduces the
        # slope by |a_j| * width_j; a breakpoint with an infinite-width
        # column is impassable. The walk runs in f32 and only the SELECTION
        # depends on it — the pivot element itself is still verified. A
        # slightly conservative threshold is always valid: passing fewer
        # breakpoints is still a correct (shorter) long step.
        width32 = pre["width32"]
        boxed = pre["boxed"]
        a32 = a.abs().to(f32)
        t32 = torch.where(elig, theta_true, _INF).to(f32)
        gain = torch.where(elig & boxed, a32 * width32, _INF)
        # only the K smallest breakpoints can be walked in one pivot;
        # truncating at K is a valid (shorter) long step
        K = min(opts.bfrt_topk, nt)
        idxK = _smallest_k(t32, K)
        tK = t32.index_select(0, idxK)
        remain = infeas_r.to(f32) - torch.cumsum(
            torch.where(elig, gain, 0.0).index_select(0, idxK), dim=0)
        canpass = (remain > 0.0) & torch.isfinite(tK)
        k_star = torch.cumprod(canpass.to(torch.int32), dim=0).sum()
        theta_stop = _at(tK, torch.clamp_max(k_star, K - 1))
        # threshold semantics (strict <) instead of ranks: breakpoints tied
        # with theta_stop stay unpassed (still eligible)
        passed = elig & boxed & (t32 < theta_stop)
        # Harris window around the stop, multiplied through by |a| to
        # avoid the divide: theta <= stop + rel/|a|  <=>
        # theta*|a| <= stop*|a| + rel
        window_ls = elig & ~passed & (
            t32 * a32 <= torch.addcmul(torch.full_like(a32, rel), a32, theta_stop))
        # degenerate guard: if the long step passes every breakpoint
        # (slope never exhausted — a dual ray through flips alone), fall
        # back to the short-step Harris window above
        pivot_mag_ls = torch.where(window_ls, a32, -_INF)
        qq = torch.argmax(torch.stack([pivot_mag.to(f32), pivot_mag_ls]), dim=1)
        q, q_ls = qq[0], qq[1]
        # slope-validity check on the candidate over the SAME predicate the
        # flip set uses downstream: the walk is only valid if the gain of
        # exactly that set stays below the leaving row's infeasibility
        use_ls = _at(pivot_mag_ls, q_ls) > -_INF
        tq_ls = _at(theta_true, q_ls)
        would_flip = elig & pre["both_fin"] & (theta_true < tq_ls - 1e-12)
        gain_flip = torch.where(would_flip, a32 * width32, 0.0).sum()
        use_ls = use_ls & (gain_flip < infeas_r.to(f32))
        q = torch.where(use_ls, q_ls, q)

    # --- bound flips decided FIRST (ClpSimplexDual flipBounds :6345):
    # candidates whose ratio falls strictly below the chosen pivot's ratio
    # would go dual infeasible after the price update — but having BOTH
    # bounds finite they can jump to the opposite bound instead.
    vlo = pre["vlo"]
    vup = pre["vup"]
    # ONE gather for every column-q scalar (same batching as row_stack)
    col_stack = torch.stack([theta_true, state.dj, vlo, vup,
                             state.vstat.to(dt), alpha.to(dt)])
    theta_q, dj_q, vlo_q, vup_q, vstat_q_f, alpha_rq = (
        col_stack.index_select(1, q.reshape(1))[:, 0].unbind(0))
    both_fin = pre["both_fin"]
    flip = elig & both_fin & (theta_true < theta_q - 1e-12) & (idx != q)
    width = pre["width"]
    flip_delta = torch.where(flip, torch.where(at_lo, width, -width), 0.0)

    # --- FTRAN entering column + DSE tau + flip flow, fused: ONE read of
    # binv for all three m^2 contractions. The flow is computed whether or
    # not any bound flips (the JAX package branches with lax.cond; a host
    # branch here would sync every pivot): G @ 0 is exactly 0, so results
    # do not change, at the cost of one matvec per pivot (m x nt dense, or
    # the covered windows of the block form). ---
    bd = state.binv.dtype
    binv_fused = None  # set when the fused pivot kernel ran
    if pm1 is not None:
        abar = _pm1_ftran_col(state.binv, q, pm1).to(dt)
        tau = (state.binv @ rho).to(dt)
        flow = (state.binv @ _pm1_matvec(flip_delta, pm1, m).to(bd)).to(dt)
    else:
        if blk is not None:
            # column and flow from the block form; in the mixed engine W is
            # f32 and its column is cast to the LP's dtype, as in JAX
            Gq = _blk_col(q, blk, m).to(dt)
            fdelta = _blk_matvec(flip_delta, blk, m).to(dt)
        else:
            Gf = G32 if (G32 is not None and mixed) else G
            Gq = Gf.index_select(1, q.reshape(1))[:, 0]
            # mixed engine: the m x nt contraction runs against the f32 G
            # copy; drift is covered by the f64 recompute at refactorization
            fdelta = Gf @ flip_delta.to(Gf.dtype)
        triple = torch.stack([Gq.to(bd), rho.to(bd), fdelta.to(bd)], dim=1)
        if opts.use_pallas_pivot and mixed and bd == f32:
            # fused kernel K2: the 3-column FTRAN AND the rank-1 update in a
            # single pass over binv. The pivot element comes from the
            # consistent scalar rho . g_q (arithmetically row r of the same
            # contraction); the pivot gate is decided BEFORE the kernel so
            # a rejected pivot writes binv back unchanged.
            rho32 = rho.to(f32)
            abar_r32 = torch.dot(rho32, triple[:, 0])
            abar_r_f = abar_r32.to(dt)
            acc_bad_f = (alpha_rq - abar_r_f).abs() > 2e-4 * (1.0 + abar_r_f.abs())
            piv_small_f = abar_r_f.abs() < max(pt, 1e-6)
            gate = (
                any_infeas & any_elig & ~acc_bad_f & ~piv_small_f
                & ~state.refactor_now
                & (state.iterations < opts.max_iterations)
            ).to(f32)
            binv_fused, res = fused_pivot_update(
                state.binv, triple, rho32, abar_r32, gate, r)
            abar = res[:, 0].to(dt)
            tau = res[:, 1]  # stays f32: only feeds the weight update
            flow = res[:, 2].to(dt)
        else:
            ftran3 = state.binv @ triple
            abar = ftran3[:, 0].to(dt)
            tau = ftran3[:, 1]  # inverse dtype: only feeds the weight update
            flow = ftran3[:, 2].to(dt)
    abar_r = _at(abar, r) if binv_fused is None else abar_r_f
    # accuracy cross-check (reference: dual checks alpha vs ftran value).
    # f32 pricing widens the acceptable discrepancy; the FTRAN value
    # abar_r is the value actually used for the pivot either way.
    acc_tol = 2e-4 if (opts.use_pallas_price or mixed) else 1e-8
    acc_bad = (alpha_rq - abar_r).abs() > acc_tol * (1.0 + abar_r.abs())
    # f32 FTRAN values below ~1e-6 relative are noise: treat them as
    # too-small pivots (forces a fresh f64 factorization instead)
    piv_floor = max(pt, 1e-6) if mixed else pt
    piv_small = abar_r.abs() < piv_floor

    # pivot gate, decided as soon as the pivot element is known so the
    # rank-1 update can fold it into `factor` (a gated no-op subtracts an
    # exact zero outer product). The ~refactor_now / iteration-limit terms
    # freeze the state exactly where the inner loop would have stopped,
    # which makes the body safe to over-run in blocks (inner_unroll).
    do_pivot = (
        any_infeas & any_elig & ~acc_bad & ~piv_small
        & ~state.refactor_now
        & (state.iterations < opts.max_iterations)
    )

    # --- primal step: leaving variable lands on its violated bound,
    # after accounting for the flip flow ---
    target = torch.where(sigma > 0, ub_r, lb_r)
    delta_q = (xb_r - _at(flow, r) - target) / abar_r
    xq_old = torch.where(vstat_q_f == AT_LOWER, vlo_q, vup_q)
    xq_new = xq_old + delta_q

    # --- dual step + dj update; point updates are full-vector selects ---
    theta_d = dj_q / abar_r
    p_leave = _at(state.basis, r)
    # scalar where-gates, not *0 products: abar_r can be exactly 0 on a
    # gated iteration (piv_small), making theta_d/inv_piv inf — inf*0
    # would poison the vectors with NaN where a select stays exact.
    inv_piv = 1.0 / abar_r
    s_piv = torch.where(do_pivot, inv_piv, 0.0)
    # addcmul: ONE rounding for x - s*v. XLA contracts a multiply feeding an
    # add into an FMA, so the JAX package's recurrences (dj, DSE weights,
    # x_B, binv) round that way; so must the port's, or the DSE weights drift
    # apart through their cancellations within a few hundred pivots
    dj_new = torch.addcmul(state.dj, alpha, theta_d, value=-1.0)
    dj_new = torch.where(idx == q, 0.0, dj_new)
    dj_new = torch.where(idx == p_leave, -theta_d, dj_new)

    # --- DSE weight update (Forrest-Goldfarb) ---
    wr = torch.clamp_min(w_r, 1e-50)
    ratio = abar / abar_r
    w_new = torch.addcmul(
        torch.addcmul(state.weights, 2.0 * ratio, tau.to(state.weights.dtype), value=-1.0),
        ratio * ratio, wr)
    w_new = torch.clamp_min(w_new, 1e-8)
    w_new = torch.where(im == r, torch.clamp_min(wr / (abar_r * abar_r), 1e-8), w_new)

    # --- basis inverse product-form update (binv's own dtype); K2 already
    # wrote it (gated) in the same pass as the FTRAN
    if binv_fused is None:
        # pivot-gated factor (s_piv above): a gated no-op subtracts an
        # exact zero outer product — binv - 0*row == binv
        factor = abar * s_piv
        factor = torch.where(
            im == r, torch.where(do_pivot, 1.0 - inv_piv, 0.0), factor)
        binv_new = torch.addcmul(state.binv, factor.to(bd)[:, None],
                                 rho.to(bd)[None, :], value=-1.0)
    else:
        binv_new = binv_fused

    # --- basic solution update ---
    xb_new = torch.where(
        im == r, xq_new, torch.addcmul(state.xb, abar, delta_q, value=-1.0) - flow)
    basis_new = torch.where(im == r, q, state.basis)
    # apply bound flips first, then the pivot's status changes
    vstat_flipped = torch.where(
        flip, torch.where(at_lo, AT_UPPER, AT_LOWER), state.vstat)
    vstat_new = torch.where(
        idx == p_leave, torch.where(sigma > 0, AT_UPPER, AT_LOWER), vstat_flipped)
    vstat_new = torch.where(idx == q, BASIC, vstat_new).to(state.vstat.dtype)

    # --- dispatch on special cases (do_pivot decided above, pre-update) ---
    status = torch.where(
        ~any_infeas, OPTIMAL,
        torch.where(~any_elig, PRIMAL_INFEASIBLE, state.status),
    ).to(state.status.dtype)
    # accuracy problems: ask for refactorization instead of pivoting
    refactor_now = state.refactor_now | (any_infeas & any_elig & (acc_bad | piv_small))

    return SimplexState(
        basis=torch.where(do_pivot, basis_new, state.basis),
        vstat=torch.where(do_pivot, vstat_new, state.vstat),
        binv=binv_new,  # pivot-gated: K2 gates its write, the plain path
        # folds the gate into `factor` (exact no-op)
        xb=torch.where(do_pivot, xb_new, state.xb),
        dj=torch.where(do_pivot, dj_new, state.dj),
        y=state.y,  # refreshed at refactorization
        weights=torch.where(do_pivot, w_new, state.weights),
        wcol=state.wcol,
        iterations=state.iterations + do_pivot.to(state.iterations.dtype),
        status=status,
        refactor_now=refactor_now,
        refactors=state.refactors,
    )


# --------------------------------------------------------------------------
# Primal simplex
# --------------------------------------------------------------------------


def primal_iteration(lp: StandardLP, state: SimplexState, opts: SimplexOptions,
                     pm1=None, G32=None):
    """One primal pivot with composite phase-1 handling.

    Phase 1 uses the infeasibility-gradient objective (the vectorized
    equivalent of ClpNonLinearCost's composite costs, ClpNonLinearCost.hpp:
    8-28): basic variables outside their bounds contribute +-1 costs.

    When opts.inverse_dtype == "float32", binv arrives in f32 and the
    O(m^2)/O(m*nt) work against it (BTRAN, PRICE, FTRAN, rank-1 update)
    stays f32; scalars feeding the f64 solution updates are upcast (same
    contract as dual_iteration).
    """
    _check_supported(opts)
    G = lp.G
    m, nt = G.shape
    dt = G.dtype
    dev = G.device
    ptol = opts.primal_tolerance
    dtol = opts.dual_tolerance
    mixed = opts.inverse_dtype == "float32"
    bd = state.binv.dtype
    Gp_ = G32 if (G32 is not None and mixed) else G  # PRICE/FTRAN source
    one = torch.ones((), dtype=dt, device=dev)
    idx = torch.arange(nt, device=dev)
    im = torch.arange(m, device=dev)

    def _bmm(x, y):  # product in binv's own dtype at full f32 accuracy
        return (x.to(bd) @ y.to(bd)).to(dt)

    lb, ub = _basic_bounds(lp, state.basis)
    below = lb - state.xb
    above = state.xb - ub
    sig = torch.where(above > ptol, one, torch.where(below > ptol, -one, 0.0))
    in_phase1 = (sig != 0.0).any()

    # phase-1 reduced costs: d1_j = -(sig' Binv G)_j
    y1 = _bmm(sig, state.binv)
    d1 = -_pm1_price(y1, pm1).to(dt) if pm1 is not None else -_bmm(y1, Gp_)
    dj_used = torch.where(in_phase1, d1, state.dj)

    at_lo = state.vstat == AT_LOWER
    at_up = state.vstat == AT_UPPER
    at_fr = state.vstat == FREE
    fixed = lp.l == lp.u
    elig = (
        ((at_lo & (dj_used < -dtol)) | (at_up & (dj_used > dtol)))
        | (at_fr & (dj_used.abs() > dtol))
    ) & ~fixed

    # --- column choice (ClpPrimalColumnSteepest mode family) ---
    if opts.primal_pivot == "dantzig":
        score = torch.where(elig, dj_used.abs(), -_INF)
    else:
        # devex / exact steepest edge share the dj^2/weight form; they
        # differ in how wcol is maintained after the pivot below
        score = torch.where(
            elig, dj_used * dj_used / torch.clamp_min(state.wcol, 1e-50), -_INF)
    if opts.primal_pivot == "partial":
        # rotating candidate window (partial pricing)
        W = opts.partial_window if opts.partial_window > 0 else max(64, nt // 8)
        W = min(W, nt)
        start = (state.iterations * W) % nt
        in_win = ((idx - start) % nt) < W
        score_w = torch.where(in_win, score, -_INF)
        score = torch.where((score_w > -_INF).any(), score_w, score)
    q = torch.argmax(score)
    any_elig = elig.any()

    # ONE gather for every column-q scalar
    cq = torch.stack([at_lo.to(dt), at_up.to(dt), at_fr.to(dt), dj_used,
                      lp.l, lp.u, state.dj, state.wcol])
    at_lo_q, at_up_q, at_fr_q, dju_q, l_q, u_q, dj_q, wcol_q = (
        cq.index_select(1, q.reshape(1))[:, 0].unbind(0))
    at_lo_q, at_up_q, at_fr_q = at_lo_q > 0.5, at_up_q > 0.5, at_fr_q > 0.5
    direction = torch.where(
        at_up_q, -one, torch.where(at_fr_q, -torch.sign(dju_q), one))

    # --- FTRAN ---
    if pm1 is not None:
        abar = _pm1_ftran_col(state.binv, q, pm1).to(dt)
    else:
        abar = _bmm(state.binv, Gp_.index_select(1, q.reshape(1))[:, 0])
    d = direction * abar  # xb changes by -t * d for entering step t >= 0

    # --- Harris two-pass primal ratio test (primalRow equivalent) ---
    # Block at the FIRST kink in the direction of travel: an infeasible-above
    # basic moving down hits its upper bound first (it lands there feasible);
    # a basic already below its lower bound moving further down has no kink
    # in that direction (phase-1 gradient already accounts for it).
    dec = d > opts.pivot_tolerance  # basic value decreasing
    inc = d < -opts.pivot_tolerance
    lb_f = torch.isfinite(lb)
    ub_f = torch.isfinite(ub)
    is_above = above > ptol
    is_below = below > ptol
    # bound each moving basic blocks at (value), +-inf if none
    dec_bnd = torch.where(is_above, ub, torch.where(
        is_below, -_INF, torch.where(lb_f, lb, -_INF)))
    inc_bnd = torch.where(is_below, lb, torch.where(
        is_above, _INF, torch.where(ub_f, ub, _INF)))
    block_dec = dec & torch.isfinite(dec_bnd)
    block_inc = inc & torch.isfinite(inc_bnd)
    blocking = block_dec | block_inc
    safe_d = torch.where(dec | inc, d, 1.0)
    bnd = torch.where(block_dec, dec_bnd, inc_bnd)
    # relaxed ratios (pass 1): allow ptol overshoot past the bound
    t_rel = torch.where(blocking, (state.xb - bnd) / safe_d + ptol / safe_d.abs(), _INF)
    theta_max = t_rel.amin()
    # true ratios (pass 2): pick largest pivot within window
    t_true = torch.where(blocking, torch.clamp_min((state.xb - bnd) / safe_d, 0.0), _INF)
    in_window = blocking & (t_true <= theta_max)
    pivot_mag = torch.where(in_window, d.abs(), -_INF)
    r = torch.argmax(pivot_mag)
    has_block = in_window.any()
    theta_basic = torch.where(has_block, _at(t_true, r), _INF)

    # entering variable's own opposite bound (bound flip)
    width_q = u_q - l_q
    theta_own = torch.where(torch.isfinite(width_q), width_q, _INF)
    theta = torch.minimum(theta_basic, theta_own)

    unbounded = ~torch.isfinite(theta) & any_elig
    flip = (theta_own <= theta_basic) & torch.isfinite(theta_own)
    theta = torch.clamp_min(theta, 0.0)

    # --- updates ---
    xb_step = torch.addcmul(state.xb, d, theta, value=-1.0)

    # dual updates need the BTRAN row of the leaving basic (pivot row);
    # index_select copies, so rho is not a view of binv
    rho = state.binv.index_select(0, r.reshape(1))[0]
    alpha = _pm1_price(rho, pm1).to(dt) if pm1 is not None else _bmm(rho, Gp_)
    alpha_rq = _at(alpha, q)
    abar_r = _at(abar, r)
    acc_tol = 2e-4 if mixed else 1e-8
    acc_bad = (alpha_rq - abar_r).abs() > acc_tol * (1.0 + abar_r.abs())
    piv_floor = max(opts.pivot_tolerance, 1e-6) if mixed else opts.pivot_tolerance
    piv_small = abar_r.abs() < piv_floor

    theta_d = dj_q / alpha_rq
    dj_piv = torch.addcmul(state.dj, alpha, theta_d, value=-1.0)
    dj_piv = torch.where(idx == q, 0.0, dj_piv)
    p_leave = _at(state.basis, r)
    dj_piv = torch.where(idx == p_leave, -theta_d, dj_piv)

    wq = torch.clamp_min(wcol_q, 1e-50)
    if opts.primal_pivot == "steepest":
        # exact steepest edge, Forrest-Goldfarb primal update:
        # gamma_j' = max(gamma_j - 2 eta_j (a_j . w) + eta_j^2 gamma_q,
        #                1 + eta_j^2),  eta_j = alpha_j / alpha_rq,
        # w = B^-T abar. Costs one extra BTRAN + PRICE per pivot — the
        # same trade the reference's exact mode makes.
        w_se = _bmm(state.binv.T, abar)
        ag = _pm1_price(w_se, pm1).to(dt) if pm1 is not None else _bmm(w_se, Gp_)
        eta = alpha / abar_r
        w_piv = torch.maximum(
            torch.addcmul(torch.addcmul(state.wcol, 2.0 * eta, ag, value=-1.0),
                          eta * eta, wq),
            torch.addcmul(torch.ones_like(eta), eta, eta))
        w_piv = torch.where(idx == p_leave, torch.maximum(
            wq / (abar_r * abar_r), 1.0 + 1.0 / (abar_r * abar_r)), w_piv)
        w_piv = torch.where(idx == q, 1.0, w_piv)
    else:
        # devex reference-framework update (ClpPrimalColumnSteepest mode 3-ish)
        alpha_sq = alpha * alpha
        w_piv = torch.maximum(state.wcol, alpha_sq * (wq / (alpha_rq * alpha_rq)))
        w_piv = torch.where(
            idx == q, torch.clamp_min(wq / (alpha_rq * alpha_rq), 1.0), w_piv)

    factor = abar / abar_r
    factor = torch.where(im == r, 1.0 - 1.0 / abar_r, factor)
    binv_piv = torch.addcmul(state.binv, factor.to(bd)[:, None],
                             rho.to(bd)[None, :], value=-1.0)

    xq_old = torch.where(at_lo_q, l_q, torch.where(at_up_q, u_q, 0.0))
    xq_new = xq_old + direction * theta
    xb_piv = torch.where(im == r, xq_new, xb_step)

    # leaving variable status: lands on the bound it hit
    rs = torch.stack([block_dec, is_above, is_below]).index_select(1, r.reshape(1))[:, 0]
    hit_lower = torch.where(rs[0], ~rs[1], rs[2])
    leave_stat = torch.where(hit_lower, AT_LOWER, AT_UPPER)
    basis_piv = torch.where(im == r, q, state.basis)
    vstat_piv = torch.where(idx == p_leave, leave_stat, state.vstat)
    vstat_piv = torch.where(idx == q, BASIC, vstat_piv).to(state.vstat.dtype)

    # bound-flip variant: no basis change
    flip_stat = torch.where(at_lo_q, AT_UPPER, AT_LOWER)
    vstat_flip = torch.where(idx == q, flip_stat, state.vstat).to(state.vstat.dtype)

    # ~refactor_now / iteration-limit freeze the body exactly where the
    # inner loop stops, so it is safe to over-run in inner_unroll blocks
    # (same contract as dual_iteration's do_pivot gate)
    do_any = (
        any_elig & ~unbounded & ~state.refactor_now
        & (state.iterations < opts.max_iterations)
    )
    do_flip = do_any & flip
    do_pivot = do_any & ~flip & has_block & ~acc_bad & ~piv_small
    bad = do_any & ~flip & has_block & (acc_bad | piv_small)

    status = torch.where(
        ~any_elig,
        torch.where(in_phase1, PRIMAL_INFEASIBLE, OPTIMAL),
        torch.where(unbounded, torch.where(in_phase1, NUMERICAL, DUAL_INFEASIBLE),
                    state.status),
    ).to(state.status.dtype)
    refactor_now = state.refactor_now | bad

    return SimplexState(
        basis=torch.where(do_pivot, basis_piv, state.basis),
        vstat=torch.where(do_pivot, vstat_piv,
                          torch.where(do_flip, vstat_flip, state.vstat)),
        binv=torch.where(do_pivot, binv_piv, state.binv),
        xb=torch.where(do_pivot, xb_piv, torch.where(do_flip, xb_step, state.xb)),
        dj=torch.where(do_pivot, dj_piv, state.dj),
        y=state.y,
        weights=state.weights,
        wcol=torch.where(do_pivot, w_piv, state.wcol),
        iterations=state.iterations + (do_pivot | do_flip).to(state.iterations.dtype),
        status=status,
        refactor_now=refactor_now,
        refactors=state.refactors,
    )


# --------------------------------------------------------------------------
# Chunked solve loops
# --------------------------------------------------------------------------


def _primal_feasible(lp: StandardLP, state: SimplexState, opts: SimplexOptions):
    lb, ub = _basic_bounds(lp, state.basis)
    infeas = torch.clamp_min(torch.maximum(lb - state.xb, state.xb - ub), 0.0)
    return torch.clamp_min(infeas.amax(), 0.0) <= opts.primal_tolerance


def _dual_feasible(lp: StandardLP, state: SimplexState, opts: SimplexOptions):
    at_lo = state.vstat == AT_LOWER
    at_up = state.vstat == AT_UPPER
    fixed = lp.l == lp.u
    viol = torch.where(
        at_lo & ~fixed,
        torch.clamp_min(-state.dj, 0.0),
        torch.where(at_up & ~fixed, torch.clamp_min(state.dj, 0.0), 0.0),
    )
    return torch.clamp_min(viol.amax(), 0.0) <= opts.dual_tolerance * 10.0


def _verify_dual_claim(lp, state, opts):
    # dual simplex optimality = primal feasibility on fresh factors
    return _primal_feasible(lp, state, opts)


def _verify_primal_claim(lp, state, opts):
    # primal simplex optimality = feasible AND no attractive entering column
    return _primal_feasible(lp, state, opts) & _dual_feasible(lp, state, opts)


def _flags(st: SimplexState) -> tuple[int, int, bool]:
    """(status, iterations, refactor_now) in ONE device-to-host copy."""
    s, it, rn = torch.stack([st.status.to(torch.int64), st.iterations.to(torch.int64),
                             st.refactor_now.to(torch.int64)]).tolist()
    return s, it, bool(rn)


def _pivot_chunk(lp, st: SimplexState, opts: SimplexOptions, iteration_fn):
    """Up to refactor_frequency pivots (the inner while_loop of the JAX
    package), in blocks of inner_unroll pivots with one host check each."""
    chunk = opts.refactor_frequency
    U = max(1, int(opts.inner_unroll))
    k = 0
    while True:
        status, iters, refactor_now = _flags(st)
        if not (status == CONTINUE and k < chunk and not refactor_now
                and iters < opts.max_iterations):
            return st
        for _ in range(U):
            st = iteration_fn(lp, st, opts)
        k += U


def _run_loop(lp: StandardLP, state: SimplexState, opts: SimplexOptions,
              iteration_fn, verify_fn):
    """outer refactorize loop + inner pivot loop (gutsOfDual structure).

    An OPTIMAL claim from the inner loop is only accepted after a fresh
    refactorization confirms it (`verify_fn`) — incremental state drifts,
    and the reference re-verifies the same way before finishing
    (statusOfProblemInDual, ClpSimplexDual.cpp:4996).
    """
    st = state
    stalls = 0
    verified = False
    while True:
        status, iters, _ = _flags(st)
        claim = status in (OPTIMAL, PRIMAL_INFEASIBLE, DUAL_INFEASIBLE)
        running = status == CONTINUE or (claim and not verified)
        if not (running and iters < opts.max_iterations and stalls < 3):
            break
        iters_before = iters
        claimed_terminal = status in (PRIMAL_INFEASIBLE, DUAL_INFEASIBLE)
        st = recompute(lp, st, opts.dual_bound)
        fresh = int(st.status)
        verified = (status == OPTIMAL and bool(verify_fn(lp, st, opts))
                    and fresh != NUMERICAL)
        # re-open EVERY claim on fresh factors: an optimality claim is
        # checked directly (verify_fn); an infeasible/unbounded claim from
        # drifted incremental state is only accepted if the re-run
        # re-derives it without managing a single pivot (reference:
        # statusOfProblemInDual re-checks before finishing)
        st = dataclasses.replace(st, status=_code(
            NUMERICAL if fresh == NUMERICAL else (OPTIMAL if verified else CONTINUE),
            st.status))
        if not verified:
            st = _pivot_chunk(lp, st, opts, iteration_fn)
        new_status, new_iters, _ = _flags(st)
        reclaimed = (claimed_terminal and new_status == status
                     and new_iters == iters_before)
        verified = verified or reclaimed
        # stall: a chunk that made no pivots right after a fresh factorization
        # means a persistent numerical block (tiny pivot) -> escalate
        # (reference analogue: saferTolerances / flagging,
        # ClpFactorization.hpp:227, ClpSimplex flagged variables)
        made_progress = new_iters > iters_before or verified
        stalls = 0 if made_progress else stalls + 1
    if status == CONTINUE and stalls >= 3:
        st = dataclasses.replace(st, status=_code(NUMERICAL, st.status))
    # final consistency pass (already on fresh factors if the claim verified)
    if not verified:
        st = recompute(lp, st, opts.dual_bound)
    status, iters, _ = _flags(st)
    if status == CONTINUE and iters >= opts.max_iterations:
        st = dataclasses.replace(st, status=_code(ITER_LIMIT, st.status))
    return st


def _dual_iteration_fn(lp: StandardLP, opts: SimplexOptions):
    """Dual iteration closure; hoists loop-invariant matrix forms out of
    the pivot loop (the f32 G copy for K1/mixed-precision pricing, built
    once per solve and never per pivot, the block forms of a block-banded
    G, or the +-1 index arrays for multiply-free pricing)."""
    _check_supported(opts)
    pre = pivot_invariants(lp, opts)
    if opts.price_mode == "pm1" and not opts.use_pallas_price:
        return partial(dual_iteration, pm1=pm1_indices(lp.G), pre=pre)
    if opts.price_mode == "block" and opts.price_block_nb > 0:
        # W in f32 when the inverse is f32 or K3 is on, else in G's dtype;
        # no f32 copy of the whole G outlives block_forms
        Gb = (lp.G.to(torch.float32)
              if (opts.inverse_dtype == "float32" or opts.use_pallas_price)
              else lp.G)
        blk = block_forms(Gb, opts.price_block_nb, opts.price_block_h,
                          opts.price_block_cb)
        return partial(dual_iteration, blk=blk, pre=pre)
    if opts.use_pallas_price or opts.inverse_dtype == "float32":
        return partial(dual_iteration, G32=lp.G.to(torch.float32), pre=pre)
    return partial(dual_iteration, pre=pre)


def _primal_iteration_fn(lp: StandardLP, opts: SimplexOptions):
    """Primal iteration closure. The block form is the dual engine's: the
    primal prices densely on the (permuted) LP, as in the JAX package."""
    _check_supported(opts)
    if opts.price_mode == "pm1":
        return partial(primal_iteration, pm1=pm1_indices(lp.G))
    if opts.inverse_dtype == "float32":
        return partial(primal_iteration, G32=lp.G.to(torch.float32))
    return primal_iteration


def dual_solve(lp: StandardLP, state: SimplexState, opts: SimplexOptions) -> SimplexState:
    return _run_loop(lp, state, opts, _dual_iteration_fn(lp, opts), _verify_dual_claim)


def primal_solve(lp: StandardLP, state: SimplexState, opts: SimplexOptions) -> SimplexState:
    return _run_loop(lp, state, opts, _primal_iteration_fn(lp, opts), _verify_primal_claim)


def _one_chunk(lp, state, opts, iteration_fn, verify_fn):
    """Refactorize + verify any OPTIMAL claim + up to `chunk` pivots.

    The host-chunked execution mode: the outer statusOfProblem loop runs in
    the caller (enabling wall-clock limits and per-chunk progress
    callbacks). Returns (state, verified, objective) — objective of the
    current iterate for progress display — as device tensors.
    """
    claimed_optimal = state.status == OPTIMAL
    state = recompute(lp, state, opts.dual_bound)
    verified = claimed_optimal & verify_fn(lp, state, opts) & (state.status != NUMERICAL)
    state = dataclasses.replace(
        state,
        status=torch.where(
            state.status == NUMERICAL, NUMERICAL,
            torch.where(verified, OPTIMAL, CONTINUE),
        ).to(state.status.dtype),
    )
    if not bool(verified):
        state = _pivot_chunk(lp, state, opts, iteration_fn)
    xn = nonbasic_values(lp, state.vstat, opts.dual_bound)
    obj = lp.c.index_select(0, state.basis) @ state.xb + lp.c @ xn
    return state, verified, obj


def _pack_info(state: SimplexState, verified, obj):
    f64 = torch.float64
    return torch.stack([state.status.to(f64), state.iterations.to(f64),
                        verified.to(f64), obj.to(f64)])


def dual_chunk_packed(lp: StandardLP, state: SimplexState, opts: SimplexOptions):
    """One dual chunk + ONE packed f64[4] = [status, iterations, verified,
    objective], so host chunk loops pay a single device fetch per chunk."""
    state, verified, obj = _one_chunk(
        lp, state, opts, _dual_iteration_fn(lp, opts), _verify_dual_claim)
    return state, _pack_info(state, verified, obj)


def primal_chunk_packed(lp: StandardLP, state: SimplexState, opts: SimplexOptions):
    state, verified, obj = _one_chunk(
        lp, state, opts, _primal_iteration_fn(lp, opts), _verify_primal_claim)
    return state, _pack_info(state, verified, obj)


def initial_state(lp: StandardLP, opts: SimplexOptions, vstat=None, basis=None) -> SimplexState:
    """All-slack starting basis (or caller-provided warm start arrays)."""
    m, nt = lp.G.shape
    n = nt - m
    dev = lp.G.device
    dt = lp.G.dtype
    if basis is None:
        basis = torch.arange(n, n + m, device=dev)
    if vstat is None:
        lf = torch.isfinite(lp.l[:n])
        uf = torch.isfinite(lp.u[:n])
        closer_upper = uf & (~lf | (lp.u[:n].abs() < lp.l[:n].abs()))
        col_stat = torch.where(
            lf & ~closer_upper, AT_LOWER, torch.where(uf, AT_UPPER, FREE))
        vstat = torch.cat([col_stat, torch.full((m,), BASIC, device=dev)])
    inv_dtype = torch.float32 if opts.inverse_dtype == "float32" else dt
    i32 = torch.int32
    return SimplexState(
        basis=torch.as_tensor(basis, device=dev).to(torch.int64),
        vstat=torch.as_tensor(vstat, device=dev).to(i32),
        binv=torch.zeros((m, m), dtype=inv_dtype, device=dev),
        xb=torch.zeros(m, dtype=dt, device=dev),
        dj=torch.zeros(nt, dtype=dt, device=dev),
        y=torch.zeros(m, dtype=dt, device=dev),
        weights=torch.ones(m, dtype=dt, device=dev),
        wcol=torch.ones(nt, dtype=dt, device=dev),
        iterations=torch.zeros((), dtype=i32, device=dev),
        status=torch.full((), CONTINUE, dtype=i32, device=dev),
        refactor_now=torch.zeros((), dtype=torch.bool, device=dev),
        refactors=torch.zeros((), dtype=i32, device=dev),
    )


def make_dual_feasible(lp: StandardLP, state: SimplexState, opts: SimplexOptions) -> SimplexState:
    """Flip nonbasic statuses so dj is sign-feasible (changeBounds :3148).

    Free nonbasics are folded to a fake bound on the side their dj prefers.
    Must be called after an initial `recompute`.
    """
    dj = state.dj
    at_nb = state.vstat != BASIC
    want_upper = at_nb & (dj < -opts.dual_tolerance)
    want_lower = at_nb & (dj > opts.dual_tolerance)
    vstat = torch.where(want_upper, AT_UPPER,
                        torch.where(want_lower, AT_LOWER, state.vstat))
    # any remaining FREE nonbasic with tiny dj: park at fake lower bound
    vstat = torch.where(at_nb & (vstat == FREE), AT_LOWER, vstat).to(state.vstat.dtype)
    return dataclasses.replace(state, vstat=vstat)
