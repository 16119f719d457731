"""Column-sharded dual simplex: ONE LP's columns distributed over a mesh.

The dual engine's per-pivot work is dominated by PRICE (rho'G, an O(m*nt)
contraction over all columns) and the column-indexed bookkeeping (dj
updates, ratio tests, bound flips). Sharding the column axis over a
"block" mesh makes all of that local per shard. The JAX package places
the LP and the state (columns sharded, rows replicated) and runs its one
engine; XLA's SPMD partitioner derives the collectives. The port writes
them out, in `_ColEngine`:

    G, c, l, u, vstat, dj, wcol    column shards, one per mesh entry
    b, basis, binv, xb, y, weights on the first entry, with the bounds of
                                   the basic variables beside them

Per pivot the first entry picks the leaving row and sends rho to every
shard; each shard prices its columns, runs its half of the Harris ratio
test and sends back its minima and its best candidate (and, for BFRT, its
k smallest breakpoints, merged as parallel/block.py merges repricing
candidates); the entering column comes from its shard; each shard sends
its part of the bound-flip flow; the first entry updates the inverse and
x_B and sends the step back for each shard's dj / status update. Every
copy between entries goes through `Wire.move`, which counts it: a pivot
moves O(shards * (m + k)) elements, whatever the LP's width. A pivot
needs no host read; the refactorization reads the basis once, to fetch
each basic column from its shard.

Columns are padded to a multiple of the mesh size with fixed dummy
columns (l = u = 0, zero objective, zero matrix column): the engine's
`fixed` mask keeps them out of every ratio test and they price to 0. As in
the JAX package, the PRICE kernel is off here (its SPMD partitioner cannot
split a pallas_call) and PRICE is dense; the pivot kernel is off too, so
this engine launches no kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..forms import StandardLP
from ..simplex import engine
from ..simplex.engine import (
    AT_LOWER,
    AT_UPPER,
    BASIC,
    FREE,
    NUMERICAL,
    OPTIMAL,
    PRIMAL_INFEASIBLE,
    SimplexOptions,
    SimplexState,
    _at,
    _mv,
    _smallest_k,
    refactor_rows,
)
from ..utils.prng import fold_in_key, threefry2x32
# make_block_mesh: the JAX module has it here too
from .block import make_block_mesh, merge_smallest_k  # noqa: F401
from .mesh import Mesh

_INF = float("inf")


class Wire:
    """Every copy between mesh entries. `elements` counts what moved
    between two different entries (a copy within one entry is free); on a
    one-card mesh the entries share the card and the copies are no-ops, but
    they are counted all the same."""

    def __init__(self, mesh: Mesh):
        self.devices = mesh.devices
        self.elements = 0

    def move(self, x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        if src != dst:
            self.elements += x.numel()
        return x.to(self.devices[dst])

    def bcast(self, x: torch.Tensor) -> list:
        """x from the first entry to every entry."""
        return [self.move(x, 0, s) for s in range(len(self.devices))]

    def gather(self, xs) -> torch.Tensor:
        """One tensor per entry, stacked on the first entry."""
        return torch.stack([self.move(x, s, 0) for s, x in enumerate(xs)])


class ColumnShardedLP:
    """An LP whose column axis lives in contiguous, equal shards over a
    mesh: `shards[s]` holds (G, c, l, u) of columns offsets[s] ... on entry
    s's device, and b sits on the first entry. Reading G, c, l or u gives
    the whole padded array on the first entry (the JAX arrays' global
    view), for callers such as `engine.nonbasic_values`."""

    def __init__(self, lp: StandardLP, mesh: Mesh):
        m, nt = lp.G.shape
        d = mesh.size
        if nt % d:
            raise ValueError(f"{nt} columns do not split over {d} mesh entries; "
                             "pad_lp_columns first")
        self.mesh, self.m, self.nt, self.w = mesh, m, nt, nt // d
        self.offsets = [s * self.w for s in range(d)]
        self.shards = [
            {k: getattr(lp, k)[..., o:o + self.w].to(dev) for k in ("G", "c", "l", "u")}
            for o, dev in zip(self.offsets, mesh.devices)]
        self.b = lp.b.to(mesh.first)

    def _whole(self, k: str) -> torch.Tensor:
        return torch.cat([sh[k].to(self.mesh.first) for sh in self.shards], dim=-1)

    G = property(lambda self: self._whole("G"))
    c = property(lambda self: self._whole("c"))
    l = property(lambda self: self._whole("l"))  # noqa: E741
    u = property(lambda self: self._whole("u"))
    Q = None


@dataclasses.dataclass
class ShardedState:
    """The engine state with its column arrays in shards: vstat, dj and
    wcol are lists (one tensor per mesh entry); the row arrays and the
    scalars live on the first entry, with the bounds of the basic
    variables (lb_b, ub_b; set by the first refactorization)."""

    basis: torch.Tensor
    vstat: list
    binv: torch.Tensor
    xb: torch.Tensor
    dj: list
    y: torch.Tensor
    weights: torch.Tensor
    wcol: list
    iterations: torch.Tensor
    status: torch.Tensor
    refactor_now: torch.Tensor
    refactors: torch.Tensor
    lb_b: Optional[torch.Tensor] = None
    ub_b: Optional[torch.Tensor] = None


def pad_lp_columns(lp: StandardLP, multiple: int) -> tuple[StandardLP, int]:
    """Pad nt up to a multiple with fixed (l=u=0) zero columns.

    Returns (padded lp, original nt). Fixed columns can never enter a
    basis (engine `fixed` mask) and contribute nothing to any matvec.
    """
    m, nt = lp.G.shape
    pad = (-nt) % multiple
    if pad == 0:
        return lp, nt
    z = lp.G.new_zeros((m, pad))
    zv = lp.c.new_zeros(pad)
    return (
        dataclasses.replace(
            lp,
            G=torch.cat([lp.G, z], dim=1),
            c=torch.cat([lp.c, zv]),
            l=torch.cat([lp.l, zv]),
            u=torch.cat([lp.u, zv]),
        ),
        nt,
    )


def shard_lp_columns(lp: StandardLP, mesh: Mesh) -> tuple[ColumnShardedLP, int]:
    """Pad and place an LP with its column axis sharded over `mesh`."""
    lp, nt0 = pad_lp_columns(lp, mesh.size)
    return ColumnShardedLP(lp, mesh), nt0


def shard_state_columns(state: SimplexState, mesh: Mesh) -> ShardedState:
    """Place engine state: column-indexed arrays sharded, rows on the first
    entry."""
    nt = state.vstat.shape[0]
    w = nt // mesh.size
    first = mesh.first

    def cols(x):
        return [x[s * w:(s + 1) * w].to(dev) for s, dev in enumerate(mesh.devices)]

    return ShardedState(
        basis=state.basis.to(first), vstat=cols(state.vstat), binv=state.binv.to(first),
        xb=state.xb.to(first), dj=cols(state.dj), y=state.y.to(first),
        weights=state.weights.to(first), wcol=cols(state.wcol),
        iterations=state.iterations.to(first), status=state.status.to(first),
        refactor_now=state.refactor_now.to(first), refactors=state.refactors.to(first))


def _rademacher_slice(seed: int, data: torch.Tensor, start: int, n: int, dtype):
    """Entries start ... start+n of utils.prng.rademacher(seed, data, nt)."""
    k1, k2 = fold_in_key(seed, data)
    lo = torch.arange(start, start + n, dtype=torch.int64, device=data.device)
    hi, _ = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.where(hi < (1 << 31), 1.0, -1.0).to(dtype)


class _ColEngine:
    """The dual engine over a ColumnShardedLP: `recompute`, `iterate` and
    `verify` in the signatures engine._run_loop calls, so the claim and
    refactorization protocol is the single-device engine's own."""

    def __init__(self, slp: ColumnShardedLP, opts: SimplexOptions):
        if opts.dual_pivot not in ("steepest", "dantzig", "pe"):
            raise ValueError(f"unknown dual_pivot {opts.dual_pivot!r}")
        if opts.ablate:
            raise ValueError("the ablate gates are single-device timing aids")
        self.slp, self.opts = slp, opts
        self.wire = Wire(slp.mesh)
        self.mixed = opts.inverse_dtype == "float32"
        self.pivots = 0  # iterate() calls
        self.pivot_elements = 0  # elements moved by them
        first = slp.mesh.first
        self.offsets_t = torch.tensor(slp.offsets, device=first)
        self.pre = []
        for o, sh in zip(slp.offsets, slp.shards):
            lp_s = StandardLP(G=sh["G"], b=slp.b.to(sh["G"].device), c=sh["c"],
                              l=sh["l"], u=sh["u"])
            p = engine.pivot_invariants(lp_s, opts)
            p["idx_nt"] = p["idx_nt"] + o  # global column indices
            p["G32"] = sh["G"].to(torch.float32) if self.mixed else None
            self.pre.append(p)
        G0 = slp.shards[0]["G"]
        self.one = torch.ones((), dtype=G0.dtype, device=first)
        self.idx_m = torch.arange(slp.m, device=first)

    # -- refactorization ---------------------------------------------------

    def recompute(self, slp, st: ShardedState, dual_bound) -> ShardedState:
        """engine.recompute with the basic columns fetched from their
        shards (one host read of the basis) and rhs = b - G x_N and dj =
        c - y'G summed / computed per shard."""
        W, S = self.wire, len(slp.shards)
        first = slp.mesh.first
        m = slp.m
        G0 = slp.shards[0]["G"]
        basis_h = st.basis.cpu().numpy()
        owner = np.searchsorted(np.asarray(slp.offsets), basis_h, side="right") - 1
        B = G0.new_empty((m, m), device=first)
        clu = G0.new_empty((3, m), device=first)  # c, l, u of the basic variables
        parts = []
        for s, sh in enumerate(slp.shards):
            rows = np.flatnonzero(owner == s)
            if rows.size:
                dev = sh["G"].device
                loc = torch.as_tensor(basis_h[rows] - slp.offsets[s], device=dev)
                ri = torch.as_tensor(rows, device=first)
                B[:, ri] = W.move(sh["G"].index_select(1, loc), s, 0)
                clu[:, ri] = W.move(torch.stack([sh["c"], sh["l"], sh["u"]])
                                    .index_select(1, loc), s, 0)
            lp_s = StandardLP(G=sh["G"], b=None, c=sh["c"], l=sh["l"], u=sh["u"])
            xn = engine.nonbasic_values(lp_s, st.vstat[s], dual_bound)
            parts.append(_mv(sh["G"], xn))
        rhs = slp.b - W.gather(parts).sum(dim=0)
        mixed = st.binv.dtype != G0.dtype
        binv, xb, y, weights, ok = refactor_rows(B, rhs, clu[0], mixed)
        ys = W.bcast(y)
        dj = [torch.where(st.vstat[s] == BASIC, 0.0, sh["c"] - ys[s] @ sh["G"])
              for s, sh in enumerate(slp.shards)]
        wcol = [torch.ones_like(w) for w in st.wcol] if mixed else st.wcol
        return dataclasses.replace(
            st, binv=binv, xb=xb, y=y, dj=dj, weights=weights, wcol=wcol,
            status=torch.where(ok, st.status, NUMERICAL).to(st.status.dtype),
            refactor_now=torch.zeros((), dtype=torch.bool, device=first),
            refactors=st.refactors + 1, lb_b=clu[1].clone(), ub_b=clu[2].clone())

    def make_dual_feasible(self, st: ShardedState) -> ShardedState:
        """engine.make_dual_feasible, shard by shard."""
        dtol = self.opts.dual_tolerance
        vs = []
        for dj, v in zip(st.dj, st.vstat):
            at_nb = v != BASIC
            nv = torch.where(at_nb & (dj < -dtol), AT_UPPER,
                             torch.where(at_nb & (dj > dtol), AT_LOWER, v))
            vs.append(torch.where(at_nb & (nv == FREE), AT_LOWER, nv).to(v.dtype))
        return dataclasses.replace(st, vstat=vs)

    def verify(self, slp, st: ShardedState, opts) -> torch.Tensor:
        """The dual claim: primal feasibility on fresh factors (row space)."""
        infeas = torch.clamp_min(torch.maximum(st.lb_b - st.xb, st.xb - st.ub_b), 0.0)
        return torch.clamp_min(infeas.amax(), 0.0) <= opts.primal_tolerance

    # -- one pivot ----------------------------------------------------------

    def _argmax(self, mags) -> tuple:
        """Global first-max over per-shard (value, local index) pairs:
        (value, global index) on the first entry. Shards are in column
        order, so the first shard holding the max gives the lowest index,
        as torch.argmax over the whole row does."""
        W = self.wire
        vals = W.gather([t.amax() for t in mags])
        locs = W.gather([torch.argmax(t) for t in mags]) + self.offsets_t
        s = torch.argmax(vals)
        return _at(vals, s), _at(locs, s)

    def iterate(self, slp, st: ShardedState, opts: SimplexOptions) -> ShardedState:
        """engine.dual_iteration's dense PRICE branch over the shards: its
        column-local steps (engine.dense_price ... engine.column_update)
        run per shard, the row-space steps on the first entry."""
        W = self.wire
        e0 = W.elements
        S = len(slp.shards)
        dt = slp.shards[0]["G"].dtype
        ptol, dtol, pt = opts.primal_tolerance, opts.dual_tolerance, opts.pivot_tolerance
        mixed = self.mixed
        im = self.idx_m
        pre = self.pre

        lb, ub = st.lb_b, st.ub_b
        below = lb - st.xb
        above = st.xb - ub
        infeas = torch.clamp_min(torch.maximum(below, above), 0.0)
        score = engine.row_scores(infeas, st.weights, opts)
        if opts.dual_pivot == "pe":
            its = W.bcast(st.iterations)
            zs = [torch.where((st.vstat[s] != BASIC) & (st.dj[s].abs() <= dtol)
                              & ~pre[s]["fixed"],
                              _rademacher_slice(20210, its[s], slp.offsets[s], slp.w, dt), 0.0)
                  for s in range(S)]
            gz = W.gather([_mv(sh["G"], z) for sh, z in zip(slp.shards, zs)]).sum(dim=0)
            zz = W.gather([torch.sum(z * z) for z in zs]).sum()
            v = _mv(st.binv, gz.to(st.binv.dtype)).to(dt)
            score = engine.pe_scores(score, v, zz, opts)
        r = torch.argmax(score)
        infeas_r, w_r, xb_r, lb_r, ub_r, sigma, any_infeas = engine.row_scalars(
            r, above, below, infeas, st.weights, st.xb, lb, ub, self.one, ptol)
        rho = st.binv.index_select(0, r.reshape(1))[0]

        # --- PRICE + Harris pass 1, per shard ---
        rhos, sigs = W.bcast(rho), W.bcast(sigma)
        rel = opts.harris_tolerance_frac * dtol
        loc = []
        for s, sh in enumerate(slp.shards):
            p = pre[s]
            at_lo = st.vstat[s] == AT_LOWER
            at_up = st.vstat[s] == AT_UPPER
            sgn = torch.where(at_lo, p["one"], -p["one"])
            alpha = engine.dense_price(rhos[s], sh["G"], p["G32"], mixed)
            a, elig, theta_true, mins = engine.ratio_columns(
                alpha, sigs[s], st.dj[s], at_lo, at_up, p["fixed"], sgn, rel, pt)
            loc.append({"at_lo": at_lo, "alpha": alpha, "a": a, "elig": elig,
                        "theta_true": theta_true, "mins": mins})
        mins2 = W.gather([d["mins"] for d in loc]).amin(dim=0)
        theta_max = torch.maximum(mins2[0], mins2[1])
        any_elig = torch.isfinite(mins2[1])
        tmaxs = W.bcast(theta_max)
        for s, d in enumerate(loc):
            d["pivot_mag"] = engine.window_mags(d["a"], d["elig"], d["theta_true"], tmaxs[s])

        if opts.dual_ratio != "bfrt":
            _, q = self._argmax([d["pivot_mag"] for d in loc])
        else:
            q = self._bfrt(slp, loc, infeas_r)

        # --- the entering column and its scalars, from q's shard ---
        qs = W.bcast(q)
        col_vals, cols = [], []
        for s, (sh, d) in enumerate(zip(slp.shards, loc)):
            p = pre[s]
            li = torch.clamp(qs[s] - slp.offsets[s], 0, slp.w - 1).reshape(1)
            col_vals.append(W.move(torch.stack(
                [d["theta_true"], st.dj[s], p["vlo"], p["vup"], st.vstat[s].to(dt),
                 d["alpha"], sh["l"], sh["u"]]).index_select(1, li)[:, 0], s, 0))
            Gf = p["G32"] if mixed else sh["G"]
            cols.append(W.move(Gf.index_select(1, li)[:, 0], s, 0))
        sid = (q >= self.offsets_t).sum() - 1
        theta_q, dj_q, vlo_q, vup_q, vstat_q_f, alpha_rq, l_q, u_q = (
            torch.stack(col_vals).index_select(0, sid.reshape(1))[0].unbind(0))
        Gq = torch.stack(cols).index_select(0, sid.reshape(1))[0]

        # --- bound flips and their flow, per shard ---
        tqs = W.bcast(theta_q)
        flows = []
        for s, (sh, d) in enumerate(zip(slp.shards, loc)):
            p = pre[s]
            d["flip"] = (engine.flip_set(d["elig"], p["both_fin"], d["theta_true"], tqs[s])
                         & (p["idx_nt"] != qs[s]))
            flip_delta = torch.where(d["flip"], torch.where(d["at_lo"], p["width"],
                                                            -p["width"]), 0.0)
            Gf = p["G32"] if mixed else sh["G"]
            flows.append(_mv(Gf, flip_delta.to(Gf.dtype)))
        fdelta = W.gather(flows).sum(dim=0)

        # --- FTRAN + DSE tau + flip flow against binv, on the first entry ---
        bd = st.binv.dtype
        triple = torch.stack([Gq.to(bd), rho.to(bd), fdelta.to(bd)], dim=1)
        ftran3 = st.binv @ triple
        abar = ftran3[:, 0].to(dt)
        tau = ftran3[:, 1]
        flow = ftran3[:, 2].to(dt)
        abar_r = _at(abar, r)
        acc_tol = 2e-4 if mixed else 1e-8
        acc_bad = (alpha_rq - abar_r).abs() > acc_tol * (1.0 + abar_r.abs())
        piv_floor = max(pt, 1e-6) if mixed else pt
        piv_small = abar_r.abs() < piv_floor
        do_pivot = (any_infeas & any_elig & ~acc_bad & ~piv_small
                    & ~st.refactor_now & (st.iterations < opts.max_iterations))

        target = torch.where(sigma > 0, ub_r, lb_r)
        delta_q = (xb_r - _at(flow, r) - target) / abar_r
        xq_old = torch.where(vstat_q_f == AT_LOWER, vlo_q, vup_q)
        xq_new = xq_old + delta_q
        theta_d = dj_q / abar_r
        p_leave = _at(st.basis, r)
        inv_piv = 1.0 / abar_r
        s_piv = torch.where(do_pivot, inv_piv, 0.0)
        w_new = engine.dse_weights(st.weights, abar, abar_r, tau, w_r, r, im)
        binv_new = engine.binv_update(st.binv, abar, rho, inv_piv, s_piv, do_pivot, r, im)
        xb_new = torch.where(
            im == r, xq_new, torch.addcmul(st.xb, abar, delta_q, value=-1.0) - flow)
        basis_new = torch.where(im == r, q, st.basis)

        # --- the step back to the shards: dj and status updates ---
        tds, pls, dps = W.bcast(theta_d), W.bcast(p_leave), W.bcast(do_pivot)
        dj_out, vs_out = [], []
        for s, d in enumerate(loc):
            dj_new, v_new = engine.column_update(
                st.dj[s], st.vstat[s], d["alpha"], tds[s], pre[s]["idx_nt"], qs[s], pls[s],
                d["flip"], d["at_lo"], sigs[s])
            dj_out.append(torch.where(dps[s], dj_new, st.dj[s]))
            vs_out.append(torch.where(dps[s], v_new, st.vstat[s]))

        status = torch.where(
            ~any_infeas, OPTIMAL,
            torch.where(~any_elig, PRIMAL_INFEASIBLE, st.status)).to(st.status.dtype)
        refactor_now = st.refactor_now | (any_infeas & any_elig & (acc_bad | piv_small))
        self.pivots += 1
        self.pivot_elements += W.elements - e0
        return dataclasses.replace(
            st,
            basis=torch.where(do_pivot, basis_new, st.basis),
            vstat=vs_out,
            binv=binv_new,
            xb=torch.where(do_pivot, xb_new, st.xb),
            dj=dj_out,
            weights=torch.where(do_pivot, w_new, st.weights),
            iterations=st.iterations + do_pivot.to(st.iterations.dtype),
            status=status,
            refactor_now=refactor_now,
            lb_b=torch.where(do_pivot & (im == r), l_q, lb),
            ub_b=torch.where(do_pivot & (im == r), u_q, ub),
        )

    def _bfrt(self, slp, loc, infeas_r) -> torch.Tensor:
        """The long-step bound-flipping choice of engine.dual_iteration: the
        K smallest breakpoints are each shard's K smallest, merged on the
        first entry (block.merge_smallest_k's order); the slope walk runs
        there, and the window and flip-gain sums per shard."""
        W, opts, f32 = self.wire, self.opts, torch.float32
        rel = opts.harris_tolerance_frac * opts.dual_tolerance
        K = min(opts.bfrt_topk, slp.nt)
        ts, gs = [], []
        for s, d in enumerate(loc):
            d["a32"], d["t32"], gain = engine.breakpoints(d["a"], d["elig"], d["theta_true"],
                                                          self.pre[s])
            k = _smallest_k(d["t32"], min(K, slp.w))
            ts.append(W.move(d["t32"].index_select(0, k), s, 0))
            gs.append(W.move(gain.index_select(0, k), s, 0))
        tK, gK = merge_smallest_k(ts, K, gs)
        remain = infeas_r.to(f32) - torch.cumsum(gK, dim=0)
        canpass = (remain > 0.0) & torch.isfinite(tK)
        k_star = torch.cumprod(canpass.to(torch.int32), dim=0).sum()
        theta_stop = _at(tK, torch.clamp_max(k_star, K - 1))
        stops = W.bcast(theta_stop)
        packs, idxs = [], []
        for s, d in enumerate(loc):
            mag_ls = engine.long_step_mags(d["a32"], d["t32"], d["elig"],
                                           self.pre[s]["boxed"], stops[s], rel)
            mags = torch.stack([d["pivot_mag"].to(f32), mag_ls])
            qq = torch.argmax(mags, dim=1)
            vals = mags.amax(dim=1).to(d["theta_true"].dtype)
            packs.append(W.move(torch.cat([vals, _at(d["theta_true"], qq[1]).reshape(1)]),
                                s, 0))
            idxs.append(W.move(qq + slp.offsets[s], s, 0))
        packs, idxs = torch.stack(packs), torch.stack(idxs)
        s_mag, s_ls = torch.argmax(packs[:, 0]), torch.argmax(packs[:, 1])
        q, q_ls = _at(idxs[:, 0], s_mag), _at(idxs[:, 1], s_ls)
        use_ls = _at(packs[:, 1], s_ls) > -_INF
        tq_ls = _at(packs[:, 2], s_ls)
        tqs = W.bcast(tq_ls)
        flips = []
        for s, d in enumerate(loc):
            p = self.pre[s]
            would_flip = engine.flip_set(d["elig"], p["both_fin"], d["theta_true"], tqs[s])
            flips.append(torch.where(would_flip, d["a32"] * p["width32"], 0.0).sum())
        gain_flip = W.gather(flips).sum()
        use_ls = use_ls & (gain_flip < infeas_r.to(f32))
        return torch.where(use_ls, q_ls, q)

    def gathered(self, st: ShardedState) -> SimplexState:
        """The state with its column arrays on the first entry."""
        first = self.slp.mesh.first

        def cat(xs):
            return torch.cat([x.to(first) for x in xs])

        return SimplexState(
            basis=st.basis, vstat=cat(st.vstat), binv=st.binv, xb=st.xb, dj=cat(st.dj),
            y=st.y, weights=st.weights, wcol=cat(st.wcol), iterations=st.iterations,
            status=st.status, refactor_now=st.refactor_now, refactors=st.refactors)


def dual_solve_colsharded(
    lp: StandardLP,
    opts: SimplexOptions,
    mesh: Mesh,
    vstat=None,
    basis=None,
    stats: Optional[dict] = None,
) -> tuple[SimplexState, ColumnShardedLP, int]:
    """Full dual solve of one LP with columns sharded over `mesh`.

    Returns (final state, the padded and sharded lp, original nt). The
    state's column arrays are gathered onto the first mesh entry; the
    caller slices column-indexed outputs back to the original nt. The
    PRICE and pivot kernels and the pm1 / ell / block PRICE forms assume
    one device, so they are forced off: dense PRICE. Given `stats`, it
    receives the pivots (engine iteration calls), the elements moved
    between mesh entries by them and per pivot, and by the whole solve.
    """
    opts = dataclasses.replace(opts, use_pallas_price=False, price_mode="dense",
                               use_pallas_pivot=False)
    # the start state on the ORIGINAL lp: padding appends columns AFTER the
    # slacks, so the all-slack basis indices (last m of nt0) stay valid,
    # but initial_state must not see the zero pads as slacks
    state = engine.initial_state(lp, opts, vstat=vstat, basis=basis)
    slp, nt0 = shard_lp_columns(lp, mesh)
    pad = slp.nt - nt0
    if pad:
        dev = state.vstat.device
        state = dataclasses.replace(
            state,
            vstat=torch.cat([state.vstat, torch.full((pad,), AT_LOWER, dtype=torch.int32,
                                                     device=dev)]),
            dj=torch.cat([state.dj, state.dj.new_zeros(pad)]),
            wcol=torch.cat([state.wcol, state.wcol.new_ones(pad)]),
        )
    eng = _ColEngine(slp, opts)
    st = shard_state_columns(state, mesh)
    st = eng.recompute(slp, st, opts.dual_bound)
    st = eng.make_dual_feasible(st)
    st = engine._run_loop(slp, st, opts, eng.iterate, eng.verify,
                          recompute_fn=eng.recompute)
    if stats is not None:
        stats.update(pivots=eng.pivots, pivot_elements=eng.pivot_elements,
                     elements_per_pivot=eng.pivot_elements / max(1, eng.pivots),
                     elements=eng.wire.elements, shards=mesh.size)
    return eng.gathered(st), slp, nt0
