"""Dynamic-matrix simplex: in-loop column generation over a bounded
working set (the ClpDynamicMatrix / ClpGubDynamicMatrix capability,
ClpDynamicMatrix.hpp:8-16).

Port of the JAX package's dynamic.py. The working set is a FIXED-SIZE
block of column slots in the standard-form matrix on `options.device`.
Pricing happens INSIDE the simplex loop at refactorization boundaries (the
reference prices in partialPricing hooks at the same cadence): after each
chunk of primal pivots, the column source is priced on the host with the
current duals; attractive columns are swapped INto nonbasic slots,
unattractive nonbasic columns swap out. The basis always references
slots, so warm state survives every swap.

A swap builds new G, c, l, u tensors (`index_copy`, out of place, as the
JAX package's functional `.at[].set`): nothing the engine state holds
aliases a tensor that a later swap changes, and each chunk rebuilds its
loop invariants from the LP it is given.

This differs from sprint.py (which rebuilds a new sub-MODEL each pass and
re-enters the solver): here one engine state machine runs start-to-finish
and the matrix mutates under it — the dynamic-matrix semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .constants import INF, ProblemStatus
from .device import resolve_device
from .forms import StandardLP
from .model import Solution
from .options import SolveOptions
from .simplex import engine


class ColumnSource:
    """Supplies columns on demand (ClpDynamicMatrix's createVariable role).

    Implement:
      n_total          — number of columns in the (possibly huge) universe,
                         or -1 when columns are generated (cutting stock)
      initial(k)       — k starting columns: (cols (m,k) ndarray, cost,
                         lower, upper, ids)
      price(y, k)      — up to k attractive columns given duals y, with
                         reduced cost < -tol: same tuple shape; ids must be
                         stable so duplicates can be filtered
    """

    n_total: int = -1

    def initial(self, k: int):
        raise NotImplementedError

    def price(self, y: np.ndarray, k: int):
        raise NotImplementedError


class ExplicitColumnSource(ColumnSource):
    """Universe given as an explicit matrix (ClpDynamicMatrix's stored
    whole-matrix mode): pricing is one dense dj sweep on the host."""

    def __init__(self, A, cost, lower=None, upper=None, dual_tol=1e-7):
        A = np.asarray(A.todense()) if hasattr(A, "todense") else np.asarray(A)
        self.A = A
        self.cost = np.asarray(cost, dtype=np.float64)
        n = A.shape[1]
        self.lower = np.zeros(n) if lower is None else np.asarray(lower, float)
        self.upper = np.full(n, INF) if upper is None else np.asarray(upper, float)
        self.n_total = n
        self.dual_tol = dual_tol

    def initial(self, k: int):
        order = np.argsort(self.cost)
        ids = order[: min(k, self.n_total)]
        return self.A[:, ids], self.cost[ids], self.lower[ids], self.upper[ids], ids

    def price(self, y: np.ndarray, k: int, exclude=()):
        dj = self.cost - y @ self.A
        dj[list(exclude)] = np.inf
        order = np.argsort(dj)
        ids = [int(j) for j in order[:k] if dj[j] < -self.dual_tol]
        ids = np.asarray(ids, dtype=np.int64)
        return self.A[:, ids], self.cost[ids], self.lower[ids], self.upper[ids], ids


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def dynamic_simplex_solve(
    row_lower: np.ndarray,
    row_upper: np.ndarray,
    source: ColumnSource,
    working_set: int = 0,
    options: Optional[SolveOptions] = None,
    max_rounds: int = 200,
) -> tuple[Solution, dict]:
    """Solve min c'x s.t. rl <= A x <= ru, l <= x <= u with columns drawn
    from `source`, keeping at most `working_set` columns on the device.

    Returns (solution over the working set, info). The Solution carries
    the working-set values; info['ids'] gives the universe id of each
    slot (-1 for an empty slot).
    """
    options = options or SolveOptions()
    dev = resolve_device(options.device)
    rl = np.asarray(row_lower, dtype=np.float64)
    ru = np.asarray(row_upper, dtype=np.float64)
    m = rl.size
    ws = working_set or max(3 * m, 64)
    if source.n_total >= 0:
        ws = min(ws, source.n_total)

    cols, cost, lo, up, ids = source.initial(ws)
    k0 = cols.shape[1]
    if k0 < ws:  # pad with dummy fixed columns (never enter)
        pad = ws - k0
        cols = np.concatenate([cols, np.zeros((m, pad))], axis=1)
        cost = np.concatenate([cost, np.zeros(pad)])
        lo = np.concatenate([lo, np.zeros(pad)])
        up = np.concatenate([up, np.zeros(pad)])
        ids = np.concatenate([ids, np.full(pad, -1, dtype=np.int64)])
    ids = np.asarray(ids, dtype=np.int64).copy()

    def dev_t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64), device=dev)

    # standard form arrays (working columns + slacks) on the device
    lp = StandardLP(
        G=dev_t(np.concatenate([cols, -np.eye(m)], axis=1)),
        b=dev_t(np.zeros(m)),
        c=dev_t(np.concatenate([cost, np.zeros(m)])),
        l=dev_t(np.concatenate([lo, np.where(rl <= -INF, -np.inf, rl)])),
        u=dev_t(np.concatenate([up, np.where(ru >= INF, np.inf, ru)])),
    )

    opts = engine.SimplexOptions(
        refactor_frequency=options.refactor_frequency or 100,
        max_iterations=options.max_iterations or 200000,
    )
    state = engine.initial_state(lp, opts)

    dual_tol = 1e-7
    total_swaps = 0
    rounds = 0
    seen_optimal = False
    for rounds in range(max_rounds):
        # run primal chunks until the working-set LP claims verified optimal
        while True:
            state, verified, _ = engine.primal_chunk(lp, state, opts)
            st = int(state.status)
            if bool(verified) or st not in (engine.CONTINUE, engine.OPTIMAL):
                break
        if st != engine.OPTIMAL:
            break

        # in-loop pricing with the current duals
        y = _np(state.y)
        exclude = set(int(i) for i in ids if i >= 0)
        new_cols, new_cost, new_lo, new_up, new_ids = source.price(
            y, max(1, ws // 4), exclude=exclude
        ) if isinstance(source, ExplicitColumnSource) else source.price(
            y, max(1, ws // 4)
        )
        if getattr(new_ids, "size", len(new_ids)) == 0:
            seen_optimal = True
            break
        # generated sources may return columns already in the set: filter
        fresh = [t for t in range(len(new_ids)) if int(new_ids[t]) not in exclude]
        if not fresh:
            seen_optimal = True
            break

        # swap-out candidates: nonbasic slots at a zero-valued bound with
        # comfortably non-negative dj (never a basic slot: basis stays valid)
        vstat = _np(state.vstat)
        dj = _np(state.dj)
        lo_h = _np(lp.l)
        # at working-set optimality every nonbasic-at-lower slot has
        # dj >= -tol; all of them (at a zero-valued lower bound) are safe
        # to evict — removal changes nothing about the current solution
        swappable = [
            s
            for s in range(ws)
            if vstat[s] == engine.AT_LOWER
            and abs(lo_h[s]) < 1e-12
            and (dj[s] >= -dual_tol or ids[s] < 0)
        ]
        # prefer evicting dummies, then the least attractive columns
        swappable.sort(key=lambda s: (ids[s] >= 0, -dj[s]))
        if len(swappable) < len(fresh):
            # saturation: columns pinned basic/at-upper leave no slots.
            # Grow the working set geometrically (ClpDynamicMatrix grows its
            # gub-column store the same way); slacks stay at the end, so
            # basis/vstat indices >= ws shift by `grow`.
            grow = max(ws // 2, len(fresh) - len(swappable))

            def widen(v, fill):
                mid = torch.full((*v.shape[:-1], grow), fill, dtype=v.dtype, device=dev)
                return torch.cat([v[..., :ws], mid, v[..., ws:]], dim=-1)

            lp = StandardLP(G=widen(lp.G, 0.0), b=lp.b, c=widen(lp.c, 0.0),
                            l=widen(lp.l, 0.0), u=widen(lp.u, 0.0))
            state = dataclasses.replace(
                state,
                basis=torch.where(state.basis >= ws, state.basis + grow, state.basis),
                vstat=widen(state.vstat, engine.AT_LOWER),
                dj=widen(state.dj, 0.0),
                wcol=widen(state.wcol, 1.0),
            )
            ids = np.concatenate([ids, np.full(grow, -1, dtype=np.int64)])
            swappable += list(range(ws, ws + grow))
            ws += grow
        n_swap = min(len(fresh), len(swappable))
        if n_swap == 0:
            break  # saturated: stop WITHOUT claiming universe optimality
        take = np.asarray(fresh[:n_swap])
        slots = torch.as_tensor(np.asarray(swappable[:n_swap], dtype=np.int64), device=dev)
        lp = dataclasses.replace(
            lp,
            G=lp.G.index_copy(1, slots, dev_t(np.asarray(new_cols)[:, take])),
            c=lp.c.index_copy(0, slots, dev_t(np.asarray(new_cost)[take])),
            l=lp.l.index_copy(0, slots, dev_t(np.asarray(new_lo)[take])),
            u=lp.u.index_copy(0, slots, dev_t(np.asarray(new_up)[take])),
        )
        ids[np.asarray(swappable[:n_swap])] = np.asarray(new_ids)[take]
        total_swaps += n_swap
        # re-open the state: statuses stay, next chunk refactorizes + reprices
        state = dataclasses.replace(state, status=engine._code(engine.CONTINUE, state.status))

    # extract
    xfull = _np(engine.nonbasic_values(lp, state.vstat, opts.dual_bound)).copy()
    xfull[_np(state.basis)] = _np(state.xb)
    x_ws = xfull[:ws]
    y = _np(state.y)
    obj_val = float(_np(lp.c[:ws]) @ x_ws)
    status = (
        ProblemStatus.OPTIMAL
        if seen_optimal and int(state.status) == engine.OPTIMAL
        else {
            engine.OPTIMAL: ProblemStatus.OPTIMAL,
            engine.PRIMAL_INFEASIBLE: ProblemStatus.PRIMAL_INFEASIBLE,
            engine.DUAL_INFEASIBLE: ProblemStatus.DUAL_INFEASIBLE,
            engine.ITER_LIMIT: ProblemStatus.STOPPED,
        }.get(int(state.status), ProblemStatus.ERRORS)
    )
    sol = Solution(
        status=status,
        objective_value=obj_val,
        primal=x_ws,
        duals=y,
        reduced_costs=_np(state.dj)[:ws],
        row_activity=_np(lp.G[:, :ws]) @ x_ws,
        iterations=int(state.iterations),
    )
    info = {
        "ids": ids.copy(),
        "rounds": rounds + 1,
        "swaps": total_swaps,
        "working_set": ws,
        "proved_optimal_over_universe": seen_optimal,
    }
    return sol, info
