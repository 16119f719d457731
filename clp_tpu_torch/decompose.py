"""Block decomposition: Benders (L-shaped) with batched scenario subproblems,
and Dantzig-Wolfe column generation.

Reference: solveDW / solveBenders over CoinStructuredModel
(ClpSolve.cpp:5294/6127), sequential subproblem loops there. All scenario
subproblems share a shape, so each Benders iteration solves them as ONE
batched IPM call (interior/mehrotra.ipm_solve_batched): the subproblem
sweep is one batched program instead of a loop.

Two-stage form handled by `benders_solve`:

    min  c'x + sum_s p_s q_s' y_s
    s.t. A x  ~ b          (first stage, any row bounds)
         T_s x + W y_s = h_s,  y_s >= 0      for each scenario s
         lx <= x <= ux

Requires relatively complete recourse (a subproblem that does not converge
raises; feasibility cuts would need rays). The algorithm's own failures
raise DecompositionError, never a bare RuntimeError, so that a caller
falling back on them cannot swallow a torch or CUDA error.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from .constants import INF, ProblemStatus, SolveMethod
from .device import resolve_device
from .model import Model, Solution
from .options import SolveOptions


class DecompositionError(RuntimeError):
    """A decomposition could not finish by its own means: a master or a
    subproblem that is not optimal, or a scenario that does not converge."""


@dataclasses.dataclass
class TwoStageLP:
    """Scenario data with identical shapes across scenarios."""

    c: np.ndarray  # (n1,)
    A: sp.spmatrix  # (m1, n1) first-stage constraints
    row_lower: np.ndarray
    row_upper: np.ndarray
    col_lower: np.ndarray
    col_upper: np.ndarray
    T: np.ndarray  # (S, m2, n1)
    W: np.ndarray  # (S, m2, n2)
    h: np.ndarray  # (S, m2)
    q: np.ndarray  # (S, n2)
    prob: np.ndarray  # (S,)


def extensive_form(ts: TwoStageLP) -> Model:
    """Deterministic equivalent (for testing and small instances)."""
    S, m2, n2 = ts.W.shape
    top = sp.hstack([sp.csc_matrix(ts.A)] + [sp.csc_matrix((ts.A.shape[0], n2))] * S)
    body = []
    for s in range(S):
        mids = [sp.csc_matrix((m2, n2))] * S
        mids[s] = sp.csc_matrix(ts.W[s])
        body.append(sp.hstack([sp.csc_matrix(ts.T[s])] + mids))
    A_full = sp.vstack([top] + body, format="csc")
    model = Model()
    model.load_problem(
        A_full,
        col_lower=np.concatenate([ts.col_lower, np.zeros(S * n2)]),
        col_upper=np.concatenate([ts.col_upper, np.full(S * n2, INF)]),
        objective=np.concatenate([ts.c] + [ts.prob[s] * ts.q[s] for s in range(S)]),
        row_lower=np.concatenate([ts.row_lower] + [ts.h[s] for s in range(S)]),
        row_upper=np.concatenate([ts.row_upper] + [ts.h[s] for s in range(S)]),
    )
    return model


def solve_scenarios(ts: TwoStageLP, x: np.ndarray, options: SolveOptions):
    """Every scenario's recourse LP at first-stage point x, in one batched
    IPM call: min q_s' y  s.t.  W_s y = h_s - T_s x,  y >= 0.

    Returns the IPMResult (lanes on the host). Raises DecompositionError
    when a scenario does not converge."""
    from .forms import StandardLP
    from .interior.mehrotra import IPMOptions, ipm_solve_batched

    dev = resolve_device(options.device)
    S, m2, n2 = ts.W.shape
    rhs = ts.h - np.einsum("smn,n->sm", ts.T, x)
    f64 = torch.float64
    lp = StandardLP(
        G=torch.as_tensor(ts.W, dtype=f64, device=dev),
        b=torch.as_tensor(rhs, dtype=f64, device=dev),
        c=torch.as_tensor(ts.q, dtype=f64, device=dev),
        l=torch.zeros((S, n2), dtype=f64, device=dev),
        u=torch.full((S, n2), torch.inf, dtype=f64, device=dev),
    )
    opts = IPMOptions(tol=max(options.barrier_tolerance, 1e-9), max_iter=100)
    res = ipm_solve_batched(lp, opts)
    res = dataclasses.replace(res, **{f.name: getattr(res, f.name).cpu()
                                      for f in dataclasses.fields(res)})
    conv = res.converged.numpy()
    if not conv.all():
        raise DecompositionError(
            f"scenario subproblems {np.flatnonzero(~conv).tolist()} did not converge "
            "(feasibility cuts require complete recourse)")
    return res


def _solve_scenarios_batched(ts: TwoStageLP, x: np.ndarray, options: SolveOptions):
    """(values, duals pi (S, m2)) of every scenario's recourse LP at x."""
    res = solve_scenarios(ts, x, options)
    return res.pobj.numpy(), res.y.numpy()


def _sub_options(options: SolveOptions) -> SolveOptions:
    sub = SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device=options.device)
    sub.presolve.enabled = False
    return sub


def benders_solve(
    ts: TwoStageLP,
    options: Optional[SolveOptions] = None,
    max_iterations: int = 100,
    tol: float = 1e-7,
) -> tuple[Solution, np.ndarray]:
    """L-shaped method with single aggregated optimality cuts.

    Returns (first-stage Solution with the total objective, x)."""
    options = options or SolveOptions()
    n1 = ts.c.size
    m1 = ts.A.shape[0]

    # master: min c'x + theta, cuts appended as rows
    master = Model()
    master.load_problem(
        sp.hstack([sp.csc_matrix(ts.A), sp.csc_matrix((m1, 1))], format="csc"),
        col_lower=np.concatenate([ts.col_lower, [-1e12]]),
        col_upper=np.concatenate([ts.col_upper, [INF]]),
        objective=np.concatenate([ts.c, [1.0]]),
        row_lower=ts.row_lower,
        row_upper=ts.row_upper,
    )
    sub_opts = _sub_options(options)

    upper = np.inf
    lower = -np.inf
    x_best = None
    for it in range(max_iterations):
        msol = master.initial_solve(sub_opts)
        if msol.status != ProblemStatus.OPTIMAL:
            raise DecompositionError(f"master not optimal: {msol.status}")
        x = np.asarray(msol.primal[:n1])
        lower = msol.objective_value

        vals, pi = _solve_scenarios_batched(ts, x, options)
        total = float(ts.c @ x) + float(np.sum(ts.prob * vals))
        if total < upper:
            upper = total
            x_best = x.copy()
        if upper - lower <= tol * (1.0 + abs(upper)):
            break
        # aggregated optimality cut:
        #   theta >= sum_s p_s [ pi_s'(h_s - T_s x) ]
        #   =>  (sum_s p_s pi_s' T_s) x + theta >= sum_s p_s pi_s' h_s
        gT = np.einsum("s,sm,smn->n", ts.prob, pi, ts.T)
        rhs = float(np.einsum("s,sm,sm->", ts.prob, pi, ts.h))
        cut = np.concatenate([gT, [1.0]])
        master.add_rows(sp.csc_matrix(cut.reshape(1, -1)), lower=[rhs], upper=[INF])

    sol = Solution(
        status=ProblemStatus.OPTIMAL
        if upper - lower <= tol * (1.0 + abs(upper))
        else ProblemStatus.STOPPED,
        objective_value=upper,
        primal=x_best,
        iterations=it + 1,
    )
    return sol, x_best


def dantzig_wolfe(
    blocks: Sequence[Model],
    linking: Sequence[sp.spmatrix],
    link_lower: np.ndarray,
    link_upper: np.ndarray,
    options: Optional[SolveOptions] = None,
    max_iterations: int = 200,
    tol: float = 1e-7,
) -> Solution:
    """Dantzig-Wolfe column generation over block-angular structure.

        min sum_k c_k' x_k
        s.t. link_lower <= sum_k L_k x_k <= link_upper   (linking rows)
             x_k feasible for block k (its own Model constraints/bounds)

    Master = convex combinations of generated block vertices; subproblems
    are priced copies of each block. Requires bounded blocks (extreme rays
    are not generated)."""
    options = options or SolveOptions()
    K = len(blocks)
    mL = link_lower.size
    sub_opts = _sub_options(options)

    # initial columns: each block's own optimum ignoring the linking rows
    vertices: list[list[np.ndarray]] = [[] for _ in range(K)]
    for k, b in enumerate(blocks):
        s = b.initial_solve(sub_opts)
        if s.status != ProblemStatus.OPTIMAL:
            raise DecompositionError(f"block {k} infeasible/unbounded: {s.status}")
        vertices[k].append(np.asarray(s.primal))

    best = None
    for it in range(max_iterations):
        # master over vertex weights: one column [L_k v; e_k] per vertex
        cols, costs = [], []
        for k in range(K):
            ck = blocks[k].objective * (blocks[k].optimization_direction or 1.0)
            for v in vertices[k]:
                cols.append(np.concatenate([np.asarray(linking[k] @ v).ravel(), np.eye(K)[k]]))
                costs.append(float(ck @ v))
        # big-M artificials on the linking rows keep the restricted master
        # feasible while the vertex pool is small (the reference's DW does
        # the same with artificial columns)
        big = 1e6 * (1.0 + max(abs(c) for c in costs))
        art = np.vstack([np.eye(mL), np.zeros((K, mL))])
        Am = sp.csc_matrix(np.column_stack(
            cols + [art[:, i] for i in range(mL)] + [-art[:, i] for i in range(mL)]))
        master = Model()
        master.load_problem(
            Am,
            col_lower=np.zeros(Am.shape[1]),
            col_upper=np.full(Am.shape[1], INF),
            objective=np.concatenate([np.array(costs), np.full(2 * mL, big)]),
            row_lower=np.concatenate([link_lower, np.ones(K)]),
            row_upper=np.concatenate([link_upper, np.ones(K)]),
        )
        msol = master.initial_solve(sub_opts)
        if msol.status != ProblemStatus.OPTIMAL:
            raise DecompositionError(f"DW master: {msol.status}")
        y = np.asarray(msol.duals[:mL])  # linking duals
        mu = np.asarray(msol.duals[mL:])  # convexity duals

        # price subproblems: min (c_k - L_k' y)' x over block k
        new_any = False
        for k in range(K):
            b = blocks[k].copy()
            sense = b.optimization_direction or 1.0
            b.objective = b.objective * sense - np.asarray(linking[k].T @ y).ravel()
            b.optimization_direction = 1.0
            s = b.initial_solve(sub_opts)
            if s.status != ProblemStatus.OPTIMAL:
                raise DecompositionError(f"pricing block {k}: {s.status}")
            rc = s.objective_value - mu[k]
            if rc < -tol * (1 + abs(mu[k])):
                vertices[k].append(np.asarray(s.primal))
                new_any = True
        best = msol
        if not new_any:
            break

    # x per block from the vertex weights (the final master was built from
    # the final vertex lists in (k, vertex) order)
    w = np.asarray(best.primal)
    art_use = float(np.abs(w[-2 * mL:]).max(initial=0.0)) if mL else 0.0
    xs = []
    pos = 0
    for k in range(K):
        nk = len(vertices[k])
        xk = np.zeros(blocks[k].num_cols)
        for v, wi in zip(vertices[k], w[pos:pos + nk]):
            xk += wi * v
        xs.append(xk)
        pos += nk
    status = best.status
    if art_use > 1e-7:
        status = ProblemStatus.PRIMAL_INFEASIBLE  # linking rows unsatisfiable
    return Solution(
        status=status,
        objective_value=best.objective_value,
        primal=np.concatenate(xs),
        duals=best.duals,
        iterations=it + 1,
    )
