"""Network LPs: arc extraction + spanning-tree-basis network simplex.

Reference components covered (see SURVEY.md §2):
  - ClpNetworkMatrix.hpp:12-16 — a matrix whose columns each have one +1
    and one -1 entry (pure network / min-cost-flow).
  - ClpNetworkBasis.* — a basis "factorization" that is a spanning tree:
    FTRAN/BTRAN are tree walks and the update is a re-rooting, with no LU
    at all.

Port of the JAX package's network.py: host-side numpy, a copy, as the
JAX package runs it on the host too. The *pricing* of network LPs on the
device is the dense engines' multiply-free path
(`SimplexOptions.price_mode="pm1"`, simplex/engine.py). This module is an
integer-arithmetic spanning-tree simplex whose per-pivot cost is O(cycle
length) + one O(nodes) potential refresh, with no factorization anywhere.
It is the direct analogue
of the reference's ClpNetworkBasis (no-LU basis) and is dramatically faster
per pivot than any factorized path for pure networks.

The standard form [A | -I] v = 0 is turned into a pure network by adding a
virtual root node: a column missing a +1 (or -1) entry gets the root as its
counterpart, so every arc is a doubleton and flow conservation at the root
holds by construction.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from .constants import INF, ProblemStatus, SecondaryStatus
from .model import Model, Solution

_TOL = 1e-9

# arc statuses
_AT_LOWER = 0
_AT_UPPER = 1
_TREE = 2
_FREE = 3


@dataclasses.dataclass
class NetworkForm:
    """Rooted arc-list form of a network LP (root node index = n_real)."""

    pos: np.ndarray  # int32[na]  node receiving +x
    neg: np.ndarray  # int32[na]  node receiving -x
    cost: np.ndarray  # f64[na]
    lo: np.ndarray  # f64[na]
    up: np.ndarray  # f64[na]
    n_struct: int  # first n_struct arcs are the model's columns
    n_nodes: int  # real nodes (rows); root is index n_nodes
    sense: float


def network_form(model: Model) -> Optional[NetworkForm]:
    """Extract arcs from a Model, or None if it is not a network.

    A column qualifies if it has at most one +1 and at most one -1 and no
    other entries (ClpNetworkMatrix semantics, singletons rooted).
    """
    A = model.matrix.tocsc()
    m, n = A.shape
    pos = np.full(n + m, m, dtype=np.int64)
    neg = np.full(n + m, m, dtype=np.int64)
    indptr, indices, data = A.indptr, A.indices, A.data
    for j in range(n):
        s, e = indptr[j], indptr[j + 1]
        if e - s > 2:
            return None
        for k in range(s, e):
            v = data[k]
            if v == 1.0:
                if pos[j] != m:
                    return None
                pos[j] = indices[k]
            elif v == -1.0:
                if neg[j] != m:
                    return None
                neg[j] = indices[k]
            elif v != 0.0:
                return None
    # slack arcs: column -e_i with bounds = row bounds (to_standard_form)
    for i in range(m):
        neg[n + i] = i
    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0
    lo = np.concatenate([model.col_lower, model.row_lower]).astype(float)
    up = np.concatenate([model.col_upper, model.row_upper]).astype(float)
    lo = np.where(lo <= -INF, -np.inf, lo)
    up = np.where(up >= INF, np.inf, up)
    cost = np.concatenate([model.objective * sense, np.zeros(m)])
    return NetworkForm(
        pos=pos.astype(np.int64),
        neg=neg.astype(np.int64),
        cost=cost,
        lo=lo,
        up=up,
        n_struct=n,
        n_nodes=m,
        sense=sense,
    )


class _Tree:
    """Spanning tree over nn+1 nodes (root = nn). parent[root] = -1."""

    def __init__(self, nn: int):
        self.nn = nn
        self.parent = np.full(nn + 1, -1, dtype=np.int64)
        self.parc = np.full(nn + 1, -1, dtype=np.int64)  # arc to parent
        self.depth = np.zeros(nn + 1, dtype=np.int64)

    def path_to_join(self, a: int, b: int):
        """Nodes a..join and b..join (join excluded from neither list's end).

        Returns (steps_a, steps_b, join) where steps_* are lists of
        (node, parent_arc) hops walked upward.
        """
        pa, pb = [], []
        da, db = self.depth[a], self.depth[b]
        while da > db:
            pa.append((a, self.parc[a]))
            a = self.parent[a]
            da -= 1
        while db > da:
            pb.append((b, self.parc[b]))
            b = self.parent[b]
            db -= 1
        while a != b:
            pa.append((a, self.parc[a]))
            pb.append((b, self.parc[b]))
            a = self.parent[a]
            b = self.parent[b]
        return pa, pb, a

    def refresh(self, cost, pos, neg, y):
        """Recompute depth + potentials from the parent array (BFS).

        Tree arcs have zero reduced cost: c_a - y[pos_a] + y[neg_a] = 0.
        """
        nn = self.nn
        children = [[] for _ in range(nn + 1)]
        for v in range(nn):
            p = self.parent[v]
            if p >= 0:
                children[p].append(v)
        y[nn] = 0.0
        self.depth[nn] = 0
        stack = [nn]
        seen = 1
        while stack:
            u = stack.pop()
            for v in children[u]:
                a = self.parc[v]
                self.depth[v] = self.depth[u] + 1
                if pos[a] == v:
                    y[v] = y[u] + cost[a]
                else:
                    y[v] = y[u] - cost[a]
                stack.append(v)
                seen += 1
        return seen == nn + 1


def network_simplex(net: NetworkForm, max_iterations: int = 0,
                    tol: float = 1e-9):
    """Primal network simplex with arc bounds and big-M artificial star.

    Pricing is vectorized Dantzig over all arcs; the basis is the spanning
    tree itself (no factorization — ClpNetworkBasis analogue). Returns
    (x, y, dj, status, iterations) in the rooted arc space.
    """
    pos0, neg0, cost0 = net.pos, net.neg, net.cost
    lo0, up0 = net.lo, net.up
    nn = net.n_nodes
    root = nn
    na0 = pos0.size
    if max_iterations <= 0:
        max_iterations = 50 * (nn + na0) + 10000

    big_m = 2.0 * (1.0 + np.sum(np.abs(cost0[np.isfinite(cost0)]))) * max(
        1.0, np.max(np.abs(np.concatenate([
            lo0[np.isfinite(lo0)], up0[np.isfinite(up0)], [1.0]])))
    )

    # initial nonbasic values: finite bound nearest zero, else 0 (free)
    x0 = np.where(
        np.isfinite(lo0),
        np.where(np.isfinite(up0), np.where(np.abs(lo0) <= np.abs(up0), lo0, up0), lo0),
        np.where(np.isfinite(up0), up0, 0.0),
    )
    stat0 = np.where(
        np.isfinite(lo0) & (x0 == lo0), _AT_LOWER,
        np.where(np.isfinite(up0) & (x0 == up0), _AT_UPPER, _FREE),
    )

    # node excess after nonbasic placement; artificial star absorbs it
    excess = np.zeros(nn + 1)
    np.add.at(excess, pos0, x0)
    np.add.at(excess, neg0, -x0)
    need = -excess[:nn]  # contribution the artificial at node i must add
    art_pos = np.where(need >= 0, np.arange(nn), root)
    art_neg = np.where(need >= 0, root, np.arange(nn))

    pos = np.concatenate([pos0, art_pos])
    neg = np.concatenate([neg0, art_neg])
    cost = np.concatenate([cost0, np.full(nn, big_m)])
    lo = np.concatenate([lo0, np.zeros(nn)])
    up = np.concatenate([up0, np.full(nn, np.inf)])
    x = np.concatenate([x0, np.abs(need)])
    stat = np.concatenate([stat0, np.full(nn, _TREE)]).astype(np.int64)
    na = pos.size
    is_art = np.arange(na) >= na0

    tree = _Tree(nn)
    tree.parent[:nn] = root
    tree.parc[:nn] = na0 + np.arange(nn)
    y = np.zeros(nn + 1)
    tree.refresh(cost, pos, neg, y)

    status = ProblemStatus.UNKNOWN
    iters = 0
    stall = 0
    last_obj = np.inf
    rng = np.random.default_rng(12345)
    perturb = np.zeros(na)

    while iters < max_iterations:
        dj = (cost + perturb) - y[pos] + y[neg]
        at_lo = stat == _AT_LOWER
        at_up = stat == _AT_UPPER
        at_fr = stat == _FREE
        fixed = lo == up
        viol = np.where(
            at_lo & ~fixed, np.maximum(-dj, 0.0),
            np.where(at_up & ~fixed, np.maximum(dj, 0.0),
                     np.where(at_fr, np.abs(dj), 0.0)),
        )
        q = int(np.argmax(viol))
        if viol[q] <= tol * (1.0 + big_m * 0.0 + np.abs(cost[q])) + tol:
            status = ProblemStatus.OPTIMAL
            break
        sigma = 1.0 if (at_lo[q] or (at_fr[q] and dj[q] < 0)) else -1.0

        # cycle: entering arc + tree path pos_q .. neg_q
        pa, pb, _join = tree.path_to_join(int(pos[q]), int(neg[q]))
        cycle = [(q, 1.0)]
        for v, a in pa:  # pos-side: compensation flows away from pos_q
            cycle.append((int(a), 1.0 if neg[a] == v else -1.0))
        for v, a in pb:  # neg-side: compensation flows toward neg_q
            cycle.append((int(a), 1.0 if pos[a] == v else -1.0))

        # ratio test: max t >= 0 with all cycle arcs inside bounds
        t_best = np.inf
        leave = -1  # cycle list index
        for ci, (a, s) in enumerate(cycle):
            d = s * sigma
            room = (up[a] - x[a]) if d > 0 else (x[a] - lo[a])
            room = max(room, 0.0)
            better = room < t_best - 1e-12
            tie = (
                leave >= 0 and np.isfinite(room) and np.isfinite(t_best)
                and abs(room - t_best) <= 1e-12
            )
            prefer = better or (
                tie and is_art[a] and not is_art[cycle[leave][0]]
            )
            if prefer:
                t_best = room
                leave = ci
        if not np.isfinite(t_best):
            status = ProblemStatus.DUAL_INFEASIBLE  # unbounded
            ray = np.zeros(na)
            for a, s in cycle:
                ray[a] = s * sigma
            x_ray = ray
            break

        for a, s in cycle:
            x[a] += s * sigma * t_best
        iters += 1

        a_out, s_out = cycle[leave]
        if a_out == q:
            # bound flip: no basis change
            stat[q] = _AT_UPPER if sigma > 0 else _AT_LOWER
        else:
            d_out = s_out * sigma
            stat[a_out] = _AT_UPPER if d_out > 0 else _AT_LOWER
            stat[q] = _TREE
            # z = deeper endpoint of the leaving arc -> subtree S(z) splits off
            pz, qz = int(pos[a_out]), int(neg[a_out])
            z = pz if tree.depth[pz] > tree.depth[qz] else qz
            # endpoint of q inside S(z): walk up from each endpoint to z
            def _in_subtree(v: int) -> bool:
                while tree.depth[v] > tree.depth[z]:
                    v = int(tree.parent[v])
                return v == z
            e_in = int(pos[q]) if _in_subtree(int(pos[q])) else int(neg[q])
            e_out = int(neg[q]) if e_in == int(pos[q]) else int(pos[q])
            # reverse parents along e_in .. z, then hang e_in on e_out via q
            v = e_in
            prev_parent, prev_arc = e_out, q
            while True:
                nxt, nxt_arc = int(tree.parent[v]), int(tree.parc[v])
                tree.parent[v] = prev_parent
                tree.parc[v] = prev_arc
                if v == z:
                    break
                prev_parent, prev_arc = v, nxt_arc
                v = nxt
            tree.refresh(cost + perturb, pos, neg, y)

        # anti-cycling: on long degenerate runs, perturb costs a little
        obj = float((cost * x).sum())
        if obj < last_obj - 1e-12 * (1 + abs(last_obj)):
            stall = 0
        else:
            stall += 1
        last_obj = obj
        if stall == 5 * (nn + 1):
            perturb = rng.uniform(0.5, 1.0, na) * tol * 100 * (1 + np.abs(cost))
            perturb[is_art] = 0.0
            tree.refresh(cost + perturb, pos, neg, y)
        elif stall == 10 * (nn + 1):
            status = ProblemStatus.STOPPED
            break
    else:
        status = ProblemStatus.STOPPED

    if perturb.any() and status == ProblemStatus.OPTIMAL:
        # re-verify without perturbation (one clean pricing pass)
        perturb = np.zeros(na)
        tree.refresh(cost, pos, neg, y)
        dj = cost - y[pos] + y[neg]

    if status == ProblemStatus.OPTIMAL and np.any(x[is_art] > 1e-7):
        status = ProblemStatus.PRIMAL_INFEASIBLE

    # clean big-M out of potentials: zero-flow basic artificials only pick
    # the potential offset of their subtree; re-cost them to 0 and refresh
    if np.any(is_art & (stat == _TREE)):
        cost2 = cost.copy()
        cost2[is_art & (stat == _TREE) & (np.abs(x) <= 1e-9)] = 0.0
        tree.refresh(cost2, pos, neg, y)
    dj = cost - y[pos] + y[neg]

    ray = x_ray if status == ProblemStatus.DUAL_INFEASIBLE else None
    return x[:na0], y[:nn], dj[:na0], status, iters, ray


def solve_network(model: Model, options=None) -> Solution:
    """Solve a network-structured Model with the spanning-tree simplex.

    Falls back to raising ValueError when the matrix is not a network —
    callers should check `network_form(model) is not None` (or
    Model.detect_structure()["network"]) first.
    """
    t0 = time.time()
    net = network_form(model)
    if net is None:
        raise ValueError("model is not a pure network (ClpNetworkMatrix shape)")
    max_it = 0
    if options is not None and getattr(options, "max_iterations", 0):
        max_it = int(options.max_iterations)
    x_all, y, dj_all, status, iters, ray = network_simplex(net, max_iterations=max_it)
    n = net.n_struct
    x = x_all[:n]
    sense = net.sense
    obj = float(model.objective @ x) + model.objective_offset
    sol = Solution(
        status=status,
        objective_value=obj,
        primal=x,
        duals=y * sense,
        reduced_costs=dj_all[:n] * sense,
        row_activity=model.matrix @ x,
        iterations=iters,
    )
    if ray is not None:
        sol.unbounded_ray = ray[:n]
        sol.secondary_status = SecondaryStatus.NONE
    sol.solve_time = time.time() - t0
    model.solution = sol
    return sol
