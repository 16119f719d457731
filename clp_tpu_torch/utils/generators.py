"""Programmatic LP generators for tests and benchmarks.

Mirrors the reference's generator-based test pattern
(test/test_racing_lp.cpp): N-Queens LP relaxation, TSP MTZ relaxation, an
infeasible LP, plus random dense/sparse LPs with known feasibility.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..constants import INF
from ..model import Model


def nqueens_lp(n: int) -> Model:
    """LP relaxation of n-queens (maximize placed queens).

    Variables x[i,j] in [0,1]; each row/col sum <= 1; each diagonal sum <= 1;
    maximize sum x. Optimal LP value is n (place 1/k fractionally).
    """
    nv = n * n
    rows = []

    def idx(i, j):
        return i * n + j

    for i in range(n):
        rows.append([idx(i, j) for j in range(n)])
    for j in range(n):
        rows.append([idx(i, j) for i in range(n)])
    for d in range(-(n - 1), n):
        diag = [idx(i, i - d) for i in range(n) if 0 <= i - d < n]
        if len(diag) > 1:
            rows.append(diag)
    for d in range(2 * n - 1):
        anti = [idx(i, d - i) for i in range(n) if 0 <= d - i < n]
        if len(anti) > 1:
            rows.append(anti)
    m = len(rows)
    ai, aj = [], []
    for r, cols in enumerate(rows):
        for c in cols:
            ai.append(r)
            aj.append(c)
    A = sp.coo_matrix((np.ones(len(ai)), (ai, aj)), shape=(m, nv)).tocsc()
    model = Model()
    model.load_problem(
        A,
        col_lower=np.zeros(nv),
        col_upper=np.ones(nv),
        objective=np.ones(nv),
        row_lower=np.full(m, -INF),
        row_upper=np.ones(m),
    )
    model.set_maximize()
    return model


def infeasible_lp() -> Model:
    """x1 + x2 <= 1, x1 + x2 >= 3, x >= 0 — plainly infeasible."""
    A = sp.csc_matrix(np.array([[1.0, 1.0], [1.0, 1.0]]))
    model = Model()
    model.load_problem(
        A,
        col_lower=[0, 0],
        col_upper=[INF, INF],
        objective=[1.0, 2.0],
        row_lower=[-INF, 3.0],
        row_upper=[1.0, INF],
    )
    return model


def unbounded_lp() -> Model:
    """min -x1, x1 - x2 <= 1, x >= 0 — unbounded below."""
    A = sp.csc_matrix(np.array([[1.0, -1.0]]))
    model = Model()
    model.load_problem(
        A,
        col_lower=[0, 0],
        col_upper=[INF, INF],
        objective=[-1.0, 0.0],
        row_lower=[-INF],
        row_upper=[1.0],
    )
    return model


def random_lp(m: int, n: int, seed: int = 0, density: float = 0.3,
              equality_frac: float = 0.3) -> Model:
    """Random feasible bounded LP with a known interior feasible point."""
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, random_state=rng, data_rvs=rng.standard_normal)
    A = A.tocsc()
    # ensure no empty rows/cols
    A = A.tolil()
    for i in range(m):
        if A.rows[i] == []:
            A[i, rng.integers(n)] = rng.standard_normal() + 1.0
    AT = A.T
    for j in range(n):
        if AT.rows[j] == []:
            A[rng.integers(m), j] = rng.standard_normal() + 1.0
    A = A.tocsc()
    x_feas = rng.uniform(0.5, 1.5, n)
    ax = A @ x_feas
    eq = rng.uniform(size=m) < equality_frac
    slack = rng.uniform(0.5, 2.0, m)
    rl = np.where(eq, ax, ax - slack)
    ru = np.where(eq, ax, ax + slack)
    model = Model()
    model.load_problem(
        A,
        col_lower=np.zeros(n),
        col_upper=np.full(n, 10.0),
        objective=rng.standard_normal(n),
        row_lower=rl,
        row_upper=ru,
    )
    return model


def staircase_lp(nblocks=8, bm=25, bn=40, seed=0) -> Model:
    """Netlib-like staircase structure: diagonal blocks + coupling columns
    (the pilot87/dfl001 shape class — the structure the bench's honest
    baseline comparison runs on, next to the random instance)."""
    rng = np.random.default_rng(seed)
    m, n = nblocks * bm, nblocks * bn
    rows, cols, vals = [], [], []
    for k in range(nblocks):
        r0, c0 = k * bm, k * bn
        B = sp.random(bm, bn, density=0.1, random_state=rng,
                      data_rvs=rng.standard_normal).tocoo()
        rows += list(r0 + B.row)
        cols += list(c0 + B.col)
        vals += list(B.data)
        if k + 1 < nblocks:
            C = sp.random(bm, 8, density=0.4, random_state=rng,
                          data_rvs=rng.standard_normal).tocoo()
            rows += list(r0 + C.row)
            cols += list((k + 1) * bn + C.col)
            vals += list(C.data)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsc()
    d = np.asarray(abs(A).sum(axis=1)).ravel()
    A = A.tolil()
    for i in np.flatnonzero(d == 0):
        A[i, rng.integers(n)] = 1.0
    A = A.tocsc()
    x_feas = rng.uniform(0.5, 1.5, n)
    ax = A @ x_feas
    eq = rng.uniform(size=m) < 0.3
    slack = rng.uniform(0.5, 2.0, m)
    model = Model()
    model.load_problem(
        A, np.zeros(n), np.full(n, 10.0), rng.standard_normal(n),
        np.where(eq, ax, ax - slack), np.where(eq, ax, ax + slack),
    )
    return model


def transport_lp(ns: int, nd: int, seed: int = 0) -> Model:
    """Classic transportation problem (network structure, degenerate-prone)."""
    rng = np.random.default_rng(seed)
    supply = rng.uniform(5, 15, ns)
    demand = rng.uniform(5, 15, nd)
    demand *= supply.sum() / demand.sum()
    cost = rng.uniform(1, 10, (ns, nd))
    nv = ns * nd
    ai, aj, av = [], [], []
    for i in range(ns):
        for j in range(nd):
            v = i * nd + j
            ai.append(i)
            aj.append(v)
            av.append(1.0)
            ai.append(ns + j)
            aj.append(v)
            av.append(1.0)
    A = sp.coo_matrix((av, (ai, aj)), shape=(ns + nd, nv)).tocsc()
    model = Model()
    model.load_problem(
        A,
        col_lower=np.zeros(nv),
        col_upper=np.full(nv, INF),
        objective=cost.ravel(),
        row_lower=np.concatenate([-np.full(ns, INF), demand]),
        row_upper=np.concatenate([supply, np.full(nd, INF)]),
    )
    return model
