"""Port parity of dynamic.py and colgen.py: `dynamic_simplex_solve` over an
explicit universe and over the generated cutting-stock source of
tests/test_dynamic.py, and `column_generation` on the cutting-stock master
of tests/test_colgen.py, each with device="cpu" against the JAX package:
status, objective, rounds and swaps."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clp_tpu
from clp_tpu.colgen import column_generation as jax_column_generation
from clp_tpu.dynamic import ExplicitColumnSource as JaxExplicitSource
from clp_tpu.dynamic import dynamic_simplex_solve as jax_dynamic
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch.colgen import column_generation
from clp_tpu_torch.constants import INF, ProblemStatus, SolveMethod
from clp_tpu_torch.dynamic import ExplicitColumnSource, dynamic_simplex_solve
from tests.test_dynamic import _CuttingStockSource
from tests.test_mps import _linprog
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _assert_same(got, want):
    (sg, ig), (sj, ij) = got, want
    assert int(sg.status) == int(sj.status) == int(ProblemStatus.OPTIMAL)
    assert abs(sg.objective_value - sj.objective_value) <= 1e-9 * (
        1 + abs(sj.objective_value))
    assert sg.iterations == sj.iterations
    for k in ("rounds", "swaps", "working_set", "proved_optimal_over_universe"):
        assert ig[k] == ij[k], k
    np.testing.assert_array_equal(ig["ids"], ij["ids"])


def _wide(seed=11):
    model = jgen.random_lp(8, 120, seed=seed, density=0.4)
    model.col_lower = np.zeros(model.num_cols)  # colgen convention: l = 0
    model.col_upper = np.full(model.num_cols, 50.0)
    return model


@pytest.mark.parametrize("working_set", [30, 16])
def test_explicit_universe_matches_jax(working_set):
    """The wide LP of tests/test_dynamic.py; both working sets saturate and
    take the grow path."""
    model = _wide()
    args = (model.matrix, model.objective, model.col_lower, model.col_upper)
    want = jax_dynamic(model.row_lower, model.row_upper, JaxExplicitSource(*args),
                       working_set=working_set)
    got = dynamic_simplex_solve(model.row_lower, model.row_upper,
                                ExplicitColumnSource(*args), working_set=working_set,
                                options=clp_tpu_torch.SolveOptions(device="cpu"))
    _assert_same(got, want)
    ref = _linprog(model)
    assert abs(got[0].objective_value - ref.fun) < 1e-6 * (1 + abs(ref.fun))
    assert got[1]["swaps"] > 0
    assert got[1]["working_set"] > working_set  # grew


def test_infeasible_start_stops_as_in_jax():
    """The 12 cheapest columns of the wide LP leave it infeasible: both
    packages stop there, PRIMAL_INFEASIBLE, without pricing a phase 1 and
    without claiming the universe (ROADMAP.md queue 3)."""
    model = _wide()
    args = (model.matrix, model.objective, model.col_lower, model.col_upper)
    sj, ij = jax_dynamic(model.row_lower, model.row_upper, JaxExplicitSource(*args),
                         working_set=12)
    st, it = dynamic_simplex_solve(model.row_lower, model.row_upper,
                                   ExplicitColumnSource(*args), working_set=12,
                                   options=clp_tpu_torch.SolveOptions(device="cpu"))
    assert int(st.status) == int(sj.status) == int(ProblemStatus.PRIMAL_INFEASIBLE)
    assert it["rounds"] == ij["rounds"] == 1 and it["swaps"] == ij["swaps"] == 0
    assert not it["proved_optimal_over_universe"] and not ij["proved_optimal_over_universe"]


CUTTING_STOCK = {
    "classic": ([45, 36, 31, 14], 100, [97.0, 610.0, 395.0, 211.0], 12),
    "eight": ([23, 31, 37, 41, 47, 53, 61, 67], 150,
              [40.0, 25.0, 33.0, 18.0, 51.0, 12.0, 20.0, 9.0], 16),
}


@pytest.mark.parametrize("case", sorted(CUTTING_STOCK))
def test_cutting_stock_source_matches_jax(case):
    """The generated Gilmore-Gomory source (patterns from a DP knapsack on
    the duals, never enumerated): the same rounds, swaps and LP bound."""
    widths, roll, demands, ws = CUTTING_STOCK[case]
    demands = np.asarray(demands)
    m = len(widths)
    want = jax_dynamic(demands, np.full(m, INF), _CuttingStockSource(widths, roll, demands),
                       working_set=ws)
    got = dynamic_simplex_solve(demands, np.full(m, INF),
                                _CuttingStockSource(widths, roll, demands), working_set=ws,
                                options=clp_tpu_torch.SolveOptions(device="cpu"))
    _assert_same(got, want)
    assert got[1]["proved_optimal_over_universe"]


def knapsack_pricer(widths, W, rounds: list):
    """tests/test_colgen.py's pricer (max duals'a s.t. widths'a <= W, a
    integer >= 0) by dynamic programming over the integer widths instead
    of the JAX package's `mip.fathom`; it counts its calls in `rounds`."""
    widths = np.asarray(widths, dtype=np.int64)

    def pricer(duals):
        rounds.append(1)
        best = np.zeros(W + 1)
        take = np.full(W + 1, -1)
        for cap in range(1, W + 1):
            best[cap] = best[cap - 1]
            for i, w in enumerate(widths):
                if w <= cap and best[cap - w] + duals[i] > best[cap] + 1e-12:
                    best[cap], take[cap] = best[cap - w] + duals[i], i
        pat, cap = np.zeros(len(widths)), W
        while cap > 0:
            if take[cap] < 0:
                cap -= 1
            else:
                pat[take[cap]] += 1
                cap -= widths[take[cap]]
        if best[W] > 1.0 + 1e-7:  # reduced cost 1 - duals'a < 0
            return [(pat, 1.0, 0.0, INF)]
        return []

    return pricer


def cutting_stock_master(lib, widths, demand, W):
    """Single-width starting patterns, as tests/test_colgen.py builds them."""
    widths = np.asarray(widths, dtype=np.float64)
    master = lib.Model()
    master.load_problem(sp.csc_matrix(np.diag(np.floor(W / widths))),
                        col_lower=np.zeros(len(widths)),
                        col_upper=np.full(len(widths), INF), objective=np.ones(len(widths)),
                        row_lower=np.asarray(demand, dtype=np.float64),
                        row_upper=np.full(len(widths), INF))
    return master


def test_column_generation_matches_jax():
    """`column_generation` with the same pricer in both packages on
    tests/test_colgen.py's instance: the same rounds, columns and objective,
    its known optimum 36. (The JAX package compiles its master anew at
    every round's shape, so the larger instance runs in the port only,
    below.)"""
    widths, demand, W = [3, 4, 5], [44.0, 30.0, 20.0], 10
    rj, rt = [], []
    mj = cutting_stock_master(clp_tpu, widths, demand, W)
    mt = cutting_stock_master(clp_tpu_torch, widths, demand, W)
    want = jax_column_generation(mj, knapsack_pricer(widths, W, rj))
    got = column_generation(
        mt, knapsack_pricer(widths, W, rt),
        clp_tpu_torch.SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device="cpu"))
    assert int(got.status) == int(want.status) == int(ProblemStatus.OPTIMAL)
    assert abs(got.objective_value - want.objective_value) <= 1e-9 * (
        1 + abs(want.objective_value))
    assert len(rt) == len(rj) and mt.num_cols == mj.num_cols
    assert (mt.matrix != mj.matrix).nnz == 0
    assert abs(got.objective_value - 36.0) < 1e-6


def test_column_generation_and_dynamic_agree():
    """The two routes to one cutting-stock LP relaxation: the same bound."""
    widths, roll, demand, ws = CUTTING_STOCK["eight"]
    demand = np.asarray(demand)
    opts = clp_tpu_torch.SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device="cpu")
    cg = column_generation(cutting_stock_master(clp_tpu_torch, widths, demand, roll),
                           knapsack_pricer(widths, roll, []), opts)
    dyn, info = dynamic_simplex_solve(demand, np.full(len(widths), INF),
                                      _CuttingStockSource(widths, roll, demand),
                                      working_set=ws,
                                      options=clp_tpu_torch.SolveOptions(device="cpu"))
    assert cg.status == dyn.status == ProblemStatus.OPTIMAL
    assert abs(cg.objective_value - dyn.objective_value) <= 1e-7 * (
        1 + abs(cg.objective_value))


def test_swaps_leave_earlier_tensors_untouched():
    """A swap builds new LP tensors: a tensor taken before it keeps its
    values (no engine state aliases a tensor a later swap changes)."""
    from clp_tpu_torch.simplex import engine

    seen = []
    orig = engine.primal_chunk

    def spy(lp, state, opts):
        seen.append((lp.G, lp.G.clone()))
        return orig(lp, state, opts)

    model = _wide()
    try:
        engine.primal_chunk = spy
        _, info = dynamic_simplex_solve(
            model.row_lower, model.row_upper,
            ExplicitColumnSource(model.matrix, model.objective, model.col_lower,
                                 model.col_upper),
            working_set=30, options=clp_tpu_torch.SolveOptions(device="cpu"))
    finally:
        engine.primal_chunk = orig
    assert info["swaps"] > 0 and len({id(g) for g, _ in seen}) > 1
    for G, copy in seen:
        assert torch.equal(G, copy)
