"""Port parity for the AUTOMATIC method choice: `_auto_method`, `_auto_idiot`
and the GUB and two-stage detection it reads return what the JAX package's
do on the same LPs; `initial_solve` then gives the JAX package's status and
objective on each destination (NETWORK, GUB, SPRINT, the idiot-warm dual,
the dualize of a tall LP, and DECOMPOSE)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clp_tpu
from clp_tpu.gub import detect_gub as jax_detect_gub
from clp_tpu.solve import _auto_idiot as jax_auto_idiot, _auto_method as jax_auto_method
from clp_tpu.structure import detect_two_stage as jax_detect_two_stage
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch import solve as tsolve
from clp_tpu_torch.gub import detect_gub
from clp_tpu_torch.structure import detect_two_stage
from tests.test_decompose import _flat_two_stage
from tests.test_gub import make_gub_lp
from tests.test_network import make_mcf
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _port_model(mj):
    mt = clp_tpu_torch.Model()
    mt.load_problem(mj.matrix, mj.col_lower, mj.col_upper, mj.objective,
                    mj.row_lower, mj.row_upper)
    mt.optimization_direction = mj.optimization_direction
    mt.objective_offset = mj.objective_offset
    return mt


def _covering_lp(m=256, n=1600, seed=0):
    """A 0/1 covering LP, wide and unit-valued: the idiot crash's shape."""
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=0.01, random_state=seed, format="csc")
    A.data[:] = 1.0
    A = (A + sp.csc_matrix((np.ones(n), (rng.integers(0, m, n), np.arange(n))),
                           shape=(m, n))).tocsc()
    A.data[:] = 1.0
    mj = clp_tpu.Model()
    mj.load_problem(A, np.zeros(n), np.ones(n), rng.integers(1, 5, n).astype(float),
                    np.ones(m), np.full(m, clp_tpu.INF))
    return mj


LPS = {
    "network": (lambda: make_mcf(15, 40, 3)[0], "NETWORK", "network.py"),
    "gub": (lambda: make_gub_lp(K=100, per=8, mg=20, seed=7), "GUB", "gub.py"),
    "two_stage": (lambda: _flat_two_stage()[1], "DECOMPOSE", "decompose.py"),
    "wide": (lambda: jgen.random_lp(100, 2100, seed=1, density=0.05), "SPRINT", "sprint.py"),
    "covering": (_covering_lp, "DUAL_SIMPLEX", "crash.py"),
    "general": (lambda: jgen.random_lp(40, 70, seed=3, density=0.3), "BARRIER", None),
}


@pytest.mark.parametrize("name", sorted(LPS))
def test_auto_method_matches_jax(name):
    make, expect, _ = LPS[name]
    mj = make()
    mt = _port_model(mj)
    choice = tsolve._auto_method(mt, clp_tpu_torch.SolveOptions(device="cpu"))
    assert choice.name == jax_auto_method(mj, clp_tpu.SolveOptions()).name == expect
    assert tsolve._auto_idiot(mt) == jax_auto_idiot(mj)


@pytest.mark.parametrize("name", sorted(n for n, v in LPS.items() if v[2]))
def test_unported_auto_destination_raises_naming_it(name):
    """Each AUTOMATIC destination the JAX package routes to: the port gives
    its status and objective (1e-9 relative). (The name is from when every
    case raised; DECOMPOSE was the last, until its port.)"""
    make, expect, item = LPS[name]
    mj = make()
    mt = _port_model(mj)
    opts = clp_tpu_torch.SolveOptions(device="cpu")
    opts.presolve.enabled = False  # the choice is made on the LP as given
    oj = clp_tpu.SolveOptions()
    oj.presolve.enabled = False
    sj = clp_tpu.initial_solve(mj, oj)
    st = clp_tpu_torch.initial_solve(mt, opts)
    assert int(st.status) == int(sj.status) == int(clp_tpu.ProblemStatus.OPTIMAL)
    assert abs(st.objective_value - sj.objective_value) <= 1e-9 * abs(sj.objective_value)


@pytest.mark.parametrize("kw, shape", [
    ({}, (2400, 300)),
    ({"dualize": 1}, (30, 20)),
], ids=["auto-tall", "explicit"])
def test_dualize_matches_jax(kw, shape):
    """A tall LP (m > 6n, m > 2000) goes through its dual under AUTOMATIC,
    and any LP under dualize=1; the primal is restored from the dual's
    solution. The same status and objective as the JAX package. Every row
    is ranged (equality_frac=0): an equality row's dual is a free variable
    split in two, both of which the sub-solves of the dual's SPRINT may park
    at the 1e10 fake bound, and the restored duals then miss the KKT check
    at 1e-6 in both packages."""
    mj = jgen.random_lp(*shape, seed=0, density=0.01 if shape[0] > 2000 else 0.3,
                        equality_frac=0.0)
    mt = _port_model(mj)
    sj = clp_tpu.initial_solve(mj, clp_tpu.SolveOptions(**kw))
    st = clp_tpu_torch.initial_solve(mt, clp_tpu_torch.SolveOptions(device="cpu", **kw))
    assert int(st.status) == int(sj.status) == int(clp_tpu.ProblemStatus.OPTIMAL)
    assert abs(st.objective_value - sj.objective_value) <= 1e-9 * abs(sj.objective_value)
    assert clp_tpu_torch.check_kkt(mt, x=st.primal, y=st.duals, tol=1e-6).ok


def test_dualize_matches_jax_arrays():
    """dualize and restore_from_dual are numpy copies: the same dual model
    and mapping, and the same primal restored from one dual solution."""
    from clp_tpu.analysis import dualize as jax_dualize, restore_from_dual as jax_restore

    from clp_tpu_torch.analysis import dualize, restore_from_dual

    mj = jgen.random_lp(12, 8, seed=4)
    mj.col_upper = mj.col_upper.copy()
    mj.col_upper[0] = mj.col_lower[0]  # a fixed column: both dual parts
    mt = _port_model(mj)
    dj, mapj = jax_dualize(mj)
    dt, mapt = dualize(mt)
    assert mapt == mapj
    assert (dt.matrix != dj.matrix).nnz == 0
    for f in ("objective", "col_lower", "col_upper", "row_lower", "row_upper"):
        np.testing.assert_array_equal(getattr(dt, f), getattr(dj, f))
    sol = clp_tpu.initial_solve(dj, clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.DUAL_SIMPLEX))
    dt.solution = clp_tpu_torch.Solution(status=clp_tpu_torch.ProblemStatus.OPTIMAL,
                                         primal=sol.primal, duals=sol.duals,
                                         iterations=sol.iterations)
    jax_restore(mj, dj, mapj)
    restore_from_dual(mt, dt, mapt)
    np.testing.assert_array_equal(mt.solution.primal, mj.solution.primal)
    np.testing.assert_array_equal(mt.solution.duals, mj.solution.duals)
    assert mt.solution.objective_value == mj.solution.objective_value


def test_card_branch_picks_the_dual_simplex_from_512_rows(monkeypatch):
    """The JAX package's TPU branch: from m >= 512 rows on the accelerator
    AUTOMATIC takes the dual simplex, elsewhere the barrier. The port asks
    whether the solve runs on the card (resolved here without one)."""
    mj = jgen.random_lp(512, 900, seed=2, density=0.02)
    mt = _port_model(mj)
    assert jax_auto_method(mj, clp_tpu.SolveOptions()).name == "BARRIER"
    assert tsolve._auto_method(mt, clp_tpu_torch.SolveOptions(device="cpu")).name == "BARRIER"
    monkeypatch.setattr(tsolve, "resolve_device", torch.device)
    card = clp_tpu_torch.SolveOptions(device="cuda")
    assert tsolve._auto_method(mt, card).name == "DUAL_SIMPLEX"
    small = _port_model(jgen.random_lp(40, 70, seed=3, density=0.3))
    assert tsolve._auto_method(small, card).name == "BARRIER"


def test_gub_and_two_stage_detection_match_jax():
    mj = make_gub_lp(K=30, per=5, mg=6, seed=3)
    sj, st = jax_detect_gub(mj), detect_gub(_port_model(mj))
    assert [(s.row, s.lower, s.upper) for s in st] == [(s.row, s.lower, s.upper) for s in sj]
    assert all(np.array_equal(a.cols, b.cols) for a, b in zip(st, sj))
    _, flat = _flat_two_stage()
    dj, dt = jax_detect_two_stage(flat), detect_two_stage(_port_model(flat))
    assert dt is not None and dj is not None
    np.testing.assert_array_equal(dt.x_cols, dj.x_cols)
    np.testing.assert_array_equal(dt.stage1_rows, dj.stage1_rows)
    assert len(dt.scenario_rows) == len(dj.scenario_rows)
    for a, b in zip(dt.scenario_rows + dt.scenario_cols, dj.scenario_rows + dj.scenario_cols):
        np.testing.assert_array_equal(a, b)
    general = jgen.random_lp(96, 160, seed=0)
    assert detect_two_stage(_port_model(general)) is None is jax_detect_two_stage(general)
