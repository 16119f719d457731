"""Port parity of the sparse ELL pricing, the Positive Edge pivot rules and
their random signs, and the bounded `dual_solve_rounds` (clp_tpu_torch vs
clp_tpu, CPU)."""

import dataclasses

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clp_tpu
from clp_tpu.forms import to_standard_form as jax_standard_form
from clp_tpu.simplex import engine as je
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch import convert
from clp_tpu_torch.constants import ProblemStatus, SolveMethod
from clp_tpu_torch.simplex import driver as td
from clp_tpu_torch.simplex import engine as te
from clp_tpu_torch.utils.prng import rademacher
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _fields(x) -> dict:
    return {k: (None if v is None else np.asarray(v)) for k, v in vars(x).items()}


def _pair(model):
    jlp, _ = jax_standard_form(model)
    return jlp, convert.standard_lp_from_numpy(_fields(jlp), "cpu")


def _jax_run(jlp, opts, dual=True):
    st = je.initial_state(jlp, opts)
    st = je.recompute(jlp, st, opts.dual_bound)
    if dual:
        st = je.make_dual_feasible(jlp, st, opts)
        return je.dual_solve(jlp, st, opts)
    return je.primal_solve(jlp, st, opts)


def _torch_run(tlp, opts, dual=True):
    st = te.initial_state(tlp, opts)
    st = te.recompute(tlp, st, opts.dual_bound)
    if dual:
        st = te.make_dual_feasible(tlp, st, opts)
        return te.dual_solve(tlp, st, opts)
    return te.primal_solve(tlp, st, opts)


def _obj(lp, st) -> float:
    l, u = np.asarray(lp.l), np.asarray(lp.u)
    vs = np.asarray(st.vstat)
    x = np.where(vs == 0, np.where(np.isfinite(l), l, 0.0),
                 np.where(vs == 1, np.where(np.isfinite(u), u, 0.0), 0.0))
    x[np.asarray(st.basis)] = np.asarray(st.xb)
    return float(np.asarray(lp.c) @ x)


def _same_solve(jst, tst, jlp, rel=1e-9, iterations=True):
    assert int(tst.status) == int(jst.status) == je.OPTIMAL
    oj, ot = _obj(jlp, jst), _obj(jlp, tst)
    assert abs(ot - oj) <= rel * (1 + abs(oj)), (ot, oj)
    if iterations:
        assert int(tst.iterations) == int(jst.iterations)


# --------------------------------------------------------------------------
# the random signs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("it", [0, 1, 12345])
@pytest.mark.parametrize("nt", [1, 7, 6656])
def test_rademacher_signs_bit_identical_to_jax(nt, it, dtype):
    for seed in (20210, 777):  # the dual and the primal rule's keys
        key = jax.random.fold_in(jax.random.PRNGKey(seed), np.int32(it))
        ref = np.asarray(jax.random.rademacher(key, (nt,), np.dtype(dtype)))
        got = rademacher(seed, torch.tensor(it, dtype=torch.int32), nt,
                         getattr(torch, dtype)).numpy()
        assert got.dtype == ref.dtype
        assert np.array_equal(got, ref)


# --------------------------------------------------------------------------
# ELL pricing
# --------------------------------------------------------------------------


def _ell_widths(jlp):
    Gn = np.asarray(jlp.G)
    kc = (int((Gn != 0).sum(axis=0).max()) + 7) // 8 * 8
    kr = (int((Gn != 0).sum(axis=1).max()) + 7) // 8 * 8
    return kc, kr


def test_ell_forms_match_jax():
    jlp, tlp = _pair(jgen.random_lp(96, 160, seed=13, density=0.08))
    kc, kr = _ell_widths(jlp)
    ref = je.ell_forms(jlp.G, kc, kr)
    got = te.ell_forms(tlp.G, kc, kr)
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())
    rho = torch.linspace(-1.0, 1.0, tlp.G.shape[0], dtype=torch.float64)
    dense = (rho.to(torch.float32) @ tlp.G.to(torch.float32))
    assert torch.allclose(te._ell_price(rho, got), dense, atol=1e-5)
    q = torch.tensor(7)
    assert torch.equal(te._ell_col(q, got, tlp.G.shape[0]), tlp.G[:, 7].to(torch.float32))


@pytest.mark.parametrize("ratio", ["bfrt", "harris"])
@pytest.mark.parametrize("shape", [(40, 70, 5, 0.15), (60, 100, 2, 0.1)],
                         ids=["40x70", "60x100"])
def test_ell_dual_matches_jax(shape, ratio):
    m, n, seed, dens = shape
    jlp, tlp = _pair(jgen.random_lp(m, n, seed=seed, density=dens))
    kc, kr = _ell_widths(jlp)
    kw = dict(dual_ratio=ratio, price_mode="ell", price_ell_kc=kc, price_ell_kr=kr)
    jst = _jax_run(jlp, je.SimplexOptions(**kw))
    tst = _torch_run(tlp, te.SimplexOptions(**kw))
    _same_solve(jst, tst, jlp)


# (ratio, port's ELL, JAX's ELL, port's dense f64, JAX's dense f64) pivots
_ELL_96 = [("bfrt", 188, 196, 194, 196), ("harris", 254, 239, 231, 240)]


@pytest.mark.parametrize("ratio, t_ell, j_ell, t_dense, j_dense", _ELL_96,
                         ids=[c[0] for c in _ELL_96])
def test_ell_dual_matches_jax_and_dense(ratio, t_ell, j_ell, t_dense, j_dense):
    """tests/test_simplex.py::test_ell_sparse_pricing_matches_dense, in both
    packages: the ELL solve, and the port's dense solve of the same LP.
    The pivot counts differ between the packages on this LP already in the
    dense f64 solve (ROADMAP.md queue 3, summation order): the counts are
    pinned, the status and the objective agree."""
    jlp, tlp = _pair(jgen.random_lp(96, 160, seed=13, density=0.08))
    kc, kr = _ell_widths(jlp)
    kw = dict(max_iterations=20000, dual_ratio=ratio)
    ell = dict(price_mode="ell", price_ell_kc=kc, price_ell_kr=kr)
    jst = _jax_run(jlp, je.SimplexOptions(**kw, **ell))
    tst = _torch_run(tlp, te.SimplexOptions(**kw, **ell))
    _same_solve(jst, tst, jlp, iterations=False)
    jd = _jax_run(jlp, je.SimplexOptions(**kw))
    td_ = _torch_run(tlp, te.SimplexOptions(**kw))
    _same_solve(jd, td_, jlp, iterations=False)
    assert abs(_obj(jlp, td_) - _obj(jlp, tst)) <= 1e-9 * (1 + abs(_obj(jlp, td_)))
    got = [int(s.iterations) for s in (tst, jst, td_, jd)]
    assert got == [t_ell, j_ell, t_dense, j_dense]


def test_ell_auto_choice_above_the_6gb_line():
    """The driver picks ELL by its own rule on a sparse 24,576 x 65,536 LP
    (the dense f32 standard form would be 8.9 GB), and not on a small one."""
    rng = np.random.default_rng(0)
    m, n = 24576, 65536
    rows = rng.integers(0, m, size=3 * n)
    cols = np.repeat(np.arange(n), 3)
    model = clp_tpu_torch.Model()
    model.load_problem(sp.csc_matrix((np.ones(3 * n), (rows, cols)), shape=(m, n)),
                       np.zeros(n), np.full(n, 1.0), np.ones(n),
                       np.full(m, -np.inf), np.full(m, 10.0))
    assert td.ell_auto(model, m, m + n)
    kc, kr = td.ell_widths(model)
    assert kc % 8 == 0 and kr % 8 == 0 and kc >= 3
    small = jgen.random_lp(96, 160, seed=13, density=0.08)
    assert not td.ell_auto(small, 96, 256)


# --------------------------------------------------------------------------
# Positive Edge
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_pe_dual_matches_jax(seed):
    """tests/test_pivot_rules.py:40-44: the PE dual, pivot for pivot."""
    jlp, tlp = _pair(jgen.random_lp(40, 70, seed=seed))
    jst = _jax_run(jlp, je.SimplexOptions(dual_pivot="pe"))
    tst = _torch_run(tlp, te.SimplexOptions(dual_pivot="pe"))
    _same_solve(jst, tst, jlp)
    assert np.array_equal(np.asarray(jst.basis), tst.basis.numpy())


@pytest.mark.parametrize("seed", [0, 3])
def test_pe_primal_matches_jax(seed):
    """tests/test_pivot_rules.py:40-44: the PE primal, pivot for pivot."""
    jlp, tlp = _pair(jgen.random_lp(40, 70, seed=seed))
    jst = _jax_run(jlp, je.SimplexOptions(primal_pivot="pe"), dual=False)
    tst = _torch_run(tlp, te.SimplexOptions(primal_pivot="pe"), dual=False)
    _same_solve(jst, tst, jlp)


def _transport():
    """tests/test_pivot_rules.py:70-88's degenerate transportation LP."""
    rng = np.random.default_rng(5)
    S, D = 8, 8
    n = S * D
    A = np.zeros((S + D, n))
    for i in range(S):
        for j in range(D):
            A[i, i * D + j] = 1.0
            A[S + j, i * D + j] = -1.0
    b = np.concatenate([np.full(S, 5.0), np.full(D, -5.0)])
    cost = np.repeat(rng.integers(1, 4, S).astype(float), D)
    m = clp_tpu.Model()
    m.load_problem(sp.csc_matrix(A), np.zeros(n), np.full(n, 5.0), cost,
                   row_lower=b, row_upper=b)
    return m


@pytest.mark.parametrize("dual", [True, False], ids=["dual", "primal"])
def test_pe_on_degenerate_transport_matches_jax(dual):
    jlp, tlp = _pair(_transport())
    kw = {"dual_pivot": "pe"} if dual else {"primal_pivot": "pe"}
    jst = _jax_run(jlp, je.SimplexOptions(**kw), dual)
    tst = _torch_run(tlp, te.SimplexOptions(**kw), dual)
    _same_solve(jst, tst, jlp, rel=1e-12)


@pytest.mark.parametrize("kw", [
    {"method": "DUAL_SIMPLEX", "dual_pivot": "pesteepest"},
    {"method": "PRIMAL_SIMPLEX", "primal_pivot": "pe"},
    {"method": "DUAL_SIMPLEX", "price_mode": "ell"},
], ids=["dual-pesteepest", "primal-pe", "dual-ell"])
def test_driver_routes_match_jax(kw):
    """initial_solve with the PE spellings and an explicit price_mode="ell".
    The JAX driver gives an explicit "ell" pad widths of 0 and so prices
    densely; the port takes the widths from the auto choice's formula, so
    that case compares status and objective only."""
    from tests.test_torch_qp import port_model

    kw = dict(kw)
    method = kw.pop("method")
    model = jgen.random_lp(30, 50, seed=7)
    jo = clp_tpu.SolveOptions(method=getattr(clp_tpu.SolveMethod, method), **kw)
    jsol = clp_tpu.solve.initial_solve(model.copy(), jo)
    to = clp_tpu_torch.SolveOptions(method=SolveMethod[method], device="cpu", **kw)
    tm = port_model(model)
    tsol = clp_tpu_torch.initial_solve(tm, to)
    assert tsol.status == ProblemStatus.OPTIMAL
    assert int(jsol.status) == int(tsol.status)
    assert abs(tsol.objective_value - jsol.objective_value) <= 1e-9 * (
        1 + abs(jsol.objective_value))
    if "ell" not in kw.values():
        assert tsol.iterations == jsol.iterations
    assert clp_tpu_torch.check_kkt(tm).ok


# --------------------------------------------------------------------------
# dual_solve_rounds
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rounds", [1, 2, 50])
def test_dual_solve_rounds_matches_jax(rounds):
    jlp, tlp = _pair(jgen.random_lp(30, 50, seed=1))
    opts_kw = dict(refactor_frequency=10)
    jo, to = je.SimplexOptions(**opts_kw), te.SimplexOptions(**opts_kw)
    jst = je.make_dual_feasible(jlp, je.recompute(jlp, je.initial_state(jlp, jo), jo.dual_bound), jo)
    tst = te.make_dual_feasible(tlp, te.recompute(tlp, te.initial_state(tlp, to), to.dual_bound), to)
    jout, jver = jax.jit(je.dual_solve_rounds, static_argnums=(2, 3))(jlp, jst, jo, rounds)
    tout, tver = te.dual_solve_rounds(tlp, tst, to, rounds)
    assert bool(jver) == tver
    assert int(jout.status) == int(tout.status)
    assert int(jout.iterations) == int(tout.iterations)
    assert int(jout.refactors) == int(tout.refactors)
    if rounds == 50:
        assert tver and int(tout.status) == te.OPTIMAL
    else:
        assert not tver and int(tout.status) == te.CONTINUE
    full = te.dual_solve(tlp, dataclasses.replace(tst), to)
    if rounds == 50:
        assert torch.equal(full.xb, tout.xb)
