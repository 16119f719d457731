"""Port parity for pdlp.py and bigsolve.py: PDHG's iterates on one ELL
matrix (and one dense matrix) handed to both packages; the gated block
loop stops where the JAX `while_loop` stops; `pdlp_solve`'s reduced-accuracy
claim; `crunch_polish` to verified simplex accuracy at the JAX package's
objective, never an unverified OPTIMAL; and the PDLP route through
`initial_solve` with its polish and its simplex adjudication."""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import clp_tpu
from clp_tpu import pdlp as jax_pdlp
from clp_tpu.bigsolve import crunch_polish as jax_crunch_polish
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch import pdlp
from clp_tpu_torch.bigsolve import crunch_polish
from clp_tpu_torch.convert import ell_from_numpy
from tests.test_bigsolve import _sparse_feasible_lp
from tests.test_torch_auto import _port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _scaled_problem(seed=1):
    """pdlp_solve's own inputs to _pdhg: the Ruiz-scaled matrix as ELL
    fields and as a dense array, and the scaled rim vectors."""
    mj = _sparse_feasible_lp(200, 400, 4000, seed=seed)
    A = mj.matrix.tocsr()
    dr, dc = jax_pdlp._ruiz_equilibrate(A)
    tr, tc = pdlp._ruiz_equilibrate(A)
    np.testing.assert_array_equal(tr, dr)
    np.testing.assert_array_equal(tc, dc)
    As = A.multiply(dr[:, None]).tocsr().multiply(dc[None, :]).tocsr()
    val, idx = jax_pdlp._pad_rows(As)
    valT, idxT = jax_pdlp._pad_rows(As.T.tocsr())
    ell = dict(val=val, idx=idx, valT=valT, idxT=idxT)
    vecs = (mj.objective * dc, np.where(mj.row_lower <= -1e30, -np.inf, mj.row_lower * dr),
            mj.row_upper * dr, mj.col_lower / dc, mj.col_upper / dc)
    return ell, np.asarray(As.todense()), vecs


def _run_both(A_j, A_t, vecs, tol, max_iter, check_every=100):
    rj = jax_pdlp._pdhg(A_j, *(jnp.asarray(v) for v in vecs), tol, max_iter=max_iter)
    rt = pdlp._pdhg(A_t, *(torch.as_tensor(v) for v in vecs), tol, max_iter=max_iter,
                    check_every=check_every)
    return [np.asarray(a) for a in rj], [a.numpy() for a in rt]


@pytest.mark.parametrize("backend", ["ell", "dense"])
def test_pdhg_iterates_match_jax(backend):
    """300 iterations with tol 0 (no stop), on one matrix handed to both:
    iterates within 1e-9 relative (f64 sums in another order)."""
    ell, dense, vecs = _scaled_problem()
    if backend == "ell":
        A_j = jax_pdlp.EllMatrix(*(jnp.asarray(ell[k]) for k in ("val", "idx", "valT", "idxT")))
        A_t = ell_from_numpy(ell, "cpu")
        assert A_t.idx.dtype == torch.int64 and A_t.val.dtype == torch.float64
    else:
        A_j, A_t = jnp.asarray(dense), torch.as_tensor(dense)
    (xj, yj, kj, dj), (xt, yt, kt, dt) = _run_both(A_j, A_t, vecs, 0.0, 300)
    assert int(kj) == int(kt) == 300 and not bool(dj) and not bool(dt)
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-9 * np.abs(xj).max())
    np.testing.assert_allclose(yt, yj, rtol=1e-9, atol=1e-9 * np.abs(yj).max())


def test_gated_blocks_stop_at_the_while_loops_count():
    """At tol 1e-4 the block loop stops at the JAX while_loop's iteration
    count, whatever the block length: iterations after convergence inside
    a block change nothing."""
    ell, _, vecs = _scaled_problem()
    A_j = jax_pdlp.EllMatrix(*(jnp.asarray(ell[k]) for k in ("val", "idx", "valT", "idxT")))
    A_t = ell_from_numpy(ell, "cpu")
    (xj, _, kj, dj), (xt, yt, kt, dt) = _run_both(A_j, A_t, vecs, 1e-4, 200000)
    assert bool(dj) and bool(dt) and int(kt) == int(kj)
    assert int(kj) % 100 != 0  # convergence fell inside a block
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-9 * np.abs(xj).max())
    _, (x7, y7, k7, d7) = _run_both(A_j, A_t, vecs, 1e-4, 200000, check_every=7)
    assert int(k7) == int(kt) and bool(d7)
    np.testing.assert_array_equal(x7, xt)
    np.testing.assert_array_equal(y7, yt)


@pytest.mark.parametrize("sparse", [True, False])
def test_pdlp_solve_optimal_with_reduced_accuracy(sparse):
    mj = _sparse_feasible_lp(200, 400, 4000, seed=1)
    sj = jax_pdlp.pdlp_solve(mj, clp_tpu.SolveOptions(pdlp_sparse=sparse))
    st = pdlp.pdlp_solve(_port_model(mj), clp_tpu_torch.SolveOptions(
        pdlp_sparse=sparse, device="cpu"))
    assert st.status == clp_tpu_torch.ProblemStatus.OPTIMAL
    assert st.secondary_status == clp_tpu_torch.SecondaryStatus.REDUCED_ACCURACY
    assert int(st.status) == int(sj.status) and st.iterations == sj.iterations
    assert abs(st.objective_value - sj.objective_value) <= 1e-9 * abs(sj.objective_value)


def test_crunch_polish_reaches_simplex_accuracy_like_jax():
    mj = _sparse_feasible_lp(600, 1200, 14000, seed=7)
    mt = _port_model(mj)
    pj = jax_crunch_polish(mj, clp_tpu.SolveOptions(),
                           jax_pdlp.pdlp_solve(mj, clp_tpu.SolveOptions()))
    opts = clp_tpu_torch.SolveOptions(device="cpu")
    seed = pdlp.pdlp_solve(mt, opts)
    pt = crunch_polish(mt, opts, seed)
    assert pj is not None and pt is not None
    assert pt.status == clp_tpu_torch.ProblemStatus.OPTIMAL
    assert pt.secondary_status == clp_tpu_torch.SecondaryStatus.NONE
    rep = clp_tpu_torch.check_kkt(mt, x=pt.primal, y=pt.duals, tol=1e-7)
    assert rep.ok, str(rep)
    assert abs(pt.objective_value - pj.objective_value) <= 1e-9 * abs(pj.objective_value)


def test_crunch_polish_never_reports_unverified_optimal():
    """A deliberately wrong seed: only a verified optimum, or None."""
    mt = _port_model(_sparse_feasible_lp(300, 500, 5000, seed=3))
    rng = np.random.default_rng(0)
    bogus = clp_tpu_torch.Solution(status=clp_tpu_torch.ProblemStatus.OPTIMAL,
                                   primal=rng.uniform(0, 1, mt.num_cols),
                                   duals=rng.normal(size=mt.num_rows))
    pol = crunch_polish(mt, clp_tpu_torch.SolveOptions(device="cpu"), bogus)
    if pol is not None:
        assert pol.status == clp_tpu_torch.ProblemStatus.OPTIMAL
        rep = clp_tpu_torch.check_kkt(mt, x=pol.primal, y=pol.duals, tol=1e-7)
        assert rep.ok, str(rep)


def _capped(pdhg, *args, max_iter):
    return pdhg(*args, max_iter=min(max_iter, 2000))


def _unbounded():
    mj = jgen.random_lp(15, 12, seed=203, density=0.4)
    a0 = np.asarray(mj.matrix.todense())[:, 0:1]
    mj.col_upper = mj.col_upper.copy()
    mj.col_upper[0] = clp_tpu.INF
    mj.add_columns(sp.csc_matrix(-a0), lower=[0.0], upper=[clp_tpu.INF],
                   objective=[-float(mj.objective[0]) - 1.0])
    return mj


@pytest.mark.parametrize("make, crossover", [
    (lambda: jgen.random_lp(30, 50, seed=21), True),
    (lambda: jgen.random_lp(30, 50, seed=21), False),
    (jgen.infeasible_lp, True),
    (_unbounded, True),
], ids=["polished", "unpolished", "infeasible", "unbounded"])
def test_pdlp_route_matches_jax(make, crossover, monkeypatch):
    """method=PDLP through initial_solve: the polish (a values-pass dual at
    this size) or, where PDHG stops short, the simplex's verdict; the same
    status and objective as the JAX package (1e-9 relative polished, the
    first-order accuracy of 1e-6 relative unpolished). PDHG's iteration
    limit is cut from 200,000 to 2,000 in both packages: an infeasible or
    unbounded LP runs to the limit, and the verdict is the simplex's."""
    for mod in (jax_pdlp, pdlp):
        monkeypatch.setattr(mod, "_pdhg", functools.partial(_capped, mod._pdhg))
    mj = make()
    mt = _port_model(mj)
    oj = clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.PDLP, crossover=crossover)
    ot = clp_tpu_torch.SolveOptions(method=clp_tpu_torch.SolveMethod.PDLP,
                                    crossover=crossover, device="cpu")
    oj.presolve.enabled = ot.presolve.enabled = False
    sj, st = clp_tpu.initial_solve(mj, oj), clp_tpu_torch.initial_solve(mt, ot)
    assert int(st.status) == int(sj.status)
    assert int(st.secondary_status) == int(sj.secondary_status)
    if sj.status == clp_tpu.ProblemStatus.OPTIMAL:
        rtol = 1e-9 if crossover else 1e-6
        assert abs(st.objective_value - sj.objective_value) <= rtol * (
            1 + abs(sj.objective_value))
