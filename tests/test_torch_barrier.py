"""Port parity for the barrier: the Cholesky half of ops/linalg, the IPM
form, `ipm_solve` branch by branch, and `initial_solve` with BARRIER,
BARRIER_NO_CROSS and AUTOMATIC (clp_tpu_torch vs clp_tpu on the same
inputs, on the CPU)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import clp_tpu
from clp_tpu.forms import to_ipm_form as jax_ipm_form
from clp_tpu.interior.mehrotra import IPMOptions as JaxIPMOptions, ipm_solve_jit
from clp_tpu.ops import linalg as jlin
from clp_tpu.solve import _rcm_band_plan as jax_band_plan
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch import convert
from clp_tpu_torch.forms import expand_ipm_solution, to_ipm_form
from clp_tpu_torch.interior import IPMOptions, ipm_solve
from clp_tpu_torch.ops import linalg as tlin
from clp_tpu_torch.solve import _rcm_band_plan
from clp_tpu_torch.utils import generators as tgen
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


# --- the Cholesky half --------------------------------------------------


def _spd_with_min_eig(rng, n, lam):
    B = rng.standard_normal((n, n + 10))
    M = B @ B.T
    return M - (np.linalg.eigvalsh(M)[0] - lam) * np.eye(n)


@pytest.mark.parametrize("bumps", [0, 5])
def test_chol_factor_reg_matches_jax(bumps):
    """An SPD matrix factors at once; one whose smallest eigenvalue is
    -delta_5 / 2 needs five x100 escalations of the diagonal shift, and both
    packages settle on the same shift and factor."""
    rng = np.random.default_rng(0)
    M = _spd_with_min_eig(rng, 30, 1.0)
    if bumps:
        scale = np.abs(np.diag(M)).max()
        M = _spd_with_min_eig(np.random.default_rng(0), 30, -0.5e-6 * scale)
    Lj, dj = jlin.chol_factor_reg(jnp.asarray(M), base_reg=0.0)
    Lt, dt = tlin.chol_factor_reg(_t(M), base_reg=0.0)
    assert float(dt) == pytest.approx(float(dj), rel=1e-12)
    if bumps:
        assert float(dt) == pytest.approx(1e-6 * np.abs(np.diag(M)).max(), rel=1e-9)
    assert np.isfinite(Lt.numpy()).all()
    assert _rel(Lt.numpy(), np.asarray(Lj)) <= 1e-10
    rhs = rng.standard_normal(30)
    xj = jlin.solve_refined(jnp.asarray(M), Lj, jnp.asarray(rhs), iters=1)
    xt = tlin.solve_refined(_t(M), Lt, _t(rhs), iters=1)
    assert _rel(xt.numpy(), np.asarray(xj)) <= 1e-10
    if not bumps:  # blocked: the same factor as the plain one
        Lb = tlin.chol_blocked(_t(M), nb=8)
        assert _rel(Lb.numpy(), np.asarray(jlin.chol_blocked(jnp.asarray(M), nb=8))) <= 1e-10


def test_chol_factor_reg_failure_is_nan_like_xla():
    """With no bumps allowed a non-SPD matrix comes back NaN, as XLA's
    Cholesky returns it: the info test replaces the NaN test."""
    M = np.diag([1.0, -1.0, 2.0])
    Lj, _ = jlin.chol_factor_reg(jnp.asarray(M), max_bumps=0)
    Lt, _ = tlin.chol_factor_reg(_t(M), max_bumps=0)
    np.testing.assert_array_equal(Lt.numpy(), np.asarray(Lj))  # NaN below, 0 above
    assert np.isnan(Lt.numpy()[np.tril_indices(3)]).all()


@pytest.mark.parametrize("bumps", [0, 5])
def test_block_tridiag_cholesky_and_solve_match_jax(bumps):
    rng = np.random.default_rng(1)
    k, nb = 4, 16
    m = k * nb
    B = np.zeros((m, m + 8))
    for i in range(m):  # banded rows: the pattern of B B' is block-tridiagonal
        lo = max(0, i - 6)
        B[i, lo:i + 3] = rng.standard_normal(i + 3 - lo)
    M = B @ B.T + np.eye(m)
    if bumps:  # smallest eigenvalue -delta_5 / 2: five escalations
        scale = np.abs(np.diag(M)).max()
        M -= (np.linalg.eigvalsh(M)[0] + 0.5e-6 * scale) * np.eye(m)
    A = np.stack([M[i * nb:(i + 1) * nb, i * nb:(i + 1) * nb] for i in range(k)])
    E = np.stack([M[(i + 1) * nb:(i + 2) * nb, i * nb:(i + 1) * nb] for i in range(k - 1)])
    Lj, Cj, dj = jlin.block_tridiag_cholesky(jnp.asarray(A), jnp.asarray(E))
    Lt, Ct, dt = tlin.block_tridiag_cholesky(_t(A), _t(E))
    assert float(dt) == pytest.approx(float(dj), rel=1e-12)
    assert (float(dt) > 0.0) == bool(bumps)
    assert _rel(Lt.numpy(), np.asarray(Lj)) <= 1e-10
    assert _rel(Ct.numpy(), np.asarray(Cj)) <= 1e-10
    rhs = rng.standard_normal((k, nb))
    xj = jlin.block_tridiag_solve(Lj, Cj, jnp.asarray(rhs))
    xt = tlin.block_tridiag_solve(Lt, Ct, _t(rhs))
    assert _rel(xt.numpy(), np.asarray(xj)) <= 1e-10


# --- the IPM form -------------------------------------------------------


def _fixed_lp(pkg):
    """random_lp(12, 20) with three columns fixed and a row pinned."""
    gen = jgen if pkg == "jax" else tgen
    model = gen.random_lp(12, 20, seed=4)
    for j, v in ((1, 0.5), (7, 2.0), (13, 0.0)):
        model.col_lower[j] = model.col_upper[j] = v
    model.row_lower[3] = model.row_upper[3] = 1.25
    model.objective_offset = 3.0
    model.optimization_direction = -1.0
    return model


def test_to_ipm_form_matches_jax_with_fixed_columns():
    lpj, infoj = jax_ipm_form(_fixed_lp("jax"))
    lpt, infot = to_ipm_form(_fixed_lp("torch"), device="cpu")
    tn = convert.standard_lp_to_numpy(lpt)
    for f in ("G", "b", "c", "l", "u"):
        np.testing.assert_array_equal(tn[f], np.asarray(getattr(lpj, f)), err_msg=f)
    model = _fixed_lp("torch")
    bounds = [np.concatenate([model.col_lower, model.row_lower]),
              np.concatenate([model.col_upper, model.row_upper])]
    assert tn["G"].shape[1] == int(np.sum(bounds[0] != bounds[1])) <= 12 + 20 - 4
    carried = convert.form_info_from_numpy(dataclasses.asdict(infoj))
    for f in ("n", "m", "sense", "offset"):
        assert getattr(infot, f) == getattr(carried, f)
    for f in ("kept", "fixed_values"):
        np.testing.assert_array_equal(getattr(infot, f), getattr(carried, f))
    v = np.arange(tn["G"].shape[1], dtype=np.float64)
    np.testing.assert_array_equal(expand_ipm_solution(infot, v),
                                  clp_tpu.forms.expand_ipm_solution(infoj, v))


# --- ipm_solve branch by branch -----------------------------------------


def _shared_form(kind):
    """One IPM form handed to both packages (numpy fields), and the options
    that pick the branch."""
    if kind == "banded":
        lpj, _ = jax_ipm_form(jgen.staircase_lp(8, 32, 72))
        G = np.asarray(lpj.G)
        perm, nb = jax_band_plan(G)
        tperm, tnb = _rcm_band_plan(G)
        assert nb == tnb == 64
        np.testing.assert_array_equal(perm, tperm)
        fields = {"G": G[perm], "b": np.asarray(lpj.b)[perm], "c": np.asarray(lpj.c),
                  "l": np.asarray(lpj.l), "u": np.asarray(lpj.u), "Q": None}
        return fields, {"band_nb": nb}
    lpj, _ = jax_ipm_form(jgen.random_lp(40, 70, seed=3, density=0.3))
    fields = {f: np.asarray(getattr(lpj, f)) for f in ("G", "b", "c", "l", "u")}
    fields["Q"] = None
    branch = {"f64": {}, "mixed32": {"mixed32": True},
              "cg": {"linear_solver": "cg"}, "lsqr": {"linear_solver": "lsqr"}}[kind]
    return fields, branch


BRANCHES = ["f64", "mixed32", "banded", "cg", "lsqr"]


def _both(fields, branch, max_iter):
    lpj = clp_tpu.forms.StandardLP(**{k: (None if v is None else jnp.asarray(v))
                                      for k, v in fields.items()})
    rj = ipm_solve_jit(lpj, JaxIPMOptions(max_iter=max_iter, **branch))
    rt = ipm_solve(convert.standard_lp_from_numpy(fields, "cpu"),
                   IPMOptions(max_iter=max_iter, **branch))
    return rj, rt


@pytest.mark.parametrize("max_iter", [1, 3])
@pytest.mark.parametrize("kind", BRANCHES)
def test_ipm_iterates_match_jax(kind, max_iter):
    fields, branch = _shared_form(kind)
    rj, rt = _both(fields, branch, max_iter)
    assert int(rt.iterations) == int(rj.iterations) == max_iter
    got = convert.ipm_result_to_numpy(rt)
    for f in ("x", "y", "z", "w"):
        assert _rel(got[f], np.asarray(getattr(rj, f))) <= 1e-8, f


@pytest.mark.parametrize("kind", BRANCHES)
def test_ipm_converges_like_jax(kind):
    fields, branch = _shared_form(kind)
    rj, rt = _both(fields, branch, 100)
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.iterations) == int(rj.iterations)
    pj = float(rj.pobj)
    assert abs(float(rt.pobj) - pj) <= 1e-9 * (1 + abs(pj))


def test_ipm_result_round_trip():
    fields, branch = _shared_form("f64")
    rj, _ = _both(fields, branch, 1)
    res = convert.ipm_result_from_numpy(
        {f.name: np.asarray(getattr(rj, f.name)) for f in dataclasses.fields(rj)}, "cpu")
    back = convert.ipm_result_to_numpy(res)
    np.testing.assert_array_equal(back["x"], np.asarray(rj.x))
    assert int(back["iterations"]) == 1


# --- initial_solve ------------------------------------------------------

SOLVES = {
    "random": ("random_lp", (40, 70), {"seed": 3, "density": 0.3}, -87.2253242516384),
    "staircase": ("staircase_lp", (8, 32, 72), {}, -1211.164614288598),
    "nqueens": ("nqueens_lp", (6,), {}, None),
    "transport": ("transport_lp", (6, 8), {"seed": 1}, None),
}


@pytest.mark.parametrize("method", ["AUTOMATIC", "BARRIER", "BARRIER_NO_CROSS"])
@pytest.mark.parametrize("family", sorted(SOLVES))
def test_initial_solve_barrier_routes_match_jax(family, method):
    """Status and objective agree to 1e-9. After the crossover the simplex
    pivot counts may differ: the crossover's basis pick is an f32 pivoted
    LU whose pivot order breaks near-ties differently in the two packages,
    so only the barrier's own iteration count is held equal."""
    name, args, kw, known = SOLVES[family]
    sj = clp_tpu.initial_solve(getattr(jgen, name)(*args, **kw),
                               clp_tpu.SolveOptions(method=clp_tpu.SolveMethod[method]))
    mt = getattr(tgen, name)(*args, **kw)
    st = clp_tpu_torch.initial_solve(mt, clp_tpu_torch.SolveOptions(
        method=clp_tpu_torch.SolveMethod[method], device="cpu"))
    assert st.status.name == sj.status.name == "OPTIMAL"
    oj = sj.objective_value
    assert abs(st.objective_value - oj) <= 1e-9 * (1 + abs(oj))
    if known is not None:
        assert abs(st.objective_value - known) <= 1e-9 * (1 + abs(known))
    if method == "BARRIER_NO_CROSS":
        assert st.iterations == sj.iterations
    assert clp_tpu_torch.check_kkt(mt, x=st.primal, y=st.duals, tol=1e-6).ok


def test_staircase_takes_the_banded_branch():
    st = clp_tpu_torch.initial_solve(tgen.staircase_lp(8, 32, 72), clp_tpu_torch.SolveOptions(
        method=clp_tpu_torch.SolveMethod.BARRIER_NO_CROSS, device="cpu"))
    assert st.timings["barrier_stats"]["branch"] == "banded nb=64"
    sr = clp_tpu_torch.initial_solve(tgen.random_lp(40, 70, seed=3, density=0.3),
                                     clp_tpu_torch.SolveOptions(device="cpu"))
    assert sr.timings["barrier_stats"]["branch"] == "dense f64"


def test_model_barrier_entry_point():
    mj = jgen.random_lp(40, 70, seed=3, density=0.3)
    mt = tgen.random_lp(40, 70, seed=3, density=0.3)
    sj, st = mj.barrier(), mt.barrier(device="cpu")
    assert st.status.name == sj.status.name == "OPTIMAL"
    assert abs(st.objective_value - sj.objective_value) <= 1e-9 * (1 + abs(sj.objective_value))
    st2 = mt.barrier(crossover=False, device="cpu")
    assert st2.status.name == "OPTIMAL"


def test_unconverged_barrier_is_adjudicated_by_the_simplex():
    """A barrier cut off after 3 iterations fails to converge; both
    packages hand the LP to the dual simplex, which proves it optimal."""
    opts = dict(barrier_max_iterations=3)
    sj = clp_tpu.initial_solve(jgen.random_lp(40, 70, seed=3, density=0.3), clp_tpu.SolveOptions(
        method=clp_tpu.SolveMethod.BARRIER_NO_CROSS, **opts))
    st = clp_tpu_torch.initial_solve(tgen.random_lp(40, 70, seed=3, density=0.3),
                                     clp_tpu_torch.SolveOptions(
        method=clp_tpu_torch.SolveMethod.BARRIER_NO_CROSS, device="cpu", **opts))
    assert st.status.name == sj.status.name == "OPTIMAL"
    assert st.timings["barrier_stats"]["converged"] is False
    assert abs(st.objective_value - sj.objective_value) <= 1e-9 * (1 + abs(sj.objective_value))


def test_crossover_lu_lets_device_errors_through(monkeypatch):
    """The crossover's basis pick runs an LU on the device. An error there
    (on the card, a CUDA error) must reach the caller, not turn into a
    slack-basis crossover."""
    from clp_tpu_torch.simplex import driver, engine

    model = tgen.random_lp(12, 20, seed=3)
    lp, _ = clp_tpu_torch.forms.to_standard_form(model, device="cpu")
    warm = clp_tpu_torch.Solution(primal=np.full(20, 0.5))

    def fail(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch.linalg, "lu_factor_ex", fail)
    with pytest.raises(RuntimeError, match="CUDA error"):
        driver._warm_state(lp, engine.SimplexOptions(), warm, 20, 12)


def test_mixed32_stalls_on_the_random_bench_lp_like_jax():
    """random_lp(1024, 1792, density=0.05), the bench's random instance:
    the mixed32 branch (the card's dense setting) stalls short of the
    tolerance in both packages: after 25 iterations neither has converged
    and both primal infeasibilities sit between 1e-5 and 1e-3, within half
    a decade of each other (ROADMAP.md queue 4 item 7)."""
    lpj, _ = jax_ipm_form(jgen.random_lp(1024, 1792, seed=0, density=0.05))
    fields = {f: np.asarray(getattr(lpj, f)) for f in ("G", "b", "c", "l", "u")}
    fields["Q"] = None
    rj, rt = _both(fields, {"mixed32": True}, 25)
    assert not bool(rt.converged) and not bool(rj.converged)
    pj, pt = float(rj.primal_infeas), float(rt.primal_infeas)
    assert 1e-5 < pt < 1e-3 and 1e-5 < pj < 1e-3
    assert abs(np.log10(pt / pj)) < 0.5


def test_f32_multifrontal_stalls_on_a_window_lp_like_jax():
    """The IPM form of window_lp(512, 1024, 40, 3) (512 x 1536) on the device
    multifrontal normal equations: in f32 (the card's setting) both packages
    stall, not converged after 40 iterations with primal infeasibilities
    near 1e-4 and within a decade of each other; in f64 both converge in the
    same number of iterations to the same objective (1e-9 relative). The
    port runs the device numeric on the CPU here (ROADMAP.md queue 4 item 7
    asks which precision the card should take)."""
    import scipy.sparse as sp

    from clp_tpu.ops import sparse_chol_device as jscd

    from clp_tpu_torch.ops import sparse_chol_device as tscd
    from tests.test_sparse_chol import window_lp

    lpj, _ = jax_ipm_form(window_lp(512, 1024, 40, 3))
    fields = {f: np.asarray(getattr(lpj, f)) for f in ("G", "b", "c", "l", "u")}
    fields["Q"] = None
    G = sp.csr_matrix(fields["G"])
    reg = JaxIPMOptions().reg_dual + 1e-12
    out = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("f64", jnp.float64, torch.float64)):
        sj = jscd.make_device_normal_solver(G, reg=reg, dtype=jdt)
        st = tscd.make_device_normal_solver(G, reg=reg, dtype=tdt, device="cpu")
        assert sj is not None and st is not None
        rj = ipm_solve_jit(clp_tpu.forms.StandardLP(
            **{k: (None if v is None else jnp.asarray(v)) for k, v in fields.items()}),
            JaxIPMOptions(max_iter=40, sparse_chol_device=sj))
        rt = ipm_solve(convert.standard_lp_from_numpy(fields, "cpu"),
                       IPMOptions(max_iter=40, sparse_chol_device=st))
        out[name] = (rj, rt)
    rj, rt = out["f32"]
    assert int(rj.iterations) == int(rt.iterations) == 40
    assert not bool(rj.converged) and not bool(rt.converged)
    pj, pt = float(rj.primal_infeas), float(rt.primal_infeas)
    assert 1e-5 < pt < 1e-3 and 1e-5 < pj < 1e-3
    assert abs(np.log10(pt / pj)) < 1.0
    rj, rt = out["f64"]
    assert bool(rj.converged) and bool(rt.converged)
    assert int(rt.iterations) == int(rj.iterations)
    assert abs(float(rt.pobj) - float(rj.pobj)) <= 1e-9 * abs(float(rj.pobj))
