"""Port parity of scenario batching: the batched dual simplex (lane by lane
with live-set compaction), the lane-wise batched IPM, the batched QP
simplex and `solve_batch` (clp_tpu_torch vs clp_tpu, CPU). Each lane of
the port's batched dual simplex is also its single solve, bit for bit."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clp_tpu
from clp_tpu.parallel import batch as jb
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch.constants import ProblemStatus
from clp_tpu_torch.forms import to_standard_form
from clp_tpu_torch.ops import linalg as tl
from clp_tpu_torch.parallel import batch as tb
from clp_tpu_torch.simplex import engine as te
from clp_tpu_torch.utils.lockstep import run
from tests.test_batch import _perturbed_models, _portfolio_qp
from tests.test_torch_qp import port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _cpu(**kw):
    return clp_tpu_torch.SolveOptions(device="cpu", **kw)


def _same(tsols, jsols, rel=1e-9, iterations=True):
    for t, j in zip(tsols, jsols):
        assert int(t.status) == int(j.status) == int(ProblemStatus.OPTIMAL)
        assert abs(t.objective_value - j.objective_value) <= rel * (1 + abs(j.objective_value))
        if iterations:
            assert t.iterations == j.iterations


def _scenarios(base, count, seed=3):
    """bench.py's perturbed-RHS scenarios of one JAX-package model."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        m = base.copy()
        shift = np.abs(rng.uniform(0, 0.05, m.num_rows))
        m.row_lower = np.where(m.row_lower > -1e29, m.row_lower - shift, m.row_lower)
        m.row_upper = np.where(m.row_upper < 1e29, m.row_upper + shift, m.row_upper)
        out.append(m)
    return out


# --------------------------------------------------------------------------
# stacking
# --------------------------------------------------------------------------


def test_shape_mismatch_raises_like_jax():
    a, b = jgen.random_lp(5, 8, seed=0), jgen.random_lp(6, 8, seed=0)
    with pytest.raises(ValueError):
        jb.stack_models([a, b])
    for fn in (tb.stack_models, tb.stack_models_simplex):
        with pytest.raises(ValueError):
            fn([port_model(a), port_model(b)], "cpu")


@pytest.mark.parametrize("form", ["ipm", "simplex"])
def test_stacked_forms_match_jax(form):
    models = _perturbed_models(count=3)
    jfn, tfn = ((jb.stack_models, tb.stack_models) if form == "ipm"
                else (jb.stack_models_simplex, tb.stack_models_simplex))
    jlp, _ = jfn(models)
    tlp, _ = tfn([port_model(m) for m in models], "cpu")
    for k in ("G", "b", "c", "l", "u"):
        assert np.array_equal(np.asarray(getattr(jlp, k)), getattr(tlp, k).numpy())


def _form_lanes(case):
    """Four 5 x 7 lanes for the batched simplex form, one case each."""
    rng = np.random.default_rng(11)
    m, n = 5, 7
    models = []
    for k in range(4):
        A = sp.random(m, n, density=0.4, random_state=k if case == "patterns" else 0,
                      format="csc") * (1.0 + k)
        if case == "duplicates":
            # column 0 unsorted with (2, 0) three times: summed in storage
            # order it is ((0 + 1e16) + 1) - 1e16 = 0, in another order 1
            R = A[:, 2:]
            A = sp.csc_matrix((np.r_[1e16, 3.0 + k, 1.0, -1e16, 0.5, 0.25, R.data],
                               np.r_[2, 0, 2, 2, 1, 1, R.indices], np.r_[0, 4, 6 + R.indptr]),
                              shape=(m, n))
        elif case == "zeros":
            # an explicit 0.0 and -0.0 (todense() writes 0.0 for both) and
            # an empty column 3
            D = A.toarray()
            D[:, 3] = 0.0
            D[4, :2] = 0.0
            r, col = np.nonzero(D)
            A = sp.csc_matrix((np.r_[D[r, col], 0.0, -0.0], (np.r_[r, 4, 4], np.r_[col, 0, 1])),
                              shape=(m, n))
        cl = rng.uniform(-1, 0, n)
        cu = rng.uniform(1, 2, n)
        rl = rng.uniform(-2, -1, m)
        ru = rng.uniform(1, 2, m)
        if case == "infinite":
            cl[:2], cu[2:4], rl[0], ru[1] = -clp_tpu_torch.INF, clp_tpu_torch.INF, -2e30, 3e30
        c = rng.standard_normal(n)
        c[1] = 0.0
        mod = clp_tpu_torch.Model()
        mod.load_problem(A, cl, cu, c, rl, ru)
        mod.objective_offset = 0.5 * k
        if case in ("maximise", "qp") and k % 2:
            mod.set_maximize()
        if case == "qp":
            Q = sp.csc_matrix((np.r_[2.0 + k, 1e16, 1.0, -1e16, 0.5, 0.5],
                               np.r_[0, 1, 1, 1, 2, 1], np.r_[0, 1, 4, 5, 6, 6, 6, 6]),
                              shape=(n, n))
            mod.load_quadratic_objective(Q)
        models.append(mod)
    return models


@pytest.mark.parametrize("case", ["duplicates", "zeros", "patterns", "maximise", "infinite",
                                  "qp"])
def test_batched_simplex_form_is_the_stacked_lane_forms_bit_for_bit(case):
    """forms.to_standard_form_batch (the scatter the card runs, here on the
    CPU) against torch.stack of each lane's to_standard_form: G, b, c, l,
    u and Q bit for bit, signs of zeros included, and the same infos."""
    models = _form_lanes(case)
    A0 = models[0].matrix
    if case == "duplicates":
        assert not A0.has_canonical_format
    if case == "zeros":
        assert (A0.data == 0).sum() == 2 and np.signbit(A0.data).any()
        assert A0.indptr[4] == A0.indptr[3]
    lp, infos = tb.stack_models_simplex(models, "cpu")
    singles = [to_standard_form(mod, device="cpu") for mod in models]
    for k in ("G", "b", "c", "l", "u", "Q"):
        got, want = getattr(lp, k), [getattr(s, k) for s, _ in singles]
        if want[0] is None:
            assert got is None and case != "qp"
            continue
        want = torch.stack(want)
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert torch.equal(got.view(torch.int64), want.view(torch.int64)), k
    assert ([(i.n, i.m, i.sense, i.offset) for i in infos]
            == [(i.n, i.m, i.sense, i.offset) for _, i in singles])


def test_mixed_lp_qp_batch_raises():
    a, b = port_model(jgen.random_lp(5, 8, seed=0)), port_model(jgen.random_lp(5, 8, seed=1))
    b.load_quadratic_objective(sp.identity(8, format="csc"))
    with pytest.raises(ValueError):
        tb.stack_models_simplex([a, b], "cpu")


# --------------------------------------------------------------------------
# the batched dual simplex
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [(10, 16, 2, 4, True), (32, 48, 4, 8, True),
                                  (64, 96, 2, 6, False)],
                         ids=["10x16", "32x48", "64x96"])
def test_batch_dual_simplex_matches_jax(spec):
    """tests/test_batch.py::test_batch_dual_simplex and bench.py's shapes:
    every lane the JAX package's status, objective and pivot count. On the
    64 x 96 LPs the single f64 dual solves already take different pivot
    counts in the two packages (~197 in the JAX package, ~176 in the port:
    ROADMAP.md queue 3, summation order), so there the counts are not
    compared; each lane is its single solve (the bit-for-bit test below)."""
    m, n, seed, B, same_count = spec
    models = _scenarios(jgen.random_lp(m, n, seed=seed), B)
    jo = clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.DUAL_SIMPLEX)
    jo.presolve.enabled = False
    jsols = jb.solve_batch_dual_simplex([x.copy() for x in models], jo)
    to = _cpu(method=clp_tpu_torch.SolveMethod.DUAL_SIMPLEX)
    to.presolve.enabled = False
    tms = [port_model(x) for x in models]
    tsols = tb.solve_batch_dual_simplex(tms, to)
    _same(tsols, jsols, iterations=same_count)
    for tm in tms:
        assert clp_tpu_torch.check_kkt(tm).ok


def _single(lp, opts):
    st = te.initial_state(lp, opts)
    st = te.recompute(lp, st, opts.dual_bound)
    st = te.make_dual_feasible(lp, st, opts)
    return te.dual_solve(lp, st, opts)


@pytest.mark.parametrize("kw", [{}, {"dual_ratio": "bfrt"},
                                {"inverse_dtype": "float32", "inner_unroll": 8,
                                 "refactor_frequency": 40},
                                {"refactor_frequency": 7}],
                         ids=["harris", "bfrt", "f32-U8", "refactor7"])
def test_batched_lane_is_its_single_solve_bit_for_bit(kw):
    """The compacting batched loop against engine.dual_solve on each lane
    alone: the same status, pivots, basis, x_B, duals and inverse, bit for
    bit in f64 on the CPU (engine._mv keeps the matvecs so under vmap). The
    lanes finish at different pivots, so compaction repacks the batch."""
    models = [port_model(x) for x in _scenarios(jgen.random_lp(40, 70, seed=5), 5)]
    opts = te.SimplexOptions(**kw)
    lp_b, _ = tb.stack_models_simplex(models, "cpu")
    E = tb._Lanes(tb._lpd(lp_b), opts)
    S = run(tb._compacting_prog(E, E.initial_state()))
    iters = set()
    for i, mdl in enumerate(models):
        lp, _ = to_standard_form(mdl, device="cpu")
        st = _single(lp, opts)
        assert int(S["status"][i]) == int(st.status) == te.OPTIMAL
        iters.add(int(st.iterations))
        for k in ("iterations", "basis", "vstat", "xb", "y", "dj", "binv", "weights"):
            assert torch.equal(S[k][i], getattr(st, k)), k
    assert len(iters) > 1  # the lanes did finish apart


@pytest.mark.parametrize("rounds", [1, 3])
def test_batched_rounds_match_jax(rounds):
    """The bounded rounds under vmap (the JAX package's `_brounds`) lane by
    lane: status, pivots and verification after `rounds` chunks."""
    models = _scenarios(jgen.random_lp(30, 50, seed=1), 4)
    jlp, _ = jb.stack_models_simplex(models)
    from clp_tpu.simplex import engine as je

    jo = je.SimplexOptions(refactor_frequency=12)
    jst, jver = jb._brounds(jlp, jb._bprep(jlp, jb._binit(jlp, jo), jo), jo, rounds)
    tlp, _ = tb.stack_models_simplex([port_model(m) for m in models], "cpu")
    E = tb._Lanes(tb._lpd(tlp), te.SimplexOptions(refactor_frequency=12))
    S, ver = run(tb._brounds_prog(E, tb._bprep(E, E.initial_state()), rounds))
    assert np.array_equal(np.asarray(jver), ver.numpy())
    assert np.array_equal(np.asarray(jst.status), S["status"].numpy())
    assert np.array_equal(np.asarray(jst.iterations), S["iterations"].numpy())


def test_batched_chunk_matches_jax():
    """One lockstep chunk (race_seeds' `_bchunk`), three times."""
    models = _scenarios(jgen.random_lp(24, 40, seed=3), 3)
    jlp, _ = jb.stack_models_simplex(models)
    from clp_tpu.simplex import engine as je

    jo = je.SimplexOptions(refactor_frequency=10)
    jst = jb._bprep(jlp, jb._binit(jlp, jo), jo)
    tlp, _ = tb.stack_models_simplex([port_model(m) for m in models], "cpu")
    E = tb._Lanes(tb._lpd(tlp), te.SimplexOptions(refactor_frequency=10))
    S = tb._bprep(E, E.initial_state())
    for _ in range(3):
        jst, jver, jobj = jb._bchunk(jlp, jst, jo)
        S, ver, obj = tb._bchunk(E, S)
        assert np.array_equal(np.asarray(jver), ver.numpy())
        assert np.array_equal(np.asarray(jst.iterations), S["iterations"].numpy())
        np.testing.assert_allclose(obj.numpy(), np.asarray(jobj), rtol=1e-9)


def test_fake_bound_lanes_rerun_and_finish_like_jax():
    """Free columns fold to fake bounds in the dual: the batch's escalation
    and primal finish, against the JAX package's on the same lanes."""
    base = jgen.random_lp(20, 30, seed=6)
    base.col_lower = base.col_lower.copy()
    base.col_upper = base.col_upper.copy()
    base.col_lower[:4] = -clp_tpu.INF
    base.col_upper[:4] = clp_tpu.INF
    models = _scenarios(base, 3)
    jo = clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.DUAL_SIMPLEX)
    jo.presolve.enabled = False
    jsols = jb.solve_batch_dual_simplex([m.copy() for m in models], jo)
    to = _cpu(method=clp_tpu_torch.SolveMethod.DUAL_SIMPLEX)
    to.presolve.enabled = False
    tsols = tb.solve_batch_dual_simplex([port_model(m) for m in models], to)
    for t, j in zip(tsols, jsols):
        assert int(t.status) == int(j.status)
        if j.status == clp_tpu.ProblemStatus.OPTIMAL:
            assert abs(t.objective_value - j.objective_value) <= 1e-9 * (1 + abs(j.objective_value))


def test_batch_dual_warm_basis_matches_jax():
    """A shared warm basis (strong branching from one parent)."""
    models = _scenarios(jgen.random_lp(12, 20, seed=2), 3)
    jparent = models[0].copy()
    jparent.initial_solve(clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.DUAL_SIMPLEX))
    warm_j = clp_tpu.Solution(column_status=jparent.solution.column_status,
                              row_status=jparent.solution.row_status)
    warm_t = clp_tpu_torch.Solution(column_status=jparent.solution.column_status,
                                    row_status=jparent.solution.row_status)
    jo = clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.DUAL_SIMPLEX)
    jsols = jb.solve_batch_dual_simplex([m.copy() for m in models], jo, warm=warm_j)
    tsols = tb.solve_batch_dual_simplex([port_model(m) for m in models],
                                        _cpu(method=clp_tpu_torch.SolveMethod.DUAL_SIMPLEX),
                                        warm=warm_t)
    _same(tsols, jsols)


# --------------------------------------------------------------------------
# the batched IPM
# --------------------------------------------------------------------------


def test_batch_matches_single_and_jax():
    """tests/test_batch.py::test_batch_matches_single through solve_batch."""
    models = _perturbed_models(count=4)
    jsols = clp_tpu.solve_batch([m.copy() for m in models])
    tms = [port_model(m) for m in models]
    tsols = clp_tpu_torch.solve.solve_batch(tms, _cpu())
    _same(tsols, jsols)
    for tm in tms:
        assert clp_tpu_torch.check_kkt(tm).ok


def test_batch_ipm_bench_shape_matches_jax():
    """bench.py:132-186's batch (random_lp(48, 72) scenarios), B = 8."""
    models = _scenarios(jgen.random_lp(48, 72, seed=0), 8, seed=1)
    jsols = clp_tpu.solve_batch([m.copy() for m in models])
    tsols = clp_tpu_torch.solve.solve_batch([port_model(m) for m in models], _cpu())
    _same(tsols, jsols)


def test_batch_ipm_banded_union_plan_matches_jax():
    """Perturbed-RHS staircases share one RCM banded plan of the union
    pattern; every lane the JAX package's IPM iterations and objective."""
    base = jgen.staircase_lp(8, 32, 72, seed=0)
    models = _scenarios(base, 3, seed=5)
    jsols = clp_tpu.solve_batch([m.copy() for m in models])
    seen = {}
    real = tb.ipm_solve_batched

    def spy(lp, opts):
        seen["nb"] = opts.band_nb
        return real(lp, opts)

    tb.ipm_solve_batched = spy
    try:
        tsols = clp_tpu_torch.solve.solve_batch([port_model(m) for m in models], _cpu())
    finally:
        tb.ipm_solve_batched = real
    assert seen["nb"] > 0
    _same(tsols, jsols)


def test_batch_qp_matches_jax():
    """tests/test_batch.py::test_batch_qp: diagonal-Q QPs through the
    batched IPM's QP branch; objectives improve as rows loosen."""
    rng = np.random.default_rng(3)
    n, mrows = 6, 3
    base = clp_tpu.Model()
    base.load_problem(sp.csc_matrix(rng.uniform(0, 1, (mrows, n))), np.zeros(n),
                      np.full(n, 2.0), rng.uniform(-2, -1, n), np.full(mrows, -clp_tpu.INF),
                      rng.uniform(2.0, 4.0, mrows))
    base.load_quadratic_objective(sp.csc_matrix(np.diag(rng.uniform(1.0, 2.0, n))))
    models = []
    for k in range(3):
        m = base.copy()
        m.row_upper = m.row_upper + 0.05 * k
        models.append(m)
    jsols = clp_tpu.solve_batch([m.copy() for m in models])
    tms = [port_model(m) for m in models]
    tsols = clp_tpu_torch.solve.solve_batch(tms, _cpu())
    _same(tsols, jsols)
    objs = [s.objective_value for s in tsols]
    assert objs[0] >= objs[1] >= objs[2]
    for tm in tms:
        assert clp_tpu_torch.check_kkt(tm).ok


def test_lanewise_cholesky_matches_single():
    """Each lane escalates its own shift, as chol_factor_reg does alone:
    lane 1 is singular (needs bumps), lanes 0 and 2 are SPD."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((3, 6, 6))
    M = A @ A.transpose(0, 2, 1)
    M[1] = np.outer(A[1, 0], A[1, 0]) - 1e-10 * np.eye(6)  # slightly indefinite
    Mt = torch.as_tensor(M)
    L, delta = run(tl.chol_factor_reg_lanes_prog(Mt))
    for i in range(3):
        L1, d1 = tl.chol_factor_reg(Mt[i])
        torch.testing.assert_close(L[i], L1, rtol=1e-12, atol=1e-12)
        assert float(delta[i]) == float(d1)
    assert float(delta[1]) > 0.0 == float(delta[0]) == float(delta[2])


def test_lanewise_block_tridiag_cholesky_matches_single():
    rng = np.random.default_rng(1)
    k, nb = 4, 5
    A = rng.standard_normal((2, k, nb, nb))
    A = A @ A.transpose(0, 1, 3, 2) + 6 * np.eye(nb)
    E = 0.3 * rng.standard_normal((2, k - 1, nb, nb))
    A[1, 2] = -1e-9 * np.eye(nb)  # lane 1 fails unshifted, passes once shifted
    E[1, 1:] = 0.0
    At, Et = torch.as_tensor(A), torch.as_tensor(E)
    L, C, delta = run(tl.block_tridiag_cholesky_lanes_prog(At, Et))
    for i in range(2):
        L1, C1, d1 = tl.block_tridiag_cholesky(At[i], Et[i])
        torch.testing.assert_close(L[i], L1, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(C[i], C1, rtol=1e-12, atol=1e-12)
        assert float(delta[i]) == float(d1)
    assert float(delta[1]) > 0.0 == float(delta[0])


# --------------------------------------------------------------------------
# the batched QP simplex
# --------------------------------------------------------------------------


def test_batch_qp_simplex_parametric_sweep_matches_jax():
    """tests/test_batch.py::test_batch_qp_simplex_parametric_sweep: each
    lane the JAX package's status, objective and iteration count, and the
    port's own single QP simplex; the frontier is monotone in gamma."""
    from clp_tpu_torch.simplex.qp import qp_simplex_solve

    gammas = np.linspace(0.5, 8.0, 8)
    models = [_portfolio_qp(16, g, seed=0) for g in gammas]
    jsols = jb.solve_batch_qp_simplex([m.copy() for m in models])
    tms = [port_model(m) for m in models]
    tsols = tb.solve_batch_qp_simplex([m.copy() for m in tms], _cpu())
    _same(tsols, jsols)
    for tm, s in zip(tms, tsols):
        ref = qp_simplex_solve(tm.copy(), _cpu())
        assert ref.status == ProblemStatus.OPTIMAL
        assert abs(s.objective_value - ref.objective_value) <= 1e-9 * (1 + abs(ref.objective_value))
    risks = [float(s.primal @ (tm.quadratic_objective @ s.primal)) / g
             for s, tm, g in zip(tsols, tms, gammas)]
    assert all(risks[i + 1] <= risks[i] + 1e-9 for i in range(len(risks) - 1))


def test_batch_qp_simplex_refuses_lps():
    models = [port_model(m) for m in _perturbed_models(count=2)]
    with pytest.raises(ValueError):
        tb.solve_batch_qp_simplex(models, _cpu())


# --------------------------------------------------------------------------
# the mesh cases of tests/test_batch.py (more in tests/test_torch_mesh.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["solve_batch", "dual", "qp"])
def test_mesh_raises_multi_device(entry):
    """A 2-entry CPU mesh (it raised until the last slice of the port): the
    lanes are the unsharded batch's, and the JAX package's over 2 XLA CPU
    devices."""
    from clp_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from clp_tpu_torch.parallel.mesh import make_mesh

    if entry == "qp":
        jmodels = [_portfolio_qp(8, g, seed=2) for g in (1.0, 3.0)]
    else:
        jmodels = _perturbed_models(count=2)
    tfn, jfn = {"solve_batch": (clp_tpu_torch.solve.solve_batch, clp_tpu.solve_batch),
                "dual": (tb.solve_batch_dual_simplex, jb.solve_batch_dual_simplex),
                "qp": (tb.solve_batch_qp_simplex, jb.solve_batch_qp_simplex)}[entry]
    jsols = jfn([m.copy() for m in jmodels], mesh=jax_make_mesh(jax.devices()[:2]))
    plain = tfn([port_model(m) for m in jmodels], _cpu())
    sharded = tfn([port_model(m) for m in jmodels], _cpu(), mesh=make_mesh(["cpu", "cpu"]))
    _same(sharded, jsols)
    _same(sharded, plain)
