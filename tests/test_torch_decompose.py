"""Port parity of the decomposition: Benders over the batched IPM,
Dantzig-Wolfe, the block-structure detection, and DECOMPOSE through
AUTOMATIC (clp_tpu_torch vs clp_tpu, CPU). A device error in the scenario
solve propagates; only the decomposition's own failures fall back."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clp_tpu
import clp_tpu.decompose as jdec
import clp_tpu.structure as jstruct

import clp_tpu_torch
import clp_tpu_torch.decompose as tdec
import clp_tpu_torch.structure as tstruct
from clp_tpu_torch.constants import ProblemStatus
from tests.test_decompose import _flat_two_stage, _two_stage
from tests.test_torch_qp import port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _cpu(**kw):
    return clp_tpu_torch.SolveOptions(device="cpu", **kw)


def _port_ts(ts) -> tdec.TwoStageLP:
    return tdec.TwoStageLP(**vars(ts))


def test_extensive_form_matches_jax():
    ts = _two_stage()
    a, b = jdec.extensive_form(ts), tdec.extensive_form(_port_ts(ts))
    assert (a.matrix != b.matrix).nnz == 0
    for k in ("col_lower", "col_upper", "objective", "row_lower", "row_upper"):
        assert np.array_equal(getattr(a, k), getattr(b, k))


def test_scenario_sweep_matches_jax():
    """Every scenario's recourse LP in one batched IPM call, at one x."""
    ts = _two_stage(S=8)
    x = np.full(ts.c.size, 0.5)
    jv, jpi = jdec._solve_scenarios_batched(ts, x, clp_tpu.SolveOptions())
    tv, tpi = tdec._solve_scenarios_batched(_port_ts(ts), x, _cpu())
    np.testing.assert_allclose(tv, jv, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tpi, jpi, rtol=1e-6, atol=1e-7)


def test_benders_matches_jax():
    """Benders at the flat test's size: the JAX package's iterations,
    objective and first-stage point."""
    ts = _two_stage(S=16, n1=4, m2=16, n2=40, seed=2)
    jsol, jx = jdec.benders_solve(ts)
    tsol, tx = tdec.benders_solve(_port_ts(ts), _cpu())
    assert tsol.status == ProblemStatus.OPTIMAL and int(jsol.status) == int(tsol.status)
    assert tsol.iterations == jsol.iterations
    assert abs(tsol.objective_value - jsol.objective_value) <= 1e-9 * (
        1 + abs(jsol.objective_value))
    np.testing.assert_allclose(tx, jx, atol=1e-7)


def test_benders_matches_extensive_form():
    """tests/test_decompose.py::test_benders_matches_extensive_form, in the
    port alone: the JAX package compiles its vmapped IPM anew in each of the
    16 Benders iterations here (~80 s on this CPU)."""
    ts = _port_ts(_two_stage())
    tsol, _ = tdec.benders_solve(ts, _cpu())
    assert tsol.status == ProblemStatus.OPTIMAL
    ref = clp_tpu_torch.initial_solve(tdec.extensive_form(ts), _cpu())
    assert abs(tsol.objective_value - ref.objective_value) < 1e-5 * (1 + abs(ref.objective_value))


def _dw_case(pkg):
    """tests/test_decompose.py::test_dantzig_wolfe_matches_direct's data."""
    rng = np.random.default_rng(3)

    def block():
        m = pkg.Model()
        m.load_problem(sp.csc_matrix(rng.uniform(0, 1, (3, 6))), np.zeros(6), np.ones(6),
                       rng.uniform(-2, -0.5, 6), np.full(3, -pkg.INF),
                       rng.uniform(2.0, 3.0, 3))
        return m

    L = sp.csc_matrix(np.ones((1, 6)))
    return [block(), block()], [L, L], np.array([-pkg.INF]), np.array([4.0])


def test_dantzig_wolfe_matches_jax():
    """The same status, objective and block points. The master rounds
    differ (6 in the JAX package, 5 in the port) with the same answer:
    summation order (ROADMAP.md queue 3 item 5), shown by the next test."""
    jsol = jdec.dantzig_wolfe(*_dw_case(clp_tpu))
    tsol = tdec.dantzig_wolfe(*_dw_case(clp_tpu_torch), _cpu())
    assert tsol.status == ProblemStatus.OPTIMAL and int(jsol.status) == int(tsol.status)
    assert (tsol.iterations, jsol.iterations) == (5, 6)
    assert abs(tsol.objective_value - jsol.objective_value) <= 1e-9 * (
        1 + abs(jsol.objective_value))
    np.testing.assert_allclose(tsol.primal, jsol.primal, atol=1e-9)


def test_dantzig_wolfe_rounds_differ_by_summation_order_only(monkeypatch):
    """Why the rounds differ: the block solves' vertices differ from the
    JAX package's in the last bits, so the masters' costs do (the big-M
    artificial cost, 1e6 * (1 + max |cost|), by one ulp); the degenerate
    fourth master then takes 8 pivots to another optimal dual where the
    JAX package's takes 7. Given the JAX package's own master LPs, the
    port's dual simplex takes its pivots to its duals, every round."""
    masters = {"jax": [], "port": []}
    for key, pkg in (("jax", clp_tpu), ("port", clp_tpu_torch)):
        inner = pkg.Model.initial_solve

        def spy(self, opts=None, _inner=inner, _key=key):
            sol = _inner(self, opts)
            if self.num_rows == 3 and self.num_cols >= 8:  # the 1 + 2-row masters
                masters[_key].append((self.copy(), sol))
            return sol

        monkeypatch.setattr(pkg.Model, "initial_solve", spy)
    jdec.dantzig_wolfe(*_dw_case(clp_tpu))
    tdec.dantzig_wolfe(*_dw_case(clp_tpu_torch), _cpu())
    for (jm, js), (tm, ts) in zip(masters["jax"], masters["port"]):
        assert np.allclose(tm.objective, jm.objective, rtol=1e-15, atol=0)
    assert [s.iterations for _, s in masters["jax"][:3]] == [5, 6, 7]
    assert [s.iterations for _, s in masters["port"][:3]] == [5, 6, 8]
    o = _cpu(method=clp_tpu_torch.SolveMethod.DUAL_SIMPLEX)
    o.presolve.enabled = False
    for jm, js in masters["jax"]:
        ts = clp_tpu_torch.initial_solve(port_model(jm), o)
        assert ts.iterations == js.iterations
        np.testing.assert_allclose(ts.duals, js.duals, rtol=0, atol=1e-12)


def test_build_two_stage_matches_jax():
    _, flat = _flat_two_stage()
    jts = jstruct.build_two_stage(flat, jstruct.detect_two_stage(flat))
    tflat = port_model(flat)
    tts = tstruct.build_two_stage(tflat, tstruct.detect_two_stage(tflat))
    for k in ("c", "row_lower", "row_upper", "col_lower", "col_upper", "T", "W", "h", "q",
              "prob"):
        assert np.array_equal(getattr(jts, k), getattr(tts, k)), k
    assert (jts.A != tts.A).nnz == 0


def test_detect_block_angular_matches_jax():
    """tests/test_decompose.py::test_detect_block_angular's model."""
    rng = np.random.default_rng(5)
    K, mb, nb_ = 6, 10, 14
    blocks = [sp.random(mb, nb_, density=0.5, random_state=int(rng.integers(1e6)),
                        data_rvs=lambda s: rng.uniform(0.5, 1.5, s)) for _ in range(K)]
    A = sp.vstack([sp.csc_matrix(np.ones((2, K * nb_))), sp.block_diag(blocks)]).tocsc()
    m = clp_tpu.Model()
    m.load_problem(A, np.zeros(K * nb_), np.ones(K * nb_), rng.uniform(-2, -0.5, K * nb_),
                   np.full(2 + K * mb, -clp_tpu.INF),
                   np.concatenate([[4.0, 5.0], rng.uniform(2, 3, K * mb)]))
    jd = jstruct.detect_block_angular(m)
    td = tstruct.detect_block_angular(port_model(m))
    assert np.array_equal(jd.linking_rows, td.linking_rows)
    assert 0 in td.linking_rows and 1 in td.linking_rows
    for a, b in zip(jd.block_rows + jd.block_cols, td.block_rows + td.block_cols):
        assert np.array_equal(a, b)
    assert tstruct.detect_block_angular(port_model(clp_tpu.utils.generators.random_lp(
        96, 160, seed=0))) is None


def test_flat_two_stage_auto_solves_via_benders_like_jax(monkeypatch):
    """tests/test_decompose.py::test_flat_two_stage_auto_solves_via_benders:
    AUTOMATIC routes the flat model to auto_decompose_solve, whose Benders
    and verified finish give the JAX package's objective; KKT holds."""
    _, flat = _flat_two_stage()
    jsol = clp_tpu.initial_solve(flat.copy(), clp_tpu.SolveOptions())
    calls = {"auto": 0, "benders": 0}
    real_auto, real_b = tstruct.auto_decompose_solve, tdec.benders_solve

    def spy_auto(model, options):
        calls["auto"] += 1
        return real_auto(model, options)

    def spy_b(*a, **k):
        calls["benders"] += 1
        return real_b(*a, **k)

    monkeypatch.setattr(tstruct, "auto_decompose_solve", spy_auto)
    monkeypatch.setattr(tdec, "benders_solve", spy_b)
    tflat = port_model(flat)
    tsol = clp_tpu_torch.initial_solve(tflat, _cpu())
    assert calls["auto"] >= 1 and calls["benders"] >= 1
    assert tsol.status == ProblemStatus.OPTIMAL
    assert abs(tsol.objective_value - jsol.objective_value) <= 1e-9 * (
        1 + abs(jsol.objective_value))
    assert clp_tpu_torch.check_kkt(tflat, x=tsol.primal, y=tsol.duals, tol=1e-6).ok


def test_decomposition_failure_falls_back_to_the_dual(monkeypatch):
    """The decomposition's own failure (DecompositionError) falls back to
    the plain dual, as the JAX package does on its RuntimeError."""
    def fail(*a, **k):
        raise tdec.DecompositionError("scenario did not converge")

    monkeypatch.setattr(tdec, "benders_solve", fail)
    _, flat = _flat_two_stage()
    tflat = port_model(flat)
    assert tstruct.auto_decompose_solve(tflat, _cpu()) is None
    sol = clp_tpu_torch.initial_solve(tflat, _cpu())
    assert sol.status == ProblemStatus.OPTIMAL
    assert clp_tpu_torch.check_kkt(tflat, x=sol.primal, y=sol.duals, tol=1e-6).ok


def test_a_device_error_in_the_scenario_solve_propagates(monkeypatch):
    """A RuntimeError that is not the port's own (torch raises CUDA errors
    so) is not taken for a failed decomposition: the JAX package's
    `except RuntimeError` fallback is narrowed to DecompositionError."""
    from clp_tpu_torch.interior import mehrotra

    def boom(lp, opts):
        raise RuntimeError("CUDA error: device-side assert triggered")

    monkeypatch.setattr(mehrotra, "ipm_solve_batched", boom)
    _, flat = _flat_two_stage()
    with pytest.raises(RuntimeError, match="device-side assert"):
        clp_tpu_torch.initial_solve(port_model(flat), _cpu())


def test_nonconverging_scenarios_raise_decomposition_error():
    ts = _port_ts(_two_stage(S=4))
    ts.W = np.zeros_like(ts.W)  # no recourse: W y = h - T x has no solution
    with pytest.raises(tdec.DecompositionError):
        tdec._solve_scenarios_batched(ts, np.zeros(ts.c.size), _cpu())
