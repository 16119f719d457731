"""Port parity for crash.py: the idiot descent, the triangular crash, and
the three routes they start (AUTOMATIC's idiot dual, PRIMAL_IDIOT and
crash="idiot"/"triangular") against the JAX package on the same LPs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import clp_tpu
from clp_tpu.crash import (
    _idiot_descend as jax_idiot_descend,
    apply_triangular_crash as jax_apply_triangular_crash,
    triangular_crash as jax_triangular_crash,
)
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch import crash
from tests.test_torch_auto import _covering_lp, _port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _descent_inputs(seed):
    """A 0/1 covering block (rows >= 1) and a ranged general block, with
    boxed, one-sided and free columns: every clamp bound kind."""
    rng = np.random.default_rng(seed)
    m, n = 24, 60
    A = (rng.random((m, n)) < 0.2) * 1.0
    A[m // 2:] = rng.normal(size=(m - m // 2, n)) * (rng.random((m - m // 2, n)) < 0.3)
    rl = np.concatenate([np.ones(m // 2), -rng.random(m - m // 2)])
    ru = np.concatenate([np.full(m // 2, np.inf), rng.random(m - m // 2)])
    cl = np.where(rng.random(n) < 0.8, 0.0, -np.inf)
    cu = np.where(rng.random(n) < 0.5, 1.0, np.inf)
    c = rng.integers(1, 5, n).astype(float)
    return A, c, rl, ru, cl, cu, np.clip(np.zeros(n), cl, cu)


@pytest.mark.parametrize("seed", [0, 1])
def test_idiot_descend_matches_jax(seed):
    """The same FISTA schedule on the same A, c and bounds: x within 1e-9
    relative (f64 sums in another order)."""
    args = _descent_inputs(seed)
    xj = np.asarray(jax_idiot_descend(*(jnp.asarray(a) for a in args), 0.5,
                                      majors=12, minors=25))
    xt = crash._idiot_descend(*(torch.as_tensor(a) for a in args), 0.5, 12, 25).numpy()
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-9 * np.abs(xj).max())


@pytest.mark.parametrize("make", [
    lambda: jgen.staircase_lp(nblocks=4, bm=8, bn=20, seed=0),
    lambda: jgen.random_lp(30, 50, seed=4, density=0.2),
    lambda: _covering_lp(40, 120, seed=2),
], ids=["staircase", "random", "covering"])
def test_triangular_crash_matches_jax(make):
    """A numpy copy: identical statuses, and the same pending warm basis."""
    mj = make()
    mt = _port_model(mj)
    sj, st = jax_triangular_crash(mj), crash.triangular_crash(mt)
    np.testing.assert_array_equal(st.column_status, sj.column_status)
    np.testing.assert_array_equal(st.row_status, sj.row_status)
    jax_apply_triangular_crash(mj)
    crash.apply_triangular_crash(mt)
    assert mt.warm_start_pending and mj.warm_start_pending
    np.testing.assert_array_equal(mt.solution.column_status, mj.solution.column_status)


def test_apply_idiot_crash_leaves_the_point():
    mt = _port_model(_covering_lp(40, 120, seed=2))
    assert crash.apply_idiot_crash(mt, passes=10, device="cpu") == 0
    x = mt.solution.primal
    assert x.shape == (120,) and np.all((x >= -1e-12) & (x <= 1 + 1e-12))
    np.testing.assert_allclose(mt.solution.row_activity, mt.matrix @ x)


@pytest.mark.parametrize("method, kw", [
    ("AUTOMATIC", {}),
    ("PRIMAL_IDIOT", {}),
    ("DUAL_SIMPLEX", {"crash": "idiot"}),
    ("DUAL_SIMPLEX", {"crash": "triangular"}),
    ("PRIMAL_SIMPLEX", {"crash": "triangular"}),
], ids=["auto-idiot-dual", "primal-idiot", "dual-idiot", "dual-triangular",
        "primal-triangular"])
def test_crash_routes_match_jax(method, kw):
    """The covering LP through each crash route: AUTOMATIC lands on the
    idiot-warm dual (as in the JAX package); the same status and the
    objective within 1e-9 relative."""
    mj = _covering_lp(256, 1600)
    mt = _port_model(mj)
    sj = clp_tpu.initial_solve(mj, clp_tpu.SolveOptions(
        method=clp_tpu.SolveMethod[method], **kw))
    st = clp_tpu_torch.initial_solve(mt, clp_tpu_torch.SolveOptions(
        method=clp_tpu_torch.SolveMethod[method], device="cpu", **kw))
    assert st.status == sj.status == clp_tpu.ProblemStatus.OPTIMAL
    assert abs(st.objective_value - sj.objective_value) <= 1e-9 * abs(sj.objective_value)
    assert clp_tpu_torch.check_kkt(mt, x=st.primal, y=st.duals, tol=1e-7).ok
