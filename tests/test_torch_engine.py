"""Port parity of the dual simplex engine: one pivot from a shared
mid-solve state, and whole f64 solves (clp_tpu_torch vs clp_tpu, CPU)."""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from clp_tpu.forms import to_standard_form as jax_standard_form
from clp_tpu.simplex import engine as je
from clp_tpu.utils import generators as jgen

from clp_tpu_torch import convert
from clp_tpu_torch.forms import to_standard_form
from clp_tpu_torch.simplex import engine as te
from clp_tpu_torch.utils import generators as tgen
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _fields(x) -> dict:
    return {k: (None if v is None else np.asarray(v)) for k, v in vars(x).items()}


def _jax_start(lp, opts):
    st = je.initial_state(lp, opts)
    st = je.recompute(lp, st, opts.dual_bound)
    return je.make_dual_feasible(lp, st, opts)


def _torch_start(lp, opts):
    st = te.initial_state(lp, opts)
    st = te.recompute(lp, st, opts.dual_bound)
    return te.make_dual_feasible(lp, st, opts)


# (dual_ratio, inverse_dtype, use_pallas_price, use_pallas_pivot)
ONE_PIVOT_CASES = [
    ("harris", "float64", False, False),
    ("bfrt", "float64", False, False),
    ("harris", "float32", False, False),
    ("bfrt", "float32", False, False),
    ("bfrt", "float32", True, True),  # K1 and K2 twins vs Pallas interpret
]


@pytest.mark.parametrize("ratio, inv, k1, k2", ONE_PIVOT_CASES)
def test_one_pivot_from_shared_state(ratio, inv, k1, k2):
    model = jgen.random_lp(12, 20, seed=5)
    kw = dict(dual_ratio=ratio, inverse_dtype=inv, use_pallas_price=k1,
              use_pallas_pivot=k2)
    jopts = je.SimplexOptions(**kw)
    topts = te.SimplexOptions(**kw)
    jlp, _ = jax_standard_form(model)
    G32j = jlp.G.astype(jnp.float32) if (inv == "float32" or k1) else None
    step = jax.jit(partial(je.dual_iteration, opts=jopts, G32=G32j))
    st = _jax_start(jlp, jopts)
    for _ in range(3):  # walk into the solve so binv is no longer trivial
        st = step(jlp, st)
    assert int(st.status) == je.CONTINUE and int(st.iterations) == 3

    tlp = convert.standard_lp_from_numpy(_fields(jlp), "cpu")
    tst = convert.simplex_state_from_numpy(_fields(st), "cpu")
    assert tst.binv.dtype == (torch.float32 if inv == "float32" else torch.float64)
    G32t = tlp.G.to(torch.float32) if G32j is not None else None
    j1 = step(jlp, st)
    t1 = convert.simplex_state_to_numpy(te.dual_iteration(tlp, tst, topts, G32=G32t))

    assert int(j1.iterations) == 4, "the shared state must pivot"
    # the same leaving row r and entering column q: basis holds both
    np.testing.assert_array_equal(t1["basis"], np.asarray(j1.basis))
    np.testing.assert_array_equal(t1["vstat"], np.asarray(j1.vstat))
    assert int(t1["iterations"]) == int(j1.iterations)
    assert int(t1["status"]) == int(j1.status)
    assert bool(t1["refactor_now"]) == bool(j1.refactor_now)
    tol = 1e-5 if inv == "float32" else 1e-10
    for f in ("binv", "xb", "dj", "weights"):
        a, b = t1[f], np.asarray(getattr(j1, f))
        assert a.dtype == b.dtype, f
        assert np.abs(a - b).max() <= tol * (1 + np.abs(b).max()), f


def _objective(c, basis, xb, vstat, l, u, dual_bound=1e10):
    vlo = np.where(np.isfinite(l), l, -dual_bound)
    vup = np.where(np.isfinite(u), u, dual_bound)
    x = np.where(vstat == je.AT_LOWER, vlo, np.where(vstat == je.AT_UPPER, vup, 0.0))
    x = np.where(vstat == je.BASIC, 0.0, x)
    x[basis] = xb
    return float(c @ x)


def solve_both(name, args, kw, jopts, topts, primal=False):
    mj = getattr(jgen, name)(*args, **kw)
    mt = getattr(tgen, name)(*args, **kw)
    jlp, _ = jax_standard_form(mj)
    tlp, _ = to_standard_form(mt, device="cpu")
    if primal:
        js = je.primal_solve(jlp, je.initial_state(jlp, jopts), jopts)
        ts = te.primal_solve(tlp, te.initial_state(tlp, topts), topts)
    else:
        js = je.dual_solve(jlp, _jax_start(jlp, jopts), jopts)
        ts = te.dual_solve(tlp, _torch_start(tlp, topts), topts)
    l, u, c = (np.asarray(getattr(jlp, f)) for f in ("l", "u", "c"))
    jres = (int(js.status), int(js.iterations),
            _objective(c, np.asarray(js.basis), np.asarray(js.xb), np.asarray(js.vstat), l, u))
    tn = convert.simplex_state_to_numpy(ts)
    tres = (int(tn["status"]), int(tn["iterations"]),
            _objective(c, tn["basis"], tn["xb"], tn["vstat"], l, u))
    return jres, tres


ENGINE_LPS = [
    ("random_lp", (10, 16), {"seed": 3}),
    ("staircase_lp", (), {}),
    ("transport_lp", (4, 6), {"seed": 1}),
]
# The unscaled 200 x 320 staircase takes 329 pivots in the JAX package and
# 349 in the port. Every single pivot agrees to < 1e-13 relative when both
# start from the same state (test_one_pivot_from_shared_state and a
# per-pivot resync over the first 300 pivots), but the two sum their dense
# products (B^-1 @ [g_q | rho | f_delta], y @ G) in different orders, and the
# steepest-edge weight recurrence amplifies those last-bit differences
# through its cancellations: by pivot 297 the weights differ by O(1) and a
# different row leaves. Status and objective still agree.
EXACT_COUNT = {"random_lp": True, "staircase_lp": False, "transport_lp": True}


@pytest.mark.parametrize("name, args, kw", ENGINE_LPS, ids=[e[0] for e in ENGINE_LPS])
def test_dual_solve_f64_parity(name, args, kw):
    opts = dict(max_iterations=5000)  # f64, Harris, steepest edge, U = 1
    (js, ji, jo), (ts, ti, to) = solve_both(
        name, args, kw, je.SimplexOptions(**opts), te.SimplexOptions(**opts))
    assert js == ts == je.OPTIMAL
    assert abs(to - jo) <= 1e-9 * (1 + abs(jo))
    if EXACT_COUNT[name]:
        assert ti == ji


@pytest.mark.parametrize("pivot", ["steepest", "dantzig"])
@pytest.mark.parametrize("name, args, kw", ENGINE_LPS[:2], ids=[e[0] for e in ENGINE_LPS[:2]])
def test_dual_solve_f64_bfrt_parity(name, args, kw, pivot):
    opts = dict(max_iterations=5000, dual_ratio="bfrt", dual_pivot=pivot)
    (js, ji, jo), (ts, ti, to) = solve_both(
        name, args, kw, je.SimplexOptions(**opts), te.SimplexOptions(**opts))
    assert js == ts == je.OPTIMAL
    assert abs(to - jo) <= 1e-9 * (1 + abs(jo))
    assert ti == ji
