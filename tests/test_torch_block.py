"""Port parity of the block-banded PRICE route (price_mode="block", K3):
the block forms, K3's plain version, the pivot body's block branches and
whole solves, clp_tpu_torch against clp_tpu on the CPU.

Where the JAX function reaches the Pallas kernel it runs in interpret mode,
as tests/test_pallas.py runs it. The CUDA kernel is held to the same plain
version on the card in tests/test_torch_cuda.py.
"""

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import clp_tpu
from clp_tpu.forms import to_standard_form as jax_standard_form
from clp_tpu.ops.pallas_price import price_and_ratios_block as jax_price_block
from clp_tpu.simplex import driver as jdrv
from clp_tpu.simplex import engine as je
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch import convert
from clp_tpu_torch.ops import price
from clp_tpu_torch.ops.price import price_and_ratios_block
from clp_tpu_torch.simplex import driver as tdrv
from clp_tpu_torch.simplex import engine as te
from clp_tpu_torch.utils import generators as tgen

from test_torch_cuda import assert_price_close

torch.set_num_threads(2)

STAIR = (8, 32, 72)  # staircase_lp(nblocks, bm, bn): 256 x 576, standard form 256 x 832


def _fields(x) -> dict:
    return {k: (None if v is None else np.asarray(v)) for k, v in vars(x).items()}


def banded_g():
    """The block-banded G and geometry of tests/test_pallas.py's K3 test."""
    rng = np.random.default_rng(0)
    m, nt, nb, H, CB = 64, 384, 3, 40, 128
    G = np.zeros((m, nt))
    for j in range(nt):
        lo = min(int(j / nt * (m - 20)), m - 20)
        G[lo:lo + 16, j] = rng.normal(size=16) * (rng.random(16) < 0.5)
    return G, (nb, H, CB)


def sorted_staircase():
    """The standard form of staircase_lp(8, 32, 72) and its copy in the
    driver's sorted column order, with the probe's geometry (nb, H, CB)
    and the permutation."""
    nb, H, CB, perm = tdrv.block_geometry(tgen.staircase_lp(*STAIR, seed=0))
    jlp, _ = jax_standard_form(jgen.staircase_lp(*STAIR, seed=0))
    pj = jnp.asarray(perm)
    jlp_s = dataclasses.replace(jlp, G=jlp.G[:, pj], c=jlp.c[pj], l=jlp.l[pj],
                                u=jlp.u[pj])
    return jlp, jlp_s, (nb, H, CB), perm


def geometry_case(which):
    if which == "banded":
        return banded_g()
    _, jlp_s, geo, _ = sorted_staircase()
    return np.asarray(jlp_s.G), geo


# ---------------------------------------------------------------------------
# (a) block_forms, (c) the block helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("which", ["banded", "staircase"])
def test_block_forms_bit_equal(which, dtype):
    G, (nb, H, CB) = geometry_case(which)
    G = G.astype(dtype)
    sj, Wj, m8j = je.block_forms(jnp.asarray(G), nb, H, CB)
    st, Wt, m8t = te.block_forms(torch.as_tensor(G), nb, H, CB)
    assert m8t == m8j and st.dtype == torch.int32 and Wt.dtype == torch.from_numpy(G).dtype
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert Wt.shape == (nb, H, CB)
    np.testing.assert_array_equal(Wt.numpy(), np.asarray(Wj))
    # and back through convert, as the pivot-body tests hand them over
    s2, W2, m82 = convert.block_forms_from_numpy((sj, Wj, m8j), "cpu")
    assert torch.equal(s2, st) and torch.equal(W2, Wt) and m82 == m8t
    s3, W3, m83 = convert.block_forms_to_numpy((st, Wt, m8t))
    assert s3.dtype == np.int32 and m83 == m8j
    np.testing.assert_array_equal(W3, np.asarray(Wj))


@pytest.mark.parametrize("which", ["banded", "staircase"])
def test_block_helpers_f64(which):
    G, (nb, H, CB) = geometry_case(which)
    m, nt = G.shape
    rng = np.random.default_rng(1)
    blk_j = je.block_forms(jnp.asarray(G), nb, H, CB)
    blk_t = convert.block_forms_from_numpy(blk_j, "cpu")
    rho = rng.standard_normal(m)
    a_j = je._blk_price(jnp.asarray(rho), blk_j, jnp.float64, nt)
    a_t = te._blk_price(torch.as_tensor(rho), blk_t, torch.float64, nt)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(a_t.numpy(), rho @ G, rtol=1e-12, atol=1e-12)
    for q in (0, 1, CB - 1, CB, nt // 2, nt - 1):
        c_j = je._blk_col(jnp.asarray(q), blk_j, m)
        c_t = te._blk_col(torch.tensor(q), blk_t, m)
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
        np.testing.assert_array_equal(c_t.numpy(), G[:, q])
    x = rng.standard_normal(nt) * (rng.random(nt) < 0.3)
    f_j = je._blk_matvec(jnp.asarray(x), blk_j, m)
    f_t = te._blk_matvec(torch.as_tensor(x), blk_t, m)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(f_t.numpy(), G @ x, rtol=1e-12, atol=1e-12)
    # the flow is computed every pivot: no flips give exactly zero
    assert not te._blk_matvec(torch.zeros(nt, dtype=torch.float64), blk_t, m).any()


# ---------------------------------------------------------------------------
# (b) K3's plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


def k3_inputs():
    """K3 inputs on the test_pallas.py geometry from a numpy seed, padded
    to nb*CB as the pivot body pads them."""
    G, (nb, H, CB) = banded_g()
    m, nt = G.shape
    starts, W, m8 = je.block_forms(jnp.asarray(G, jnp.float32), nb, H, CB)
    rng = np.random.default_rng(2)
    pad = nb * CB - nt
    return dict(
        rho_p=np.concatenate([rng.standard_normal(m), np.zeros(m8 - m)]).astype(np.float32),
        starts=np.asarray(starts), W=np.asarray(W),
        dj=np.concatenate([np.abs(rng.standard_normal(nt)), np.zeros(pad)]).astype(np.float32),
        elig=np.concatenate([rng.random(nt) < 0.6, np.zeros(pad, bool)]).astype(np.int32),
        sgn=np.concatenate([np.where(rng.random(nt) < 0.5, 1.0, -1.0),
                            np.ones(pad)]).astype(np.float32),
    )


@pytest.mark.parametrize("sigma", [1.0, -1.0])
def test_block_price_twin_matches_jax_kernel(sigma):
    x = k3_inputs()
    rel, ptol = 5e-8, 1e-9
    a_j, r_j = jax_price_block(*(jnp.asarray(x[k]) for k in
                                 ("rho_p", "starts", "W", "dj", "elig", "sgn")),
                               jnp.asarray(sigma), rel, ptol, interpret=True)
    t = {k: torch.tensor(v) for k, v in x.items()}
    n = price_and_ratios_block.launches
    a_t, r_t = price_and_ratios_block(t["rho_p"], t["starts"], t["W"], t["dj"],
                                      t["elig"], t["sgn"], torch.tensor(sigma), rel, ptol)
    assert price_and_ratios_block.launches == n  # the CPU runs the plain version
    assert a_t.dtype == r_t.dtype == torch.float32 and a_t.shape == (3 * 128,)
    assert_price_close(a_t.numpy(), r_t.numpy(), np.asarray(a_j), np.asarray(r_j))


def test_block_price_wrapper_checks_its_inputs():
    t = {k: torch.tensor(v) for k, v in k3_inputs().items()}
    args = [t[k] for k in ("rho_p", "starts", "W", "dj", "elig", "sgn")]
    with pytest.raises(ValueError, match="float32"):
        price_and_ratios_block(*args[:2], args[2].double(), *args[3:], 1.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="dj"):
        price_and_ratios_block(*args[:3], args[3][:-1], *args[4:], 1.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="window height"):
        price_and_ratios_block(args[0][:16], *args[1:], 1.0, 0.0, 0.0)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        price_and_ratios_block(*meta, 1.0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# (d) one dual pivot with the block form from a shared mid-solve state
# ---------------------------------------------------------------------------

# (dual_ratio, inverse_dtype, use_pallas_price (K3), use_pallas_pivot (K2))
ONE_PIVOT_CASES = [
    ("harris", "float64", False, False),
    ("bfrt", "float64", False, False),
    ("bfrt", "float32", False, False),
    ("bfrt", "float32", True, False),  # K3's twin vs the Pallas kernel in interpret mode
    ("bfrt", "float32", True, True),  # with K2's twin too
]


@pytest.mark.parametrize("ratio, inv, k3, k2", ONE_PIVOT_CASES)
def test_one_block_pivot_from_shared_state(ratio, inv, k3, k2):
    jlp0, jlp, (nb, H, CB), perm = sorted_staircase()
    kw = dict(dual_ratio=ratio, inverse_dtype=inv, use_pallas_price=k3,
              use_pallas_pivot=k2, price_mode="block", price_block_nb=nb,
              price_block_h=H, price_block_cb=CB)
    jopts = je.SimplexOptions(**kw)
    topts = te.SimplexOptions(**kw)
    f32 = inv == "float32" or k3
    blk_j = je.block_forms(jlp.G.astype(jnp.float32) if f32 else jlp.G, nb, H, CB)
    step = jax.jit(partial(je.dual_iteration, opts=jopts, blk=blk_j))
    # the all-slack start is built in the original column order (slacks
    # last), then relabelled to the sorted order, as the driver does
    st = je.initial_state(jlp0, jopts)
    st = dataclasses.replace(st, vstat=st.vstat[perm], dj=st.dj[perm],
                             basis=jnp.asarray(np.argsort(perm), jnp.int32)[st.basis])
    st = je.make_dual_feasible(jlp, je.recompute(jlp, st, jopts.dual_bound), jopts)
    for _ in range(5):  # walk into the solve so binv is no longer trivial
        st = step(jlp, st)
    assert int(st.status) == je.CONTINUE and int(st.iterations) == 5

    tlp = convert.standard_lp_from_numpy(_fields(jlp), "cpu")
    tst = convert.simplex_state_from_numpy(_fields(st), "cpu")
    blk_t = convert.block_forms_from_numpy(blk_j, "cpu")
    assert blk_t[1].dtype == (torch.float32 if f32 else torch.float64)
    j1 = step(jlp, st)
    t1 = convert.simplex_state_to_numpy(te.dual_iteration(tlp, tst, topts, blk=blk_t))

    assert int(j1.iterations) == 6, "the shared state must pivot"
    # the same leaving row r and entering column q: basis holds both
    np.testing.assert_array_equal(t1["basis"], np.asarray(j1.basis))
    np.testing.assert_array_equal(t1["vstat"], np.asarray(j1.vstat))
    assert int(t1["status"]) == int(j1.status)
    assert bool(t1["refactor_now"]) == bool(j1.refactor_now)
    tol = 1e-5 if inv == "float32" else 1e-10
    for f in ("binv", "xb", "dj", "weights"):
        a, b = t1[f], np.asarray(getattr(j1, f))
        assert a.dtype == b.dtype, f
        assert np.abs(a - b).max() <= tol * (1 + np.abs(b).max()), f


# ---------------------------------------------------------------------------
# (e), (f) whole solves through the driver
# ---------------------------------------------------------------------------


def _capture_geometry(monkeypatch, module):
    """Record the (nb, H, CB) that `module.simplex_solve` hands the engine."""
    seen = []
    orig = module.dual_solve

    def spy(lp, state, opts):
        seen.append((opts.price_block_nb, opts.price_block_h, opts.price_block_cb))
        return orig(lp, state, opts)

    monkeypatch.setattr(module, "dual_solve", spy)
    return seen


def _solve_both(monkeypatch, name, args, **kw):
    geo_j = _capture_geometry(monkeypatch, jdrv)
    geo_t = _capture_geometry(monkeypatch, tdrv)
    oj = clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.DUAL_SIMPLEX, **kw)
    oj.presolve.enabled = False
    ot = clp_tpu_torch.SolveOptions(method=clp_tpu_torch.SolveMethod.DUAL_SIMPLEX,
                                    device="cpu", **kw)
    ot.presolve.enabled = False
    sj = jdrv.simplex_solve(getattr(jgen, name)(*args), oj, dual=True)
    st = tdrv.simplex_solve(getattr(tgen, name)(*args), ot, dual=True)
    return sj, st, geo_j, geo_t


def test_block_solve_f64_parity(monkeypatch):
    sj, st, geo_j, geo_t = _solve_both(monkeypatch, "staircase_lp", STAIR,
                                       price_mode="block")
    assert geo_t == geo_j and geo_t[0] == (7, 104, 128)
    assert st.status.name == sj.status.name == "OPTIMAL"
    assert abs(st.objective_value - sj.objective_value) <= 1e-9 * (1 + abs(sj.objective_value))
    assert st.iterations == sj.iterations == 400
    # the solution comes back in the LP's own column order
    np.testing.assert_allclose(st.primal, sj.primal, rtol=0, atol=1e-7)
    np.testing.assert_allclose(st.duals, sj.duals, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(st.column_status, sj.column_status)
    np.testing.assert_array_equal(st.row_status, sj.row_status)
    # in f64 the block route takes the dense route's pivots
    ot = clp_tpu_torch.SolveOptions(method=clp_tpu_torch.SolveMethod.DUAL_SIMPLEX,
                                    device="cpu", price_mode="dense")
    ot.presolve.enabled = False
    dense = tdrv.simplex_solve(tgen.staircase_lp(*STAIR), ot, dual=True)
    assert dense.iterations == st.iterations
    assert abs(dense.objective_value - st.objective_value) <= 1e-9 * (
        1 + abs(st.objective_value))


def test_block_declines_on_unstructured_lp(monkeypatch):
    sj, st, geo_j, geo_t = _solve_both(monkeypatch, "random_lp", (30, 50),
                                       price_mode="block")
    assert tdrv.block_geometry(tgen.random_lp(30, 50)) is None
    assert geo_t == geo_j and geo_t[0] == (0, 0, 0)
    assert st.status.name == sj.status.name == "OPTIMAL"
    assert abs(st.objective_value - sj.objective_value) <= 1e-9 * (1 + abs(sj.objective_value))
    assert st.iterations == sj.iterations


def test_forced_k3_route_on_cpu(monkeypatch):
    """K3 forced on the CPU (f32 inverse): the port's wrapper runs its plain
    version, the JAX package its Pallas kernel in interpret mode.

    The two agree per pivot (test_one_block_pivot_from_shared_state), but
    each sums its f32 products in its own order (torch.bmm against the
    interpreted jnp.dot), and the f32 ratio test and steepest-edge weights
    turn last-bit differences into other pivot choices over a solve: the
    JAX package took 503 pivots here and the port 466. Status and the
    f64-verified objective agree.
    """
    calls = []
    ref = price.price_and_ratios_block_reference
    monkeypatch.setattr(price, "price_and_ratios_block_reference",
                        lambda *a: calls.append(1) or ref(*a))
    sj, st, geo_j, geo_t = _solve_both(
        monkeypatch, "staircase_lp", STAIR, price_mode="block",
        use_pallas_price=True, inverse_dtype="float32")
    assert geo_t == geo_j and geo_t[0] == (7, 104, 128)
    assert st.status.name == sj.status.name == "OPTIMAL"
    assert abs(st.objective_value - sj.objective_value) <= 1e-7 * (1 + abs(sj.objective_value))
    assert len(calls) >= st.iterations > 0  # every pivot priced through K3's wrapper


def test_initial_solve_block_parity():
    """The whole entry point (presolve, scaling, simplex, postsolve) with
    price_mode="block", port against JAX package."""
    mj, mt = jgen.staircase_lp(*STAIR), tgen.staircase_lp(*STAIR)
    sj = clp_tpu.initial_solve(mj, clp_tpu.SolveOptions(
        method=clp_tpu.SolveMethod.DUAL_SIMPLEX, price_mode="block"))
    st = clp_tpu_torch.initial_solve(mt, clp_tpu_torch.SolveOptions(
        method=clp_tpu_torch.SolveMethod.DUAL_SIMPLEX, price_mode="block", device="cpu"))
    assert st.status.name == sj.status.name == "OPTIMAL"
    assert abs(st.objective_value - sj.objective_value) <= 1e-9 * (1 + abs(sj.objective_value))
    np.testing.assert_allclose(st.primal, sj.primal, rtol=0, atol=1e-7)
    assert clp_tpu_torch.check_kkt(mt, x=st.primal, y=st.duals, tol=1e-6).ok
