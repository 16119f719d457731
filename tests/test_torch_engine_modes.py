"""Port parity of the engine's other modes: the primal simplex, the
mixed-precision engine with the K1 and K2 twins, +-1 (pm1) pricing, and
blocks of gated pivots (clp_tpu_torch vs clp_tpu, CPU)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from clp_tpu.forms import to_standard_form as jax_standard_form
from clp_tpu.model import Model as JaxModel
from clp_tpu.simplex import engine as je

from clp_tpu_torch.forms import to_standard_form
from clp_tpu_torch.model import Model as TorchModel
from clp_tpu_torch.simplex import engine as te

from test_torch_engine import _jax_start, _objective, _torch_start, solve_both
from tests.worker_threads import set_worker_threads

set_worker_threads()


# The devex update sets w_j = alpha_j^2 w_q / alpha_rq^2 along the pivot
# row, which leaves several columns with scores dj^2 / w that are equal in
# exact arithmetic (five of them at pivot 7 on this LP). The FTRAN column
# B^-1 a_q is summed in another order by torch's and XLA's CPU matvecs, so
# the last bits of those ties, and then the entering column, differ: 18
# pivots in the port against 16 in the JAX package. Dantzig and exact
# steepest edge have no such ties here and agree pivot for pivot.
EXACT_PRIMAL_COUNT = {"devex": False, "dantzig": True, "steepest": True, "partial": False}


@pytest.mark.parametrize("pivot", ["devex", "dantzig", "steepest", "partial"])
def test_primal_solve_f64_parity(pivot):
    opts = dict(max_iterations=5000, primal_pivot=pivot)
    (js, ji, jo), (ts, ti, to) = solve_both(
        "random_lp", (10, 16), {"seed": 3},
        je.SimplexOptions(**opts), te.SimplexOptions(**opts), primal=True)
    assert js == ts == je.OPTIMAL
    assert abs(to - jo) <= 1e-9 * (1 + abs(jo))
    if EXACT_PRIMAL_COUNT[pivot]:
        assert ti == ji


def test_mixed_engine_with_k1_twin_bfrt():
    """f32 inverse + K1 (twin here, Pallas interpret in JAX) + BFRT, the
    configuration the driver picks on the card: status and objective."""
    opts = dict(max_iterations=5000, inverse_dtype="float32", use_pallas_price=True,
                dual_ratio="bfrt", refactor_frequency=40)
    (js, _, jo), (ts, _, to) = solve_both(
        "random_lp", (10, 16), {"seed": 3},
        je.SimplexOptions(**opts), te.SimplexOptions(**opts))
    assert js == ts == je.OPTIMAL
    assert abs(to - jo) <= 1e-9 * (1 + abs(jo))


def test_mixed_engine_with_k2_twin_matches_highs():
    """use_pallas_pivot=True reaches the same optimum as the JAX engine and
    HiGHS (mirrors tests/test_pallas.py::test_fused_pivot_in_engine)."""
    from scipy.optimize import linprog

    opts = dict(max_iterations=10000, inverse_dtype="float32", refactor_frequency=50,
                dual_ratio="bfrt", use_pallas_pivot=True)
    (js, _, jo), (ts, _, to) = solve_both(
        "random_lp", (64, 96), {"seed": 9, "density": 0.15},
        je.SimplexOptions(**opts), te.SimplexOptions(**opts))
    assert js == ts == je.OPTIMAL
    assert abs(to - jo) <= 1e-9 * (1 + abs(jo))
    from clp_tpu_torch.utils.generators import random_lp

    m = random_lp(64, 96, seed=9, density=0.15)
    A = m.matrix.toarray()
    ref = linprog(m.objective, A_ub=np.vstack([A, -A]),
                  b_ub=np.concatenate([m.row_upper, -m.row_lower]),
                  bounds=list(zip(m.col_lower, m.col_upper)), method="highs")
    assert ref.status == 0
    assert abs(to - ref.fun) < 1e-6 * (1 + abs(ref.fun))


def network_arrays(seed=4, nodes=9, arcs=24):
    """A small min-cost flow: each column one +1 (tail) and one -1 (head)."""
    rng = np.random.default_rng(seed)
    tails = np.concatenate([np.arange(nodes - 1), rng.integers(0, nodes, arcs)])
    heads = np.concatenate([np.arange(1, nodes), rng.integers(0, nodes, arcs)])
    keep = tails != heads
    tails, heads = tails[keep], heads[keep]
    n = tails.size
    A = sp.csc_matrix((np.concatenate([np.ones(n), -np.ones(n)]),
                       (np.concatenate([tails, heads]), np.concatenate([np.arange(n)] * 2))),
                      shape=(nodes, n))
    supply = np.zeros(nodes)
    supply[0], supply[-1] = 7.0, -7.0
    cost = rng.uniform(1, 5, n)
    return A, np.zeros(n), np.full(n, 6.0), cost, supply, supply


def _network_models():
    arrays = network_arrays()
    mj, mt = JaxModel(), TorchModel()
    mj.load_problem(*arrays)
    mt.load_problem(*arrays)
    return mj, mt


def test_pm1_pricing_parity():
    mj, mt = _network_models()
    jlp, _ = jax_standard_form(mj)
    tlp, _ = to_standard_form(mt, device="cpu")
    jo = je.SimplexOptions(price_mode="pm1", max_iterations=2000)
    to = te.SimplexOptions(price_mode="pm1", max_iterations=2000)
    js = je.dual_solve(jlp, _jax_start(jlp, jo), jo)
    ts = te.dual_solve(tlp, _torch_start(tlp, to), to)
    assert int(js.status) == int(ts.status) == je.OPTIMAL
    assert int(js.iterations) == int(ts.iterations)
    l, u, c = (np.asarray(getattr(jlp, f)) for f in ("l", "u", "c"))
    oj = _objective(c, np.asarray(js.basis), np.asarray(js.xb), np.asarray(js.vstat), l, u)
    ot = _objective(c, ts.basis.numpy(), ts.xb.numpy(), ts.vstat.numpy(), l, u)
    assert abs(ot - oj) <= 1e-9 * (1 + abs(oj))
    # the +-1 index arrays agree with the JAX package's
    pj = je.pm1_indices(jlp.G)
    pt = te.pm1_indices(tlp.G)
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("freq", [40, 37])
def test_gated_blocks_of_pivots(freq):
    """inner_unroll = 8: with a refactor frequency that is a multiple of 8
    the blocks are exact (same result as U = 1); at 37 each chunk over-runs
    by up to 7 pivots, in the port as in the JAX package (ROADMAP.md queue
    3 pins that), so the two packages still agree pivot for pivot."""
    base = dict(max_iterations=5000, refactor_frequency=freq)
    (js, ji, jo), (ts, ti, to) = solve_both(
        "staircase_lp", (), {"nblocks": 4},
        je.SimplexOptions(**base, inner_unroll=8), te.SimplexOptions(**base, inner_unroll=8))
    assert js == ts == je.OPTIMAL
    assert abs(to - jo) <= 1e-9 * (1 + abs(jo))
    assert ti == ji
    if freq % 8 == 0:
        _, (t1s, t1i, t1o) = solve_both(
            "staircase_lp", (), {"nblocks": 4},
            je.SimplexOptions(**base), te.SimplexOptions(**base))
        assert (t1s, t1i) == (ts, ti) and abs(t1o - to) <= 1e-12 * (1 + abs(to))


ABLATE_CASES = [("price",), ("bfrt",), ("flip",), ("forceflow",), ("ftran",), ("update",),
                ("book",), ("rowchoice",), ("price", "ftran", "update", "book")]


@pytest.mark.parametrize("ablate", ABLATE_CASES, ids=lambda a: "+".join(a))
def test_ablate_gates_match_jax(ablate):
    """The timing-only gates: from a shared mid-solve state, five gated
    pivot bodies leave the same engine state in both packages."""
    _pivots_from_shared_state(dict(dual_ratio="bfrt", ablate=ablate))


def test_bfrt_select_approx_is_the_exact_selection():
    """bfrt_select="approx" is jax.lax.approx_max_k, exact off the TPU; the
    port takes its exact selection for it: the same states as the JAX
    package's, and the same as "topk"."""
    t_approx = _pivots_from_shared_state(dict(dual_ratio="bfrt", bfrt_select="approx"))
    t_topk = _pivots_from_shared_state(dict(dual_ratio="bfrt", bfrt_select="topk"))
    for f in ("basis", "vstat", "binv", "xb", "dj", "weights"):
        np.testing.assert_array_equal(t_approx[f], t_topk[f])


def _pivots_from_shared_state(kw, pivots=5):
    import jax
    from functools import partial

    from clp_tpu.utils import generators as jgen
    from clp_tpu_torch import convert
    from test_torch_engine import _fields

    model = jgen.random_lp(12, 20, seed=5)
    jlp, _ = jax_standard_form(model)
    base = je.SimplexOptions(dual_ratio=kw["dual_ratio"])
    st = _jax_start(jlp, base)
    walk = jax.jit(partial(je.dual_iteration, opts=base))
    for _ in range(3):  # walk into the solve so binv is no longer trivial
        st = walk(jlp, st)
    jopts, topts = je.SimplexOptions(**kw), te.SimplexOptions(**kw)
    step = jax.jit(partial(je.dual_iteration, opts=jopts))
    tlp = convert.standard_lp_from_numpy(_fields(jlp), "cpu")
    tst = convert.simplex_state_from_numpy(_fields(st), "cpu")
    for _ in range(pivots):
        st = step(jlp, st)
        tst = te.dual_iteration(tlp, tst, topts)
    t = convert.simplex_state_to_numpy(tst)
    for f in ("basis", "vstat", "iterations", "status", "refactor_now"):
        np.testing.assert_array_equal(t[f], np.asarray(getattr(st, f)), err_msg=f)
    for f in ("binv", "xb", "dj", "weights"):
        a, b = t[f], np.asarray(getattr(st, f))
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=f)
        assert np.abs(a[fin] - b[fin]).max(initial=0) <= 1e-10 * (1 + np.abs(b[fin]).max(initial=0)), f
    return t
