"""Port parity: standard forms and basis refactorization (clp_tpu_torch vs
clp_tpu on the same LPs, on the CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from clp_tpu.forms import to_standard_form as jax_standard_form
from clp_tpu.ops import linalg as jax_linalg
from clp_tpu.ops.linalg import lu_refactor as jax_lu, lu_refactor32 as jax_lu32
from clp_tpu.utils import generators as jgen

from clp_tpu_torch import convert
from clp_tpu_torch.forms import to_standard_form
from clp_tpu_torch.ops import linalg
from clp_tpu_torch.ops.linalg import lu_refactor, lu_refactor32
from clp_tpu_torch.utils import generators as tgen
from tests.worker_threads import set_worker_threads

set_worker_threads()


FAMILIES = {
    "random": ("random_lp", (12, 20), {"seed": 3}),
    "staircase": ("staircase_lp", (), {}),
    "transport": ("transport_lp", (4, 6), {"seed": 1}),
    "infeasible": ("infeasible_lp", (), {}),
    "unbounded": ("unbounded_lp", (), {}),
    "nqueens": ("nqueens_lp", (4,), {}),
}


def both_models(family):
    name, args, kw = FAMILIES[family]
    return getattr(jgen, name)(*args, **kw), getattr(tgen, name)(*args, **kw)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generators_and_standard_form_match(family):
    mj, mt = both_models(family)
    assert (mj.matrix != mt.matrix).nnz == 0
    for attr in ("col_lower", "col_upper", "objective", "row_lower", "row_upper"):
        np.testing.assert_array_equal(getattr(mj, attr), getattr(mt, attr))
    lpj, infoj = jax_standard_form(mj)
    lpt, infot = to_standard_form(mt, device="cpu")
    tn = convert.standard_lp_to_numpy(lpt)
    for f in ("G", "b", "c", "l", "u"):
        a, b = np.asarray(getattr(lpj, f)), tn[f]
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tn["Q"] is None and lpj.Q is None
    # and back: the JAX package's arrays make the same port tensors
    back = convert.standard_lp_from_numpy(
        {f: np.asarray(getattr(lpj, f)) for f in ("G", "b", "c", "l", "u")}, "cpu")
    for f in ("G", "b", "c", "l", "u"):
        assert torch.equal(getattr(back, f), getattr(lpt, f))
    assert (infoj.n, infoj.m, infoj.sense, infoj.offset) == (
        infot.n, infot.m, infot.sense, infot.offset)


def _bases(seed):
    """A well-conditioned and a badly row/column-scaled basis."""
    rng = np.random.default_rng(seed)
    m = 40
    B = rng.standard_normal((m, m)) + 4 * np.eye(m)
    graded = B * np.logspace(-6, 6, m)[:, None] * np.logspace(3, -3, m)[None, :]
    return [B, graded]


@pytest.mark.parametrize("which", [0, 1])
def test_lu_refactor_f64_matches(which):
    B = _bases(7)[which]
    Xj, okj = jax_lu(jnp.asarray(B))
    Xt, okt = lu_refactor(torch.as_tensor(B))
    assert bool(okj) and bool(okt)
    Xj = np.asarray(Xj)
    scale = np.abs(Xj).max()
    assert np.abs(Xt.numpy() - Xj).max() <= 1e-12 * scale


@pytest.mark.parametrize("which", [0, 1])
def test_lu_refactor32_matches(which):
    B = _bases(8)[which]
    Xj, okj = jax_lu32(jnp.asarray(B))
    Xt, okt = lu_refactor32(torch.as_tensor(B))
    assert Xt.dtype == torch.float32
    assert bool(okj) == bool(okt)
    # both are f32 inverses of the same power-of-2 equilibrated matrix:
    # compare them with each other and with the exact inverse at f32
    # tolerance (entries of the graded inverse span ~18 decades, so the
    # absolute part is taken per row and column scale)
    exact = np.linalg.inv(B)
    scale = np.abs(exact).max(axis=1, keepdims=True) * np.abs(exact).max(
        axis=0, keepdims=True) / np.abs(exact).max()
    for X in (np.asarray(Xj, np.float64), Xt.numpy().astype(np.float64)):
        assert np.all(np.abs(X - exact) <= 1e-3 * np.abs(exact) + 1e-4 * scale)
    assert np.all(np.abs(Xt.numpy() - np.asarray(Xj)) <= 1e-3 * np.abs(exact) + 1e-4 * scale)


def test_lu_refactor_singular_flags_not_ok():
    B = np.ones((5, 5))
    _, okj = jax_lu(jnp.asarray(B))
    _, okt = lu_refactor(torch.as_tensor(B))
    assert bool(okt) == bool(okj) is False
    _, okj32 = jax_lu32(jnp.asarray(B))
    _, okt32 = lu_refactor32(torch.as_tensor(B))
    assert bool(okt32) == bool(okj32) is False


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("block", [8, 16, 128])
def test_blocked_lu_and_inverse_match_jax(which, block):
    """The JAX package's TPU LU in plain torch: the same pivots and the
    factors within 1e-10, for panels that divide m (8), pad it (16) and
    exceed it (128); the inverse through it, and lu_refactor's unused
    `block`, within 1e-10 of the JAX inverse (relative to its largest
    entry)."""
    B = _bases(9)[which]
    LUj, pj = jax_linalg.blocked_lu(jnp.asarray(B), block)
    LUt, pt = linalg.blocked_lu(torch.as_tensor(B), block)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    LUj = np.asarray(LUj)
    assert np.abs(LUt.numpy() - LUj).max() <= 1e-10 * np.abs(LUj).max()
    Xj = np.asarray(jax_linalg.blocked_inverse(jnp.asarray(B), block))
    for Xt in (linalg.blocked_inverse(torch.as_tensor(B), block),
               lu_refactor(torch.as_tensor(B), block=block)[0]):
        assert np.abs(Xt.numpy() - Xj).max() <= 1e-10 * np.abs(Xj).max()


@pytest.mark.parametrize("which", [0, 1])
def test_gauss_jordan_inverse_matches_jax(which):
    B = _bases(10)[which]
    Xj = np.asarray(jax_linalg.gauss_jordan_inverse(jnp.asarray(B)))
    Xt = linalg.gauss_jordan_inverse(torch.as_tensor(B)).numpy()
    assert np.abs(Xt - Xj).max() <= 1e-10 * np.abs(Xj).max()
