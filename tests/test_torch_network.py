"""Port parity for network.py (a numpy copy): the arc form, the
spanning-tree simplex and `solve_network` give the JAX package's arrays,
counts and statuses on the same LPs, and the NETWORK route through
`initial_solve` (AUTOMATIC, explicit, and the fall-through to the dual on a
matrix that is not a network) gives its status and objective."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clp_tpu
from clp_tpu.network import (
    network_form as jax_network_form,
    network_simplex as jax_network_simplex,
    solve_network as jax_solve_network,
)
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch import network
from tests.test_network import make_mcf
from tests.test_torch_auto import _port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _mcf(seed, ranges=False, sense=1.0):
    mj = make_mcf(18, 50, seed, ranges=ranges)[0]
    mj.optimization_direction = sense
    return mj


def _infeasible():
    A = np.zeros((2, 1))
    A[0, 0], A[1, 0] = 1.0, -1.0
    mj = clp_tpu.Model()
    mj.load_problem(sp.csc_matrix(A), np.zeros(1), np.full(1, 2.0), np.ones(1),
                    row_lower=np.array([5.0, -5.0]), row_upper=np.array([5.0, -5.0]))
    return mj


def _unbounded():
    A = np.zeros((2, 2))
    A[0, 0], A[1, 0] = 1.0, -1.0
    A[1, 1], A[0, 1] = 1.0, -1.0  # 2-cycle, both arcs negative cost, no caps
    mj = clp_tpu.Model()
    mj.load_problem(sp.csc_matrix(A), np.zeros(2), np.full(2, np.inf),
                    np.array([-1.0, -1.0]), row_lower=np.zeros(2), row_upper=np.zeros(2))
    return mj


CASES = {
    "mcf0": lambda: _mcf(0),
    "mcf1": lambda: _mcf(1),
    "mcf2-ranges": lambda: _mcf(2, ranges=True),
    "mcf3-ranges-max": lambda: _mcf(3, ranges=True, sense=-1.0),
    "infeasible": _infeasible,
    "unbounded": _unbounded,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_network_form_and_simplex_match_jax(name):
    """Equal arc arrays; the same x, potentials, reduced costs, status and
    pivot count (the same numpy arithmetic)."""
    mj = CASES[name]()
    nj, nt = jax_network_form(mj), network.network_form(_port_model(mj))
    for f in dataclasses.fields(nj):
        np.testing.assert_array_equal(getattr(nt, f.name), getattr(nj, f.name))
    rj, rt = jax_network_simplex(nj), network.network_simplex(nt)
    for a, b in zip(rt[:3], rj[:3]):
        np.testing.assert_array_equal(a, b)
    assert int(rt[3]) == int(rj[3]) and rt[4] == rj[4]
    assert (rt[5] is None) == (rj[5] is None)


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_network_matches_jax(name):
    mj = CASES[name]()
    mt = _port_model(mj)
    sj, st = jax_solve_network(mj), network.solve_network(mt)
    assert int(st.status) == int(sj.status) and st.iterations == sj.iterations
    assert st.objective_value == sj.objective_value
    np.testing.assert_array_equal(st.primal, sj.primal)
    np.testing.assert_array_equal(st.duals, sj.duals)
    if sj.unbounded_ray is not None:
        np.testing.assert_array_equal(st.unbounded_ray, sj.unbounded_ray)


def test_network_form_rejects_general_matrices():
    mj = jgen.random_lp(6, 9, seed=2)
    assert network.network_form(_port_model(mj)) is None is jax_network_form(mj)
    with pytest.raises(ValueError, match="network"):
        network.solve_network(_port_model(mj))


@pytest.mark.parametrize("method, make", [
    ("AUTOMATIC", lambda: _mcf(0)),
    ("NETWORK", lambda: _mcf(2, ranges=True)),
    ("NETWORK", lambda: jgen.random_lp(20, 30, seed=5, density=0.3)),
], ids=["auto", "explicit-ranges", "not-a-network"])
def test_network_route_matches_jax(method, make):
    """AUTOMATIC lands on NETWORK as in the JAX package; an explicit
    NETWORK on a matrix that is not a network falls through to the dual."""
    mj = make()
    mt = _port_model(mj)
    sj = clp_tpu.initial_solve(mj, clp_tpu.SolveOptions(method=clp_tpu.SolveMethod[method]))
    st = clp_tpu_torch.initial_solve(mt, clp_tpu_torch.SolveOptions(
        method=clp_tpu_torch.SolveMethod[method], device="cpu"))
    assert int(st.status) == int(sj.status)
    assert abs(st.objective_value - sj.objective_value) <= 1e-9 * (1 + abs(sj.objective_value))
