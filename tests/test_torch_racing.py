"""Port parity of racing: `racing_solve` (threads on one device) and
`race_seeds` (K cost-perturbed variants as one batched dual simplex), and
the race's error rule: a solver's own failure loses, any other error ends
the race (clp_tpu_torch vs clp_tpu, CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

import clp_tpu
from clp_tpu.parallel.racing import race_seeds as jax_race_seeds
from clp_tpu.parallel.racing import racing_solve as jax_racing_solve
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch.constants import ProblemStatus, SolveMethod
from clp_tpu_torch.decompose import DecompositionError
from clp_tpu_torch.parallel import racing
from tests.test_torch_qp import port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()


def _cpu_configs():
    return [dataclasses.replace(o, device="cpu") for o in racing.default_race_configs()]


def test_default_configs_match_jax():
    from clp_tpu.parallel.racing import default_race_configs

    for j, t in zip(default_race_configs(), racing.default_race_configs()):
        assert j.method.name == t.method.name and j.crash == t.crash


@pytest.mark.parametrize("devices", [None, ["cpu"]], ids=["configs", "devices"])
def test_racing_optimal_matches_jax(devices):
    """tests/test_sprint_racing.py::test_racing_optimal. The winner is the
    first thread to finish, so only the answer is compared."""
    model = jgen.random_lp(10, 15, seed=4)
    jsol = jax_racing_solve(model.copy())
    configs = _cpu_configs() if devices is None else None
    tsol = racing.racing_solve(port_model(model), configs, devices)
    assert tsol.status == ProblemStatus.OPTIMAL
    assert abs(tsol.objective_value - jsol.objective_value) <= 1e-9 * (
        1 + abs(jsol.objective_value))
    assert tsol.winning_config in (0, 1, 2)


def test_racing_infeasible():
    model = jgen.infeasible_lp()
    assert jax_racing_solve(model.copy()).status == clp_tpu.ProblemStatus.PRIMAL_INFEASIBLE
    sol = racing.racing_solve(port_model(model), devices=["cpu"])
    assert sol.status == ProblemStatus.PRIMAL_INFEASIBLE


@pytest.mark.parametrize("make", [lambda: jgen.random_lp(24, 40, seed=3),
                                  lambda: jgen.transport_lp(5, 6, seed=1)],
                         ids=["random", "transport"])
def test_race_seeds_matches_jax(make):
    """tests/test_sprint_racing.py::test_race_seeds_on_device_batched: the
    same winner (numpy draws the perturbations from the model's seed in
    both packages), the same cleanup pivots and objective."""
    jo = clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.DUAL_SIMPLEX)
    jo.presolve.enabled = False
    jsol = jax_race_seeds(make(), jo, k=6)
    to = clp_tpu_torch.SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device="cpu")
    to.presolve.enabled = False
    tsol = racing.race_seeds(port_model(make()), to, k=6)
    assert tsol.status == ProblemStatus.OPTIMAL
    assert tsol.winning_config == jsol.winning_config
    assert tsol.iterations == jsol.iterations <= 3
    assert abs(tsol.objective_value - jsol.objective_value) <= 1e-9 * (
        1 + abs(jsol.objective_value))


def test_race_seeds_infeasible_falls_back_to_driver():
    to = clp_tpu_torch.SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device="cpu")
    to.presolve.enabled = False
    sol = racing.race_seeds(port_model(jgen.infeasible_lp()), to, k=4)
    assert sol.status == ProblemStatus.PRIMAL_INFEASIBLE


def _failing(exc):
    """A configuration whose solve raises `exc` (the method's entry point
    is replaced for the one config that asks for BARRIER_NO_CROSS)."""
    from clp_tpu_torch import solve as tsolve

    real = tsolve._solve_barrier

    def boom(model, options):
        raise exc

    return tsolve, real, boom


@pytest.mark.parametrize("exc", [NotImplementedError("not ported"), ValueError("bad"),
                                 DecompositionError("no")],
                         ids=["NotImplementedError", "ValueError", "DecompositionError"])
def test_a_solver_failure_loses_the_race(exc, monkeypatch):
    tsolve, real, boom = _failing(exc)
    monkeypatch.setattr(tsolve, "_solve_barrier", boom)
    model = port_model(jgen.random_lp(10, 15, seed=4))
    sol = racing.racing_solve(model, devices=["cpu"])
    assert sol.status == ProblemStatus.OPTIMAL and sol.winning_config in (0, 1)
    only = racing.racing_solve(port_model(jgen.random_lp(10, 15, seed=4)),
                               [racing.default_race_configs()[2]], devices=["cpu"])
    assert only.status == ProblemStatus.ERRORS and str(exc) in only.error


def test_a_torch_error_ends_the_race(monkeypatch):
    """A RuntimeError that is not the solver's own (torch raises CUDA
    errors as RuntimeError) is not swallowed as a lost configuration."""
    tsolve, real, boom = _failing(RuntimeError("CUDA error: an illegal memory access"))
    monkeypatch.setattr(tsolve, "_solve_barrier", boom)
    model = port_model(jgen.random_lp(10, 15, seed=4))
    configs = [racing.default_race_configs()[2]]
    with pytest.raises(RuntimeError, match="illegal memory access"):
        racing.racing_solve(model, configs, devices=["cpu"])
