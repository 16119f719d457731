"""Port parity for sprint.py: the column working-set solve gives the JAX
package's status and objective on the same wide LPs, directly and as
AUTOMATIC's SPRINT route; its sub-solves run on the caller's device; its
repricing over a "block" device mesh gives the JAX package's objective."""

import pytest
import torch

import clp_tpu
from clp_tpu.sprint import sprint_solve as jax_sprint_solve
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch import sprint
from clp_tpu_torch.simplex import driver
from tests.test_torch_auto import _port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()


@pytest.mark.parametrize("make", [
    lambda: jgen.random_lp(100, 2100, density=0.05, seed=1),
    lambda: jgen.random_lp(30, 700, density=0.05, seed=2),
], ids=["100x2100", "30x700"])
def test_sprint_solve_matches_jax(make):
    """The same passes in both packages: status, objective within 1e-9
    relative. (AUTOMATIC's SPRINT route on the wide LP is a case of
    tests/test_torch_auto.py.)"""
    mj = make()
    mt = _port_model(mj)
    sj = jax_sprint_solve(mj, clp_tpu.SolveOptions())
    st = sprint.sprint_solve(mt, clp_tpu_torch.SolveOptions(device="cpu"))
    assert int(st.status) == int(sj.status) == int(clp_tpu.ProblemStatus.OPTIMAL)
    assert abs(st.objective_value - sj.objective_value) <= 1e-9 * abs(sj.objective_value)
    assert clp_tpu_torch.check_kkt(mt, x=st.primal, y=st.duals, tol=1e-7).ok


def test_explicit_sprint_method_matches_jax():
    mj = jgen.random_lp(30, 700, density=0.05, seed=3)
    mt = _port_model(mj)
    sj = clp_tpu.initial_solve(mj, clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.SPRINT))
    st = clp_tpu_torch.initial_solve(mt, clp_tpu_torch.SolveOptions(
        method=clp_tpu_torch.SolveMethod.SPRINT, device="cpu"))
    assert int(st.status) == int(sj.status) == int(clp_tpu.ProblemStatus.OPTIMAL)
    assert abs(st.objective_value - sj.objective_value) <= 1e-9 * abs(sj.objective_value)


def test_sprint_sub_solves_run_on_the_callers_device(monkeypatch):
    seen = []
    inner = driver.simplex_solve

    def spy(model, options, dual, warm=None):
        seen.append((options.device, options.method.name, options.presolve.enabled))
        return inner(model, options, dual, warm)

    monkeypatch.setattr(driver, "simplex_solve", spy)
    sol = sprint.sprint_solve(_port_model(jgen.random_lp(30, 700, density=0.05, seed=2)),
                              clp_tpu_torch.SolveOptions(device="cpu"))
    assert sol.status == clp_tpu_torch.ProblemStatus.OPTIMAL
    assert seen and set(seen) == {("cpu", "PRIMAL_SIMPLEX", False)}


@pytest.mark.parametrize("where", ["mesh", "devices"])
def test_sprint_mesh_raises(where):
    """SPRINT's repricing over a 2-entry "block" mesh, given as `mesh` or as
    `options.devices` (it raised until the last slice of the port): the
    JAX package's objective over 2 XLA CPU devices."""
    import jax
    from clp_tpu.parallel.block import make_block_mesh as jax_block_mesh
    from clp_tpu_torch.parallel.block import make_block_mesh

    mj = jgen.random_lp(6, 40, seed=2)
    mt = _port_model(mj)
    opts = clp_tpu_torch.SolveOptions(device="cpu")
    jopts = clp_tpu.SolveOptions()
    kw, jkw = {}, {}
    if where == "mesh":
        kw["mesh"] = make_block_mesh(["cpu", "cpu"])
        jkw["mesh"] = jax_block_mesh(jax.devices()[:2])
    else:
        opts.devices = make_block_mesh(["cpu", "cpu"])
        jopts.devices = jax_block_mesh(jax.devices()[:2])
    sj = jax_sprint_solve(mj, jopts, **jkw)
    st = sprint.sprint_solve(mt, opts, **kw)
    assert int(st.status) == int(sj.status) == int(clp_tpu.ProblemStatus.OPTIMAL)
    assert abs(st.objective_value - sj.objective_value) <= 1e-9 * (1 + abs(sj.objective_value))
