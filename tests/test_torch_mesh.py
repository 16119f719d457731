"""Port parity of the device mesh (clp_tpu_torch vs clp_tpu, CPU, f64).

The JAX side runs on the 8 XLA CPU devices that tests/conftest.py forces;
the port's mesh is ["cpu"] * 8, one process driving every entry. Covered:
the lane split of a batch, block repricing and SPRINT over a "block" mesh,
the column-sharded dual engine (against the JAX package's, and pivot for
pivot against the port's single-device engine), its shard merge and its traffic between shards,
scenario-sharded batches, racing over several devices and the dry run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from hypothesis import given, settings, strategies as st

import clp_tpu
from clp_tpu.forms import to_standard_form as jax_standard_form
from clp_tpu.parallel.block import BlockShardedColumns as JaxBlockColumns
from clp_tpu.parallel.block import make_block_mesh as jax_block_mesh
from clp_tpu.parallel.colshard import dual_solve_colsharded as jax_colsharded
from clp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from clp_tpu.simplex import engine as je
from clp_tpu.sprint import sprint_solve as jax_sprint_solve
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch.forms import to_standard_form
from clp_tpu_torch.parallel import batch as tb
from clp_tpu_torch.parallel.block import BlockShardedColumns, make_block_mesh, merge_smallest_k
from clp_tpu_torch.parallel.colshard import dual_solve_colsharded
from clp_tpu_torch.parallel.mesh import make_mesh, replicated, scenario_sharding
from clp_tpu_torch.simplex import engine as te
from clp_tpu_torch.sprint import sprint_solve
from clp_tpu_torch.utils.generators import random_lp
from tests.test_batch import _perturbed_models, _portfolio_qp
from tests.test_torch_qp import port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()

CPU8 = ["cpu"] * 8


def _cpu(**kw):
    return clp_tpu_torch.SolveOptions(device="cpu", **kw)


# --------------------------------------------------------------------------
# the mesh and the lane split
# --------------------------------------------------------------------------


def test_mesh_splits_lanes_into_contiguous_blocks():
    mesh = make_mesh(CPU8)
    assert mesh.size == 8 and mesh.axis_names == ("scenario",)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    sh = scenario_sharding(mesh)
    x = torch.arange(16 * 3).reshape(16, 3)
    parts = sh.split(x)
    assert [tuple(p.shape) for p in parts] == [(2, 3)] * 8
    assert torch.equal(torch.cat(parts), x)
    assert all(torch.equal(p, x) for p in replicated(mesh).split(x))
    with pytest.raises(ValueError):
        scenario_sharding(make_block_mesh(CPU8))


def test_uneven_batch_raises_like_jax():
    """jax.device_put refuses a leading axis the mesh size does not
    divide; so does the port's split."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    jmesh = jax_make_mesh(jax.devices()[:8])
    with pytest.raises(ValueError):
        jax.device_put(np.zeros((3, 4)), NamedSharding(jmesh, P("scenario")))
    models = [port_model(m) for m in _perturbed_models(count=3)]
    with pytest.raises(ValueError, match="divisible"):
        clp_tpu_torch.solve_batch(models, _cpu(), mesh=make_mesh(CPU8))


# --------------------------------------------------------------------------
# block repricing and SPRINT
# --------------------------------------------------------------------------


def test_reprice_matches_jax_ties_included():
    """Integer data, so dj is exact in both packages and ties are real:
    duplicated columns across shard borders tie in dj and must come out in
    global index order."""
    rng = np.random.default_rng(1)
    A = rng.integers(-3, 4, size=(6, 25)).astype(float)
    c = rng.integers(-5, 6, size=25).astype(float)
    A[:, 13] = A[:, 2]
    c[13] = c[2]
    A[:, 22] = A[:, 5]
    c[22] = c[5]
    y = rng.integers(-2, 3, size=6).astype(float)
    jd, jv, ji = JaxBlockColumns(sp.csc_matrix(A), c, jax_block_mesh(jax.devices()[:8])
                                 ).reprice(y, k=9)
    td, tv, ti = BlockShardedColumns(sp.csc_matrix(A), c, make_block_mesh(CPU8)
                                     ).reprice(y, k=9)
    np.testing.assert_allclose(td, np.asarray(jd), rtol=0, atol=1e-12)
    assert np.array_equal(ti, np.asarray(ji))
    assert np.array_equal(tv, np.asarray(jv))
    dj_ref = c - A.T @ y
    assert np.array_equal(ti, np.argsort(dj_ref, kind="stable")[:9])


@pytest.mark.parametrize("where", ["mesh", "options.devices"])
def test_sprint_over_a_block_mesh_matches_jax(where):
    mj = jgen.random_lp(8, 200, seed=3, density=0.3)
    jo = clp_tpu.SolveOptions()
    jo.presolve.enabled = False
    js = jax_sprint_solve(mj.copy(), jo, mesh=jax_block_mesh(jax.devices()[:8]))
    to = _cpu()
    to.presolve.enabled = False
    mesh = make_block_mesh(CPU8)
    if where == "mesh":
        ts = sprint_solve(port_model(mj), to, mesh=mesh)
    else:
        to.devices = mesh
        to.method = clp_tpu_torch.SolveMethod.SPRINT
        ts = clp_tpu_torch.initial_solve(port_model(mj), to)
    assert int(ts.status) == int(js.status) == int(clp_tpu.ProblemStatus.OPTIMAL)
    assert abs(ts.objective_value - js.objective_value) <= 1e-9 * (1 + abs(js.objective_value))


# --------------------------------------------------------------------------
# the column-sharded dual engine
# --------------------------------------------------------------------------


def _single(lp, opts):
    s = te.initial_state(lp, opts)
    s = te.recompute(lp, s, opts.dual_bound)
    s = te.make_dual_feasible(lp, s, opts)
    return te.dual_solve(lp, s, opts)


def _objective(lp, s, opts):
    xn = te.nonbasic_values(lp, s.vstat, opts.dual_bound)
    return float(lp.c.index_select(0, s.basis) @ s.xb + lp.c @ xn)


COLSHARD_CASES = {
    # tests/test_block.py:57-100's two cases (45 + 20 and 30 + 16 columns
    # do not split over 8: padded), the first also under Dantzig's rule
    "steepest": ((20, 45, 5, 0.3), {}),
    "dantzig": ((20, 45, 5, 0.3), {"dual_pivot": "dantzig"}),
    "bfrt": ((16, 30, 9, None), {"dual_ratio": "bfrt"}),
    # the card's settings (f32 inverse, blocks of 8) and Positive Edge
    "f32-U8-bfrt": ((40, 120, 4, 0.2), {"inverse_dtype": "float32", "inner_unroll": 8,
                                         "dual_ratio": "bfrt"}),
    "pe": ((30, 90, 7, 0.3), {"dual_pivot": "pe"}),
}


@pytest.mark.parametrize("case", sorted(COLSHARD_CASES))
def test_colsharded_engine_matches_single_device_pivot_for_pivot(case):
    (m, n, seed, dens), kw = COLSHARD_CASES[case]
    mj = jgen.random_lp(m, n, seed=seed, **({} if dens is None else {"density": dens}))
    lp, _ = to_standard_form(port_model(mj), device="cpu")
    opts = te.SimplexOptions(max_iterations=20000, **kw)
    ref = _single(lp, opts)
    state, slp, nt0 = dual_solve_colsharded(lp, opts, make_block_mesh(CPU8))
    assert int(state.status) == int(ref.status) == te.OPTIMAL
    assert int(state.iterations) == int(ref.iterations)
    obj = _objective(slp, state, opts)
    ref_obj = _objective(lp, ref, opts)
    assert abs(obj - ref_obj) <= 1e-9 * (1 + abs(ref_obj))
    assert nt0 == lp.G.shape[1] and state.dj.shape[0] == slp.nt >= nt0
    assert slp.nt % 8 == 0 and len(slp.shards) == 8


def _jax_colsharded(mj, kw):
    jlp, _ = jax_standard_form(mj)
    jo = je.SimplexOptions(max_iterations=20000, **kw)
    js, jslp, _ = jax_colsharded(jlp, jo, jax_block_mesh(jax.devices()[:8]))
    xn = je.nonbasic_values(jslp, js.vstat, jo.dual_bound)
    return int(js.status), int(js.iterations), float(jnp.take(jslp.c, js.basis) @ js.xb
                                                      + jslp.c @ xn)


def _port_colsharded(mj, kw):
    lp, _ = to_standard_form(port_model(mj), device="cpu")
    opts = te.SimplexOptions(max_iterations=20000, **kw)
    state, slp, _ = dual_solve_colsharded(lp, opts, make_block_mesh(CPU8))
    return int(state.status), int(state.iterations), _objective(slp, state, opts)


@pytest.mark.parametrize("case", sorted(COLSHARD_CASES))
def test_colsharded_engine_matches_jax(case):
    """The port's column-sharded engine against the JAX package's
    dual_solve_colsharded on its 8 XLA CPU devices: the same status, the
    objective within 1e-9 relative and the same pivot count. The f32
    inverse case runs both in f64: under the f32 inverse the two packages
    round B^-1 in other summation orders (torch's CPU matmul against XLA's
    dot) and take other pivot paths (68 against 80 pivots on this LP, as
    each package's own single-device engine does), while in f64 the paths
    are the same."""
    (m, n, seed, dens), kw = COLSHARD_CASES[case]
    if kw.get("inverse_dtype") == "float32":
        kw = {**kw, "inverse_dtype": "float64"}
    mj = jgen.random_lp(m, n, seed=seed, **({} if dens is None else {"density": dens}))
    jstatus, jits, jobj = _jax_colsharded(mj, kw)
    status, its, obj = _port_colsharded(mj, kw)
    assert status == jstatus == te.OPTIMAL
    assert abs(obj - jobj) <= 1e-9 * (1 + abs(jobj))
    assert its == jits


_F32 = st.sampled_from([0.0, -0.0, 1.0, -1.0, 2.5, float("inf"), -float("inf"),
                        1e-30, -3.25, 7.0])


@settings(max_examples=60, deadline=None, database=None)
@given(vals=st.lists(_F32, min_size=1, max_size=40), shards=st.integers(1, 6),
       k=st.integers(1, 40))
def test_shard_merge_equals_smallest_k(vals, shards, k):
    """Each shard's k smallest, merged, are the k smallest of the whole row
    bit for bit: ties (also across shard borders) by global index, -0.0
    before +0.0."""
    t = torch.tensor(vals, dtype=torch.float32)
    pad = (-t.numel()) % shards
    t = torch.cat([t, torch.full((pad,), float("inf"))])
    K = min(k, t.numel())
    w = t.numel() // shards
    cand_v, cand_i = [], []
    for s in range(shards):
        part = t[s * w:(s + 1) * w]
        loc = te._smallest_k(part, min(K, w))
        cand_v.append(part.index_select(0, loc))
        cand_i.append(loc + s * w)
    v, i = merge_smallest_k(cand_v, K, cand_i)
    ref = te._smallest_k(t, K)
    assert torch.equal(i, ref)
    assert torch.equal(v.view(torch.int32), t.index_select(0, ref).view(torch.int32))


@pytest.mark.parametrize("ratio", ["harris", "bfrt"])
def test_colsharded_traffic_does_not_grow_with_width(ratio):
    """Elements moved between mesh entries per pivot: the same for an LP
    twice as wide (each shard keeps >= k columns, BFRT's breakpoints)."""
    per = []
    k = 16
    for n in (100, 200):
        lp, _ = to_standard_form(random_lp(8, n, seed=3, density=0.3), device="cpu")
        stats = {}
        dual_solve_colsharded(
            lp, te.SimplexOptions(dual_ratio=ratio, bfrt_topk=k, max_iterations=400),
            make_block_mesh(["cpu"] * 4), stats=stats)
        assert stats["pivots"] > 0
        per.append(stats["elements_per_pivot"])
    assert per[0] == per[1]
    # (shards - 1) * (3m + 2k + 25): rho out, the entering column and the
    # flow back, k breakpoints and their gains under BFRT, and scalars
    assert per[0] == 3 * (3 * 8 + (2 * k + 25 if ratio == "bfrt" else 19))


# --------------------------------------------------------------------------
# scenario-sharded batches (tests/test_batch.py:39 and :136)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["solve_batch", "dual", "qp"])
def test_sharded_batch_lanes_match_unsharded(entry):
    """tests/test_batch.py:39 and :136 over the 8-entry CPU mesh: every
    lane OPTIMAL, with its unsharded lane's pivots and objective. (The
    JAX package's sharded lanes are held to the port's over 2 devices in
    tests/test_torch_batch.py::test_mesh_raises_multi_device.)"""
    if entry == "qp":
        jmodels = [_portfolio_qp(12, g, seed=1) for g in np.linspace(1.0, 4.0, 8)]
    else:
        jmodels = _perturbed_models(count=8)
    fn = {"solve_batch": clp_tpu_torch.solve_batch, "dual": tb.solve_batch_dual_simplex,
          "qp": tb.solve_batch_qp_simplex}[entry]
    plain = fn([port_model(m) for m in jmodels], _cpu())
    sharded = fn([port_model(m) for m in jmodels], _cpu(), mesh=make_mesh(CPU8))
    for s, p in zip(sharded, plain):
        assert int(s.status) == int(p.status) == int(clp_tpu.ProblemStatus.OPTIMAL)
        assert s.iterations == p.iterations
        assert abs(s.objective_value - p.objective_value) <= 1e-9 * (1 + abs(p.objective_value))


# --------------------------------------------------------------------------
# racing over several devices, the dry run
# --------------------------------------------------------------------------


def test_racing_places_configuration_i_on_device_i_mod_n(monkeypatch):
    from clp_tpu_torch.model import Model
    from clp_tpu_torch.parallel.racing import default_race_configs, racing_solve

    seen = []
    inner = Model.initial_solve

    def spy(self, opts=None):
        seen.append(str(opts.device))
        return inner(self, _cpu(**{k: getattr(opts, k) for k in ("method", "crash")}))

    monkeypatch.setattr(Model, "initial_solve", spy)
    mj = jgen.random_lp(12, 20, seed=4)
    configs = default_race_configs() + default_race_configs()[:1]  # 4 on 3 devices
    sol = racing_solve(port_model(mj), configs, devices=["cpu", "cpu:1", "cpu:2"])
    assert sorted(seen) == ["cpu", "cpu", "cpu:1", "cpu:2"]
    ref = inner(port_model(mj), _cpu(method=clp_tpu_torch.SolveMethod.DUAL_SIMPLEX))
    assert int(sol.status) == int(ref.status) == int(clp_tpu.ProblemStatus.OPTIMAL)
    # the winner may be the barrier without crossover
    assert abs(sol.objective_value - ref.objective_value) <= 1e-6 * (
        1 + abs(ref.objective_value))


def test_dryrun_multichip_runs(monkeypatch):
    from clp_tpu_torch.parallel.dryrun import dryrun_multichip, entry

    monkeypatch.setenv("CLPTPU_PLATFORM", "cpu")
    dryrun_multichip(8)
    fn, args = entry()
    pobj = fn(*args)
    assert pobj.shape == (4,) and bool(torch.isfinite(pobj).all())
