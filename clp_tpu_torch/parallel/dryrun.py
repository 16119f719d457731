"""Single-device compile check and multi-device dry run of the port.

The port's counterpart of the JAX package's `__graft_entry__.py`:

entry() returns a callable and example tensors for the flagship compute
path: one scenario-batched Mehrotra IPM solve (bounded iterations) of 4
tiny LPs, on the default device.

dryrun_multichip(n_or_devices) builds a mesh of n devices (or of the
devices given) and runs both mesh axes end to end on tiny shapes: the
scenario-sharded batched IPM, block repricing with SPRINT, the
column-sharded dual engine and the scenario-sharded QP-simplex risk sweep.
Given a count, the mesh repeats the visible devices in turn (one card
gives ["cuda:0"] * n; under CLPTPU_PLATFORM=cpu, ["cpu"] * n).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch


def _tiny_batch(batch: int, m: int = 6, n: int = 10, seed: int = 0, device="cpu"):
    from ..forms import StandardLP, to_ipm_form
    from ..utils.generators import random_lp

    # perturbed-RHS scenarios of one base model (same shape across batch;
    # equality rows would otherwise change the IPM form's column count)
    base = random_lp(m, n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    lps = []
    for _ in range(batch):
        model = base.copy()
        shift = np.abs(rng.uniform(0, 0.05, model.num_rows))
        model.row_lower = np.where(
            model.row_lower > -1e29, model.row_lower - shift, model.row_lower)
        model.row_upper = np.where(
            model.row_upper < 1e29, model.row_upper + shift, model.row_upper)
        lp, _ = to_ipm_form(model, device="cpu")
        lps.append(lp)
    return StandardLP(**{k: torch.stack([getattr(lp, k) for lp in lps]).to(device)
                         for k in ("G", "b", "c", "l", "u")})


def entry():
    """(fn, example_args): the batched IPM solve on one device."""
    from ..device import default_device, resolve_device
    from ..interior.mehrotra import IPMOptions, ipm_solve_batched

    opts = IPMOptions(max_iter=5)
    batched = _tiny_batch(4, device=resolve_device(default_device()))

    def fn(lp):
        return ipm_solve_batched(lp, opts).pobj

    return fn, (batched,)


def _devices(n_or_devices) -> list:
    from .mesh import default_devices

    if isinstance(n_or_devices, int):
        vis = default_devices()
        return [vis[i % len(vis)] for i in range(n_or_devices)]
    return list(n_or_devices)


def dryrun_multichip(n_or_devices: Union[int, Sequence]) -> None:
    """Exercise BOTH mesh axes on an n-entry mesh:

    1. `scenario` — a sharded batch of LP instances through the batched
       Mehrotra IPM (data-parallel analog).
    2. `block`   — columns of ONE wide LP sharded across the entries:
       SPRINT with sharded repricing, then the dual simplex itself with its
       column axis sharded.
    """
    from ..forms import StandardLP, to_standard_form
    from ..interior.mehrotra import IPMOptions, ipm_batched_prog
    from ..options import SolveOptions
    from ..simplex import engine
    from ..sprint import sprint_solve
    from ..utils.generators import random_lp
    from ..utils.lockstep import lockstep
    from .block import BlockShardedColumns, make_block_mesh
    from .colshard import dual_solve_colsharded
    from .mesh import make_mesh, scenario_sharding

    devices = _devices(n_or_devices)
    n = len(devices)

    # --- scenario axis: sharded instance batch, all shards in lockstep ---
    mesh = make_mesh(devices, axis_name="scenario")
    sh = scenario_sharding(mesh)
    batched = _tiny_batch(2 * n)
    blocks = [dict(zip("Gbclu", parts)) for parts in zip(
        *(sh.split(getattr(batched, k)) for k in ("G", "b", "c", "l", "u")))]
    res = lockstep([ipm_batched_prog(StandardLP(**b), IPMOptions(max_iter=3))
                    for b in blocks])
    pobj = torch.cat([r.pobj.cpu() for r in res])
    assert pobj.shape == (2 * n,), pobj.shape

    # --- block axis: one wide LP, columns sharded, sprint repricing ---
    bmesh = make_block_mesh(devices)
    wide = random_lp(4, 16 * n, seed=2, density=0.5)
    cols = BlockShardedColumns(wide.matrix, wide.objective, bmesh)
    dj, vals, idx = cols.reprice(np.zeros(wide.num_rows), k=8)
    assert dj.shape == (wide.num_cols,)
    sopts = SolveOptions(device=str(devices[0]))
    sopts.presolve.enabled = False
    sol = sprint_solve(wide, sopts, max_passes=3, mesh=bmesh)
    assert sol.primal is not None

    # --- block axis, IN-ENGINE: the dual simplex with its column axis
    # sharded (PRICE local per shard, the merges on the first entry) ---
    lp2, _ = to_standard_form(random_lp(6, 8 * n, seed=3, density=0.5), device="cpu")
    st, _slp2, _ = dual_solve_colsharded(
        lp2, engine.SimplexOptions(max_iterations=2000, dual_ratio="bfrt"), bmesh)
    assert int(st.status) == engine.OPTIMAL, int(st.status)

    _dryrun_qp_batch(devices)


def _dryrun_qp_batch(devices) -> None:
    """Scenario axis for the QP active-set engine: a sharded risk-aversion
    sweep of same-structure portfolio QPs (parallel/batch.py
    solve_batch_qp_simplex), all lane blocks in lockstep."""
    import scipy.sparse as sp

    from ..model import Model
    from ..options import SolveOptions
    from .batch import solve_batch_qp_simplex
    from .mesh import make_mesh

    rng = np.random.default_rng(0)
    n = 6
    F = rng.normal(size=(n, 3))
    S = F @ F.T / n + np.eye(n) * 0.05
    mu = rng.uniform(0.01, 0.12, n)
    models = []
    for gamma in np.linspace(1.0, 4.0, 2 * len(devices)):
        m = Model()
        m.load_problem(sp.csc_matrix(np.ones((1, n))), np.zeros(n),
                       np.full(n, 0.6), -mu, np.array([1.0]),
                       np.array([1.0]))
        m.quadratic_objective = sp.csc_matrix(gamma * S)
        models.append(m)
    mesh = make_mesh(devices, axis_name="scenario")
    sols = solve_batch_qp_simplex(models, SolveOptions(device=str(devices[0])), mesh=mesh)
    assert all(s.primal is not None for s in sols)
