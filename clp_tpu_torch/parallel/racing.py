"""Portfolio racing — several solver configurations, first winner takes it.

Reference: ClpRacingSolver (ClpRacingSolver.hpp:12-26) races {dual,
primal+idiot, primal+sprint} clones on std::threads with an atomic abort.
Here each configuration runs on its own thread and, on the card, on its
own CUDA stream of its device (configuration i on devices[i % len(devices)]
when a device list is given); the first OPTIMAL result wins and is
installed on the model. Once a winner is in, the others stop at their next
event (the reference's atomic abort; the JAX package lets them run on and
waits up to 60 s for each): a copy with no event handler of its own gets
one that asks to abort, and a simplex stops USER_STOPPED at its next chunk. `race_seeds` runs K cost-perturbed variants of one
LP as one batched dual simplex instead.

A configuration that fails by the solver's own means (a non-OPTIMAL
status, NotImplementedError, ValueError, DecompositionError) loses and is
recorded. Any other exception, a torch or CUDA error among them, ends the
race with that error: the JAX package's catch-all would hide a device
fault as a lost configuration.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..constants import ProblemStatus, SolveMethod
from ..decompose import DecompositionError
from ..device import resolve_device
from ..model import Model, Solution
from ..options import SolveOptions

# the solver's own ways to fail: a configuration that raises one of these
# loses the race; anything else ends it
SOLVER_ERRORS = (NotImplementedError, ValueError, DecompositionError)


def default_race_configs() -> list[SolveOptions]:
    """The reference's portfolio: dual / primal+idiot / barrier."""
    a = SolveOptions(method=SolveMethod.DUAL_SIMPLEX)
    b = SolveOptions(method=SolveMethod.PRIMAL_SIMPLEX, crash="idiot")
    c = SolveOptions(method=SolveMethod.BARRIER_NO_CROSS)
    return [a, b, c]


def racing_solve(
    model: Model,
    configs: Optional[Sequence[SolveOptions]] = None,
    devices: Optional[Sequence] = None,
) -> Solution:
    """Race `configs` on threads. Given `devices`, configuration i runs on
    devices[i % len(devices)], as in the JAX package; without, each on its
    own `device`."""
    configs = list(configs or default_race_configs())
    if devices:
        devices = list(devices)
        configs = [dataclasses.replace(o, device=devices[i % len(devices)])
                   for i, o in enumerate(configs)]
    winner: dict = {"results": []}
    lock = threading.Lock()
    done = threading.Event()

    won = threading.Event()

    def run(i: int, opts: SolveOptions):
        mod = model.copy()
        if getattr(mod, "event_handler", None) is None:
            mod.event_handler = lambda which, m: 0 if won.is_set() else None
        dev = resolve_device(opts.device)
        try:
            if dev.type == "cuda":
                with torch.cuda.stream(torch.cuda.Stream(dev)):
                    sol = mod.initial_solve(opts)
                    torch.cuda.current_stream(dev).synchronize()
            else:
                sol = mod.initial_solve(opts)
        except SOLVER_ERRORS as e:
            sol = Solution(status=ProblemStatus.ERRORS)
            sol.error = str(e)  # type: ignore[attr-defined]
        except Exception as e:  # noqa: BLE001 — raised in the caller below
            with lock:
                winner.setdefault("fault", e)
            done.set()
            return
        with lock:
            if sol.status == ProblemStatus.OPTIMAL and "sol" not in winner:
                winner["sol"] = sol
                winner["config"] = i
                won.set()
                done.set()
            winner["results"].append((i, sol))
            if len(winner["results"]) == len(configs):
                done.set()

    threads = [threading.Thread(target=run, args=(i, o), daemon=True)
               for i, o in enumerate(configs)]
    for t in threads:
        t.start()
    done.wait()
    for t in threads:
        t.join(timeout=60.0)
    if "fault" in winner:
        raise winner["fault"]

    if "sol" in winner:
        model.solution = winner["sol"]
        model.solution.winning_config = winner["config"]  # type: ignore[attr-defined]
        return model.solution
    # no optimal finisher: the most definitive result
    order = {
        ProblemStatus.PRIMAL_INFEASIBLE: 0,
        ProblemStatus.DUAL_INFEASIBLE: 1,
        ProblemStatus.STOPPED: 2,
        ProblemStatus.ERRORS: 3,
        ProblemStatus.UNKNOWN: 4,
    }
    results = sorted(winner["results"], key=lambda r: order.get(r[1].status, 9))
    sol = results[0][1] if results else Solution(status=ProblemStatus.ERRORS)
    model.solution = sol
    return sol


def race_seeds(
    model: Model,
    options: Optional[SolveOptions] = None,
    k: int = 8,
    perturb: float = 1e-6,
    max_chunks: int = 400,
) -> Solution:
    """K data-parameterized variants of ONE LP in one batched dual simplex.

    Variant 0 keeps the true costs; the others perturb them (the
    anti-degeneracy diversification of ClpSimplexDual::perturb), drawn by
    numpy from the model's random seed as in the JAX package. Chunks run in
    lockstep; the first variant whose claim verifies wins, its basis
    warm-starts one cleanup solve on the true costs, and the rest stop. On
    degenerate LPs where one trajectory stalls, another seed's usually
    does not."""
    from ..forms import to_standard_form
    from ..simplex import engine
    from ..simplex.driver import _ENGINE_TO_VS, simplex_solve
    from .batch import _bchunk, _bprep, _Lanes

    options = options or SolveOptions()
    lp, _info = to_standard_form(model, device=options.device)
    m, nt = lp.G.shape
    n = nt - m
    c = lp.c.cpu().numpy()
    rng = np.random.default_rng(model.random_seed)
    rows = [np.zeros(nt)]
    for _ in range(k - 1):
        rows.append(rng.uniform(0.5, 1.0, nt) * perturb * (1.0 + np.abs(c)))
    dev = lp.G.device
    lpd = {"G": lp.G.expand(k, m, nt),
           "b": lp.b.expand(k, m),
           "c": torch.as_tensor(c[None, :] + np.stack(rows), dtype=lp.c.dtype, device=dev),
           "l": lp.l.expand(k, nt),
           "u": lp.u.expand(k, nt)}
    opts = engine.SimplexOptions(
        refactor_frequency=options.refactor_frequency or 100,
        max_iterations=options.max_iterations or 100000,
    )
    E = _Lanes(lpd, opts)
    st = _bprep(E, E.initial_state())
    winner = -1
    for _ in range(max_chunks):
        st, verified, _obj = _bchunk(E, st)
        ver, stat = torch.stack([verified.to(torch.int64),
                                 st["status"].to(torch.int64)]).cpu().numpy()
        wins = np.flatnonzero(ver.astype(bool) & (stat == engine.OPTIMAL))
        if wins.size:
            winner = int(wins[0])
            break
        # an OPTIMAL claim verifies in the NEXT chunk (fresh factors): keep
        # going while any variant runs or has a pending claim
        pending = (stat == engine.CONTINUE) | ((stat == engine.OPTIMAL) & ~ver.astype(bool))
        if not np.any(pending):
            break
    if winner < 0:
        # no variant verified: the plain driver adjudicates (its certificate
        # checks also own infeasible/unbounded claims)
        return simplex_solve(model, options, dual=True)
    vstat = st["vstat"][winner].cpu().numpy()
    warm = Solution(
        column_status=np.array([_ENGINE_TO_VS[int(s)] for s in vstat[:n]], dtype=np.int8),
        row_status=np.array([_ENGINE_TO_VS[int(s)] for s in vstat[n:]], dtype=np.int8),
    )
    # cleanup on the true costs from the winning basis (perturbation
    # removal, ClpSimplexDual.cpp:6533 restore-and-clean step)
    sol = simplex_solve(model, options, dual=True, warm=warm)
    sol.winning_config = winner  # type: ignore[attr-defined]
    model.solution = sol
    return sol
