"""The system under test: clp_tpu_torch, driven as its users call it.

A traffic file names the entry (`module:function` inside clp_tpu_torch)
and the SolveOptions it is given. The entry takes the call's list of
Models and returns one Solution per Model. The harness builds the Models
from the generated arrays before a call's clock starts, and reads back
what a user receives: status, objective, primal values, row duals and the
iteration count.
"""

from __future__ import annotations

import importlib

import numpy as np

PACKAGE = "clp_tpu_torch"
BIG = 1e30  # the port's infinity (Clp's COIN_DBL_MAX convention)


def entry(traffic: dict, device: str):
    """fn(models) -> solutions for the traffic's entry and options."""
    from clp_tpu_torch import SolveOptions
    from clp_tpu_torch.constants import SolveMethod

    module, _, func = traffic["entry"].partition(":")
    if module.split(".")[0] != PACKAGE:
        raise ValueError(f"entry {traffic['entry']!r} is not in {PACKAGE}")
    fn = getattr(importlib.import_module(module), func)
    opts = SolveOptions(device=device)
    for key, value in traffic.get("options", {}).items():
        if key == "method":
            opts.method = SolveMethod[value]
        elif key == "presolve":
            opts.presolve.enabled = bool(value)
        else:
            setattr(opts, key, value)
    return lambda models: fn(models, opts)


def models(batch: dict) -> list:
    """One clp_tpu_torch Model per lane of a generated batch."""
    from clp_tpu_torch.model import Model

    def big(v):
        return np.where(np.isinf(v), np.sign(v) * BIG, v)

    A, c = batch["A"], batch["c"]
    l, u = big(batch["l"]), big(batch["u"])
    rl, ru = big(batch["rl"]), big(batch["ru"])
    out = []
    for i in range(rl.shape[0]):
        mod = Model()
        mod.load_problem(A, l, u, c, rl[i], ru[i])
        out.append(mod)
    return out


def answers(solutions: list) -> dict:
    """What the callers receive, stacked over lanes."""
    from clp_tpu_torch.constants import ProblemStatus

    return {"optimal": np.array([s.status == ProblemStatus.OPTIMAL for s in solutions]),
            "obj": np.array([s.objective_value for s in solutions], dtype=np.float64),
            "x": np.stack([np.asarray(s.primal, dtype=np.float64) for s in solutions]),
            "y": np.stack([np.asarray(s.duals, dtype=np.float64) for s in solutions]),
            "iterations": np.array([s.iterations for s in solutions], dtype=np.int64)}
