"""The comparison that decides `correct`.

Every lane that the timed calls returned is judged against the plain
reference (reference/lp.py), which solves the same generated arrays again
in float64 and never sees what the program made:

  not_optimal  lanes whose status is not OPTIMAL (every generated LP is
               feasible and bounded);
  obj_gap      |objective returned - reference optimum| / (1 + |optimum|);
  primal_inf   the primal values' worst bound violation (lp.measures);
  dual_inf     the row duals' worst sign error against an infinite bound;
  gap          |c'x - g(y)| / (1 + |c'x|) of the returned x and y.

Each is the worst over the OPTIMAL lanes and is held to the cell's limit
(the traffic file's `limits`); a number that a cell's LPs cannot move (no
infinite bound, so no dual of the wrong sign) has no limit there and is
not compared. A lane passes when it is OPTIMAL and each of its compared
readings is within its limit.

A lane on which the reference stops short of its tolerance is solved again
with a longer stall rule. Where it still stops short, its optimum is not
known to the tolerance, so that lane's `obj_gap` is not compared: it is
judged by `primal_inf`, `dual_inf` and `gap` alone, which certify its x
and y as optimal without the reference (weak duality). Such lanes are
counted in `ref_unconverged`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lp

NAMES = ("not_optimal", "obj_gap", "primal_inf", "dual_inf", "gap")
RETRY = {"max_iter": 400, "stall": 40}  # the second try on lanes that stopped short


def reference(batch: dict, device="cpu") -> dict:
    """The reference's optimum of every lane; the lanes that stop short of
    its tolerance are solved again under RETRY."""
    ref = lp.solve(batch, device=device, dtype=torch.float64)
    short = np.flatnonzero(~ref["converged"])
    if short.size:
        sub = dict(batch, rl=batch["rl"][short], ru=batch["ru"][short])
        again = lp.solve(sub, device=device, dtype=torch.float64, **RETRY)
        for k in ("obj", "converged", "err"):
            ref[k][short] = again[k]
    return ref


def lane_readings(batch: dict, ans: dict, ref_obj: np.ndarray) -> dict:
    """Per lane readings of the program's answers `ans` (program.answers)."""
    ms = lp.measures(batch, ans["x"], ans["y"])
    return {"obj_gap": np.abs(ans["obj"] - ref_obj) / (1.0 + np.abs(ref_obj)),
            "primal_inf": ms["primal_inf"], "dual_inf": ms["dual_inf"], "gap": ms["gap"]}


def judge(records: list, limits: dict, device="cpu") -> dict:
    """Judge every record (one call: its batch and its answers). Returns the
    worst reading of each number, each record's passing lanes, the lanes on
    which the reference itself stopped short of its tolerance, and the
    largest error it stopped at there."""
    worst = dict.fromkeys(NAMES, 0.0)
    worst["not_optimal"] = 0
    passed, ref_unconverged, ref_err = [], 0, 0.0
    for rec in records:
        ref = reference(rec["batch"], device)
        known = ref["converged"]
        ref_unconverged += int((~known).sum())
        if not known.all():
            ref_err = max(ref_err, float(ref["err"][~known].max()))
        read = lane_readings(rec["batch"], rec["answers"], ref["obj"])
        ok = rec["answers"]["optimal"]
        worst["not_optimal"] += int((~ok).sum())
        lane_ok = ok.copy()
        for k, v in read.items():
            if k not in limits:
                continue
            v = np.where(np.isnan(v), np.inf, v)
            if k == "obj_gap":  # only where the reference knows the optimum
                v = np.where(known, v, 0.0)
            if ok.any():
                worst[k] = max(worst[k], float(v[ok].max()))
            lane_ok &= v <= limits[k]
        passed.append(int(lane_ok.sum()))
    worst = {k: v for k, v in worst.items() if k in limits}
    correct = all(worst[k] <= limits[k] for k in worst)
    return {"worst": worst, "passed": passed, "correct": correct,
            "ref_unconverged": ref_unconverged, "ref_err": ref_err}
