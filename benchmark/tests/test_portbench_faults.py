"""A whole run on the CPU at a small batch, sound and with the timed path
broken underneath: each fault, and the control (the reference in the
program's place, in float32), has to turn `correct` false. (The cell runs
on one card, so no exchange between cards can be left out.)"""

import dataclasses
import time
import types

import numpy as np
import pytest
import torch

from benchmark import control, harness, program, spec

LANES = {"ssn.dual.b2048": 4}


def run(cell, broken=None):
    sp = spec.Spec()
    work = sp.workload(cell)
    cfg = sp.config(work["config"])
    tr = dict(spec.traffic(work["traffic"]), lanes=LANES[cell], warmup_calls=0)
    real = program.entry(tr, "cpu")
    entry = real if broken is None else broken(real)
    return harness.run_cell(sp, work, 2**31 + 21, 0.0, False, "cpu", time.perf_counter(),
                            config=cfg, traffic=tr, entry=entry)


def unchanged(real):
    """The start handed back as the answer: no step taken."""
    from clp_tpu_torch.constants import ProblemStatus

    def call(models):
        sols = []
        for m in models:
            x = np.where(np.abs(m.col_lower) < program.BIG, m.col_lower, 0.0)
            sols.append(types.SimpleNamespace(
                status=ProblemStatus.OPTIMAL, objective_value=float(m.objective @ x),
                primal=x, duals=np.zeros(m.num_rows), iterations=0))
        return sols
    return call


def half_batch(real):
    """Half of the lanes solved, the other half given their answers."""
    def call(models):
        h = len(models) // 2
        sols = real(models[:h])
        return sols + [sols[i % h] for i in range(len(models) - h)]
    return call


def altered(what):
    def broken(real):
        def call(models):
            sols = real(models)
            s = sols[1]
            if what == "objective":
                s = dataclasses.replace(s, objective_value=s.objective_value
                                        + 1e-2 * (1 + abs(s.objective_value)))
            elif what == "primal":
                x = s.primal.copy()
                j = int(np.argmax(x))
                x[j] += 1e-2 * (1 + abs(x[j]))
                s = dataclasses.replace(s, primal=x)
            else:
                y = s.duals.copy()
                y[0] += 1e-2 * (1 + abs(y[0]))
                s = dataclasses.replace(s, duals=y)
            sols[1] = s
            return sols
        return call
    return broken


def reference_f32(real):
    return control.reference_entry("cpu", torch.float32)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "objective": altered("objective"), "primal": altered("primal"),
          "dual": altered("dual"), "control_f32": reference_f32}
CELLS = sorted(LANES)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert list(res)[-1] == "checks" and res["metrics"]["instances_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(cell, fault):
    res = run(cell, FAULTS[fault])
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0
