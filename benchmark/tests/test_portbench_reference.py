"""The reference: it solves the generated LPs to HiGHS's optimum, accepts
an optimal answer and rejects a perturbed objective, primal or dual."""

import json
import pathlib

import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from benchmark import spec
from benchmark.generators import ssn
from benchmark.reference import check, lp

HERE = pathlib.Path(__file__).resolve().parent.parent


def highs(batch, i):
    A = batch["A"].toarray()
    rl, ru = batch["rl"][i], batch["ru"][i]
    lo, up = np.isfinite(rl), np.isfinite(ru)
    res = linprog(batch["c"], A_ub=np.vstack([A[up], -A[lo]]),
                  b_ub=np.concatenate([ru[up], -rl[lo]]),
                  bounds=[(a, None if np.isinf(b) else b) for a, b in zip(batch["l"], batch["u"])],
                  method="highs")
    assert res.status == 0
    return res.fun


def batches():
    """Each cell's LPs, small."""
    cfg = json.loads((HERE / "configs" / "ssn-recourse.json").read_text())
    sb = ssn.batch(cfg, ssn.base(cfg), np.random.default_rng(2**31 + 3), 6)
    return {"ssn.dual.b2048": sb}


BATCHES = batches()


@pytest.fixture(scope="module")
def solved():
    return {k: lp.solve(b) for k, b in BATCHES.items()}


@pytest.mark.parametrize("cell", sorted(BATCHES))
def test_reference_reaches_the_highs_optimum(cell, solved):
    res = solved[cell]
    assert res["converged"].all()
    for i in range(res["obj"].size):
        ref = highs(BATCHES[cell], i)
        assert abs(res["obj"][i] - ref) <= 1e-9 * (1 + abs(ref))


def answers(res):
    return {"optimal": np.ones(res["obj"].size, bool), "obj": res["obj"].copy(),
            "x": res["x"].copy(), "y": res["y"].copy(),
            "iterations": res["iterations"].copy()}


def worst(cell, ans, ref_obj):
    read = check.lane_readings(BATCHES[cell], ans, ref_obj)
    limits = spec.traffic(cell)["limits"]
    return {k: (float(v.max()), limits[k]) for k, v in read.items() if k in limits}


@pytest.mark.parametrize("cell", sorted(BATCHES))
def test_an_optimal_answer_passes(cell, solved):
    res = solved[cell]
    for k, (value, limit) in worst(cell, answers(res), res["obj"]).items():
        assert value <= limit, k


def perturbed(res, what):
    ans = answers(res)
    if what == "objective":
        ans["obj"][1] += 1e-2 * (1 + abs(ans["obj"][1]))
    elif what == "primal":
        j = int(np.argmax(ans["x"][1]))
        ans["x"][1, j] += 1e-2 * (1 + abs(ans["x"][1, j]))
    elif what == "dual":
        ans["y"][1, 0] += 1e-2 * (1 + abs(ans["y"][1, 0]))
    return ans


@pytest.mark.parametrize("what", ["objective", "primal", "dual"])
@pytest.mark.parametrize("cell", sorted(BATCHES))
def test_a_perturbed_answer_fails(cell, what, solved):
    res = solved[cell]
    read = worst(cell, perturbed(res, what), res["obj"])
    assert any(value > limit for value, limit in read.values()), read


def test_measures_are_zero_on_an_exact_vertex():
    """min x1 + x2, x1 + x2 >= 1, 0 <= x <= 1: x = (1, 0), y = 1."""
    batch = {"A": np.array([[1.0, 1.0]]), "c": np.array([1.0, 1.0]),
             "l": np.zeros(2), "u": np.ones(2),
             "rl": np.array([[1.0]]), "ru": np.array([[np.inf]])}
    ms = lp.measures(batch, np.array([[1.0, 0.0]]), np.array([[1.0]]))
    assert ms["primal_inf"][0] == ms["dual_inf"][0] == ms["gap"][0] == 0.0
    wrong = lp.measures(batch, np.array([[1.0, 0.0]]), np.array([[-1.0]]))
    assert wrong["dual_inf"][0] > 0  # y < 0 on a row with no upper bound
    res = lp.solve(batch, dtype=torch.float64)
    assert abs(res["obj"][0] - 1.0) < 1e-9


def test_a_lane_the_reference_leaves_short_is_judged_by_its_certificates(monkeypatch):
    """Where the reference stops short of its tolerance on a lane, even on
    the second try, that lane's objective is not held to the reference's
    (wrong here on purpose) but its x and y still have to certify it."""
    cell = "ssn.dual.b2048"
    batch, limits = BATCHES[cell], spec.traffic(cell)["limits"]
    good = lp.solve(batch)
    short = dict(good, obj=good["obj"].copy(), converged=good["converged"].copy(),
                 err=good["err"].copy())
    short["obj"][1] += 1.0
    short["converged"][1] = False
    short["err"][1] = 1e-5
    tries = []

    def stub(b, **kw):
        tries.append(b["rl"].shape[0])
        return short if len(tries) == 1 else {k: v[1:2] for k, v in short.items()}

    monkeypatch.setattr(lp, "solve", stub)
    verdict = check.judge([{"batch": batch, "answers": answers(good)}], limits)
    assert tries == [6, 1] and verdict["ref_unconverged"] == 1
    assert verdict["correct"] and verdict["ref_err"] == 1e-5
    verdict = check.judge([{"batch": batch, "answers": perturbed(good, "primal")}], limits)
    assert not verdict["correct"] and verdict["passed"] == [5]
