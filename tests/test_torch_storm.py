"""The batched dual simplex on the float32 inverse, which the card takes
from m = 512 (STORM's second stage, 528 x 1259): the lanes the float32
loop leaves unsettled finish warm on the float64 engine as one batch, and
none goes to the single-LP driver (CPU, the inverse dtype forced).

The batched solves run on one torch thread: batched LU under vmap has hung
at two to four threads on CPU LAPACK (ROADMAP queue 3)."""

import json
import pathlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clp_tpu_torch
from benchmark import program
from benchmark.generators import ssn, storm
from benchmark.reference import check
from clp_tpu_torch import trace
from clp_tpu_torch.constants import INF, ProblemStatus
from clp_tpu_torch.parallel import batch as tb
from clp_tpu_torch.simplex import engine as te
from clp_tpu_torch.simplex.driver import simplex_solve
from clp_tpu_torch.utils import generators as gen
from clp_tpu_torch.utils.lockstep import run
from tests.worker_threads import set_worker_threads

set_worker_threads()

BENCH = pathlib.Path(__file__).resolve().parent.parent / "benchmark"
# SSN's 32 lanes of seed 1 under the float32 inverse: the float32 loop
# stops 9 of them, each after three fresh factors in a row whose next
# pivot the f32 pivot floor refused (a column made eligible by pricing
# noise, |alpha| ~1e-7 where the exact value is ~1e-16); the float64
# finish ends all 9
SSN32_STOPPED = [2, 7, 8, 13, 15, 19, 27, 28, 29]


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _limits(cell):
    return json.loads((BENCH / "traffic" / f"{cell}.json").read_text())["limits"]


def _options(inverse_dtype):
    o = clp_tpu_torch.SolveOptions(device="cpu", inverse_dtype=inverse_dtype,
                                   method=clp_tpu_torch.SolveMethod.DUAL_SIMPLEX)
    o.presolve.enabled = False
    return o


@pytest.fixture(autouse=True)
def _one_thread_traced():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.enable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ssn32():
    cfg = _config("ssn-recourse")
    return ssn.batch(cfg, ssn.base(cfg), np.random.default_rng(1), 32)


def _solve(batch, inverse_dtype):
    sols = tb.solve_batch_dual_simplex(program.models(batch), _options(inverse_dtype))
    (root,) = trace.snapshot()
    trace.reset()
    return sols, root


def test_ssn_lanes_the_f32_loop_stops_finish_in_f64(ssn32):
    sols, root = _solve(ssn32, "float32")
    ref, _ = _solve(ssn32, "float64")
    c = root["counters"]
    assert all(s.status == ProblemStatus.OPTIMAL for s in sols)
    assert c.get("leftover_lanes", 0) == 0
    assert c["f64_finish_lanes"] == c["f32_stops"] == c["f32_stops_stall"] == len(SSN32_STOPPED)
    assert c["f32_stops_refactor"] == c["f32_stops_claim"] == c["f32_stops_limit"] == 0
    assert 0 < c["lane_steps_f32"] < c["lane_steps"]
    spans = {s["name"]: s for s in root["spans"]}
    assert spans["f64_finish"]["parent"] == spans["loop"]["id"]
    for s, r in zip(sols, ref):
        assert abs(s.objective_value - r.objective_value) <= 1e-9 * (1 + abs(r.objective_value))


def test_the_f32_loop_stops_the_lanes_named():
    """The compacting loop itself ends NUMERICAL the lanes named above."""
    cfg = _config("ssn-recourse")
    batch = ssn.batch(cfg, ssn.base(cfg), np.random.default_rng(1), 32)
    lp_b, _ = tb.stack_models_simplex(program.models(batch), "cpu")
    E = tb._Lanes(tb._lpd(lp_b), tb._engine_options(_options("float32"), 175, False))
    S = run(tb._compacting_prog(E, E.initial_state()))
    assert np.flatnonzero(S["status"].numpy() == te.NUMERICAL).tolist() == SSN32_STOPPED


def _storm_part():
    """STORM's configuration at about half its rows (298 x 580), its
    kinds of rows, coefficients and costs kept: below m = 512, so the
    float32 inverse is forced."""
    cfg = dict(_config("storm-recourse"), airports=18, legs=110, demands=60, paths=520,
               extra_flights=220)
    cfg["rows"], cfg["columns"] = 2 * 110 + 18 + 60, 520 + 60
    return cfg, storm.base(cfg)


@pytest.mark.parametrize("seed", [3, 4])
def test_a_storm_batch_under_f32_against_the_reference(seed):
    """Each seed's batch has a lane the float32 loop stops (a refused
    pivot after three fresh factors); every lane within the cell's limits
    of the plain reference."""
    cfg, base = _storm_part()
    batch = storm.batch(cfg, base, np.random.default_rng(seed), 8)
    assert base["A"].shape == (cfg["rows"], cfg["columns"])
    sols, root = _solve(batch, "float32")
    c = root["counters"]
    assert c["f64_finish_lanes"] == c["f32_stops_stall"] == 1
    assert c.get("leftover_lanes", 0) == 0
    verdict = check.judge([{"batch": batch, "answers": program.answers(sols)}],
                          _limits("storm.dual.b512"))
    assert verdict["correct"] and verdict["passed"] == [8], verdict["worst"]


def test_a_finished_lane_is_its_single_solve(ssn32):
    """A lane sent to the float64 finish: the status and objective that the
    single-LP driver gives it alone (its own mixed-precision escalation)."""
    sols, _ = _solve(ssn32, "float32")
    for i in SSN32_STOPPED[:2]:
        one = simplex_solve(program.models(ssn32)[i], _options("float32"), dual=True)
        assert one.status == sols[i].status == ProblemStatus.OPTIMAL
        assert abs(one.objective_value - sols[i].objective_value) <= \
            1e-9 * (1 + abs(one.objective_value))


def test_the_f64_primal_cleans_a_primal_feasible_basis():
    """The cleanup of an OPTIMAL claim whose reduced costs have the wrong
    sign, on a basis far from optimal: every demand unmet (the unmet
    columns and the capacity rows' slacks basic), primal feasible, every
    route priced in. The float64 primal ends at the float64 route's
    optima."""
    cfg, base = _storm_part()
    batch = storm.batch(cfg, base, np.random.default_rng(5), 4)
    lp_b, _ = tb.stack_models_simplex(program.models(batch), "cpu")
    E = tb._Lanes(tb._lpd(lp_b), tb._engine_options(_options("float32"), 298, False))
    m, n, routes = 298, 580, 520
    basis = torch.cat([n + torch.arange(m - 60), routes + torch.arange(60)])
    vstat = torch.full((n + m,), te.AT_LOWER, dtype=torch.int32)
    vstat[basis] = te.BASIC
    S = E.initial_state()
    S["basis"], S["vstat"] = basis.expand(4, m).clone(), vstat.expand(4, n + m).clone()
    S = E.recompute(S)
    assert E.verify_dual(S).all() and not E.verify_primal(S).any()
    S["status"] = torch.full_like(S["status"], te.OPTIMAL)
    S["binv"] = S["binv"].double()  # as _bf64_prog hands the states on
    S = run(tb._bf64_clean_prog(E, S, torch.ones(4, dtype=torch.bool)))
    assert S["binv"].dtype == torch.float64 and (S["status"] == te.OPTIMAL).all()
    ref, _ = _solve(batch, "float64")
    got = E.objective(S)
    for g, r in zip(got.tolist(), ref):
        assert abs(g - r.objective_value) <= 1e-9 * (1 + abs(r.objective_value))


def _on_a_fake_bound():
    """Lanes that end OPTIMAL with a free column nonbasic at a fake bound
    (no row holds it and no cost moves it), so each is re-solved twice
    and finished by the primal."""
    base = gen.random_lp(12, 20, seed=0)
    m = clp_tpu_torch.Model()
    m.load_problem(sp.hstack([base.matrix, sp.csc_matrix((12, 1))]).tocsc(),
                   np.r_[base.col_lower, -INF], np.r_[base.col_upper, INF],
                   np.r_[base.objective, 0.0], base.row_lower, base.row_upper)
    rng = np.random.default_rng(3)
    out = []
    for _ in range(4):
        lane = m.copy()
        shift = rng.uniform(0, 0.05, lane.num_rows)
        lane.row_lower = np.where(lane.row_lower > -1e29, lane.row_lower - shift, lane.row_lower)
        lane.row_upper = np.where(lane.row_upper < 1e29, lane.row_upper + shift, lane.row_upper)
        out.append(lane)
    return out


def test_a_finished_lane_on_a_fake_bound_escalates_in_f64(monkeypatch):
    """Lanes 1 and 2 are left NUMERICAL by the float32 loop (set after it)
    and finish in float64; they, like the rest, end on a fake bound. The
    escalation and the primal finish then run on the float64 engine, so
    every lane's x_B and y are those of fresh float64 factors of its final
    basis, and each lane is its single solve; none is a leftover."""
    stop, runs, out = [1, 2], [], {}
    loop, lanes = tb._compacting_prog, tb._dual_lanes

    def stopped(E, S, *a):
        S = yield from loop(E, S, *a)
        S = dict(S, status=S["status"].clone())
        S["status"][stop] = te.NUMERICAL
        return S

    def spy(name):
        real = getattr(tb, name)

        def prog(E, S, need, *a):
            runs.append((name, E.opts.inverse_dtype, E.G32 is None,
                         np.flatnonzero(need.numpy()).tolist()))
            return (yield from real(E, S, need, *a))
        monkeypatch.setattr(tb, name, prog)

    def dual_lanes(*a, **k):
        out["Ss"], out["lpds"], _, out["opts"] = r = lanes(*a, **k)
        return r

    monkeypatch.setattr(tb, "_compacting_prog", stopped)
    monkeypatch.setattr(tb, "_dual_lanes", dual_lanes)
    for name in ("_bf64_finish_prog", "_brerun_prog", "_bprimal_finish_prog"):
        spy(name)
    models = _on_a_fake_bound()
    sols = tb.solve_batch_dual_simplex(models, _options("float32"))
    c = trace.snapshot()[0]["counters"]
    assert c["f64_finish_lanes"] == len(stop) and c.get("leftover_lanes", 0) == 0
    assert runs[0] == ("_bf64_finish_prog", "float32", False, stop)
    assert [r[0] for r in runs[1:]] == ["_brerun_prog", "_brerun_prog", "_bprimal_finish_prog"]
    for _, dtype, no_g32, need in runs[1:]:
        assert dtype == "float64" and no_g32 and set(stop) <= set(need)
    (S,), (lpd,) = out["Ss"], out["lpds"]
    assert out["opts"].inverse_dtype == "float64" and S["binv"].dtype == torch.float64
    R = tb._Lanes(lpd, out["opts"]).recompute(S)
    for k in ("xb", "y"):
        assert torch.allclose(S[k], R[k], rtol=0, atol=1e-12), k
    for i, s in enumerate(sols):
        one = simplex_solve(_on_a_fake_bound()[i], _options("float32"), dual=True)
        assert one.status == s.status == ProblemStatus.OPTIMAL
        assert abs(one.objective_value - s.objective_value) <= \
            1e-9 * (1 + abs(one.objective_value))
