"""STORM's second stage (benchmark/generators/storm.py) and the readers of
the batched dual's float32 route: the generator's shape and structure,
its complete recourse, the readers on made-up roots, and a whole run on
the CPU at reduced sizes, sound and with each fault of
test_portbench_faults turning `correct` false; the warm-up call's time
limit."""

import json
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from benchmark import harness, program, spec
from benchmark.generators import storm
from benchmark.metrics import _program_trace as pt
from benchmark.reference import lp
from benchmark.tests.test_portbench_faults import FAULTS

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
CELL = "storm.dual.b512"
LEGS, AIRPORTS, DEMANDS, ROUTES = 193, 24, 118, 1141


def config():
    return json.loads((CONFIGS / "storm-recourse.json").read_text())


@pytest.fixture(scope="module")
def base():
    return storm.base(config())


def test_storm_shape_and_structure(base):
    cfg = config()
    A = base["A"]
    assert A.shape == (cfg["rows"], cfg["columns"]) == (528, 1259)
    assert 2 * LEGS + AIRPORTS + DEMANDS == 528 and ROUTES + DEMANDS == 1259
    assert cfg["random_parameters"] == DEMANDS
    dense = A.toarray()
    dem = dense[2 * LEGS + AIRPORTS:]
    # each route: its demand row, and the same weight on its legs' payload
    # rows as its demand's unit tons, real-valued; each unmet column: its
    # demand row alone
    assert np.array_equal(dem[:, :ROUTES].sum(0), np.ones(ROUTES))
    assert np.array_equal(dense[:, ROUTES:], np.vstack([np.zeros((528 - DEMANDS, DEMANDS)),
                                                        np.eye(DEMANDS)]))
    payload = dense[:LEGS, :ROUTES]
    assert (payload > 0).sum(0).min() >= 1
    assert np.unique(payload[payload > 0]).size > 100  # not 0/1
    assert np.array_equal(payload > 0, dense[LEGS:2 * LEGS, :ROUTES] > 0)
    assert (base["c"] > 0).all()
    # the penalty on unmet demand is above the cost of each of its routes
    owner = dem[:, :ROUTES].argmax(0)
    assert (base["c"][ROUTES + owner] > base["c"][:ROUTES]).all()
    per = dem[:, :ROUTES].sum(1)
    assert set(per) <= {9, 10} and per.sum() == ROUTES


def test_storm_batches_follow_the_seed(base):
    cfg = config()
    a = storm.batch(cfg, base, np.random.default_rng(2**31 + 7), 16)
    b = storm.batch(cfg, base, np.random.default_rng(2**31 + 7), 16)
    c = storm.batch(cfg, base, np.random.default_rng(2**31 + 8), 16)
    assert all(np.array_equal(a[k], b[k]) for k in ("rl", "ru", "c", "l", "u"))
    assert not np.array_equal(a["ru"], c["ru"])
    assert a["A"] is base["A"] and a["c"] is base["c"]  # shared A and c
    assert a["rl"].shape == a["ru"].shape == (16, 528)
    k = 2 * LEGS + AIRPORTS
    # capacities (<= rows) one per call, demands (= rows) one per lane: the
    # 118 random right-hand sides, each of five levels
    assert (a["ru"][:, :k] == a["ru"][:1, :k]).all() and np.isinf(a["rl"][:, :k]).all()
    assert (a["ru"][:, :k] > 0).all()
    assert np.array_equal(a["rl"][:, k:], a["ru"][:, k:])
    assert len({tuple(r) for r in a["rl"][:, k:]}) == 16
    assert all(len(set(a["rl"][:, k + i])) <= 5 for i in range(DEMANDS))


def test_storm_recourse_is_complete(base):
    """Leaving every demand unmet is feasible in every lane, and the
    reference finds each lane's optimum below that cost."""
    cfg = config()
    bt = storm.batch(cfg, base, np.random.default_rng(2**31 + 9), 2)
    x = np.zeros((2, 1259))
    x[:, ROUTES:] = bt["rl"][:, 2 * LEGS + AIRPORTS:]
    assert (lp.measures(bt, x, np.zeros((2, 528)))["primal_inf"] == 0).all()
    ref = lp.solve(bt)
    assert (ref["obj"] < x @ base["c"]).all()
    assert (lp.measures(bt, ref["x"], ref["y"])["primal_inf"] < 1e-8).all()


# --------------------------------------------------------------------------
# the readers
# --------------------------------------------------------------------------

READERS = ["f64_finish_lane_pct", "leftover_lane_pct", "pivot32_hbm_pct"]
S = 10**9


def root(spans, counters, lanes=512, m=528, n=1787):
    out, t = [], 0
    for name, s in spans.items():
        out.append({"name": name, "start_ns": t, "end_ns": t + int(s * S)})
        t += int(s * S)
    return {"profiled": False, "spans": out, "counters": counters,
            "attrs": {"lanes": lanes, "m": m, "n": n}}


def ctx(calls):
    return {"peak_bytes": None, "profile": None,
            "calls": [{"wall": 1.0, "iterations": np.array([1])}] * calls}


def test_readers_on_made_up_roots(monkeypatch):
    step = 4 * 528 * 1787 + 8 * 528 * 528
    assert step == 6_004_416
    one = root({"loop": 3.0, "f64_finish": 1.0},
               {"lane_steps_f32": 512 * 1000, "f64_finish_lanes": 64, "leftover_lanes": 1})
    two = root({"loop": 2.0, "f64_finish": 0.0}, {"lane_steps_f32": 512 * 500,
                                                  "f64_finish_lanes": 0})
    monkeypatch.setattr(pt, "trace", types.SimpleNamespace(snapshot=lambda: [one, two]))
    got = {n: spec.metric_reader(n)(ctx(2)) for n in READERS}
    assert got == pytest.approx({
        "f64_finish_lane_pct": 100 * 64 / 1024, "leftover_lane_pct": 100 * 1 / 1024,
        "pivot32_hbm_pct": 100 * 512 * 1500 * step / 3.35e12 / 4.0})
    # 512 lanes a step at the bound: 0.918 ms
    assert 512 * step / 3.35e12 == pytest.approx(0.918e-3, rel=1e-3)


def test_readers_on_a_program_without_the_float32_counters(monkeypatch):
    """The float64 route, or a program before the float64 finish: the
    finish and the float32 pivot are not read, no leftover reads 0."""
    plain = root({"loop": 1.0}, {"lane_steps": 100})
    monkeypatch.setattr(pt, "trace", types.SimpleNamespace(snapshot=lambda: [plain]))
    got = {n: spec.metric_reader(n)(ctx(1)) for n in READERS}
    assert got == {"f64_finish_lane_pct": None, "leftover_lane_pct": 0.0,
                   "pivot32_hbm_pct": None}
    for name in READERS:
        assert spec.metric_reader(name)(ctx(0)) is None
    monkeypatch.setattr(pt, "trace", None)
    for name in READERS:
        assert spec.metric_reader(name)(ctx(1)) is None


# --------------------------------------------------------------------------
# whole runs at reduced sizes
# --------------------------------------------------------------------------


def small():
    """The configuration at a tenth of its scale, widths and kinds kept."""
    cfg = dict(config(), airports=10, legs=40, demands=20, paths=130, extra_flights=60)
    cfg["rows"], cfg["columns"] = 2 * 40 + 10 + 20, 130 + 20
    return cfg


def run(broken=None):
    sp = spec.Spec()
    work = sp.workload(CELL)
    tr = dict(spec.traffic(work["traffic"]), lanes=4, warmup_calls=0)
    real = program.entry(tr, "cpu")
    entry = real if broken is None else broken(real)
    return harness.run_cell(sp, work, 2**31 + 21, 0.0, False, "cpu", time.perf_counter(),
                            config=small(), traffic=tr, entry=entry)


def test_a_sound_storm_run_is_correct():
    res = run()
    assert res["correct"] and res["failed"] == 0, res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_perturbed_storm_lane_is_not_correct(fault):
    res = run(FAULTS[fault])
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0


# --------------------------------------------------------------------------
# the warm-up call's time limit
# --------------------------------------------------------------------------

WATCHED = """
import json, sys, time
import numpy as np
from benchmark.generators import storm
storm._in_a_run = lambda: True
storm.WARMUP_LIMIT_S = 1.0
cfg = json.loads(sys.argv[1])
net = storm.base(cfg)
rng = np.random.default_rng(7)
for _ in range(int(sys.argv[2])):
    storm.batch(cfg, net, rng, 2)
time.sleep(4.0)  # a call that has not returned, or the rest of a run
"""


@pytest.mark.parametrize("calls, rc", [(1, 1), (2, 0)], ids=["warm-up-outlasts", "warm-up-returns"])
def test_a_warmup_call_past_its_limit_ends_the_run(calls, rc):
    root = pathlib.Path(__file__).resolve().parents[2]
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", WATCHED, json.dumps(small()), str(calls)],
                         cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == rc, out.stderr
    assert ("Timeout" in out.stderr) == (rc == 1), out.stderr
    assert "the warm-up call has 1 s" in out.stderr
    if rc:
        assert time.perf_counter() - t < 60


def test_only_a_run_is_timed():
    assert not storm._in_a_run()
    assert storm.RUN_PY.is_file()
