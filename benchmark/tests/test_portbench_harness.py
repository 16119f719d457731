"""The harness: BENCHMARK.json to the contract, lookups by name, the trace
reduction, the readers, and a run with no card."""

import json
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import spec, trace
from benchmark.reference import check

HERE = pathlib.Path(__file__).resolve().parent.parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer") for m in BENCH[k])
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    sp = spec.Spec()
    work = sp.workload(cell)
    cfg = sp.config(work["config"])
    tr = spec.traffic(work["traffic"])
    assert spec.generator(cfg["generator"]).batch
    assert {"not_optimal", "obj_gap", "gap"} <= set(tr["limits"]) <= set(check.NAMES)
    for m in sp.per_layer(cell):
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("lookup, name", [
    (lambda n: spec.Spec().workload(n), "no-such-cell"),
    (lambda n: spec.Spec().config(n), "no-such-config"),
    (spec.traffic, "no-such-mix"),
    (spec.generator, "no-such-generator"),
    (spec.metric_reader, "no_such_metric"),
])
def test_a_missing_name_is_named(lookup, name):
    with pytest.raises(KeyError, match=name):
        lookup(name)


def run_py(cwd, timeout=120):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ssn.dual.b2048",
                           "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=timeout)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = run_py(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in out.stderr


def test_run_alone_in_its_paths_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_trace_reduction():
    device = [(10, 20, "k1"), (15, 30, "k2"), (50, 60, "Memcpy HtoD"), (200, 210, "late")]
    host = [(0, 9, "aten::stack"), (32, 45, "aten::where"), (33, 40, "aten::item")]
    r = trace.reduce_intervals(device, host, (0, 100))
    assert r["kernels"] == 2 and r["busy_s"] == pytest.approx(30e-6)
    assert r["window_s"] == pytest.approx(100e-6)
    gaps = dict((n, s) for n, s in r["idle_gaps"])
    assert gaps == pytest.approx({"stack: aten::stack": 10e-6, "solve call: aten::item": 20e-6,
                                  "unpack: python": 40e-6})
    assert r["device_ops"][0] == ["k2", pytest.approx(15e-6)]


def ctx(profile=None):
    return {"peak_bytes": 3 * 2**30, "profile": profile,
            "calls": [{"wall": 2.0, "iterations": np.array([10, 30])},
                      {"wall": 3.0, "iterations": np.array([20, 40])}]}


def test_readers():
    read = {m["name"]: spec.metric_reader(m["name"]) for m in BENCH["per_layer"]}
    prof = {"kernels": 800, "max_iterations": 40, "busy_s": 1.0, "window_s": 4.0}
    run = ctx(prof)
    assert read["lane_pivots_per_s"](run) == 20.0 and read["pivots_per_lane"](run) == 25.0
    assert read["launches_per_pivot"](run) == 20.0
    assert read["idle_pct"](run) == 75.0 and read["peak_device_gib"](run) == 3.0
    for name in ("launches_per_pivot", "idle_pct"):
        assert read[name](ctx()) is None
    nothing = dict(run, profile=dict(prof, kernels=0, busy_s=0.0))
    assert read["launches_per_pivot"](nothing) is None and read["idle_pct"](nothing) is None
    assert read["pivots_per_lane"](dict(run, calls=[])) is None
