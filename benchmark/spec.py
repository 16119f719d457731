"""BENCHMARK.json and the files it names, found by name."""

from __future__ import annotations

import importlib
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


class Spec:
    """The benchmark's description and lookups by name. Each lookup of a
    name that is not there raises KeyError naming it."""

    def __init__(self, path: pathlib.Path = ROOT / "BENCHMARK.json"):
        self.data = json.loads(pathlib.Path(path).read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((ROOT / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def per_layer(self, workload: str) -> list:
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", [workload])]


def traffic(name: str) -> dict:
    """benchmark/traffic/<name>.json."""
    path = HERE / "traffic" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no traffic mix {name!r} ({path.relative_to(ROOT)})")
    return json.loads(path.read_text())


def generator(name: str):
    """benchmark/generators/<name>.py."""
    if not (HERE / "generators" / f"{name}.py").is_file():
        raise KeyError(f"no generator {name!r} under benchmark/generators")
    return importlib.import_module(f"benchmark.generators.{name}")


def metric_reader(name: str):
    """The `read` of benchmark/metrics/<name>.py."""
    if not (HERE / "metrics" / f"{name}.py").is_file():
        raise KeyError(f"no reader for metric {name!r} under benchmark/metrics")
    return importlib.import_module(f"benchmark.metrics.{name}").read
