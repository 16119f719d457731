"""One run of one cell: set-up, the measured window, the profiled call, the
check against the reference, and the result line.

The calls form a closed loop with one caller: the next call starts when the
last has returned, as a Benders or SAA loop waits for all its scenarios.
Before a call's clock starts, the generator draws the call's scenarios from
the run's seed and the harness builds one Model per lane; the clock then
runs from the entry to its return after torch.cuda.synchronize(): the
port's stacking into standard form, the device loop and the per-lane
unpack into Solutions. Calls start until `--seconds` have passed since the
window opened; the last one runs to its end.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import program, spec, trace
from .reference import check

FORBIDDEN = ("jax", "jaxlib", "flax", "clp_tpu")


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({k for k in list(sys.modules) if k.split(".")[0] in FORBIDDEN})


def main(argv, t0: float) -> int:
    args = parse(argv)
    sp = spec.Spec()
    try:
        work = sp.workload(args.workload)
    except KeyError as e:
        log(str(e))
        return 2
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: the benchmark runs on an NVIDIA card only")
        return 2
    if torch.cuda.device_count() < work["chips"]:
        log(f"{work['name']} needs {work['chips']} cards; "
            f"torch.cuda.device_count() is {torch.cuda.device_count()}")
        return 2
    result = run_cell(sp, work, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")
        return 3
    print_result(result)
    return 0


def print_result(result: dict) -> None:
    for name, c in result["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)


def run_cell(sp, work: dict, seed: int, seconds: float, trace_on: bool, device: str,
             t0: float, config: dict = None, traffic: dict = None, entry=None) -> dict:
    """Run the cell `work` once and return the result object. `config`,
    `traffic` and `entry` replace what the cell names (the tests' small
    sizes and broken paths)."""
    import torch

    cuda = device == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = config or sp.config(work["config"])
    tr = traffic or spec.traffic(work["traffic"])
    gen = spec.generator(cfg["generator"])
    call = entry or program.entry(tr, device)
    rng = np.random.default_rng(seed)
    base = gen.base(cfg)
    lanes = tr["lanes"]
    per_layer = sp.per_layer(work["name"]) if trace_on else []
    readers = [(m["name"], m["unit"], spec.metric_reader(m["name"])) for m in per_layer]

    def one_call(fn=None):
        batch = gen.batch(cfg, base, rng, lanes)
        mods = program.models(batch)
        sync()
        t = time.perf_counter()
        sols = call(mods) if fn is None else fn(lambda: call(mods))
        sync()
        wall = time.perf_counter() - t
        return batch, sols, wall

    for i in range(tr["warmup_calls"]):
        _, _, wall = one_call()
        log(f"warm-up call {i}: {lanes} lanes in {wall:.3f} s")
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    records = []
    opened = time.perf_counter()
    while not records or time.perf_counter() - opened < seconds:
        batch, sols, wall = one_call()
        ans = program.answers(sols)
        del sols
        records.append({"batch": batch, "answers": ans, "wall": wall})
        log(f"call {len(records) - 1}: {lanes} lanes in {wall:.3f} s, "
            f"{int(ans['optimal'].sum())} OPTIMAL, iterations "
            f"{int(ans['iterations'].min())}-{int(ans['iterations'].max())}")
    window_s = time.perf_counter() - opened
    peak = torch.cuda.max_memory_allocated() if cuda else None
    if cuda:
        torch.cuda.empty_cache()

    profile = None
    judged = list(records)
    if trace_on:
        batch, (sols, prof), wall = one_call(lambda f: trace.profiled(f, sync))
        ans = program.answers(sols)
        del sols
        t_red = time.perf_counter()
        profile = trace.reduce(prof)
        del prof
        log(f"profile read in {time.perf_counter() - t_red:.1f} s")
        profile["max_iterations"] = int(ans["iterations"].max())
        judged.append({"batch": batch, "answers": ans, "wall": wall})
        log(f"profiled call: {lanes} lanes in {wall:.3f} s, {profile['kernels']} kernels, "
            f"device busy {profile['busy_s']:.3f} of {profile['window_s']:.3f} s")
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    verdict = check.judge(judged, tr["limits"], device)
    log(f"reference: {sum(r['answers']['x'].shape[0] for r in judged)} lanes judged in "
        f"{time.perf_counter() - t_ref:.1f} s; it stopped short of its tolerance on "
        f"{verdict['ref_unconverged']} (error up to {verdict['ref_err']:.3g}), judged "
        f"there without obj_gap")
    attempted = sum(r["answers"]["x"].shape[0] for r in judged)
    failed = attempted - sum(verdict["passed"])
    walls = sum(r["wall"] for r in records)
    ctx = {"peak_bytes": peak, "profile": profile,
           "calls": [{"wall": r["wall"], "iterations": r["answers"]["iterations"]}
                     for r in records]}
    if trace_on:
        metrics = {}
        for name, unit, read in readers:
            value = read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    else:
        metrics = {"instances_per_s": {"value": sum(verdict["passed"][:len(records)]) / walls,
                                       "unit": "instances/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    log(f"window: {len(records)} calls, {window_s:.3f} s, {walls:.3f} s in calls; "
        f"set-up {setup_s:.3f} s")
    result = {"correct": verdict["correct"], "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if trace_on and profile is not None:
        result["device"]["busy_s"] = profile["busy_s"]
        result["device"]["window_s"] = profile["window_s"]
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    result["ref_unconverged"] = verdict["ref_unconverged"]
    result["checks"] = {k: {"value": v, "limit": tr["limits"][k]}
                        for k, v in verdict["worst"].items()}
    return result
