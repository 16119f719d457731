"""What the port's tracing (clp_tpu_torch/trace.py) costs on the
benchmark's cell: calls of ssn.dual.b2048's size with tracing off and on
in turns (off, on, on, off, ...), in one process on one card.

    python3 tools/trace_cost.py [--pairs 6]

Each call draws new scenarios, builds its Models before the clock starts
and is timed to its return after torch.cuda.synchronize(), as the
benchmark times a call. Prints each call's wall and OPTIMAL instances a
second, the median of each side, and the host time of one span and of one
count, on and off.
"""

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CELL = "ssn.dual.b2048"
SEED = 2**31 + 77


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--pairs", type=int, default=6)
    a = p.parse_args(argv)

    import numpy as np
    import torch

    from benchmark import program, spec
    from clp_tpu_torch import trace

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sp = spec.Spec()
    work = sp.workload(CELL)
    cfg = sp.config(work["config"])
    tr = spec.traffic(work["traffic"])
    gen = spec.generator(cfg["generator"])
    call = program.entry(tr, "cuda")
    rng = np.random.default_rng(SEED)
    base = gen.base(cfg)

    def one(on: bool) -> dict:
        mods = program.models(gen.batch(cfg, base, rng, tr["lanes"]))
        if on:
            trace.enable()
        torch.cuda.synchronize()
        t = time.perf_counter()
        sols = call(mods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        trace.disable()
        trace.reset()
        rec = {"tracing": on, "wall_s": wall,
               "instances_per_s": int(program.answers(sols)["optimal"].sum()) / wall}
        print(json.dumps(rec), flush=True)
        return rec

    one(False)  # warm-up
    runs = []
    for i in range(a.pairs):
        runs += [one(on) for on in ((False, True) if i % 2 == 0 else (True, False))]
    med = {on: statistics.median(r["instances_per_s"] for r in runs if r["tracing"] is on)
           for on in (False, True)}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "pairs": a.pairs,
                      "median_off": med[False], "median_on": med[True],
                      "cost_pct": 100 * (1 - med[True] / med[False]),
                      "host_ns": op_costs(trace)}), flush=True)
    return 0


def op_costs(trace, n: int = 100_000) -> dict:
    """Host nanoseconds of one span (enter and exit) and of one count, with
    tracing on (inside an open root) and off."""
    out = {}
    for on in (False, True):
        (trace.enable if on else trace.disable)()
        with trace.span("cost"):
            t = time.perf_counter_ns()
            for _ in range(n):
                trace.count("n", 1)
            out[f"count_{'on' if on else 'off'}"] = (time.perf_counter_ns() - t) / n
            t = time.perf_counter_ns()
            for _ in range(n):
                with trace.span("s"):
                    pass
            out[f"span_{'on' if on else 'off'}"] = (time.perf_counter_ns() - t) / n
    trace.disable()
    trace.reset()
    return out


if __name__ == "__main__":
    sys.exit(main())
