"""The readings that a cell's limits are set from.

For each seed, one call of the cell's own size through the timed entry (the
first batch that the seed draws), judged as a run judges it: the program's
readings, whose largest over a dozen seeds or more is the lower reading of
each number. On the first seeds also the control: the plain reference
itself, put in the program's place and computed in float32, the precision
below the float64 that the configurations state; its smallest reading of
each number is the upper one. `--control-device cpu` computes the control
on the host (the card's float32 Cholesky makes no progress on these
normal equations, so the host's control is the nearer one).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 ... --control-seeds 3

Prints one JSON line per seed and side, then the lower and upper readings.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import types

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from benchmark import program, spec  # noqa: E402
from benchmark.reference import check, lp  # noqa: E402


def arrays(models: list) -> dict:
    """A call's Models back to the generated arrays (the port's 1e30 as inf)."""
    def inf(v):
        v = np.asarray(v, dtype=np.float64)
        return np.where(np.abs(v) >= program.BIG, np.copysign(np.inf, v), v)

    m0 = models[0]
    return {"A": m0.matrix, "c": np.asarray(m0.objective, dtype=np.float64),
            "l": inf(m0.col_lower), "u": inf(m0.col_upper),
            "rl": np.stack([inf(m.row_lower) for m in models]),
            "ru": np.stack([inf(m.row_upper) for m in models])}


def reference_entry(device: str, dtype):
    """The control: the reference solver in the program's place, claiming
    OPTIMAL for each lane, as a program that computes in `dtype` would."""
    import torch  # noqa: F401

    from clp_tpu_torch.constants import ProblemStatus

    def call(models):
        res = lp.solve(arrays(models), device=device, dtype=dtype, tol=1e-6)
        return [types.SimpleNamespace(status=ProblemStatus.OPTIMAL, objective_value=float(o),
                                      primal=x, duals=y, iterations=int(k))
                for o, x, y, k in zip(res["obj"], res["x"], res["y"], res["iterations"])]
    return call


def readings(batch: dict, ans: dict, device: str) -> dict:
    ref = lp.solve(batch, device=device)
    read = check.lane_readings(batch, ans, ref["obj"])
    out = {k: float(np.nan_to_num(v, nan=np.inf).max()) for k, v in read.items()}
    out["not_optimal"] = int((~ans["optimal"]).sum())
    out["ref_unconverged"] = int((~ref["converged"]).sum())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--control-device", default=None,
                   help="where the float32 control computes (default: --device)")
    args = p.parse_args(argv)
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sp = spec.Spec()
    work = sp.workload(args.workload)
    cfg, tr = sp.config(work["config"]), spec.traffic(work["traffic"])
    gen = spec.generator(cfg["generator"])
    base = gen.base(cfg)
    sides = {"program": program.entry(tr, args.device),
             "control": reference_entry(args.control_device or args.device, torch.float32)}
    counts = {"program": len(args.seeds), "control": args.control_seeds}
    seen: dict = {}
    for k, seed in enumerate(args.seeds):
        batch = gen.batch(cfg, base, np.random.default_rng(seed), tr["lanes"])
        for side, call in sides.items():
            if k >= counts[side]:
                continue
            mods = program.models(batch)
            t = time.perf_counter()
            ans = program.answers(call(mods))
            wall = time.perf_counter() - t
            r = readings(batch, ans, args.device)
            seen.setdefault(side, []).append(r)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "wall": wall, "iterations_max": int(ans["iterations"].max()),
                              **r}), flush=True)
    names = [n for n in check.NAMES if n != "not_optimal"]
    for side, rs in seen.items():
        agg = max if side == "program" else min
        print(json.dumps({"workload": args.workload, "side": side, "seeds": len(rs),
                          "reading": "lower (largest)" if agg is max else "upper (smallest)",
                          **{n: agg(r[n] for r in rs) for n in names},
                          "not_optimal": sum(r["not_optimal"] for r in rs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
