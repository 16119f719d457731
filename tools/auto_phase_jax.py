"""Run the JAX package on the CPU on the LPs of chip_smoke.py's AUTOMATIC
phase: for each, the route its AUTOMATIC takes on the model as given, then
`initial_solve` with its status, objective, iterations, wall and KKT check.

    JAX_PLATFORMS=cpu python tools/auto_phase_jax.py [label words ...]

Label words pick LPs by substring (e.g. `network GUB`); none runs all six.
The sizes are chip_smoke.auto_models()'s; `--gub-k K` sizes the GUB LP.
"""

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import clp_tpu  # noqa: E402
from clp_tpu.solve import _auto_idiot, _auto_method  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("labels", nargs="*")
    ap.add_argument("--gub-k", type=int, default=None)
    args = ap.parse_args()
    for label, make, expect, _ in chip_smoke.auto_models():
        if args.labels and not any(w in label for w in args.labels):
            continue
        if args.gub_k is not None and label.startswith("GUB"):
            label = f"GUB K={args.gub_k}"
            make = (lambda k: lambda: chip_smoke.gub_lp(k, 8, 64, 7))(args.gub_k)
        mt = make()
        mj = clp_tpu.Model()
        mj.load_problem(mt.matrix, mt.col_lower, mt.col_upper, mt.objective,
                        mt.row_lower, mt.row_upper)
        tall = mj.num_rows > 6 * mj.num_cols and mj.num_rows > 2000
        route = "dualize" if tall else _auto_method(mj, clp_tpu.SolveOptions()).name
        print(f"{label} ({mj.num_rows} x {mj.num_cols}): AUTOMATIC on the model as given -> "
              f"{route} (idiot {_auto_idiot(mj)}; chip_smoke expects {expect})", flush=True)
        t0 = time.perf_counter()
        sol = clp_tpu.initial_solve(mj, clp_tpu.SolveOptions())
        wall = time.perf_counter() - t0
        rep = clp_tpu.check_kkt(mj, x=sol.primal, y=sol.duals, tol=1e-6)
        print(f"{label}: {sol.status.name} obj={sol.objective_value!r} "
              f"iterations={sol.iterations} wall={wall:.1f} s {rep}", flush=True)


if __name__ == "__main__":
    main()
