"""Netlib regression harness — golden objectives (BASELINE.md oracle).

Equivalent of `clp -netlib` (reference: unitTest.cpp:395-1074): solve every
problem found in a data directory and compare the objective against the
golden table within per-problem tolerance. Data files are NOT bundled —
point this at a Data-Netlib checkout (files like `afiro.mps[.gz]`). The
solves run on `options.device` (default `device.default_device()`).
"""

from __future__ import annotations

import glob
import os
import time

from .model import Model
from .options import SolveOptions
from .constants import ProblemStatus

# (objective, relative tolerance) per problem — from BASELINE.md, extracted
# from the reference's golden table (unitTest.cpp:395-1074).
GOLDEN = {
    "25fv47": (5.5018458883e03, 1e-8),
    "80bau3b": (9.8722419241e05, 1e-8),
    "adlittle": (2.2549496316e05, 1e-8),
    "afiro": (-4.6475314286e02, 1e-8),
    "agg": (-3.5991767287e07, 1e-8),
    "agg2": (-2.0239252356e07, 1e-8),
    "agg3": (1.0312115935e07, 1e-8),
    "bandm": (-1.5862801845e02, 1e-8),
    "beaconfd": (3.3592485807e04, 1e-8),
    "blend": (-3.0812149846e01, 1e-8),
    "bnl1": (1.9776295615e03, 1e-8),
    "bnl2": (1.8112365404e03, 1e-8),
    "boeing1": (-3.3521356751e02, 1e-8),
    "boeing2": (-3.1501872802e02, 1e-8),
    "bore3d": (1.3730803942e03, 1e-8),
    "brandy": (1.5185098965e03, 1e-8),
    "capri": (2.6900129138e03, 1e-8),
    "cycle": (-5.2263930249e00, 1e-9),
    "czprob": (2.1851966989e06, 1e-8),
    "d2q06c": (122784.21557456, 1e-7),
    "d6cube": (3.1549166667e02, 1e-7),
    "degen2": (-1.4351780000e03, 1e-8),
    "degen3": (-9.8729400000e02, 1e-8),
    "dfl001": (1.1266396047e07, 1e-5),
    "e226": (-1.8751929066e01, 1e-8),
    "etamacro": (-7.5571521774e02, 1e-6),
    "fffff800": (5.5567961165e05, 1e-6),
    "finnis": (1.7279096547e05, 1e-6),
    "fit1d": (-9.1463780924e03, 1e-8),
    "fit1p": (9.1463780924e03, 1e-8),
    "fit2d": (-6.8464293294e04, 1e-8),
    "fit2p": (6.8464293232e04, 1e-9),
    "forplan": (-6.6421873953e02, 1e-6),
    "ganges": (-1.0958636356e05, 1e-5),
    "gfrd-pnc": (6.9022359995e06, 1e-8),
    "greenbea": (-72555248.129846, 1e-8),
    "greenbeb": (-4302260.2612066, 1e-8),
    "grow15": (-1.0687094129e08, 1e-8),
    "grow22": (-1.6083433648e08, 1e-8),
    "grow7": (-4.7787811815e07, 1e-8),
    "israel": (-8.9664482186e05, 1e-8),
    "kb2": (-1.7499001299e03, 1e-8),
    "lotfi": (-2.5264706062e01, 1e-8),
    "maros": (-5.8063743701e04, 1e-8),
    "maros-r7": (1.4971851665e06, 1e-8),
    "modszk1": (3.2061972906e02, 1e-8),
    "nesm": (1.4076073035e07, 1e-5),
    "perold": (-9.3807580773e03, 1e-6),
    "pilot": (-557.48972927292, 1e-5),
    "pilot4": (-2.5811392641e03, 5e-5),
    "pilot87": (3.0171072827e02, 1e-4),
    "pilotnov": (-4.4972761882e03, 1e-8),
    "recipe": (-2.6661600000e02, 1e-8),
    "sc105": (-5.2202061212e01, 1e-8),
    "sc205": (-5.2202061212e01, 1e-8),
    "sc50a": (-6.4575077059e01, 1e-8),
    "sc50b": (-7.0000000000e01, 1e-8),
    "scagr25": (-1.4753433061e07, 1e-8),
    "scagr7": (-2.3313892548e06, 1e-6),
    "scfxm1": (1.8416759028e04, 1e-8),
    "scfxm2": (3.6660261565e04, 1e-8),
    "scfxm3": (5.4901254550e04, 1e-8),
    "scorpion": (1.8781248227e03, 1e-8),
    "scrs8": (9.0429998619e02, 1e-5),
    "scsd1": (8.6666666743e00, 1e-8),
    "scsd6": (5.0500000078e01, 1e-8),
    "scsd8": (9.0499999993e02, 1e-7),
    "sctap1": (1.4122500000e03, 1e-8),
    "sctap2": (1.7248071429e03, 1e-8),
    "sctap3": (1.4240000000e03, 1e-8),
    "seba": (1.5711600000e04, 1e-8),
    "share1b": (-7.6589318579e04, 1e-8),
    "share2b": (-4.1573224074e02, 1e-8),
    "shell": (1.2088253460e09, 1e-8),
    "ship04l": (1.7933245380e06, 1e-8),
    "ship04s": (1.7987147004e06, 1e-8),
    "ship08l": (1.9090552114e06, 1e-8),
    "ship08s": (1.9200982105e06, 1e-8),
    "ship12l": (1.4701879193e06, 1e-8),
    "ship12s": (1.4892361344e06, 1e-8),
    "sierra": (1.5394362184e07, 1e-8),
    "stair": (-2.5126695119e02, 1e-8),
    "standata": (1.2576995000e03, 1e-8),
    "standmps": (1.4060175000e03, 1e-8),
    "stocfor1": (-4.1131976219e04, 1e-8),
    "stocfor2": (-3.9024408538e04, 1e-8),
    "tuff": (2.9214776509e-01, 1e-8),
    "vtpbase": (1.2983146246e05, 1e-8),
    "wood1p": (1.4429024116e00, 5e-5),
    "woodw": (1.3044763331e00, 1e-8),
}


def run_netlib(data_dir: str, options: SolveOptions | None = None,
               problems: list[str] | None = None, check_tol_scale: float = 1.0) -> int:
    """Solve all known problems in data_dir; return number of failures.

    The default `check_tol_scale=1.0` applies the reference oracle's exact
    per-problem tolerances (unitTest.cpp:395-1074); pass >1 only to triage
    with a deliberately looser check.
    """
    options = options or SolveOptions()
    failures = 0
    solved = 0
    t_total = time.time()
    for name in sorted(problems or GOLDEN):
        candidates = (
            glob.glob(os.path.join(data_dir, f"{name}.mps"))
            + glob.glob(os.path.join(data_dir, f"{name}.mps.gz"))
            + glob.glob(os.path.join(data_dir, name))
            + glob.glob(os.path.join(data_dir, f"{name}.gz"))
        )
        if not candidates:
            continue
        golden, tol = GOLDEN[name]
        model = Model()
        if model.read_mps(candidates[0]) != 0:
            print(f"{name}: READ FAILED")
            failures += 1
            continue
        t0 = time.time()
        sol = model.initial_solve(options)
        dt = time.time() - t0
        ok = (
            sol.status == ProblemStatus.OPTIMAL
            and abs(sol.objective_value - golden)
            <= tol * check_tol_scale * (1.0 + abs(golden))
        )
        solved += 1
        failures += 0 if ok else 1
        print(
            f"{name:12s} {model.num_rows:5d}x{model.num_cols:<5d} "
            f"{sol.status.name:18s} obj {sol.objective_value:.10g} "
            f"(golden {golden:.10g}) {'OK' if ok else 'FAIL'} "
            f"{sol.iterations:6d} its {dt:6.2f}s"
        )
    print(
        f"netlib: {solved - failures}/{solved} OK in {time.time()-t_total:.1f}s"
        + (" (no data files found)" if solved == 0 else "")
    )
    return failures
