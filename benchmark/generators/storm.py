"""The second stage of STORM, the air-cargo scheduling problem of Mulvey and
Ruszczyński (Oper. Res. 43(3), 1995), at the shape that Linderoth, Shapiro
and Wright (2006, Table 1) give: 528 rows x 1259 columns, 118 random
parameters.

The first stage schedules cargo flights; the second routes cargo over them
to meet uncertain demands and pays a penalty for demand left unmet.

Rows, in this order: on each flight leg a payload row (tons, <=) and a
pallet row (pallet positions, <=); at each airport a handling row (tons
transferred there, <=); one demand row (=) per origin-destination demand.
Columns: one flow column per (demand, route), then one unmet-demand column
per demand. A unit of demand k weighs `unit_tons[k]` tons and takes
`unit_positions[k]` pallet positions, so the capacity rows carry those
real-valued coefficients on every leg of a route, and the handling rows the
tons at each intermediate airport. A flow costs its tons times the route's
flight cost (per ton-mile) plus handling at each transfer; unmet demand
costs a penalty per ton, above every route's cost, so every scenario is
feasible and bounded (complete recourse).

The recourse is fixed: the matrix and the costs are the same in every
scenario. The 118 demands vary by scenario, and the legs' capacities by
first-stage decision (the flights a call's schedule puts on each leg, times
the leg aircraft's payload and pallet positions). The handling capacities
are the airports' own and stay fixed.

The STORM data file is not in the repository, so the network, the aircraft,
the routes, the units and the demand outcomes are drawn here from the
configuration's `topology_seed` with the sizes it states (its `assumed`
list): `airports` airports on a square, `legs` directed legs (a cycle
through every airport, then random legs), each flown by one of the
`aircraft`; `demands` ordered airport pairs, each routed over its k
shortest loopless routes by distance (Yen), `paths` in all; each demand
takes one of five equally likely levels around its mean.

A run of `benchmark/run.py` on this configuration gives its warm-up call
`WARMUP_LIMIT_S` seconds: a 512-lane call takes 20-45 s on an H100, and a
program that needs minutes for one call cannot finish the run (set-up, the
window of calls, the profiled call and the reference's check) in the time a
run has. Such a run ends with exit code 1 and the threads' tracebacks on
standard error, as a failed run, instead of running on until it is killed.
"""

from __future__ import annotations

import faulthandler
import pathlib
import sys

import numpy as np
import scipy.sparse as sp

from .ssn import _k_shortest

WARMUP_LIMIT_S = 300.0
RUN_PY = pathlib.Path(__file__).resolve().parents[1] / "run.py"
_watch = {"calls": 0, "armed": False}


def _in_a_run() -> bool:
    """Whether this process is `python3 benchmark/run.py` (and not a test
    or another caller of the generator)."""
    main = getattr(sys.modules.get("__main__"), "__file__", None)
    return main is not None and pathlib.Path(main).resolve() == RUN_PY


def _watch_warmup() -> None:
    """At a run's first call, arm a timer that ends the process (exit code
    1, tracebacks on standard error) if no second call has begun within
    WARMUP_LIMIT_S; the second call disarms it. The timer is faulthandler's
    C thread, so it fires while the main thread holds the GIL too."""
    _watch["calls"] += 1
    if _watch["calls"] == 1 and _in_a_run():
        print(f"storm: the warm-up call has {WARMUP_LIMIT_S:.0f} s", file=sys.stderr, flush=True)
        faulthandler.dump_traceback_later(WARMUP_LIMIT_S, exit=True)
        _watch["armed"] = True
    elif _watch["armed"]:
        faulthandler.cancel_dump_traceback_later()
        _watch["armed"] = False


def _legs(rng, airports: int, legs: int) -> list:
    """`legs` directed legs on `airports` airports: a random cycle through
    every airport (so each reaches every other), then random legs, no two
    alike and none from an airport to itself."""
    order = rng.permutation(airports)
    arcs = {(int(order[i]), int(order[(i + 1) % airports])) for i in range(airports)}
    while len(arcs) < legs:
        a, b = (int(v) for v in rng.choice(airports, 2, replace=False))
        arcs.add((a, b))
    return sorted(arcs)


def base(cfg: dict) -> dict:
    """The fixed part of the configuration: the recourse matrix W, the
    costs, the column bounds, each demand's levels, and each leg's payload,
    pallet positions and base flights. The same for every run."""
    rng = np.random.default_rng(cfg["topology_seed"])
    airports, legs, demands, paths = cfg["airports"], cfg["legs"], cfg["demands"], cfg["paths"]
    side = cfg["square_miles"]
    where = rng.uniform(0.0, side, (airports, 2))
    arcs = _legs(rng, airports, legs)
    miles = np.array([np.hypot(*(where[a] - where[b])) for a, b in arcs])
    adj: list = [[] for _ in range(airports)]
    for e, (a, b) in enumerate(arcs):
        adj[a].append((b, e, float(miles[e])))
    kinds = rng.integers(0, len(cfg["aircraft"]), legs)
    payload = np.array([cfg["aircraft"][k]["tons"] for k in kinds], dtype=np.float64)
    pallets = np.array([cfg["aircraft"][k]["positions"] for k in kinds], dtype=np.float64)

    all_pairs = [(a, b) for a in range(airports) for b in range(airports) if a != b]
    pairs = [all_pairs[i] for i in rng.choice(len(all_pairs), demands, replace=False)]
    per = np.full(demands, paths // demands)
    per[rng.choice(demands, paths - per.sum(), replace=False)] += 1
    tons = rng.uniform(*cfg["unit_tons"], demands)
    positions = rng.uniform(*cfg["unit_positions"], demands)
    mean = rng.uniform(*cfg["demand_mean"], demands)
    levels = [np.round(mean[i] * np.asarray(cfg["demand_levels"]), 3) for i in range(demands)]

    hub0 = 2 * legs  # the first handling row
    dem0 = hub0 + airports  # the first demand row
    rate, handling = cfg["cost_per_ton_mile"], cfg["handling_cost_per_ton"]
    rows, cols, vals, cost = [], [], [], []
    load_t = np.zeros(legs)  # tons a leg carries at the mean demands
    load_p = np.zeros(legs)
    transfer = np.zeros(airports)
    col = 0
    for i, (a, b) in enumerate(pairs):
        for route in _k_shortest(adj, miles, a, b, int(per[i])):
            stops = [arcs[e][1] for e in route[:-1]]  # the airports it changes aircraft at
            rows += route + [legs + e for e in route] + [hub0 + s for s in stops] + [dem0 + i]
            vals += ([tons[i]] * len(route) + [positions[i]] * len(route)
                     + [tons[i]] * len(stops) + [1.0])
            cols += [col] * (2 * len(route) + len(stops) + 1)
            cost.append(tons[i] * (rate * miles[route].sum() + handling * len(stops)))
            share = mean[i] / per[i]
            load_t[route] += share * tons[i]
            load_p[route] += share * positions[i]
            transfer[stops] += share * tons[i]
            col += 1
    m, n = dem0 + demands, paths + demands
    rows += list(dem0 + np.arange(demands))
    cols += list(paths + np.arange(demands))
    vals += [1.0] * demands
    A = sp.csc_matrix((np.asarray(vals), (rows, cols)), shape=(m, n))
    c = np.concatenate([np.asarray(cost), cfg["penalty_per_ton"] * tons])
    # a leg's base schedule: the flights that carry a share of its mean
    # load by payload and by pallets, whichever needs more
    need = np.maximum(load_t / payload, load_p / pallets)
    return {"A": A, "c": c, "l": np.zeros(n), "u": np.full(n, np.inf),
            "levels": levels, "payload": payload, "pallets": pallets, "need": need,
            "flights": np.maximum(np.floor(cfg["base_flight_share"] * need), 1.0),
            "handling": np.maximum(np.round(cfg["handling_share"] * transfer, 3), 0.01)}


def batch(cfg: dict, net: dict, rng: np.random.Generator, lanes: int) -> dict:
    """One call's scenarios. The call draws one first-stage schedule: the
    base flights plus `extra_flights` more over the legs, multinomial with
    weights need x U(0.5, 1.5). Each lane draws every demand's level
    independently and uniformly."""
    _watch_warmup()
    legs = net["payload"].shape[0]
    w = net["need"] * rng.uniform(0.5, 1.5, legs)
    flights = net["flights"] + rng.multinomial(cfg["extra_flights"], w / w.sum())
    cap = np.concatenate([flights * net["payload"], flights * net["pallets"], net["handling"]])
    demand = np.stack([lv[rng.integers(0, lv.size, lanes)] for lv in net["levels"]], axis=1)
    k = cap.shape[0]
    rl = np.concatenate([np.full((lanes, k), -np.inf), demand], axis=1)
    ru = np.concatenate([np.broadcast_to(cap, (lanes, k)), demand], axis=1)
    return {"A": net["A"], "c": net["c"], "l": net["l"], "u": net["u"], "rl": rl, "ru": ru}
