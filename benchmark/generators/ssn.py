"""The second stage of SSN, the telecommunication network-planning problem of
Sen, Doverspike and Cosares (1994), at the shape that Linderoth, Shapiro and
Wright (2006, Table 1) give: 175 rows x 706 columns.

Rows: one capacity row (<=) per link, then one demand row (=) per
point-to-point demand. Columns: one flow column per (demand, path), then one
shortfall column per demand. Cost 1 on shortfall, 0 on flow, so the
objective is the unserved demand. The recourse is fixed: the matrix and the
costs are the same in every scenario; the demands vary by scenario and the
capacities by first-stage decision.

The SSN data file is not in the repository, so the network, the paths and
the demand distributions are drawn here from the configuration's
`topology_seed` with the sizes it states (its `assumed` list): a connected
graph of `nodes` nodes and `links` links, `demands` node pairs, each routed
over its k shortest loopless paths by random link lengths (Yen), `paths` in
all; each demand takes one of 3-7 equally likely integer levels.
"""

from __future__ import annotations

import heapq

import numpy as np
import scipy.sparse as sp


def _graph(rng, nodes: int, links: int) -> list:
    """`links` undirected edges on `nodes` nodes: a random recursive
    spanning tree, then random extra edges, no two alike."""
    order = rng.permutation(nodes)
    edges = {tuple(sorted((int(order[v]), int(order[rng.integers(v)]))))
             for v in range(1, nodes)}
    while len(edges) < links:
        a, b = (int(v) for v in rng.choice(nodes, 2, replace=False))
        edges.add((min(a, b), max(a, b)))
    return sorted(edges)


def _shortest(adj, src, dst, banned_nodes, banned_edges):
    """Dijkstra from src to dst avoiding nodes and edge ids; (length, node
    list, edge list) or None."""
    heap = [(0.0, src, [src], [])]
    seen = set()
    while heap:
        d, v, path, used = heapq.heappop(heap)
        if v == dst:
            return d, path, used
        if v in seen:
            continue
        seen.add(v)
        for w, e, length in adj[v]:
            if w in seen or w in banned_nodes or e in banned_edges:
                continue
            heapq.heappush(heap, (d + length, w, path + [w], used + [e]))
    return None


def _k_shortest(adj, lengths, src, dst, k: int) -> list:
    """Yen's k shortest loopless paths, as lists of edge ids."""
    first = _shortest(adj, src, dst, set(), set())
    if first is None:
        raise ValueError(f"no path between {src} and {dst}")
    found = [first]
    cands: list = []
    while len(found) < k:
        _, nodes_prev, edges_prev = found[-1]
        for i in range(len(nodes_prev) - 1):
            root_nodes, root_edges = nodes_prev[:i + 1], edges_prev[:i]
            banned_e = {p[2][i] for p in found if p[1][:i + 1] == root_nodes}
            spur = _shortest(adj, nodes_prev[i], dst, set(root_nodes[:-1]), banned_e)
            if spur is None:
                continue
            length = float(lengths[root_edges].sum()) + spur[0]
            cand = (length, root_nodes[:-1] + spur[1], root_edges + spur[2])
            if all(c[2] != cand[2] for c in cands) and all(p[2] != cand[2] for p in found):
                heapq.heappush(cands, cand)
        if not cands:
            raise ValueError(f"only {len(found)} loopless paths between {src} and {dst}")
        found.append(heapq.heappop(cands))
    return [p[2] for p in found]


def base(cfg: dict) -> dict:
    """The fixed part of the configuration: the recourse matrix W, the
    costs, the column bounds, each demand's levels and the capacities
    before any expansion. The same for every run."""
    rng = np.random.default_rng(cfg["topology_seed"])
    nodes, links, demands, paths = cfg["nodes"], cfg["links"], cfg["demands"], cfg["paths"]
    edges = _graph(rng, nodes, links)
    lengths = rng.uniform(1.0, 10.0, links)
    adj: list = [[] for _ in range(nodes)]
    for e, (a, b) in enumerate(edges):
        adj[a].append((b, e, float(lengths[e])))
        adj[b].append((a, e, float(lengths[e])))
    all_pairs = [(a, b) for a in range(nodes) for b in range(a + 1, nodes)]
    pairs = [all_pairs[i] for i in rng.choice(len(all_pairs), demands, replace=False)]
    per = np.full(demands, paths // demands)
    per[rng.choice(demands, paths - per.sum(), replace=False)] += 1
    lo, hi = cfg["demand_mean"]
    mean = rng.uniform(lo, hi, demands)
    k_lo, k_hi = cfg["demand_levels"]
    f_lo, f_hi = cfg["demand_spread"]
    levels = [np.round(mean[i] * np.linspace(f_lo, f_hi, int(rng.integers(k_lo, k_hi + 1))))
              for i in range(demands)]

    rows, cols = [], []
    col = 0
    load = np.zeros(links)
    for i, (a, b) in enumerate(pairs):
        for path in _k_shortest(adj, lengths, a, b, int(per[i])):
            rows += path
            cols += [col] * len(path)
            rows.append(links + i)
            cols.append(col)
            load[path] += mean[i] / per[i]
            col += 1
    n = paths + demands
    rows += list(links + np.arange(demands))
    cols += list(paths + np.arange(demands))
    m = links + demands
    A = sp.csc_matrix((np.ones(len(rows)), (rows, cols)), shape=(m, n))
    c = np.concatenate([np.zeros(paths), np.ones(demands)])
    return {"A": A, "c": c, "l": np.zeros(n), "u": np.full(n, np.inf),
            "levels": levels, "load": load,
            "capacity": np.round(cfg["base_capacity_share"] * load)}


def batch(cfg: dict, net: dict, rng: np.random.Generator, lanes: int) -> dict:
    """One call's scenarios. The call draws one first-stage decision: a
    capacity expansion of `budget` units over the links, multinomial with
    weights load x U(0.5, 1.5). Each lane draws every demand's level
    independently and uniformly."""
    links = net["load"].shape[0]
    w = net["load"] * rng.uniform(0.5, 1.5, links)
    cap = net["capacity"] + rng.multinomial(cfg["budget"], w / w.sum())
    demand = np.stack([lv[rng.integers(0, lv.size, lanes)] for lv in net["levels"]], axis=1)
    rl = np.concatenate([np.full((lanes, links), -np.inf), demand], axis=1)
    ru = np.concatenate([np.broadcast_to(cap, (lanes, links)), demand], axis=1)
    return {"A": net["A"], "c": net["c"], "l": net["l"], "u": net["u"], "rl": rl, "ru": ru}
