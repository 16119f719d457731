"""The program's own spans and counters (clp_tpu_torch/trace.py), selected
for the readers of the per-layer metrics that come from them.

Importing this module turns the program's tracing on. The harness imports
a cell's readers only in a `--trace 1` run, before the cell's set-up
(harness.run_cell), so the program records in exactly the runs that read
it; the `--trace 0` runs, whose end-to-end metrics are compared, run with
tracing off. Where the program has no trace module, nothing is recorded
and every reader returns None.
"""

try:
    from clp_tpu_torch import trace
except ImportError:  # a program without spans and counters
    trace = None
else:
    trace.enable()


def timed_roots(ctx) -> list:
    """The roots of the window's timed calls: the last len(ctx["calls"])
    roots recorded with no profiler active, which leaves out the warm-up
    calls before them and the profiled call after; [] where the program
    recorded fewer."""
    n = len(ctx["calls"])
    if trace is None or n == 0:
        return []
    roots = [r for r in trace.snapshot() if not r["profiled"]]
    return roots[-n:] if len(roots) >= n else []


def span_ns(root: dict, names) -> int:
    """The summed length of the root's spans named in `names`."""
    return sum(s["end_ns"] - s["start_ns"] for s in root["spans"] if s["name"] in names)


def counter(roots: list, name: str) -> int:
    return sum(r["counters"].get(name, 0) for r in roots)


def seconds_per_call(ctx, names):
    """The mean over the timed calls of the spans `names`, in seconds."""
    roots = timed_roots(ctx)
    if not roots:
        return None
    return sum(span_ns(r, names) for r in roots) * 1e-9 / len(roots)


def per_loop_ns(ctx, name: str):
    """The counter `name` over the timed calls' summed span `loop` (the
    pivot loop, the fake-bound escalation and the primal finish), in
    nanoseconds."""
    roots = timed_roots(ctx)
    loop = sum(span_ns(r, ("loop",)) for r in roots)
    if loop <= 0:
        return None
    return counter(roots, name) / loop
