"""The share of the lane-steps computed that were pivots: the program's
counters `lane_pivots` over `lane_steps` (each gated block's batch size
times its steps: under vmap a frozen lane is computed and thrown away),
over the window's timed calls."""

from ._program_trace import counter, timed_roots


def read(ctx):
    roots = timed_roots(ctx)
    steps = counter(roots, "lane_steps")
    if steps <= 0:
        return None
    return 100.0 * counter(roots, "lane_pivots") / steps
