"""The pivot layer's rate: the program's counter `lane_pivots` (each
lane's pivots, summed) over its span `loop` (the compacting pivot loop,
the fake-bound escalation and the primal finish), over the window's timed
calls. Stacking, copies and unpack are left out."""

from ._program_trace import per_loop_ns


def read(ctx):
    v = per_loop_ns(ctx, "lane_pivots")
    return None if v is None else v * 1e9
