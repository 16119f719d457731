"""The share of the lanes that the float32 pivot loop left unsettled and
the batched float64 finish took over: the program's counter
`f64_finish_lanes` over the roots' `lanes`, over the window's timed calls,
in %. None where the program counts no such lanes (no f64 finish, or the
float64 route)."""

from ._lane_counters import lane_share


def read(ctx):
    return lane_share(ctx, "f64_finish_lanes", absent=None)
