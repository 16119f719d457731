"""The share of the lanes sent one at a time to the single-LP driver
(`simplex_solve`) after the batch: the program's counter `leftover_lanes`
over the roots' `lanes`, over the window's timed calls, in %. The counter
is only added to where a lane is sent, so its absence reads 0."""

from ._lane_counters import lane_share


def read(ctx):
    return lane_share(ctx, "leftover_lanes", absent=0)
