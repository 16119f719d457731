"""The share of the pivot loop the host spends blocked on the card: the
program's counter `host_read_ns` (the time inside each host read's copy
to the host) over its span `loop`, over the window's timed calls."""

from ._program_trace import per_loop_ns


def read(ctx):
    v = per_loop_ns(ctx, "host_read_ns")
    return None if v is None else 100.0 * v
