"""Bytes between host and card a call: the program's counters `h2d_bytes`
and `d2h_bytes`, mean over the window's timed calls, in GiB."""

from ._program_trace import counter, timed_roots


def read(ctx):
    roots = timed_roots(ctx)
    if not roots:
        return None
    return (counter(roots, "h2d_bytes") + counter(roots, "d2h_bytes")) / len(roots) / 2**30
