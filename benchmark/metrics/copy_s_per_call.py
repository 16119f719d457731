"""Copies between host and card a call: the program's spans `place` (the
stacked batch copied in) and `copy_back` (the states and the batch copied
out for the unpack), mean over the window's timed calls, in seconds."""

from ._program_trace import seconds_per_call


def read(ctx):
    return seconds_per_call(ctx, ("place", "copy_back"))
