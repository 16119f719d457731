"""Host form stacking a call: the program's span `stack` (the standard
form of each lane built on the host and stacked), mean over the window's
timed calls, in seconds."""

from ._program_trace import seconds_per_call


def read(ctx):
    return seconds_per_call(ctx, ("stack",))
