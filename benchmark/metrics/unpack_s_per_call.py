"""The unpack a call: the program's span `unpack` (one Solution a lane,
leftover lanes' single solves included), mean over the window's timed
calls, in seconds."""

from ._program_trace import seconds_per_call


def read(ctx):
    return seconds_per_call(ctx, ("unpack",))
