"""Pivots a lane: the mean Solution.iterations over the timed calls' lanes."""


def read(ctx):
    if not ctx["calls"]:
        return None
    return (sum(int(c["iterations"].sum()) for c in ctx["calls"])
            / sum(c["iterations"].size for c in ctx["calls"]))
