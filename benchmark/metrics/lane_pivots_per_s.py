"""Lane pivots a second: the pivots of every lane of the timed calls (the
sum of Solution.iterations) over the calls' summed wall."""


def read(ctx):
    if not ctx["calls"]:
        return None
    return (sum(int(c["iterations"].sum()) for c in ctx["calls"])
            / sum(c["wall"] for c in ctx["calls"]))
