"""The device's idle share of the profiled call: 100 x (1 - the union of
device operation intervals / the call's wall)."""


def read(ctx):
    p = ctx["profile"]
    if p is None or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
