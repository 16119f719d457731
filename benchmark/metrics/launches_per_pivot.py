"""Kernel launches per batched pivot: the device kernels of the profiled
call over that call's slowest-lane pivot count."""


def read(ctx):
    p = ctx["profile"]
    if p is None or p["kernels"] == 0 or p["max_iterations"] <= 0:
        return None
    return p["kernels"] / p["max_iterations"]
