"""One whole call under torch.profiler, reduced to what the per-layer
metrics and the result's `breakdown` read.

The call runs inside the benchmark's own span "call". Device time is the
union of the intervals of every device operation (kernels, copies, sets)
inside the span. Each idle gap of the device inside the span is labelled by
where it falls: before the call's first device operation ("stack": the port
builds and stacks the standard forms on the host), after its last
("unpack": the per-lane Solutions), or between ("solve call": the device
loop), and by the innermost host operation running at the gap's middle
("python" where none is).
"""

from __future__ import annotations

from collections import defaultdict

SPAN = "call"
TOP = 10


def profiled(fn, sync):
    """Run fn() once under torch.profiler, inside the span; (fn's result,
    the profiler)."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    import torch

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            out = fn()
            sync()
    return out, prof


def reduce(prof) -> dict:
    """The reduction of a finished profile, read from the profiler's raw
    events (building its FunctionEvent tree takes minutes at a call's
    million events)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    device, span, thread = [], None, None
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name()))
        elif span is None and e.name() == SPAN:
            span = (e.start_ns() * 1e-3, e.end_ns() * 1e-3)
            thread = e.start_thread_id()
    host = [(e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name()) for e in events
            if e.device_type() == DeviceType.CPU and e.start_thread_id() == thread
            and e.name() != SPAN]
    return reduce_intervals(device, host, span)


def _innermost(host: list, points: list) -> list:
    """For each time in `points` (sorted), the name of the innermost host
    op containing it, or "python"."""
    host = sorted(host)
    out, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "python")
    return out


def reduce_intervals(device: list, host: list, span) -> dict:
    """Busy and idle time of the device inside `span`, the kernels, and
    the top device ops and idle gaps by name (seconds)."""
    if span is None:
        raise ValueError(f"the profile holds no {SPAN!r} span")
    a0, b0 = span
    inside = sorted((max(a, a0), min(b, b0), n) for a, b, n in device if b > a0 and a < b0)
    kernels = sum(1 for _, _, n in inside if not n.startswith(("Memcpy", "Memset")))
    busy, gaps, end = 0.0, [], a0
    for a, b, _ in inside:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if b0 > end:
        gaps.append((end, b0))
    first = inside[0][0] if inside else b0
    last = max((b for _, b, _ in inside), default=a0)
    mids = [(g0 + g1) / 2 for g0, g1 in gaps]
    ops = _innermost(host, mids)
    idle: dict = defaultdict(float)
    for (g0, g1), op in zip(gaps, ops):
        where = "stack" if g1 <= first else "unpack" if g0 >= last else "solve call"
        idle[f"{where}: {op}"] += (g1 - g0) * 1e-6
    by_op: dict = defaultdict(float)
    for a, b, n in inside:
        by_op[n] += (b - a) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy * 1e-6, "window_s": (b0 - a0) * 1e-6, "kernels": kernels,
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n[:160], s] for n, s in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]}
