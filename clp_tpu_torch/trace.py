"""Spans and counters of the port's solves, off by default.

    from clp_tpu_torch import trace
    trace.enable()
    sols = solve_batch_dual_simplex(models, options)
    roots = trace.snapshot()   # one dict a solve call, ready for json.dumps
    trace.reset()              # forget what was recorded
    trace.disable()

A root is the outermost span open on a thread: one solve call
(`batch_dual`, `batch_ipm`). Spans opened inside it on the same thread are
its children, and `count` adds to its counters. The open-span stack is per
thread, so solves racing in threads keep apart. Only the newest `KEEP`
roots are kept, so a long loop of solves with tracing on stays bounded.

Off, `span` returns one shared no-op object and `count` returns at once.
On or off, tracing adds no kernel and no host read: every value counted is
a shape or a value the host already holds.

One clock with torch.profiler: spans are stamped with
time.perf_counter_ns() and given on the clock of the profiler's events
(time.time_ns()'s epoch) through an anchor pair of the two clocks read as
each root opens, so no drift between them builds up over a long run. While
a profiler records, each span also opens record_function("clp." + name),
which puts the spans in the profiler's event stream beside the kernels;
each root says whether one recorded (`profiled`).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch
from torch.autograd.profiler import record_function

KEEP = 1024

_on = False
_roots: collections.deque = collections.deque(maxlen=KEEP)
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    """Record spans and counters from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans open now still close into their roots."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every recorded root."""
    with _lock:
        _roots.clear()


class _Off:
    """The span returned while tracing is off: it records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "start", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Attributes known only after the span opened."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent = None
            self.root = {"id": self.id, "name": self.name,
                         "profiled": torch._C._autograd._profiler_enabled(),
                         "anchor": (time.time_ns(), time.perf_counter_ns()),
                         "spans": [], "counters": {}}
        stack.append(self)
        self.start = time.perf_counter_ns()
        self.rf = None
        if self.root["profiled"]:
            self.rf = record_function("clp." + self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        root = self.root
        root["spans"].append({"name": self.name, "id": self.id, "parent": self.parent,
                              "root": root["id"], "start": self.start, "end": end,
                              "attrs": self.attrs})
        if self.parent is None:
            with _lock:
                _roots.append(root)
        return False


def span(name: str, **attrs):
    """A context manager timing `name` inside the open root (or opening
    one); the shared no-op while tracing is off."""
    if not _on:
        return OFF
    return _Span(name, attrs)


def count(name: str, n=1) -> None:
    """Add n to the counter `name` of this thread's open root; nothing
    while tracing is off or no root is open."""
    if not _on:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        c = stack[0].root["counters"]
        c[name] = c.get(name, 0) + int(n)


def snapshot() -> list:
    """The kept roots, oldest first, as plain dicts: each with its id,
    name, `profiled`, start_ns and end_ns on the profiler's clock, its
    attrs, its counters, and its spans in the order they closed, the
    root's own last (each with name, id, parent, root, start_ns, end_ns and
    attrs)."""
    with _lock:
        roots = list(_roots)
    out = []
    for r in roots:
        wall, pc = r["anchor"]
        spans = [{"name": s["name"], "id": s["id"], "parent": s["parent"], "root": s["root"],
                  "start_ns": wall + s["start"] - pc, "end_ns": wall + s["end"] - pc,
                  "attrs": dict(s["attrs"])} for s in r["spans"]]
        top = next(s for s in spans if s["id"] == r["id"])
        out.append({"id": r["id"], "name": r["name"], "profiled": r["profiled"],
                    "start_ns": top["start_ns"], "end_ns": top["end_ns"],
                    "attrs": top["attrs"], "counters": dict(r["counters"]), "spans": spans})
    return out
