"""Host reads for programs that run side by side on several devices.

A solve that loops on the host reads a device flag now and then (is any
lane still pivoting? did a factorization fail?). Written as a generator,
such a program yields the integer or bool tensor it needs and receives its
value as a numpy array. `lockstep` drives several of them together, one
per mesh entry (parallel/mesh.py): each round it lets every program run
to its next read, so the work of all of them is queued before any waits,
then moves every tensor asked for to the first program's device and reads
them in ONE device-to-host copy. `run` drives one program alone, with the
same reads a plain loop would make. Each host read is counted, with the
time the host blocked in it (clp_tpu_torch/trace.py: host_reads,
host_read_ns).
"""

from __future__ import annotations

import time
from typing import Generator, Sequence

import numpy as np
import torch

from .. import trace


def _blocking_copy(t: torch.Tensor) -> torch.Tensor:
    """t on the host, counted as one host read and the time it blocked."""
    if not trace.enabled():
        return t.cpu()
    t0 = time.perf_counter_ns()
    out = t.cpu()
    trace.count("host_read_ns", time.perf_counter_ns() - t0)
    trace.count("host_reads")
    return out


def host_read(ts: Sequence[torch.Tensor]) -> list:
    """The values of integer or bool tensors, one host copy for all."""
    for t in ts:
        if t.is_floating_point() or t.is_complex():
            raise TypeError("a lockstep read carries integer or bool tensors only")
    if len(ts) == 1:
        return [_blocking_copy(ts[0]).numpy()]
    dev = ts[0].device
    flat = _blocking_copy(torch.cat([t.reshape(-1).to(device=dev, dtype=torch.int64)
                                     for t in ts]))
    out, at = [], 0
    for t in ts:
        n = t.numel()
        v = flat[at:at + n].numpy().reshape(t.shape)
        out.append(v.astype(bool) if t.dtype == torch.bool else v)
        at += n
    return out


def lockstep(programs: Sequence[Generator]) -> list:
    """Run the programs to their ends, one host read per round for all of
    them. Returns each program's return value, in order."""
    progs = list(programs)
    out: list = [None] * len(progs)
    pending: dict = {}

    def step(i, value):
        try:
            pending[i] = progs[i].send(value)
        except StopIteration as e:
            pending.pop(i, None)
            out[i] = e.value

    for i in range(len(progs)):
        step(i, None)
    while pending:
        idx = list(pending)
        values = host_read([pending[i] for i in idx])
        for i, v in zip(idx, values):
            step(i, np.asarray(v))
    return out


def run(program: Generator):
    """One program alone: its return value."""
    return lockstep([program])[0]
