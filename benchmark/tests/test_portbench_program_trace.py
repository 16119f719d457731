"""The readers of the program's own spans and counters
(benchmark/metrics/_program_trace.py): their arithmetic on a made-up
snapshot, the choice of the timed calls' roots, a whole traced run on the
CPU, and on a card the bytes and the clock."""

import time
import types

import numpy as np
import pytest

from benchmark import harness, program, spec
from benchmark.metrics import _program_trace as pt

READERS = ["stack_s_per_call", "copy_s_per_call", "unpack_s_per_call",
           "loop_lane_pivots_per_s", "sync_wait_pct", "lane_step_yield_pct",
           "copy_gib_per_call"]
CELL = "ssn.dual.b2048"
S = 10**9


def root(profiled, spans, counters):
    """A root as trace.snapshot() gives it: `spans` maps a name to its
    seconds, laid end to end."""
    out, t = [], 0
    for name, s in spans.items():
        out.append({"name": name, "start_ns": t, "end_ns": t + int(s * S)})
        t += int(s * S)
    return {"profiled": profiled, "spans": out, "counters": counters}


def snapshot():
    warm = root(False, {"stack": 100.0, "loop": 1.0}, {"lane_pivots": 7, "lane_steps": 7})
    one = root(False, {"stack": 1.0, "place": 0.5, "loop": 2.0, "copy_back": 0.25,
                       "unpack": 0.5},
               {"lane_pivots": 1000, "lane_steps": 1250, "host_read_ns": S // 2,
                "h2d_bytes": 2**30, "d2h_bytes": 2**31})
    two = root(False, {"stack": 2.0, "place": 0.5, "loop": 3.0, "copy_back": 0.75,
                       "unpack": 1.0},
               {"lane_pivots": 1500, "lane_steps": 2500, "host_read_ns": S,
                "h2d_bytes": 2**30, "d2h_bytes": 2**30})
    prof = root(True, {"stack": 50.0, "loop": 9.0}, {"lane_pivots": 9, "lane_steps": 99})
    return [warm, one, two, prof]


def ctx(calls):
    return {"peak_bytes": None, "profile": None,
            "calls": [{"wall": 1.0, "iterations": np.array([1])}] * calls}


@pytest.fixture
def made_up(monkeypatch):
    monkeypatch.setattr(pt, "trace", types.SimpleNamespace(snapshot=snapshot))


def test_readers_on_a_made_up_snapshot(made_up):
    got = {n: spec.metric_reader(n)(ctx(2)) for n in READERS}
    assert got == pytest.approx({"stack_s_per_call": 1.5, "copy_s_per_call": 1.0,
                                 "unpack_s_per_call": 0.75, "loop_lane_pivots_per_s": 500.0,
                                 "sync_wait_pct": 30.0, "lane_step_yield_pct": 100 * 2 / 3,
                                 "copy_gib_per_call": 2.5})


def test_the_timed_roots_leave_out_warm_up_and_profiled_calls(made_up):
    roots = pt.timed_roots(ctx(2))
    assert [r["counters"]["lane_pivots"] for r in roots] == [1000, 1500]
    assert [r["counters"]["lane_pivots"] for r in pt.timed_roots(ctx(1))] == [1500]
    assert pt.timed_roots(ctx(3)) == [r for r in snapshot() if not r["profiled"]]


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_with_nothing_to_read(monkeypatch, made_up, name):
    read = spec.metric_reader(name)
    assert read(ctx(0)) is None and read(ctx(4)) is None
    monkeypatch.setattr(pt, "trace", None)
    assert read(ctx(2)) is None


@pytest.fixture
def tracing():
    """Tracing on for the test, then back as it was, with no roots kept."""
    was = pt.trace.enabled()
    pt.trace.enable()
    pt.trace.reset()
    yield
    pt.trace.reset()
    if not was:
        pt.trace.disable()


def test_a_traced_run_on_the_cpu_reports_every_reader(tracing):
    sp = spec.Spec()
    work = sp.workload(CELL)
    tr = dict(spec.traffic(work["traffic"]), lanes=4, warmup_calls=1)
    res = harness.run_cell(sp, work, 2**31 + 33, 0.0, True, "cpu", time.perf_counter(),
                           traffic=tr)
    assert res["correct"]
    for name in READERS:
        assert res["metrics"][name]["value"] is not None, name
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["copy_gib_per_call"] == 0.0
    assert 0 < m["lane_step_yield_pct"] <= 100 and m["loop_lane_pivots_per_s"] > 0


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def shape_bytes(B, m, nt):
    """The bytes a call of B lanes of the m x nt standard form copies to
    the card (G, b, c, l, u in float64) and back (those, each lane's
    simplex state with its float64 inverse, and its fake-bound flag)."""
    lp = 8 * (m * nt + m + 3 * nt)
    state = 8 * m + 4 * nt + 8 * m * m + 3 * 8 * m + 2 * 8 * nt + 4 + 4 + 1 + 4
    return B * lp + B * (lp + state + 1)


@pytest.mark.cuda
def test_on_the_card_the_bytes_and_the_clock(card, tracing):
    import torch

    from benchmark import trace as btrace

    B = 256
    sp = spec.Spec()
    cfg = sp.config(sp.workload(CELL)["config"])
    gen = spec.generator(cfg["generator"])
    batch = gen.batch(cfg, gen.base(cfg), np.random.default_rng(2**31 + 5), B)
    call = program.entry(spec.traffic(sp.workload(CELL)["traffic"]), "cuda")
    call(program.models(batch))
    mods = program.models(batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    call(mods)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    _, prof = btrace.profiled(lambda: call(program.models(batch)), torch.cuda.synchronize)
    *_, timed, profiled = pt.trace.snapshot()
    assert not timed["profiled"] and profiled["profiled"]

    m, nt = batch["A"].shape[0], sum(batch["A"].shape)
    want = shape_bytes(B, m, nt) / 2**30
    assert pt.trace.snapshot()[-2] == timed
    assert abs(spec.metric_reader("copy_gib_per_call")(ctx(1)) - want) <= 0.02 * want
    length = timed["end_ns"] - timed["start_ns"]
    assert abs(length * 1e-9 - wall) <= 0.02 * wall
    top = [s for s in timed["spans"] if s["parent"] == timed["id"]]
    assert sum(s["end_ns"] - s["start_ns"] for s in top) >= 0.95 * length

    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "clp.batch_dual"]
    assert abs(ev.start_ns() - profiled["start_ns"]) < 1_000_000
    assert abs(ev.end_ns() - profiled["end_ns"]) < 1_000_000
