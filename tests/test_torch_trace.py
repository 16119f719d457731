"""clp_tpu_torch.trace: off it records nothing; on, the batched solves'
span trees, counters and profiler events, with the same Solutions (CPU)."""

import json
import threading

import numpy as np
import pytest
import scipy.sparse as sp
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import clp_tpu_torch
from clp_tpu_torch import forms, trace
from clp_tpu_torch.constants import INF
from clp_tpu_torch.parallel import batch as tb
from clp_tpu_torch.simplex import driver
from clp_tpu_torch.simplex.engine import NUMERICAL
from clp_tpu_torch.utils import generators as gen
from clp_tpu_torch.utils import lockstep
from tests.worker_threads import set_worker_threads

set_worker_threads()

ROOT_CHILDREN = ["stack", "place", "loop", "copy_back", "unpack"]


@pytest.fixture(autouse=True)
def _tracing_off_after():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _scenarios(base, count, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        m = base.copy()
        shift = np.abs(rng.uniform(0, 0.05, m.num_rows))
        m.row_lower = np.where(m.row_lower > -1e29, m.row_lower - shift, m.row_lower)
        m.row_upper = np.where(m.row_upper < 1e29, m.row_upper + shift, m.row_upper)
        out.append(m)
    return out


def _fake_bound_models():
    """test_torch_batch's fake-bound case: four free columns."""
    base = gen.random_lp(20, 30, seed=6)
    base.col_lower = base.col_lower.copy()
    base.col_upper = base.col_upper.copy()
    base.col_lower[:4] = -INF
    base.col_upper[:4] = INF
    return _scenarios(base, 4)


def _escalating_models():
    """A free column that no row holds and no cost moves: every lane ends
    OPTIMAL with it nonbasic at a fake bound, so every lane is re-solved
    twice and finished by the primal."""
    base = gen.random_lp(12, 20, seed=0)
    m = clp_tpu_torch.Model()
    m.load_problem(sp.hstack([base.matrix, sp.csc_matrix((12, 1))]).tocsc(),
                   np.r_[base.col_lower, -INF], np.r_[base.col_upper, INF],
                   np.r_[base.objective, 0.0], base.row_lower, base.row_upper)
    return _scenarios(m, 4)


CASES = {"plain": lambda: _scenarios(gen.random_lp(12, 20, seed=2), 6),
         "fake_bounds": _fake_bound_models,
         "escalation": _escalating_models}


def _opts():
    o = clp_tpu_torch.SolveOptions(device="cpu",
                                   method=clp_tpu_torch.SolveMethod.DUAL_SIMPLEX)
    o.presolve.enabled = False
    return o


class _Spy:
    """Counts what the tracer should count, by wrapping the functions that
    do it: host reads, lanes sent to simplex_solve, and the batch states.
    Lane 1 is turned NUMERICAL after the loop, so one lane is a leftover."""

    def __init__(self, monkeypatch):
        self.reads = 0
        self.leftovers = 0
        self.states = []
        read, solve, lanes = lockstep.host_read, driver.simplex_solve, tb._dual_lanes

        def host_read(ts):
            self.reads += 1
            return read(ts)

        def simplex_solve(*a, **k):
            self.leftovers += 1
            return solve(*a, **k)

        def dual_lanes(*a, **k):
            Ss, lpds, fakes, opts_e = lanes(*a, **k)
            Ss[0]["status"] = Ss[0]["status"].clone()
            Ss[0]["status"][1] = NUMERICAL
            self.states.append(Ss)
            return Ss, lpds, fakes, opts_e

        monkeypatch.setattr(lockstep, "host_read", host_read)
        monkeypatch.setattr(tb, "host_read", host_read)
        monkeypatch.setattr(driver, "simplex_solve", simplex_solve)
        monkeypatch.setattr(tb, "_dual_lanes", dual_lanes)


def _dur(s):
    return s["end_ns"] - s["start_ns"]


def _solve(models):
    return tb.solve_batch_dual_simplex([m.copy() for m in models], _opts())


def _same_solutions(a, b):
    assert len(a) == len(b)
    for s, t in zip(a, b):
        assert int(s.status) == int(t.status) and s.iterations == t.iterations
        assert s.objective_value == t.objective_value
        for k in ("primal", "duals", "reduced_costs", "row_activity",
                  "column_status", "row_status"):
            assert np.array_equal(np.asarray(getattr(s, k)), np.asarray(getattr(t, k))), k


def test_off_records_nothing():
    models = CASES["plain"]()[:4]
    assert not trace.enabled()
    assert trace.span("batch_dual", lanes=4) is trace.OFF
    assert trace.span("stack") is trace.span("loop") is trace.OFF
    with trace.span("x") as s:
        s.set(m=1)
        trace.count("lane_steps", 5)
    _solve(models)
    assert trace.snapshot() == []


def test_count_outside_a_root_is_dropped():
    trace.enable()
    trace.count("host_reads", 3)
    with trace.span("r"):
        trace.count("host_reads", 2)
    trace.count("host_reads", 7)
    (root,) = trace.snapshot()
    assert root["counters"] == {"host_reads": 2}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_dual_spans_and_counters(monkeypatch, case):
    models = CASES[case]()
    spy = _Spy(monkeypatch)
    off = _solve(models)
    reads_off = spy.reads
    trace.enable()
    on = _solve(models)
    assert spy.reads == 2 * reads_off and spy.leftovers == 2
    _same_solutions(on, off)

    (root,) = trace.snapshot()
    json.dumps(root)
    assert root["name"] == "batch_dual" and root["profiled"] is False
    assert root["attrs"]["lanes"] == len(models)
    assert (root["attrs"]["m"], root["attrs"]["n"]) == (models[0].num_rows,
                                                        models[0].num_rows + models[0].num_cols)
    spans = root["spans"]
    by_id = {s["id"]: s for s in spans}
    assert spans[-1]["id"] == root["id"] and spans[-1]["parent"] is None
    assert all(s["root"] == root["id"] for s in spans)
    assert all(s["parent"] in by_id for s in spans[:-1])

    def children(name):
        (parent,) = [s for s in spans if s["name"] == name]
        return sorted((s for s in spans if s["parent"] == parent["id"]),
                      key=lambda s: s["start_ns"])

    top = children("batch_dual")
    assert [s["name"] for s in top] == ROOT_CHILDREN
    assert sum(_dur(s) for s in top) >= 0.95 * _dur(root)
    for a, b in zip(top, top[1:]):
        assert a["end_ns"] <= b["start_ns"]
    assert [s["name"] for s in children("loop")] == ["escalation", "primal_finish"]
    assert [s["name"] for s in children("unpack")] == ["leftover"]
    assert children("unpack")[0]["attrs"] == {"lane": 1}

    c = root["counters"]
    (Ss,) = spy.states[1:]
    assert c["lane_pivots"] == sum(int(S["iterations"].sum()) for S in Ss)
    assert c["refactors"] == sum(int(S["refactors"].sum()) for S in Ss)
    assert c["leftover_lanes"] == 1
    assert c["host_reads"] == reads_off and c["host_read_ns"] > 0
    assert c.get("h2d_bytes", 0) == 0 and c.get("d2h_bytes", 0) == 0
    assert c["form_nnz"] == sum(m.matrix.nnz for m in models)
    assert c["lane_pivots"] <= c["lane_steps"]
    assert 0 <= c.get("compactions", 0) < c["dispatches"]
    if case == "escalation":
        assert c["rerun_lanes"] == 2 * len(models) and c["finish_lanes"] == len(models)
    else:
        assert "rerun_lanes" not in c and "finish_lanes" not in c


@pytest.mark.parametrize("tracing", [False, True])
def test_profiler_events_sit_on_their_spans(tracing):
    models = CASES["escalation"]()
    if tracing:
        trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve(models)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU and e.name().startswith("clp.")]
    if not tracing:
        assert events == [] and trace.snapshot() == []
        return
    (root,) = trace.snapshot()
    assert root["profiled"] is True
    spans = sorted(root["spans"], key=lambda s: s["start_ns"])
    events.sort(key=lambda e: e.start_ns())
    assert [e.name() for e in events] == ["clp." + s["name"] for s in spans]
    for e, s in zip(events, spans):
        assert abs(e.start_ns() - s["start_ns"]) < 1_000_000
        assert abs(e.end_ns() - s["end_ns"]) < 1_000_000


def test_form_build_counts_the_payload_that_leaves_the_host():
    """The batched simplex form built for a device (meta: shapes with no
    data) counts as h2d_bytes the arrays it sends: a row index and a value
    a nonzero, a count a column, and c, l and u; form_nnz counts the
    nonzeros scattered. Built on the CPU, nothing leaves the host."""
    models = CASES["plain"]()
    A = models[0].matrix
    B, (m, n) = len(models), A.shape
    nnz = sum(mod.matrix.nnz for mod in models)
    payload = nnz * (A.indices.itemsize + 8) + B * n * A.indptr.itemsize + 3 * B * (n + m) * 8
    trace.enable()
    for dev in ("meta", "cpu"):
        with trace.span("r"):
            lp, _ = forms.to_standard_form_batch(models, device=dev)
        assert lp.G.device.type == dev and lp.G.shape == (B, m, n + m)
    meta, cpu = (r["counters"] for r in trace.snapshot())
    assert meta == {"h2d_bytes": payload, "form_nnz": nnz}
    assert cpu == {"form_nnz": nnz}
    assert payload < lp.G.nbytes


def test_batch_ipm_spans():
    models = _scenarios(gen.random_lp(12, 20, seed=2), 4)
    trace.enable()
    sols = tb.solve_batch_ipm([m.copy() for m in models], _opts())
    assert all(int(s.status) == 0 for s in sols)
    (root,) = trace.snapshot()
    assert root["name"] == "batch_ipm" and root["attrs"]["lanes"] == 4
    top = sorted((s for s in root["spans"] if s["parent"] == root["id"]),
                 key=lambda s: s["start_ns"])
    assert [s["name"] for s in top] == ROOT_CHILDREN
    assert sum(_dur(s) for s in top) >= 0.95 * _dur(root)
    c = root["counters"]
    assert c["host_reads"] >= 1 and c.get("h2d_bytes", 0) == c.get("d2h_bytes", 0) == 0


def test_roots_are_bounded_and_threads_keep_apart():
    trace.enable()
    errors = []

    def work(k):
        try:
            for i in range(300):
                with trace.span("root", k=k, i=i):
                    with trace.span("child"):
                        trace.count("n", k)
                    trace.count("n", k)
        except Exception as e:  # read in the main thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(1, 9)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    roots = trace.snapshot()
    assert len(roots) == trace.KEEP
    for r in roots:
        k = r["attrs"]["k"]
        assert r["counters"] == {"n": 2 * k}
        assert [s["name"] for s in r["spans"]] == ["child", "root"]
        assert r["spans"][0]["parent"] == r["id"]
