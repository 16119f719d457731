"""Scenario-batched solves: many same-shape LPs as one batched program.

The JAX package's headline capability (BASELINE.json configs[4]): stack B
instances on a leading axis and run the IPM, the dual simplex or the QP
simplex over all of them at once. The JAX package vmaps its jitted loops;
under vmap a `while_loop` becomes one loop whose lanes freeze once their
own predicate fails. The port runs the same bodies (engine.recompute,
dual_iteration, primal_iteration, make_dual_feasible, simplex/qp's gated
iteration) under torch.func.vmap and writes that loop out lane by lane:

  * each lane's "still pivoting" flag is the JAX inner loop's predicate
    (status, the chunk count, refactor_now, max_iterations);
  * the flag gates the lane's update with torch.where over every field of
    the state, so a frozen lane is left exactly as it was;
  * the host reads the flags once per block of `inner_unroll` pivots for
    the whole batch, and once per refactor round, never once per lane.

On the CPU a lane then gives the bits of its single solve
(engine._mv keeps the matvecs so).

Over a device mesh (parallel/mesh.py, the "scenario" axis) each entry
takes a contiguous block of lanes onto its device. The loops above are
lockstep programs (utils/lockstep.py): every block runs to its next host
read, then one copy reads all of them, so the blocks advance together with
one host read per block of pivots (or per IPM iteration) for the whole
mesh, and no host thread per block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from .. import trace
from ..device import check_fp32_precision, on_accelerator, resolve_device
from ..forms import StandardLP, batch_shape, to_device, to_ipm_form, to_standard_form_batch
from ..interior.mehrotra import IPMOptions, ipm_solve_batched
from ..model import Model, Solution
from ..options import SolveOptions
from ..simplex import engine
from ..simplex import qp as qpm
from ..simplex.engine import CONTINUE, NUMERICAL, OPTIMAL, SimplexOptions, SimplexState
from ..utils.lockstep import host_read, lockstep, run
from .mesh import scenario_sharding

_LP = ("G", "b", "c", "l", "u")
_SF = tuple(f.name for f in dataclasses.fields(SimplexState))
_QF = tuple(f.name for f in dataclasses.fields(qpm.QPState))
# a lane's cause of a NUMERICAL end in _lanes_prog (its `stops`)
_STOP_REFACTOR, _STOP_STALL = 1, 2
# the dual tolerance of the float64 primal cleanup of the float32 loop's
# optimal bases: it prices in reduced costs of the wrong sign from 10 x
# this (engine._dual_feasible), which the float64 route does not leave
_CLEAN_DUAL_TOL = 1e-10


# --------------------------------------------------------------------------
# stacking
# --------------------------------------------------------------------------


def _stack(lps, device) -> StandardLP:
    has_q = [lp.Q is not None for lp in lps]
    if any(has_q) and not all(has_q):
        raise ValueError("mixed LP/QP batches are not supported")
    f = {k: torch.stack([getattr(lp, k) for lp in lps]).to(device) for k in _LP}
    f["Q"] = torch.stack([lp.Q for lp in lps]).to(device) if all(has_q) else None
    return StandardLP(**f)


def stack_models(models: Sequence[Model], device="cuda") -> tuple[StandardLP, list]:
    """Stack same-shape models into one batched StandardLP (IPM form) and
    the per-model form infos. The forms are built on the host and moved to
    `device` once."""
    lps, infos = [], []
    shape = None
    for mod in models:
        lp, info = to_ipm_form(mod, device="cpu")
        if shape is None:
            shape = lp.G.shape
        elif lp.G.shape != shape:
            raise ValueError(
                f"all models in a batch must share shape; got {tuple(lp.G.shape)} vs "
                f"{tuple(shape)} (pad or bucket by shape first)")
        lps.append(lp)
        infos.append(info)
    return _stack(lps, resolve_device(device)), infos


def stack_models_simplex(models: Sequence[Model], device="cuda") -> tuple[StandardLP, list]:
    """Stack same-shape models into one batched StandardLP (simplex form),
    built on `device` from each model's sparse data
    (forms.to_standard_form_batch)."""
    return to_standard_form_batch(models, device=device)


# --------------------------------------------------------------------------
# lanes: batched states as dicts of tensors with a leading lane axis
# --------------------------------------------------------------------------


def _lp(d) -> StandardLP:
    return StandardLP(**d)


def _lpd(lp: StandardLP) -> dict:
    return {k: getattr(lp, k) for k in _LP}


def _sd(st, fields=_SF) -> dict:
    return {k: getattr(st, k) for k in fields}


def take(d: dict, idx: torch.Tensor) -> dict:
    """The lanes `idx` of a batched dict."""
    return {k: v.index_select(0, idx) for k, v in d.items()}


def put(d: dict, idx: torch.Tensor, sub: dict) -> dict:
    """d with the lanes `idx` replaced by `sub` (out of place)."""
    return {k: v.index_copy(0, idx, sub[k]) for k, v in d.items()}


def gate(mask: torch.Tensor, new: dict, old: dict) -> dict:
    """Per lane: `new` where mask, else `old` bit for bit."""
    return {k: torch.where(mask.reshape((-1,) + (1,) * (v.ndim - 1)), new[k], v)
            for k, v in old.items()}


def lane(d: dict, i: int) -> dict:
    return {k: v[i] for k, v in d.items()}


class _Lanes:
    """The port's single-LP simplex bodies, vmapped over a batch of lanes.

    The loop-invariant forms (pivot_invariants, the f32 copy of G in the
    mixed engine) are built once per batch, as `_dual_iteration_fn` builds
    them once per solve. The batched routes run the EngineOptions defaults:
    dense PRICE with no kernel launch under vmap."""

    def __init__(self, lpd: dict, opts: SimplexOptions):
        if opts.price_mode != "dense" or opts.use_pallas_price or opts.use_pallas_pivot:
            raise ValueError("the batched engine runs dense PRICE with no kernel")
        self.lpd, self.opts = lpd, opts
        o = opts
        self.pre = vmap(lambda l: engine.pivot_invariants(_lp(l), o))(lpd)
        self.G32 = lpd["G"].to(torch.float32) if o.inverse_dtype == "float32" else None

    def take(self, idx: torch.Tensor) -> "_Lanes":
        out = object.__new__(_Lanes)
        out.lpd, out.opts = take(self.lpd, idx), self.opts
        out.pre = take(self.pre, idx)
        out.G32 = None if self.G32 is None else self.G32.index_select(0, idx)
        return out

    def with_opts(self, opts: SimplexOptions) -> "_Lanes":
        return _Lanes(self.lpd, opts)

    # the vmapped bodies -----------------------------------------------------

    def dual_step(self, S: dict) -> dict:
        o = self.opts
        if self.G32 is None:
            def one(l, s, pre):
                return _sd(engine.dual_iteration(_lp(l), SimplexState(**s), o, pre=pre))
            return vmap(one)(self.lpd, S, self.pre)

        def one32(l, s, pre, g32):
            return _sd(engine.dual_iteration(_lp(l), SimplexState(**s), o, G32=g32, pre=pre))
        return vmap(one32)(self.lpd, S, self.pre, self.G32)

    def primal_step(self, S: dict) -> dict:
        o = self.opts
        if self.G32 is None:
            def one(l, s):
                return _sd(engine.primal_iteration(_lp(l), SimplexState(**s), o))
            return vmap(one)(self.lpd, S)

        def one32(l, s, g32):
            return _sd(engine.primal_iteration(_lp(l), SimplexState(**s), o, G32=g32))
        return vmap(one32)(self.lpd, S, self.G32)

    def recompute(self, S: dict) -> dict:
        o = self.opts
        return vmap(lambda l, s: _sd(engine.recompute(_lp(l), SimplexState(**s),
                                                      o.dual_bound)))(self.lpd, S)

    def make_dual_feasible(self, S: dict) -> dict:
        o = self.opts
        return vmap(lambda l, s: _sd(engine.make_dual_feasible(
            _lp(l), SimplexState(**s), o)))(self.lpd, S)

    def verify_dual(self, S: dict) -> torch.Tensor:
        o = self.opts
        return vmap(lambda l, s: engine._verify_dual_claim(
            _lp(l), SimplexState(**s), o))(self.lpd, S)

    def verify_primal(self, S: dict) -> torch.Tensor:
        o = self.opts
        return vmap(lambda l, s: engine._verify_primal_claim(
            _lp(l), SimplexState(**s), o))(self.lpd, S)

    def initial_state(self) -> dict:
        o = self.opts
        return vmap(lambda l: _sd(engine.initial_state(_lp(l), o)))(self.lpd)

    def objective(self, S: dict) -> torch.Tensor:
        o = self.opts

        def one(l, s):
            xn = engine.nonbasic_values(_lp(l), s["vstat"], o.dual_bound)
            return l["c"].index_select(0, s["basis"]) @ s["xb"] + l["c"] @ xn
        return vmap(one)(self.lpd, S)


def _chunk(S: dict, active: torch.Tensor, step, chunk: int, U: int, max_iter: int,
           clip: bool = False):
    """The JAX inner while_loop under vmap: up to `chunk` pivots per lane,
    in blocks of U with one host read per block for the whole batch. A
    lane runs while its own predicate holds; a gated lane keeps its state
    bit for bit. `clip` ends a block at the chunk boundary (the QP loop's
    blocks); the simplex's self-gating pivots over-run it, as in JAX. A
    lockstep program (utils/lockstep.py): it yields its host reads."""
    k = 0

    def pred(S, k):
        return ((S["status"] == CONTINUE) & ~S["refactor_now"]
                & (S["iterations"] < max_iter)) if k < chunk else torch.zeros_like(active)

    run = active & pred(S, k)
    while (yield run.any()):
        n = min(U, chunk - k) if clip else U
        # under vmap every lane of the batch computes each step
        trace.count("lane_steps", run.shape[0] * n)
        if S["binv"].dtype == torch.float32:
            trace.count("lane_steps_f32", run.shape[0] * n)
        for _ in range(n):
            S = gate(run, step(S), S)
        k += n
        run = run & pred(S, k)
    return S


def _lanes_prog(S: dict, recompute, verify, step, opts: SimplexOptions,
                max_chunks: int = 0, claims=(engine.OPTIMAL, engine.PRIMAL_INFEASIBLE,
                                             engine.DUAL_INFEASIBLE),
                reclaim: bool = True, U: Optional[int] = None, clip: bool = False,
                stops: Optional[dict] = None):
    """engine._run_loop over a batch of lanes, as jax.vmap runs the JAX
    package's: each lane keeps its own stall count, verification and round
    count, and freezes once its own outer predicate fails. One host read
    per refactor round for the whole batch. A lockstep program; returns
    (S, verified). Given a dict `stops`, it also leaves there, under
    "why", each lane's cause of a NUMERICAL end (0 none, _STOP_REFACTOR a
    fresh factor rejected the basis, _STOP_STALL three rounds without a
    pivot)."""
    U = max(1, int(opts.inner_unroll)) if U is None else U
    Bn = S["status"].shape[0]
    dev = S["status"].device
    stalls = torch.zeros(Bn, dtype=torch.int32, device=dev)
    verified = torch.zeros(Bn, dtype=torch.bool, device=dev)
    rounds = torch.zeros(Bn, dtype=torch.int32, device=dev)
    claims_t = torch.tensor(claims, dtype=S["status"].dtype, device=dev)
    term_t = claims_t[claims_t != OPTIMAL]
    why = None if stops is None else torch.zeros(Bn, dtype=torch.int8, device=dev)
    while True:
        status = S["status"]
        claim = torch.isin(status, claims_t)
        ok = (((status == CONTINUE) | (claim & ~verified))
              & (S["iterations"] < opts.max_iterations) & (stalls < 3))
        if max_chunks > 0:
            ok = ok & (rounds < max_chunks)
        if not (yield ok.any()):
            break
        iters_before = S["iterations"]
        claimed_opt = status == OPTIMAL
        claimed_term = torch.isin(status, term_t) if reclaim else torch.zeros_like(ok)
        R = recompute(S)
        if why is not None:
            why = torch.where(ok & (R["status"] == NUMERICAL) & (why == 0),
                              _STOP_REFACTOR, why)
        v = claimed_opt & verify(R) & (R["status"] != NUMERICAL)
        R["status"] = torch.where(
            R["status"] == NUMERICAL, NUMERICAL,
            torch.where(v, OPTIMAL, CONTINUE)).to(status.dtype)
        R = yield from _chunk(R, ok & ~v, step, opts.refactor_frequency, U,
                              opts.max_iterations, clip)
        reclaimed = claimed_term & (R["status"] == status) & (R["iterations"] == iters_before)
        v = v | reclaimed
        made = (R["iterations"] > iters_before) | v
        S = gate(ok, R, S)
        verified = torch.where(ok, v, verified)
        stalls = torch.where(ok, torch.where(made, 0, stalls + 1), stalls).to(stalls.dtype)
        rounds = torch.where(ok, rounds + 1, rounds)
    S = dict(S)
    stalled = (S["status"] == CONTINUE) & (stalls >= 3)
    S["status"] = torch.where(stalled, NUMERICAL, S["status"]).to(S["status"].dtype)
    if why is not None:
        stops["why"] = torch.where(stalled, _STOP_STALL, why)
    # final consistency pass (already on fresh factors where verified)
    if (yield (~verified).any()):
        S = gate(verified, S, recompute(S))
    S["status"] = torch.where(
        (S["status"] == CONTINUE) & (S["iterations"] >= opts.max_iterations),
        engine.ITER_LIMIT, S["status"]).to(S["status"].dtype)
    return S, verified


# --------------------------------------------------------------------------
# the batched dual simplex engine (the JAX package's _b* programs)
# --------------------------------------------------------------------------


def _bprep(E: _Lanes, S: dict) -> dict:
    return E.make_dual_feasible(E.recompute(S))


def _brounds_prog(E: _Lanes, S: dict, rounds: int, stops: Optional[dict] = None):
    """`rounds` refactor-chunks of the full claim protocol per lane
    (engine.dual_solve_rounds, lane by lane). A lockstep program; returns
    (S, verified), and the lanes' NUMERICAL causes in `stops` (_lanes_prog)."""
    return (yield from _lanes_prog(S, E.recompute, E.verify_dual, E.dual_step, E.opts,
                                   max_chunks=rounds, stops=stops))


def _bchunk(E: _Lanes, S: dict):
    """engine._one_chunk lane by lane: refactorize, verify an OPTIMAL claim,
    and up to one chunk of pivots where it did not verify. Returns (S,
    verified, objective)."""
    o = E.opts
    claimed = S["status"] == OPTIMAL
    R = E.recompute(S)
    v = claimed & E.verify_dual(R) & (R["status"] != NUMERICAL)
    R["status"] = torch.where(R["status"] == NUMERICAL, NUMERICAL,
                              torch.where(v, OPTIMAL, CONTINUE)).to(S["status"].dtype)
    R = run(_chunk(R, ~v, E.dual_step, o.refactor_frequency, max(1, int(o.inner_unroll)),
                   o.max_iterations))
    return R, v, E.objective(R)


def _lanes_of(mask: torch.Tensor):
    """The indices where `mask` holds, read on the host (a lockstep read)."""
    v = yield mask
    return torch.as_tensor(np.flatnonzero(v), device=mask.device)


def _brerun_prog(E: _Lanes, S: dict, need: torch.Tensor):
    """Re-solve the lanes `need` from their own bases (the fake-bound
    escalation): recompute, make dual feasible, a whole dual solve."""
    idx = yield from _lanes_of(need)
    trace.count("rerun_lanes", idx.numel())
    Es = E.take(idx)
    sub = take(S, idx)
    sub["status"] = torch.full_like(sub["status"], CONTINUE)
    sub = _bprep(Es, sub)
    sub, _ = yield from _lanes_prog(sub, Es.recompute, Es.verify_dual, Es.dual_step, Es.opts)
    return put(S, idx, sub)


def _bprimal_finish_prog(E: _Lanes, S: dict, need: torch.Tensor):
    """The lanes `need` park their fake-bound nonbasics at 0 as FREE and
    finish with the primal on the true bounds (resetFakeBounds + primal
    cleanup, ClpSimplexDual.cpp:8303)."""
    idx = yield from _lanes_of(need)
    trace.count("finish_lanes", idx.numel())
    Es = E.take(idx)
    sub = take(S, idx)
    vs = sub["vstat"]
    sub["vstat"] = torch.where(_fake(Es.lpd, vs), engine.FREE, vs).to(vs.dtype)
    sub["status"] = torch.full_like(sub["status"], CONTINUE)
    sub = Es.recompute(sub)
    sub, _ = yield from _lanes_prog(sub, Es.recompute, Es.verify_primal, Es.primal_step,
                                    Es.opts)
    return put(S, idx, sub)


def _fake(lpd: dict, vs: torch.Tensor) -> torch.Tensor:
    """Nonbasics sitting at a fake bound (an infinite bound of the LP)."""
    return (((vs == engine.AT_LOWER) & ~torch.isfinite(lpd["l"]))
            | ((vs == engine.AT_UPPER) & ~torch.isfinite(lpd["u"])))


def _fake_lanes(lpd: dict, S: dict) -> torch.Tensor:
    return _fake(lpd, S["vstat"]).any(dim=1)


def _compacting_prog(E: _Lanes, S: dict, rounds_per_dispatch: int = 6):
    """The batched dual simplex with live-set compaction.

    Runs a bounded number of refactor-chunks per dispatch (the whole
    verified-claim protocol inside), then retires the lanes whose status
    is settled and packs the survivors together, so finished lanes stop
    costing work. The JAX package pads the survivors to a power of two to
    bound its compiled programs; nothing compiles here, so the live set is
    packed exactly. One packed host read per dispatch; a lockstep program,
    so over a mesh each shard compacts its own lanes. Traced under the
    float32 inverse, the read also carries each lane's NUMERICAL cause,
    and the lanes retired unsettled are counted by cause
    (_count_f32_stops); untraced, nothing of that is computed."""
    o = E.opts
    f32 = trace.enabled() and o.inverse_dtype == "float32"
    Bn = S["status"].shape[0]
    dev = S["status"].device
    out = {k: v.clone() for k, v in S.items()}
    live = torch.arange(Bn, device=dev)
    S = _bprep(E, S)
    max_disp = int(o.max_iterations) // max(1, int(o.refactor_frequency) * rounds_per_dispatch) + 8
    prev_iters = np.full(Bn, -1, dtype=np.int64)
    stall = np.zeros(Bn, dtype=np.int64)
    for _ in range(max_disp):
        stops = {} if f32 else None
        S, ver = yield from _brounds_prog(E, S, rounds_per_dispatch, stops)
        read = yield torch.stack(
            [S["status"].to(torch.int64), ver.to(torch.int64),
             S["iterations"].to(torch.int64)]
            + ([stops["why"].to(torch.int64)] if f32 else []))
        stat, ver_np, iters = read[:3]
        trace.count("dispatches")
        ver_np = ver_np.astype(bool)
        # settled: verified claims and hard stops. A lane whose terminal
        # claim persists unverified with no pivots over two dispatches is
        # retired as NUMERICAL (the host pending/stall protocol)
        hard = np.isin(stat, (NUMERICAL, engine.ITER_LIMIT))
        claim_stalled = ~ver_np & (stat != CONTINUE) & ~hard & (iters == prev_iters)
        stall = np.where(claim_stalled, stall + 1, 0)
        prev_iters = iters.copy()
        give_up = stall >= 2
        finish = ver_np | hard | give_up
        if finish.any():
            if f32:
                _count_f32_stops(finish & ~ver_np, read[3], give_up & ~hard)
            gu = torch.as_tensor(give_up & ~(ver_np | hard), device=dev)
            S["status"] = torch.where(gu, NUMERICAL, S["status"]).to(S["status"].dtype)
            fin = torch.as_tensor(np.flatnonzero(finish), device=dev)
            out = put(out, live.index_select(0, fin), take(S, fin))
            keep = ~finish
            if not keep.any():
                return out
            trace.count("compactions")
            kidx = torch.as_tensor(np.flatnonzero(keep), device=dev)
            live = live.index_select(0, kidx)
            prev_iters, stall = prev_iters[keep], stall[keep]
            E, S = E.take(kidx), take(S, kidx)
    # dispatch budget exhausted: what is left goes back as NUMERICAL
    if f32:
        _count_f32_stops(np.ones(live.numel(), dtype=bool), 0, False)
    S["status"] = torch.full_like(S["status"], NUMERICAL)
    return put(out, live, S)


def _count_f32_stops(stopped: np.ndarray, why, claim) -> None:
    """Count the lanes that the float32 loop retires unsettled (`stopped`,
    host arrays), by cause: `refactor`, a fresh factor or its float64
    refinement rejected the basis; `stall`, three fresh factors in a row
    each followed by a refused pivot (the pivot cross-check or the f32
    pivot floor); `claim`, a claim that never verified; `limit`, the
    iteration limit or the dispatch budget."""
    by = {"refactor": stopped & (why == _STOP_REFACTOR),
          "stall": stopped & (why == _STOP_STALL), "claim": stopped & claim}
    by["limit"] = stopped & ~(by["refactor"] | by["stall"] | by["claim"])
    trace.count("f32_stops", stopped.sum())
    for cause, lanes in by.items():
        trace.count(f"f32_stops_{cause}", lanes.sum())


def _unsettled(S: dict) -> torch.Tensor:
    return (S["status"] == NUMERICAL) | (S["status"] == CONTINUE)


def _f64_options(opts: SimplexOptions, dual_tolerance: Optional[float] = None):
    """The float64 engine of the single-LP driver's mixed-precision
    escalation: refactor every 100 pivots, one pivot a host read."""
    return dataclasses.replace(opts, inverse_dtype="float64", refactor_frequency=100,
                               inner_unroll=1,
                               dual_tolerance=dual_tolerance or opts.dual_tolerance)


def _lanes64(E: _Lanes, S: dict, idx: torch.Tensor, opts: SimplexOptions):
    """The lanes `idx` of S (its inverse already float64) on the float64
    engine `opts`: their _Lanes, and their states with status CONTINUE."""
    sub = take(S, idx)
    sub["status"] = torch.full_like(sub["status"], CONTINUE)
    return _Lanes(take(E.lpd, idx), opts), sub


def _bcold_prog(E: _Lanes, S: dict, mask: torch.Tensor, start, solve: bool):
    """S with the lanes `mask` restarted cold from `start(lanes)` and
    refactorized, then, where `solve`, made dual feasible and solved by
    the dual. A lockstep program."""
    idx = yield from _lanes_of(mask)
    if not idx.numel():
        return S
    trace.count("f64_finish_cold", idx.numel())
    Ec = E.take(idx)
    sub = Ec.recompute(start(Ec))
    if solve:
        sub, _ = yield from _lanes_prog(Ec.make_dual_feasible(sub), Ec.recompute,
                                        Ec.verify_dual, Ec.dual_step, Ec.opts)
    return put(S, idx, sub)


def _bf64_finish_prog(E: _Lanes, S: dict, need: torch.Tensor, start):
    """The lanes `need` go on warm from their own bases on the float64
    engine, as one batch: the single-LP driver's mixed-precision
    escalation (simplex/driver.py) lane by lane. Each lane's inverse is
    refactorized in float64, the lane made dual feasible and solved by the
    float64 dual. A lane whose carried basis the float64 factor rejects
    restarts cold from `start(lanes)`; so, once, does one that the float64
    dual cannot finish from (a near-singular basis the factor let
    through). A lockstep program."""
    idx = yield from _lanes_of(need)
    trace.count("f64_finish_lanes", idx.numel())
    if not idx.numel():
        return S
    Es, sub = _lanes64(E, S, idx, _f64_options(E.opts))
    sub = Es.recompute(sub)
    rejected = sub["status"] == NUMERICAL
    sub = yield from _bcold_prog(Es, sub, rejected, start, solve=False)
    sub, _ = yield from _lanes_prog(Es.make_dual_feasible(sub), Es.recompute, Es.verify_dual,
                                    Es.dual_step, Es.opts)
    sub = yield from _bcold_prog(Es, sub, _unsettled(sub) & ~rejected, start, solve=True)
    return put(S, idx, sub)


def _bf64_clean_prog(E: _Lanes, S: dict, need: torch.Tensor):
    """The OPTIMAL lanes `need`, primal feasible on fresh float64 factors
    but with reduced costs of the wrong sign that the float64 route does
    not leave (the float32 pricing leaves up to ~1e-7, inside the dual
    tolerance), cleaned by the float64 primal simplex from their own bases
    at the dual tolerance _CLEAN_DUAL_TOL: Clp's primal cleanup after the
    dual. A lockstep program."""
    idx = yield from _lanes_of(need)
    trace.count("f64_clean_lanes", idx.numel())
    if not idx.numel():
        return S
    Es, sub = _lanes64(E, S, idx, _f64_options(E.opts, _CLEAN_DUAL_TOL))
    sub, _ = yield from _lanes_prog(Es.recompute(sub), Es.recompute, Es.verify_primal,
                                    Es.primal_step, Es.opts)
    return put(S, idx, sub)


def _bf64_prog(E: _Lanes, S: dict, start):
    """The float64 end of the float32 route, over one block of lanes (a
    lockstep program):
      1. every OPTIMAL claim of the float32 loop is refactorized in
         float64, so its x_B, y and dj are the float64 engine's; a claim
         that is not primal feasible there is reopened;
      2. the lanes the float32 loop left unsettled, and the reopened
         ones, finish on the float64 engine (_bf64_finish_prog);
      3. an OPTIMAL lane with reduced costs of the wrong sign beyond 10 x
         _CLEAN_DUAL_TOL is cleaned by the float64 primal
         (_bf64_clean_prog).
    Returns the lanes' states on float64 inverses, for the float64 engine
    that the escalation and the primal finish run on next. Only what
    these leave unsettled goes to the single-LP driver."""
    S = dict(S, binv=S["binv"].to(E.lpd["G"].dtype))
    Ec = E.with_opts(_f64_options(E.opts, _CLEAN_DUAL_TOL))
    R = Ec.recompute(S)
    R["status"] = torch.where(Ec.verify_dual(R) & (R["status"] != NUMERICAL),
                              OPTIMAL, CONTINUE).to(S["status"].dtype)
    S = gate(S["status"] == OPTIMAL, R, S)
    S = yield from _bf64_finish_prog(E, S, _unsettled(S), start)
    return (yield from _bf64_clean_prog(E, S, (S["status"] == OPTIMAL) & ~Ec.verify_primal(S)))


def _engine_options(options: SolveOptions, m0: int, accel: bool) -> SimplexOptions:
    inv = getattr(options, "inverse_dtype", "auto")
    if inv == "auto":
        # the single-LP driver's policy: the f32 pivot loop on the card at
        # scale (the JAX package's TPU branch)
        inv = "float32" if accel and m0 >= 512 else "float64"
    return SimplexOptions(
        refactor_frequency=options.refactor_frequency or (400 if inv == "float32" else 100),
        max_iterations=options.max_iterations or 100000,
        inverse_dtype=inv,
        # blocks of 8 gated pivots per host read in the mixed engine: every
        # lane pays the slowest lane's loop boundary
        inner_unroll=8 if inv == "float32" else 1,
    )


def _blocks(mesh, options: SolveOptions, B: int) -> list:
    """((a, b), device) for each block of lanes: one per mesh entry
    (contiguous blocks, as scenario_sharding splits them), or the whole
    batch on options.device without a mesh."""
    if mesh is None:
        return [((0, B), resolve_device(options.device))]
    return list(zip(scenario_sharding(mesh, options.mesh_axis).bounds(B), mesh.devices))


def _placed(mesh, options: SolveOptions, batched: StandardLP) -> list:
    """The host batch's lane blocks, each a StandardLP copied to its
    device."""
    return [StandardLP(**{k: None if getattr(batched, k) is None
                          else to_device(getattr(batched, k)[a:b], dev)
                          for k in _LP + ("Q",)})
            for (a, b), dev in _blocks(mesh, options, batched.G.shape[0])]


def _built_simplex(mesh, options: SolveOptions, models) -> tuple[list, list]:
    """The batch's simplex form as lane blocks, each built on its device
    from its own models, and the per-lane form infos."""
    blocks = _blocks(mesh, options, len(models))
    if len(blocks) > 1:
        batch_shape(models)  # the blocks must agree with each other
    built = [stack_models_simplex(models[a:b], dev) for (a, b), dev in blocks]
    return [lp for lp, _ in built], [i for _, infos in built for i in infos]


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """t on the host, its bytes counted as d2h_bytes when they come off a
    device."""
    if t.device.type != "cpu":
        trace.count("d2h_bytes", t.nbytes)
    return t.cpu()


def _each(flags, progs) -> list:
    """Run the programs whose flag holds in lockstep; None for the rest."""
    on = [i for i, f in enumerate(flags) if f]
    res = lockstep([progs[i]() for i in on])
    out = [None] * len(flags)
    for i, r in zip(on, res):
        out[i] = r
    return out


def _start(E: _Lanes, warm: Optional[Solution]) -> dict:
    """The lanes' starting states: all-slack, or a shared warm basis (e.g.
    strong branching from one parent), each lane's built on the host, then
    stacked."""
    from ..simplex.driver import _warm_state

    if warm is None or warm.column_status is None:
        return E.initial_state()
    B, m0, nt0 = E.lpd["G"].shape
    per = [_warm_state(_lp(lane(E.lpd, i)), E.opts, warm, nt0 - m0, m0) for i in range(B)]
    return {k: torch.stack([getattr(p, k) for p in per]) for k in _SF}


def _dual_lanes(shards: list, options: SolveOptions, warm: Optional[Solution]):
    """The batched dual over the placed lane blocks: the compacting pivot
    loop, under the float32 inverse its float64 end (_bf64_prog), then
    the fake-bound escalation and the primal finish, on the float64 engine
    after a float64 end (as the single-LP driver's after its escalation).
    Returns each block's states, LP dicts and fake-bound flags, and the
    options of the last escalation."""
    accel = on_accelerator(shards[0].G)
    if accel:
        check_fp32_precision()
    opts = _engine_options(options, shards[0].G.shape[1], accel)
    Es = [_Lanes(_lpd(lp_s), opts) for lp_s in shards]
    Ss = lockstep([_compacting_prog(E, _start(E, warm)) for E in Es])
    if opts.inverse_dtype == "float32":
        with trace.span("f64_finish"):
            Ss = lockstep([_bf64_prog(E, S, lambda lanes: _start(lanes, warm))
                           for E, S in zip(Es, Ss)])
        opts = _f64_options(opts)
        Es = [E.with_opts(opts) for E in Es]

    lpds = [E.lpd for E in Es]
    fakes = [_fake_lanes(lpd, S) for lpd, S in zip(lpds, Ss)]
    opts_e = opts
    with trace.span("escalation"):
        for _ in range(2):
            need = [(S["status"] == OPTIMAL) & f for S, f in zip(Ss, fakes)]
            flags = host_read([n.any() for n in need])
            if not any(flags):
                break
            opts_e = dataclasses.replace(opts_e, dual_bound=opts_e.dual_bound * 100.0)
            Es = [E.with_opts(opts_e) for E in Es]
            re = _each(flags, [lambda i=i: _brerun_prog(Es[i], Ss[i], need[i])
                               for i in range(len(Es))])
            Ss = [S if r is None else r for S, r in zip(Ss, re)]
            fakes = [_fake_lanes(lpd, S) for lpd, S in zip(lpds, Ss)]
    # OPTIMAL on a fake bound needs the true-bounds primal finish; an
    # infeasibility claim with fakes active is suspect for the same reason
    # the driver adjudicates it (a folded free variable prices one way)
    with trace.span("primal_finish"):
        need_pf = [((S["status"] == OPTIMAL) | (S["status"] == engine.PRIMAL_INFEASIBLE)) & f
                   for S, f in zip(Ss, fakes)]
        flags = host_read([n.any() for n in need_pf])
        if any(flags):
            re = _each(flags, [lambda i=i: _bprimal_finish_prog(Es[i], Ss[i], need_pf[i])
                               for i in range(len(Es))])
            Ss = [S if r is None else r for S, r in zip(Ss, re)]
            fakes = [_fake_lanes(lpd, S) for lpd, S in zip(lpds, Ss)]
    return Ss, lpds, fakes, opts_e


def solve_batch_dual_simplex(
    models: Sequence[Model],
    options: Optional[SolveOptions] = None,
    mesh=None,
    warm: Optional[Solution] = None,
) -> list[Solution]:
    """Batched dual simplex: the whole pivot loop over all instances at once.

    The per-instance host policies (fake-bound escalation, algorithm
    switching) run batched where they can: lanes that end on a fake bound
    re-solve with a larger bound, then finish with the primal, still as one
    batch. Only numerical leftovers go through the single-instance driver.

    Over a `mesh` (axis options.mesh_axis) each entry runs its contiguous
    block of lanes on its device; the blocks advance in lockstep, one host
    read per block of pivots for the whole mesh, and each compacts its own
    live set. The escalation decisions stay the batch's, as without a mesh.

    Under the float32 inverse (the card's choice from m = 512), the lanes
    the float32 loop leaves unsettled go on warm from their own bases on
    the float64 engine, still as one batch, before the escalation: the
    single-instance driver's mixed-precision escalation, batched. The
    escalation and the primal finish then run on that float64 engine.

    Traced (clp_tpu_torch/trace.py) as the root `batch_dual` with the
    spans stack, place, loop (f64_finish under the float32 inverse,
    escalation, primal_finish), copy_back and unpack (leftover, one a lane
    sent to the single-instance driver).
    """
    with trace.span("batch_dual", lanes=len(models)) as root:
        # the call's locals (gigabytes of host copies) are freed as
        # _batch_dual returns, inside the root, so the root spans the call
        return _batch_dual(models, options or SolveOptions(), mesh, warm, root)


def _batch_dual(models, options: SolveOptions, mesh, warm, root) -> list[Solution]:
    from ..simplex.driver import _extract, simplex_solve

    with trace.span("stack"):
        shards, _infos = _built_simplex(mesh, options, models)
    root.set(m=shards[0].G.shape[1], n=shards[0].G.shape[2])
    with trace.span("place"):
        pass  # each block was built on its device: nothing is left to copy in
    with trace.span("loop"):
        Ss, lpds, fakes, opts_e = _dual_lanes(shards, options, warm)

    # one transfer of each block to the host, then numpy per lane
    with trace.span("copy_back"):
        S_h = {k: torch.cat([_to_host(S[k]) for S in Ss]) for k in _SF}
        lp_h = {k: torch.cat([_to_host(lpd[k]) for lpd in lpds]) for k in _LP}
        fakes_h = torch.cat([_to_host(f) for f in fakes]).numpy()
    if trace.enabled():
        trace.count("lane_pivots", S_h["iterations"].sum())
        trace.count("refactors", S_h["refactors"].sum())
    with trace.span("unpack"):
        out = []
        for i, mod in enumerate(models):
            st_i = SimplexState(**lane(S_h, i))
            status = int(st_i.status)
            clean = status in (OPTIMAL, engine.PRIMAL_INFEASIBLE, engine.DUAL_INFEASIBLE) \
                and not (status == OPTIMAL and fakes_h[i])
            if clean:
                sol = _extract(mod, _lp(lane(lp_h, i)), st_i, opts_e, status)
            else:
                # numerical leftovers only: the per-instance policies
                trace.count("leftover_lanes")
                with trace.span("leftover", lane=i):
                    sol = simplex_solve(mod, options, dual=True)
            mod.solution = sol
            out.append(sol)
    return out


# --------------------------------------------------------------------------
# the batched IPM
# --------------------------------------------------------------------------


def solve_batch_ipm(
    models: Sequence[Model],
    options: SolveOptions,
    mesh=None,
) -> list[Solution]:
    """Same-shape models through the lane-wise batched IPM. LPs share one
    banded plan where RCM on the union pattern makes it pay (the reference's
    symbolic/numeric split, ClpCholeskyBase.cpp:638: order once, factor
    many), else run the dense normal equations.

    Traced (clp_tpu_torch/trace.py) as the root `batch_ipm` with the spans
    stack, place (without a mesh; over one, the blocks are placed inside
    loop), loop, copy_back and unpack.
    """
    with trace.span("batch_ipm", lanes=len(models)) as root:
        # as in solve_batch_dual_simplex: the locals are freed inside the root
        return _batch_ipm(models, options, mesh, root)


def _batch_ipm(models, options: SolveOptions, mesh, root) -> list[Solution]:
    from ..interior.mehrotra import ipm_batched_prog
    from ..solve import _ipm_to_solution, _rcm_band_plan

    with trace.span("stack"):
        batched, infos = stack_models(models, "cpu")
    root.set(m=batched.G.shape[1], n=batched.G.shape[2])
    if mesh is None:
        with trace.span("place"):
            batched = _placed(None, options, batched)[0]
    with trace.span("loop"):
        opts = IPMOptions(tol=options.barrier_tolerance,
                          max_iter=options.barrier_max_iterations)
        perm = None
        if batched.Q is None:
            union = _to_host((batched.G.abs() > 0).any(dim=0)).numpy()
            perm, nb = _rcm_band_plan(union.astype(np.float64))
            if perm is not None:
                perm = np.ascontiguousarray(perm)
                pj = torch.as_tensor(perm, device=batched.G.device)
                batched = dataclasses.replace(batched, G=batched.G.index_select(1, pj),
                                              b=batched.b.index_select(1, pj))
                opts = dataclasses.replace(opts, band_nb=nb)
        if mesh is None:
            parts = [ipm_solve_batched(batched, opts)]
        else:
            # each entry's block of lanes on its device, the IPM
            # iterations of all blocks in lockstep; the results meet on
            # the host
            parts = lockstep([ipm_batched_prog(lp_s, opts)
                              for lp_s in _placed(mesh, options, batched)])
    with trace.span("copy_back"):
        host = [{f.name: _to_host(getattr(r, f.name)) for f in dataclasses.fields(r)}
                for r in parts]
        res = dataclasses.replace(parts[0], **(host[0] if len(host) == 1 else {
            k: torch.cat([h[k] for h in host]) for k in host[0]}))
    with trace.span("unpack"):
        if perm is not None:
            y = torch.empty_like(res.y)
            y[:, torch.as_tensor(perm)] = res.y
            res.y = y
        out = []
        for i, (mod, info) in enumerate(zip(models, infos)):
            one = dataclasses.replace(res, **{f.name: getattr(res, f.name)[i]
                                              for f in dataclasses.fields(res)})
            sol = _ipm_to_solution(mod, one, info, options)
            mod.solution = sol
            out.append(sol)
    return out


# --------------------------------------------------------------------------
# the batched QP simplex
# --------------------------------------------------------------------------


def _qp_prog(lp: StandardLP, opts: SimplexOptions):
    """One block of QP lanes: phase 1 (the zero-cost dual) and the
    reduced-gradient loop, as a lockstep program. Returns (phase-1 lanes,
    QP lanes, duals y per lane)."""
    lpd = _lpd(lp)
    lpd0 = dict(lpd, c=torch.zeros_like(lpd["c"]))
    E0 = _Lanes(lpd0, opts)
    S0 = _bprep(E0, E0.initial_state())
    S0, _ = yield from _lanes_prog(S0, E0.recompute, E0.verify_dual, E0.dual_step, opts)

    def q0(l, s):
        xn = engine.nonbasic_values(_lp(l), s["vstat"], opts.dual_bound)
        return {"basis": s["basis"], "vstat": s["vstat"], "binv": s["binv"],
                "x": xn.index_put((s["basis"],), s["xb"]),
                "iterations": torch.zeros_like(s["iterations"]),
                "status": torch.full_like(s["status"], CONTINUE),
                "refactor_now": torch.zeros_like(s["refactor_now"])}

    Q = vmap(q0)(lpd0, S0)
    qlpd = dict(lpd, Q=lp.Q)

    def qlp(l):
        return StandardLP(**l)

    def rec(S):
        return vmap(lambda l, s: _sd(qpm.qp_recompute(qlp(l), qpm.QPState(**s)), _QF))(qlpd, S)

    def ver(S):
        return vmap(lambda l, s: qpm._qp_optimal(qlp(l), qpm.QPState(**s), opts))(qlpd, S)

    def step(S):
        def one(l, s):
            lp1, st = qlp(l), qpm.QPState(**s)
            new = qpm.qp_sweep_iteration(lp1, qpm.qp_iteration(lp1, st, opts), opts)
            run = ((st.status == CONTINUE) & ~st.refactor_now
                   & (st.iterations < opts.max_iterations))
            return _sd(qpm._gate(run, new, st), _QF)
        return vmap(one)(qlpd, S)

    Q, _ = yield from _lanes_prog(Q, rec, ver, step, opts, claims=(OPTIMAL,), reclaim=False,
                                  U=qpm.QP_BLOCK, clip=True)
    grad = vmap(lambda l, x: qpm._gradient(qlp(l), x))(qlpd, Q["x"])
    y_all = vmap(lambda g, bs, bi: g.index_select(0, bs) @ bi)(grad, Q["basis"], Q["binv"])
    return S0, Q, y_all


def solve_batch_qp_simplex(
    models: Sequence[Model],
    options: Optional[SolveOptions] = None,
    mesh=None,
) -> list[Solution]:
    """Batched QP active-set simplex: same-shape QPs as one batch.

    The scenario shape this serves is the warm parametric sweep (portfolio
    rebalancing: one structure, many risk aversions). Phase 1 (a zero-cost
    dual to a feasible vertex) and the reduced-gradient loop of simplex/qp
    both run lane by lane over the batch; lanes the batch cannot finish
    cleanly fall back to the single-instance QP driver. Over a `mesh` each
    entry runs its contiguous block of lanes, all blocks in lockstep."""
    from ..constants import ProblemStatus
    from ..simplex.driver import _ENGINE_TO_VS

    options = options or SolveOptions()
    shards, infos = _built_simplex(mesh, options, models)
    if shards[0].Q is None:
        raise ValueError("solve_batch_qp_simplex needs quadratic objectives"
                         " (use solve_batch_dual_simplex for LPs)")
    m0, nt0 = shards[0].G.shape[1:]
    n0 = nt0 - m0
    opts = SimplexOptions(
        refactor_frequency=options.refactor_frequency or 100,
        max_iterations=int(min(options.max_iterations or 10 ** 9, 50 * (m0 + n0) + 10000)),
    )
    parts = lockstep([_qp_prog(lp_s, opts) for lp_s in shards])
    S0 = {k: torch.cat([p[0][k].cpu() for p in parts]) for k in ("status", "iterations")}
    Q = {k: torch.cat([p[1][k].cpu() for p in parts]) for k in _QF if k != "binv"}
    y_all = torch.cat([p[2].cpu() for p in parts])

    status_map = {
        OPTIMAL: ProblemStatus.OPTIMAL,
        engine.DUAL_INFEASIBLE: ProblemStatus.DUAL_INFEASIBLE,
        engine.ITER_LIMIT: ProblemStatus.STOPPED,
    }
    p1 = S0["status"].numpy()
    p1_it = S0["iterations"].numpy()
    Qh = {k: v.numpy() for k, v in Q.items()}
    y_h = y_all.numpy()
    out = []
    for i, (mod, info) in enumerate(zip(models, infos)):
        st = int(Qh["status"][i])
        if p1[i] == engine.PRIMAL_INFEASIBLE:
            sol = Solution(status=ProblemStatus.PRIMAL_INFEASIBLE)
        elif p1[i] != OPTIMAL or st not in status_map:
            sol = qpm.qp_simplex_solve(mod, options)  # per-instance fallback
        else:
            n = mod.num_cols
            xs = Qh["x"][i][:n]
            obj = float(mod.objective @ xs) + mod.objective_offset
            Qm = mod.quadratic_objective
            if Qm is not None:
                obj += 0.5 * float(xs @ (Qm @ xs))
            vstat = Qh["vstat"][i]
            duals = y_h[i] * info.sense
            dj_user = mod.objective + (Qm @ xs if Qm is not None else 0.0) - mod.matrix.T @ duals
            sol = Solution(
                status=status_map[st],
                objective_value=obj,
                primal=xs,
                duals=duals,
                reduced_costs=np.asarray(dj_user),
                row_activity=np.asarray(mod.matrix @ xs),
                iterations=int(Qh["iterations"][i]) + int(p1_it[i]),
                column_status=np.array([_ENGINE_TO_VS[int(s)] for s in vstat[:n]],
                                       dtype=np.int8),
                row_status=np.array([_ENGINE_TO_VS[int(s)] for s in vstat[n:]],
                                    dtype=np.int8),
            )
        mod.solution = sol
        out.append(sol)
    return out
