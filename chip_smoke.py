"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from clp_tpu_torch/csrc (nvcc, sm_90a, one
process per source, all started together), holds each kernel against its
plain PyTorch version at the main path's shapes and times both, then solves
the 2048 x 4608 staircase LP end to end through
`initial_solve(method=DUAL_SIMPLEX, device="cuda")` three times — with K1,
with K1 + K2, and on the block-banded route `price_mode="block"` with K3 —
and checks each answer against the port's KKT check and HiGHS
(scipy.optimize.milp). Last, each in a fresh process
(`chip_smoke.py --profile-pivots dense|block`), it profiles 200 pivots of
the engine on the dense route and on the block route. Every phase that
fails exits non-zero.

Prints a `{"kernels": [...]}` line, the card's name and power limit, and as
its last line `{"ok": true, "device": {...}}`. Imports nothing of the JAX
package. Exits non-zero with no result line when no CUDA card is visible.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the f32
# rate outside the tensor cores, which is what the port's f32 FMA kernels use
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
REPS = 30
# GPU cycles of torch.cuda._sleep before each timed launch (~1 ms at the
# H100's 1.98 GHz boost clock): longer than the host takes to enqueue the
# start event, the function's launches and the stop event
BUSY_CYCLES = 2_000_000
# every kernel of each profile window, too long for the console
PROFILE_DIR = pathlib.Path(__file__).resolve().parent / "build" / "profiles"
M, NT = 2048, 6656  # the staircase's standard form: 2048 rows, 4608 + 2048 columns
BLOCKS = (52, 264, 128)  # its block geometry (nb, H, CB) as the driver's probe picks it


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cold_ms(fn, flush, busy: bool = True) -> float:
    """Median device time of fn over REPS launches, each after an L2 flush
    (the pivot loop streams the f32 G or binv between two launches of a
    kernel, so no kernel finds its inputs in the 50 MB L2).

    With `busy`, the stream spins (torch.cuda._sleep) while the host
    enqueues the start event, fn's launches and the stop event, so the
    events bracket device work only. Without it the start event fires on an
    idle device and the time includes the host's submission of fn — how
    the kernels were timed before, kept to show the difference.
    """
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        if busy:
            torch.cuda._sleep(BUSY_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def staircase_g32(dev) -> torch.Tensor:
    """The f32 standard-form matrix [A | -I] of the main path's LP."""
    from clp_tpu_torch.forms import to_standard_form

    lp, _ = to_standard_form(staircase_model(), device=dev)
    if lp.G.shape != (M, NT):
        raise AssertionError(f"staircase standard form is {tuple(lp.G.shape)}")
    return lp.G.to(torch.float32)


def staircase_model():
    from clp_tpu_torch.utils.generators import staircase_lp

    return staircase_lp(nblocks=16, bm=128, bn=288, seed=0)


def staircase_blocks(dev, G32):
    """The main path's block form: the staircase's f32 G in the driver's
    sorted column order through engine.block_forms."""
    from clp_tpu_torch.simplex.driver import block_geometry
    from clp_tpu_torch.simplex.engine import block_forms

    geo = block_geometry(staircase_model())
    if geo is None or geo[:3] != BLOCKS:
        raise AssertionError(f"block geometry {None if geo is None else geo[:3]}, "
                             f"expected {BLOCKS}")
    nb, H, CB, perm = geo
    Gs = G32.index_select(1, torch.as_tensor(perm, device=dev))
    return Gs, block_forms(Gs, nb, H, CB)


def check_k1(dev, flush, G):
    """K1 on the main path's own G (the staircase's f32 standard form) with
    rho, dj, sgn and the eligibility mask drawn from default_rng(0).

    A dense N(0,1) G is no fair test at m = 2048: two f32 summation orders
    of 2048 unit-size products differ by up to ~4e-5 (on the H100, K1 and
    cuBLAS disagree that way on 9 of 6656 alphas beyond 2e-5), which is
    rounding noise of the product and not of the kernel. The staircase's
    structural columns hold 2-80 nonzeros (median 13), its slacks one.
    """
    from clp_tpu_torch.ops import price
    from clp_tpu_torch.ops.price import price_and_ratios, price_and_ratios_reference

    rng = np.random.default_rng(0)
    f32 = torch.float32
    rho = torch.as_tensor(rng.standard_normal(M), dtype=f32, device=dev)
    dj = torch.as_tensor(np.abs(rng.standard_normal(NT)), dtype=f32, device=dev)
    elig = torch.as_tensor(rng.uniform(size=NT) < 0.7, device=dev)
    sgn = torch.as_tensor(np.where(rng.uniform(size=NT) < 0.5, 1.0, -1.0),
                          dtype=f32, device=dev)
    sigma = torch.ones((), dtype=f32, device=dev)
    rel, ptol = 5e-8, 1e-9
    elig32 = elig.to(torch.int32)
    a_k, r_k = price_and_ratios(rho, G, dj, elig, sgn, sigma, rel, ptol)
    a_p, r_p = price_and_ratios_reference(rho, G, dj, elig32, sgn, sigma, rel, ptol)
    torch.cuda.synchronize()
    a_k, r_k, a_p, r_p = (t.cpu().numpy() for t in (a_k, r_k, a_p, r_p))
    # tolerances of tests/test_pallas.py: f32 sums in another order
    np.testing.assert_allclose(a_k, a_p, rtol=2e-5, atol=2e-5)
    agree = float((np.isfinite(r_k) == np.isfinite(r_p)).mean())
    if agree <= 0.99:
        raise AssertionError(f"K1 ratio finiteness agreement {agree} <= 0.99")
    both = np.isfinite(r_k) & np.isfinite(r_p)
    np.testing.assert_allclose(r_k[both], r_p[both], rtol=2e-4, atol=2e-4)
    err = float(np.abs(a_k - a_p).max())

    def library():
        alpha = rho @ G
        a = sigma * alpha
        ok = elig & (a.abs() > ptol) & (sgn * a > 0)
        return alpha, torch.where(ok, (dj + sgn * rel) / torch.where(ok, a, 1.0), torch.inf)

    out = torch.empty((2, NT), dtype=f32, device=dev)
    sig1 = sigma.reshape(1)
    ms = cold_ms(lambda: price._launch(rho, G, dj, elig32, sgn, sig1, rel, ptol, out), flush)
    idle = cold_ms(lambda: price._launch(rho, G, dj, elig32, sgn, sig1, rel, ptol, out),
                   flush, busy=False)
    wrapper = cold_ms(lambda: price_and_ratios(rho, G, dj, elig, sgn, sigma, rel, ptol), flush)
    plain = cold_ms(lambda: price_and_ratios_reference(
        rho, G, dj, elig32, sgn, sigma, rel, ptol), flush)
    lib = cold_ms(library, flush)
    nbytes = 4 * (M * NT + M + 3 * NT + 1) + 4 * 2 * NT
    b_ms, b_by = bound(nbytes, 2 * M * NT + 6 * NT)
    print(f"K1 price_and_ratios m={M} nt={NT}: max|alpha err|={err:.3e} "
          f"ratio finiteness agreement={agree:.5f}; kernel {ms * 1e3:.1f} us "
          f"(from an idle stream {idle * 1e3:.1f} us), wrapper {wrapper * 1e3:.1f} us, "
          f"plain {plain * 1e3:.1f} us, library {lib * 1e3:.1f} us, "
          f"bound {b_ms * 1e3:.1f} us ({b_by}, {nbytes / 1e6:.1f} MB)", flush=True)
    return {"name": "K1 price_and_ratios", "route": "cuda",
            "source": "clp_tpu_torch/csrc/price.cu",
            "replaces": "clp_tpu/ops/pallas_price.py:110",
            "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def check_k2(dev, flush, G32):
    from clp_tpu_torch.ops import pivot
    from clp_tpu_torch.ops.pivot import fused_pivot_update, fused_pivot_update_reference

    rng = np.random.default_rng(0)
    f32 = torch.float32
    # binv entries N(0, 1/m): rows of unit norm, the scale of the inverse of a
    # well-conditioned basis; g_q a column of the main path's G and f_delta a
    # flip flow G @ delta, as the pivot body builds them
    binv = torch.as_tensor(rng.standard_normal((M, M)) / np.sqrt(M), dtype=f32, device=dev)
    gq = G32[:, 100].contiguous()
    delta = torch.as_tensor(rng.standard_normal(NT) * (rng.uniform(size=NT) < 0.02),
                            dtype=f32, device=dev)
    fd = G32 @ delta
    r = torch.tensor(1234, device=dev)
    rho = binv[1234].clone()
    triple = torch.stack([gq, rho, fd], dim=1).contiguous()
    abar_r = torch.dot(rho, gq)
    one = torch.ones((), dtype=f32, device=dev)
    bn, res = fused_pivot_update(binv, triple, rho, abar_r, one, r)
    bp, rp = fused_pivot_update_reference(binv, triple, rho, abar_r, one, r)
    bn0, _ = fused_pivot_update(binv, triple, rho, abar_r, 0.0 * one, r)
    torch.cuda.synchronize()
    err = max(float((bn - bp).abs().max()), float((res - rp).abs().max()))
    if not err < 1e-5:
        raise AssertionError(f"K2 differs from its plain version by {err}")
    if float((bn0 - binv).abs().max()) != 0.0:
        raise AssertionError("K2 with gate = 0 changed binv")
    factor = torch.empty(M, dtype=f32, device=dev)

    def library():
        R = binv @ triple
        torch.div(R[:, 0], abar_r, out=factor)
        return scratch.addr_(factor, rho, alpha=-1.0), R

    scratch = binv.clone()
    scal = torch.stack([1.0 / abar_r, one])
    r32 = r.to(torch.int32).reshape(1)
    bout = torch.empty_like(binv)
    rout = torch.empty((M, 3), dtype=f32, device=dev)
    ms = cold_ms(lambda: pivot._launch(binv, triple, rho, scal, r32, bout, rout), flush)
    idle = cold_ms(lambda: pivot._launch(binv, triple, rho, scal, r32, bout, rout), flush,
                   busy=False)
    wrapper = cold_ms(lambda: fused_pivot_update(binv, triple, rho, abar_r, one, r), flush)
    plain = cold_ms(lambda: fused_pivot_update_reference(
        binv, triple, rho, abar_r, one, r), flush)
    lib = cold_ms(library, flush)
    nbytes = 4 * (2 * M * M + 3 * M + M + 2 + 3 * M)
    b_ms, b_by = bound(nbytes, 8 * M * M)
    print(f"K2 fused_pivot_update m={M}: max|err|={err:.3e}, gate=0 bit-exact; "
          f"kernel {ms * 1e3:.1f} us (from an idle stream {idle * 1e3:.1f} us), "
          f"wrapper {wrapper * 1e3:.1f} us, "
          f"plain {plain * 1e3:.1f} us, library "
          f"{lib * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}, "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    return {"name": "K2 fused_pivot_update", "route": "cuda",
            "source": "clp_tpu_torch/csrc/pivot.cu",
            "replaces": "clp_tpu/ops/pallas_pivot.py:96",
            "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def check_k3(dev, flush, Gs, blk):
    """K3 on the main path's block form, with the inputs of check_k1 in the
    sorted column order, held against its plain version and against the
    dense product rho @ G over the same sorted columns."""
    from clp_tpu_torch.ops import price
    from clp_tpu_torch.ops.price import (
        price_and_ratios_block,
        price_and_ratios_block_reference,
    )

    starts, W, m8 = blk
    nb, H, CB = W.shape
    ntp = nb * CB
    rng = np.random.default_rng(0)
    f32 = torch.float32
    rho = torch.as_tensor(rng.standard_normal(M), dtype=f32, device=dev)
    rho_p = torch.nn.functional.pad(rho, (0, m8 - M))
    dj = torch.as_tensor(np.abs(rng.standard_normal(ntp)), dtype=f32, device=dev)
    elig = torch.as_tensor(rng.uniform(size=ntp) < 0.7, device=dev)
    sgn = torch.as_tensor(np.where(rng.uniform(size=ntp) < 0.5, 1.0, -1.0),
                          dtype=f32, device=dev)
    sigma = torch.ones((), dtype=f32, device=dev)
    rel, ptol = 5e-8, 1e-9
    elig32 = elig.to(torch.int32)
    a_k, r_k = price_and_ratios_block(rho_p, starts, W, dj, elig, sgn, sigma, rel, ptol)
    a_p, r_p = price_and_ratios_block_reference(rho_p, starts, W, dj, elig32, sgn,
                                                sigma, rel, ptol)
    dense = rho @ Gs
    torch.cuda.synchronize()
    a_k, r_k, a_p, r_p, dense = (t.cpu().numpy() for t in (a_k, r_k, a_p, r_p, dense))
    # K1's tolerances: f32 sums in another order
    np.testing.assert_allclose(a_k, a_p, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(a_k[:NT], dense, rtol=2e-5, atol=2e-5)
    agree = float((np.isfinite(r_k) == np.isfinite(r_p)).mean())
    if agree <= 0.99:
        raise AssertionError(f"K3 ratio finiteness agreement {agree} <= 0.99")
    both = np.isfinite(r_k) & np.isfinite(r_p)
    np.testing.assert_allclose(r_k[both], r_p[both], rtol=2e-4, atol=2e-4)
    err = float(np.abs(a_k - a_p).max())

    rows = starts.to(torch.int64)[:, None] + torch.arange(H, device=dev)

    def library():
        alpha = torch.bmm(rho_p[rows][:, None, :], W)[:, 0, :].reshape(-1)
        a = sigma * alpha
        ok = elig & (a.abs() > ptol) & (sgn * a > 0)
        return alpha, torch.where(ok, (dj + sgn * rel) / torch.where(ok, a, 1.0), torch.inf)

    out = torch.empty((2, ntp), dtype=f32, device=dev)
    starts32 = starts.to(torch.int32)
    sig1 = sigma.reshape(1)
    ms = cold_ms(lambda: price._launch_block(rho_p, starts32, W, dj, elig32, sgn, sig1,
                                             rel, ptol, out), flush)
    idle = cold_ms(lambda: price._launch_block(rho_p, starts32, W, dj, elig32, sgn, sig1,
                                               rel, ptol, out), flush, busy=False)
    wrapper = cold_ms(lambda: price_and_ratios_block(
        rho_p, starts, W, dj, elig, sgn, sigma, rel, ptol), flush)
    plain = cold_ms(lambda: price_and_ratios_block_reference(
        rho_p, starts, W, dj, elig32, sgn, sigma, rel, ptol), flush)
    lib = cold_ms(library, flush)
    nbytes = 4 * (nb * H * CB + m8 + nb + 3 * ntp + 1) + 4 * 2 * ntp
    b_ms, b_by = bound(nbytes, 2 * nb * H * CB + 6 * ntp)
    print(f"K3 price_and_ratios_block nb={nb} H={H} CB={CB} m8={m8}: "
          f"max|alpha err|={err:.3e} ratio finiteness agreement={agree:.5f}; "
          f"kernel {ms * 1e3:.1f} us (from an idle stream {idle * 1e3:.1f} us), "
          f"wrapper {wrapper * 1e3:.1f} us, "
          f"plain {plain * 1e3:.1f} us, library {lib * 1e3:.1f} us, "
          f"bound {b_ms * 1e3:.2f} us ({b_by}, {nbytes / 1e6:.2f} MB)", flush=True)
    return {"name": "K3 price_and_ratios_block", "route": "cuda",
            "source": "clp_tpu_torch/csrc/price_block.cu",
            "replaces": "clp_tpu/ops/pallas_price.py:205",
            "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def highs_objective(model) -> float:
    from scipy.optimize import Bounds, LinearConstraint, milp

    lc = LinearConstraint(model.matrix.tocsc(), np.maximum(model.row_lower, -1e30),
                          np.minimum(model.row_upper, 1e30))
    bnd = Bounds(np.maximum(model.col_lower, -1e30), np.minimum(model.col_upper, 1e30))
    res = milp(model.objective, constraints=lc, bounds=bnd)
    if not res.success:
        raise AssertionError(f"HiGHS failed on the reference LP: {res.message}")
    return float(res.fun)


def main_path(label: str, use_k2: bool, price_mode: str = "auto") -> dict:
    """One solve of the staircase through the port's public entry point,
    with the launch counts of exactly this run; checked for status, KKT and
    the kernels its route must (and must not) launch here, against HiGHS
    by the caller."""
    from clp_tpu_torch import SolveOptions, check_kkt, initial_solve
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.ops.pivot import fused_pivot_update
    from clp_tpu_torch.ops.price import price_and_ratios, price_and_ratios_block

    model = staircase_model()
    opts = SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device="cuda",
                        use_pallas_pivot=use_k2, price_mode=price_mode)
    price_and_ratios.launches = 0
    fused_pivot_update.launches = 0
    price_and_ratios_block.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = initial_solve(model, opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": price_and_ratios.launches, "K2": fused_pivot_update.launches,
                "K3": price_and_ratios_block.launches}
    if sol.status != ProblemStatus.OPTIMAL:
        raise AssertionError(f"{label}: status {sol.status!r}, expected OPTIMAL")
    rep = check_kkt(model, x=sol.primal, y=sol.duals, tol=1e-6)
    if not rep.ok:
        raise AssertionError(f"{label}: KKT check failed: {rep}")
    # the block route prices through K3 and never K1; the dense route the reverse
    pricer, other = ("K3", "K1") if price_mode == "block" else ("K1", "K3")
    if launches[pricer] <= 0 or launches[other] != 0 or (use_k2 and launches["K2"] <= 0):
        raise AssertionError(f"{label}: wrong kernels launched on the main path: {launches}")
    stats = sol.timings.get("factorization_stats", {})
    print(f"main path [{label}]: OPTIMAL obj={sol.objective_value!r}, KKT ok, "
          f"iterations={sol.iterations}, wall={wall:.3f} s, "
          f"pivots/s={sol.iterations / wall:.1f}, launches={launches}, "
          f"factorizations={stats.get('factorizations')}, "
          f"solve phases={ {k: round(v, 3) for k, v in sol.timings.items() if isinstance(v, float)} }",
          flush=True)
    return {"label": label, "launches": launches, "objective": sol.objective_value}


def profile_pivots(dev, route: str, pivots: int = 200) -> None:
    """Where a pivot's time goes on the card.

    Runs the engine's own chunk loop (`_pivot_chunk`: blocks of 8 gated
    pivots, one host status check per block) as the driver configures it on
    the card for the unscaled staircase (f32 inverse, K1 or on the block
    route K3, BFRT), for two windows of up to `pivots` pivots, each from a
    fresh refactorization: the first timed plainly, the second under
    torch.profiler. Prints wall per pivot, device busy time per pivot (the
    union of kernel intervals), kernel launches per pivot, the kernels that
    take the most device time, and one refactorization's wall.
    """
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from clp_tpu_torch.forms import to_standard_form
    from clp_tpu_torch.simplex import driver, engine

    model = staircase_model()
    lp, _ = to_standard_form(model, device=dev)
    opts = engine.SimplexOptions(inverse_dtype="float32", use_pallas_price=True,
                                 dual_ratio="bfrt", refactor_frequency=800, inner_unroll=8)
    start = engine.initial_state(lp, opts)
    if route == "block":
        # as the driver runs it: columns sorted by window once, the state
        # relabelled, the block geometry of its probe
        nb, H, CB, perm = driver.block_geometry(model)
        perm = torch.as_tensor(perm, device=dev)
        lp0, lp = lp, dataclasses.replace(
            lp, G=lp.G.index_select(1, perm), c=lp.c.index_select(0, perm),
            l=lp.l.index_select(0, perm), u=lp.u.index_select(0, perm))
        start = driver._sorted_state(start, perm, torch.argsort(perm))
        opts = dataclasses.replace(opts, price_mode="block", price_block_nb=nb,
                                   price_block_h=H, price_block_cb=CB)
    step = engine._dual_iteration_fn(lp, opts)

    def chunk(st, n):
        """Up to n pivots; returns (state, pivots made, seconds)."""
        it0 = int(st.iterations)
        t0 = time.perf_counter()
        st = engine._pivot_chunk(lp, st, dataclasses.replace(opts, refactor_frequency=n), step)
        torch.cuda.synchronize()
        return st, int(st.iterations) - it0, time.perf_counter() - t0

    def refactor(st):
        t0 = time.perf_counter()
        st = engine.recompute(lp, st, opts.dual_bound)
        torch.cuda.synchronize()
        return st, 1e3 * (time.perf_counter() - t0)

    st, _ = refactor(start)
    st, _, _ = chunk(engine.make_dual_feasible(lp, st, opts), 16)  # warm-up
    st, refactor_ms = refactor(st)
    st, n_plain, wall_plain = chunk(st, pivots)
    st, _ = refactor(st)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        st, n, wall = chunk(st, pivots)
    if n_plain <= 0 or n <= 0:
        raise AssertionError(f"profile windows made {n_plain} and {n} pivots")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of kernel intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.elapsed_us()
        rec[1] += 1
    table = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    PROFILE_DIR.mkdir(parents=True, exist_ok=True)
    (PROFILE_DIR / f"profile_{route}.txt").write_text("".join(
        f"{t / n:10.2f} us/pivot {c / n:7.2f} launches/pivot  {name}\n"
        for name, (t, c) in table))
    top = [(name, t) for name, (t, _) in table[:10]]
    wall_us = 1e6 * wall / n
    pricer = "K3, price_mode=block" if route == "block" else "K1"
    print(f"pivot profile [{route}] (unscaled staircase, f32 inverse + {pricer} + BFRT, "
          f"blocks of 8; "
          f"{n_plain} + {n} pivots after a refactorization): wall "
          f"{1e6 * wall_plain / n_plain:.1f} us/pivot, {wall_us:.1f} us/pivot under the "
          f"profiler; device busy {busy / n:.1f} us/pivot "
          f"({100 * busy / n / wall_us:.1f}% of the profiled wall), "
          f"{len(kernels) / n:.1f} kernel launches/pivot; one refactorization "
          f"{refactor_ms:.1f} ms; top device time per pivot (us): "
          + "; ".join(f"{name[:90]} = {t / n:.1f}" for name, t in top)
          + f" (every kernel: build/profiles/profile_{route}.txt)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from clp_tpu_torch.ops import build

    dev = torch.device("cuda")
    smi = nvidia_smi()
    nvcc = subprocess.run([build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip().splitlines()[-1]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {nvcc}", flush=True)
    t0 = time.perf_counter()
    logs = build.build_all(["price", "pivot", "price_block"])
    print(f"built kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}.cu ptxas: {line.strip()}")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    G32 = staircase_g32(dev)
    k1 = check_k1(dev, flush, G32)
    k2 = check_k2(dev, flush, G32)
    k3 = check_k3(dev, flush, *staircase_blocks(dev, G32))
    del flush, G32

    run_k1 = main_path("K1", False)
    run_k2 = main_path("K1+K2", True)
    run_k3 = main_path("block, K3", False, price_mode="block")
    k1["launches"] = run_k1["launches"]["K1"]
    k2["launches"] = run_k2["launches"]["K2"]
    k3["launches"] = run_k3["launches"]["K3"]
    # HiGHS after the solves: its worker threads share the host's cores
    highs_obj = highs_objective(staircase_model())
    for run in (run_k1, run_k2, run_k3):
        if not abs(run["objective"] - highs_obj) <= 1e-6 * (1 + abs(highs_obj)):
            raise AssertionError(f"{run['label']}: objective {run['objective']!r} "
                                 f"vs HiGHS {highs_obj!r}")
    print(f"HiGHS objective {highs_obj!r}: all three main-path runs agree within "
          f"1e-6 * (1 + |obj|)", flush=True)
    # each in a process of its own: torch.profiler leaves state behind that
    # slows the host side of its process, and the same pivots ran slower
    # after the solves above than in a fresh process
    for route in ("dense", "block"):
        subprocess.run([sys.executable, __file__, "--profile-pivots", route],
                       check=True, timeout=600)
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "wrapper_ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in (k1, k2, k3)]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_main(route: str) -> int:
    """`chip_smoke.py --profile-pivots dense|block`: one profile phase alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    profile_pivots(torch.device("cuda"), route)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--profile-pivots" and args[1] in ("dense", "block"):
        sys.exit(profile_main(args[1]))
    sys.exit(main())
