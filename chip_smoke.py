"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from clp_tpu_torch/csrc (nvcc, sm_90a, one
process per source, all started together), holds each kernel against its
plain PyTorch version at the main path's shapes and times both (each
also for bit-identical results over 10 launches, K2 and K3 beside the
device-side floor of an empty launch; K2 also at the wide m = 14,465
(odd: rows not 16-byte aligned), 16,384 and 24,576, one launch each),
then solves
the 2048 x 4608 staircase LP end to end through
`initial_solve(method=DUAL_SIMPLEX, device="cuda")` three times — with K1,
with K1 + K2, and on the block-banded route `price_mode="block"` with K3 —
and checks each answer against the port's KKT check and HiGHS
(scipy.optimize.milp). Then the barrier: it asserts on each LP's IPM form
the Newton branch the port's own planners pick (`_rcm_band_plan`,
`make_device_normal_solver`, `_auto_method`), times one factorization of
that branch (its launches are counted under torch.profiler after the last
phase, since a traced process launches more slowly), and solves three LPs against HiGHS
— the staircase with `method=BARRIER` (banded normal equations, nb = 256,
then the crossover's dual simplex through K1), `random_lp(1024, 1792,
density=0.05)` with `method=BARRIER` (dense mixed32 normal equations, then
the crossover) and a 4096 x 8192 window LP with the default AUTOMATIC
(BARRIER_NO_CROSS on the device multifrontal Cholesky). Then the
AUTOMATIC destinations (`auto_phase`): six LPs through the default
`initial_solve`, each asserted to take its route — a covering LP the
idiot-warm dual, a wide LP SPRINT, a tall LP its dual, a min-cost flow
NETWORK, a GUB LP GUB, a large sparse LP PDLP with `crunch_polish` — and
checked against HiGHS. Then the solve-level QP and the single-model
solvers (`nonlinear_phase`): the staircase with a diagonal Q through
AUTOMATIC (BARRIER_NO_CROSS, banded with q_diag), a 2048-asset portfolio
QP through AUTOMATIC (the dense (nt, nt) Newton branch) and through the
QP simplex, which must agree, each held to the port's KKT check and its
peak device memory printed; piecewise costs in the engine on the host and
reformulated on the card, against HiGHS; SLP driven by torch.autograd,
its LP sub-solves on the card; the dynamic matrix over an explicit
universe against HiGHS, and one cutting-stock LP by column generation
and by the dynamic matrix (`chip_smoke.py --nonlinear` runs this phase
alone). Then `batch_phase`: ELL pricing on the staircase and the Positive Edge
rules, the batched dual simplex on bench.py's batches, a 10,240-scenario
sweep (5,120 in the no-argument run) and a batch of 16 LPs, the batched IPM (dense and banded), the
batched QP simplex on a risk sweep, racing by seeds and by configurations,
DECOMPOSE through AUTOMATIC and Dantzig-Wolfe, and the IIS, each route
asserted and held to HiGHS or to its single solve; `chip_smoke.py --batch`
runs it alone with PE, the batch of 16, racing and the IIS on the bench LP
(the no-argument run cuts those to a 512-row LP for its time, which
keeps each route, `BP_CUTS`). Then `api_phase` (`--api` alone), the surfaces a Clp user
touches, on the staircase: written as MPS and read back through the native
C++ parser, solved by the port's `clp` command line (K1 on every pivot)
with basis and solution files out and again warm from the basis file,
LP-format and NL round trips, ranging on the card with each gated range
checked by a warm re-solve, the parametric walker against HiGHS, OSI's
hot starts and a tableau column, strong branching (16 lanes), `fathom` on
a 0-1 knapsack against HiGHS, the C API's C client and `python -m
clp_tpu_torch -unitTest` in subprocesses on the card. Then `mesh_phase`
(`--mesh` alone), shape buckets and the device mesh: the staircase
bucketed to 2560 x 5120 through the dual simplex (K1 on every pivot) and
the barrier with crossover, the column-sharded dual engine on the bench
LP, SPRINT over a "block" mesh, bench.py's batches, the B = 64 IPM batch
and the risk sweep over a 4-entry "scenario" mesh (lane by lane against
the unsharded batch), racing over 3 devices and the port's multi-device
dry run; every mesh entry is the one card, so no copy between devices is
timed. The kernels and the main paths run alone; the six phases after
them run in four child processes started together (`PHASE_GROUPS`,
`chip_smoke.py --phases`; their logs are printed in turn once all have
ended, and a child that fails, or runs past `CHILD_DEADLINE_S`, stops the
others and fails the run). It prints the wall of every phase before the
kernels line. Every phase that fails exits non-zero. The profiles run apart, each in a fresh process
(`chip_smoke.py --profile-pivots dense|block|batch`): 200 pivots of the
engine on the dense route and on the block route, and one wide batch.
`chip_smoke.py --profiler-cost` times the staircase's solve before and
after one torch.profiler trace in one process; `chip_smoke.py
--race-configs` times racing's configurations alone and raced.

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
    f32, f64 = torch.float32, torch.float64
    rho = torch.as_tensor(rng.standard_normal(M), dtype=f32, device=dev)
    # dj, sgn and sigma in f64 and the mask as bool, as the engine hands them over
    dj = torch.as_tensor(np.abs(rng.standard_normal(NT)), dtype=f64, device=dev)
    elig = torch.as_tensor(rng.uniform(size=NT) < 0.7, device=dev)
    sgn = torch.as_tensor(np.where(rng.uniform(size=NT) < 0.5, 1.0, -1.0),
                          dtype=f64, device=dev)
    sigma = torch.ones((), dtype=f64, device=dev)
    rel, ptol = 5e-8, 1e-9
    # the plain version's inputs: the same values as the kernel reads them
    plain_in = (rho, G, dj.to(f32), elig.to(torch.int32), sgn.to(f32), sigma.to(f32))
    a_k, r_k = price_and_ratios(rho, G, dj, elig, sgn, sigma, rel, ptol)
    a_p, r_p = price_and_ratios_reference(*plain_in, rel, ptol)
    torch.cuda.synchronize()
    err, agree = assert_price_close("K1", a_k, r_k, a_p, r_p)

    def library():
        alpha = rho @ G
        d, s, sig = plain_in[2], plain_in[4], plain_in[5]
        a = sig * alpha
        ok = elig & (a.abs() > ptol) & (s * a > 0)
        return alpha, torch.where(ok, (d + s * rel) / torch.where(ok, a, 1.0), torch.inf)

    out = torch.empty((2, NT), dtype=f32, device=dev)
    vecs = price._kernel_vecs(dj, elig, sgn, sigma, dev)

    def launch():
        price._launch(rho, G, *vecs, rel, ptol, out)
        return out

    det = assert_deterministic("K1", launch)
    ms = cold_ms(launch, flush)
    idle = cold_ms(launch, flush, busy=False)
    wrapper = cold_ms(lambda: price_and_ratios(rho, G, dj, elig, sgn, sigma, rel, ptol), flush)
    plain = cold_ms(lambda: price_and_ratios_reference(*plain_in, rel, ptol), flush)
    lib = cold_ms(library, flush)
    nbytes = tensor_bytes(rho, G, *vecs[:4], out)
    b_ms, b_by = bound(nbytes, 2 * M * NT + 6 * NT)
    plan = price.k1_plan(M, NT, torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"K1 price_and_ratios m={M} nt={NT} ({plan.tiles} tiles x {plan.splits} splits "
          f"= {plan.grid} blocks): max|alpha err|={err:.3e} "
          f"ratio finiteness agreement={agree:.5f}, {det}; kernel {ms * 1e3:.1f} us "
          f"(from an idle stream {idle * 1e3:.1f} us), wrapper {wrapper * 1e3:.1f} us, "
          f"plain {plain * 1e3:.1f} us, library {lib * 1e3:.1f} us, "
          f"bound {b_ms * 1e3:.1f} us ({b_by}, {nbytes / 1e6:.1f} MB), "
          f"{100 * b_ms / ms:.1f}% of the bound", flush=True)
    return {"name": "K1 price_and_ratios", "route": "cuda",
            "source": "clp_tpu_torch/csrc/price.cu",
            "replaces": "clp_tpu/ops/pallas_price.py:110",
            "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def tensor_bytes(*ts) -> int:
    """Bytes of the tensors: each input read once, each output written once."""
    return sum(t.numel() * t.element_size() for t in ts)


def assert_price_close(name, a_k, r_k, a_p, r_p) -> tuple[float, float]:
    """The tolerances of tests/test_pallas.py (f32 sums in another order);
    returns the largest alpha difference and the ratio finiteness agreement."""
    a_k, r_k, a_p, r_p = (t.cpu().numpy() for t in (a_k, r_k, a_p, r_p))
    np.testing.assert_allclose(a_k, a_p, rtol=2e-5, atol=2e-5)
    agree = float((np.isfinite(r_k) == np.isfinite(r_p)).mean())
    if agree <= 0.99:
        raise AssertionError(f"{name} ratio finiteness agreement {agree} <= 0.99")
    both = np.isfinite(r_k) & np.isfinite(r_p)
    np.testing.assert_allclose(r_k[both], r_p[both], rtol=2e-4, atol=2e-4)
    return float(np.abs(a_k - a_p).max()), agree


def assert_deterministic(name, launch, reps: int = 10) -> str:
    """`reps` launches on the same inputs must give the same bits; `launch`
    returns its output tensor or a tuple of them."""
    def bits(out):
        return [t.view(torch.int32).clone() for t in (out if isinstance(out, tuple) else (out,))]

    first = bits(launch())
    for i in range(1, reps):
        if not all(torch.equal(a, b) for a, b in zip(bits(launch()), first)):
            raise AssertionError(f"{name}: launch {i + 1} differs in its bits from launch 1")
    return f"{reps} launches bit-identical"


def k2_library(binv, triple, rho, abar_r):
    """One PyTorch call for each step of K2's function (a skinny matmul, a
    division and `addr_` on a copy of binv): the library yardstick."""
    scratch = binv.clone()
    factor = torch.empty(binv.shape[0], dtype=binv.dtype, device=binv.device)

    def library():
        R = binv @ triple
        torch.div(R[:, 0], abar_r, out=factor)
        return scratch.addr_(factor, rho, alpha=-1.0), R
    return library


def k2_bytes(m: int) -> int:
    """K2's bytes: binv read and binv' written, triple, rho, res, scal."""
    return 4 * (2 * m * m + 3 * m + m + 2 + 3 * m)


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
    scal = torch.stack([1.0 / abar_r, one])
    r32 = r.to(torch.int32).reshape(1)
    bout = torch.empty_like(binv)
    rout = torch.empty((M, 3), dtype=f32, device=dev)

    def launch():
        pivot._launch(binv, triple, rho, scal, r32, bout, rout)
        return bout, rout

    det = assert_deterministic("K2", launch)
    ms = cold_ms(launch, flush)
    idle = cold_ms(launch, flush, busy=False)
    floor = cold_ms(lambda: torch.cuda._sleep(0), flush)
    wrapper = cold_ms(lambda: fused_pivot_update(binv, triple, rho, abar_r, one, r), flush)
    plain = cold_ms(lambda: fused_pivot_update_reference(
        binv, triple, rho, abar_r, one, r), flush)
    lib = cold_ms(k2_library(binv, triple, rho, abar_r), flush)
    nbytes = k2_bytes(M)
    b_ms, b_by = bound(nbytes, 8 * M * M)
    plan = pivot.k2_plan(M, torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"K2 fused_pivot_update m={M} (clusters of {plan.cluster} x {plan.slice_cols} "
          f"columns, tiles of {plan.tile_rows} rows, {plan.stages} stages): "
          f"max|err|={err:.3e}, gate=0 bit-exact, {det}; "
          f"kernel {ms * 1e3:.1f} us (from an idle stream {idle * 1e3:.1f} us), "
          f"wrapper {wrapper * 1e3:.1f} us, "
          f"plain {plain * 1e3:.1f} us, library "
          f"{lib * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}, "
          f"{nbytes / 1e6:.1f} MB), {100 * b_ms / ms:.1f}% of the bound, "
          f"{100 * b_ms / (ms - floor):.1f}% above the launch floor "
          f"({floor * 1e3:.2f} us)", flush=True)
    return {"name": "K2 fused_pivot_update", "route": "cuda",
            "source": "clp_tpu_torch/csrc/pivot.cu",
            "replaces": "clp_tpu/ops/pallas_pivot.py:96",
            "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib, "launch_floor_ms": floor}


def check_k2_wide(dev, flush, m: int) -> dict:
    """K2 at a wide m (14,465 is odd, so its rows are not 16-byte aligned;
    16,384 and 24,576 are past what 4 rows of binv in one block's shared
    memory could hold): one counted launch, held against the plain version
    with gate 1 and gate 0, the same bits over 10 launches, and its time
    against the byte bound (binv read once and binv' written once, plus the
    small vectors)."""
    from clp_tpu_torch.ops import pivot
    from clp_tpu_torch.ops.pivot import fused_pivot_update, fused_pivot_update_reference

    f32 = torch.float32
    g = torch.Generator(device=dev).manual_seed(m)
    # unit-norm rows, as in check_k2; g_q near rho so that the pivot
    # element abar_r = rho . g_q is near 1, and a flip flow of N(0, 1)
    binv = torch.randn(m, m, generator=g, device=dev, dtype=f32) / m ** 0.5
    r = torch.tensor(m // 3, device=dev)
    rho = binv[m // 3].clone()
    gq = rho + torch.randn(m, generator=g, device=dev, dtype=f32) / m ** 0.5
    triple = torch.stack([gq, rho, torch.randn(m, generator=g, device=dev, dtype=f32)],
                         dim=1).contiguous()
    abar_r = torch.dot(rho, gq)
    one = torch.ones((), dtype=f32, device=dev)
    n0 = fused_pivot_update.launches
    bn, res = fused_pivot_update(binv, triple, rho, abar_r, one, r)
    if fused_pivot_update.launches != n0 + 1:
        raise AssertionError(f"K2 at m={m}: {fused_pivot_update.launches - n0} launches "
                             f"counted for one call")
    bp, rp = fused_pivot_update_reference(binv, triple, rho, abar_r, one, r)
    torch.cuda.synchronize()
    # sums of m products of unit-norm rows in two orders: a few f32 spacings
    err = max(float((bn - bp).abs().max()), float((res - rp).abs().max()))
    del bp, rp, bn, res
    if not err < 1e-4:
        raise AssertionError(f"K2 at m={m} differs from its plain version by {err}")
    bn0, _ = fused_pivot_update(binv, triple, rho, abar_r, 0.0 * one, r)
    if not torch.equal(bn0, binv):
        raise AssertionError(f"K2 at m={m} with gate = 0 changed binv")
    del bn0
    scal = torch.stack([1.0 / abar_r, one])
    r32 = r.to(torch.int32).reshape(1)
    bout = torch.empty_like(binv)
    rout = torch.empty((m, 3), dtype=f32, device=dev)

    def launch():
        pivot._launch(binv, triple, rho, scal, r32, bout, rout)
        return bout, rout

    det = assert_deterministic(f"K2 at m={m}", launch)
    ms = cold_ms(launch, flush)
    plain = cold_ms(lambda: fused_pivot_update_reference(binv, triple, rho, abar_r, one, r),
                    flush)
    lib = cold_ms(k2_library(binv, triple, rho, abar_r), flush)
    nbytes = k2_bytes(m)
    b_ms, b_by = bound(nbytes, 8 * m * m)
    plan = pivot.k2_plan(m, torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"K2 fused_pivot_update m={m} (clusters of {plan.cluster} x {plan.slice_cols} "
          f"columns, tiles of {plan.tile_rows} rows, {plan.stages} stages): one launch, "
          f"max|err|={err:.3e}, gate=0 bit-exact, {det}; "
          f"kernel {ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, library {lib * 1e3:.1f} us, "
          f"bound {b_ms * 1e3:.1f} us ({b_by}, {nbytes / 1e6:.1f} MB), "
          f"{100 * b_ms / ms:.1f}% of the bound", flush=True)
    return {"m": m, "max_abs_err": err, "ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": b_ms, "bound_by": b_by}


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
    f32, f64 = torch.float32, torch.float64
    rho = torch.as_tensor(rng.standard_normal(M), dtype=f32, device=dev)
    rho_p = torch.nn.functional.pad(rho, (0, m8 - M))
    # as the engine hands them over: dj, sgn and sigma in f64, the mask as
    # bool, all three vectors unpadded (NT columns of the ntp = nb * CB)
    dj = torch.as_tensor(np.abs(rng.standard_normal(NT)), dtype=f64, device=dev)
    elig = torch.as_tensor(rng.uniform(size=NT) < 0.7, device=dev)
    sgn = torch.as_tensor(np.where(rng.uniform(size=NT) < 0.5, 1.0, -1.0),
                          dtype=f64, device=dev)
    sigma = torch.ones((), dtype=f64, device=dev)
    rel, ptol = 5e-8, 1e-9
    pad = ntp - NT
    plain_in = (rho_p, starts, W, torch.nn.functional.pad(dj.to(f32), (0, pad)),
                torch.nn.functional.pad(elig.to(torch.int32), (0, pad)),
                torch.nn.functional.pad(sgn.to(f32), (0, pad), value=1.0), sigma.to(f32))
    a_k, r_k = price_and_ratios_block(rho_p, starts, W, dj, elig, sgn, sigma, rel, ptol)
    a_p, r_p = price_and_ratios_block_reference(*plain_in, rel, ptol)
    dense = rho @ Gs
    torch.cuda.synchronize()
    err, agree = assert_price_close("K3", a_k, r_k, a_p, r_p)
    np.testing.assert_allclose(a_k[:NT].cpu().numpy(), dense.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)

    rows = starts.to(torch.int64)[:, None] + torch.arange(H, device=dev)
    plain_vecs = plain_in[3:6]

    def library():
        alpha = torch.bmm(rho_p[rows][:, None, :], W)[:, 0, :].reshape(-1)
        a = sigma * alpha
        d, e, s = plain_vecs
        ok = (e != 0) & (a.abs() > ptol) & (s * a > 0)
        return alpha, torch.where(ok, (d + s * rel) / torch.where(ok, a, 1.0), torch.inf)

    out = torch.empty((2, ntp), dtype=f32, device=dev)
    starts32 = starts.to(torch.int32)
    vecs = price._kernel_vecs(dj, elig, sgn, sigma, dev)

    def launch():
        price._launch_block(rho_p, starts32, W, *vecs, rel, ptol, out)
        return out

    det = assert_deterministic("K3", launch)
    ms = cold_ms(launch, flush)
    idle = cold_ms(launch, flush, busy=False)
    # the device-side floor of any launch: an empty kernel timed the same way
    floor = cold_ms(lambda: torch.cuda._sleep(0), flush)
    wrapper = cold_ms(lambda: price_and_ratios_block(
        rho_p, starts, W, dj, elig, sgn, sigma, rel, ptol), flush)
    plain = cold_ms(lambda: price_and_ratios_block_reference(*plain_in, rel, ptol), flush)
    lib = cold_ms(library, flush)
    nbytes = tensor_bytes(rho_p, starts32, W, *vecs[:4], out)
    b_ms, b_by = bound(nbytes, 2 * nb * H * CB + 6 * ntp)
    plan = price.k3_plan(nb, H, CB)
    print(f"K3 price_and_ratios_block nb={nb} H={H} CB={CB} m8={m8} ({plan.grid} blocks of "
          f"{plan.tile_cols} columns): "
          f"max|alpha err|={err:.3e} ratio finiteness agreement={agree:.5f}, {det}; "
          f"kernel {ms * 1e3:.2f} us (from an idle stream {idle * 1e3:.1f} us; "
          f"launch floor, torch.cuda._sleep(0), {floor * 1e3:.2f} us), "
          f"wrapper {wrapper * 1e3:.1f} us, "
          f"plain {plain * 1e3:.1f} us, library {lib * 1e3:.1f} us, "
          f"bound {b_ms * 1e3:.2f} us ({b_by}, {nbytes / 1e6:.2f} MB), "
          f"{100 * b_ms / ms:.1f}% of the bound", flush=True)
    return {"name": "K3 price_and_ratios_block", "route": "cuda",
            "source": "clp_tpu_torch/csrc/price_block.cu",
            "replaces": "clp_tpu/ops/pallas_price.py:205",
            "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib, "launch_floor_ms": floor}


def highs_objective(model, ipm: bool = False) -> float:
    """HiGHS's optimum of the model: its dual simplex through
    `scipy.optimize.milp`, or with `ipm` its interior point with crossover
    through `linprog(method="highs-ipm")` (three times faster than its
    simplex on the dense-ish random LP)."""
    from scipy.optimize import Bounds, LinearConstraint, linprog, milp

    rl, ru = np.maximum(model.row_lower, -1e30), np.minimum(model.row_upper, 1e30)
    cl, cu = np.maximum(model.col_lower, -1e30), np.minimum(model.col_upper, 1e30)
    if ipm:
        import scipy.sparse as sp

        A = model.matrix.tocsr()
        eq = rl == ru
        up, lo = ~eq & (ru < 1e30), ~eq & (rl > -1e30)
        res = linprog(model.objective, A_ub=sp.vstack([A[up], -A[lo]]),
                      b_ub=np.concatenate([ru[up], -rl[lo]]), A_eq=A[eq], b_eq=rl[eq],
                      bounds=np.stack([cl, cu], axis=1), method="highs-ipm")
    else:
        res = milp(model.objective, constraints=LinearConstraint(model.matrix.tocsc(), rl, ru),
                   bounds=Bounds(cl, cu))
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
    return {"label": label, "launches": launches, "objective": sol.objective_value,
            "iterations": sol.iterations}


def window_lp(m: int, ncols: int, win: int, seed: int):
    """Local-window LP with sporadic long-range skips: sparse normal
    equations that are not banded under RCM (the general-sparse case).
    The generator of tests/test_sparse_chol.py, building a port Model."""
    import scipy.sparse as sp

    from clp_tpu_torch import Model

    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(m):
        base = int(i * (ncols - win) / m)
        for j in base + rng.choice(win, 12, replace=False):
            rows.append(i), cols.append(j), vals.append(rng.normal())
        if rng.random() < 0.15:
            rows.append(i), cols.append(int(rng.integers(0, ncols))), vals.append(rng.normal())
    A = sp.csr_matrix((vals, (rows, cols)), shape=(m, ncols)).tocsc()
    b = A @ rng.random(ncols)
    model = Model()
    model.load_problem(A, np.zeros(ncols), np.full(ncols, 3.0), rng.normal(size=ncols),
                       b - rng.random(m), b + rng.random(m))
    return model


def barrier_models():
    """The barrier phase's three LPs: (label, model factory, method, the
    Newton branch expected, crossover?, KKT tolerance, HiGHS by its IPM?,
    other SolveOptions)."""
    from clp_tpu_torch.utils.generators import random_lp

    return [
        ("staircase", staircase_model, "BARRIER", "banded nb=256", True, 1e-6, False, {}),
        ("random 1024x1792", lambda: random_lp(1024, 1792, seed=0, density=0.05),
         "BARRIER", "dense mixed32", True, 1e-6, True, {}),
        # the card's f32 multifrontal IPM does not converge here (200
        # iterations, 104.9 s, PERF.md §5), and the simplex adjudicates from
        # scratch; its depth is cut to 20 IPM iterations for the script's
        # time (PERF.md §4)
        ("window 4096x8192", lambda: window_lp(4096, 8192, 40, 3),
         "AUTOMATIC", "device multifrontal", False, 1e-5, False,
         {"barrier_max_iterations": 20}),
    ]


def launches_of(fn) -> int:
    """Kernel launches of one call of fn on the card (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of fn to a synchronized device, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def barrier_branch(dev, label, model, branch) -> dict:
    """Assert on the LP's IPM form the branch the port's planners pick
    (`_rcm_band_plan`; `_barrier_plan`, which calls
    `make_device_normal_solver` on the card; `_auto_method`), and time one
    factorization of it (d = 1: the normal matrix G G' + reg)."""
    import dataclasses

    import scipy.sparse as sp

    from clp_tpu_torch import SolveOptions
    from clp_tpu_torch.constants import SolveMethod
    from clp_tpu_torch.forms import to_ipm_form
    from clp_tpu_torch.interior import IPMOptions, ipm_solve
    from clp_tpu_torch.ops.sparse_chol_device import DeviceNormalSolver
    from clp_tpu_torch.ops.linalg import block_tridiag_cholesky, chol_factor_reg
    from clp_tpu_torch.solve import _auto_method, _barrier_plan, _rcm_band_plan

    lp, _ = to_ipm_form(model, device="cpu")
    G = lp.G.numpy()
    m, nt = G.shape
    perm, nb = _rcm_band_plan(G)
    planned = _barrier_plan(G, IPMOptions(mixed32=True), dev)[1]
    reg = IPMOptions().reg_dual + 1e-12
    d = torch.ones(nt, dtype=torch.float64, device=dev)
    info = {"label": label, "m": m, "nt": nt, "nnz": int(np.count_nonzero(G))}
    if branch.startswith("banded"):
        if perm is None or f"banded nb={nb}" != branch or planned.band_nb != nb:
            raise AssertionError(f"{label}: RCM band plan gave nb={nb}, expected {branch}")
        # the block form ipm_solve assembles: rows in RCM order, padded
        # rows carrying an identity
        mpad = -(-m // nb) * nb
        Gb = torch.zeros((mpad, nt), dtype=torch.float64, device=dev)
        Gb[:m] = torch.as_tensor(G[np.ascontiguousarray(perm)], device=dev)
        Gb = Gb.reshape(-1, nb, nt)
        pad = (torch.arange(mpad, device=dev) >= m).to(torch.float64).reshape(-1, nb)
        A = (torch.bmm(Gb * d, Gb.mT) + torch.diag_embed(pad)
             + reg * torch.eye(nb, dtype=torch.float64, device=dev))
        E = torch.bmm(Gb[1:] * d, Gb[:-1].mT)

        def factor():
            return block_tridiag_cholesky(A, E)
    elif branch == "dense mixed32":
        if perm is not None or planned.sparse_chol_device is not None or not planned.mixed32:
            raise AssertionError(f"{label}: expected the dense normal equations, "
                                 f"got nb={nb}, {planned}")
        G32 = torch.as_tensor(G, dtype=torch.float32, device=dev)
        M32 = G32 @ G32.T
        s32 = torch.rsqrt(torch.diagonal(M32) + reg)
        Ms = M32 * s32[:, None] * s32[None, :] + torch.diag(reg * s32 * s32 + 1e-7)

        def factor():
            return chol_factor_reg(Ms)

        # the card's setting against the CPU's on this form: the IPM alone
        # with mixed32 and in f64 (ROADMAP.md queue 4)
        lp_dev = dataclasses.replace(lp, **{k: getattr(lp, k).to(dev)
                                            for k in ("G", "b", "c", "l", "u")})
        for m32 in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ipm_solve(lp_dev, IPMOptions(max_iter=200, mixed32=m32))
            secs = time.perf_counter() - t0
            info[f"ipm_{'mixed32' if m32 else 'f64'}"] = (int(res.iterations),
                                                         bool(res.converged), secs)
            print(f"barrier IPM alone [{label}, {'mixed32' if m32 else 'f64'}]: "
                  f"{int(res.iterations)} iterations, converged={bool(res.converged)}, "
                  f"{secs:.3f} s ({1e3 * secs / max(int(res.iterations), 1):.1f} ms/iteration), "
                  f"primal infeasibility {float(res.primal_infeas):.2e}, "
                  f"gap {float(res.rel_gap):.2e}", flush=True)
    else:
        auto = _auto_method(model, SolveOptions(device=dev.type))
        if perm is not None or planned.sparse_chol_device is None or \
                auto != SolveMethod.BARRIER_NO_CROSS:
            raise AssertionError(f"{label}: expected AUTOMATIC -> BARRIER_NO_CROSS on the "
                                 f"device multifrontal, got {auto!r}, nb={nb}")
        solver = planned.sparse_chol_device
        info["buckets"] = sum(1 for _ in solver.dev.buckets())
        info["levels"] = len(solver.dev.schedule)
        # the card's f32 factor against f64 on this form: the IPM alone on
        # the same plan in f64 (ROADMAP.md queue 4); the solve below runs f32
        lp_dev = dataclasses.replace(lp, **{k: getattr(lp, k).to(dev)
                                            for k in ("G", "b", "c", "l", "u")})
        f64 = DeviceNormalSolver(sp.csr_matrix(G), solver.plan, reg, torch.float64, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ipm_solve(lp_dev, IPMOptions(max_iter=200, sparse_chol_device=f64))
        secs = time.perf_counter() - t0
        info["ipm_f64"] = (int(res.iterations), bool(res.converged), secs)
        print(f"barrier IPM alone [{label}, device multifrontal f64]: "
              f"{int(res.iterations)} iterations, converged={bool(res.converged)}, "
              f"{secs:.3f} s ({1e3 * secs / max(int(res.iterations), 1):.1f} ms/iteration), "
              f"primal infeasibility {float(res.primal_infeas):.2e}, "
              f"gap {float(res.rel_gap):.2e}", flush=True)

        def factor():
            fstate, ok = solver.factor(d)
            if not bool(ok):
                raise AssertionError(f"{label}: multifrontal factor of G G' failed")
            return fstate

        (f1, _), (f2, _) = factor(), factor()
        if not all(torch.equal(a, b) for a, b in zip(f1, f2)):
            raise AssertionError(f"{label}: two factorizations differ in their bits")
        info["same_bits"] = True
    info["factor_ms"] = host_ms(factor)
    # its launches are counted after the last phase (`factor_launches`)
    info["factor"] = factor
    print(f"barrier branch [{label}]: IPM form {m} x {nt} ({info['nnz']} nonzeros), "
          f"{branch} as planned; one factorization {info['factor_ms']:.2f} ms"
          + (f" ({info['buckets']} buckets in {info['levels']} levels, "
             "2 factorizations bit-identical)" if "buckets" in info else ""), flush=True)
    return info


def factor_launches(runs) -> None:
    """Kernel launches of one factorization of each barrier branch, counted
    under torch.profiler after every other phase: once the profiler has
    traced the card, each later launch of the process costs more host time
    (PERF.md §6, PR 9), which slowed every phase after the barrier's."""
    for info in runs:
        n = launches_of(info.pop("factor"))
        print(f"barrier branch [{info['label']}]: one factorization {n} launches "
              f"(torch.profiler)", flush=True)


def barrier_path(dev, label, make, method, branch, crossover, kkt_tol, highs_ref,
                 kw) -> dict:
    """One barrier solve through the public entry point, with the launch
    counts of exactly this run; checked for status, KKT, the branch taken,
    the crossover's K1 and the objective against HiGHS."""
    from clp_tpu_torch import SolveOptions, check_kkt, initial_solve
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.ops.pivot import fused_pivot_update
    from clp_tpu_torch.ops.price import price_and_ratios, price_and_ratios_block

    model = make()
    opts = SolveOptions(method=SolveMethod[method], device=dev.type, **kw)
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
    stats = sol.timings.get("barrier_stats")
    if sol.status != ProblemStatus.OPTIMAL:
        raise AssertionError(f"barrier [{label}]: status {sol.status!r}, expected OPTIMAL")
    # an IPM that stops short is finished by the crossover (or, without
    # one, adjudicated by the simplex), as in the JAX package; the gates
    # are the answer's, below
    if stats is None or stats["branch"] != branch:
        raise AssertionError(f"barrier [{label}]: barrier stats {stats}, expected the "
                             f"{branch} branch")
    rep = check_kkt(model, x=sol.primal, y=sol.duals, tol=kkt_tol)
    if not rep.ok:
        raise AssertionError(f"barrier [{label}]: KKT check at {kkt_tol} failed: {rep}")
    # on the card the simplex that follows the IPM (the crossover, or the
    # adjudication of an IPM that did not converge) prices through K1
    # (dense route); no other kernel runs
    simplex = crossover or not stats["converged"]
    if (launches["K1"] > 0) != (simplex and dev.type == "cuda") or \
            launches["K2"] or launches["K3"]:
        raise AssertionError(f"barrier [{label}]: wrong kernels launched: {launches}")
    ref = highs_ref.result()
    if not abs(sol.objective_value - ref) <= 1e-6 * (1 + abs(ref)):
        raise AssertionError(f"barrier [{label}]: objective {sol.objective_value!r} "
                             f"vs HiGHS {ref!r}")
    pivots = sol.iterations if simplex else 0
    finish = "crossover" if crossover else "adjudication" if simplex else "no simplex"
    print(f"barrier path [{label}, {method}]: OPTIMAL obj={sol.objective_value!r} "
          f"(HiGHS {ref!r}), KKT ok at {kkt_tol}, {branch}; IPM {stats['iterations']} "
          f"iterations ({'converged' if stats['converged'] else 'NOT converged'}) "
          f"in {stats['seconds']:.3f} s "
          f"({1e3 * stats['seconds'] / max(stats['iterations'], 1):.1f} ms/iteration), "
          f"{finish} pivots={pivots}, solve wall={wall:.3f} s, launches={launches}, "
          f"phases={ {k: round(v, 3) for k, v in sol.timings.items() if isinstance(v, float)} }",
          flush=True)
    return {"label": label, "launches": launches, "ipm_iterations": stats["iterations"],
            "ipm_converged": stats["converged"], "ipm_seconds": stats["seconds"],
            "pivots": pivots, "wall": wall}


def barrier_phase(dev) -> list:
    """The barrier's branch checks, then its three solves against HiGHS,
    and AUTOMATIC's choice of the dual simplex for the staircase here."""
    from clp_tpu_torch import SolveOptions
    from clp_tpu_torch.constants import SolveMethod
    from clp_tpu_torch.solve import _auto_method

    auto = _auto_method(staircase_model(), SolveOptions(device=dev.type))
    if auto != SolveMethod.DUAL_SIMPLEX:
        raise AssertionError(f"AUTOMATIC chose {auto!r} for the staircase on the card, "
                             "expected DUAL_SIMPLEX")
    print(f"AUTOMATIC on the staircase ({dev.type}): {auto.name}", flush=True)
    runs = []
    specs = barrier_models()
    refs = HighsRefs("barrier phase", workers=len(specs))
    try:
        futures = [refs.reference(spec[1](), spec[6]) for spec in specs]
        for (label, make, method, branch, crossover, kkt_tol, _, kw), ref in zip(specs, futures):
            info = barrier_branch(dev, label, make(), branch)
            runs.append(info | barrier_path(dev, label, make, method, branch, crossover,
                                            kkt_tol, ref, kw))
    finally:
        refs.close()
    return runs


def covering_lp(m: int, n: int, seed: int = 0):
    """A 0/1 covering LP, wide and unit-valued: the idiot crash's shape.
    The generator of tests/test_torch_auto.py, building a port Model."""
    import scipy.sparse as sp

    from clp_tpu_torch import INF, Model

    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=0.01, random_state=seed, format="csc")
    A.data[:] = 1.0
    A = (A + sp.csc_matrix((np.ones(n), (rng.integers(0, m, n), np.arange(n))),
                           shape=(m, n))).tocsc()
    A.data[:] = 1.0
    model = Model()
    model.load_problem(A, np.zeros(n), np.ones(n), rng.integers(1, 5, n).astype(float),
                       np.ones(m), np.full(m, INF))
    return model


def mcf_lp(nn: int, na: int, seed: int, cap: float = 30.0, supply: int = 5):
    """Random connected min-cost flow (na random arcs plus a ring of nn),
    the LP of tests/test_network.py:make_mcf from the same random draws,
    built sparse."""
    import scipy.sparse as sp

    from clp_tpu_torch import Model

    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for j in range(na):
        t, h = rng.choice(nn, 2, replace=False)
        rows += [h, t]
        cols += [j, j]
        vals += [1.0, -1.0]
    for i in range(nn):
        rows += [(i + 1) % nn, i]
        cols += [na + i, na + i]
        vals += [1.0, -1.0]
    natot = na + nn
    A = sp.csc_matrix((vals, (rows, cols)), shape=(nn, natot))
    cost = rng.integers(1, 9, natot).astype(float)
    b = rng.integers(-supply, supply + 1, nn).astype(float)
    b[-1] = -b[:-1].sum()
    model = Model()
    model.load_problem(A, np.zeros(natot), np.full(natot, cap), cost, b.copy(), b.copy())
    return model


def gub_lp(K: int, per: int, mg: int, seed: int):
    """K disjoint GUB rows over `per` columns each plus mg general rows, the
    LP of tests/test_gub.py:make_gub_lp (its default shape arguments)."""
    import scipy.sparse as sp

    from clp_tpu_torch import INF, Model

    rng = np.random.default_rng(seed)
    n = K * per
    Agen = sp.random(mg, n, density=0.3, random_state=rng.integers(1 << 30),
                     data_rvs=lambda s: rng.normal(size=s)).tocsr()
    gub = sp.csr_matrix((np.ones(n), (np.repeat(np.arange(K), per), np.arange(n))),
                        shape=(K, n))
    A = sp.vstack([Agen, gub]).tocsc()
    kind = rng.random(K)
    eq_frac, onesided = 0.3, 0.0
    grl = np.where(kind < eq_frac, 1.0, np.where(kind < eq_frac + onesided, -INF, 0.2))
    gru = np.where((kind >= eq_frac + onesided) & (kind < eq_frac + 2 * onesided), INF, 1.0)
    gru = np.maximum(gru, grl)
    rl = np.concatenate([rng.normal(size=mg) - 2.0, grl])
    ru = np.concatenate([rng.normal(size=mg) + 4.0, gru])
    model = Model()
    model.load_problem(A, np.zeros(n), np.full(n, 2.0), rng.normal(size=n), rl, ru)
    return model


def sparse_feasible_lp(m: int, n: int, nnz: int, seed: int = 0, slack: float = 0.5):
    """Random sparse rows <= b + slack around a known point, the LP of
    tests/test_bigsolve.py:_sparse_feasible_lp."""
    import scipy.sparse as sp

    from clp_tpu_torch import Model

    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    A = sp.csc_matrix((rng.normal(size=nnz), (rows, cols)), shape=(m, n))
    A.sum_duplicates()
    b = A @ rng.uniform(0, 2, n)
    model = Model()
    model.load_problem(A, np.zeros(n), np.full(n, 10.0), rng.normal(size=n),
                       np.full(m, -1e30), b + slack)
    return model


def auto_models():
    """The AUTOMATIC phase's six LPs: (label, model factory, the route
    expected, HiGHS by its IPM?). On the sparse LP HiGHS's dual simplex
    takes far longer than its IPM with crossover (PERF.md §5)."""
    from clp_tpu_torch.utils.generators import random_lp

    return [
        ("covering 1024x6144", lambda: covering_lp(1024, 6144), "idiot-warm DUAL_SIMPLEX",
         False),
        # the wide and the tall LP cut from 1024 x 16384 and 12288 x 1536,
        # keeping their aspect and density: their SPRINT sub-solves (the
        # tall LP's through its dual) ran far past the phase's time
        # (PERF.md §4)
        ("wide 192x3072", lambda: random_lp(192, 3072, density=0.01, seed=1), "SPRINT", False),
        ("tall 3072x384", lambda: random_lp(3072, 384, density=0.01, equality_frac=0.0,
                                            seed=2), "dualize", False),
        ("network 2000 nodes", lambda: mcf_lp(2000, 16000, seed=0), "NETWORK", False),
        # K cut from 2000 to 500 to fit the phase's time: the GUB simplex
        # runs on the host, one Python pivot at a time (PERF.md §4)
        ("GUB K=500", lambda: gub_lp(500, 8, 64, 7), "GUB", False),
        # cut from 10240 x 20480 (163,840 nonzeros; 100.9 s of solve and
        # 19.9 s of HiGHS, PERF.md §4) for the script's time, keeping 16
        # nonzeros a row and m > 8192, where AUTOMATIC skips the
        # multifrontal probe and takes PDLP
        ("sparse 8448x16896", lambda: sparse_feasible_lp(8448, 16896, 135168, seed=0),
         "PDLP", True),
    ]


class RouteSpy:
    """Records which of the port's route functions a solve entered, and the
    simplex sub-solves each ran, by wrapping the module attributes that
    `initial_solve` looks up at call time; `close` restores them."""

    TARGETS = [("crash", "idiot_crash"), ("crash", "_idiot_descend"),
               ("sprint", "sprint_solve"), ("network", "solve_network"),
               ("gub", "solve_gub"), ("pdlp", "pdlp_solve"),
               ("bigsolve", "crunch_polish"), ("analysis", "dualize"),
               ("simplex.driver", "simplex_solve")]

    def __init__(self):
        import importlib

        self.saved = []
        self.calls: list[tuple] = []
        self.active: list[str] = []
        for mod_name, fn_name in self.TARGETS:
            mod = importlib.import_module(f"clp_tpu_torch.{mod_name}")
            fn = getattr(mod, fn_name)
            self.saved.append((mod, fn_name, fn))
            setattr(mod, fn_name, self._wrap(fn_name, fn))

    def _wrap(self, name, fn):
        def spy(*args, **kw):
            i = len(self.calls)
            self.calls.append((name, tuple(self.active), args, kw))
            self.active.append(name)
            try:
                out = fn(*args, **kw)
            finally:
                self.active.pop()
            self.calls[i] = self.calls[i] + (out,)  # nested calls came after it
            return out
        return spy

    def entered(self, name) -> list:
        return [c for c in self.calls if c[0] == name]

    def sub_solves(self, inside) -> int:
        return sum(1 for c in self.calls if c[0] == "simplex_solve" and inside in c[1])

    def close(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def route_summary(spy: RouteSpy, sol) -> tuple[str, str]:
    """(route, its iteration counts) from what the spy saw; a dualized LP
    names the route its dual took."""
    counts = route_counts(spy, sol)
    if spy.entered("dualize"):
        return "dualize", f"the dual's route {_route_name(spy)}, {counts}"
    return _route_name(spy), counts


def _route_name(spy: RouteSpy) -> str:
    for name, label in (("pdlp_solve", "PDLP"), ("sprint_solve", "SPRINT"),
                        ("solve_network", "NETWORK"), ("solve_gub", "GUB"),
                        ("idiot_crash", "idiot-warm DUAL_SIMPLEX")):
        if spy.entered(name):
            return label
    return "simplex"


def route_counts(spy: RouteSpy, sol) -> str:
    parts = []
    for c in spy.entered("_idiot_descend"):
        parts.append(f"idiot majors={c[2][8]}")
    if spy.entered("sprint_solve"):
        parts.append(f"sprint passes={spy.sub_solves('sprint_solve')}")
    for name, what in (("solve_network", "network pivots"), ("solve_gub", "GUB pivots"),
                       ("pdlp_solve", "PDHG iterations")):
        for c in spy.entered(name):
            parts.append(f"{what}={c[-1].iterations}")
    if spy.entered("crunch_polish"):
        done = spy.entered("crunch_polish")[-1][-1] is not None
        first = next(c[2][0] for c in spy.calls
                     if c[0] == "simplex_solve" and "crunch_polish" in c[1])
        parts.append(f"polish passes={spy.sub_solves('crunch_polish')}"
                     f"{'' if done else ' (declined)'} (first sub-LP "
                     f"{first.num_rows} x {first.num_cols})")
    parts.append(f"simplex sub-solves={len(spy.entered('simplex_solve'))}, "
                 f"iterations={sol.iterations}")
    return ", ".join(parts)


def auto_path(dev, label, make, expect, highs_ref) -> dict:
    """One LP through `initial_solve` with the default AUTOMATIC on the
    card, with the launch counts of exactly this run; checked for the route,
    status, KKT at 1e-6 and the objective against HiGHS."""
    from clp_tpu_torch import SolveOptions, check_kkt, initial_solve
    from clp_tpu_torch.constants import ProblemStatus
    from clp_tpu_torch.ops.pivot import fused_pivot_update
    from clp_tpu_torch.ops.price import price_and_ratios, price_and_ratios_block

    model = make()
    shape = (model.num_rows, model.num_cols, model.num_elements)
    spy = RouteSpy()
    try:
        price_and_ratios.launches = 0
        fused_pivot_update.launches = 0
        price_and_ratios_block.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = initial_solve(model, SolveOptions(device=dev.type))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": price_and_ratios.launches, "K2": fused_pivot_update.launches,
                    "K3": price_and_ratios_block.launches}
    finally:
        spy.close()
    route, counts = route_summary(spy, sol)
    if route != expect:
        raise AssertionError(f"auto [{label}]: AUTOMATIC took {route}, expected {expect}")
    if expect == "PDLP" and not spy.entered("crunch_polish"):
        raise AssertionError(f"auto [{label}]: the PDLP route did not run crunch_polish")
    if sol.status != ProblemStatus.OPTIMAL:
        raise AssertionError(f"auto [{label}]: status {sol.status!r}, expected OPTIMAL")
    rep = check_kkt(model, x=sol.primal, y=sol.duals, tol=1e-6)
    if not rep.ok:
        raise AssertionError(f"auto [{label}]: KKT check at 1e-6 failed: {rep}")
    if launches["K2"] or launches["K3"]:
        raise AssertionError(f"auto [{label}]: K2 or K3 launched: {launches}")
    t0 = time.perf_counter()
    ref = highs_ref.result()
    highs_s = time.perf_counter() - t0
    if not abs(sol.objective_value - ref) <= 1e-6 * (1 + abs(ref)):
        raise AssertionError(f"auto [{label}]: objective {sol.objective_value!r} "
                             f"vs HiGHS {ref!r}")
    print(f"auto path [{label}: {shape[0]} x {shape[1]}, {shape[2]} nonzeros]: {route} "
          f"as expected; OPTIMAL obj={sol.objective_value!r} (HiGHS {ref!r}, "
          f"{highs_s:.2f} s waited), KKT ok at 1e-6; {counts}; solve wall={wall:.3f} s, "
          f"K1 launches={launches['K1']}, "
          f"phases={ {k: round(v, 3) for k, v in sol.timings.items() if isinstance(v, float)} }",
          flush=True)
    return {"label": label, "route": route, "wall": wall, "launches": launches}


def auto_phase(dev) -> list:
    """Each AUTOMATIC destination but DECOMPOSE, driven through the default
    `initial_solve` on the card; K1 must launch inside the phase's simplex
    sub-solves."""
    specs = auto_models()
    refs = HighsRefs("auto phase", workers=3)
    try:
        futures = [refs.reference(make(), ipm) for _, make, _, ipm in specs]
        runs = [auto_path(dev, label, make, expect, ref)
                for (label, make, expect, _), ref in zip(specs, futures)]
    finally:
        refs.close()
    if sum(r["launches"]["K1"] for r in runs) <= 0:
        raise AssertionError("auto phase: K1 never launched in its simplex sub-solves")
    return runs


# ---------------------------------------------------------------------------
# nonlinear_phase: the solve-level QP and the single-model solvers
# ---------------------------------------------------------------------------

# sizes of the phase's models; a CPU rehearsal patches smaller ones in
NL = {
    "portfolio_n": 2048,  # (b): assets of the factor-model Markowitz QP
    # (c): the LP under the piecewise costs, cut from (256, 1024) for the
    # script's time (PERF.md §4)
    "pw_lp": (128, 512),
    # (d): the separable objective's LP, cut from random_lp(128, 256) and
    # then from (64, 128) for the script's time (80 LP passes, 61-64 s on
    # the card; PERF.md §4); at (48, 96) 60 passes reach 4e-7 on the CPU
    "slp_lp": (48, 96),
    "dyn_lp": (192, 3072),  # (e): the wide AUTOMATIC LP, explicit universe
    # (e)'s starting working set: the 3m = 576 cheapest columns leave the
    # LP infeasible, and dynamic_simplex_solve, as the JAX package's, stops
    # there (it prices no phase 1; ROADMAP.md queue 3); 1024 starts feasible
    "dyn_ws": 1024,
    "cut_items": 50,  # (e): item widths of the cutting-stock LP
}


def separable_staircase_qp(seed: int = 0):
    """(a): the bench staircase with Q = diag(uniform(0.1, 2.0)), the
    recipe of tests/test_scale.py::test_separable_qp_banded_barrier."""
    import scipy.sparse as sp

    model = staircase_model()
    rng = np.random.default_rng(seed)
    model.load_quadratic_objective(sp.diags(rng.uniform(0.1, 2.0, model.num_cols)).tocsc())
    return model


def portfolio_qp(n: int, gamma: float = 2.0, seed: int = 0):
    """(b): tests/test_batch.py's `_portfolio_qp`, a factor-model
    Markowitz QP (one budget row, holdings in [0, 0.3]), as a port Model."""
    import scipy.sparse as sp

    from clp_tpu_torch import Model

    rng = np.random.default_rng(seed)
    F = rng.normal(size=(n, max(2, n // 4)))
    S = F @ F.T / n + np.eye(n) * 0.05
    mu = rng.uniform(0.01, 0.12, n)
    m = Model()
    m.load_problem(sp.csc_matrix(np.ones((1, n))), np.zeros(n), np.full(n, 0.3), -mu,
                   np.array([1.0]), np.array([1.0]))
    m.quadratic_objective = sp.csc_matrix(gamma * S)
    return m


class QPSpy(RouteSpy):
    """The QP routes `initial_solve` can take: the barrier, the QP simplex,
    and any LP simplex (a crossover would run one)."""

    TARGETS = [("solve", "_solve_barrier"), ("simplex.qp", "qp_simplex_solve"),
               ("simplex.driver", "simplex_solve")]


def kernel_launches() -> dict:
    from clp_tpu_torch.ops.pivot import fused_pivot_update
    from clp_tpu_torch.ops.price import price_and_ratios, price_and_ratios_block

    return {"K1": price_and_ratios.launches, "K2": fused_pivot_update.launches,
            "K3": price_and_ratios_block.launches}


def zero_launches() -> None:
    from clp_tpu_torch.ops.pivot import fused_pivot_update
    from clp_tpu_torch.ops.price import price_and_ratios, price_and_ratios_block

    price_and_ratios.launches = 0
    fused_pivot_update.launches = 0
    price_and_ratios_block.launches = 0


def qp_path(dev, label, model, method, route, branch, kkt_tol) -> dict:
    """One QP through `initial_solve` on the card: the route (asserted with
    QPSpy), status, the port's KKT check at `kkt_tol`, the barrier's branch,
    and the peak device memory of the solve."""
    from clp_tpu_torch import SolveOptions, check_kkt, initial_solve
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.solve import _auto_method

    opts = SolveOptions(method=SolveMethod[method], device=dev.type)
    if method == "AUTOMATIC":
        auto = _auto_method(model, opts)
        if auto.name != route:
            raise AssertionError(f"qp [{label}]: AUTOMATIC chose {auto.name}, "
                                 f"expected {route}")
    shape = (model.num_rows, model.num_cols)
    spy = QPSpy()
    try:
        zero_launches()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = initial_solve(model, opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches()
    finally:
        spy.close()
    peak = torch.cuda.max_memory_allocated() / 2**20 if dev.type == "cuda" else None
    entered = {name: len(spy.entered(name)) for name in
               ("_solve_barrier", "qp_simplex_solve", "simplex_solve")}
    want = ({"_solve_barrier": 1, "qp_simplex_solve": 0, "simplex_solve": 0}
            if route == "BARRIER_NO_CROSS" else
            {"_solve_barrier": 0, "qp_simplex_solve": 1, "simplex_solve": 0})
    if entered != want:
        raise AssertionError(f"qp [{label}]: routes entered {entered}, expected {want}")
    if sol.status != ProblemStatus.OPTIMAL:
        raise AssertionError(f"qp [{label}]: status {sol.status!r}, expected OPTIMAL")
    rep = check_kkt(model, x=sol.primal, y=sol.duals, tol=kkt_tol)
    if not rep.ok:
        raise AssertionError(f"qp [{label}]: KKT check at {kkt_tol} failed: {rep}")
    info = {"label": label, "route": route, "wall": wall, "objective": sol.objective_value,
            "peak_mib": peak, "launches": launches}
    if route == "BARRIER_NO_CROSS":
        stats = sol.timings["barrier_stats"]
        if not branch(stats["branch"]):
            raise AssertionError(f"qp [{label}]: barrier branch {stats['branch']!r}")
        info |= {"branch": stats["branch"], "ipm_iterations": stats["iterations"],
                 "ipm_seconds": stats["seconds"], "ipm_converged": stats["converged"],
                 "f64_retry": stats["f64_retry"]}
        detail = (f"{stats['branch']}; IPM {stats['iterations']} iterations "
                  f"({'converged' if stats['converged'] else 'NOT converged'}) in "
                  f"{stats['seconds']:.3f} s, f64 retry: {stats['f64_retry'] or 'not needed'}")
    else:
        st = sol.timings["qp_stats"]
        info |= st
        detail = (f"QP simplex: phase 1 {st['phase1_iterations']} dual pivots in "
                  f"{st['phase1_seconds']:.3f} s, {st['qp_iterations']} QP iterations in "
                  f"{st['qp_seconds']:.3f} s "
                  f"({1e3 * st['qp_seconds'] / max(st['qp_iterations'], 1):.2f} ms/iteration)")
    print(f"nonlinear [{label}: {shape[0]} x {shape[1]}, {method} -> {route}]: OPTIMAL "
          f"obj={sol.objective_value!r}, KKT ok at {kkt_tol}; {detail}; solve wall={wall:.3f} s, "
          f"peak device memory {peak if peak is None else round(peak, 1)} MiB, "
          f"launches={launches}", flush=True)
    return info


def piecewise_costs(model, seed: int = 3) -> dict:
    """(c): a convex 3-piece cost on every column of the model: breakpoints
    at the column's bounds and two interior kinks, slopes c_j + sorted
    N(0, 1) draws."""
    rng = np.random.default_rng(seed)
    pw = {}
    for j in range(model.num_cols):
        lo, up = model.col_lower[j], model.col_upper[j]
        t = np.sort(rng.uniform(0.1, 0.9, 2))
        pw[j] = (np.concatenate([[lo], lo + (up - lo) * t, [up]]),
                 np.sort(model.objective[j] + rng.normal(size=3)))
    return pw


def piecewise_path(dev) -> dict:
    """(c): `solve_piecewise` in the engine on the host, and the
    reformulation `set_piecewise_linear_cost` through `initial_solve` on
    the card, by the dual simplex with presolve off as tests/test_piecewise.py
    solves it (AUTOMATIC takes SPRINT there, several times slower: PERF.md
    §4); both against HiGHS on the reformulation."""
    from clp_tpu_torch import SolveOptions, initial_solve
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.piecewise import set_piecewise_linear_cost, solve_piecewise
    from clp_tpu_torch.utils.generators import random_lp

    m, n = NL["pw_lp"]
    base = random_lp(m, n, seed=3)
    pw = piecewise_costs(base)
    t0 = time.perf_counter()
    inengine = solve_piecewise(base.copy(), pw)
    pw_wall = time.perf_counter() - t0
    reform = base.copy()
    for j in range(n):
        set_piecewise_linear_cost(reform, j, *pw[j])
    spy = RouteSpy()
    try:
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opts = SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device=dev.type)
        opts.presolve.enabled = False
        sol = initial_solve(reform, opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches()
    finally:
        spy.close()
    route, counts = route_summary(spy, sol)
    ref = highs_objective(reform)
    for what, s in (("in-engine", inengine), ("reformulation", sol)):
        if s.status != ProblemStatus.OPTIMAL:
            raise AssertionError(f"piecewise [{what}]: status {s.status!r}")
        if not abs(s.objective_value - ref) <= 1e-6 * (1 + abs(ref)):
            raise AssertionError(f"piecewise [{what}]: objective {s.objective_value!r} "
                                 f"vs HiGHS {ref!r}")
    print(f"nonlinear [piecewise {m} x {n}, 3 pieces a column]: in-engine solve_piecewise "
          f"(host) OPTIMAL obj={inengine.objective_value!r} in {inengine.iterations} "
          f"iterations, {pw_wall:.3f} s; reformulation {reform.num_rows} x {reform.num_cols} "
          f"by DUAL_SIMPLEX: {route}, OPTIMAL obj={sol.objective_value!r}, {counts}, "
          f"solve wall={wall:.3f} s, launches={launches}; HiGHS {ref!r}", flush=True)
    return {"label": "piecewise", "pw_iterations": inengine.iterations, "pw_wall": pw_wall,
            "reform_route": route, "reform_wall": wall, "launches": launches}


def slp_path(dev) -> dict:
    """(d): `nonlinear_slp` with torch callables and no gradient (autograd
    drives it), its LP sub-solves on the card: the convex log objective of
    tests/test_slp.py against its optimum (1, 1), and a separable convex
    objective against the QP barrier of its quadratic twin."""
    import scipy.sparse as sp

    from clp_tpu_torch import INF, Model, SolveOptions, initial_solve
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.slp import nonlinear_slp
    from clp_tpu_torch.utils.generators import random_lp

    small = Model()
    small.load_problem(sp.csc_matrix(np.array([[1.0, 1.0]])), col_lower=[0.1, 0.1],
                       col_upper=[5.0, 5.0], objective=[0.0, 0.0], row_lower=[-INF],
                       row_upper=[4.0])
    t0 = time.perf_counter()
    s1 = nonlinear_slp(small, lambda x: -torch.log(x[0]) - torch.log(x[1]) + x[0] + x[1],
                       max_passes=60, device=dev.type)
    w1 = time.perf_counter() - t0
    if s1.status != ProblemStatus.OPTIMAL or not np.allclose(s1.primal, 1.0, atol=5e-3):
        raise AssertionError(f"slp [log]: {s1.status!r} at {s1.primal}, expected (1, 1)")
    m, n = NL["slp_lp"]
    model = random_lp(m, n, seed=4)
    q = np.random.default_rng(4).uniform(0.5, 2.0, n)
    c, qt = torch.as_tensor(model.objective), torch.as_tensor(q)
    t0 = time.perf_counter()
    s2 = nonlinear_slp(model.copy(), lambda x: c @ x + 0.5 * torch.sum(qt * x * x),
                       max_passes=80, device=dev.type)
    w2 = time.perf_counter() - t0
    twin = model.copy()
    twin.load_quadratic_objective(sp.diags(q).tocsc())
    ref = initial_solve(twin, SolveOptions(method=SolveMethod.BARRIER, crossover=False,
                                           device=dev.type))
    if s2.status != ProblemStatus.OPTIMAL or ref.status != ProblemStatus.OPTIMAL:
        raise AssertionError(f"slp [separable]: {s2.status!r}, QP barrier {ref.status!r}")
    # tests/test_slp.py's tolerance for SLP against the QP barrier
    if not abs(s2.objective_value - ref.objective_value) < 1e-4 * (
            1 + abs(ref.objective_value)):
        raise AssertionError(f"slp [separable]: {s2.objective_value!r} vs the QP "
                             f"barrier's {ref.objective_value!r}")
    print(f"nonlinear [SLP]: log objective OPTIMAL at {s1.primal.tolist()} in {s1.iterations} "
          f"passes, {w1:.3f} s; separable on random_lp({m}, {n}) OPTIMAL "
          f"obj={s2.objective_value!r} in {s2.iterations} passes, {w2:.3f} s; QP barrier twin "
          f"{ref.objective_value!r} ({ref.timings['barrier_stats']['branch']})", flush=True)
    return {"label": "slp", "log_passes": s1.iterations, "log_wall": w1,
            "separable_passes": s2.iterations, "separable_wall": w2}


class CuttingStockSource:
    """Gilmore-Gomory pricing for `dynamic_simplex_solve`: columns are
    cutting patterns from a DP knapsack on the current duals, never
    enumerated up front; the source of tests/test_dynamic.py."""

    n_total = -1

    def __init__(self, widths, roll):
        self.w = np.asarray(widths, dtype=np.int64)
        self.roll = int(roll)
        self.m = len(widths)
        self.ids = {}

    def _id(self, pat):
        return self.ids.setdefault(tuple(pat), len(self.ids))

    def initial(self, k):
        pats = [np.where(np.arange(self.m) == i, self.roll // self.w[i], 0)
                for i in range(self.m)]
        A = np.array(pats, dtype=float).T
        kk = A.shape[1]
        return (A, np.ones(kk), np.zeros(kk), np.full(kk, 1e30),
                np.array([self._id(p) for p in pats]))

    def price(self, y, k):
        pat, val = knapsack(self.w, self.roll, np.maximum(y, 0.0))
        if val <= 1.0 + 1e-7:
            return (np.zeros((self.m, 0)), np.zeros(0), np.zeros(0), np.zeros(0),
                    np.zeros(0, np.int64))
        return (pat.astype(float).reshape(self.m, 1), np.ones(1), np.zeros(1),
                np.full(1, 1e30), np.array([self._id(pat)]))


def knapsack(w, roll: int, values):
    """max values'p s.t. w'p <= roll, p >= 0 integer, by DP over the roll."""
    best = np.zeros(roll + 1)
    take = np.full(roll + 1, -1)
    for cap in range(1, roll + 1):
        best[cap] = best[cap - 1]
        for i in range(len(w)):
            if w[i] <= cap and best[cap - w[i]] + values[i] > best[cap] + 1e-12:
                best[cap], take[cap] = best[cap - w[i]] + values[i], i
    pat, cap = np.zeros(len(w), dtype=np.int64), roll
    while cap > 0:
        if take[cap] < 0:
            cap -= 1
        else:
            pat[take[cap]] += 1
            cap -= w[take[cap]]
    return pat, best[roll]


def cutting_stock(items: int, seed: int = 0):
    """(e): item widths in [15, 95) without repeats, a roll of 200, demands
    in [10, 100)."""
    rng = np.random.default_rng(seed)
    widths = np.sort(rng.choice(np.arange(15, 95), items, replace=False))
    return widths, 200, rng.integers(10, 100, items).astype(float)


def dynamic_path(dev) -> dict:
    """(e): `dynamic_simplex_solve` over the wide AUTOMATIC LP's explicit
    universe against HiGHS on the whole LP; then one cutting-stock LP
    relaxation by `column_generation` (the knapsack pricer, master on the
    card) and by `dynamic_simplex_solve` (the pricing source): the same
    bound."""
    import scipy.sparse as sp

    from clp_tpu_torch import INF, Model, SolveOptions
    from clp_tpu_torch.colgen import column_generation
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.dynamic import ExplicitColumnSource, dynamic_simplex_solve
    from clp_tpu_torch.utils.generators import random_lp

    m, n = NL["dyn_lp"]
    model = random_lp(m, n, density=0.01, seed=1)
    model.col_lower = np.zeros(n)  # the colgen convention: l = 0
    model.col_upper = np.full(n, 50.0)
    src = ExplicitColumnSource(model.matrix, model.objective, model.col_lower,
                               model.col_upper)
    # from the 3m cheapest columns the LP is infeasible, and the dynamic
    # matrix stops there, as the JAX package's does (ROADMAP.md queue 3)
    start, sinfo = dynamic_simplex_solve(model.row_lower, model.row_upper, src,
                                         working_set=3 * m,
                                         options=SolveOptions(device=dev.type))
    if start.status != ProblemStatus.PRIMAL_INFEASIBLE or sinfo["swaps"]:
        raise AssertionError(f"dynamic [wide, {3 * m} columns]: {start.status!r}, {sinfo}")
    print(f"nonlinear [dynamic {m} x {n}, working set {3 * m}]: PRIMAL_INFEASIBLE from "
          f"its {3 * m} cheapest columns after {start.iterations} pivots, no phase-1 "
          "pricing (as in the JAX package)", flush=True)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ws = NL["dyn_ws"]
    sol, info = dynamic_simplex_solve(model.row_lower, model.row_upper, src,
                                      working_set=ws, options=SolveOptions(device=dev.type))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref = highs_objective(model)
    if sol.status != ProblemStatus.OPTIMAL or not info["proved_optimal_over_universe"]:
        raise AssertionError(f"dynamic [wide]: {sol.status!r}, {info}")
    if not abs(sol.objective_value - ref) <= 1e-6 * (1 + abs(ref)):
        raise AssertionError(f"dynamic [wide]: objective {sol.objective_value!r} "
                             f"vs HiGHS {ref!r}")
    print(f"nonlinear [dynamic {m} x {n}, working set {ws}]: OPTIMAL "
          f"obj={sol.objective_value!r} (HiGHS {ref!r}), {info['rounds']} rounds, "
          f"{info['swaps']} swaps, final working set {info['working_set']}, "
          f"{sol.iterations} primal pivots, wall={wall:.3f} s, "
          f"launches={kernel_launches()}", flush=True)

    widths, roll, demand = cutting_stock(NL["cut_items"])
    k = len(widths)
    master = Model()
    master.load_problem(sp.csc_matrix(np.diag(np.floor(roll / widths))), np.zeros(k),
                        np.full(k, INF), np.ones(k), demand, np.full(k, INF))
    rounds = []

    def pricer(duals):
        rounds.append(1)
        pat, val = knapsack(widths, roll, duals)
        return [(pat, 1.0, 0.0, INF)] if val > 1.0 + 1e-7 else []

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cg = column_generation(master, pricer,
                           SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device=dev.type))
    torch.cuda.synchronize()
    cg_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    dyn, dinfo = dynamic_simplex_solve(demand, np.full(k, INF),
                                       CuttingStockSource(widths, roll),
                                       working_set=2 * k, options=SolveOptions(device=dev.type))
    torch.cuda.synchronize()
    dyn_wall = time.perf_counter() - t0
    if cg.status != ProblemStatus.OPTIMAL or dyn.status != ProblemStatus.OPTIMAL or \
            not dinfo["proved_optimal_over_universe"]:
        raise AssertionError(f"cutting stock: colgen {cg.status!r}, dynamic {dyn.status!r}")
    if not abs(cg.objective_value - dyn.objective_value) <= 1e-6 * (
            1 + abs(cg.objective_value)):
        raise AssertionError(f"cutting stock: colgen {cg.objective_value!r} vs dynamic "
                             f"{dyn.objective_value!r}")
    print(f"nonlinear [cutting stock, {k} widths, roll {roll}]: column_generation OPTIMAL "
          f"obj={cg.objective_value!r} in {len(rounds)} pricing rounds "
          f"({master.num_cols} columns), {cg_wall:.3f} s; dynamic_simplex_solve OPTIMAL "
          f"obj={dyn.objective_value!r} in {dinfo['rounds']} rounds, {dinfo['swaps']} swaps, "
          f"final working set {dinfo['working_set']}, {dyn_wall:.3f} s", flush=True)
    return {"label": "dynamic", "rounds": info["rounds"], "swaps": info["swaps"],
            "working_set": info["working_set"], "wall": wall,
            "cg_rounds": len(rounds), "cg_wall": cg_wall,
            "cut_rounds": dinfo["rounds"], "cut_swaps": dinfo["swaps"], "cut_wall": dyn_wall}


def nonlinear_phase(dev) -> list:
    """The solve-level QP and the single-model solvers on the card:
    (a) the separable staircase QP through AUTOMATIC (BARRIER_NO_CROSS,
    banded q_diag); (b) the dense-Q portfolio QP through AUTOMATIC (the
    (nt, nt) Newton branch) and PRIMAL_SIMPLEX (the QP simplex), which must
    agree; (c) piecewise costs; (d) SLP; (e) the dynamic matrix and column
    generation. No QP runs BARRIER with crossover: its LP crossover ignores
    Q, as the JAX package's does (ROADMAP.md queue 3)."""
    t_phase = time.perf_counter()
    runs = [qp_path(dev, "separable staircase", separable_staircase_qp(), "AUTOMATIC",
                    "BARRIER_NO_CROSS",
                    lambda b: b.startswith("banded") and b.endswith("q_diag"), 1e-5)]
    n = NL["portfolio_n"]
    bar = qp_path(dev, f"portfolio n={n}", portfolio_qp(n), "AUTOMATIC", "BARRIER_NO_CROSS",
                  lambda b: b == "dense QP (nt, nt)", 1e-5)
    smp = qp_path(dev, f"portfolio n={n}", portfolio_qp(n), "PRIMAL_SIMPLEX",
                  "PRIMAL_SIMPLEX", None, 1e-6)
    if not abs(smp["objective"] - bar["objective"]) <= 1e-6 * (1 + abs(bar["objective"])):
        raise AssertionError(f"portfolio: QP simplex {smp['objective']!r} vs QP barrier "
                             f"{bar['objective']!r}")
    print(f"nonlinear [portfolio n={n}]: QP simplex and QP barrier agree within "
          f"1e-6 * (1 + |obj|): {smp['objective']!r} vs {bar['objective']!r}", flush=True)
    runs += [bar, smp, piecewise_path(dev), slp_path(dev), dynamic_path(dev)]
    print(f"nonlinear phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return runs


# ---------------------------------------------------------------------------
# batch_phase: ELL and Positive Edge, scenario batching, racing, DECOMPOSE, IIS
# ---------------------------------------------------------------------------

# sizes of the phase's models, as `--batch` runs them; the no-argument
# run cuts some (BP_CUTS), and a CPU rehearsal patches smaller ones in
BP = {
    "wide": (1024, 1792, 0.05),  # random_lp(1024, 1792, density=0.05): the bench LP
    # the LPs of the PE dual (None: the staircase), the PE primal, the B = 16
    # batch and racing
    "pe_dual": None,
    "pe_primal": (1024, 1792, 0.05),
    "batch_lp": (1024, 1792, 0.05),
    "race": (1024, 1792, 0.05),
    "iis": (1024, 1792, 0.05),  # the IIS's LP, three conflicting rows appended
    # processes for the HiGHS references of the bench LPs, which solve
    # while the card goes on with the phase
    "highs_workers": 4,
    "ell_auto": (24576, 65536),  # the ELL auto choice's probe (no solve)
    "dual_b32": (32, 64, 96, 2),  # bench.py:208: B, m, n, generator seed
    "dual_b256": (256, 32, 48, 4),  # bench.py:237
    "sweep_batches": 40,  # 40 x 256 = 10,240 scenarios (BASELINE.json configs[4])
    "wide_batch": 16,
    "ipm_b64": (64, 48, 72, 0),  # bench.py:138
    "stair_batch": 16,
    "qp_n": 2048,
    "qp_gammas": 8,
    "two_stage": (64, 32, 24, 72),  # S, n1, m2, n2: 1537 x 4640 flat
}
# the no-argument run's cuts: at the sizes above its batch phase took
# 669.9 s and the whole script 1202.3 s (PERF.md §4), past the 1200 s it
# is allowed; PE's dual and primal, the B = 16 batch, racing and the IIS
# run on random_lp(512, 640, density=0.05) there (512 x 896 until the mesh
# phase added ~190 s to a run of ~860 s; the run is to stay under 1000 s),
# the sweep on 20 batches of 256. Each keeps its route
# on the card: 512 rows keep the f32 inverse (m >= 512) and m * (n + m)
# keeps K1 (>= 512 * 1024) wherever the full size has them
MID = (512, 640, 0.05)
BP_CUTS = {"pe_dual": MID, "pe_primal": MID, "batch_lp": MID, "race": MID, "iis": MID,
           "sweep_batches": 20}


def perturbed(base, B: int, rng):
    """bench.py's perturbed-RHS scenarios: every finite row bound moves
    outwards by |U(0, 0.05)|."""
    out = []
    for _ in range(B):
        m = base.copy()
        shift = np.abs(rng.uniform(0, 0.05, m.num_rows))
        m.row_lower = np.where(m.row_lower > -1e29, m.row_lower - shift, m.row_lower)
        m.row_upper = np.where(m.row_upper < 1e29, m.row_upper + shift, m.row_upper)
        out.append(m)
    return out


class BatchSpy(RouteSpy):
    """The routes of batch_phase: the ELL forms, the PE signs, the batched
    programs, the single-LP fallbacks and the decomposition."""

    TARGETS = [("simplex.engine", "ell_forms"), ("simplex.engine", "rademacher"),
               ("simplex.driver", "simplex_solve"), ("simplex.qp", "qp_simplex_solve"),
               ("parallel.batch", "ipm_solve_batched"),
               ("interior.mehrotra", "ipm_solve_batched"),
               ("structure", "auto_decompose_solve"), ("decompose", "benders_solve"),
               ("parallel.batch", "solve_batch_dual_simplex")]


def timed(dev, fn):
    """(result, wall s, peak device MiB, K1-K3 launches) of one call."""
    zero_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20 if dev.type == "cuda" else None
    return out, wall, peak, kernel_launches()


def _mib(peak) -> str:
    return "n/a" if peak is None else f"{peak:.1f} MiB"


def agree(label, obj, ref) -> None:
    if not abs(obj - ref) <= 1e-6 * (1 + abs(ref)):
        raise AssertionError(f"{label}: objective {obj!r} vs HiGHS {ref!r}")


def single_path(dev, label, model, opts, spy_name, ref, want_k1, refs=None) -> dict:
    """One LP through initial_solve with an engine option of this slice;
    `spy_name` must run (ell_forms / rademacher), K1 as `want_k1` says. With
    `ref` None the HiGHS check goes to `refs` (HighsRefs)."""
    from clp_tpu_torch import check_kkt, initial_solve
    from clp_tpu_torch.constants import ProblemStatus

    spy = BatchSpy()
    try:
        sol, wall, peak, launches = timed(dev, lambda: initial_solve(model, opts))
    finally:
        spy.close()
    if not spy.entered(spy_name):
        raise AssertionError(f"{label}: {spy_name} never ran")
    # K1 launches only on the card (on the CPU the plain PRICE runs)
    if ((launches["K1"] > 0) != (want_k1 and dev.type == "cuda")
            or launches["K2"] or launches["K3"]):
        raise AssertionError(f"{label}: wrong kernels launched: {launches}")
    if sol.status != ProblemStatus.OPTIMAL:
        raise AssertionError(f"{label}: status {sol.status!r}")
    rep = check_kkt(model, x=sol.primal, y=sol.duals, tol=1e-6)
    if not rep.ok:
        raise AssertionError(f"{label}: KKT check at 1e-6 failed: {rep}")
    if ref is None:
        refs.add(label, model, sol.objective_value)
    else:
        agree(label, sol.objective_value, ref)
    print(f"batch phase [{label}: {model.num_rows} x {model.num_cols}]: OPTIMAL "
          f"obj={sol.objective_value!r} (HiGHS {'checked below' if ref is None else ref}), "
          f"KKT ok; {spy_name} calls="
          f"{len(spy.entered(spy_name))}, iterations={sol.iterations}, wall={wall:.3f} s, "
          f"pivots/s={sol.iterations / wall:.1f}, peak {_mib(peak)}, launches={launches}",
          flush=True)
    return {"label": label, "wall": wall, "launches": launches}


def ell_pe_paths(dev, stair_ref: float, refs) -> list:
    """ELL on the staircase, the ELL auto choice on a sparse LP above the
    6 GB line, PE's dual (K1 on) on the staircase or `BP["pe_dual"]`, and
    PE's primal on `BP["pe_primal"]`."""
    import scipy.sparse as sp

    from clp_tpu_torch import Model, SolveOptions
    from clp_tpu_torch.constants import SolveMethod
    from clp_tpu_torch.simplex import driver
    from clp_tpu_torch.utils.generators import random_lp

    m, n = BP["ell_auto"]
    rng = np.random.default_rng(0)
    big = Model()
    big.load_problem(sp.csc_matrix((np.ones(3 * n), (rng.integers(0, m, 3 * n),
                                                     np.repeat(np.arange(n), 3))),
                                   shape=(m, n)),
                     np.zeros(n), np.ones(n), np.ones(n), np.full(m, -np.inf),
                     np.full(m, 10.0))
    if not driver.ell_auto(big, m, m + n):
        raise AssertionError("ELL: the auto choice declined the sparse LP above 6 GB")
    kc, kr = driver.ell_widths(big)
    print(f"batch phase [ELL auto choice]: {m} x {n}, {big.num_elements} nonzeros "
          f"(dense f32 standard form {4 * m * (m + n) / 2**30:.2f} GiB): ell, kc={kc}, "
          f"kr={kr}; the solve needs a {8 * m * (m + n) / 2**30:.1f} GiB dense f64 "
          f"form on the host and is left out", flush=True)
    stair = staircase_model()
    kc, kr = driver.ell_widths(stair)
    dual = SolveMethod.DUAL_SIMPLEX
    pe_dual = BP["pe_dual"]
    pm, pn, pd = BP["pe_primal"]
    return [single_path(dev, f"ELL staircase kc={kc} kr={kr}", stair,
                        SolveOptions(method=dual, device=dev.type, price_mode="ell"),
                        "ell_forms", stair_ref, False),
            single_path(dev, "PE dual staircase", stair,
                        SolveOptions(method=dual, device=dev.type, dual_pivot="pesteepest"),
                        "rademacher", stair_ref, True) if pe_dual is None else
            single_path(dev, "PE dual random", random_lp(pe_dual[0], pe_dual[1],
                                                         density=pe_dual[2]),
                        SolveOptions(method=dual, device=dev.type, dual_pivot="pesteepest"),
                        "rademacher", None, True, refs),
            single_path(dev, "PE primal random", random_lp(pm, pn, density=pd),
                        SolveOptions(method=SolveMethod.PRIMAL_SIMPLEX, device=dev.type,
                                     primal_pivot="pe"),
                        "rademacher", None, False, refs)]


def _model_key(model) -> str:
    import hashlib

    h = hashlib.sha1()
    for a in (model.matrix.data, model.matrix.indices, model.row_lower, model.row_upper,
              model.col_lower, model.col_upper, model.objective):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


class HighsRefs:
    """HiGHS references solved while the card works (HiGHS's IPM takes
    10-60 s on each bench LP; waiting for each in turn cost the barrier and
    AUTOMATIC phases ~70 s of the run, PERF.md §4): every distinct LP
    solves in one of `workers` (default `BP["highs_workers"]`) spawned
    processes from the moment it is added. `reference` returns the
    objective's future; `add` queues a check that `check` holds to its
    reference within 1e-6 * (1 + |obj|). `close` ends the pool."""

    def __init__(self, phase: str = "batch phase", workers: int | None = None):
        import concurrent.futures as cf
        import multiprocessing
        import os

        self.phase = phase
        self.workers = workers or BP["highs_workers"]
        # at a lower priority: the engines' host threads come first
        self.pool = cf.ProcessPoolExecutor(self.workers,
                                           mp_context=multiprocessing.get_context("spawn"),
                                           initializer=os.nice, initargs=(10,))
        self.futures: dict = {}
        self.checks: list = []

    def reference(self, model, ipm: bool = True):
        key = (_model_key(model), ipm)
        if key not in self.futures:
            self.futures[key] = self.pool.submit(highs_objective, model, ipm)
        return self.futures[key]

    def add(self, label, model, obj) -> None:
        self.checks.append((label, self.reference(model), obj))

    def check(self) -> None:
        t0 = time.perf_counter()
        for label, future, obj in self.checks:
            agree(label, obj, future.result())
        print(f"{self.phase} [HiGHS references]: {len(self.checks)} "
              f"objectives agree within 1e-6 * (1 + |obj|) ({len(self.futures)} HiGHS "
              f"solves in {self.workers} background processes; "
              f"{time.perf_counter() - t0:.1f} s waited at the end)", flush=True)

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


def batch_dual(dev, label, models, check_lanes, refs=None) -> dict:
    """One solve_batch_dual_simplex: every lane OPTIMAL, the lanes
    `check_lanes` against HiGHS (or, given `refs`, every lane there), and
    no lane through the single driver."""
    from clp_tpu_torch import SolveOptions
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.parallel.batch import solve_batch_dual_simplex

    opts = SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device=dev.type)
    opts.presolve.enabled = False
    spy = BatchSpy()
    try:
        sols, wall, peak, launches = timed(dev, lambda: solve_batch_dual_simplex(models, opts))
    finally:
        spy.close()
    bad = [i for i, s in enumerate(sols) if s.status != ProblemStatus.OPTIMAL]
    if bad:
        raise AssertionError(f"{label}: lanes {bad[:10]} not OPTIMAL")
    if spy.entered("simplex_solve"):
        raise AssertionError(f"{label}: {len(spy.entered('simplex_solve'))} lanes fell back "
                             "to the single-LP driver")
    if any(launches.values()):
        raise AssertionError(f"{label}: a kernel launched under the batch: {launches}")
    for i in check_lanes:
        agree(f"{label} lane {i}", sols[i].objective_value, highs_objective(models[i]))
    if refs is not None:
        for i, (m, s) in enumerate(zip(models, sols)):
            refs.add(f"{label} lane {i}", m, s.objective_value)
    pivots = sum(s.iterations for s in sols)
    return {"label": label, "wall": wall, "peak": peak, "launches": launches,
            "B": len(models), "pivots": pivots,
            "max_pivots": max(s.iterations for s in sols),
            "inverse": sols[0].timings["factorization_stats"]["inverse_dtype"]}


def print_batch(r, shape) -> None:
    print(f"batch phase [batched dual {r['label']}: B={r['B']} x {shape}, "
          f"{r['inverse']} inverse]: all lanes OPTIMAL, checked lanes agree with HiGHS; "
          f"wall={r['wall']:.3f} s, {r['B'] / r['wall']:.1f} instances/s, "
          f"{r['pivots']} lane pivots ({r['pivots'] / r['wall']:.1f} lane pivots/s, "
          f"slowest lane {r['max_pivots']}), peak {_mib(r['peak'])}", flush=True)


def batched_dual_paths(dev, refs) -> list:
    """bench.py:188-276's batches at full size, the 10,240-scenario sweep and
    B = 16 perturbed copies of `BP["batch_lp"]` (f32 inverse, blocks of 8)."""
    from clp_tpu_torch.utils.generators import random_lp

    rng = np.random.default_rng(3)
    runs = []
    B, m, n, seed = BP["dual_b32"]
    r = batch_dual(dev, "b32", perturbed(random_lp(m, n, seed=seed), B, rng), (0, B - 1))
    print_batch(r, f"{m} x {n}")
    runs.append(r)
    B, m, n, seed = BP["dual_b256"]
    base = random_lp(m, n, seed=seed)
    r = batch_dual(dev, "b256", perturbed(base, B, rng), (0, B - 1))
    print_batch(r, f"{m} x {n}")
    runs.append(r)
    # the sweep: fresh batches of 256 head to tail, wall with each batch's
    # model build and stacking
    t0 = time.perf_counter()
    done = lanes = pivots = 0
    for k in range(BP["sweep_batches"]):
        r = batch_dual(dev, f"sweep {k}", perturbed(base, B, rng), (0, B - 1))
        done, lanes, pivots = done + 1, lanes + r["B"], pivots + r["pivots"]
    wall = time.perf_counter() - t0
    print(f"batch phase [scenario sweep: {done} of {BP['sweep_batches']} batches of "
          f"{B} x {m} x {n}]: {lanes} scenarios all OPTIMAL, first and last lane of each "
          f"batch agree with HiGHS; wall={wall:.3f} s (HiGHS checks included), "
          f"{lanes / wall:.1f} scenarios/s, {pivots} lane pivots", flush=True)
    runs.append({"label": "sweep", "wall": wall, "launches": r["launches"],
                 "batches": done, "scenarios": lanes})
    wm, wn, wd = BP["batch_lp"]
    models = perturbed(random_lp(wm, wn, density=wd), BP["wide_batch"], rng)
    r = batch_dual(dev, "b16", models, (), refs)
    print_batch(r, f"{wm} x {wn}")
    runs.append(r)
    return runs


def batched_ipm_paths(dev) -> list:
    """solve_batch on bench.py:132-186's B = 64 batch and on perturbed-RHS
    copies of the staircase (the banded plan of the union pattern)."""
    from clp_tpu_torch import SolveOptions
    from clp_tpu_torch.constants import ProblemStatus
    from clp_tpu_torch.solve import solve_batch
    from clp_tpu_torch.utils.generators import random_lp

    runs = []
    B, m, n, seed = BP["ipm_b64"]
    specs = [("b64", perturbed(random_lp(m, n, seed=seed), B, np.random.default_rng(1)),
              False),
             ("staircase", perturbed(staircase_model(), BP["stair_batch"],
                                     np.random.default_rng(5)), True)]
    for label, models, banded in specs:
        spy = BatchSpy()
        try:
            sols, wall, peak, launches = timed(
                dev, lambda: solve_batch(models, SolveOptions(device=dev.type)))
        finally:
            spy.close()
        calls = spy.entered("ipm_solve_batched")
        nb = calls[0][2][1].band_nb if calls else None
        if len(calls) != 1 or (nb > 0) != banded:
            raise AssertionError(f"batched IPM [{label}]: ipm_solve_batched calls "
                                 f"{len(calls)}, band_nb={nb}")
        bad = [i for i, s in enumerate(sols) if s.status != ProblemStatus.OPTIMAL]
        if bad:
            raise AssertionError(f"batched IPM [{label}]: lanes {bad[:10]} did not converge")
        for i in (0, len(models) - 1):
            agree(f"batched IPM [{label}] lane {i}", sols[i].objective_value,
                  highs_objective(models[i], ipm=True))
        its = [s.iterations for s in sols]
        mdl = models[0]
        print(f"batch phase [batched IPM {label}: B={len(models)} x {mdl.num_rows} x "
              f"{mdl.num_cols}, {'banded nb=' + str(nb) if banded else 'dense'}]: all lanes "
              f"converged, lanes 0 and B-1 agree with HiGHS; IPM iterations "
              f"{min(its)}-{max(its)}; wall={wall:.3f} s, {len(models) / wall:.1f} "
              f"instances/s, peak {_mib(peak)}", flush=True)
        runs.append({"label": f"ipm {label}", "wall": wall, "launches": launches})
    return runs


def batched_qp_path(dev) -> dict:
    """tests/test_batch.py:115's risk sweep at n = 2048 assets: each lane
    within 1e-6 of the single QP simplex, the frontier monotone."""
    from clp_tpu_torch import SolveOptions
    from clp_tpu_torch.constants import ProblemStatus
    from clp_tpu_torch.parallel.batch import solve_batch_qp_simplex
    from clp_tpu_torch.simplex.qp import qp_simplex_solve

    n = BP["qp_n"]
    gammas = np.linspace(0.5, 8.0, BP["qp_gammas"])
    models = [portfolio_qp(n, gamma=g) for g in gammas]
    opts = SolveOptions(device=dev.type)
    spy = BatchSpy()
    try:
        sols, wall, peak, launches = timed(
            dev, lambda: solve_batch_qp_simplex([m.copy() for m in models], opts))
    finally:
        spy.close()
    if spy.entered("qp_simplex_solve"):
        raise AssertionError("batched QP: a lane fell back to the single QP simplex")
    t0 = time.perf_counter()
    refs = [qp_simplex_solve(m.copy(), opts) for m in models]
    single = time.perf_counter() - t0
    for g, s, r in zip(gammas, sols, refs):
        if not (s.status == r.status == ProblemStatus.OPTIMAL):
            raise AssertionError(f"batched QP gamma={g}: {s.status!r} / {r.status!r}")
        if not abs(s.objective_value - r.objective_value) <= 1e-6 * (1 + abs(r.objective_value)):
            raise AssertionError(f"batched QP gamma={g}: {s.objective_value!r} vs single "
                                 f"{r.objective_value!r}")
    risks = [float(s.primal @ (m.quadratic_objective @ s.primal)) / g
             for s, m, g in zip(sols, models, gammas)]
    if not all(risks[i + 1] <= risks[i] + 1e-9 for i in range(len(risks) - 1)):
        raise AssertionError(f"batched QP: the frontier is not monotone: {risks}")
    print(f"batch phase [batched QP simplex: {len(models)} gammas x {n} assets]: every "
          f"lane OPTIMAL within 1e-6 of its single QP simplex, frontier monotone; "
          f"iterations {[s.iterations for s in sols]}; wall={wall:.3f} s "
          f"({len(models) / wall:.2f} instances/s) against {single:.3f} s for the "
          f"{len(models)} single solves; peak {_mib(peak)}", flush=True)
    return {"label": "qp", "wall": wall, "launches": launches}


def racing_paths(dev, refs) -> list:
    from clp_tpu_torch import SolveOptions
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.parallel.racing import race_seeds, racing_solve
    from clp_tpu_torch.utils.generators import random_lp

    wm, wn, wd = BP["race"]
    opts = SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device=dev.type)
    runs = []
    for label, fn in (("race_seeds k=8", lambda mdl: race_seeds(mdl, opts, k=8)),
                      ("racing_solve, default configs",
                       lambda mdl: racing_solve(mdl, devices=[dev.type]))):
        model = random_lp(wm, wn, density=wd)
        sol, wall, peak, launches = timed(dev, lambda: fn(model))
        if sol.status != ProblemStatus.OPTIMAL:
            raise AssertionError(f"{label}: status {sol.status!r}")
        refs.add(label, model, sol.objective_value)
        # the dual configuration prices through K1 wherever its gate holds
        if (label.startswith("racing_solve") and dev.type == "cuda"
                and wm * (wn + wm) >= 512 * 1024 and launches["K1"] <= 0):
            raise AssertionError(f"{label}: K1 never launched: {launches}")
        print(f"batch phase [{label}: {wm} x {wn}]: OPTIMAL obj={sol.objective_value!r} "
              f"(HiGHS checked below), winner {getattr(sol, 'winning_config', None)}, "
              f"iterations={sol.iterations}, wall={wall:.3f} s, peak {_mib(peak)}, "
              f"launches={launches}", flush=True)
        runs.append({"label": label, "wall": wall, "launches": launches})
    return runs


def two_stage_lp(S, n1, m2, n2, seed=0):
    """tests/test_decompose.py's `_two_stage`: a random two-stage LP with
    complete recourse (W holds +-I under a penalty), as a port TwoStageLP."""
    import scipy.sparse as sp

    from clp_tpu_torch import INF
    from clp_tpu_torch.decompose import TwoStageLP

    rng = np.random.default_rng(seed)
    c = rng.uniform(1.0, 2.0, n1)
    T = rng.uniform(-0.5, 0.5, (S, m2, n1))
    W_core = rng.uniform(-1, 1, (S, m2, n2 - 2 * m2))
    eye = np.broadcast_to(np.eye(m2), (S, m2, m2))
    W = np.concatenate([W_core, eye, -eye], axis=2)
    h = rng.uniform(0.0, 1.0, (S, m2))
    q = np.concatenate([rng.uniform(0.5, 1.5, (S, n2 - 2 * m2)),
                        np.full((S, 2 * m2), 5.0)], axis=1)
    return TwoStageLP(c=c, A=sp.csc_matrix(np.ones((1, n1))), row_lower=np.array([-INF]),
                      row_upper=np.array([10.0]), col_lower=np.zeros(n1),
                      col_upper=np.full(n1, 3.0), T=T, W=W, h=h, q=q,
                      prob=np.full(S, 1.0 / S))


def dw_blocks():
    """tests/test_decompose.py's Dantzig-Wolfe recipe: two bounded 3 x 6
    blocks and one linking capacity row; also the direct model."""
    import scipy.sparse as sp

    from clp_tpu_torch import INF, Model

    rng = np.random.default_rng(3)

    def block():
        m = Model()
        m.load_problem(sp.csc_matrix(rng.uniform(0, 1, (3, 6))), np.zeros(6), np.ones(6),
                       rng.uniform(-2, -0.5, 6), np.full(3, -INF), rng.uniform(2.0, 3.0, 3))
        return m

    b1, b2 = block(), block()
    L = sp.csc_matrix(np.ones((1, 6)))
    direct = Model()
    direct.load_problem(
        sp.vstack([sp.hstack([L, L]), sp.hstack([b1.matrix, sp.csc_matrix((3, 6))]),
                   sp.hstack([sp.csc_matrix((3, 6)), b2.matrix])], format="csc"),
        np.zeros(12), np.ones(12), np.concatenate([b1.objective, b2.objective]),
        np.concatenate([[-INF], b1.row_lower, b2.row_lower]),
        np.concatenate([[4.0], b1.row_upper, b2.row_upper]))
    return [b1, b2], [L, L], np.array([-INF]), np.array([4.0]), direct


def decompose_paths(dev) -> list:
    from clp_tpu_torch import SolveOptions, check_kkt, initial_solve
    from clp_tpu_torch.constants import ProblemStatus
    from clp_tpu_torch.decompose import dantzig_wolfe, extensive_form

    flat = extensive_form(two_stage_lp(*BP["two_stage"]))
    spy = BatchSpy()
    try:
        sol, wall, peak, launches = timed(dev, lambda: initial_solve(
            flat, SolveOptions(device=dev.type)))
    finally:
        spy.close()
    if not (spy.entered("auto_decompose_solve") and spy.entered("benders_solve")):
        raise AssertionError("DECOMPOSE: AUTOMATIC did not run auto_decompose_solve and "
                             "benders_solve")
    if sol.status != ProblemStatus.OPTIMAL:
        raise AssertionError(f"DECOMPOSE: status {sol.status!r}")
    rep = check_kkt(flat, x=sol.primal, y=sol.duals, tol=1e-6)
    if not rep.ok:
        raise AssertionError(f"DECOMPOSE: KKT check at 1e-6 failed: {rep}")
    agree("DECOMPOSE", sol.objective_value, highs_objective(flat))
    bs = spy.entered("benders_solve")[0][-1][0]
    print(f"batch phase [DECOMPOSE: flat {flat.num_rows} x {flat.num_cols}, AUTOMATIC -> "
          f"auto_decompose_solve -> benders_solve]: OPTIMAL obj={sol.objective_value!r}, "
          f"KKT ok, agrees with HiGHS on the extensive form; Benders iterations="
          f"{bs.iterations}, batched IPM calls={len(spy.entered('ipm_solve_batched'))}, "
          f"finish pivots={sol.iterations}; wall={wall:.3f} s, peak {_mib(peak)}", flush=True)
    runs = [{"label": "decompose", "wall": wall, "launches": launches}]
    blocks, links, lo, up, direct = dw_blocks()
    dsol, wall, peak, launches = timed(dev, lambda: dantzig_wolfe(
        blocks, links, lo, up, SolveOptions(device=dev.type)))
    if dsol.status != ProblemStatus.OPTIMAL:
        raise AssertionError(f"Dantzig-Wolfe: status {dsol.status!r}")
    agree("Dantzig-Wolfe", dsol.objective_value, highs_objective(direct))
    print(f"batch phase [Dantzig-Wolfe: 2 blocks of 3 x 6 + 1 linking row]: OPTIMAL "
          f"obj={dsol.objective_value!r}, agrees with HiGHS on the direct model; "
          f"master rounds={dsol.iterations}, wall={wall:.3f} s", flush=True)
    runs.append({"label": "dantzig-wolfe", "wall": wall, "launches": launches})
    return runs


def iis_path(dev) -> dict:
    """find_iis(batch=True) on `BP["iis"]` with tests/test_analysis.py:107's
    three conflicting rows over two of its columns appended."""
    import scipy.sparse as sp

    from clp_tpu_torch import INF, SolveOptions
    from clp_tpu_torch.analysis import find_iis
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.utils.generators import random_lp

    wm, wn, wd = BP["iis"]
    model = random_lp(wm, wn, density=wd)
    rows = np.zeros((3, wn))
    rows[0, :2] = 1.0  # x0 + x1 >= 4
    rows[1, 0] = 1.0  # x0 <= 1
    rows[2, 1] = 1.0  # x1 <= 1
    model.add_rows(sp.csc_matrix(rows), lower=[4.0, -INF, -INF], upper=[INF, 1.0, 1.0])
    want = [wm, wm + 1, wm + 2]
    # the f64 inverse: the Farkas ray of the f32 one carries f32 noise above
    # find_iis's 1e-9 support threshold, which makes every row a candidate
    # (1027 lanes of 1027 x 2819: the card ran out of memory, PERF.md §4)
    opts = SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device=dev.type,
                        inverse_dtype="float64")
    spy = BatchSpy()
    try:
        iis, wall, peak, launches = timed(dev, lambda: find_iis(model, opts, batch=True))
    finally:
        spy.close()
    if sorted(iis) != want:
        raise AssertionError(f"IIS: found rows {iis}, expected {want}")
    batches = [c[2][0] for c in spy.entered("solve_batch_dual_simplex")]
    if not batches:
        raise AssertionError("IIS: the deletion filter never ran a batch")
    # irreducible as tests/test_analysis.py checks it: the IIS alone is
    # infeasible (find_iis verified it) and loses that with any row freed
    opts.presolve.enabled = False
    others = sorted(set(range(model.num_rows)) - set(iis))
    for r in iis:
        t = model.copy()
        t.row_lower, t.row_upper = t.row_lower.copy(), t.row_upper.copy()
        t.row_lower[others + [r]], t.row_upper[others + [r]] = -INF, INF
        st = t.initial_solve(opts).status
        if st != ProblemStatus.OPTIMAL:
            raise AssertionError(f"IIS: with row {r} freed the rest is {st!r}, not OPTIMAL")
    print(f"batch phase [IIS: {model.num_rows} x {model.num_cols}]: rows {iis} found; "
          f"freeing any one restores feasibility; deletion-filter batches "
          f"{[len(b) for b in batches]} of {batches[0][0].num_rows}-row LPs; "
          f"wall={wall:.3f} s, peak {_mib(peak)}", flush=True)
    return {"label": "iis", "wall": wall, "launches": launches}


def batch_phase(dev, stair_ref: float) -> list:
    """ELL and PE (`ell_pe_paths`), the batched dual simplex (bench.py's
    batches, the 10,240-scenario sweep, a batch of 16 LPs), the
    batched IPM, the batched QP simplex, racing, DECOMPOSE and the IIS. Each
    model prints its route (asserted), counts, wall, instances/s where
    batched and peak device memory, and is held to HiGHS or to its single
    solve. K1 launches only on the PE dual route."""
    t_phase = time.perf_counter()
    refs = HighsRefs()
    try:
        runs = ell_pe_paths(dev, stair_ref, refs)
        runs += batched_dual_paths(dev, refs)
        runs += batched_ipm_paths(dev)
        runs.append(batched_qp_path(dev))
        runs += racing_paths(dev, refs)
        runs += decompose_paths(dev)
        runs.append(iis_path(dev))
        refs.check()
    finally:
        refs.close()
    print(f"batch phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return runs


# ---------------------------------------------------------------------------
# api_phase: the clp command line, model files, analysis, B&B hooks, C API
# ---------------------------------------------------------------------------

API_DIR = pathlib.Path(__file__).resolve().parent / "build" / "api_phase"
# sizes of the phase's extra models, and a CPU rehearsal patches smaller ones in
API = {
    "gates": 8,  # basic and nonbasic structurals whose cost ranges are gated
    "theta_end": 0.01,  # of the seeded cost direction: ~100 breakpoints here
    "breakpoints": 4,  # breakpoints held to HiGHS
    "hot_starts": 4,  # OSI bound changes held to HiGHS
    "branch_cols": 8,  # strong branching: 16 lanes
    # fathom's MIP: a seeded 0-1 multidimensional knapsack, 5 weight rows
    # x 40 items (the shape of the OR-Library mknap problems)
    "knapsack": (5, 40, 0),
}


class ApiSpy(RouteSpy):
    """The native MPS parser and the parametric walker, as `read_mps` and
    `parametrics` look them up at call time."""

    TARGETS = [("io.native", "read_mps_native"), ("analysis", "parametrics_exact")]


def lp_split_rows(model):
    """The model as the LP format writes it: a row with two different finite
    bounds becomes its upper row and then its lower row (io/lp_format.py)."""
    import scipy.sparse as sp

    from clp_tpu_torch import INF

    rl, ru = model.row_lower, model.row_upper
    take, lo, up = [], [], []
    for i in range(model.num_rows):
        if rl[i] == ru[i]:
            take.append(i), lo.append(rl[i]), up.append(ru[i])
            continue
        if ru[i] < INF:
            take.append(i), lo.append(-INF), up.append(ru[i])
        if rl[i] > -INF:
            take.append(i), lo.append(rl[i]), up.append(INF)
    A = sp.csr_matrix(model.matrix)[take]
    return A, np.array(lo), np.array(up)


def knapsack_mip(k: int, n: int, seed: int):
    """A seeded 0-1 multidimensional knapsack: max v'x, W x <= W 1 / 2."""
    import scipy.sparse as sp

    from clp_tpu_torch import INF, Model

    rng = np.random.default_rng(seed)
    W = rng.integers(5, 40, (k, n)).astype(float)
    v = rng.integers(10, 60, n).astype(float)
    m = Model()
    m.load_problem(sp.csc_matrix(W), np.zeros(n), np.ones(n), v, [-INF] * k,
                   0.5 * W.sum(axis=1))
    m.set_maximize()
    for j in range(n):
        m.set_integer(j)
    return m


def _child_env() -> dict:
    """The environment of the phase's subprocesses: this interpreter's
    module path (the C client embeds CPython), the repository root, and no
    CLPTPU_PLATFORM, so that they solve on the card."""
    import os

    env = {k: v for k, v in os.environ.items() if k != "CLPTPU_PLATFORM"}
    root = str(pathlib.Path(__file__).resolve().parent)
    env["CLPTPU_ROOT"] = root
    env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in sys.path if p])
    return env


def api_phase(dev, stair_ref: float) -> dict:
    """The surfaces a Clp user touches, on the staircase at full width:
    write it as MPS and read it back through the native parser; solve it
    with the port's `clp` command line (`-dualsimplex`, K1 on every pivot)
    with basis and solution files out, and again warm from the basis file;
    LP-format and NL round trips; ranging on the card, each gated range
    checked by a warm re-solve; the parametric walker against HiGHS at its
    breakpoints; OSI's hot starts against HiGHS and a tableau column;
    strong branching against single hot starts; `fathom` on a knapsack
    against HiGHS; the C API client and `python -m clp_tpu_torch -unitTest`
    in subprocesses on the card. Every failure raises. Returns K1's launches
    and the walls. The entry points refuse to run with CLPTPU_PLATFORM set:
    the CLI, OSI's default and the subprocesses run on the port's default
    device, the card."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    from clp_tpu_torch import SolveOptions, parametrics, ranging
    from clp_tpu_torch.branching import (mark_hot_start, solve_from_hot_start,
                                         strong_branch)
    from clp_tpu_torch.cli import CLI
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod, VariableStatus
    from clp_tpu_torch.io import native
    from clp_tpu_torch.io.lp_format import read_lp, write_lp
    from clp_tpu_torch.io.mps import read_mps, write_mps
    from clp_tpu_torch.io.nl import read_nl, write_nl
    from clp_tpu_torch.mip import fathom
    from clp_tpu_torch.osi import OsiClpTpuSolverInterface

    t_phase = time.perf_counter()
    walls: dict = {}
    API_DIR.mkdir(parents=True, exist_ok=True)
    mps, bas, sol_file = (str(API_DIR / f) for f in ("stair.mps", "stair.bas", "stair.sol"))
    refs = HighsRefs("api phase")
    spy = ApiSpy()
    try:
        # 1. the staircase as MPS, read back through the native parser
        model = staircase_model()
        t0 = time.perf_counter()
        write_mps(model, mps)
        walls["write_mps"] = time.perf_counter() - t0
        if not native.available():
            raise AssertionError("api phase: the native MPS parser did not build")
        t0 = time.perf_counter()
        back = read_mps(mps)
        walls["read_mps native"] = time.perf_counter() - t0
        if len(spy.entered("read_mps_native")) != 1 or spy.entered("read_mps_native")[0][-1] is None:
            raise AssertionError("api phase: read_mps did not take the native route")
        t0 = time.perf_counter()
        slow = read_mps(mps, use_native=False)
        walls["read_mps python"] = time.perf_counter() - t0
        for f in ("col_lower", "col_upper", "objective", "row_lower", "row_upper"):
            if not np.array_equal(getattr(back, f), getattr(slow, f)):
                raise AssertionError(f"api phase: native and Python readers differ in {f}")
        if (back.matrix != slow.matrix).nnz:
            raise AssertionError("api phase: native and Python readers differ in A")

        # 2. the cold CLI solve (CLI().run_args(argv) is cli.main(argv))
        cold, wall, _, launches = timed(dev, lambda: _cli(
            [mps, "-dualsimplex", "-basisOut", bas, "-solution", sol_file]))
        walls["cli cold"] = wall
        s = cold.model.solution
        # K1 launches only on the card (on the CPU the plain PRICE runs)
        if s.status != ProblemStatus.OPTIMAL or (launches["K1"] > 0) != (dev.type == "cuda"):
            raise AssertionError(f"api phase: cold CLI solve {s.status!r}, K1 {launches}")
        agree("api phase: cold CLI solve", s.objective_value, stair_ref)
        k1 = launches["K1"]
        reader = CLI()
        reader.run_args([mps])
        if reader.read_solution_file(sol_file) != 0:
            raise AssertionError("api phase: the solution file does not read back")
        # the file holds 8 significant digits ("%15.8g")
        if not np.allclose(reader.model.solution.primal, s.primal, rtol=5e-8, atol=1e-300):
            raise AssertionError("api phase: the solution file's primal differs")
        print(f"api phase [cli cold: {mps} -dualsimplex -basisOut -solution]: OPTIMAL "
              f"obj={s.objective_value!r} (HiGHS {stair_ref!r}); iterations={s.iterations}, "
              f"wall={wall:.3f} s, K1 launches={launches['K1']}; native MPS read "
              f"{walls['read_mps native']:.3f} s against the Python reader's "
              f"{walls['read_mps python']:.3f} s; solution file read back", flush=True)

        # 3. the warm CLI solve from the basis file
        warm, wall, _, launches = timed(dev, lambda: _cli([mps, "-basisIn", bas,
                                                             "-dualsimplex"]))
        walls["cli warm"] = wall
        k1 += launches["K1"]
        w = warm.model.solution
        if w.status != ProblemStatus.OPTIMAL or w.iterations >= 0.01 * s.iterations:
            raise AssertionError(f"api phase: warm CLI solve {w.status!r} in {w.iterations} "
                                 f"pivots (cold {s.iterations})")
        agree("api phase: warm CLI solve", w.objective_value, stair_ref)
        print(f"api phase [cli warm: -basisIn -dualsimplex]: OPTIMAL obj={w.objective_value!r}; "
              f"iterations={w.iterations} against the cold solve's {s.iterations}, "
              f"wall={wall:.3f} s", flush=True)

        # 4. LP-format and NL round trips (numbers are written in
        # round-trip form: the arrays come back exactly)
        t0 = time.perf_counter()
        write_lp(model, str(API_DIR / "stair.lp"))
        lp = read_lp(str(API_DIR / "stair.lp"))
        A, lo, up = lp_split_rows(model)
        if (lp.matrix.tocsr() != A).nnz or not (np.array_equal(lp.row_lower, lo)
                                                and np.array_equal(lp.row_upper, up)):
            raise AssertionError("api phase: the LP file's rows differ from the model's")
        write_nl(model, str(API_DIR / "stair.nl"))
        nl = read_nl(str(API_DIR / "stair.nl"))
        if (nl.matrix != model.matrix).nnz:
            raise AssertionError("api phase: the NL file's matrix differs from the model's")
        for f in ("col_lower", "col_upper", "objective"):
            if not (np.array_equal(getattr(lp, f), getattr(model, f))
                    and np.array_equal(getattr(nl, f), getattr(model, f))):
                raise AssertionError(f"api phase: {f} differs after the LP / NL round trip")
        for f in ("row_lower", "row_upper"):
            if not np.array_equal(getattr(nl, f), getattr(model, f)):
                raise AssertionError(f"api phase: {f} differs after the NL round trip")
        walls["lp and nl files"] = time.perf_counter() - t0
        print(f"api phase [files]: LP format ({lp.num_rows} rows: ranged rows split) and NL "
              f"read back equal to the model, exactly; {walls['lp and nl files']:.3f} s",
              flush=True)

        # 5. ranging on the card, gated by warm re-solves
        solved = cold.model
        rng_, wall, _, launches = timed(dev, lambda: ranging(solved, device=dev.type))
        walls["ranging"] = wall
        k1 += launches["K1"] + _ranging_gates(dev, solved, rng_, walls)
        print(f"api phase [ranging: {solved.num_rows} x {solved.num_cols}]: wall={wall:.3f} s; "
              f"{2 * API['gates']} costs moved 99% of the way to a range end keep the basis "
              f"and move the objective by dc * x_j, {walls['ranging gates']:.3f} s", flush=True)

        # 6. parametrics: the walker, its breakpoints against HiGHS
        dc = np.random.default_rng(11).standard_normal(model.num_cols)
        pts, wall, _, launches = timed(dev, lambda: parametrics(
            solved, API["theta_end"], dc=dc, device=dev.type))
        walls["parametrics"] = wall
        k1 += launches["K1"]
        res = spy.entered("parametrics_exact")[-1][-1]
        if res.status != ProblemStatus.OPTIMAL or res.pivots < 2:
            raise AssertionError(f"api phase: parametrics {res.status!r}, {res.pivots} steps")
        picks = np.unique(np.linspace(1, len(res.thetas) - 1, API["breakpoints"]).astype(int))
        for k in picks:
            mk = model.copy()
            mk.objective = model.objective + res.thetas[k] * dc
            refs.add(f"parametrics at theta={res.thetas[k]!r}", mk, res.objectives[k])
        print(f"api phase [parametrics: theta_end={API['theta_end']}]: {res.pivots} walker "
              f"steps, {len(res.thetas)} breakpoints ({len(pts)} points returned), "
              f"wall={wall:.3f} s; {picks.size} breakpoints against HiGHS below", flush=True)

        # 7. OSI: initial solve from the basis, hot starts, a tableau column
        t0 = time.perf_counter()
        zero_launches()
        si = OsiClpTpuSolverInterface(model.copy(), device=dev.type)
        si.options.method = SolveMethod.DUAL_SIMPLEX
        si.setWarmStart(solved.get_basis_status())
        si.initialSolve()
        if not si.isProvenOptimal():
            raise AssertionError("api phase: OSI initialSolve not optimal")
        agree("api phase: OSI initialSolve", si.getObjValue(), stair_ref)
        x = si.getColSolution().copy()
        basic = np.flatnonzero((si.model.solution.column_status == int(VariableStatus.BASIC))
                               & (x > 0.5) & (x < 9.5))
        pick = np.random.default_rng(5).choice(basic, API["hot_starts"], replace=False)
        si.markHotStart()
        hot_iters = []
        for j in pick:
            lo_, up_ = si.getColLower()[j], si.getColUpper()[j]
            si.setColBounds(int(j), lo_, 0.5 * x[j])
            si.solveFromHotStart()
            if not si.isProvenOptimal():
                raise AssertionError(f"api phase: solveFromHotStart on column {j}")
            refs.add(f"OSI hot start x{j} <= {0.5 * x[j]!r}", si.model.copy(), si.getObjValue())
            hot_iters.append(si.getIterationCount())
            si.setColBounds(int(j), lo_, up_)
        si.unmarkHotStart()
        si.enableFactorization()
        q = int(si.getBasics()[7])
        col = si.getBInvACol(q)
        e = np.zeros(si.getNumRows())
        e[7] = 1.0
        if not np.abs(col - e).max() <= 1e-9:
            raise AssertionError(f"api phase: getBInvACol of basic {q} is off the unit "
                                 f"vector by {np.abs(col - e).max()!r}")
        walls["osi"] = time.perf_counter() - t0
        k1 += kernel_launches()["K1"]
        print(f"api phase [OSI]: initialSolve from setWarmStart, {len(pick)} hot starts in "
              f"{hot_iters} pivots (HiGHS below); getBInvACol({q}) a unit vector within "
              f"{np.abs(col - e).max():.2e}; {walls['osi']:.3f} s", flush=True)

        # 8. strong branching: 16 lanes warm from the parent
        xs = solved.solution.primal
        frac = np.flatnonzero(np.abs(xs - np.round(xs)) > 0.1)
        cols = [int(j) for j in np.random.default_rng(3).choice(frac, API["branch_cols"],
                                                              replace=False)]
        res_b, wall, _, launches = timed(dev, lambda: strong_branch(solved, cols,
                                                                   device=dev.type))
        walls["strong branching"] = wall
        k1 += launches["K1"]
        hot = mark_hot_start(solved)
        for r in (res_b[0], res_b[-1]):
            v = xs[r.column]
            kw = (dict(new_upper=np.floor(v)) if r.direction == "down"
                  else dict(new_lower=np.ceil(v)))
            single, _, _, launches = timed(dev, lambda: solve_from_hot_start(
                solved, hot, r.column, device=dev.type, **kw))
            k1 += launches["K1"]
            if single.status != r.status or not abs(single.objective_value - r.objective) \
                    <= 1e-6 * (1 + abs(r.objective)):
                raise AssertionError(f"api phase: strong branch {r} vs its hot start "
                                     f"{single.status!r} {single.objective_value!r}")
        print(f"api phase [strong branching: {len(res_b)} lanes of {model.num_rows} x "
              f"{model.num_cols + model.num_rows}]: statuses "
              f"{sorted({r.status.name for r in res_b})}, lane pivots "
              f"{[r.iterations for r in res_b]}, wall={wall:.3f} s; first and last lanes "
              f"equal their single hot starts", flush=True)

        # 9. branch and bound
        mip = knapsack_mip(*API["knapsack"])
        W, cap = mip.matrix.toarray(), mip.row_upper
        ref = milp(-mip.objective, constraints=LinearConstraint(W, -np.inf, cap),
                   bounds=Bounds(0, 1), integrality=np.ones(mip.num_cols))
        if not ref.success:
            raise AssertionError(f"api phase: HiGHS milp failed: {ref.message}")
        fr, wall, _, launches = timed(dev, lambda: fathom(
            mip, max_nodes=5000,
            options=SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device=dev.type)))
        walls["fathom"] = wall
        k1 += launches["K1"]
        if fr.status != ProblemStatus.OPTIMAL:
            raise AssertionError(f"api phase: fathom {fr.status!r}")
        agree("api phase: fathom", fr.objective_value, -ref.fun)
        print(f"api phase [fathom: knapsack {mip.num_rows} x {mip.num_cols}]: OPTIMAL "
              f"obj={fr.objective_value!r} (HiGHS milp {-ref.fun!r}); nodes={fr.nodes}, "
              f"iterations={fr.iterations}, wall={wall:.3f} s", flush=True)

        # 10. the C API client, 11. the module entry point, on the card
        walls["c api"] = _c_api_client(dev)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "clp_tpu_torch", "-unitTest"],
                           cwd=API_DIR, env=_child_env(), capture_output=True, text=True,
                           timeout=300)
        walls["python -m unitTest"] = time.perf_counter() - t0
        if r.returncode != 0 or "unitTest: OK" not in r.stdout:
            raise AssertionError(f"api phase: python -m clp_tpu_torch -unitTest exit "
                                 f"{r.returncode}: {r.stdout[-1000:]} {r.stderr[-2000:]}")
        print(f"api phase [python -m clp_tpu_torch -unitTest]: unitTest: OK, "
              f"{walls['python -m unitTest']:.3f} s", flush=True)
        refs.check()
    finally:
        spy.close()
        refs.close()
    walls["phase"] = time.perf_counter() - t_phase
    print(f"api phase: {walls['phase']:.1f} s; walls "
          f"{ {k: round(v, 3) for k, v in walls.items()} }", flush=True)
    return {"launches": k1, "walls": walls}


def _cli(argv):
    from clp_tpu_torch.cli import CLI

    c = CLI()
    rc = c.run_args(argv)
    if rc != 0:
        raise AssertionError(f"api phase: clp {' '.join(argv)} exited {rc}")
    return c


def _ranging_gates(dev, solved, rng_, walls) -> int:
    """API["gates"] basic and as many nonbasic structurals, picked by a seed
    among those with a finite range end at least 1e-3 away (a 1% margin
    above the dual tolerance): each cost moved 99% of the way to that end,
    then a warm dual re-solve must keep the basis (no pivot) and move the
    objective by dc * x_j. Returns K1's launches."""
    from clp_tpu_torch import SolveOptions, Solution
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod, VariableStatus
    from clp_tpu_torch.simplex.driver import simplex_solve

    t0 = time.perf_counter()
    s = solved.solution
    c = solved.objective
    up_ok = np.isfinite(rng_.cost_up) & (rng_.cost_up - c >= 1e-3)
    dn_ok = np.isfinite(rng_.cost_down) & (c - rng_.cost_down >= 1e-3)
    ok = up_ok | dn_ok
    basic = s.column_status == int(VariableStatus.BASIC)
    gen = np.random.default_rng(7)
    picks = [int(j) for j in gen.choice(np.flatnonzero(ok & basic), API["gates"], replace=False)]
    picks += [int(j) for j in gen.choice(np.flatnonzero(ok & ~basic), API["gates"],
                                         replace=False)]
    opts = SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device=dev.type)
    opts.presolve.enabled = False
    warm = Solution(column_status=s.column_status, row_status=s.row_status)
    k1 = 0
    for j in picks:
        end = rng_.cost_up[j] if up_ok[j] else rng_.cost_down[j]
        dcj = 0.99 * (end - c[j])
        mm = solved.copy()
        mm.objective = c.copy()
        mm.objective[j] += dcj
        zero_launches()
        sj = simplex_solve(mm, opts, dual=True, warm=warm)
        k1 += kernel_launches()["K1"]
        if sj.status != ProblemStatus.OPTIMAL or sj.iterations != 0 or not (
                np.array_equal(sj.column_status, s.column_status)):
            raise AssertionError(f"api phase: ranging gate x{j}: cost {c[j]!r} + {dcj!r} "
                                 f"left the basis ({sj.status!r}, {sj.iterations} pivots)")
        want = s.objective_value + dcj * s.primal[j]
        if not abs(sj.objective_value - want) <= 1e-6 * (1 + abs(want)):
            raise AssertionError(f"api phase: ranging gate x{j}: objective "
                                 f"{sj.objective_value!r}, expected {want!r}")
    walls["ranging gates"] = time.perf_counter() - t0
    return k1


def _c_api_client(dev) -> float:
    """Build the port's C API and the C client test_capi.c, run the client
    with CLPTPU_PLATFORM unset (it solves on the card); returns its wall."""
    from clp_tpu_torch.io import native

    t0 = time.perf_counter()
    lib = native.build_capi()
    exe = str(API_DIR / "test_capi")
    r = subprocess.run(["gcc", str(native.NATIVE_DIR / "test_capi.c"), "-I",
                        str(native.NATIVE_DIR), str(lib), "-lm", "-o", exe],
                       capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        raise AssertionError(f"api phase: the C client did not compile: {r.stderr[-2000:]}")
    built = time.perf_counter() - t0
    r = subprocess.run([exe], cwd=API_DIR, env=_child_env(), capture_output=True, text=True,
                       timeout=300)
    wall = time.perf_counter() - t0
    if r.returncode != 0 or "C API test OK" not in r.stdout:
        raise AssertionError(f"api phase: C API client exit {r.returncode}: "
                             f"{r.stdout[-1500:]} {r.stderr[-2000:]}")
    print(f"api phase [C API: test_capi.c against libclptpu_capi, on {dev.type}]: "
          f"{r.stdout.splitlines()[0]}; C API test OK; built in {built:.3f} s, "
          f"{wall:.3f} s in all", flush=True)
    return wall


# ---------------------------------------------------------------------------
# mesh_phase: shape buckets and the device mesh
# ---------------------------------------------------------------------------

# sizes of the phase's models; a CPU rehearsal patches smaller ones in. The
# card's mesh puts every entry on the one card ("cuda:0" * MP["mesh"]), so
# no copy between devices is timed here
MP = {
    "bucket": 640,  # the staircase 2048 x 4608 pads to 2560 x 5120
    "colshard_lp": (1024, 1792, 0.05),  # bench.py's random LP
    # 2, not 4: over 4 entries of the one card the phase took 193.3 s (its
    # engine 40.9 s beside 16.2 s on one device), past its 180 s; the
    # shards are cut before any LP is made smaller (PERF.md §4)
    "colshard_shards": 2,
    "sprint_lp": (192, 3072, 0.01, 1),  # auto_phase's wide LP
    "dual_b32": (32, 64, 96, 2),  # bench.py:208
    "dual_b256": (256, 32, 48, 4),  # bench.py:237
    "ipm_b64": (64, 48, 72, 0),  # bench.py:138
    "qp": (2048, 8),  # batch_phase's risk sweep: assets, gammas
    # racing's dual configuration takes the f32 inverse and K1 here, as in
    # batch_phase (MID); at 256 x 448 every configuration ran f64, no kernel
    "race": MID,
    "mesh": 4,
}


class MeshSpy(RouteSpy):
    TARGETS = [("simplex.driver", "simplex_solve"), ("solve", "_pad_ipm_lp"),
               ("parallel.batch", "ipm_solve_batched"),
               ("interior.mehrotra", "ipm_batched_prog")]


def _devices(dev, n: int) -> list:
    return [f"{dev.type}:0" if dev.type == "cuda" else "cpu"] * n


def bucketed_paths(dev, stair_ref: float, main_pivots: int) -> list:
    """(a) the staircase's dual simplex and (b) its BARRIER with crossover,
    each with shape_bucket = MP["bucket"]: the padded shape asserted, K1 on
    every pivot of the padded dual simplex, the stripped answer held to
    HiGHS and to the port's KKT check on the model itself."""
    from clp_tpu_torch import SolveOptions, check_kkt, initial_solve
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.simplex.driver import _bucket_shape

    runs = []
    bucket = MP["bucket"]
    for label, method in (("dual simplex", "DUAL_SIMPLEX"), ("barrier", "BARRIER")):
        model = staircase_model()
        opts = SolveOptions(method=SolveMethod[method], device=dev.type, shape_bucket=bucket)
        spy = MeshSpy()
        try:
            sol, wall, peak, launches = timed(dev, lambda: initial_solve(model, opts))
        finally:
            spy.close()
        if sol.status != ProblemStatus.OPTIMAL:
            raise AssertionError(f"bucketed {label}: status {sol.status!r}")
        calls = [(c[2][0].num_rows, c[2][0].num_cols, c[2][1].shape_bucket)
                 for c in spy.entered("simplex_solve")]
        outer = [c for c in calls if c[2] == bucket]
        padded = [c[:2] for c in calls if c[2] == 0]
        want = _bucket_shape(*outer[0][:2], bucket) if outer else None
        if not outer or want not in padded:
            raise AssertionError(f"bucketed {label}: simplex calls {calls}, expected a "
                                 f"padded solve at {want}")
        if method == "BARRIER":
            pads = spy.entered("_pad_ipm_lp")
            stats = sol.timings.get("barrier_stats") or {}
            if len(pads) != 1 or not str(stats.get("branch", "")).startswith("banded"):
                raise AssertionError(f"bucketed barrier: {len(pads)} pads, stats {stats}")
        if dev.type == "cuda" and (launches["K1"] < sol.iterations or launches["K1"] <= 0
                                   or launches["K2"] or launches["K3"]):
            raise AssertionError(f"bucketed {label}: K1 not on every pivot: {launches}, "
                                 f"{sol.iterations} pivots")
        if sol.primal.shape != (model.num_cols,) or sol.duals.shape != (model.num_rows,):
            raise AssertionError(f"bucketed {label}: vectors not stripped: "
                                 f"{sol.primal.shape}, {sol.duals.shape}")
        rep = check_kkt(model, x=sol.primal, y=sol.duals, tol=1e-6)
        if not rep.ok:
            raise AssertionError(f"bucketed {label}: KKT check at 1e-6 failed: {rep}")
        agree(f"bucketed {label}", sol.objective_value, stair_ref)
        extra = ""
        if method == "BARRIER":
            extra = (f"; {stats['branch']}, IPM {stats['iterations']} iterations "
                     f"({'converged' if stats['converged'] else 'NOT converged'}) in "
                     f"{stats['seconds']:.3f} s, crossover pivots {sol.iterations}")
        else:
            extra = f"; {sol.iterations} pivots (unbucketed K1 main path: {main_pivots})"
        print(f"mesh phase [bucketed {label}: staircase {model.num_rows} x {model.num_cols} "
              f"padded to {want[0]} x {want[1]} at bucket {bucket}]: OPTIMAL "
              f"obj={sol.objective_value!r} (HiGHS {stair_ref!r}), KKT ok on the model"
              f"{extra}; wall={wall:.3f} s, peak {_mib(peak)}, launches={launches}",
              flush=True)
        runs.append({"label": f"bucketed {label}", "wall": wall, "launches": launches})
    return runs


def colsharded_path(dev, refs, shards: int) -> dict:
    """(c) bench.py's random LP through dual_solve_colsharded over `shards`
    mesh entries with the card's engine settings, against the port's
    single-device engine on the same LP and HiGHS."""
    from clp_tpu_torch.forms import to_standard_form
    from clp_tpu_torch.parallel.colshard import dual_solve_colsharded, make_block_mesh
    from clp_tpu_torch.simplex import engine
    from clp_tpu_torch.utils.generators import random_lp

    m, n, d = MP["colshard_lp"]
    model = random_lp(m, n, density=d)
    lp, _ = to_standard_form(model, device=dev)
    opts = engine.SimplexOptions(inverse_dtype="float32", dual_ratio="bfrt",
                                 inner_unroll=8, refactor_frequency=400)

    def objective(lp_, s):
        xn = engine.nonbasic_values(lp_, s.vstat, opts.dual_bound)
        return float(lp_.c.index_select(0, s.basis) @ s.xb + lp_.c @ xn)

    def single():
        s = engine.initial_state(lp, opts)
        s = engine.make_dual_feasible(lp, engine.recompute(lp, s, opts.dual_bound), opts)
        return engine.dual_solve(lp, s, opts)

    ref, wall1, _, _ = timed(dev, single)
    stats = {}
    (st, slp, nt0), wall, peak, launches = timed(dev, lambda: dual_solve_colsharded(
        lp, opts, make_block_mesh(_devices(dev, shards)), stats=stats))
    if int(st.status) != engine.OPTIMAL or int(ref.status) != engine.OPTIMAL:
        raise AssertionError(f"colsharded: status {int(st.status)}, single {int(ref.status)}")
    if any(launches.values()):
        raise AssertionError(f"colsharded: a kernel launched: {launches}")
    obj, obj1 = objective(slp, st), objective(lp, ref)
    agree("colsharded vs the single-device engine", obj, obj1)
    refs.add("colsharded", model, obj)
    print(f"mesh phase [column-sharded dual engine: random_lp({m}, {n}), simplex form "
          f"{lp.G.shape[0]} x {lp.G.shape[1]} padded to {slp.nt}, {shards} shards on "
          f"{_devices(dev, shards)[0]}; f32 inverse, BFRT, U=8, refactor 400]: OPTIMAL "
          f"obj={obj!r} (single-device {obj1!r}; HiGHS checked below); "
          f"pivots {int(st.iterations)} (single-device {int(ref.iterations)}); "
          f"wall={wall:.3f} s (single-device {wall1:.3f} s); elements moved between "
          f"shards per pivot {stats['elements_per_pivot']:.0f} over "
          f"{stats['pivots']} engine iterations, {stats['elements']} in all; "
          f"peak {_mib(peak)}", flush=True)
    return {"label": "colsharded", "wall": wall, "launches": launches}


def block_sprint_path(dev, refs) -> dict:
    """(d) SPRINT on auto_phase's wide LP with a 4-entry "block" mesh given
    as options.devices: the sharded repricing asserted, HiGHS below."""
    from clp_tpu_torch import SolveOptions, check_kkt, initial_solve
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.parallel.block import BlockShardedColumns, make_block_mesh
    from clp_tpu_torch.utils.generators import random_lp

    m, n, d, seed = MP["sprint_lp"]
    model = random_lp(m, n, density=d, seed=seed)
    opts = SolveOptions(method=SolveMethod.SPRINT, device=dev.type,
                        devices=make_block_mesh(_devices(dev, MP["mesh"])))
    calls = []
    inner = BlockShardedColumns.reprice

    def reprice(self, y, k=256):
        calls.append(len(self.G))
        return inner(self, y, k)

    BlockShardedColumns.reprice = reprice
    try:
        sol, wall, peak, launches = timed(dev, lambda: initial_solve(model, opts))
    finally:
        BlockShardedColumns.reprice = inner
    if sol.status != ProblemStatus.OPTIMAL or not calls or set(calls) != {MP["mesh"]}:
        raise AssertionError(f"block SPRINT: status {sol.status!r}, reprices {calls}")
    rep = check_kkt(model, x=sol.primal, y=sol.duals, tol=1e-6)
    if not rep.ok:
        raise AssertionError(f"block SPRINT: KKT check at 1e-6 failed: {rep}")
    refs.add("block SPRINT", model, sol.objective_value)
    print(f"mesh phase [block-sharded SPRINT: {m} x {n}, {MP['mesh']} shards]: OPTIMAL "
          f"obj={sol.objective_value!r} (HiGHS checked below), KKT ok; {len(calls)} sharded "
          f"repricings, iterations={sol.iterations}, wall={wall:.3f} s, peak {_mib(peak)}, "
          f"launches={launches}", flush=True)
    return {"label": "block SPRINT", "wall": wall, "launches": launches}


def sharded_batch_paths(dev) -> list:
    """(e) bench.py's batched dual simplex (B = 32 and 256), the B = 64 IPM
    batch and the risk sweep, each unsharded and over a 4-entry
    "scenario" mesh: every lane the same status as its unsharded lane and
    the objective within 1e-9 relative."""
    from clp_tpu_torch import SolveOptions
    from clp_tpu_torch.constants import ProblemStatus, SolveMethod
    from clp_tpu_torch.parallel.batch import solve_batch_dual_simplex, solve_batch_qp_simplex
    from clp_tpu_torch.parallel.mesh import make_mesh
    from clp_tpu_torch.solve import solve_batch
    from clp_tpu_torch.utils.generators import random_lp

    mesh = make_mesh(_devices(dev, MP["mesh"]))
    dual_opts = SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device=dev.type)
    dual_opts.presolve.enabled = False
    rng = np.random.default_rng(3)
    specs = []
    for key in ("dual_b32", "dual_b256"):
        B, m, n, seed = MP[key]
        specs.append((f"batched dual {key[5:]}", perturbed(random_lp(m, n, seed=seed), B, rng),
                      lambda ms, **kw: solve_batch_dual_simplex(ms, dual_opts, **kw)))
    B, m, n, seed = MP["ipm_b64"]
    specs.append(("batched IPM b64", perturbed(random_lp(m, n, seed=seed), B,
                                               np.random.default_rng(1)),
                  lambda ms, **kw: solve_batch(ms, SolveOptions(device=dev.type), **kw)))
    nq, gq = MP["qp"]
    specs.append((f"batched QP simplex {gq} gammas x {nq} assets",
                  [portfolio_qp(nq, gamma=g) for g in np.linspace(0.5, 8.0, gq)],
                  lambda ms, **kw: solve_batch_qp_simplex(ms, SolveOptions(device=dev.type),
                                                          **kw)))
    runs = []
    for label, models, fn in specs:
        plain, wall0, _, l0 = timed(dev, lambda: fn([x.copy() for x in models]))
        spy = MeshSpy()
        try:
            sharded, wall, peak, launches = timed(
                dev, lambda: fn([x.copy() for x in models], mesh=mesh))
        finally:
            spy.close()
        if spy.entered("simplex_solve"):
            raise AssertionError(f"{label}: a lane fell back to the single-LP driver")
        if label.startswith("batched IPM") and (spy.entered("ipm_solve_batched")
                                                or len(spy.entered("ipm_batched_prog"))
                                                != MP["mesh"]):
            raise AssertionError(f"{label}: not one lockstep IPM program per mesh entry")
        for i, (s, p) in enumerate(zip(sharded, plain)):
            if s.status != p.status or s.status != ProblemStatus.OPTIMAL or not abs(
                    s.objective_value - p.objective_value) <= 1e-9 * (1 + abs(p.objective_value)):
                raise AssertionError(f"{label} lane {i}: sharded {s.status!r} "
                                     f"{s.objective_value!r} vs unsharded {p.status!r} "
                                     f"{p.objective_value!r}")
        if any(launches.values()) or any(l0.values()):
            raise AssertionError(f"{label}: a kernel launched under the batch")
        B = len(models)
        print(f"mesh phase [{label}: B={B} over {MP['mesh']} entries of the "
              f"\"scenario\" mesh]: all {B} lanes OPTIMAL as unsharded, each objective "
              f"within 1e-9 relative of its unsharded lane; "
              f"wall={wall:.3f} s, {B / wall:.1f} instances/s against unsharded "
              f"{wall0:.3f} s, {B / wall0:.1f} instances/s; peak {_mib(peak)}", flush=True)
        runs.append({"label": label, "wall": wall, "launches": launches})
    return runs


def racing_devices_path(dev, refs) -> dict:
    """(f) racing_solve over a 3-entry device list."""
    from clp_tpu_torch.constants import ProblemStatus
    from clp_tpu_torch.parallel.racing import racing_solve
    from clp_tpu_torch.utils.generators import random_lp

    m, n, d = MP["race"]
    model = random_lp(m, n, density=d)
    devs = _devices(dev, 3)
    sol, wall, peak, launches = timed(dev, lambda: racing_solve(model, devices=devs))
    if sol.status != ProblemStatus.OPTIMAL:
        raise AssertionError(f"racing over {devs}: status {sol.status!r}")
    # the dual configuration prices through K1 wherever its gate holds
    if dev.type == "cuda" and m * (n + m) >= 512 * 1024 and launches["K1"] <= 0:
        raise AssertionError(f"racing over {devs}: K1 never launched: {launches}")
    refs.add("racing over 3 devices", model, sol.objective_value)
    print(f"mesh phase [racing_solve over {devs}: {m} x {n}]: OPTIMAL "
          f"obj={sol.objective_value!r} (HiGHS checked below), winner "
          f"{getattr(sol, 'winning_config', None)}, wall={wall:.3f} s, launches={launches}",
          flush=True)
    return {"label": "racing", "wall": wall, "launches": launches}


def mesh_phase(dev, stair_ref: float, main_pivots: int) -> dict:
    """Shape buckets and the device mesh, (a)-(g): the bucketed staircase's
    dual simplex (K1) and barrier, the column-sharded dual engine, SPRINT
    over a "block" mesh, the scenario-sharded batches, racing over 3
    devices and the port's multi-device dry run. Returns the K1 launches
    and the phase's wall."""
    from clp_tpu_torch.parallel.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    refs = HighsRefs("mesh phase")
    try:
        runs = bucketed_paths(dev, stair_ref, main_pivots)
        runs.append(colsharded_path(dev, refs, MP["colshard_shards"]))
        runs.append(block_sprint_path(dev, refs))
        runs += sharded_batch_paths(dev)
        runs.append(racing_devices_path(dev, refs))
        _, wall, _, launches = timed(dev, lambda: dryrun_multichip(_devices(dev, MP["mesh"])))
        print(f"mesh phase [dryrun_multichip over {_devices(dev, MP['mesh'])}]: both axes "
              f"ran (scenario IPM, block repricing + SPRINT, column-sharded dual, QP "
              f"sweep); wall={wall:.3f} s", flush=True)
        runs.append({"label": "dry run", "wall": wall, "launches": launches})
        refs.check()
    finally:
        refs.close()
    wall = time.perf_counter() - t_phase
    print(f"mesh phase: {wall:.1f} s (every mesh entry on {_devices(dev, 1)[0]}: no copy "
          f"between devices is measured)", flush=True)
    return {"launches": sum(r["launches"]["K1"] for r in runs), "wall": wall, "runs": runs}


def device_profile(prof, n: int, route: str):
    """(device busy us, kernel events, top 10 (name, us)) of a profiled
    window of n pivots; every kernel's time and launches per pivot go to
    build/profiles/profile_<route>.txt."""
    from torch.autograd import DeviceType

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
    return busy, kernels, [(name, t) for name, (t, _) in table[:10]]


def profile_batch(dev, pivots: int = 200) -> None:
    """Where a batched pivot's time goes: the wide batch of batch_phase (B
    perturbed-RHS copies of the bench LP, f32 inverse, blocks of 8 gated
    pivots per host read), two windows of up to `pivots` batched pivots
    from a fresh refactorization, the second under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from clp_tpu_torch import SolveOptions
    from clp_tpu_torch.parallel import batch as pb
    from clp_tpu_torch.utils.generators import random_lp
    from clp_tpu_torch.utils.lockstep import run

    wm, wn, wd = BP["wide"]
    models = perturbed(random_lp(wm, wn, density=wd), BP["wide_batch"],
                       np.random.default_rng(3))
    lp, _ = pb.stack_models_simplex(models, dev)
    opts = pb._engine_options(SolveOptions(device=dev.type), wm, dev.type == "cuda")
    E = pb._Lanes(pb._lpd(lp), opts)
    S = pb._bprep(E, E.initial_state())
    B = len(models)
    live = torch.ones(B, dtype=torch.bool, device=dev)

    def window(S, n):
        it0 = S["iterations"].clone()
        t0 = time.perf_counter()
        S = run(pb._chunk(S, live, E.dual_step, n, opts.inner_unroll, opts.max_iterations))
        torch.cuda.synchronize()
        return S, int((S["iterations"] - it0).sum()), time.perf_counter() - t0

    S, _, _ = window(S, 16)  # warm-up
    S = E.recompute(S)
    S, lanes_plain, wall_plain = window(S, pivots)
    S = E.recompute(S)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        S, lanes, wall = window(S, pivots)
    n = pivots  # batched steps of the window (every lane gated alike)
    busy, kernels, top = device_profile(prof, n, "batch")
    print(f"pivot profile [batch] (B={B} x {wm} x {wn}, {opts.inverse_dtype} inverse, "
          f"blocks of {opts.inner_unroll}; {pivots} batched pivots a window): wall "
          f"{1e3 * wall_plain / n:.3f} ms a batched pivot ({lanes_plain} lane pivots, "
          f"{lanes_plain / wall_plain:.1f}/s), {1e3 * wall / n:.3f} ms under the profiler; "
          f"device busy {1e-3 * busy / n:.3f} ms a batched pivot "
          f"({100 * busy / (1e6 * wall):.1f}% of the profiled wall, idle "
          f"{100 - 100 * busy / (1e6 * wall):.1f}%), {len(kernels) / n:.1f} kernel launches "
          f"a batched pivot; top device time a batched pivot (us): "
          + "; ".join(f"{name[:80]} = {t / n:.1f}" for name, t in top)
          + " (every kernel: build/profiles/profile_batch.txt)", flush=True)


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
    busy, kernels, top = device_profile(prof, n, route)
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


# ---------------------------------------------------------------------------
# the phases after the main paths, in child processes that run at once
# ---------------------------------------------------------------------------

# Every phase after the main paths is host-bound: one process keeps the card
# busy ~9% of a pivot (PERF.md §5), and in one process they took 829-1062 s
# of a run allowed 1200. Each group runs in a child process of its own, all
# started together (a group's phases in turn), so the run takes about its
# longest group. The kernels and the main paths run before, alone, so their
# times are not shared with another process.
PHASE_GROUPS = (("batch",), ("mesh",), ("auto", "nonlinear"), ("barrier", "api"))
# the children's CPU threads (torch, BLAS), so that four engines and their
# HiGHS workers share the host's cores without waiting on one another's spins
CHILD_THREADS = "2"
# the children are stopped, and the run fails, at this many seconds from the
# start: inside the 1200 s the run is allowed
CHILD_DEADLINE_S = 1140.0


def run_phases(names, stair_ref: float, main_pivots: int) -> dict:
    """Run the named phases in turn in this process, the launch counts set
    to 0 just before each and read just after (a phase sums its runs' own
    counts), then the barrier's profiled factorizations last, since a
    traced process launches more slowly. Returns {phase: {"wall": s,
    "launches": {kernel: n}}}."""
    dev = torch.device("cuda")

    def k1(runs):
        return {"K1": sum(r["launches"]["K1"] for r in runs if "launches" in r)}

    def batch():
        BP.update(BP_CUTS)
        runs = batch_phase(dev, stair_ref)
        return {k: sum(r["launches"][k] for r in runs) for k in ("K1", "K2", "K3")}

    barrier_runs: list = []

    def barrier():
        barrier_runs.extend(barrier_phase(dev))
        return {}

    drive = {"barrier": barrier,
             "auto": lambda: k1(auto_phase(dev)),
             "nonlinear": lambda: k1(nonlinear_phase(dev)),
             "batch": batch,
             "api": lambda: {"K1": api_phase(dev, stair_ref)["launches"]},
             "mesh": lambda: {"K1": mesh_phase(dev, stair_ref, main_pivots)["launches"]}}
    out = {}
    for name in names:
        t0 = time.perf_counter()
        zero_launches()
        launches = drive[name]()
        out[f"{name} phase"] = {"wall": time.perf_counter() - t0, "launches": launches}
    if barrier_runs:
        t0 = time.perf_counter()
        factor_launches(barrier_runs)
        out["factorization launches"] = {"wall": time.perf_counter() - t0, "launches": {}}
    return out


def _stop_group(proc) -> None:
    """Stop a child and every process it started (its own session)."""
    import os
    import signal

    for sig in (signal.SIGTERM, signal.SIGKILL):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            return
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            continue
        if sig == signal.SIGTERM:
            time.sleep(1)  # its workers' own exit, before the group's SIGKILL


def run_phase_groups(stair_ref: float, main_pivots: int, t_start: float) -> dict | None:
    """Start one child (`chip_smoke.py --phases`) for each of PHASE_GROUPS,
    all together, and wait for them; then print their logs in turn and
    return their phases' walls and launches, or None when a child failed or
    the deadline passed. Every child and what it started is stopped before
    this returns."""
    import os
    import signal

    log_dir = pathlib.Path(__file__).resolve().parent / "build" / "smoke_phases"
    log_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        env[var] = CHILD_THREADS
    children = []
    # the driver's SIGTERM ends the parent through its `finally`
    old = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    failed = None
    try:
        for group in PHASE_GROUPS:
            stem = "+".join(group)
            log, res = log_dir / f"{stem}.log", log_dir / f"{stem}.json"
            res.unlink(missing_ok=True)
            with open(log, "w") as fh:
                proc = subprocess.Popen(
                    [sys.executable, str(pathlib.Path(__file__).resolve()), "--phases",
                     ",".join(group), repr(stair_ref), str(main_pivots), str(res)],
                    stdout=fh, stderr=subprocess.STDOUT, env=env, start_new_session=True)
            children.append((stem, proc, log, res))
        pending = list(children)
        while pending and failed is None:
            time.sleep(1.0)
            for child in list(pending):
                stem, proc, _, _ = child
                if proc.poll() is None:
                    continue
                pending.remove(child)
                _stop_group(proc)
                print(f"[{time.perf_counter() - t_start:.1f} s since the start] child "
                      f"{stem} done, exit code {proc.returncode}", flush=True)
                if proc.returncode != 0:
                    failed = f"child {stem} exited {proc.returncode}"
            if pending and time.perf_counter() - t_start > CHILD_DEADLINE_S:
                failed = (f"children {[c[0] for c in pending]} still running "
                          f"{CHILD_DEADLINE_S:.0f} s from the start")
    finally:
        for _, proc, _, _ in children:
            _stop_group(proc)
        signal.signal(signal.SIGTERM, old)
    phases: dict = {}
    for stem, proc, log, res in children:
        print(f"--- child {stem} ---", flush=True)
        sys.stdout.write(log.read_text(errors="replace"))
        if proc.returncode == 0:
            phases.update(json.loads(res.read_text()))
    sys.stdout.flush()
    if failed is not None:
        print(f"chip_smoke: {failed}", file=sys.stderr)
        return None
    return phases


def phases_main(names: str, stair_ref: str, main_pivots: str, result: str) -> int:
    """`chip_smoke.py --phases barrier,api STAIR_REF MAIN_PIVOTS RESULT`: the
    child that the no-argument run starts for one of PHASE_GROUPS. It runs
    those phases (`run_phases`, with the no-argument run's cuts) against the
    staircase's HiGHS objective and its K1 pivots from the parent's main
    path, and writes their walls and launches to RESULT as JSON."""
    import os

    if not torch.cuda.is_available() or "CLPTPU_PLATFORM" in os.environ:
        print("chip_smoke: no card, or CLPTPU_PLATFORM is set", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from clp_tpu_torch.ops import build

    build.build_all(["price", "pivot", "price_block"])  # built by the parent: a hash check
    out = run_phases(names.split(","), float(stair_ref), int(main_pivots))
    pathlib.Path(result).write_text(json.dumps(out))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from clp_tpu_torch.ops import build

    import os

    if "CLPTPU_PLATFORM" in os.environ:
        print("chip_smoke: CLPTPU_PLATFORM is set; unset it to run on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_walls: dict = {}

    def mark(phase: str) -> None:
        now = time.perf_counter() - t_start
        phase_walls[phase] = now - sum(phase_walls.values())
        print(f"[{now:.1f} s since the start] {phase} done", flush=True)

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
    # the wide shapes, under "above_limit": m past 4 rows of binv in one
    # block's shared memory (14,465 odd)
    k2["above_limit"] = [check_k2_wide(dev, flush, m) for m in (14465, 16384, 24576)]
    k3 = check_k3(dev, flush, *staircase_blocks(dev, G32))
    del flush, G32
    mark("kernel phase")

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
    mark("main paths")
    torch.cuda.empty_cache()  # the kernel phase's wide K2 buffers, for the children
    t_groups = time.perf_counter()
    phases = run_phase_groups(highs_obj, run_k1["iterations"], t_start)
    if phases is None:
        return 1
    k1["auto_phase_launches"] = phases["auto phase"]["launches"]["K1"]
    k1["nonlinear_phase_launches"] = phases["nonlinear phase"]["launches"]["K1"]
    for rec, name in ((k1, "K1"), (k2, "K2"), (k3, "K3")):
        rec["batch_phase_launches"] = phases["batch phase"]["launches"][name]
    k1["api_phase_launches"] = phases["api phase"]["launches"]["K1"]
    k1["mesh_phase_launches"] = phases["mesh phase"]["launches"]["K1"]
    print("phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_walls.items())
          + ", then in " + f"{len(PHASE_GROUPS)} processes at once: "
          + ", ".join(f"{k} {v['wall']:.1f}" for k, v in phases.items())
          + f" ({time.perf_counter() - t_groups:.1f} in all); "
          f"total {time.perf_counter() - t_start:.1f}", flush=True)
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "wrapper_ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    extra = ("launch_floor_ms", "above_limit", "auto_phase_launches",
             "nonlinear_phase_launches", "batch_phase_launches", "api_phase_launches",
             "mesh_phase_launches")
    print(json.dumps({"kernels": [
        {k: rec[k] for k in keys} | {k: v for k, v in rec.items() if k in extra}
        for rec in (k1, k2, k3)]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def nonlinear_main() -> int:
    """`chip_smoke.py --nonlinear`: the kernels' build and `nonlinear_phase`
    alone, for work on that phase (the contract run is the one with no
    arguments)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from clp_tpu_torch.ops import build

    print(f"card: {nvidia_smi()}", flush=True)
    build.build_all(["price", "pivot", "price_block"])
    nonlinear_phase(torch.device("cuda"))
    return 0


def batch_main() -> int:
    """`chip_smoke.py --batch`: the kernels' build and `batch_phase` alone at
    BP's sizes, without BP_CUTS (the contract run is the one with no
    arguments)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from clp_tpu_torch.ops import build

    print(f"card: {nvidia_smi()}", flush=True)
    build.build_all(["price", "pivot", "price_block"])
    batch_phase(torch.device("cuda"), highs_objective(staircase_model()))
    return 0


def api_main() -> int:
    """`chip_smoke.py --api`: the kernels' build and `api_phase` alone (the
    contract run is the one with no arguments)."""
    import os

    if not torch.cuda.is_available() or "CLPTPU_PLATFORM" in os.environ:
        print("chip_smoke: no card, or CLPTPU_PLATFORM is set", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from clp_tpu_torch.ops import build

    print(f"card: {nvidia_smi()}", flush=True)
    build.build_all(["price", "pivot", "price_block"])
    api_phase(torch.device("cuda"), highs_objective(staircase_model()))
    return 0


def mesh_main() -> int:
    """`chip_smoke.py --mesh`: the kernels' build and `mesh_phase` alone (the
    contract run is the one with no arguments)."""
    import os

    if not torch.cuda.is_available() or "CLPTPU_PLATFORM" in os.environ:
        print("chip_smoke: no card, or CLPTPU_PLATFORM is set", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from clp_tpu_torch.ops import build

    print(f"card: {nvidia_smi()}", flush=True)
    build.build_all(["price", "pivot", "price_block"])
    mesh_phase(torch.device("cuda"), highs_objective(staircase_model()),
               main_path("K1", False)["iterations"])
    return 0


def profiler_cost_main() -> int:
    """`chip_smoke.py --profiler-cost`: in one process, the staircase's K1
    solve twice, then one torch.profiler trace of a single launch, then the
    same solve again: what a trace leaves on every later launch's host
    time (why the no-argument run counts its launches last)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from clp_tpu_torch.ops import build

    print(f"card: {nvidia_smi()}", flush=True)
    build.build_all(["price", "pivot", "price_block"])
    walls = []
    for i in range(3):
        if i == 2:
            launches_of(lambda: torch.zeros(1, device="cuda"))
        t0 = time.perf_counter()
        main_path("K1", False)
        walls.append(time.perf_counter() - t0)
    print(f"profiler cost: the staircase's K1 solve {walls[0]:.3f} s, {walls[1]:.3f} s, "
          f"then after one trace {walls[2]:.3f} s", flush=True)
    return 0


def race_configs_main() -> int:
    """`chip_smoke.py --race-configs`: racing's three default
    configurations, each alone (twice: the first pays its warm-up), one
    after another, then racing_solve over 3 entries of the card, on
    racing's LP of the mesh phase (MP["race"]): what the race's threads
    cost against running the configurations in turn."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import dataclasses

    from clp_tpu_torch.ops import build
    from clp_tpu_torch.parallel.racing import default_race_configs, racing_solve
    from clp_tpu_torch.utils.generators import random_lp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"card: {nvidia_smi()}", flush=True)
    build.build_all(["price", "pivot", "price_block"])
    m, n, d = MP["race"]
    model = random_lp(m, n, density=d)
    for i, opts in enumerate(default_race_configs()):
        opts = dataclasses.replace(opts, device="cuda")
        for rep in range(2):
            sol, wall, _, launches = timed(torch.device("cuda"),
                                           lambda: model.copy().initial_solve(opts))
            print(f"race configs [{m} x {n}]: configuration {i} ({opts.method.name}) alone, "
                  f"run {rep + 1}: {sol.status!r} obj={sol.objective_value!r}, "
                  f"iterations={sol.iterations}, wall={wall:.3f} s, "
                  f"barrier {sol.timings.get('barrier_stats')}, launches={launches}",
                  flush=True)
    devs = ["cuda:0"] * 3
    sol, wall, _, launches = timed(torch.device("cuda"),
                                   lambda: racing_solve(model, devices=devs))
    print(f"race configs [{m} x {n}]: racing_solve over {devs}: {sol.status!r}, winner "
          f"{getattr(sol, 'winning_config', None)}, wall={wall:.3f} s, launches={launches}",
          flush=True)
    return 0


def profile_main(route: str) -> int:
    """`chip_smoke.py --profile-pivots dense|block|batch`: one profile alone,
    in a fresh process (torch.profiler leaves state behind that slows the
    host side of its process, and the same pivots ran slower after the
    solves of the contract run than in a fresh process)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if route == "batch":
        profile_batch(torch.device("cuda"))
    else:
        profile_pivots(torch.device("cuda"), route)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--profile-pivots" and args[1] in ("dense", "block",
                                                                        "batch"):
        sys.exit(profile_main(args[1]))
    if len(args) == 5 and args[0] == "--phases":
        sys.exit(phases_main(*args[1:]))
    if args == ["--nonlinear"]:
        sys.exit(nonlinear_main())
    if args == ["--batch"]:
        sys.exit(batch_main())
    if args == ["--api"]:
        sys.exit(api_main())
    if args == ["--mesh"]:
        sys.exit(mesh_main())
    if args == ["--profiler-cost"]:
        sys.exit(profiler_cost_main())
    if args == ["--race-configs"]:
        sys.exit(race_configs_main())
    sys.exit(main())
