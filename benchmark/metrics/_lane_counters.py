"""Per-lane and per-step readings of the program's counters, for the
readers of the batched dual's float32 route (f64_finish_lane_pct,
leftover_lane_pct, pivot32_hbm_pct)."""

from ._program_trace import counter, span_ns, timed_roots

HBM_BYTES_PER_S = 3.35e12  # one H100's HBM3 (NVIDIA's data sheet, SXM)


def lane_share(ctx, name: str, absent):
    """The counter `name` over the timed roots' summed `lanes` attribute,
    in %. Where no timed root holds the counter, `absent` stands for it
    (None: the metric is not read)."""
    roots = timed_roots(ctx)
    lanes = sum(r["attrs"].get("lanes", 0) for r in roots)
    if lanes <= 0:
        return None
    if not any(name in r["counters"] for r in roots):
        return None if absent is None else float(absent)
    return 100.0 * counter(roots, name) / lanes


def pivot32_step_bytes(m: int, n: int) -> int:
    """The bytes one lane-step of the float32 dual pivot moves at least, on
    the m x n standard form: the dense PRICE's one read of the float32 G
    (4 m n) and the rank-1 update's one read and one write of the float32
    inverse (8 m^2)."""
    return 4 * m * n + 8 * m * m


def pivot32_hbm_pct(ctx):
    """lane_steps_f32 x pivot32_step_bytes over the time of the float32
    loop (span `loop` less its child `f64_finish`) at the HBM's bytes a
    second, in %; None where the program counts no float32 lane-steps."""
    roots = [r for r in timed_roots(ctx) if "lane_steps_f32" in r["counters"]]
    if not roots:
        return None
    moved = sum(r["counters"]["lane_steps_f32"]
                * pivot32_step_bytes(r["attrs"]["m"], r["attrs"]["n"]) for r in roots)
    ns = sum(span_ns(r, ("loop",)) - span_ns(r, ("f64_finish",)) for r in roots)
    if ns <= 0 or moved <= 0:
        return None
    return 100.0 * moved / HBM_BYTES_PER_S / (ns * 1e-9)
