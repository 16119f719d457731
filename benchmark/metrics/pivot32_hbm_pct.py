"""The float32 batched pivot's share of the byte roofline: the bytes its
lane-steps move at least (the program's counter `lane_steps_f32` times
`_lane_counters.pivot32_step_bytes` at the root's m and n) over the time
of the float32 loop (span `loop` less `f64_finish`) at 3.35e12 B/s, in %,
over the window's timed calls."""

from ._lane_counters import pivot32_hbm_pct


def read(ctx):
    return pivot32_hbm_pct(ctx)
