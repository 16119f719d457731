"""One reader per per-layer metric, found by the metric's name: `read(ctx)`
returns the value, or None where the run holds nothing to read."""
