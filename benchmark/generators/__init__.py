"""One generator per configuration family, found by the configuration's
`generator` key: `base(cfg)` builds the fixed part of the LP, `batch(cfg,
base, rng, lanes)` one call's scenarios, as arrays (A, c, l, u, rl, ru)."""
