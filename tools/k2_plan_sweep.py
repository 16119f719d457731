"""Time K2 (csrc/pivot.cu) at one m under launch geometries around the one
`ops/pivot.py:k2_plan` picks, on the card.

    python3 tools/k2_plan_sweep.py M [M ...]

For each m: the plan's own geometry, then variants of it (cluster size C,
rows a tile R, stages S, clusters G), each checked once against the plain
version and timed as `chip_smoke.cold_ms` times kernels (busy stream,
median of 30 launches, 64 MB zeroed before each). Prints one line per
geometry and the card's name and power limit. This is how the plan's
choices were made; the script needs a card and imports nothing of JAX.
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from clp_tpu_torch.ops import build, pivot  # noqa: E402


def variants(m: int, base: pivot.PivotPlan):
    """The plan, then other cluster sizes, tiles, stages and cluster counts
    that fit in shared memory."""
    yield base
    for c in (1, 2, 4, 8):
        w = 4 * -(-(-(-m // c)) // 4)
        if (c - 1) * w >= m:
            continue
        rows = pivot._ring_rows(w)
        for R in (2, 4, 8):
            for S in (2, 3, 4):
                if R * S > rows:
                    continue
                tiles = -(-m // R)
                for G in sorted({min(tiles, 132 // c), min(tiles, 264 // c)}):
                    p = pivot.PivotPlan(c, w, R, S, tiles, G, pivot.K2_THREADS,
                                        pivot._vector_bytes(w) + 4 * S * R * (w + pivot.K2_PAD))
                    if p != base:
                        yield p


def sweep(dev, flush, m: int) -> None:
    g = torch.Generator(device=dev).manual_seed(m)
    binv = torch.randn(m, m, generator=g, device=dev) / m ** 0.5
    r = m // 3
    rho = binv[r].clone()
    triple = torch.stack([rho + torch.randn(m, generator=g, device=dev) / m ** 0.5, rho,
                          torch.randn(m, generator=g, device=dev)], 1).contiguous()
    abar = torch.dot(rho, triple[:, 0])
    one = torch.ones((), device=dev)
    scal = torch.stack([1.0 / abar, one])
    r32 = torch.tensor([r], dtype=torch.int32, device=dev)
    bout, rout = torch.empty_like(binv), torch.empty((m, 3), device=dev)
    want, _ = pivot.fused_pivot_update_reference(binv, triple, rho, abar, one,
                                                  torch.tensor(r, device=dev))
    b_ms, _ = cs.bound(cs.k2_bytes(m), 8 * m * m)
    base = pivot.k2_plan(m, torch.cuda.get_device_properties(dev).multi_processor_count)
    for p in variants(m, base):
        ms = cs.cold_ms(lambda: pivot._launch(binv, triple, rho, scal, r32, bout, rout, p), flush)
        err = float((bout - want).abs().max())
        tag = "plan" if p == base else "    "
        print(f"{tag} m={m} C={p.cluster} w={p.slice_cols} R={p.tile_rows} S={p.stages} "
              f"G={p.clusters}: {ms * 1e3:.1f} us, {100 * b_ms / ms:.1f}% of the bound "
              f"{b_ms * 1e3:.1f} us; max|err| {err:.1e}", flush=True)


def main(argv) -> int:
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    build.build_all(["pivot"])
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for m in map(int, argv):
        sweep(dev, flush, m)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
