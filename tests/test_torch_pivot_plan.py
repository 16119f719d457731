"""The host side of K2 on the CPU: the launch geometry `k2_plan` gives the
kernel in csrc/pivot.cu (column slices of a cluster, row tiles walked by
the clusters, the ring in shared memory), and a numpy emulation of the
schedule that geometry sets (each slice's partial dot products, summed in
rank order) held against the plain version and against the JAX package's
Pallas kernel in interpret mode, on ragged shapes.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from clp_tpu.ops.pallas_pivot import fused_pivot_update as jax_pivot
from clp_tpu_torch.ops import pivot
from clp_tpu_torch.ops.pivot import (
    K2_MAX_CLUSTER,
    K2_MAX_M,
    K2_PAD,
    K2_STATIC_SMEM,
    SMEM_LIMIT,
    fused_pivot_update,
    fused_pivot_update_reference,
    k2_plan,
)

from tests.worker_threads import set_worker_threads

set_worker_threads()

PLAN_M = [1, 3, 4, 5, 127, 2048, 14464, 14465, 16384, 24576, 65536]


def slices(plan, m):
    """The column range of each CTA of a cluster."""
    w = plan.slice_cols
    return [(j * w, min(m, (j + 1) * w)) for j in range(plan.cluster)]


def cluster_tiles(plan, k):
    """The row tiles cluster k walks: k, k + G, ... (G clusters)."""
    return list(range(k, plan.tiles, plan.clusters))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m", PLAN_M)
def test_k2_plan_covers_binv(m, sms):
    plan = k2_plan(m, sms)
    assert 1 <= plan.cluster <= K2_MAX_CLUSTER
    # every column in exactly one slice, none empty; a slice starts at a
    # multiple of 4 columns, so 16-byte aligned wherever the rows are
    cols = [j for a, b in slices(plan, m) for j in range(a, b)]
    assert cols == list(range(m))
    assert all(a < b for a, b in slices(plan, m))
    assert plan.slice_cols % 4 == 0
    if m % 4 == 0:
        assert all((4 * (i * m + a)) % 16 == 0 for a, _ in slices(plan, m)
                   for i in (0, 1, m - 1))
    # every row in exactly one tile, every tile walked by exactly one cluster
    R = plan.tile_rows
    assert R in pivot.K2_TILE_ROWS and plan.tiles == -(-m // R)
    walked = sorted(t for k in range(plan.clusters) for t in cluster_tiles(plan, k))
    assert walked == list(range(plan.tiles))
    rows = [i for t in walked for i in range(t * R, min(m, (t + 1) * R))]
    assert rows == list(range(m))
    assert 1 <= plan.clusters <= max(1, sms // plan.cluster)
    if m <= pivot.K2_SOLO_MAX_M:  # whole rows a CTA, a row a warp
        assert (plan.cluster, plan.tile_rows) == (1, 8)
    # the ring and the staged vectors fit beside the static shared memory
    assert 2 <= plan.stages <= pivot.K2_MAX_STAGES
    assert plan.smem == 4 * (4 * plan.slice_cols + 2 * K2_PAD
                             + plan.stages * R * (plan.slice_cols + K2_PAD))
    assert plan.smem + K2_STATIC_SMEM <= SMEM_LIMIT == 232448
    assert plan.threads == pivot.K2_THREADS


@pytest.mark.parametrize("sms", [132, 114])
def test_k2_plan_refuses_past_its_largest_m(sms):
    assert K2_MAX_M >= 65536
    assert k2_plan(K2_MAX_M, sms).cluster == K2_MAX_CLUSTER
    with pytest.raises(ValueError, match=str(K2_MAX_M)):
        k2_plan(K2_MAX_M + 1, sms)
    for bad in ((0, sms), (5, 0)):
        with pytest.raises(ValueError):
            k2_plan(*bad)


def test_k2_main_path_geometry():
    """The staircase's m = 2048 on the H100's 132 SMs: whole rows a CTA, a
    row a warp, 256 tiles of 8 rows on 132 CTAs through 2 stages; above
    the solo range (2864) clusters of 4 CTAs, of 8 from m = 4097 (16,384:
    2048 columns a CTA, tiles of 4 rows, 3 stages)."""
    p = k2_plan(2048, 132)
    assert (p.cluster, p.slice_cols, p.tile_rows, p.stages, p.tiles, p.clusters) == \
        (1, 2048, 8, 2, 256, 132)
    assert pivot.K2_SOLO_MAX_M == 2864
    assert k2_plan(2864, 132).cluster == 1
    assert k2_plan(2865, 132).cluster == 4
    assert k2_plan(4097, 132).cluster == 8
    assert k2_plan(16384, 132)[:4] == (8, 2048, 4, 3)


def emulate(binv, triple, rho, abar_r, gate, r, plan):
    """K2 as the plan schedules it, in numpy f32: each cluster walks its
    tiles; each CTA's partial dot products over its slice; the partials of
    a row summed in rank order 0 .. C-1; then the update of each row."""
    m = binv.shape[0]
    f32 = np.float32
    res = np.full((m, 3), np.nan, dtype=f32)
    out = np.full_like(binv, np.nan)
    inv = f32(1) / f32(abar_r)
    for k in range(plan.clusters):
        for t in cluster_tiles(plan, k):
            for i in range(t * plan.tile_rows, min(m, (t + 1) * plan.tile_rows)):
                parts = [binv[i, a:b] @ triple[a:b] for a, b in slices(plan, m)]
                s = np.zeros(3, dtype=f32)
                for p in parts:  # rank order
                    s = (s + p).astype(f32)
                assert np.isnan(res[i]).all(), "a row visited twice"
                res[i] = s
                factor = f32(1) - inv if i == r else s[0] * inv
                out[i] = binv[i] - f32(gate) * f32(factor) * rho
    return out, res


def emulation_inputs(m, r, seed=11):
    """Unit-norm rows of binv, g_q near rho (abar_r near 1), as chip_smoke."""
    rng = np.random.default_rng(seed)
    binv = (rng.standard_normal((m, m)) / np.sqrt(m)).astype(np.float32)
    rho = binv[r].copy()
    gq = (rho + rng.standard_normal(m) / np.sqrt(m)).astype(np.float32)
    triple = np.stack([gq, rho, rng.standard_normal(m).astype(np.float32)], axis=1)
    return binv, triple, rho, np.float32(rho @ gq)


# (m, sms): tiles of 8 rows, a row a warp, the last tile ragged (127 =
# 15 * 8 + 7, 2052 = 256 * 8 + 4) in one CTA a row; 2900 runs clusters of
# 4 CTAs (slices of 728 columns, the last 716), its last tile ragged too
EMULATED = [(127, 132), (2052, 132), (2900, 132)]


@pytest.mark.parametrize("gate", [1.0, 0.0])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("m, sms", EMULATED)
def test_k2_schedule_matches_plain_and_jax(m, sms, where, gate):
    plan = k2_plan(m, sms)
    R = plan.tile_rows
    assert m % R, "the last tile is ragged"
    r = {"first": R // 2, "middle": (plan.tiles // 2) * R + 1, "last": m - 1}[where]
    binv, triple, rho, abar_r = emulation_inputs(m, r)
    be, re = emulate(binv, triple, rho, abar_r, gate, r, plan)
    bp, rp = fused_pivot_update_reference(torch.as_tensor(binv), torch.as_tensor(triple),
                                          torch.as_tensor(rho), torch.tensor(abar_r),
                                          torch.tensor(gate), torch.tensor(r))
    bj, rj = jax_pivot(jnp.asarray(binv), jnp.asarray(triple), jnp.asarray(rho),
                       jnp.asarray(abar_r), jnp.asarray(gate), jnp.asarray(r),
                       interpret=True)
    # unit-norm rows against an N(0, 1) flip flow: R reaches |4|, where
    # the f32 spacing is 4.8e-7, and sums of m products in three orders
    # differ by a few spacings
    for b_other, r_other in ((bp.numpy(), rp.numpy()), (np.asarray(bj), np.asarray(rj))):
        np.testing.assert_allclose(re, r_other, rtol=0, atol=1e-5)
        np.testing.assert_allclose(be, b_other, rtol=0, atol=1e-5)
    if gate == 0.0:
        np.testing.assert_array_equal(be, binv)  # gate 0 passes binv through
    else:
        assert np.abs(be[r] - (binv[r] - (1 - 1 / abar_r) * rho)).max() < 1e-6


def test_wrapper_plans_only_on_the_card():
    """On the CPU the wrapper runs the plain version at any m, with no
    plan; the plan's limit is the kernel's."""
    m = 6
    binv, triple, rho, abar_r = emulation_inputs(m, 2)
    args = [torch.as_tensor(a) for a in (binv, triple, rho, abar_r)]
    n = fused_pivot_update.launches
    out, res = fused_pivot_update(*args, torch.tensor(1.0), torch.tensor(2))
    assert fused_pivot_update.launches == n, "no launch on the CPU"
    assert out.shape == (m, m) and res.shape == (m, 3)
