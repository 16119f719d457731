"""K2: fused FTRAN + DSE tau + flip flow + rank-1 basis-inverse update.

Per dual pivot the engine runs three O(m^2) contractions against the basis
inverse and then a rank-1 product-form update of it (reference hot steps:
updateColumnFT / updateWeights / replaceColumn, ClpFactorization.hpp:89-135).
As separate operations that costs three full passes over binv; the fused
kernel does all of it in one read and one write of binv:

    R       = binv @ [g_q | rho | f_delta]
    factor  = R[:,0] / abar_r   (row r: 1 - 1/abar_r)
    binv'   = binv - gate * factor (x) rho

Replaces the TPU kernel clp_tpu/ops/pallas_pivot.py:fused_pivot_update. On
CUDA tensors the wrapper launches the hand-written kernel in csrc/pivot.cu
(its note gives the bound on the H100 and the design) once per call; on
CPU tensors it runs the plain version below. The pivot scalars (r,
1/abar_r, gate) stay on the device: they come out of device argmaxes, and
handing them to the kernel as host numbers would sync every pivot.

The update is out of place (binv' is a new buffer), as in the JAX
function; rho must be a copy of row r, not a view of binv. `k2_plan`
gives the launch geometry from m and the SM count: clusters of CTAs that
split each row into column slices, row tiles walked through a ring of
shared-memory stages. It serves every m up to `K2_MAX_M` and raises
ValueError above it; the kernel needs no scratch, so one call allocates
only its two outputs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build
from .price import _sm_count

# csrc/pivot.cu: threads of a CTA (K2_THREADS: 8 warps that compute and a
# producer warp), the largest cluster (K2_MAX_CLUSTER, the portable limit),
# the row tiles a template exists for, the most ring stages a plan uses
# (K2_MAX_STAGES; the kernel holds barriers for 4, and on the H100 a fourth
# stage was no faster at m = 16,384) and the floats a staged row or vector
# holds beyond its slice (K2_PAD: the ends of its 16-byte aligned span)
K2_THREADS = 288
K2_MAX_CLUSTER = 8
K2_TILE_ROWS = (8, 4, 2, 1)
K2_MAX_STAGES = 3
K2_PAD = 8
# the shared memory a CTA may use on Hopper, and a bound on the kernel's
# static shared memory (barriers, the cluster's partials: 2456 bytes at R = 8)
SMEM_LIMIT = 232448
K2_STATIC_SMEM = 2560
# above K2_SOLO_MAX_M, a cluster grows (2, 4, 8 CTAs) while a CTA's slice
# would be wider than K2_SLICE_COLS
K2_SLICE_COLS = 1024


class PivotPlan(NamedTuple):
    """Launch geometry of K2 for one m: clusters of `cluster` CTAs; CTA j of
    a cluster owns columns [j * slice_cols, min(m, (j + 1) * slice_cols)),
    none empty, each starting at a multiple of 4 columns; `tiles` row tiles
    of `tile_rows` rows (the last may be shorter), tile t walked by cluster
    t % clusters through a ring of `stages` stages; `smem` bytes of
    dynamic shared memory a CTA. `clusters` is the most launched: the launcher lowers it to what
    fits on the card at once."""
    cluster: int
    slice_cols: int
    tile_rows: int
    stages: int
    tiles: int
    clusters: int
    threads: int
    smem: int


def _slices(m: int) -> tuple[int, int]:
    """(C, w): the cluster size and the slice width for m columns."""
    def width(c):  # ceil(m / c) rounded up to a multiple of 4
        return 4 * -(-(-(-m // c)) // 4)

    c = 1
    while c < K2_MAX_CLUSTER and m > c * K2_SLICE_COLS:
        c *= 2
    while c > 1 and (c - 1) * width(c) >= m:  # no empty slice
        c //= 2
    return c, width(c)


def _vector_bytes(w: int) -> int:
    """The staged slices of triple (3 w floats) and rho (w), each with its
    K2_PAD."""
    return 4 * (4 * w + 2 * K2_PAD)


def _ring_rows(w: int) -> int:
    """Rows of a w-column slice that fit in the ring beside the staged
    vectors."""
    return (SMEM_LIMIT - K2_STATIC_SMEM - _vector_bytes(w)) // (4 * (w + K2_PAD))


def _largest_m() -> int:
    """The largest m k2_plan serves: 8 slices whose ring holds 2 rows."""
    w = (SMEM_LIMIT - K2_STATIC_SMEM - 16 * K2_PAD) // 24 // 4 * 4
    assert _ring_rows(w) >= 2 and _ring_rows(w + 4) < 2
    return K2_MAX_CLUSTER * w


K2_MAX_M = _largest_m()


def _solo_max_m() -> int:
    """The largest m at which one CTA holds whole rows, a warp each, with
    2 stages of 8 rows beside the vectors (no cluster, nothing exchanged)."""
    w = 4
    while _ring_rows(w + 4) >= 2 * K2_TILE_ROWS[0]:
        w += 4
    return w


K2_SOLO_MAX_M = _solo_max_m()


@functools.lru_cache(maxsize=64)
def k2_plan(m: int, sms: int) -> PivotPlan:
    """K2's geometry for an (m, m) binv on a card with `sms` SMs.

    Up to K2_SOLO_MAX_M (2864) a CTA holds whole rows, 8 a tile, one a
    warp, which takes two tiles' rows at once: m = 2048 runs 256 tiles
    on 132 CTAs through 2 stages. Above it the cluster grows while a slice
    would be wider than K2_SLICE_COLS (4 CTAs up to m = 4096, 8 above),
    and the ring takes the shared memory left beside the staged vectors:
    the largest tile (8, 4, 2, 1 rows) that leaves 3 stages and gives
    every cluster a tile. Stages: up to K2_MAX_STAGES, and no more than a
    cluster has tiles. One cluster per C SMs, as many as there are tiles.
    """
    if m < 1 or sms < 1:
        raise ValueError(f"k2_plan: m={m}, sms={sms}")
    if m > K2_MAX_M:
        raise ValueError(f"K2 serves m up to {K2_MAX_M}; m = {m} is larger (its slices "
                         f"and a 2-row ring no longer fit in {SMEM_LIMIT} bytes of shared "
                         f"memory)")
    if m <= K2_SOLO_MAX_M:
        # whole rows in one CTA, a row a warp: nothing to exchange
        c, w = 1, 4 * -(-m // 4)
        rows = _ring_rows(w)
        R = K2_TILE_ROWS[0]
    else:
        c, w = _slices(m)
        rows = _ring_rows(w)
        want = max(1, sms // c)
        fits = [R for R in K2_TILE_ROWS if 3 * R <= rows]
        R = next((R for R in fits if -(-m // R) >= want), fits[-1] if fits else 1)
    want = max(1, sms // c)
    tiles = -(-m // R)
    # no more stages than a cluster has tiles to hold at once
    stages = max(2, min(K2_MAX_STAGES, rows // R, -(-tiles // min(tiles, want))))
    smem = _vector_bytes(w) + 4 * stages * R * (w + K2_PAD)
    return PivotPlan(c, w, R, stages, tiles, min(tiles, want), K2_THREADS, smem)


def fused_pivot_update_reference(binv, triple, rho, abar_r, gate, r):
    """Plain PyTorch version: the CPU path and the kernel's oracle."""
    m = binv.shape[0]
    R = binv @ triple
    inv = 1.0 / abar_r
    factor = R[:, 0] * inv
    rows = torch.arange(m, device=binv.device)
    factor = torch.where(rows == r, 1.0 - inv, factor)
    binv_new = binv - (gate * factor)[:, None] * rho[None, :]
    return binv_new, R


def _k2():
    fn = build.load("pivot").k2_pivot
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return fn


def fused_pivot_update(binv, triple, rho, abar_r, gate, r):
    """(binv', [abar | tau | flow]) in one pass over binv.

    binv: (m, m) f32. triple: (m, 3) f32 columns [g_q, rho, f_delta].
    rho: (m,) f32 — a copy of row r of binv. abar_r: consistent pivot
    element (rho . g_q). gate: 1.0 to pivot, 0.0 to pass binv through
    unchanged. r: leaving row index. The scalars may be 0-dim tensors on
    binv's device.
    """
    f32 = torch.float32
    m = binv.shape[0]
    dev = binv.device
    if binv.shape != (m, m) or binv.dtype != f32 or not binv.is_contiguous():
        raise ValueError("binv must be a contiguous square float32 tensor")
    if triple.shape != (m, 3) or triple.dtype != f32 or triple.device != dev:
        raise ValueError(f"triple must be ({m}, 3) float32 on {dev}")
    if rho.shape != (m,) or rho.dtype != f32 or rho.device != dev:
        raise ValueError(f"rho must be ({m},) float32 on {dev}")
    abar_r = torch.as_tensor(abar_r, device=dev).to(f32)
    gate = torch.as_tensor(gate, device=dev).to(f32)
    r = torch.as_tensor(r, device=dev)
    if dev.type == "cpu":
        return fused_pivot_update_reference(binv, triple, rho, abar_r, gate, r)
    if dev.type != "cuda":
        raise ValueError(f"fused_pivot_update: unsupported device {dev}")
    binv_new = torch.empty_like(binv)
    res = torch.empty((m, 3), dtype=f32, device=dev)
    if m == 0:
        return binv_new, res
    plan = k2_plan(m, _sm_count(dev))  # raises above K2_MAX_M
    scal = torch.stack([1.0 / abar_r.reshape(()), gate.reshape(())])
    r32 = r.to(torch.int32).reshape(1)
    _launch(binv, triple.contiguous(), rho.contiguous(), scal, r32, binv_new, res, plan)
    return binv_new, res


def _launch(binv, triple, rho, scal, r32, binv_new, res, plan=None):
    """Launch K2 once on prepared contiguous CUDA tensors (f32; r32 int32),
    with `k2_plan`'s geometry unless a plan is given."""
    m = binv.shape[0]
    dev = binv.device
    p = plan or k2_plan(m, _sm_count(dev))
    rc = _k2()(binv.data_ptr(), triple.data_ptr(), rho.data_ptr(), scal.data_ptr(),
               r32.data_ptr(), m, p.cluster, p.slice_cols, p.tile_rows, p.stages,
               p.clusters, p.smem, binv_new.data_ptr(), res.data_ptr(),
               torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 pivot kernel launch failed: CUDA error {rc}")
    fused_pivot_update.launches += 1


fused_pivot_update.launches = 0
