"""K1 and K3: fused dual-simplex PRICE + Harris pass-1 ratios.

The hot PRICE step (reference: ClpPackedMatrix::transposeTimesByRow,
ClpPackedMatrix.cpp:706-1307) computes alpha = rho' G and immediately feeds
the Harris pass-1 ratio scan (ClpSimplexDual.cpp:3665). Fusing both reads G
once and emits the tableau row and the relaxed ratios together.

K1 (`price_and_ratios`) replaces the TPU kernel
clp_tpu/ops/pallas_price.py:price_and_ratios and reads the dense G; K3
(`price_and_ratios_block`) replaces pallas_price.py:price_and_ratios_block
and reads the window-compacted tiles of a block-banded G
(engine.block_forms). On a CUDA tensor each wrapper launches its
hand-written kernel, csrc/price.cu and csrc/price_block.cu (their notes give
the bound on the H100 and the design), once per call; on a CPU tensor it
runs the plain version below on the same f32 inputs. There is no fallback
from one to the other.

Each call is one launch. K1 splits each tile of 128 columns over several
blocks along the rows and sums the splits in the same launch, in a fixed
order, through a scratch of partial sums and one counter per tile; the
scratch and counters are allocated once per device (`_workspace`) and
reused by every later call, so the pivot loop allocates nothing for them.
K3's windows are short, so its blocks split the columns instead and need
no scratch. `k1_plan` and `k3_plan` give the launch geometry from the
shapes and the SM count.

Precision: the kernel computes in f32, as the Pallas kernel does; the
engine re-verifies the chosen pivot against its own FTRAN value, so pricing
precision costs at most an extra pivot, never correctness.
"""

from __future__ import annotations

import ctypes
import functools
from fractions import Fraction
from typing import NamedTuple

import torch

from . import build

# csrc/price.cu: columns of a tile (K1_COLS), threads of a block
# (K1_THREADS), the blocks its __launch_bounds__ keeps on one SM, and the
# fewest rows of G a split takes (one round of 8 rows for each warp)
K1_COLS = 128
K1_THREADS = 256
K1_BLOCKS_PER_SM = 4
K1_MIN_ROWS = 64
# csrc/price_block.cu: columns of a block (K3_COLS), threads (K3_THREADS)
K3_COLS = 32
K3_THREADS = 256
MAX_GRID = 2**31 - 1

# csrc/price_epilogue.cuh PT_*: how the epilogue's vectors are stored
_DJ_F64, _SGN_F64, _SIGMA_F64, _ELIG_BYTE = 1, 2, 4, 8
_FLOATS = (torch.float32, torch.float64)
_BYTES = (torch.bool, torch.uint8, torch.int8)


class PricePlan(NamedTuple):
    """Launch geometry of K1 or K3: `tiles` column tiles of `tile_cols`,
    each split into `splits` row ranges of `rows_per_split` rows (the last
    may be shorter), one block of `threads` threads per (tile, split),
    numbered split-major. With more than one split, a (splits, ncols) f32
    scratch of partial sums and one int32 counter per tile; with one, none
    (a (0, ncols) scratch and 0 counters)."""
    tile_cols: int
    tiles: int
    splits: int
    rows_per_split: int
    grid: int
    threads: int
    scratch_shape: tuple[int, int]
    counters: int


def _row_split(tiles: int, depth: int, sms: int, min_rows: int) -> tuple[int, int]:
    """(splits, rows_per_split) of a reduction `depth` rows deep.

    Every block of a tile split has the same work, so a launch lasts as long
    as the busiest SM's blocks: ceil(tiles * S / sms) of them, each 1/S of
    a tile. S minimizes that product; ties go to the larger S (more blocks,
    more loads in flight). S stays small enough that all blocks are resident
    at once and each split has at least min_rows rows; the row count is then
    rounded so no split is empty.
    """
    s_max = max(1, min(depth // min_rows, K1_BLOCKS_PER_SM * sms // tiles))
    best = min(range(1, s_max + 1),
               key=lambda s: (Fraction(-(-tiles * s // sms), s), -s))
    rows = max(1, -(-depth // best))
    return max(1, -(-depth // rows)), rows


def _checked(plan: PricePlan) -> PricePlan:
    if plan.grid > MAX_GRID:
        raise ValueError(f"{plan.grid} blocks exceed the launch limit {MAX_GRID}")
    return plan


@functools.lru_cache(maxsize=64)
def k1_plan(m: int, nt: int, sms: int) -> PricePlan:
    """K1's geometry for an (m, nt) G on a card with `sms` SMs: ceil(nt /
    128) column tiles, each split along m as `_row_split` decides."""
    if m < 0 or nt < 1 or sms < 1:
        raise ValueError(f"k1_plan: m={m}, nt={nt}, sms={sms}")
    tiles = -(-nt // K1_COLS)
    splits, rows = _row_split(tiles, m, sms, K1_MIN_ROWS)
    many = splits > 1
    return _checked(PricePlan(K1_COLS, tiles, splits, rows, tiles * splits, K1_THREADS,
                              (splits if many else 0, nt), tiles if many else 0))


@functools.lru_cache(maxsize=64)
def k3_plan(nb: int, H: int, CB: int) -> PricePlan:
    """K3's geometry for (nb, H, CB) tiles: every tile's CB columns in
    ceil(CB / 32) blocks, each over all H rows of its window, so no sum
    crosses blocks and no scratch is needed. The staircase's 52 tiles give
    208 blocks, at most 2 on any of the H100's 132 SMs."""
    if nb < 1 or H < 0 or CB < 1:
        raise ValueError(f"k3_plan: nb={nb}, H={H}, CB={CB}")
    tiles = nb * -(-CB // K3_COLS)
    return _checked(PricePlan(K3_COLS, tiles, 1, max(1, H), tiles, K3_THREADS,
                              (0, nb * CB), 0))


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_workspaces: dict = {}


def _workspace(dev: torch.device, plan: PricePlan):
    """K1's (scratch, counters) on one device, made once and grown only
    when a call needs more. The counters are zeroed here once; each launch
    leaves them at zero again (the last block of a tile resets its
    counter). One stream per device uses them, as the engine runs: two
    launches on two streams at once would share them."""
    need = plan.scratch_shape[0] * plan.scratch_shape[1]
    ws = _workspaces.get(dev)
    if ws is None or ws[0].numel() < need or ws[1].numel() < plan.counters:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.empty(max(need, old[0]), dtype=torch.float32, device=dev),
              torch.zeros(max(plan.counters, old[1]), dtype=torch.int32, device=dev))
        _workspaces[dev] = ws
    return ws


def _ratios(alpha, dj, elig_mask, sgn, sigma, rel, ptol):
    """The fused epilogue both kernels share: Harris pass-1 relaxed ratios."""
    a = sigma * alpha
    elig = (elig_mask != 0) & (a.abs() > ptol) & (sgn * a > 0)
    safe_a = torch.where(elig, a, 1.0)
    return torch.where(elig, (dj + sgn * rel) / safe_a, torch.inf)


def price_and_ratios_reference(rho, G, dj, elig_mask, sgn, sigma, rel, ptol):
    """Plain PyTorch version of K1: the CPU path and the kernel's oracle."""
    alpha = rho @ G
    return alpha, _ratios(alpha, dj, elig_mask, sgn, sigma, rel, ptol)


def _check_sigma(sigma) -> None:
    if isinstance(sigma, torch.Tensor) and sigma.numel() != 1:
        raise ValueError(f"sigma must hold one value, got shape {tuple(sigma.shape)}")


def _kernel_vecs(dj, elig_mask, sgn, sigma, dev):
    """dj, elig_mask, sgn and sigma as the kernels read them, with the
    flags that say how each is stored. f32 or f64 vectors and a bool, byte
    or int32 mask pass as they are (no cast launched); sigma may be a
    number or a one-element tensor."""
    if dj.dtype not in _FLOATS:
        dj = dj.to(torch.float32)
    if sgn.dtype not in _FLOATS:
        sgn = sgn.to(torch.float32)
    if elig_mask.dtype not in _BYTES + (torch.int32,):
        elig_mask = elig_mask.to(torch.int32)
    if not isinstance(sigma, torch.Tensor):
        sigma = torch.tensor(float(sigma), dtype=torch.float32, device=dev)
    elif sigma.device != dev or sigma.dtype not in _FLOATS:
        sigma = sigma.to(device=dev, dtype=sigma.dtype if sigma.dtype in _FLOATS
                         else torch.float32)
    flags = ((_DJ_F64 if dj.dtype == torch.float64 else 0)
             | (_SGN_F64 if sgn.dtype == torch.float64 else 0)
             | (_SIGMA_F64 if sigma.dtype == torch.float64 else 0)
             | (_ELIG_BYTE if elig_mask.dtype in _BYTES else 0))
    return (dj.contiguous(), elig_mask.contiguous(), sgn.contiguous(),
            sigma.reshape(1), flags)


def _k1():
    fn = build.load("price").k1_price
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_float, ctypes.c_float] \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return fn


def price_and_ratios(rho, G, dj, elig_mask, sgn, sigma, rel: float, ptol: float):
    """Fused alpha = rho'G and Harris pass-1 relaxed ratios.

    G may be f32 (preferred: pass a loop-invariant f32 copy so the cast is
    not re-done per pivot) or f64 (cast here). rho is cast to f32. dj and
    sgn may be f32 or f64 and sigma an f32 or f64 number or one-element
    tensor on G's device: the kernel reads each as it is stored and rounds
    it to f32, so the pivot loop neither casts nor syncs to pass them.

    elig_mask: bool/int — candidate nonbasic in the right direction class.
    sgn: +1.0 for at-lower candidates, -1.0 for at-upper.
    Returns (alpha[nt], relaxed_ratio[nt]) in the promoted dtype of rho and G.

    On a CUDA device the kernel uses a scratch and counters kept per device
    (`_workspace`): calls must come from one stream at a time.
    """
    if G.dim() != 2:
        raise ValueError(f"G must be 2-D, got shape {tuple(G.shape)}")
    m, nt = G.shape
    dev = G.device
    for name, v, n in (("rho", rho, m), ("dj", dj, nt), ("elig_mask", elig_mask, nt),
                       ("sgn", sgn, nt)):
        if v.shape != (n,) or v.device != dev:
            raise ValueError(f"{name} must have shape ({n},) on {dev}, got "
                             f"{tuple(v.shape)} on {v.device}")
    _check_sigma(sigma)
    out_dtype = torch.promote_types(rho.dtype, G.dtype)
    f32 = torch.float32
    if dev.type == "cpu":
        alpha, ratio = price_and_ratios_reference(
            rho.to(f32), G.to(f32), dj.to(f32), elig_mask.to(torch.int32), sgn.to(f32),
            torch.as_tensor(sigma).to(f32), rel, ptol)
        return alpha.to(out_dtype), ratio.to(out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"price_and_ratios: unsupported device {dev}")
    G32 = G.to(f32).contiguous()
    rho32 = rho.to(f32).contiguous()
    dj, elig_mask, sgn, sig, flags = _kernel_vecs(dj, elig_mask, sgn, sigma, dev)
    out = torch.empty((2, nt), dtype=f32, device=dev)
    _launch(rho32, G32, dj, elig_mask, sgn, sig, flags, rel, ptol, out)
    return out[0].to(out_dtype), out[1].to(out_dtype)


def _launch(rho32, G32, dj, elig, sgn, sig, flags, rel, ptol, out):
    """Launch K1 on prepared contiguous CUDA tensors (rho, G f32; dj, elig,
    sgn, sig and flags from _kernel_vecs)."""
    m, nt = G32.shape
    dev = G32.device
    plan = k1_plan(m, nt, _sm_count(dev))
    part, counters = _workspace(dev, plan)
    rc = _k1()(rho32.data_ptr(), G32.data_ptr(), dj.data_ptr(), elig.data_ptr(),
               sgn.data_ptr(), sig.data_ptr(), flags, float(rel), float(ptol), m, nt,
               plan.splits, plan.rows_per_split, part.data_ptr(), counters.data_ptr(),
               out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 price kernel launch failed: CUDA error {rc}")
    price_and_ratios.launches += 1


price_and_ratios.launches = 0


# ---------------------------------------------------------------------------
# K3: block-banded variant, PRICE over window-compacted column tiles
# ---------------------------------------------------------------------------


def price_and_ratios_block_reference(rho_p, starts, W, dj, elig_mask, sgn, sigma,
                                     rel, ptol):
    """Plain PyTorch version of K3: the CPU path and the kernel's oracle.

    alpha[b*CB + c] = sum_h rho_p[starts[b] + h] * W[b, h, c]: the rho
    windows are gathered, multiplied with W as one batched product, and
    K1's epilogue follows.
    """
    H = W.shape[1]
    rows = starts.to(torch.int64)[:, None] + torch.arange(H, device=W.device)
    alpha = torch.bmm(rho_p[rows][:, None, :], W)[:, 0, :].reshape(-1)
    return alpha, _ratios(alpha, dj, elig_mask, sgn, sigma, rel, ptol)


def _k3():
    fn = build.load("price_block").k3_price_block
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_float, ctypes.c_float] \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


def price_and_ratios_block(rho_p, starts, W, dj, elig_mask, sgn, sigma,
                           rel: float, ptol: float):
    """Fused block-banded PRICE + Harris pass-1 (K3).

    rho_p: (m8,) the BTRAN row padded to the block form's 8-aligned row
    domain. starts: (nb,) window starts (multiples of 8, starts[b] + H <=
    m8), int32 as the kernel reads them. W: (nb, H, CB) f32 tiles from
    engine.block_forms. dj/elig_mask/sgn: (n,) in the block form's (sorted)
    column order, n <= nb*CB; a column j >= n is not eligible, as if the
    three were padded with dj = 0, elig = 0 and sgn = 1 (the engine passes
    them unpadded). dj and sgn may be f32 or f64, elig_mask bool, byte or
    int32, and sigma an f32 or f64 number or one-element tensor on W's
    device: the kernel reads each as it is stored. Returns (alpha,
    relaxed_ratio), two f32 vectors of length nb*CB, as the JAX function
    returns them in W's dtype.
    """
    if W.dim() != 3 or W.dtype != torch.float32:
        raise ValueError(f"W must be a 3-D float32 tensor, got {tuple(W.shape)} "
                         f"{W.dtype}")
    nb, H, CB = W.shape
    ntp = nb * CB
    dev = W.device
    m8 = rho_p.shape[0] if rho_p.dim() == 1 else -1
    for name, v, n in (("rho_p", rho_p, m8), ("starts", starts, nb)):
        if v.shape != (n,) or v.device != dev:
            raise ValueError(f"{name} must have shape ({n},) on {dev}, got "
                             f"{tuple(v.shape)} on {v.device}")
    n = dj.shape[0] if dj.dim() == 1 else -1
    if not (0 <= n <= ntp and elig_mask.shape == sgn.shape == (n,)
            and dj.device == elig_mask.device == sgn.device == dev):
        raise ValueError(f"dj, elig_mask and sgn must share one length n <= {ntp} on "
                         f"{dev}, got dj {tuple(dj.shape)} on {dj.device}, elig_mask "
                         f"{tuple(elig_mask.shape)}, sgn {tuple(sgn.shape)}")
    if m8 < H:
        raise ValueError(f"rho_p has {m8} rows, fewer than the window height {H}")
    _check_sigma(sigma)
    f32 = torch.float32
    if dev.type == "cpu":
        pad = ntp - n
        return price_and_ratios_block_reference(
            rho_p.to(f32), starts.to(torch.int32), W,
            torch.nn.functional.pad(dj.to(f32), (0, pad)),
            torch.nn.functional.pad(elig_mask.to(torch.int32), (0, pad)),
            torch.nn.functional.pad(sgn.to(f32), (0, pad), value=1.0),
            torch.as_tensor(sigma).to(f32), rel, ptol)
    if dev.type != "cuda":
        raise ValueError(f"price_and_ratios_block: unsupported device {dev}")
    W = W.contiguous()
    rho32 = rho_p.to(f32).contiguous()
    starts32 = starts.to(torch.int32).contiguous()
    dj, elig_mask, sgn, sig, flags = _kernel_vecs(dj, elig_mask, sgn, sigma, dev)
    out = torch.empty((2, ntp), dtype=f32, device=dev)
    _launch_block(rho32, starts32, W, dj, elig_mask, sgn, sig, flags, rel, ptol, out)
    return out[0], out[1]


def _launch_block(rho32, starts32, W, dj, elig, sgn, sig, flags, rel, ptol, out):
    """Launch K3 on prepared contiguous CUDA tensors (rho, W f32; starts
    int32; dj, elig, sgn, sig and flags from _kernel_vecs)."""
    nb, H, CB = W.shape
    plan = k3_plan(nb, H, CB)
    rc = _k3()(rho32.data_ptr(), starts32.data_ptr(), W.data_ptr(), dj.data_ptr(),
               elig.data_ptr(), sgn.data_ptr(), sig.data_ptr(), flags, float(rel),
               float(ptol), rho32.shape[0], nb, H, CB, dj.shape[0], plan.tiles // nb,
               out.data_ptr(), torch.cuda.current_stream(W.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K3 block price kernel launch failed: CUDA error {rc}")
    price_and_ratios_block.launches += 1


price_and_ratios_block.launches = 0
