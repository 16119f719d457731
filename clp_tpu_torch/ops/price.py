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
the bound on the H100 and the design); on a CPU tensor it runs the plain
version below on the same f32 inputs. There is no fallback from one to the
other.

Precision: the kernel computes in f32, as the Pallas kernel does; the
engine re-verifies the chosen pivot against its own FTRAN value, so pricing
precision costs at most an extra pivot, never correctness.
"""

from __future__ import annotations

import ctypes

import torch

from . import build


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


def _k1():
    fn = build.load("price").k1_price
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_float,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def price_and_ratios(rho, G, dj, elig_mask, sgn, sigma, rel: float, ptol: float):
    """Fused alpha = rho'G and Harris pass-1 relaxed ratios.

    G may be f32 (preferred: pass a loop-invariant f32 copy so the cast is
    not re-done per pivot) or f64 (cast here). rho/dj/sgn/sigma are cast to
    f32. sigma may be a 0-dim tensor on G's device: the kernel reads it from
    device memory, so the pivot loop never syncs to pass it.

    elig_mask: bool/int — candidate nonbasic in the right direction class.
    sgn: +1.0 for at-lower candidates, -1.0 for at-upper.
    Returns (alpha[nt], relaxed_ratio[nt]) in the promoted dtype of rho and G.
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
    out_dtype = torch.promote_types(rho.dtype, G.dtype)
    f32 = torch.float32
    G32 = G.to(f32).contiguous()
    rho32 = rho.to(f32).contiguous()
    dj32 = dj.to(f32).contiguous()
    sgn32 = sgn.to(f32).contiguous()
    elig32 = elig_mask.to(torch.int32).contiguous()
    sig32 = torch.as_tensor(sigma, device=dev).to(f32).reshape(1)
    if dev.type == "cpu":
        alpha, ratio = price_and_ratios_reference(
            rho32, G32, dj32, elig32, sgn32, sig32[0], rel, ptol)
        return alpha.to(out_dtype), ratio.to(out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"price_and_ratios: unsupported device {dev}")
    out = torch.empty((2, nt), dtype=f32, device=dev)
    _launch(rho32, G32, dj32, elig32, sgn32, sig32, rel, ptol, out)
    return out[0].to(out_dtype), out[1].to(out_dtype)


def _launch(rho32, G32, dj32, elig32, sgn32, sig32, rel, ptol, out):
    """Launch K1 on prepared contiguous CUDA tensors (f32; elig int32)."""
    m, nt = G32.shape
    rc = _k1()(rho32.data_ptr(), G32.data_ptr(), dj32.data_ptr(),
               elig32.data_ptr(), sgn32.data_ptr(), sig32.data_ptr(),
               float(rel), float(ptol), m, nt, out.data_ptr(),
               torch.cuda.current_stream(G32.device).cuda_stream)
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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_float, ctypes.c_float] \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def price_and_ratios_block(rho_p, starts, W, dj, elig_mask, sgn, sigma,
                           rel: float, ptol: float):
    """Fused block-banded PRICE + Harris pass-1 (K3).

    rho_p: (m8,) the BTRAN row padded to the block form's 8-aligned row
    domain. starts: (nb,) window starts (multiples of 8, starts[b] + H <=
    m8), int32 as the kernel reads them. W: (nb, H, CB) f32 tiles from
    engine.block_forms. dj/elig_mask/sgn: (nb*CB,) in the block form's
    (sorted) column order. sigma may be a 0-dim tensor on W's device: the
    kernel reads it from device memory. Returns (alpha, relaxed_ratio), two
    f32 vectors of length nb*CB, as the JAX function returns them in W's
    dtype.
    """
    if W.dim() != 3 or W.dtype != torch.float32:
        raise ValueError(f"W must be a 3-D float32 tensor, got {tuple(W.shape)} "
                         f"{W.dtype}")
    nb, H, CB = W.shape
    ntp = nb * CB
    dev = W.device
    m8 = rho_p.shape[0] if rho_p.dim() == 1 else -1
    for name, v, n in (("rho_p", rho_p, m8), ("starts", starts, nb), ("dj", dj, ntp),
                       ("elig_mask", elig_mask, ntp), ("sgn", sgn, ntp)):
        if v.shape != (n,) or v.device != dev:
            raise ValueError(f"{name} must have shape ({n},) on {dev}, got "
                             f"{tuple(v.shape)} on {v.device}")
    if m8 < H:
        raise ValueError(f"rho_p has {m8} rows, fewer than the window height {H}")
    f32 = torch.float32
    W = W.contiguous()
    rho32 = rho_p.to(f32).contiguous()
    starts32 = starts.to(torch.int32).contiguous()
    dj32 = dj.to(f32).contiguous()
    sgn32 = sgn.to(f32).contiguous()
    elig32 = elig_mask.to(torch.int32).contiguous()
    sig32 = torch.as_tensor(sigma, device=dev).to(f32).reshape(1)
    if dev.type == "cpu":
        return price_and_ratios_block_reference(
            rho32, starts32, W, dj32, elig32, sgn32, sig32[0], rel, ptol)
    if dev.type != "cuda":
        raise ValueError(f"price_and_ratios_block: unsupported device {dev}")
    out = torch.empty((2, ntp), dtype=f32, device=dev)
    _launch_block(rho32, starts32, W, dj32, elig32, sgn32, sig32, rel, ptol, out)
    return out[0], out[1]


def _launch_block(rho32, starts32, W, dj32, elig32, sgn32, sig32, rel, ptol, out):
    """Launch K3 on prepared contiguous CUDA tensors (f32; starts, elig int32)."""
    nb, H, CB = W.shape
    rc = _k3()(rho32.data_ptr(), starts32.data_ptr(), W.data_ptr(), dj32.data_ptr(),
               elig32.data_ptr(), sgn32.data_ptr(), sig32.data_ptr(),
               float(rel), float(ptol), rho32.shape[0], nb, H, CB, out.data_ptr(),
               torch.cuda.current_stream(W.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K3 block price kernel launch failed: CUDA error {rc}")
    price_and_ratios_block.launches += 1


price_and_ratios_block.launches = 0
