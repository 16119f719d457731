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
(its note gives the bound on the H100 and the design); on CPU tensors it
runs the plain version below. The pivot scalars (r, 1/abar_r, gate) stay
on the device: they come out of device argmaxes, and handing them to the
kernel as host numbers would sync every pivot.

The update is out of place (binv' is a new buffer), as in the JAX
function; rho must be a copy of row r, not a view of binv. Above
`_K2_MAX_M` rows the one-pass kernel's rows no longer fit in shared
memory, and the wrapper launches the library's two-pass path instead
(the same function, binv read twice); the choice is made by m alone.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# rows of binv a K2 block holds in shared memory (csrc/pivot.cu K2_ROWS)
# against the 227 KB a block may use on Hopper
_K2_ROWS = 4
_K2_MAX_M = (232448 - 1024) // (4 * _K2_ROWS)


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


def _k2(m: int):
    lib = build.load("pivot")
    fn = lib.k2_pivot if m <= _K2_MAX_M else lib.k2_pivot_two_pass
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                                               ctypes.c_void_p, ctypes.c_void_p]
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
    scal = torch.stack([1.0 / abar_r.reshape(()), gate.reshape(())])
    r32 = r.to(torch.int32).reshape(1)
    triple = triple.contiguous()
    rho = rho.contiguous()
    binv_new = torch.empty_like(binv)
    res = torch.empty((m, 3), dtype=f32, device=dev)
    _launch(binv, triple, rho, scal, r32, binv_new, res)
    return binv_new, res


def _launch(binv, triple, rho, scal, r32, binv_new, res):
    """Launch K2 on prepared contiguous CUDA tensors (f32; r32 int32):
    the one-pass kernel up to `_K2_MAX_M` rows, the two-pass path above."""
    m = binv.shape[0]
    rc = _k2(m)(binv.data_ptr(), triple.data_ptr(), rho.data_ptr(),
                scal.data_ptr(), r32.data_ptr(), m, binv_new.data_ptr(),
                res.data_ptr(), torch.cuda.current_stream(binv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 pivot kernel launch failed: CUDA error {rc}")
    fused_pivot_update.launches += 1


fused_pivot_update.launches = 0
