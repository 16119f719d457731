"""Device placement and the one accelerator test of the port.

The JAX package picks its accelerator settings with
`jax.default_backend() == "tpu"`. The port decides the same questions in
one place, `on_accelerator`, from where the LP's tensors live: on the CPU
it takes the JAX package's non-TPU branch exactly (so CPU parity holds),
on a CUDA device it mirrors the TPU branch.
"""

from __future__ import annotations

import os

import torch


def default_device() -> str:
    """The device a solve runs on when the caller names none.

    `CLPTPU_PLATFORM` is the JAX package's platform switch
    (clp_tpu/__init__.py): "cpu" there puts the port on the CPU too, as
    the C API's callers and the CLI's scripted runs expect. Anything else,
    or no setting, gives "cuda", which `resolve_device` refuses without a
    card.
    """
    return "cpu" if os.environ.get("CLPTPU_PLATFORM", "").lower() == "cpu" else "cuda"


def resolve_device(name) -> torch.device:
    """The torch device a solve runs on.

    A CUDA device with no card raises: the port never carries on on the
    CPU behind the caller's back. The f32 precision guard runs here too,
    because every entry point resolves its device first.
    """
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to solve on the CPU")
    check_fp32_precision()
    return dev


def check_fp32_precision() -> None:
    """Raise unless float32 products run in full f32.

    The JAX package asks for `Precision.HIGHEST` wherever an f32 product
    feeds the pivot (the f32 preconditioner in recompute, the mixed
    PRICE and FTRAN contractions, both Pallas kernels). On the card the
    counterpart is plain IEEE f32: TF32 keeps ~10 mantissa bits and would
    trip the engine's 2e-4 pivot cross-check on most pivots.
    """
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 must be False: the "
            "simplex engine needs full-f32 matrix products")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "torch.get_float32_matmul_precision() must be 'highest': the "
            "simplex engine needs full-f32 matrix products")


def on_accelerator(x: torch.Tensor) -> bool:
    """True when `x` (an LP tensor) lives on a CUDA device."""
    return x.device.type == "cuda"
