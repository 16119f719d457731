"""The JAX package's random signs, bit for bit, in torch integer arithmetic.

The Positive Edge pivot rules draw `jax.random.rademacher(fold_in(
PRNGKey(seed), iterations), (n,))` with the JAX package's x64 mode on
(clp_tpu/__init__.py:28). This module reproduces that draw exactly, so the
port and the JAX package take the same pivots:

  * the key of `PRNGKey(seed)` is the pair (seed >> 32, seed & 0xffffffff);
  * `fold_in(key, d)` hashes the counter pair (0, d) with Threefry-2x32
    under that key, and the hashed pair is the new key;
  * 64 random bits per element hash the counter pair (0, i) for
    i = 0 .. n-1 (jax's "partitionable" layout, its default), the first
    word being the high half;
  * `bernoulli(p=0.5)` in f64 is `uniform < 0.5`, true exactly when bit 63
    of those 64 bits is clear, and `rademacher` maps true to +1, false to -1.

uint32 values live in int64 tensors, masked after every add and shift, so
the same code runs on the CPU and on the card. The folded-in counter is a
0-dim tensor (the state's iteration count): nothing is read on the host.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the key
    (k1, k2); every argument holds uint32 values in int64."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in_key(seed: int, data: torch.Tensor):
    """`fold_in(PRNGKey(seed), data)` as two 0-dim int64 tensors on data's
    device; `data` is an integer tensor, taken modulo 2**32 as jax does."""
    d = data.to(torch.int64) & _M32
    zero = torch.zeros_like(d)
    return threefry2x32((seed >> 32) & _M32, seed & _M32, zero, d)


def rademacher(seed: int, data: torch.Tensor, n: int,
               dtype=torch.float64) -> torch.Tensor:
    """`jax.random.rademacher(fold_in(PRNGKey(seed), data), (n,), dtype)`
    with x64 on: n signs of +-1 in `dtype` on data's device."""
    k1, k2 = fold_in_key(seed, data)
    lo = torch.arange(n, dtype=torch.int64, device=data.device)
    hi, _ = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.where(hi < (1 << 31), 1.0, -1.0).to(dtype)
