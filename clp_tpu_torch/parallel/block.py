"""Block mesh axis: column shards of ONE wide LP across devices.

The reference's Sprint/column-generation repricing is a sequential loop
over all columns (ClpSolve.cpp:2486+). Here the matrix's columns live as
contiguous shards over the "block" mesh axis, the duals are copied to
every shard, and each shard computes its own dj = c - y'G and its own k
best columns. The candidates are merged on the first device into the
global top k: traffic O(shards * k) floats plus dj itself, never the
matrix.

The JAX package's version lets XLA derive the all-gather behind
`lax.top_k` from the shardings; `merge_smallest_k` writes that merge out
with the engine's total order and a global-index tie-break, so it gives
the top k over the whole row bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..simplex.engine import _smallest_k
from .mesh import Mesh, make_mesh


def make_block_mesh(devices: Optional[Sequence] = None) -> Mesh:
    return make_mesh(devices, axis_name="block")


def merge_smallest_k(vals: Sequence[torch.Tensor], K: int, *payloads) -> tuple:
    """The K smallest of per-shard candidate lists, ascending, ties by the
    lower global index.

    `vals[s]` are shard s's candidate values, ascending in the engine's
    total order with ties by index (`engine._smallest_k` over the shard);
    shards come in column order. Every list is moved to the first shard's
    device and concatenated, so equal keys stand in global index order, and
    one stable sort keeps it: the result equals `_smallest_k` over the
    whole row. Each payload (per-shard lists beside `vals`, such as the
    candidates' global indices) is permuted the same way. Returns
    (values, *payloads)."""
    dev = vals[0].device

    def cat(ts):
        return torch.cat([t.to(dev) for t in ts])

    v = cat(vals)
    order = _smallest_k(v, K)
    return (v.index_select(0, order),) + tuple(cat(p).index_select(0, order)
                                               for p in payloads)


class BlockShardedColumns:
    """Device-resident column shards of (A, c) for repeated repricing."""

    def __init__(self, A, c, mesh: Mesh):
        A = np.asarray(A.todense()) if hasattr(A, "todense") else np.asarray(A)
        c = np.asarray(c, dtype=np.float64)
        m, n = A.shape
        d = mesh.size
        pad = (-n) % d
        if pad:
            A = np.pad(A, ((0, 0), (0, pad)))
            # padded columns never price as attractive
            c = np.pad(c, (0, pad), constant_values=1e30)
        self.n = n
        self.mesh = mesh
        w = (n + pad) // d
        self.offsets = [s * w for s in range(d)]
        At = torch.as_tensor(A, dtype=torch.float64)
        ct = torch.as_tensor(c)
        self.G = [At[:, o:o + w].to(dev) for o, dev in zip(self.offsets, mesh.devices)]
        self.c = [ct[o:o + w].to(dev) for o, dev in zip(self.offsets, mesh.devices)]

    def reprice(self, y: np.ndarray, k: int = 256):
        """Full-set pricing: returns (dj[n], top-k values, top-k indices),
        the k most attractive (most negative) reduced costs first."""
        k = min(k, self.n)
        yt = torch.as_tensor(np.asarray(y, dtype=np.float64))
        djs, vals, idxs = [], [], []
        for G, c, off in zip(self.G, self.c, self.offsets):
            dj = c - yt.to(G.device) @ G
            loc = _smallest_k(dj, min(k, dj.shape[0]))
            djs.append(dj)
            vals.append(dj.index_select(0, loc))
            idxs.append(loc + off)
        v, i = merge_smallest_k(vals, k, idxs)
        dev = self.mesh.first
        dj = torch.cat([t.to(dev) for t in djs])
        return dj[: self.n].cpu().numpy(), v.cpu().numpy(), i.cpu().numpy()
