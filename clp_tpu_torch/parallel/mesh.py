"""Device meshes and the split of a leading axis over them.

Axes: "scenario" shards independent LP instances (parallel/batch.py);
"block" shards the columns of one LP (parallel/block.py for SPRINT's
repricing, parallel/colshard.py for the dual engine).

The JAX package's `jax.sharding.Mesh` is single-controller: one process
drives every device. The port's mesh is the same idea written out: an
ordered tuple of torch devices that one process drives. A shard is a
tensor on its entry's device, and what the partitioner's collectives do
in the JAX package the port does with explicit copies onto the first
entry's device. The same device may appear several times, the port's
counterpart of the JAX tests' forced host device count: ["cpu"] * 8 on
the CPU, ["cuda:0"] * 4 on one card (every shard then lives on that one
card), cuda:0 ... cuda:3 on a four-card host, with the same code.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..device import default_device, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple  # torch.device per mesh entry, in order
    axis_name: str = "scenario"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> tuple:
        return (self.axis_name,)

    @property
    def first(self) -> torch.device:
        return self.devices[0]


def default_devices() -> list:
    """Every CUDA device the process sees; under CLPTPU_PLATFORM=cpu the
    CPU alone."""
    if default_device() == "cpu":
        return [torch.device("cpu")]
    resolve_device("cuda")  # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = "scenario") -> Mesh:
    devs = default_devices() if devices is None else list(devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(resolve_device(d) for d in devs), axis_name)


@dataclasses.dataclass(frozen=True)
class LaneSharding:
    """A leading axis split into contiguous blocks, one per mesh entry (the
    JAX package's NamedSharding(mesh, P(axis)))."""

    mesh: Mesh

    def bounds(self, n: int) -> list:
        """(start, stop) of each entry's block of an axis of length n."""
        d = self.mesh.size
        if n % d:
            # jax.device_put refuses the same split
            raise ValueError(
                f"the leading axis ({n}) must be divisible by the mesh size ({d})")
        w = n // d
        return [(i * w, (i + 1) * w) for i in range(d)]

    def split(self, x: torch.Tensor) -> list:
        """x's blocks, each on its entry's device."""
        return [x[a:b].to(dev) for (a, b), dev in zip(self.bounds(x.shape[0]),
                                                       self.mesh.devices)]


@dataclasses.dataclass(frozen=True)
class Replicated:
    """A copy on every mesh entry (NamedSharding(mesh, P()))."""

    mesh: Mesh

    def split(self, x: torch.Tensor) -> list:
        return [x.to(dev) for dev in self.mesh.devices]


def scenario_sharding(mesh: Mesh, axis_name: str = "scenario") -> LaneSharding:
    """Shard the leading (batch) axis across the mesh; replicate the rest."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"axis {axis_name!r} is not in the mesh's axes {mesh.axis_names}")
    return LaneSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)
