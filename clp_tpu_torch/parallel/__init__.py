"""Scale-out: scenario batching, racing and device meshes.

The reference is a single-process shared-memory code; the capability it
lacks, and the JAX package adds, is solving many LP instances as one
batched program (`batch.py`), racing seeds or configurations
(`racing.py`), and splitting either a batch ("scenario" axis) or the
columns of one LP ("block" axis: `block.py`, `colshard.py`) over a device
mesh (`mesh.py`): an ordered list of devices that one process drives.
"""

from .mesh import make_mesh, scenario_sharding  # noqa: F401
from .batch import solve_batch_ipm, stack_models  # noqa: F401
