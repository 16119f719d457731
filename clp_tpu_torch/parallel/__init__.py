"""Scale-out: scenario batching and racing on one device.

The reference is a single-process shared-memory code; the capability it
lacks, and the JAX package adds, is solving many LP instances as one
batched program (`batch.py`) and racing seeds or configurations
(`racing.py`). A device mesh is not ported (ROADMAP.md queue 1:
multi-device).
"""

from .batch import solve_batch_ipm, stack_models  # noqa: F401
