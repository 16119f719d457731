"""Model IO: the pure-Python MPS reader and writer.

The LP-format, NL and basis files and the native MPS parser route of the
JAX package wait (ROADMAP.md queue 1: analysis/API/CLI).
"""

from .mps import read_mps, write_mps  # noqa: F401
