"""Model IO: MPS (native C++ parser with the Python reader behind it),
LP-format, AMPL .nl and MPS basis files.

Copies of the JAX package's readers and writers (clp_tpu/io), which write
the same bytes and read back the same arrays.
"""

from .mps import read_mps, write_mps  # noqa: F401
from .lp_format import read_lp, write_lp  # noqa: F401
