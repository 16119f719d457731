"""clp_tpu_torch — the PyTorch + CUDA port of clp_tpu, the JAX package.

The same capability surface as the JAX package, for one NVIDIA Hopper card:
plain tensor code is PyTorch, and each TPU kernel of the JAX package is a
CUDA kernel written by hand (`csrc/`, built with nvcc at first use). The
port imports neither jax nor any module of the JAX package.

Problem class:  minimize c'x
                subject to row_lower <= A x <= row_upper
                           col_lower <=   x <= col_upper

Entry points:
    Model               — problem container (ClpModel equivalent)
    SolveOptions        — solve configuration; `device` picks the card
                          ("cuda", the default) or the CPU ("cpu")
    initial_solve       — orchestrated solve (presolve -> method -> postsolve)
    solve_batch         — one-call batched solve of many same-shape LPs
    read_mps/write_mps  — MPS IO (read_lp/write_lp: LP format)
    ranging/parametrics — post-optimal analysis on the solve's device
    python -m clp_tpu_torch — the clp command line (cli.py)

LP solvers need float64 for the rim data and the refactorizations; the
mixed-precision engine runs its pivot loop in f32 on the card.
"""

from __future__ import annotations

from .constants import (  # noqa: F401
    INF,
    ProblemStatus,
    SecondaryStatus,
    VariableStatus,
    SolveMethod,
    ScalingMode,
)
from .model import Model, Solution  # noqa: F401
from .options import SolveOptions, PresolveOptions  # noqa: F401
from .io.mps import read_mps, write_mps  # noqa: F401
from .io.lp_format import read_lp, write_lp  # noqa: F401
from .validate import check_kkt, check_objective  # noqa: F401
from .solve import initial_solve, solve_batch  # noqa: F401
from .analysis import ranging, parametrics, dualize, find_iis  # noqa: F401

__version__ = "0.1.0"
