"""Interior-point solvers (the barrier path).

The port of ClpInterior + ClpPredictorCorrector (ClpInterior.hpp:71,
ClpPredictorCorrector.cpp:75): a Mehrotra predictor-corrector whose
Newton systems run on the LP tensors' device — dense, banded or
multifrontal normal equations, or matrix-free CG / LSQR.
"""

from .mehrotra import IPMOptions, IPMResult, ipm_solve, ipm_solve_jit  # noqa: F401
