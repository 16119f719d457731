"""Solve options — the ClpSolve equivalent (reference: ClpSolve.hpp).

Carries the method choice, presolve controls (per-transform on/off mirrors
ClpSolve.hpp:123-262), special options, and device/batching controls that are
new in the TPU build.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .constants import SolveMethod, ScalingMode
from .device import default_device


@dataclasses.dataclass
class PresolveOptions:
    """Per-transform switches (reference: ClpSolve.hpp:123-262)."""

    enabled: bool = True
    passes: int = 5  # reference default numberPasses
    tolerance: float = 1e-10  # presolve feasibility tolerance
    zero_coefficient_tol: float = 1e-20  # drop matrix entries below this
    dual_fixing: bool = True
    singleton_rows: bool = True
    singleton_cols: bool = True
    doubleton: bool = True
    tripleton: bool = True
    forcing: bool = True
    fixed_variables: bool = True
    empty_rows_cols: bool = True
    duplicate_rows: bool = True
    duplicate_cols: bool = True
    implied_free: bool = True
    dominated_cols: bool = False  # off by default, as in reference substitution=3


@dataclasses.dataclass
class SolveOptions:
    """Equivalent of ClpSolve + the TPU-native execution controls."""

    method: SolveMethod = SolveMethod.AUTOMATIC
    presolve: PresolveOptions = dataclasses.field(default_factory=PresolveOptions)
    scaling: ScalingMode = ScalingMode.AUTO
    max_iterations: Optional[int] = None
    max_seconds: Optional[float] = None
    # simplex knobs
    dual_pivot: str = "steepest"  # "steepest" | "dantzig" | "pesteepest"
    # "devex" | "dantzig" | "steepest"/"exact" | "partial" | "pesteepest"
    primal_pivot: str = "devex"
    perturbation: int = 100  # reference semantics: 100 = auto-on-if-slow
    # None = auto: 100, raised to 400/800 in the mixed-precision engine
    # that CUDA solves run (cost-model analogue of
    # ClpFactorization::timeToRefactorize)
    refactor_frequency: Optional[int] = None
    dual_bound: float = 1e10  # fake bound magnitude (dualBound param)
    crash: str = "none"  # "none" | "idiot" | "triangular" | "allslack"
    idiot_passes: int = 0
    sprint_passes: int = 100
    slp_passes: int = 0
    dualize: int = 0  # 1 = solve the dualized model and map back
    # start from the current solution values (reference ifValuesPass:
    # ClpSimplex::dual(1)/primal(1)); basis built from the point
    values_pass: int = 0
    # PDLP matrix backend: None = auto (sparse BCOO when the matrix is
    # large and sparse), True/False force sparse/dense matvecs
    pdlp_sparse: Optional[bool] = None
    # fused FTRAN + rank-1 update kernel K2 (mixed engine; see
    # ops/pivot.py) — opt-in, as in the JAX package
    use_pallas_pivot: bool = False
    # progress table (reference -progress/-progressIter): -1 off,
    # 0 deterministic (no timestamps, diffable), 1 live
    progress: int = -1
    progress_iter: int = 100
    # rim scale factors applied for the solve, unscaled on the way out
    # (reference: ClpObjScale/ClpRhsScale dblParams, ClpModel.hpp:1124-1161)
    objective_scale: float = 1.0
    rhs_scale: float = 1.0
    # serving-mode compile amortization (no reference analogue — XLA
    # compiles one program per (rows, cols) shape, minutes per shape on a
    # TPU): pad rows/cols up to multiples of this bucket with inert
    # zero-row/zero-column padding so nearby shapes share one compiled
    # program. 0 = off. The padding never pivots (fixed [0,0] bounds,
    # decoupled rows) and is stripped from the Solution.
    shape_bucket: int = 0
    # barrier knobs
    barrier_max_iterations: int = 200
    barrier_tolerance: float = 1e-8
    crossover: bool = True
    barrier_regularize: bool = False  # gamma/delta boost (100x regularization)
    # mixed-precision barrier: f32 dense normal-equations assembly/factor
    # with Jacobi scaling + f64 matvec refinement. "auto" = on for CUDA
    # solves, mirroring the JAX package's TPU setting; True/False force it.
    # An LP whose IPM exits non-converged is finished by the simplex.
    barrier_mixed32: object = "auto"
    # numerics
    dtype: str = "float64"
    # fused PRICE kernel K1 for the dual simplex (f32 pricing, f64 pivot
    # verification; ops/price.py). "auto" = on for CUDA solves with
    # m*nt >= 512*1024, off on the CPU; True/False force it.
    use_pallas_price: object = "auto"
    # mixed-precision pivot loop: the basis inverse and all O(m^2)-per-pivot
    # work against it run in f32, with f64 refactorization/recompute and
    # claim verification every refactor_frequency pivots. "auto" = f32 for
    # CUDA solves at >=512 rows (mirroring the JAX package's TPU branch),
    # f64 on the CPU; "float64"/"float32" force it.
    inverse_dtype: str = "auto"  # "auto" | "float64" | "float32"
    # engine PRICE/FTRAN kernels: "auto" picks the multiply-free +-1 path
    # (gathers, O(n) PRICE) when the matrix qualifies (ClpPlusMinusOneMatrix
    # / ClpNetworkMatrix role); "dense" forces the dense contraction;
    # "block" prices block-banded LPs over column tiles of their row
    # windows (kernel K3 on the card), and declines to "dense" where the LP
    # is not block-banded enough. It is opt-in, as in the JAX package.
    # "ell" prices through sparse row-padded forms of G (gathers and row
    # sums); "auto" takes it only when the dense f32 copy of G would pass
    # 6 GB at density <= 2%.
    price_mode: str = "auto"  # "auto" | "dense" | "pm1" | "ell" | "block"
    # dual ratio test: "bfrt" = long-step bound-flipping ratio test (walk
    # past boxed breakpoints while the leaving row's infeasibility slope
    # stays positive — far fewer pivots on box-rich LPs), "harris" =
    # first-breakpoint two-pass test. "auto" = bfrt when a meaningful
    # fraction of variables (columns + slacks) is boxed.
    dual_ratio: str = "auto"  # "auto" | "harris" | "bfrt"
    # Positive-Edge threshold (reference: ClpPESimplex psi); used by the
    # "pesteepest" pivot rules
    pe_psi: float = 0.5
    # batching / sharding (TPU-native, no reference analogue)
    mesh_axis: str = "scenario"
    devices: Optional[object] = None  # a parallel.mesh.Mesh ("block" axis: SPRINT's repricing)
    # cleanup: run a finishing simplex on the original model after postsolve
    # if residual infeasibilities remain (reference: ClpSolve.cpp:~3550+)
    cleanup: bool = True
    log_level: int = 1
    # torch device the solve runs on. "cuda" with no card raises; the
    # port never falls back to the CPU on its own. Tests pass "cpu". The
    # default is device.default_device(): "cpu" under CLPTPU_PLATFORM=cpu.
    device: str = dataclasses.field(default_factory=default_device)
