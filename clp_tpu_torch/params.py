"""Typed parameter registry — the ClpParam/ClpParameters equivalent.

The reference registers ~100 typed CLI parameters with help text and
prefix matching (ClpParam.hpp ClpParamCode enum; ClpParameters.hpp:99-109).
This registry covers that enum name-for-name (Clp spellings kept) mapped
onto the framework's actual knobs. Every entry carries a `scope`:

  real    — the parameter changes behavior in this framework
  compat  — accepted for Clp CLI compatibility but a no-op BY DESIGN here
            (e.g. -threads: XLA owns threading; -sparseFactor: the basis
            kernel is blocked-dense on the MXU always). The help text says
            so explicitly — nothing is silently swallowed.

Actions (solves, IO, etc.) are declared here for help/parity and dispatched
by the CLI. STATUS.md carries the generated name-by-name parity table.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .constants import ScalingMode, SolveMethod


@dataclasses.dataclass
class Param:
    name: str
    kind: str  # "dbl" | "int" | "kwd" | "bool" | "action" | "str" | "file" | "dir"
    default: object
    help: str
    setter: Optional[Callable] = None  # (cli, value) -> None
    choices: Optional[tuple] = None
    scope: str = "real"  # "real" | "compat"


def _set_model(attr):
    def f(cli, v):
        setattr(cli.model, attr, v)

    return f


def _set_opts(attr):
    def f(cli, v):
        setattr(cli.options, attr, v)

    return f


def _set_presolve(attr):
    def f(cli, v):
        setattr(cli.options.presolve, attr, v)

    return f


def _set_cli(attr):
    def f(cli, v):
        setattr(cli, attr, v)

    return f


def _store(attr):
    """Accepted-for-compatibility: remembered on the CLI, no behavior."""

    def f(cli, v):
        cli.compat_params[attr] = v

    return f


def _scaling(cli, v):
    cli.options.scaling = {
        "off": ScalingMode.OFF,
        "equilibrium": ScalingMode.EQUILIBRIUM,
        "geometric": ScalingMode.GEOMETRIC,
        "automatic": ScalingMode.AUTO,
        "dynamic": ScalingMode.DYNAMIC,
    }.get(str(v).lower(), ScalingMode.AUTO)


def _direction(cli, v):
    v = str(v).lower()
    if v in ("max", "maximize"):
        cli.model.set_maximize()
    elif v in ("min", "minimize"):
        cli.model.set_minimize()
    else:
        cli.model.optimization_direction = 0.0


def _substitution(cli, v):
    """Presolve substitution level (ClpSolve.hpp:264-272 semantics)."""
    level = int(v)
    p = cli.options.presolve
    p.doubleton = level >= 1
    p.tripleton = level >= 2
    p.singleton_cols = level >= 3


def _presolve_kwd(cli, v):
    v = str(v).lower()
    cli.options.presolve.enabled = v != "off"
    if v == "more":
        cli.options.presolve.passes = 10


REGISTRY: dict[str, Param] = {}


def _reg(p: Param):
    REGISTRY[p.name.lower()] = p


# ---------------------------------------------------------------------------
# double parameters (reference: ClpParam.hpp FIRSTDBLPARAM..LASTDBLPARAM)
# ---------------------------------------------------------------------------
_reg(Param("primalTolerance", "dbl", 1e-7, "primal feasibility tolerance", _set_model("primal_tolerance")))
_reg(Param("dualTolerance", "dbl", 1e-7, "dual feasibility tolerance", _set_model("dual_tolerance")))
_reg(Param("seconds", "dbl", -1.0, "maximum seconds", _set_opts("max_seconds")))
_reg(Param("timeLimit", "dbl", -1.0, "maximum seconds (alias)", _set_opts("max_seconds")))
_reg(Param("dualBound", "dbl", 1e10, "fake bound magnitude for dual phase 1", _set_opts("dual_bound")))
_reg(Param("fakeBound", "dbl", 1e10, "fake bound magnitude (alias of dualBound)", _set_opts("dual_bound")))
_reg(Param("objScale", "dbl", 1.0, "objective scale factor applied for the solve", _set_opts("objective_scale")))
_reg(Param("objScale2", "dbl", 1.0, "second objective scale factor (multiplies objScale)",
           lambda cli, v: setattr(cli.options, "objective_scale", cli.options.objective_scale * float(v))))
_reg(Param("rhsScale", "dbl", 1.0, "rhs/bounds scale factor applied for the solve", _set_opts("rhs_scale")))
_reg(Param("presolveTolerance", "dbl", 1e-10, "presolve feasibility tolerance", _set_presolve("tolerance")))
_reg(Param("zeroTolerance", "dbl", 1e-20, "drop matrix coefficients below this in presolve", _set_presolve("zero_coefficient_tol")))
_reg(Param("dualObjectiveLimit", "dbl", 1e30, "stop dual when objective exceeds", _set_model("dual_objective_limit")))
_reg(Param("primalObjectiveLimit", "dbl", -1e30, "stop primal when objective below", _set_model("primal_objective_limit")))
_reg(Param("barrierTolerance", "dbl", 1e-8, "barrier convergence tolerance", _set_opts("barrier_tolerance")))
_reg(Param("primalWeight", "dbl", 1e10, "infeasibility cost weight (compat: phase 1 here uses the pure "
           "infeasibility gradient, not a composite cost)", _store("primalWeight"), scope="compat"))
def _psi(cli, v):
    # reference semantics (ClpParam psi): magnitude is the PE threshold;
    # a positive value also switches pricing to the Positive-Edge rules
    v = float(v)
    cli.options.pe_psi = abs(v)
    if v > 0:
        cli.options.dual_pivot = "pesteepest"
        cli.options.primal_pivot = "pesteepest"


_reg(Param("psi", "dbl", -0.5, "positive-edge psi threshold (>0 also selects PE pricing)", _psi))
def _progress(cli, v):
    cli.options.progress = 0 if float(v) == 0.0 else 1
    cli.progress_deterministic = float(v) == 0.0


_reg(Param("progress", "dbl", 1.0, "progress display: 0 = deterministic table mode",
           _progress))

# ---------------------------------------------------------------------------
# integer parameters
# ---------------------------------------------------------------------------
_reg(Param("maxIterations", "int", 2**31 - 1, "iteration limit", _set_opts("max_iterations")))
_reg(Param("shapeBucket", "int", 0, "pad shapes to this multiple so nearby"
           " shapes share one compiled program (serving lever; 0 = off)",
           _set_opts("shape_bucket")))
_reg(Param("maxFactor", "int", 100, "refactorization frequency", _set_opts("refactor_frequency")))
_reg(Param("logLevel", "int", 1, "verbosity 0-4",
           lambda cli, v: (setattr(cli, "log_level", int(v)), setattr(cli.options, "log_level", int(v)))))
_reg(Param("randomSeed", "int", 1234567, "random seed (perturbation)", _set_model("random_seed")))
_reg(Param("idiotCrash", "int", 0, "idiot crash passes", _set_opts("idiot_passes")))
_reg(Param("sprint", "int", 100, "sprint (sifting) pass limit", _set_opts("sprint_passes")))
_reg(Param("sprintCrash", "int", 0, "sprint pass limit (alias)", _set_opts("sprint_passes")))
_reg(Param("perturbation", "int", 100, "perturbation (100 = auto)", _set_opts("perturbation")))
_reg(Param("pertValue", "int", 0, "perturbation magnitude override", _set_opts("perturbation")))
_reg(Param("maxBarrierIterations", "int", 200, "barrier iteration limit", _set_opts("barrier_max_iterations")))
_reg(Param("presolvePass", "int", 5, "presolve passes", _set_presolve("passes")))
_reg(Param("substitution", "int", 3, "presolve substitution level: 0 none / 1 doubleton / "
           "2 +tripleton / 3 +singleton-column (default)", _substitution))
_reg(Param("dualize", "int", 0, "0 off / 1 solve the dualized model and map back", _set_opts("dualize")))
_reg(Param("slpValue", "int", 0, "SLP passes for nonlinear objectives", _set_opts("slp_passes")))
_reg(Param("cppGenerate", "int", 0, "generate_python output level (see -genPy FILE action)", _store("cpp"), scope="compat"))
def _progress_iter(cli, v):
    cli.options.progress_iter = int(v)
    cli.progress_every = int(v)


_reg(Param("progressIter", "int", 100, "progress line every N iterations",
           _progress_iter))
_reg(Param("outputFormat", "int", 2, "solution file format 1-6 (1=plain values, 2=indexed)", _set_cli("output_format")))
_reg(Param("specialOptions", "int", 0, "bitmask behavior switches (compat: stored on the model; "
           "TPU engine switches are explicit options)", _set_model("special_options"), scope="compat"))
_reg(Param("moreSpecialOptions", "int", 0, "more bitmask switches (compat: stored)", _store("moreSpecialOptions"), scope="compat"))
_reg(Param("presolveOptions", "int", 0, "per-transform presolve bits (compat: use -substitution / "
           "PresolveOptions fields)", _store("presolveOptions"), scope="compat"))
_reg(Param("decomposeBlocks", "int", 0, "Benders/DW block count hint (library: clp_tpu_torch.decompose)", _store("decomposeBlocks"), scope="compat"))
_reg(Param("denseThreshold", "int", -1, "dense factorization threshold (compat: basis kernel is "
           "blocked-dense on the MXU always)", _store("dense"), scope="compat"))
_reg(Param("smallFactorization", "int", -1, "small-basis factorization threshold (compat: see denseThreshold)", _store("smallFact"), scope="compat"))
_reg(Param("threads", "int", 0, "thread count (compat: XLA owns device parallelism)", _store("threads"), scope="compat"))
_reg(Param("vectorMode", "int", 0, "vector-copy matrix mode (compat: single dense device layout)", _store("vectorMode"), scope="compat"))
_reg(Param("printOptions", "int", 0, "print-format switches (compat)", _store("printOptions"), scope="compat"))
_reg(Param("verbose", "int", 0, "help verbosity (compat: one help level)", _store("verbose"), scope="compat"))

# ---------------------------------------------------------------------------
# keyword parameters
# ---------------------------------------------------------------------------
_reg(Param("scaling", "kwd", "automatic", "off/equilibrium/geometric/automatic/dynamic", _scaling,
           ("off", "equilibrium", "geometric", "automatic", "dynamic")))
_reg(Param("presolve", "kwd", "on", "on/off/more", _presolve_kwd, ("on", "off", "more")))
_reg(Param("crash", "kwd", "off", "initial basis heuristic", lambda cli, v: _set_opts("crash")(cli, str(v).lower()),
           ("off", "idiot", "triangular", "allslack")))
_reg(Param("dualPivot", "kwd", "steepest", "dual pricing rule", _set_opts("dual_pivot"),
           ("steepest", "dantzig", "pesteepest")))
_reg(Param("primalPivot", "kwd", "devex", "primal pricing rule", _set_opts("primal_pivot"),
           ("devex", "dantzig", "steepest", "exact", "partial", "pesteepest")))
_reg(Param("crossover", "kwd", "on", "barrier crossover on/off",
           lambda cli, v: _set_opts("crossover")(cli, str(v).lower() != "off"), ("on", "off")))
_reg(Param("direction", "kwd", "minimize", "optimization direction", _direction,
           ("minimize", "maximize", "zero")))
_reg(Param("gamma", "kwd", "off", "barrier regularization boost (on = 100x primal/dual regularization)",
           lambda cli, v: setattr(cli.options, "barrier_regularize", str(v).lower() != "off"),
           ("off", "on", "gamma", "delta")))
_reg(Param("KKT", "kwd", "off", "barrier KKT mode (compat: normal equations always; QP handled natively)",
           _store("kkt"), ("off", "on"), scope="compat"))
_reg(Param("cholesky", "kwd", "native", "Cholesky backend (compat: dense regularized Cholesky on the MXU "
           "is the only backend; external libs n/a)", _store("cholesky"),
           ("native", "dense", "fudgeLong", "wssmp", "universityOfFlorida", "Taucs", "Mumps", "Pardiso"), scope="compat"))
_reg(Param("factorization", "kwd", "normal", "LU flavor (compat: blocked-dense panel LU always)",
           _store("factorization"), ("normal", "dense", "simple", "osl"), scope="compat"))
_reg(Param("biasLU", "kwd", "UX", "LU pivot bias (compat)", _store("biasLU"), ("UU", "UX", "LX", "LL"), scope="compat"))
_reg(Param("barrierScale", "kwd", "off", "barrier-specific scaling (compat: one scaling pipeline)",
           _store("barrierScale"), ("off", "on"), scope="compat"))
_reg(Param("abcWanted", "kwd", "off", "Aboca parallel simplex (compat: the engine is vectorized by design)",
           _store("abc"), ("off", "one", "two", "decide"), scope="compat"))
_reg(Param("vector", "kwd", "off", "vector matrix copy (compat)", _store("vector"), ("off", "on"), scope="compat"))
_reg(Param("commandPrintLevel", "kwd", "more", "parameter echo level (compat)", _store("commandPrintLevel"),
           ("more", "all", "important"), scope="compat"))
_reg(Param("intPrint", "kwd", "off", "print integer solution style (compat)", _store("intPrint"),
           ("off", "on"), scope="compat"))

# ---------------------------------------------------------------------------
# bool parameters
# ---------------------------------------------------------------------------
_reg(Param("autoScale", "bool", False, "automatic scaling (alias of -scaling automatic)",
           lambda cli, v: _scaling(cli, "automatic" if v else "off")))
_reg(Param("errorsAllowed", "bool", False, "continue after import errors", _set_cli("errors_allowed")))
_reg(Param("keepNames", "bool", True, "keep row/column names (compat: names are always kept)",
           _store("keepNames"), scope="compat"))
_reg(Param("messages", "bool", False, "message prefixes on/off",
           lambda cli, v: setattr(cli, "message_prefixes", bool(v))))
_reg(Param("bufferMode", "bool", False, "buffered stdout (compat)", _store("bufferMode"), scope="compat"))
_reg(Param("PFI", "bool", False, "product-form-of-inverse updates (compat: PF updates are the engine's "
           "only update scheme — always on)", _store("pfi"), scope="compat"))
_reg(Param("sparseFactor", "bool", True, "sparse LU (compat: blocked-dense MXU kernels by design)",
           _store("sparseFactor"), scope="compat"))

# ---------------------------------------------------------------------------
# string / file / directory parameters
# ---------------------------------------------------------------------------
_reg(Param("printMask", "str", "", "fnmatch mask filtering -printsol rows", _set_cli("print_mask")))
_reg(Param("directory", "dir", ".", "base directory for file actions", _set_cli("directory")))
_reg(Param("dirSample", "dir", "", "sample-data directory", _set_cli("dir_sample")))
_reg(Param("dirNetlib", "dir", "", "netlib-data directory", _set_cli("dir_netlib")))
_reg(Param("dirMiplib", "dir", "", "miplib directory (compat: no MIP data driver)", _store("dirMiplib"), scope="compat"))

# ---------------------------------------------------------------------------
# actions (dispatched by the CLI; declared here for help + parity)
# ---------------------------------------------------------------------------
for name, help_ in (
    ("dualSimplex", "solve with dual simplex"),
    ("primalSimplex", "solve with primal simplex"),
    ("eitherSimplex", "automatic simplex choice"),
    ("barrier", "interior point + crossover"),
    ("solve", "automatic method choice"),
    ("either", "automatic method choice"),
    ("sprintSolve", "sifting / column subset solve"),
    ("pdlp", "first-order PDHG solve"),
    ("network", "network-structure handling (structure is auto-detected; prints detection)"),
    ("plusMinus", "+-1 structure handling (auto-detected; prints detection)"),
    ("allSlack", "reset to the all-slack basis"),
    ("reallyScale", "permanently scale the model in place"),
    ("reverse", "reverse the optimization direction"),
    ("tighten", "tighten integer/continuous bounds from row ranges"),
    ("outDupRows", "detect and drop duplicate rows"),
    ("parametrics", "FILE: RHS/bound homotopy driven by a parametrics file"),
    ("guess", "suggest solve settings from problem shape"),
    ("import", "read model file (MPS/LP, gzip ok)"),
    ("export", "write MPS file"),
    ("readModel", "restore a model saved with -writeModel"),
    ("writeModel", "save the model in binary form"),
    ("readSol", "read a solution file"),
    ("writeSol", "write solution file (-solution alias)"),
    ("writeSolBinary", "write solution in binary form"),
    ("basisIn", "read basis file"),
    ("basisOut", "write basis file"),
    ("printSolution", "print nonzero primal solution values"),
    ("solution", "write solution to file ('-' = stdout)"),
    ("maximize", "set maximization"),
    ("minimize", "set minimization"),
    ("statistics", "print problem statistics"),
    ("environment", "process the CLP_ENVIRONMENT variable"),
    ("genPy", "FILE: write a python script reproducing the model (generateCpp parity)"),
    ("stdin", "enter interactive mode"),
    ("netlib", "run netlib golden set (dual)"),
    ("netlibPrimal", "netlib via primal simplex"),
    ("netlibDual", "netlib via dual simplex"),
    ("netlibBarrier", "netlib via barrier"),
    ("netlibTune", "netlib with tuned settings"),
    ("unitTest", "run built-in tests"),
    ("printVersion", "print version"),
    ("writeGmplSol", "write solution in GMPL/MathProg data format"),
    ("help", "print the command list (also '?')"),
    ("generalQuery", "print the command list (alias of help / '?')"),
    ("fullGeneralQuery", "print every parameter with help text (also '???')"),
    ("end", "quit"),
    ("exit", "quit"),
    ("quit", "quit"),
    ("stop", "quit"),
):
    _reg(Param(name, "action", None, help_))

# compat actions: accepted, no-op BY DESIGN, help says why
for name, help_ in (
    ("clearCuts", "clear the cut store (compat: cuts live in the MIP layer here)"),
    ("userClp", "user-registered action hook (compat: use event handlers / the Python API)"),
):
    _reg(Param(name, "action", None, help_, scope="compat"))

# AMPL driver protocol (ClpMain.cpp:292-303 clpReadAmpl/writeAmplSol):
# `clp_tpu stub -AMPL` reads the linear text-format stub.nl (io/nl.py),
# solves (AUTOMATIC unless another solve action ran), and writes stub.sol
_reg(Param("AMPL", "action", None,
           "AMPL driver protocol: read <stub>.nl (linear, text format), "
           "solve, write <stub>.sol"))


def _file_default(key):
    def f(cli, v):
        cli.file_defaults[key] = str(v)

    return f


# ---------------------------------------------------------------------------
# file parameters (reference: FIRSTFILEPARAM..LASTFILEPARAM) — each sets the
# DEFAULT filename its matching action uses when invoked without one
# ---------------------------------------------------------------------------
for name, key, help_ in (
    ("basisFile", "basis", "default file for -basisIn/-basisOut"),
    ("exportFile", "export", "default file for -export"),
    ("importFile", "import", "default file for -import"),
    ("modelFile", "model", "default file for -readModel/-writeModel"),
    ("solutionFile", "solution", "default file for -solution/-writeSol"),
    ("solutionBinaryFile", "solution_binary", "default file for -writeSolBinary"),
    ("parametricsFile", "parametrics", "default file for -parametrics"),
    ("gmplSolFile", "gmpl_sol", "default file for -writeGmplSol"),
):
    _reg(Param(name, "file", "", help_, _file_default(key)))


def lookup(name: str) -> Optional[Param]:
    """Clp-style abbreviated matching: unique case-insensitive prefix."""
    low = name.lower()
    if low in REGISTRY:
        return REGISTRY[low]
    matches = [p for k, p in REGISTRY.items() if k.startswith(low)]
    return matches[0] if len(matches) == 1 else None


def apply(cli, name: str, value) -> bool:
    p = lookup(name)
    if p is None or p.setter is None:
        return False
    if p.kind == "dbl":
        value = float(value)
    elif p.kind == "int":
        value = int(value)
    elif p.kind == "bool":
        value = str(value).lower() in ("1", "on", "true", "yes")
    elif p.kind == "kwd" and p.choices:
        v = str(value).lower()
        full = [c for c in p.choices if c.lower().startswith(v)]
        if len(full) != 1:
            raise ValueError(f"{name}: expected one of {p.choices}, got {value!r}")
        value = full[0]
    p.setter(cli, value)
    return True


def help_text(scope: Optional[str] = None) -> str:
    lines = ["Parameters (Clp-style names, unique-prefix matching):"]
    for p in sorted(REGISTRY.values(), key=lambda p: (p.kind, p.name.lower())):
        if scope and p.scope != scope:
            continue
        ch = f" [{'/'.join(p.choices)}]" if p.choices else ""
        d = f" (default {p.default})" if p.default is not None else ""
        tag = "" if p.scope == "real" else " [compat]"
        lines.append(f"  {p.name:24s} {p.kind:6s} {p.help}{ch}{d}{tag}")
    return "\n".join(lines)


def parity_table() -> str:
    """Markdown table: every registered param, kind, and scope."""
    lines = ["| parameter | kind | scope | effect |", "|---|---|---|---|"]
    for p in sorted(REGISTRY.values(), key=lambda p: (p.kind, p.name.lower())):
        lines.append(f"| {p.name} | {p.kind} | {p.scope} | {p.help} |")
    return "\n".join(lines)
