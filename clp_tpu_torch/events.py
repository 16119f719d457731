"""Event hooks, message catalog, and progress output.

Reference surfaces re-created:
  - ClpEventHandler (ClpEventHandler.hpp:61-103): named hook points fired
    through the solve; a handler returning a value >= 0 aborts the solve
    (status USER_STOPPED, ClpModel.hpp:435).
  - CoinMessageHandler / ClpMessage (ClpMessage.hpp): numbered message
    catalog with log levels.
  - ClpOutput (ClpOutput.hpp:16-80): tabular progress UI with a
    deterministic mode for diffable output.
"""

from __future__ import annotations

import dataclasses
import enum
import sys
import time


class Event(enum.IntEnum):
    """Hook points — the full ClpEventHandler enum (ClpEventHandler.hpp:
    32-76, values 100..141 match the reference so handlers written
    against Clp's numbering port unchanged) plus TPU-build extras below
    100.

    Granularity note: the jitted device engines trace whole pivot CHUNKS,
    so per-pivot reference hooks (PIVOT_ROW, BEFORE/AFTER_CHOOSE_INCOMING,
    START_OF_ITERATION_IN_DUAL, UPDATE_DUALS_IN_DUAL, COMPLICATED_PIVOT_*)
    fire at chunk boundaries where the information exists, and per-pivot
    only inside host-side engines; the remaining hooks fire at the exact
    structural analogue of the reference site (listed per member).
    """

    # --- TPU-build extras (no reference analogue) ---
    POSTSOLVE_START = 9
    POSTSOLVE_END = 10
    START_SOLVE = 11
    END_SOLVE = 12
    BARRIER_ITERATION = 13

    # --- ClpEventHandler.hpp enum, reference values ---
    END_OF_ITERATION = 100  # chunk boundary in the chunked loop
    END_OF_FACTORIZATION = 101  # chunk boundary (>=1 refactor per chunk)
    END_OF_VALUES_PASS = 102  # after the values-pass warmed solve
    NODE = 103  # B&B node processed (mip.py)
    TREE_STATUS = 104  # B&B tree stats (mip.py)
    SOLUTION = 105  # incumbent / final solution stored
    THETA = 106  # parametrics breakpoint (analysis.parametrics_exact)
    PIVOT_ROW = 107  # per-pivot: host engines only (see class docstring)
    PRESOLVE_START = 108
    PRESOLVE_SIZE = 109  # after presolve, with the size delta
    PRESOLVE_INFEASIBLE = 110  # presolve proves infeasible/unbounded
    PRESOLVE_BEFORE_SOLVE = 111  # presolved model about to be solved
    PRESOLVE_AFTER_FIRST_SOLVE = 112  # first inner solve done
    PRESOLVE_AFTER_SOLVE = 113  # after postsolve cleanup solve decision
    PRESOLVE_END = 114
    GOOD_FACTORIZATION = 115  # before a recompute (gutsOfSolution site)
    COMPLICATED_PIVOT_IN = 116  # chunk-level (see class docstring)
    NO_CANDIDATE_IN_PRIMAL = 117  # engine claims optimal, pre-verification
    LOOKS_END_IN_PRIMAL = 118  # about to declare victory (or defeat)
    END_IN_PRIMAL = 119  # final primal status settled
    BEFORE_STATUS_OF_PROBLEM_IN_PRIMAL = 120
    START_OF_STATUS_OF_PROBLEM_IN_PRIMAL = 121
    COMPLICATED_PIVOT_OUT = 122  # chunk-level (see class docstring)
    NO_CANDIDATE_IN_DUAL = 123  # engine claims optimal, pre-verification
    LOOKS_END_IN_DUAL = 124
    END_IN_DUAL = 125
    BEFORE_STATUS_OF_PROBLEM_IN_DUAL = 126
    START_OF_STATUS_OF_PROBLEM_IN_DUAL = 127
    START_OF_ITERATION_IN_DUAL = 128  # chunk-level (see class docstring)
    UPDATE_DUALS_IN_DUAL = 129  # chunk-level (see class docstring)
    BEFORE_DELETE_RIM = 130  # before unbuilding the standard form
    END_OF_CREATE_RIM = 131  # after to_standard_form
    SLIGHTLY_INFEASIBLE = 132  # postsolved point needs a cleanup solve
    MODIFY_MATRIX_IN_MINI_PRESOLVE = 133  # declared: no mini-presolve here
    MORE_MINI_PRESOLVE = 134  # declared: no mini-presolve here
    MODIFY_MATRIX_IN_MINI_POSTSOLVE = 135  # declared: no mini-presolve
    BEFORE_CHOOSE_INCOMING = 136  # chunk-level (see class docstring)
    AFTER_CHOOSE_INCOMING = 137  # chunk-level (see class docstring)
    BEFORE_CREATE_NON_LINEAR = 138  # solve_piecewise entry
    AFTER_CREATE_NON_LINEAR = 139  # solve_piecewise exit
    START_OF_CROSSOVER = 140  # barrier -> simplex crossover start
    NO_THETA = 141  # parametrics ends with no further pivot

    # legacy alias (round-1 name for the same hook)
    CROSSOVER_START = 140


class EventHandler:
    """Subclass and override `event`; return >= 0 to abort the solve."""

    def event(self, which: Event, model=None, **info) -> int:
        return -1


def fire_event(model, which: Event, **info) -> bool:
    """Fire a hook on the model's handler; True means abort requested
    (reference: handler return >= 0 -> ClpModel::status() = 5,
    ClpEventHandler.hpp:81-84)."""
    h = getattr(model, "event_handler", None)
    if h is None:
        return False
    if isinstance(h, EventHandler):
        rc = h.event(which, model, **info)
    else:
        rc = h(which, model)
    return rc is not None and rc >= 0


@dataclasses.dataclass
class DisasterSnapshot:
    """State handed to a DisasterHandler when a solve hits a terminal
    numerical failure: the model, which engine failed, the engine status
    code, iterations spent, and the basis statuses at the failure point
    (standard-form vstat: structurals then slacks)."""

    model: object
    algorithm: str  # "dual" | "primal"
    status: int  # engine status code (simplex.engine.NUMERICAL etc.)
    iterations: int
    vstat: object  # np.ndarray int32[n + m] at the failure point
    # the handler may adjust these before the recovery retry fires;
    # recognised keys: primal_tolerance, dual_tolerance, pivot_tolerance,
    # dual_bound, refactor_frequency, max_iterations
    retry_options: dict = dataclasses.field(default_factory=dict)


class DisasterHandler:
    """Pluggable catastrophic-recovery callback — the ClpDisasterHandler
    analogue (ClpEventHandler.hpp:154-205, attached via
    ClpSimplex::setDisasterHandler, ClpSimplex.hpp:992-1001).

    Attach with ``model.disaster_handler = handler``. When a simplex solve
    reaches a terminal numerical-failure state AFTER the driver's built-in
    escalation chain (algorithm switch -> full-f64 -> perturbation retry),
    the driver calls ``save_info(snapshot)`` then ``check(snapshot)``. If
    check returns True and ``type_of_disaster()`` is 0 ("can fix"), the
    driver runs ONE recovery retry: a fresh all-slack full-f64 solve with
    any tolerance adjustments the handler left in
    ``snapshot.retry_options``. Type 1 ("abort") accepts the failure.
    """

    def into_simplex(self, model) -> None:
        """Called when the simplex driver takes over the model."""

    def check(self, snapshot: DisasterSnapshot) -> bool:
        """Return True if this failure should trigger a recovery retry."""
        return False

    def save_info(self, snapshot: DisasterSnapshot) -> None:
        """Record state for the next attempt (reference saveInfo)."""

    def type_of_disaster(self) -> int:
        """0 = recoverable (retry fires), 1 = abort (reference contract)."""
        return 0


@dataclasses.dataclass
class Message:
    number: int
    level: int
    text: str


# ---------------------------------------------------------------------------
# Message catalog — name-for-name coverage of the reference's CLP_Message
# enum (ClpMessage.hpp:16-113). Keyed by the CLP_* name; legacy numeric keys
# used by early emitters are kept as aliases. Format fields are free-form
# kwargs; missing fields render as '?'.
# ---------------------------------------------------------------------------

_CLP_NAMES = [
    # (name, level, template)
    ("CLP_SIMPLEX_FINISHED", 1, "Optimal - objective value {obj:.10g}"),
    ("CLP_SIMPLEX_INFEASIBLE", 1, "Primal infeasible - infeasibility {pinf:.6g}"),
    ("CLP_SIMPLEX_UNBOUNDED", 1, "Dual infeasible (unbounded)"),
    ("CLP_SIMPLEX_STOPPED", 1, "Stopped on iterations/time - objective {obj:.10g}"),
    ("CLP_SIMPLEX_ERROR", 1, "Stopped due to errors"),
    ("CLP_SIMPLEX_INTERRUPT", 1, "Stopped by event handler"),
    ("CLP_SIMPLEX_STATUS", 1, "{it} Obj {obj:.8g}{extra}"),
    ("CLP_DUAL_BOUNDS", 3, "Dual bound {bound:.4g}"),
    ("CLP_SIMPLEX_ACCURACY", 2, "Primal error {perr:.3e} dual error {derr:.3e}"),
    ("CLP_SIMPLEX_BADFACTOR", 2, "Factorization accuracy {acc:.3e} - refactorizing"),
    ("CLP_SIMPLEX_BOUNDTIGHTEN", 2, "Tightened {n} bounds"),
    ("CLP_SIMPLEX_INFEASIBILITIES", 1, "{n} infeasibilities sum {sum:.6g}"),
    ("CLP_SIMPLEX_FLAG", 3, "Flagging variable {seq}"),
    ("CLP_SIMPLEX_GIVINGUP", 1, "Giving up on improving accuracy"),
    ("CLP_DUAL_CHECKB", 3, "Dual bound check {val:.4g}"),
    ("CLP_DUAL_ORIGINAL", 2, "Going back to original dual bounds"),
    ("CLP_SIMPLEX_PERTURB", 2, "Perturbing problem by {pct:.4g}%"),
    ("CLP_PRIMAL_ORIGINAL", 2, "Going back to original costs"),
    ("CLP_PRIMAL_WEIGHT", 3, "Infeasibility weight {w:.4g}"),
    ("CLP_PRIMAL_OPTIMAL", 1, "Primal optimal - objective {obj:.10g}"),
    ("CLP_SINGULARITIES", 2, "Factorization hit {n} singularities"),
    ("CLP_MODIFIEDBOUNDS", 2, "{n} variables had bounds modified"),
    ("CLP_RIMSTATISTICS1", 3, "Objective range {lo:.4g} to {hi:.4g}"),
    ("CLP_RIMSTATISTICS2", 3, "Bound range {lo:.4g} to {hi:.4g}"),
    ("CLP_RIMSTATISTICS3", 3, "RHS range {lo:.4g} to {hi:.4g}"),
    ("CLP_POSSIBLELOOP", 2, "Possible loop: objective repeated at iteration {it}"),
    ("CLP_SMALLELEMENTS", 1, "Dropped {n} elements smaller than {tol:.3g}"),
    ("CLP_DUPLICATEELEMENTS", 1, "{n} duplicate elements summed"),
    ("CLP_SIMPLEX_HOUSE1", 3, "Housekeeping {what}"),
    ("CLP_SIMPLEX_HOUSE2", 3, "Housekeeping {what}"),
    ("CLP_SIMPLEX_NONLINEAR", 2, "Nonlinear objective pass {it} value {obj:.8g}"),
    ("CLP_SIMPLEX_FREEIN", 3, "Free variable {seq} entering"),
    ("CLP_SIMPLEX_PIVOTROW", 3, "Pivot row {row} alpha {alpha:.4g}"),
    ("CLP_DUAL_CHECK", 3, "Dual check {val:.4g}"),
    ("CLP_PRIMAL_DJ", 3, "dj {dj:.4g} for sequence {seq}"),
    ("CLP_PACKEDSCALE_INITIAL", 3, "Initial scaling: range {lo:.3g}-{hi:.3g}"),
    ("CLP_PACKEDSCALE_WHILE", 3, "Scaling pass {it}: range {lo:.3g}-{hi:.3g}"),
    ("CLP_PACKEDSCALE_FINAL", 2, "Final scaling: range {lo:.3g}-{hi:.3g}"),
    ("CLP_PACKEDSCALE_FORGET", 2, "Scaling abandoned (already well scaled)"),
    ("CLP_INITIALIZE_STEEP", 3, "Initializing steepest-edge weights"),
    ("CLP_UNABLE_OPEN", 1, "Unable to open file {file}"),
    ("CLP_BAD_BOUNDS", 1, "{n} bad bound pairs were found"),
    ("CLP_BAD_MATRIX", 1, "Matrix has {n} large/bad elements"),
    ("CLP_LOOP", 1, "Loop detected - applying perturbation"),
    ("CLP_IMPORT_RESULT", 1, "Model was imported from {file} in {time:.2f} seconds"),
    ("CLP_IMPORT_ERRORS", 1, "{n} errors importing {file}"),
    ("CLP_EMPTY_PROBLEM", 1, "Empty problem - {rows} rows, {cols} columns"),
    ("CLP_CRASH", 2, "Crash basis: {n} variables placed"),
    ("CLP_END_VALUES_PASS", 2, "End of values pass at iteration {it}"),
    ("CLP_QUADRATIC_BOTH", 2, "QP {phase}: objective {obj:.8g}"),
    ("CLP_QUADRATIC_PRIMAL_DETAILS", 3, "QP primal details {what}"),
    ("CLP_IDIOT_ITERATION", 2, "Idiot pass {it}: objective {obj:.8g} infeas {pinf:.3e}"),
    ("CLP_INFEASIBLE", 1, "Problem proven infeasible"),
    ("CLP_MATRIX_CHANGE", 2, "Matrix specialized to {kind}"),
    ("CLP_TIMING", 1, "{phase} objective {obj:.10g} - {it} iterations time {time:.2f}"),
    ("CLP_INTERVAL_TIMING", 2, "{phase} took {time:.2f} seconds (total {total:.2f})"),
    ("CLP_SPRINT", 1, "Sprint pass {it}: {n} columns, objective {obj:.8g}"),
    ("CLP_BARRIER_ITERATION", 2, "Barrier iteration {it}: gap {gap:.3e} pinf {pinf:.3e} dinf {dinf:.3e}"),
    ("CLP_BARRIER_OBJECTIVE_GAP", 3, "Objective gap {gap:.3e}"),
    ("CLP_BARRIER_GONE_INFEASIBLE", 1, "Barrier lost feasibility"),
    ("CLP_BARRIER_CLOSE_TO_OPTIMAL", 2, "Barrier close to optimal"),
    ("CLP_BARRIER_COMPLEMENTARITY", 3, "Complementarity {mu:.3e}"),
    ("CLP_BARRIER_EXIT2", 2, "Barrier exit: {why}"),
    ("CLP_BARRIER_STOPPING", 1, "Barrier stopping: {why}"),
    ("CLP_BARRIER_EXIT", 1, "Barrier exit after {it} iterations"),
    ("CLP_BARRIER_SCALING", 3, "Barrier scaling {what}"),
    ("CLP_BARRIER_MU", 3, "mu {mu:.3e}"),
    ("CLP_BARRIER_INFO", 3, "Barrier info {what}"),
    ("CLP_BARRIER_END", 1, "Barrier done: objective {obj:.10g} ({it} iterations)"),
    ("CLP_BARRIER_ACCURACY", 2, "Barrier accuracy {acc:.3e}"),
    ("CLP_BARRIER_SAFE", 3, "Barrier safe mode {what}"),
    ("CLP_BARRIER_NEGATIVE_GAPS", 2, "{n} negative gaps"),
    ("CLP_BARRIER_REDUCING", 2, "Reducing {what}"),
    ("CLP_BARRIER_DIAGONAL", 3, "Diagonal range {lo:.3g}-{hi:.3g}"),
    ("CLP_BARRIER_SLACKS", 3, "Slack range {lo:.3g}-{hi:.3g}"),
    ("CLP_BARRIER_DUALINF", 2, "Barrier dual infeasibility {dinf:.3e}"),
    ("CLP_BARRIER_KILLED", 3, "{n} variables killed"),
    ("CLP_BARRIER_ABS_DROPPED", 2, "Dropped {n} dependent rows"),
    ("CLP_BARRIER_ABS_ERROR", 2, "Absolute error {err:.3e}"),
    ("CLP_BARRIER_FEASIBLE", 2, "Barrier primal feasible"),
    ("CLP_BARRIER_STEP", 3, "Steps: primal {ap:.3g} dual {ad:.3g}"),
    ("CLP_BARRIER_KKT", 2, "Using KKT system"),
    ("CLP_RIM_SCALE", 2, "Rim scaled: objective {os:.3g} rhs {rs:.3g}"),
    ("CLP_SLP_ITER", 2, "SLP pass {it}: objective {obj:.8g} step {step:.3e}"),
    ("CLP_COMPLICATED_MODEL", 1, "Model too complicated for {what}"),
    ("CLP_BAD_STRING_VALUES", 1, "{n} string values could not be processed"),
    ("CLP_CRUNCH_STATS", 2, "Crunch: {rows} rows, {cols} columns kept"),
    ("CLP_PARAMETRICS_STATS", 2, "Parametrics: theta {theta:.6g} objective {obj:.10g}"),
    ("CLP_PARAMETRICS_STATS2", 3, "Parametrics detail theta {theta:.6g}"),
    ("CLP_FATHOM_STATUS", 2, "Fathom node {node}: {status}"),
    ("CLP_FATHOM_SOLUTION", 2, "Fathom solution {obj:.10g} at node {node}"),
    ("CLP_FATHOM_FINISH", 2, "Fathom finished: {n} nodes"),
    ("CLP_GENERAL", 1, "{text}"),
    ("CLP_GENERAL2", 2, "{text}"),
    ("CLP_GENERAL_WARNING", 1, "WARNING: {text}"),
]

CATALOG: dict = {}
for _i, (_name, _lvl, _tmpl) in enumerate(_CLP_NAMES):
    _m = Message(_i, _lvl, _tmpl)
    CATALOG[_name] = _m
    CATALOG[_i + 100] = _m  # numeric id = 100 + enum position

# legacy numeric aliases (early emitters)
CATALOG[1] = CATALOG["CLP_SIMPLEX_FINISHED"]
CATALOG[2] = CATALOG["CLP_SIMPLEX_INFEASIBLE"]
CATALOG[3] = CATALOG["CLP_SIMPLEX_UNBOUNDED"]
CATALOG[4] = CATALOG["CLP_SIMPLEX_STOPPED"]
CATALOG[5] = CATALOG["CLP_SIMPLEX_ERROR"]
CATALOG[6] = Message(6, 1, "{rows} rows, {cols} columns and {elems} elements")
CATALOG[14] = Message(14, 1, "Presolve: {drows} rows and {dcols} columns dropped")
CATALOG[16] = Message(16, 2, "Solve phase {phase}: iteration {it} objective {obj:.8g}")
CATALOG[29] = Message(29, 1, "End of solve: status {status} time {time:.3f}s")
CATALOG[40] = CATALOG["CLP_BARRIER_ITERATION"]


import string as _string


class _SafeFormatter(_string.Formatter):
    """Missing fields render '?'; incompatible format specs degrade to str."""

    def get_value(self, key, args, kwargs):
        if isinstance(key, str):
            return kwargs.get(key, "?")
        return "?"

    def format_field(self, value, spec):
        try:
            return format(value, spec)
        except (ValueError, TypeError):
            return str(value)


_FORMATTER = _SafeFormatter()


class MessageHandler:
    """Log-level filtered message printing; override `print_message` to
    intercept (the reference's unit test does exactly that,
    unitTest.cpp:1567). Messages are addressed by CLP_* name or number."""

    def __init__(self, log_level: int = 1, stream=None):
        self.log_level = log_level
        self.stream = stream or sys.stdout
        self.messages_seen: list = []

    def message(self, number, **kw) -> None:
        msg = CATALOG.get(number)
        if msg is None:
            return
        self.messages_seen.append(number)
        if msg.level <= self.log_level:
            text = _FORMATTER.vformat(msg.text, (), kw)
            self.print_message(msg, text)

    def print_message(self, msg: Message, text: str) -> None:
        print(text, file=self.stream)


class CallbackHandler(MessageHandler):
    """Wraps a callable(message_number, text) — backs the C API's
    Clp_registerCallBack (reference: Clp_C_Interface.h clp_callback).
    Sees every message regardless of log level, like the reference's
    callback path."""

    def __init__(self, fn):
        super().__init__(log_level=63)
        self.fn = fn

    def print_message(self, msg, text):
        self.fn(int(msg.number), text)


def get_handler(model=None, options=None):
    """Resolve the active MessageHandler for a solver phase.

    The model-attached handler wins (passMessageHandler parity — the unit
    tests intercept through it at any log level); otherwise a fresh
    printing handler is created when the log level asks for messages.
    """
    h = getattr(model, "message_handler", None)
    if h is not None:
        return h
    ll = max(
        int(getattr(options, "log_level", 0) or 0),
        int(getattr(model, "log_level", 1) or 1) if model is not None else 1,
    )
    if ll >= 2:
        return MessageHandler(log_level=ll)
    return None


class ProgressDisplay:
    """Tabular progress UI (ClpOutput-style).

    Deterministic mode prints every `every` iterations without timestamps so
    output is diffable (reference: `-progress 0 -progressIter N`,
    doc/clp-output-comparison.md).
    """

    HEADER = f"{'phase':>8} {'iter':>8} {'objective':>16} {'p.inf':>10} {'d.inf':>10} {'time':>8}"

    def __init__(self, stream=None, deterministic: bool = False, every: int = 100):
        self.stream = stream or sys.stdout
        self.deterministic = deterministic
        self.every = max(1, every)
        self._t0 = time.time()
        self._printed_header = False
        self._last = -1

    def line(self, phase: str, iteration: int, objective: float,
             pinf: float = 0.0, dinf: float = 0.0) -> None:
        # calls arrive at chunk grain (arbitrary iteration numbers): print
        # whenever the counter crosses the next multiple of `every`
        if self._last >= 0 and iteration < self._last + self.every:
            return
        self._last = iteration
        if not self._printed_header:
            print(self.HEADER, file=self.stream)
            self._printed_header = True
        t = 0.0 if self.deterministic else time.time() - self._t0
        print(
            f"{phase:>8} {iteration:>8d} {objective:>16.8g} {pinf:>10.3g} "
            f"{dinf:>10.3g} {t:>8.2f}",
            file=self.stream,
        )
