"""Command-line interface — the `clp` binary equivalent.

Follows the reference CLI's shape (ClpMain.cpp:254-310, ClpSolver.cpp):
a queue of parameters/actions processed in order, with an interactive REPL
when invoked without arguments. Parameter names keep Clp's spellings where
sensible (-dualsimplex, -primalsimplex, -barrier, -presolve, -maxIts, ...).

    python -m clp_tpu_torch model.mps -dualsimplex -printsol
    python -m clp_tpu_torch -import model.mps.gz -barrier -basisO out.bas
    python -m clp_tpu_torch -unitTest

Every solve runs on `SolveOptions.device`, whose default is
`device.default_device()`: the card, or the CPU under CLPTPU_PLATFORM=cpu.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np

from .constants import ProblemStatus, ScalingMode, SolveMethod
from .model import Model
from .options import SolveOptions


HELP = """clp_tpu_torch — LP/QP solver on one NVIDIA card (capabilities of coin-or/Clp)

usage: python -m clp_tpu_torch [file.mps[.gz]] [actions/options...]

actions:
  -dualsimplex | -duals       solve with dual simplex
  -primalsimplex | -primals   solve with primal simplex
  -barrier                    interior point + simplex crossover
  -barriernocross             interior point, no crossover
  -pdlp                       first-order PDHG solver
  -solve | -either            automatic method choice
  -import FILE                read MPS (gzip ok); .lp read as LP format
  -export FILE                write model as MPS (.lp -> LP format)
  -basisI FILE                read starting basis
  -basisO FILE                write final basis
  -printsol                   print nonzero primal solution values
  -solution FILE              write solution to file ('-' = stdout, all rows)
  -unitTest                   run built-in smoke tests
  -netlib DIR                 solve all MPS files in DIR, check golden objs
options:
  -maximize / -minimize       objective sense
  -presolve on|off            (default on)
  -scaling off|equil|geom|auto (default auto)
  -maxIts N                   iteration limit
  -sec N                      time limit (seconds)
  -primalT TOL / -dualT TOL   feasibility tolerances
  -log N                      verbosity 0-4
  -batch FILES...             solve many same-shape MPS files batched
exit / quit / help in interactive mode.
"""


def _fmt_status(model: Model) -> str:
    sol = model.solution
    s = sol.status
    if s == ProblemStatus.OPTIMAL:
        return (
            f"Optimal - objective value {sol.objective_value:.10g}\n"
            f"Optimal objective {sol.objective_value:.12g} - {sol.iterations} "
            f"iterations time {sol.solve_time:.3f}"
        )
    if s == ProblemStatus.PRIMAL_INFEASIBLE:
        return "Primal infeasible"
    if s == ProblemStatus.DUAL_INFEASIBLE:
        return "Dual infeasible (unbounded)"
    if s == ProblemStatus.STOPPED:
        return f"Stopped on limits - objective value {sol.objective_value:.10g}"
    return f"Finished with status {s.name}"


class CLI:
    def __init__(self):
        self.model = Model()
        self.options = SolveOptions()
        self.log_level = 1
        self.have_model = False
        # parameter-system state (see params.py)
        self.compat_params: dict = {}
        self.print_mask = ""
        self.output_format = 2
        self.errors_allowed = False
        self.progress_every = 100
        self.progress_deterministic = False
        self.message_prefixes = False
        self.directory = "."
        self.dir_sample = ""
        self.dir_netlib = ""
        # default filenames set by the FILE parameter group (-basisFile
        # etc., reference FIRSTFILEPARAM..LASTFILEPARAM): used by the
        # matching action when no filename follows it
        self.file_defaults: dict = {}

    def _path(self, p: str, data_dir: str = "") -> str:
        import os

        if os.path.isabs(p) or os.path.exists(p):
            return p
        for base in (data_dir, self.directory):
            if base and os.path.exists(os.path.join(base, p)):
                return os.path.join(base, p)
        return p

    def log(self, msg, level=1):
        if self.log_level >= level:
            print(msg)

    def do_import(self, path: str) -> int:
        t0 = time.time()
        from .io.nl import NLError, _resolve_stub, read_nl

        resolved = _resolve_stub(path)
        if resolved.endswith(".nl"):
            # AMPL stub (ClpMain.cpp:292-303 clpReadAmpl role): linear
            # text-format .nl; remember the stub for -AMPL's .sol
            # answer-back
            try:
                read_nl(resolved, self.model)
                self.ampl_stub = resolved
                rc = 0
            except (NLError, OSError) as e:
                print(f"** .nl import failed: {e}")
                rc = 1
        elif path.endswith(".lp"):
            rc = self.model.read_lp(path)
        else:
            rc = self.model.read_mps(path)
        if rc == 0:
            self.have_model = True
            self.log(
                f"Problem {self.model.problem_name or path} has {self.model.num_rows} rows, "
                f"{self.model.num_cols} columns and {self.model.num_elements} elements"
            )
            self.log(f"Model was imported from {path} in {time.time()-t0:.2f} seconds", 2)
        else:
            print(f"Unable to import model from {path}")
        return rc

    def do_solve(self, method: SolveMethod) -> None:
        if not self.have_model:
            print("** no model - import a file first")
            return
        self.options.method = method
        sol = self.model.initial_solve(self.options)
        self._did_solve = True
        print(_fmt_status(self.model))

    def print_solution(self, out=None, all_rows=False):
        sol = self.model.solution
        if sol is None or sol.primal is None:
            print("** no solution available")
            return
        f = out or sys.stdout
        cn = self.model.col_names or [f"C{j}" for j in range(self.model.num_cols)]
        mask = self.print_mask
        if mask:
            import fnmatch
        print(f"status {sol.status.name}", file=f)
        print(f"objective {sol.objective_value:.12g}", file=f)
        for j, v in enumerate(sol.primal):
            if mask and not fnmatch.fnmatch(cn[j], mask):
                continue
            if all_rows or abs(v) > 1e-8:
                dj = sol.reduced_costs[j] if sol.reduced_costs is not None else 0.0
                if self.output_format == 1:
                    print(f"{cn[j]} {v:.12g}", file=f)
                else:
                    print(f"{j:7d} {cn[j]:<16} {v:15.8g} {dj:15.8g}", file=f)

    def write_solution_file(self, path: str, binary: bool = False) -> None:
        sol = self.model.solution
        if sol is None or sol.primal is None:
            print("** no solution available")
            return
        if binary:
            np.savez(
                path,
                status=int(sol.status),
                objective=sol.objective_value,
                primal=sol.primal,
                duals=sol.duals,
                reduced_costs=sol.reduced_costs,
                row_activity=sol.row_activity,
            )
        else:
            with open(path, "w") as f:
                self.print_solution(out=f, all_rows=True)
        self.log(f"Solution written to {path}", 2)

    def write_gmpl_solution(self, path: str) -> None:
        """Write the solution in GMPL/MathProg data format (writeGmplSol
        parity, CbcOrClpParam WRITEGMPLSOL): a `param` block per variable
        so a .mod file can re-read the solution as data."""
        sol = self.model.solution
        if sol is None or sol.primal is None:
            print("** no solution available")
            return
        cn = self.model.col_names or [f"C{j}" for j in range(self.model.num_cols)]
        with open(path, "w") as f:
            print(f"/* status {sol.status.name} */", file=f)
            print(f"/* objective {sol.objective_value:.12g} */", file=f)
            print("param solution :=", file=f)
            for j, v in enumerate(sol.primal):
                print(f"  '{cn[j]}' {v:.12g}", file=f)
            print(";", file=f)
            print("end;", file=f)
        self.log(f"GMPL solution written to {path}", 2)

    def read_solution_file(self, path: str) -> int:
        """Read a text solution file written by -writeSol / -solution."""
        from .model import Solution
        from .constants import ProblemStatus as PS

        try:
            vals = np.zeros(self.model.num_cols)
            status = PS.UNKNOWN
            obj = 0.0
            name_to_j = {
                n: j for j, n in enumerate(self.model.col_names or [])
            }
            with open(path) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    if parts[0] == "status":
                        status = PS[parts[1]] if parts[1] in PS.__members__ else PS.UNKNOWN
                    elif parts[0] == "objective":
                        obj = float(parts[1])
                    elif len(parts) >= 3 and parts[0].lstrip("-").isdigit():
                        j = int(parts[0])
                        if 0 <= j < vals.size:
                            vals[j] = float(parts[2])
                    elif len(parts) == 2 and parts[0] in name_to_j:
                        vals[name_to_j[parts[0]]] = float(parts[1])
            self.model.solution = Solution(
                status=status, objective_value=obj, primal=vals,
                row_activity=self.model.matrix @ vals,
            )
            return 0
        except OSError as e:
            print(f"** cannot read solution file: {e}")
            return 1

    def statistics(self) -> None:
        """Problem-shape dump (reference: BENCHMARK_STATS, ClpSolve.cpp:1085)."""
        m = self.model
        if not self.have_model:
            print("** no model - import a file first")
            return
        A = m.matrix
        nnz = m.num_elements
        absd = np.abs(A.data) if nnz else np.array([1.0])
        counts_r = np.diff(A.tocsr().indptr) if m.num_rows else np.array([0])
        counts_c = np.diff(A.tocsc().indptr) if m.num_cols else np.array([0])
        eq = int(np.sum(m.row_lower == m.row_upper))
        pm1 = int(np.sum((np.abs(absd) == 1.0))) if nnz else 0
        print(f"Statistics for {m.problem_name or 'model'}:")
        print(f"  {m.num_rows} rows ({eq} equalities), {m.num_cols} columns, {nnz} elements")
        print(f"  element range [{absd.min():.6g}, {absd.max():.6g}], +-1 elements {pm1}")
        print(f"  row counts min/median/max {counts_r.min()}/{int(np.median(counts_r))}/{counts_r.max()}")
        print(f"  column counts min/median/max {counts_c.min()}/{int(np.median(counts_c))}/{counts_c.max()}")
        fin_cl = np.sum(m.col_lower > -1e29)
        fin_cu = np.sum(m.col_upper < 1e29)
        print(f"  finite column bounds: {fin_cl} lower, {fin_cu} upper")
        st = m.detect_structure() if hasattr(m, "detect_structure") else {}
        if st:
            print(f"  structure: {st}")

    def do_parametrics(self, path: str) -> int:
        """File-driven parametrics (ClpSimplexOther::parametrics(dataFile),
        ClpSimplexOther.cpp:2797). Format (comma separated, case-insensitive):

            ROWS,startTheta,endTheta[,interval[,detail]]
            name,lower,upper          <- headings line
            <rowname>,<dlo>,<dup>     <- per-row bound moves
            COLUMNS
            name,lower,upper,objective
            <colname>,<dlo>,<dup>,<dobj>
        """
        if not self.have_model:
            print("** no model - import a file first")
            return 1
        m = self.model
        try:
            with open(self._path(path)) as f:
                lines = [ln.strip() for ln in f if ln.strip()]
        except OSError as e:
            print(f"** cannot open parametrics file: {e}")
            return 1
        if not lines or not lines[0].lower().replace(" ", "").startswith("rows,"):
            print(f"Odd first line on parametrics file {path}")
            return 1
        head = lines[0].replace(" ", "").split(",")
        start_theta = float(head[1]) if len(head) > 1 else 0.0
        end_theta = float(head[2]) if len(head) > 2 else 1.0
        if start_theta < 0 or start_theta > end_theta:
            print(f"Odd first line on parametrics file {path}")
            return 1
        rn = {n: i for i, n in enumerate(m.row_names or [])}
        cn = {n: j for j, n in enumerate(m.col_names or [])}
        d_rl = np.zeros(m.num_rows)
        d_ru = np.zeros(m.num_rows)
        d_cl = np.zeros(m.num_cols)
        d_cu = np.zeros(m.num_cols)
        d_obj = np.zeros(m.num_cols)
        section = "rows"
        headings: list[str] = []
        for ln in lines[1:]:
            parts = [p.strip() for p in ln.split(",")]
            key = parts[0].lower()
            if key.startswith("column"):
                section = "columns"
                headings = []
                continue
            if key in ("name", "number"):
                headings = [p.lower() for p in parts]
                continue
            if not headings:
                headings = (["name", "lower", "upper"] if section == "rows"
                            else ["name", "lower", "upper", "objective"])
            rec = dict(zip(headings, parts))
            name = rec.get("name") or rec.get("number")
            try:
                idx = int(name) if name and name.lstrip("-").isdigit() else (
                    rn.get(name, -1) if section == "rows" else cn.get(name, -1)
                )
            except ValueError:
                idx = -1
            if idx < 0:
                print(f"** unknown {section[:-1]} {name!r} in parametrics file")
                continue
            lo = float(rec.get("lower", 0) or 0)
            up = float(rec.get("upper", 0) or 0)
            if section == "rows":
                d_rl[idx] = lo
                d_ru[idx] = up
            else:
                d_cl[idx] = lo
                d_cu[idx] = up
                d_obj[idx] = float(rec.get("objective", 0) or 0)
        from .analysis import parametrics as run_parametrics

        if m.solution is None or m.solution.primal is None:
            self.do_solve(SolveMethod.DUAL_SIMPLEX)
        pts = run_parametrics(
            m, end_theta, device=self.options.device,
            dc=d_obj if d_obj.any() else None,
            d_row_lower=d_rl if d_rl.any() else None,
            d_row_upper=d_ru if d_ru.any() else None,
            d_col_lower=d_cl if d_cl.any() else None,
            d_col_upper=d_cu if d_cu.any() else None,
        )
        for theta, obj in pts:
            if theta >= start_theta - 1e-12:
                print(f"theta {theta:.6g} objective {obj:.10g}")
        return 0

    def guess(self) -> None:
        """Suggest settings from shape (reference: ClpSolver GUESS action)."""
        m = self.model
        if not self.have_model:
            print("** no model - import a file first")
            return
        r, c = m.num_rows, m.num_cols
        if c > 4 * r:
            print("Many more columns than rows - suggest -sprintSolve or -idiotCrash 50 -primalsimplex")
        elif r > 4 * c:
            print("Many more rows than columns - suggest -dualize 1 -dualsimplex")
        elif m.num_elements > 0.2 * r * c:
            print("Dense problem - suggest -barrier")
        else:
            print("Suggest -dualsimplex (default)")

    def tighten(self) -> None:
        """Bound tightening from row activity ranges (tightenIntegerBounds
        analogue, ClpSimplexOther.cpp:2396, applied to all columns)."""
        m = self.model
        if not self.have_model:
            print("** no model - import a file first")
            return
        A = m.matrix.tocsr()
        INFB = 1e29
        cl = np.where(m.col_lower <= -INFB, -np.inf, m.col_lower)
        cu = np.where(m.col_upper >= INFB, np.inf, m.col_upper)
        tightened = 0
        for i in range(m.num_rows):
            s, e = A.indptr[i], A.indptr[i + 1]
            cols = A.indices[s:e]
            coefs = A.data[s:e]
            pos = coefs > 0
            with np.errstate(invalid="ignore"):
                min_act = np.sum(np.where(pos, coefs * cl[cols], coefs * cu[cols]))
                max_act = np.sum(np.where(pos, coefs * cu[cols], coefs * cl[cols]))
            ru = m.row_upper[i] if m.row_upper[i] < INFB else np.inf
            rl = m.row_lower[i] if m.row_lower[i] > -INFB else -np.inf
            for t in range(cols.size):
                j, a = cols[t], coefs[t]
                rest_min = min_act - (a * (cl[j] if a > 0 else cu[j]))
                rest_max = max_act - (a * (cu[j] if a > 0 else cl[j]))
                if np.isfinite(ru) and np.isfinite(rest_min):
                    lim = (ru - rest_min) / a
                    if a > 0 and lim < cu[j] - 1e-9:
                        cu[j] = lim
                        tightened += 1
                    elif a < 0 and lim > cl[j] + 1e-9:
                        cl[j] = lim
                        tightened += 1
                if np.isfinite(rl) and np.isfinite(rest_max):
                    lim = (rl - rest_max) / a
                    if a > 0 and lim > cl[j] + 1e-9:
                        cl[j] = lim
                        tightened += 1
                    elif a < 0 and lim < cu[j] - 1e-9:
                        cu[j] = lim
                        tightened += 1
        if m.integer_mask is not None:
            ints = m.integer_mask.astype(bool)
            cl[ints] = np.ceil(cl[ints] - 1e-9)
            cu[ints] = np.floor(cu[ints] + 1e-9)
        m.col_lower = np.where(np.isfinite(cl), cl, -1e30)
        m.col_upper = np.where(np.isfinite(cu), cu, 1e30)
        print(f"Tightened {tightened} bounds")

    def _take_file(self, args: list[str], i: int, key: str):
        """Filename for a file action: next token if present and not a
        parameter, else the default set by the matching FILE parameter
        (-basisFile etc., reference ClpParam FIRSTFILEPARAM group)."""
        if i + 1 < len(args) and not args[i + 1].startswith("-"):
            return args[i + 1], i + 1
        d = self.file_defaults.get(key, "")
        if not d:
            raise IndexError(f"missing filename for {args[i]}")
        return d, i

    def run_args(self, args: list[str]) -> int:
        try:
            rc = self._run_args(args)
        except IndexError:
            print("** missing value for the last parameter (try -help)")
            return 1
        except ValueError as e:
            print(f"** bad parameter value: {e}")
            return 1
        if getattr(self, "ampl_mode", False) and getattr(self, "ampl_stub", None):
            if not getattr(self, "_did_solve", False) and self.have_model:
                self.do_solve(SolveMethod.AUTOMATIC)
            from .io.nl import write_sol

            out = write_sol(self.ampl_stub, self.model, self.model.solution)
            self.log(f"AMPL solution written to {out}", 2)
        return rc

    def _run_args(self, args: list[str]) -> int:
        i = 0
        rc = 0
        while i < len(args):
            a = args[i]
            al = a.lstrip("-").lower()
            # bare keywords work in the REPL like the reference CLI: only
            # treat a dashless token as a filename if it isn't a command
            if (not a.startswith("-") and not self.have_model
                    and al not in ("help", "?", "???", "params", "exit", "quit",
                                   "end", "stop", "unittest")):
                rc = self.do_import(a)
                i += 1
                continue
            if al in ("dualsimplex", "duals"):
                self.do_solve(SolveMethod.DUAL_SIMPLEX)
            elif al in ("primalsimplex", "primals"):
                self.do_solve(SolveMethod.PRIMAL_SIMPLEX)
            elif al == "barrier":
                self.do_solve(SolveMethod.BARRIER)
            elif al in ("barriernocross", "barriernocrossover"):
                self.do_solve(SolveMethod.BARRIER_NO_CROSS)
            elif al == "pdlp":
                self.do_solve(SolveMethod.PDLP)
            elif al in ("solve", "either", "auto"):
                self.do_solve(SolveMethod.AUTOMATIC)
            elif al == "import":
                fn, i = self._take_file(args, i, "import")
                rc = self.do_import(self._path(fn, self.dir_sample))
                if rc != 0 and not self.errors_allowed:
                    return rc
            elif al == "export":
                fn, i = self._take_file(args, i, "export")
                if fn.endswith(".lp"):
                    from .io.lp_format import write_lp

                    write_lp(self.model, fn)
                else:
                    self.model.write_mps(fn)
                self.log(f"Model written to {fn}")
            elif al in ("basisi", "basisin"):
                fn, i = self._take_file(args, i, "basis")
                from .io.basis import read_basis

                read_basis(self.model, fn)
            elif al in ("basiso", "basisout"):
                fn, i = self._take_file(args, i, "basis")
                from .io.basis import write_basis

                write_basis(self.model, fn)
            elif al == "printsol":
                self.print_solution()
            elif al == "solution":
                fn, i = self._take_file(args, i, "solution")
                if fn == "-":
                    self.print_solution(all_rows=True)
                else:
                    with open(fn, "w") as f:
                        self.print_solution(out=f, all_rows=True)
            elif al == "maximize":
                self.model.set_maximize()
            elif al == "minimize":
                self.model.set_minimize()
            elif al == "presolve":
                i += 1
                self.options.presolve.enabled = args[i].lower() != "off"
            elif al == "scaling":
                i += 1
                v = args[i].lower()
                self.options.scaling = {
                    "off": ScalingMode.OFF,
                    "0": ScalingMode.OFF,
                    "equil": ScalingMode.EQUILIBRIUM,
                    "1": ScalingMode.EQUILIBRIUM,
                    "geom": ScalingMode.GEOMETRIC,
                    "2": ScalingMode.GEOMETRIC,
                    "auto": ScalingMode.AUTO,
                    "3": ScalingMode.AUTO,
                }.get(v, ScalingMode.AUTO)
            elif al in ("maxits", "maxiterations"):
                i += 1
                self.options.max_iterations = int(args[i])
            elif al in ("sec", "seconds", "maxseconds"):
                i += 1
                self.options.max_seconds = float(args[i])
            elif al in ("primalt", "primaltolerance"):
                i += 1
                self.model.primal_tolerance = float(args[i])
            elif al in ("dualt", "dualtolerance"):
                i += 1
                self.model.dual_tolerance = float(args[i])
            elif al in ("log", "loglevel"):
                i += 1
                self.log_level = int(args[i])
                self.options.log_level = self.log_level
            elif al in ("sprintsolve", "sifting"):
                self.do_solve(SolveMethod.SPRINT)
            elif al == "allslack":
                self.model.solution = None
                self.log("Basis reset to all-slack")
            elif al == "reverse":
                self.model.optimization_direction = -(
                    self.model.optimization_direction or 1.0
                )
                self.log("Objective direction reversed")
            elif al == "reallyscale":
                from .scaling import compute_scaling, scale_model_arrays
                from .constants import ScalingMode as _SM

                mode = self.options.scaling
                if mode == _SM.OFF:
                    mode = _SM.EQUILIBRIUM
                factors = compute_scaling(self.model.matrix.tocsc(), mode)
                scale_model_arrays(self.model, factors)
                self.log("Model scaled in place")
            elif al == "tighten":
                self.tighten()
            elif al == "outduprows":
                from .options import PresolveOptions
                from .presolve import _duplicate_rows

                nr = self.model.num_rows
                _duplicate_rows(self.model, [], 1e-10)
                print(f"Dropped {nr - self.model.num_rows} duplicate rows")
            elif al == "statistics":
                self.statistics()
            elif al == "guess":
                self.guess()
            elif al in ("network", "plusminus"):
                st = self.model.detect_structure() if self.have_model else {}
                print(f"Structure detection (automatic at solve time): {st}")
            elif al == "parametrics":
                fn, i = self._take_file(args, i, "parametrics")
                rc = self.do_parametrics(fn)
            elif al in ("readmodel", "restoremodel"):
                fn, i = self._take_file(args, i, "model")
                rc = self.model.restore_model(self._path(fn))
                self.have_model = rc == 0 and self.model.num_cols > 0
            elif al in ("writemodel", "savemodel"):
                fn, i = self._take_file(args, i, "model")
                rc = self.model.save_model(fn)
            elif al == "readsol":
                fn, i = self._take_file(args, i, "solution")
                rc = self.read_solution_file(self._path(fn))
            elif al == "writesol":
                fn, i = self._take_file(args, i, "solution")
                self.write_solution_file(fn)
            elif al == "writesolbinary":
                fn, i = self._take_file(args, i, "solution_binary")
                self.write_solution_file(fn, binary=True)
            elif al in ("genpy", "cppgenerate", "generatepython"):
                i += 1
                self.model.generate_python(args[i])
                self.log(f"Python model script written to {args[i]}")
            elif al == "environment":
                import os as _os

                env = _os.environ.get("CLP_ENVIRONMENT", "")
                if env:
                    rc = self.run_args(env.split())
            elif al == "stdin":
                rc = self.repl()
            elif al == "printversion":
                from . import __version__

                print(f"clp_tpu_torch {__version__}")
            elif al == "unittest":
                rc = self.unit_test()
            elif al in ("netlib", "netlibd", "netlibdual", "netlibp",
                        "netlibprimal", "netlibb", "netlibbarrier", "netlibtune"):
                i += 1
                from .netlib import run_netlib

                method = {
                    "netlibp": SolveMethod.PRIMAL_SIMPLEX,
                    "netlibprimal": SolveMethod.PRIMAL_SIMPLEX,
                    "netlibb": SolveMethod.BARRIER,
                    "netlibbarrier": SolveMethod.BARRIER,
                }.get(al, SolveMethod.DUAL_SIMPLEX)
                self.options.method = method
                rc = run_netlib(self._path(args[i], self.dir_netlib), self.options)
            elif al == "batch":
                files = args[i + 1 :]
                i = len(args)
                rc = self.do_batch(files)
            elif al == "writegmplsol":
                fn, i = self._take_file(args, i, "gmpl_sol")
                self.write_gmpl_solution(fn)
            elif al == "ampl":
                # AMPL driver protocol (ClpMain.cpp:292-303): the stub's
                # .nl was (or will be) imported; on exit, solve if nothing
                # solved yet and write <stub>.sol (run_args finalizer)
                self.ampl_mode = True
                self.log("AMPL mode: will write <stub>.sol on exit", 2)
            elif al in ("clearcuts", "userclp"):
                self.log(f"{al}: accepted (no-op by design here; see -params)")
            elif al in ("help", "?", "generalquery"):
                print(HELP)
            elif al in ("???", "fullgeneralquery"):
                from .params import help_text

                print(HELP)
                print(help_text())
            elif al == "params":
                from .params import help_text

                print(help_text())
            elif al in ("exit", "quit", "end", "stop"):
                return rc
            else:
                # typed parameter registry with Clp-style prefix matching
                from .params import apply as apply_param, lookup

                p = lookup(al)
                if p is not None and p.setter is not None:
                    i += 1
                    if i >= len(args):
                        print(f"** missing value for {a}")
                        return 1
                    try:
                        apply_param(self, al, args[i])
                    except (TypeError, ValueError) as e:
                        print(f"** bad value for {a}: {e}")
                        return 1
                else:
                    print(f"Unknown parameter {a} (try -help or -params)")
            i += 1
        return rc

    def do_batch(self, files: list[str]) -> int:
        from .solve import solve_batch

        models = []
        for p in files:
            m = Model()
            if m.read_mps(p) != 0:
                print(f"cannot read {p}")
                return 1
            models.append(m)
        t0 = time.time()
        sols = solve_batch(models, self.options)
        dt = time.time() - t0
        for p, s in zip(files, sols):
            print(f"{p}: {s.status.name} objective {s.objective_value:.10g}")
        print(f"Batch of {len(models)} solved in {dt:.3f}s ({len(models)/dt:.1f}/s)")
        return 0

    def unit_test(self) -> int:
        """Built-in smoke test (reference: clp -unitTest, unitTest.cpp:286)."""
        from .utils.generators import random_lp, infeasible_lp, nqueens_lp
        from .validate import check_kkt

        dev = self.options.device
        failures = 0
        for seed in range(3):
            m = random_lp(8, 12, seed=seed)
            m.dual(device=dev)
            if not (m.is_proven_optimal() and check_kkt(m).ok):
                failures += 1
                print(f"unitTest FAILED: random_lp seed {seed} dual")
            m2 = random_lp(8, 12, seed=seed)
            m2.barrier(crossover=False, device=dev)
            if not (m2.is_proven_optimal() and check_kkt(m2).ok):
                failures += 1
                print(f"unitTest FAILED: random_lp seed {seed} barrier")
        mi = infeasible_lp()
        mi.dual(device=dev)
        if not mi.is_proven_primal_infeasible():
            failures += 1
            print("unitTest FAILED: infeasible detection")
        mq = nqueens_lp(4)
        mq.primal(device=dev)
        if not (mq.is_proven_optimal() and abs(mq.objective_value() - 4.0) < 1e-6):
            failures += 1
            print("unitTest FAILED: nqueens primal")
        print(f"unitTest: {'OK' if failures == 0 else f'{failures} FAILURES'}")
        return failures

    def repl(self) -> int:
        print("clp_tpu_torch — type 'help' for commands, 'quit' to exit")
        rc = 0
        while True:
            try:
                line = input("Clp:").strip()
            except EOFError:
                break
            if not line:
                continue
            if line.lower() in ("quit", "exit", "end", "stop"):
                break
            rc = self.run_args(line.split())
        return rc


def main(argv: Optional[list[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    cli = CLI()
    if not argv:
        return cli.repl()
    return cli.run_args(argv)


if __name__ == "__main__":
    sys.exit(main())
