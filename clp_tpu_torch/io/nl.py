"""AMPL .nl reader/writer (linear problems) + AMPL .sol writer.

The reference switches to the AMPL driver protocol on `clp stub -AMPL`
(ClpMain.cpp:292-303 clpReadAmpl -> readAmplInfo; solution written back
via writeAmplSol). Clp is an LP solver, so only the LINEAR subset of the
.nl format matters: this module parses text-format ('g') .nl files whose
constraint/objective expression bodies are constants, and rejects
nonlinear bodies with a clear error instead of mis-solving.

Format notes (text .nl, "Writing .nl Files", D. Gay, AMPL):
  - 10-line header: 'g' + version ints; then per-line counts of vars/
    cons/objs/ranges/eqns, nonlinear counts, network counts, nonlinear
    variable counts, flags, discrete-variable counts, Jacobian/gradient
    nonzero counts, name lengths, common expressions.
  - segments, one letter each:
      C i        constraint i nonlinear body (linear => 'n0')
      O i s      objective i (s=1 max) body (linear => 'n<const>')
      x n        n initial primal guesses (j v)
      d n        n initial dual guesses (i v)
      r          n_con constraint-body bounds, type-coded
      b          n_var variable bounds, type-coded
      k K        K = n_var-1 cumulative Jacobian column counts
      J i n      n Jacobian entries (j coef) for constraint i
      G i n      n gradient entries (j coef) for objective i
      S k n nm   suffix table (skipped)
  - bound type codes (r and b): 0 l u | 1 u | 2 l | 3 | 4 v | 5 ... .

Binary-format files (first header byte 'b') are rejected — AMPL can
re-emit text with `option nl_comments 0; option auxfiles ''` or `ampl -og`.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..constants import INF


class NLError(ValueError):
    pass


def _resolve_stub(path: str) -> str:
    """AMPL passes a stub (no extension); accept both spellings."""
    if os.path.exists(path):
        return path
    if not path.endswith(".nl") and os.path.exists(path + ".nl"):
        return path + ".nl"
    return path


def read_nl(path: str, model=None):
    """Parse a linear text-format .nl file into `model` (a fresh Model by
    default). Returns the model. Raises NLError on binary format or
    nonlinear bodies."""
    from ..model import Model

    path = _resolve_stub(path)
    with open(path, "rt") as f:
        lines = f.read().splitlines()
    if not lines:
        raise NLError("empty .nl file")
    tag = lines[0].lstrip()[:1]
    if tag == "b":
        raise NLError(
            "binary-format .nl (header 'b'); re-emit text format with "
            "AMPL's -og or option nl_binary 0"
        )
    if tag != "g":
        raise NLError(f".nl header must start with 'g' or 'b', got {lines[0]!r}")

    def ints(line):
        return [int(float(t)) for t in line.split("#")[0].split()]

    hdr = [ints(lines[i]) for i in range(1, 10)]
    n_var, n_con, n_obj = hdr[0][0], hdr[0][1], hdr[0][2]
    nlc, nlo = (hdr[1] + [0, 0])[:2]
    if nlc > 0:
        raise NLError(f"{nlc} nonlinear constraints — only linear .nl is supported")
    # discrete variables (header line 7): nbv binary + niv integer come
    # LAST in the variable order for linear problems
    disc = (hdr[5] + [0] * 5)[:5]
    nbv, niv = disc[0], disc[1]

    pos = 10
    obj_sense = 1  # 1 = minimize
    obj_const = 0.0
    # true inf for absent bounds (round-trips exactly; the engines treat
    # anything >= constants.INF as infinite either way)
    row_lo = np.full(n_con, -np.inf)
    row_up = np.full(n_con, np.inf)
    col_lo = np.zeros(n_var)
    col_up = np.full(n_var, np.inf)
    jac_r, jac_c, jac_v = [], [], []
    grad = np.zeros(n_var)
    x0 = None
    con_const: dict[int, float] = {}  # constant C-bodies shift row bounds

    def read_expr(p):
        """Single-line constant expression 'n<val>'; anything else is
        nonlinear."""
        tok = lines[p].split()
        if not tok or not tok[0].startswith("n"):
            raise NLError(
                f"nonlinear expression body at line {p + 1} "
                f"({lines[p][:40]!r}) — only linear .nl is supported"
            )
        return float(tok[0][1:]), p + 1

    def read_bounds(p, k):
        lo = np.empty(k)
        up = np.empty(k)
        for i in range(k):
            t = lines[p].split()
            code = int(t[0])
            if code == 0:
                lo[i], up[i] = float(t[1]), float(t[2])
            elif code == 1:
                lo[i], up[i] = -np.inf, float(t[1])
            elif code == 2:
                lo[i], up[i] = float(t[1]), np.inf
            elif code == 3:
                lo[i], up[i] = -np.inf, np.inf
            elif code == 4:
                lo[i] = up[i] = float(t[1])
            else:
                raise NLError(
                    f"complementarity bound (code {code}) at line {p + 1} "
                    "is not supported"
                )
            p += 1
        return lo, up, p

    while pos < len(lines):
        line = lines[pos]
        if not line.strip():
            pos += 1
            continue
        seg = line.split("#")[0].split()
        tag = seg[0][0]
        if tag == "C":
            i = int(seg[0][1:]) if len(seg[0]) > 1 else int(seg[1])
            pos += 1
            v, pos = read_expr(pos)
            if v != 0.0:
                con_const[i] = v
        elif tag == "O":
            i = int(seg[0][1:]) if len(seg[0]) > 1 else int(seg[1])
            sense = int(seg[-1])
            pos += 1
            v, pos = read_expr(pos)
            if i == 0:
                obj_sense = -1 if sense == 1 else 1
                obj_const = v
        elif tag == "x":
            k = int(seg[0][1:]) if len(seg[0]) > 1 else int(seg[1])
            pos += 1
            x0 = np.zeros(n_var)
            for _ in range(k):
                t = lines[pos].split()
                x0[int(t[0])] = float(t[1])
                pos += 1
        elif tag == "d":
            k = int(seg[0][1:]) if len(seg[0]) > 1 else int(seg[1])
            pos += 1 + k
        elif tag == "r":
            pos += 1
            row_lo, row_up, pos = read_bounds(pos, n_con)
        elif tag == "b":
            pos += 1
            col_lo, col_up, pos = read_bounds(pos, n_var)
        elif tag == "k":
            k = int(seg[0][1:]) if len(seg[0]) > 1 else int(seg[1])
            pos += 1 + k  # cumulative counts are redundant given J
        elif tag == "J":
            i = int(seg[0][1:]) if len(seg[0]) > 1 else int(seg[1])
            k = int(seg[-1])
            pos += 1
            for _ in range(k):
                t = lines[pos].split()
                jac_r.append(i)
                jac_c.append(int(t[0]))
                jac_v.append(float(t[1]))
                pos += 1
        elif tag == "G":
            i = int(seg[0][1:]) if len(seg[0]) > 1 else int(seg[1])
            k = int(seg[-1])
            pos += 1
            for _ in range(k):
                t = lines[pos].split()
                if i == 0:
                    grad[int(t[0])] += float(t[1])
                pos += 1
        elif tag == "S":
            k = int(seg[2])
            pos += 1 + k  # suffixes: skipped
        elif tag in ("F", "V", "L"):
            raise NLError(
                f"segment '{tag}' (functions/defined vars/logical "
                "constraints) is not supported — linear .nl only"
            )
        else:
            raise NLError(f"unknown .nl segment {line!r} at line {pos + 1}")

    # a constant body v in constraint i means lo <= v + J_i.x <= up
    for i, v in con_const.items():
        if np.isfinite(row_lo[i]):
            row_lo[i] -= v
        if np.isfinite(row_up[i]):
            row_up[i] -= v

    A = sp.csc_matrix(
        (jac_v, (jac_r, jac_c)), shape=(n_con, n_var)
    )
    if model is None:
        model = Model()
    # model.objective holds USER-SENSE coefficients; maximize is carried
    # by optimization_direction = -1 (same convention as the MPS reader)
    model.load_problem(A, col_lo, col_up, grad, row_lo, row_up)
    model.objective_offset = obj_const
    model.optimization_direction = float(obj_sense)
    model.problem_name = os.path.splitext(os.path.basename(path))[0]
    if nbv or niv:
        model.set_integer(np.arange(n_var - nbv - niv, n_var))
    if x0 is not None:
        model._nl_x0 = x0
    return model


def write_nl(model, path: str) -> None:
    """Emit a linear text-format .nl for `model` (round-trip/testing aid;
    AMPL itself generates these)."""
    A = model.matrix.tocsr()
    A.sort_indices()
    m, n = A.shape
    sense = getattr(model, "optimization_direction", 1.0) or 1.0
    c = model.objective  # user-sense coefficients, like the .nl gradient
    const = model.objective_offset
    rl, ru = model.row_lower, model.row_upper
    cl, cu = model.col_lower, model.col_upper
    n_rng = int(np.sum((rl > -INF) & (ru < INF) & (rl != ru)))
    n_eq = int(np.sum(rl == ru))
    nzo = int(np.count_nonzero(c))
    with open(path, "wt") as f:
        f.write(f"g3 1 1 0\t# problem {model.problem_name or 'clp_tpu'}\n")
        f.write(f" {n} {m} 1 {n_rng} {n_eq}\n")
        f.write(" 0 0\n 0 0\n 0 0 0\n 0 0 0 1\n 0 0 0 0 0\n")
        f.write(f" {A.nnz} {nzo}\n 0 0\n 0 0 0 0 0\n")
        for i in range(m):
            f.write(f"C{i}\nn0\n")
        f.write(f"O0 {0 if sense >= 0 else 1}\nn{float(const)!r}\n")
        f.write("r\n")
        for i in range(m):
            lo, up = rl[i], ru[i]
            if lo <= -INF and up >= INF:
                f.write("3\n")
            elif lo == up:
                f.write(f"4 {float(lo)!r}\n")
            elif lo <= -INF:
                f.write(f"1 {float(up)!r}\n")
            elif up >= INF:
                f.write(f"2 {float(lo)!r}\n")
            else:
                f.write(f"0 {float(lo)!r} {float(up)!r}\n")
        f.write("b\n")
        for j in range(n):
            lo, up = cl[j], cu[j]
            if lo <= -INF and up >= INF:
                f.write("3\n")
            elif lo == up:
                f.write(f"4 {float(lo)!r}\n")
            elif lo <= -INF:
                f.write(f"1 {float(up)!r}\n")
            elif up >= INF:
                f.write(f"2 {float(lo)!r}\n")
            else:
                f.write(f"0 {float(lo)!r} {float(up)!r}\n")
        colnnz = np.diff(A.tocsc().indptr)
        f.write(f"k{n - 1}\n")
        cum = 0
        for j in range(n - 1):
            cum += int(colnnz[j])
            f.write(f"{cum}\n")
        for i in range(m):
            s, e = A.indptr[i], A.indptr[i + 1]
            if e > s:
                f.write(f"J{i} {e - s}\n")
                for j, v in zip(A.indices[s:e], A.data[s:e]):
                    f.write(f"{j} {float(v)!r}\n")
        cj = np.flatnonzero(c)
        if cj.size:
            f.write(f"G0 {cj.size}\n")
            for j in cj:
                f.write(f"{j} {float(c[j])!r}\n")


_SOLVE_CODE = {
    # AMPL solve_result_num conventions
    "OPTIMAL": 0,
    "PRIMAL_INFEASIBLE": 200,
    "DUAL_INFEASIBLE": 300,  # unbounded
    "STOPPED": 400,
    "USER_STOPPED": 400,
    "NUMERICAL": 500,
    "ERRORS": 500,
}


def write_sol(stub: str, model, solution, message: Optional[str] = None) -> str:
    """Write the AMPL stub.sol answer-back file (writeAmplSol role)."""
    path = stub[:-3] + ".sol" if stub.endswith(".nl") else stub + ".sol"
    status_name = solution.status.name if solution is not None else "ERRORS"
    code = _SOLVE_CODE.get(status_name, 500)
    msg = message or f"clp_tpu: {status_name.lower()}"
    if solution is not None and solution.objective_value is not None:
        msg += f", objective {solution.objective_value:.12g}"
    m, n = model.num_rows, model.num_cols
    y = (solution.duals if solution is not None and solution.duals is not None
         else np.zeros(0))
    x = (solution.primal if solution is not None and solution.primal is not None
         else np.zeros(0))
    with open(path, "wt") as f:
        f.write(msg + "\n\n")
        f.write("Options\n3\n0\n1\n0\n")
        f.write(f"{m} {len(y)}\n{n} {len(x)}\n")
        for v in y:
            f.write(f"{float(v)!r}\n")
        for v in x:
            f.write(f"{float(v)!r}\n")
        f.write(f"objno 0 {code}\n")
    return path
