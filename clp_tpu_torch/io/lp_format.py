"""CPLEX-style LP format reader/writer (subset).

Capability parity with CoinLpIO as used by the reference
(ClpSimplex.hpp readLp/writeLp).  Supports: Minimize/Maximize objective
(with constant), Subject To with <=, >=, =, and range syntax `lhs <= expr <=
rhs`, Bounds (including `free`, `-inf`, `+inf`), General/Integer/Binary
sections, End.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..constants import INF

_TOKEN = re.compile(
    r"""(?x)
    (?P<num>[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z!"#$%&()/,;?@_'`{}|~.][A-Za-z0-9!"#$%&()/,;?@_'`{}|~.]*)
  | (?P<op><=|>=|=<|=>|=|\+|-|<|>)
  | (?P<colon>:)
    """
)

_SECTION = re.compile(
    r"(?i)^\s*(minimize|minimise|min|maximize|maximise|max|subject\s+to|such\s+that|"
    r"s\.?t\.?|st|bounds?|generals?|gen|integers?|int|binar(?:y|ies)|bin|end|free)\s*$"
)


def _tokenize(text: str):
    # strip comments
    text = re.sub(r"\\[^\n]*", "", text)
    lines = text.split("\n")
    out = []
    for ln in lines:
        s = ln.strip()
        if not s:
            continue
        msec = _SECTION.match(s)
        if msec:
            out.append(("SECTION", msec.group(1).lower()))
            continue
        for mo in _TOKEN.finditer(s):
            if mo.lastgroup == "num":
                out.append(("NUM", float(mo.group())))
            elif mo.lastgroup == "name":
                nm = mo.group()
                if nm.lower() in ("inf", "infinity"):
                    out.append(("NUM", INF))
                else:
                    out.append(("NAME", nm))
            elif mo.lastgroup == "op":
                op = mo.group()
                op = {"=<": "<=", "=>": ">=", "<": "<=", ">": ">="}.get(op, op)
                out.append(("OP", op))
            else:
                out.append(("COLON", ":"))
    return out


def read_lp(filename: str, into=None):
    from ..model import Model

    model = into if into is not None else Model()
    with open(filename) as f:
        toks = _tokenize(f.read())

    col_index: dict[str, int] = {}
    col_names: list[str] = []

    def col(nm: str) -> int:
        if nm not in col_index:
            col_index[nm] = len(col_names)
            col_names.append(nm)
        return col_index[nm]

    maximize = False
    obj: dict[int, float] = {}
    obj_offset = 0.0
    rows = []  # (name, dict coeffs, lo, up)
    bounds: dict[int, list] = {}
    integers: set[int] = set()

    i = 0
    section = None
    pending_label: Optional[str] = None

    def parse_expr(i):
        """Parse a linear expression; returns (coeffs, const, i)."""
        coeffs: dict[int, float] = {}
        const = 0.0
        sign = 1.0
        coef: Optional[float] = None
        while i < len(toks):
            t, v = toks[i]
            if t == "SECTION" or (t == "OP" and v in ("<=", ">=", "=")):
                break
            if t == "OP" and v == "+":
                if coef is not None:
                    const += sign * coef
                    coef = None
                sign = 1.0
            elif t == "OP" and v == "-":
                if coef is not None:
                    const += sign * coef
                    coef = None
                sign = -1.0
            elif t == "NUM":
                coef = v if coef is None else coef * v
            elif t == "NAME":
                # a "name:" label starts a NEW constraint — stop here
                if i + 1 < len(toks) and toks[i + 1][0] == "COLON":
                    break
                j = col(v)
                c = sign * (1.0 if coef is None else coef)
                coeffs[j] = coeffs.get(j, 0.0) + c
                coef = None
                sign = 1.0
            i += 1
        if coef is not None:
            const += sign * coef
        return coeffs, const, i

    while i < len(toks):
        t, v = toks[i]
        if t == "SECTION":
            if v in ("minimize", "minimise", "min"):
                section = "obj"
                maximize = False
            elif v in ("maximize", "maximise", "max"):
                section = "obj"
                maximize = True
            elif v in ("subject to", "such that", "s.t.", "st") or v.startswith("s"):
                # careful: 'st' etc. — the regex groups normalize spacing
                if v.replace(" ", "") in ("subjectto", "suchthat", "s.t.", "st"):
                    section = "cons"
                elif v in ("bounds", "bound"):
                    section = "bounds"
                else:
                    section = "cons"
            if v in ("bounds", "bound"):
                section = "bounds"
            elif v in ("general", "generals", "gen", "integer", "integers", "int"):
                section = "int"
            elif v in ("binary", "binaries", "bin"):
                section = "bin"
            elif v == "free":
                # 'free' can be a Bounds keyword handled inline; as a section
                # header it marks free variables (rare) — treat like bounds.
                section = section or "bounds"
                i += 1
                continue
            elif v == "end":
                break
            i += 1
            continue
        if section == "obj":
            if t == "NAME" and i + 1 < len(toks) and toks[i + 1][0] == "COLON":
                i += 2
                continue
            coeffs, const, i = parse_expr(i)
            for j, c in coeffs.items():
                obj[j] = obj.get(j, 0.0) + c
            obj_offset += const
            pending_label = None
            continue
        if section == "cons":
            # optional label
            if t == "NAME" and i + 1 < len(toks) and toks[i + 1][0] == "COLON":
                pending_label = v
                i += 2
                continue
            coeffs, const, i = parse_expr(i)
            label = pending_label
            pending_label = None
            if i >= len(toks) or toks[i][0] != "OP":
                if not coeffs and const == 0.0:
                    continue
                raise ValueError("constraint without relational operator")
            op = toks[i][1]
            i += 1
            rhs_coeffs, rhs_const, i = parse_expr(i)
            # three-part range:  a <= expr <= b  (first expr was the constant)
            if i < len(toks) and toks[i][0] == "OP" and toks[i][1] in ("<=", ">="):
                op2 = toks[i][1]
                i += 1
                _, far_const, i = parse_expr(i)
                if coeffs:
                    raise ValueError("malformed range constraint")
                if op == "<=" and op2 == "<=":
                    lo, up = const, far_const
                elif op == ">=" and op2 == ">=":
                    lo, up = far_const, const
                else:
                    raise ValueError("mixed operators in range constraint")
                rows.append((label, rhs_coeffs, lo, up))
                continue
            if rhs_coeffs:
                for j, c in rhs_coeffs.items():
                    coeffs[j] = coeffs.get(j, 0.0) - c
            b = rhs_const - const
            lo, up = -INF, INF
            if op == "<=":
                up = b
            elif op == ">=":
                lo = b
            else:
                lo = up = b
            rows.append((label, coeffs, lo, up))
            continue
        if section == "bounds":
            # forms: l <= x <= u ; x <= u ; x >= l ; x = v ; x free ;
            #        -inf <= x <= u
            # gather one bound statement
            if t == "NUM" or (t == "OP" and v == "-"):
                sign = 1.0
                if t == "OP":
                    sign = -1.0
                    i += 1
                lo = sign * toks[i][1]
                i += 1
                assert toks[i][1] == "<="
                i += 1
                nm = toks[i][1]
                j = col(nm)
                i += 1
                bounds.setdefault(j, [None, None])[0] = lo
                if i < len(toks) and toks[i][0] == "OP" and toks[i][1] == "<=":
                    i += 1
                    sign = 1.0
                    while toks[i][0] == "OP":
                        sign = -sign if toks[i][1] == "-" else sign
                        i += 1
                    bounds[j][1] = sign * toks[i][1]
                    i += 1
                continue
            if t == "NAME":
                nm = v
                if i + 1 < len(toks) and toks[i + 1][0] == "SECTION" and toks[i + 1][1] == "free":
                    j = col(nm)
                    bounds[j] = [-INF, INF]
                    i += 2
                    continue
                if i + 1 < len(toks) and toks[i + 1][0] == "NAME" and toks[i + 1][1].lower() == "free":
                    j = col(nm)
                    bounds[j] = [-INF, INF]
                    i += 2
                    continue
                j = col(nm)
                i += 1
                if i >= len(toks) or toks[i][0] != "OP":
                    continue
                op = toks[i][1]
                i += 1
                sign = 1.0
                while toks[i][0] == "OP":
                    sign = -sign if toks[i][1] == "-" else sign
                    i += 1
                val = sign * toks[i][1]
                i += 1
                b = bounds.setdefault(j, [None, None])
                if op == "<=":
                    b[1] = val
                elif op == ">=":
                    b[0] = val
                else:
                    b[0] = b[1] = val
                continue
            i += 1
            continue
        if section == "int":
            if t == "NAME":
                integers.add(col(v))
            i += 1
            continue
        if section == "bin":
            if t == "NAME":
                j = col(v)
                integers.add(j)
                bounds[j] = [0.0, 1.0]
            i += 1
            continue
        i += 1

    n = len(col_names)
    m = len(rows)
    ai, aj, av = [], [], []
    row_lower = np.empty(m)
    row_upper = np.empty(m)
    row_names = []
    for r, (label, coeffs, lo, up) in enumerate(rows):
        row_names.append(label or f"R{r}")
        row_lower[r], row_upper[r] = lo, up
        for j, c in coeffs.items():
            ai.append(r)
            aj.append(j)
            av.append(c)
    A = sp.coo_matrix((av, (ai, aj)), shape=(m, n)).tocsc()
    cl = np.zeros(n)
    cu = np.full(n, INF)
    for j, (lo, up) in bounds.items():
        if lo is not None:
            cl[j] = lo
        if up is not None:
            cu[j] = up
            if up < 0 and lo is None:
                cl[j] = -INF
    c = np.zeros(n)
    for j, val in obj.items():
        c[j] = val
    model.load_problem(A, cl, cu, c, row_lower, row_upper)
    model.objective_offset = obj_offset
    model.optimization_direction = -1.0 if maximize else 1.0
    model.col_names = col_names
    model.row_names = row_names
    if integers:
        mask = np.zeros(n, dtype=bool)
        mask[sorted(integers)] = True
        model.integer_mask = mask
    return model


def write_lp(model, filename: str) -> None:
    m, n = model.num_rows, model.num_cols
    cn = model.col_names or [f"x{j}" for j in range(n)]
    rn = model.row_names or [f"r{i}" for i in range(m)]
    obj = model.objective
    out = []
    out.append("Minimize" if model.optimization_direction >= 0 else "Maximize")
    terms = [" obj:"]
    for j in range(n):
        if obj[j]:
            terms.append(f" {'+' if obj[j] >= 0 else '-'} {repr(float(abs(obj[j])))} {cn[j]}")
    if model.objective_offset:
        terms.append(f" + {repr(float(model.objective_offset))}")
    out.append("".join(terms))
    out.append("Subject To")
    A = model.matrix.tocsr()
    for i in range(m):
        lo, up = model.row_lower[i], model.row_upper[i]
        expr = []
        for k in range(A.indptr[i], A.indptr[i + 1]):
            v = A.data[k]
            expr.append(f" {'+' if v >= 0 else '-'} {repr(float(abs(v)))} {cn[A.indices[k]]}")
        e = "".join(expr)
        if lo == up:
            out.append(f" {rn[i]}:{e} = {repr(float(lo))}")
        else:
            if up < INF:
                out.append(f" {rn[i]}:{e} <= {repr(float(up))}")
            if lo > -INF:
                out.append(f" {rn[i]}_l:{e} >= {repr(float(lo))}")
    out.append("Bounds")
    for j in range(n):
        lo, up = model.col_lower[j], model.col_upper[j]
        if lo <= -INF and up >= INF:
            out.append(f" {cn[j]} free")
        elif lo == up:
            out.append(f" {cn[j]} = {repr(float(lo))}")
        else:
            lo_s = "-inf" if lo <= -INF else repr(float(lo))
            up_s = "+inf" if up >= INF else repr(float(up))
            out.append(f" {lo_s} <= {cn[j]} <= {up_s}")
    if model.integer_mask is not None and model.integer_mask.any():
        out.append("General")
        out.append(" " + " ".join(cn[j] for j in np.flatnonzero(model.integer_mask)))
    out.append("End")
    with open(filename, "w") as f:
        f.write("\n".join(out) + "\n")
