"""MPS file reader/writer (fixed and free format, optional gzip).

Implements the MPS format from its specification: sections NAME, OBJSENSE,
ROWS, COLUMNS (with INTORG/INTEND integrality markers), RHS, RANGES, BOUNDS
(LO/UP/FX/FR/MI/PL/BV/LI/UI), QUADOBJ/QMATRIX, ENDATA.  Capability parity
with the CoinMpsIO reader the reference uses (ClpModel.hpp:131 readMps;
quadratic objective via readQuadraticMps).

Semantics notes (standard MPS conventions, as honored by CoinMpsIO):
  - row types: N free/objective (first N row is the objective), L (<=),
    G (>=), E (=).
  - RANGES on row with rhs b and range r:
      L: [b - |r|, b];  G: [b, b + |r|];  E: r >= 0 -> [b, b + r],
      r < 0 -> [b + r, b].
  - an RHS entry on the objective row supplies the *negated* objective
    constant (offset = -value).
  - BOUNDS `UP` with a negative value on a column whose lower bound is still
    the default 0 makes the lower bound -inf (classic MPS quirk).
"""

from __future__ import annotations

import gzip
import math
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..constants import INF


def _open_text(filename: str):
    if filename.endswith(".gz"):
        return gzip.open(filename, "rt")
    # Also sniff gzip magic for files without the extension.
    with open(filename, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(filename, "rt")
    return open(filename, "rt")


_SECTIONS = {
    "NAME",
    "OBJSENSE",
    "OBJSENSE MAX",
    "OBJSENSE MIN",
    "ROWS",
    "COLUMNS",
    "RHS",
    "RANGES",
    "BOUNDS",
    "QUADOBJ",
    "QMATRIX",
    "QSECTION",
    "SOS",
    "ENDATA",
}


def read_mps(filename: str, into=None, keep_names: bool = True):
    """Parse an MPS file into a Model (creates one if ``into`` is None).

    The pure-Python reader; the native C++ parser route of the JAX
    package waits (ROADMAP.md queue 1: analysis/API/CLI).
    """
    from ..model import Model

    model = into if into is not None else Model()

    row_names: list[str] = []
    row_types: list[str] = []
    row_index: dict[str, int] = {}
    obj_row: Optional[str] = None
    free_rows: set[str] = set()

    col_names: list[str] = []
    col_index: dict[str, int] = {}
    integer_cols: set[int] = set()

    # COO triplets for A
    ai: list[int] = []
    aj: list[int] = []
    av: list[float] = []
    obj_coeffs: dict[int, float] = {}

    rhs: dict[int, float] = {}
    ranges: dict[int, float] = {}
    obj_offset = 0.0
    maximize = False
    problem_name = ""

    # bounds records applied after COLUMNS
    bound_records: list[tuple[str, str, Optional[float]]] = []
    q_triplets: list[tuple[str, str, float]] = []

    section = None
    in_integer = False

    with _open_text(filename) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip():
                continue
            if line[0] == "*":
                continue
            if line[0] not in " \t":
                # section header
                parts = line.split()
                head = parts[0].upper()
                if head == "NAME":
                    problem_name = parts[1] if len(parts) > 1 else ""
                    section = "NAME"
                elif head == "OBJSENSE":
                    section = "OBJSENSE"
                    if len(parts) > 1 and parts[1].upper().startswith("MAX"):
                        maximize = True
                elif head in ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS",
                              "QUADOBJ", "QMATRIX", "QSECTION", "SOS"):
                    section = head
                elif head == "ENDATA":
                    break
                else:
                    raise ValueError(f"unknown MPS section: {line!r}")
                continue

            fields = line.split()
            if section == "OBJSENSE":
                if fields[0].upper().startswith("MAX"):
                    maximize = True
                continue
            if section == "ROWS":
                rtype = fields[0].upper()
                rname = fields[1]
                if rtype == "N" and obj_row is None:
                    obj_row = rname
                elif rtype in ("N", "L", "G", "E"):
                    # extra N rows are kept as free constraint rows with
                    # infinite bounds (CoinMpsIO semantics) so row counts,
                    # names, duals and activities match the reference
                    row_index[rname] = len(row_names)
                    row_names.append(rname)
                    row_types.append(rtype)
                    if rtype == "N":
                        free_rows.add(rname)
                else:
                    raise ValueError(f"bad row type {rtype!r}")
                continue
            if section == "COLUMNS":
                # marker lines: <name> 'MARKER' ... 'INTORG'/'INTEND'
                if len(fields) >= 3 and fields[1].strip("'\"").upper() == "MARKER":
                    marker = fields[-1].strip("'\"").upper()
                    if marker == "INTORG":
                        in_integer = True
                    elif marker == "INTEND":
                        in_integer = False
                    continue
                cname = fields[0]
                if cname not in col_index:
                    col_index[cname] = len(col_names)
                    col_names.append(cname)
                j = col_index[cname]
                if in_integer:
                    integer_cols.add(j)
                # pairs of (row, value)
                k = 1
                while k + 1 < len(fields) + 1 and k + 1 <= len(fields):
                    rname, val = fields[k], float(fields[k + 1])
                    if rname == obj_row:
                        obj_coeffs[j] = obj_coeffs.get(j, 0.0) + val
                    else:
                        i = row_index[rname]
                        ai.append(i)
                        aj.append(j)
                        av.append(val)
                    k += 2
                continue
            if section == "RHS":
                # first field is the RHS set name (may be omitted in sloppy
                # files -> detect by checking whether it is a row name)
                k = 1 if (fields[0] not in row_index and fields[0] != obj_row) else 0
                while k + 1 <= len(fields) - 1:
                    rname, val = fields[k], float(fields[k + 1])
                    if rname == obj_row:
                        obj_offset = -val
                    elif rname in free_rows:
                        pass  # RHS on a free row has no effect
                    else:
                        rhs[row_index[rname]] = val
                    k += 2
                continue
            if section == "RANGES":
                k = 1 if fields[0] not in row_index else 0
                while k + 1 <= len(fields) - 1:
                    rname, val = fields[k], float(fields[k + 1])
                    ranges[row_index[rname]] = val
                    k += 2
                continue
            if section == "BOUNDS":
                btype = fields[0].upper()
                if btype in ("FR", "MI", "PL", "BV"):
                    # bound-set name optional: FR SETNAME COL  or  FR COL
                    cname = fields[2] if len(fields) >= 3 else fields[1]
                    bound_records.append((btype, cname, None))
                else:
                    if len(fields) >= 4:
                        cname, val = fields[2], float(fields[3])
                    else:
                        cname, val = fields[1], float(fields[2])
                    bound_records.append((btype, cname, val))
                continue
            if section in ("QUADOBJ", "QMATRIX", "QSECTION"):
                q_triplets.append((fields[0], fields[1], float(fields[2])))
                continue
            if section == "SOS":
                continue  # parsed but unused (LP relaxation)
            if section == "NAME":
                continue
            raise ValueError(f"data line outside a section: {line!r}")

    m, n = len(row_names), len(col_names)

    # rim arrays from row types + rhs + ranges
    row_lower = np.empty(m)
    row_upper = np.empty(m)
    for i, rt in enumerate(row_types):
        b = rhs.get(i, 0.0)
        if rt == "N":  # extra free row: never binds
            row_lower[i], row_upper[i] = -INF, INF
            continue
        if rt == "L":
            row_lower[i], row_upper[i] = -INF, b
        elif rt == "G":
            row_lower[i], row_upper[i] = b, INF
        else:  # E
            row_lower[i] = row_upper[i] = b
        if i in ranges:
            r = ranges[i]
            if rt == "L":
                row_lower[i] = b - abs(r)
            elif rt == "G":
                row_upper[i] = b + abs(r)
            else:
                if r >= 0:
                    row_upper[i] = b + r
                else:
                    row_lower[i] = b + r

    col_lower = np.zeros(n)
    col_upper = np.full(n, INF)
    # integers default to [0, 1]? CoinMpsIO defaults integer bounds to
    # [0, +inf) unless specified; we keep [0, inf) and rely on BOUNDS.
    explicit_lower = np.zeros(n, dtype=bool)
    for btype, cname, val in bound_records:
        if cname not in col_index:
            continue  # ignore bounds on unknown columns (CoinMpsIO warns)
        j = col_index[cname]
        if btype == "LO":
            col_lower[j] = val
            explicit_lower[j] = True
        elif btype == "UP":
            col_upper[j] = val
            if val < 0 and not explicit_lower[j]:
                col_lower[j] = -INF
        elif btype == "FX":
            col_lower[j] = col_upper[j] = val
            explicit_lower[j] = True
        elif btype == "FR":
            col_lower[j], col_upper[j] = -INF, INF
        elif btype == "MI":
            col_lower[j] = -INF
        elif btype == "PL":
            col_upper[j] = INF
        elif btype == "BV":
            col_lower[j], col_upper[j] = 0.0, 1.0
            integer_cols.add(j)
            explicit_lower[j] = True
        elif btype == "LI":
            col_lower[j] = val
            integer_cols.add(j)
            explicit_lower[j] = True
        elif btype == "UI":
            col_upper[j] = val
            integer_cols.add(j)
        else:
            raise ValueError(f"bad bound type {btype!r}")

    objective = np.zeros(n)
    for j, v in obj_coeffs.items():
        objective[j] = v

    A = sp.coo_matrix((av, (ai, aj)), shape=(m, n)).tocsc()
    A.sum_duplicates()

    model.load_problem(A, col_lower, col_upper, objective, row_lower, row_upper)
    model.objective_offset = obj_offset
    model.optimization_direction = -1.0 if maximize else 1.0
    model.problem_name = problem_name
    if keep_names:
        model.row_names = row_names
        model.col_names = col_names
    if integer_cols:
        mask = np.zeros(n, dtype=bool)
        mask[sorted(integer_cols)] = True
        model.integer_mask = mask

    if q_triplets:
        qi, qj, qv = [], [], []
        for c1, c2, v in q_triplets:
            j1, j2 = col_index[c1], col_index[c2]
            qi.append(j1)
            qj.append(j2)
            qv.append(v)
            if j1 != j2:
                qi.append(j2)
                qj.append(j1)
                qv.append(v)
        Q = sp.coo_matrix((qv, (qi, qj)), shape=(n, n)).tocsc()
        model.load_quadratic_objective(Q)
    return model


def _fmt(v: float) -> str:
    if v == math.floor(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def write_mps(model, filename: str) -> None:
    """Write the model in free MPS format (gzip if filename ends .gz)."""
    m, n = model.num_rows, model.num_cols
    rnames = model.row_names or [f"R{i}" for i in range(m)]
    cnames = model.col_names or [f"C{j}" for j in range(n)]
    rl, ru = model.row_lower, model.row_upper
    cl, cu = model.col_lower, model.col_upper
    obj = model.objective
    lines = []
    lines.append(f"NAME {model.problem_name or 'CLPTPU'}")
    if model.optimization_direction < 0:
        lines.append("OBJSENSE")
        lines.append(" MAX")
    lines.append("ROWS")
    lines.append(" N OBJ")
    row_type = []
    for i in range(m):
        if rl[i] <= -INF and ru[i] >= INF:
            # free row: emit as N (non-objective)
            row_type.append("N")
            lines.append(f" N {rnames[i]}")
        elif rl[i] == ru[i]:
            row_type.append("E")
            lines.append(f" E {rnames[i]}")
        elif ru[i] >= INF:
            row_type.append("G")
            lines.append(f" G {rnames[i]}")
        else:
            row_type.append("L")
            lines.append(f" L {rnames[i]}")
    lines.append("COLUMNS")
    A = model.matrix.tocsc()
    in_int = False
    imask = model.integer_mask
    marker_ct = 0
    for j in range(n):
        is_int = bool(imask is not None and imask[j])
        if is_int and not in_int:
            lines.append(f"    MARKER{marker_ct} 'MARKER' 'INTORG'")
            marker_ct += 1
            in_int = True
        elif not is_int and in_int:
            lines.append(f"    MARKER{marker_ct} 'MARKER' 'INTEND'")
            marker_ct += 1
            in_int = False
        if obj[j] != 0.0:
            lines.append(f"    {cnames[j]} OBJ {_fmt(obj[j])}")
        start, end = A.indptr[j], A.indptr[j + 1]
        for k in range(start, end):
            lines.append(f"    {cnames[j]} {rnames[A.indices[k]]} {_fmt(A.data[k])}")
    if in_int:
        lines.append(f"    MARKER{marker_ct} 'MARKER' 'INTEND'")
    lines.append("RHS")
    if model.objective_offset != 0.0:
        lines.append(f"    RHS OBJ {_fmt(-model.objective_offset)}")
    for i in range(m):
        if row_type[i] == "N":
            continue
        b = ru[i] if row_type[i] in ("L", "E") else rl[i]
        if b != 0.0:
            lines.append(f"    RHS {rnames[i]} {_fmt(b)}")
    lines.append("RANGES")
    for i in range(m):
        if row_type[i] == "L" and rl[i] > -INF:
            lines.append(f"    RNG {rnames[i]} {_fmt(ru[i] - rl[i])}")
        elif row_type[i] == "G" and ru[i] < INF:
            lines.append(f"    RNG {rnames[i]} {_fmt(ru[i] - rl[i])}")
    lines.append("BOUNDS")
    for j in range(n):
        lo, up = cl[j], cu[j]
        if lo == up:
            lines.append(f" FX BND {cnames[j]} {_fmt(lo)}")
            continue
        if lo <= -INF and up >= INF:
            lines.append(f" FR BND {cnames[j]}")
            continue
        if lo <= -INF:
            lines.append(f" MI BND {cnames[j]}")
        elif lo != 0.0:
            lines.append(f" LO BND {cnames[j]} {_fmt(lo)}")
        if up < INF:
            lines.append(f" UP BND {cnames[j]} {_fmt(up)}")
    Q = model.quadratic_objective
    if Q is not None:
        lines.append("QUADOBJ")
        Qc = sp.triu(Q).tocoo()
        for i, j, v in zip(Qc.row, Qc.col, Qc.data):
            lines.append(f"    {cnames[i]} {cnames[j]} {_fmt(v)}")
    lines.append("ENDATA")
    text = "\n".join(lines) + "\n"
    if filename.endswith(".gz"):
        with gzip.open(filename, "wt") as f:
            f.write(text)
    else:
        with open(filename, "wt") as f:
            f.write(text)
