"""MPS-format basis files (warm-start checkpointing).

Equivalent of ClpSimplex::writeBasis/readBasis
(ClpSimplexOther.cpp:1018/1136) in the standard MPS basis format:

    NAME <name>
     XU <col> <row>   column basic, paired row nonbasic at upper
     XL <col> <row>   column basic, paired row nonbasic at lower
     UL <col>         column nonbasic at upper bound
     LL <col>         column nonbasic at lower bound (also the default)
     BS <col>         column basic with no paired row (free rows exhausted)
    ENDATA

Every basic column must pair with a nonbasic row (counts always match since
#basic_cols = m - #basic_rows).
"""

from __future__ import annotations

import numpy as np

from ..constants import VariableStatus


def write_basis(model, filename: str) -> int:
    sol = model.solution
    if sol.column_status is None or sol.row_status is None:
        return -1
    cn = model.col_names or [f"C{j}" for j in range(model.num_cols)]
    rn = model.row_names or [f"R{i}" for i in range(model.num_rows)]
    cstat = np.asarray(sol.column_status)
    rstat = np.asarray(sol.row_status)
    nonbasic_rows = [i for i in range(len(rstat)) if rstat[i] != int(VariableStatus.BASIC)]
    lines = [f"NAME {model.problem_name or 'CLPTPU'}"]
    k = 0
    for j in range(len(cstat)):
        s = int(cstat[j])
        if s == int(VariableStatus.BASIC):
            if k < len(nonbasic_rows):
                i = nonbasic_rows[k]
                k += 1
                tag = "XU" if int(rstat[i]) == int(VariableStatus.AT_UPPER) else "XL"
                lines.append(f" {tag} {cn[j]} {rn[i]}")
            else:
                lines.append(f" BS {cn[j]}")
        elif s == int(VariableStatus.AT_UPPER):
            lines.append(f" UL {cn[j]}")
        # AT_LOWER / FIXED are the default -> omitted
    lines.append("ENDATA")
    with open(filename, "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


def read_basis(model, filename: str) -> int:
    cn = model.col_names or [f"C{j}" for j in range(model.num_cols)]
    rn = model.row_names or [f"R{i}" for i in range(model.num_rows)]
    cidx = {n: j for j, n in enumerate(cn)}
    ridx = {n: i for i, n in enumerate(rn)}
    cstat = np.full(model.num_cols, int(VariableStatus.AT_LOWER), dtype=np.int8)
    rstat = np.full(model.num_rows, int(VariableStatus.BASIC), dtype=np.int8)
    try:
        with open(filename) as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0] in ("NAME", "ENDATA") or line.startswith("*"):
                    continue
                tag = parts[0].upper()
                if tag in ("XU", "XL"):
                    j = cidx.get(parts[1])
                    i = ridx.get(parts[2])
                    if j is not None:
                        cstat[j] = int(VariableStatus.BASIC)
                    if i is not None:
                        rstat[i] = int(
                            VariableStatus.AT_UPPER if tag == "XU" else VariableStatus.AT_LOWER
                        )
                elif tag == "UL":
                    j = cidx.get(parts[1])
                    if j is not None:
                        cstat[j] = int(VariableStatus.AT_UPPER)
                elif tag == "LL":
                    j = cidx.get(parts[1])
                    if j is not None:
                        cstat[j] = int(VariableStatus.AT_LOWER)
                elif tag == "BS":
                    j = cidx.get(parts[1])
                    if j is not None:
                        cstat[j] = int(VariableStatus.BASIC)
    except FileNotFoundError:
        return -1
    # the MPS basis format has no code for isFixed: restore it for any
    # nonbasic column with equal bounds (Clp marks those Status::isFixed)
    fixed = (model.col_lower == model.col_upper) & (
        cstat != int(VariableStatus.BASIC)
    )
    cstat[fixed] = int(VariableStatus.FIXED)
    model.set_basis_status(cstat, rstat)
    return 0
