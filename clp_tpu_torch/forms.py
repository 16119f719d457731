"""Host -> device problem forms.

Both solver families consume one *computational standard form*:

    minimize  c'v   s.t.  G v = b,   l <= v <= u

built from the user form (rl <= Ax <= ru, cl <= x <= cu) by appending one
slack per row:  G = [A | -I],  b = 0,  slack bounds = [rl, ru].  This mirrors
the reference's internal convention of treating rows as bounded "logical"
variables (ClpSimplex status bytes cover rows and columns alike,
ClpSimplex.hpp:119-126), but collapses Clp's six matrix classes into a single
dense device tensor.

The interior-point form (`to_ipm_form`) also substitutes fixed variables
out; `expand_ipm_solution` puts them back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .constants import INF
from .device import resolve_device


@dataclasses.dataclass
class StandardLP:
    """Dense standard-form LP/QP on one device:
        min c'v + (1/2) v'Qv   s.t.  Gv=b,  l<=v<=u   (Q optional).
    """

    G: torch.Tensor  # (m, nt)
    b: torch.Tensor  # (m,)
    c: torch.Tensor  # (nt,)
    l: torch.Tensor  # (nt,)  -inf allowed
    u: torch.Tensor  # (nt,)  +inf allowed
    Q: Optional[torch.Tensor] = None  # (nt, nt) PSD, or None for pure LP

    @property
    def m(self) -> int:
        return self.G.shape[-2]

    @property
    def nt(self) -> int:
        return self.G.shape[-1]


@dataclasses.dataclass
class FormInfo:
    """Static host-side bookkeeping to map device solutions back."""

    n: int  # structural columns
    m: int  # rows
    sense: float  # +1 min, -1 max
    offset: float
    kept: Optional[np.ndarray] = None
    fixed_values: Optional[np.ndarray] = None


def to_standard_form(model, dtype=torch.float64,
                     device="cuda") -> tuple[StandardLP, FormInfo]:
    """User form -> [A | -I] equality standard form (simplex flavor)."""
    dev = resolve_device(device)
    A = np.asarray(model.matrix.todense(), dtype=np.float64)
    m, n = A.shape
    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0
    G = np.concatenate([A, -np.eye(m)], axis=1)
    c = np.concatenate([model.objective * sense, np.zeros(m)])
    l = np.concatenate([model.col_lower, model.row_lower])
    u = np.concatenate([model.col_upper, model.row_upper])
    l = np.where(l <= -INF, -np.inf, l)
    u = np.where(u >= INF, np.inf, u)
    b = np.zeros(m)
    Q_dev = None
    if model.quadratic_objective is not None:
        nt = n + m
        Qfull = np.zeros((nt, nt))
        Qfull[:n, :n] = np.asarray(model.quadratic_objective.todense()) * sense
        Q_dev = torch.as_tensor(Qfull, dtype=dtype, device=dev)

    def dev_t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    lp = StandardLP(G=dev_t(G), b=dev_t(b), c=dev_t(c), l=dev_t(l),
                    u=dev_t(u), Q=Q_dev)
    info = FormInfo(n=n, m=m, sense=sense, offset=model.objective_offset)
    return lp, info


def to_ipm_form(model, dtype=torch.float64,
                device="cuda") -> tuple[StandardLP, FormInfo]:
    """Standard form with fixed variables substituted out (IPM flavor).

    Built on the host in numpy; the tensors land on `device`. The barrier
    asks for the CPU form first, plans its normal equations on those
    arrays (`.numpy()` views) and moves the final form to the card once.
    """
    dev = resolve_device(device)
    A = np.asarray(model.matrix.todense(), dtype=np.float64)
    m, n = A.shape
    sense = model.optimization_direction if model.optimization_direction != 0 else 1.0
    G = np.concatenate([A, -np.eye(m)], axis=1)
    c = np.concatenate([model.objective * sense, np.zeros(m)])
    l = np.concatenate([model.col_lower, model.row_lower])
    u = np.concatenate([model.col_upper, model.row_upper])
    l = np.where(l <= -INF, -np.inf, l)
    u = np.where(u >= INF, np.inf, u)

    fixed = l == u
    kept = np.flatnonzero(~fixed)
    fixed_idx = np.flatnonzero(fixed)
    b = np.zeros(m)
    if fixed_idx.size:
        b = b - G[:, fixed_idx] @ l[fixed_idx]
    offset_extra = float(c[fixed_idx] @ l[fixed_idx]) if fixed_idx.size else 0.0

    Q = None
    if model.quadratic_objective is not None:
        nt = n + m
        Qfull = np.zeros((nt, nt))
        Qfull[:n, :n] = np.asarray(model.quadratic_objective.todense()) * sense
        if fixed_idx.size:
            vals = l[fixed_idx]
            # cross terms with fixed variables fold into c and the offset
            c = c + Qfull[:, fixed_idx] @ vals
            offset_extra += 0.5 * float(vals @ (Qfull[np.ix_(fixed_idx, fixed_idx)] @ vals))
        Q = Qfull[np.ix_(kept, kept)]

    def dev_t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    lp = StandardLP(G=dev_t(G[:, kept]), b=dev_t(b), c=dev_t(c[kept]),
                    l=dev_t(l[kept]), u=dev_t(u[kept]),
                    Q=None if Q is None else dev_t(Q))
    info = FormInfo(
        n=n,
        m=m,
        sense=sense,
        offset=model.objective_offset + offset_extra * sense,
        kept=kept,
        fixed_values=np.where(fixed, l, 0.0),
    )
    return lp, info


def expand_ipm_solution(info: FormInfo, v_kept: np.ndarray) -> np.ndarray:
    """Re-insert fixed variables into the nt = n + m vector."""
    nt = info.n + info.m
    v = np.array(info.fixed_values, dtype=np.float64, copy=True)
    v[info.kept] = np.asarray(v_kept, dtype=np.float64)
    if v.shape != (nt,):
        raise ValueError(f"expanded IPM solution has shape {v.shape}, expected ({nt},)")
    return v
