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

`to_standard_form_batch` builds the simplex form of many same-shape models
at once on the device that solves them, from each model's sparse data.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import trace
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


def to_device(t: torch.Tensor, dev) -> torch.Tensor:
    """t on `dev`, its bytes counted as h2d_bytes when they leave the host."""
    if t.device.type == "cpu" and torch.device(dev).type != "cpu":
        trace.count("h2d_bytes", t.nbytes)
    return t.to(dev)


def batch_shape(models: Sequence) -> tuple[int, int, bool]:
    """(m, n, QP) that every model of a batch shares; ValueError where the
    shapes differ or LPs and QPs mix."""
    if not models:
        raise ValueError("a batch needs at least one model")
    shape = models[0].matrix.shape
    if any(mod.matrix.shape != shape for mod in models):
        raise ValueError("all models in a batch must share shape")
    has_q = [mod.quadratic_objective is not None for mod in models]
    if any(has_q) and not all(has_q):
        raise ValueError("mixing QP and LP instances in one batch")
    return shape[0], shape[1], has_q[0]


def _csc_entries(mats: list, rows: int):
    """The entries of same-shape sparse matrices, one after the other: row
    index, column count (a matrix's columns in order, then the next
    matrix's) and value, as flat host arrays. A position given more than
    once is summed in storage order, as todense() sums it, so each
    position appears once; every value is 0.0 + itself, as todense()
    writes it (an explicit -0.0 becomes 0.0)."""
    mats = [a.tocsc() for a in mats]
    counts = np.diff(np.stack([a.indptr for a in mats]), axis=1).ravel()
    idx = np.concatenate([a.indices for a in mats])
    val = np.concatenate([a.data for a in mats]).astype(np.float64, copy=False)
    # canonical (rows strictly rising inside each column) leaves no repeats
    rising = idx[1:] > idx[:-1]
    starts = np.cumsum(counts)[:-1]
    rising[starts[(starts > 0) & (starts < idx.size)] - 1] = True
    if rising.all():
        return idx, counts, val + 0.0
    seg = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
    key = seg * rows + idx
    order = np.argsort(key, kind="stable")
    key, val = key[order], val[order]
    first = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    size = np.diff(np.r_[first, key.size])
    total = 0.0 + val[first]
    for k in range(1, int(size.max())):
        more = size > k
        total[more] += val[first[more] + k]
    key = key[first]
    return (key % rows).astype(idx.dtype), np.bincount(key // rows, minlength=counts.size), total


def _scatter(out: torch.Tensor, entries, dtype, dev) -> int:
    """Write the entries of B matrices (`_csc_entries`) into `out` (B, R,
    C): entry (r, j) of matrix k at out[k, r, j]. Each position is
    written once, so the result is deterministic. Returns the entries
    written."""
    idx, counts, val = entries
    cols = counts.size // out.shape[0]
    lane_stride, row_stride = out.shape[1] * out.shape[2], out.shape[2]
    idx_d = to_device(torch.from_numpy(idx), dev)
    counts_d = to_device(torch.from_numpy(counts), dev)
    val_d = to_device(torch.as_tensor(val, dtype=dtype), dev)
    seg = torch.repeat_interleave(counts_d, output_size=val.size).long()
    flat = seg // cols * lane_stride + seg % cols + idx_d.long() * row_stride
    out.view(-1)[flat] = val_d
    return val.size


def to_standard_form_batch(models: Sequence, dtype=torch.float64,
                           device="cuda") -> tuple[StandardLP, list]:
    """Same-shape models -> one batched [A | -I] standard form on `device`,
    equal bit for bit to torch.stack of each model's to_standard_form.

    The host gathers the lanes' sparse entries and their bound and cost
    vectors into flat arrays and sends each array once; the device
    zero-fills G (B, m, n + m), scatters the entries and writes the -I
    slack block (Q likewise from its own entries). So only the nonzeros
    and the vectors leave the host, never the dense form. Traced as the
    counters h2d_bytes (the arrays sent) and form_nnz (the entries
    scattered into G and Q)."""
    dev = resolve_device(device)
    m, n, qp = batch_shape(models)
    B, nt = len(models), n + m
    sense = np.array([mod.optimization_direction or 1.0 for mod in models], dtype=np.float64)

    def rows_of(name):
        return np.stack([getattr(mod, name) for mod in models]).astype(np.float64, copy=False)

    c = np.zeros((B, nt))
    c[:, :n] = rows_of("objective") * sense[:, None]
    l = np.concatenate([rows_of("col_lower"), rows_of("row_lower")], axis=1)
    u = np.concatenate([rows_of("col_upper"), rows_of("row_upper")], axis=1)
    l = np.where(l <= -INF, -np.inf, l)
    u = np.where(u >= INF, np.inf, u)

    G = torch.zeros((B, m, nt), dtype=dtype, device=dev)
    G[:, :, n:] = -torch.eye(m, dtype=dtype, device=dev)
    nnz = _scatter(G, _csc_entries([mod.matrix for mod in models], m), dtype, dev)
    Q = None
    if qp:
        idx, counts, val = _csc_entries([mod.quadratic_objective for mod in models], n)
        val = val * np.repeat(sense, counts.reshape(B, n).sum(axis=1))
        Q = torch.zeros((B, nt, nt), dtype=dtype, device=dev)
        # the block's empty entries are 0 * sense, as the dense product gives
        zero = to_device(torch.as_tensor(0.0 * sense, dtype=dtype), dev)
        Q[:, :n, :n] = zero[:, None, None]
        nnz += _scatter(Q, (idx, counts, val), dtype, dev)
    trace.count("form_nnz", nnz)

    def sent(a):
        return to_device(torch.as_tensor(a, dtype=dtype), dev)

    lp = StandardLP(G=G, b=torch.zeros((B, m), dtype=dtype, device=dev),
                    c=sent(c), l=sent(l), u=sent(u), Q=Q)
    infos = [FormInfo(n=n, m=m, sense=float(s), offset=mod.objective_offset)
             for mod, s in zip(models, sense)]
    return lp, infos


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
