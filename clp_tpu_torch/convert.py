"""Carry LP and simplex state between numpy and the port's tensors.

The JAX package's `StandardLP`, `SimplexState`, `QPState` and `IPMResult` are
pytrees of arrays; their fields, as numpy arrays in a `{name: array}` dict,
go through `*_from_numpy` to the port's dataclasses on a chosen device, and
back through `*_to_numpy`. `FormInfo` (host bookkeeping of a form) and the
PDHG's ELL matrix carry the same way. The tests hand one mid-solve state,
one IPM form or one ELL matrix to both packages this way, and compare what
comes out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .forms import FormInfo, StandardLP
from .interior.mehrotra import IPMResult
from .pdlp import EllMatrix
from .simplex.engine import SimplexState
from .simplex.qp import QPState

# dtypes the port keeps per SimplexState field where JAX's differ
# (torch indexes with int64; the JAX package stores int32 indices)
_STATE_INT = {"basis": torch.int64, "vstat": torch.int32,
              "iterations": torch.int32, "status": torch.int32,
              "refactors": torch.int32, "refactor_now": torch.bool}


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True)).to(device)
    return t if dtype is None else t.to(dtype)


def standard_lp_from_numpy(fields: dict, device) -> StandardLP:
    q = fields.get("Q")
    return StandardLP(
        **{k: _tensor(fields[k], device) for k in ("G", "b", "c", "l", "u")},
        Q=None if q is None else _tensor(q, device),
    )


def standard_lp_to_numpy(lp: StandardLP) -> dict:
    return {f.name: (None if getattr(lp, f.name) is None
                     else getattr(lp, f.name).detach().cpu().numpy())
            for f in dataclasses.fields(lp)}


def simplex_state_from_numpy(fields: dict, device) -> SimplexState:
    return SimplexState(**{
        f.name: _tensor(fields[f.name], device, _STATE_INT.get(f.name))
        for f in dataclasses.fields(SimplexState)})


def simplex_state_to_numpy(state: SimplexState) -> dict:
    out = {f.name: getattr(state, f.name).detach().cpu().numpy()
           for f in dataclasses.fields(state)}
    out["basis"] = out["basis"].astype(np.int32)
    return out


def qp_state_from_numpy(fields: dict, device) -> QPState:
    return QPState(**{
        f.name: _tensor(fields[f.name], device, _STATE_INT.get(f.name))
        for f in dataclasses.fields(QPState)})


def qp_state_to_numpy(state: QPState) -> dict:
    out = {f.name: getattr(state, f.name).detach().cpu().numpy()
           for f in dataclasses.fields(state)}
    out["basis"] = out["basis"].astype(np.int32)
    return out


def block_forms_from_numpy(blk, device) -> tuple:
    """(starts, W, m8) as the engine takes them: starts int32, as the
    kernel K3 reads them."""
    starts, W, m8 = blk
    return _tensor(starts, device, torch.int32), _tensor(W, device), int(m8)


def block_forms_to_numpy(blk) -> tuple:
    starts, W, m8 = blk
    return starts.detach().cpu().numpy(), W.detach().cpu().numpy(), int(m8)


def form_info_from_numpy(fields: dict) -> FormInfo:
    return FormInfo(**{f.name: fields.get(f.name) for f in dataclasses.fields(FormInfo)})


def ipm_result_from_numpy(fields: dict, device) -> IPMResult:
    return IPMResult(**{f.name: _tensor(fields[f.name], device)
                        for f in dataclasses.fields(IPMResult)})


def ipm_result_to_numpy(res: IPMResult) -> dict:
    return {f.name: getattr(res, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(res)}


def ell_from_numpy(fields: dict, device) -> EllMatrix:
    """The four ELL fields (val, idx, valT, idxT) to the port's EllMatrix:
    values f64, indices int64, as torch indexes."""
    return EllMatrix(*(_tensor(fields[k], device, torch.float64 if k.startswith("val")
                                else torch.int64)
                       for k in ("val", "idx", "valT", "idxT")))
