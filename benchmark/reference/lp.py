"""The plain reference: a batched primal-dual interior-point solver for

    min c'x  subject to  rl <= A x <= ru,  l <= x <= u

and the optimality measures that judge an answer. Plain PyTorch and NumPy;
it imports nothing of the program under test and works from the generated
arrays alone (a batch: A, c, l, u shared by the lanes, rl, ru per lane).

Row duals y follow the convention of the program's `Solution.duals`:
reduced costs d = c - A'y, and y_i > 0 prices a row at its lower bound.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def _dense(A) -> np.ndarray:
    return A.toarray() if sp.issparse(A) else np.asarray(A, dtype=np.float64)


def _lanes(batch: dict) -> int:
    return batch["rl"].shape[0]


def _per_lane(v, lanes: int) -> np.ndarray:
    v = np.asarray(v, dtype=np.float64)
    return np.broadcast_to(v, (lanes,) + v.shape[-1:]) if v.ndim == 1 else v


# --------------------------------------------------------------------------
# judging an answer
# --------------------------------------------------------------------------


def measures(batch: dict, x: np.ndarray, y: np.ndarray) -> dict:
    """Per lane, in float64 on the host, for primal values x (lanes x n) and
    row duals y (lanes x m):

      primal_inf  largest violation of a row or column bound,
                  over 1 + the largest finite bound;
      dual_inf    largest dual of the wrong sign for an infinite bound
                  (y_i > 0 with rl_i = -inf, y_i < 0 with ru_i = +inf, and
                  alike for d = c - A'y on the columns), over 1 + max |c|;
      gap         |c'x - g(y)| / (1 + |c'x|), where g(y) is the Lagrangian
                  dual bound: sum of y+ rl - y- ru over rows and d+ l - d- u
                  over columns, finite bounds only. Weak duality gives
                  c'x >= g(y) for every feasible x; both are optimal exactly
                  when the gap is 0;
      primal_obj  c'x.
    """
    lanes = x.shape[0]
    A = batch["A"]
    c = _per_lane(batch["c"], lanes)
    l, u = _per_lane(batch["l"], lanes), _per_lane(batch["u"], lanes)
    rl, ru = batch["rl"], batch["ru"]
    A = A if sp.issparse(A) else np.asarray(A, dtype=np.float64)
    ax = np.asarray(A @ x.T).T
    aty = np.asarray(A.T @ y.T).T
    with np.errstate(invalid="ignore"):
        viol = np.maximum.reduce([
            np.max(np.maximum(rl - ax, ax - ru), axis=1, initial=0.0),
            np.max(np.maximum(l - x, x - u), axis=1, initial=0.0)])

    def scale(*vs):
        return 1.0 + np.max(np.stack([np.max(np.where(np.isfinite(v), np.abs(v), 0.0), axis=1)
                                      for v in vs]), axis=0)

    d = c - aty
    yp, yn = np.maximum(y, 0.0), np.maximum(-y, 0.0)
    dp, dn = np.maximum(d, 0.0), np.maximum(-d, 0.0)
    wrong = np.maximum.reduce([
        np.max(np.where(np.isfinite(rl), 0.0, yp), axis=1, initial=0.0),
        np.max(np.where(np.isfinite(ru), 0.0, yn), axis=1, initial=0.0),
        np.max(np.where(np.isfinite(l), 0.0, dp), axis=1, initial=0.0),
        np.max(np.where(np.isfinite(u), 0.0, dn), axis=1, initial=0.0)])

    def fin(v):
        return np.where(np.isfinite(v), v, 0.0)

    g = ((yp * fin(rl)).sum(1) - (yn * fin(ru)).sum(1)
         + (dp * fin(l)).sum(1) - (dn * fin(u)).sum(1))
    pobj = (c * x).sum(1)
    return {"primal_inf": viol / scale(rl, ru, l, u),
            "dual_inf": wrong / (1.0 + np.max(np.abs(c), axis=1)),
            "gap": np.abs(pobj - g) / (1.0 + np.abs(pobj)),
            "primal_obj": pobj}


# --------------------------------------------------------------------------
# solving
# --------------------------------------------------------------------------


def solve(batch: dict, device="cpu", dtype=torch.float64, tol: float = 1e-9,
          max_iter: int = 100, chunk: int = 2048, stall: int = 8) -> dict:
    """Solve every lane of `batch` by Mehrotra's predictor-corrector
    interior-point method on the normal equations, dense Cholesky, in
    `dtype` on `device`, `chunk` lanes at a time. A lane stops at `tol`
    (the largest of its relative primal and dual residuals and duality
    gap), or once `stall` iterations have not improved its best iterate,
    which it returns. Returns numpy arrays: x (lanes x n), y (lanes x m),
    obj (c'x), converged (bool per lane), err (the best iterate's error),
    iterations. Lanes must share
    which rows are equalities (rl == ru)."""
    lanes = _lanes(batch)
    if np.ndim(batch["A"]) != 2:
        raise ValueError("the reference solver takes one matrix shared by the lanes")
    eq = batch["rl"] == batch["ru"]
    if not (eq == eq[:1]).all():
        raise ValueError("the lanes of a batch must share their equality rows")
    out = {"x": [], "y": [], "obj": [], "converged": [], "err": [], "iterations": []}
    for a in range(0, lanes, chunk):
        sub = dict(batch, rl=batch["rl"][a:a + chunk], ru=batch["ru"][a:a + chunk])
        res = _solve_chunk(sub, eq[0], torch.device(device), dtype, tol, max_iter, stall)
        for k in out:
            out[k].append(res[k])
    return {k: np.concatenate(v) for k, v in out.items()}


def _solve_chunk(batch, eq, dev, dtype, tol, max_iter, stall) -> dict:
    lanes = _lanes(batch)
    A = _dense(batch["A"])
    m, n = A.shape
    E, I = np.flatnonzero(eq), np.flatnonzero(~eq)
    k = I.size

    def t(v):
        return torch.as_tensor(np.array(v, dtype=np.float64), dtype=dtype, device=dev)

    # z = [x; s], s = A_I x the slacks of the inequality rows:
    # M z = b with M = [[A_E, 0], [A_I, -I]], b = [rl_E; 0]
    At = t(A)
    M = torch.cat([At.index_select(0, torch.as_tensor(E, device=dev)),
                   At.index_select(0, torch.as_tensor(I, device=dev))])
    neg = torch.zeros((m, k), dtype=dtype, device=dev)
    neg[E.size + torch.arange(k, device=dev), torch.arange(k, device=dev)] = -1.0
    M = torch.cat([M, neg], 1)
    b = torch.zeros(lanes, m, dtype=dtype, device=dev)
    b[:, :E.size] = t(batch["rl"][:, E])
    c = torch.cat([t(_per_lane(batch["c"], lanes)),
                   torch.zeros(lanes, k, dtype=dtype, device=dev)], 1)
    zl = torch.cat([t(_per_lane(batch["l"], lanes)), t(batch["rl"][:, I])], 1)
    zu = torch.cat([t(_per_lane(batch["u"], lanes)), t(batch["ru"][:, I])], 1)
    hl, hu = torch.isfinite(zl), torch.isfinite(zu)
    if not (hl | hu).all():
        raise ValueError("the reference solver takes no free variable")
    zl0, zu0 = torch.where(hl, zl, 0.0), torch.where(hu, zu, 0.0)
    one = torch.ones((), dtype=dtype, device=dev)

    def mv(v):  # M v per lane
        return v @ M.T

    def mtv(v):  # M' v per lane
        return v @ M

    # start: inside the bounds, one unit from a single bound, mid-box on a
    # narrow box; bound duals 1
    width = zu - zl
    inset = torch.clamp(0.5 * width, max=1.0)
    z = torch.where(hl & hu, zl0 + inset, torch.where(hl, zl0 + 1.0, zu0 - 1.0))
    z = torch.where(hl & hu & (width <= 2.0), 0.5 * (zl0 + zu0), z)
    y = torch.zeros(lanes, m, dtype=dtype, device=dev)
    wl = torch.where(hl, one, 0.0)
    wu = torch.where(hu, one, 0.0)
    nb = (hl.sum(1) + hu.sum(1)).to(dtype)
    bscale = 1.0 + torch.stack([torch.where(torch.isfinite(v), v.abs(), 0.0).amax(1)
                                for v in (zl, zu, b)]).amax(0)
    cscale = 1.0 + c.abs().amax(1)
    done = torch.zeros(lanes, dtype=torch.bool, device=dev)
    iters = torch.zeros(lanes, dtype=torch.int64, device=dev)
    since = torch.zeros(lanes, dtype=torch.int64, device=dev)
    best = None

    for _ in range(max_iter):
        g = torch.where(hl, z - zl0, 1.0)
        tt = torch.where(hu, zu0 - z, 1.0)
        rp = b - mv(z)
        rd = c - mtv(y) - wl + wu
        pobj = (c * z).sum(1)
        dobj = (b * y).sum(1) + (wl * zl0).sum(1) - (wu * zu0).sum(1)
        mu = ((g * wl).sum(1) + (tt * wu).sum(1)) / nb
        pres = rp.abs().amax(1) / bscale
        dres = rd.abs().amax(1) / cscale
        rgap = (pobj - dobj).abs() / (1.0 + pobj.abs())
        err = torch.maximum(torch.maximum(pres, dres), rgap)
        conv = (err <= tol) & torch.isfinite(err)
        if best is None:
            best = {"z": z, "y": y, "err": torch.where(torch.isfinite(err), err, torch.inf)}
        else:
            better = torch.isfinite(err) & (err < best["err"]) & ~done
            since = torch.where(better & (err < 0.9 * best["err"]), 0, since + 1)
            best = {"z": torch.where(better[:, None], z, best["z"]),
                    "y": torch.where(better[:, None], y, best["y"]),
                    "err": torch.where(better, err, best["err"])}
        done = done | conv | (since >= stall)
        if bool(done.all()):
            break
        iters = iters + (~done).long()

        D = torch.where(hl, wl / g, 0.0) + torch.where(hu, wu / tt, 0.0)
        theta = 1.0 / torch.clamp(D, min=torch.finfo(dtype).tiny ** 0.5)
        K = (M[None] * theta[:, None, :]) @ M.T
        diag = K.diagonal(dim1=-2, dim2=-1)
        reg = torch.finfo(dtype).eps * (1.0 + diag.amax(-1))
        K = K + torch.diag_embed(reg[:, None].expand_as(diag))
        L, info = torch.linalg.cholesky_ex(K)
        for shift in (1e2, 1e4, 1e6, 1e8, 1e10, 1e12):
            bad = info > 0
            if not bool(bad.any()):
                break
            K = K + torch.diag_embed((bad.to(dtype) * shift * reg)[:, None].expand_as(diag))
            L, info = torch.linalg.cholesky_ex(K)
        failed = info > 0
        if bool((failed | done).all()):
            break

        def newton(rcl, rcu):
            r = rd - torch.where(hl, rcl / g, 0.0) + torch.where(hu, rcu / tt, 0.0)
            rhs = rp + mv(theta * r)
            dy = torch.cholesky_solve(rhs[..., None], L)[..., 0]
            dz = theta * (mtv(dy) - r)
            dwl = torch.where(hl, (rcl - wl * dz) / g, 0.0)
            dwu = torch.where(hu, (rcu + wu * dz) / tt, 0.0)
            return dz, dy, dwl, dwu

        def steps(dz, dwl, dwu):
            inf = torch.full_like(z, torch.inf)
            ap = torch.minimum(
                torch.where(hl & (dz < 0), -g / dz, inf).amin(1),
                torch.where(hu & (dz > 0), tt / dz, inf).amin(1))
            ad = torch.minimum(
                torch.where(hl & (dwl < 0), -wl / dwl, inf).amin(1),
                torch.where(hu & (dwu < 0), -wu / dwu, inf).amin(1))
            return torch.clamp(ap, max=1.0), torch.clamp(ad, max=1.0)

        dz, dy, dwl, dwu = newton(-g * wl, -tt * wu)
        ap, ad = steps(dz, dwl, dwu)
        g_a = g + ap[:, None] * dz
        t_a = tt - ap[:, None] * dz
        mu_a = ((torch.where(hl, g_a * (wl + ad[:, None] * dwl), 0.0)).sum(1)
                + (torch.where(hu, t_a * (wu + ad[:, None] * dwu), 0.0)).sum(1)) / nb
        sigma = torch.clamp(mu_a / mu, 0.0, 1.0) ** 3
        sm = (sigma * mu)[:, None]
        dz, dy, dwl, dwu = newton(sm - g * wl - dz * dwl, sm - tt * wu + dz * dwu)
        ap, ad = steps(dz, dwl, dwu)
        ap, ad = torch.clamp(0.995 * ap, max=1.0), torch.clamp(0.995 * ad, max=1.0)
        keep = (done | failed)[:, None]
        z = torch.where(keep, z, z + ap[:, None] * dz)
        y = torch.where(keep, y, y + ad[:, None] * dy)
        wl = torch.where(keep, wl, wl + ad[:, None] * dwl)
        wu = torch.where(keep, wu, wu + ad[:, None] * dwu)

    z, y = best["z"], best["y"]
    x = z[:, :n]
    # y over the original rows: M's rows are the equalities, then the rest
    order = np.concatenate([E, I])
    y_rows = torch.empty_like(y)
    y_rows[:, torch.as_tensor(order, device=dev)] = y
    return {"x": x.double().cpu().numpy(), "y": y_rows.double().cpu().numpy(),
            "obj": (c[:, :n] * x).sum(1).double().cpu().numpy(),
            "converged": (best["err"] <= tol).cpu().numpy(),
            "err": best["err"].double().cpu().numpy(),
            "iterations": iters.cpu().numpy()}
