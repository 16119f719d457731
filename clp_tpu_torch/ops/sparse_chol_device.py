"""Device multifrontal sparse-Cholesky numeric for the barrier.

ops/sparse_chol.py builds the symbolic plan on the host (minimum-degree
ordering, etree + postorder, relaxed supernodes) and factors it there.
This module runs the plan's NUMERIC on the tensors' device (the reference
hot loop: ClpCholeskyBase.cpp:2767 factorize, :3640 dense window):

  * supernodes are scheduled into LEVELS of the supernode etree
    (children strictly before parents); levels run in order, fronts
    within a level batch;
  * within a level, fronts are BUCKETED by padded tile shape
    (nr, w -> next multiples of 8) and each bucket runs as batched dense
    tile ops: POTRF (`torch.linalg.cholesky_ex`), TRSM
    (`torch.linalg.solve_triangular`), SYRK (`torch.bmm`);
  * assembly, extend-add and the solve's updates are index maps
    PRECOMPUTED on the host from the symbolic plan, moved to the device
    once per plan as int64 tensors (the update pool is one flat device
    vector with per-front offsets);
  * the factor dtype is a parameter: float32 on the card (the caller
    wraps solves in f64 iterative refinement — the same mixed-precision
    contract as the simplex engine's f32 inverse), float64 to match the
    host numeric in tests.

Every scatter with repeated targets (extend-add of several children into
one parent, the normal equations' products summed per entry, the
forward solve's updates of shared ancestor rows) is a `_SegmentSum`: the
contributions of each target are gathered into a padded row in a fixed
host-sorted order and summed along the row, so no atomics run and two
factorizations of the same values give the same bits. The upper
triangles of frontal matrices are never referenced (POTRF and TRSM read
the lower triangle; Schur updates are tril-masked), matching the host
plan's lower-triangle discipline: frontal matrices are never
symmetrized.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .sparse_chol import SparseCholesky


def _pad8(x: int) -> int:
    return max(8, -(-x // 8) * 8)


class _SegmentSum:
    """out[t] = sum of the contributions with target t, in a fixed order
    and without atomics.

    Built on the host from the target of every contribution; contribution
    i reads `src[source[i]]` (`source` defaults to i). Targets are grouped
    by their number of contributions (next power of two), and each group
    is one padded gather `src[pos]` summed along its rows; a padded slot
    reads `src[zero]`, which the caller keeps at zero. Within a target the
    contributions are summed in the order they were given.
    """

    def __init__(self, target: np.ndarray, zero: int, device, source=None):
        target = np.asarray(target, dtype=np.int64)
        src_of = (np.arange(target.size, dtype=np.int64) if source is None
                  else np.asarray(source, dtype=np.int64))
        order = np.argsort(target, kind="stable")
        uniq, start, counts = np.unique(target[order], return_index=True,
                                        return_counts=True)
        self.groups = []
        cls = np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64)
        for c in np.unique(cls):
            sel = np.flatnonzero(cls == c)
            width = int(counts[sel].max())
            slot = np.arange(width)
            valid = slot[None, :] < counts[sel][:, None]
            pos = np.full((sel.size, width), zero, dtype=np.int64)
            pos[valid] = src_of[order[(start[sel][:, None] + slot[None, :])[valid]]]
            self.groups.append((torch.as_tensor(uniq[sel], device=device),
                                torch.as_tensor(pos, device=device)))

    def set_into(self, out: torch.Tensor, src: torch.Tensor) -> None:
        for t, pos in self.groups:
            out[t] = src[pos].sum(dim=1)

    def add_into(self, out: torch.Tensor, src: torch.Tensor, alpha: float = 1.0) -> None:
        for t, pos in self.groups:
            out[t] = out[t] + alpha * src[pos].sum(dim=1)


class DeviceSparseCholesky:
    """Compile a SparseCholesky symbolic plan into device index maps.

    Usage:
        plan = SparseCholesky(S_pattern)
        dev = DeviceSparseCholesky(plan, dtype=torch.float32, device="cuda")
        factors, ok = dev.factor(data)    # data: plan-permuted S values
        x = dev.solve(factors, rhs)

    `data` is the value array aligned with the plan's permuted pattern
    (what SparseCholesky._permuted_data produces); see
    NormalEquationsDevice below for computing it on the device from G and d.
    """

    def __init__(self, plan: SparseCholesky, dtype=torch.float32, device="cuda"):
        dev = resolve_device(device)
        self.plan = plan
        self.dtype = dtype
        self.device = dev
        self.n = plan.n
        ns = len(plan.sn_rows)
        sn_start = plan.sn_start
        widths = np.diff(sn_start)
        nrs = np.array([r.size for r in plan.sn_rows], dtype=np.int64)
        nus = nrs - widths

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

        # --- levels: longest path from leaves in the supernode etree ---
        level = np.zeros(ns, dtype=np.int64)
        for s in range(ns):  # children come before parents (postorder)
            p = plan.sn_parent[s]
            if p >= 0:
                level[p] = max(level[p], level[s] + 1)
        nlev = int(level.max()) + 1 if ns else 0

        # --- update pool offsets (one flat vector on the device, with a
        # trailing zero slot that padded gathers read) ---
        upool_off = np.zeros(ns + 1, dtype=np.int64)
        upool_off[1:] = np.cumsum(nus * nus)
        self.upool_size = int(upool_off[-1])

        data_len = plan._A_pattern.indices.size
        # schedule[l] = list of buckets of common padded shape
        self.schedule = []
        for lv in range(nlev):
            sns = np.flatnonzero(level == lv)
            keys = {}
            for s in sns:
                # pivot block and below block pad independently: padded
                # front layout is [0:w_p) pivot rows, [w_p:w_p+nu_p)
                # below rows
                w_p = _pad8(int(widths[s]))
                nu_p = _pad8(int(nus[s])) if nus[s] > 0 else 0
                keys.setdefault((w_p + nu_p, w_p), []).append(int(s))
            buckets = []
            for (nr_p, w_p), members in sorted(keys.items()):
                B = len(members)
                nu_p = nr_p - w_p
                # assembly: data[di] added at flat front positions;
                # extend-add: upool[src] added at flat front positions
                a_idx, a_src, e_idx, e_src = [], [], [], []
                for slot, s in enumerate(members):
                    w = int(widths[s])
                    nr = int(nrs[s])
                    base = slot * nr_p * nr_p

                    def remap(r, w=w, w_p=w_p):
                        return np.where(r < w, r, w_p + (r - w))

                    flat, di = plan.assemble[s]
                    # flat positions are row*nr + col in the UNPADDED
                    # front; remap both coordinates to the padded layout
                    rr, cc = flat // nr, flat % nr
                    a_idx.append(base + remap(rr) * nr_p + remap(cc))
                    a_src.append(di)
                    for c in plan.children[s]:
                        if nus[c] == 0:
                            continue
                        em = plan.extend_maps[c]
                        rr, cc = em // nr, em % nr
                        e_idx.append(base + remap(rr) * nr_p + remap(cc))
                        e_src.append(np.arange(upool_off[c], upool_off[c + 1]))
                # update-pool write positions for this bucket's fronts:
                # the U tile is (nu_p, nu_p) at [w_p:, w_p:]; its real part
                # is the top-left (nu, nu)
                u_dst, u_keep = [], []
                for slot, s in enumerate(members):
                    nu = int(nus[s])
                    if nu == 0:
                        continue
                    rr = np.repeat(np.arange(nu), nu)
                    cc = np.tile(np.arange(nu), nu)
                    u_keep.append(slot * nu_p * nu_p + rr * nu_p + cc)
                    u_dst.append(np.arange(upool_off[s], upool_off[s + 1]))
                # solve maps: x-block gather/scatter indices (padded slots
                # read and write the dummy entry n, kept at zero)
                xb_idx = np.full((B, w_p), self.n, dtype=np.int64)
                xr_idx = np.full((B, nu_p), self.n, dtype=np.int64)
                for slot, s in enumerate(members):
                    w = int(widths[s])
                    xb_idx[slot, :w] = np.arange(sn_start[s], sn_start[s + 1])
                    nu = int(nus[s])
                    if nu:
                        xr_idx[slot, :nu] = plan.sn_rows[s][w:]
                # the forward solve's update of the below rows: several
                # fronts of a bucket can share an ancestor row
                real = np.flatnonzero(xr_idx.ravel() != self.n)
                cat = (lambda parts: np.concatenate(parts) if parts
                       else np.zeros(0, np.int64))
                a_idx, a_src, e_idx, e_src = map(cat, (a_idx, a_src, e_idx, e_src))
                buckets.append(dict(
                    nr_p=nr_p, w_p=w_p, B=B,
                    # assembly from data and extend-add from the update
                    # pool, each a fixed-order sum into F's positions
                    assemble=_SegmentSum(a_idx, data_len, dev, a_src)
                    if a_idx.size else None,
                    extend=_SegmentSum(e_idx, self.upool_size, dev, e_src)
                    if e_idx.size else None,
                    u_keep=t(cat(u_keep)) if u_keep else None,
                    u_dst=t(cat(u_dst)) if u_dst else None,
                    pad_eye=torch.as_tensor(self._pad_eye(members, widths, w_p),
                                            dtype=dtype, device=dev),
                    xb_idx=t(xb_idx),
                    xr_idx=t(xr_idx),
                    # reads the bucket's (B * nu_p) contributions and a
                    # trailing zero
                    xr_update=_SegmentSum(xr_idx.ravel()[real], B * nu_p, dev, real)
                    if real.size else None,
                ))
            self.schedule.append(buckets)
        self._data_len = data_len
        self.perm = t(plan.perm)
        self.iperm = t(plan.iperm)

    @staticmethod
    def _pad_eye(members, widths, w_p):
        B = len(members)
        eye = np.zeros((B, w_p, w_p))
        for slot, s in enumerate(members):
            for k in range(int(widths[s]), w_p):
                eye[slot, k, k] = 1.0
        return eye

    def buckets(self):
        for buckets in self.schedule:
            yield from buckets

    # -- numeric ----------------------------------------------------------

    def factor(self, data: torch.Tensor, shift: float = 0.0):
        """data: plan-permuted S values (length = plan pattern nnz).

        Returns (factors, ok): factors is a list of per-bucket panels
        [(B, nr_p, w_p) tensors in schedule order]; ok is a 0-dim bool
        tensor (False when any pivot block lost positive-definiteness),
        left on the device for the caller to read.
        """
        dt, dev = self.dtype, self.device
        zero = torch.zeros(1, dtype=dt, device=dev)
        data = torch.cat([data.to(device=dev, dtype=dt), zero])
        upool = torch.zeros(self.upool_size + 1, dtype=dt, device=dev)
        factors = []
        ok = torch.ones((), dtype=torch.bool, device=dev)
        for bk in self.buckets():
            B, nr_p, w_p = bk["B"], bk["nr_p"], bk["w_p"]
            F = torch.zeros(B * nr_p * nr_p, dtype=dt, device=dev)
            if bk["assemble"] is not None:
                bk["assemble"].set_into(F, data)
            if bk["extend"] is not None:
                bk["extend"].add_into(F, upool)
            F = F.view(B, nr_p, nr_p)
            F11 = F[:, :w_p, :w_p] + bk["pad_eye"]
            if shift != 0.0:
                F11 = F11 + shift * torch.eye(w_p, dtype=dt, device=dev)
            # the lower triangle only: frontal matrices carry no upper half
            L11, info = torch.linalg.cholesky_ex(F11)
            bad = info > 0
            ok = ok & ~bad.any() & torch.isfinite(L11).all()
            # a failed front's factor is zeroed, as XLA's NaN factor is
            L11 = torch.where(bad[:, None, None] | ~torch.isfinite(L11), 0.0, L11)
            nu_p = nr_p - w_p
            if nu_p > 0:
                # L21 = F21 L11^-T  (X L11' = F21)
                L21 = torch.linalg.solve_triangular(
                    L11.mT, F[:, w_p:, :w_p], upper=True, left=False)
                U = torch.tril(F[:, w_p:, w_p:] - torch.bmm(L21, L21.mT))
                if bk["u_dst"] is not None:
                    upool[bk["u_dst"]] = U.reshape(-1)[bk["u_keep"]]
                panel = torch.cat([L11, L21], dim=1)
            else:
                panel = L11
            factors.append(panel)
        return factors, ok

    def solve(self, factors, rhs: torch.Tensor) -> torch.Tensor:
        """Supernodal forward/backward substitution on the device."""
        dt, n = self.dtype, self.n
        x = torch.cat([rhs.to(dt)[self.perm], torch.zeros(1, dtype=dt, device=self.device)])
        flat = list(zip(self.buckets(), factors))
        # forward: L y = b, level order
        for bk, panel in flat:
            w_p = bk["w_p"]
            yb = torch.linalg.solve_triangular(
                panel[:, :w_p, :], x[bk["xb_idx"]][..., None], upper=False)[..., 0]
            x[bk["xb_idx"]] = yb
            x[n] = 0.0  # the dummy stays clean
            if bk["xr_update"] is not None:
                contrib = torch.bmm(panel[:, w_p:, :], yb[..., None]).reshape(-1)
                bk["xr_update"].add_into(x, torch.cat([contrib, contrib.new_zeros(1)]),
                                         alpha=-1.0)
        # backward: L' x = y, reverse level order
        for bk, panel in reversed(flat):
            w_p = bk["w_p"]
            tb = x[bk["xb_idx"]]
            if panel.shape[1] > w_p:
                below = x[bk["xr_idx"]]
                tb = tb - torch.bmm(panel[:, w_p:, :].mT, below[..., None])[..., 0]
            xb = torch.linalg.solve_triangular(
                panel[:, :w_p, :].mT, tb[..., None], upper=True)[..., 0]
            x[bk["xb_idx"]] = xb
            x[n] = 0.0
        return x[:n][self.iperm]


class NormalEquationsDevice:
    """Device computation of the permuted values of S = G D G' + reg I
    for a FIXED pattern, as one fixed-order segment sum (no host assembly).

    For every stored entry e = (i, j) of the plan pattern, the value is
      sum_k G[i, k] * G[j, k] * d[k]  (+ reg on the diagonal).
    The contributing (k, G_ik * G_jk) pairs are enumerated once on the
    host; per iteration the device does w * d[kidx] and the segment sum.
    """

    def __init__(self, G_sp, plan: SparseCholesky, reg: float, device="cuda"):
        import scipy.sparse as sp

        dev = resolve_device(device)
        P = plan._A_pattern  # permuted pattern, canonical order
        n = plan.n
        Gr = sp.csr_matrix(G_sp)
        Gr.sort_indices()
        # permuted row i of S corresponds to original row perm[i]
        perm = plan.perm
        rows = [Gr.indices[Gr.indptr[r]:Gr.indptr[r + 1]] for r in range(n)]
        vals = [Gr.data[Gr.indptr[r]:Gr.indptr[r + 1]] for r in range(n)]
        seg_e, seg_k, seg_w = [], [], []
        diag_e = np.zeros(n, dtype=np.int64)
        for j in range(n):  # permuted column j
            oj = perm[j]
            for p in range(P.indptr[j], P.indptr[j + 1]):
                i = int(P.indices[p])
                oi = perm[i]
                if i == j:
                    diag_e[j] = p
                # sparse row intersection
                ra, rb = rows[oi], rows[oj]
                va, vb = vals[oi], vals[oj]
                pos = np.searchsorted(ra, rb)
                ok = pos < ra.size
                okk = np.zeros(rb.size, dtype=bool)
                okk[ok] = ra[pos[ok]] == rb[ok]
                if okk.any():
                    ks = rb[okk]
                    seg_e.append(np.full(ks.size, p, dtype=np.int64))
                    seg_k.append(ks.astype(np.int64))
                    seg_w.append(va[pos[okk]] * vb[okk])
        seg_e = np.concatenate(seg_e)
        self.nnzP = P.indices.size
        self.device = dev
        self.seg_k = torch.as_tensor(np.concatenate(seg_k), device=dev)
        self.seg_w = torch.as_tensor(np.concatenate(seg_w), device=dev)
        self.segsum = _SegmentSum(seg_e, seg_e.size, dev)  # reads a trailing zero
        self.diag_e = torch.as_tensor(diag_e, device=dev)
        self.reg = reg
        # per-entry (row, col) for symmetric Jacobi scaling of the values
        ecol = np.empty(P.indices.size, dtype=np.int64)
        for j in range(n):
            ecol[P.indptr[j]:P.indptr[j + 1]] = j
        self.entry_row = torch.as_tensor(P.indices.astype(np.int64), device=dev)
        self.entry_col = torch.as_tensor(ecol, device=dev)

    def values(self, d: torch.Tensor) -> torch.Tensor:
        contrib = self.seg_w.to(d.dtype) * d[self.seg_k]
        out = torch.zeros(self.nnzP, dtype=d.dtype, device=d.device)
        self.segsum.set_into(out, torch.cat([contrib, contrib.new_zeros(1)]))
        out[self.diag_e] += self.reg
        return out


def make_device_normal_solver(G_sp, reg: float,
                              max_density: float = 0.08,
                              min_flop_win: float = 4.0,
                              dtype=torch.float32, device="cuda"):
    """Device analogue of sparse_chol.make_normal_solver.

    Returns a DeviceNormalSolver computing (G diag(d) G' + reg)^{-1} rhs
    through the device multifrontal factor, or None when the pattern does
    not qualify (the host version's gates; dense columns are NOT split
    here — callers with arrow structures keep the host Woodbury path).
    """
    import scipy.sparse as sp

    m = G_sp.shape[0]
    if m < 512:
        return None
    Gc = sp.csc_matrix(G_sp)
    col_nnz = np.diff(Gc.indptr)
    if (col_nnz > 0.1 * m).any():
        return None  # dense columns: the host Woodbury path handles these
    Gp = sp.csr_matrix(G_sp, copy=True)
    Gp.data[:] = 1.0
    S_pat = (Gp @ Gp.T + sp.eye(m, format="csr")).tocsc()
    if S_pat.nnz > max_density * m * m:
        return None
    plan = SparseCholesky(S_pat)
    if plan.flops * min_flop_win > m ** 3 / 3.0:
        return None
    return DeviceNormalSolver(G_sp, plan, reg, dtype, device)


class DeviceNormalSolver:
    """(d, rhs) -> (G D G' + reg)^{-1} rhs, all on the device."""

    def __init__(self, G_sp, plan, reg, dtype=torch.float32, device="cuda"):
        self.plan = plan
        self.dev = DeviceSparseCholesky(plan, dtype=dtype, device=device)
        self.neq = NormalEquationsDevice(G_sp, plan, reg, device=device)

    def factor(self, d: torch.Tensor, shift: float = 0.0):
        """Returns ((factors, jacobi_scale), ok), ok a 0-dim device bool.

        The values are symmetrically Jacobi-scaled before the factor:
        S_hat = Ds^{-1/2} S Ds^{-1/2} with Ds = diag(S). The IPM's
        ill-conditioning is largely diagonal (D spans ~1e+-8 late), so
        scaling keeps kappa(S_hat) within what an f32 factor + f64
        refinement can recover."""
        vals = self.neq.values(d)
        s = torch.rsqrt(torch.clamp(vals[self.neq.diag_e], min=1e-300))
        vals_s = vals * s[self.neq.entry_row] * s[self.neq.entry_col]
        factors, ok = self.dev.factor(vals_s, shift=shift)
        return (factors, s), ok

    def factor_shifted(self, d: torch.Tensor, shift: float):
        return self.factor(d, shift=shift)

    def solve_with(self, fstate, rhs: torch.Tensor) -> torch.Tensor:
        factors, s = fstate
        # s is indexed in PLAN (permuted) order; rhs/x are in original
        # order — un-permute the scale before applying
        su = s[self.dev.iperm]
        x = self.dev.solve(factors, (su * rhs).to(self.dev.dtype))
        return su * x.to(rhs.dtype)

    def solve(self, d: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        fstate, _ok = self.factor(d)
        return self.solve_with(fstate, rhs)
