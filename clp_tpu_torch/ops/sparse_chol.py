"""General sparse Cholesky: fill-reducing ordering + supernodal
multifrontal numeric factorization built from dense tiles.

The port's own copy of the JAX package's host module (numpy and scipy
only). The reference's sparse-Cholesky capability lives in ClpCholeskyBase:
ordering (ClpCholeskyBase.cpp:638 order / :792 orderAMD), symbolic
(:1982), numeric with a dense trailing window switch (:3640).  This
module keeps the same three-phase shape but the numeric phase is
MULTIFRONTAL: every supernode's work is a dense partial Cholesky +
triangular solve + SYRK on a frontal matrix — the operation mix that
ops/sparse_chol_device.py batches on the card (on the host these are
BLAS calls).

Phases:
  1. `minimum_degree` — our own elimination-graph minimum-degree ordering
     with element absorption (quotient-graph style storage so cliques are
     never materialized as edges).
  2. `SparseCholesky.__init__` — symbolic: elimination tree, postorder,
     per-column structure, fundamental supernodes, and the child->parent
     extend-add index maps.  Runs ONCE per sparsity pattern; the barrier
     re-uses the plan every IPM iteration.
  3. `SparseCholesky.factor` — numeric multifrontal in O(fill) flops with
     dense-tile inner kernels; `solve` does the supernodal forward/back
     substitution.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def minimum_degree(S: sp.spmatrix, dense_cutoff: float = 0.5) -> np.ndarray:
    """Elimination-graph minimum degree ordering of a symmetric pattern.

    Quotient-graph storage: each uneliminated node carries plain neighbors
    plus membership in "elements" (the cliques created by eliminations);
    eliminating v creates one element reach(v) and absorbs v's elements
    (ClpCholeskyBase::orderAMD role, ClpCholeskyBase.cpp:792).  Nodes whose
    degree exceeds dense_cutoff * remaining are deferred to the end (the
    reference's dense-window idea applied to the ordering).
    """
    n = S.shape[0]
    C = sp.csr_matrix(S)
    C = C + C.T
    adj = [set(C.indices[C.indptr[i]:C.indptr[i + 1]].tolist()) - {i}
           for i in range(n)]
    elems_of = [set() for _ in range(n)]  # elements each node belongs to
    elem_nodes: dict[int, set] = {}  # element id -> live nodes
    alive = np.ones(n, dtype=bool)
    perm = np.empty(n, dtype=np.int64)
    import heapq

    def reach(v):
        r = set(adj[v])
        for e in elems_of[v]:
            r |= elem_nodes[e]
        r.discard(v)
        return r

    heap = [(len(adj[v]), v) for v in range(n)]
    heapq.heapify(heap)
    deg = np.array([len(adj[v]) for v in range(n)], dtype=np.int64)
    k = 0
    next_elem = 0
    deferred = []
    remaining = n
    while heap and k < n:
        d, v = heapq.heappop(heap)
        if not alive[v] or d != deg[v]:
            continue
        r = reach(v)
        if len(r) > dense_cutoff * remaining and remaining > 32:
            deferred.append(v)
            alive[v] = False
            remaining -= 1
            continue
        perm[k] = v
        k += 1
        alive[v] = False
        remaining -= 1
        # new element = reach(v); absorb v's old elements
        e_id = next_elem
        next_elem += 1
        live = {u for u in r if alive[u]}
        elem_nodes[e_id] = live
        dead_elems = elems_of[v]
        for u in live:
            adj[u].discard(v)
            adj[u] -= live  # clique edges are implied by the element
            elems_of[u] -= dead_elems
            elems_of[u].add(e_id)
        for e in dead_elems:
            elem_nodes.pop(e, None)
        adj[v] = set()
        elems_of[v] = set()
        for u in live:
            nd = len(adj[u])
            for e in elems_of[u]:
                nd += len(elem_nodes[e]) - 1
            if nd != deg[u]:
                deg[u] = nd
                heapq.heappush(heap, (nd, u))
    for v in deferred:  # dense tail: any order (it factors as one window)
        perm[k] = v
        k += 1
    if k != n:
        raise RuntimeError(f"minimum_degree ordered {k} of {n} nodes")
    return perm


class SparseCholesky:
    """Symbolic plan + supernodal multifrontal numeric for SPD matrices
    with a FIXED pattern and changing values (the normal-equations case).
    """

    def __init__(self, S: sp.spmatrix, perm: np.ndarray | None = None,
                 relax: int = 8):
        n = S.shape[0]
        pat = sp.csc_matrix(S, copy=True)
        pat.data[:] = 1.0
        pat = (pat + pat.T).tocsc()
        if perm is None:
            perm = minimum_degree(pat)
        self.perm = np.asarray(perm, dtype=np.int64)
        self.iperm = np.empty(n, dtype=np.int64)
        self.iperm[self.perm] = np.arange(n)
        A = pat[self.perm][:, self.perm].tocsc()
        A.sort_indices()  # searchsorted-based maps need canonical order
        self.n = n

        def _symbolic(Am):
            """Elimination tree + below-diagonal row lists (up-looking)."""
            parent = np.full(n, -1, dtype=np.int64)
            col_rows = [[] for _ in range(n)]
            flag = np.full(n, -1, dtype=np.int64)
            indptr, indices = Am.indptr, Am.indices
            for i in range(n):
                flag[i] = i
                for p in range(indptr[i], indptr[i + 1]):
                    j = int(indices[p])
                    if j >= i:
                        continue
                    while flag[j] != i:
                        if parent[j] == -1:
                            parent[j] = i
                        flag[j] = i
                        col_rows[j].append(i)
                        j = int(parent[j])
            return parent, col_rows

        parent, col_rows = _symbolic(A)
        # postorder the etree: fill is invariant, but parent chains become
        # column-adjacent — the prerequisite for supernodes to amalgamate
        # into large dense tiles (the standard pipeline step between the
        # fill-reducing ordering and the supernode partition)
        kids: list[list[int]] = [[] for _ in range(n + 1)]
        for j in range(n):
            kids[parent[j] if parent[j] >= 0 else n].append(j)
        post = np.empty(n, dtype=np.int64)
        k_post = 0
        for root in kids[n]:
            stack = [(root, 0)]
            while stack:
                v, ci = stack.pop()
                if ci < len(kids[v]):
                    stack.append((v, ci + 1))
                    stack.append((kids[v][ci], 0))
                else:
                    post[k_post] = v
                    k_post += 1
        assert k_post == n
        if not np.array_equal(post, np.arange(n)):
            self.perm = self.perm[post]
            self.iperm[self.perm] = np.arange(n)
            A = pat[self.perm][:, self.perm].tocsc()
            A.sort_indices()
            parent, col_rows = _symbolic(A)
        self.parent = parent
        col_struct = [np.array(sorted(r), dtype=np.int64) for r in col_rows]
        counts = np.array([1 + len(r) for r in col_rows], dtype=np.int64)
        self.nnz_L = int(counts.sum())
        # flop estimate: sum of count(j)^2 (partial cholesky column work)
        self.flops = float(np.sum(counts.astype(float) ** 2))

        # --- supernodes: fundamental, then relaxed amalgamation ---
        sn_start = [0]
        for j in range(1, n):
            fund = (parent[j - 1] == j and counts[j - 1] == counts[j] + 1)
            if not fund:
                sn_start.append(j)
        sn_start.append(n)

        def rows_of(j0, j1):
            below = set()
            for j in range(j0, j1):
                below.update(int(r) for r in col_struct[j] if r >= j1)
            return np.concatenate([
                np.arange(j0, j1, dtype=np.int64),
                np.array(sorted(below), dtype=np.int64),
            ])

        sn_rows = [rows_of(sn_start[s], sn_start[s + 1])
                   for s in range(len(sn_start) - 1)]

        # relaxed amalgamation (CHOLMOD-style): merge a supernode with its
        # column-adjacent etree parent while the explicit-zero fraction of
        # the merged panel stays small.  Tiny dense tiles are dominated by
        # per-call overhead, not flops — fewer, larger POTRF/TRSM/SYRK
        # tiles are the multifrontal speed lever (and the tile-shape lever
        # on device).
        changed = True
        while changed:
            changed = False
            s = len(sn_rows) - 2
            while s >= 0:
                j0, j1 = sn_start[s], sn_start[s + 1]
                w_s = j1 - j0
                rows_s = sn_rows[s]
                # parent must be the NEXT supernode (column adjacency) and
                # the etree parent of s's first below row
                if rows_s.size > w_s and rows_s[w_s] == j1:
                    j2 = sn_start[s + 2]
                    w_p = j2 - j1
                    rows_p = sn_rows[s + 1]
                    union = np.union1d(rows_s, rows_p)
                    nr_new = union.size
                    old = rows_s.size * w_s + rows_p.size * w_p
                    new = nr_new * (w_s + w_p)
                    zfrac = 1.0 - old / max(new, 1)
                    small = w_s + w_p <= max(relax, 2)
                    if small or zfrac < 0.25 or (
                            w_s <= 8 and zfrac < 0.4):
                        sn_start.pop(s + 1)
                        sn_rows[s] = union
                        sn_rows.pop(s + 1)
                        changed = True
                s -= 1
        self.sn_start = np.array(sn_start, dtype=np.int64)
        ns = len(sn_start) - 1
        self.sn_rows = sn_rows
        self.sn_of_col = np.empty(n, dtype=np.int64)
        for s in range(ns):
            self.sn_of_col[sn_start[s]:sn_start[s + 1]] = s
        # supernode etree: parent supernode = supernode of first below row
        self.sn_parent = np.full(ns, -1, dtype=np.int64)
        for s in range(ns):
            j1 = sn_start[s + 1]
            rows = self.sn_rows[s]
            if rows.size > j1 - sn_start[s]:
                self.sn_parent[s] = self.sn_of_col[rows[j1 - sn_start[s]]]
        # extend-add maps: child's update rows located in parent's rows,
        # precomputed as FLAT positions into the parent's frontal buffer
        # (one fancy-index add, no np.ix_ grids in the hot loop)
        self.extend_maps: list[np.ndarray | None] = [None] * ns
        for s in range(ns):
            p = self.sn_parent[s]
            if p < 0:
                continue
            upd_rows = self.sn_rows[s][self.sn_start[s + 1] - self.sn_start[s]:]
            prow = self.sn_rows[p]
            pos = np.searchsorted(prow, upd_rows)
            assert np.all(prow[pos] == upd_rows), "extend-add map broken"
            self.extend_maps[s] = (pos[:, None] * prow.size + pos).ravel()
        # assembly maps: original A entries (permuted) into frontal slots,
        # SYMMETRIC (both triangles) so frontal matrices stay symmetric
        # end-to-end and no mirroring copies are needed in the hot loop.
        # Stored per supernode as flat positions row_pos * nr + col_off.
        # LOWER-triangle discipline end to end: POTRF/TRSM read the lower
        # triangle only and SYRK (BLAS dsyrk) writes it only, so upper
        # halves are never touched — half the update flops, zero
        # symmetrization copies
        Ac = A
        self.assemble: list[tuple[np.ndarray, np.ndarray]] = []
        for s in range(ns):
            j0, j1 = sn_start[s], sn_start[s + 1]
            rows = self.sn_rows[s]
            nr = rows.size
            flat, ds = [], []
            for j in range(j0, j1):
                lo_, hi_ = Ac.indptr[j], Ac.indptr[j + 1]
                rr = Ac.indices[lo_:hi_]
                keep = rr >= j  # lower triangle of the frame only
                rr = rr[keep]
                pos = np.searchsorted(rows, rr)
                flat.append(pos * nr + (j - j0))
                ds.append(np.arange(lo_, hi_, dtype=np.int64)[keep])
            self.assemble.append((
                np.concatenate(flat) if flat else np.zeros(0, np.int64),
                np.concatenate(ds) if ds else np.zeros(0, np.int64),
            ))
        # children grouped once (avoids an O(ns) scan per supernode)
        self.children: list[list[int]] = [[] for _ in range(ns)]
        for s in range(ns):
            if self.sn_parent[s] >= 0:
                self.children[self.sn_parent[s]].append(s)
        self._A_pattern = A  # indptr/indices define the data layout
        self._data_map: np.ndarray | None = None  # input-CSC -> plan order
        self._data_sig: tuple | None = None
        self._factors: list[np.ndarray] | None = None

    # -- numeric ---------------------------------------------------------

    def _permuted_data(self, S: sp.spmatrix) -> np.ndarray:
        """Values of S aligned with the stored permuted pattern.

        The scatter map from the INPUT matrix's CSC layout to the plan's
        permuted layout is computed once and reused while the input
        pattern signature (shape, nnz) is unchanged — the IPM re-factors
        the same pattern with new values every iteration.
        """
        Sc = sp.csc_matrix(S)
        sig = (Sc.shape, Sc.nnz, int(Sc.indices[0]) if Sc.nnz else -1,
               int(Sc.indices[-1]) if Sc.nnz else -1)
        P = self._A_pattern
        if self._data_map is None or self._data_sig != sig:
            Sp = Sc[self.perm][:, self.perm].tocsc()
            Sp.sort_indices()
            # positions of Sp entries inside the plan pattern
            plan_pos = np.empty(Sp.indices.size, dtype=np.int64)
            for j in range(self.n):
                lo_, hi_ = Sp.indptr[j], Sp.indptr[j + 1]
                if lo_ == hi_:
                    continue
                plan_pos[lo_:hi_] = np.searchsorted(
                    P.indices[P.indptr[j]:P.indptr[j + 1]],
                    Sp.indices[lo_:hi_]) + P.indptr[j]
            # Sp.data is a permutation/subset of Sc.data: recover the map
            # by permuting a tagged copy of the input values
            tag = sp.csc_matrix(
                (np.arange(Sc.nnz, dtype=np.float64) + 1.0,
                 Sc.indices.copy(), Sc.indptr.copy()), shape=Sc.shape)
            tagp = tag[self.perm][:, self.perm].tocsc()
            tagp.sort_indices()
            src = tagp.data.astype(np.int64) - 1
            scatter = np.full(P.indices.size, -1, dtype=np.int64)
            scatter[plan_pos] = src
            self._data_map = scatter
            self._data_sig = sig
        out = np.zeros(P.indices.size)
        ok = self._data_map >= 0
        out[ok] = Sc.data[self._data_map[ok]]
        return out

    def factor(self, S: sp.spmatrix, shift: float = 0.0) -> bool:
        """Multifrontal numeric factorization; True on success.

        Dense tile work per supernode: partial Cholesky (POTRF) on the
        pivot block, triangular solve (TRSM) for the subdiagonal panel,
        SYRK for the Schur update passed to the parent.
        """
        import scipy.linalg as sla
        from scipy.linalg.blas import dsyrk

        data = self._permuted_data(S)
        ns = len(self.sn_rows)
        updates: list[np.ndarray | None] = [None] * ns
        factors: list[np.ndarray] = [np.zeros((0, 0))] * ns
        for s in range(ns):
            j0, j1 = int(self.sn_start[s]), int(self.sn_start[s + 1])
            w = j1 - j0
            rows = self.sn_rows[s]
            nr = rows.size
            F = np.zeros((nr, nr))
            Fr = F.ravel()
            flat, di = self.assemble[s]
            Fr[flat] = data[di]  # lower triangle of the frame
            if shift:
                Fr[(nr + 1) * np.arange(w)] += shift
            for c in self.children[s]:
                U = updates[c]
                if U is None:
                    continue
                # U's upper half is zeros (dsyrk lower): adding the full
                # block only touches the authoritative lower triangle
                Fr[self.extend_maps[c]] += U.ravel()
                updates[c] = None
            try:
                L11 = sla.cholesky(F[:w, :w], lower=True,
                                   check_finite=False)
            except sla.LinAlgError:
                self._factors = None
                return False
            panel = np.empty((nr, w))
            panel[:w] = L11
            if nr > w:
                # L21' = L11^{-1} F21' (F21.T is an F-order view: no copy)
                L21t = sla.solve_triangular(
                    L11, F[w:, :w].T, lower=True, check_finite=False)
                panel[w:] = L21t.T
                # Schur update, lower triangle only (true SYRK flops);
                # F22's upper half is already all zeros by the lower-only
                # discipline, so a plain copy keeps the invariant
                U = F[w:, w:].copy(order="F")
                updates[s] = dsyrk(-1.0, L21t, beta=1.0, c=U, trans=1,
                                   lower=1, overwrite_c=1)
            factors[s] = panel
        self._factors = factors
        return True

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        """Supernodal forward/backward substitution (permuted internally)."""
        assert self._factors is not None, "factor() first"
        import scipy.linalg as sla

        x = np.asarray(rhs, dtype=float)[self.perm].copy()
        ns = len(self.sn_rows)
        for s in range(ns):
            j0, j1 = int(self.sn_start[s]), int(self.sn_start[s + 1])
            w = j1 - j0
            P = self._factors[s]
            rows = self.sn_rows[s]
            x[j0:j1] = sla.solve_triangular(P[:w], x[j0:j1], lower=True,
                                            check_finite=False)
            if rows.size > w:
                x[rows[w:]] -= P[w:] @ x[j0:j1]
        for s in range(ns - 1, -1, -1):
            j0, j1 = int(self.sn_start[s]), int(self.sn_start[s + 1])
            w = j1 - j0
            P = self._factors[s]
            rows = self.sn_rows[s]
            t = x[j0:j1]
            if rows.size > w:
                t = t - P[w:].T @ x[rows[w:]]
            x[j0:j1] = sla.solve_triangular(P[:w], t, lower=True, trans=1,
                                            check_finite=False)
        return x[self.iperm]


def make_normal_solver(G_sp: sp.spmatrix, reg: float,
                       max_density: float = 0.08,
                       min_flop_win: float = 4.0,
                       dense_col_frac: float = 0.1,
                       max_dense_cols: int = 64):
    """Build the barrier's sparse normal-equations solver, or None.

    Returns a host callable (d, rhs) -> dy on numpy arrays solving
    (G diag(d) G' + reg) dy = rhs with the supernodal multifrontal plan
    (IPMOptions.sparse_chol).  Declines (returns None) when the pattern of
    G G' is too dense or the predicted factor flops don't beat the dense
    O(m^3/3) by `min_flop_win` — the dense Cholesky is the right kernel
    then (the same dense/sparse decision
    ClpCholeskyBase makes with its dense-window switch, :3640).

    DENSE COLUMNS (the reference's denseColumn treatment): a handful of
    columns touching > dense_col_frac of the rows would densify G G'
    catastrophically (arrow/linking structure).  They are split out:
    S = S_sparse + U diag(d_U) U', the sparse part gets the multifrontal
    plan, and solves go through the Woodbury identity with a small
    (k x k) capacitance factor.
    """
    m = G_sp.shape[0]
    if m < 512:
        return None
    Gc = sp.csc_matrix(G_sp)
    col_nnz = np.diff(Gc.indptr)
    dense_cols = np.flatnonzero(col_nnz > dense_col_frac * m)
    U = None
    if dense_cols.size:
        if dense_cols.size > max_dense_cols:
            return None  # too many coupling columns: dense is right
        keep = np.ones(Gc.shape[1], dtype=bool)
        keep[dense_cols] = False
        U = np.asarray(Gc[:, dense_cols].todense())
        G_use = Gc[:, keep].tocsr()
        keep_idx = np.flatnonzero(keep)
    else:
        G_use = sp.csr_matrix(G_sp)
        keep_idx = None
    Gp = sp.csr_matrix(G_use, copy=True)
    Gp.data[:] = 1.0
    S_pat = (Gp @ Gp.T + sp.eye(m, format="csr")).tocsc()
    if S_pat.nnz > max_density * m * m:
        return None
    plan = SparseCholesky(S_pat)
    dense_flops = m ** 3 / 3.0
    if plan.flops * min_flop_win > dense_flops:
        return None
    reg_eye = reg * sp.eye(m, format="csr")
    scale = 1.0 + float(np.max(np.abs(G_sp.data), initial=0.0)) ** 2
    state: dict = {"key": None, "cap": None, "W": None}

    def solver(d, rhs):
        d = np.asarray(d, dtype=np.float64)
        rhs = np.asarray(rhs, dtype=np.float64)
        key = d.tobytes()
        if state["key"] != key:
            d_sp = d[keep_idx] if keep_idx is not None else d
            Sd = ((G_use.multiply(d_sp) @ G_use.T) + reg_eye).tocsc()
            shift = 0.0
            while not plan.factor(Sd, shift=shift):
                shift = 1e-10 * scale if shift == 0.0 else shift * 100.0
                if shift > scale:
                    # hopeless: return a Jacobi-ish fallback direction
                    state["key"] = None
                    diag = np.maximum(Sd.diagonal(), 1e-30)
                    return rhs / diag
            if U is not None:
                # Woodbury capacitance: C = I + V' S_sp^{-1} V with
                # V = U sqrt(d_U); W = S_sp^{-1} V solved column-wise on
                # the fresh factor
                V = U * np.sqrt(np.maximum(d[dense_cols], 0.0))
                W = np.stack([plan.solve(V[:, j])
                              for j in range(V.shape[1])], axis=1)
                C = np.eye(V.shape[1]) + V.T @ W
                import scipy.linalg as sla

                state["cap"] = (sla.cho_factor(C), V, W)
            state["key"] = key
        x = plan.solve(rhs)
        if U is not None:
            import scipy.linalg as sla

            cf, V, W = state["cap"]
            x = x - W @ sla.cho_solve(cf, V.T @ x)
        return x

    solver.plan = plan  # introspection for tests/telemetry
    return solver
