"""Host-side sparse system: the exact reference discretization, assembled
with NumPy and solved with a scipy direct factorization.

Reference parity: smooth.zig RowCompressedMatrixSystem2d (entire struct).
This is the correctness oracle for the TPU device solver and the direct
small-mesh path (stands in for the reference's UMFPACK/PETSc backends).

Row equations per point kind (see classify.Kind):

  INTERIOR   9-pt Winslow stencil, P,Q from the control function
             (smooth.zig:923-992; StencilData smooth.zig:171-216)
  FIXED      x = current coordinate (smooth.zig:790-796)
  SMOOTHED   9-pt Winslow spanning the connection: 3 interior points of
             each block + 3 on the connection; ghost neighbor shifted by
             -periodicity, RHS periodicity * (sum of block-1 coefs)
             (smooth.zig:994-1105). NOTE the deliberate reference quirk:
             the non-periodic path passes (cf.y, cf.x) as (P, Q) while
             the periodic path passes (cf.x, cf.y) (smooth.zig:1041 vs
             1083-1084) — replicated.
  CONNECTED  x_slave = x_master + offset (smooth.zig:804-812, 904-915)
  LAPLACIAN  sum(x_stencil) - (n-1) x_self = accumulated periodicity
             (smooth.zig:813-836, 917-921)
  SLIDING    x-solve: x = initial x; y-solve: y = y(first interior
             neighbor) (smooth.zig:837-859, 1115-1165)
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from .classify import BoundaryInfo, Kind


def _winslow_coefs(im1_j, ip1_j, i_jm1, i_jp1, P, Q):
    """9-point stencil coefficients (smooth.zig:192-215). Inputs (..., 2).

    Returns dict of coefficient arrays keyed like the reference's enum.
    """
    x_xi = 0.5 * (ip1_j[..., 0] - im1_j[..., 0])
    x_eta = 0.5 * (i_jp1[..., 0] - i_jm1[..., 0])
    y_xi = 0.5 * (ip1_j[..., 1] - im1_j[..., 1])
    y_eta = 0.5 * (i_jp1[..., 1] - i_jm1[..., 1])

    g22 = x_eta * x_eta + y_eta * y_eta
    g12 = x_xi * x_eta + y_xi * y_eta
    g11 = x_xi * x_xi + y_xi * y_xi

    return {
        "i_j": -2.0 * g22 - 2.0 * g11,
        "ip1_j": g22 * (1 + 0.5 * P),
        "im1_j": g22 * (1 - 0.5 * P),
        "i_jp1": g11 * (1 + 0.5 * Q),
        "i_jm1": g11 * (1 - 0.5 * Q),
        "ip1_jp1": -0.5 * g12,
        "ip1_jm1": 0.5 * g12,
        "im1_jp1": 0.5 * g12,
        "im1_jm1": -0.5 * g12,
    }


def ilu0(A: sp.csr_matrix):
    """ILU(0): incomplete LU on the existing sparsity pattern — the
    reference's strong preconditioner (BiCGStab.zig:178-277 / GMRES.zig,
    marker-array algorithm). Returns (L, U) sparse factors; apply as
    M_inv = U^-1 L^-1 with unit-diagonal L.

    Factorization is a per-row host loop (O(nnz) with 9-entry rows);
    triangular applies use scipy's C solvers.
    """
    A = A.copy()
    A.sort_indices()
    n = A.shape[0]
    indptr, indices, data = A.indptr, A.indices, A.data
    diag_ptr = np.zeros(n, dtype=np.int64)
    marker = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        r0, r1 = indptr[i], indptr[i + 1]
        row_cols = indices[r0:r1]
        dpos = r0 + int(np.searchsorted(row_cols, i))
        if dpos >= r1 or indices[dpos] != i:
            # cannot happen for this discretization: every row kind
            # writes its diagonal
            raise ValueError(f"row {i} has no diagonal entry")
        diag_ptr[i] = dpos
        marker[row_cols] = np.arange(r0, r1)
        for pj in range(r0, dpos):  # strictly-lower entries, ascending j
            j = indices[pj]
            dj = data[diag_ptr[j]]
            lij = data[pj] / (dj if dj != 0.0 else 1.0)
            data[pj] = lij
            # eliminate against row j's upper part where the pattern matches
            for pk in range(diag_ptr[j] + 1, indptr[j + 1]):
                pi = marker[indices[pk]]
                if pi >= 0:
                    data[pi] -= lij * data[pk]
        marker[row_cols] = -1

    lower = np.zeros(len(data), dtype=bool)
    upper = np.zeros(len(data), dtype=bool)
    for i in range(n):
        lower[indptr[i] : diag_ptr[i]] = True
        upper[diag_ptr[i] : indptr[i + 1]] = True
    rows = np.repeat(np.arange(n), np.diff(indptr))
    L = sp.csr_matrix((data[lower], (rows[lower], indices[lower])), (n, n))
    L = L + sp.eye(n, format="csr")
    U = sp.csr_matrix((data[upper], (rows[upper], indices[upper])), (n, n))
    return L.tocsr(), U.tocsr()


def _make_preconditioner(A: sp.csr_matrix, kind: str):
    """diagonal | ilu0 (preconditioner.zig:1-4) -> M_inv callable."""
    if kind == "diagonal":
        d = A.diagonal()
        inv_d = 1.0 / np.where(d == 0.0, 1.0, d)
        return lambda v: inv_d * v
    if kind == "ilu0":
        L, U = ilu0(A)
        def M_inv(v):
            y = spla.spsolve_triangular(L, v, lower=True,
                                        unit_diagonal=True)
            return spla.spsolve_triangular(U, y, lower=False)
        return M_inv
    raise ValueError(f"unknown preconditioner {kind!r}")


class SparseSystem:
    """Assembles and solves the global linear system for one Picard step.

    method selects the linear solver on the assembled CSR pair, mirroring
    the reference's user-facing solver options (solver.zig:10-38):

      "direct"    scipy sparse LU (stands in for UMFPACK/PETSc direct)
      "gmres"     restarted GMRES(30), reference tolerances
                  (GMRES.zig:21-24: rtol 1e-6, atol 1e-8, max 1000)
      "bicgstab"  preconditioned BiCGStab (BiCGStab.zig:19-21)

    preconditioner (Krylov methods): "diagonal" or "ilu0"
    (preconditioner.zig:1-4; ilu0 is the in-repo marker-array ILU(0)
    factorization on the existing CSR pattern — ilu0() in this module,
    same algorithm as BiCGStab.zig:178-277).
    """

    def __init__(self, mesh, info: BoundaryInfo, method: str = "direct",
                 preconditioner: str = "ilu0"):
        self.info = info
        self.starts = mesh.block_row_starts()
        self.sizes = [b.size for b in mesh.blocks]
        self.P = mesh.num_points
        self.method = method
        self.preconditioner = preconditioner
        self._static = self._build_static_rows(info)

    # ---- static rows (kind-dependent, coordinate-independent columns) -------

    def _build_static_rows(self, info):
        rows, cols, vals = [], [], []
        kind = info.kind

        fixed_ids = np.nonzero(kind == Kind.FIXED)[0]
        rows.append(fixed_ids)
        cols.append(fixed_ids)
        vals.append(np.ones(len(fixed_ids)))

        # connected slaves: x_master - x_slave = -offset  (row = slave id)
        rows.append(info.slave_ids)
        cols.append(info.master_ids)
        vals.append(np.ones(len(info.slave_ids)))
        rows.append(info.slave_ids)
        cols.append(info.slave_ids)
        vals.append(-np.ones(len(info.slave_ids)))

        for lp in info.laplacian_points:
            n = len(lp.stencil_ids)
            v = np.ones(n)
            v[lp.stencil_ids == lp.global_id] = -(n - 1)
            rows.append(np.full(n, lp.global_id))
            cols.append(lp.stencil_ids)
            vals.append(v)

        return (np.concatenate(rows).astype(np.int64),
                np.concatenate(cols).astype(np.int64),
                np.concatenate(vals))

    # ---- per-iteration assembly ---------------------------------------------

    def assemble(self, coords: np.ndarray, cf: np.ndarray):
        """Build matrix pieces common to the x and y solves.

        coords: (P, 2) current flat coordinates; cf: (P, 2) control function.
        Returns (rows, cols, vals, rhs (P,2)).
        """
        info = self.info
        kind = info.kind
        rows_l, cols_l, vals_l = [list(x) for x in ([], [], [])]
        rhs = np.zeros((self.P, 2))

        # interior 9-pt stencils, vectorized per block
        for (ni, nj), s in zip(self.sizes, self.starts):
            pts = coords[s : s + ni * nj].reshape(ni, nj, 2)
            pq = cf[s : s + ni * nj].reshape(ni, nj, 2)
            c = _winslow_coefs(
                pts[:-2, 1:-1], pts[2:, 1:-1], pts[1:-1, :-2], pts[1:-1, 2:],
                pq[1:-1, 1:-1, 0], pq[1:-1, 1:-1, 1],
            )
            ii, jj = np.meshgrid(
                np.arange(1, ni - 1), np.arange(1, nj - 1), indexing="ij"
            )
            base = s + ii * nj + jj  # (ni-2, nj-2)
            for key, off in (
                ("im1_jm1", -nj - 1), ("im1_j", -nj), ("im1_jp1", -nj + 1),
                ("i_jm1", -1), ("i_j", 0), ("i_jp1", 1),
                ("ip1_jm1", nj - 1), ("ip1_j", nj), ("ip1_jp1", nj + 1),
            ):
                rows_l.append(base.ravel())
                cols_l.append((base + off).ravel())
                vals_l.append(c[key].ravel())

        # smoothed connection rows, vectorized per connection
        for cm in info.conn_meta:
            g0 = cm.g0[1:-1]
            g1 = cm.g1[1:-1]
            sm = kind[g0] == Kind.SMOOTHED
            if not np.any(sm):
                continue
            g0 = g0[sm]
            g1 = g1[sm]
            im1_j = coords[g0 - cm.cs0]
            ip1_j = coords[g0 + cm.cs0]
            i_jm1 = coords[g0 + cm.fis0]
            i_jp1 = coords[g1 + cm.fis1]
            if cm.periodicity is not None:
                i_jp1 = i_jp1 - cm.periodicity
                P_, Q_ = cf[g0, 0], cf[g0, 1]
            else:
                # reference argument-order quirk (smooth.zig:1083-1084)
                P_, Q_ = cf[g0, 1], cf[g0, 0]
            c = _winslow_coefs(im1_j, ip1_j, i_jm1, i_jp1, P_, Q_)
            for key, col in (
                ("im1_jm1", g0 - cm.cs0 + cm.fis0),
                ("i_jm1", g0 + cm.fis0),
                ("ip1_jm1", g0 + cm.cs0 + cm.fis0),
                ("im1_j", g0 - cm.cs0),
                ("i_j", g0),
                ("ip1_j", g0 + cm.cs0),
                ("im1_jp1", g1 - cm.cs1 + cm.fis1),
                ("i_jp1", g1 + cm.fis1),
                ("ip1_jp1", g1 + cm.cs1 + cm.fis1),
            ):
                rows_l.append(g0)
                cols_l.append(col)
                vals_l.append(c[key])
            if cm.periodicity is not None:
                csum = c["im1_jp1"] + c["i_jp1"] + c["ip1_jp1"]
                rhs[g0, 0] = cm.periodicity[0] * csum
                rhs[g0, 1] = cm.periodicity[1] * csum

        # static rows
        srows, scols, svals = self._static
        rows_l.append(srows)
        cols_l.append(scols)
        vals_l.append(svals)

        # static rhs: fixed -> current coords; connected -> -offset;
        # laplacian -> accumulated periodicity
        fixed_ids = np.nonzero(kind == Kind.FIXED)[0]
        rhs[fixed_ids] = coords[fixed_ids]
        rhs[info.slave_ids] = -info.slave_offsets
        for lp in info.laplacian_points:
            rhs[lp.global_id] = lp.rhs

        return (np.concatenate(rows_l), np.concatenate(cols_l),
                np.concatenate(vals_l), rhs)

    def _solve_csr(self, A: sp.csr_matrix, b: np.ndarray,
                   x0: np.ndarray) -> np.ndarray:
        """Dispatch one CSR solve per self.method. Krylov paths are
        LEFT-preconditioned like the reference (GMRES.zig preconditions
        the residual; this also equilibrates the wildly mixed row scales
        of fixed rows (1.0) vs stencil rows (~h^2)), seed the initial
        guess from the current coordinates (BiCGStab.zig:136-153) and use
        the reference tolerances."""
        if self.method == "direct":
            return spla.spsolve(A, b)

        from .krylov import numpy_bicgstab, numpy_gmres

        M_inv = _make_preconditioner(A, self.preconditioner)

        def A_left(v):
            return M_inv(A @ v)

        ident = lambda v: v
        if self.method == "gmres":
            # reference: restart 30, rtol 1e-6, atol 1e-8, max 1000 iters
            dx, _ = numpy_gmres(A_left, ident, M_inv(b - A @ x0),
                                rtol=1e-6, atol=1e-8, restart=30,
                                max_restarts=34)
            return x0 + dx
        if self.method == "bicgstab":
            x, _ = numpy_bicgstab(A_left, ident, M_inv(b), rtol=1e-6,
                                  atol=1e-8, max_iters=1000, x0=x0)
            return x
        raise ValueError(f"unknown solver method {self.method!r}")

    def solve(self, coords: np.ndarray, cf: np.ndarray) -> np.ndarray:
        """One linear solve pair (x then y system) -> new (P, 2) coords."""
        info = self.info
        rows, cols, vals, rhs = self.assemble(coords, cf)
        new = np.empty_like(coords)

        sl = info.sliding_ids
        nb = info.sliding_neighbor_ids

        # x-system: sliding rows x = current x
        rx = np.concatenate([rows, sl, sl])
        cx = np.concatenate([cols, sl, nb])
        vx = np.concatenate([vals, np.ones(len(sl)), np.zeros(len(sl))])
        bx = rhs[:, 0].copy()
        bx[sl] = coords[sl, 0]
        Ax = sp.csr_matrix((vx, (rx, cx)), shape=(self.P, self.P))
        Ax.sum_duplicates()
        new[:, 0] = self._solve_csr(Ax, bx, coords[:, 0])

        # y-system: sliding rows y - y_neighbor = 0
        ry = np.concatenate([rows, sl, sl])
        cy = np.concatenate([cols, sl, nb])
        vy = np.concatenate([vals, np.ones(len(sl)), -np.ones(len(sl))])
        by = rhs[:, 1].copy()
        by[sl] = 0.0
        Ay = sp.csr_matrix((vy, (ry, cy)), shape=(self.P, self.P))
        Ay.sum_duplicates()
        new[:, 1] = self._solve_csr(Ay, by, coords[:, 1])

        return new


def mumps_prototype_solve(n: int, irn, jcn, a, rhs):
    """Counterpart of the reference's dormant MUMPS prototype
    (mumps.zig:37-97): an unsymmetric sparse direct solve given 1-based
    COO triplets, overwriting ``rhs`` with the solution in place, exactly
    as dmumps_c(job=6) does. The reference never wires MUMPS into
    solver.zig — it exists only as a test-only 2x2 smoke (diag(1,2) x =
    [1,4]); this records the capability with the same call shape on the
    direct sparse backend that stands in for all MPI direct solvers here.
    """
    irn = np.asarray(irn, dtype=np.int64) - 1
    jcn = np.asarray(jcn, dtype=np.int64) - 1
    A = sp.csr_matrix((np.asarray(a, dtype=np.float64), (irn, jcn)),
                      shape=(n, n))
    rhs = np.asarray(rhs, dtype=np.float64)
    rhs[:] = spla.spsolve(A.tocsc(), rhs.copy())
    return rhs
