"""The linearized Winslow system of one Picard step, and its checks.

Frozen copy of the assembly of the port's host oracle
(``smoothing.system.SparseSystem``; reference parity: smooth.zig
RowCompressedMatrixSystem2d), in the dtype asked for: float64 for the
check, float32 for the lower-precision control.

Row equations per point kind (classify.Kind): INTERIOR 9-point Winslow
stencil with P, Q from the control function; FIXED x = current x;
SMOOTHED the stencil spanning a connection (ghost neighbour shifted by
the periodicity; the reference's (P, Q) argument-order quirk on
non-periodic connections kept); CONNECTED x_slave = x_master + offset;
LAPLACIAN the junction stencil; SLIDING x = current x, y = y of the
first interior neighbour.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from .classify import BoundaryInfo, Kind

#: the nine stencil entries with their block-local flat offsets (nj-based)
_STENCIL = ("im1_jm1", "im1_j", "im1_jp1", "i_jm1", "i_j", "i_jp1",
            "ip1_jm1", "ip1_j", "ip1_jp1")


def _winslow_coefs(im1_j, ip1_j, i_jm1, i_jp1, P, Q):
    """9-point stencil coefficients (smooth.zig:192-215). Inputs (..., 2)."""
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


class WinslowSystem:
    """Assembles the x and y systems of one Picard step of ``mesh``."""

    def __init__(self, mesh, info: BoundaryInfo):
        self.info = info
        self.starts = mesh.block_row_starts()
        self.sizes = [b.size for b in mesh.blocks]
        self.P = mesh.num_points
        self._static = self._static_rows(info)

    @staticmethod
    def _static_rows(info):
        rows, cols, vals = [], [], []
        fixed_ids = np.nonzero(info.kind == Kind.FIXED)[0]
        rows.append(fixed_ids)
        cols.append(fixed_ids)
        vals.append(np.ones(len(fixed_ids)))
        # connected slaves: x_master - x_slave = -offset (row = slave id)
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

    def _assemble(self, coords, cf):
        """COO rows, columns and values common to the x and y systems, and
        the right-hand sides (P, 2); arithmetic in the dtype of coords."""
        info = self.info
        rows_l, cols_l, vals_l = [], [], []
        rhs = np.zeros((self.P, 2), dtype=coords.dtype)

        for (ni, nj), s in zip(self.sizes, self.starts):
            pts = coords[s : s + ni * nj].reshape(ni, nj, 2)
            pq = cf[s : s + ni * nj].reshape(ni, nj, 2)
            c = _winslow_coefs(pts[:-2, 1:-1], pts[2:, 1:-1],
                               pts[1:-1, :-2], pts[1:-1, 2:],
                               pq[1:-1, 1:-1, 0], pq[1:-1, 1:-1, 1])
            ii, jj = np.meshgrid(np.arange(1, ni - 1), np.arange(1, nj - 1),
                                 indexing="ij")
            base = s + ii * nj + jj
            offsets = (-nj - 1, -nj, -nj + 1, -1, 0, 1, nj - 1, nj, nj + 1)
            for key, off in zip(_STENCIL, offsets):
                rows_l.append(base.ravel())
                cols_l.append((base + off).ravel())
                vals_l.append(c[key].ravel())

        for cm in info.conn_meta:
            g0 = cm.g0[1:-1]
            g1 = cm.g1[1:-1]
            sm = info.kind[g0] == Kind.SMOOTHED
            if not np.any(sm):
                continue
            g0, g1 = g0[sm], g1[sm]
            i_jp1 = coords[g1 + cm.fis1]
            if cm.periodicity is not None:
                i_jp1 = i_jp1 - cm.periodicity.astype(coords.dtype)
                P_, Q_ = cf[g0, 0], cf[g0, 1]
            else:
                # reference argument-order quirk (smooth.zig:1083-1084)
                P_, Q_ = cf[g0, 1], cf[g0, 0]
            c = _winslow_coefs(coords[g0 - cm.cs0], coords[g0 + cm.cs0],
                               coords[g0 + cm.fis0], i_jp1, P_, Q_)
            columns = {
                "im1_jm1": g0 - cm.cs0 + cm.fis0, "i_jm1": g0 + cm.fis0,
                "ip1_jm1": g0 + cm.cs0 + cm.fis0, "im1_j": g0 - cm.cs0,
                "i_j": g0, "ip1_j": g0 + cm.cs0,
                "im1_jp1": g1 - cm.cs1 + cm.fis1, "i_jp1": g1 + cm.fis1,
                "ip1_jp1": g1 + cm.cs1 + cm.fis1,
            }
            for key in _STENCIL:
                rows_l.append(g0)
                cols_l.append(columns[key])
                vals_l.append(c[key])
            if cm.periodicity is not None:
                csum = c["im1_jp1"] + c["i_jp1"] + c["ip1_jp1"]
                rhs[g0, 0] = cm.periodicity[0] * csum
                rhs[g0, 1] = cm.periodicity[1] * csum

        srows, scols, svals = self._static
        rows_l.append(srows)
        cols_l.append(scols)
        vals_l.append(svals.astype(coords.dtype))

        fixed_ids = np.nonzero(info.kind == Kind.FIXED)[0]
        rhs[fixed_ids] = coords[fixed_ids]
        rhs[info.slave_ids] = -info.slave_offsets
        for lp in info.laplacian_points:
            rhs[lp.global_id] = lp.rhs
        return (np.concatenate(rows_l), np.concatenate(cols_l),
                np.concatenate(vals_l).astype(coords.dtype), rhs)

    def systems(self, coords, cf, dtype=np.float64):
        """[(A_x, b_x), (A_y, b_y)] of the step from ``coords`` with the
        control function ``cf``, assembled and held in ``dtype``."""
        coords = np.asarray(coords).astype(dtype)
        cf = np.asarray(cf).astype(dtype)
        rows, cols, vals, rhs = self._assemble(coords, cf)
        sl = self.info.sliding_ids
        nb = self.info.sliding_neighbor_ids
        one = np.ones(len(sl), dtype=dtype)
        out = []
        # x: sliding rows x = current x; y: y - y_neighbour = 0
        for comp, nb_val, b_sl in ((0, 0.0, coords[sl, 0]), (1, -1.0, 0.0)):
            r = np.concatenate([rows, sl, sl])
            c = np.concatenate([cols, sl, nb])
            v = np.concatenate([vals, one, nb_val * one])
            b = rhs[:, comp].copy()
            b[sl] = b_sl
            A = sp.csr_matrix((v, (r, c)), shape=(self.P, self.P), dtype=dtype)
            A.sum_duplicates()
            out.append((A, b))
        return out


def solve(systems) -> np.ndarray:
    """The step's exact solution (sparse LU) in the systems' dtype, (P, 2)."""
    return np.stack([spla.splu(A.tocsc()).solve(b) for A, b in systems], -1)


def residual_ratio(systems, x_prev, x_new) -> float:
    """How far ``x_new`` solves the step: the largest row residual of the
    x and y systems at ``x_new`` over the largest at ``x_prev``, each row
    divided by its diagonal (row-equilibrated, in float64). 0 for the
    exact solution, 1 for a step that leaves the state unchanged."""
    num = den = 0.0
    for comp, (A, b) in enumerate(systems):
        A = A.astype(np.float64)
        b = b.astype(np.float64)
        d = np.abs(A.diagonal())
        d[d == 0.0] = 1.0
        num = max(num, float(np.max(np.abs(b - A @ x_new[:, comp]) / d)))
        den = max(den, float(np.max(np.abs(b - A @ x_prev[:, comp]) / d)))
    return num / den if den > 0.0 else (0.0 if num == 0.0 else np.inf)
