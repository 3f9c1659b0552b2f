"""Wall control functions P,Q for the Poisson smoothing equations.

Reference parity: src/core/smoothing/wall_control_function.zig.

- ``laplace``: P = Q = 0 everywhere.
- ``white``: boundary-layer forcing on the two O-grid wall blocks
  (reference hard-codes blocks[0..2] and connections[0] — the leading-edge
  radial edge; we reproduce that scope for the O4H topology,
  wall_control_function.zig:72,204,327,395):

  * init: P,Q at each wall (j=0) point from one-sided/central second
    differences ("eq. 6.10", wall_control_function.zig:101-102), decayed
    linearly to 0 across j: cf(i,j) = (1 - j/(Nj-1)) * cf(i,0);
  * update (each Picard iteration n>0): measured wall spacing ds = sqrt(g22)
    and angle theta = acos(g12/sqrt(g11 g22)); feedback
    dP = -atan2(dtheta, theta_t), dQ = atan2(dds, ds_t), relaxation 0.1,
    accumulated into the wall row then re-decayed
    (wall_control_function.zig:282-473).

All wall rows are computed vectorized over i (formulas identical to the
reference's per-point scheme). P,Q are stored per global point id, like
the reference's flat cf array.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Laplace:
    def init(self, mesh) -> np.ndarray:
        return np.zeros((mesh.num_points, 2), dtype=np.float64)

    def update(self, cf: np.ndarray, mesh) -> None:
        pass


def _wall_xi_derivs(x, y, second: bool):
    """xi derivatives along the wall row (j=0): central interior, one-sided
    ends; optionally second derivatives too. x, y: (ni, nj)."""
    ni = x.shape[0]
    x_xi = np.empty(ni)
    y_xi = np.empty(ni)
    x_xi[1:-1] = 0.5 * (x[2:, 0] - x[:-2, 0])
    y_xi[1:-1] = 0.5 * (y[2:, 0] - y[:-2, 0])
    x_xi[0] = -x[0, 0] + x[1, 0]
    y_xi[0] = -y[0, 0] + y[1, 0]
    x_xi[-1] = x[-1, 0] - x[-2, 0]
    y_xi[-1] = y[-1, 0] - y[-2, 0]
    if not second:
        return x_xi, y_xi, None, None
    x_xi2 = np.empty(ni)
    y_xi2 = np.empty(ni)
    x_xi2[1:-1] = x[2:, 0] - 2 * x[1:-1, 0] + x[:-2, 0]
    y_xi2[1:-1] = y[2:, 0] - 2 * y[1:-1, 0] + y[:-2, 0]
    x_xi2[0] = x[0, 0] - 2 * x[1, 0] + x[2, 0]
    y_xi2[0] = y[0, 0] - 2 * y[1, 0] + y[2, 0]
    x_xi2[-1] = x[-1, 0] - 2 * x[-2, 0] + x[-3, 0]
    y_xi2[-1] = y[-1, 0] - 2 * y[-2, 0] + y[-3, 0]
    return x_xi, y_xi, x_xi2, y_xi2


@dataclasses.dataclass
class White:
    ds_target: float
    theta_target: float = 0.5 * math.pi

    # -- helpers --------------------------------------------------------------

    @staticmethod
    def _pq_from_derivs(x_xi, y_xi, x_xi2, y_xi2, x_eta, y_eta, x_eta2, y_eta2):
        g11 = x_xi * x_xi + y_xi * y_xi
        g22 = x_eta * x_eta + y_eta * y_eta
        # eq. 6.10 (wall_control_function.zig:101-102)
        p = -(x_xi * x_xi2 + y_xi * y_xi2) / g11 - (x_xi * x_eta2 + y_xi * y_eta2) / g22
        q = -(x_eta * x_eta2 + y_eta * y_eta2) / g22 - (x_eta * x_xi2 + y_eta * y_xi2) / g11
        return p, q

    @staticmethod
    def _decay_fill_block(cf, base, ni, nj, p, q):
        """All wall rows of one block: cf(i, j) = (1 - j/(nj-1)) * (p_i, q_i)."""
        factor = 1.0 - np.arange(nj, dtype=np.float64) / (nj - 1.0)
        block = cf[base : base + ni * nj].reshape(ni, nj, 2)
        block[:, :, 0] = np.asarray(p)[:, None] * factor[None, :]
        block[:, :, 1] = np.asarray(q)[:, None] * factor[None, :]

    @staticmethod
    def _decay_fill(cf, start, nj, p, q):
        """cf rows [start .. start+nj): wall value with linear decay in j."""
        factor = 1.0 - np.arange(nj, dtype=np.float64) / (nj - 1.0)
        cf[start : start + nj, 0] = factor * p
        cf[start : start + nj, 1] = factor * q

    # -- init (wall_control_function.zig:70-280) ------------------------------

    @staticmethod
    def _wall_blocks(mesh):
        """Blocks with a j_min viscous wall. The template declares them
        (mesh.wall_blocks); for meshes without the declaration fall back
        to the reference's hard-coded blocks 0..1
        (wall_control_function.zig:72)."""
        if getattr(mesh, "wall_blocks", None):
            return [b for b in mesh.wall_blocks
                    if mesh.blocks[b].size[0] > 2 and mesh.blocks[b].size[1] > 2]
        return list(range(min(2, len(mesh.blocks))))

    def init(self, mesh) -> np.ndarray:
        cf = np.zeros((mesh.num_points, 2), dtype=np.float64)
        starts = mesh.block_row_starts()

        for b in self._wall_blocks(mesh):
            pts = mesh.blocks[b].points
            ni, nj = mesh.blocks[b].size
            x = pts[:, :, 0]
            y = pts[:, :, 1]
            x_xi, y_xi, x_xi2, y_xi2 = _wall_xi_derivs(x, y, second=True)
            # forward eta derivatives off the wall
            x_eta = -x[:, 0] + x[:, 1]
            y_eta = -y[:, 0] + y[:, 1]
            x_eta2 = x[:, 0] - 2 * x[:, 1] + x[:, 2]
            y_eta2 = y[:, 0] - 2 * y[:, 1] + y[:, 2]
            p, q = self._pq_from_derivs(x_xi, y_xi, x_xi2, y_xi2,
                                        x_eta, y_eta, x_eta2, y_eta2)
            self._decay_fill_block(cf, starts[b], ni, nj, p, q)

        self._le_connection_init(cf, mesh)
        return cf

    @staticmethod
    def _le_connection_applicable(mesh) -> bool:
        """The reference hard-asserts connection 0 is blade_up.j_min <->
        blade_down.j_min starting at 0 (wall_control_function.zig:212-217);
        we skip the LE special case for other topologies instead."""
        if len(mesh.connections) == 0 or len(mesh.blocks) < 2:
            return False
        from ..boundary import Side

        c = mesh.connections[0]
        r0, r1 = c.ranges
        return (c.periodicity is None
                and r0.block == 0 and r0.side is Side.J_MIN and r0.start == 0
                and r1.block == 1 and r1.side is Side.J_MIN and r1.start == 0
                and mesh.blocks[0].size[0] > 2 and mesh.blocks[0].size[1] > 2)

    def _le_connection_pq(self, mesh, second_order: bool):
        """P,Q at the leading-edge junction of connection 0 (blade_up j_min
        <-> blade_down j_min), using both blocks' data
        (wall_control_function.zig:203-279, 393-450)."""
        b0 = mesh.blocks[0].points
        b1 = mesh.blocks[1].points
        nj = mesh.blocks[0].size[1]
        # connection 0: both ranges side J_MIN starting at 0 ->
        # first_internal_point_shift = nj for both; in-connection shift = 1
        p0 = b0.reshape(-1, 2)
        p1 = b1.reshape(-1, 2)
        x_i_j = p0[0]
        x_ip1_j = p0[nj]       # first interior of block 0
        x_im1_j = p1[nj]       # first interior of block 1
        x_i_jp1 = p0[1]        # next point along the connection
        x_i_jp2 = p0[2]

        if second_order:
            x_xi = 0.5 * (x_ip1_j[0] - x_im1_j[0])
            y_xi = 0.5 * (x_ip1_j[1] - x_im1_j[1])
            x_xi2 = x_ip1_j[0] - 2 * x_i_j[0] + x_im1_j[0]
            y_xi2 = x_ip1_j[1] - 2 * x_i_j[1] + x_im1_j[1]
            x_eta = -x_i_j[0] + x_i_jp1[0]
            y_eta = -x_i_j[1] + x_i_jp1[1]
            x_eta2 = x_i_j[0] - 2 * x_i_jp1[0] + x_i_jp2[0]
            y_eta2 = x_i_j[1] - 2 * x_i_jp1[1] + x_i_jp2[1]
            return self._pq_from_derivs(x_xi, y_xi, x_xi2, y_xi2,
                                        x_eta, y_eta, x_eta2, y_eta2)
        else:
            # update path: first derivatives only, with the reference's
            # negated central difference (wall_control_function.zig:429-431)
            x_xi = -0.5 * (x_ip1_j[0] - x_im1_j[0])
            y_xi = -0.5 * (x_ip1_j[1] - x_im1_j[1])
            x_eta = -x_i_j[0] + x_i_jp1[0]
            y_eta = -x_i_j[1] + x_i_jp1[1]
            return x_xi, y_xi, x_eta, y_eta

    def _le_connection_init(self, cf, mesh):
        if not self._le_connection_applicable(mesh):
            return
        p, q = self._le_connection_pq(mesh, second_order=True)
        nj = mesh.blocks[0].size[1]
        self._decay_fill(cf, 0, nj, p, q)

    # -- update (wall_control_function.zig:282-473) ---------------------------

    def _feedback(self, p, q, x_xi, y_xi, x_eta, y_eta):
        g11 = x_xi * x_xi + y_xi * y_xi
        g12 = x_xi * x_eta + y_xi * y_eta
        g22 = x_eta * x_eta + y_eta * y_eta
        ds = math.sqrt(g22)
        theta = math.acos(g12 / math.sqrt(g11 * g22))
        delta_p = -math.atan2(self.theta_target - theta, self.theta_target)
        delta_q = math.atan2(self.ds_target - ds, self.ds_target)
        return p + 0.1 * delta_p, q + 0.1 * delta_q

    def update(self, cf: np.ndarray, mesh) -> None:
        starts = mesh.block_row_starts()
        for b in self._wall_blocks(mesh):
            pts = mesh.blocks[b].points
            ni, nj = mesh.blocks[b].size
            x = pts[:, :, 0]
            y = pts[:, :, 1]
            x_xi, y_xi, _, _ = _wall_xi_derivs(x, y, second=False)
            x_eta = -x[:, 0] + x[:, 1]
            y_eta = -y[:, 0] + y[:, 1]

            g11 = x_xi * x_xi + y_xi * y_xi
            g12 = x_xi * x_eta + y_xi * y_eta
            g22 = x_eta * x_eta + y_eta * y_eta
            ds = np.sqrt(g22)
            theta = np.arccos(g12 / np.sqrt(g11 * g22))
            delta_p = -np.arctan2(self.theta_target - theta, self.theta_target)
            delta_q = np.arctan2(self.ds_target - ds, self.ds_target)

            base = starts[b]
            wall = cf[base : base + ni * nj].reshape(ni, nj, 2)[:, 0, :]
            p = wall[:, 0] + 0.1 * delta_p
            q = wall[:, 1] + 0.1 * delta_q
            self._decay_fill_block(cf, base, ni, nj, p, q)

        # leading-edge connection update (block 0 column 0)
        if not self._le_connection_applicable(mesh):
            return
        x_xi, y_xi, x_eta, y_eta = self._le_connection_pq(mesh, second_order=False)
        p, q = cf[0]
        p, q = self._feedback(p, q, x_xi, y_xi, x_eta, y_eta)
        nj = mesh.blocks[0].size[1]
        self._decay_fill(cf, 0, nj, p, q)


def from_config(cfg) -> Laplace | White:
    """Tagged-union config: "laplace" or {"white": {"ds_target": ..}}."""
    if cfg in ("laplace", None) or cfg == {"laplace": {}}:
        return Laplace()
    if isinstance(cfg, (Laplace, White)):
        return cfg
    if isinstance(cfg, dict):
        (tag, params), = cfg.items()
        if tag == "laplace":
            return Laplace()
        if tag == "white":
            out = White(ds_target=params["ds_target"])
            if "theta_target" in params:
                out.theta_target = params["theta_target"]
            return out
    raise ValueError(f"unknown wall control function {cfg!r}")


# ---------------------------------------------------------------------------
# Device-resident control-function update (for DeviceSmoother.run's
# device-resident Picard loop). Same formulas as White.update /
# wall_control_function.zig:282-473, expressed as tensor ops over the
# padded (B, N, M, 2) coordinate/cf stacks so the outer loop never
# downloads the field.
# ---------------------------------------------------------------------------


def make_device_update(algorithm, mesh, plan):
    """Build ``update(X, cf) -> cf`` on padded stacks, or None when the
    algorithm has no per-iteration update (Laplace).

    Block extents and the wall-block list are fixed at build time; X and
    cf are (B, N, M, 2) tensors laid out as DevicePlan pads them (block
    point (i, j) at [b, i, j], or [b, j, i] with cf components swapped on
    transposed blocks). The returned cf is a new tensor."""
    if not isinstance(algorithm, White):
        return None

    import torch

    wall_blocks = [(b, mesh.blocks[b].size) for b in White._wall_blocks(mesh)]
    le = White._le_connection_applicable(mesh)
    nj0 = mesh.blocks[0].size[1] if le else 0
    ds_t = algorithm.ds_target
    th_t = algorithm.theta_target
    tr = getattr(plan, "transposed", None)
    tr = (np.zeros(len(mesh.blocks), dtype=bool) if tr is None else tr)

    def read_block(A, b, ni, nj, is_cf):
        """Logical-frame (ni, nj, 2) view of block b from the padded
        stack (coords or cf; cf components swap on transposed blocks)."""
        if tr[b]:
            v = A[b, :nj, :ni, :].transpose(0, 1)
            return v.flip(-1) if is_cf else v
        return A[b, :ni, :nj, :]

    def write_cf_block(cf, b, ni, nj, newb):
        """Write a logical-frame (ni, nj, 2) cf block back in storage."""
        if tr[b]:
            cf[b, :nj, :ni, :] = newb.flip(-1).transpose(0, 1)
        else:
            cf[b, :ni, :nj, :] = newb

    def _wall_first_derivs(x, y):
        """First xi derivatives along the wall row j=0 (central interior,
        one-sided ends — _wall_xi_derivs, second=False)."""
        x_xi = torch.cat([
            (x[1, 0] - x[0, 0])[None],
            0.5 * (x[2:, 0] - x[:-2, 0]),
            (x[-1, 0] - x[-2, 0])[None],
        ])
        y_xi = torch.cat([
            (y[1, 0] - y[0, 0])[None],
            0.5 * (y[2:, 0] - y[:-2, 0]),
            (y[-1, 0] - y[-2, 0])[None],
        ])
        return x_xi, y_xi

    def atan2(a, b):
        return torch.atan2(a, torch.full_like(a, b))

    def update(X, cf):
        cf = cf.clone()
        for b, (ni, nj) in wall_blocks:
            xb = read_block(X, b, ni, nj, is_cf=False)
            x = xb[..., 0]
            y = xb[..., 1]
            x_xi, y_xi = _wall_first_derivs(x, y)
            x_eta = -x[:, 0] + x[:, 1]
            y_eta = -y[:, 0] + y[:, 1]

            g11 = x_xi * x_xi + y_xi * y_xi
            g12 = x_xi * x_eta + y_xi * y_eta
            g22 = x_eta * x_eta + y_eta * y_eta
            ds = torch.sqrt(g22)
            theta = torch.arccos(g12 / torch.sqrt(g11 * g22))
            delta_p = -atan2(th_t - theta, th_t)
            delta_q = atan2(ds_t - ds, ds_t)

            wall = read_block(cf, b, ni, nj, is_cf=True)[:, 0, :]
            p = wall[:, 0] + 0.1 * delta_p
            q = wall[:, 1] + 0.1 * delta_q
            factor = 1.0 - torch.arange(nj, dtype=X.dtype,
                                        device=X.device) / (nj - 1.0)
            newb = torch.stack([p[:, None] * factor[None, :],
                                q[:, None] * factor[None, :]], dim=-1)
            write_cf_block(cf, b, ni, nj, newb)

        if le:
            # leading-edge junction feedback (block 0 column i=0), reading
            # cf[0,(0,0)] AFTER the wall-block decay fill, like the host path
            def pt(b, i, j):
                return (b, j, i) if tr[b] else (b, i, j)

            x_i_j = X[pt(0, 0, 0)]
            x_ip1_j = X[pt(0, 1, 0)]   # first interior of block 0
            x_im1_j = X[pt(1, 1, 0)]   # first interior of block 1
            x_i_jp1 = X[pt(0, 0, 1)]
            # negated central difference (wall_control_function.zig:429-431)
            x_xi = -0.5 * (x_ip1_j[0] - x_im1_j[0])
            y_xi = -0.5 * (x_ip1_j[1] - x_im1_j[1])
            x_eta = -x_i_j[0] + x_i_jp1[0]
            y_eta = -x_i_j[1] + x_i_jp1[1]

            g11 = x_xi * x_xi + y_xi * y_xi
            g12 = x_xi * x_eta + y_xi * y_eta
            g22 = x_eta * x_eta + y_eta * y_eta
            ds = torch.sqrt(g22)
            theta = torch.arccos(g12 / torch.sqrt(g11 * g22))
            cP, cQ = (1, 0) if tr[0] else (0, 1)  # storage cf components
            p_ = cf[pt(0, 0, 0) + (cP,)] - 0.1 * atan2(th_t - theta, th_t)
            q_ = cf[pt(0, 0, 0) + (cQ,)] + 0.1 * atan2(ds_t - ds, ds_t)
            factor0 = 1.0 - torch.arange(nj0, dtype=X.dtype,
                                         device=X.device) / (nj0 - 1.0)
            if tr[0]:
                cf[0, :nj0, 0, cP] = factor0 * p_
                cf[0, :nj0, 0, cQ] = factor0 * q_
            else:
                cf[0, 0, :nj0, cP] = factor0 * p_
                cf[0, 0, :nj0, cQ] = factor0 * q_
        return cf

    return update
