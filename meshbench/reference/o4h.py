r"""O4H automated blocking template for axial cascades.

Reference parity: src/core/templates/O4H.zig (entire file).

Topology — O-grid around the blade (blade_up / blade_down) plus six H
blocks (O4H.zig:21-37):

  .-----------------------------------------------------------------.
  |           |      *            up (5)              **|           |
  |           |------------------------------------**   |           |
  |           |   /          blade_up (0)         \     |           |
  | upstream  | IN (2) |--- LE ............ TE ---| out  | downstream|
  |   (6)     |   \        blade_down (1)         /  (3) |    (7)   |
  |           |------------------------------------------|           |
  |           |      *           down (4)          *     |           |
  '-----------------------------------------------------------------'

8 blocks, 21 connections (3 periodic with pitch vector (0, pitch)),
inlet/outlet boundary conditions.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .types import Float
from .clustering import (
    ClusteringFunction,
    SingleHyperbolic,
    Uniform,
    from_config as clustering_from_config,
)
from .edge import Edge, EdgeView
from .geometry import Line
from .machine import Geometry
from .mesh import Block2d, Mesh
from .boundary import Side, Range, Connection, Condition, BCKind

# O-grid wall offset distance (O4H.zig:102) and wall-normal first-cell
# clustering spacing (O4H.zig:133,141).
O_GRID_OFFSET = 0.001
O_GRID_WALL_DELTA_S = 0.01


@dataclasses.dataclass(frozen=True)
class NumCells:
    o_grid: int
    middle_i: int
    in_up_j: int
    in_down_j: int
    in_i: int
    out_up_j: int
    out_down_j: int
    out_i: int
    down_j: int
    bulge: int
    upstream_i: int
    downstream_i: int


@dataclasses.dataclass(frozen=True)
class O4H:
    blade_clustering: ClusteringFunction
    num_cells: NumCells
    inlet_distance: float | None = None
    outlet_distance: float | None = None
    # wall-normal first-cell clustering spacing of the O-grid. The reference
    # hard-codes 0.01 (O4H.zig:133,141), which makes the Vinokur law invalid
    # for o_grid > 100 cells (B = n*ds > 1); expose it for fine meshes.
    wall_delta_s: float = O_GRID_WALL_DELTA_S

    @staticmethod
    def from_config(cfg: dict) -> "O4H":
        return O4H(
            blade_clustering=clustering_from_config(cfg["blade_clustering"]),
            num_cells=NumCells(**cfg["num_cells"]),
            inlet_distance=cfg.get("inlet_distance"),
            outlet_distance=cfg.get("outlet_distance"),
            wall_delta_s=cfg.get("wall_delta_s", O_GRID_WALL_DELTA_S),
        )

    def run(self, geom: Geometry) -> Mesh:  # noqa: C901 — mirrors O4H.zig:67-528
        nc = self.num_cells
        num_cells_up = nc.in_up_j + nc.middle_i + nc.bulge + nc.out_up_j + nc.out_i
        num_cells_down = nc.in_down_j + nc.middle_i + nc.out_down_j

        profile_length = geom.profile.up_part.total_length + geom.profile.down_part.total_length
        default_spacing = profile_length / Float(num_cells_up + num_cells_down)

        down_edge = Edge.from_curve(num_cells_down + 1, geom.profile.down_part, self.blade_clustering)
        up_edge = Edge.from_curve(num_cells_up + 1, geom.profile.up_part, self.blade_clustering)

        # force identical leading/trailing edge points (O4H.zig:85-91)
        leading_edge = up_edge.points[0].copy()
        down_edge.points[0] = leading_edge
        trailing_edge = up_edge.points[-1].copy()
        down_edge.points[-1] = trailing_edge

        inlet_distance = (
            self.inlet_distance
            if self.inlet_distance is not None
            else default_spacing * Float(nc.upstream_i)
        )
        outlet_distance = (
            self.outlet_distance
            if self.outlet_distance is not None
            else default_spacing * Float(nc.downstream_i)
        )

        # O-grid outer edges by projecting blade normals outward (O4H.zig:104-113)
        down_outer_edge = Edge(
            points=project_normal(down_edge.points, O_GRID_OFFSET),
            clustering=down_edge.clustering.copy(),
        )
        up_outer_edge = Edge(
            points=project_normal(up_edge.points, -O_GRID_OFFSET),
            clustering=up_edge.clustering.copy(),
        )
        up_outer_edge.points[0] = down_outer_edge.points[0]
        up_outer_edge.points[-1] = down_outer_edge.points[-1]

        mesh = Mesh()
        wall_clustering = SingleHyperbolic(delta_s=self.wall_delta_s)
        uniform = Uniform()

        # ---- Block BLADE_UP (0) -------------------------------------- O4H.zig:118-148
        blade_up_i_min = up_edge
        blade_up_i_max = up_outer_edge
        blade_up_j_min = Edge.from_curve(
            nc.o_grid + 1,
            Line(tuple(blade_up_i_min.points[0]), tuple(blade_up_i_max.points[0])),
            wall_clustering,
        )
        blade_up_j_max = Edge.from_curve(
            nc.o_grid + 1,
            Line(tuple(blade_up_i_min.points[-1]), tuple(blade_up_i_max.points[-1])),
            wall_clustering,
        )
        blade_up_id = mesh.add_block(
            "blade_up", Block2d.from_edges(blade_up_i_min, blade_up_i_max, blade_up_j_min, blade_up_j_max)
        )

        # ---- Block BLADE_DOWN (1) ------------------------------------ O4H.zig:150-166
        blade_down_i_max = down_outer_edge
        blade_down_id = mesh.add_block(
            "blade_down", Block2d.from_edges(down_edge, blade_down_i_max, blade_up_j_min, blade_up_j_max)
        )
        # the O-grid halves carry the viscous wall on j_min
        mesh.wall_blocks = [blade_up_id, blade_down_id]

        # ---- Block IN (2) -------------------------------------------- O4H.zig:168-209
        in_j_min = Edge.combine([
            EdgeView(blade_up_i_max, nc.in_up_j, 0),
            EdgeView(blade_down_i_max, 0, nc.in_down_j),
        ])
        assert len(in_j_min) == nc.in_up_j + nc.in_down_j + 1

        in_x_00 = in_j_min.points[0]
        in_x_01 = in_j_min.points[-1]
        in_x_start = leading_edge[0] - inlet_distance * 0.5
        in_x_10 = np.array([in_x_start, leading_edge[1] + geom.pitch * 0.25], dtype=Float)
        in_x_11 = np.array([in_x_start, leading_edge[1] - geom.pitch * 0.25], dtype=Float)

        in_j_max = Edge.from_curve(len(in_j_min), Line(tuple(in_x_10), tuple(in_x_11)), uniform)
        in_i_min = Edge.from_curve(nc.in_i + 1, Line(tuple(in_x_00), tuple(in_x_10)), uniform)
        in_i_max = Edge.from_curve(nc.in_i + 1, Line(tuple(in_x_01), tuple(in_x_11)), uniform)
        in_id = mesh.add_block("in", Block2d.from_edges(in_i_min, in_i_max, in_j_min, in_j_max))

        # ---- Block OUT (3) ------------------------------------------- O4H.zig:211-245
        out_j_min = Edge.combine([
            EdgeView(blade_down_i_max, nc.in_down_j + nc.middle_i, len(blade_down_i_max) - 1),
            EdgeView(blade_up_i_max, len(blade_up_i_max) - 1, nc.in_up_j + nc.bulge + nc.middle_i + nc.out_i),
        ])
        assert len(out_j_min) == nc.out_down_j + nc.out_up_j + 1

        out_x_00 = out_j_min.points[0]
        out_x_01 = out_j_min.points[-1]
        out_x_end = outlet_distance * 0.5 + trailing_edge[0]
        out_x_10 = np.array([out_x_end, trailing_edge[1] - geom.pitch * 0.25], dtype=Float)
        out_x_11 = np.array([out_x_end, trailing_edge[1] + geom.pitch * 0.25], dtype=Float)

        out_j_max = Edge.from_curve(len(out_j_min), Line(tuple(out_x_10), tuple(out_x_11)), uniform)
        out_i_min = Edge.from_curve(nc.out_i + 1, Line(tuple(out_x_00), tuple(out_x_10)), uniform)
        out_i_max = Edge.from_curve(nc.out_i + 1, Line(tuple(out_x_01), tuple(out_x_11)), uniform)
        out_id = mesh.add_block("out", Block2d.from_edges(out_i_min, out_i_max, out_j_min, out_j_max))

        # ---- Block DOWN (4) ------------------------------------------ O4H.zig:247-287
        down_i_min = Edge.combine([
            EdgeView(in_i_max, nc.in_i, 0),
            EdgeView(blade_down_i_max, nc.in_down_j, nc.in_down_j + nc.middle_i),
            EdgeView(out_i_min, 0, nc.out_i),
        ])

        down_x_00 = in_x_11
        down_x_01 = leading_edge - np.array([0.0, 0.5 * geom.pitch], dtype=Float)
        down_x_11 = trailing_edge - np.array([0.0, 0.5 * geom.pitch], dtype=Float)
        down_x_10 = out_x_10

        down_i_max = Edge.from_curve(len(down_i_min), Line(tuple(down_x_01), tuple(down_x_11)), uniform)
        down_j_min = Edge.from_curve(nc.down_j + 1, Line(tuple(down_x_00), tuple(down_x_01)), uniform)
        down_j_max = Edge.from_curve(len(down_j_min), Line(tuple(down_x_10), tuple(down_x_11)), uniform)
        down_id = mesh.add_block("down", Block2d.from_edges(down_i_min, down_i_max, down_j_min, down_j_max))

        # ---- Block UP (5) -------------------------------------------- O4H.zig:289-343
        up_j_min = out_i_max
        up_i_min = Edge.combine([
            EdgeView(blade_up_i_max, nc.in_up_j + nc.middle_i + nc.bulge + nc.out_i, nc.in_up_j),
            EdgeView(in_i_min, 0, nc.in_i),
        ])

        up_x_11 = leading_edge + np.array([0.0, 0.5 * geom.pitch], dtype=Float)
        up_x_i_max_middle = trailing_edge + np.array([0.0, 0.5 * geom.pitch], dtype=Float)
        up_x_01 = out_x_11
        up_x_10 = in_x_10

        up_i_max_0 = Edge.from_curve(nc.bulge + 1, Line(tuple(up_x_01), tuple(up_x_i_max_middle)), uniform)
        up_i_max_1 = Edge.from_curve(
            len(up_i_min) - nc.bulge, Line(tuple(up_x_i_max_middle), tuple(up_x_11)), uniform
        )
        up_i_max = Edge.combine([
            EdgeView(up_i_max_0, 0, nc.bulge),
            EdgeView(up_i_max_1, 0, len(up_i_max_1) - 1),
        ])
        up_j_max = Edge.from_curve(nc.out_i + 1, Line(tuple(up_x_10), tuple(up_x_11)), uniform)
        up_id = mesh.add_block("up", Block2d.from_edges(up_i_min, up_i_max, up_j_min, up_j_max))

        # ---- Block UPSTREAM (6) -------------------------------------- O4H.zig:345-381
        upstream_j_max = Edge.combine([
            EdgeView(down_j_min, nc.down_j, 0),
            EdgeView(in_j_max, len(in_j_max) - 1, 0),
            EdgeView(up_j_max, 0, len(up_j_max) - 1),
        ])

        upstream_x_10 = upstream_j_max.points[0]
        upstream_x_11 = upstream_j_max.points[-1]
        upstream_x_00 = np.array(
            [leading_edge[0] - inlet_distance, leading_edge[1] - 0.5 * geom.pitch], dtype=Float
        )
        upstream_x_01 = np.array(
            [leading_edge[0] - inlet_distance, leading_edge[1] + 0.5 * geom.pitch], dtype=Float
        )

        upstream_j_min = Edge.from_curve(
            len(upstream_j_max), Line(tuple(upstream_x_00), tuple(upstream_x_01)), uniform
        )
        upstream_i_min = Edge.from_curve(
            nc.upstream_i + 1, Line(tuple(upstream_x_00), tuple(upstream_x_10)), uniform
        )
        upstream_i_max = Edge.from_curve(
            nc.upstream_i + 1, Line(tuple(upstream_x_01), tuple(upstream_x_11)), uniform
        )
        upstream_id = mesh.add_block(
            "upstream", Block2d.from_edges(upstream_i_min, upstream_i_max, upstream_j_min, upstream_j_max)
        )

        # ---- Block DOWNSTREAM (7) ------------------------------------ O4H.zig:383-419
        downstream_j_min = Edge.combine([
            EdgeView(down_j_max, len(down_j_max) - 1, 0),
            EdgeView(out_j_max, 0, len(out_j_max) - 1),
            EdgeView(up_i_max_0, 0, len(up_i_max_0) - 1),
        ])

        downstream_x_00 = downstream_j_min.points[0]
        downstream_x_01 = downstream_j_min.points[-1]
        downstream_x_10 = downstream_x_00 + np.array([outlet_distance, 0.0], dtype=Float)
        downstream_x_11 = downstream_x_10 + np.array([0.0, geom.pitch], dtype=Float)

        downstream_j_max = Edge.from_curve(
            len(downstream_j_min), Line(tuple(downstream_x_10), tuple(downstream_x_11)), uniform
        )
        downstream_i_min = Edge.from_curve(
            nc.downstream_i + 1, Line(tuple(downstream_x_00), tuple(downstream_x_10)), uniform
        )
        downstream_i_max = Edge.from_curve(
            nc.downstream_i + 1, Line(tuple(downstream_x_01), tuple(downstream_x_11)), uniform
        )
        downstream_id = mesh.add_block(
            "downstream",
            Block2d.from_edges(downstream_i_min, downstream_i_max, downstream_j_min, downstream_j_max),
        )

        # ---- Connections (O4H.zig:423-515) ---------------------------------
        pitch_vec = (0.0, geom.pitch)
        C, R = Connection, Range
        mesh.connections += [
            C((R(blade_up_id, Side.J_MIN, 0, nc.o_grid),
               R(blade_down_id, Side.J_MIN, 0, nc.o_grid))),
            C((R(blade_up_id, Side.J_MAX, 0, nc.o_grid),
               R(blade_down_id, Side.J_MAX, 0, nc.o_grid))),

            C((R(down_id, Side.J_MIN, nc.down_j, 0),
               R(upstream_id, Side.J_MAX, 0, nc.down_j))),
            C((R(in_id, Side.J_MAX, len(in_j_min) - 1, 0),
               R(upstream_id, Side.J_MAX, nc.down_j, nc.down_j + len(in_j_min) - 1))),
            C((R(in_id, Side.I_MAX, 0, nc.in_i),
               R(down_id, Side.I_MIN, nc.in_i, 0))),

            C((R(up_id, Side.J_MAX, 0, nc.out_i),
               R(upstream_id, Side.J_MAX, nc.down_j + len(in_j_min) - 1, len(upstream_j_max) - 1))),
            C((R(in_id, Side.I_MIN, 0, nc.in_i),
               R(up_id, Side.I_MIN, len(up_i_min) - nc.in_i - 1, len(up_i_min) - 1))),

            C((R(down_id, Side.J_MAX, nc.down_j, 0),
               R(downstream_id, Side.J_MIN, 0, nc.down_j))),
            C((R(out_id, Side.J_MAX, 0, len(out_j_max) - 1),
               R(downstream_id, Side.J_MIN, nc.down_j, nc.down_j + len(out_j_max) - 1))),
            C((R(out_id, Side.I_MIN, 0, nc.out_i),
               R(down_id, Side.I_MIN, len(down_i_min) - 1 - nc.out_i, len(down_i_min) - 1))),

            C((R(out_id, Side.I_MAX, 0, nc.out_i),
               R(up_id, Side.J_MIN, 0, nc.out_i))),
            C((R(up_id, Side.I_MAX, 0, nc.bulge),
               R(downstream_id, Side.J_MIN, len(downstream_j_min) - 1 - nc.bulge, len(downstream_j_min) - 1))),

            C((R(blade_up_id, Side.I_MAX, 0, nc.in_up_j),
               R(in_id, Side.J_MIN, nc.in_up_j, 0))),
            C((R(blade_up_id, Side.I_MAX, nc.in_up_j, nc.in_up_j + nc.middle_i + nc.bulge + nc.out_i),
               R(up_id, Side.I_MIN, len(up_i_min) - 1 - nc.in_i, 0))),
            C((R(blade_up_id, Side.I_MAX, nc.in_up_j + nc.bulge + nc.middle_i + nc.out_i, len(blade_up_i_max) - 1),
               R(out_id, Side.J_MIN, len(out_j_min) - 1, nc.out_down_j))),

            C((R(blade_down_id, Side.I_MAX, 0, nc.in_down_j),
               R(in_id, Side.J_MIN, nc.in_up_j, len(in_j_min) - 1))),
            C((R(blade_down_id, Side.I_MAX, nc.in_down_j, nc.in_down_j + nc.middle_i),
               R(down_id, Side.I_MIN, nc.in_i, len(down_i_min) - 1 - nc.out_i))),
            C((R(blade_down_id, Side.I_MAX, nc.in_down_j + nc.middle_i, len(blade_down_i_max) - 1),
               R(out_id, Side.J_MIN, 0, nc.out_down_j))),

            C((R(upstream_id, Side.I_MIN, 0, nc.upstream_i),
               R(upstream_id, Side.I_MAX, 0, nc.upstream_i)), pitch_vec),
            C((R(down_id, Side.I_MAX, 0, len(down_i_max) - 1),
               R(up_id, Side.I_MAX, len(up_i_max) - 1, len(up_i_max) - len(down_i_max))), pitch_vec),
            C((R(downstream_id, Side.I_MIN, 0, nc.downstream_i),
               R(downstream_id, Side.I_MAX, 0, nc.downstream_i)), pitch_vec),
        ]

        # ---- Boundary conditions (O4H.zig:518-521) --------------------------
        mesh.boundary_conditions += [
            Condition(Range(upstream_id, Side.J_MIN, 0, len(upstream_j_min) - 1), BCKind.INLET),
            Condition(Range(downstream_id, Side.J_MAX, 0, len(downstream_j_max) - 1), BCKind.OUTLET),
        ]

        return mesh


def project_normal(edge_points: np.ndarray, distance: float) -> np.ndarray:
    """Offset a polyline along its (rotated-tangent) normals (O4H.zig:531-574).

    Interior points use central differences; endpoints one-sided. The normal
    is the tangent rotated by -90deg: n = (t_y, -t_x)/|t|.
    """
    p = np.asarray(edge_points, dtype=Float)
    t = np.empty_like(p)
    t[1:-1] = 0.5 * (p[2:] - p[:-2])
    t[0] = p[1] - p[0]
    t[-1] = p[-1] - p[-2]
    n = np.stack([t[:, 1], -t[:, 0]], axis=1)
    n /= np.sqrt(np.sum(t * t, axis=1))[:, None]
    return p + Float(distance) * n
