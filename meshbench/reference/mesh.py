"""Multi-block structured mesh: dense per-block coordinate arrays.

Reference parity: src/core/discrete.zig (Block2d, Mesh).

A Block2d holds an (Ni, Nj, 2) float64 array whose C-order flattening of
the first two axes matches the reference's Mat2d linear index j + Nj*i.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .types import Float
from .edge import Edge
from .boundary import Connection, Condition
from . import tfi as tfi_mod


@dataclasses.dataclass
class Block2d:
    points: np.ndarray  # (Ni, Nj, 2) float64

    @staticmethod
    def from_edges(i_min: Edge, i_max: Edge, j_min: Edge, j_max: Edge) -> "Block2d":
        """Fill the block by boundary-blended TFI (discrete.zig:142-159)."""
        assert len(i_min) == len(i_max)
        assert len(j_min) == len(j_max)
        pts = tfi_mod.blended_tfi_np(
            i_min.points,
            i_max.points,
            j_min.points,
            j_max.points,
            i_min.clustering,
            i_max.clustering,
            j_min.clustering,
            j_max.clustering,
        )
        return Block2d(points=np.asarray(pts, dtype=Float))

    @property
    def size(self) -> tuple[int, int]:
        return self.points.shape[0], self.points.shape[1]

    def __len__(self) -> int:
        return self.points.shape[0] * self.points.shape[1]


@dataclasses.dataclass
class Mesh:
    blocks: list[Block2d] = dataclasses.field(default_factory=list)
    names: list[str] = dataclasses.field(default_factory=list)
    connections: list[Connection] = dataclasses.field(default_factory=list)
    boundary_conditions: list[Condition] = dataclasses.field(default_factory=list)
    # blocks whose j_min side is a viscous wall, declared by the template
    # (SURVEY.md §7.3 item 5: the reference hard-codes blocks 0..1 inside
    # the White control function, wall_control_function.zig:72; here the
    # topology declares them so boundary-layer forcing generalizes)
    wall_blocks: list[int] = dataclasses.field(default_factory=list)

    def add_block(self, name: str, block: Block2d) -> int:
        self.blocks.append(block)
        self.names.append(name)
        return len(self.blocks) - 1

    @property
    def num_points(self) -> int:
        return sum(len(b) for b in self.blocks)

    def block_row_starts(self) -> np.ndarray:
        """Global flat point-index start of each block (smooth.zig:1623-1637)."""
        sizes = [len(b) for b in self.blocks]
        return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)

    def flat_coords(self) -> np.ndarray:
        """All block coordinates concatenated in global point order -> (P, 2)."""
        return np.concatenate([b.points.reshape(-1, 2) for b in self.blocks], axis=0)

    def set_flat_coords(self, coords: np.ndarray) -> None:
        starts = self.block_row_starts()
        for b, s in zip(self.blocks, starts):
            n = len(b)
            b.points[...] = coords[s : s + n].reshape(b.points.shape)
