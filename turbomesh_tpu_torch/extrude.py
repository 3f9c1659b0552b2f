"""3-D meshes from stacked 2-D cuts.

The reference roadmap lists "3D: multiple stacked 2D cuts" and "radial
configurations" as planned-but-unimplemented (README.md:19-21). A 3-D
block is a batched stack of 2-D cuts — ``(Nk, Ni, Nj, 3)`` with the
spanwise cut axis leading, so every per-cut operation (TFI, smoothing)
runs over it unchanged.

A jax-free copy of turbomesh_tpu/extrude.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .types import Float
from .mesh import Mesh


@dataclasses.dataclass
class Block3d:
    points: np.ndarray  # (Nk, Ni, Nj, 3)

    @property
    def size(self):
        return self.points.shape[:3]


@dataclasses.dataclass
class Mesh3d:
    blocks: list[Block3d]
    names: list[str]

    @property
    def num_points(self) -> int:
        return sum(int(np.prod(b.size)) for b in self.blocks)

    def write(self, filename: str) -> None:
        from .io.cgns3d import write_cgns3d

        write_cgns3d(self, filename)


def extrude(mesh: Mesh, spans, twist=None, scale=None, stack_axis: int = 2) -> Mesh3d:
    """Linear extrusion of a 2-D multi-block mesh into 3-D.

    spans: (Nk,) spanwise coordinates of the cuts.
    twist: optional (Nk,) rotation angle (radians) applied about the
        centroid of each cut (simple swept-blade stacking).
    scale: optional (Nk,) in-plane scale factor per cut.
    """
    spans = np.asarray(spans, dtype=Float)
    nk = len(spans)
    if twist is not None:
        twist = np.asarray(twist, dtype=Float)
        assert len(twist) == nk
    if scale is not None:
        scale = np.asarray(scale, dtype=Float)
        assert len(scale) == nk

    blocks3 = []
    for blk in mesh.blocks:
        pts2 = blk.points  # (Ni, Nj, 2)
        cuts = np.broadcast_to(pts2, (nk,) + pts2.shape).copy()
        if twist is not None or scale is not None:
            centroid = pts2.reshape(-1, 2).mean(axis=0)
            rel = cuts - centroid
            if scale is not None:
                rel = rel * scale[:, None, None, None]
            if twist is not None:
                c = np.cos(twist)[:, None, None]
                s = np.sin(twist)[:, None, None]
                x = c * rel[..., 0] - s * rel[..., 1]
                y = s * rel[..., 0] + c * rel[..., 1]
                rel = np.stack([x, y], axis=-1)
            cuts = centroid + rel
        z = np.broadcast_to(spans[:, None, None], cuts.shape[:3])
        pts3 = np.concatenate([cuts, z[..., None]], axis=-1)
        blocks3.append(Block3d(points=pts3))

    return Mesh3d(blocks=blocks3, names=list(mesh.names))


def from_cuts(meshes: list[Mesh], spans) -> Mesh3d:
    """3-D mesh from independently generated 2-D cuts (e.g. different blade
    sections per span). All cuts must share block shapes and topology."""
    spans = np.asarray(spans, dtype=Float)
    assert len(meshes) == len(spans)
    n_blocks = len(meshes[0].blocks)
    for m in meshes[1:]:
        assert len(m.blocks) == n_blocks
        for a, b in zip(m.blocks, meshes[0].blocks):
            assert a.size == b.size, "cut block shapes must match"

    blocks3 = []
    for bi in range(n_blocks):
        cuts = np.stack([m.blocks[bi].points for m in meshes])  # (Nk, Ni, Nj, 2)
        z = np.broadcast_to(spans[:, None, None], cuts.shape[:3])
        blocks3.append(Block3d(points=np.concatenate([cuts, z[..., None]], axis=-1)))
    return Mesh3d(blocks=blocks3, names=list(meshes[0].names))
