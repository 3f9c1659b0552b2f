"""Legacy-VTK structured-grid writer (multi-block as one file per block or
a single .vtm-free multi-piece legacy file is not supported by legacy VTK;
we write one STRUCTURED_GRID per file, suffixing block names).

This is the easy-golden-file output path (SURVEY.md §7.2 step 3).
"""

from __future__ import annotations

import os


def write_vtk(mesh, filename: str) -> None:
    """Write each block as `<stem>_<blockname>.vtk` legacy STRUCTURED_GRID.

    If the mesh has a single block, writes exactly `filename`.
    """
    stem, ext = os.path.splitext(filename)
    single = len(mesh.blocks) == 1
    for name, block in zip(mesh.names, mesh.blocks):
        path = filename if single else f"{stem}_{name}{ext}"
        _write_block(block, name, path)


def _write_block(block, name: str, path: str) -> None:
    ni, nj = block.size
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(f"turbomesh_tpu block {name}\n")
        f.write("ASCII\n")
        f.write("DATASET STRUCTURED_GRID\n")
        # VTK dimensions are (x-fastest); our j is fastest in memory, so
        # emit dimensions (nj, ni, 1) and iterate i-outer, j-inner.
        f.write(f"DIMENSIONS {nj} {ni} 1\n")
        f.write(f"POINTS {ni * nj} double\n")
        pts = block.points
        for i in range(ni):
            for j in range(nj):
                f.write(f"{pts[i, j, 0]:.17g} {pts[i, j, 1]:.17g} 0\n")
