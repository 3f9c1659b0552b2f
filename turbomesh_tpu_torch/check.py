"""Mesh topology integrity checks.

Reference parity: smooth.zig:220-275 (connectionDataCheck) — every
connection's two ranges must hold coincident point locations (offset by the
periodicity vector for periodic connections) within CONNECTION_TOL.
"""

from __future__ import annotations

import numpy as np

from .types import CONNECTION_TOL


def check_connections(mesh, tol: float | None = None) -> None:
    """Verify coincidence of all connection point pairs.

    Deliberate deviation from the reference: the tolerance is scale-aware,
    ``max(1e-15, 4 ulp of the largest coordinate magnitude)``. The reference
    uses absolute 1e-15 (smooth.zig:221), but its own TFI boundary evaluation
    carries ~1 ulp of noise relative to coordinate magnitude (the
    ``(u_ij + v_ij) - uv_ij`` projector rounds at the magnitude of the corner
    terms), so an absolute tolerance is unsatisfiable for meshes with
    coordinates much larger than 1 (e.g. LS89, where the example config's
    unscaled pitch of 57.5 produces O(30) coordinates).
    """
    if tol is None:
        max_mag = max(
            (float(np.abs(b.points).max()) for b in mesh.blocks), default=1.0
        )
        tol = max(CONNECTION_TOL, 4.0 * np.finfo(np.float64).eps * max_mag)
    for ci, conn in enumerate(mesh.connections):
        r0, r1 = conn.ranges
        b0 = mesh.blocks[r0.block]
        b1 = mesh.blocks[r1.block]
        idx0 = r0.flat_indices(b0.size)
        idx1 = r1.flat_indices(b1.size)
        if len(idx0) != len(idx1):
            raise ValueError(f"connection {ci}: range lengths differ "
                             f"({len(idx0)} vs {len(idx1)})")
        p0 = b0.points.reshape(-1, 2)[idx0]
        p1 = b1.points.reshape(-1, 2)[idx1]
        if conn.periodicity is not None:
            p0 = p0 + np.asarray(conn.periodicity)
        err = np.abs(p0 - p1).max()
        if err > tol:
            k = int(np.abs(p0 - p1).max(axis=1).argmax())
            raise ValueError(
                f"non matching points for connection {ci} point {k}: "
                f"{p0[k]} vs {p1[k]} (err {err:.3e})"
            )
