"""Foundation scalar/array types and tolerances.

Reference parity: src/core/types.zig (Float = f64, Mat2d block storage with
linear index ``j + Nj * i``, i.e. row-major with j fastest).

In this framework a *block* is a dense ``(Ni, Nj, 2)`` float64 array; the
flat (C-order) view of its first two axes reproduces the reference's global
point ordering exactly.
"""

from __future__ import annotations

import numpy as np

Float = np.float64

# Tolerances mirrored from the reference:
#   edge-merge & TFI corner coincidence (discrete.zig:41, tfi.zig:150)
EDGE_MERGE_TOL = 1e-10
#   connection point coincidence check before smoothing (smooth.zig:221)
CONNECTION_TOL = 1e-15
#   junction (laplacian) point coincidence (smooth.zig:1419)
JUNCTION_TOL = 1e-12


def as_points(a) -> np.ndarray:
    """Coerce input to an (N, 2) float64 point array."""
    arr = np.asarray(a, dtype=Float)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"expected (N, 2) point array, got shape {arr.shape}")
    return arr
