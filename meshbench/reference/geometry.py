"""Parametric curves: straight lines and fitting splines.

Reference parity: src/core/geometry.zig (Curve union, Line.interpolate).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .types import Float
from .spline import FittingSpline


@dataclasses.dataclass(frozen=True)
class Line:
    """Straight segment from start to end, sampled at clustering u in [0,1]
    (geometry.zig:18-41)."""

    start: tuple
    end: tuple

    def interpolate(self, clustering: np.ndarray) -> np.ndarray:
        u = np.asarray(clustering, dtype=Float)
        assert u[0] == 0.0 and u[-1] == 1.0
        start = np.asarray(self.start, dtype=Float)
        end = np.asarray(self.end, dtype=Float)
        dx = end - start
        return start[None, :] + u[:, None] * dx[None, :]


# A Curve is anything with .interpolate(clustering) -> (N, 2): Line or FittingSpline.
Curve = Line | FittingSpline
