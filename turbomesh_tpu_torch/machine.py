"""Turbomachinery geometry: blade profile and cascade pitch.

Reference parity: src/core/machine.zig (Geometry, Profile).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .types import as_points
from .spline import FittingSpline


@dataclasses.dataclass
class Profile:
    """Blade profile as two fitting splines: pressure side (down) and
    suction side (up), both running leading edge -> trailing edge
    (machine.zig:17-45)."""

    down_part: FittingSpline
    up_part: FittingSpline

    @staticmethod
    def from_points(down, up) -> "Profile":
        down = as_points(down)
        up = as_points(up)
        if not np.array_equal(down[0], up[0]):
            raise ValueError("Leading edge of suction and pressure side must be equal.")
        if not np.array_equal(down[-1], up[-1]):
            raise ValueError("Trailing edge of suction and pressure side must be equal.")
        assert len(down) > 1
        assert down[0, 0] < down[-1, 0]
        return Profile(
            down_part=FittingSpline(down, degree=3),
            up_part=FittingSpline(up, degree=3),
        )


@dataclasses.dataclass
class Geometry:
    pitch: float
    profile: Profile
