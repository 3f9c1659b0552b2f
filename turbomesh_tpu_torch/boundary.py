"""Multi-block boundary topology: sides, ranges, connections, conditions.

Reference parity: src/core/boundary.zig.

Side naming follows the reference convention (boundary.zig:28-61): the name
says which index *varies along the side*:

  I_MIN : points (i, 0),        i varies, j = 0
  I_MAX : points (i, Nj-1),     i varies, j = Nj-1
  J_MIN : points (0, j),        j varies, i = 0
  J_MAX : points (Ni-1, j),     j varies, i = Ni-1

A Range walks flat (C-order, j fastest) point ids of one block side from
`start` to `end` inclusive; start > end iterates in reverse.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class Side(enum.Enum):
    I_MIN = "i_min"
    I_MAX = "i_max"
    J_MIN = "j_min"
    J_MAX = "j_max"


class BCKind(enum.Enum):
    WALL = "wall"
    INLET = "inlet"
    OUTLET = "outlet"


@dataclasses.dataclass(frozen=True)
class Range:
    """(block, side, start, end) index range along a block side."""

    block: int
    side: Side
    start: int
    end: int

    def __len__(self) -> int:
        return abs(self.start - self.end) + 1

    def _base_increment(self, size) -> tuple[int, int]:
        """(first flat id, along-side flat increment) for ascending start."""
        ni, nj = size
        if self.side is Side.I_MIN:
            return self.start * nj, nj
        if self.side is Side.I_MAX:
            return self.start * nj + (nj - 1), nj
        if self.side is Side.J_MIN:
            return self.start, 1
        if self.side is Side.J_MAX:
            return (ni - 1) * nj + self.start, 1
        raise AssertionError

    def flat_indices(self, size) -> np.ndarray:
        """Flat point ids along the range, honoring direction
        (boundary.zig:28-61). `size` is the block's (Ni, Nj)."""
        idx0, inc = self._base_increment(size)
        n = len(self)
        if self.start > self.end:
            inc = -inc
        return idx0 + inc * np.arange(n, dtype=np.int64)

    def endpoints(self, size) -> tuple[int, int]:
        """Block-local flat ids of the two range endpoints (boundary.zig:64-75).
        NOTE: order is (start, end) as given, not sorted."""
        ni, nj = size
        if self.side is Side.I_MIN:
            return self.start * nj, self.end * nj
        if self.side is Side.J_MAX:
            base = (ni - 1) * nj
            return base + self.start, base + self.end
        if self.side is Side.I_MAX:
            return self.start * nj + nj - 1, self.end * nj + nj - 1
        if self.side is Side.J_MIN:
            return self.start, self.end
        raise AssertionError

    def first_internal_point_shift(self, size) -> int:
        """Flat-index offset from a side point to its first interior neighbor
        (boundary.zig:78-97)."""
        ni, nj = size
        return {
            Side.I_MIN: 1,
            Side.I_MAX: -1,
            Side.J_MIN: nj,
            Side.J_MAX: -nj,
        }[self.side]

    def in_connection_direction_shift(self, size) -> int:
        """Flat-index increment that walks along the side in range direction
        (smooth.zig:1556-1598)."""
        _, inc = self._base_increment(size)
        return -inc if self.start > self.end else inc


@dataclasses.dataclass(frozen=True)
class Connection:
    """Two coincident ranges; periodicity (if set) maps range[0] to range[1]:
    x(range0) + periodicity == x(range1)  (boundary.zig:119-162)."""

    ranges: tuple[Range, Range]
    periodicity: tuple[float, float] | None = None

    def __len__(self) -> int:
        n = len(self.ranges[0])
        assert n == len(self.ranges[1])
        return n


@dataclasses.dataclass(frozen=True)
class Condition:
    """Boundary condition on a block side range (boundary.zig:178-187)."""

    range: Range
    kind: BCKind
