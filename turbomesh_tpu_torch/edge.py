"""Discrete edges: point lists with their clustering, views, and merging.

Reference parity: src/core/discrete.zig (Edge, EdgeView, Edge.combine).

Edge.combine semantics determine node placement on shared block faces and
must match the reference exactly (SURVEY.md §7.3 item 2):

- consecutive views must meet within EDGE_MERGE_TOL; the shared point is
  taken from the *later* view (the reference memcpy overwrites it);
- the merged clustering is a cumulative sum of per-view clustering deltas
  taken in *ascending index order of the underlying edge* (even when the
  view is reversed!), rescaled to [0, 1]  (discrete.zig:119-135, 72-84).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .types import Float, EDGE_MERGE_TOL
from .clustering import ClusteringFunction
from .geometry import Curve


@dataclasses.dataclass
class Edge:
    """Discretized curve: (N, 2) points and length-N clustering in [0,1]."""

    points: np.ndarray
    clustering: np.ndarray

    @staticmethod
    def from_curve(n: int, curve: Curve, clustering: ClusteringFunction) -> "Edge":
        u = clustering(n)
        pts = curve.interpolate(u)
        return Edge(points=np.asarray(pts, dtype=Float), clustering=u)

    def view(self, start: int, end: int) -> "EdgeView":
        return EdgeView(self, start, end)

    def __len__(self) -> int:
        return len(self.points)

    @staticmethod
    def combine(views: list["EdgeView"]) -> "Edge":
        assert len(views) > 1
        for k in range(len(views) - 1):
            a = views[k].edge.points[views[k].end]
            b = views[k + 1].edge.points[views[k + 1].start]
            if not np.all(np.abs(a - b) <= EDGE_MERGE_TOL):
                raise ValueError(
                    f"edges {k} and {k + 1} cannot be combined: end points "
                    f"{a} and {b} do not match"
                )

        n = sum(v.length() for v in views) - (len(views) - 1)
        points = np.empty((n, 2), dtype=Float)
        u = np.empty(n, dtype=Float)

        # points: each view writes its full range; the shared junction point is
        # overwritten by the next view (matches reference memcpy order).
        start = 0
        for v in views:
            seg = v.clone_points()
            points[start : start + len(seg)] = seg
            start += len(seg) - 1

        # clustering: cumulative deltas in ascending underlying-index order.
        start = 0
        last_value = Float(0.0)
        for v in views:
            seg = v.clone_clustering(last_value)
            u[start : start + len(seg)] = seg
            start += len(seg) - 1
            last_value = u[start]
        u /= last_value

        return Edge(points=points, clustering=u)


@dataclasses.dataclass
class EdgeView:
    """Sub-range [start, end] of an edge; start > end means reversed
    (discrete.zig:94-136)."""

    edge: Edge
    start: int
    end: int

    def length(self) -> int:
        return abs(self.start - self.end) + 1

    def clone_points(self) -> np.ndarray:
        if self.start > self.end:
            return self.edge.points[self.end : self.start + 1][::-1].copy()
        return self.edge.points[self.start : self.end + 1].copy()

    def clone_clustering(self, initial_value: float) -> np.ndarray:
        first = min(self.start, self.end)
        last = max(self.start, self.end)
        c = self.edge.clustering
        out = np.empty(last - first + 1, dtype=Float)
        out[0] = initial_value
        # NOTE: deltas are taken from the ascending-index clustering values
        # regardless of view direction — reference behavior (discrete.zig:119-135).
        out[1:] = initial_value + (c[first + 1 : last + 1] - c[first])
        return out
