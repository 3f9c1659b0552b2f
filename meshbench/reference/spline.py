"""Arc-length-parameterized natural cubic fitting spline.

Reference parity: src/core/spline.zig (FittingSpline).

The curve is a natural cubic spline through the input points,
parameterized by normalized cumulative chord length. A 200-interval
lookup table maps normalized arc length in [0, 1] back into the
parameter domain (spline.zig:22,87-139). Every formula form, the sample
count, the lower-bound binary search, and the segment-selection linear
scan semantics are reproduced so node placement matches the reference
within f64 roundoff — this is load-bearing for the 1e-10 parity bar
(SURVEY.md §7.3).
"""

from __future__ import annotations

import numpy as np

from .types import Float

SAMPLE_COUNT = 200  # spline.zig:22


class FittingSpline:
    """Natural cubic spline through `points` (N, dim), chord-length params,
    arc-length inverse lookup. Degree must be 3 (spline.zig:25)."""

    def __init__(self, points, degree: int = 3):
        if degree != 3:
            raise ValueError("unsupported degree (must be 3)")
        pts = np.asarray(points, dtype=Float)
        if pts.ndim != 2 or len(pts) < 2:
            raise ValueError("need at least 2 points of shape (N, dim)")
        self.points = pts.copy()
        self.params, total_chord = _chord_params(self.points)
        # natural spline second derivatives per dimension (spline.zig:157-200)
        self.second_derivs = np.stack(
            [_second_derivs(self.params, self.points[:, d]) for d in range(pts.shape[1])],
            axis=1,
        )  # (N, dim)
        self.total_length = total_chord
        self._build_arc_length_table()

    # -- public API (mirrors reference names) --------------------------------

    def interpolate(self, u) -> np.ndarray:
        """Evaluate at arc-length fractions u (array-like in [0,1]) -> (M, dim)."""
        u = np.atleast_1d(np.asarray(u, dtype=Float))
        params = self.param_at_arc_fraction(u)
        return self.eval(params)

    def integrate(self) -> float:
        """Total (sampled) arc length (spline.zig:83-85)."""
        return float(self.total_length)

    # -- internals ------------------------------------------------------------

    def _build_arc_length_table(self):
        # sample parameters evenly in the spline domain (spline.zig:87-110)
        sp = np.arange(SAMPLE_COUNT + 1, dtype=Float) / Float(SAMPLE_COUNT)
        vals = self.eval(sp)
        seg = np.sqrt(np.sum(np.diff(vals, axis=0) ** 2, axis=1))
        arc = np.concatenate([[0.0], np.cumsum(seg)])
        length = arc[-1]
        self.sample_params = sp
        self.total_length = length
        if length == 0.0:
            self.sample_arc = np.zeros_like(arc)
        else:
            self.sample_arc = arc / length

    def param_at_arc_fraction(self, u) -> np.ndarray:
        """Inverse arc-length mapping via lower-bound search on the LUT
        with linear interpolation (spline.zig:112-139)."""
        u = np.atleast_1d(np.asarray(u, dtype=Float))
        if self.total_length == 0.0:
            return np.zeros_like(u)
        target = np.clip(u, 0.0, 1.0)
        # lower-bound: first index with sample_arc[lo] >= target
        lo = np.searchsorted(self.sample_arc, target, side="left")
        out = np.empty_like(target)
        at_zero = lo == 0
        out[at_zero] = self.sample_params[0]
        mid = ~at_zero
        lo_m = lo[mid]
        a0 = self.sample_arc[lo_m - 1]
        a1 = self.sample_arc[lo_m]
        p0 = self.sample_params[lo_m - 1]
        p1 = self.sample_params[lo_m]
        t = np.where(a1 > a0, (target[mid] - a0) / np.where(a1 > a0, a1 - a0, 1.0), 0.0)
        out[mid] = p0 + t * (p1 - p0)
        return out

    def eval(self, param) -> np.ndarray:
        """Evaluate the cubic at raw parameter values (clamped to [0,1]).

        Segment selection mirrors the reference's linear scan
        (spline.zig:202-222): idx = first segment with params[idx+1] >= u,
        clamped to the last segment.
        """
        u = np.clip(np.atleast_1d(np.asarray(param, dtype=Float)), 0.0, 1.0)
        n = len(self.params)
        # count of knots in params[1:] strictly below u == reference scan result
        idx = np.searchsorted(self.params[1:], u, side="left")
        idx = np.minimum(idx, n - 2)
        h = self.params[idx + 1] - self.params[idx]
        a = (self.params[idx + 1] - u) / h
        b = (u - self.params[idx]) / h
        y0 = self.points[idx]
        y1 = self.points[idx + 1]
        z0 = self.second_derivs[idx]
        z1 = self.second_derivs[idx + 1]
        a_ = a[:, None]
        b_ = b[:, None]
        h_ = h[:, None]
        return (
            a_ * y0
            + b_ * y1
            + ((a_**3 - a_) * z0 + (b_**3 - b_) * z1) * (h_ * h_) / 6.0
        )


def _chord_params(points: np.ndarray):
    """Normalized cumulative chord-length parameters (spline.zig:141-155)."""
    seg = np.sqrt(np.sum(np.diff(points, axis=0) ** 2, axis=1))
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = cum[-1]
    if total == 0.0:
        n = len(points)
        return np.arange(n, dtype=Float) / Float(n - 1), 0.0
    return cum / total, total


def _second_derivs(params: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Natural-spline second derivatives via the reference's tridiagonal
    forward elimination / back substitution (spline.zig:157-200)."""
    n = len(params)
    z = np.zeros(n, dtype=Float)
    if n == 2:
        return z
    tmp = np.zeros(n, dtype=Float)
    for i in range(1, n - 1):
        h_im1 = params[i] - params[i - 1]
        h_i = params[i + 1] - params[i]
        if h_im1 == 0.0 or h_i == 0.0:
            raise ValueError("coincident spline parameters")
        dy_im1 = y[i] - y[i - 1]
        dy_i = y[i + 1] - y[i]
        alpha = (dy_i / h_i) - (dy_im1 / h_im1)
        denom = 2.0 * (params[i + 1] - params[i - 1]) - h_im1 * tmp[i - 1]
        tmp[i] = h_i / denom
        z[i] = (6.0 * alpha - h_im1 * z[i - 1]) / denom
    z[n - 1] = 0.0
    for k in range(n - 2, -1, -1):
        z[k] = z[k] - tmp[k] * z[k + 1]
    return z
