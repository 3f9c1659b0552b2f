"""Edge clustering (stretching) laws.

Reference parity: src/core/clustering.zig
  - Uniform          (clustering.zig:9-17)
  - Roberts          (clustering.zig:24-42)
  - Vinokur single-sided hyperbolic tangent (clustering.zig:56-95,
    Vinokur JCP 50 (1983) eqs. 63-67 series / log approximations)

All laws return a float64 array u of length n with u[0] == 0, u[-1] == 1.
These run on host (tiny 1-D arrays, irregular sizes); formulas are written
in the exact same algebraic form as the reference so node placement agrees
to f64 roundoff.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .types import Float


@dataclasses.dataclass(frozen=True)
class Uniform:
    def __call__(self, n: int) -> np.ndarray:
        return np.arange(n, dtype=Float) / Float(n - 1)


@dataclasses.dataclass(frozen=True)
class Roberts:
    """Roberts stretching. alpha=0.5 clusters both ends, alpha=0 toward u=1.

    Stretching factor beta in (1, inf); closer to 1 is stronger clustering.
    """

    alpha: float
    beta: float

    def __call__(self, n: int) -> np.ndarray:
        assert n > 1
        alpha = Float(self.alpha)
        beta = Float(self.beta)
        u = np.arange(n, dtype=Float) / Float(n - 1)
        tmp = ((beta + 1.0) / (beta - 1.0)) ** ((u - alpha) / (1.0 - alpha))
        tbar = (beta + 2.0 * alpha) * tmp - beta + 2.0 * alpha
        return tbar / ((2.0 * alpha + 1.0) * (1.0 + tmp))


@dataclasses.dataclass(frozen=True)
class SingleHyperbolic:
    """Vinokur (1983) tanh law matching first-cell spacing approximately.

    delta_s is the normalized target spacing of the first cell.
    """

    delta_s: float

    def __call__(self, n: int) -> np.ndarray:
        n_1 = Float(n - 1)
        b = n_1 * Float(self.delta_s)
        y = 1.0 / b

        # eqs. 63-67 in Vinokur 1983 (series below the crossover, log above)
        if y < 2.7829681:
            y_bar = y - 1.0
            delta = np.sqrt(6.0 * y_bar) * (
                1.0
                + y_bar
                * (
                    -0.15
                    + y_bar
                    * (
                        0.057321429
                        + y_bar
                        * (-0.024907295 + y_bar * (0.0077424461 - 0.0010794123 * y_bar))
                    )
                )
            )
        else:
            w = 1.0 / y - 0.028527431
            v = np.log(y)
            delta = (
                v
                + (1.0 + 1.0 / v) * np.log(2.0 * v)
                - 0.02041793
                + w * (0.24902722 + w * (1.9496443 + w * (-2.6294547 + 8.56795911 * w)))
            )

        xi = np.arange(n, dtype=Float) / n_1
        s = 1.0 + np.tanh(0.5 * delta * (xi - 1.0)) / np.tanh(0.5 * delta)
        out = np.empty(n, dtype=Float)
        out[0] = 0.0
        out[1:] = s[1:]
        assert out[0] == 0.0 and out[-1] == 1.0
        return out


ClusteringFunction = Uniform | Roberts | SingleHyperbolic


def from_config(cfg) -> ClusteringFunction:
    """Build a clustering law from the JSON-config tagged-union shape,
    e.g. ``{"roberts": {"alpha": 0.5, "beta": 1.03}}`` (input.zig schema)."""
    if isinstance(cfg, str):
        if cfg == "uniform":
            return Uniform()
        raise ValueError(f"unknown clustering {cfg!r}")
    (tag, params), = cfg.items()
    if tag == "uniform":
        return Uniform()
    if tag == "roberts":
        return Roberts(alpha=params["alpha"], beta=params["beta"])
    if tag == "single_hyperbolic_clustering":
        return SingleHyperbolic(delta_s=params["delta_s"])
    raise ValueError(f"unknown clustering {tag!r}")
