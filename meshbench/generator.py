"""The job generator: one general reader of the traffic files.

A traffic mix is a closed loop of one client: job k is the cell's
configuration with the blade profile restaggered, both sides rotated
rigidly by one angle about the profile's centroid, the angle drawn from
the traffic file's ``restagger_deg`` distribution by ``SeedSequence([seed,
k])``. The same seed gives the same jobs; pitch and cell counts stay the
configuration's. The profile goes to the program inline
(``geometry.profile.data``), and the reference gets the same job.

The traffic file's ``smooth_mesh`` object holds the keyword arguments of
the job's ``smooth_mesh`` call (``solver``; ``iterations``,
``wall_control_function`` and ``target_residual`` override the
configuration's ``smoothing`` block, which the job's configuration then
carries for the reference); its optional ``environment`` object is set
in the run's environment before set-up (the port's options that only an
environment variable reaches, such as ``TURBOMESH_DEFLATION``).
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np

#: ``smooth_mesh`` arguments that the job's configuration carries
SMOOTHING_KEYS = ("iterations", "wall_control_function", "target_residual")

#: Picard iterations of the warm-up job: the second is the first to run
#: the control function's update on the device
WARMUP_ITERATIONS = 2


@dataclasses.dataclass
class Job:
    index: int
    restagger_deg: float
    config: dict          # the run configuration of this job
    iterations: int       # Picard iterations (the cap under a target)
    smooth_mesh: dict     # the other keyword arguments of smooth_mesh


def profile_centroid(down: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Area centroid of the closed profile: the pressure side from the
    leading to the trailing edge, then the suction side back."""
    ring = np.concatenate([down[:-1], up[::-1][:-1]])
    x, y = ring[:, 0], ring[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    cross = x * yn - xn * y
    area = 0.5 * cross.sum()
    return np.array([((x + xn) * cross).sum(), ((y + yn) * cross).sum()]) \
        / (6.0 * area)


def restagger(config: dict, degrees: float) -> dict:
    """``config`` with both profile sides rotated by ``degrees`` about the
    profile's centroid (a new dict; the input is not changed)."""
    out = copy.deepcopy(config)
    data = out["geometry"]["profile"]["data"]
    down = np.asarray(data["down"], dtype=np.float64)
    up = np.asarray(data["up"], dtype=np.float64)
    if degrees != 0.0:
        c = profile_centroid(down, up)
        a = math.radians(degrees)
        rot = np.array([[math.cos(a), -math.sin(a)],
                        [math.sin(a), math.cos(a)]])
        # one expression for both sides: equal leading / trailing edge
        # points stay bit-for-bit equal, as the profile loader requires
        down = (down - c) @ rot.T + c
        up = (up - c) @ rot.T + c
    data["down"] = down.tolist()
    data["up"] = up.tolist()
    return out


def _draw(dist: dict, rng: np.random.Generator) -> float:
    (kind, params), = dist.items()
    if kind == "uniform":
        lo, hi = params
        return float(rng.uniform(lo, hi))
    raise ValueError(f"unknown distribution {kind!r}")


def _make(index: int, degrees: float, traffic: dict, config: dict) -> Job:
    cfg = restagger(config, degrees)
    call = dict(traffic["smooth_mesh"])
    smoothing = cfg.setdefault("smoothing", {})
    for key in SMOOTHING_KEYS:
        if key in call:
            smoothing[key] = call.pop(key)
    return Job(index, degrees, cfg, int(smoothing["iterations"]), call)


def job(traffic: dict, config: dict, seed: int, k: int) -> Job:
    """Job ``k`` of the stream that ``seed`` draws."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, k]))
    return _make(k, _draw(traffic["restagger_deg"], rng), traffic, config)


def warmup_job(traffic: dict, config: dict) -> Job:
    """The set-up's job, counted nowhere: the traffic's shapes and calls
    on the configuration's own blade, for ``WARMUP_ITERATIONS``."""
    w = _make(-1, 0.0, traffic, config)
    w.config["smoothing"]["iterations"] = w.iterations = WARMUP_ITERATIONS
    return w
