"""Run configuration -> blocking template and geometry.

Frozen copy of the port's ``input`` for configurations whose profile is
given inline (``geometry.profile.data``), as the benchmark's jobs give it.
Reference parity: src/core/input.zig.
"""

from __future__ import annotations

import dataclasses

from .machine import Geometry, Profile
from .o4h import O4H
from .types import Float, as_points


@dataclasses.dataclass
class Input:
    template: O4H
    smoothing: dict
    pitch: float
    profile: Profile

    @property
    def geometry(self) -> Geometry:
        return Geometry(pitch=self.pitch, profile=self.profile)


def create_profile(profile_cfg: dict, scale: float = 1.0) -> Profile:
    """Profile from ``{"data": {"down": [[x, y], ...], "up": [...]}}``."""
    (tag, params), = profile_cfg.items()
    if tag != "data":
        raise ValueError(f"reference front end takes inline profiles, "
                         f"got {tag!r}")
    down = as_points(params["down"])
    up = as_points(params["up"])
    if scale != 1.0:
        down = down * Float(scale)
        up = up * Float(scale)
    return Profile.from_points(down, up)


def load(cfg: dict) -> Input:
    (tag, params), = cfg["template"].items()
    if tag != "O4H":
        raise ValueError(f"unknown template {tag!r}")
    geo = cfg["geometry"]
    scale = geo.get("scale", 1.0)
    return Input(
        template=O4H.from_config(params),
        smoothing=cfg.get("smoothing", {}),
        # the pitch scales with the geometry (gui/main.zig:45)
        pitch=Float(geo["pitch"]) * Float(scale),
        profile=create_profile(geo["profile"], scale=scale),
    )


def build_mesh(cfg: dict):
    """The front end: O4H blocking and TFI node placement."""
    inp = load(cfg)
    return inp.template.run(inp.geometry)
