"""Run-time JSON configuration — schema-compatible with the reference.

Reference parity: src/core/input.zig (Input struct = the JSON schema),
src/core/csv.zig (space-delimited 2-column profile reader).

The same JSON files that drive the reference (examples/LS89/LS89.json,
examples/T106/T106.json) drive this framework unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .types import Float, as_points
from .machine import Profile, Geometry
from .profiling import span
from . import templates as templates_mod


@dataclasses.dataclass
class SmoothingConfig:
    iterations: int = 0
    solver: dict | str = "jacobi_cg"
    wall_control_function: dict | str = "laplace"


@dataclasses.dataclass
class Input:
    template: object  # templates.O4H
    smoothing: SmoothingConfig
    pitch: float
    profile: Profile
    output: str | None = None
    gui: bool | None = None

    @property
    def geometry(self) -> Geometry:
        return Geometry(pitch=self.pitch, profile=self.profile)


def parse_csv_points(path: str) -> np.ndarray:
    """Space-delimited two-float-per-line parser with '#' comments
    (csv.zig:10-57)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) != 2:
                raise ValueError(f"csv parsing error in {path}: {line!r}")
            rows.append([Float(parts[0]), Float(parts[1])])
    return np.array(rows, dtype=Float)


def _resolve_path(path: str, base_dir: str) -> str:
    """Resolve a profile CSV path: absolute, then base_dir-relative, then
    CWD-relative, then walking up from base_dir (the reference resolves
    paths from the CWD, and its example configs use repo-root-relative
    paths like 'examples/T106/T106_ps.dat')."""
    if os.path.isabs(path):
        return path
    candidates = [os.path.join(base_dir, path), path]
    d = os.path.abspath(base_dir)
    while True:
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
        candidates.append(os.path.join(d, path))
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(f"profile csv {path!r} not found (tried {candidates})")


def _read_side(path: str) -> np.ndarray:
    """CSV side with x-direction normalization by reversal (input.zig:100-108)."""
    side = parse_csv_points(path)
    if side[0, 0] > side[-1, 0]:
        side = side[::-1].copy()
    return side


def create_profile(profile_cfg: dict, scale: float = 1.0, base_dir: str = ".") -> Profile:
    """Build a Profile from the tagged-union profile config
    (input.zig:43-90): {"data": {down, up}} or {"csv": {down_csv_path, up_csv_path}}."""
    (tag, params), = profile_cfg.items()
    if tag == "data":
        down = as_points(params["down"])
        up = as_points(params["up"])
    elif tag == "csv":
        down = _read_side(_resolve_path(params["down_csv_path"], base_dir))
        up = _read_side(_resolve_path(params["up_csv_path"], base_dir))
    else:
        raise ValueError(f"unknown profile input {tag!r}")
    if scale != 1.0:
        down = down * Float(scale)
        up = up * Float(scale)
    return Profile.from_points(down, up)


def load(path_or_dict, base_dir: str | None = None) -> Input:
    """Load a run configuration from a JSON file path or a parsed dict."""
    with span("load"):
        if isinstance(path_or_dict, (str, os.PathLike)):
            if base_dir is None:
                # reference resolves csv paths relative to the CWD; we
                # default to the config file's directory unless paths
                # resolve from CWD
                base_dir = "."
            with open(path_or_dict) as f:
                cfg = json.load(f)
        else:
            cfg = path_or_dict
            if base_dir is None:
                base_dir = "."

        geo = cfg["geometry"]
        scale = geo.get("scale", 1.0)
        profile = create_profile(geo["profile"], scale=scale,
                                 base_dir=base_dir)

        sm = cfg.get("smoothing", {})
        smoothing = SmoothingConfig(
            iterations=sm.get("iterations", 0),
            solver=sm.get("solver", "jacobi_cg"),
            wall_control_function=sm.get("wall_control_function", "laplace"),
        )

        return Input(
            template=templates_mod.from_config(cfg["template"]),
            smoothing=smoothing,
            # the reference scales the pitch by the geometry scale factor
            # along with the profile (gui/main.zig:45, wasm/lib.zig:41:
            # Geometry.init(input.geometry.scale * input.geometry.pitch,
            # ..)); LS89's mm-coordinates (scale 1e-3, pitch 57.5) are
            # inconsistent without it — pitch 1600x chord — and White
            # smoothing diverges
            pitch=Float(geo["pitch"]) * Float(scale),
            profile=profile,
            output=cfg.get("output"),
            gui=cfg.get("gui"),
        )
