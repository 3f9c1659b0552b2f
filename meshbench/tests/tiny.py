"""Small configurations for the CPU tests, cut from the cells' own."""

from __future__ import annotations

import copy
import json
import pathlib

from meshbench import manifest

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"

#: O4H cell counts of the repository's small-O4H test mesh (1,174 points)
SMALL_CELLS = {
    "o_grid": 6, "middle_i": 12, "in_up_j": 6, "in_down_j": 5, "in_i": 5,
    "out_up_j": 6, "out_down_j": 5, "out_i": 5, "down_j": 6, "bulge": 6,
    "upstream_i": 5, "downstream_i": 5,
}


def t106() -> dict:
    with open(CONFIGS / "t106.json") as f:
        return json.load(f)


def small(wall="laplace", iterations=3) -> dict:
    """T106's profile on the small O4H mesh."""
    cfg = t106()
    cfg["template"]["O4H"]["num_cells"] = dict(SMALL_CELLS)
    cfg["smoothing"]["iterations"] = iterations
    cfg["smoothing"]["wall_control_function"] = wall
    return cfg


def half_t106(iterations=3) -> dict:
    """T106 with every cell count halved (6,563 points) and a White wall
    control the small mesh resolves (ds_target 1e-4)."""
    cfg = t106()
    o4h = cfg["template"]["O4H"]
    o4h["num_cells"] = {k: v // 2 for k, v in o4h["num_cells"].items()}
    cfg["smoothing"]["iterations"] = iterations
    cfg["smoothing"]["wall_control_function"] = {"white": {"ds_target": 1e-4}}
    return cfg


def cell(config: dict, limits=None, per_layer=()) -> manifest.Cell:
    """A one-chip design-loop cell of ``config``."""
    with open(manifest.PACKAGE / "traffic" / "design_loop.json") as f:
        traffic = json.load(f)
    spec = {"limits": limits or {"frontend_gap": 1e-10,
                                 "step_residual": 0.05},
            "profile": {"after_iteration": 1, "iterations": 1}}
    return manifest.Cell("small.design_loop", 1, copy.deepcopy(config),
                         traffic, spec,
                         [{"name": "mesh_s", "unit": "s"},
                          {"name": "setup_s", "unit": "s"}],
                         [{"name": n, "unit": "-"} for n in per_layer])
