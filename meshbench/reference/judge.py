"""The comparisons that decide ``correct``, and the control's readings.

A job's answer is judged as the program produced it: the front end's
mesh x_0, the coordinates after each Picard iteration x_1 .. x_{n-1}, and
the final mesh x_n that the job hands back. The reference works the rest
out again from the job's configuration: its own blocking and TFI, and
along the program's trajectory its own control function (White's init
and feedback) and each step's linearized Winslow system.

Numbers compared (each against its limit in the cell's file):

- ``frontend_gap``: max |x_0 - reference front end|;
- ``step_residual``: the largest over the n steps of
  ``winslow.residual_ratio``: how far the program's x_{i+1} solves the
  step from x_i with the control function the reference derives. The
  program's solves stop at a relative tolerance, so it reads small but
  not 0; a step left out reads 1.
"""

from __future__ import annotations

import numpy as np

from .classify import classify
from .control_function import from_config
from .input import build_mesh
from .winslow import WinslowSystem, residual_ratio, solve


def _trajectory(cfg, x0, steps, final):
    """The states x_0 .. x_n: the program's front-end mesh, its states
    after iterations 1 .. n-1 and its final mesh. n is the configuration's
    ``iterations``, or fewer where a ``target_residual`` is set and the
    last step's displacement residual, (|dx|^2 + |dy|^2)^2 as the Picard
    loop reckons it, is below it."""
    smoothing = cfg["smoothing"]
    n, ran = int(smoothing["iterations"]), len(steps)
    states = [np.asarray(x0)] + [np.asarray(s) for s in steps[:-1]] + \
        [np.asarray(final)]
    target = smoothing.get("target_residual")
    stopped = (target is not None and 0 < ran < n
               and np.sum((states[-1] - states[-2]) ** 2) ** 2 < target)
    if ran != n and not stopped:
        raise ValueError(f"the job ran {ran} Picard iterations, the "
                         f"configuration asks for {n}")
    return states


def step_systems(cfg, mesh, states):
    """Yield (i, the Winslow assembler, the control function of step i)
    along ``states``, the control function worked out as the Picard loop
    does: White's init from x_0, its feedback from x_i before step i > 0.
    ``mesh`` (the reference's) takes each state in turn."""
    algorithm = from_config(cfg["smoothing"].get("wall_control_function",
                                                 "laplace"))
    winslow = WinslowSystem(mesh, classify(mesh))
    cf = None
    for i in range(len(states) - 1):
        mesh.set_flat_coords(states[i])
        if i == 0:
            cf = algorithm.init(mesh)
        else:
            algorithm.update(cf, mesh)
        yield i, winslow, cf


def judge(cfg, x0, steps, final) -> dict:
    """The compared numbers of one job (module docstring). ``steps``: the
    program's coordinates after each iteration (n of them; the last is
    replaced by ``final``, the mesh the job handed back)."""
    states = _trajectory(cfg, x0, steps, final)
    mesh = build_mesh(cfg)
    out = {"frontend_gap": float(np.max(np.abs(mesh.flat_coords() - x0)))}
    worst = 0.0
    for i, winslow, cf in step_systems(cfg, mesh, states):
        systems = winslow.systems(states[i], cf)
        worst = max(worst, residual_ratio(systems, states[i], states[i + 1]))
    out["step_residual"] = worst
    return out


def control_readings(cfg, x0, steps, final, which=None,
                     dtype=np.float32) -> dict:
    """The control: at each step of the program's trajectory (or those
    in ``which``) the reference itself takes the program's place in
    ``dtype`` (assembly and sparse LU), and its answer is judged as the
    program's is. Also the front end's answer rounded to ``dtype``.
    Returns the compared numbers of the control."""
    mesh = build_mesh(cfg)
    x0_ref = mesh.flat_coords()
    out = {"frontend_gap": float(np.max(np.abs(
        x0_ref.astype(dtype).astype(np.float64) - x0_ref)))}
    states = _trajectory(cfg, x0, steps, final)
    worst = 0.0
    for i, winslow, cf in step_systems(cfg, mesh, states):
        if which is not None and i not in which:
            continue
        x_low = solve(winslow.systems(states[i], cf, dtype)).astype(np.float64)
        worst = max(worst, residual_ratio(winslow.systems(states[i], cf),
                                          states[i], x_low))
    out["step_residual"] = worst
    return out
