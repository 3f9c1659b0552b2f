#!/usr/bin/env python3
"""How far the White feedback carries a linear-solve difference.

    python3 white_sensitivity.py [--iterations 10] [--rtol 1e-10]
        [--atol 1e-12] [--device cuda|cpu]

Runs the port's DeviceSmoother on the T106 example for ``--iterations``
White Picard iterations twice, at FGMRES restart lengths 10 and 30 (the
same formulation, both converged to the same tolerances), and prints per
iteration the max |difference| of the coordinates and of the control
function and the relative difference of the displacement residuals. Two
solvers that each meet the tolerance can stand that far apart; it is the
floor under any comparison of two smoothers' White runs (chip_smoke.py
phase 8(b)). Prints the card's nvidia-smi name and power limit first when
it runs on one.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
T106 = ROOT / "examples" / "T106" / "T106.json"


def run(mesh, white, device, restart, rtol, atol, iterations):
    """Per-iteration host coords, cf and displacement residuals."""
    from turbomesh_tpu_torch.smoothing.classify import classify
    from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

    dev = DeviceSmoother(mesh, classify(mesh), device=device, rtol=rtol,
                         atol=atol, restart=restart, max_restarts=100)
    X, C = dev._upload(mesh.flat_coords(), white.init(mesh))
    upd = dev._device_update(white)
    out = []
    t0 = time.perf_counter()
    for n in range(iterations):
        if n > 0:
            C = upd(X, C)
        X, stats = dev._solve_impl(X, C, rtol)
        out.append((dev._coords_to_host(X), dev._cf_to_host(C),
                    stats.tolist()[2], dev.last_restarts))
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--rtol", type=float, default=1e-10)
    ap.add_argument("--atol", type=float, default=1e-12)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from turbomesh_tpu_torch import input as input_mod
    from turbomesh_tpu_torch.smoothing.control_function import from_config

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
    inp = input_mod.load(str(T106), base_dir=str(T106.parent))
    mesh = inp.template.run(inp.geometry)
    white = from_config(inp.smoothing.wall_control_function)
    runs = {}
    for restart in (10, 30):
        runs[restart], secs = run(mesh, white, args.device, restart,
                                  args.rtol, args.atol, args.iterations)
        print(f"restart {restart}: {secs:.2f} s, restarts per iteration "
              f"{[r[3] for r in runs[restart]]}", flush=True)
    print(f"T106, {args.iterations} White iterations, rtol {args.rtol}, "
          f"atol {args.atol}, {args.device}: restart 10 against 30")
    worst = [0.0, 0.0, 0.0]
    for n, (a, b) in enumerate(zip(runs[10], runs[30])):
        d = (float(np.abs(a[0] - b[0]).max()), float(np.abs(a[1] - b[1]).max()),
             abs(a[2] - b[2]) / abs(a[2]))
        worst = [max(w, x) for w, x in zip(worst, d)]
        print(f"  iteration {n}: coords {d[0]:.3e}, cf {d[1]:.3e}, "
              f"residual rel {d[2]:.3e}")
    print(f"max: coords {worst[0]:.3e}, cf {worst[1]:.3e}, residual rel "
          f"{worst[2]:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
