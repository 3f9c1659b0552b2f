"""Benchmark entry point of the port: elliptic smoothing run to target.

    python -m turbomesh_tpu_torch.bench [scales_csv] [picard_cap] [--device cuda|cpu]

Defaults: scales 4,15,8,1,2, Picard cap 30, device cuda (raises without a
card). Counterpart of the JAX package's ``bench.py`` sweep, in one
process: no worker subprocesses, crash retries, cooldown, budget or
compile-cache logic.

Entries run in this order: the first two scales of the list that are 4
or 15, the reference's own LS89 and T106 configs (examples/), the other
scales from the smallest up, then the SOR kernel probe ``sor``. A scale
entry builds the scaled T106 cascade (every O4H cell count times the
scale, ~25k points at scale 1) and runs the device smoother with Laplace
control to the displacement residual 1e-10, at most ``picard_cap``
Picard iterations (3 above scale 8). An example entry runs the config's
own iteration count with its White control function, then, when that
leaves the residual above 1e-10, continues with the control function
frozen until 1e-10 (the fixed point of a frozen control function; the
live White feedback floors the residual near 1e-5). Each entry also runs
one warm-up iteration first (``warmup_s``; on the card it includes the
kernel builds) and, at scale <= 4 and for examples under 200k points, the
host sparse direct solve (scipy splu) as the oracle rate.

Output: one JSON record per entry on its own line and, after each, a
cumulative summary line of at most 1024 bytes:

  value       : run-to-target Mnodes/s (points / seconds to 1e-10) at the
                largest entry that reached 1e-10;
  vs_baseline : device per-iteration rate over the host direct solve's
                rate, at the largest entry where both ran;
  card        : nvidia-smi's name and power limit of the card ("cpu"
                on --device cpu);
  entries     : a compact status per entry.

On the card it first launches the probe kernel (ops/probe.py) and stops
if that fails.
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
import subprocess
import sys
import time
import traceback

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TARGET = 1e-10             # displacement residual target
ORACLE_MAX = 4             # largest scale the host splu oracle runs at
DEFAULT_SCALES = (4, 15, 8, 1, 2)
DEFAULT_PICARD_CAP = 30
SUMMARY_MAX_BYTES = 1024
SOR_N, SOR_SWEEPS, SOR_CALLS = 256, 50, 10


def scaled_t106_config(s: int) -> dict:
    """The scaled T106 cascade: O4H cell counts multiplied by ``s``."""
    return {
        "template": {"O4H": {
            "inlet_distance": 0.05, "outlet_distance": 0.02,
            "wall_delta_s": min(0.01, 0.4 / (40 * s)),
            "blade_clustering": {"roberts": {"alpha": 0.5, "beta": 1.03}},
            "num_cells": {
                "o_grid": 40 * s, "middle_i": 100 * s, "in_up_j": 30 * s,
                "in_down_j": 10 * s, "in_i": 10 * s, "out_up_j": 40 * s,
                "out_down_j": 10 * s, "out_i": 10 * s, "down_j": 40 * s,
                "bulge": 40 * s, "upstream_i": 20 * s, "downstream_i": 10 * s,
            },
        }},
        "smoothing": {},
        "geometry": {
            "pitch": 0.08836,
            "profile": {"csv": {
                "down_csv_path": "examples/T106/T106_ps.dat",
                "up_csv_path": "examples/T106/T106_ss.dat",
            }},
        },
    }


def build_mesh(scale: int = 4):
    from . import input as input_mod

    inp = input_mod.load(scaled_t106_config(scale), base_dir=str(ROOT))
    return inp.template.run(inp.geometry)


class NonConvergedCounter(logging.Handler):
    """Counts the linear solves that report "did not converge" on the
    ``turbomesh.krylov`` logger while attached."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def emit(self, record):
        if "did not converge" in record.getMessage():
            self.count += 1


def _timed_device_run(rec, mesh, picard_cap, algorithm, oracle, device,
                      counter, continue_frozen=False):
    """Shared entry body: set-up, one warm-up iteration, the timed
    device-resident run to TARGET (capped), the frozen-control-function
    continuation when ``continue_frozen`` and the target was missed, and
    the host direct oracle's rate when ``oracle``. Returns (rec, coords)."""
    from .ops import zebra
    from .smoothing.classify import classify
    from .smoothing.control_function import Laplace
    from .smoothing.device import DeviceSmoother
    from .smoothing.system import SparseSystem

    n = rec["nodes"]
    rec["device"] = str(device)
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    info = classify(mesh)
    dev = DeviceSmoother(mesh, info, device=device, rtol=1e-6, atol=1e-8,
                         restart=10, max_restarts=10)
    rec["setup_s"] = time.perf_counter() - t0

    cf0 = (algorithm or Laplace()).init(mesh)
    coords0 = mesh.flat_coords()

    t0 = time.perf_counter()
    dev.run(coords0, cf0, 1, algorithm=None)
    rec["warmup_s"] = time.perf_counter() - t0

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    nonconv = counter.count
    launches = zebra.ZEBRA_LAUNCHES
    t0 = time.perf_counter()
    coords, cf, disp, iters = dev.run(
        coords0, cf0, picard_cap, algorithm=algorithm,
        target_residual=TARGET)
    dt = time.perf_counter() - t0
    rec["picard_iters"] = iters
    rec["seconds_to_1e-10"] = dt
    rec["reached_target"] = bool(disp < TARGET)
    rec["final_displacement_residual"] = float(disp)
    rec["device_mnodes_per_s"] = n * iters / dt / 1e6
    rec["run_to_target_mnodes_per_s"] = n / dt / 1e6
    rec["last_linear_residual"] = float(dev.last_linear_residual)
    rec["linear_solves_converged"] = counter.count == nonconv
    rec["linear_rtols_used"] = sorted(set(dev.last_run_rtols))
    rec["zebra_launches"] = zebra.ZEBRA_LAUNCHES - launches

    if continue_frozen and not rec["reached_target"]:
        nonconv2 = counter.count
        t0 = time.perf_counter()
        coords, cf, disp2, it2 = dev.run(
            coords, cf, 60, algorithm=None, start_iteration=iters,
            target_residual=TARGET)
        dt2 = time.perf_counter() - t0
        rec["frozen_continuation"] = {
            "picard_iters": it2 - iters,
            "seconds": dt2,
            "final_displacement_residual": float(disp2),
            "reached_target": bool(disp2 < TARGET),
            "linear_solves_converged": counter.count == nonconv2,
        }
        if disp2 < TARGET:
            rec["seconds_to_1e-10_total"] = dt + dt2
            rec["run_to_target_mnodes_per_s"] = n / (dt + dt2) / 1e6
    if cuda:
        rec["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20

    if oracle:
        # one timed solve: splu refactorizes from scratch on every call
        oracle_sys = SparseSystem(mesh, info)
        t0 = time.perf_counter()
        oracle_sys.solve(mesh.flat_coords(), cf0)
        rec["host_direct_mnodes_per_s"] = n / (time.perf_counter() - t0) / 1e6
    return rec, coords


def bench_scale(scale, picard_cap, device, counter):
    """Scaled T106 cascade, Laplace, run to 1e-10; above scale 8 at most 3
    Picard iterations (one linearized solve there is the costly part)."""
    rec = {"scale_cells": scale}
    if scale > 8:
        picard_cap = min(picard_cap, 3)
    rec["picard_capped"] = scale > 8
    t0 = time.perf_counter()
    mesh = build_mesh(scale)
    rec["nodes"] = mesh.num_points
    rec["blocking_s"] = time.perf_counter() - t0
    return _timed_device_run(rec, mesh, picard_cap, None,
                             scale <= ORACLE_MAX, device, counter)[0]


def bench_example(name, picard_cap, device, counter):
    """The reference's own example config (examples/<name>/<name>.json),
    unchanged: the config's iterations with its wall control function,
    then the frozen continuation to 1e-10."""
    from . import input as input_mod
    from .smoothing.control_function import from_config

    rec = {"example": name}
    t0 = time.perf_counter()
    inp = input_mod.load(str(ROOT / "examples" / name / f"{name}.json"),
                         base_dir=str(ROOT))
    mesh = inp.template.run(inp.geometry)
    rec["nodes"] = mesh.num_points
    rec["blocking_s"] = time.perf_counter() - t0
    algorithm = from_config(inp.smoothing.wall_control_function)
    iters_cfg = inp.smoothing.iterations or picard_cap
    rec["config_iterations"] = iters_cfg
    rec["picard_capped"] = True
    return _timed_device_run(rec, mesh, iters_cfg, algorithm,
                             mesh.num_points < 200_000, device, counter,
                             continue_frozen=True)[0]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sor_probe(device):
    """Rate of ``red_black_sor`` on a 256 x 256 block, 50 sweeps a call.

    The 10 timed calls are chained (each starts from the previous output),
    so they cannot overlap. The inputs are an exact fixed point (x0 = base,
    cf = 0): the entry times and checks nothing."""
    from .ops import sor

    n = SOR_N
    u = torch.linspace(0.0, 1.0, n, dtype=torch.float32)
    base = torch.stack(torch.meshgrid(u, u, indexing="ij"), -1).to(device)
    cf = torch.zeros_like(base)
    mask = torch.zeros((n, n), dtype=torch.bool, device=device)
    mask[1:-1, 1:-1] = True
    launches = sor.SOR_LAUNCHES
    t0 = time.perf_counter()
    x = sor.red_black_sor(base, cf, base, mask, omega=1.5, sweeps=SOR_SWEEPS)
    _sync(device)
    warmup = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(SOR_CALLS):
        x = sor.red_black_sor(base, cf, x, mask, omega=1.5,
                              sweeps=SOR_SWEEPS)
    _sync(device)
    dt = time.perf_counter() - t0
    return {"entry": "sor", "device": str(device), "timing": "chained",
            "shape": [n, n], "sweeps_per_call": SOR_SWEEPS,
            "calls": SOR_CALLS, "warmup_s": warmup, "seconds": dt,
            "sor_mnode_sweeps_per_s": n * n * SOR_SWEEPS * SOR_CALLS / dt
            / 1e6,
            "sor_launches": sor.SOR_LAUNCHES - launches}


def build_specs(scales):
    """Entry order: scales 4 and 15 (those listed), LS89 and T106, the
    other scales from the smallest up, then the SOR probe."""
    prio = [s for s in (4, 15) if s in scales]
    ordered = prio + sorted(s for s in scales if s not in prio)
    specs = [{"kind": "scale", "scale": s} for s in ordered[:2]]
    specs += [{"kind": "example", "name": "LS89"},
              {"kind": "example", "name": "T106"}]
    specs += [{"kind": "scale", "scale": s} for s in ordered[2:]]
    specs.append({"kind": "sor"})
    return specs


def _spec_ident(spec):
    """(key, value) identifying the spec's record, as in the records."""
    if spec["kind"] == "scale":
        return "scale_cells", spec["scale"]
    if spec["kind"] == "example":
        return "example", spec["name"]
    return "entry", "sor"


def record_key(rec) -> str:
    """The entry's name: "scale4", "LS89", "T106", "sor"."""
    if "scale_cells" in rec:
        return f"scale{rec['scale_cells']}"
    return rec.get("example") or rec["entry"]


def card_name(device) -> str:
    """nvidia-smi's name and power limit of the card; "cpu" on the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def entry_status(rec, error_chars: int = 80) -> str:
    """Compact status of one record for the summary line."""
    if "error" in rec:
        return "error: " + rec["error"][:error_chars]
    if rec.get("entry") == "sor":
        return (f"{rec['sor_mnode_sweeps_per_s']:.1f} Mnode-sweeps/s, "
                f"{rec['sor_launches']} launches")
    frozen = rec.get("frozen_continuation")
    iters = str(rec["picard_iters"])
    secs = rec["seconds_to_1e-10"]
    disp = rec["final_displacement_residual"]
    conv = rec["linear_solves_converged"]
    if frozen:
        iters += f"+{frozen['picard_iters']}"
        secs += frozen["seconds"]
        disp = frozen["final_displacement_residual"]
        conv = conv and frozen["linear_solves_converged"]
    head = "ok" if disp < TARGET else f"res {disp:.1e}"
    return (f"{head} {iters}it {secs:.2f}s"
            + ("" if conv else " nonconv"))


def summary(records, card, elapsed) -> str:
    """The cumulative summary line (at most SUMMARY_MAX_BYTES bytes)."""
    done = [r for r in records if "run_to_target_mnodes_per_s" in r]
    reached = [r for r in done
               if (r.get("frozen_continuation") or r)["reached_target"]]
    both = [r for r in done if "host_direct_mnodes_per_s" in r]
    head = max(reached, key=lambda r: r["nodes"]) if reached else {}
    ratio = max(both, key=lambda r: r["nodes"]) if both else {}
    vs = (ratio["device_mnodes_per_s"] / ratio["host_direct_mnodes_per_s"]
          if ratio else 0.0)

    for error_chars in (80, 40, 16, 0):
        line = json.dumps({
            "metric": "elliptic_smoothing_run_to_target",
            "value": head.get("run_to_target_mnodes_per_s", 0.0),
            "unit": "Mnodes/s",
            "vs_baseline": vs,
            "headline": record_key(head) if head else None,
            "card": card,
            "target_residual": TARGET,
            "elapsed_s": round(elapsed, 1),
            "entries": {record_key(r): entry_status(r, error_chars)
                        for r in records},
        })
        if len(line.encode()) <= SUMMARY_MAX_BYTES:
            break
    return line


def run(specs, picard_cap, device, emit=print):
    """Run the entries in order; ``emit`` gets each record line and each
    summary line. Returns the records."""
    from .ops import probe

    card = card_name(device)
    if torch.device(device).type == "cuda":
        probe.check_card(device)
    counter = NonConvergedCounter()
    logger = logging.getLogger("turbomesh.krylov")
    logger.addHandler(counter)
    records = []
    t_start = time.perf_counter()
    try:
        for spec in specs:
            try:
                if spec["kind"] == "scale":
                    rec = bench_scale(spec["scale"], picard_cap, device,
                                      counter)
                elif spec["kind"] == "example":
                    rec = bench_example(spec["name"], picard_cap, device,
                                        counter)
                else:
                    rec = sor_probe(device)
            except Exception as e:  # noqa: BLE001 — record it, run the rest
                traceback.print_exc()
                k, v = _spec_ident(spec)
                msg = (str(e).splitlines() or [type(e).__name__])[0]
                rec = {k: v, "error": msg[:200]}
            records.append(rec)
            emit(json.dumps(rec))
            emit(summary(records, card, time.perf_counter() - t_start))
    finally:
        logger.removeHandler(counter)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m turbomesh_tpu_torch.bench",
        description="elliptic smoothing run-to-target sweep of the port")
    ap.add_argument("scales", nargs="?",
                    default=",".join(map(str, DEFAULT_SCALES)),
                    help="comma-separated O4H cell-count scales "
                         "(default 4,15,8,1,2)")
    ap.add_argument("picard_cap", nargs="?", type=int,
                    default=DEFAULT_PICARD_CAP,
                    help="Picard iteration cap per entry (default 30)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="torch device of the device solver (default cuda)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu)")
    scales = [int(s) for s in args.scales.replace(",", " ").split()]
    logging.basicConfig(level=logging.WARNING)
    records = run(build_specs(scales), args.picard_cap, args.device,
                  emit=lambda line: print(line, flush=True))
    return 1 if any("error" in r for r in records) else 0


if __name__ == "__main__":
    sys.exit(main())
