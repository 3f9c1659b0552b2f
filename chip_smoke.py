#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (turbomesh_tpu_torch) on one card.

    python3 chip_smoke.py                 # all phases (one CUDA device)
    python3 chip_smoke.py --phases 0,1,2  # a subset, for development

Phases (each prints its result and wall time on its own line):
  0. environment: card name and power limit, torch and CUDA versions;
     TF32 off for matmuls and cuDNN.
  1. build the zebra kernel (csrc/zebra.cu) with nvcc.
  2. kernel vs plain PyTorch version on the card, both line axes: at the
     unit-test shape on unit-normal planes (rtol = atol = 1e-5), and on the
     real level-0 planes of the T106 and scale-4 meshes as the device
     solver builds them (max |err| <= 1e-5 max |plain|, plain version in
     f64 on the same operands); median of 20 CUDA-event timings on the
     scale-4 planes.
  3. main path: ``cli.main`` on examples/T106/T106.json with the device
     solver (10 White Picard iterations, 25,118 points); the kernel must
     have launched, coordinates be finite, the last linear solve have
     converged, and the written mesh read back bit-identical.
  4. oracle: one Laplace linearized solve of the T106 mesh on the card
     (rtol 1e-15, atol 1e-18) vs the host sparse direct solve,
     max |delta| < 1e-10.
  5. real size: the scaled T106 cascade at scale 4 (388,448 points),
     Laplace, run to the displacement residual 1e-10 within 30 Picard
     iterations.

Exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository, and when any phase fails. On success the last
two lines are the kernels JSON object and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}},
preceded by the nvidia-smi name and power limit of the card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
PKG = ROOT / "turbomesh_tpu_torch"
T106 = ROOT / "examples" / "T106" / "T106.json"
KERNEL_RTOL = KERNEL_ATOL = 1e-5   # kernel vs plain (tests/test_zebra.py:103)
# kernel vs plain on the main path's level-0 planes: max |err| <= PLANE_RTOL
# * max |plain|, per output plane, with the plain version evaluated in f64
# on the same operands. The wall-normal lines there are only weakly
# diagonally dominant, so each f32 line solver carries its own error of
# that order: the plain version's PCR in f32 sits 2.3e-5 from its f64
# result on the scale-4 planes, the kernel's Thomas 6.5e-6. Two f32
# solvers also differ elementwise by more than 1e-5 at small entries
# (tests/test_torch_zebra.py).
PLANE_RTOL = 1e-5
ORACLE_TOL = 1e-10                 # device vs host direct solve
TARGET = 1e-10                     # displacement residual, scale 4
SCALE4_PICARD_CAP = 30


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def scaled_t106_config(s: int) -> dict:
    """The scaled T106 cascade of the JAX package's bench (bench.py
    build_mesh): O4H cell counts multiplied by ``s``."""
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


def zebra_inputs(torch, shape, seed):
    """Zebra half-sweep operands on the card as in the JAX package's
    kernel test: unit-normal planes, ghost frame masked, P != Q,
    diagonally dominant lines."""
    import numpy as np

    rng = np.random.default_rng(seed)
    B, Ng, Mg = shape

    def rand(scale=1.0):
        return scale * rng.standard_normal(shape).astype(np.float32)

    msk = np.ones(shape, np.float32)
    msk[:, [0, -1], :] = 0.0
    msk[:, :, [0, -1]] = 0.0
    bx, by = rand(), rand()
    d = np.full(shape, 4.0, np.float32)
    dl = np.full(shape, -1.0, np.float32)
    du = dl.copy()
    cfp, cfq = rand(0.1), rand(0.1)
    rx, ry, zx, zy = rand(), rand(), rand(), rand()
    sel = (np.arange(Mg) % 2 == 0).astype(np.float32)[None, None, :] * msk
    arrs = [bx, by, cfp, cfq, dl, d, du, msk, sel, rx, ry, zx, zy]
    return [torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                            device="cuda") for a in arrs]


def level0_sweeps(mesh, device, seed):
    """(axis, operands) of one zebra half-sweep per line direction on
    level 0 of the glued hierarchy the device solver builds for ``mesh``:
    the real ghost-framed metric planes, line tridiagonals, masks and
    colors, from a seeded random control function (P != Q, |P|, |Q| ~
    0.1). rx, ry are diag * u and zx, zy are u for unit-normal u, so the
    r and A z terms of the residual weigh alike and a wrong stencil term
    shows."""
    import numpy as np
    import torch

    from turbomesh_tpu_torch.smoothing.classify import classify
    from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

    dev = DeviceSmoother(mesh, classify(mesh), device=device)
    rng = np.random.default_rng(seed)
    cf = 0.1 * rng.standard_normal((mesh.num_points, 2))
    X, C = dev._upload(mesh.flat_coords(), cf)
    base, _ = dev._stage_base(X, C)
    zb = dev._stage_prepare32(base, C)["mg"][0]["zebra"]
    shape = tuple(zb["bx"].shape)
    u = [torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                         device=device) for _ in range(4)]
    diag = zb["li"][1]
    r = [(diag * u[0]).contiguous(), (diag * u[1]).contiguous(), u[2], u[3]]
    head = [zb["bx"], zb["by"], zb["cfp"], zb["cfq"]]
    return [(0, head + [*zb["li"], zb["msk"], zb["sel_j"][0], *r]),
            (1, head + [*zb["lj"], zb["msk"], zb["sel_i"][1], *r])]


def max_rel_err(got, want) -> float:
    """max |got - want| over max |want|, the worse of the x and y planes."""
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def cuda_median_ms(torch, fn, reps=20):
    """Median of ``reps`` CUDA-event timings of fn() (after a warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failed = []
        self._meshes = {}
        # one kernel for the four TPU decompositions of the half-sweep:
        # the default split pair, the fused PCR and the Thomas variant
        self.kernel = {"name": "zebra_half_sweep", "route": "cuda",
                       "source": "turbomesh_tpu_torch/csrc/zebra.cu",
                       "replaces": ", ".join(
                           f"turbomesh_tpu/ops/zebra.py:{line}"
                           for line in (232, 274, 127, 138))}

    def mesh(self, name):
        """The T106 mesh ("t106") or the scale-4 cascade ("scale4"),
        built once."""
        if name not in self._meshes:
            from turbomesh_tpu_torch import input as input_mod

            if name == "t106":
                inp = input_mod.load(str(T106), base_dir=str(T106.parent))
            else:
                inp = input_mod.load(scaled_t106_config(4), base_dir=str(ROOT))
            self._meshes[name] = inp.template.run(inp.geometry)
        return self._meshes[name]

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            msg = fn()
        except Exception:  # noqa: BLE001 — report, mark failed, go on
            traceback.print_exc()
            self.failed.append(name)
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.2f} s",
                  flush=True)
            return
        print(f"[{name}] ok ({time.perf_counter() - t0:.2f} s): {msg}",
              flush=True)

    # -- phases -----------------------------------------------------------

    def p0_env(self):
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return (f"nvidia-smi: {nvidia_smi()}; torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}, "
                f"{torch.cuda.get_device_name(0)} x "
                f"{torch.cuda.device_count()}")

    def p1_build(self):
        from turbomesh_tpu_torch.ops import zebra

        t0 = time.perf_counter()
        path = zebra.build_library()
        zebra.load_library()
        return f"built {path.name} in {time.perf_counter() - t0:.2f} s"

    def p2_kernel(self):
        torch = self.torch
        from turbomesh_tpu_torch.ops import zebra

        def compare(ops, axis):
            ker = zebra.zebra_half_sweep(*ops, axis=axis)
            ref = zebra.zebra_half_sweep_ref(*ops, axis=axis)
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(a).all()) for a in ker):
                raise AssertionError(f"non-finite kernel output "
                                     f"{tuple(ops[0].shape)} axis {axis}")
            err = max(float((a - b).abs().max()) for a, b in zip(ker, ref))
            return ker, ref, err

        worst = 0.0
        ops = zebra_inputs(torch, (3, 14, 12), seed=0)
        for axis in (0, 1):
            ker, ref, err = compare(ops, axis)
            worst = max(worst, err)
            for a, b in zip(ker, ref):
                torch.testing.assert_close(a, b, rtol=KERNEL_RTOL,
                                           atol=KERNEL_ATOL)
        lines = [f"(3, 14, 12) unit-normal planes within rtol=atol="
                 f"{KERNEL_RTOL}, max |err| {worst:.3e}"]

        # the main path's level-0 planes; the plain version also runs in
        # f64 on the same operands to show each f32 solver's own error
        bad = []
        for name in ("t106", "scale4"):
            sweeps = level0_sweeps(self.mesh(name), "cuda", seed=1)
            for axis, ops in sweeps:
                ker, ref32, err32 = compare(ops, axis)
                ref = zebra.zebra_half_sweep_ref(
                    *[o.double() for o in ops], axis=axis)
                ker64 = [a.double() for a in ker]
                err = max(float((a - b).abs().max())
                          for a, b in zip(ker64, ref))
                worst = max(worst, err)
                rel = max_rel_err(ker64, ref)
                rel_plain = max_rel_err([b.double() for b in ref32], ref)
                rel32 = max_rel_err(ker, ref32)
                lines.append(
                    f"{name} {tuple(ops[0].shape)} axis {axis}: vs f64 plain "
                    f"max |err| {err:.3e}, rel {rel:.3e} (f32 plain's own "
                    f"rel {rel_plain:.3e}; kernel vs f32 plain rel "
                    f"{rel32:.3e}, max |err| {err32:.3e})")
                print("  " + lines[-1], flush=True)
                if not rel <= PLANE_RTOL:
                    bad.append(f"{name} axis {axis}: rel {rel:.3e}")
        if bad:
            raise AssertionError(f"kernel vs f64 plain above {PLANE_RTOL}: "
                                 + "; ".join(bad))

        # timing at the scale-4 planes (sweeps from the loop above)
        ms, plain = [], []
        for axis, ops in sweeps:
            ms.append(cuda_median_ms(
                torch, lambda: zebra.zebra_half_sweep(*ops, axis=axis)))
            plain.append(cuda_median_ms(
                torch, lambda: zebra.zebra_half_sweep_ref(*ops, axis=axis)))
        self.kernel.update(max_abs_err=worst, ms=sum(ms) / 2,
                           plain_ms=sum(plain) / 2)
        return ("kernel vs plain, both axes: " + "; ".join(lines)
                + f" (bar max |err| <= {PLANE_RTOL} max |f64 plain|); scale-4 "
                f"planes median of 20: kernel axis0 {ms[0]:.4f} ms, axis1 "
                f"{ms[1]:.4f} ms; plain axis0 {plain[0]:.4f} ms, axis1 "
                f"{plain[1]:.4f} ms")

    def p3_main_path(self):
        import numpy as np

        from turbomesh_tpu_torch import cli
        from turbomesh_tpu_torch.ops import zebra
        from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

        runs = []
        orig_run = DeviceSmoother.run

        def recording_run(smoother, *args, **kwargs):
            out = orig_run(smoother, *args, **kwargs)
            runs.append((smoother, out))
            return out

        # CGNS needs h5py, which the card's machine may lack; the npz
        # writer then takes the round trip
        ext = ".cgns" if importlib.util.find_spec("h5py") else ".npz"
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "t106" + ext)
            # the reference's T106 config asks for the interactive viewer
            # ("gui": true); run a copy with it off, profiles resolved from
            # the example's own directory
            cfg = json.loads(T106.read_text())
            cfg["gui"] = False
            cfg_path = os.path.join(tmp, "T106.json")
            with open(cfg_path, "w") as f:
                json.dump(cfg, f)
            DeviceSmoother.run = recording_run
            try:
                zebra.ZEBRA_LAUNCHES = 0
                rc = cli.main([cfg_path, "--base-dir", str(T106.parent),
                               "--solver", "device", "--output", out])
                self.torch.cuda.synchronize()
                launches = zebra.ZEBRA_LAUNCHES
            finally:
                DeviceSmoother.run = orig_run
            if rc != 0:
                raise AssertionError(f"cli.main returned {rc}")
            if launches <= 0:
                raise AssertionError("the main path launched no zebra kernel")
            (smoother, (coords, _cf, disp, n_done)), = runs
            if not np.all(np.isfinite(coords)):
                raise AssertionError("non-finite coordinates")
            if not smoother.last_linear_converged:
                raise AssertionError("the last linear solve did not converge "
                                     f"({smoother.last_linear_residual:.3e})")
            if ext == ".cgns":
                from turbomesh_tpu_torch.io.cgns import read_cgns as reader
            else:
                from turbomesh_tpu_torch.io.npz import read_npz as reader
            _names, blocks = reader(out)
        back = np.concatenate([b.reshape(-1, 2) for b in blocks])
        if not np.array_equal(back, coords):
            raise AssertionError(f"{ext} read-back differs from the mesh")
        self.kernel["launches"] = launches
        return (f"T106 {len(coords)} points, {n_done} White Picard "
                f"iterations, residual {disp:.3e}, last linear residual "
                f"{smoother.last_linear_residual:.3e} (converged), "
                f"{launches} zebra launches, {ext} read back bit-identical")

    def p4_oracle(self):
        import numpy as np

        from turbomesh_tpu_torch.smoothing.classify import classify
        from turbomesh_tpu_torch.smoothing.control_function import Laplace
        from turbomesh_tpu_torch.smoothing.device import DeviceSmoother
        from turbomesh_tpu_torch.smoothing.system import SparseSystem

        mesh = self.mesh("t106")
        info = classify(mesh)
        cf = Laplace().init(mesh)
        coords = mesh.flat_coords()
        t0 = time.perf_counter()
        # At the default tolerances (rtol 1e-13, atol 1e-15) the plain
        # residual criterion stops the solve 3.1e-9 from the oracle on this
        # mesh, in the JAX package as in the port; 1e-15 / 1e-18 reaches
        # the 1e-10 bar.
        dev = DeviceSmoother(mesh, info, device="cuda", rtol=1e-15,
                             atol=1e-18)
        cd = dev.solve(coords, cf)
        if not dev.last_linear_converged:
            raise AssertionError("device solve did not converge")
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        co = SparseSystem(mesh, info).solve(coords, cf)
        t_host = time.perf_counter() - t0
        err = float(np.abs(cd - co).max())
        if not err < ORACLE_TOL:
            raise AssertionError(f"device vs oracle {err:.3e} >= {ORACLE_TOL}")
        return (f"T106 Laplace solve: max |device - oracle| {err:.3e} "
                f"(< {ORACLE_TOL}); device {t_dev:.2f} s (setup included), "
                f"host direct {t_host:.2f} s")

    def p5_scale4(self):
        import numpy as np

        torch = self.torch
        from turbomesh_tpu_torch.smoothing.classify import classify
        from turbomesh_tpu_torch.smoothing.control_function import Laplace
        from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

        mesh = self.mesh("scale4")
        info = classify(mesh)
        n = mesh.num_points
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dev = DeviceSmoother(mesh, info, device="cuda", rtol=1e-6, atol=1e-8,
                             restart=10, max_restarts=10)
        t_setup = time.perf_counter() - t0
        cf = Laplace().init(mesh)
        t0 = time.perf_counter()
        coords, _cf, disp, iters = dev.run(mesh.flat_coords(), cf,
                                           SCALE4_PICARD_CAP,
                                           target_residual=TARGET)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if not np.all(np.isfinite(coords)):
            raise AssertionError("non-finite coordinates")
        if not disp < TARGET:
            raise AssertionError(f"residual {disp:.3e} not below {TARGET} "
                                 f"after {iters} Picard iterations")
        p = dev.plan
        return (f"scale 4: {n} points (padded {p.B}x{p.N}x{p.M}), "
                f"{iters} Picard iterations to residual {disp:.3e} in "
                f"{dt:.2f} s (setup {t_setup:.2f} s); run-to-target "
                f"{n / dt / 1e6:.4f} Mnodes/s, per iteration "
                f"{n * iters / dt / 1e6:.4f} Mnodes/s; max_memory_allocated "
                f"{peak / 2**20:.1f} MiB; linear rtols "
                f"{sorted(set(dev.last_run_rtols))}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    try:
        import torch
    except ImportError:
        print("error: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not (PKG / "__init__.py").exists() or not T106.exists():
        print(f"error: {PKG.name} or the T106 example not found beside "
              f"{pathlib.Path(__file__).name}; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    logging.basicConfig(level=logging.WARNING)

    smoke = Smoke(torch)
    steps = [(0, "0 environment", smoke.p0_env),
             (1, "1 build", smoke.p1_build),
             (2, "2 kernel vs plain", smoke.p2_kernel),
             (3, "3 main path (T106, White, cli)", smoke.p3_main_path),
             (4, "4 oracle (T106, Laplace)", smoke.p4_oracle),
             (5, "5 scale 4 run to 1e-10", smoke.p5_scale4)]
    for k, name, fn in steps:
        if k in phases:
            smoke.phase(name, fn)
    if smoke.failed:
        print(f"FAILED phases: {smoke.failed}", file=sys.stderr)
        return 1
    print(nvidia_smi())
    print(json.dumps({"kernels": [smoke.kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
