#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (turbomesh_tpu_torch) on one card.

    python3 chip_smoke.py                 # all phases (one CUDA device)
    python3 chip_smoke.py --phases 0,1,2  # a subset, for development

Phases (each prints its result and wall time on its own line):
  0. environment: card name and power limit, torch and CUDA versions;
     TF32 off for matmuls and cuDNN.
  1. build the six kernels (csrc/probe.cu, zebra.cu, sor.cu, chain.cu,
     winslow.cu, glue.cu) with nvcc,
     all at once (ptxas's registers and spills printed), then launch the
     probe first: its output must be exactly i + 1. Its time a call is
     printed beside torch.add's on the same tile, with the host cost of
     each step of its launch path; the comparison is reported, not held.
  2. zebra kernel vs plain PyTorch version on the card, both line axes: on
     unit-normal planes at (3, 14, 12) (Thomas, K = 1) and (4, 70, 200)
     (partitioned) within rtol = atol = 1e-5, and on the real planes of
     level 0 of the T106 and LS89 meshes and of every level of the scale-4
     hierarchy, both colors, as the device solver builds them (max |err| <=
     1e-5 max |plain|, plain version in f64 on the same operands); times
     at the three level-0 shapes and of one scale-4 V-cycle's launches.
  3. SOR kernel vs plain version, 50 sweeps, f32 and f64, on (a) 256 x 256
     with a perturbed x0 and cf != 0, (b) the largest block of the scale-4
     mesh frozen at its coordinates (centred on the origin) with seeded cf
     and a perturbed interior, (c) a small mask that touches the edges
     (wrap-around).
     Bars: max |err| <= 1e-12 max |plain| in f64; in f32 <= 1e-5 max
     |plain| against the plain version in f64. A call must launch
     ``sor_launches(SOR_SWEEPS, s)`` kernels (s from ``sor_schedule``);
     the schedule (tile, s, CTA, shared memory) and ptxas's report of the
     kernel are printed. Times at (a) and (b).
  4. main path of the CLI: ``cli.main`` on examples/T106/T106.json with
     the device solver (10 White Picard iterations, 25,118 points); the
     zebra kernel must have launched, coordinates be finite, the last
     linear solve have converged, and the written mesh read back
     bit-identical.
  5. oracle: one Laplace linearized solve of the T106 mesh on the card
     (rtol 1e-15, atol 1e-18) vs the host sparse direct solve,
     max |delta| < 1e-10.
  6. real size: the scaled T106 cascade at scale 4 (388,448 points),
     Laplace, run to the displacement residual 1e-10 within 30 Picard
     iterations.
  8. the block-sharded path (parallel.ShardedSmoother, one process per
     rank, spawned from here; each rank's counts set to 0 just before its
     run and read just after): (a) NCCL, world 1, scale 4, Laplace, run to
     1e-10 within 30 Picard iterations, against phase 6's result; (b)
     gloo, world 4, all four ranks on cuda:0 (NCCL puts no two ranks on
     one card): T106, 3 White iterations at rtol 1e-13 against
     DeviceSmoother.run on the card, run meanwhile (coordinates and
     control function 1e-6, residual histories rtol 1e-5), then one
     Laplace solve at rtol 1e-15 against the host oracle (1e-10); the
     zebra kernel must launch on every rank; (c) with two cards or more, NCCL
     over min(4, count) cards at scale 4 to 1e-10, else reported as not
     run. Ranks that share a card are time-sliced: (b)'s walls are a
     correctness run, not a scaling figure.
  9. 3-D stacked cuts (demo_3d_sharded.run_demo): 3 cuts of T106 on a
     world of 2; the mid cut reaches 1e-10, from_cuts holds 3 x 25,118
     points, and the CGNS-3D read-back is bit-identical where h5py is
     installed (else the stacked Mesh3d is checked in memory).
 10. the last modules: (a) coarse-space deflation, T106, DeviceSmoother
     with deflation off, "y", "xy" and "j", 3 linearized solves at rtol
     DEFL_RTOL with the White control function updated on the host from
     the undeflated solve between them (tests/test_device_solver.py::
     test_deflation_optin_parity): every solve converged, max |delta| to
     the undeflated one < 1e-9; K, restarts, zebra launches (set to 0
     just before each mode and read just after; each mode must launch)
     and the time of one Galerkin build; then scale 4 with "y" to 1e-10
     as phase 6 runs it, beside phase 6; (b) ShardedSmoother, NCCL world
     1, deflation "y", one T106 Laplace solve against the host oracle
     (1e-9); (c) is phase 8's restart and iteration counts, printed there
     beside those of the sharded glue without the correction embeddings
     (EARLIER_SHARDED_*); (d) profiling.torch_trace around one T106 Picard
     iteration: the trace must be written; the CUDA kernels in it and the
     device-busy share (kernel time over the iteration's wall, under the
     profiler) are printed; (e) the browser service, web.serve(port=0,
     device="cuda"): POST /run of the T106 config with 0 iterations, then
     with 2 device iterations; the block points equal a direct run of the
     port's pipeline, bit for bit at 0 iterations and to 1e-12 after
     smoothing; (f) tfi.blended_tfi and linear_tfi on the card in f64 at
     the largest T106 block's size against the same calls on the CPU
     (1e-14).
 11. the preconditioner's options (``mg_opts``): (a) T106, one linearized
     solve with the White control function at rtol MG_RTOL, FGMRES(30),
     by DeviceSmoother with each of MG_CONFIGS beside the default: every
     solve converged and within 1e-9 of the default one, and the zebra
     launches equal to the preconditioner applications times
     ``multigrid.vcycle_half_sweeps`` of the instance's schedule and
     depth (counts set to 0 just before each solve and read just after);
     restarts, launches and walls printed; (b) scale 4 with ``schur`` False to
     1e-10 as phase 6 runs it, beside phase 6; (c) ShardedSmoother, NCCL
     world 1, the T106 Laplace solve at rtol 1e-15, undeflated in the
     Schur and then the base composition, each within 1e-10 of the host
     oracle, the restarts beside 10(b)'s deflated ones.
 12. the interface solve's chain kernel K-I (csrc/chain.cu): (a) on the
     T106 plan's chain table with its coefficients and a seeded
     right-hand side and field, the kernel against the plain version
     (ops/chain.py chain_solve_ref) on the same tensors, bit for bit, with
     one CHAIN_LAUNCHES a call; its time a call (median of 11 runs of
     CHAIN_RUN back-to-back calls between CUDA events), its device time in
     a CUDA graph, the plain version's time and the bound; (b) T106 through
     smooth_mesh(..., solver="device") for its 10 White iterations twice,
     the interface's chain solve routed to the plain version and then
     through the kernel: final coordinates equal bit for bit, the same
     zebra launches, CHAIN_LAUNCHES 0 and CHAIN_LEN_T106 (63 an
     iteration), the walls, the interface span's seconds an iteration and
     K-I's run's split by span (P12_SPANS) printed, the K-W launches
     an iteration (equal in both runs), and GLUE_LAUNCHES equal to the
     zebra launches in both runs (K-G once a V-cycle half-sweep on the
     main path); (c) the linear Winslow operator
     K-W (csrc/winslow.cu) on the T106 plan (8, 221, 41) and the medium
     grid's (8, 441, 81), at a seeded perturbation of the mesh and a
     seeded control function: in f32 as the preconditioner's residual
     (metrics G, cG) and in f64 as FGMRES's operator (cG64, the row scale
     1 / diag), against the plain version (ops/winslow.py
     winslow_apply_ref) on the same tensors: bit for bit outside the
     junction rows, within WINSLOW_JUNCTION_RTOL there (whether they too
     are bit for bit printed), one WINSLOW_LAUNCHES a call; the time a
     call back to back (WINSLOW_RUN between CUDA events) and in a CUDA
     graph, the plain version's and the bound. Phases 8(b), 10(a)
     and 11(a) check that the sharded ranks, the deflated solves and the
     option solves launched K-I.
 13. the preconditioner's CUDA graph (DeviceSmoother._apply_Minv): (a)
     on T106 and the medium grid (meshbench/configs/t106_x2.json), 30
     applications over two solves through the graph (eager, capture,
     replays) against the eager _stage_Minv on the same context and
     input, bit for bit, with the eager application's zebra, chain and
     K-W launches; one capture, 29 replays; an application's time eagerly and
     replayed (P13_RUN in a row between CUDA events); (b) the first job
     of the benchmark cells t106.design_loop and t106_x2.laplace_target
     (seed P13_SEED) through smooth_mesh with the graph and eagerly: final
     coordinates bit for bit, the same zebra, chain and K-W launches, one
     capture; walls, Picard iterations, the spans an iteration, the
     capture's seconds (span precond.graph.capture), the peak allocated
     and the peak reserved memory of each and the graph pool's reserved
     bytes printed; (c) the harness, ``meshbench.run --trace 1`` for
     P13_SECONDS s in each of the two cells: every run correct, the K-A
     kernels in the breakdown's device operations, the zebra roofline
     shares and graph_capture_s read above 0.
 14. the V-cycle's glue kernel K-G (csrc/glue.cu): (a) on every level of
     T106, LS89 and the medium grid, at a seeded perturbation of the mesh
     and a seeded control function, the kernel against the plain version
     (ops/glue.py glue_planes_ref) on the same tensors from both input
     forms (a seeded field; two seeded framed planes), bit for bit, one
     GLUE_LAUNCHES a call, and the module's frame_planes and
     unframe_planes against their CPU versions, bit for bit, counting no
     GLUE_LAUNCHES; at each level 0 its time a call back to back
     (GLUE_RUN between CUDA events) and in a CUDA graph, the plain
     version's, the glue it replaces (MapGlue.correction between the mask
     and the split) and the bound (bytes: the code byte and the output
     of every framed point, the input only on the mask); (b) one
     preconditioner application
     (_stage_Minv) of each mesh with K-G and with the per-half-sweep
     loop it replaced (tests/test_torch_glue_planes.py
     smooth_glued_loop): the same result bit for bit, the kernels each
     launches on the card (torch.profiler, eager) and the nodes of its
     CUDA graph (cuGraphGetNodes, where torch keeps the graph), and its
     device time replayed (P14_RUN in a row between CUDA events).

Times: a call's time is a run of back-to-back calls between two CUDA
events over the count, median of several runs (cuda_time_ms); the window
around one call, the method of the earlier numbers, is printed beside it.

Exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository, and when any phase fails. On success the last
two lines are the kernels JSON object (name, route, source, replaced TPU
kernel, max |err|, kernel / plain /
library ms, and the bound: the larger of the bytes each call must move
at 3.35 TB/s and its flops at the card's peak for their type;
red_black_sor also its launches a 256 x 256 f32 call) and
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
LS89 = ROOT / "examples" / "LS89" / "LS89.json"
X2_CONFIG = ROOT / "meshbench" / "configs" / "t106_x2.json"
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
SOR_SWEEPS = 50
# SOR kernel vs plain: max |err| <= bar * max |plain|; f32 against the
# plain version run in f64 on the same (f32) operands
SOR_BAR = {"float64": 1e-12, "float32": 1e-5}
# timing: runs of back-to-back calls per measurement, and launches a run
TIMING_REPS = 11
PROBE_RUN = 200
PROBE_TURNS = 20
ZEBRA_RUN = 50
PLAIN_RUN = 3
SOR_RUN = 10
# the scale-4 run to 1e-10 before the partitioned zebra kernel (PERF.md §5
# table, same card type and power limit): seconds, Picard iterations
EARLIER_SCALE4 = (38.27, 15)
# phase 8(b): the sharded White run against DeviceSmoother.run (coords and
# control function, residual histories: tests/test_sharded_solver.py:
# 205-207) and the Laplace solve vs oracle. The White feedback carries any
# difference between two solvers that meet the tolerance into the next
# iterations: on T106 two DeviceSmoother runs that differ in the restart
# length alone stand 2.2e-6 apart in the coordinates after 10 iterations
# at rtol 1e-10 and 3.0e-9 at 1e-13, with 5.2e-5 in the control function
# and 3.7e-6 in the residuals (white_sensitivity.py on the card). So both
# runs solve to 1e-13, and for SHARDED_WHITE_ITERS iterations, not 10: ten
# took 380 s on four ranks that share the card.
SHARDED_WHITE_ITERS = 3
SHARDED_RTOL, SHARDED_ATOL = 1e-13, 1e-15
SHARDED_RUN_TOL = 1e-6
SHARDED_HIST_RTOL = 1e-5
SHARDED_WORLD = 4
# the sharded runs' counts before the sharded correction glue carried the
# sliding and junction embeddings (PERF.md §6, same card type and power
# limit): 8(b)'s FGMRES(30) restart cycles per White iteration, 8(a)'s
# Picard iterations
EARLIER_SHARDED_RESTARTS = [4, 3, 3]
EARLIER_SHARDED_SCALE4_ITERS = 17
# phase 10 (a): deflated vs undeflated linearized solves (tests/
# test_device_solver.py::test_deflation_optin_parity: 1e-9 over 3 White
# iterations), FGMRES(30) as 8(b)'s device run
DEFL_MODES = ("y", "xy", "j")
DEFL_RTOL, DEFL_ATOL = 1e-13, 1e-15
DEFL_TOL = 1e-9
DEFL_SOLVES = 3
# phase 10 (b), (e), (f)
SHARDED_DEFL_TOL = 1e-9
SERVICE_TOL = 1e-12
TFI_TOL = 1e-14
# phase 11 (a): each option's T106 solve against the default's, FGMRES(30)
# as 10(a), at rtol MG_RTOL. At 1e-13 a T106 solve stops up to ~3e-9 from
# the exact one (the plain-residual criterion; phase 5), so two
# preconditioners that both meet it may differ by more than MG_TOL; at
# 1e-14, atol 1e-17 the options stand 1e-11 or closer (PERF.md §6). One
# solve, not 10(a)'s three: three took about 300 s on the card, where the
# host issues every kernel.
MG_CONFIGS = (
    ("schur False", {"schur": False}),
    ("interface_passes 1", {"interface_passes": 1}),
    ("interface_passes 4", {"interface_passes": 4}),
    ("pre_dirs j, post_dirs i", {"pre_dirs": "j", "post_dirs": "i"}),
    ("pre 2, post 2, coarse_iters 8", {"pre": 2, "post": 2,
                                       "coarse_iters": 8}),
    ("n_levels 3", {"n_levels": 3}))
MG_RTOL, MG_ATOL, MG_RESTART = 1e-14, 1e-17, 30
MG_TOL = 1e-9

# Bounds: H100 SXM peaks from NVIDIA's data sheet (700 W): device memory
# 3.35 TB/s; outside the tensor cores 67 TFLOP/s in f32, 34 in f64.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# flops a point of one zebra half-sweep (csrc/zebra.cu): the residual
# (metrics 8, g 9, diag 2, four coefficients 12, h 1, stencil 2 x 17,
# masked r - Az 4 = 70) and Thomas for x and y with shared diagonals (18)
ZEBRA_FLOPS_PER_POINT = 88
# flops per masked point of an SOR call (csrc/sor.cu): the coefficients
# come from the frozen base and cf, so the function needs them once a call
# (metrics 8, g 9, diag 2, coefficients 12, h 1, scale 1 = 33); each sweep
# then updates x and y (2 x (stencil 17 + update 2) = 38)
SOR_FLOPS_SETUP = 33
SOR_FLOPS_PER_SWEEP = 38
# phase 12: back-to-back kernel calls a timing run; the kernel's launches
# over T106's 10 White iterations (3 interface solves in each of 21
# preconditioner applications an iteration)
CHAIN_RUN = 200
CHAIN_LEN_T106 = 630
# flops a table point of one chain call (csrc/chain.cu): the forward step
# (2 multiplies, 3 subtracts, 3 divides) and the back substitution for x
# and y (2 multiplies, 2 subtracts)
CHAIN_FLOPS_PER_POINT = 12
# phase 12(c): back-to-back K-W calls a timing run; the junction rows'
# bar against the plain version, relative to their largest value (their
# sums may round in another order than torch's reduction); flops a padded
# point of one call (csrc/winslow.cu): f64 the metrics 17, coefficients
# 14, the stencil of x and y 34, the scale 2; f32 without the metrics and
# the scale
WINSLOW_RUN = 200
WINSLOW_JUNCTION_RTOL = {"float32": 1e-6, "float64": 1e-14}
WINSLOW_FLOPS_PER_POINT = {"float32": 48, "float64": 67}
# the spans whose seconds an iteration 12(b) prints (PERF.md §3)
P12_SPANS = ("picard.solve", "solve.prepare", "fgmres.cycle",
             "fgmres.operator", "precond", "precond.vcycle",
             "precond.residual", "precond.interface", "fgmres.stop_test",
             "picard.update", "picard.read")


# phase 13: applications in a row a timing run; the benchmark seed of its
# jobs and the harness's window
P13_RUN = 20
P13_SEED = 2718281829
P13_SECONDS = 5
P13_CELLS = (("t106.design_loop", "zebra_roofline_pct"),
             ("t106_x2.laplace_target", "x2_zebra_roofline_pct"))
# phase 14: back-to-back K-G calls a timing run, applications in a row a
# replay timing run; flops of a copy entry (a multiply a component) and of
# a junction member (a multiply and an add a component)
GLUE_RUN = 200
P14_RUN = 20
GLUE_FLOPS_COPY = 2
GLUE_FLOPS_MEMBER = 4


def scaled_t106_config(s: int) -> dict:
    """The scaled T106 cascade: O4H cell counts multiplied by ``s``
    (25,118 points at scale 1, 388,448 at scale 4)."""
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


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


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


def level_sweeps(mesh, device, seed, colors=(0,)):
    """Per level of the glued hierarchy the device solver builds for
    ``mesh``, the (axis, operands) of zebra half-sweeps on that level: the
    real ghost-framed metric planes, line tridiagonals, masks and colors,
    from a seeded random control function (P != Q, |P|, |Q| ~ 0.1). rx, ry
    are diag * u and zx, zy are u for unit-normal u, so the r and A z terms
    of the residual weigh alike and a wrong stencil term shows. For each
    color in ``colors`` one sweep per line direction (axis 0 with sel_j,
    axis 1 with sel_i), in the order of ``multigrid._smooth_glued``."""
    import numpy as np
    import torch

    from turbomesh_tpu_torch.smoothing.classify import classify
    from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

    dev = DeviceSmoother(mesh, classify(mesh), device=device)
    rng = np.random.default_rng(seed)
    cf = 0.1 * rng.standard_normal((mesh.num_points, 2))
    X, C = dev._upload(mesh.flat_coords(), cf)
    base, _ = dev._stage_base(X, C)
    out = []
    for level in dev._stage_prepare32(base, C)["mg"]:
        zb = level["zebra"]
        shape = tuple(zb["bx"].shape)
        u = [torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                             device=device) for _ in range(4)]
        diag = zb["li"][1]
        r = [(diag * u[0]).contiguous(), (diag * u[1]).contiguous(), u[2],
             u[3]]
        head = [zb["bx"], zb["by"], zb["cfp"], zb["cfq"]]
        sweeps = [(0, head + [*zb["li"], zb["msk"], zb["sel_j"][c], *r])
                  for c in colors]
        sweeps += [(1, head + [*zb["lj"], zb["msk"], zb["sel_i"][c], *r])
                   for c in colors]
        out.append(sweeps)
    return out


def level0_sweeps(mesh, device, seed):
    """(axis, operands) of one zebra half-sweep per line direction on
    level 0 (``level_sweeps``), axis 0 with the even-column color and
    axis 1 with the odd-row one."""
    sweeps = level_sweeps(mesh, device, seed, colors=(0, 1))[0]
    return [sweeps[0], sweeps[3]]


def vcycle_calls(levels):
    """The zebra half-sweeps of one default V-cycle (``multigrid.
    v_cycle_glued`` with ``DeviceSmoother.MG_DEFAULTS``), in order, from
    ``level_sweeps(..., colors=(0, 1))``: pre + post smooths on each level
    above the coarsest, coarse_iters on the coarsest, each smooth four
    half-sweeps."""
    from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

    o = DeviceSmoother.MG_DEFAULTS
    calls = []
    for lvl, sweeps in enumerate(levels):
        smooths = (o["coarse_iters"] if lvl == len(levels) - 1
                   else o["pre"] + o["post"])
        calls += sweeps * smooths
    return calls


def count_applications(sm):
    """Count the preconditioner applications of smoother ``sm`` in
    ``sm.applications`` (one V-cycle each; eager, captured or replayed)."""
    inner = sm._apply_Minv

    def counted(ctx, v):
        sm.applications += 1
        return inner(ctx, v)

    sm.applications = 0
    sm._apply_Minv = counted


def predicted_launches(sm):
    """The zebra launches of ``sm``'s counted applications: each one
    V-cycle of its schedule over its hierarchy's depth."""
    from turbomesh_tpu_torch.smoothing import multigrid as mg

    o = sm.mg_opts
    return sm.applications * mg.vcycle_half_sweeps(
        len(sm._glue_dev), o["pre"], o["post"], o["coarse_iters"],
        o["pre_dirs"], o["post_dirs"])


def mg_option_solves(mesh, cf, device, sync):
    """Phase 11 (a): one linearized solve of ``mesh`` at control function
    ``cf`` by a DeviceSmoother on ``device`` with the default options and
    with each of MG_CONFIGS. ``sync()`` waits for the device. Returns per
    config (name, the opts, the glued levels, the restarts, the zebra
    launches measured and predicted, the chain-kernel launches, seconds,
    max |delta| vs the default solve, converged)."""
    import numpy as np

    from turbomesh_tpu_torch.ops import chain, zebra
    from turbomesh_tpu_torch.smoothing.classify import classify
    from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

    info = classify(mesh)
    runs = []
    for name, opts in (("default", None),) + MG_CONFIGS:
        sm = DeviceSmoother(mesh, info, device=device, rtol=MG_RTOL,
                            atol=MG_ATOL, restart=MG_RESTART, mg_opts=opts)
        count_applications(sm)
        sync()
        zebra.ZEBRA_LAUNCHES = chain.CHAIN_LAUNCHES = 0
        t0 = time.perf_counter()
        coords = sm.solve(mesh.flat_coords(), cf)
        sync()
        seconds = time.perf_counter() - t0
        runs.append(dict(
            name=name, opts=opts, coords=coords, levels=len(sm._glue_dev),
            restarts=sm.last_restarts, launches=zebra.ZEBRA_LAUNCHES,
            predicted=predicted_launches(sm), chain=chain.CHAIN_LAUNCHES,
            seconds=seconds,
            converged=sm.last_linear_converged,
            err=float(np.abs(coords - runs[0]["coords"]).max()) if runs
            else 0.0))
    return runs


def ptxas_report(log):
    """ptxas's lines on each kernel (its mangled name, then registers and
    spills) from nvcc's -Xptxas -v output."""
    keep = ("Compiling entry function", "spill stores", "Used ")
    return [line.strip() for line in log.splitlines()
            if any(k in line for k in keep)]


def bound_ms(nbytes, flops, dtype_name):
    """(ms, "bytes" | "operations"): the least time of a call that reads
    each input once, writes each output once and does ``flops`` flops."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sor_cases(np, scale4_mesh, seed):
    """(name, base, cf, x0, mask) numpy inputs of the SOR check: (a) 256 x
    256 unit square, (b) the largest block of the scale-4 mesh frozen at
    its coordinates, centred, (c) a 24 x 20 random mask holding row 0 and
    column 0 (their neighbours wrap around). Seeded cf with |P|, |Q| ~ 0.1
    and a perturbed x0 inside the mask."""
    rng = np.random.default_rng(seed)

    def case(name, base, mask, amp):
        x0 = base.copy()
        x0[mask] += amp * rng.standard_normal(x0[mask].shape)
        cf = 0.1 * rng.standard_normal(base.shape)
        return name, base, cf, x0, mask

    u = np.linspace(0.0, 1.0, 256)
    square = np.stack(np.meshgrid(u, u, indexing="ij"), -1)
    interior = np.zeros((256, 256), bool)
    interior[1:-1, 1:-1] = True
    # (b) is moved rigidly so that its centroid sits at the origin. The
    # stencil's coefficients sum to 0, so a translation commutes with the
    # sweeps; but at its own place (|x| up to 1.13, the block 0.09 across,
    # wall cells far below f32's resolution there) f32 cannot resolve the
    # metrics: the f32 plain version alone is 1.0e-5 off, and rounding only
    # the stored iterate to f32 already costs 3.0e-6.
    block = max(scale4_mesh.blocks, key=lambda b: b.size[0] * b.size[1])
    bbase = np.ascontiguousarray(block.points, dtype=np.float64)
    bbase = bbase - bbase.reshape(-1, 2).mean(axis=0)
    bmask = np.zeros(bbase.shape[:2], bool)
    bmask[1:-1, 1:-1] = True
    spacing = np.abs(np.diff(bbase[:, :, 0], axis=1)).min()
    u = np.linspace(0.0, 1.0, 24)
    v = np.linspace(0.0, 1.0, 20)
    small = np.stack(np.meshgrid(u, v, indexing="ij"), -1)
    emask = rng.random((24, 20)) < 0.6
    emask[0, :] = True
    emask[:, 0] = True
    return [case("a 256x256", square, interior, 0.3 / 256),
            case(f"b scale-4 block {bbase.shape[0]}x{bbase.shape[1]}",
                 bbase, bmask, 0.3 * spacing),
            case("c 24x20 edge mask", small, emask, 0.3 / 24)]


def max_rel_err(got, want) -> float:
    """max |got - want| over max |want|, the worse of the x and y planes."""
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


def cuda_time_ms(torch, fn, launches, reps=TIMING_REPS):
    """(per-call ms, one-call ms) of fn() on the card. The first: a run of
    ``launches`` back-to-back calls between two CUDA events, over the
    count, median of ``reps`` runs after one warm-up run; a call that is
    quicker on the card than on the host is timed at its host rate, as a
    caller that launches it repeatedly sees it. The second: the median of
    ``reps`` windows around one call each (the method of the earlier
    numbers in PERF.md)."""
    def window(count):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(count):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / count

    window(launches)
    many = sorted(window(launches) for _ in range(reps))
    one = sorted(window(1) for _ in range(reps))
    return many[reps // 2], one[reps // 2]


def graph_us(torch, fn, calls=200, reps=11):
    """Device time of one fn() call, in us: ``calls`` calls captured in a
    CUDA graph, the median of ``reps`` replays over the count. No host
    work is left in the window, so this is what the card spends."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        keep = [fn() for _ in range(calls)]
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls * 1e3)
    del keep, graph
    return sorted(times)[reps // 2]


def host_us(fn, calls=2000):
    """Median over 5 runs of the host time of one fn() call, in us, from a
    run of ``calls`` calls (host clock; fn must not wait for the card)."""
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    return sorted(runs)[2]


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failed = []
        self._meshes = {}
        self._scale4 = None   # phase 6's scale-4 coordinates
        self._p6 = None       # phase 6's iterations, wall, peak MiB
        self._p10b_restarts = None   # 10(b)'s deflated sharded restarts
        # zebra: one kernel for the four TPU decompositions of the
        # half-sweep (the default split pair, the fused PCR and the Thomas
        # variant)
        self.kernels = {
            "zebra_half_sweep": {
                "name": "zebra_half_sweep", "route": "cuda",
                "source": "turbomesh_tpu_torch/csrc/zebra.cu",
                "replaces": ", ".join(f"turbomesh_tpu/ops/zebra.py:{line}"
                                      for line in (232, 274, 127, 138)),
                "library_ms": None},
            "red_black_sor": {
                "name": "red_black_sor", "route": "cuda",
                "source": "turbomesh_tpu_torch/csrc/sor.cu",
                "replaces": "turbomesh_tpu/ops/sor.py:74",
                "library_ms": None},
            "probe": {
                "name": "probe", "route": "cuda",
                "source": "turbomesh_tpu_torch/csrc/probe.cu",
                "replaces": "turbomesh_tpu/ops/zebra.py:297"},
            # K-I replaces no Pallas kernel: the lax.scan Thomas of the
            # interface solve
            "chain_solve": {
                "name": "chain_solve", "route": "cuda",
                "source": "turbomesh_tpu_torch/csrc/chain.cu",
                "replaces": "none (turbomesh_tpu/smoothing/krylov.py:333 "
                            "lax.scan, as device.py:1072 uses it)",
                "library_ms": None},
            # K-G replaces no Pallas kernel: the glue that the JAX package
            # leaves to XLA
            "glue_planes": {
                "name": "glue_planes", "route": "cuda",
                "source": "turbomesh_tpu_torch/csrc/glue.cu",
                "replaces": "none (turbomesh_tpu/smoothing/multigrid.py "
                            "_glue_correction, left to XLA)",
                "library_ms": None},
            # K-W replaces no Pallas kernel: the equation map that the JAX
            # package leaves to XLA
            "winslow_apply": {
                "name": "winslow_apply", "route": "cuda",
                "source": "turbomesh_tpu_torch/csrc/winslow.cu",
                "replaces": "none (turbomesh_tpu/smoothing/device.py "
                            "_apply, left to XLA)",
                "library_ms": None},
        }

    def mesh(self, name):
        """The T106 ("t106") or LS89 ("ls89") example mesh, or the scale-4
        cascade ("scale4"), built once."""
        if name not in self._meshes:
            from turbomesh_tpu_torch import input as input_mod

            if name in ("t106", "ls89"):
                path = T106 if name == "t106" else LS89
                inp = input_mod.load(str(path), base_dir=str(path.parent))
            else:
                inp = input_mod.load(scaled_t106_config(4),
                                     base_dir=str(ROOT))
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
        from concurrent.futures import ThreadPoolExecutor

        torch = self.torch
        from turbomesh_tpu_torch.ops import (_build, chain, glue, probe,
                                             sor, winslow, zebra)

        # one nvcc per source, all started together
        t0 = time.perf_counter()
        names = ("probe", "zebra", "sor", "chain", "winslow", "glue")
        with ThreadPoolExecutor(len(names)) as pool:
            paths = list(pool.map(_build.build_library, names))
        t_build = time.perf_counter() - t0
        for mod in (probe, zebra, sor, chain, winslow, glue):
            mod.load_library()

        # the probe launches first: o = i + 1, exactly
        probe.check_card("cuda")
        x = torch.randn(probe.SHAPE, device="cuda")
        err = float((probe.probe(x) - probe.probe_ref(x)).abs().max())
        # a call of each is host-bound and the host drifts: PROBE_TURNS
        # alternating turns (kernel, plain, library, library, plain,
        # kernel, ...), the median of each one's turns
        fns = {"kernel": lambda: probe.probe(x),
               "plain": lambda: probe.probe_ref(x),
               "torch.add": lambda: torch.add(x, 1.0)}
        runs = {name: [] for name in fns}
        for turn in range(PROBE_TURNS):
            for name in (fns if turn % 2 == 0 else reversed(fns)):
                runs[name].append(cuda_time_ms(torch, fns[name], PROBE_RUN,
                                               reps=5))
        t = {name: (sorted(r[0] for r in rs)[len(rs) // 2],
                    sorted(r[1] for r in rs)[len(rs) // 2])
             for name, rs in runs.items()}
        b_ms, b_by = bound_ms(2 * x.numel() * 4, x.numel(), "float32")
        self.kernels["probe"].update(
            max_abs_err=err, ms=t["kernel"][0], plain_ms=t["plain"][0],
            bound_ms=b_ms, bound_by=b_by, library_ms=t["torch.add"][0])
        # the host cost of each step of the probe's launch path
        out = torch.empty_like(x)
        entry = probe.load_library().probe_add_one
        stream = torch._C._cuda_getCurrentRawStream(0)
        steps = {
            "checks": lambda: (x.dtype != torch.float32,
                               x.is_contiguous(), x.is_cuda),
            "torch.empty_like": lambda: torch.empty_like(x),
            "stream": lambda: torch._C._cuda_getCurrentRawStream(0),
            "data_ptr x2, get_device": lambda: (x.data_ptr(), out.data_ptr(),
                                                x.get_device()),
            "entry point (launch)": lambda: entry(x.data_ptr(),
                                                  out.data_ptr(), 1024, 0,
                                                  stream),
            "probe()": lambda: probe.probe(x),
            "torch.add": lambda: torch.add(x, 1.0)}
        host = {name: host_us(fn) for name, fn in steps.items()}
        torch.cuda.synchronize()
        device = {name: graph_us(torch, fns[name])
                  for name in ("kernel", "torch.add")}
        for path in paths:
            print(f"  ptxas {path.name}:\n    " + "\n    ".join(ptxas_report(
                _build.log_path(path).read_text())), flush=True)
        timing = "; ".join(f"{name} {ms:.5f} ms ({one:.5f} ms one-call "
                           f"window)" for name, (ms, one) in t.items())
        print(f"  probe a call: {timing}; host us: "
              + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
              + "; device us a call (CUDA graph of 200): "
              + ", ".join(f"{k} {v:.3f}" for k, v in device.items()),
              flush=True)
        wins = sum(k[0] <= a[0] for k, a in zip(runs["kernel"],
                                                  runs["torch.add"]))
        verdict = ("at or below" if t["kernel"][0] <= t["torch.add"][0]
                   else "above") + (f" torch.add; at or below it in {wins} "
                                    f"of {PROBE_TURNS} turns")
        return (f"built {', '.join(p.name for p in paths)} in {t_build:.2f} s "
                f"(parallel nvcc); probe (8, 128) exact (i + 1); a call, "
                f"median of {PROBE_TURNS} turns of 5 x {PROBE_RUN} "
                f"back-to-back calls: {timing} (kernel {verdict}); "
                f"bound {b_ms:.2e} ms "
                f"({b_by}); host us a call, median of 5 runs of 2000: "
                + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
                + "; device us a call, in a CUDA graph of 200 calls: "
                + ", ".join(f"{k} {v:.3f}" for k, v in device.items()))

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
        lines = []
        for shape in ((3, 14, 12), (4, 70, 200)):
            ops = zebra_inputs(torch, shape, seed=0)
            for axis in (0, 1):
                ker, ref, err = compare(ops, axis)
                worst = max(worst, err)
                for a, b in zip(ker, ref):
                    torch.testing.assert_close(a, b, rtol=KERNEL_RTOL,
                                               atol=KERNEL_ATOL)
            lines.append(f"{shape} unit-normal planes within rtol=atol="
                         f"{KERNEL_RTOL}, max |err| {worst:.3e}")

        # the main path's planes: level 0 of T106 and LS89, every level of
        # scale 4, both colors of both axes; the plain version also runs in
        # f64 on the same operands to show each f32 solver's own error
        bad, level0 = [], {}
        for name in ("t106", "ls89", "scale4"):
            levels = level_sweeps(self.mesh(name), "cuda", seed=1,
                                  colors=(0, 1))
            if name != "scale4":
                levels = levels[:1]
            else:
                vcycle = levels
            level0[name] = levels[0]
            for lvl, sweeps in enumerate(levels):
                rels = {0: [], 1: []}
                for axis, ops in sweeps:
                    ker, ref32, _ = compare(ops, axis)
                    ref = zebra.zebra_half_sweep_ref(
                        *[o.double() for o in ops], axis=axis)
                    ker64 = [a.double() for a in ker]
                    worst = max(worst, max(float((a - b).abs().max())
                                           for a, b in zip(ker64, ref)))
                    rel = max_rel_err(ker64, ref)
                    rel_plain = max_rel_err([b.double() for b in ref32], ref)
                    rels[axis].append((rel, rel_plain))
                    if not rel <= PLANE_RTOL:
                        bad.append(f"{name} level {lvl} axis {axis}: rel "
                                   f"{rel:.3e}")
                shape = tuple(sweeps[0][1][0].shape)
                lines.append(f"{name} level {lvl} {shape}: " + "; ".join(
                    f"axis {a} (K={zebra.zebra_chunks(shape[1 + a])}) rel "
                    f"{max(r for r, _ in v):.3e} (f32 plain's own "
                    f"{max(p for _, p in v):.3e})" for a, v in rels.items()))
                print("  " + lines[-1], flush=True)
        if bad:
            raise AssertionError(f"kernel vs f64 plain above {PLANE_RTOL}: "
                                 + "; ".join(bad))

        # times at the level-0 shapes (one color per axis, as the smoother
        # runs half of each axis's sweeps with it)
        times = {}
        for name, sweeps in level0.items():
            for axis, ops in (sweeps[0], sweeps[2]):
                times[(name, axis)] = (
                    cuda_time_ms(torch, lambda: zebra.zebra_half_sweep(
                        *ops, axis=axis), ZEBRA_RUN),
                    cuda_time_ms(torch, lambda: zebra.zebra_half_sweep_ref(
                        *ops, axis=axis), PLAIN_RUN, reps=3))
        calls = vcycle_calls(vcycle)

        def run_vcycle():
            for axis, ops in calls:
                zebra.zebra_half_sweep(*ops, axis=axis)

        v_ms, v_one = cuda_time_ms(torch, run_vcycle, 5)
        # 13 input planes read once, 2 output planes written once
        points = level0["scale4"][0][1][0].numel()
        b_ms, b_by = bound_ms(15 * 4 * points, ZEBRA_FLOPS_PER_POINT * points,
                              "float32")
        s4 = [times[("scale4", a)] for a in (0, 1)]
        self.kernels["zebra_half_sweep"].update(
            max_abs_err=worst, ms=(s4[0][0][0] + s4[1][0][0]) / 2,
            plain_ms=(s4[0][1][0] + s4[1][1][0]) / 2, bound_ms=b_ms,
            bound_by=b_by)
        timing = "; ".join(
            f"{name} {tuple(level0[name][0][1][0].shape)} axis {axis}: kernel "
            f"{k[0]:.4f} ms ({k[1]:.4f} one-call), plain {p[0]:.4f} ms"
            for (name, axis), (k, p) in times.items())
        return ("kernel vs plain: " + "; ".join(lines)
                + f" (bar max |err| <= {PLANE_RTOL} max |f64 plain|); a call, "
                f"median of {TIMING_REPS} runs of {ZEBRA_RUN} (plain "
                f"{PLAIN_RUN}): {timing}; scale-4 level-0 bound {b_ms:.4f} ms "
                f"({b_by}); one scale-4 V-cycle's {len(calls)} launches "
                f"{v_ms:.4f} ms ({v_one:.4f} one-run window)")

    def p3_sor(self):
        import numpy as np

        torch = self.torch
        from turbomesh_tpu_torch.ops import sor

        lines, bad, worst = [], [], 0.0
        timed, schedules, per_calls = {}, {}, {}
        for name, *arrs in sor_cases(np, self.mesh("scale4"), seed=7):
            for dt in (torch.float64, torch.float32):
                dname = str(dt).split(".")[1]
                base, cf, x0 = [torch.as_tensor(a, dtype=dt, device="cuda")
                                for a in arrs[:3]]
                mask = torch.as_tensor(arrs[3], device="cuda")
                ti, tj, s, rows = sor.sor_schedule(*x0.shape[:2])
                schedules[(x0.shape[:2], dname)] = (
                    f"{tuple(x0.shape[:2])} {dname}: tile {ti}x{tj}, s {s}, "
                    f"CTA 32x{rows}, "
                    f"{sor.sor_smem_bytes(ti, tj, s, dt)} B shared")
                before = sor.SOR_LAUNCHES
                ker = sor.red_black_sor(base, cf, x0, mask, 1.5, SOR_SWEEPS)
                per_call = sor.SOR_LAUNCHES - before
                per_calls[(name[0], dname)] = per_call
                ref = sor.red_black_sor_ref(base.double(), cf.double(),
                                            x0.double(), mask, 1.5, SOR_SWEEPS)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(ker).all()):
                    raise AssertionError(f"non-finite SOR output, {name}")
                want_calls = sor.sor_launches(SOR_SWEEPS, s)
                if per_call != want_calls:
                    raise AssertionError(f"{per_call} launches per call, "
                                         f"expected {want_calls}")
                err = float((ker.double() - ref).abs().max())
                rel = err / float(ref.abs().max())
                worst = max(worst, err)
                note = ""
                if dt == torch.float32:
                    own = sor.red_black_sor_ref(base, cf, x0, mask, 1.5,
                                                SOR_SWEEPS)
                    own_rel = float((own.double() - ref).abs().max()
                                    / ref.abs().max())
                    note = f" (f32 plain's own rel {own_rel:.3e})"
                lines.append(f"{name} {dname}: max |err| {err:.3e}, rel "
                             f"{rel:.3e}{note}")
                print("  " + lines[-1], flush=True)
                if not rel <= SOR_BAR[dname]:
                    bad.append(f"{name} {dname}: rel {rel:.3e}")
                if not name.startswith("c"):
                    timed[(name[0], dname)] = (base, cf, x0, mask)
        if bad:
            raise AssertionError("SOR kernel vs f64 plain above the bar: "
                                 + "; ".join(bad))
        from turbomesh_tpu_torch.ops import _build

        print("  SOR schedules: " + "; ".join(schedules.values())
              + "\n  ptxas sor:\n    " + "\n    ".join(ptxas_report(
                  _build.log_path(_build.build_library("sor")).read_text())),
              flush=True)

        times = {}
        for (case, dname), (base, cf, x0, mask) in timed.items():
            times[(case, dname)] = (
                cuda_time_ms(torch, lambda: sor.red_black_sor(
                    base, cf, x0, mask, 1.5, SOR_SWEEPS), SOR_RUN)[0],
                cuda_time_ms(torch, lambda: sor.red_black_sor_ref(
                    base, cf, x0, mask, 1.5, SOR_SWEEPS), 1, reps=3)[0])
            elem = 4 if dname == "float32" else 8
            b_ms, b_by = bound_ms(
                x0.numel() // 2 * (8 * elem + 1),
                int(mask.sum())
                * (SOR_FLOPS_SETUP + SOR_SWEEPS * SOR_FLOPS_PER_SWEEP), dname)
            times[(case, dname)] += (b_ms, b_by)
        ms, plain, b_ms, b_by = times[("a", "float32")]
        self.kernels["red_black_sor"].update(
            max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, launches_per_call=per_calls[("a", "float32")])
        timing = "; ".join(
            f"({case}) {dname}: kernel {k:.4f} ms, plain {p:.4f} ms, bound "
            f"{b:.4f} ms ({by})"
            for (case, dname), (k, p, b, by) in times.items())
        return (f"{SOR_SWEEPS} sweeps; launches a call "
                + ", ".join(f"({c}) {d} {n}" for (c, d), n in
                            per_calls.items())
                + "; " + "; ".join(lines) + f" (bars: rel <= {SOR_BAR}); a call, "
                f"median of {TIMING_REPS} runs of {SOR_RUN} back-to-back "
                f"calls (plain: 3 single calls): {timing}")

    def p4_main_path(self):
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
        return (f"T106 {len(coords)} points, {n_done} White Picard "
                f"iterations, residual {disp:.3e}, last linear residual "
                f"{smoother.last_linear_residual:.3e} (converged), "
                f"{launches} zebra launches, {ext} read back bit-identical")

    def p5_oracle(self):
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

    def p6_scale4(self):
        import numpy as np

        torch = self.torch
        from turbomesh_tpu_torch.ops import zebra
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
        launches = zebra.ZEBRA_LAUNCHES
        t0 = time.perf_counter()
        coords, _cf, disp, iters = dev.run(mesh.flat_coords(), cf,
                                           SCALE4_PICARD_CAP,
                                           target_residual=TARGET)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = zebra.ZEBRA_LAUNCHES - launches
        peak = torch.cuda.max_memory_allocated()
        if not np.all(np.isfinite(coords)):
            raise AssertionError("non-finite coordinates")
        if not disp < TARGET:
            raise AssertionError(f"residual {disp:.3e} not below {TARGET} "
                                 f"after {iters} Picard iterations")
        self._scale4 = coords
        self._p6 = dict(iters=iters, seconds=dt, peak_mib=peak / 2**20)
        p = dev.plan
        return (f"scale 4: {n} points (padded {p.B}x{p.N}x{p.M}), "
                f"{iters} Picard iterations to residual {disp:.3e} in "
                f"{dt:.2f} s (earlier record, PERF.md: {EARLIER_SCALE4[0]} s, "
                f"{EARLIER_SCALE4[1]} iterations; setup {t_setup:.2f} s); "
                f"run-to-target "
                f"{n / dt / 1e6:.4f} Mnodes/s, per iteration "
                f"{n * iters / dt / 1e6:.4f} Mnodes/s; max_memory_allocated "
                f"{peak / 2**20:.1f} MiB; linear rtols "
                f"{sorted(set(dev.last_run_rtols))}; {launches} zebra "
                f"launches, {launches / iters:.1f} per Picard iteration")

    # -- the sharded path ----------------------------------------------------

    def _spawn_tasks(self, world, backend, device, tasks):
        """Run ``shard.run_tasks`` on a new world of ``world`` ranks; the
        zebra kernel is built here first, so the ranks only load it."""
        import functools

        from turbomesh_tpu_torch.ops import _build
        from turbomesh_tpu_torch.parallel import dist as pdist
        from turbomesh_tpu_torch.parallel import shard

        _build.build_library("zebra")
        return pdist.spawn(functools.partial(shard.run_tasks, device=device),
                           world, backend, device, args=(tasks,))

    @staticmethod
    def _ranks(recs, what):
        """Per-rank walls, iterations, restarts per iteration, K-A launches,
        exchanges and all_reduces of one task."""
        return "; ".join(
            f"rank {r['rank']}: {r['seconds']:.2f} s, "
            + (f"{r['n_done']} Picard iterations, restarts "
               f"{r['restart_history']}, " if "n_done" in r else
               f"restarts {r['restarts']}, ")
            + f"{r['zebra_launches']} zebra launches, "
            f"{r.get('chain_launches', 'no')} chain launches "
            f"({r.get('chain_rows', '?')} chain rows), {r['exchanges']} "
            f"exchanges and {r['all_reduces']} all_reduces taking "
            f"{r['collective_s']:.2f} s"
            + (f", peak {r['peak_mib']:.1f} MiB" if "peak_mib" in r else "")
            for r in recs) + f" ({what})"

    def _sharded_scale4(self, world, name, bad):
        """The scale-4 Laplace run to 1e-10 on a new NCCL world of
        ``world`` ranks, a card a rank where there are cards enough (phase
        8 (a) and (c)); appends its faults to ``bad``, returns its line."""
        import numpy as np

        from turbomesh_tpu_torch.smoothing.control_function import Laplace

        s4 = self.mesh("scale4")
        task = dict(mesh=s4, cf=Laplace().init(s4),
                    iterations=SCALE4_PICARD_CAP, target_residual=TARGET,
                    smoother=dict(rtol=1e-6, atol=1e-8, restart=10,
                                  max_restarts=30))
        t0 = time.perf_counter()
        recs = [r[0] for r in self._spawn_tasks(world, "nccl", "cuda",
                                                [task])]
        name = f"{name}, {time.perf_counter() - t0:.2f} s with start-up"
        for r in recs:
            if r["zebra_launches"] <= 0:
                bad.append(f"{name}: rank {r['rank']} launched no zebra "
                           f"kernel")
            np.testing.assert_array_equal(r["coords"], recs[0]["coords"])
        r = recs[0]
        if not np.all(np.isfinite(r["coords"])):
            bad.append(f"{name}: non-finite coordinates")
        if not r["disp"] < TARGET:
            bad.append(f"{name}: residual {r['disp']:.3e} after "
                       f"{r['n_done']} iterations")
        delta = ("phase 6 not run" if self._scale4 is None else
                 f"max |delta| vs phase 6's DeviceSmoother "
                 f"{np.abs(r['coords'] - self._scale4).max():.3e}")
        line = (f"{name}: {s4.num_points} points, {r['n_done']} Picard "
                f"iterations (without the correction embeddings: "
                f"{EARLIER_SHARDED_SCALE4_ITERS}; phase 6: "
                f"{self._p6['iters'] if self._p6 else 'not run'}), residual "
                f"{r['disp']:.3e}; {delta}; " + self._ranks(recs, name))
        print("  " + line, flush=True)
        return line

    def p8c_cards(self, bad):
        """Phase 8 (c): NCCL over min(4, count) cards, a card a rank, when
        the machine has two or more; else the reason it did not run."""
        count = self.torch.cuda.device_count()
        if count < 2:
            return (f"(c) not run: {count} CUDA device (NCCL needs a card a "
                    f"rank)")
        world = min(SHARDED_WORLD, count)
        return self._sharded_scale4(
            world, f"(c) nccl world {world}, one card a rank", bad)

    def p8_sharded(self):
        import numpy as np

        from turbomesh_tpu_torch import input as input_mod
        from turbomesh_tpu_torch.smoothing.classify import classify
        from turbomesh_tpu_torch.smoothing.control_function import (
            Laplace, from_config)
        from turbomesh_tpu_torch.smoothing.device import DeviceSmoother
        from turbomesh_tpu_torch.smoothing.system import SparseSystem

        bad = []
        # (a) NCCL, world 1, at scale 4
        lines = [self._sharded_scale4(1, "(a) nccl world 1", bad)]

        # (b) gloo, world 4, every rank on cuda:0, T106; this process runs
        # DeviceSmoother.run on the same card meanwhile
        from concurrent.futures import ThreadPoolExecutor

        t106 = self.mesh("t106")
        inp = input_mod.load(str(T106), base_dir=str(T106.parent))
        white = from_config(inp.smoothing.wall_control_function)
        lap = Laplace().init(t106)
        tol = dict(rtol=SHARDED_RTOL, atol=SHARDED_ATOL, restart=30,
                   max_restarts=100)
        info = classify(t106)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(1) as pool:
            world = pool.submit(self._spawn_tasks, SHARDED_WORLD, "gloo",
                                "cuda:0", [
                dict(mesh=t106, cf=white.init(t106),
                     iterations=SHARDED_WHITE_ITERS, algorithm=white,
                     smoother=tol),
                dict(mesh=t106, cf=lap, solves=1,
                     smoother=dict(rtol=1e-15, atol=1e-18, restart=30,
                                   max_restarts=100))])
            dev = DeviceSmoother(t106, info, device="cuda", **tol)
            hist, dev_restarts = [], []
            cd, cfd, _, _ = dev.run(t106.flat_coords(), white.init(t106),
                                    SHARDED_WHITE_ITERS, algorithm=white,
                                    residual_history=hist,
                                    restart_history=dev_restarts)
            t_dev = time.perf_counter() - t0
            recs = world.result()
        wall = time.perf_counter() - t0
        runs, solves = [r[0] for r in recs], [r[1] for r in recs]
        for r in runs + solves:
            if r["zebra_launches"] <= 0:
                bad.append(f"(b): rank {r['rank']} launched no zebra kernel")
            if (r["chain_launches"] > 0) != (r["chain_rows"] > 0):
                bad.append(f"(b): rank {r['rank']} with {r['chain_rows']} "
                           f"chain rows launched K-I {r['chain_launches']} "
                           f"times")
        for r in runs[1:]:
            np.testing.assert_array_equal(r["coords"], runs[0]["coords"])
            np.testing.assert_array_equal(r["cf"], runs[0]["cf"])
        self.kernels["zebra_half_sweep"]["launches_sharded_per_rank"] = [
            r["zebra_launches"] for r in runs]
        e_x = float(np.abs(cd - runs[0]["coords"]).max())
        e_cf = float(np.abs(cfd - runs[0]["cf"]).max())
        e_h = float(np.max(np.abs(np.array(runs[0]["residual_history"])
                                  - hist) / np.abs(hist)))
        if not (e_x < SHARDED_RUN_TOL and e_cf < SHARDED_RUN_TOL
                and e_h <= SHARDED_HIST_RTOL):
            bad.append(f"(b) vs DeviceSmoother.run: coords {e_x:.3e}, cf "
                       f"{e_cf:.3e}, histories rel {e_h:.3e}")
        co = SparseSystem(t106, info).solve(t106.flat_coords(), lap)
        e_o = max(float(np.abs(r["solves"][0] - co).max()) for r in solves)
        if not e_o < ORACLE_TOL:
            bad.append(f"(b) Laplace solve vs oracle {e_o:.3e}")
        lines.append(
            f"(b) gloo world {SHARDED_WORLD} on cuda:0 (time-sliced: a "
            f"correctness run), {wall:.2f} s with start-up: T106 "
            f"{SHARDED_WHITE_ITERS} White iterations at rtol {SHARDED_RTOL}, "
            f"restarts {runs[0]['restart_history']} (the card's "
            f"DeviceSmoother.run {dev_restarts}; without the correction "
            f"embeddings {EARLIER_SHARDED_RESTARTS}), "
            f"max |delta| vs the card's DeviceSmoother.run (run meanwhile, "
            f"{t_dev:.2f} s) "
            f"coords {e_x:.3e}, cf {e_cf:.3e} (bar {SHARDED_RUN_TOL}), "
            f"residual histories rel {e_h:.3e} (bar "
            f"{SHARDED_HIST_RTOL}); "
            + self._ranks(runs, "White run")
            + f"; Laplace solve at rtol 1e-15 vs host oracle {e_o:.3e}; "
            + self._ranks(solves, "Laplace solve"))
        print("  " + lines[-1], flush=True)

        # (c) NCCL, a card a rank, when there are cards enough
        lines.append(self.p8c_cards(bad))
        if bad:
            raise AssertionError("; ".join(bad))
        return "; ".join(lines)

    def p9_stacked_cuts(self):
        from turbomesh_tpu_torch import demo_3d_sharded as demo
        from turbomesh_tpu_torch.ops import _build

        _build.build_library("zebra")
        rec = demo.run_demo(n_cuts=3, picard=1, mesh_scale=1, world=2,
                            device="cuda")
        cuts, m3 = rec["cuts"], rec["mesh3d"]
        mid = cuts[1]
        bad = []
        if not mid["reached_target"]:
            bad.append(f"mid cut at {mid['displacement_residual']:.3e} after "
                       f"{mid['picard_done']} iterations")
        if m3["nodes_3d"] != 3 * 25118 or not m3["ok"]:
            bad.append(f"3-D mesh {m3}")
        for c in cuts:
            if min(c["zebra_launches_per_rank"]) <= 0:
                bad.append(f"cut {c['cut']}: a rank launched no zebra kernel")
        if bad:
            raise AssertionError("; ".join(bad))
        return (f"{rec['backend']} world {rec['world']} ({rec['device']}, "
                f"time-sliced), {rec['wall_s']:.2f} s with start-up; "
                + "; ".join(
                    f"cut {c['cut']} ({c['nodes']} points): "
                    f"{c['picard_done']} Picard iterations"
                    f"{' (frozen cf, to 1e-10)' if c['driven_to_target'] else ' (White)'}"
                    f" in {c['run_s']:.2f} s (set-up {c['setup_s']:.2f} s), "
                    f"residual {c['displacement_residual']:.3e}, restarts "
                    f"{c['fgmres_restarts_per_iter']}, zebra launches per "
                    f"rank {c['zebra_launches_per_rank']}" for c in cuts)
                + f"; 3-D: {m3}")

    # -- the last modules ------------------------------------------------------

    def p10_last_modules(self):
        from turbomesh_tpu_torch import input as input_mod

        inp = input_mod.load(str(T106), base_dir=str(T106.parent))
        bad, lines = [], []
        for part in (self.p10a_deflation, self.p10b_sharded_deflation,
                     self.p10d_trace, self.p10e_service, self.p10f_tfi):
            t0 = time.perf_counter()
            line = f"{part(inp, bad)} ({time.perf_counter() - t0:.2f} s)"
            print("  " + line, flush=True)
            lines.append(line)
        if bad:
            raise AssertionError("; ".join(bad))
        return "; ".join(lines)

    def p10a_deflation(self, inp, bad):
        import numpy as np

        torch = self.torch
        from turbomesh_tpu_torch.ops import chain, zebra
        from turbomesh_tpu_torch.smoothing.classify import classify
        from turbomesh_tpu_torch.smoothing.control_function import (
            Laplace, from_config)
        from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

        # a mesh of its own: the White update moves its coordinates
        mesh = inp.template.run(inp.geometry)
        info = classify(mesh)
        white = from_config(inp.smoothing.wall_control_function)
        start = mesh.flat_coords()
        tol = dict(rtol=DEFL_RTOL, atol=DEFL_ATOL, restart=30,
                   max_restarts=100)
        modes = (None,) + DEFL_MODES
        sms = {m: DeviceSmoother(mesh, info, device="cuda", deflation=m,
                                 **tol) for m in modes}
        cf = white.init(mesh)
        coords = {m: start for m in modes}
        stats = {m: dict(restarts=[], launches=0, chain=0, seconds=0.0)
                 for m in modes}
        for n in range(DEFL_SOLVES):
            if n > 0:
                mesh.set_flat_coords(coords[None])
                white.update(cf, mesh)
            for m in modes:
                torch.cuda.synchronize()
                zebra.ZEBRA_LAUNCHES = chain.CHAIN_LAUNCHES = 0
                t0 = time.perf_counter()
                coords[m] = sms[m].solve(coords[m], cf)
                torch.cuda.synchronize()
                st = stats[m]
                st["seconds"] += time.perf_counter() - t0
                st["launches"] += zebra.ZEBRA_LAUNCHES
                st["chain"] += chain.CHAIN_LAUNCHES
                st["restarts"].append(sms[m].last_restarts)
                if not sms[m].last_linear_converged:
                    bad.append(f"(a) deflation {m}: solve {n} did not "
                               f"converge")
        out = []
        for m in modes:
            st, sm = stats[m], sms[m]
            if st["launches"] <= 0:
                bad.append(f"(a) deflation {m}: no zebra launch")
            if st["chain"] <= 0:
                bad.append(f"(a) deflation {m}: no K-I launch")
            err = float(np.abs(coords[m] - coords[None]).max())
            if m is not None and not err < DEFL_TOL:
                bad.append(f"(a) deflation {m}: {err:.3e} from the "
                           f"undeflated solves")
            desc = (f"{m or 'off'}: K {sm._defl_K}, restarts "
                    f"{st['restarts']}, {st['launches']} zebra launches, "
                    f"{st['chain']} K-I launches, {st['seconds']:.2f} s")
            if m is not None:
                desc += (f", max |delta| vs off {err:.3e} (bar {DEFL_TOL}),"
                         f" Galerkin build {self._galerkin_ms(sm, mesh, start):.2f}"
                         f" ms")
            out.append(desc)
        mesh.set_flat_coords(start)

        # scale 4 to 1e-10 with "y", as phase 6 runs it
        s4 = self.mesh("scale4")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dev = DeviceSmoother(s4, classify(s4), device="cuda", rtol=1e-6,
                             atol=1e-8, restart=10, max_restarts=10,
                             deflation="y")
        zebra.ZEBRA_LAUNCHES = 0
        rhist = []
        t0 = time.perf_counter()
        c4, _cf, disp, iters = dev.run(s4.flat_coords(), Laplace().init(s4),
                                       SCALE4_PICARD_CAP,
                                       target_residual=TARGET,
                                       restart_history=rhist)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = zebra.ZEBRA_LAUNCHES
        peak = torch.cuda.max_memory_allocated() / 2**20
        if not (np.all(np.isfinite(c4)) and disp < TARGET and launches > 0):
            bad.append(f"(a) scale 4 with deflation y: residual {disp:.3e} "
                       f"after {iters} iterations, {launches} zebra launches")
        p6 = ("phase 6 not run" if self._p6 is None else
              f"phase 6: {self._p6['iters']} iterations, "
              f"{self._p6['seconds']:.2f} s, peak {self._p6['peak_mib']:.1f}"
              f" MiB")
        return (f"(a) T106 deflation, {DEFL_SOLVES} solves at rtol "
                f"{DEFL_RTOL}: " + "; ".join(out)
                + f"; scale 4 with y (K {dev._defl_K}): {iters} Picard "
                f"iterations to {disp:.3e} in {dt:.2f} s, restarts {rhist},"
                f" peak {peak:.1f} MiB, {launches} zebra launches ({p6})")

    def _galerkin_ms(self, sm, mesh, coords):
        """Device time of one Galerkin build (K operator applications and
        the K x K factorisation) at the frozen base of ``coords``, median
        of 3 between CUDA events."""
        from turbomesh_tpu_torch.smoothing.control_function import Laplace

        X, C = sm._upload(coords, Laplace().init(mesh))
        ctx = sm._stage_prepare32(sm._stage_base(X, C)[0], C)
        return cuda_time_ms(self.torch, lambda: sm._defl_galerkin(ctx), 1,
                            reps=3)[0]

    def p10b_sharded_deflation(self, inp, bad):
        import numpy as np

        from turbomesh_tpu_torch.smoothing.classify import classify
        from turbomesh_tpu_torch.smoothing.control_function import Laplace
        from turbomesh_tpu_torch.smoothing.system import SparseSystem

        t106 = self.mesh("t106")
        lap = Laplace().init(t106)
        t0 = time.perf_counter()
        (r,), = self._spawn_tasks(1, "nccl", "cuda", [dict(
            mesh=t106, cf=lap, solves=1,
            smoother=dict(rtol=1e-15, atol=1e-18, restart=30,
                          max_restarts=100, deflation="y"))])
        wall = time.perf_counter() - t0
        self._p10b_restarts = r["restarts"]
        co = SparseSystem(t106, classify(t106)).solve(t106.flat_coords(),
                                                       lap)
        err = float(np.abs(r["solves"][0] - co).max())
        if not (err < SHARDED_DEFL_TOL and r["zebra_launches"] > 0
                and r["defl_K"] > 0):
            bad.append(f"(b) sharded deflation: {err:.3e} from the oracle, "
                       f"K {r['defl_K']}, {r['zebra_launches']} zebra "
                       f"launches")
        # as 8(b)'s Laplace solve: the oracle is the bar; the sharded plain
        # residual stalls near 2.5e-17 on T106, above atol 1e-18, so the
        # converged flag is printed, not held
        return (f"(b) nccl world 1, deflation y (K {r['defl_K']}), T106 "
                f"Laplace solve at rtol 1e-15, atol 1e-18: max |delta| vs "
                f"host oracle {err:.3e} (bar {SHARDED_DEFL_TOL}), converged "
                f"flag {r['converged']}, {wall:.2f} s with start-up; "
                + self._ranks([r], "solve"))

    def p10d_trace(self, inp, bad):
        torch = self.torch
        from turbomesh_tpu_torch.profiling import torch_trace
        from turbomesh_tpu_torch.smoothing.classify import classify
        from turbomesh_tpu_torch.smoothing.control_function import (
            from_config)
        from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

        mesh = self.mesh("t106")
        white = from_config(inp.smoothing.wall_control_function)
        dev = DeviceSmoother(mesh, classify(mesh), device="cuda", rtol=1e-4,
                             atol=1e-11)
        cf = white.init(mesh)
        dev.run(mesh.flat_coords(), cf, 1, algorithm=white)   # warm-up
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            with torch_trace(tmp):
                t0 = time.perf_counter()
                dev.run(mesh.flat_coords(), cf, 1, algorithm=white)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            path = pathlib.Path(tmp) / "trace.json"
            if not path.exists():
                bad.append("(d) torch_trace wrote no trace")
                return "(d) no trace"
            size = path.stat().st_size
            events = json.loads(path.read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        busy_us = sum(float(e.get("dur", 0.0)) for e in kernels)
        return (f"(d) torch_trace of one T106 Picard iteration (White, "
                f"rtol 1e-4, under the profiler): trace {size / 2**20:.1f} "
                f"MiB, {len(kernels)} CUDA kernels, kernel time "
                f"{busy_us / 1e3:.2f} ms of {wall * 1e3:.2f} ms wall: "
                f"device busy {100 * busy_us / 1e6 / wall:.2f} %")

    def p10e_service(self, inp, bad):
        import urllib.request

        import numpy as np

        from turbomesh_tpu_torch import web
        from turbomesh_tpu_torch import input as input_mod
        from turbomesh_tpu_torch.smoothing import smooth_mesh

        cfg = json.loads(T106.read_text())
        httpd = web.serve(port=0, base_dir=str(T106.parent), device="cuda")
        base = f"http://127.0.0.1:{httpd.server_address[1]}"

        def post(c):
            req = urllib.request.Request(
                f"{base}/run", data=json.dumps(c).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                return json.loads(resp.read())

        def points(b, mesh):
            ni, nj = mesh.blocks[b].size
            with urllib.request.urlopen(f"{base}/block/{b}/points",
                                        timeout=60) as resp:
                raw = resp.read()
            return np.frombuffer(raw, dtype="<f8").reshape(ni, nj, 2)

        out = []
        try:
            for iters in (0, 2):
                c = dict(cfg, smoothing=dict(cfg["smoothing"],
                                             iterations=iters,
                                             solver="device"))
                t0 = time.perf_counter()
                res = post(c)
                t_srv = time.perf_counter() - t0
                direct = input_mod.load(c, base_dir=str(T106.parent))
                mesh = direct.template.run(direct.geometry)
                if iters:
                    smooth_mesh(mesh, iterations=iters, solver="device",
                                wall_control_function=(
                                    direct.smoothing.wall_control_function),
                                device="cuda")
                err = max(float(np.abs(points(b, mesh)
                                       - mesh.blocks[b].points).max())
                          for b in range(len(mesh.blocks)))
                bar = 0.0 if iters == 0 else SERVICE_TOL
                if res["blocks"] != len(mesh.blocks) or err > bar:
                    bad.append(f"(e) service, {iters} iterations: {err:.3e} "
                               f"from the direct run (bar {bar})")
                out.append(f"{iters} iterations: {res['blocks']} blocks, "
                           f"{res['points']} points, POST /run {t_srv:.2f} "
                           f"s, max |delta| vs direct {err:.3e} (bar {bar})")
        finally:
            httpd.shutdown()
            httpd.server_close()
        return "(e) web.serve(device='cuda'): " + "; ".join(out)

    def p10f_tfi(self, inp, bad):
        import numpy as np

        torch = self.torch
        from turbomesh_tpu_torch import tfi

        mesh = self.mesh("t106")
        pts = max((b.points for b in mesh.blocks), key=lambda a: a.size)

        def param(edge):
            d = np.concatenate([[0.0], np.cumsum(np.linalg.norm(
                np.diff(edge, axis=0), axis=1))])
            return d / d[-1]

        edges = (pts[:, 0], pts[:, -1], pts[0, :], pts[-1, :])
        args = edges + (param(pts[:, 0]), param(pts[:, -1]),
                        param(pts[0, :]), param(pts[-1, :]))
        errs = []
        for fn, a in ((tfi.blended_tfi, args), (tfi.linear_tfi, edges)):
            cpu = fn(*(torch.as_tensor(x) for x in a))
            dev = fn(*(torch.as_tensor(x, device="cuda") for x in a))
            if dev.device.type != "cuda":
                bad.append(f"(f) {fn.__name__} left the card")
            errs.append(float((dev.cpu() - cpu).abs().max()))
        if not max(errs) < TFI_TOL:
            bad.append(f"(f) bulk TFI card vs CPU {errs}")
        return (f"(f) blended_tfi / linear_tfi at {pts.shape[0]} x "
                f"{pts.shape[1]}, f64: card vs CPU {errs[0]:.3e} / "
                f"{errs[1]:.3e} (bar {TFI_TOL})")


    # -- the preconditioner's options ----------------------------------------

    def p11_mg_opts(self):
        from turbomesh_tpu_torch import input as input_mod

        inp = input_mod.load(str(T106), base_dir=str(T106.parent))
        bad, lines = [], []
        for part in (self.p11a_options, self.p11b_scale4_base,
                     self.p11c_sharded):
            t0 = time.perf_counter()
            line = f"{part(inp, bad)} ({time.perf_counter() - t0:.2f} s)"
            print("  " + line, flush=True)
            lines.append(line)
        if bad:
            raise AssertionError("; ".join(bad))
        return "; ".join(lines)

    def p11a_options(self, inp, bad):
        from turbomesh_tpu_torch.smoothing.control_function import (
            from_config)
        from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

        mesh = self.mesh("t106")
        cf = from_config(inp.smoothing.wall_control_function).init(mesh)
        runs = mg_option_solves(mesh, cf, "cuda", self.torch.cuda.synchronize)
        out = []
        for run in runs:
            name = run["name"]
            if not run["converged"]:
                bad.append(f"(a) {name}: the solve did not converge")
            if run["launches"] <= 0 or run["launches"] != run["predicted"]:
                bad.append(f"(a) {name}: {run['launches']} zebra launches, "
                           f"the schedule predicts {run['predicted']}")
            if run["chain"] <= 0:
                bad.append(f"(a) {name}: no K-I launch")
            if run["opts"] is not None and not run["err"] < MG_TOL:
                bad.append(f"(a) {name}: {run['err']:.3e} from the default "
                           f"solve")
            out.append(f"{name} (L {run['levels']}): restarts "
                       f"{run['restarts']}, {run['launches']} zebra launches "
                       f"(predicted {run['predicted']}), {run['chain']} K-I "
                       f"launches, {run['seconds']:.2f} s"
                       + ("" if run["opts"] is None else
                          f", max |delta| vs default {run['err']:.3e}"))
        return (f"(a) T106 White solve at rtol {MG_RTOL}, atol {MG_ATOL}, "
                f"FGMRES({MG_RESTART}) (defaults "
                f"{DeviceSmoother.MG_DEFAULTS}; bar {MG_TOL}): "
                + "; ".join(out))

    def p11b_scale4_base(self, inp, bad):
        import numpy as np

        torch = self.torch
        from turbomesh_tpu_torch.ops import zebra
        from turbomesh_tpu_torch.smoothing.classify import classify
        from turbomesh_tpu_torch.smoothing.control_function import Laplace
        from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

        s4 = self.mesh("scale4")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dev = DeviceSmoother(s4, classify(s4), device="cuda", rtol=1e-6,
                             atol=1e-8, restart=10, max_restarts=10,
                             mg_opts={"schur": False})
        zebra.ZEBRA_LAUNCHES = 0
        rhist = []
        t0 = time.perf_counter()
        c4, _cf, disp, iters = dev.run(s4.flat_coords(), Laplace().init(s4),
                                       SCALE4_PICARD_CAP,
                                       target_residual=TARGET,
                                       restart_history=rhist)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = zebra.ZEBRA_LAUNCHES
        peak = torch.cuda.max_memory_allocated() / 2**20
        if not (np.all(np.isfinite(c4)) and disp < TARGET and launches > 0):
            bad.append(f"(b) scale 4 with schur False: residual {disp:.3e} "
                       f"after {iters} iterations, {launches} zebra launches")
        p6 = ("phase 6 not run" if self._p6 is None else
              f"phase 6: {self._p6['iters']} iterations, "
              f"{self._p6['seconds']:.2f} s, peak {self._p6['peak_mib']:.1f}"
              f" MiB")
        return (f"(b) scale 4 with schur False: {iters} Picard iterations to "
                f"{disp:.3e} in {dt:.2f} s, restarts {rhist}, peak "
                f"{peak:.1f} MiB, {launches} zebra launches ({p6})")

    def p11c_sharded(self, inp, bad):
        import numpy as np

        from turbomesh_tpu_torch.smoothing.classify import classify
        from turbomesh_tpu_torch.smoothing.control_function import Laplace
        from turbomesh_tpu_torch.smoothing.system import SparseSystem

        t106 = self.mesh("t106")
        lap = Laplace().init(t106)
        tol = dict(rtol=1e-15, atol=1e-18, restart=30, max_restarts=100)
        names = ("schur", "schur False")
        t0 = time.perf_counter()
        (recs,) = self._spawn_tasks(1, "nccl", "cuda", [
            dict(mesh=t106, cf=lap, solves=1, smoother=tol),
            dict(mesh=t106, cf=lap, solves=1,
                 smoother=dict(tol, mg_opts={"schur": False}))])
        wall = time.perf_counter() - t0
        co = SparseSystem(t106, classify(t106)).solve(t106.flat_coords(),
                                                       lap)
        out = []
        for name, r in zip(names, recs):
            err = float(np.abs(r["solves"][0] - co).max())
            if not (err < ORACLE_TOL and r["zebra_launches"] > 0
                    and r["defl_K"] == 0):
                bad.append(f"(c) sharded {name}: {err:.3e} from the oracle, "
                           f"{r['zebra_launches']} zebra launches, K "
                           f"{r['defl_K']}")
            # the converged flag is printed, not held (10(b))
            out.append(f"{name}: max |delta| vs host oracle {err:.3e} (bar "
                       f"{ORACLE_TOL}), restarts {r['restarts']}, converged "
                       f"flag {r['converged']}; " + self._ranks([r], name))
        return (f"(c) nccl world 1, undeflated, T106 Laplace solve at rtol "
                f"1e-15, atol 1e-18, FGMRES(30), {wall:.2f} s with start-up "
                f"(10(b), deflated y: restarts "
                f"{self._p10b_restarts or 'not run'}): " + "; ".join(out))

    def p12_chain(self):
        bad, lines = [], []
        for part in (self.p12a_kernel, self.p12b_trajectory,
                     self.p12c_winslow):
            t0 = time.perf_counter()
            line = f"{part(bad)} ({time.perf_counter() - t0:.2f} s)"
            print("  " + line, flush=True)
            lines.append(line)
        if bad:
            raise AssertionError("; ".join(bad))
        return "; ".join(lines)

    def p12a_kernel(self, bad):
        import numpy as np

        torch = self.torch
        from turbomesh_tpu_torch.ops import chain
        from turbomesh_tpu_torch.smoothing.classify import classify
        from turbomesh_tpu_torch.smoothing.control_function import White
        from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

        mesh = self.mesh("t106")
        sm = DeviceSmoother(mesh, classify(mesh), device="cuda")
        cf = White(ds_target=1e-6).init(mesh)
        X, C = sm._upload(mesh.flat_coords(), cf)
        base, _ = sm._stage_base(X, C)
        ctx = sm._stage_prepare32(base, C)
        p = sm._p32
        rng = np.random.default_rng(14)
        P = p["free_mask"].numel() // 2
        vflat, zf = (torch.as_tensor(rng.standard_normal((P, 2)),
                                     dtype=torch.float32, device="cuda")
                     for _ in range(2))
        # both versions update the field in place: each gets a copy
        args = (ctx["chain"], p["c_seg"], p["c_seg_valid"], p["c_seg_pos"],
                p["c_row"], vflat, zf.clone())
        n0 = chain.CHAIN_LAUNCHES
        got = chain.chain_solve(*args)
        calls = chain.CHAIN_LAUNCHES - n0
        want = chain.chain_solve_ref(*args[:-1], zf.clone())
        torch.cuda.synchronize()
        same = (torch.equal(got, want)
                and torch.equal(got.view(torch.int32), want.view(torch.int32)))
        if not same or calls != 1:
            diff = int((got != want).sum())
            bad.append(f"(a) K-I vs plain on T106: {diff} values differ, "
                       f"{calls} launches a call")
        S, L = p["c_seg"].shape
        nc = int(p["c_row"].shape[0])
        # bytes of one kernel call: the table's mask, the table and c_row
        # twice (gather, scatter), the coefficients, the rhs, the field's
        # rows read and written
        nbytes = S * L + nc * (2 * 8 + 2 * 8 + 3 * 4 + 8 + 2 * 8)
        b_ms, b_by = bound_ms(nbytes, CHAIN_FLOPS_PER_POINT * S * L,
                              "float32")
        k_ms, k_one = cuda_time_ms(torch, lambda: chain.chain_solve(*args),
                                   CHAIN_RUN)
        r_ms, r_one = cuda_time_ms(torch,
                                   lambda: chain.chain_solve_ref(*args),
                                   PLAIN_RUN)
        g_us = graph_us(torch, lambda: chain.chain_solve(*args))
        self.kernels["chain_solve"].update(
            max_abs_err=float((got - want).abs().max()), ms=k_ms,
            plain_ms=r_ms, bound_ms=b_ms, bound_by=b_by)
        return (f"(a) T106 table ({S}, {L}), {nc} rows: K-I vs plain bit for "
                f"bit {same}, {calls} launch a call; a call, median of "
                f"{TIMING_REPS} runs between CUDA events: K-I {k_ms:.5f} ms "
                f"({CHAIN_RUN} back-to-back; one-call window {k_one:.5f} "
                f"ms), device {g_us:.3f} us a call in a CUDA graph of 200; "
                f"plain {r_ms:.4f} ms "
                f"({PLAIN_RUN} back-to-back; one-call {r_one:.4f} ms); bound "
                f"{b_ms:.2e} ms ({b_by})")

    def p12b_trajectory(self, bad):
        import numpy as np

        torch = self.torch
        from turbomesh_tpu_torch import input as input_mod
        from turbomesh_tpu_torch.ops import chain, glue, winslow, zebra
        from turbomesh_tpu_torch.profiling import PhaseTimer
        from turbomesh_tpu_torch.smoothing import smooth_mesh

        kernel = chain.chain_solve

        def job(route):
            inp = input_mod.load(str(T106), base_dir=str(T106.parent))
            mesh = inp.template.run(inp.geometry)
            timer = PhaseTimer()
            if route == "plain":
                chain.chain_solve = chain.chain_solve_ref
            zebra.ZEBRA_LAUNCHES = chain.CHAIN_LAUNCHES = 0
            winslow.WINSLOW_LAUNCHES = glue.GLUE_LAUNCHES = 0
            t0 = time.perf_counter()
            try:
                smooth_mesh(mesh, inp.smoothing.iterations, solver="device",
                            wall_control_function=(
                                inp.smoothing.wall_control_function),
                            timer=timer, device="cuda")
                torch.cuda.synchronize()
            finally:
                chain.chain_solve = kernel
            n = inp.smoothing.iterations
            return dict(coords=mesh.flat_coords(),
                        zebra=zebra.ZEBRA_LAUNCHES,
                        chain=chain.CHAIN_LAUNCHES,
                        winslow=winslow.WINSLOW_LAUNCHES / n,
                        glue=glue.GLUE_LAUNCHES, iterations=n,
                        seconds=time.perf_counter() - t0,
                        interface=timer.totals["precond.interface"] / n,
                        picard=timer.totals["picard_loop"] / n,
                        spans={name: timer.totals.get(name, 0.0) / n
                               for name in P12_SPANS})

        runs = {route: job(route) for route in ("plain", "kernel")}
        a, b = runs["plain"], runs["kernel"]
        self.kernels["chain_solve"]["launches_t106_10_iterations"] = (
            b["chain"])
        same = np.array_equal(a["coords"], b["coords"])
        self.kernels["winslow_apply"]["launches_t106_iteration"] = (
            b["winslow"])
        # K-G once a zebra half-sweep of the main path (the V-cycle's
        # smooths, eager and replayed), on either route of the chain solve
        self.kernels["glue_planes"]["launches_t106_iteration"] = (
            b["glue"] / b["iterations"])
        if not (same and a["zebra"] == b["zebra"] > 0 and a["chain"] == 0
                and b["chain"] == CHAIN_LEN_T106
                and a["winslow"] == b["winslow"] > 0
                and a["glue"] == a["zebra"] and b["glue"] == b["zebra"]):
            bad.append(f"(b) T106 plain vs K-I: coordinates equal {same} "
                       f"(max |delta| "
                       f"{float(np.abs(a['coords'] - b['coords']).max()):.3e}"
                       f"), zebra launches {a['zebra']} / {b['zebra']}, "
                       f"chain launches {a['chain']} / {b['chain']} (want 0 "
                       f"/ {CHAIN_LEN_T106}), K-W launches an iteration "
                       f"{a['winslow']} / {b['winslow']}, K-G launches "
                       f"{a['glue']} / {b['glue']} (want the zebra "
                       f"launches)")
        return (f"(b) T106 smooth_mesh, 10 White iterations, chain solve "
                f"plain / K-I: final coordinates bit for bit {same}; zebra "
                f"launches {a['zebra']} / {b['zebra']}; chain launches "
                f"{a['chain']} / {b['chain']}; K-G launches {a['glue']} / "
                f"{b['glue']}; K-W launches an iteration "
                f"{a['winslow']:.1f} / {b['winslow']:.1f}; wall {a['seconds']:.3f} / "
                f"{b['seconds']:.3f} s; picard_loop an iteration "
                f"{a['picard']:.4f} / {b['picard']:.4f} s; precond.interface "
                f"an iteration {a['interface']:.4f} / {b['interface']:.4f} s; "
                f"K-I's run, seconds an iteration by span: "
                + ", ".join(f"{k} {v:.4f}" for k, v in b["spans"].items()))

    def p12c_winslow(self, bad):
        import numpy as np

        torch = self.torch
        from turbomesh_tpu_torch import input as input_mod
        from turbomesh_tpu_torch.ops import winslow
        from turbomesh_tpu_torch.smoothing.classify import classify
        from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

        out = []
        for name, path in (("T106", T106), ("t106_x2", X2_CONFIG)):
            inp = (input_mod.load(str(path), base_dir=str(path.parent))
                   if path == T106 else
                   input_mod.load(json.loads(path.read_text())))
            mesh = inp.template.run(inp.geometry)
            sm = DeviceSmoother(mesh, classify(mesh), device="cuda")
            rng = np.random.default_rng(12)
            coords = mesh.flat_coords()
            coords = coords + 1e-4 * np.ptp(coords) * rng.standard_normal(
                coords.shape)
            cf = 0.1 * rng.standard_normal((mesh.num_points, 2))
            X, C = sm._upload(coords, cf)
            base, _ = sm._stage_base(X, C)
            ctx = sm._stage_prepare32(base, C)
            t = sm._winslow
            B, N, M = t.shape
            P = B * N * M
            junction = torch.zeros(P, dtype=torch.bool, device="cuda")
            junction[t.decoded(torch.float64)["l_row"]] = True
            calls = {
                "float32": dict(V=torch.as_tensor(
                    rng.standard_normal((P, 2)), dtype=torch.float32,
                    device="cuda"), cf=ctx["cf32"], cG=ctx["cG"], G=ctx["G"]),
                "float64": dict(V=torch.as_tensor(
                    rng.standard_normal((P, 2)), device="cuda"), cf=C,
                    cG=ctx["cG64"], base=base,
                    scale=1.0 / ctx["diag"].to(torch.float64).reshape(-1, 2))}
            parts = []
            for dtype, kw in calls.items():
                V, cfd, cG = kw.pop("V"), kw.pop("cf"), kw.pop("cG")

                def kernel():
                    return winslow.winslow_apply(t, V, cfd, cG, 0.0, **kw)

                def plain():
                    return winslow.winslow_apply_ref(t, V, cfd, cG, 0.0,
                                                     **kw)

                n0 = winslow.WINSLOW_LAUNCHES
                got = kernel()
                n_calls = winslow.WINSLOW_LAUNCHES - n0
                want = plain()
                torch.cuda.synchronize()
                rest = torch.equal(got[~junction].view(torch.uint8),
                                   want[~junction].view(torch.uint8))
                j_bits = torch.equal(got[junction].view(torch.uint8),
                                     want[junction].view(torch.uint8))
                gap = float((got[junction] - want[junction]).abs().max()
                            / want[junction].abs().max())
                if not (rest and gap <= WINSLOW_JUNCTION_RTOL[dtype]
                        and n_calls == 1):
                    bad.append(f"(c) {name} {dtype}: K-W vs plain outside "
                               f"the junction rows bit for bit {rest}, "
                               f"junction gap {gap:.3e}, {n_calls} launches "
                               f"a call")
                s_ = got.element_size()
                C_, L_ = t.C, int(t.plans[torch.float64]["l_rhs"].shape[0])
                S_ = int(t.plans[torch.float64]["s_nb"].shape[0])
                Q_ = int(t.plans[torch.float64]["sl_master"].shape[0])
                # each input byte once: the tables, field, control function
                # and result, the base and scale (f64) or the metrics (f32),
                # the per-row tables
                nbytes = (P * 8 + 3 * P * 2 * s_
                          + (P * 2 * 16 if dtype == "float64"
                             else ctx["G"].numel() * 4)
                          + C_ * (8 * 8 + 3 * s_ + 2 * s_ + 1)
                          + L_ * (t.K * (8 + s_) + 2 * s_) + S_ * 8
                          + Q_ * (8 + 2 * s_))
                b_ms, b_by = bound_ms(nbytes,
                                      WINSLOW_FLOPS_PER_POINT[dtype] * P,
                                      dtype)
                k_ms, k_one = cuda_time_ms(torch, kernel, WINSLOW_RUN)
                r_ms, r_one = cuda_time_ms(torch, plain, WINSLOW_RUN // 10)
                g_us = graph_us(torch, kernel)
                if name == "T106" and dtype == "float64":
                    self.kernels["winslow_apply"].update(
                        max_abs_err=float((got - want).abs().max()),
                        ms=k_ms, plain_ms=r_ms, bound_ms=b_ms,
                        bound_by=b_by)
                parts.append(
                    f"{dtype}{' scaled' if 'scale' in kw else ''}: bit for "
                    f"bit outside the junction rows {rest}, in them {j_bits} "
                    f"(gap {gap:.3e}), {n_calls} launch a call; K-W "
                    f"{k_ms:.5f} ms a call ({WINSLOW_RUN} back to back; "
                    f"one-call window {k_one:.5f} ms), {g_us:.3f} us in a "
                    f"CUDA graph of 200; plain {r_ms:.4f} ms "
                    f"({WINSLOW_RUN // 10} back to back; one-call "
                    f"{r_one:.4f} ms); bound {b_ms:.2e} ms ({b_by}, "
                    f"{nbytes} B)")
            out.append(f"{name} ({B}, {N}, {M}), {P} points, tables "
                       f"{t.nbytes} B: " + "; ".join(parts))
            del sm, ctx
        return "(c) K-W " + " | ".join(out)


    def p13_graph(self):
        bad, lines = [], []
        for part in (self.p13a_replay, self.p13b_jobs, self.p13c_harness):
            t0 = time.perf_counter()
            line = f"{part(bad)} ({time.perf_counter() - t0:.2f} s)"
            print("  " + line, flush=True)
            lines.append(line)
        if bad:
            raise AssertionError("; ".join(bad))
        return "; ".join(lines)

    def p13a_replay(self, bad):
        import numpy as np

        torch = self.torch
        import turbomesh_tpu_torch.smoothing.device as dm
        from turbomesh_tpu_torch import input as input_mod
        from turbomesh_tpu_torch.ops import chain, winslow, zebra
        from turbomesh_tpu_torch.smoothing.classify import classify

        def launches():
            return (zebra.ZEBRA_LAUNCHES, chain.CHAIN_LAUNCHES,
                    winslow.WINSLOW_LAUNCHES)

        out = []
        for name, path in (("T106", T106), ("t106_x2", X2_CONFIG)):
            inp = (input_mod.load(str(path), base_dir=str(path.parent))
                   if path == T106 else
                   input_mod.load(json.loads(path.read_text())))
            mesh = inp.template.run(inp.geometry)
            sm = dm.DeviceSmoother(mesh, classify(mesh), device="cuda")
            gen = torch.Generator(device="cuda").manual_seed(13)
            rng = np.random.default_rng(13)
            n0 = (dm.PRECOND_CAPTURES, dm.PRECOND_REPLAYS)
            same = launches_ok = True
            for solve in range(2):
                coords = mesh.flat_coords() + 1e-4 * np.ptp(
                    mesh.flat_coords()) * rng.standard_normal(
                        (mesh.num_points, 2))
                cf = 0.1 * rng.standard_normal((mesh.num_points, 2))
                X, C = sm._upload(coords, cf)
                base, _ = sm._stage_base(X, C)
                ctx = sm._stage_prepare32(base, C)
                for _ in range(15):
                    v = torch.randn((base.shape[0], 2), generator=gen,
                                    device="cuda")
                    k = launches()
                    got = sm._apply_Minv(ctx, v).clone()
                    k1 = launches()
                    want = sm._stage_Minv(ctx, v)
                    k2 = launches()
                    same &= torch.equal(got.view(torch.int32),
                                        want.view(torch.int32))
                    launches_ok &= all(b - a == c - b
                                       for a, b, c in zip(k, k1, k2))
            caps = dm.PRECOND_CAPTURES - n0[0]
            reps = dm.PRECOND_REPLAYS - n0[1]
            v = torch.randn((base.shape[0], 2), generator=gen, device="cuda")
            e_ms, _ = cuda_time_ms(torch, lambda: sm._stage_Minv(ctx, v),
                                   P13_RUN, reps=5)
            g_ms, _ = cuda_time_ms(torch, lambda: sm._apply_Minv(ctx, v),
                                   P13_RUN, reps=5)
            if not (same and launches_ok and caps == 1 and reps == 29):
                bad.append(f"(a) {name}: replay vs eager bit for bit {same}, "
                           f"launches equal {launches_ok}, {caps} captures, "
                           f"{reps} replays (want 1, 29)")
            out.append(f"{name} ({mesh.num_points} points): 30 applications "
                       f"over 2 solves, replay vs eager bit for bit {same}, "
                       f"launches equal {launches_ok}, {caps} capture, "
                       f"{reps} replays; an application eagerly {e_ms:.4f} "
                       f"ms, replayed {g_ms:.4f} ms ({P13_RUN} in a row "
                       f"between CUDA events, median of 5)")
            del sm, ctx
        return "(a) " + "; ".join(out)

    def p13b_jobs(self, bad):
        import numpy as np

        torch = self.torch
        import turbomesh_tpu_torch.smoothing.device as dm
        from meshbench import generator, manifest
        from turbomesh_tpu_torch import input as input_mod
        from turbomesh_tpu_torch.ops import chain, winslow, zebra
        from turbomesh_tpu_torch.profiling import PhaseTimer
        from turbomesh_tpu_torch.smoothing import smooth_mesh

        graphed = dm.DeviceSmoother._apply_Minv

        def eager(self, ctx, v):
            return self._stage_Minv(ctx, v)

        def run(job, route):
            inp = input_mod.load(job.config)
            mesh = inp.template.run(inp.geometry)
            timer = PhaseTimer()
            n0 = (zebra.ZEBRA_LAUNCHES, chain.CHAIN_LAUNCHES,
                  dm.PRECOND_CAPTURES, dm.PRECOND_REPLAYS,
                  winslow.WINSLOW_LAUNCHES)
            hist = []
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            dm.DeviceSmoother._apply_Minv = (graphed if route == "graph"
                                             else eager)
            t0 = time.perf_counter()
            try:
                smooth_mesh(mesh, job.iterations,
                            wall_control_function=(
                                inp.smoothing.wall_control_function),
                            target_residual=job.config["smoothing"].get(
                                "target_residual"),
                            residual_history=hist, timer=timer,
                            device="cuda", **job.smooth_mesh)
                torch.cuda.synchronize()
            finally:
                dm.DeviceSmoother._apply_Minv = graphed
            wall = time.perf_counter() - t0
            n = len(hist)
            return dict(
                coords=mesh.flat_coords(), wall=wall, iterations=n,
                zebra=zebra.ZEBRA_LAUNCHES - n0[0],
                chain=chain.CHAIN_LAUNCHES - n0[1],
                captures=dm.PRECOND_CAPTURES - n0[2],
                replays=dm.PRECOND_REPLAYS - n0[3],
                winslow=winslow.WINSLOW_LAUNCHES - n0[4],
                peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                reserved_mib=torch.cuda.max_memory_reserved() / 2**20,
                # the graph's pool stays reserved after the smoother has
                # gone, until the next capture or empty_cache
                pool_mib=sum(g["total_size"]
                             for g in torch.cuda.memory_snapshot()
                             if tuple(g["segment_pool_id"]) != (0, 0))
                / 2**20,
                capture_s=timer.totals.get("precond.graph.capture", 0.0),
                spans={k: timer.totals.get(k, 0.0) / n
                       for k in ("picard_loop", "precond", "fgmres.operator",
                                 "fgmres.stop_test", "picard.read")})

        out = []
        for cell, _ in P13_CELLS:
            c = manifest.load_cell(cell)
            job = generator.job(c.traffic, c.config, P13_SEED, 0)
            # the first run also warms the process up: eager, then the
            # graph, then eager again, which is kept
            runs = {}
            for route in ("eager", "graph", "eager"):
                runs[route] = run(job, route)
            g, e = runs["graph"], runs["eager"]
            same = np.array_equal(g["coords"], e["coords"])
            if not (same and (g["zebra"], g["chain"], g["winslow"]) == (
                    e["zebra"], e["chain"], e["winslow"])
                    and g["zebra"] > 0 and g["winslow"] > 0
                    and g["captures"] == 1
                    and e["captures"] == 0):
                bad.append(f"(b) {cell}: coordinates equal {same}, zebra "
                           f"{g['zebra']} / {e['zebra']}, chain "
                           f"{g['chain']} / {e['chain']}, K-W "
                           f"{g['winslow']} / {e['winslow']}, captures "
                           f"{g['captures']} / {e['captures']}")

            def fmt(r):
                return (f"wall {r['wall']:.3f} s, {r['iterations']} "
                        f"iterations, zebra {r['zebra']}, chain "
                        f"{r['chain']}, K-W {r['winslow']}, captures {r['captures']}, replays "
                        f"{r['replays']}, capture {r['capture_s']:.4f} s, "
                        f"peak {r['peak_mib']:.3f} MiB allocated, "
                        f"{r['reserved_mib']:.3f} MiB reserved (graph pool "
                        f"{r['pool_mib']:.3f} MiB), an iteration: "
                        + ", ".join(f"{k} {v:.4f} s"
                                    for k, v in r["spans"].items()))

            out.append(f"{cell} job 0 ({job.restagger_deg:+.4f} deg): "
                       f"coordinates bit for bit {same}; graph: {fmt(g)}; "
                       f"eager: {fmt(e)}")
        return "(b) " + "; ".join(out)

    def p13c_harness(self, bad):
        out = []
        for cell, roofline in P13_CELLS:
            res = subprocess.run(
                [sys.executable, "-m", "meshbench.run", "--workload", cell,
                 "--seed", str(P13_SEED), "--seconds", str(P13_SECONDS),
                 "--trace", "1"], cwd=str(ROOT), capture_output=True,
                text=True, timeout=900)
            try:
                line = json.loads(res.stdout.strip().splitlines()[-1])
            except (IndexError, ValueError):
                bad.append(f"(c) {cell}: rc {res.returncode}, no result "
                           f"line; stderr tail {res.stderr[-2000:]}")
                continue
            m = {k: v["value"] for k, v in line["metrics"].items()}
            ops = [name for name, _ in line["breakdown"]["device_ops"]]
            ka = [o for o in ops if "zebra" in o]
            if not (line["correct"] and ka and m.get(roofline, 0.0) > 0.0
                    and m.get("graph_capture_s", 0.0) > 0.0):
                bad.append(f"(c) {cell}: correct {line['correct']}, K-A in "
                           f"device ops {ka}, {roofline} "
                           f"{m.get(roofline)}, graph_capture_s "
                           f"{m.get('graph_capture_s')}")
            out.append(f"{cell}: correct {line['correct']}, metrics {m}, "
                       f"busy {line['device']['busy_s']:.4f} s of "
                       f"{line['device']['window_s']:.4f} s, device ops "
                       f"{line['breakdown']['device_ops'][:6]}, idle gaps "
                       f"{line['breakdown']['idle_gaps'][:6]}")
        return "(c) " + "; ".join(out)

    def p14_glue(self):
        bad, lines = [], []
        for part in (self.p14a_kernel, self.p14b_application):
            t0 = time.perf_counter()
            line = f"{part(bad)} ({time.perf_counter() - t0:.2f} s)"
            print("  " + line, flush=True)
            lines.append(line)
        if bad:
            raise AssertionError("; ".join(bad))
        return "; ".join(lines)

    def _p14_smoother(self, inp, seed):
        """A DeviceSmoother of ``inp``'s mesh on the card and its f32
        context at a seeded perturbation and control function."""
        import numpy as np

        from turbomesh_tpu_torch.smoothing.classify import classify
        from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

        mesh = inp.template.run(inp.geometry)
        sm = DeviceSmoother(mesh, classify(mesh), device="cuda")
        rng = np.random.default_rng(seed)
        coords = mesh.flat_coords()
        coords = coords + 1e-4 * np.ptp(coords) * rng.standard_normal(
            coords.shape)
        cf = 0.1 * rng.standard_normal((mesh.num_points, 2))
        X, C = sm._upload(coords, cf)
        base, _ = sm._stage_base(X, C)
        return sm, sm._stage_prepare32(base, C)

    def p14a_kernel(self, bad):
        torch = self.torch
        from turbomesh_tpu_torch.ops import glue

        def same(a, b):
            return torch.equal(a.view(torch.int32), b.view(torch.int32))

        out = []
        for name, inp in _p14_meshes():
            sm, ctx = self._p14_smoother(inp, 14)
            gen = torch.Generator(device="cuda").manual_seed(14)
            levels_ok = framing_ok = True
            parts = []
            for lvl, level in enumerate(ctx["mg"]):
                t = level["glue"].tables
                B, N, M = t.shape
                z = torch.randn((B, N, M, 2), generator=gen, device="cuda")
                planes = tuple(torch.randn((B, N + 2, M + 2), generator=gen,
                                           device="cuda") for _ in range(2))
                for v in (z, planes):
                    n0 = glue.GLUE_LAUNCHES
                    got = glue.glue_planes(t, v)
                    n_calls = glue.GLUE_LAUNCHES - n0
                    want = glue.glue_planes_ref(t, v)
                    torch.cuda.synchronize()
                    levels_ok &= (n_calls == 1 and same(got[0], want[0])
                                  and same(got[1], want[1]))
                # the smooth's two other launches of the module, frame and
                # unframe, against their CPU versions; neither counts
                n0 = glue.GLUE_LAUNCHES
                got = glue.frame_planes(z) + (
                    glue.unframe_planes(*planes, t.mask),)
                want = glue.frame_planes(z.cpu()) + (glue.unframe_planes(
                    *(p.cpu() for p in planes), t.mask.cpu()),)
                framing_ok &= (glue.GLUE_LAUNCHES == n0 and all(
                    same(g.cpu(), w) for g, w in zip(got, want)))
                if lvl:
                    continue
                mask = level["interior"]
                g = level["glue"]

                def kernel():
                    return glue.glue_planes(t, planes)

                def plain():
                    return glue.glue_planes_ref(t, planes)

                def replaced():
                    zm = glue.unframe_planes(*planes, mask)
                    zg = g.correction(zm)
                    return zg[..., 0].contiguous(), zg[..., 1].contiguous()

                P = B * (N + 2) * (M + 2)
                E, L, K = t._sizes
                on = int((t.code == glue.ON).sum())
                # each byte the call must move once: the code byte and the
                # two output floats of every framed point, the two input
                # floats of the points on the mask (the only ones value()
                # reads), the entries and their weights
                nbytes = (P * (1 + 2 * 4) + on * 2 * 4 + E * 16
                          + L * (4 * (1 + K) + 4 * K))
                flops = E * GLUE_FLOPS_COPY + L * K * GLUE_FLOPS_MEMBER
                b_ms, b_by = bound_ms(nbytes, flops, "float32")
                k_ms, k_one = cuda_time_ms(torch, kernel, GLUE_RUN)
                g_us = graph_us(torch, kernel)
                r_ms, _ = cuda_time_ms(torch, plain, GLUE_RUN // 10)
                x_ms, _ = cuda_time_ms(torch, replaced, GLUE_RUN // 10)
                x_us = graph_us(torch, replaced)
                if name == "T106":
                    self.kernels["glue_planes"].update(
                        max_abs_err=0.0 if levels_ok else None, ms=k_ms,
                        plain_ms=r_ms, bound_ms=b_ms, bound_by=b_by)
                parts.append(
                    f"level 0 ({B}, {N + 2}, {M + 2}) framed, {E} copies, "
                    f"{L} x {K} junction members: K-G {k_ms:.5f} ms a call "
                    f"({GLUE_RUN} back to back; one-call window "
                    f"{k_one:.5f} ms), {g_us:.3f} us in a CUDA graph of "
                    f"200; plain {r_ms:.4f} ms; the glue it replaced "
                    f"(unframe, correction, split) {x_ms:.4f} ms back to "
                    f"back, {x_us:.3f} us in a graph; bound {b_ms:.2e} ms "
                    f"({b_by}, {nbytes} B, {on} points on the mask)")
            if not levels_ok:
                bad.append(f"(a) {name}: K-G vs plain not bit for bit on "
                           f"every level, or not one launch a call")
            if not framing_ok:
                bad.append(f"(a) {name}: frame_planes / unframe_planes vs "
                           f"their CPU versions not bit for bit on every "
                           f"level, or counted in GLUE_LAUNCHES")
            out.append(f"{name} ({len(ctx['mg'])} levels, tables "
                       f"{sum(lv['glue'].tables.nbytes for lv in ctx['mg'])}"
                       f" B): both forms bit for bit on every level "
                       f"{levels_ok}; frame and unframe bit for bit the CPU "
                       f"on every level {framing_ok}; " + "; ".join(parts))
            del sm, ctx
        return "(a) K-G " + " | ".join(out)

    def p14b_application(self, bad):
        torch = self.torch
        import turbomesh_tpu_torch.smoothing.multigrid as tmg
        from turbomesh_tpu_torch.ops import glue

        loop = glue_loop()
        planes_smooth = tmg._smooth_glued
        out = []
        for name, inp in _p14_meshes():
            sm, ctx = self._p14_smoother(inp, 15)
            P = ctx["baseF32"].shape[0]
            v = torch.randn((P, 2), device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(15))
            row = {}
            for layout, smooth in (("loop", loop), ("K-G", planes_smooth)):
                tmg._smooth_glued = smooth
                try:
                    def app():
                        return sm._stage_Minv(ctx, v)

                    n0 = glue.GLUE_LAUNCHES
                    z = app().clone()
                    launches = glue.GLUE_LAUNCHES - n0
                    kernels, top = profiled_kernels(torch, app)
                    nodes = graph_nodes(torch, app)
                    graph = torch.cuda.CUDAGraph()
                    side = torch.cuda.Stream()
                    side.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(side):
                        app()
                    torch.cuda.current_stream().wait_stream(side)
                    with torch.cuda.graph(graph):
                        app()
                    r_ms, _ = cuda_time_ms(torch, graph.replay, P14_RUN,
                                           reps=5)
                    del graph
                finally:
                    tmg._smooth_glued = planes_smooth
                row[layout] = dict(z=z, launches=launches, kernels=kernels,
                                   top=top, nodes=nodes, replay_ms=r_ms)
            a, b = row["loop"], row["K-G"]
            same = torch.equal(a["z"].view(torch.int32),
                               b["z"].view(torch.int32))
            if not (same and a["launches"] == 0 and b["launches"] > 0):
                bad.append(f"(b) {name}: K-G vs loop bit for bit {same}, "
                           f"glue launches {a['launches']} / "
                           f"{b['launches']}")
            out.append(
                f"{name}: an application bit for bit {same}; "
                + "; ".join(f"{k}: {r['kernels']} device ops (profiler), "
                            f"{r['nodes']} graph nodes, {r['launches']} "
                            f"K-G launches, replayed {r['replay_ms']:.4f} ms "
                            f"({P14_RUN} in a row), most frequent "
                            f"{r['top'][:6]}" for k, r in row.items()))
            del sm, ctx
        return "(b) " + " | ".join(out)


def glue_loop():
    """The V-cycle's smooth before K-G (the per-half-sweep loop), from the
    test file that keeps it as the reference."""
    path = ROOT / "tests" / "test_torch_glue_planes.py"
    spec = importlib.util.spec_from_file_location("glue_planes_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.smooth_glued_loop


def graph_nodes(torch, fn):
    """The nodes of a CUDA graph captured over fn() (cuGraphGetNodes on
    ``CUDAGraph.raw_cuda_graph``), or None where this torch does not keep
    the captured graph."""
    import ctypes

    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    count = ctypes.c_size_t(0)
    try:
        raw = graph.raw_cuda_graph()
        err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
            ctypes.c_void_p(raw), None, ctypes.byref(count))
    except (AttributeError, OSError, RuntimeError):
        return None
    finally:
        del graph
    return None if err else count.value


def profiled_kernels(torch, fn):
    """The device operations (kernels, copies, sets) fn() runs on the
    card, by torch.profiler: (count, the ten most frequent names with
    their counts)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = Counter(e.name[:48] for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return sum(names.values()), names.most_common(10)


def _p14_meshes():
    """(name, input) of the three meshes that the benchmark's cells
    smooth."""
    from turbomesh_tpu_torch import input as input_mod

    yield "T106", input_mod.load(str(T106), base_dir=str(T106.parent))
    yield "LS89", input_mod.load(str(LS89), base_dir=str(LS89.parent))
    yield "t106_x2", input_mod.load(json.loads(X2_CONFIG.read_text()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="0,1,2,3,4,5,6,8,9,10,11,12,13,14",
                    help="comma-separated phases to run (default: 0-6, "
                    "8-14)")
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
    if not all(p.exists() for p in (PKG / "__init__.py", T106, LS89)):
        print(f"error: {PKG.name} or the examples not found beside "
              f"{pathlib.Path(__file__).name}; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    logging.basicConfig(level=logging.WARNING)

    smoke = Smoke(torch)
    steps = [(0, "0 environment", smoke.p0_env),
             (1, "1 build + probe", smoke.p1_build),
             (2, "2 zebra kernel vs plain", smoke.p2_kernel),
             (3, "3 SOR kernel vs plain", smoke.p3_sor),
             (4, "4 main path (T106, White, cli)", smoke.p4_main_path),
             (5, "5 oracle (T106, Laplace)", smoke.p5_oracle),
             (6, "6 scale 4 run to 1e-10", smoke.p6_scale4),
             (8, "8 sharded path (nccl world 1; gloo world 4 on one card)",
              smoke.p8_sharded),
             (9, "9 3-D stacked cuts (demo_3d_sharded, world 2)",
              smoke.p9_stacked_cuts),
             (10, "10 the last modules (deflation, sharded deflation, "
              "torch_trace, service, bulk TFI)", smoke.p10_last_modules),
             (11, "11 preconditioner options (mg_opts)", smoke.p11_mg_opts),
             (12, "12 chain kernel K-I (interface solve)", smoke.p12_chain),
             (13, "13 the preconditioner's CUDA graph", smoke.p13_graph),
             (14, "14 the V-cycle's glue kernel K-G", smoke.p14_glue)]
    for k, name, fn in steps:
        if k in phases:
            smoke.phase(name, fn)
    if smoke.failed:
        print(f"FAILED phases: {smoke.failed}", file=sys.stderr)
        return 1
    print(nvidia_smi())
    print(json.dumps({"kernels": list(smoke.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
