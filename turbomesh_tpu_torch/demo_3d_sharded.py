"""3-D T106 from stacked 2-D cuts, each cut's blocks sharded across ranks.

The reference lists "3D: multiple stacked 2D cuts" as planned but not
implemented (README.md:19-21). This runs the whole pipeline with the
port:

  1. per-span 2-D sections: the T106 example config with a per-cut
     geometry scale (radially shrinking blade sections; the pitch scales
     with the profile) -> O4H blocking per cut;
  2. per-cut elliptic smoothing with the cut's 8 blocks sharded across the
     ranks (ShardedSmoother.run, White wall control function). The MIDDLE
     cut is driven to the 1e-10 displacement residual with its control
     function initialised by White's law and then frozen (a 1e-10 fixed
     point is a property of a frozen control function; under live White
     feedback the residual floors at the moving fixed point); the side
     cuts keep the live feedback for ``picard`` iterations;
  3. stacking the smoothed cuts into a 3-D mesh (extrude.from_cuts);
  4. structured-CGNS 3-D output read back bit for bit, where h5py is
     installed; without it the stacked Mesh3d is checked in memory.

    python -m turbomesh_tpu_torch.demo_3d_sharded [n_cuts] [picard] \\
        [OUT.json] [mesh_scale] [--world N] [--backend gloo|nccl] \\
        [--device cuda|cpu]
    torchrun --nproc-per-node N -m turbomesh_tpu_torch.demo_3d_sharded ...

Without torchrun it spawns a world of ``--world`` ranks on this machine
(default 1). mesh_scale multiplies every O4H cell count of the example
config (about 25k * mesh_scale^2 points a cut). The record goes to
OUT.json when it is given, and nowhere else; the CGNS file lives in a
temporary directory for the read-back only.

Counterpart of tools/demo_3d_sharded.py.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import importlib.util
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

T106 = pathlib.Path(__file__).resolve().parents[1] / "examples" / "T106" / \
    "T106.json"
TARGET = 1e-10
MID_CAP = 60


def cut_meshes(n_cuts: int, mesh_scale: int = 1):
    """(meshes, spans, scales): the T106 O4H mesh of every cut."""
    from . import input as input_mod

    cfg = json.loads(T106.read_text())
    if mesh_scale != 1:
        nc = cfg["template"]["O4H"]["num_cells"]
        for key in nc:
            nc[key] = nc[key] * mesh_scale
    spans = np.linspace(0.0, 0.05, n_cuts)
    scales = np.linspace(1.0, 0.88, n_cuts)  # radial section shrink
    meshes = []
    for k in range(n_cuts):
        ck = copy.deepcopy(cfg)
        ck["geometry"]["scale"] = float(scales[k])
        inp = input_mod.load(ck, base_dir=str(T106.parent))
        meshes.append(inp.template.run(inp.geometry))
    return meshes, spans, scales


def smooth_cuts(n_cuts: int, picard: int, mesh_scale: int, device):
    """What every rank runs (the spawn target): smooth each cut with a
    ShardedSmoother over the process group. Returns (smoothed meshes,
    per-cut records)."""
    import torch

    from .ops import zebra
    from .parallel import ShardedSmoother
    from .parallel import dist as pdist
    from .smoothing.classify import classify
    from .smoothing.control_function import White

    meshes, spans, scales = cut_meshes(n_cuts, mesh_scale)
    mid = n_cuts // 2
    cuts = []
    for k, mesh in enumerate(meshes):
        white = White(ds_target=1e-6 * scales[k])
        t0 = time.perf_counter()
        sm = ShardedSmoother(mesh, classify(mesh), device=device,
                             rtol=1e-6, atol=1e-8)
        setup_s = time.perf_counter() - t0
        converge = k == mid
        restarts = []
        zebra.ZEBRA_LAUNCHES = 0
        t0 = time.perf_counter()
        coords, _cf, disp, n_done = sm.run(
            mesh.flat_coords(), white.init(mesh),
            MID_CAP if converge else picard,
            algorithm=None if converge else white,
            target_residual=TARGET if converge else None,
            restart_history=restarts)
        if sm.device.type == "cuda":
            torch.cuda.synchronize(sm.device)
        run_s = time.perf_counter() - t0
        launches = torch.tensor([zebra.ZEBRA_LAUNCHES], device=sm.device)
        launches = pdist.all_gather_stack(launches).tolist()
        mesh.set_flat_coords(coords)
        cuts.append({
            "cut": k, "span": float(spans[k]), "scale": float(scales[k]),
            "nodes": mesh.num_points, "setup_s": setup_s, "run_s": run_s,
            "picard_done": n_done, "fgmres_restarts_per_iter": restarts,
            "displacement_residual": float(disp),
            "driven_to_target": converge,
            "target_residual": TARGET if converge else None,
            "reached_target": bool(disp < TARGET) if converge else None,
            "zebra_launches_per_rank": launches,
        })
    return meshes, cuts


def stack_and_check(meshes, spans):
    """from_cuts, then the CGNS-3D round trip where h5py is installed,
    else an in-memory check of the stacked planes. Returns the record."""
    from .extrude import from_cuts

    m3 = from_cuts(meshes, spans)
    rec = {"blocks": len(m3.blocks), "nodes_3d": m3.num_points,
           "nodes_per_cut": meshes[0].num_points}
    planes_ok = all(
        np.array_equal(b.points[k, ..., :2], m.blocks[i].points)
        and np.all(b.points[k, ..., 2] == spans[k])
        for i, b in enumerate(m3.blocks) for k, m in enumerate(meshes))
    rec["planes_match_cuts"] = bool(planes_ok)
    if importlib.util.find_spec("h5py") is None:
        rec["cgns"] = "h5py absent: Mesh3d checked in memory"
        rec["ok"] = bool(planes_ok)
        return m3, rec
    from .io.cgns3d import read_cgns3d

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t106_3d.cgns")
        m3.write(path)
        names, blocks = read_cgns3d(path)  # zone order: alphabetical
        got = dict(zip(names, blocks))
        back = (sorted(names) == sorted(m3.names)
                and all(np.array_equal(got[nm], b.points)
                        for nm, b in zip(m3.names, m3.blocks)))
        rec["cgns_sha256"] = hashlib.sha256(
            pathlib.Path(path).read_bytes()).hexdigest()
    rec["readback_bit_identical"] = bool(back)
    rec["ok"] = bool(planes_ok and back)
    return m3, rec


def run_demo(n_cuts=5, picard=3, mesh_scale=1, world=1, backend=None,
             device="cuda"):
    """Spawn a world of ``world`` ranks on this machine, smooth the cuts,
    stack them and check the 3-D mesh. Returns the run record (the
    meshes of rank 0; every rank holds the same)."""
    from .parallel import dist as pdist

    backend = backend or pdist.backend_for(device, world)
    t0 = time.perf_counter()
    results = pdist.spawn(smooth_cuts, world, backend, device,
                          args=(n_cuts, picard, mesh_scale, device))
    wall = time.perf_counter() - t0
    meshes, cuts = results[0]
    for other, _ in results[1:]:
        if not all(np.array_equal(a.flat_coords(), b.flat_coords())
                   for a, b in zip(meshes, other)):
            raise RuntimeError("the ranks returned different cuts")
    spans = np.array([c["span"] for c in cuts])
    _m3, mesh3d = stack_and_check(meshes, spans)
    return _record(cuts, mesh3d, world, backend, device, n_cuts, picard,
                   mesh_scale, wall)


def _record(cuts, mesh3d, world, backend, device, n_cuts, picard,
            mesh_scale, wall):
    import torch

    kind = (torch.cuda.get_device_name(0)
            if str(device).startswith("cuda") else "cpu")
    return {
        "what": "3-D T106 from stacked 2-D cuts, each cut's blocks "
                "sharded across ranks (reference roadmap README.md:19-21)",
        "world": world, "backend": backend, "device": kind,
        "n_cuts": n_cuts, "picard_iters_per_cut": picard,
        "mesh_scale": mesh_scale, "wall_s": wall,
        "shared_card_caveat": (
            "ranks that share one card, or the CPU, are time-sliced: "
            "walls are a correctness run, not a scaling figure"),
        "cuts": cuts, "mesh3d": mesh3d,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m turbomesh_tpu_torch.demo_3d_sharded",
        description=__doc__.splitlines()[0])
    ap.add_argument("n_cuts", nargs="?", type=int, default=5)
    ap.add_argument("picard", nargs="?", type=int, default=3)
    ap.add_argument("out", nargs="?", default=None,
                    help="JSON record to write (nothing is written without)")
    ap.add_argument("mesh_scale", nargs="?", type=int, default=1)
    ap.add_argument("--world", type=int, default=1,
                    help="ranks to spawn when not under torchrun")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl when each rank has a card, else gloo")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from .parallel import dist as pdist

    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        pdist.ensure_group(args.device)
        t0 = time.perf_counter()
        meshes, cuts = smooth_cuts(args.n_cuts, args.picard, args.mesh_scale,
                                   args.device)
        wall = time.perf_counter() - t0
        world, backend = dist.get_world_size(), dist.get_backend()
        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank != 0:
            return 0
        _m3, mesh3d = stack_and_check(meshes, np.array(
            [c["span"] for c in cuts]))
        record = _record(cuts, mesh3d, world, backend, args.device,
                         args.n_cuts, args.picard, args.mesh_scale, wall)
    else:
        record = run_demo(args.n_cuts, args.picard, args.mesh_scale,
                          args.world, args.backend, args.device)
    for cut in record["cuts"]:
        print(json.dumps(cut), flush=True)
    print(json.dumps(record["mesh3d"]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {args.out}", flush=True)
    mid = record["cuts"][args.n_cuts // 2]
    return 0 if record["mesh3d"]["ok"] and mid["reached_target"] else 1


if __name__ == "__main__":
    sys.exit(main())
