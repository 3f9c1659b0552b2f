"""Command-line interface: ``turbomesh-torch <config.json>``.

The options of ``turbomesh`` (reference parity: src/gui/cmd.zig +
src/gui/main.zig; exit codes 64 usage error, 66 cannot open input) plus
``--device``: the torch device of the ``device`` solver. The default is
``cuda``, and it raises when no CUDA device is present. ``--trace DIR``
writes a Chrome trace of the smoothing (``DIR/trace.json``, with the
program's ``turbomesh.*`` ranges) and prints the tree of its spans.

Under ``torchrun --nproc-per-node N`` with ``--solver sharded`` (or
``device``, which then shards) every rank builds the mesh and smooths its
slice of the blocks on ``cuda:{local_rank}``; rank 0 alone prints, logs
and writes the output.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="turbomesh-torch",
        description="block-structured mesh generation (PyTorch/CUDA)",
    )
    p.add_argument("config", help="JSON run configuration (reference schema)")
    p.add_argument("--output", help="override output path (.cgns/.vtk/.npz)")
    p.add_argument("--iterations", type=int, default=None,
                   help="override smoothing iterations")
    p.add_argument("--base-dir", default=None,
                   help="directory CSV profile paths resolve against "
                        "(default: config file's directory)")
    p.add_argument("--plot", action="store_true",
                   help="render the mesh wireframe to mesh.png")
    p.add_argument("--gui", action="store_true",
                   help="open the interactive viewer window after the run")
    p.add_argument("--solver", default=None,
                   help="override solver backend (direct | device | "
                        "sharded)")
    p.add_argument("--target-residual", type=float, default=None,
                   help="stop smoothing once the residual drops below this")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file for save/resume of smoothing state")
    p.add_argument("--resume", action="store_true",
                   help="resume smoothing from --checkpoint")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of the device solver (default cuda)")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="write a Chrome trace of the smoothing to "
                        "DIR/trace.json and print the spans' tree")
    p.add_argument("--version", action="version",
                   version="turbomesh-tpu-torch 0.1.0")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu)")
    # under torchrun every rank runs this; rank 0 alone speaks and writes
    lead = int(os.environ.get("RANK", 0)) == 0
    say = print if lead else (lambda *a, **k: None)
    if not lead:
        logging.disable(logging.CRITICAL)
    # a process group the sharded solver starts here ends here
    own_group = not dist.is_initialized()

    if not os.path.exists(args.config):
        print(f"error: cannot open config file {args.config!r}", file=sys.stderr)
        return 66

    from . import input as input_mod
    from .check import check_connections
    from .profiling import PhaseTimer, torch_trace

    timer = PhaseTimer()
    base_dir = args.base_dir or os.path.dirname(os.path.abspath(args.config))
    try:
        with timer.active():
            inp = input_mod.load(args.config, base_dir=base_dir)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 66
    except (KeyError, ValueError) as e:
        print(f"error: invalid config: {e}", file=sys.stderr)
        return 64

    t0 = time.perf_counter()
    with timer.active():
        mesh = inp.template.run(inp.geometry)
    say(f"blocking: {len(mesh.blocks)} blocks, {mesh.num_points} points "
          f"({time.perf_counter() - t0:.2f} s)")
    check_connections(mesh)

    iterations = (args.iterations if args.iterations is not None
                  else inp.smoothing.iterations)
    if iterations > 0:
        from .smoothing import smooth_mesh

        t0 = time.perf_counter()
        with torch_trace(args.trace if lead else None):
            smooth_mesh(
                mesh,
                iterations=iterations,
                solver=args.solver or inp.smoothing.solver,
                wall_control_function=inp.smoothing.wall_control_function,
                target_residual=args.target_residual,
                checkpoint_path=args.checkpoint,
                resume=args.resume,
                timer=timer,
                device=args.device,
            )
        say(f"elapsed time for smoothing: {time.perf_counter() - t0:.2f} s")
        if args.trace:
            say(timer.report(nodes=mesh.num_points))
            say(f"wrote {os.path.join(args.trace, 'trace.json')}")

    if own_group and dist.is_initialized():
        dist.destroy_process_group()
    if not lead:
        return 0
    output = args.output or inp.output
    if output:
        mesh.write(output)
        print(f"wrote {output}")

    if args.plot:
        _plot(mesh)
    if args.gui or inp.gui:
        from .gui import view_mesh

        view_mesh(mesh, title=os.path.basename(args.config))
    return 0


def _plot(mesh) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 8))
    for blk in mesh.blocks:
        pts = blk.points
        ax.plot(pts[:, :, 0], pts[:, :, 1], "b-", lw=0.2)
        ax.plot(pts[:, :, 0].T, pts[:, :, 1].T, "b-", lw=0.2)
    ax.set_aspect("equal")
    fig.savefig("mesh.png", dpi=150)
    print("wrote mesh.png")


if __name__ == "__main__":
    sys.exit(main())
