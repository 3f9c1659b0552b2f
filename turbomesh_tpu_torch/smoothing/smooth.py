"""Outer smoothing loop (Picard iteration over the nonlinear Winslow system).

Reference parity: smooth.zig:74-166 (mesh()): per iteration — update the
control function (n > 0), freeze stencil coefficients at the current
coordinates, solve the linearized system for new coordinates (x-system then
y-system), log the displacement-norm residual, copy the solution back.

Solver selection mirrors the reference's user-facing options
(solver.zig:10-38): "gmres" and "bicgstab" select the host Krylov
implementations (with the "preconditioner" sub-option: diagonal | ilu0),
"umfpack"/"petsc"/"direct" the sparse direct factorization,
"device" the matrix-free torch path on ``device``, and "sharded" that
path with the blocks cut across the ranks of a ``torch.distributed``
group (parallel.ShardedSmoother). All converge the same linear systems to
tight tolerance, so Picard fixed points agree to solver tolerance.
"""

from __future__ import annotations

import dataclasses
import logging
import time

from ..check import check_connections
from .classify import classify
from .control_function import from_config as cf_from_config
from .system import SparseSystem

log = logging.getLogger("turbomesh.smoothing")


@dataclasses.dataclass
class SmoothOptions:
    iterations: int = 10
    solver: str | dict = "direct"
    wall_control_function: object = "laplace"


def _solver_name(option) -> tuple[str, str]:
    """Map reference JSON solver options onto (backend, preconditioner).

    JSON shape (input.zig:29 / solver.zig:18-27): a string tag or a
    single-key object, e.g. {"gmres": {"preconditioner": "ilu0"}}.
    """
    precond = "ilu0"
    if isinstance(option, dict):
        (tag, params), = option.items()
        option = tag
        if isinstance(params, dict):
            precond = params.get("preconditioner", precond)
    if option in ("direct", "umfpack", "petsc"):
        return "direct", precond
    if option in ("gmres", "bicgstab"):
        return option, precond
    if option in ("device", "jacobi_cg", "sor"):
        return "device", precond
    if option == "sharded":
        return "sharded", precond
    raise ValueError(f"unknown solver option {option!r}")


def _auto_shard(backend: str) -> str:
    """A "device" request runs block-sharded (parallel.ShardedSmoother)
    when the process group, or torchrun's world before the group exists,
    has more than one rank; TURBOMESH_SHARDED=0 opts out, =1 forces the
    sharded path whatever the world size."""
    import os

    from ..parallel import dist as pdist

    gate = os.environ.get("TURBOMESH_SHARDED", "auto")
    if backend != "device" or gate == "0":
        return backend
    if gate == "1" or pdist.world_size() > 1:
        return "sharded"
    return backend


def smooth_mesh(mesh, iterations: int, solver="direct",
                wall_control_function="laplace",
                residual_history: list | None = None,
                checkpoint_path: str | None = None,
                checkpoint_every: int = 10,
                resume: bool = False,
                target_residual: float | None = None,
                timer=None, device="cuda") -> None:
    """Smooth `mesh` in place for `iterations` Picard steps.

    checkpoint_path/checkpoint_every: periodically save restartable state
    (coordinates + control function + iteration counter); `resume=True`
    restores from checkpoint_path and continues from the saved iteration.
    target_residual: stop early once the displacement-norm residual drops
    below this value (run-to-convergence mode; `iterations` is the cap).
    timer: the ``profiling.PhaseTimer`` that records the phases and the
    spans inside them (a new one when None); its tree is logged at the end.
    device: torch device of the "device" and "sharded" backends (ignored
    by the host backends); under "sharded", "cuda" is rank r's card
    ``cuda:{local_rank % device_count}`` and a missing process group is
    initialised (torchrun's environment, else a world of 1). Every rank
    of the group calls this on the same mesh; only rank 0 writes the
    checkpoint.
    """
    from ..profiling import PhaseTimer

    t0 = time.perf_counter()
    timer = timer or PhaseTimer()
    with timer.phase("connection_check"):
        check_connections(mesh)

    with timer.phase("classify"):
        info = classify(mesh)
    algorithm = cf_from_config(wall_control_function)
    backend, precond = _solver_name(solver)

    backend = _auto_shard(backend)
    writer = True
    with timer.phase("solver_setup"):
        if backend == "sharded":
            from ..parallel import ShardedSmoother

            smoother = ShardedSmoother(mesh, info, rtol=1e-4, atol=1e-11,
                                       device=device)
            writer = smoother.rank == 0
        elif backend == "device":
            from .device import DeviceSmoother

            # inexact Picard: 1e-4 relative reduction per linearized solve
            # plus an absolute equilibrated floor ~displacement units that
            # pins the fixed point at the 1e-10-class acceptance bar
            smoother = DeviceSmoother(mesh, info, rtol=1e-4, atol=1e-11,
                                      device=device)
        else:
            smoother = SparseSystem(mesh, info, method=backend,
                                    preconditioner=precond)

    cf = algorithm.init(mesh)
    start_iteration = 0
    if resume and checkpoint_path is not None:
        from ..checkpoint import load_checkpoint

        start_iteration, cf_saved = load_checkpoint(checkpoint_path, mesh)
        if cf_saved is not None:
            cf = cf_saved
        log.info("resumed from %s at iteration %d", checkpoint_path, start_iteration)

    coords = mesh.flat_coords()

    if backend in ("device", "sharded"):
        # device-resident Picard loop: the field stays on the device
        # (sharded: cut across the ranks) across iterations (the White
        # update runs there too); only the per-iteration stats vector
        # comes back. The reference's outer loop (smooth.zig:104-153)
        # with device data residency.
        def checkpoint_cb(c, f, n_done):
            from ..checkpoint import save_checkpoint

            mesh.set_flat_coords(c)
            if writer:
                with timer.phase("checkpoint"):
                    save_checkpoint(checkpoint_path, mesh, n_done, f)

        with timer.phase("picard_loop"):
            coords, cf, disp, n_done = smoother.run(
                coords, cf, iterations, algorithm=algorithm,
                start_iteration=start_iteration,
                target_residual=target_residual,
                residual_history=residual_history,
                checkpoint_cb=(checkpoint_cb if checkpoint_path is not None
                               else None),
                checkpoint_every=checkpoint_every)
        mesh.set_flat_coords(coords)
        if writer and checkpoint_path is not None \
                and target_residual is not None and disp < target_residual:
            from ..checkpoint import save_checkpoint

            save_checkpoint(checkpoint_path, mesh, n_done, cf)
        timer.log_report(nodes=mesh.num_points)
        log.info("elapsed time for smoothing: %.2f s",
                 time.perf_counter() - t0)
        return

    for n in range(start_iteration, iterations):
        log.info("iteration: %d", n)
        if n > 0:
            with timer.phase("control_function_update"):
                algorithm.update(cf, mesh)
        with timer.phase("linear_solve"):
            new = smoother.solve(coords, cf)

        dx = coords[:, 0] - new[:, 0]
        dy = coords[:, 1] - new[:, 1]
        norm = (dx @ dx + dy @ dy) ** 2  # reference residual (smooth.zig:136)
        log.info("\tresidual: %.6e", norm)
        if residual_history is not None:
            residual_history.append(norm)

        coords = new
        mesh.set_flat_coords(coords)

        if target_residual is not None and norm < target_residual:
            log.info("converged: residual %.3e < target %.3e at iteration %d",
                     norm, target_residual, n)
            if checkpoint_path is not None:
                from ..checkpoint import save_checkpoint

                save_checkpoint(checkpoint_path, mesh, n + 1, cf)
            break

        if checkpoint_path is not None and (n + 1) % checkpoint_every == 0:
            from ..checkpoint import save_checkpoint

            with timer.phase("checkpoint"):
                save_checkpoint(checkpoint_path, mesh, n + 1, cf)

    timer.log_report(nodes=mesh.num_points)
    log.info("elapsed time for smoothing: %.2f s", time.perf_counter() - t0)
