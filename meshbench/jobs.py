"""One job on the users' path, and what the harness records of it.

The entry the window drives is the one ``turbomesh-torch <config>
--solver device`` drives: ``input.load`` -> ``template.run`` ->
``smooth_mesh(mesh, iterations, solver="device", ...)``, ending with the
coordinates back in host memory. The harness passes ``smooth_mesh`` a
``PhaseTimer`` and, as ``residual_history``, an ``IterationHook``: a list
whose ``append`` (one call at the end of each Picard iteration, after the
iteration's host read) also notes the time and, for the check, copies the
coordinates the iteration produced to the host. The hook can also stop
the job at that iteration's end (``Stop``), as the traced stretch does.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
import time

import numpy as np


class NonConvergedCounter(logging.Handler):
    """Counts the linear solves that log "did not converge" on the
    ``turbomesh.krylov`` logger while attached."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def emit(self, record):
        if "did not converge" in record.getMessage():
            self.count += 1


class Stop(BaseException):
    """Raised by an ``IterationHook`` to end its job at an iteration's end
    (a BaseException, so that no handler of the program takes it)."""


class IterationHook(list):
    """``residual_history`` stand-in (module docstring). ``capture``: copy
    each iteration's coordinates to the host. ``smooth_mesh`` hands no
    state out between iterations, so the padded coordinate stack is read
    as the local ``X`` of the calling frame, the port's device Picard loop
    (``DeviceSmoother.run``), and copied in one device-to-host transfer
    after the iteration's own host read; ``unpad`` takes it apart with the
    benchmark's own copy of the layout, and ``JobRecord.steps`` holds the
    last copy to the mesh the job handed back. ``on_step``: called after
    each iteration with the hook; a true return ends the job there."""

    def __init__(self, capture: bool, on_step=None):
        super().__init__()
        self.capture = capture
        self.on_step = on_step
        self.ends: list[float] = []
        self.states: list[np.ndarray] = []

    def append(self, value):
        self.ends.append(time.perf_counter())
        super().append(value)
        if self.capture:
            X = sys._getframe(1).f_locals.get("X")
            if getattr(X, "ndim", None) != 4:
                raise RuntimeError(
                    "the benchmark reads each Picard iteration's coordinates "
                    "as the padded stack X (blocks, N, M, 2) of the frame "
                    "that appends to residual_history (DeviceSmoother.run) "
                    f"and found {type(X).__name__}: the loop's locals changed")
            self.states.append(X.detach().to("cpu", copy=True).numpy())
        if self.on_step is not None and self.on_step(self):
            raise Stop


def unpad(X: np.ndarray, block_sizes) -> np.ndarray:
    """The device Picard loop's padded stack (blocks, N, M, 2) -> the flat
    (points, 2) coordinates in the mesh's order: block by block, row-major
    in (i, j), a block with nj > ni stored transposed (the port's storage
    layout, copied here so that the program's own converter is not used).
    Raises ValueError where the stack does not fit the blocks."""
    if X.ndim != 4 or X.shape[0] != len(block_sizes) or X.shape[3] != 2:
        raise ValueError(f"a padded stack of shape {X.shape} does not fit "
                         f"{len(block_sizes)} blocks")
    out = []
    for b, (ni, nj) in enumerate(block_sizes):
        blk = X[b, :nj, :ni].transpose(1, 0, 2) if nj > ni else X[b, :ni, :nj]
        if blk.shape[:2] != (ni, nj):
            raise ValueError(f"block {b} ({ni} x {nj}) does not fit the "
                             f"padded stack of shape {X.shape}")
        out.append(blk.reshape(-1, 2))
    return np.concatenate(out)


@dataclasses.dataclass
class JobRecord:
    index: int
    restagger_deg: float
    iterations: int
    start: float
    end: float = float("nan")
    frontend_end: float = float("nan")
    iteration_ends: list = dataclasses.field(default_factory=list)
    phases: dict = dataclasses.field(default_factory=dict)
    zebra_launches: int = 0
    nonconverged: int = 0
    block_sizes: list = dataclasses.field(default_factory=list)
    x0: np.ndarray | None = None
    final: np.ndarray | None = None
    states: list = dataclasses.field(default_factory=list)
    error: str | None = None

    @property
    def done(self) -> bool:
        return self.error is None and self.final is not None

    def steps(self) -> list[np.ndarray]:
        """The captured coordinates after each iteration, unpadded. Raises
        ValueError unless the last is the mesh the job handed back."""
        out = [unpad(X, self.block_sizes) for X in self.states]
        if not out or not np.array_equal(out[-1], self.final):
            raise ValueError(
                "the coordinates captured after the last Picard iteration "
                "are not the mesh the job handed back: the benchmark's copy "
                "of the device loop's padded layout (jobs.unpad) no longer "
                "matches the program")
        return out

    def share_before(self, t: float) -> float:
        """The share of this job done by time ``t``: 1 when it ended by
        then, else the share of its Picard iterations that had."""
        if not self.done:
            return 0.0
        if self.end <= t:
            return 1.0
        return sum(1 for e in self.iteration_ends if e <= t) / self.iterations


def run_job(job, device: str, counter: NonConvergedCounter,
            capture: bool = True, on_step=None) -> JobRecord:
    """Run ``job`` (generator.Job) on the users' path; never raises: an
    exception is recorded in ``error``; a job that ``on_step`` stops has
    no ``final``."""
    from turbomesh_tpu_torch import input as input_mod
    from turbomesh_tpu_torch.ops import zebra
    from turbomesh_tpu_torch.profiling import PhaseTimer
    from turbomesh_tpu_torch.smoothing import smooth_mesh

    rec = JobRecord(job.index, job.restagger_deg, job.iterations,
                    start=time.perf_counter())
    z0, n0 = zebra.ZEBRA_LAUNCHES, counter.count
    hook = IterationHook(capture, on_step)
    timer = PhaseTimer()
    try:
        inp = input_mod.load(job.config)
        mesh = inp.template.run(inp.geometry)
        rec.frontend_end = time.perf_counter()
        rec.x0 = mesh.flat_coords()
        rec.block_sizes = [b.size for b in mesh.blocks]
        smooth_mesh(mesh, job.iterations,
                    wall_control_function=inp.smoothing.wall_control_function,
                    target_residual=job.config["smoothing"].get(
                        "target_residual"),
                    residual_history=hook, timer=timer, device=device,
                    **job.smooth_mesh)
        rec.final = mesh.flat_coords()
        rec.end = time.perf_counter()
    except Stop:
        rec.end = time.perf_counter()
    except Exception as e:  # noqa: BLE001 — a failed job is a result
        rec.error = f"{type(e).__name__}: {e}"
        import traceback

        traceback.print_exc()
    rec.iteration_ends = hook.ends
    rec.states = hook.states
    rec.phases = dict(timer.totals)
    rec.zebra_launches = zebra.ZEBRA_LAUNCHES - z0
    rec.nonconverged = counter.count - n0
    return rec
