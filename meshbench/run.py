"""Run one cell of the benchmark once and print its result line.

    python -m meshbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cell's CUDA cards;
without them it exits 2 and prints no result. The run:

1. set-up (``setup_s``): imports, the port's kernel build or its cache in
   the checkout's ``build/``, and a warm-up job (the traffic's shapes,
   two Picard iterations, the second with the control function's
   update);
2. the window: ``--seconds`` of the traffic's jobs back to back (a closed
   loop of one client), closed at the first Picard iteration's end after
   that: the job in flight counts the share of its iterations done by
   then, and runs on to its end untimed;
3. with ``--trace 1``, one more job with ``torch.profiler`` over a few
   steady iterations (the cell's ``profile``), stopped after them;
4. the check: the reference judges every job of the window, the one in
   flight at the close included, after the peak memory is read; each
   compared number is printed with its limit;
5. the last line of stdout: ``correct``, ``attempted``, ``failed``,
   ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
   per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
   ``checks`` last.

It exits 3 with no result if JAX, jaxlib, flax or the JAX package
``turbomesh_tpu`` is loaded in the process once the window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import subprocess
import sys
import time

T_START = time.perf_counter()

from . import generator, manifest  # noqa: E402
from .jobs import JobRecord, NonConvergedCounter, run_job  # noqa: E402

#: top-level module names that may not be loaded (compared whole: the
#: port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "turbomesh_tpu")


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers read it."""

    cell: manifest.Cell
    seed: int
    seconds: float            # the window's length, to its close
    window: tuple[float, float]
    jobs: list[JobRecord]
    setup_s: float
    peak_bytes: int
    device_kind: str
    trace: object = None      # trace.TraceSummary with --trace 1

    @property
    def meshes(self) -> float:
        """Meshes completed in the window, the one in flight at the close
        by its share of Picard iterations."""
        return sum(j.share_before(self.window[1]) for j in self.jobs)

    def finished(self) -> list[JobRecord]:
        """The window's jobs that handed back a mesh (the one in flight at
        the close included)."""
        return [j for j in self.jobs if j.done]


def forbidden_modules() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_line() -> str:
    """nvidia-smi's name and power limit of the cards."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return res.stdout.strip().replace("\n", "; ") or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def _say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def measure(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
            device: str) -> tuple[Run, dict]:
    """Set-up, window and (with ``trace``) the profiled stretch of one run.
    Returns the run and the jobs' configurations by index.

    The window closes at the end of the first Picard iteration that ends
    ``seconds`` or more after it opened (or at the end of a job that ended
    past that time), so that it holds whole iterations; the job in flight
    counts by the share of its iterations done by then, and runs on to
    its end untimed, so that the check sees its whole answer."""
    import torch

    from turbomesh_tpu_torch.ops import zebra

    cuda = device.startswith("cuda")
    os.environ.update(cell.traffic.get("environment", {}))
    counter = NonConvergedCounter()
    logging.getLogger("turbomesh.krylov").addHandler(counter)

    t0 = time.perf_counter()
    if cuda:
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    if cuda:
        zebra.load_library()
    t2 = time.perf_counter()
    warm = run_job(generator.warmup_job(cell.traffic, cell.config), device,
                   counter)
    if warm.error:
        raise RuntimeError(f"the warm-up job failed: {warm.error}")
    if cuda:
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    _say(f"setup: imports {t0 - T_START:.3f} s, CUDA context {t1 - t0:.3f} "
         f"s, kernel library {t2 - t1:.3f} s, warm-up job {t3 - t2:.3f} s "
         f"(front end {warm.frontend_end - warm.start:.3f} s, "
         + ", ".join(f"{k} {v:.3f} s" for k, v in warm.phases.items()) + ")")

    configs = {}
    jobs: list[JobRecord] = []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_w0 = time.perf_counter()
    setup_s = t_w0 - T_START
    due = t_w0 + seconds
    close = None

    def at_iteration_end(hook):
        nonlocal close
        if close is None and hook.ends[-1] >= due:
            close = hook.ends[-1]

    while close is None:
        now = time.perf_counter()
        if now >= due:
            close = now
            break
        job = generator.job(cell.traffic, cell.config, seed, len(jobs))
        configs[job.index] = job.config
        jobs.append(run_job(job, device, counter, on_step=at_iteration_end))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    run = Run(cell, seed, close - t_w0, (t_w0, close), jobs, setup_s, peak,
              kind)

    if trace:
        from .trace import Profiled

        prof = cell.spec["profile"]
        p = Profiled(prof["after_iteration"], prof["iterations"],
                     lambda: {"zebra": zebra.ZEBRA_LAUNCHES})
        job = generator.job(cell.traffic, cell.config, seed, len(jobs))
        rec = run_job(job, device, counter, capture=False,
                      on_step=lambda hook: p.step())
        if rec.error or p.summary is None:
            raise RuntimeError(f"the profiled job failed: {rec.error}")
        run.trace = p.summary
    logging.getLogger("turbomesh.krylov").removeHandler(counter)
    return run, configs


def judge(run: Run, configs: dict) -> tuple[bool, dict, list[str]]:
    """The reference's verdict on the window's jobs: (correct, the worst
    of each compared number beside its limit, reasons it is not)."""
    from .reference.judge import judge as judge_job

    limits = run.cell.spec["limits"]
    why = []
    for j in run.jobs:
        if j.error:
            why.append(f"job {j.index} raised: {j.error}")
    if run.meshes <= 0.0:
        why.append("no Picard iteration ended inside the window")
    done = run.finished()
    worst = {k: 0.0 for k in limits}
    for j in done:
        t0 = time.perf_counter()
        try:
            got = judge_job(configs[j.index], j.x0, j.steps(), j.final)
        except ValueError as e:   # the answer does not fit the job's mesh
            why.append(f"job {j.index} cannot be judged: {e}")
            continue
        for k in limits:
            worst[k] = max(worst[k], got[k])
        _say(f"judged job {j.index} ({j.restagger_deg:+.4f} deg) in "
             f"{time.perf_counter() - t0:.2f} s: "
             + ", ".join(f"{k} {v:.6e}" for k, v in got.items()))
    if not done:
        why.append("no job to judge")
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    for k, c in checks.items():
        if not c["value"] <= c["limit"]:
            why.append(f"{k} {c['value']!r} above its limit {c['limit']!r}")
    return not why, checks, why


def metrics(run: Run, trace: bool) -> dict:
    out = {}
    for m in (run.cell.per_layer if trace else run.cell.end_to_end):
        value = manifest.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(run: Run, trace: bool, correct: bool, checks: dict) -> dict:
    device = {"platform": "gpu", "kind": run.device_kind,
              "count": run.cell.chips, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": correct, "attempted": len(run.jobs),
           "failed": sum(1 for j in run.jobs if j.error or j.nonconverged),
           "metrics": metrics(run, trace), "device": device}
    if trace:
        t = run.trace
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        out["breakdown"] = {"device_ops": t.top(t.device_ops, kernels=True),
                            "idle_gaps": t.top(t.idle_gaps)}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m meshbench.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = manifest.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _say(f"meshbench: {args.workload} needs {cell.chips} CUDA card(s); "
             f"this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    # caches of the program's toolchain stay at fixed paths of the checkout
    # (the port's own nvcc cache is build/turbomesh_tpu_torch already)
    build = manifest.ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")

    run, configs = measure(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda")
    _say(f"card: {card_line()}")
    _say(f"window: {len(run.jobs)} jobs started, {run.meshes:.4f} meshes in "
         f"{run.seconds:.3f} s; setup {run.setup_s:.3f} s; peak "
         f"{run.peak_bytes} bytes")
    correct, checks, why = judge(run, configs)
    out = result(run, bool(args.trace), correct, checks)
    bad = forbidden_modules()
    if bad:
        _say(f"meshbench: forbidden modules loaded: {', '.join(bad)}")
        return 3
    for reason in why:
        _say(f"not correct: {reason}")
    for k, c in checks.items():
        _say(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
