"""The readings that a cell's limits are set from: the control and the
faults, at the cell's own size, on the card.

    python -m meshbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control-steps 0,4,9]

For each seed, job 0 of the seed's stream runs on the users' path as in a
benchmark run (not timed), and prints one JSON line with the compared
numbers (``reference.judge``) of:

- ``program``: the job as the program produced it;
- ``control``: the reference in the program's place in float32 at the
  ``--control-steps`` of the program's trajectory (sparse LU of the
  float32 system), its front end rounded to float32;
- ``unchanged_step``: step s (drawn from the seed) returns its state;
- ``half_batch``: the last step leaves the first half of the blocks
  where they were;
- ``answer_altered``: one interior point of the final mesh moved by 1e-5.

The last line gives, per number, the largest program reading and the
smallest reading of the control and of each fault. Prints the card's
nvidia-smi name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import generator, manifest
from .jobs import NonConvergedCounter, run_job
from .reference.classify import Kind, classify
from .reference.input import build_mesh
from .reference.judge import control_readings, judge

ALTER = 1e-5


def faults(cfg, x0, steps, final, seed, alter=ALTER) -> dict:
    """The compared numbers of each planted fault (module docstring;
    ``alter``: the altered point's shift)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 7]))
    xs = list(steps[:-1]) + [final]
    states = [x0] + xs

    def judged(xs):
        return judge(cfg, x0, xs, xs[-1])

    s = int(rng.integers(len(xs)))
    bad = list(xs)
    bad[s] = states[s]
    mesh = build_mesh(cfg)
    half = sum(len(b) for b in mesh.blocks[: len(mesh.blocks) // 2])
    last = final.copy()
    last[:half] = states[-2][:half]
    free = np.flatnonzero(classify(mesh).kind == Kind.INTERIOR)
    moved = final.copy()
    moved[free[rng.integers(len(free))], 0] += alter
    return {"unchanged_step": judged(bad),
            "half_batch": judged(xs[:-1] + [last]),
            "answer_altered": judged(xs[:-1] + [moved])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m meshbench.calibrate",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-steps", default=None,
                    help="comma-separated steps the control takes "
                         "(default all)")
    args = ap.parse_args(argv)
    from .run import card_line

    print(f"card: {card_line()}", flush=True)
    cell = manifest.load_cell(args.workload)
    which = (None if args.control_steps is None else
             {int(s) for s in args.control_steps.split(",")})
    counter = NonConvergedCounter()
    import logging

    logging.getLogger("turbomesh.krylov").addHandler(counter)
    worst: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        job = generator.job(cell.traffic, cell.config, seed, 0)
        t0 = time.perf_counter()
        rec = run_job(job, "cuda", counter)
        if rec.error:
            print(json.dumps({"seed": seed, "error": rec.error}), flush=True)
            continue
        t1 = time.perf_counter()
        steps = rec.steps()
        row = {"program": judge(job.config, rec.x0, steps, rec.final)}
        t2 = time.perf_counter()
        row["control"] = control_readings(job.config, rec.x0, steps,
                                          rec.final, which)
        t3 = time.perf_counter()
        row.update(faults(job.config, rec.x0, steps, rec.final, seed))
        for name, nums in row.items():
            for key, v in nums.items():
                w = worst.setdefault(key, {})
                w[name] = (max if name == "program" else min)(
                    w.get(name, v), v)
        print(json.dumps({"seed": seed, "restagger_deg": job.restagger_deg,
                          "nonconverged": rec.nonconverged,
                          "job_s": t1 - t0, "judge_s": t2 - t1,
                          "control_s": t3 - t2, **row}), flush=True)
    print(json.dumps({"largest_program_and_smallest_others": worst}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
