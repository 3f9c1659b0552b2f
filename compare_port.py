#!/usr/bin/env python3
"""Time this checkout's kernels against another checkout's.

    python3 compare_port.py DIR     # DIR: the root of another checkout

DIR's package ``turbomesh_tpu_torch`` is imported under the name
``other_port``; it builds its own kernels from its own sources with its
own build step (into DIR/build/). Both versions then run, on one card, the
zebra half-sweep at the level-0 planes of T106, LS89 and the scale-4
cascade (both line axes, ``chip_smoke.level_sweeps``), one scale-4
V-cycle's zebra launches, the red-black SOR kernel (50 sweeps) at the
bench's 256 x 256 and the centred scale-4 block in f32 and f64
(``chip_smoke.sor_cases``; this checkout's kernel also at the other
schedules of ``SOR_CANDIDATES``), and the probe on its (8, 128) tile,
with torch.add on that tile beside them. Each is timed as in chip_smoke.py
(``cuda_time_ms``: a run of back-to-back calls between two CUDA events
over the count, median of 11 runs) in turns other, this, this, other, and
the better of each pair is printed. Each zebra result is held against the
plain version in f64 (max |err| <= chip_smoke.PLANE_RTOL max |plain|),
each SOR result too (chip_smoke.SOR_BAR), at every schedule.

Prints one line per shape and, last, one JSON object of all the times in
ms. Exits nonzero without a card, or when a result is off the bar.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent
# other (ti, tj, s, rows) of the SOR kernel timed beside its own schedule
SOR_CANDIDATES = [(16, 32, 16, 16), (32, 48, 8, 16), (16, 32, 8, 16),
                  (16, 48, 8, 16), (32, 32, 16, 16), (16, 40, 12, 16)]


def import_other(root: pathlib.Path):
    """The package ``turbomesh_tpu_torch`` of the checkout at ``root``,
    imported as ``other_port`` (its imports of itself are relative)."""
    init = root / "turbomesh_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "other_port", init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["other_port"] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=pathlib.Path,
                    help="root of the other checkout")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    from turbomesh_tpu_torch.ops import probe, sor, zebra

    import_other(args.other.resolve())
    other = {name: importlib.import_module(f"other_port.ops.{name}")
             for name in ("zebra", "probe", "sor")}
    smoke = cs.Smoke(torch)

    def turns(fns, launches):
        """{name: best ms}: each fn in turns, then in the reverse order."""
        got = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                got[name].append(cs.cuda_time_ms(torch, fns[name],
                                                 launches)[0])
        return {name: min(ms) for name, ms in got.items()}

    times, bad = {}, []
    for mesh in ("t106", "ls89", "scale4"):
        levels = cs.level_sweeps(smoke.mesh(mesh), "cuda", seed=1,
                                 colors=(0, 1))
        for axis, ops in (levels[0][0], levels[0][2]):
            ref = zebra.zebra_half_sweep_ref(*[o.double() for o in ops],
                                             axis=axis)
            for name, mod in (("other", other["zebra"]), ("this", zebra)):
                got = mod.zebra_half_sweep(*ops, axis=axis)
                rel = cs.max_rel_err([g.double() for g in got], ref)
                if not rel <= cs.PLANE_RTOL:
                    bad.append(f"{name} {mesh} axis {axis}: rel {rel:.3e}")
            key = f"{mesh} {tuple(ops[0].shape)} axis {axis}"
            times[key] = turns({
                "other": lambda: other["zebra"].zebra_half_sweep(*ops,
                                                                 axis=axis),
                "this": lambda: zebra.zebra_half_sweep(*ops, axis=axis)},
                cs.ZEBRA_RUN)
            print(f"zebra {key}: {times[key]}", flush=True)
    calls = cs.vcycle_calls(levels)

    def vcycle(mod):
        def run():
            for axis, ops in calls:
                mod.zebra_half_sweep(*ops, axis=axis)
        return run

    key = f"scale-4 V-cycle ({len(calls)} zebra launches)"
    times[key] = turns({"other": vcycle(other["zebra"]),
                        "this": vcycle(zebra)}, 5)
    print(f"{key}: {times[key]}", flush=True)

    def sor_call(mod, ops, schedule=None):
        """A 50-sweep call of ``mod.red_black_sor``, at ``schedule`` (in
        place of this checkout's ``sor.sor_schedule`` for the call) when
        one is given."""
        def run():
            if schedule is None:
                return mod.red_black_sor(*ops, 1.5, cs.SOR_SWEEPS)
            keep = sor.sor_schedule
            sor.sor_schedule = lambda *args: schedule
            try:
                return mod.red_black_sor(*ops, 1.5, cs.SOR_SWEEPS)
            finally:
                sor.sor_schedule = keep
        return run

    for name, *arrs in cs.sor_cases(np, smoke.mesh("scale4"), seed=7)[:2]:
        for dt in (torch.float32, torch.float64):
            dname = str(dt).split(".")[1]
            ops = [torch.as_tensor(a, dtype=dt, device="cuda")
                   for a in arrs[:3]]
            ops.append(torch.as_tensor(arrs[3], device="cuda"))
            ref = sor.red_black_sor_ref(*[o.double() for o in ops[:3]],
                                        ops[3], 1.5, cs.SOR_SWEEPS)
            fns = {"other": sor_call(other["sor"], ops),
                   "this": sor_call(sor, ops)}
            fns.update({f"this {sched}": sor_call(sor, ops, sched)
                        for sched in SOR_CANDIDATES
                        if sor.sor_schedule_fits(*sched, dt)})
            for label, fn in fns.items():
                got = fn().double()
                rel = float((got - ref).abs().max() / ref.abs().max())
                if not rel <= cs.SOR_BAR[dname]:
                    bad.append(f"sor {label} {name} {dname}: rel {rel:.3e}")
            key = (f"sor {name} {dname}, this at "
                   f"{sor.sor_schedule(*ops[0].shape[:2])}")
            times[key] = turns(fns, cs.SOR_RUN)
            print(f"{key}: {times[key]}", flush=True)
    x = torch.randn(probe.SHAPE, device="cuda")
    key = f"probe {probe.SHAPE}"
    times[key] = turns({"other": lambda: other["probe"].probe(x),
                        "this": lambda: probe.probe(x),
                        "torch.add": lambda: torch.add(x, 1.0)},
                       cs.PROBE_RUN)
    print(f"{key}: {times[key]}", flush=True)
    print(cs.nvidia_smi())
    print(json.dumps(times))
    if bad:
        print("off the bar: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
