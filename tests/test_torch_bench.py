"""Port bench entry point (turbomesh_tpu_torch.bench) vs the JAX bench.

The port's ``_timed_device_run`` (warm-up, White run to the target,
frozen-control-function continuation, host oracle) on a small scaled
T106 cascade against JAX ``DeviceSmoother.run`` called as the JAX
``bench.py`` calls it; the summary line's size bound; the entry order;
the SOR entry on the CPU; and the jax-free import.
"""

import json
import logging
import subprocess
import sys

import numpy as np
import pytest
import torch

from turbomesh_tpu import input as jax_input
from turbomesh_tpu.smoothing.classify import classify as jax_classify
from turbomesh_tpu.smoothing.control_function import White as JWhite
from turbomesh_tpu.smoothing.device import DeviceSmoother as JaxSmoother

from turbomesh_tpu_torch import bench
from turbomesh_tpu_torch import input as torch_input
from turbomesh_tpu_torch.smoothing.control_function import White

from test_torch_frontend import ROOT, _no_jax_env

torch.set_num_threads(1)


def _cut_cascade():
    """The bench's scaled T106 cascade at scale 1 with every cell count
    cut to 0.3 (2,501 points). The small O4H mesh of the other tests is
    no use here: White's init puts |P| up to 87 at its coarse leading-edge
    junction, and with that control function frozen the Picard iteration
    diverges in both packages."""
    cfg = bench.scaled_t106_config(1)
    cells = cfg["template"]["O4H"]["num_cells"]
    for k in cells:
        cells[k] = max(2, int(cells[k] * 0.3))
    return cfg


def test_timed_device_run_matches_jax():
    """White (ds_target 1e-6, as examples/T106) for 3 Picard iterations,
    which leave the residual near 4e-5, then the frozen continuation to
    1e-10, on device="cpu". Measured: both reach 2.9e-12 after 5 frozen
    iterations and agree to 2.9e-11. Bar: 5e-9, the whole-slice bar of
    tests/test_torch_solver.py (both packages solve the early iterations
    only to rtol 1e-2 and their f32 smoothers round differently)."""
    cfg = _cut_cascade()
    target, cap, ds = bench.TARGET, 3, 1e-6
    inp = torch_input.load(cfg, base_dir=str(ROOT))
    mt = inp.template.run(inp.geometry)
    counter = bench.NonConvergedCounter()
    log = logging.getLogger("turbomesh.krylov")
    log.addHandler(counter)
    try:
        rec, coords = bench._timed_device_run(
            {"nodes": mt.num_points}, mt, cap, White(ds_target=ds), True,
            "cpu", counter, continue_frozen=True)
    finally:
        log.removeHandler(counter)

    inp = jax_input.load(cfg, base_dir=str(ROOT))
    mj = inp.template.run(inp.geometry)
    white = JWhite(ds_target=ds)
    dev = JaxSmoother(mj, jax_classify(mj), rtol=1e-6, atol=1e-8,
                      restart=10, max_restarts=10)
    cf0 = white.init(mj)
    coords0 = mj.flat_coords()
    dev.run(coords0, cf0, 1, algorithm=None)
    c, cf, disp, iters = dev.run(coords0, cf0, cap, algorithm=white,
                                 target_residual=target)
    assert disp >= target  # the continuation is exercised
    c, cf, disp2, it2 = dev.run(c, cf, 60, algorithm=None,
                                start_iteration=iters, target_residual=target)

    assert rec["picard_iters"] == iters == cap
    assert not rec["reached_target"]
    frozen = rec["frozen_continuation"]
    assert frozen["reached_target"] and disp2 < target
    assert frozen["picard_iters"] == it2 - iters
    assert rec["linear_solves_converged"] and frozen["linear_solves_converged"]
    assert rec["zebra_launches"] == 0  # the CPU runs the plain version
    assert rec["host_direct_mnodes_per_s"] > 0
    assert rec["seconds_to_1e-10_total"] > rec["seconds_to_1e-10"]
    np.testing.assert_allclose(rec["final_displacement_residual"], disp,
                               rtol=1e-3)
    err = np.abs(coords - c).max()
    assert err < 5e-9, f"bench run mismatch {err:.3e}"


def _full_records(error: bool):
    """One record per default entry, each as long as it gets."""
    recs = []
    for spec in bench.build_specs(list(bench.DEFAULT_SCALES)):
        k, v = bench._spec_ident(spec)
        if error:
            recs.append({k: v, "error": "RuntimeError: " + "x" * 300})
        elif spec["kind"] == "sor":
            recs.append({"entry": "sor", "sor_mnode_sweeps_per_s":
                         123456.789012, "sor_launches": 1100})
        else:
            recs.append({k: v, "nodes": 5_400_000, "picard_iters": 30,
                         "seconds_to_1e-10": 12345.678,
                         "reached_target": False,
                         "final_displacement_residual": 1.234e-9,
                         "linear_solves_converged": False,
                         "run_to_target_mnodes_per_s": 0.123456789012,
                         "device_mnodes_per_s": 1.23456789012,
                         "host_direct_mnodes_per_s": 0.0123456789,
                         "frozen_continuation": {
                             "picard_iters": 60, "seconds": 9999.999,
                             "final_displacement_residual": 9.87e-11,
                             "reached_target": True,
                             "linear_solves_converged": False}})
    return recs


@pytest.mark.parametrize("error", [True, False])
def test_summary_line_fits(error):
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    recs = _full_records(error)
    line = bench.summary(recs, card, 123456.7)
    assert len(line.encode()) <= bench.SUMMARY_MAX_BYTES
    out = json.loads(line)
    assert out["metric"] == "elliptic_smoothing_run_to_target"
    assert out["card"] == card
    assert len(out["entries"]) == len(recs) == 8
    if error:
        assert out["value"] == 0.0 and out["headline"] is None
        assert all(s.startswith("error") for s in out["entries"].values())
    else:
        assert out["value"] == pytest.approx(0.123456789012)
        assert out["vs_baseline"] == pytest.approx(1.23456789012
                                                   / 0.0123456789)


def _keys(scales):
    return [bench.record_key(dict([bench._spec_ident(s)]))
            for s in bench.build_specs(scales)]


def test_entry_order():
    assert _keys(list(bench.DEFAULT_SCALES)) == [
        "scale4", "scale15", "LS89", "T106", "scale1", "scale2", "scale8",
        "sor"]
    assert _keys([1]) == ["scale1", "LS89", "T106", "sor"]


def test_sor_entry_on_cpu():
    lines = []
    recs = bench.run([{"kind": "sor"}], 30, "cpu", emit=lines.append)
    assert len(lines) == 2
    rec = json.loads(lines[0])
    assert rec == recs[0]
    assert rec["entry"] == "sor" and rec["device"] == "cpu"
    assert rec["sor_mnode_sweeps_per_s"] > 0
    assert rec["sor_launches"] == 0  # the plain version is no launch
    out = json.loads(lines[1])
    assert out["card"] == "cpu" and list(out["entries"]) == ["sor"]


def test_main_cuda_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["1"])


def test_bench_and_sor_import_no_jax():
    code = ("import sys\n"
            "import turbomesh_tpu_torch.bench, turbomesh_tpu_torch.ops.sor\n"
            "import turbomesh_tpu_torch.ops.probe\n"
            "assert 'jax' not in sys.modules, 'the port imported jax'\n")
    res = subprocess.run([sys.executable, "-c", code], env=_no_jax_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
