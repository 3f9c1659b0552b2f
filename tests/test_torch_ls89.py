"""The LS89 vane (the configuration ``ls89``) on the users' path, against
the benchmark's reference and the JAX package.

LS89's profile is given in millimetres with ``geometry.scale`` 0.001 and
``pitch`` 57.5, so the front end scales the profile and the pitch alike;
its O4H blocking holds a 6-point-wide block (``in_i`` 5) that coarsens to
3, 2 and 1 points on the multigrid's coarse levels. On the CPU:

- the full-size front end (37,703 points) under two seeded restaggers of
  the ``design_loop`` traffic is the reference's mesh bit for bit;
- both front ends scale the pitch and the profile by ``geometry.scale``;
- LS89 with its O4H cell counts halved (odd counts rounded up, ``in_i``
  kept at 5) and 3 Picard iterations, through ``smooth_mesh(...,
  solver="device")`` as a benchmark job runs it, is judged by
  ``meshbench.reference.judge`` under the limits of the cell
  ``ls89.design_loop``, and its final mesh is the JAX package's
  ``smooth_mesh`` on the same configuration to within a bar that a
  float32 solve fails.
"""

import copy
import json

import numpy as np
import pytest
import torch

from meshbench import generator, manifest
from meshbench.jobs import NonConvergedCounter, run_job
from meshbench.reference import input as ref_input
from meshbench.reference.judge import judge
from turbomesh_tpu import input as jax_input
from turbomesh_tpu.smoothing import smooth_mesh as jax_smooth_mesh
from turbomesh_tpu_torch import input as port_input

torch.set_num_threads(1)

CELL = "ls89.design_loop"
SEEDS = [3, 2**31 + 17]
SEED_IDS = ["seed3", "seed2^31+17"]


def _read(path):
    with open(path) as f:
        return json.load(f)


CONFIG = _read(manifest.PACKAGE / "configs" / "ls89.json")
TRAFFIC = _read(manifest.PACKAGE / "traffic" / "design_loop.json")
LIMITS = _read(manifest.PACKAGE / "workloads" / f"{CELL}.json")["limits"]


def half_ls89(iterations=3) -> dict:
    """LS89 with every O4H cell count halved, odd counts rounded up, and
    ``in_i`` kept at 5 (the thin block that coarsens to 1 point)."""
    cfg = copy.deepcopy(CONFIG)
    cells = cfg["template"]["O4H"]["num_cells"]
    for k, v in cells.items():
        cells[k] = v if k == "in_i" else (v + 1) // 2
    cfg["smoothing"]["iterations"] = iterations
    return cfg


@pytest.mark.parametrize("seed", SEEDS, ids=SEED_IDS)
def test_front_end_is_the_references(seed):
    job = generator.job(TRAFFIC, CONFIG, seed, 0)
    assert job.restagger_deg != 0.0
    inp = port_input.load(job.config)
    port = inp.template.run(inp.geometry)
    ref = ref_input.build_mesh(job.config)
    sizes = [b.size for b in port.blocks]
    assert sum(ni * nj for ni, nj in sizes) == 37703
    assert (6, 131) in sizes
    assert [b.size for b in ref.blocks] == sizes
    assert np.array_equal(ref.flat_coords(), port.flat_coords())


@pytest.mark.parametrize("front_end", ["port", "reference"])
def test_scale_applies_to_pitch_and_profile(front_end):
    load = port_input.load if front_end == "port" else ref_input.load
    geo = CONFIG["geometry"]
    assert (geo["scale"], geo["pitch"]) == (0.001, 57.5)
    inp = load(CONFIG)
    unscaled = copy.deepcopy(CONFIG)
    del unscaled["geometry"]["scale"]
    raw = load(unscaled)
    assert inp.geometry.pitch == pytest.approx(0.0575, rel=1e-15)
    assert raw.geometry.pitch == 57.5
    for side in ("down_part", "up_part"):
        got = getattr(inp.geometry.profile, side).points
        want = getattr(raw.geometry.profile, side).points
        np.testing.assert_array_equal(got, want * 0.001)


@pytest.fixture(scope="module", params=SEEDS, ids=SEED_IDS)
def half_job(request):
    job = generator.job(TRAFFIC, half_ls89(), request.param, 0)
    assert job.iterations == 3 and job.smooth_mesh == {"solver": "device"}
    rec = run_job(job, "cpu", NonConvergedCounter())
    assert rec.error is None, rec.error
    return job, rec


def test_half_ls89_device_path_judged_by_the_reference(half_job):
    job, rec = half_job
    assert min(min(s) for s in rec.block_sizes) == 6
    assert rec.nonconverged == 0
    got = judge(job.config, rec.x0, rec.steps(), rec.final)
    assert got["frontend_gap"] == 0.0
    assert 0.0 < got["step_residual"] <= LIMITS["step_residual"]


def test_half_ls89_device_path_matches_jax(half_job):
    """The port's final mesh against the JAX package's ``smooth_mesh``
    (device solver, White control) on the job's configuration. Both stop
    each solve at the same rtol / atol and differ only by the float32
    preconditioners' roundoff: measured 2.4e-10 and 4.6e-10 after 3
    iterations on the two seeds. A float32 solve moves a step by far
    more: the reference's float32 sparse LU of each step's system, from
    the port's states, lies 4.8e-7 to 6.3e-6 from its float64 LU, and
    even a float64 solve whose answer is rounded to float32 at every
    step reads 7.8e-9 and 1.3e-8. Bar: 2e-9."""
    job, rec = half_job
    inp = jax_input.load(copy.deepcopy(job.config))
    mesh = inp.template.run(inp.geometry)
    jax_smooth_mesh(mesh, job.iterations, solver="device",
                    wall_control_function=inp.smoothing.wall_control_function)
    err = np.abs(rec.final - mesh.flat_coords()).max()
    assert err < 2e-9, f"port vs JAX {err:.3e}"
