"""The reference against the port at a small size, and its control."""

import dataclasses
import sys

import numpy as np
import pytest

from meshbench import generator
from meshbench.calibrate import faults
from meshbench.jobs import IterationHook, NonConvergedCounter, run_job
from meshbench.reference import input as ref_input
from meshbench.reference.judge import control_readings, judge
from meshbench.tests import tiny

LIMITS = {"frontend_gap": 1e-10, "step_residual": 0.05}


@pytest.mark.parametrize("cfg", [tiny.t106(), tiny.small(), tiny.half_t106()],
                         ids=["t106", "small", "half_t106"])
def test_front_end_is_the_ports(cfg):
    from turbomesh_tpu_torch import input as port_input

    job = generator.restagger(cfg, -0.6)
    inp = port_input.load(job)
    port = inp.template.run(inp.geometry)
    ref = ref_input.build_mesh(job)
    assert [b.size for b in ref.blocks] == [b.size for b in port.blocks]
    assert np.array_equal(ref.flat_coords(), port.flat_coords())


def _host_trajectory(cfg):
    """The port's host direct solver over the job: exact steps."""
    from turbomesh_tpu_torch import input as port_input
    from turbomesh_tpu_torch.smoothing import smooth_mesh

    inp = port_input.load(cfg)
    mesh = inp.template.run(inp.geometry)
    x0 = mesh.flat_coords()
    steps = []

    class Hook(list):
        def append(self, v):
            # the host loop appends before it stores the step's answer
            super().append(v)
            steps.append(sys._getframe(1).f_locals["new"].copy())

    smooth_mesh(mesh, cfg["smoothing"]["iterations"], solver="direct",
                wall_control_function=cfg["smoothing"]["wall_control_function"],
                residual_history=Hook())
    return x0, steps, mesh.flat_coords()


def test_exact_steps_read_zero():
    cfg = generator.restagger(tiny.half_t106(), 0.4)
    x0, steps, final = _host_trajectory(cfg)
    got = judge(cfg, x0, steps, final)
    assert got["frontend_gap"] == 0.0
    assert got["step_residual"] < 1e-8


@pytest.fixture(scope="module")
def device_job():
    cfg = tiny.half_t106()
    job = generator.Job(0, 0.4, generator.restagger(cfg, 0.4), 3,
                        {"solver": "device"})
    rec = run_job(job, "cpu", NonConvergedCounter())
    assert rec.error is None, rec.error
    return job.config, rec


def test_port_device_path_within_limits(device_job):
    cfg, rec = device_job
    got = judge(cfg, rec.x0, rec.steps(), rec.final)
    assert got["frontend_gap"] == 0.0
    assert 0.0 < got["step_residual"] < LIMITS["step_residual"]


def test_control_and_faults_fail(device_job):
    cfg, rec = device_job
    steps = rec.steps()
    control = control_readings(cfg, rec.x0, steps, rec.final)
    assert control["frontend_gap"] > LIMITS["frontend_gap"]
    # three iterations leave the last step's moves ~1e-3 on this mesh, so
    # the altered point moves 1e-4 here (1e-5 at the cells' ten)
    for name, got in faults(cfg, rec.x0, steps, rec.final, 5,
                            alter=1e-4).items():
        assert got["step_residual"] > LIMITS["step_residual"], name


def test_capture_is_the_ports_layout(device_job):
    """The benchmark's own unpadding of the captured stacks agrees with
    the program's converter, and the last is the final mesh."""
    from turbomesh_tpu_torch import input as port_input
    from turbomesh_tpu_torch.smoothing.classify import classify
    from turbomesh_tpu_torch.smoothing.device import build_plan

    cfg, rec = device_job
    inp = port_input.load(cfg)
    mesh = inp.template.run(inp.geometry)
    plan = build_plan(mesh, classify(mesh))
    steps = rec.steps()
    assert len(steps) == len(rec.states) == 3
    for X, x in zip(rec.states, steps):
        assert np.array_equal(plan.unpad_coords(X), x)
    assert np.array_equal(steps[-1], rec.final)
    bad = dataclasses.replace(rec, states=rec.states[:-1] + rec.states[-2:-1])
    with pytest.raises(ValueError, match="padded layout"):
        bad.steps()


def test_capture_without_the_loops_stack_says_so():
    hook = IterationHook(capture=True)
    with pytest.raises(RuntimeError, match="loop's locals changed"):
        hook.append(1.0)


def test_wrong_iteration_count_raises(device_job):
    cfg, rec = device_job
    with pytest.raises(ValueError):
        judge(cfg, rec.x0, rec.steps()[:-1], rec.final)
