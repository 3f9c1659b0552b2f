"""The window's fractional job count, and the metric readers over it."""

import math

import pytest

from meshbench import manifest
from meshbench.jobs import JobRecord
from meshbench.run import Run
from meshbench.tests import tiny


def _job(index, start, iteration_ends, error=None):
    j = JobRecord(index, 0.0, 10, start=start)
    j.iteration_ends = list(iteration_ends)
    j.end = iteration_ends[-1] + 0.01 if iteration_ends else math.nan
    j.frontend_end = start + 0.5
    j.phases = {"picard_loop": 8.0, "classify": 0.1, "solver_setup": 0.4,
                "connection_check": 0.05}
    j.zebra_launches = 10_080
    if error is None:
        j.final = object()
    j.error = error
    return j


def _run(jobs, seconds=30.0):
    return Run(tiny.cell(tiny.small()), 1, seconds, (0.0, seconds), jobs,
               5.0, 2**27, "NVIDIA H100 80GB HBM3")


def test_share_of_the_job_in_flight():
    a = _job(0, 0.0, [1.0 + k for k in range(10)])          # ends 10.01
    b = _job(1, 10.01, [12.5 + 2 * k for k in range(10)])   # 9 inside
    c = _job(2, 29.9, [30.5 + k for k in range(10)])        # 0 inside
    d = _job(3, 0.0, [], error="RuntimeError: boom")
    run = _run([a, b, c, d], seconds=30.0)
    assert a.share_before(30.0) == 1.0
    assert b.share_before(30.0) == 0.9
    assert c.share_before(30.0) == 0.0
    assert d.share_before(30.0) == 0.0
    assert run.meshes == pytest.approx(1.9)
    assert manifest.reader("mesh_s")(run) == pytest.approx(30.0 / 1.9)


def test_no_mesh_no_number():
    run = _run([_job(0, 0.0, [40.0 + k for k in range(10)])])
    assert run.meshes == 0.0
    assert manifest.reader("mesh_s")(run) is None


def test_per_mesh_readers():
    jobs = [_job(0, 0.0, [1.0 + k for k in range(10)]),
            _job(1, 10.01, [11.0 + k for k in range(10)])]
    run = _run(jobs)
    assert manifest.reader("picard_iter_s")(run) == pytest.approx(0.8)
    assert manifest.reader("frontend_s")(run) == pytest.approx(1.05)
    assert manifest.reader("zebra_launches_per_iter")(run) == 1008.0
    assert manifest.reader("peak_mib")(run) == 128.0
    assert manifest.reader("setup_s")(run) == 5.0
    # nothing traced: the trace's readers have nothing to read
    assert manifest.reader("zebra_roofline_pct")(run) is None
    assert manifest.reader("device_idle_pct")(run) is None
