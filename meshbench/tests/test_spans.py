"""The program's spans as the harness sees them: the idle gaps of a
profiled stretch named by the innermost ``turbomesh.*`` range where the
host ran Python between operations, and ``precond_s_per_iter`` and
``interface_s_per_iter`` read from the jobs' ``PhaseTimer`` totals (None
where the program has no span)."""

import pytest

from meshbench import manifest
from meshbench.jobs import NonConvergedCounter, run_job
from meshbench.tests import tiny
from meshbench.tests.test_counting import _job, _run
from meshbench.trace import Event, summarize


def test_idle_gaps_named_by_the_innermost_range():
    ev = [Event("k", True, 40, 50, 0), Event("k", True, 90, 100, 0),
          Event("turbomesh.precond", False, 0, 100, 7),
          Event("turbomesh.precond.interface", False, 10, 60, 7),
          Event("aten::mul", False, 20, 30, 7),
          Event("cudaLaunchKernel", False, 25, 29, 7, runtime=True),
          Event("turbomesh.precond.vcycle", False, 60, 100, 7),
          Event("aten::add", False, 62, 88, 7)]
    s = summarize(ev, {"zebra": 0}, 1)
    # gaps [0, 40] (midpoint 20: inside the interface's aten::mul),
    # [50, 90] (midpoint 70: inside the V-cycle's aten::add); no gap is
    # left to "python between operations"
    assert s.idle_gaps == pytest.approx({"aten::mul": 40e-9,
                                         "aten::add": 40e-9})
    ev[4] = Event("aten::mul", False, 2, 8, 7)
    s = summarize(ev, {"zebra": 0}, 1)
    assert s.idle_gaps == pytest.approx({"turbomesh.precond.interface": 40e-9,
                                         "aten::add": 40e-9})


def _with_span(job, span, seconds):
    job.phases = dict(job.phases, **{span: seconds})
    return job


@pytest.mark.parametrize("metric, span", [
    ("precond_s_per_iter", "precond"),
    ("interface_s_per_iter", "precond.interface")])
def test_span_readers(metric, span):
    read = manifest.reader(metric)
    a = _with_span(_job(0, 0.0, [1.0 + k for k in range(10)]), span, 6.0)
    b = _with_span(_job(1, 11.0, [12.0 + k for k in range(4)]), span, 2.0)
    failed = _with_span(_job(2, 0.0, [], error="RuntimeError: x"), span, 9.0)
    assert read(_run([a, b, failed])) == pytest.approx(8.0 / 14)
    # the parent program has no span: no reading, no error
    assert read(_run([_job(0, 0.0, [1.0 + k for k in range(10)])])) is None
    assert read(_run([])) is None


def test_a_job_records_the_programs_spans():
    cfg = tiny.small(iterations=2)
    cell = tiny.cell(cfg)
    from meshbench import generator

    job = generator.job(cell.traffic, cell.config, 7, 0)
    rec = run_job(job, "cpu", NonConvergedCounter(), capture=False)
    assert rec.error is None
    for name in ("picard_loop", "picard.solve", "precond", "precond.vcycle",
                 "solver_setup.plan"):
        assert rec.phases[name] > 0.0, name
    assert rec.phases["precond"] < rec.phases["picard_loop"]
    run = _run([rec])
    assert 0.0 < manifest.reader("interface_s_per_iter")(run) < \
        manifest.reader("precond_s_per_iter")(run) < \
        manifest.reader("picard_iter_s")(run)
