"""The reader of the preconditioner's CUDA graph capture, on hand-made run
records: seconds a finished job spends in the span
``precond.graph.capture``, and None where the program has no such span
(a program without the graph)."""

import pytest

from meshbench import manifest
from meshbench.tests.test_counting import _job, _run

SPAN = "precond.graph.capture"


def _jobs():
    a = _job(0, 0.0, [1.0 + k for k in range(10)])
    b = _job(1, 10.01, [11.0 + k for k in range(10)])
    failed = _job(2, 20.5, [], error="RuntimeError: x")
    for j, s in ((a, 0.04), (b, 0.06), (failed, 9.0)):
        j.phases = dict(j.phases, precond=5.0, **{SPAN: s})
    return a, b, failed


def test_capture_seconds_per_finished_job():
    read = manifest.reader("graph_capture_s")
    assert read(_run(list(_jobs()))) == pytest.approx((0.04 + 0.06) / 2)
    # a finished job that captured nothing counts as 0 s once the span
    # exists in the window
    a, b, _ = _jobs()
    del b.phases[SPAN]
    assert read(_run([a, b])) == pytest.approx(0.04 / 2)


def test_capture_none_without_the_span():
    read = manifest.reader("graph_capture_s")
    assert read(_run([_job(0, 0.0, [1.0 + k for k in range(10)])])) is None
    assert read(_run([])) is None
    _, _, failed = _jobs()
    assert read(_run([failed])) is None


def test_reported_in_both_cells():
    cells = ("t106.design_loop", "t106_x2.laplace_target")
    for cell in cells:
        names = [m["name"] for m in manifest.load_cell(cell).per_layer]
        assert "graph_capture_s" in names
