"""The program's spans (``profiling.span``) and its recorder, ``PhaseTimer``.

On the CPU, the tiny O4H mesh through the device solver: the span tree
is consistent (each child inside its parent, self seconds >= 0), the
counts are the stages' calls (``precond`` one a ``_stage_Minv``
application, one V-cycle each), the mesh is bit for bit the same with
no timer, with an active one and under ``torch.profiler``, the profiler's
``turbomesh.*`` ranges enclose their operators and agree with the
recorder (operator ranges, which the profiler keeps off the device's
timeline), and with neither a timer nor a profiler a span reads no clock
and enters no range. ``turbomesh-torch --trace DIR``
writes a Chrome trace with the ranges and prints the tree.
"""

import contextlib
import json
import time

import numpy as np
import pytest
import torch

from turbomesh_tpu_torch import cli, profiling
from turbomesh_tpu_torch import input as input_mod
from turbomesh_tpu_torch.profiling import PhaseTimer, span
from turbomesh_tpu_torch.smoothing import smooth_mesh
from turbomesh_tpu_torch.smoothing.classify import classify
from turbomesh_tpu_torch.smoothing.control_function import from_config
from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

from test_frontends import TINY_CFG
from test_torch_frontend import ROOT

torch.set_num_threads(1)

WHITE = {"white": {"ds_target": 1e-4}}
ITERATIONS = 2


def _mesh():
    inp = input_mod.load(TINY_CFG, base_dir=str(ROOT))
    return inp.template.run(inp.geometry)


@pytest.fixture(scope="module")
def smoothed():
    """smooth_mesh on the tiny mesh with a timer active around the front
    end too, counting the ``_stage_Minv`` applications."""
    calls = []
    inner = DeviceSmoother._stage_Minv

    def counted(self, ctx, v):
        calls.append(1)
        return inner(self, ctx, v)

    timer = PhaseTimer()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DeviceSmoother, "_stage_Minv", counted)
        with timer.active():
            mesh = _mesh()
        smooth_mesh(mesh, ITERATIONS, solver="device",
                    wall_control_function=WHITE, timer=timer, device="cpu")
    return timer, len(calls)


def test_span_tree_nests(smoothed):
    timer, _ = smoothed
    c = timer.counts
    for name in ("load", "template", "template.tfi", "connection_check",
                 "classify", "solver_setup", "solver_setup.plan",
                 "solver_setup.glue", "solver_setup.upload", "picard_loop",
                 "picard.update", "picard.solve", "picard.read",
                 "solve.prepare", "fgmres.cycle", "fgmres.operator",
                 "fgmres.stop_test", "precond", "precond.interface",
                 "precond.vcycle", "precond.residual"):
        assert c.get(name, 0) > 0, name
    for edge in ((None, "picard_loop"), ("template", "template.tfi"),
                 ("solver_setup", "solver_setup.glue"),
                 ("picard_loop", "picard.solve"),
                 ("picard_loop", "picard.read"),
                 ("picard_loop", "picard.update"),
                 ("picard.solve", "solve.prepare"),
                 ("picard.solve", "fgmres.cycle"),
                 ("picard.solve", "fgmres.stop_test"),
                 ("fgmres.cycle", "fgmres.operator"),
                 ("fgmres.cycle", "precond"),
                 ("precond", "precond.vcycle")):
        assert edge in timer.edges, edge
    assert c["picard.solve"] == c["picard.read"] == ITERATIONS
    assert c["picard.update"] == ITERATIONS - 1
    assert c["template.tfi"] == 8
    # children inside their parents; self seconds never negative
    inside: dict = {}
    for (parent, name), (n, total, own) in timer.edges.items():
        assert own >= 0.0 and total <= timer.totals[name]
        if parent is not None:
            inside[parent] = inside.get(parent, 0.0) + total
    for parent, total in inside.items():
        assert total <= timer.totals[parent]
        assert timer.self_s[parent] == pytest.approx(
            timer.totals[parent] - total, abs=1e-9)
    for name, own in timer.self_s.items():
        assert 0.0 <= own <= timer.totals[name]
    lines = timer.report(nodes=660).splitlines()
    assert len(lines) == len(timer.edges)
    assert lines[0].startswith("picard_loop: ") and "Mnodes/s" in lines[0]
    assert any(ln.startswith("      precond: ") for ln in lines)


def test_span_counts_are_the_stages_calls(smoothed):
    timer, minv_calls = smoothed
    c = timer.counts
    # one FGMRES iteration: one preconditioner application, one f64
    # operator; each cycle adds the operator for its first and last
    # residual; the default Schur composition with two interface passes
    assert c["precond"] == minv_calls == c["precond.vcycle"] > 0
    assert c["fgmres.operator"] == c["precond"] + 2 * c["fgmres.cycle"]
    assert c["fgmres.stop_test"] == c["fgmres.cycle"]
    assert c["precond.interface"] == c["precond.residual"] == 3 * c["precond"]
    assert "precond.deflation" not in c


def _run(timer=None, profile=False):
    """Two White iterations of DeviceSmoother.run on the tiny mesh: the
    coordinates, and with ``profile`` the profiler's events."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    mesh = _mesh()
    alg = from_config(WHITE)
    sm = DeviceSmoother(mesh, classify(mesh), rtol=1e-4, atol=1e-11,
                        device="cpu")
    args = (mesh.flat_coords(), alg.init(mesh), ITERATIONS)
    with (timer.active() if timer else contextlib.nullcontext()):
        if not profile:
            return sm.run(*args, algorithm=alg)[0], None
        with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
            out = sm.run(*args, algorithm=alg)[0]
    return out, list(prof.profiler.kineto_results.events())


@pytest.fixture(scope="module")
def profiled():
    timer = PhaseTimer()
    out, events = _run(timer, profile=True)
    return timer, out, events


def test_spans_leave_the_mesh_bit_for_bit(profiled):
    plain, _ = _run()
    timed, _ = _run(PhaseTimer())
    np.testing.assert_array_equal(timed, plain)
    np.testing.assert_array_equal(profiled[1], plain)


def test_profiler_ranges_enclose_ops_and_agree(profiled):
    timer, _, events = profiled
    ranges: dict = {}
    ops = []
    for e in events:
        s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.name().startswith("turbomesh."):
            assert not e.is_user_annotation(), e.name()
            ranges.setdefault(e.name(), []).append((s, t, e.start_thread_id()))
        elif e.name().startswith("aten::"):
            ops.append((s, t, e.start_thread_id()))
    ops.sort()
    starts = np.array([s for s, _, _ in ops])
    assert ranges.keys() == {f"turbomesh.{n}" for n in timer.counts}
    for name in ("turbomesh.precond", "turbomesh.precond.vcycle",
                 "turbomesh.precond.interface", "turbomesh.precond.residual"):
        rec = name.removeprefix("turbomesh.")
        assert len(ranges[name]) == timer.counts[rec]
        for s, t, thread in ranges[name]:
            lo, hi = np.searchsorted(starts, [s, t])
            body = [op for op in ops[lo:hi] if op[2] == thread]
            assert body, f"{name} holds no operator"
            assert all(end <= t for _, end, _ in body), \
                f"an operator crosses the end of {name}"
            before = [op for op in ops[max(0, lo - 64):lo] if op[2] == thread]
            assert all(end <= s or end >= t for _, end, _ in before), \
                f"an operator crosses the start of {name}"
        got = sum(t - s for s, t, _ in ranges[name]) * 1e-9
        want = timer.totals[rec]
        assert abs(got - want) <= 0.1 * want + 50e-6 * timer.counts[rec], \
            (name, got, want)


def test_span_off_reads_no_clock(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("read the clock or entered a range")

    assert not torch.autograd._profiler_enabled()
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(time, "perf_counter", refuse)
    with span("a"):
        with span("a.b"):
            pass
    assert span("a") is span("b")       # one shared no-op
    # an active timer reads the clock, still with no profiler range
    monkeypatch.undo()
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    timer = PhaseTimer()
    with timer.active():
        with span("a"):
            with span("a.b"):
                pass
        with span("a"):
            pass
    assert timer.counts == {"a": 2, "a.b": 1}
    assert set(timer.edges) == {(None, "a"), ("a", "a.b")}
    assert profiling._local.timer is None


def test_cli_trace_writes_ranges(tmp_path, capsys):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY_CFG))
    rc = cli.main([str(cfg), "--base-dir", str(ROOT), "--device", "cpu",
                   "--solver", "device", "--iterations", "1",
                   "--trace", str(tmp_path / "tr"),
                   "--output", str(tmp_path / "m.npz")])
    assert rc == 0
    out = capsys.readouterr().out
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"turbomesh.picard.solve", "turbomesh.precond",
            "turbomesh.precond.vcycle", "turbomesh.fgmres.cycle"} <= names
    assert "aten::mul" in names
    for line in ("load: ", "template: ", "picard_loop: ",
                 "      precond: "):
        assert any(ln.startswith(line) for ln in out.splitlines()), line
    assert "trace.json" in out
