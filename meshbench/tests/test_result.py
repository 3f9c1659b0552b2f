"""The result line's keys, and the run's refusal of JAX."""

import json
import sys

from meshbench import run as R
from meshbench.tests import tiny
from meshbench.tests.test_counting import _job, _run
from meshbench.trace import TraceSummary


def _checks():
    return {"frontend_gap": {"value": 0.0, "limit": 1e-10},
            "step_residual": {"value": 0.004, "limit": 0.05}}


def test_keys_untraced():
    run = _run([_job(0, 0.0, [1.0 + k for k in range(10)])])
    out = R.result(run, False, True, _checks())
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"mesh_s", "setup_s"}
    assert out["metrics"]["mesh_s"] == {"value": 30.0, "unit": "s"}
    assert out["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                             "count": 1, "memory_peak_bytes": 2**27}
    json.dumps(out)


def test_keys_traced():
    j = _job(0, 0.0, [1.0 + k for k in range(10)])
    j.block_sizes = [(221, 41)]
    run = _run([j, _job(1, 0, [], error="ValueError: x")])
    run.cell = tiny.cell(tiny.small(), per_layer=(
        "frontend_s", "picard_iter_s", "device_idle_pct", "zebra_roofline_pct"))
    run.trace = TraceSummary(2.0, 0.2, {f"op{i}": i * 1e-3 for i in range(12)},
                             {"aten::add": 1.5, "aten::item": 0.3}, {"zebra": 0},
                             2)
    out = R.result(run, True, False, _checks())
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["attempted"] == 2 and out["failed"] == 1
    # no K-A launch traced: its roofline is left out, not 0
    assert set(out["metrics"]) == {"frontend_s", "picard_iter_s",
                                   "device_idle_pct"}
    assert out["device"]["busy_s"] == 0.2 and out["device"]["window_s"] == 2.0
    b = out["breakdown"]
    assert len(b["device_ops"]) == 10 and b["device_ops"][0] == ["op11", 0.011]
    assert b["idle_gaps"] == [["aten::add", 1.5], ["aten::item", 0.3]]


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "turbomesh_tpu_torch_like", sys)
    assert "turbomesh_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "turbomesh_tpu.smoothing", sys)
    assert R.forbidden_modules() == ["turbomesh_tpu"]


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = R.main(["--workload", "t106.design_loop", "--seed", "1",
                 "--seconds", "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""
