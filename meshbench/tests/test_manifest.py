"""Every cell, configuration, traffic mix and metric is found by name."""

import json

import pytest

from meshbench import manifest

MANIFEST = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_found(name):
    cell = manifest.load_cell(name)
    w = next(w for w in MANIFEST["workloads"] if w["name"] == name)
    assert cell.chips == w["chips"] == 1
    assert cell.traffic["smooth_mesh"]["solver"] == "device"
    assert set(cell.spec["limits"]) == {"frontend_gap", "step_residual"}
    assert {m["name"] for m in cell.end_to_end} == {"mesh_s", "peak_mib",
                                                     "setup_s"}


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda e: e["name"])
def test_config_found(entry):
    cfg = json.loads((manifest.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert entry["file"].startswith("meshbench/configs/")
    assert cfg["reduced"] == entry["reduced"]
    assert "data" in cfg["geometry"]["profile"]
    assert cfg["smoothing"]["iterations"] == 10


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    assert callable(manifest.reader(metric["name"]))


def test_layers_and_moves():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert m["moves"] == "mesh_s"


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        manifest.load_cell("no_such.cell")
