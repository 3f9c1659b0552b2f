"""The manifest (``BENCHMARK.json``) and the files it names, by name.

A cell ``<config>.<traffic>`` of the manifest's ``workloads`` is made of:

- ``configs/<config>.json``: the configuration as it is run (the manifest
  gives its path under ``file``);
- ``traffic/<traffic>.json``: the traffic mix's parameters, read by
  ``generator``;
- ``workloads/<cell>.json``: what belongs to the cell alone: the limits
  of the comparisons that decide ``correct`` and how many jobs a run
  judges at most, and the traced iterations;
- ``metrics/<metric>.py``: one reader per metric, ``read(run)`` -> a
  number, or None when the run holds nothing for it to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib

PACKAGE = pathlib.Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file as run
    traffic: dict         # the traffic mix's parameters
    spec: dict            # the cell's own file
    end_to_end: list      # manifest entries of the metrics it reports
    per_layer: list


def _read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in the manifest")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic, own file and the metrics it reports."""
    manifest = _read_json(ROOT / "BENCHMARK.json")
    w = _by_name(manifest["workloads"], name, "workload")
    c = _by_name(manifest["configs"], w["config"], "config")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_read_json(ROOT / c["file"]),
        traffic=_read_json(PACKAGE / "traffic" / f"{w['traffic']}.json"),
        spec=_read_json(PACKAGE / "workloads" / f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, name)],
    )


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    return importlib.import_module(f"meshbench.metrics.{metric}").read
