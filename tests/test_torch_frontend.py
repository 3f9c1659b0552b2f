"""Port front end (turbomesh_tpu_torch) vs the JAX package, bit for bit.

The port carries jax-free copies of the NumPy front end (blocking,
classification, index plans, glue maps) so it runs where JAX is absent;
these tests pin the copies to the originals: the same configs give the
same meshes, boundary classification, device plans and glue maps, and
``plan_tensors`` turns either package's plan into the same tensors.
"""

import dataclasses
import enum
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from turbomesh_tpu import input as jax_input
from turbomesh_tpu.smoothing.classify import classify as jax_classify
from turbomesh_tpu.smoothing.device import build_plan as jax_build_plan
from turbomesh_tpu.smoothing.glue import build_glue as jax_build_glue

from turbomesh_tpu_torch import input as torch_input
from turbomesh_tpu_torch.smoothing.classify import classify
from turbomesh_tpu_torch.smoothing.device import build_plan, plan_tensors
from turbomesh_tpu_torch.smoothing.glue import build_glue

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
T106 = ROOT / "examples" / "T106" / "T106.json"
# mm-unit geometry (``geometry.scale`` on profile and pitch) and a 6-point
# block (``in_i`` 5) that coarsens to 1 point on the multigrid's levels
LS89 = ROOT / "examples" / "LS89" / "LS89.json"

SMALL_O4H = {
    "template": {"O4H": {
        "inlet_distance": 0.05, "outlet_distance": 0.02,
        "blade_clustering": {"roberts": {"alpha": 0.5, "beta": 1.1}},
        "num_cells": {
            "o_grid": 6, "middle_i": 12, "in_up_j": 6, "in_down_j": 5,
            "in_i": 5, "out_up_j": 6, "out_down_j": 5, "out_i": 5,
            "down_j": 6, "bulge": 6, "upstream_i": 5, "downstream_i": 5,
        },
    }},
    "smoothing": {},
    "geometry": {"pitch": 0.08836, "profile": {"csv": {
        "down_csv_path": "examples/T106/T106_ps.dat",
        "up_csv_path": "examples/T106/T106_ss.dat"}}},
}


def _meshes(case):
    """(jax mesh, port mesh) for the named config."""
    out = []
    for mod in (jax_input, torch_input):
        if case in ("t106", "ls89"):
            path = T106 if case == "t106" else LS89
            inp = mod.load(str(path), base_dir=str(path.parent))
        else:
            inp = mod.load(SMALL_O4H, base_dir=str(ROOT))
        out.append(inp.template.run(inp.geometry))
    return out


def _same(a, b, path="root"):
    """Deep equality across the two packages' objects: dataclasses field
    by field, arrays bit for bit (dtype included), enums by name/value."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, enum.Enum):
        assert (type(a).__name__, a.name, a.value) == \
            (type(b).__name__, b.name, b.value), path
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        assert a.shape == b.shape and np.array_equal(a, b), path
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{k}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b and type(a) is type(b), f"{path}: {a!r} != {b!r}"


@pytest.mark.parametrize("case", ["t106", "small_o4h", "ls89"])
def test_mesh_bit_identical(case):
    mj, mt = _meshes(case)
    assert mj.num_points == mt.num_points
    _same(mj, mt)
    np.testing.assert_array_equal(mj.flat_coords(), mt.flat_coords())


@pytest.mark.parametrize("case", ["t106", "small_o4h", "ls89"])
def test_classify_plan_glue_identical(case):
    mj, mt = _meshes(case)
    ij, it = jax_classify(mj), classify(mt)
    _same(ij, it)
    pj, pt = jax_build_plan(mj, ij), build_plan(mt, it)
    _same(pj, pt)
    gj = jax_build_glue(mj, ij, pj.N, pj.M, transposed=pj.transposed,
                        keep_boundaries=True)
    gt = build_glue(mt, it, pt.N, pt.M, transposed=pt.transposed,
                    keep_boundaries=True)
    _same(gj, gt)


def test_plan_tensors_of_both_plans_equal():
    mj, mt = _meshes("small_o4h")
    pj = jax_build_plan(mj, jax_classify(mj))
    pt = build_plan(mt, classify(mt))
    tj, tt = plan_tensors(pj, "cpu"), plan_tensors(pt, "cpu")
    assert tj.keys() == tt.keys() == {"p64", "p32"}
    for prec in ("p64", "p32"):
        assert tj[prec].keys() == tt[prec].keys()
        for k, v in tj[prec].items():
            w = tt[prec][k]
            assert v.dtype == w.dtype and torch.equal(v, w), (prec, k)
    # dtypes and values against the plan's arrays
    for k, v in tj["p64"].items():
        arr = getattr(pj, k, None)
        if arr is None:  # derived entries (c_seg_pos)
            continue
        kind = np.asarray(arr).dtype.kind
        want = {"b": torch.bool, "i": torch.int64, "u": torch.int64,
                "f": torch.float64}[kind]
        assert v.dtype == want, k
        np.testing.assert_array_equal(v.numpy(), arr)
        if kind == "f":
            np.testing.assert_array_equal(tj["p32"][k].numpy(),
                                          np.asarray(arr, np.float32))
    np.testing.assert_array_equal(tj["p64"]["c_seg_pos"].numpy(),
                                  np.flatnonzero(pj.c_seg_valid))
    # the f32 twin shares the index/mask tensors and rounds the floats
    p64, p32 = tt["p64"], tt["p32"]
    assert p32["c_row"] is p64["c_row"]
    assert p32["l_weight"].dtype == torch.float32
    np.testing.assert_array_equal(p32["sl_off"].numpy(),
                                  pt.sl_off.astype(np.float32))


def _no_jax_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_subprocess_imports_no_jax(tmp_path):
    cfg = tmp_path / "small.json"
    cfg.write_text(json.dumps(SMALL_O4H))
    out = tmp_path / "small.npz"
    code = (
        "import sys\n"
        "import turbomesh_tpu_torch\n"
        "from turbomesh_tpu_torch import cli\n"
        f"rc = cli.main([{str(cfg)!r}, '--base-dir', {str(ROOT)!r},\n"
        "              '--device', 'cpu', '--solver', 'device',\n"
        f"              '--iterations', '1', '--output', {str(out)!r}])\n"
        "assert 'jax' not in sys.modules, 'the port imported jax'\n"
        "sys.exit(rc)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=_no_jax_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "wrote" in res.stdout
    from turbomesh_tpu_torch.io.npz import read_npz

    names, blocks = read_npz(str(out))
    assert len(blocks) == 8
    assert all(np.isfinite(b).all() for b in blocks)


def test_chip_smoke_imports_no_jax_and_refuses_without_card(tmp_path):
    # importing the script (and the whole port) pulls in no jax
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import chip_smoke\n"
            "import turbomesh_tpu_torch.smoothing.smooth\n"
            "import turbomesh_tpu_torch.smoothing.device\n"
            "import turbomesh_tpu_torch.ops.zebra\n"
            "assert 'jax' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], env=_no_jax_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal path is not taken")
    # without a card the script exits nonzero and prints no result, both
    # in the checkout and alone in an empty directory
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_cli_device_cuda_raises_without_card(tmp_path):
    from turbomesh_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tmp_path / "small.json"
    cfg.write_text(json.dumps(SMALL_O4H))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(cfg), "--base-dir", str(ROOT), "--iterations", "0"])
