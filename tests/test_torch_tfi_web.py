"""The port's bulk TFI, torch_trace and browser service.

``tfi.blended_tfi`` / ``linear_tfi`` on torch tensors: the three TFI tests
of tests/test_foundation.py, and both functions against the JAX ones at
f64 roundoff (1e-14) on random perturbed boundaries. The service
(``turbomesh_tpu_torch.web``) on the CPU: the two service tests of
tests/test_frontends.py, with block points bit for bit against a direct
run of the port's pipeline. ``profiling.torch_trace`` writes a Chrome
trace, and is a no-op on None.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from turbomesh_tpu import tfi as jtfi

from turbomesh_tpu_torch import input as input_mod
from turbomesh_tpu_torch import profiling, tfi, web
from turbomesh_tpu_torch.clustering import Roberts, Uniform
from turbomesh_tpu_torch.smoothing import smooth_mesh

from test_frontends import TINY_CFG
from test_torch_frontend import ROOT

torch.set_num_threads(1)


# --- bulk TFI ------------------------------------------------------------------

def _rect(n, m, s, t):
    return (np.stack([s, np.zeros(n)], 1), np.stack([s, np.ones(n)], 1),
            np.stack([np.zeros(m), t], 1), np.stack([np.ones(m), t], 1))


def test_blended_tfi_unit_square_uniform():
    n, m = 5, 4
    s = Uniform()(n)
    t = Uniform()(m)
    out = tfi.blended_tfi(*_rect(n, m, s, t), s, s, t, t)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float64
    expect = np.stack(np.meshgrid(s, t, indexing="ij"), axis=-1)
    np.testing.assert_allclose(out.numpy(), expect, atol=1e-14)


def test_blended_tfi_respects_boundary_clustering():
    n, m = 9, 5
    s = Roberts(alpha=0.5, beta=1.05)(n)
    t = Uniform()(m)
    out = tfi.blended_tfi(*_rect(n, m, s, t), s, s, t, t).numpy()
    for j in range(m):
        np.testing.assert_allclose(out[:, j, 0], s, atol=1e-13)


def _perturbed(n, m, seed, amp=0.05):
    """Gently perturbed boundaries of the unit square, corners shared."""
    rng = np.random.default_rng(seed)
    s = Uniform()(n)
    t = Uniform()(m)
    x_i_min = np.stack([s, amp * rng.standard_normal(n)], 1)
    x_i_max = np.stack([s, 1.0 + amp * rng.standard_normal(n)], 1)
    x_i_min[0] = (0, 0); x_i_min[-1] = (1, 0)
    x_i_max[0] = (0, 1); x_i_max[-1] = (1, 1)
    x_j_min = np.stack([amp * rng.standard_normal(m), t], 1)
    x_j_max = np.stack([1.0 + amp * rng.standard_normal(m), t], 1)
    x_j_min[0] = (0, 0); x_j_min[-1] = (0, 1)
    x_j_max[0] = (1, 0); x_j_max[-1] = (1, 1)
    return (x_i_min, x_i_max, x_j_min, x_j_max), s, t


def test_linear_tfi_matches_blended_on_uniform():
    edges, s, t = _perturbed(6, 7, 0)
    a = tfi.blended_tfi(*edges, s, s, t, t).numpy()
    b = tfi.linear_tfi(*edges).numpy()
    np.testing.assert_allclose(a, b, atol=1e-13)


@pytest.mark.parametrize("seed", [1, 2])
def test_bulk_tfi_matches_jax(seed):
    """Both functions on tensors against the JAX ones on the same arrays:
    f64 roundoff (1e-14), with clustered, differing rail parameters."""
    n, m = 41, 23
    edges, _, _ = _perturbed(n, m, seed)
    rng = np.random.default_rng(seed + 10)
    s1 = Roberts(alpha=0.5, beta=1.05)(n)
    s2 = np.sort(np.concatenate([[0.0, 1.0], rng.uniform(0, 1, n - 2)]))
    t1 = Roberts(alpha=0.0, beta=1.1)(m)
    t2 = Uniform()(m)
    args = edges + (s1, s2, t1, t2)
    got = tfi.blended_tfi(*(torch.as_tensor(a) for a in args)).numpy()
    want = np.asarray(jtfi.blended_tfi(*args))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    got = tfi.linear_tfi(*(torch.as_tensor(a) for a in edges)).numpy()
    want = np.asarray(jtfi.linear_tfi(*edges))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    assert np.abs(want[1:-1, 1:-1]).max() > 0.1


# --- torch_trace -----------------------------------------------------------------

def test_torch_trace_writes_a_trace(tmp_path):
    with profiling.torch_trace(str(tmp_path / "tr")) as prof:
        x = torch.arange(10.0)
        (x * 2 + 1).sum()
    path = tmp_path / "tr" / "trace.json"
    assert path.exists()
    trace = json.loads(path.read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mul" in names and "aten::sum" in names
    assert any(e.name == "aten::mul" for e in prof.events())
    with profiling.torch_trace(None) as prof:
        assert prof is None
    assert sorted(os.listdir(tmp_path)) == ["tr"]


# --- browser service -------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=300).read())


def _direct(cfg, iterations=0):
    """The port's pipeline run directly: template, then the smoother."""
    inp = input_mod.load(cfg, base_dir=str(ROOT))
    mesh = inp.template.run(inp.geometry)
    if iterations:
        smooth_mesh(mesh, iterations=iterations, solver=inp.smoothing.solver,
                    wall_control_function=inp.smoothing.wall_control_function,
                    device="cpu")
    return mesh


def _block_points(base, b, mesh):
    size = json.loads(_get(f"{base}/block/{b}/size"))
    ni, nj = mesh.blocks[b].size
    assert (size["i"], size["j"]) == (ni, nj)
    raw = _get(f"{base}/block/{b}/points")
    return np.frombuffer(raw, dtype="<f8").reshape(ni, nj, 2)


def test_web_service_roundtrip():
    httpd = web.serve(port=0, base_dir=str(ROOT), device="cpu")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        out = _post(f"{base}/run", json.dumps(TINY_CFG).encode())
        assert out["blocks"] == 8
        assert json.loads(_get(f"{base}/blocks"))["count"] == 8
        mesh = _direct(TINY_CFG)
        for b in (0, 7):
            np.testing.assert_array_equal(_block_points(base, b, mesh),
                                          mesh.blocks[b].points)
        assert b"<canvas" in _get(f"{base}/")
        assert _post(f"{base}/free", b"") == {"ok": True}
        assert json.loads(_get(f"{base}/blocks"))["count"] == 0
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"{base}/block/0/size")
        assert exc.value.code == 404
    finally:
        httpd.shutdown()


def test_web_service_run_with_smoothing():
    """POST /run with 2 White iterations of the device solver on the CPU:
    the block points equal a direct smooth_mesh run bit for bit, and moved
    from the unsmoothed mesh."""
    cfg = dict(TINY_CFG)
    cfg["smoothing"] = {"iterations": 2, "solver": "device",
                        "wall_control_function": {
                            "white": {"ds_target": 1e-4}}}
    httpd = web.serve(port=0, base_dir=str(ROOT), device="cpu")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        out = _post(f"{base}/run", json.dumps(cfg).encode())
        assert out["blocks"] == 8
        assert any("residual" in line for line in out["log"]), out["log"][:5]
        smoothed, tfi_mesh = _direct(cfg, 2), _direct(TINY_CFG)
        for b in range(8):
            got = _block_points(base, b, smoothed)
            np.testing.assert_array_equal(got, smoothed.blocks[b].points)
        assert np.abs(got - tfi_mesh.blocks[7].points).max() > 0
    finally:
        httpd.shutdown()


def test_web_service_defaults_to_cuda(monkeypatch):
    """serve() and the entry point default to the card and raise without
    one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        web.serve(port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        web.main(["--port", "0"])
    assert web.MeshService().device == "cuda"
