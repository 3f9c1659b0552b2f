"""The port's kernel launch path (turbomesh_tpu_torch.ops._build.launch).

On the CPU: the launch helper hands an entry point its arguments, the
device ordinal and the current stream in that order and raises on a
failed launch; the wrappers never reach it for CPU tensors; the binding
of ``csrc/launch.cuh``, built with the host's C++ compiler against a
stand-in CUDA runtime header, converts Python arguments to the entry
point's parameter types and rejects the wrong ones. On a card
(``cuda``-marked): every kernel (K-W on the small O4H mesh) launches on
PyTorch's current stream, a non-default one included, and agrees there
with its plain version.
"""

import pathlib
import shutil
import subprocess
import sysconfig
import textwrap

import numpy as np
import pytest
import torch

from turbomesh_tpu_torch.ops import _build, chain, probe, sor, winslow, zebra

from chip_smoke import zebra_inputs
from test_torch_chain import ragged_table
from test_torch_winslow import _cached, _operands

# A stand-in for cuda_runtime.h: four devices, the current one in a static.
_FAKE_RUNTIME = """
#pragma once
typedef int cudaError_t;
const cudaError_t cudaSuccess = 0;
static int current = 0;
inline cudaError_t cudaGetDevice(int* d) { *d = current; return 0; }
inline cudaError_t cudaSetDevice(int d) {
  if (d < 0 || d >= 4) return 101;  // cudaErrorInvalidDevice
  current = d;
  return 0;
}
"""

# An entry point of the kernels' shape that writes what it was given.
_FAKE_SOURCE = """
#include <cstdint>
#include <cuda_runtime.h>
#include "launch.cuh"
namespace {
template <typename T>
int echo(const T* in, T* out, long n, double w, int device, void* stream) {
  turbomesh::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  out[0] = in[0] + 1;
  out[1] = (T)n;
  out[2] = (T)w;
  out[3] = (T)device;
  out[4] = (T)reinterpret_cast<std::uintptr_t>(stream);
  out[5] = (T)current;
  return 0;
}
int current_device() { return current; }
}  // namespace
static PyMethodDef methods[] = {
    turbomesh::method<echo<float>>("echo_f32"),
    turbomesh::method<echo<double>>("echo_f64"),
    turbomesh::method<current_device>("current_device"),
    {nullptr, nullptr, 0, nullptr}};
TURBOMESH_MODULE(fake_kernels, methods)
"""


@pytest.fixture(scope="module")
def fake_kernels(tmp_path_factory):
    """launch.cuh's binding around ``echo``, built by the host's C++
    compiler (the kernels themselves need nvcc and a card)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    include = sysconfig.get_paths()["include"]
    if cxx is None or not (pathlib.Path(include) / "Python.h").exists():
        pytest.skip("needs a host C++ compiler and Python's headers")
    tmp = tmp_path_factory.mktemp("binding")
    (tmp / "cuda_runtime.h").write_text(_FAKE_RUNTIME)
    (tmp / "fake.cpp").write_text(textwrap.dedent(_FAKE_SOURCE))
    out = tmp / "fake_kernels.so"
    res = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                          f"-I{tmp}", f"-I{_build.CSRC}", f"-I{include}",
                          "-o", str(out), str(tmp / "fake.cpp")],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return _build.import_extension("fake_kernels", out)


class _Entry:
    """Stands in for a kernel entry point: records its arguments."""

    __name__ = "fake_entry"

    def __init__(self, err=0):
        self.err = err
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


def test_launch_passes_device_and_current_stream(monkeypatch):
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    entry = _Entry()
    _build.launch(entry, 3, 11, 22, 33)
    assert entry.calls == [(11, 22, 33, 3, 1003)]


def test_launch_raises_on_a_failed_launch(monkeypatch):
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    with pytest.raises(RuntimeError, match="fake_entry launch failed: "
                                           "cudaError 9"):
        _build.launch(_Entry(err=9), 0, 1)


def test_cpu_tensors_never_reach_the_launch_path(monkeypatch):
    def no_launch(*args):
        raise AssertionError("launch reached from a CPU tensor")

    monkeypatch.setattr(_build, "launch", no_launch)
    x = torch.ones(probe.SHAPE)
    assert torch.equal(probe.probe(x), x + 1.0)
    rng = np.random.default_rng(0)
    ops = [torch.as_tensor(rng.standard_normal((2, 9, 7)).astype(np.float32))
           for _ in range(13)]
    for axis in (0, 1):
        got = zebra.zebra_half_sweep(*ops, axis=axis)
        want = zebra.zebra_half_sweep_ref(*ops, axis=axis)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    base = torch.as_tensor(rng.standard_normal((6, 5, 2)))
    mask = torch.zeros(6, 5, dtype=torch.bool)
    mask[1:-1, 1:-1] = True
    assert torch.equal(sor.red_black_sor(base, 0 * base, base, mask, 1.5, 2),
                       sor.red_black_sor_ref(base, 0 * base, base, mask, 1.5,
                                             2))
    ch, p32, vflat, zf = ragged_table(0, [5, 1, 3], P=20)
    args = (ch, p32["c_seg"], p32["c_seg_valid"], p32["c_seg_pos"],
            p32["c_row"], vflat)
    assert torch.equal(chain.chain_solve(*args, zf.clone()),
                       chain.chain_solve_ref(*args, zf.clone()))
    t = _cached("small", "cpu")[0]._winslow
    V, cf, cG, b, G, scale = _operands(_cached("small", "cpu"),
                                       torch.float64, True, 0)
    assert torch.equal(
        winslow.winslow_apply(t, V, cf, cG, 1.0, base=b, scale=scale),
        winslow.winslow_apply_ref(t, V, cf, cG, 1.0, base=b, scale=scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_binding_converts_arguments(fake_kernels, monkeypatch, dtype):
    """Through ``_build.launch``: pointers (the data of CPU tensors), a
    long, a double, the device ordinal and the stream arrive as the entry
    point's parameters; the guard switches device for the call and
    restores it after."""
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 4096 + index, raising=False)
    entry = (fake_kernels.echo_f32 if dtype == torch.float32
             else fake_kernels.echo_f64)
    x = torch.full((6,), 2.5, dtype=dtype)
    out = torch.zeros(6, dtype=dtype)
    _build.launch(entry, 2, x.data_ptr(), out.data_ptr(), 123456, 1.5)
    assert out.tolist() == [3.5, 123456.0, 1.5, 2.0, 4098.0, 2.0]
    assert fake_kernels.current_device() == 0


def test_binding_reports_a_failed_launch(fake_kernels, monkeypatch):
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    x = torch.zeros(6)
    with pytest.raises(RuntimeError, match="echo_f32 launch failed: "
                                           "cudaError 101"):
        _build.launch(fake_kernels.echo_f32, 7, x.data_ptr(), x.data_ptr(),
                      1, 1.0)
    assert x.tolist() == [0.0] * 6


@pytest.mark.parametrize("args, message", [
    ((1, 2, 3), "takes 6 arguments, got 3"),
    ((1.5, 2, 3, 1.0, 0, 0), "integer"),
    ((1, 2, 3, "w", 0, 0), "real number"),
    ((1, 2, 2 ** 70, 1.0, 0, 0), "too large"),
])
def test_binding_rejects_wrong_arguments(fake_kernels, args, message):
    with pytest.raises((TypeError, OverflowError), match=message):
        fake_kernels.echo_f32(*args)


@pytest.mark.cuda
def test_kernels_launch_on_the_current_stream():
    """Each kernel launched inside ``torch.cuda.stream(s)`` runs on s: with
    the default stream held busy, its result is read back on s, right,
    while the default stream is still busy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x = torch.randn(probe.SHAPE, device="cuda")
    zops = zebra_inputs(torch, (4, 70, 200), seed=3)
    u = torch.linspace(0.0, 1.0, 64, dtype=torch.float64, device="cuda")
    base = torch.stack(torch.meshgrid(u, u, indexing="ij"), -1)
    mask = torch.zeros(64, 64, dtype=torch.bool, device="cuda")
    mask[1:-1, 1:-1] = True
    x0 = base + 0.003 * torch.randn_like(base) * mask[..., None]
    cf = 0.1 * torch.randn_like(base)
    ch, p32, vflat, zf = ragged_table(3, [39, 149, 9], device="cuda")
    cargs = (ch, p32["c_seg"], p32["c_seg_valid"], p32["c_seg_pos"],
             p32["c_row"], vflat)
    case = _cached("small", "cuda")
    t = case[0]._winslow
    V, wcf, cG, _, G, _ = _operands(case, torch.float32, False, 1)
    launches = {"probe": lambda: [probe.probe(x)],
                "zebra0": lambda: list(zebra.zebra_half_sweep(*zops, axis=0)),
                "zebra1": lambda: list(zebra.zebra_half_sweep(*zops, axis=1)),
                "sor": lambda: [sor.red_black_sor(base, cf, x0, mask, 1.5, 3)],
                "chain": lambda: [chain.chain_solve(*cargs, zf.clone())],
                "winslow": lambda: [winslow.winslow_apply(t, V, wcf, cG, 0.0,
                                                          G=G)]}
    plain = {"probe": lambda: [probe.probe_ref(x)],
             "zebra0": lambda: list(zebra.zebra_half_sweep_ref(*zops, axis=0)),
             "zebra1": lambda: list(zebra.zebra_half_sweep_ref(*zops, axis=1)),
             "sor": lambda: [sor.red_black_sor_ref(base, cf, x0, mask, 1.5,
                                                   3)],
             "chain": lambda: [chain.chain_solve_ref(*cargs, zf.clone())],
             "winslow": lambda: [winslow.winslow_apply_ref(t, V, wcf, cG, 0.0,
                                                           G=G)]}
    # the first launch of a kernel loads its module, which may wait for
    # the whole device (CUDA's lazy loading): load each one first
    for launch in launches.values():
        launch()
    s = torch.cuda.Stream()
    for name, launch in launches.items():
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)  # about a second on the default
        with torch.cuda.stream(s):
            got = [t.cpu() for t in launch()]
        assert not torch.cuda.default_stream().query(), \
            f"{name}: the launch waited for the default stream"
        torch.cuda.synchronize()
        want = [t.cpu() for t in plain[name]()]
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
