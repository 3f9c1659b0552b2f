"""Shared build and launch steps of the port's CUDA kernels.

Every kernel source ``csrc/<name>.cu`` is a Python extension module whose
functions are its entry points (``csrc/launch.cuh``). It is compiled with
nvcc for Hopper (``sm_90a``) against this Python's headers into
``build/turbomesh_tpu_torch/`` beside the package, named by the hash of
the sources, the flags and the Python ABI, and loaded by path. Nothing
builds at import: a wrapper calls ``load_library`` at its first launch on
a CUDA tensor, and keeps the entry point in a module-level name.

``launch`` is the one launch path of all wrappers: it hands the entry
point the device ordinal of the tensors (the entry point makes that device
current only when it is not) and PyTorch's current stream on that device,
looked up at every call, and raises when the launch failed.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sysconfig
import tempfile
from importlib.machinery import ExtensionFileLoader

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "turbomesh_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# ptxas's resource report; it does not change the code
_REPORT_FLAGS = ["-Xptxas", "-v"]

_MODULES: dict[str, object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin)")
    return path


def _python_include() -> str:
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(f"Python.h not found in {include}: the kernels "
                           f"build as extension modules of this Python")
    return include


def build_library(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` into an extension module (once per
    version of the sources: the file name carries the hash of the source,
    the shared headers ``csrc/*.cuh``, the flags and the Python ABI).
    ptxas's report of registers, shared memory and spills goes to
    ``log_path(library)``. Returns the module's path; raises with nvcc's
    output when the build fails."""
    src_path = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src_path.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(sysconfig.get_config_var("EXT_SUFFIX").encode())
    out = BUILD_DIR / f"{name}_{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, *_REPORT_FLAGS,
               f"-I{_python_include()}", "-o", tmp, str(src_path)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src_path.name} "
                               f"({res.returncode}):\n{res.stdout}\n"
                               f"{res.stderr}")
        log_path(out).write_text(res.stdout + res.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def log_path(library: pathlib.Path) -> pathlib.Path:
    """Where ``build_library`` keeps nvcc's output for ``library``."""
    return library.with_suffix(".log")


def load_library(name: str):
    """Build (if needed) and import the extension module of
    ``csrc/<name>.cu``; idempotent. Its functions are the entry points:
    each takes its pointers, the device ordinal and the stream as ints and
    returns the launch's cudaError as an int."""
    module = _MODULES.get(name)
    if module is None:
        module = _MODULES[name] = import_extension(name, build_library(name))
    return module


def import_extension(name: str, path: pathlib.Path):
    """Import the extension module ``name`` (its ``PyInit_<name>``) from
    the shared library at ``path``."""
    loader = ExtensionFileLoader(name, str(path))
    spec = importlib.util.spec_from_loader(name, loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


def launch(entry, device_index: int, *args) -> None:
    """Call the entry point ``entry(*args, device_index, stream)`` on
    PyTorch's current stream of that device; raise if the launch failed.

    The stream comes from ``torch._C._cuda_getCurrentRawStream``, the
    getter that PyTorch's own generated kernel launchers call
    (``torch._inductor``), in place of the public
    ``torch.cuda.current_stream(i).cuda_stream``: the public call builds a
    Stream object and costs 2.4-3.8 us a launch on the host of an H100
    machine, more than the probe kernel's whole launch (PERF.md). It is
    looked up at every launch, so a kernel follows ``torch.cuda.stream``."""
    err = entry(*args, device_index,
                torch._C._cuda_getCurrentRawStream(device_index))
    if err:
        raise RuntimeError(f"{entry.__name__} launch failed: cudaError {err}")
