"""Shared build step of the port's CUDA kernels.

Every kernel source ``csrc/<name>.cu`` exposes a plain C entry point. It is
compiled with nvcc for Hopper (``sm_90a``) into a shared library under
``build/turbomesh_tpu_torch/`` beside the package, named by the hash of
the source and the flags, and loaded with ctypes. Nothing builds at
import: a wrapper calls ``load_library`` at its first launch on a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "turbomesh_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin)")
    return path


def build_library(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` into a shared library (once per source
    version: the file name carries the hash of source and flags). Returns
    its path; raises with nvcc's output when the build fails."""
    src_path = CSRC / f"{name}.cu"
    src = src_path.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src_path)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src_path.name} "
                               f"({res.returncode}):\n{res.stdout}\n"
                               f"{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; idempotent.

    ``signatures`` maps each C entry point to its argtypes (pointers and
    the stream as ``c_void_p``, so ctypes does not cut them to 32 bits);
    every entry point returns the launch's cudaError as an int."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(name)))
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check_launch(what: str, err: int) -> None:
    """Raise when a C entry point reports a failed launch."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
