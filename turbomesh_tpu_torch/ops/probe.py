"""Build-and-launch probe: ``o = i + 1`` on one (8, 128) f32 tile.

Counterpart of the probe kernel inside
turbomesh_tpu/ops/zebra.py ``pallas_service_ok``. There it decided whether
the Pallas kernels ran at all; here it decides nothing. ``probe`` launches
the hand-written kernel ``csrc/probe.cu`` for a CUDA tensor and raises
when the build or the launch fails; a CPU tensor runs the plain version
``probe_ref``. chip_smoke.py launches it first, so a broken toolchain
shows before any real work.
"""

from __future__ import annotations

import torch

from . import _build

#: kernel launches since the last reset
PROBE_LAUNCHES = 0

#: the probe's tile, as in the TPU kernel
SHAPE = (8, 128)

_ENTRY = None   # the loaded entry point


def load_library():
    """Build (if needed) and load csrc/probe.cu; idempotent."""
    return _build.load_library("probe")


def probe_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x + 1``."""
    return x + 1.0


def probe(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` for a contiguous f32 tensor: the kernel on a CUDA tensor
    (or raise), the plain version on a CPU tensor."""
    global PROBE_LAUNCHES, _ENTRY
    if x.dtype is not torch.float32:
        raise TypeError(f"probe takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("probe takes a contiguous tensor")
    if not x.is_cuda:
        if x.is_cpu:
            return probe_ref(x)
        raise RuntimeError(f"probe: unsupported device {x.device}")
    if _ENTRY is None:
        _ENTRY = load_library().probe_add_one
    out = torch.empty_like(x)
    _build.launch(_ENTRY, x.get_device(), x.data_ptr(), out.data_ptr(),
                  x.numel())
    PROBE_LAUNCHES += 1
    return out


def check_card(device) -> None:
    """Launch the probe once on ``device`` (a CUDA device) and raise unless
    the result is exactly ``i + 1``."""
    x = torch.arange(SHAPE[0] * SHAPE[1], dtype=torch.float32,
                     device=device).reshape(SHAPE)
    out = probe(x)
    if not torch.equal(out.cpu(), x.cpu() + 1.0):
        raise RuntimeError("probe kernel: output is not input + 1")
