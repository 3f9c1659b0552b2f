"""Transfinite interpolation (TFI) for block node placement.

Reference parity: src/core/tfi.zig
  - linear2dBoundaryBlendedControlFunction    (tfi.zig:112-208;
    Thompson, Handbook of Grid Generation ch. 3.5.1 + 3.6.5)

The reference fills each block with an Ni x Nj double loop; here the whole
block is one closed-form broadcasted expression: NumPy for template node
placement (``blended_tfi_np``), torch tensors on any device for bulk
generation (``blended_tfi``, ``linear_tfi``). Operation order matches the
reference's projector sum u_ij + v_ij - uv_ij so results agree to f64
roundoff.

Edge naming (mirrors the reference's Side convention, boundary.zig:8-13):
  x_i_min : (Ni, 2) row j = 0          s1 : clustering along i at j = 0
  x_i_max : (Ni, 2) row j = Nj-1       s2 : clustering along i at j = Nj-1
  x_j_min : (Nj, 2) column i = 0       t1 : clustering along j at i = 0
  x_j_max : (Nj, 2) column i = Ni-1    t2 : clustering along j at i = Ni-1
"""

from __future__ import annotations

import numpy as np
import torch

from .types import EDGE_MERGE_TOL


def _blended_tfi_impl(x_i_min, x_i_max, x_j_min, x_j_max, s1, s2, t1, t2):
    s1 = s1[:, None]  # (Ni, 1)
    s2 = s2[:, None]
    t1 = t1[None, :]  # (1, Nj)
    t2 = t2[None, :]

    denom = 1.0 - (s2 - s1) * (t2 - t1)
    u = ((1.0 - t1) * s1 + t1 * s2) / denom
    v = ((1.0 - s1) * t1 + s1 * t2) / denom

    x_0_0 = x_i_min[0]  # (2,)
    x_n_0 = x_i_min[-1]
    x_0_m = x_j_min[-1]
    x_n_m = x_i_max[-1]

    u_ = u[:, :, None]
    v_ = v[:, :, None]

    u_ij = (1.0 - u_) * x_j_min[None, :, :] + u_ * x_j_max[None, :, :]
    v_ij = (1.0 - v_) * x_i_min[:, None, :] + v_ * x_i_max[:, None, :]
    uv_ij = (
        (u_ * v_) * x_n_m
        + (u_ * (1.0 - v_)) * x_n_0
        + ((1.0 - u_) * v_) * x_0_m
        + ((1.0 - u_) * (1.0 - v_)) * x_0_0
    )
    return (u_ij + v_ij) - uv_ij


def blended_tfi_np(x_i_min, x_i_max, x_j_min, x_j_max, s1, s2, t1, t2):
    """Boundary-blended TFI evaluated with NumPy (one rounding per op, no
    FMA/reassociation). This is the node-placement path used by the blocking
    templates: plain NumPy matches the reference's sequential scalar
    evaluation to 1 ulp, which the reference's 1e-15 connection-coincidence
    check (smooth.zig:221) needs.
    """
    return _blended_tfi_impl(
        np.asarray(x_i_min), np.asarray(x_i_max), np.asarray(x_j_min),
        np.asarray(x_j_max), np.asarray(s1), np.asarray(s2), np.asarray(t1),
        np.asarray(t2),
    )


def _tensors(*arrays):
    """Tensors on the device of the first tensor among ``arrays`` (the CPU
    when none is one); array-likes are converted there."""
    dev = next((a.device for a in arrays if isinstance(a, torch.Tensor)),
               torch.device("cpu"))
    return [torch.as_tensor(a, device=dev) for a in arrays]


def blended_tfi(x_i_min, x_i_max, x_j_min, x_j_max, s1, s2, t1, t2):
    """Boundary-blended-control-function TFI (tfi.zig:112-208) on torch
    tensors, on any device.

    Returns the full (Ni, Nj, 2) block including boundary rows/columns
    (the reference evaluates the formula everywhere, not just the interior).
    Use for bulk mesh generation; for template node placement feeding the
    1e-15 topology checks use blended_tfi_np.
    """
    return _blended_tfi_impl(*_tensors(x_i_min, x_i_max, x_j_min, x_j_max,
                                       s1, s2, t1, t2))


def linear_tfi(x_i_min, x_i_max, x_j_min, x_j_max):
    """Plain bilinear TFI with uniform parameters (tfi.zig:19-67) on torch
    tensors, on any device.

    NOTE the reference's argument convention here differs from the blended
    variant: edge_i_min/i_max index along i with xi = i/(Ni-1) and are blended
    in the *v* direction; corners are taken from the i edges.
    """
    x_i_min, x_i_max, x_j_min, x_j_max = _tensors(x_i_min, x_i_max, x_j_min,
                                                  x_j_max)
    ni = x_i_min.shape[0]
    nj = x_j_min.shape[0]
    kw = dict(dtype=x_i_min.dtype, device=x_i_min.device)
    xi = (torch.arange(ni, **kw) / (ni - 1))[:, None, None]
    eta = (torch.arange(nj, **kw) / (nj - 1))[None, :, None]

    c00 = x_i_min[0]
    c10 = x_i_min[-1]
    c01 = x_i_max[0]
    c11 = x_i_max[-1]

    u_ij = (1.0 - xi) * x_j_min[None, :, :] + xi * x_j_max[None, :, :]
    v_ij = (1.0 - eta) * x_i_min[:, None, :] + eta * x_i_max[:, None, :]
    uv_ij = (
        xi * eta * c11
        + xi * (1.0 - eta) * c10
        + (1.0 - xi) * eta * c01
        + (1.0 - xi) * (1.0 - eta) * c00
    )
    return u_ij + v_ij - uv_ij


def check_corner_consistency(x_i_min, x_i_max, x_j_min, x_j_max, tol=EDGE_MERGE_TOL):
    """Corner coincidence asserts mirrored from tfi.zig:150-162."""
    pairs = [
        (x_i_min[0], x_j_min[0]),
        (x_i_min[-1], x_j_max[0]),
        (x_j_min[-1], x_i_max[0]),
        (x_i_max[-1], x_j_max[-1]),
    ]
    for a, b in pairs:
        if not np.all(np.abs(np.asarray(a) - np.asarray(b)) <= tol):
            raise ValueError(f"TFI corner mismatch: {a} vs {b}")
