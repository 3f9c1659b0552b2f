"""The V-cycle's correction glue on the zebra planes, K-G.

``glue_planes`` glues one multigrid level's correction field (the
single-device ``multigrid.MapGlue.correction``) and returns it as the two
ghost-framed f32 planes (B, N + 2, M + 2) that the zebra kernel reads, from
either form of its input: the level's (B, N, M, 2) field (the first
half-sweep of a smooth) or the two framed planes that the zebra kernel
wrote (every later one), whose interiors are read through the level's
smooth mask as the V-cycle's ``torch.where`` did between the half-sweeps.

It reads the level's ``GlueTables``: one byte a framed point (``OFF``,
``ON`` the smooth mask, ``DEST`` written by one glue entry), the copy
entries (dst, src) with their weights and the junction masters (dst,
members) with theirs, all built once a mesh (``build_tables``, checked by
``check_tables``) from ``multigrid.prep_glue_arrays``' unique-destination
maps.

A CUDA tensor launches the hand-written kernel ``csrc/glue.cu`` (one
launch a call, ``GLUE_LAUNCHES``) or raises; a CPU tensor runs the plain
version ``glue_planes_ref``, ``MapGlue.correction``'s arithmetic over the
tables' index sets, which the kernel equals bit for bit on the card.
``frame_planes`` (the field framed by zeros, as two planes) and
``unframe_planes`` (the masked field from two framed planes) are the
V-cycle's two other reshapings around the zebra kernel, from the same
module; they count no launch.

It ports no Pallas kernel: the JAX package leaves the glue to XLA
(turbomesh_tpu/smoothing/multigrid.py ``_glue_correction``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

#: glue launches since the last reset (the tests, chip_smoke.py and the
#: preconditioner's CUDA graph read it to show that the V-cycle's smooths
#: went through the kernel: one a zebra half-sweep)
GLUE_LAUNCHES = 0

#: the per-point byte table: off the smooth mask (a ghost, or an interior
#: point the V-cycle does not smooth), on it, a glue destination
OFF, ON, DEST = 0, 1, 2

_ENTRIES = {}   # the loaded entry points, by name


def load_library():
    """Build (if needed) and load the kernel library; idempotent."""
    return _build.load_library("glue")


def _entry(name):
    entry = _ENTRIES.get(name)
    if entry is None:
        entry = _ENTRIES[name] = getattr(load_library(), name)
    return entry


def _framed(mask):
    """The smooth mask (B, N, M) on the ghost-framed points, flat."""
    B, N, M = mask.shape
    framed = np.zeros((B, N + 2, M + 2), dtype=bool)
    framed[:, 1:-1, 1:-1] = mask
    return framed.reshape(-1)


def build_tables(mask, cdst, csrc, jdst, jsrc):
    """K-G's tables of one level, as numpy arrays: ``code`` (B * (N + 2) *
    (M + 2),) uint8 (OFF, ON, DEST), ``copy`` (E, 2) int32 (dst, src) and
    ``junction`` (L, 1 + K) int32 (dst, members), from the level's smooth
    mask (B, N, M) and the correction glue's unique-destination maps
    (flat indices into the ghost-framed stack); checked by
    ``check_tables``."""
    mask = np.asarray(mask, dtype=bool)
    code = _framed(mask).astype(np.uint8)   # ON = 1 on the mask, else OFF
    copy = np.stack([cdst, csrc], axis=-1).astype(np.int32)
    junction = np.concatenate([np.asarray(jdst)[:, None], jsrc],
                              axis=1).astype(np.int32)
    dst = np.concatenate([copy[:, 0], junction[:, 0]])
    if dst.size and (dst.min() < 0 or dst.max() >= code.size):
        raise ValueError("glue tables: a destination outside the frame")
    if (code[dst] == ON).any():
        raise ValueError("glue tables: a destination on the smooth mask")
    code[dst] = DEST
    check_tables(code, copy, junction, mask)
    return code, copy, junction


def check_tables(code, copy, junction, mask):
    """Raise ValueError unless the tables give every framed point of
    ``mask``'s stack exactly one writer, as the kernel needs: ``code`` ON
    exactly on the smooth mask, DEST exactly at the entries'
    destinations, each destination one entry's and off the mask, every
    index inside the frame."""
    mask = np.asarray(mask, dtype=bool)
    B, N, M = mask.shape
    P = B * (N + 2) * (M + 2)
    if P >= 2**31:
        raise ValueError(f"glue tables: {P} framed points do not fit int32")
    code, copy, junction = (np.asarray(code), np.asarray(copy),
                            np.asarray(junction))
    if code.shape != (P,) or code.dtype != np.uint8:
        raise ValueError(f"glue tables: code must be ({P},) uint8")
    if copy.ndim != 2 or copy.shape[1] != 2 or junction.ndim != 2:
        raise ValueError("glue tables: copy must be (E, 2), junction "
                         "(L, 1 + K)")
    for index in (copy, junction):
        if index.size and (index.min() < 0 or index.max() >= P):
            raise ValueError("glue tables: an index outside the frame")
    if code.size and code.max() > DEST:
        raise ValueError("glue tables: a code other than OFF, ON, DEST")
    if not np.array_equal(code == ON, _framed(mask)):
        raise ValueError("glue tables: ON is not the smooth mask (or a "
                         "destination lies on it)")
    written = np.zeros(P, dtype=bool)
    dst = np.concatenate([copy[:, 0], junction[:, 0]])
    written[dst] = True
    if np.count_nonzero(written) != len(dst):
        raise ValueError("glue tables: a destination written twice")
    if not np.array_equal(code == DEST, written):
        raise ValueError("glue tables: DEST is not the entries' "
                         "destinations")


class GlueTables:
    """What K-G reads of one level: ``code``, ``copy``, ``junction``
    (``build_tables``, on the level's device) and the entries' f32
    weights ``cw`` (E, 2) and ``jw`` (L, K), the same tensors as the
    level's ``MapGlue``; ``mask`` is the level's smooth mask (B, N, M)
    that ``code`` was built from. Checked once here; the kernel's pointers
    to them are kept."""

    def __init__(self, mask, code, copy, junction, cw, jw):
        if mask.dtype != torch.bool or mask.dim() != 3:
            raise ValueError("glue tables: mask must be a (B, N, M) bool "
                             "tensor")
        self.mask, self.shape = mask, tuple(mask.shape)
        self.code, self.copy, self.junction = code, copy, junction
        self.cw, self.jw = cw, jw
        B, N, M = self.shape
        E, L = copy.shape[0], junction.shape[0]
        self.K = junction.shape[1] - 1
        want = {"code": ((B * (N + 2) * (M + 2),), torch.uint8),
                "copy": ((E, 2), torch.int32),
                "junction": ((L, self.K + 1), torch.int32),
                "cw": ((E, 2), torch.float32),
                "jw": ((L, self.K), torch.float32)}
        for name, (shp, dtype) in want.items():
            t = getattr(self, name)
            if tuple(t.shape) != shp or t.dtype != dtype:
                raise ValueError(f"glue tables: {name} {tuple(t.shape)} "
                                 f"{t.dtype}, expected {shp} {dtype}")
            if not t.is_contiguous() or t.device != code.device:
                raise ValueError(f"glue tables: {name} must be contiguous "
                                 f"on {code.device}")
        self._args = (code.data_ptr(), copy.data_ptr(), cw.data_ptr(),
                      junction.data_ptr(), jw.data_ptr())
        self._sizes = (E, L, self.K)

    @property
    def nbytes(self) -> int:
        """Bytes of the point and index tables (the weights are the
        glue's)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.code, self.copy, self.junction))


def _check_field(v, shape, device, name):
    if v.dtype != torch.float32:
        raise TypeError(f"{name}: float32 expected, got {v.dtype}")
    if tuple(v.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(v.shape)}, expected {shape}")
    if not v.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")
    if v.device != device:
        raise ValueError(f"{name}: {v.device}, expected {device}")


def _check_input(v, shape, device, name):
    """Raise unless ``v`` is a (B, N, M, 2) field or a pair of framed
    (B, N + 2, M + 2) planes of ``shape`` (B, N, M), f32, contiguous, on
    ``device``; returns whether it is the field."""
    B, N, M = shape
    if isinstance(v, torch.Tensor):
        _check_field(v, (B, N, M, 2), device, name)
        return True
    if len(v) != 2:
        raise ValueError(f"{name}: a field or two planes expected")
    for p in v:
        _check_field(p, (B, N + 2, M + 2), device, name)
    return False


def glue_planes(t, v):
    """The glued correction of ``v`` as two contiguous ghost-framed planes
    (x, y), each point written once: ``v`` the level's (B, N, M, 2) field,
    or two framed planes (x, y) read through the smooth mask; ``t`` the
    level's GlueTables. CPU tensors run the plain version; CUDA tensors
    launch the kernel on PyTorch's current stream or raise."""
    global GLUE_LAUNCHES
    device = t.code.device
    field = _check_input(v, t.shape, device, "glue_planes")
    if device.type != "cuda":
        if device.type == "cpu":
            return glue_planes_ref(t, v)
        raise RuntimeError(f"glue_planes: unsupported device {device}")
    B, N, M = t.shape
    out = torch.empty((2, B, N + 2, M + 2), dtype=torch.float32,
                      device=device)
    inputs = ((v.data_ptr(), 0, 0) if field
              else (0, v[0].data_ptr(), v[1].data_ptr()))
    _build.launch(_entry("glue_planes"), out.get_device(), *inputs,
                  *t._args, out.data_ptr(), B, N + 2, M + 2, *t._sizes)
    GLUE_LAUNCHES += 1
    return out[0], out[1]


def glue_planes_ref(t, v):
    """Plain PyTorch version of ``glue_planes``: the framed field (the
    planes' values where ``code`` is ON, else 0; or the field framed by
    zeros), ``MapGlue.correction``'s gather, multiply, junction sum and
    scatter over the tables' entries, split into planes. Used on CPU
    tensors and as the reference the kernel is held against on the
    card."""
    B, N, M = t.shape
    if isinstance(v, torch.Tensor):
        vf = F.pad(v, (0, 0, 1, 1, 1, 1)).reshape(-1, 2)
    else:
        vf = torch.stack(list(v), dim=-1).reshape(-1, 2)
        vf = torch.where((t.code == ON)[:, None], vf,
                         torch.zeros((), dtype=vf.dtype, device=vf.device))
    copy, junction = t.copy.long(), t.junction.long()
    vals = t.cw * vf[copy[:, 1]]
    jvals = torch.sum(t.jw[..., None] * vf[junction[:, 1:]], dim=1)
    out = vf.index_copy(0, torch.cat([copy[:, 0], junction[:, 0]]),
                        torch.cat([vals, jvals], dim=0))
    out = out.reshape(B, N + 2, M + 2, 2)
    return out[..., 0].contiguous(), out[..., 1].contiguous()


def frame_planes(v):
    """The (B, N, M, 2) field ``v`` framed by one ghost ring of zeros, as
    two contiguous (B, N + 2, M + 2) planes. A CUDA tensor launches K-G's
    field form with no table (one launch), a CPU tensor pads."""
    if v.dim() != 4 or v.shape[-1] != 2:
        raise ValueError(f"frame_planes: (B, N, M, 2) expected, got "
                         f"{tuple(v.shape)}")
    B, N, M, _ = v.shape
    _check_field(v, (B, N, M, 2), v.device, "frame_planes")
    if not v.is_cuda:
        return (F.pad(v[..., 0], (1, 1, 1, 1)),
                F.pad(v[..., 1], (1, 1, 1, 1)))
    out = torch.empty((2, B, N + 2, M + 2), dtype=torch.float32,
                      device=v.device)
    _build.launch(_entry("glue_planes"), v.get_device(), v.data_ptr(), 0, 0,
                  0, 0, 0, 0, 0, out.data_ptr(), B, N + 2, M + 2, 0, 0, 0)
    return out[0], out[1]


def unframe_planes(x, y, mask):
    """The masked (B, N, M, 2) field of two framed planes: (x, y) at the
    interior points of the smooth ``mask`` (B, N, M, bool), 0 elsewhere.
    A CUDA tensor launches one kernel, a CPU tensor stacks and selects."""
    if mask.dtype != torch.bool or mask.dim() != 3:
        raise TypeError("unframe_planes: mask must be a (B, N, M) bool "
                        "tensor")
    B, N, M = mask.shape
    for p in (x, y):
        _check_field(p, (B, N + 2, M + 2), mask.device, "unframe_planes")
    if not mask.is_contiguous():
        raise ValueError("unframe_planes: mask must be contiguous")
    if not mask.is_cuda:
        z = torch.stack([x[:, 1:-1, 1:-1], y[:, 1:-1, 1:-1]], dim=-1)
        return torch.where(mask[..., None], z,
                           torch.zeros((), dtype=z.dtype, device=z.device))
    out = torch.empty((B, N, M, 2), dtype=torch.float32, device=mask.device)
    _build.launch(_entry("unframe_planes"), mask.get_device(), x.data_ptr(),
                  y.data_ptr(), mask.data_ptr(), out.data_ptr(), B, N, M)
    return out
