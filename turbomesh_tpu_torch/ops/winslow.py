"""The linear Winslow operator of one Picard step, K-W.

``winslow_apply`` applies the affine equation map of
``DeviceSmoother._apply`` (interior 9-point stencils, connection middle
rows, junction and sliding rows, slave substitution, the free mask) to a
flat field of one device's padded stack, optionally scaled row by row, in
f32 (the preconditioner's residual: the f64-differenced metrics ``G`` and
``cG`` given) or in f64 (FGMRES's operator and the right-hand side: the
interior metrics formed from the base coordinates, the connection metrics
``cG64`` given).

It reads the mesh's ``WinslowTables``: two int32 tables of one value a
padded point, built once a mesh (``row``: which row each point holds, its
free components and its index into that row kind's per-row tables;
``src``: the point that each point reads its value from, or the slave it
is), and the plan's per-row index tensors (``c_*``, ``l_*``, ``s_nb``,
``sl_master``, ``sl_off``).

A CUDA tensor launches the hand-written kernel ``csrc/winslow.cu`` (one
launch a call, ``WINSLOW_LAUNCHES``) or raises; a CPU tensor runs the
plain version ``winslow_apply_ref``, the eager expression of
``DeviceSmoother._apply`` over the index sets that the tables hold. The
kernel equals the plain version bit for bit on the card but in the junction
rows' sums, where the rounding may differ.

It ports no Pallas kernel: the JAX package leaves this map to XLA
(turbomesh_tpu/smoothing/device.py ``_apply``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

#: kernel launches since the last reset (chip_smoke.py, the tests and the
#: preconditioner's CUDA graph read it to show the main path went through
#: the kernel)
WINSLOW_LAUNCHES = 0

#: row kinds of the table ``row`` (its low 3 bits): none (the row is 0),
#: the interior stencil, a connection middle row, a junction row, a
#: sliding row
NONE, INTERIOR, CONNECTION, JUNCTION, SLIDING = range(5)
KIND_MASK = 7
#: the free x and y components of the point
FREE_X, FREE_Y = 8, 16
#: the row's index into its kind's per-row tables, above these bits
INDEX_SHIFT = 5

#: the plan's per-row tensors of each row kind (DevicePlan fields), in the
#: order the kernel's entry points take them
CONNECTION_KEYS = ("c_g0m", "c_g0p", "c_in0", "c_in1", "c_d0m", "c_d0p",
                   "c_d1m", "c_d1p", "c_pi", "c_swap_pq")
JUNCTION_KEYS = ("l_stencil", "l_weight", "l_rhs")
SLIDING_KEYS = ("s_nb",)
SLAVE_KEYS = ("sl_master", "sl_off")

_ENTRIES = {}   # the loaded entry points, by dtype


def load_library():
    """Build (if needed) and load the kernel library; idempotent."""
    return _build.load_library("winslow")


def build_tables(plan):
    """The per-point tables of a DevicePlan, as int32 numpy arrays (P,):
    ``row`` (kind | FREE_X | FREE_Y | index << INDEX_SHIFT: the interior
    points, then the connection, junction and sliding rows, each later
    kind over an earlier one where a point is listed twice, as the
    ``index_copy`` sequence of ``_apply`` writes them) and ``src`` (the
    point itself, or -(k + 1) for the k-th slave)."""
    B, N, M = plan.B, plan.N, plan.M
    P = B * N * M
    row = np.zeros(P, dtype=np.int64)
    row[np.asarray(plan.interior_mask).reshape(-1)] = INTERIOR
    for kind, rows in ((CONNECTION, plan.c_row), (JUNCTION, plan.l_row),
                       (SLIDING, plan.s_row)):
        rows = np.asarray(rows, dtype=np.int64)
        row[rows] = kind | (np.arange(len(rows)) << INDEX_SHIFT)
    free = np.asarray(plan.free_mask).reshape(-1, 2)
    row |= free[:, 0] * FREE_X | free[:, 1] * FREE_Y
    src = np.arange(P, dtype=np.int64)
    sl_row = np.asarray(plan.sl_row, dtype=np.int64)
    src[sl_row] = -1 - np.arange(len(sl_row))
    if row.max(initial=0) >= 2**31 or P >= 2**31:
        raise ValueError(f"winslow tables: {P} points or their row indices "
                         f"do not fit int32")
    return row.astype(np.int32), src.astype(np.int32)


class WinslowTables:
    """What K-W reads of one mesh: the per-point tables ``row`` and
    ``src`` (int32 on the plan tensors' device; 8 bytes a padded point)
    and the plan's per-row tensors of each row kind (``plans[dtype]``,
    from the ``p64`` and ``p32`` of ``device.plan_tensors``, which share
    their index tensors). Checked once here; the kernel's pointers to them
    are kept."""

    def __init__(self, plan, p64, p32):
        self.shape = (plan.B, plan.N, plan.M)
        device = p64["c_row"].device
        row, src = build_tables(plan)
        self.row = torch.as_tensor(row, device=device)
        self.src = torch.as_tensor(src, device=device)
        self.K = int(p64["l_stencil"].shape[1])
        self.C = int(p64["c_row"].shape[0])
        B, N, M = self.shape
        P = B * N * M
        #: the shape of each tensor of a call (``_check``)
        self.shapes = {"field": (P, 2), "cf": (B, N, M, 2),
                       "cG": (self.C, 3), "base": (P, 2),
                       "G": (B, N - 2, M - 2, 3), "scale": (P, 2)}
        #: the tables' device ordinal (-1: the CPU)
        self.device_index = self.row.get_device()
        self._decoded = {}
        #: the per-row tensors K-W reads, by dtype (contiguous copies
        #: where the plan's are not)
        self.plans = {}
        self._pointers = {}
        keys = CONNECTION_KEYS + JUNCTION_KEYS + SLIDING_KEYS + SLAVE_KEYS
        for dtype, p in ((torch.float64, p64), (torch.float32, p32)):
            side = self.plans[dtype] = {}
            for key in keys:
                t = side[key] = p[key].contiguous()
                want = (torch.bool if key == "c_swap_pq" else dtype
                        if t.is_floating_point() else torch.int64)
                if t.dtype != want or t.device != device:
                    raise ValueError(f"winslow tables: {key} must be a "
                                     f"{want} tensor on {device}")
            self._pointers[dtype] = (
                self.row.data_ptr(), self.src.data_ptr(),
                *(side[key].data_ptr() for key in keys))

    @property
    def nbytes(self) -> int:
        """Bytes of the per-point tables (the per-row tensors are the
        plan's)."""
        return (self.row.numel() * self.row.element_size()
                + self.src.numel() * self.src.element_size())

    def decoded(self, dtype):
        """The plan's fields as ``_apply`` reads them, rebuilt from the
        tables: the masks, each row kind's rows in the order of their
        index and its per-row tensors gathered at that index, and the
        slaves (``sl_row``, ``sl_master``, ``sl_off``). Built once a dtype."""
        d = self._decoded.get(dtype)
        if d is not None:
            return d
        p = self.plans[dtype]
        B, N, M = self.shape
        row = self.row.to(torch.int64)
        kind = row & KIND_MASK
        index = row >> INDEX_SHIFT
        d = {"interior_mask": (kind == INTERIOR).reshape(B, N, M),
             "free_mask": torch.stack([(row & FREE_X) != 0,
                                       (row & FREE_Y) != 0],
                                      dim=-1).reshape(B, N, M, 2)}
        for k, prefix, keys in ((CONNECTION, "c_row", CONNECTION_KEYS),
                                (JUNCTION, "l_row", JUNCTION_KEYS),
                                (SLIDING, "s_row", SLIDING_KEYS)):
            pos = torch.nonzero(kind == k).reshape(-1)
            order = torch.argsort(index[pos])
            pos, at = pos[order], index[pos][order]
            d[prefix] = pos
            d.update({key: p[key][at] for key in keys})
        src = self.src.to(torch.int64)
        slaves = torch.nonzero(src < 0).reshape(-1)
        at = -1 - src[slaves]
        d.update(sl_row=slaves, sl_master=p["sl_master"][at],
                 sl_off=p["sl_off"][at])
        self._decoded[dtype] = d
        return d


def _check(t, V, cf, cG, base, G, scale):
    """Raise unless the call's tensors are of V's dtype (f32 or f64), of
    their shapes (``WinslowTables.shapes``), contiguous and on the tables'
    device; f64 takes ``base`` and f32 ``G``, not the other."""
    dtype = V.dtype
    if dtype is not torch.float64 and dtype is not torch.float32:
        raise TypeError(f"winslow_apply: float32 or float64 field expected, "
                        f"got {dtype}")
    if dtype is torch.float64:
        if base is None or G is not None:
            raise ValueError("winslow_apply: float64 takes base, not G")
        metric = ("base", base)
    else:
        if G is None or base is not None:
            raise ValueError("winslow_apply: float32 takes G, not base")
        metric = ("G", G)
    device = t.device_index
    for name, x in (("field", V), ("cf", cf), ("cG", cG), metric,
                    ("scale", scale)):
        if x is None:
            continue
        if x.dtype is not dtype:
            raise TypeError(f"winslow_apply: {name} {x.dtype}, expected "
                            f"{dtype}")
        if x.shape != t.shapes[name]:
            raise ValueError(f"winslow_apply: {name} {tuple(x.shape)}, "
                             f"expected {t.shapes[name]}")
        if not x.is_contiguous():
            raise ValueError(f"winslow_apply: {name} must be contiguous")
        if x.get_device() != device:
            raise ValueError(f"winslow_apply: {name} on {x.device}, the "
                             f"tables on {t.row.device}")


def winslow_apply(t, V, cf, cG, with_offsets, *, base=None, G=None,
                  scale=None):
    """``scale * _apply(V)`` (scale optional) on one device's stack:
    ``t`` the mesh's WinslowTables, ``V`` the (P, 2) field, ``cf`` the
    padded control function (B, N, M, 2), ``cG`` the (C, 3) connection
    metrics, ``with_offsets`` 1.0 for F(V) or 0.0 for A V; f32 takes the
    (B, N-2, M-2, 3) metrics ``G``, f64 the (P, 2) base coordinates
    ``base``; all of one dtype. Returns a new (P, 2) tensor. CPU tensors
    run the plain version; CUDA tensors launch the kernel on PyTorch's
    current stream or raise."""
    global WINSLOW_LAUNCHES
    _check(t, V, cf, cG, base, G, scale)
    if not V.is_cuda:
        if V.is_cpu:
            return winslow_apply_ref(t, V, cf, cG, with_offsets, base=base,
                                     G=G, scale=scale)
        raise RuntimeError(f"winslow_apply: unsupported device {V.device}")
    f64 = V.dtype == torch.float64
    entry = _ENTRIES.get(V.dtype)
    if entry is None:
        lib = load_library()
        entry = _ENTRIES[V.dtype] = lib.winslow_f64 if f64 else lib.winslow_f32
    out = torch.empty_like(V)
    B, N, M = t.shape
    _build.launch(entry, V.get_device(), V.data_ptr(), cf.data_ptr(),
                  (base if f64 else G).data_ptr(), cG.data_ptr(),
                  0 if scale is None else scale.data_ptr(), out.data_ptr(),
                  *t._pointers[V.dtype], float(with_offsets), B * N * M, N,
                  M, t.K)
    WINSLOW_LAUNCHES += 1
    return out


def winslow_apply_ref(t, V, cf, cG, with_offsets, *, base=None, G=None,
                      scale=None):
    """Plain PyTorch version of ``winslow_apply``: the slave substitution
    and ``device._equation_rows`` (the eager expression of
    ``DeviceSmoother._apply``) over the index sets decoded from the
    tables, then the scale. Used on CPU tensors and as the reference the
    kernel is held against on the card."""
    from ..smoothing.device import _equation_rows

    d = t.decoded(V.dtype)
    Vf = V.index_copy(0, d["sl_row"],
                      V[d["sl_master"]] + with_offsets * d["sl_off"])
    baseX = None if base is None else base.reshape(t.shape + (2,))
    R = _equation_rows(d, t.shape, baseX, cf, Vf, Vf, with_offsets, G, cG)
    return R if scale is None else scale * R
