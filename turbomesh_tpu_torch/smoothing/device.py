"""Device solver: matrix-free elliptic smoothing on dense block stacks.

This replaces the reference's global-CSR + GMRES/BiCGStab/ILU0/UMFPACK
machinery (smooth.zig:277-1166) with a formulation over dense per-block
tensors:

- the mesh is a padded stack ``X: (B, N, M, 2)`` of per-block arrays;
- the linearized Winslow system of one Picard step is applied matrix-free:
  interior 9-point stencils are tensor ops over the whole stack;
  inter-block connection rows, junction rows, sliding rows and slave
  (equality) substitutions are gathers and unique-index scatters over
  precomputed index plans — the same equations the host oracle assembles;
- each linear solve is exact-f64 FGMRES over the equilibrated system,
  preconditioned by an f32 composition of the interface solve and the
  glued multigrid V-cycle (zebra line relaxation, multigrid.py): the
  Schur one by default, the base one with ``mg_opts={"schur": False}``;
  dual stop test (row-relative + the reference's plain criterion,
  GMRES.zig:21-24).

Slave (``CONNECTED``) points are eliminated by substitution
(x_slave = x_master + offset), so the reduced system's solution equals the
oracle's full-system solution to solver tolerance.

Counterpart of the fused path of turbomesh_tpu/smoothing/device.py.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading

import numpy as np
import torch

from ..ops import winslow
from ..profiling import span
from .classify import BoundaryInfo, Kind

log = logging.getLogger("turbomesh.smoothing")

#: CUDA graphs captured over one preconditioner application, and their
#: replays, since the last reset (each DeviceSmoother captures one and
#: replays it for its later applications: DeviceSmoother._apply_Minv)
PRECOND_CAPTURES = 0
PRECOND_REPLAYS = 0


@dataclasses.dataclass
class DevicePlan:
    """Static (host-precomputed) index plan, all indices into the padded
    flat space of shape (B*N*M,)."""

    B: int
    N: int
    M: int
    scatter_idx: np.ndarray      # (P,) global flat -> padded flat
    transposed: np.ndarray       # (B,) bool — block stored (j, i)
    cf_swap: np.ndarray          # (P,) bool — cf components swapped in pad
    interior_mask: np.ndarray    # (B, N, M) bool
    free_mask: np.ndarray        # (B, N, M, 2) bool — solved components

    # connection middle rows (concatenated over all connections)
    c_row: np.ndarray            # (C,) padded idx of the smoothed point g0
    c_g0m: np.ndarray            # g0 - cs0
    c_g0p: np.ndarray            # g0 + cs0
    c_in0: np.ndarray            # g0 + fis0
    c_in1: np.ndarray            # g1 + fis1
    c_d0m: np.ndarray            # g0 - cs0 + fis0
    c_d0p: np.ndarray            # g0 + cs0 + fis0
    c_d1m: np.ndarray            # g1 - cs1 + fis1
    c_d1p: np.ndarray            # g1 + cs1 + fis1
    c_pi: np.ndarray             # (C, 2) periodicity (0 for non-periodic)
    c_swap_pq: np.ndarray        # (C,) bool: True -> (P,Q) = (cf.y, cf.x)

    # per-connection segmentation of the c_* arrays (for the chain
    # tridiagonal preconditioner): indices into the C-length flat arrays
    c_seg: np.ndarray            # (S, Lmax) int64
    c_seg_valid: np.ndarray      # (S, Lmax) bool

    # junction rows, padded to width K
    l_row: np.ndarray            # (L,) padded idx of the master
    l_stencil: np.ndarray        # (L, K) padded idx (self included)
    l_weight: np.ndarray         # (L, K) f64 weights (0 padding)
    l_rhs: np.ndarray            # (L, 2)

    # sliding rows
    s_row: np.ndarray            # (S,)
    s_nb: np.ndarray             # (S,)

    # slave substitution
    sl_row: np.ndarray           # (Q,)
    sl_master: np.ndarray        # (Q,)
    sl_off: np.ndarray           # (Q, 2)

    # -- host<->pad converters (the ONLY correct way to move fields in and
    # out of the padded stack once per-block transposition is active) ----

    def pad_coords(self, coords: np.ndarray) -> np.ndarray:
        """(P, 2) physical coordinates -> (B*N*M, 2) padded flat."""
        out = np.zeros((self.B * self.N * self.M, 2))
        out[self.scatter_idx] = coords
        return out

    def pad_cf(self, cf: np.ndarray) -> np.ndarray:
        """(P, 2) logical (P, Q) control function -> padded flat in the
        STORAGE frame: components swap on transposed blocks so the
        interior stencil's direction pairing stays correct."""
        out = np.zeros((self.B * self.N * self.M, 2))
        out[self.scatter_idx] = np.where(
            self.cf_swap[:, None], cf[:, ::-1], cf)
        return out

    def unpad_coords(self, padded) -> np.ndarray:
        return np.asarray(padded).reshape(-1, 2)[self.scatter_idx]

    def unpad_cf(self, padded) -> np.ndarray:
        v = np.asarray(padded).reshape(-1, 2)[self.scatter_idx]
        return np.where(self.cf_swap[:, None], v[:, ::-1], v)


def build_plan(mesh, info: BoundaryInfo, transpose: bool = True) -> DevicePlan:
    starts = mesh.block_row_starts()
    sizes = [b.size for b in mesh.blocks]
    B = len(sizes)

    # Per-block storage transposition: store wide blocks (nj > ni)
    # transposed so every block is "tall" before padding to the common
    # (N, M). The O4H family mixes shapes like (441, 81) and (21, 261);
    # padding those untransposed costs 9.4x the real point count in
    # memory and stencil work. The Winslow interior stencil is exactly
    # invariant under (i, j) swap with (P, Q) swapped (control-function
    # components are stored storage-frame in the padded cf; see pad_cf),
    # and all boundary-row equations are built from global-id gathers, so
    # parity with the untransposed oracle is preserved to solver
    # tolerance.
    transposed = (np.array([nj > ni for ni, nj in sizes], dtype=bool)
                  if transpose else np.zeros(B, dtype=bool))
    sizes_st = [(nj, ni) if t else (ni, nj)
                for (ni, nj), t in zip(sizes, transposed)]
    N = max(s[0] for s in sizes_st)
    M = max(s[1] for s in sizes_st)

    # global flat -> padded flat (storage frame)
    scatter_idx = np.empty(mesh.num_points, dtype=np.int64)
    cf_swap = np.zeros(mesh.num_points, dtype=bool)
    for b, ((ni, nj), s) in enumerate(zip(sizes, starts)):
        ii, jj = np.meshgrid(np.arange(ni), np.arange(nj), indexing="ij")
        if transposed[b]:
            scatter_idx[s : s + ni * nj] = (
                b * N * M + jj * M + ii).reshape(-1)
            cf_swap[s : s + ni * nj] = True
        else:
            scatter_idx[s : s + ni * nj] = (
                b * N * M + ii * M + jj).reshape(-1)

    def to_pad(global_ids: np.ndarray) -> np.ndarray:
        return scatter_idx[global_ids]

    interior_mask = np.zeros((B, N, M), dtype=bool)
    for b, (ni, nj) in enumerate(sizes_st):
        interior_mask[b, 1 : ni - 1, 1 : nj - 1] = True

    free = np.zeros((B * N * M, 2), dtype=bool)
    free[scatter_idx[info.kind == Kind.INTERIOR]] = True
    free[scatter_idx[info.kind == Kind.SMOOTHED]] = True
    free[scatter_idx[info.kind == Kind.LAPLACIAN]] = True
    free[scatter_idx[info.sliding_ids], 1] = True  # y only

    # connection middle rows. Shifts are block-local flat (nj-based) in
    # global space; convert endpoints to padded indices via to_pad of the
    # *global* shifted ids (shifted points stay inside the same block).
    cr, cg0m, cg0p, cin0, cin1, cd0m, cd0p, cd1m, cd1p = ([] for _ in range(9))
    cpi, cswap = [], []
    for cm in info.conn_meta:
        g0 = cm.g0[1:-1]
        g1 = cm.g1[1:-1]
        sm = info.kind[g0] == Kind.SMOOTHED
        if not np.any(sm):
            continue
        g0, g1 = g0[sm], g1[sm]
        cr.append(to_pad(g0))
        cg0m.append(to_pad(g0 - cm.cs0))
        cg0p.append(to_pad(g0 + cm.cs0))
        cin0.append(to_pad(g0 + cm.fis0))
        cin1.append(to_pad(g1 + cm.fis1))
        cd0m.append(to_pad(g0 - cm.cs0 + cm.fis0))
        cd0p.append(to_pad(g0 + cm.cs0 + cm.fis0))
        cd1m.append(to_pad(g1 - cm.cs1 + cm.fis1))
        cd1p.append(to_pad(g1 + cm.cs1 + cm.fis1))
        pi = np.zeros(2) if cm.periodicity is None else cm.periodicity
        cpi.append(np.broadcast_to(pi, (len(g0), 2)))
        # the padded cf stores storage-frame components (swapped on
        # transposed blocks), while the reference's argument-order quirk
        # selects logical components — XOR the two swaps
        b0 = int(np.searchsorted(starts, cm.g0[0], side="right") - 1)
        cswap.append(np.full(len(g0),
                             (cm.periodicity is None) ^ bool(transposed[b0])))

    # segment table: one row per connection chain in the concatenated arrays
    seg_lens = [len(x) for x in cr]
    S = len(seg_lens)
    Lmax = max(seg_lens, default=1)
    c_seg = np.zeros((max(S, 1), Lmax), dtype=np.int64)
    c_seg_valid = np.zeros((max(S, 1), Lmax), dtype=bool)
    off = 0
    for s, ln in enumerate(seg_lens):
        c_seg[s, :ln] = off + np.arange(ln)
        c_seg_valid[s, :ln] = True
        off += ln

    def cat(parts, dtype=np.int64, width=None):
        if parts:
            return np.concatenate(parts).astype(dtype)
        return (np.empty((0,), dtype=dtype) if width is None
                else np.empty((0, width), dtype=dtype))

    # junction rows padded to fixed width
    K = max((len(lp.stencil_ids) for lp in info.laplacian_points), default=1)
    L = len(info.laplacian_points)
    l_row = np.zeros(L, dtype=np.int64)
    l_stencil = np.zeros((L, K), dtype=np.int64)
    l_weight = np.zeros((L, K), dtype=np.float64)
    l_rhs = np.zeros((L, 2), dtype=np.float64)
    for li, lp in enumerate(info.laplacian_points):
        n = len(lp.stencil_ids)
        l_row[li] = to_pad(np.array([lp.global_id]))[0]
        l_stencil[li, :n] = to_pad(lp.stencil_ids)
        l_weight[li, :n] = 1.0
        l_weight[li, : n][lp.stencil_ids == lp.global_id] = -(n - 1)
        l_rhs[li] = lp.rhs

    return DevicePlan(
        B=B, N=N, M=M,
        scatter_idx=scatter_idx,
        transposed=transposed,
        cf_swap=cf_swap,
        interior_mask=interior_mask,
        free_mask=free.reshape(B, N, M, 2),
        c_row=cat(cr), c_g0m=cat(cg0m), c_g0p=cat(cg0p),
        c_in0=cat(cin0), c_in1=cat(cin1),
        c_d0m=cat(cd0m), c_d0p=cat(cd0p), c_d1m=cat(cd1m), c_d1p=cat(cd1p),
        c_pi=cat(cpi, dtype=np.float64, width=2).reshape(-1, 2),
        c_swap_pq=cat(cswap, dtype=bool),
        c_seg=c_seg, c_seg_valid=c_seg_valid,
        l_row=l_row, l_stencil=l_stencil, l_weight=l_weight, l_rhs=l_rhs,
        s_row=to_pad(info.sliding_ids) if len(info.sliding_ids) else np.empty(0, np.int64),
        s_nb=to_pad(info.sliding_neighbor_ids) if len(info.sliding_ids) else np.empty(0, np.int64),
        sl_row=to_pad(info.slave_ids) if len(info.slave_ids) else np.empty(0, np.int64),
        sl_master=to_pad(info.master_ids) if len(info.slave_ids) else np.empty(0, np.int64),
        sl_off=info.slave_offsets.reshape(-1, 2),
    )


#: DevicePlan array fields that become tensors
PLAN_KEYS = ("interior_mask", "free_mask",
             "c_row", "c_g0m", "c_g0p", "c_in0", "c_in1",
             "c_d0m", "c_d0p", "c_d1m", "c_d1p", "c_pi", "c_swap_pq",
             "c_seg", "c_seg_valid",
             "l_row", "l_stencil", "l_weight", "l_rhs",
             "s_row", "s_nb", "sl_row", "sl_master", "sl_off")


def plan_tensors(plan, device) -> dict:
    """A DevicePlan's arrays as tensors on ``device``: integer indices as
    int64, masks as bool, floats as f64 — ``{"p64": ..., "p32": ...}``
    where the f32 twin shares the index and mask tensors and holds f32
    copies of the float arrays. Also carries ``c_seg_pos``, the flat
    positions of the valid entries of the chain segment table."""
    p64 = {}
    for key in PLAN_KEYS:
        a = np.asarray(getattr(plan, key))
        if a.dtype == np.bool_:
            dt = torch.bool
        elif np.issubdtype(a.dtype, np.integer):
            dt = torch.int64
        else:
            dt = torch.float64
        p64[key] = torch.as_tensor(a, dtype=dt, device=device)
    p64["c_seg_pos"] = torch.as_tensor(
        np.flatnonzero(np.asarray(plan.c_seg_valid)), dtype=torch.int64,
        device=device)
    p32 = {k: (v.to(torch.float32) if v.dtype == torch.float64 else v)
           for k, v in p64.items()}
    return {"p64": p64, "p32": p32}


# ---------------------------------------------------------------------------
# operator pieces
# ---------------------------------------------------------------------------

def _metrics(im1_j, ip1_j, i_jm1, i_jp1):
    x_xi = 0.5 * (ip1_j[..., 0] - im1_j[..., 0])
    x_eta = 0.5 * (i_jp1[..., 0] - i_jm1[..., 0])
    y_xi = 0.5 * (ip1_j[..., 1] - im1_j[..., 1])
    y_eta = 0.5 * (i_jp1[..., 1] - i_jm1[..., 1])
    g22 = x_eta * x_eta + y_eta * y_eta
    g12 = x_xi * x_eta + y_xi * y_eta
    g11 = x_xi * x_xi + y_xi * y_xi
    return g11, g12, g22


def _interior_apply(base, v, cf, G=None):
    """Apply the interior Winslow stencil (coefs frozen at `base`) to `v`.

    base, v, cf: (B, N, M, 2). Returns (B, N, M, 2) with the result in the
    interior slots [1:-1, 1:-1] and zeros elsewhere. G: optional
    precomputed (B, N-2, M-2, 3) [g11, g12, g22] metric stack — used by
    the f32 operator so the metric DIFFERENCES are formed in f64 and only
    then rounded (differencing closely-spaced wall points in f32 loses ~4
    digits and stalls iterative refinement at high condition numbers).
    """
    if G is not None:
        g11, g12, g22 = G[..., 0], G[..., 1], G[..., 2]
    else:
        g11, g12, g22 = _metrics(
            base[:, :-2, 1:-1], base[:, 2:, 1:-1],
            base[:, 1:-1, :-2], base[:, 1:-1, 2:])
    P = cf[:, 1:-1, 1:-1, 0][..., None]
    Q = cf[:, 1:-1, 1:-1, 1][..., None]
    g11 = g11[..., None]
    g12 = g12[..., None]
    g22 = g22[..., None]

    out = (
        (-2.0 * g22 - 2.0 * g11) * v[:, 1:-1, 1:-1]
        + g22 * (1 + 0.5 * P) * v[:, 2:, 1:-1]      # ip1_j
        + g22 * (1 - 0.5 * P) * v[:, :-2, 1:-1]     # im1_j
        + g11 * (1 + 0.5 * Q) * v[:, 1:-1, 2:]      # i_jp1
        + g11 * (1 - 0.5 * Q) * v[:, 1:-1, :-2]     # i_jm1
        - 0.5 * g12 * v[:, 2:, 2:]                   # ip1_jp1
        + 0.5 * g12 * v[:, 2:, :-2]                  # ip1_jm1
        + 0.5 * g12 * v[:, :-2, 2:]                  # im1_jp1
        - 0.5 * g12 * v[:, :-2, :-2]                 # im1_jm1
    )
    return torch.nn.functional.pad(out, (0, 0, 1, 1, 1, 1))


def _interior_diag(base):
    g11, g12, g22 = _metrics(
        base[:, :-2, 1:-1], base[:, 2:, 1:-1], base[:, 1:-1, :-2], base[:, 1:-1, 2:])
    return torch.nn.functional.pad(-2.0 * g22 - 2.0 * g11, (1, 1, 1, 1))


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _equation_rows(p, shape, baseX, cf_pad, Vf, VV, with_offsets, G, cG):
    """The rows of the equation map (DeviceSmoother._apply) from the
    slave-substituted flat field ``Vf`` (``VV``: the values that
    connection and junction rows read across blocks, ``Vf`` itself on one
    device): the interior stencil, the connection middle rows (cG: their
    metrics), the junction and sliding rows, the free mask. ``p``: the
    plan's tensors in Vf's dtype; baseX: (B, N, M, 2) frozen coordinates,
    unread when ``G`` is given."""
    B, N, M = shape
    zero = _zero(Vf)
    V = Vf.reshape(B, N, M, 2)

    # interior rows
    R = _interior_apply(baseX, V, cf_pad, G=G)
    R = torch.where(p["interior_mask"][..., None], R, zero)
    Rf = R.reshape(-1, 2)

    # connection middle rows (exact reference layout, smooth.zig:994-1105)
    c_row = p["c_row"]
    if c_row.shape[0]:
        c_pi = p["c_pi"]
        pi = with_offsets * c_pi
        g11, g12, g22 = cG[:, 0], cG[:, 1], cG[:, 2]
        cf_row = cf_pad.reshape(-1, 2)[c_row]
        c_swap = p["c_swap_pq"]
        P = torch.where(c_swap, cf_row[:, 1], cf_row[:, 0])
        Q = torch.where(c_swap, cf_row[:, 0], cf_row[:, 1])

        c_ij = (-2.0 * g22 - 2.0 * g11)[:, None]
        c_ip1 = (g22 * (1 + 0.5 * P))[:, None]
        c_im1 = (g22 * (1 - 0.5 * P))[:, None]
        c_jp1 = (g11 * (1 + 0.5 * Q))[:, None]
        c_jm1 = (g11 * (1 - 0.5 * Q))[:, None]
        c_pp = (-0.5 * g12)[:, None]
        c_pm = (0.5 * g12)[:, None]
        c_mp = (0.5 * g12)[:, None]
        c_mm = (-0.5 * g12)[:, None]

        r = (
            c_ij * Vf[c_row]
            + c_ip1 * Vf[p["c_g0p"]] + c_im1 * Vf[p["c_g0m"]]
            + c_jm1 * Vf[p["c_in0"]]
            + c_jp1 * (VV[p["c_in1"]] - pi)
            + c_mm * Vf[p["c_d0m"]] + c_pm * Vf[p["c_d0p"]]
            + c_mp * (VV[p["c_d1m"]] - pi) + c_pp * (VV[p["c_d1p"]] - pi)
        )
        Rf = Rf.index_copy(0, c_row, r)

    # junction rows
    l_row = p["l_row"]
    if l_row.shape[0]:
        vals = VV[p["l_stencil"]]  # (L, K, 2)
        r = torch.sum(p["l_weight"][..., None] * vals, dim=1)
        r = r - with_offsets * p["l_rhs"]
        Rf = Rf.index_copy(0, l_row, r)

    # sliding rows: y - y_neighbor (x handled by exclusion from free set)
    s_row = p["s_row"]
    if s_row.shape[0]:
        ry = Vf[s_row, 1] - Vf[p["s_nb"], 1]
        Rf = Rf.index_copy(0, s_row, torch.stack([torch.zeros_like(ry), ry],
                                                 dim=-1))

    return torch.where(p["free_mask"].reshape(-1, 2), Rf, zero)


#: coarse-space deflation modes (DeviceSmoother ``deflation``): basis
#: components of the per-block bilinear modes; "j" is the junction mode
DEFLATION_COMPS = {"y": (1,), "xy": (0, 1)}


def _defl_basis_arrays(block_sizes, N, M, free_mask, comps):
    """Per-block bilinear deflation profiles for the coarse-space solve.

    Returns (FU (B,N,2), FV (B,M,2), keep (K,)) with column ordering
    k = ((b*2 + p)*2 + q)*C + c: FU[b,:,p] / FV[b,:,q] are the 1-u / u
    (resp. 1-v / v) ramps over the block's REAL extents (zero on padding,
    and on a block of size (0, 0)), and keep[k]=0 marks columns that are
    structurally zero after free-component masking (e.g. a fully fixed
    block) so the Galerkin matrix gets an identity row/column there
    instead of a zero pivot. comps selects basis components ((1,)='y',
    (0,1)='xy')."""
    B = len(block_sizes)
    C = len(comps)
    FU = np.zeros((B, N, 2))
    FV = np.zeros((B, M, 2))
    K = B * 2 * 2 * C
    keep = np.zeros((K,))
    for b, (ni, nj) in enumerate(block_sizes):
        u = np.linspace(0.0, 1.0, ni)
        v = np.linspace(0.0, 1.0, nj)
        FU[b, :ni, 0] = 1.0 - u
        FU[b, :ni, 1] = u
        FV[b, :nj, 0] = 1.0 - v
        FV[b, :nj, 1] = v
        for p in range(2):
            for q in range(2):
                hat = FU[b, :, p][:, None] * FV[b, :, q][None, :]
                for ci, c in enumerate(comps):
                    k = ((b * 2 + p) * 2 + q) * C + ci
                    if np.any(hat * free_mask[b, :, :, c]):
                        keep[k] = 1.0
    return FU, FV, keep


def _adaptive_rtol_env():
    """TURBOMESH_ADAPTIVE_RTOL as the JAX package reads it: run's adaptive
    forcing may apply only where the variable is "1" or unset."""
    return os.environ.get("TURBOMESH_ADAPTIVE_RTOL", "1") == "1"


def _write_into(kept, fresh):
    """Copy every tensor of ``fresh`` (tensors in dicts, tuples and lists)
    into the tensor at the same place of ``kept``, the same structure;
    a tensor that is the kept one itself is left alone."""
    if isinstance(fresh, torch.Tensor):
        if fresh is not kept:
            kept.copy_(fresh)
    elif isinstance(fresh, dict):
        for key, value in fresh.items():
            _write_into(kept[key], value)
    elif isinstance(fresh, (tuple, list)):
        for a, b in zip(kept, fresh):
            _write_into(a, b)


#: one capture at a time in the process, as torch's CUDA graphs require
#: (``MeshService`` runs jobs in threads); ``_CAPTURING`` is the thread
#: that captures, and ``_KEPT`` holds the graphs that the collector frees
#: in that thread meanwhile: destroying a graph there would invalidate the
#: capture, so they go when it ends (``_PrecondGraph.__del__``)
_CAPTURE_LOCK = threading.Lock()
_CAPTURING = None
_KEPT = []


class _PrecondGraph:
    """One CUDA graph over one f32 preconditioner application of a
    smoother, ``stage(ctx, v)`` with ``ctx`` the smoother's kept context.

    The first application runs eagerly: it loads the kernels' modules
    (CUDA's lazy loading) and warms the allocator. The second captures
    ``stage`` (``torch.cuda.graph``: the card synchronised, the
    allocator's free cache, other smoothers' released pools included,
    handed back first), its input ``v`` then the graph's static input,
    its intermediates in the graph's private memory pool, and replays the
    graph once; every later one copies its input into the static input
    and replays. A replay runs the captured kernels in the captured order,
    so it returns the eager application's values bit for bit.
    ``ops.zebra.ZEBRA_LAUNCHES``, ``ops.chain.CHAIN_LAUNCHES``,
    ``ops.winslow.WINSLOW_LAUNCHES`` and ``ops.glue.GLUE_LAUNCHES`` count
    the launches a replay makes: the
    capture counts them once (for the replay that follows it), and each
    later replay adds them. The graph and its pool go with the
    smoother."""

    __slots__ = ("applications", "graph", "v", "z", "launches")

    def __init__(self):
        self.applications = 0
        self.graph = None

    def __del__(self):
        if _CAPTURING is not None and _CAPTURING == threading.get_ident() \
                and self.graph is not None:
            _KEPT.append((self.graph, self.v, self.z))

    def __call__(self, stage, ctx, v):
        from ..ops import chain, glue, zebra

        global PRECOND_CAPTURES, PRECOND_REPLAYS
        self.applications += 1
        if self.applications == 1:
            return stage(ctx, v)
        if self.graph is None:
            self._capture(stage, ctx, v)
        else:
            self.v.copy_(v)
            nz, nc, nw, ng = self.launches
            zebra.ZEBRA_LAUNCHES += nz
            chain.CHAIN_LAUNCHES += nc
            winslow.WINSLOW_LAUNCHES += nw
            glue.GLUE_LAUNCHES += ng
        self.graph.replay()
        PRECOND_REPLAYS += 1
        return self.z

    def _capture(self, stage, ctx, v):
        """Capture ``stage(ctx, v)`` into ``graph`` (and instantiate it),
        ``v`` the static input and the result the static output ``z``."""
        from ..ops import chain, glue, zebra

        global _CAPTURING, PRECOND_CAPTURES
        with _CAPTURE_LOCK, span("precond.graph.capture"):
            graph = torch.cuda.CUDAGraph()
            nz, nc, nw, ng = (zebra.ZEBRA_LAUNCHES, chain.CHAIN_LAUNCHES,
                              winslow.WINSLOW_LAUNCHES, glue.GLUE_LAUNCHES)
            _CAPTURING = threading.get_ident()
            try:
                with torch.cuda.graph(graph,
                                      stream=torch.cuda.Stream(v.device),
                                      capture_error_mode="thread_local"):
                    z = stage(ctx, v)
            finally:
                _CAPTURING = None
                _KEPT.clear()
            self.launches = (zebra.ZEBRA_LAUNCHES - nz,
                             chain.CHAIN_LAUNCHES - nc,
                             winslow.WINSLOW_LAUNCHES - nw,
                             glue.GLUE_LAUNCHES - ng)
            self.graph, self.v, self.z = graph, v, z
            PRECOND_CAPTURES += 1


class DeviceSmoother:
    """Device counterpart of SparseSystem.solve, plus the device-resident
    Picard loop (run).

    The block-sharded smoother (parallel/shard.py) is a subclass: it
    overrides the hooks that move data across blocks (``_remote_S``,
    ``_remote_F``, ``_dot``, ``_norm``, ``_coarse_vector``), builds its
    own multigrid statics (``_mg_static``, with glue that exchanges
    across ranks), the host transfers and the control-function update,
    and runs every stage, the preconditioner composition and the Picard
    loop written here."""

    #: inexact Picard with a target residual (run); the sharded loop keeps
    #: a fixed tolerance, as the JAX package's does
    adaptive_forcing = True
    #: the junction deflation mode "j" (single device only)
    junction_deflation = True
    #: the preconditioner's options (``mg_opts``), the JAX package's keys
    #: and defaults plus ``adaptive_rtol``:
    #: pre, post, coarse_iters, pre_dirs, post_dirs: the V-cycle schedule
    #: (multigrid.v_cycle_glued; directions "ij", "i" or "j");
    #: n_levels: the hierarchy's depth (None: coarsen to the smallest);
    #: deflation: as the keyword of the same name;
    #: interface_passes: defect-correction passes of the interface solve
    #: (_interface_passes);
    #: schur: the Schur composition of _stage_Minv (True) or the base one
    #: (False); None reads TURBOMESH_SCHUR (default "1");
    #: adaptive_rtol: the adaptive forcing of run (TURBOMESH_ADAPTIVE_RTOL
    #: other than "1" also turns it off: _adaptive_rtol_env).
    MG_DEFAULTS = dict(pre=1, post=1, coarse_iters=4,
                       pre_dirs="ij", post_dirs="ij", n_levels=None,
                       deflation=None, interface_passes=2, schur=None,
                       adaptive_rtol=True)
    #: the mg_opts keys that set the V-cycle's schedule and depth
    SCHEDULE_KEYS = ("pre", "post", "coarse_iters", "pre_dirs", "post_dirs",
                     "n_levels")
    #: the f32 context that _stage_prepare32 writes every solve into (the
    #: first solve's); the preconditioner's CUDA graph reads it
    #: (_apply_Minv)
    _ctx = None
    #: the _PrecondGraph of _apply_Minv: on a CUDA device without
    #: deflation only (the sharded subclass has none: its collectives
    #: stay eager)
    _graph = None
    #: the mesh's K-W tables (ops.winslow.WinslowTables), through which
    #: _op applies the operator; the sharded subclass has none: its rows
    #: read exchanged tables, through _apply's hooks
    _winslow = None

    def __init__(self, mesh, info: BoundaryInfo, *, device,
                 rtol: float = 1e-13, atol: float = 1e-15,
                 restart: int = 10, max_restarts: int = 100,
                 max_iters: int | None = None,
                 deflation: str | None = None,
                 mg_opts: dict | None = None):
        """deflation: opt-in coarse-space deflation at the head of every
        preconditioner application (_defl_apply): "y" deflates a per-block
        bilinear coarse space in the y component (the near-null mode that
        sliding BCs allow: whole regions floating in y), "xy" both
        components, "j" unit columns at the junction rows in both
        components; None (default) disables. TURBOMESH_DEFLATION
        overrides it. The JAX package measured it cost-neutral at best.
        mg_opts: the preconditioner's options over MG_DEFAULTS (an unknown
        key raises ValueError; ``deflation`` here or as the keyword, not
        both). max_iters: FGMRES iterations in all, the JAX package's
        alias of max_restarts = max(1, max_iters // restart)."""
        from .glue import build_glue
        from .multigrid import map_level_statics, prep_glue_arrays

        self.device = torch.device(device)
        with span("solver_setup.plan"):
            self.plan = build_plan(mesh, info)
        self._mesh = mesh
        self.rtol = rtol
        self.atol = atol
        self.restart = restart
        if max_iters is not None:
            max_restarts = max(1, max_iters // restart)
        self.max_restarts = max_restarts
        deflation = self._set_mg_opts(mg_opts, deflation)
        p = self.plan
        #: the (B, N, M) of the stack this instance holds, and its blocks'
        #: range in the whole stack
        self._shape = (p.B, p.N, p.M)
        self._lo, self._hi = 0, p.B
        with span("solver_setup.upload"):
            tens = plan_tensors(p, self.device)
            self._p64 = tens["p64"]
            self._p32 = tens["p32"]
            self._winslow = winslow.WinslowTables(p, self._p64, self._p32)
        # STORAGE-frame block extents (transposed blocks store (nj, ni))
        sizes = [(nj, ni) if t else (ni, nj)
                 for (ni, nj), t in zip((b.size for b in mesh.blocks),
                                        p.transposed)]
        self._setup_deflation(deflation, sizes, p.N, p.M, p.free_mask,
                              p.l_row)
        # keep_boundaries: boundary-aligned coarse lattices, so block axes
        # whose lattice length goes even keep their far boundary at every
        # level (plain [::2] moves the coarse Dirichlet up to 2^level
        # cells inside the block)
        with span("solver_setup.glue"):
            glue = build_glue(mesh, info, p.N, p.M,
                              n_levels=self.mg_opts["n_levels"],
                              transposed=p.transposed, keep_boundaries=True)
            self._glue_dev = prep_glue_arrays(glue, self.device)
            self._mg_static = map_level_statics(self._glue_dev,
                                                torch.float32)
        if self.device.type == "cuda" and not self._defl_K:
            self._graph = _PrecondGraph()
        self.last_linear_residual = float("nan")
        self.last_linear_converged = False
        self.last_restarts = 0
        self.last_run_rtols = []

    def _set_mg_opts(self, mg_opts, deflation):
        """Merge ``mg_opts`` over MG_DEFAULTS into ``self.mg_opts``, fix
        the composition (``_schur``) and return the deflation mode that
        the keyword or mg_opts gives. Unknown keys raise ValueError, and
        so does a deflation given both ways."""
        opts = dict(mg_opts or {})
        unknown = sorted(set(opts) - set(self.MG_DEFAULTS))
        if unknown:
            raise ValueError(f"unknown mg_opts keys {unknown}: expected "
                             f"some of {sorted(self.MG_DEFAULTS)}")
        for key in ("pre_dirs", "post_dirs"):
            if opts.get(key, "ij") not in ("ij", "i", "j"):
                raise ValueError(f"mg_opts {key} {opts[key]!r}: expected "
                                 f"'ij', 'i' or 'j'")
        if opts.get("deflation") is not None:
            if deflation is not None:
                raise ValueError("deflation given both as a keyword and in "
                                 "mg_opts")
            deflation = opts["deflation"]
        self.mg_opts = dict(self.MG_DEFAULTS, **opts)
        self.mg_opts["deflation"] = deflation
        schur = self.mg_opts["schur"]
        if schur is None:
            schur = os.environ.get("TURBOMESH_SCHUR", "1") == "1"
        self._schur = bool(schur)
        return deflation

    def _setup_deflation(self, deflation, block_sizes, N, M, free_mask,
                         l_row):
        """The coarse space of ``deflation`` (or TURBOMESH_DEFLATION) over
        the whole stack's blocks (``block_sizes`` in the storage frame,
        ``free_mask`` (B, N, M, 2)); this instance keeps the profiles of
        its blocks [_lo, _hi). Sets ``_defl_mode`` (None, "bilinear" or
        "junction"), ``_defl_comps`` and ``_defl_K`` (0 when off)."""
        mode = os.environ.get("TURBOMESH_DEFLATION", "") or deflation
        if mode in (None, "", "0"):
            mode = None
        elif mode != "j" and mode not in DEFLATION_COMPS:
            raise ValueError(f"deflation {mode!r}: expected one of 'y', "
                             f"'xy', 'j' or None")
        elif mode == "j" and not self.junction_deflation:
            raise ValueError("junction deflation ('j') is single-device "
                             "only: use DeviceSmoother, or 'y' / 'xy' here")
        self._defl_mode, self._defl_comps, self._defl_K = None, (), 0
        f64 = dict(dtype=torch.float64, device=self.device)
        if mode == "j":
            # junction-indicator mode: unit columns at the LAPLACIAN
            # (junction) rows, both components — the exact coupled
            # junction solve each preconditioner application
            jrows = np.unique(l_row)
            if len(jrows):
                self._defl_mode, self._defl_comps = "junction", (0, 1)
                keep = free_mask.reshape(-1, 2)[jrows].astype(
                    np.float64).ravel()
                self._djr = torch.as_tensor(jrows, dtype=torch.int64,
                                            device=self.device)
                self._dkeep = torch.as_tensor(keep, **f64)
                self._defl_K = len(keep)
        elif mode is not None:
            comps = DEFLATION_COMPS[mode]
            fu, fv, keep = _defl_basis_arrays(block_sizes, N, M, free_mask,
                                              comps)
            self._defl_mode, self._defl_comps = "bilinear", comps
            f32 = dict(dtype=torch.float32, device=self.device)
            self._dfu = torch.as_tensor(fu[self._lo:self._hi], **f32)
            self._dfv = torch.as_tensor(fv[self._lo:self._hi], **f32)
            self._dkeep = torch.as_tensor(keep, **f64)
            self._defl_K = len(keep)

    # -- residual / operator --------------------------------------------------

    def _plan_for(self, dtype):
        return self._p32 if dtype == torch.float32 else self._p64

    def _remote_S(self, Xf):
        """The values slave rows read their masters from (stage S): the
        field itself on one device, an exchange table when sharded."""
        return Xf

    def _remote_F(self, Vf):
        """The values connection and junction rows read across blocks
        (stage F): the field itself on one device, an exchange table when
        sharded (``c_in1``, ``c_d1m``, ``c_d1p``, ``l_stencil`` index it)."""
        return Vf

    def _dot(self, x, y):
        return torch.sum(x * y)

    def _norm(self, x):
        return torch.linalg.vector_norm(x)

    def _coarse_vector(self, part):
        """The whole block-partitioned coarse vector (K,) from this
        instance's blocks' part (Bl, ...): the part itself on one device,
        an all-gather in rank order when sharded."""
        return part.reshape(-1)

    def _substitute(self, Xf, with_offsets: float):
        """Slave substitution x_slave = x_master + with_offsets * offset."""
        p = self._plan_for(Xf.dtype)
        val = self._remote_S(Xf)[p["sl_master"]] + with_offsets * p["sl_off"]
        return Xf.index_copy(0, p["sl_row"], val)

    def _conn_metrics(self, baseF, baseV):
        """(C, 3) [g11, g12, g22] of the connection rows at the frozen base
        (baseV = ``_remote_F(baseF)``): the frozen coefficients see the
        periodic shift."""
        p = self._plan_for(baseF.dtype)
        g11, g12, g22 = _metrics(
            baseF[p["c_g0m"]], baseF[p["c_g0p"]], baseF[p["c_in0"]],
            baseV[p["c_in1"]] - p["c_pi"])
        return torch.stack([g11, g12, g22], dim=-1)

    def _apply(self, baseX, baseF, cf_pad, Vf, with_offsets: float,
               G=None, cG=None):
        """Affine equation map. baseX: (B,N,M,2) frozen coords (stencil
        coefficients); baseF: its flat slave-substituted version; Vf: flat
        (B*N*M, 2) point values to apply the equations to. Returns flat
        residuals over the free components. with_offsets 1.0 gives the
        affine map F(v), 0.0 the linear map A v. G/cG: optional
        precomputed interior/connection metric stacks (f64-differenced,
        f32-stored — see _interior_apply; cG as from _conn_metrics)."""
        # every exchange happens here, before any branch on this rank's
        # row counts, so all ranks post the same ones in the same order
        if cG is None:
            cG = self._conn_metrics(baseF, self._remote_F(baseF))
        Vf = self._substitute(Vf, with_offsets)
        return _equation_rows(self._plan_for(Vf.dtype), self._shape, baseX,
                              cf_pad, Vf, self._remote_F(Vf), with_offsets,
                              G, cG)

    def _op(self, baseF, cf_pad, Vf, with_offsets: float, G=None, cG=None,
            scale=None):
        """``scale * _apply(...)`` (scale optional) at the frozen flat base
        ``baseF``: one K-W launch (``ops.winslow``) where this smoother
        holds the mesh's tables (``_winslow``: a DeviceSmoother; the plain
        version on CPU tensors), ``_apply`` through the exchange hooks
        otherwise (the sharded subclass). f32 takes ``G`` and ``cG``; f64
        forms the interior metrics from ``baseF``, and ``cG`` when not
        given."""
        if self._winslow is None:
            B, N, M = self._shape
            R = self._apply(baseF.reshape(B, N, M, 2), baseF, cf_pad, Vf,
                            with_offsets, G=G, cG=cG)
            return R if scale is None else scale * R
        if cG is None:
            cG = self._conn_metrics(baseF, baseF)
        return winslow.winslow_apply(self._winslow, Vf, cf_pad, cG,
                                     with_offsets,
                                     base=None if G is not None else baseF,
                                     G=G, scale=scale)

    def _diag(self, baseX, cG):
        """Jacobi diagonal over free components (1 elsewhere); cG: the
        connection rows' metrics (_conn_metrics)."""
        p = self._plan_for(baseX.dtype)
        d0 = _interior_diag(baseX)[..., None]
        df = d0.expand(d0.shape[:-1] + (2,)).reshape(-1, 2)

        c_row = p["c_row"]
        if c_row.shape[0]:
            g11, g22 = cG[:, 0], cG[:, 2]
            dc = (-2.0 * g22 - 2.0 * g11)[:, None]
            df = df.index_copy(0, c_row, dc.expand(dc.shape[0], 2))

        l_row = p["l_row"]
        if l_row.shape[0]:
            n = torch.sum(p["l_weight"] != 0.0, dim=1).to(df.dtype)
            dln = (-(n - 1))[:, None]
            df = df.index_copy(0, l_row, dln.expand(dln.shape[0], 2))

        s_row = p["s_row"]
        if s_row.shape[0]:
            df = df.clone()
            df[s_row, 1] = 1.0

        free = p["free_mask"].reshape(-1, 2)
        return torch.where(free, df, torch.ones((), dtype=df.dtype,
                                                device=df.device))

    # -- stages ---------------------------------------------------------------

    def _stage_base(self, Xpad, cf_pad):
        """Frozen base (slave-substituted, flat) and the rhs b = -F(base)."""
        baseF = self._substitute(Xpad.reshape(-1, 2), 1.0)
        b = -self._op(baseF, cf_pad, baseF, 1.0)
        return baseF, b

    def _stage_apply64(self, baseF, cf_pad, v, cG=None, scale=None):
        """f64 linear operator A v, times the row scale ``scale`` where
        given (cG: the f64 connection metrics, ``ctx["cG64"]``, formed
        here when not given)."""
        return self._op(baseF, cf_pad, v, 0.0, cG=cG, scale=scale)

    def _stage_finish(self, baseF, delta):
        free64 = self._p64["free_mask"].reshape(-1, 2)
        Xf1 = baseF + torch.where(free64, delta, _zero(delta))
        return self._substitute(Xf1, 1.0)

    def _stage_prepare32(self, baseF, cf_pad):
        """f32 inner-solver context: diagonal, chain factors, glued
        multigrid levels and the f64-differenced operator metrics.

        The first context is kept (``_ctx``), and every later solve
        writes its values into the kept tensors (each multigrid level as
        it is built) and returns that context: its tensors keep their
        addresses for the life of the smoother, as the preconditioner's
        CUDA graph needs (_apply_Minv). The parts that depend on the mesh
        alone are built once (``_mg_static``)."""
        from .multigrid import iter_glued_levels

        p32 = self._p32
        B, N, M = self._shape
        baseV = self._remote_F(baseF)
        baseF32 = baseF.to(torch.float32)
        baseX32 = baseF32.reshape(B, N, M, 2)
        cf32 = cf_pad.to(torch.float32)
        cg32 = self._conn_metrics(baseF32, baseV.to(torch.float32))
        diag_field = self._diag(baseX32, cg32).reshape(B, N, M, 2)

        cg11, cg22 = cg32[:, 0], cg32[:, 2]
        cf_row = cf32.reshape(-1, 2)[p32["c_row"]]
        Pq = torch.where(p32["c_swap_pq"], cf_row[:, 1], cf_row[:, 0])
        ch = (cg22 * (1 - 0.5 * Pq), -2.0 * cg22 - 2.0 * cg11,
              cg22 * (1 + 0.5 * Pq))

        levels = iter_glued_levels(baseX32, cf32, self._mg_static)
        if self._ctx is None:
            levels = list(levels)
        else:
            for kept, level in zip(self._ctx["mg"], levels):
                _write_into(kept, level)
            levels = self._ctx["mg"]

        # f64-differenced, f32-stored operator metrics: the f32 inner
        # operator's coefficients are formed by differencing the f64 frozen
        # coordinates and only then rounding, so the inner operator
        # matches the true operator to ~eps32 even at strong wall
        # clustering
        baseX64 = baseF.reshape(B, N, M, 2)
        g11, g12, g22 = _metrics(
            baseX64[:, :-2, 1:-1], baseX64[:, 2:, 1:-1],
            baseX64[:, 1:-1, :-2], baseX64[:, 1:-1, 2:])
        G = torch.stack([g11, g12, g22], dim=-1).to(torch.float32)
        cG64 = self._conn_metrics(baseF, baseV)

        ctx = dict(baseF32=baseF32, cf32=cf32, diag=diag_field, chain=ch,
                   G=G, cG=cG64.to(torch.float32), cG64=cG64, mg=levels)
        if self._ctx is None:
            self._ctx = ctx
        else:
            _write_into(self._ctx, ctx)
            ctx = self._ctx
        if self._defl_K:
            ctx["defl"] = self._defl_galerkin(ctx)
        return ctx

    def _stage_A32(self, ctx, v):
        """f32 linear operator application."""
        with span("precond.residual"):
            return self._op(ctx["baseF32"], ctx["cf32"], v, 0.0, G=ctx["G"],
                            cG=ctx["cG"])

    # -- coarse-space deflation (implicit per-block bilinear basis) ----------
    #
    # The exact Petrov-Galerkin solve over a tiny coarse space W (per block,
    # 4 bilinear corner hats in the free components, or unit columns at the
    # junction rows): alpha = (W^T A W)^-1 W^T r; z0 = W alpha; then the
    # Schur composition on r - A z0. W is never materialized: each column
    # is a rank-1 FU x FV outer product, so W^T r and W alpha are two small
    # per-block contractions; the K x K Galerkin matrix (K = 4B or 8B) is
    # rebuilt each prepare from K sequential f32 operator applications.

    def _defl_Wt(self, vflat):
        """W^T v: (P, 2) f32 field -> (K,) coarse vector."""
        vm = vflat * self._p32["free_mask"].reshape(-1, 2)
        if self._defl_mode == "junction":
            return vm[self._djr].reshape(-1)
        B, N, M = self._shape
        v = vm.reshape(B, N, M, 2)
        outs = []
        for c in self._defl_comps:
            t = torch.einsum("bnp,bnm->bpm", self._dfu, v[..., c])
            outs.append(torch.einsum("bpm,bmq->bpq", t, self._dfv))
        return self._coarse_vector(torch.stack(outs, dim=-1))

    def _defl_W(self, alpha):
        """W alpha: (K,) f32 -> (P, 2) correction field of this
        instance's blocks."""
        B, N, M = self._shape
        free = self._p32["free_mask"]
        if self._defl_mode == "junction":
            z = torch.zeros((B * N * M, 2), dtype=alpha.dtype,
                            device=alpha.device)
            z = z.index_copy(0, self._djr, alpha.reshape(-1, 2))
            return z * free.reshape(-1, 2)
        C = len(self._defl_comps)
        a = alpha.reshape(-1, 2, 2, C)[self._lo:self._hi]
        z = torch.zeros((B, N, M, 2), dtype=alpha.dtype, device=alpha.device)
        for ci, c in enumerate(self._defl_comps):
            t = torch.einsum("bpq,bnp->bnq", a[..., ci], self._dfu)
            z[..., c] = torch.einsum("bnq,bmq->bnm", t, self._dfv)
        return (z * free).reshape(-1, 2)

    def _defl_galerkin(self, ctx):
        """The equilibrated (K, K) Galerkin matrix W^T A W of the f32
        operator, its scaling vector and its LU factors: K sequential
        operator applications (one basis column each, so peak memory stays
        at one field), then in f64 identity rows at the structurally zero
        columns and the symmetric equilibration rsqrt(|diag|). The K x K
        algebra runs in f64 without a ridge: a ridge or an f32 solve puts
        a systematic bias on the coarse-mode elimination that the outer
        FGMRES stalls at. Returns dict(G, D, LU, piv)."""
        K = self._defl_K
        eye = torch.eye(K, dtype=torch.float32, device=self.device)
        cols = [self._defl_Wt(self._stage_A32(ctx, self._defl_W(eye[k])))
                for k in range(K)]
        G = torch.stack(cols, dim=1).to(torch.float64)
        keep = self._dkeep
        G = G * keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)
        d = torch.rsqrt(torch.abs(torch.diagonal(G)) + 1e-300)
        G = G * d[:, None] * d[None, :]
        LU, piv, _ = torch.linalg.lu_factor_ex(G)
        return dict(G=G, D=d, LU=LU, piv=piv)

    def _defl_apply(self, ctx, vflat):
        """Safeguarded coarse solve: returns (t z0, v - t A z0).

        The raw Petrov-Galerkin correction is unsafe for this nonsymmetric
        A: when the residual has little true coarse content, (W^T A W)^-1
        makes a correction whose image A z0 dwarfs v outside the coarse
        space and stalls the outer FGMRES. So the Galerkin direction is
        scaled by the weighted least-squares step t = <D^2 v, A z0> /
        <D^2 A z0, A z0> (D = 1/|diag|, f32 dots: t is a safeguard, three
        digits do), which guarantees ||D (v - t A z0)|| <= ||D v||."""
        with span("precond.deflation"):
            dfl = ctx["defl"]
            rhs = self._defl_Wt(vflat).to(torch.float64) * dfl["D"]
            alpha = dfl["D"] * torch.linalg.lu_solve(
                dfl["LU"], dfl["piv"], rhs[:, None])[:, 0]
            z0 = self._defl_W(alpha.to(torch.float32))
            Az0 = self._stage_A32(ctx, z0)
            w = 1.0 / ctx["diag"].reshape(-1, 2)
            wA = w * Az0
            t = self._dot(w * vflat, wA) / (self._dot(wA, wA) + 1e-30)
            return t * z0, vflat - t * Az0

    def _stage_vcycle_interior(self, ctx, vflat):
        """f32 glued multigrid V-cycle: block interiors + SMOOTHED
        connection-face rows relax together (ghost halos + slave sync at
        every level)."""
        from .multigrid import v_cycle_glued

        with span("precond.vcycle"):
            B, N, M = self._shape
            levels = ctx["mg"]
            # interior + SMOOTHED faces
            mask = levels[0]["interior"][..., None]
            v = vflat.reshape(B, N, M, 2)
            zero = _zero(vflat)
            o = self.mg_opts
            z = v_cycle_glued(levels, torch.where(mask, v, zero),
                              pre=o["pre"], post=o["post"],
                              coarse_iters=o["coarse_iters"],
                              pre_dirs=o["pre_dirs"], post_dirs=o["post_dirs"])
            z = torch.where(mask & self._p32["free_mask"], z, zero)
            return z.reshape(-1, 2)

    def _stage_interface(self, ctx, vflat):
        """f32 interface solve: connection-chain tridiagonal solves +
        Jacobi on junction/sliding/other boundary free rows; zero on the
        interior. Sliding rows go LAST and read the UPDATED neighbour
        correction: the row y_s - y_nb = r solves exactly as z_s = r + z_nb,
        and at BC corners the neighbour is a face/chain row updated above;
        two passes resolve neighbour-sliding chains."""
        from ..ops.chain import chain_solve

        with span("precond.interface"):
            p32 = self._p32
            B, N, M = self._shape
            diag_field = ctx["diag"]
            zero = _zero(vflat)
            one = torch.ones((), dtype=vflat.dtype, device=vflat.device)

            v = vflat.reshape(B, N, M, 2)
            interior = p32["interior_mask"][..., None]
            inv_diag = 1.0 / torch.where(diag_field == 0.0, one, diag_field)
            z = torch.where(interior, zero, v * inv_diag)
            z = torch.where(p32["free_mask"], z, zero)
            zf = z.reshape(-1, 2)

            zf = chain_solve(ctx["chain"], p32["c_seg"], p32["c_seg_valid"],
                             p32["c_seg_pos"], p32["c_row"], vflat, zf)

            s_row = p32["s_row"]
            if s_row.shape[0]:
                s_nb = p32["s_nb"]
                for _ in range(2):
                    zy = vflat[s_row, 1] + zf[s_nb, 1]
                    zf = zf.index_copy(
                        0, s_row, torch.stack([zf[s_row, 0], zy], dim=-1))
                zf = torch.where(p32["free_mask"].reshape(-1, 2), zf, zero)
            return zf

    def _interface_passes(self, ctx, rr):
        """Defect-correction iteration of the interface solve: each extra
        pass re-solves the interface on the updated residual, subtracting
        A of the LAST increment, which Gauss-Seidels the junction <->
        chain <-> sliding coupling one pass alone never resolves.
        mg_opts ``interface_passes`` sets the count (default 2)."""
        n = int(self.mg_opts["interface_passes"])
        z = self._stage_interface(ctx, rr)
        if n <= 1:
            return z
        r_c, dz = rr, z
        for _ in range(n - 1):
            r_c = r_c - self._stage_A32(ctx, dz)
            dz = self._stage_interface(ctx, r_c)
            z = z + dz
        return z

    def _stage_Minv(self, ctx, vflat):
        """f32 preconditioner. With mg_opts ``schur`` (the default) an
        approximate EXACT ELIMINATION (Schur composition) of the interface
        unknowns:
          e  = A_JJ^-1 v_J          (_stage_interface)
          z  = V(v - A e)           (the correction glue already makes the
                                     V-cycle's operator the Schur
                                     complement; this adds its rhs)
          rr = v - A (z + e)
          M^-1 v = z + e + interface_passes(rr)
        Without it the base composition, the V-cycle then the interface:
          z  = V(v),  rr = v - A z,  M^-1 v = z + interface_passes(rr)
        With deflation on, the coarse-space solve goes first
        (_defl_apply): the composition runs on v - t A z0, and t z0 is
        added to its result."""
        z0 = None
        if "defl" in ctx:
            z0, vflat = self._defl_apply(ctx, vflat)
        if self._schur:
            e = self._stage_interface(ctx, vflat)
            ze = self._stage_vcycle_interior(
                ctx, vflat - self._stage_A32(ctx, e)) + e
        else:
            ze = self._stage_vcycle_interior(ctx, vflat)
        rr = vflat - self._stage_A32(ctx, ze)
        if z0 is None:
            return ze + self._interface_passes(ctx, rr)
        return z0 + ze + self._interface_passes(ctx, rr)

    def _apply_Minv(self, ctx, vflat):
        """One preconditioner application, ``_stage_Minv(ctx, vflat)``:
        through the smoother's CUDA graph where it has one (``_graph``),
        eagerly otherwise (the CPU, the deflated path, the sharded one).
        The result may be the graph's static output, which the next
        application overwrites: the caller copies it."""
        if self._graph is None:
            return self._stage_Minv(ctx, vflat)
        return self._graph(self._stage_Minv, ctx, vflat)

    # -- the linear solve -------------------------------------------------------

    def _solve_impl(self, Xpad, cf_pad, rtol: float):
        """One linearized solve: exact-f64 FGMRES over the equilibrated
        system, preconditioned by one f32 _stage_Minv application per
        iteration. Returns (X1, stats) with stats = [plain residual,
        converged flag, displacement residual] as a device tensor; the
        FGMRES restart cycles it took go to ``last_restarts``."""
        from .krylov import restarted_fgmres

        with span("solve.prepare"):
            base, b = self._stage_base(Xpad, cf_pad)
            ctx = self._stage_prepare32(base, cf_pad)
        free64 = self._p64["free_mask"].reshape(-1, 2)

        # equilibrated iteration: FGMRES minimizes the row-scaled residual,
        # which the 1e-10 node-for-node bar needs; the reference's own
        # plain-residual stop test (GMRES.zig:21-24) is kept as a second
        # criterion
        row_diag = ctx["diag"].to(torch.float64).reshape(-1, 2)
        inv_row = 1.0 / row_diag

        def A_s(v):
            with span("fgmres.operator"):
                return self._stage_apply64(base, cf_pad, v, cG=ctx["cG64"],
                                           scale=inv_row)

        def M_s(v):
            with span("precond"):
                v32 = (row_diag * v).to(torch.float32)
                return self._apply_Minv(ctx, v32).to(torch.float64)

        b_s = inv_row * b
        tol2 = torch.clamp(rtol * self._norm(b), min=self.atol)
        d_s, rn_s, self.last_restarts = restarted_fgmres(
            A_s, b_s, M_s, dot=self._dot, rtol=rtol, atol=self.atol,
            restart=self.restart, max_restarts=self.max_restarts,
            w2=row_diag, tol2=tol2, return_restarts=True)
        delta = torch.where(free64, d_s, _zero(d_s))
        # true unequilibrated residual for the convergence report
        rnorm = self._norm(
            b - self._stage_apply64(base, cf_pad, delta, cG=ctx["cG64"]))
        tol_s = torch.clamp(rtol * self._norm(b_s), min=self.atol)
        converged = torch.logical_or(rn_s <= tol_s, rnorm <= tol2)
        X1 = self._stage_finish(base, delta).reshape(Xpad.shape)
        # displacement-norm Picard residual (smooth.zig:136 formula):
        # (sum dx^2 + sum dy^2)^2 — padded lanes are zero in both fields
        dX = X1 - Xpad
        d2 = self._dot(dX, dX)
        stats = torch.stack([rnorm, converged.to(torch.float64), d2 * d2])
        return X1, stats

    def _upload(self, coords, cf):
        p = self.plan
        X = torch.as_tensor(p.pad_coords(coords).reshape(p.B, p.N, p.M, 2),
                            dtype=torch.float64, device=self.device)
        C = torch.as_tensor(p.pad_cf(cf).reshape(p.B, p.N, p.M, 2),
                            dtype=torch.float64, device=self.device)
        return X, C

    def _coords_to_host(self, X) -> np.ndarray:
        return self.plan.unpad_coords(X.cpu().numpy())

    def _cf_to_host(self, C) -> np.ndarray:
        return self.plan.unpad_cf(C.cpu().numpy())

    def _device_update(self, algorithm):
        """The control-function update ``C = upd(X, C)`` on the stack."""
        from .control_function import make_device_update

        return make_device_update(algorithm, self._mesh, self.plan)

    def solve(self, coords: np.ndarray, cf: np.ndarray) -> np.ndarray:
        """One linearized Picard solve: upload the padded field, run the
        device solve, download the smoothed field."""
        from .krylov import _warn_nonconverged

        X, C = self._upload(coords, cf)
        with span("picard.solve"):
            X1, stats = self._solve_impl(X, C, self.rtol)
        rn, ok, _ = stats.tolist()
        if not ok:
            _warn_nonconverged("device fgmres",
                               self.restart * self.max_restarts, rn,
                               self.atol)
        self.last_linear_residual = rn
        self.last_linear_converged = bool(ok)
        return self._coords_to_host(X1)

    def run(self, coords: np.ndarray, cf: np.ndarray, iterations: int,
            algorithm=None, start_iteration: int = 0,
            target_residual: float | None = None,
            residual_history: list | None = None,
            restart_history: list | None = None,
            checkpoint_cb=None, checkpoint_every: int = 10):
        """Device-resident outer Picard loop (the reference's iteration
        loop, smooth.zig:104-153).

        The padded coordinate stack is uploaded ONCE and stays on the
        device across Picard iterations; each iteration runs (a) the
        control-function update (control_function.make_device_update) for
        n > 0 and (b) the linearized solve, and reads ONE small stats
        vector [linear residual, converged flag, displacement residual].
        The full field comes back only at checkpoints and at the end.

        algorithm: control-function object (Laplace/White) whose update
        runs on the device; None skips updates. restart_history: gets the
        FGMRES restart cycles of each iteration. checkpoint_cb(coords, cf,
        n): called with host arrays every checkpoint_every iterations.
        Returns (coords, cf, last_displacement_residual, iterations_run).
        """
        from .krylov import _warn_nonconverged

        upd = (self._device_update(algorithm)
               if algorithm is not None else None)

        # Inexact Picard (adaptive forcing term): with a TARGET residual the
        # linear solves only need enough accuracy to preserve the outer
        # contraction, so iterations far from the target solve at 1e-2;
        # within ~1e6x of the target (the 4th-power displacement metric)
        # they run at the full instance rtol. Fixed-iteration runs (the
        # reference's own semantics, smooth.zig:104) keep the fixed
        # tolerance, and so does every run of a class without
        # ``adaptive_forcing``, with mg_opts ``adaptive_rtol`` False or with
        # TURBOMESH_ADAPTIVE_RTOL set to anything but "1".
        adaptive = (self.adaptive_forcing and target_residual is not None
                    and bool(self.mg_opts["adaptive_rtol"])
                    and _adaptive_rtol_env())
        eta_loose = max(self.rtol, 1e-2)
        #: per-iteration linear-solve tolerances of the last run()
        self.last_run_rtols = []

        X, C = self._upload(coords, cf)

        def to_host(Xdev, Cdev):
            return self._coords_to_host(Xdev), self._cf_to_host(Cdev)

        disp = np.inf
        n_done = start_iteration
        for n in range(start_iteration, iterations):
            log.info("iteration: %d", n)
            if n > 0 and upd is not None:
                with span("picard.update"):
                    C = upd(X, C)
            loose = adaptive and disp > target_residual * 1e6
            eta = eta_loose if loose else self.rtol
            self.last_run_rtols.append(eta)
            with span("picard.solve"), (span("picard.solve.loose") if loose
                                        else contextlib.nullcontext()):
                X, stats = self._solve_impl(X, C, eta)
            with span("picard.read"):
                rn, ok, disp = stats.tolist()  # one read per iteration
            if not ok:
                _warn_nonconverged("device fgmres",
                                   self.restart * self.max_restarts, rn,
                                   self.atol)
            self.last_linear_residual = rn
            self.last_linear_converged = bool(ok)
            log.info("\tresidual: %.6e", disp)
            # in this frame, with the stack as the local X: a caller's
            # list may read the iteration's coordinates from it
            if residual_history is not None:
                residual_history.append(disp)
            if restart_history is not None:
                restart_history.append(self.last_restarts)
            n_done = n + 1
            if target_residual is not None and disp < target_residual:
                log.info("converged: residual %.3e < target %.3e at "
                         "iteration %d", disp, target_residual, n)
                break
            if checkpoint_cb is not None and n_done % checkpoint_every == 0:
                checkpoint_cb(*to_host(X, C), n_done)

        coords, cf = to_host(X, C)
        return coords, cf, disp, n_done

