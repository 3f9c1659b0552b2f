"""Glued geometric multigrid V-cycle preconditioner for the Winslow system.

Each block is coarsened 2x per level (the padded block stack coarsens as
one batched tensor; boundary-aligned lattices carry gather maps), the
Winslow operator is rediscretized from the sampled base coordinates, and
connection faces participate at every level through one ghost ring per
block filled from the partner block (glue.py): error modes smooth ACROSS
block interfaces are damped by the hierarchy instead of being left to the
Krylov iteration. The smoother is zebra line relaxation, one
``ops.zebra.zebra_half_sweep`` per (direction, color), each after the
glue of the correction on the two ghost-framed planes it reads.

Levels are plain dicts of tensors, each with its glue: an object with
``pad``, ``correction`` and ``correction_planes`` (``MapGlue`` on one
device, the sharded path's ``ShardGlue``), which the V-cycle calls without
knowing which it is.
Counterpart of the glued half of turbomesh_tpu/smoothing/multigrid.py
(prep_glue_arrays .. v_cycle_glued).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import glue as kg
from ..ops.zebra import zebra_half_sweep

#: transfer-map field names for boundary-aligned (non-stride-2) levels
MAP_KEYS = ("li_map", "lj_map", "pi_lo", "pi_w", "pj_lo", "pj_w")


def _last_unique(dst: np.ndarray) -> np.ndarray:
    """Sorted positions of the LAST occurrence of each value of ``dst``.

    The reference scatters the glue map with duplicate destinations and
    XLA on the CPU keeps the last write; keeping exactly that entry makes
    every scatter here a deterministic copy with unique indices."""
    if len(dst) == 0:
        return np.zeros(0, dtype=np.int64)
    _, first_rev = np.unique(dst[::-1], return_index=True)
    return np.sort(len(dst) - 1 - first_rev)


def prep_glue_arrays(glue_levels, device):
    """One-time conversion of glue.GlueLevel records into per-level dicts
    of tensors on ``device``.

    The plain glue map is made unique per destination (last entry wins,
    as XLA:CPU resolves the reference's duplicates). The correction glue
    then drops the plain copies whose destination a sliding (c*) or
    junction (j*) entry owns, so it too is one scatter with unique
    destinations. Float arrays stay f64; callers cast to their dtype.
    Each level also carries the index tables of its correction glue on the
    zebra planes (``ops.glue.build_tables``: ``kg_code``, ``kg_copy``,
    ``kg_junction``), built and checked here once."""
    out = []
    for gl in glue_levels:
        u = _last_unique(gl.dst)
        src, dst, off = gl.src[u], gl.dst[u], gl.off[u]
        taken = set(gl.cdst.tolist()) | set(gl.jdst.tolist())
        keep = np.array([d not in taken for d in dst], dtype=bool)
        ga_src = np.concatenate([src[keep], gl.csrc])
        ga_dst = np.concatenate([dst[keep], gl.cdst])
        ga_w = np.concatenate([np.ones((int(keep.sum()), 2)), gl.cw])
        all_dst = np.concatenate([ga_dst, gl.jdst])
        if len(np.unique(all_dst)) != len(all_dst):
            raise ValueError("correction glue has duplicate destinations")

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        code, copy, junction = kg.build_tables(gl.smooth_mask, ga_dst,
                                               ga_src, gl.jdst, gl.jsrc)
        rec = dict(
            smooth_mask=t(gl.smooth_mask, torch.bool),
            kg_code=t(code, torch.uint8), kg_copy=t(copy, torch.int32),
            kg_junction=t(junction, torch.int32),
            gsrc=t(src, torch.int64), gdst=t(dst, torch.int64),
            goff=t(off.reshape(-1, 2), torch.float64),
            gcsrc=t(ga_src, torch.int64), gcdst=t(ga_dst, torch.int64),
            gcw=t(ga_w.reshape(-1, 2), torch.float64),
            gjdst=t(gl.jdst, torch.int64), gjsrc=t(gl.jsrc, torch.int64),
            gjw=t(gl.jw, torch.float64),
        )
        if gl.li_map is not None:
            for key in MAP_KEYS:
                arr = getattr(gl, key)
                rec[key] = t(arr, torch.float64 if key.endswith("_w")
                             else torch.int64)
        out.append(rec)
    return out


def _pad1(a, value=0.0):
    """Pad the two grid axes of a (B, N, M) plane by one ghost ring."""
    return F.pad(a, (1, 1, 1, 1), value=value)


class MapGlue:
    """A level's glue on one device: one ghost ring around every block,
    filled (with the slave rows) from sources in the level's own
    ghost-framed field over the unique-destination maps of
    ``prep_glue_arrays``, whose weights and offsets are cast to the
    level's dtype here, once. ``pad(v, coord_field)`` glues coordinate
    (with the periodic offsets) and residual fields with the plain map;
    ``correction(v)`` glues a correction field.

    The correction glue adds the correction-only embeddings (glue.py
    GlueLevel.c*/j*): junction masters take the mean of their members'
    interior-neighbor corrections, and sliding points copy the
    y-correction of their level-local first interior neighbor (x forced
    to 0). Each call is one gather and one scatter over a map with
    unique destinations; values read the pre-scatter field. Never apply
    it to coordinate or residual fields. ``correction_planes`` glues the
    zebra smoother's correction into its two ghost-framed planes: with
    ``tables`` (``ops.glue.GlueTables``, from ``from_prep``) on CUDA
    tensors one launch of K-G, else ``correction`` between the mask and
    the split.

    The block-sharded glue (parallel.shard.ShardGlue) keeps this
    arithmetic and overrides where the sources are read: ``_frame``,
    ``_copies`` and ``_members``."""

    #: the level's K-G tables (ops.glue.GlueTables), or None: no kernel
    tables = None

    def __init__(self, src, dst, off, csrc, cdst, cw, jdst, jsrc, jw,
                 tables=None):
        self.src, self.dst, self.off = src, dst, off
        self.csrc, self.cdst, self.cw = csrc, cdst, cw
        self.jdst, self.jsrc, self.jw = jdst, jsrc, jw
        self.tables = tables

    @classmethod
    def from_prep(cls, gl, dtype):
        """The glue of ``gl``, one level of ``prep_glue_arrays``, with its
        K-G tables in f32."""
        cw, jw = gl["gcw"].to(dtype), gl["gjw"].to(dtype)
        tables = None
        if dtype == torch.float32:
            tables = kg.GlueTables(gl["smooth_mask"], gl["kg_code"],
                                   gl["kg_copy"], gl["kg_junction"], cw, jw)
        return cls(gl["gsrc"], gl["gdst"], gl["goff"].to(dtype),
                   gl["gcsrc"], gl["gcdst"], cw, gl["gjdst"], gl["gjsrc"],
                   jw, tables)

    def _frame(self, v, corr):
        """(the flat view of ``v`` padded by one ghost ring, the padded
        shape, the values the sources read besides it: none here)"""
        vg = F.pad(v, (0, 0, 1, 1, 1, 1))
        return vg.reshape(-1, v.shape[-1]), vg.shape, None

    def _copies(self, vf, far, corr):
        """The sources of the copy entries (``corr``: of the correction
        glue) in the padded flat field ``vf``."""
        return vf[self.csrc if corr else self.src]

    def _members(self, vf, far):
        """The junction masters' members (L, K, C)."""
        return vf[self.jsrc]

    def pad(self, v, coord_field=False):
        vf, shape, far = self._frame(v, False)
        vals = self._copies(vf, far, False)
        if coord_field:
            vals = vals + self.off
        vf.index_copy_(0, self.dst, vals)
        return vf.reshape(shape)

    def correction(self, v):
        vf, shape, far = self._frame(v, True)
        vals = self.cw * self._copies(vf, far, True)
        dst = self.cdst
        if self.jdst.shape[0]:
            jvals = torch.sum(self.jw[..., None] * self._members(vf, far),
                              dim=1)
            vals = torch.cat([vals, jvals], dim=0)
            dst = torch.cat([dst, self.jdst], dim=0)
        vf.index_copy_(0, dst, vals)
        return vf.reshape(shape)

    def correction_planes(self, v, mask):
        """The glued correction as two contiguous ghost-framed planes (x,
        y): ``v`` the level's (B, N, M, 2) field, or the two framed planes
        of a zebra half-sweep, whose interiors count only on the smooth
        ``mask`` (B, N, M). A glue with tables takes only the mask they
        were built from (the same tensor), since the kernel reads theirs."""
        planes = not isinstance(v, torch.Tensor)
        if self.tables is not None:
            if mask is not self.tables.mask:
                raise ValueError("correction_planes: not the smooth mask "
                                 "the glue's tables were built from")
            if (v[0] if planes else v).is_cuda:
                return kg.glue_planes(self.tables, v)
        if planes:
            v = kg.unframe_planes(*v, mask)
        vg = self.correction(v)
        return vg[..., 0].contiguous(), vg[..., 1].contiguous()


def glued_level_statics(glues, masks, maps, dtype):
    """The part of each level of the glued hierarchy that depends on the
    mesh alone, from its caller's per-level pieces: ``glues`` the levels'
    glue (``MapGlue`` or one with its interface), ``masks`` their smooth
    masks (interior + SMOOTHED faces), ``maps`` their transfer maps (None
    on a stride-2 level, else a dict of MAP_KEYS relative to the PARENT
    level). Each level holds those, its smooth mask as ``interior`` and
    the ghost-framed mask and color selectors of the zebra planes in
    ``dtype``."""
    out = []
    for glue, mask, mp in zip(glues, masks, maps):
        B, N, M = mask.shape
        mskp = _pad1(mask.to(dtype))
        odd_i = (torch.arange(N + 2, device=mask.device) + 1) % 2
        odd_j = (torch.arange(M + 2, device=mask.device) + 1) % 2
        odd_i = odd_i.view(1, N + 2, 1).to(dtype)
        odd_j = odd_j.view(1, 1, M + 2).to(dtype)

        def sel(odd, par):
            return (mskp * (odd == par).to(dtype)).contiguous()

        rec = dict(interior=mask, glue=glue, zebra=dict(
            msk=mskp.contiguous(),
            sel_j=(sel(odd_j, 0.0), sel(odd_j, 1.0)),
            sel_i=(sel(odd_i, 0.0), sel(odd_i, 1.0))))
        if mp is not None:
            rec.update(mp)
        out.append(rec)
    return out


def map_level_statics(glue_levels, dtype):
    """``glued_level_statics`` of one device's levels: glue, smooth masks
    and transfer maps from ``glue_levels``, prep_glue_arrays output."""
    return glued_level_statics(
        [MapGlue.from_prep(gl, dtype) for gl in glue_levels],
        [gl["smooth_mask"] for gl in glue_levels],
        [{k: gl[k] for k in MAP_KEYS} if "li_map" in gl else None
         for gl in glue_levels], dtype)


def build_glued_levels(base, cf, glue_levels):
    """Build the glued hierarchy. base/cf: (B, N, M, 2) padded stacks
    (finest); glue_levels: prep_glue_arrays output. The JAX package's
    entry point of the same name; the smoothers build their statics once
    and call ``iter_glued_levels``."""
    return list(iter_glued_levels(base, cf,
                                  map_level_statics(glue_levels, base.dtype)))


def iter_glued_levels(base, cf, statics):
    """The glued hierarchy one level at a time, finest first: a caller
    that keeps what it needs of a level lets the level's tensors go before
    the next is built. base/cf: (B, N, M, 2) padded stacks (finest);
    statics: ``glued_level_statics``, built once for a mesh, whose tensors
    and glue each level holds as they are. Level fields are
    ghost-augmented where needed; stencil coefficients use the GLUED base
    so face-row equations couple across blocks. Each level also carries
    the ghost-framed zebra planes its smoother sweeps over."""
    dt = base.dtype
    for lvl, st in enumerate(statics):
        if lvl > 0:
            if "li_map" in st:
                base = _subsample_mapped(base, st["li_map"], st["lj_map"])
                cf = _subsample_mapped(cf, st["li_map"], st["lj_map"])
            else:
                base = base[:, ::2, ::2, :]
                cf = cf[:, ::2, ::2, :]
        mask = st["interior"]
        baseg = st["glue"].pad(base, True)
        # glued metrics over the whole block region (faces included)
        x_xi = 0.5 * (baseg[:, 2:, 1:-1] - baseg[:, :-2, 1:-1])
        x_eta = 0.5 * (baseg[:, 1:-1, 2:] - baseg[:, 1:-1, :-2])
        g11 = torch.sum(x_xi * x_xi, dim=-1)
        g22 = torch.sum(x_eta * x_eta, dim=-1)
        g12 = torch.sum(x_xi * x_eta, dim=-1)
        one = torch.ones((), dtype=dt, device=base.device)
        diag = torch.where(mask, -2.0 * (g11 + g22), one)
        diag = torch.where(diag == 0.0, one, diag)

        P = cf[..., 0]
        Q = cf[..., 1]
        c_jp1 = g11 * (1 + 0.5 * Q)
        c_jm1 = g11 * (1 - 0.5 * Q)
        c_ip1 = g22 * (1 + 0.5 * P)
        c_im1 = g22 * (1 - 0.5 * P)
        zero = torch.zeros((), dtype=dt, device=base.device)
        # line tridiagonals: identity rows off the smooth mask
        lj = (torch.where(mask, c_jm1, zero), diag,
              torch.where(mask, c_jp1, zero))
        li = (torch.where(mask, c_im1, zero), diag,
              torch.where(mask, c_ip1, zero))

        g11e, g22e, g12e = g11[..., None], g22[..., None], g12[..., None]
        Pe, Qe = P[..., None], Q[..., None]
        stencil = dict(
            c_ij=-2.0 * g22e - 2.0 * g11e,
            c_ip=g22e * (1 + 0.5 * Pe), c_im=g22e * (1 - 0.5 * Pe),
            c_jp=g11e * (1 + 0.5 * Qe), c_jm=g11e * (1 - 0.5 * Qe),
            h=0.5 * g12e,
        )

        # ghost-framed zebra planes (one ghost ring, contiguous)
        zebra = dict(
            st["zebra"],
            bx=baseg[..., 0].contiguous(), by=baseg[..., 1].contiguous(),
            cfp=_pad1(P).contiguous(), cfq=_pad1(Q).contiguous(),
            li=tuple(_pad1(a, v).contiguous()
                     for a, v in zip(li, (0.0, 1.0, 0.0))),
            lj=tuple(_pad1(a, v).contiguous()
                     for a, v in zip(lj, (0.0, 1.0, 0.0))),
        )
        yield dict(st, baseg=baseg, cf=cf, stencil=stencil, zebra=zebra)


def _apply_glued(level, v):
    """Winslow stencil over the glued field; rows = smooth mask
    (interior + SMOOTHED connection faces). v is a correction field."""
    vg = level["glue"].correction(v)
    s = level["stencil"]
    out = (
        s["c_ij"] * vg[:, 1:-1, 1:-1]
        + s["c_ip"] * vg[:, 2:, 1:-1]
        + s["c_im"] * vg[:, :-2, 1:-1]
        + s["c_jp"] * vg[:, 1:-1, 2:]
        + s["c_jm"] * vg[:, 1:-1, :-2]
        - s["h"] * vg[:, 2:, 2:]
        + s["h"] * vg[:, 2:, :-2]
        + s["h"] * vg[:, :-2, 2:]
        - s["h"] * vg[:, :-2, :-2]
    )
    return torch.where(level["interior"][..., None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _smooth_glued(level, r, z, directions="ij"):
    """Zebra line relaxation over the glued mesh: for each direction in
    ``directions`` ("i": lines along i colored by j parity, then "j":
    lines along j colored by i parity; "ij" runs both, "i" or "j" one at
    half the cost) and each color, glue the correction into the
    ghost-framed planes, then one zebra half-sweep (residual + line solve
    + colored update) on them. The correction stays in the planes from
    the first half-sweep to the last; each glue reads the planes' values
    on the smooth mask only (the glue wrote master values into slave rows;
    corrections live on smoothed rows, and the glue re-syncs them each
    apply), and so does the field returned."""
    zb = level["zebra"]
    glue, mask = level["glue"], level["interior"]
    rx, ry = kg.frame_planes(r)
    passes = []
    if "i" in directions:  # lines along i, each color of j parity
        passes += [(zb["li"], 0, sel) for sel in zb["sel_j"]]
    if "j" in directions:  # lines along j, each color of i parity
        passes += [(zb["lj"], 1, sel) for sel in zb["sel_i"]]
    for (dl, d, du), axis, sel in passes:
        zx, zy = glue.correction_planes(z, mask)
        z = zebra_half_sweep(
            zb["bx"], zb["by"], zb["cfp"], zb["cfq"], dl, d, du, zb["msk"],
            sel, rx, ry, zx, zy, axis=axis)
    return kg.unframe_planes(*z, mask)


def _gather_axis(a, idx, dim):
    """take_along_axis(a, idx, dim, mode="clip") for a (B, N, M, C) stack
    with a (B, K) per-block index along ``dim`` (1 or 2)."""
    idx = idx.clamp(0, a.shape[dim] - 1)
    shape = list(a.shape)
    shape[dim] = idx.shape[1]
    view = [idx.shape[0], 1, 1, 1]
    view[dim] = idx.shape[1]
    return torch.gather(a, dim, idx.view(view).expand(shape))


def _subsample_mapped(a, im, jm):
    """Per-block gather subsample of a (B, N, M, C) stack with the
    boundary-aligned lattice maps im (B, Nc) / jm (B, Mc)."""
    return _gather_axis(_gather_axis(a, im, 1), jm, 2)


def _prolong(zc, fine_shape):
    """Bilinear prolongation from the stride-2 coarse grid."""
    B, Nf, Mf = fine_shape
    Nc, Mc = zc.shape[1:3]
    z = torch.zeros((B, Nf, Mf, 2), dtype=zc.dtype, device=zc.device)
    z[:, : 2 * Nc - 1 : 2, : 2 * Mc - 1 : 2, :] = zc
    # odd i rows: average vertical coarse neighbors
    zi = 0.5 * (z[:, : Nf - 2 : 2, :, :] + z[:, 2::2, :, :])
    z[:, 1 : Nf - 1 : 2, :, :] = zi[:, : (Nf - 1) // 2, :, :]
    # odd j cols: average horizontal neighbors (covers diagonals too since
    # odd-i rows are already filled)
    zj = 0.5 * (z[:, :, : Mf - 2 : 2, :] + z[:, :, 2::2, :])
    z[:, :, 1 : Mf - 1 : 2, :] = zj[:, :, : (Mf - 1) // 2, :]
    return z


def _prolong_mapped(zc, fine_shape, plo_i, pw_i, plo_j, pw_j):
    """Linear prolongation along per-block bracketing maps (the
    boundary-aligned generalization of _prolong; identical values on
    stride-2 aligned lattices)."""
    nc_i = zc.shape[1]
    wi = pw_i.to(zc.dtype)[:, :, None, None]
    z1 = (_gather_axis(zc, plo_i, 1) * (1.0 - wi)
          + _gather_axis(zc, torch.clamp(plo_i + 1, max=nc_i - 1), 1) * wi)
    nc_j = zc.shape[2]
    wj = pw_j.to(zc.dtype)[:, None, :, None]
    z2 = (_gather_axis(z1, plo_j, 2) * (1.0 - wj)
          + _gather_axis(z1, torch.clamp(plo_j + 1, max=nc_j - 1), 2) * wj)
    return z2


def _restrict_glued(level, r, coarse):
    """Full-weighting restriction using glued residual ghosts, so the
    stencil at a face point weights the partner block's residuals. When
    the coarse level carries boundary-aligned lattice maps the 3x3 stencil
    gathers at the mapped parent ordinals instead of stride-2 slicing."""
    B, Nc, Mc = coarse["interior"].shape
    rp = level["glue"].pad(r)
    im = coarse.get("li_map")

    if im is None:
        def at(di, dj):
            return rp[:, 1 + di : 1 + di + 2 * Nc - 1 : 2,
                      1 + dj : 1 + dj + 2 * Mc - 1 : 2, :]
    else:
        jm = coarse["lj_map"]
        rows = {di: _gather_axis(rp, im + 1 + di, 1) for di in (-1, 0, 1)}

        def at(di, dj):
            return _gather_axis(rows[di], jm + 1 + dj, 2)

    return (4.0 * at(0, 0)
            + 2.0 * (at(1, 0) + at(-1, 0) + at(0, 1) + at(0, -1))
            + (at(1, 1) + at(1, -1) + at(-1, 1) + at(-1, -1))) / 16.0


def vcycle_half_sweeps(n_levels, pre=1, post=1, coarse_iters=4,
                       pre_dirs="ij", post_dirs="ij"):
    """The zebra half-sweeps (kernel launches) of one v_cycle_glued call on
    ``n_levels`` levels: two colors a direction, the smooths of the
    schedule on every level above the coarsest, ``coarse_iters``
    alternating ("ij") smooths on the coarsest."""
    return (2 * (n_levels - 1) * (pre * len(pre_dirs) + post * len(post_dirs))
            + 4 * coarse_iters)


def v_cycle_glued(levels, r, level_idx=0, pre=1, post=1, coarse_iters=4,
                  pre_dirs="ij", post_dirs="ij"):
    """Glued multigrid V-cycle (recursion over the level list): ``pre``
    smooths over ``pre_dirs`` before the coarse correction on each level
    and ``post`` over ``post_dirs`` after it, ``coarse_iters`` alternating
    ("ij") smooths on the coarsest. Each level glues with its own
    ``glue``."""
    level = levels[level_idx]
    mask = level["interior"][..., None]
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    r = torch.where(mask, r, zero)
    z = torch.zeros_like(r)

    if level_idx == len(levels) - 1:
        for _ in range(coarse_iters):
            z = _smooth_glued(level, r, z)
        return z

    for _ in range(pre):
        z = _smooth_glued(level, r, z, pre_dirs)

    res = torch.where(mask, r - _apply_glued(level, z), zero)
    coarse = levels[level_idx + 1]
    # undivided stencils scale as h^4, so A_c ~ 16 A_f on smooth modes
    rc = 16.0 * _restrict_glued(level, res, coarse)
    zc = v_cycle_glued(levels, rc, level_idx + 1, pre, post, coarse_iters,
                       pre_dirs, post_dirs)
    if coarse.get("pi_lo") is not None:
        zf = _prolong_mapped(zc, tuple(level["interior"].shape),
                             coarse["pi_lo"], coarse["pi_w"],
                             coarse["pj_lo"], coarse["pj_w"])
    else:
        zf = _prolong(zc, tuple(level["interior"].shape))
    z = z + torch.where(mask, zf, zero)

    for _ in range(post):
        z = _smooth_glued(level, r, z, post_dirs)
    return z
