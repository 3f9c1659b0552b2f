"""Inter-block "glue" maps for the multigrid hierarchy.

The round-1/round-2 interior-only V-cycle preconditioned each block with
zero-Dirichlet interfaces, which leaves error modes that are smooth
ACROSS a connection untouched — measured as a large cluster of
barely-preconditioned eigenvalues (GMRES needed ~200 iterations on the
T106 O4H mesh regardless of preconditioner precision). The fix is the
classic parallel-multigrid one: connection face points participate in
the relaxation at EVERY level, with one ghost layer per block face
filled from the partner block (SURVEY.md §7.1 "boundary kinds as masks
and exchange rules"; the reference couples these rows exactly through
its global CSR, smooth.zig:994-1105).

This module precomputes, per multigrid level, a static gather map in the
ghost-augmented padded-stack space (B, N_l+2, M_l+2):

- ghost entries: the out-of-block stencil neighbor of a SMOOTHED
  connection-face point <- the partner block's first interior point
  (minus the connection periodicity for coordinate fields);
- slave entries: CONNECTED face points <- their master point (+ the
  slave offset for coordinate fields),

so one ``Xg.at[dst].set(Xg[src] + s*off)`` glues the whole mesh. At
coarse levels only lattice-aligned points are glued (others degrade to
the zero-Dirichlet behavior — acceptable in a preconditioner).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .classify import BoundaryInfo, Kind


@dataclasses.dataclass
class GlueLevel:
    """Static per-level glue data. N, M are the level's padded block
    dims (without ghosts); indices are ghost-space flat
    (b*(N+2)*(M+2) + (i+1)*(M+2) + (j+1) for a block point (i, j)).

    The ``c*``/``j*`` arrays are CORRECTION-FIELD-ONLY entries: they embed
    the sliding rows (y copies the level-local first interior neighbor)
    and the junction rows (master <- mean of the members' level-local
    interior neighbors) into every relaxation pass, so the V-cycle's
    interior solve sees consistent boundary corrections instead of
    Dirichlet-0 walls. Without them those rows are preconditioned only by
    the one interface Jacobi step outside the V-cycle, and the resulting
    interior<->boundary block Gauss-Seidel owns the Krylov iteration
    count (measured round 3: the mid-solve residual concentrates on the
    ~230 sliding/junction rows at 5-10x the interior norm). They must NOT
    be applied to coordinate or residual fields."""

    N: int
    M: int
    smooth_mask: np.ndarray   # (B, N, M) bool — interior + SMOOTHED faces
    src: np.ndarray           # (G,)
    dst: np.ndarray           # (G,)
    off: np.ndarray           # (G, 2) — added to coordinate fields only
    # correction-only sliding/slave-like copies (channel-weighted)
    csrc: np.ndarray          # (Gc,)
    cdst: np.ndarray          # (Gc,)
    cw: np.ndarray            # (Gc, 2) per-channel weights
    # correction-only junction neighbor means
    jdst: np.ndarray          # (L,)
    jsrc: np.ndarray          # (L, K) ghost-space stencil (padded w/ dst)
    jw: np.ndarray            # (L, K) weights (0 padding)
    # boundary-aligned coarsening maps (build_glue(keep_boundaries=True)
    # only, and only on levels where the plain [::2] lattice would lose
    # a block's far boundary — None means "this level is stride-2
    # aligned, use the fast slicing transfers"). li/lj map this level's
    # ordinals to PARENT-level ordinals; p*_lo/p*_w give, per PARENT
    # ordinal, the bracketing coarse ordinal and the weight of
    # ordinal+1 for linear prolongation.
    li_map: np.ndarray | None = None   # (B, N)
    lj_map: np.ndarray | None = None   # (B, M)
    pi_lo: np.ndarray | None = None    # (B, N_parent)
    pi_w: np.ndarray | None = None     # (B, N_parent)
    pj_lo: np.ndarray | None = None    # (B, M_parent)
    pj_w: np.ndarray | None = None     # (B, M_parent)


def _subsample_positions(n: int) -> np.ndarray:
    """Coarse lattice positions inside a length-n parent lattice, always
    keeping BOTH endpoints. For odd n this is exactly [0, 2, ..., n-1]
    (the plain stride-2 lattice); for even n the stride-2 lattice loses
    the far endpoint — the boundary line the coarse level must represent
    as Dirichlet — so the positions are rounded-uniform with one
    irregular interval instead (e.g. n=6 -> [0, 2, 5])."""
    nc = (n - 1) // 2 + 1
    if nc <= 1:
        return np.zeros(1, dtype=np.int64)
    return np.rint(np.linspace(0, n - 1, nc)).astype(np.int64)


def _bracket(pos: np.ndarray, nf: int):
    """Per parent ordinal f in [0, nf): bracketing coarse ordinal lo and
    the linear weight w of ordinal lo+1, so that
    value(f) = (1-w)*z[lo] + w*z[min(lo+1, nc-1)]. Exact lattice points
    get w=0."""
    f = np.arange(nf)
    hi = np.clip(np.searchsorted(pos, f, side="left"), 0, len(pos) - 1)
    lo = np.where(pos[hi] > f, np.maximum(hi - 1, 0), hi)
    nxt = np.minimum(lo + 1, len(pos) - 1)
    den = np.maximum(pos[nxt] - pos[lo], 1)
    w = (f - pos[lo]) / den
    return lo.astype(np.int64), w.astype(np.float64)


def _decode_shift(shift: int, nj: int):
    """Block-local flat shift -> (di, dj) unit step (shift in {±1, ±nj})."""
    if abs(shift) == 1:
        return 0, int(np.sign(shift))
    return int(shift // nj), 0


def build_glue(mesh, info: BoundaryInfo, N: int, M: int,
               min_size: int = 5, n_levels: int | None = None,
               transposed=None, keep_boundaries: bool = False):
    """Build per-level glue maps + smooth masks for the padded stack.

    Returns a list of GlueLevel, finest first, with the same ladder the
    multigrid uses ((n-1)//2+1 coarsening of the padded dims).

    ``keep_boundaries``: coarsen each block's lattice with
    _subsample_positions (both endpoints always kept) instead of plain
    [::2]. With [::2], any block axis of even lattice length loses its
    far boundary at the next level and the coarse grid imposes
    Dirichlet-0 on what is an interior fine line, up to 2^level cells
    inside the block — at scales whose sizes go even high in the ladder
    (e.g. 1501 -> 751 -> 376) this collapses the V-cycle's coarse
    correction over widening strips and was measured as a near-total
    preconditioner stall (contraction ~0.995/iteration at 5.4M nodes).
    Levels whose lattices are stride-2 aligned anyway get no maps
    (li_map=None), so aligned ladders keep byte-identical programs.

    ``transposed``: optional (B,) bool from DevicePlan — blocks stored
    (j, i) in the padded stack. All positions/lattices below are in the
    STORAGE frame; decode handles the logical->storage swap.
    """
    sizes_log = [b.size for b in mesh.blocks]
    B = len(sizes_log)
    if transposed is None:
        transposed = np.zeros(B, dtype=bool)
    sizes = [(nj, ni) if t else (ni, nj)
             for (ni, nj), t in zip(sizes_log, transposed)]  # storage
    starts = mesh.block_row_starts()
    kind = info.kind
    sizes_j_log = np.array([nj for _, nj in sizes_log], dtype=np.int64)

    def decode_global(g):
        """global flat id -> (block, i, j) in the STORAGE frame"""
        b = int(np.searchsorted(starts, g, side="right") - 1)
        r = int(g - starts[b])
        nj = sizes_log[b][1]
        i, j = r // nj, r % nj
        return (b, j, i) if transposed[b] else (b, i, j)

    def decode_global_vec(g):
        """vectorized decode: (G,) global ids -> storage (b, i, j)"""
        g = np.asarray(g, dtype=np.int64)
        b = np.searchsorted(starts, g, side="right") - 1
        r = g - np.asarray(starts)[b]
        nj = sizes_j_log[b]
        i, j = r // nj, r % nj
        t = transposed[b]
        return b, np.where(t, j, i), np.where(t, i, j)

    # per-level sampled fine indices per block + padded dims
    ii = [np.arange(ni) for ni, nj in sizes]
    jj = [np.arange(nj) for ni, nj in sizes]
    Nl, Ml = N, M
    levels = []
    lvl = 0
    pending_maps = {}  # coarsening maps attached to the NEXT level
    while True:
        # inverse lattice lookups
        inv_i = [np.full(sizes[b][0], -1, dtype=np.int64) for b in range(B)]
        inv_j = [np.full(sizes[b][1], -1, dtype=np.int64) for b in range(B)]
        for b in range(B):
            inv_i[b][ii[b]] = np.arange(len(ii[b]))
            inv_j[b][jj[b]] = np.arange(len(jj[b]))

        Ng, Mg = Nl + 2, Ml + 2

        def gflat(b, ci, cj):
            return b * Ng * Mg + (ci + 1) * Mg + (cj + 1)

        # smooth mask: INTERIOR + SMOOTHED at lattice points
        smooth = np.zeros((B, Nl, Ml), dtype=bool)
        for b in range(B):
            ni, nj = sizes[b]
            ni_l, nj_l = sizes_log[b]
            kb = kind[starts[b] : starts[b] + ni_l * nj_l].reshape(ni_l, nj_l)
            if transposed[b]:
                kb = kb.T
            ks = kb[np.ix_(ii[b], jj[b])]
            ok = (ks == Kind.INTERIOR) | (ks == Kind.SMOOTHED)
            # the [::2]-per-level lattice loses the block's far boundary
            # whenever the index-list length is even; the last lattice
            # row is then a fine-INTERIOR point whose coarse stencil
            # reads the zero pad beyond the block — near-zero metric
            # diagonals there made the coarse zebra sweeps amplify
            # residuals ~100-1000x (measured level 2+, rounds 1-3).
            # Treat that row as the boundary instead (Dirichlet at the
            # nearest on-lattice line): stable, and only shifts the
            # coarse BC by one fine cell.
            if ii[b][-1] != ni - 1:
                ok[-1, :] = False
            if jj[b][-1] != nj - 1:
                ok[:, -1] = False
            smooth[b, : len(ii[b]), : len(jj[b])] = ok

        src_l, dst_l, off_l = [], [], []

        def nearest_lattice(f, b, axis):
            """Fine index -> nearest lattice ORDINAL on this level.

            Exact when the fine index is on the lattice; otherwise rounds
            to the nearest lattice point — coarse-level glue must NOT
            demand exact alignment: connection ranges start at arbitrary
            offsets, so requiring both sides on-lattice loses almost all
            entries below level ~2 (measured: 1690 -> 217 -> 47 -> 6 on
            the scale-1 T106), leaving smooth across-interface error
            modes without any coarse correction — which was the dominant
            Krylov cost. A nearest-point ghost is plenty for a
            preconditioner. searchsorted (not rint(f/2^level)) because
            keep_boundaries lattices are not exact powers-of-two grids."""
            lat = (ii if axis == 0 else jj)[b]
            f = np.asarray(f)
            if len(lat) == 1:
                return np.zeros(f.shape, dtype=np.int64)
            k = np.clip(np.searchsorted(lat, f), 1, len(lat) - 1)
            lo, hi = lat[k - 1], lat[k]
            return np.where(f - lo <= hi - f, k - 1, k)

        # ghost entries per connection (side-0 SMOOTHED rows are relaxed;
        # side-1 faces are slaves whose adjacent interiors need no ghosts)
        for cm in info.conn_meta:
            b0, i00, j00 = decode_global(int(cm.g0[0]))
            b1, i10, j10 = decode_global(int(cm.g1[0]))
            nj0, nj1 = sizes_log[b0][1], sizes_log[b1][1]

            def shift_st(shift, nj, b):
                di, dj = _decode_shift(shift, nj)
                return (dj, di) if transposed[b] else (di, dj)

            di_f0, dj_f0 = shift_st(cm.fis0, nj0, b0)   # into block 0
            di_f1, dj_f1 = shift_st(cm.fis1, nj1, b1)   # into block 1
            di_c0, dj_c0 = shift_st(cm.cs0, nj0, b0)    # along face, side 0
            di_c1, dj_c1 = shift_st(cm.cs1, nj1, b1)
            pi = (np.zeros(2) if cm.periodicity is None
                  else np.asarray(cm.periodicity, dtype=np.float64))
            L = len(cm.g0)
            k = np.arange(L)
            i0, j0 = i00 + k * di_c0, j00 + k * dj_c0
            i1, j1 = i10 + k * di_c1, j10 + k * dj_c1
            # side-0 face points must exist on this level (they carry the
            # relaxed rows); partner positions round to nearest lattice
            c_i0, c_j0 = inv_i[b0][i0], inv_j[b0][j0]
            ok = (c_i0 >= 0) & (c_j0 >= 0)
            if not np.any(ok):
                continue
            c_i0, c_j0 = c_i0[ok], c_j0[ok]
            n1i, n1j = len(ii[b1]), len(jj[b1])
            c_i1 = nearest_lattice(i1[ok], b1, 0)
            c_j1 = nearest_lattice(j1[ok], b1, 1)
            # partner first interior = one LEVEL step inward
            s_i1 = np.clip(c_i1 + di_f1, 0, n1i - 1)
            s_j1 = np.clip(c_j1 + dj_f1, 0, n1j - 1)
            # ghost position: one lattice step OUTSIDE block 0
            dst_l.append(gflat(b0, c_i0 - di_f0, c_j0 - dj_f0))
            src_l.append(gflat(b1, s_i1, s_j1))
            off_l.append(np.broadcast_to(-pi, (int(ok.sum()), 2)))

        # slave entries (x_s = x_m + off; corrections copy exactly);
        # masters round to the nearest lattice face point
        if len(info.slave_ids):
            bs, is_, js = decode_global_vec(info.slave_ids)
            bm, im, jm = decode_global_vec(info.master_ids)
            c_is = np.array([inv_i[b][i] for b, i in zip(bs, is_)])
            c_js = np.array([inv_j[b][j] for b, j in zip(bs, js)])
            ok = (c_is >= 0) & (c_js >= 0)
            if np.any(ok):
                bs_, bm_ = bs[ok], bm[ok]

                def _nearest_vec(f, blocks, lats):
                    out = np.empty(len(f), dtype=np.int64)
                    for b in np.unique(blocks):
                        m = blocks == b
                        lat = lats[b]
                        if len(lat) == 1:
                            out[m] = 0
                            continue
                        k = np.clip(np.searchsorted(lat, f[m]),
                                    1, len(lat) - 1)
                        lo, hi = lat[k - 1], lat[k]
                        out[m] = np.where(f[m] - lo <= hi - f[m], k - 1, k)
                    return out

                c_im = _nearest_vec(im[ok], bm_, ii)
                c_jm = _nearest_vec(jm[ok], bm_, jj)
                dst_l.append(gflat(bs_, c_is[ok], c_js[ok]))
                src_l.append(gflat(bm_, c_im, c_jm))
                off_l.append(np.asarray(info.slave_offsets,
                                        dtype=np.float64)[ok])

        src = (np.concatenate(src_l) if src_l
               else np.empty(0, np.int64)).astype(np.int64)
        dst = (np.concatenate(dst_l) if dst_l
               else np.empty(0, np.int64)).astype(np.int64)
        off = (np.concatenate(off_l).reshape(-1, 2) if off_l
               else np.empty((0, 2), np.float64))

        # correction-only sliding embedding: y(sliding pt) <- y(level-local
        # first interior neighbor); x forced to 0 (its correction is 0)
        csrc, cdst, cw = [], [], []
        for gs, gn in zip(info.sliding_ids, info.sliding_neighbor_ids):
            bs, i_s, j_s = decode_global(int(gs))
            _, i_n, j_n = decode_global(int(gn))
            di = int(np.sign(i_n - i_s))
            dj = int(np.sign(j_n - j_s))
            c_is, c_js = inv_i[bs][i_s], inv_j[bs][j_s]
            if min(c_is, c_js) < 0:
                continue
            c_in, c_jn = c_is + di, c_js + dj
            if not (0 <= c_in < len(ii[bs]) and 0 <= c_jn < len(jj[bs])):
                continue
            cdst.append(gflat(bs, c_is, c_js))
            csrc.append(gflat(bs, c_in, c_jn))
            cw.append((0.0, 1.0))

        # correction-only junction embedding: master <- mean of the
        # members' level-local interior neighbors (the row's exact solve
        # for r=0; same neighbor topology as classify._interior_neighbors)
        from .classify import _interior_neighbors

        jdst, jsrc, jw = [], [], []
        for lp in info.laplacian_points:
            bm, i_m, j_m = decode_global(int(lp.global_id))
            c_im, c_jm = inv_i[bm][i_m], inv_j[bm][j_m]
            if min(c_im, c_jm) < 0:
                continue
            nbrs = []
            for gid, _per in lp.overlapping:
                b2, i2, j2 = decode_global(int(gid))
                c_i2, c_j2 = inv_i[b2][i2], inv_j[b2][j2]
                if min(c_i2, c_j2) < 0:
                    continue
                for pi_, pj_ in _interior_neighbors(
                        int(c_i2), int(c_j2), len(ii[b2]), len(jj[b2])):
                    nbrs.append(gflat(b2, pi_, pj_))
            if not nbrs:
                continue
            jdst.append(gflat(bm, c_im, c_jm))
            jsrc.append(nbrs)
            jw.append([1.0 / len(nbrs)] * len(nbrs))

        K = max((len(s_) for s_ in jsrc), default=1)
        jsrc_a = np.zeros((len(jdst), K), dtype=np.int64)
        jw_a = np.zeros((len(jdst), K), dtype=np.float64)
        for li, (d_, s_, w_) in enumerate(zip(jdst, jsrc, jw)):
            jsrc_a[li, :] = d_          # padding reads dst (weight 0)
            jsrc_a[li, : len(s_)] = s_
            jw_a[li, : len(w_)] = w_

        levels.append(GlueLevel(
            N=Nl, M=Ml, smooth_mask=smooth,
            src=np.asarray(src, dtype=np.int64),
            dst=np.asarray(dst, dtype=np.int64),
            off=(np.asarray(off, dtype=np.float64).reshape(-1, 2)),
            csrc=np.asarray(csrc, dtype=np.int64),
            cdst=np.asarray(cdst, dtype=np.int64),
            cw=np.asarray(cw, dtype=np.float64).reshape(-1, 2),
            jdst=np.asarray(jdst, dtype=np.int64),
            jsrc=jsrc_a,
            jw=jw_a,
            **pending_maps,
        ))

        if (n_levels is not None and len(levels) >= n_levels) or \
           min(Nl, Ml) <= min_size or \
           all(min(len(ii[b]), len(jj[b])) <= min_size for b in range(B)):
            break
        Nc = (Nl - 1) // 2 + 1
        Mc = (Ml - 1) // 2 + 1
        pending_maps = {}
        if keep_boundaries:
            pos_i = [_subsample_positions(len(a)) for a in ii]
            pos_j = [_subsample_positions(len(a)) for a in jj]
            aligned = all(
                len(p) == 1 or np.array_equal(p, 2 * np.arange(len(p)))
                for p in pos_i + pos_j)
            if not aligned:
                li = np.zeros((B, Nc), dtype=np.int64)
                lj = np.zeros((B, Mc), dtype=np.int64)
                pil = np.zeros((B, Nl), dtype=np.int64)
                piw = np.zeros((B, Nl), dtype=np.float64)
                pjl = np.zeros((B, Ml), dtype=np.int64)
                pjw = np.zeros((B, Ml), dtype=np.float64)
                for b in range(B):
                    li[b, : len(pos_i[b])] = pos_i[b]
                    li[b, len(pos_i[b]):] = pos_i[b][-1]
                    lj[b, : len(pos_j[b])] = pos_j[b]
                    lj[b, len(pos_j[b]):] = pos_j[b][-1]
                    lo, w = _bracket(pos_i[b], len(ii[b]))
                    pil[b, : len(lo)], piw[b, : len(lo)] = lo, w
                    pil[b, len(lo):] = lo[-1]
                    lo, w = _bracket(pos_j[b], len(jj[b]))
                    pjl[b, : len(lo)], pjw[b, : len(lo)] = lo, w
                    pjl[b, len(lo):] = lo[-1]
                pending_maps = dict(li_map=li, lj_map=lj,
                                    pi_lo=pil, pi_w=piw,
                                    pj_lo=pjl, pj_w=pjw)
            ii = [a[p] for a, p in zip(ii, pos_i)]
            jj = [a[p] for a, p in zip(jj, pos_j)]
        else:
            ii = [a[::2] for a in ii]
            jj = [a[::2] for a in jj]
        Nl, Ml = Nc, Mc
        lvl += 1

    return levels
