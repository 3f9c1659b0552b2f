"""Block-sharded multi-GPU elliptic smoothing over ``torch.distributed``.

The structured-grid analog of spatial parallelism: the padded block stack
is cut into ``D`` contiguous slices, one per rank (one process per GPU, or
several ranks on one card or the CPU under gloo). Cross-block references
(connection-partner stencils, junction stencils, slave masters) travel
point-to-point: for every active ring offset ``o`` each rank gathers
exactly the values its offset-``o`` neighbour needs and sends one packed
chunk (``dist.exchange``), so a rank's traffic is proportional to its
shared perimeter. Dot products are a local sum and one ``all_reduce``.

The plans are NumPy, copied from the JAX package (``ShardLayout``: the
exchange schedules, the per-rank row tables padded to a common length
with ``*_valid`` masks, the connection-chain tables and the split glue
maps of every multigrid level); each rank keeps its own slice.

The solve is the single-device one: ``ShardedSmoother`` subclasses
``DeviceSmoother`` and overrides only what moves data across ranks (the
stage-S and stage-F exchanges, the dot product, the V-cycle's per-level
glue ``ShardGlue``, the host transfers and the control-function update).
Every rank runs the same f64 FGMRES, the same f32 composition
``_stage_Minv`` (Schur or base, ``mg_opts``) and the same zebra kernel on
its slice, eagerly: the sharded path captures no CUDA graph.

Counterpart of turbomesh_tpu/parallel/shard.py (``ShardedSmoother``).
"""

from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import torch

from . import dist as pdist
from ..smoothing.classify import BoundaryInfo
from ..smoothing.device import DeviceSmoother, build_plan, plan_tensors
from ..smoothing.multigrid import MapGlue, glued_level_statics


@dataclasses.dataclass
class Exchange:
    """Static point-to-point exchange schedule.

    For each active ring offset ``o`` (0 = same-device gather), device
    ``s`` sends the values of its local flat indices ``send_idx[o][s]``
    to device ``(s+o) % D``; the receiver concatenates the chunks in
    offset order into a value table VAL, and every remote reference reads
    VAL at a precomputed position.
    """

    offsets: list          # active offsets, ascending, 0 first if present
    send_idx: dict         # o -> (D, L_o) int array of sender-local flats
    lengths: dict          # o -> L_o
    base: dict             # o -> start of o's chunk within VAL
    total: int             # VAL length


class _ExchangeBuilder:
    """Accumulates remote references (vectorized — no per-point Python);
    slot assignment is deferred to finalize(), which dedupes per
    (receiving device, ring offset) with one np.unique per group. All
    positions() calls must precede the single finalize()."""

    def __init__(self, D, Bl, N, M):
        self.D, self.Bl, self.N, self.M = D, Bl, N, M
        self._dev, self._off, self._lf = [], [], []
        self._n = 0
        self._val_pos = None

    def positions(self, own_dev, refs):
        """own_dev: (R,) receiving device per row; refs: (R,) global padded
        flat indices. Returns (R,) provisional handles for resolve()."""
        refs = np.asarray(refs, dtype=np.int64).ravel()
        own_dev = np.broadcast_to(
            np.asarray(own_dev, dtype=np.int64), refs.shape)
        NM = self.N * self.M
        blk = refs // NM
        self._dev.append(own_dev.copy())
        self._off.append((own_dev - blk // self.Bl) % self.D)
        self._lf.append((blk % self.Bl) * NM + refs % NM)
        start, self._n = self._n, self._n + len(refs)
        return np.arange(start, self._n, dtype=np.int64)

    def finalize(self):
        D = self.D
        cat = (lambda xs: np.concatenate(xs) if xs
               else np.empty(0, np.int64))
        dev, off, lf = cat(self._dev), cat(self._off), cat(self._lf)
        offsets = sorted(set(off.tolist())) or [0]
        self._val_pos = np.zeros(len(lf), dtype=np.int64)
        lengths, base, send_idx, acc = {}, {}, {}, 0
        for o in offsets:
            sel_o = off == o
            uniq = [np.unique(lf[sel_o & (dev == d)]) for d in range(D)]
            L = max((len(u) for u in uniq), default=0) or 1
            lengths[o], base[o] = L, acc
            buf = np.zeros((D, L), dtype=np.int64)
            for s in range(D):
                u = uniq[(s + o) % D]
                buf[s, : len(u)] = u
            send_idx[o] = buf
            for d in range(D):
                rows = np.nonzero(sel_o & (dev == d))[0]
                if len(rows):
                    self._val_pos[rows] = acc + np.searchsorted(
                        uniq[d], lf[rows])
            acc += L
        return Exchange(offsets=offsets, send_idx=send_idx,
                        lengths=lengths, base=base, total=acc)

    def resolve(self, ex: Exchange, provisional):
        """(R,) provisional handles -> (R,) VAL positions."""
        return self._val_pos[np.asarray(provisional, dtype=np.int64)]


@dataclasses.dataclass
class ShardPlanArrays:
    """Per-device plan arrays, stacked over devices (leading axis D) and
    padded to the max row count; `*_valid` masks mark real rows. ``*_v``
    fields index the exchanged value table VAL."""

    # connection middle rows
    c_row: np.ndarray; c_g0m: np.ndarray; c_g0p: np.ndarray; c_in0: np.ndarray
    c_d0m: np.ndarray; c_d0p: np.ndarray
    c_in1v: np.ndarray; c_d1mv: np.ndarray; c_d1pv: np.ndarray
    c_pi: np.ndarray; c_swap: np.ndarray; c_valid: np.ndarray
    # junction rows (stencil via VAL)
    l_row: np.ndarray; l_stencil_v: np.ndarray; l_weight: np.ndarray
    l_rhs: np.ndarray; l_valid: np.ndarray
    # sliding rows (local)
    s_row: np.ndarray; s_nb: np.ndarray; s_valid: np.ndarray
    # slave substitution (master via stage-S VAL)
    sl_row: np.ndarray; sl_master_v: np.ndarray; sl_off: np.ndarray
    sl_valid: np.ndarray


class ShardLayout:
    """The NumPy plans of a mesh cut into ``D`` rank slices: blocks padded
    to a common (N, M) in the logical frame (``build_plan(...,
    transpose=False)``), B padded with inert dummy blocks to a multiple of
    D, rank r owning blocks [r*Bl, (r+1)*Bl). No torch, no process group:
    the attributes are the JAX ``ShardedSmoother``'s, bit for bit."""

    def __init__(self, mesh, info: BoundaryInfo, D: int):
        # sharded path keeps logical storage (transpose=False): its shard
        # plans, halo schedules and glue splits are built in the logical
        # frame; the single-chip DeviceSmoother carries the transposed
        # layout (see device.build_plan)
        plan = build_plan(mesh, info, transpose=False)
        self.base_plan = plan
        B0, N, M = plan.B, plan.N, plan.M
        B = ((B0 + D - 1) // D) * D  # pad with dummy blocks
        self.B, self.N, self.M, self.D = B, N, M, D
        self.Bl = B // D

        # global (B,N,M) masks, padded blocks inert
        interior = np.zeros((B, N, M), dtype=bool)
        interior[:B0] = plan.interior_mask
        free = np.zeros((B, N, M, 2), dtype=bool)
        free[:B0] = plan.free_mask
        self.interior_mask = interior
        self.free_mask = free

        self.scatter_idx = plan.scatter_idx  # into (B0*N*M); B padding appended after

        # glued multigrid ladder: smooth masks (interior + SMOOTHED faces)
        # padded to B blocks; glue maps split into local / cross-device.
        # keep_boundaries: boundary-aligned coarse lattices — with plain
        # [::2] lattices any block axis of even lattice length loses its
        # far boundary at the next level and the coarse Dirichlet moves
        # up to 2^level cells inside the block (the near-total V-I
        # preconditioner stall measured single-chip at 5.4M nodes; see
        # glue.build_glue). The per-BLOCK transfer maps are sliced per
        # rank (mg_maps below).
        from ..smoothing.glue import build_glue

        self.glue_levels = build_glue(mesh, info, N, M,
                                      keep_boundaries=True)
        self.mg_masks = []
        self.mg_maps = []   # per level: None | dict of per-block arrays
        for gl in self.glue_levels:
            m = np.zeros((B, gl.N, gl.M), dtype=bool)
            m[:B0] = gl.smooth_mask
            self.mg_masks.append(m)
            if gl.li_map is None:
                self.mg_maps.append(None)
            else:
                def padB(a):
                    out = np.zeros((B,) + a.shape[1:], dtype=a.dtype)
                    out[:B0] = a
                    return out

                self.mg_maps.append(dict(
                    li_map=padB(gl.li_map), lj_map=padB(gl.lj_map),
                    pi_lo=padB(gl.pi_lo), pi_w=padB(gl.pi_w),
                    pj_lo=padB(gl.pj_lo), pj_w=padB(gl.pj_w)))

        self._build_shard_plans(mesh, info)
        self._build_glue_plans()

    # ------------------------------------------------------------------ plans

    def _split_pad_stack(self, rows_block, arrays, D, pad_values):
        """Split row-arrays by owning device, pad to max count, stack (D, C)."""
        per_dev = [[] for _ in range(D)]
        for k, blk in enumerate(rows_block):
            per_dev[blk // self.Bl].append(k)
        cmax = max((len(x) for x in per_dev), default=0)
        cmax = max(cmax, 1)
        out = []
        for arr, padv in zip(arrays, pad_values):
            shp = (D, cmax) + arr.shape[1:]
            buf = np.full(shp, padv, dtype=arr.dtype)
            for d in range(D):
                sel = per_dev[d]
                if sel:
                    buf[d, : len(sel)] = arr[sel]
            out.append(buf)
        valid = np.zeros((D, cmax), dtype=bool)
        for d in range(D):
            valid[d, : len(per_dev[d])] = True
        return out, valid

    def _build_shard_plans(self, mesh, info):
        plan = self.base_plan
        B, N, M, D, Bl = self.B, self.N, self.M, self.D, self.Bl

        def pad_to_bij(padded_idx):
            """padded flat (B0*N*M) -> (block, i, j)"""
            b, r = np.divmod(padded_idx, N * M)
            i, j = np.divmod(r, M)
            return b, i, j

        def to_local(padded_idx):
            """padded flat -> owning-device local flat."""
            b, i, j = pad_to_bij(padded_idx)
            lb = b % Bl
            return (lb * N + i) * M + j

        # owning device per row
        c_dev = pad_to_bij(plan.c_row)[0] // Bl
        l_dev = (pad_to_bij(plan.l_row)[0] // Bl if len(plan.l_row)
                 else np.empty(0, np.int64))
        s_dev = (pad_to_bij(plan.s_row)[0] // Bl if len(plan.s_row)
                 else np.empty(0, np.int64))
        sl_dev = (pad_to_bij(plan.sl_row)[0] // Bl if len(plan.sl_row)
                  else np.empty(0, np.int64))

        # stage-S exchange: slave masters (raw field values)
        bS = _ExchangeBuilder(D, Bl, N, M)
        sl_prov = bS.positions(sl_dev, plan.sl_master)
        self.ex_S = bS.finalize()
        sl_master_v = bS.resolve(self.ex_S, sl_prov)

        # stage-F exchange: stencil references (substituted field values)
        bF = _ExchangeBuilder(D, Bl, N, M)
        c_in1_p = bF.positions(c_dev, plan.c_in1)
        c_d1m_p = bF.positions(c_dev, plan.c_d1m)
        c_d1p_p = bF.positions(c_dev, plan.c_d1p)
        K = plan.l_stencil.shape[1] if plan.l_stencil.ndim == 2 else 1
        l_st_p = [bF.positions(l_dev, plan.l_stencil[:, k]) for k in range(K)] \
            if len(plan.l_row) else []
        self.ex_F = bF.finalize()
        c_in1v = bF.resolve(self.ex_F, c_in1_p)
        c_d1mv = bF.resolve(self.ex_F, c_d1m_p)
        c_d1pv = bF.resolve(self.ex_F, c_d1p_p)
        l_st_v = (np.stack([bF.resolve(self.ex_F, pk) for pk in l_st_p], axis=1)
                  if len(plan.l_row) else np.empty((0, K), np.int64))

        c_row_b = pad_to_bij(plan.c_row)[0]
        (c_arr, c_valid) = self._split_pad_stack(
            c_row_b,
            [to_local(plan.c_row), to_local(plan.c_g0m), to_local(plan.c_g0p),
             to_local(plan.c_in0), to_local(plan.c_d0m), to_local(plan.c_d0p),
             c_in1v, c_d1mv, c_d1pv,
             plan.c_pi, plan.c_swap_pq],
            D,
            [0, 0, 0, 0, 0, 0, 0, 0, 0, 0.0, False],
        )

        l_row_b = pad_to_bij(plan.l_row)[0] if len(plan.l_row) else np.empty(0, np.int64)
        (l_arr, l_valid) = self._split_pad_stack(
            l_row_b,
            [to_local(plan.l_row) if len(plan.l_row) else np.empty(0, np.int64),
             l_st_v, plan.l_weight, plan.l_rhs],
            D,
            [0, 0, 0.0, 0.0],
        )

        s_row_b = pad_to_bij(plan.s_row)[0] if len(plan.s_row) else np.empty(0, np.int64)
        (s_arr, s_valid) = self._split_pad_stack(
            s_row_b,
            [to_local(plan.s_row) if len(plan.s_row) else np.empty(0, np.int64),
             to_local(plan.s_nb) if len(plan.s_nb) else np.empty(0, np.int64)],
            D,
            [0, 0],
        )

        sl_row_b = pad_to_bij(plan.sl_row)[0] if len(plan.sl_row) else np.empty(0, np.int64)
        (sl_arr, sl_valid) = self._split_pad_stack(
            sl_row_b,
            [to_local(plan.sl_row) if len(plan.sl_row) else np.empty(0, np.int64),
             sl_master_v,
             plan.sl_off],
            D,
            [0, 0, 0.0],
        )

        # per-device connection-chain segment tables (indices into the
        # device's padded c-row arrays). Chains live on one device (the
        # range-0 block's owner); rows of one chain stay consecutive.
        C = len(plan.c_row)
        c_conn = np.zeros(C, dtype=np.int64)
        for s in range(plan.c_seg.shape[0]):
            sel = plan.c_seg[s][plan.c_seg_valid[s]]
            c_conn[sel] = s
        per_dev = [[] for _ in range(D)]
        for k, blk in enumerate(c_row_b):
            per_dev[blk // Bl].append(k)
        dev_tables = []
        for d in range(D):
            sel = per_dev[d]
            runs = []
            for pos, k in enumerate(sel):
                if runs and c_conn[k] == runs[-1][0]:
                    runs[-1][1].append(pos)
                else:
                    runs.append((c_conn[k], [pos]))
            dev_tables.append([r[1] for r in runs])
        S_max = max((len(t) for t in dev_tables), default=1) or 1
        L_max = max((len(run) for t in dev_tables for run in t), default=1) or 1
        cseg = np.zeros((D, S_max, L_max), dtype=np.int64)
        cseg_valid = np.zeros((D, S_max, L_max), dtype=bool)
        for d, t in enumerate(dev_tables):
            for s, run in enumerate(t):
                cseg[d, s, : len(run)] = run
                cseg_valid[d, s, : len(run)] = True
        self.cseg = cseg
        self.cseg_valid = cseg_valid

        self.shard_plan = ShardPlanArrays(
            c_row=c_arr[0], c_g0m=c_arr[1], c_g0p=c_arr[2], c_in0=c_arr[3],
            c_d0m=c_arr[4], c_d0p=c_arr[5],
            c_in1v=c_arr[6], c_d1mv=c_arr[7], c_d1pv=c_arr[8],
            c_pi=c_arr[9], c_swap=c_arr[10], c_valid=c_valid,
            l_row=l_arr[0], l_stencil_v=l_arr[1], l_weight=l_arr[2],
            l_rhs=l_arr[3], l_valid=l_valid,
            s_row=s_arr[0], s_nb=s_arr[1], s_valid=s_valid,
            sl_row=sl_arr[0], sl_master_v=sl_arr[1], sl_off=sl_arr[2],
            sl_valid=sl_valid,
        )

    def _build_glue_plans(self):
        """Split each multigrid level's glue map (smoothing/glue.py) into
        same-device entries (local gather in ghost space) and cross-device
        entries (ppermute exchange of the referenced region values)."""
        D, Bl = self.D, self.Bl
        self.glue_local = []   # per level: (arrays, valid)
        self.glue_cross = []   # per level: (arrays, valid)
        self.glue_ex = []      # per level: Exchange
        self.glue_corr = []    # per level: (Exchange, per-rank dicts)

        for gl in self.glue_levels:
            Ng, Mg = gl.N + 2, gl.M + 2
            NgMg = Ng * Mg
            src_b = gl.src // NgMg
            dst_b = gl.dst // NgMg
            same = (src_b // Bl) == (dst_b // Bl)

            def ghost_local(g):
                return (g // NgMg % Bl) * NgMg + g % NgMg

            (larr, lvalid) = self._split_pad_stack(
                dst_b[same],
                [ghost_local(gl.src[same]), ghost_local(gl.dst[same]),
                 gl.off[same]],
                D, [0, 0, 0.0])

            # cross-device: sources are in-region points of remote blocks;
            # ship them as region-flat values via a per-level exchange
            cross = ~same
            bx = _ExchangeBuilder(D, Bl, gl.N, gl.M)
            if np.any(cross):
                gsrc = gl.src[cross]
                b = gsrc // NgMg
                rem = gsrc % NgMg
                i = rem // Mg - 1
                j = rem % Mg - 1
                region_global = (b * gl.N + i) * gl.M + j
                prov = bx.positions(dst_b[cross] // Bl, region_global)
                ex = bx.finalize()
                pos = bx.resolve(ex, prov)
            else:
                ex = bx.finalize()
                pos = np.empty(0, np.int64)
            (xarr, xvalid) = self._split_pad_stack(
                dst_b[cross],
                [ghost_local(gl.dst[cross]), pos, gl.off[cross]],
                D, [0, 0, 0.0])

            self.glue_local.append((larr, lvalid))
            self.glue_cross.append((xarr, xvalid))
            self.glue_ex.append(ex)
            self.glue_corr.append(self._split_correction(gl))

    def _split_correction(self, gl):
        """Level ``gl``'s CORRECTION glue (multigrid.MapGlue.correction) cut
        into rank slices: the plain map made unique per destination (last
        entry wins), minus the destinations a sliding (``c*``) or junction
        (``j*``) entry owns, plus those entries, as ``prep_glue_arrays``
        builds it for one device. Sources on the destination's rank are
        ghost-space local indices; the others are positions in the level's
        correction exchange, which carries the plain map's cross-rank
        sources and the correction ones (one exchange a call). Returns
        (Exchange, [per-rank dict]) with the copy entries ``src`` (local),
        ``pos`` (exchanged), ``dst``/``w`` (local first, then exchanged)
        and the junction rows ``jdst``, ``jloc``/``jpos``/``jrem`` (L, K)
        and ``jw``, in the single-device order."""
        from ..smoothing.multigrid import _last_unique

        D, Bl = self.D, self.Bl
        Mg = gl.M + 2
        NgMg = (gl.N + 2) * Mg

        def ghost_local(g):
            return (g // NgMg % Bl) * NgMg + g % NgMg

        def region(g):
            rem = g % NgMg
            return ((g // NgMg) * gl.N + rem // Mg - 1) * gl.M + rem % Mg - 1

        u = _last_unique(gl.dst)
        keep = ~np.isin(gl.dst[u], np.concatenate([gl.cdst, gl.jdst]))
        src = np.concatenate([gl.src[u][keep], gl.csrc])
        dst = np.concatenate([gl.dst[u][keep], gl.cdst])
        w = np.concatenate([np.ones((int(keep.sum()), 2)),
                            gl.cw.reshape(-1, 2)])
        own = dst // NgMg // Bl
        same = src // NgMg // Bl == own
        jown = gl.jdst // NgMg // Bl
        jsame = gl.jsrc // NgMg // Bl == jown[:, None]

        bx = _ExchangeBuilder(D, Bl, gl.N, gl.M)
        prov = bx.positions(own[~same], region(src[~same]))
        jprov = bx.positions(np.broadcast_to(jown[:, None],
                                             gl.jsrc.shape)[~jsame],
                             region(gl.jsrc[~jsame]))
        ex = bx.finalize()
        pos = np.zeros(len(src), dtype=np.int64)
        pos[~same] = bx.resolve(ex, prov)
        jpos = np.zeros(gl.jsrc.shape, dtype=np.int64)
        jpos[~jsame] = bx.resolve(ex, jprov)
        jloc = np.where(jsame, ghost_local(gl.jsrc), 0)

        ranks = []
        for r in range(D):
            loc, crs, jr = (own == r) & same, (own == r) & ~same, jown == r
            ranks.append(dict(
                src=ghost_local(src[loc]), pos=pos[crs],
                dst=ghost_local(np.concatenate([dst[loc], dst[crs]])),
                w=np.concatenate([w[loc], w[crs]]),
                jdst=ghost_local(gl.jdst[jr]), jloc=jloc[jr], jpos=jpos[jr],
                jrem=~jsame[jr], jw=gl.jw[jr]))
        return ex, ranks

    def glue_last_wins(self, lvl):
        """(local, cross) (D, cmax) bool tables aligned with glue_local /
        glue_cross of level ``lvl``: True on the entry that writes each
        destination last in the level's glue map. The JAX package's split
        glue adds ``val - cur`` for every entry, so a destination listed
        twice ends at ``v1 + v2 - cur``; keeping only the last entry makes
        each write the plain copy the single-device glue makes
        (``multigrid._last_unique``)."""
        from ..smoothing.multigrid import _last_unique

        gl = self.glue_levels[lvl]
        NgMg = (gl.N + 2) * (gl.M + 2)
        last = np.zeros(len(gl.dst), dtype=bool)
        last[_last_unique(gl.dst)] = True
        src_b, dst_b = gl.src // NgMg, gl.dst // NgMg
        same = (src_b // self.Bl) == (dst_b // self.Bl)
        (loc,), _ = self._split_pad_stack(dst_b[same], [last[same]],
                                          self.D, [False])
        (crs,), _ = self._split_pad_stack(dst_b[~same], [last[~same]],
                                          self.D, [False])
        return loc, crs


class ShardGlue(MapGlue):
    """A level's glue on one rank: ``MapGlue``'s arithmetic, with every
    source either a local ghost-space index (``src``, ``csrc``, ``jsrc``)
    or a position in the values the level's exchange brings from the
    other ranks (``pos``, ``cpos``; ``jpos`` where ``jrem``). Each call
    makes one exchange, on every rank: ``ex``/``send`` for ``pad``,
    ``cex``/``csend`` for ``correction``. Destinations are written from
    local sources first, then exchanged ones; junction members keep the
    single-device order, so a world of 1 glues as one device does."""

    def __init__(self, plain, corr, dtype, tensor, send):
        """plain, corr: this rank's plain and correction tables
        (ShardedSmoother._rank_glue); tensor(a, dtype) puts an array on
        the rank's device, send(ex) the rank's send indices of an
        exchange; weights and offsets in ``dtype``."""
        def idx(a):
            return tensor(a, torch.int64)

        super().__init__(idx(plain["src"]), idx(plain["dst"]),
                         tensor(plain["off"], dtype),
                         idx(corr["src"]), idx(corr["dst"]),
                         tensor(corr["w"], dtype),
                         idx(corr["jdst"]), idx(corr["jloc"]),
                         tensor(corr["jw"], dtype))
        self.pos, self.cpos = idx(plain["pos"]), idx(corr["pos"])
        self.jpos = idx(corr["jpos"])
        self.jrem = tensor(corr["jrem"], torch.bool)
        self.ex, self.send = plain["ex"], send(plain["ex"])
        self.cex, self.csend = corr["ex"], send(corr["ex"])

    def _frame(self, v, corr):
        vf, shape, _ = super()._frame(v, corr)
        ex, send = (self.cex, self.csend) if corr else (self.ex, self.send)
        return vf, shape, pdist.exchange(ex, send,
                                         v.reshape(-1, v.shape[-1]))

    def _copies(self, vf, far, corr):
        return torch.cat([super()._copies(vf, far, corr),
                          far[self.cpos if corr else self.pos]], dim=0)

    def _members(self, vf, far):
        return torch.where(self.jrem[..., None], far[self.jpos],
                           super()._members(vf, far))


class ShardedSmoother(DeviceSmoother):
    """Block-sharded multi-GPU drop-in for DeviceSmoother: one rank of a
    ``torch.distributed`` group (initialised from torchrun's environment
    or as a world of 1 when none exists). Every rank of the group
    constructs one on the same mesh and calls the same methods; ``solve``
    and ``run`` take and return global host arrays, the same on every
    rank. Defaults as the JAX package's ShardedSmoother."""

    adaptive_forcing = False
    junction_deflation = False

    def __init__(self, mesh, info: BoundaryInfo, *, device,
                 rtol: float = 1e-12, atol: float = 1e-14,
                 restart: int = 30, max_restarts: int = 400,
                 deflation: str | None = None,
                 mg_opts: dict | None = None):
        """deflation: as DeviceSmoother's, modes "y" and "xy" only (the
        columns are block-partitioned: W^T r is a local contraction and
        one all-gather, the K x K solve runs on every rank); the junction
        mode "j" raises ValueError. mg_opts: as DeviceSmoother's, where
        ``schur``, ``interface_passes`` and ``deflation`` take effect; a
        schedule key (SCHEDULE_KEYS) away from its default raises
        ValueError, since the sharded hierarchy and V-cycle run the
        default schedule (as the JAX package's sharded path does), and
        ``adaptive_rtol`` has no effect (the loop keeps a fixed
        tolerance)."""
        import torch.distributed as dist

        deflation = self._set_mg_opts(mg_opts, deflation)
        odd = [k for k in self.SCHEDULE_KEYS
               if self.mg_opts[k] != self.MG_DEFAULTS[k]]
        if odd:
            raise ValueError(f"mg_opts {odd}: the V-cycle schedule and depth "
                             f"are single-device only: use DeviceSmoother, "
                             f"or the defaults here")
        pdist.ensure_group(device)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.device = pdist.rank_device(device)
        self.layout = lay = ShardLayout(mesh, info, self.world)
        self.plan = lay.base_plan
        self._mesh = mesh
        self.rtol = rtol
        self.atol = atol
        self.restart = restart
        self.max_restarts = max_restarts
        self._shape = (lay.Bl, lay.N, lay.M)
        self._lo, self._hi = self.rank * lay.Bl, (self.rank + 1) * lay.Bl
        tens = plan_tensors(self._rank_plan(), self.device)
        self._p64 = tens["p64"]
        self._p32 = tens["p32"]
        self._send_S = self._send(lay.ex_S)
        self._send_F = self._send(lay.ex_F)
        self._mg_static = glued_level_statics(
            [self._rank_glue(lvl, torch.float32)
             for lvl in range(len(lay.glue_levels))],
            [self._t(m[self._lo:self._hi]) for m in lay.mg_masks],
            [None if mp is None else
             {k: self._t(v[self._lo:self._hi],
                         torch.float64 if k.endswith("_w") else torch.int64)
              for k, v in mp.items()}
             for mp in lay.mg_maps], torch.float32)
        # logical-frame block extents; padding blocks are empty (keep = 0)
        sizes = [b.size for b in mesh.blocks]
        sizes += [(0, 0)] * (lay.B - len(sizes))
        self._setup_deflation(deflation, sizes, lay.N, lay.M, lay.free_mask,
                              np.empty(0, np.int64))
        self.last_linear_residual = float("nan")
        self.last_linear_converged = False
        self.last_restarts = 0
        self.last_run_rtols = []

    # -- this rank's slice of the plans ------------------------------------

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _send(self, ex):
        return {o: self._t(ex.send_idx[o][self.rank], torch.int64)
                for o in ex.offsets}

    def _rank_plan(self):
        """This rank's rows, in the DevicePlan fields the stages read:
        local flat indices for local references, exchange-table positions
        for ``c_in1``, ``c_d1m``, ``c_d1p``, ``l_stencil`` (stage F) and
        ``sl_master`` (stage S). The padded tables are cut to their valid
        rows (a prefix), so every scatter writes unique rows."""
        lay, r = self.layout, self.rank
        sp = lay.shard_plan
        nc, nl, ns, nsl = (int(v[r].sum()) for v in (
            sp.c_valid, sp.l_valid, sp.s_valid, sp.sl_valid))
        return types.SimpleNamespace(
            interior_mask=lay.interior_mask[self._lo:self._hi],
            free_mask=lay.free_mask[self._lo:self._hi],
            c_row=sp.c_row[r, :nc], c_g0m=sp.c_g0m[r, :nc],
            c_g0p=sp.c_g0p[r, :nc], c_in0=sp.c_in0[r, :nc],
            c_in1=sp.c_in1v[r, :nc], c_d0m=sp.c_d0m[r, :nc],
            c_d0p=sp.c_d0p[r, :nc], c_d1m=sp.c_d1mv[r, :nc],
            c_d1p=sp.c_d1pv[r, :nc], c_pi=sp.c_pi[r, :nc],
            c_swap_pq=sp.c_swap[r, :nc],
            c_seg=lay.cseg[r], c_seg_valid=lay.cseg_valid[r],
            l_row=sp.l_row[r, :nl], l_stencil=sp.l_stencil_v[r, :nl],
            l_weight=sp.l_weight[r, :nl], l_rhs=sp.l_rhs[r, :nl],
            s_row=sp.s_row[r, :ns], s_nb=sp.s_nb[r, :ns],
            sl_row=sp.sl_row[r, :nsl], sl_master=sp.sl_master_v[r, :nsl],
            sl_off=sp.sl_off[r, :nsl])

    def _rank_glue(self, lvl, dtype):
        """Level ``lvl``'s ``ShardGlue`` for this rank, weights and
        offsets in ``dtype``: of the plain map the local (ghost-space src
        -> dst) and cross-rank (exchange position -> dst) entries that are
        valid and write their destination last, and the rank's slice of
        the correction map (ShardLayout._split_correction)."""
        lay, r = self.layout, self.rank
        (lsrc, ldst, loff), lvalid = lay.glue_local[lvl]
        (xdst, xpos, xoff), xvalid = lay.glue_cross[lvl]
        lkeep, xkeep = lay.glue_last_wins(lvl)
        lk = lvalid[r] & lkeep[r]
        xk = xvalid[r] & xkeep[r]
        cex, crank = lay.glue_corr[lvl]
        plain = dict(ex=lay.glue_ex[lvl], src=lsrc[r][lk], pos=xpos[r][xk],
                     dst=np.concatenate([ldst[r][lk], xdst[r][xk]]),
                     off=np.concatenate([loff[r][lk], xoff[r][xk]]))
        return ShardGlue(plain, dict(crank[r], ex=cex), dtype, self._t,
                         self._send)

    # -- the hooks of DeviceSmoother -----------------------------------------

    def _remote_S(self, Xf):
        return pdist.exchange(self.layout.ex_S, self._send_S, Xf)

    def _remote_F(self, Vf):
        return pdist.exchange(self.layout.ex_F, self._send_F, Vf)

    def _dot(self, x, y):
        return pdist.pdot(x, y)

    def _norm(self, x):
        return torch.sqrt(pdist.pdot(x, x))

    def _coarse_vector(self, part):
        return pdist.all_gather_stack(part).reshape(-1)

    # -- host transfers and the control-function update --------------------

    def _pad_global(self, field):
        """(P, 2) global-space field -> this rank's (Bl, N, M, 2) slice."""
        lay = self.layout
        buf = np.zeros((lay.B * lay.N * lay.M, 2))
        buf[: self.plan.B * lay.N * lay.M][lay.scatter_idx] = field
        buf = buf.reshape(lay.B, lay.N, lay.M, 2)[self._lo:self._hi]
        return torch.as_tensor(buf, dtype=torch.float64, device=self.device)

    def _upload(self, coords, cf):
        # logical frame: the control function needs no component swap
        return self._pad_global(coords), self._pad_global(cf)

    def _coords_to_host(self, X) -> np.ndarray:
        Xg = pdist.all_gather_stack(X)[: self.plan.B]
        return self.plan.unpad_coords(Xg.cpu().numpy())

    def _cf_to_host(self, C) -> np.ndarray:
        Cg = pdist.all_gather_stack(C)[: self.plan.B]
        return self.plan.unpad_cf(Cg.cpu().numpy())

    def _device_update(self, algorithm):
        """The White update reads across blocks (the leading-edge junction
        reads blocks 0 and 1), so each call gathers the coordinate stack,
        updates a control function every rank holds whole (the same
        arithmetic on the same data on every rank) and returns this rank's
        slice of it."""
        from ..smoothing.control_function import make_device_update

        upd = make_device_update(algorithm, self._mesh, self.plan)
        if upd is None:   # a control function with no update (Laplace)
            return None
        whole = {}

        def update(X, C):
            if "C" not in whole:
                whole["C"] = pdist.all_gather_stack(C)
            whole["C"] = upd(pdist.all_gather_stack(X), whole["C"])
            return whole["C"][self._lo:self._hi]

        return update


def run_tasks(tasks, *, device):
    """Spawn target (``dist.spawn(functools.partial(run_tasks,
    device=device), D, backend, device, args=(tasks,))``): for each task,
    a dict with ``mesh`` and ``cf`` (global host arrays) and optionally
    ``solves``, ``iterations``, ``algorithm``, ``target_residual`` and
    ``smoother`` (ShardedSmoother keywords), build a ShardedSmoother on
    this rank, do ``solves``
    successive linearized solves at the fixed cf, then one ``run`` of
    ``iterations`` Picard iterations. Returns this rank's records: the
    solutions, the run's result and histories, its seconds, its coarse
    space's size ``defl_K``, this rank's zebra launches, its chain rows and
    chain-kernel launches, and its exchanges and all_reduces with the host
    seconds spent in them."""
    from ..ops import chain, zebra
    from ..smoothing.classify import classify

    recs = []
    for task in tasks:
        mesh, cf = task["mesh"], task["cf"]
        sm = ShardedSmoother(mesh, classify(mesh), device=device,
                             **task.get("smoother", {}))
        cuda = sm.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(sm.device)
            torch.cuda.reset_peak_memory_stats(sm.device)
        zebra.ZEBRA_LAUNCHES = chain.CHAIN_LAUNCHES = 0
        pdist.EXCHANGES = pdist.ALL_REDUCES = 0
        pdist.COLLECTIVE_S = 0.0
        rec = dict(rank=sm.rank, world=sm.world, solves=[], restarts=[],
                   defl_K=sm._defl_K)
        t0 = time.perf_counter()
        coords = mesh.flat_coords()
        for _ in range(task.get("solves", 0)):
            coords = sm.solve(coords, cf)
            rec["solves"].append(coords)
            rec["restarts"].append(sm.last_restarts)
        if task.get("iterations"):
            hist, rhist = [], []
            out = sm.run(mesh.flat_coords(), cf, task["iterations"],
                         algorithm=task.get("algorithm"),
                         target_residual=task.get("target_residual"),
                         residual_history=hist, restart_history=rhist)
            rec.update(coords=out[0], cf=out[1], disp=out[2],
                       n_done=out[3], residual_history=hist,
                       restart_history=rhist)
        if cuda:
            torch.cuda.synchronize(sm.device)
            rec["peak_mib"] = (torch.cuda.max_memory_allocated(sm.device)
                               / 2**20)
        rec.update(seconds=time.perf_counter() - t0,
                   converged=sm.last_linear_converged,
                   zebra_launches=zebra.ZEBRA_LAUNCHES,
                   chain_rows=int(sm._p32["c_row"].shape[0]),
                   chain_launches=chain.CHAIN_LAUNCHES,
                   exchanges=pdist.EXCHANGES, all_reduces=pdist.ALL_REDUCES,
                   collective_s=pdist.COLLECTIVE_S)
        recs.append(rec)
    return recs
