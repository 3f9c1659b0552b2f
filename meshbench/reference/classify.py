"""Boundary-point classification for multi-block elliptic smoothing.

Reference parity: smooth.zig:1168-1174 (point kinds), 1212-1529
(BlockBoundaryPoints incl. junction/"laplacian" point detection) and the
classification order in BlockBoundaryPoints.init (smooth.zig:1234-1332):

1. every boundary point starts ``FIXED``;
2. junction points (duplicated connection endpoints) form groups: the
   lowest-global-id member is ``LAPLACIAN`` (solved by a small junction
   stencil), the others ``CONNECTED`` slaves of it;
3. inlet/outlet BC ranges become ``SLIDING`` (x pinned, y follows the
   first interior neighbor);
4. per connection, in order: middle points are ``SMOOTHED`` on side 0
   (full Winslow stencil spanning both blocks) and ``CONNECTED`` on
   side 1; an endpoint whose side-0 partner is FIXED/SLIDING makes the
   side-1 endpoint CONNECTED.

The output is static topology metadata (index arrays) consumed by both the
host oracle solver and the TPU device solver.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from .boundary import BCKind


class Kind(enum.IntEnum):
    INTERIOR = 0
    FIXED = 1
    SMOOTHED = 2
    CONNECTED = 3
    LAPLACIAN = 4
    SLIDING = 5


@dataclasses.dataclass
class LaplacianPoint:
    """A junction point group (smooth.zig:1219-1232)."""

    # (global_id, periodicity (2,)) sorted by global id; [0] is the master
    overlapping: list[tuple[int, np.ndarray]]
    stencil_ids: np.ndarray  # sorted global ids incl. the master itself
    rhs: np.ndarray  # (2,) accumulated periodicity

    @property
    def global_id(self) -> int:
        return self.overlapping[0][0]


@dataclasses.dataclass
class ConnectionMeta:
    """Precomputed per-connection index arithmetic (smooth.zig:1531-1599)."""

    g0: np.ndarray  # global ids along range 0 (incl. endpoints)
    g1: np.ndarray  # global ids along range 1
    cs0: int  # in-connection direction shift, side 0 (flat, block-local == global)
    cs1: int
    fis0: int  # first-internal-point shift, side 0
    fis1: int
    periodicity: np.ndarray | None  # (2,) or None


@dataclasses.dataclass
class BoundaryInfo:
    kind: np.ndarray  # (P,) int8 Kind per global point
    laplacian_points: list[LaplacianPoint]
    conn_meta: list[ConnectionMeta]
    # slave -> (master, offset): x_slave = x_master + offset
    slave_ids: np.ndarray  # (S,)
    master_ids: np.ndarray  # (S,)
    slave_offsets: np.ndarray  # (S, 2)
    # sliding points: x pinned at initial value, y = y[neighbor]
    sliding_ids: np.ndarray  # (L,)
    sliding_neighbor_ids: np.ndarray  # (L,)


def _range_globals(mesh, rng, starts) -> np.ndarray:
    size = mesh.blocks[rng.block].size
    return starts[rng.block] + rng.flat_indices(size)


def classify(mesh) -> BoundaryInfo:
    starts = mesh.block_row_starts()
    P = mesh.num_points
    kind = np.zeros(P, dtype=np.int8)

    # step 1: boundary points FIXED, interior INTERIOR
    for b, s in zip(mesh.blocks, starts):
        ni, nj = b.size
        k = np.full((ni, nj), Kind.FIXED, dtype=np.int8)
        k[1:-1, 1:-1] = Kind.INTERIOR
        kind[s : s + ni * nj] = k.reshape(-1)

    # connection metadata
    conn_meta = []
    for conn in mesh.connections:
        r0, r1 = conn.ranges
        s0, s1 = mesh.blocks[r0.block].size, mesh.blocks[r1.block].size
        conn_meta.append(
            ConnectionMeta(
                g0=_range_globals(mesh, r0, starts),
                g1=_range_globals(mesh, r1, starts),
                cs0=r0.in_connection_direction_shift(s0),
                cs1=r1.in_connection_direction_shift(s1),
                fis0=r0.first_internal_point_shift(s0),
                fis1=r1.first_internal_point_shift(s1),
                periodicity=None
                if conn.periodicity is None
                else np.asarray(conn.periodicity, dtype=np.float64),
            )
        )

    # step 2: junction ("laplacian") points
    laplacian_points = _find_laplacian_points(mesh, starts, conn_meta)
    for lp in laplacian_points:
        kind[lp.global_id] = Kind.LAPLACIAN
        for gid, _ in lp.overlapping[1:]:
            kind[gid] = Kind.CONNECTED

    # step 3: inlet/outlet BC ranges -> SLIDING
    for bc in mesh.boundary_conditions:
        if bc.kind in (BCKind.INLET, BCKind.OUTLET):
            kind[_range_globals(mesh, bc.range, starts)] = Kind.SLIDING

    # step 4: connections, in order
    for cm in conn_meta:
        # first endpoint
        if kind[cm.g0[0]] in (Kind.FIXED, Kind.SLIDING):
            kind[cm.g1[0]] = Kind.CONNECTED
        # middle
        kind[cm.g0[1:-1]] = Kind.SMOOTHED
        kind[cm.g1[1:-1]] = Kind.CONNECTED
        # second endpoint
        if kind[cm.g0[-1]] in (Kind.FIXED, Kind.SLIDING):
            kind[cm.g1[-1]] = Kind.CONNECTED

    # master/slave equality map. Mirrors the matrix rows the reference
    # builds for CONNECTED points: laplacian-group slaves follow the group
    # master (smooth.zig:738-747); connection side-1 points follow their
    # side-0 partner (smooth.zig:639-693). Later writes win, as in the
    # reference's in-place entry rewrites, so assemble in the same order
    # and deduplicate keeping the last assignment.
    slave_map: dict[int, tuple[int, np.ndarray]] = {}
    zero2 = np.zeros(2)
    for lp in laplacian_points:
        for gid, _ in lp.overlapping[1:]:
            slave_map[gid] = (lp.global_id, zero2)
    for cm in conn_meta:
        off = cm.periodicity if cm.periodicity is not None else zero2
        # middle pairs always; endpoints only when the side-0 endpoint is
        # FIXED/SLIDING (smooth.zig:695-721 switches on the side-0 kind)
        pairs = [(cm.g0[k], cm.g1[k]) for k in range(1, len(cm.g0) - 1)]
        if kind[cm.g0[0]] in (Kind.FIXED, Kind.SLIDING):
            pairs.append((cm.g0[0], cm.g1[0]))
        if kind[cm.g0[-1]] in (Kind.FIXED, Kind.SLIDING):
            pairs.append((cm.g0[-1], cm.g1[-1]))
        for a, b in pairs:
            if kind[b] == Kind.CONNECTED:
                slave_map[int(b)] = (int(a), off)

    # The reference applies the periodic RHS (x1 = x0 + pi) for *every*
    # point pair of a periodic connection (smooth.zig:904-915), which can
    # override a laplacian-slave's offset set above; replicate by a final
    # periodic pass over slaves that belong to periodic connections.
    for cm in conn_meta:
        if cm.periodicity is None:
            continue
        for a, b in zip(cm.g0, cm.g1):
            if int(b) in slave_map:
                slave_map[int(b)] = (slave_map[int(b)][0], cm.periodicity)

    slave_ids = np.array(sorted(slave_map), dtype=np.int64)
    master_ids = np.array([slave_map[s][0] for s in slave_ids], dtype=np.int64)
    slave_offsets = np.array([slave_map[s][1] for s in slave_ids], dtype=np.float64)
    if len(slave_ids) == 0:
        slave_offsets = slave_offsets.reshape(0, 2)

    # sliding points and their first interior neighbors
    sliding_ids, sliding_nb = [], []
    for bc in mesh.boundary_conditions:
        if bc.kind not in (BCKind.INLET, BCKind.OUTLET):
            continue
        size = mesh.blocks[bc.range.block].size
        shift = bc.range.first_internal_point_shift(size)
        for g in _range_globals(mesh, bc.range, starts):
            if kind[g] == Kind.SLIDING:
                sliding_ids.append(int(g))
                sliding_nb.append(int(g) + shift)

    return BoundaryInfo(
        kind=kind,
        laplacian_points=laplacian_points,
        conn_meta=conn_meta,
        slave_ids=slave_ids,
        master_ids=master_ids,
        slave_offsets=slave_offsets,
        sliding_ids=np.array(sliding_ids, dtype=np.int64),
        sliding_neighbor_ids=np.array(sliding_nb, dtype=np.int64),
    )


def _find_laplacian_points(mesh, starts, conn_meta) -> list[LaplacianPoint]:
    """Junction detection by duplicate connection-endpoint global ids
    (smooth.zig:1340-1455), replicated including the grouping/merge order."""
    n_conn = len(mesh.connections)
    # flat endpoint ids: per connection [r0.start, r1.start, r0.end, r1.end]
    endpoint_ids = np.empty(n_conn * 4, dtype=np.int64)
    for cid, cm in enumerate(conn_meta):
        endpoint_ids[cid * 4 + 0] = cm.g0[0]
        endpoint_ids[cid * 4 + 1] = cm.g1[0]
        endpoint_ids[cid * 4 + 2] = cm.g0[-1]
        endpoint_ids[cid * 4 + 3] = cm.g1[-1]

    def conn_periodicity(cid: int) -> np.ndarray:
        p = conn_meta[cid].periodicity
        return np.zeros(2) if p is None else p

    groups: list[list[tuple[int, np.ndarray]]] = []

    def append_if_unique(group, gid, periodicity):
        for g, _ in group:
            if g == gid:
                return
        group.append((int(gid), periodicity))

    n = len(endpoint_ids)
    for ei in range(n - 1):
        e = endpoint_ids[ei]
        for ej in range(ei + 1, n):
            if endpoint_ids[ej] != e:
                continue
            found = False
            for group in groups:
                if any(g == e for g, _ in group):
                    found = True
                    partner = ej + 1 if ej % 2 == 0 else ej - 1
                    cid = partner // 4
                    append_if_unique(group, endpoint_ids[partner], conn_periodicity(cid))
            if not found:
                pair_i, pair_j = ei // 2, ej // 2
                assert pair_i != pair_j
                group: list[tuple[int, np.ndarray]] = []
                cid_i = pair_i // 2
                per_i = conn_periodicity(cid_i)
                group.append((int(endpoint_ids[pair_i * 2]), np.zeros(2)))
                append_if_unique(group, endpoint_ids[pair_i * 2 + 1], per_i)
                cid_j = pair_j // 2
                per_j = conn_periodicity(cid_j)
                append_if_unique(group, endpoint_ids[pair_j * 2], per_j)
                append_if_unique(group, endpoint_ids[pair_j * 2 + 1], per_j)
                groups.append(group)

    # sort members by global id; groups by master id (smooth.zig:1441-1455)
    for group in groups:
        group.sort(key=lambda t: t[0])
    groups.sort(key=lambda g: g[0][0])

    # stencil ids: master + the 1-2 interior neighbors of every member,
    # accumulating periodicity into the RHS per appended neighbor
    # (smooth.zig:1457-1511)
    result = []
    for group in groups:
        master = group[0][0]
        stencil = [master]
        rhs = np.zeros(2)
        for gid, periodicity in group:
            b = int(np.searchsorted(starts, gid, side="right") - 1)
            ni, nj = mesh.blocks[b].size
            loc = gid - starts[b]
            i, j = divmod(int(loc), nj)
            for p in _interior_neighbors(i, j, ni, nj):
                stencil.append(int(starts[b] + p[0] * nj + p[1]))
                rhs = rhs + periodicity
        stencil = np.array(sorted(stencil), dtype=np.int64)
        result.append(LaplacianPoint(overlapping=group, stencil_ids=stencil, rhs=rhs))

    # Frame-consistency check. Member offsets are the RAW periodicity of
    # the connection each member was reached through (smooth.zig:1381-1384,
    # direction-agnostic), so x_member - offset must land on one shared
    # physical point — true only when periodic connections are oriented
    # with range0 on the junction-frame side and periodicity mapping
    # range0 -> range1 (the O4H convention, O4H.zig:503-514). The reference
    # debug-asserts only the FIRST pair coincides (smooth.zig:1409-1424);
    # checking every member turns a silent full-period junction shift into
    # a hard error (tests/test_periodic_junction_analytic.py found one).
    coords = mesh.flat_coords()
    for lp in result:
        pos = np.stack([coords[g] - off for g, off in lp.overlapping])
        tol = 1e-8 * (1.0 + np.abs(pos[0]).max())
        if np.abs(pos - pos[0]).max() > tol:
            raise ValueError(
                "junction group at global id %d has inconsistent member "
                "frames (max deviation %.3e): a periodic connection at this "
                "junction is oriented range1->range0; orient periodic "
                "connections with range0 on the junction-frame side so "
                "x(range0) + periodicity == x(range1)"
                % (lp.global_id, float(np.abs(pos - pos[0]).max())))
    return result


def _interior_neighbors(i: int, j: int, ni: int, nj: int) -> list[tuple[int, int]]:
    """Interior stencil neighbors of a boundary point (smooth.zig:1469-1498):
    corners contribute one diagonal interior point, side points two."""
    if i == 0:
        if j == 0:
            return [(1, 1)]
        if j == nj - 1:
            return [(1, nj - 2)]
        return [(1, j - 1), (1, j + 1)]
    if i == ni - 1:
        if j == 0:
            return [(ni - 2, 1)]
        if j == nj - 1:
            return [(ni - 2, nj - 2)]
        return [(ni - 2, j - 1), (ni - 2, j + 1)]
    assert j == 0 or j == nj - 1
    if j == 0:
        return [(i - 1, 1), (i + 1, 1)]
    return [(i - 1, nj - 2), (i + 1, nj - 2)]
