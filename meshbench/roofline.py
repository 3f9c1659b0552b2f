"""The least time K-A's half-sweeps need, from the mesh's block sizes.

Frozen copies of the port's rules that fix the work, so that a later
change to the port cannot change the yardstick:

- the coarsening of the glued multigrid (``smoothing.glue.build_glue``
  with ``keep_boundaries``): each block lattice of n points keeps
  (n - 1) // 2 + 1 of them a level; the padded stack's dims (storage
  frame: the longer side first) coarsen alike; the hierarchy stops after
  the level where the padded stack's shorter dim, or every block's, is
  5 or less;
- the half-sweeps a V-cycle launches at the default schedule
  (``multigrid.vcycle_half_sweeps``): pre and post one smooth each in
  "ij", two colours a direction: 8 on each level above the coarsest, and
  16 (4 coarse iterations of "ij") on the coarsest;
- the bytes of one half-sweep: 15 four-byte planes of the level's
  logical points, 13 read and 2 written, as ``chip_smoke.py`` counts
  them but on unpadded points (a layout's padding is not work).
"""

from __future__ import annotations

import json
import pathlib

MIN_SIZE = 5
PLANES = 15
PLANE_BYTES = 4


def level_points(block_sizes) -> list[int]:
    """Logical points of each multigrid level, finest first, of blocks of
    (ni, nj) points."""
    dims = [(max(ni, nj), min(ni, nj)) for ni, nj in block_sizes]
    N = max(d[0] for d in dims)
    M = max(d[1] for d in dims)
    out = []
    while True:
        out.append(sum(a * b for a, b in dims))
        if min(N, M) <= MIN_SIZE or all(min(a, b) <= MIN_SIZE
                                        for a, b in dims):
            return out
        N, M = (N - 1) // 2 + 1, (M - 1) // 2 + 1
        dims = [((a - 1) // 2 + 1, (b - 1) // 2 + 1) for a, b in dims]


def half_sweeps(n_levels: int) -> list[int]:
    """K-A half-sweeps of one V-cycle on each level, finest first."""
    return [8] * (n_levels - 1) + [16]


def vcycle_bytes(block_sizes) -> tuple[int, int]:
    """(half-sweeps, bytes) of one V-cycle."""
    pts = level_points(block_sizes)
    hs = half_sweeps(len(pts))
    return sum(hs), sum(h * PLANES * PLANE_BYTES * p for h, p in zip(hs, pts))


def peak(kind: str, key: str) -> float | None:
    """The card's published peak ``key`` (peaks.json), None when the card
    is not in the table."""
    path = pathlib.Path(__file__).resolve().parent / "peaks.json"
    with open(path) as f:
        return json.load(f)["cards"].get(kind, {}).get(key)
