"""``zebra_roofline_pct`` in the LS89 cells: K-A's share of its memory
roofline over the traced iterations, by the same reader, which works the
hierarchy out from the job's block sizes (5 levels, 48 half-sweeps and
24.6 MB a V-cycle on LS89's 8 blocks)."""

from .zebra_roofline_pct import read  # noqa: F401
