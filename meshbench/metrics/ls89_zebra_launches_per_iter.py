"""``zebra_launches_per_iter`` in the LS89 cells: K-A launches per Picard
iteration over the window's finished jobs, by the same reader (48
half-sweeps a V-cycle on LS89's 5 levels, so the launches over 48 are
the preconditioner applications an iteration)."""

from .zebra_launches_per_iter import read  # noqa: F401
