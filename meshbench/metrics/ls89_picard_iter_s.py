"""``picard_iter_s`` in the LS89 cells: seconds per Picard iteration over
the window's finished jobs, by the same reader."""

from .picard_iter_s import read  # noqa: F401
