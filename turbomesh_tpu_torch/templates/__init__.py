"""Automated blocking templates."""

from .o4h import O4H

__all__ = ["O4H", "from_config"]


def from_config(cfg) -> O4H:
    """Template from JSON-config tagged union, e.g. {"O4H": {...}}
    (templates/templates.zig:13-21 dispatch)."""
    (tag, params), = cfg.items()
    if tag == "O4H":
        return O4H.from_config(params)
    raise ValueError(f"unknown template {tag!r}")
