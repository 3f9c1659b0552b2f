"""Checkpoint / resume for long smoothing runs.

The reference has no restart path (SURVEY.md §5.4 — its CGNS output is
write-only). Here a checkpoint captures the full smoothing state: block
coordinates, the control-function field (which accumulates White feedback
across Picard iterations), and the iteration counter — so a 100M-node run
can resume exactly where it stopped.
"""

from __future__ import annotations

import numpy as np


def save_checkpoint(path: str, mesh, iteration: int,
                    control_function: np.ndarray | None = None) -> None:
    payload = {
        "iteration": np.asarray(iteration, dtype=np.int64),
        "num_blocks": np.asarray(len(mesh.blocks), dtype=np.int64),
    }
    for i, (name, blk) in enumerate(zip(mesh.names, mesh.blocks)):
        payload[f"block_{i:03d}_points"] = blk.points
        payload[f"block_{i:03d}_name"] = np.bytes_(name.encode())
    if control_function is not None:
        payload["control_function"] = np.asarray(control_function)
    np.savez_compressed(path, **payload)


def load_checkpoint(path: str, mesh) -> tuple[int, np.ndarray | None]:
    """Restore coordinates (and control function) into `mesh` in place.

    Returns (iteration, control_function or None). The mesh must have the
    same topology (block count and shapes) the checkpoint was written with.
    """
    data = np.load(path)
    n = int(data["num_blocks"])
    if n != len(mesh.blocks):
        raise ValueError(f"checkpoint has {n} blocks, mesh has {len(mesh.blocks)}")
    for i, blk in enumerate(mesh.blocks):
        pts = data[f"block_{i:03d}_points"]
        if pts.shape != blk.points.shape:
            raise ValueError(
                f"block {i} shape mismatch: checkpoint {pts.shape} vs mesh "
                f"{blk.points.shape}")
        blk.points[...] = pts
    cf = data["control_function"] if "control_function" in data.files else None
    return int(data["iteration"]), cf
