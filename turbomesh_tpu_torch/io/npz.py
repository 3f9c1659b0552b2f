"""npz block-coordinate output — also the checkpoint/restart format."""

from __future__ import annotations

import numpy as np


def write_npz(mesh, filename: str, extra: dict | None = None) -> None:
    payload = {f"block_{i:03d}_{name}": blk.points
               for i, (name, blk) in enumerate(zip(mesh.names, mesh.blocks))}
    if extra:
        payload.update(extra)
    np.savez_compressed(filename, **payload)


def read_npz(filename: str):
    data = np.load(filename)
    names, blocks = [], []
    for key in sorted(k for k in data.files if k.startswith("block_")):
        names.append(key.split("_", 2)[2])
        blocks.append(data[key])
    return names, blocks
