"""CGNS writer for 3-D structured meshes (HDF5 layout, see cgns.py).

A jax-free copy of turbomesh_tpu/io/cgns3d.py. Import it directly:
``io/__init__.py`` does not export it."""

from __future__ import annotations

import numpy as np

from .cgns import _node, _c1, CGNS_VERSION


def write_cgns3d(mesh3d, filename: str) -> None:
    import h5py

    with h5py.File(filename, "w") as f:
        root = f["/"]
        root.attrs.create("name", np.bytes_(b"HDF5 MotherNode".ljust(33, b"\x00")), dtype="S33")
        root.attrs.create("label", np.bytes_(b"Root Node of HDF5 File".ljust(33, b"\x00")), dtype="S33")
        root.attrs.create("type", np.bytes_(b"MT\x00"), dtype="S3")
        f.create_dataset(" format", data=np.frombuffer(b"IEEE_LITTLE_32\x00", dtype=np.int8))
        f.create_dataset(" hdf5version", data=np.frombuffer(b"HDF5 Version 1.10".ljust(33, b"\x00"), dtype=np.int8))
        _node(root, "CGNSLibraryVersion", "CGNSLibraryVersion_t", "R4",
              np.array([CGNS_VERSION], dtype=np.float32))

        base = _node(root, "Base", "CGNSBase_t", "I4", np.array([3, 3], dtype=np.int32))

        for name, block in zip(mesh3d.names, mesh3d.blocks):
            nk, ni, nj = block.size
            size = np.array(
                [[ni, nj, nk], [ni - 1, nj - 1, nk - 1], [0, 0, 0]], dtype=np.int32
            )
            zone = _node(base, name, "Zone_t", "I4", size)
            _c1(zone, "ZoneType", "ZoneType_t", "Structured")
            gc = _node(zone, "GridCoordinates", "GridCoordinates_t", "MT")
            # Fortran order for dims (ni, nj, nk): i fastest -> C array (nk, nj, ni)
            pts = block.points  # (nk, ni, nj, 3)
            x = np.ascontiguousarray(np.transpose(pts[..., 0], (0, 2, 1)))
            y = np.ascontiguousarray(np.transpose(pts[..., 1], (0, 2, 1)))
            z = np.ascontiguousarray(np.transpose(pts[..., 2], (0, 2, 1)))
            _node(gc, "CoordinateX", "DataArray_t", "R8", x)
            _node(gc, "CoordinateY", "DataArray_t", "R8", y)
            _node(gc, "CoordinateZ", "DataArray_t", "R8", z)


def read_cgns3d(filename: str):
    """Read back block names and (Nk, Ni, Nj, 3) coordinate arrays."""
    import h5py

    names, blocks = [], []
    with h5py.File(filename, "r") as f:
        base = f["Base"]
        for key, node in base.items():
            if node.attrs.get("label", b"").rstrip(b"\x00") != b"Zone_t":
                continue
            # stored C-order (nk, nj, ni): invert the writer's transpose
            x = node["GridCoordinates/CoordinateX/ data"][()]
            y = node["GridCoordinates/CoordinateY/ data"][()]
            z = node["GridCoordinates/CoordinateZ/ data"][()]
            pts = np.stack([np.transpose(x, (0, 2, 1)),
                            np.transpose(y, (0, 2, 1)),
                            np.transpose(z, (0, 2, 1))], axis=-1)
            names.append(key)
            blocks.append(pts)
    return names, blocks
