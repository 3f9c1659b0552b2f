"""CGNS writer/reader using the CGNS/HDF5 file mapping directly via h5py.

Reference parity: src/core/cgns.zig (write): one base "Base" with
cell_dim=2, phys_dim=2; one Structured Zone_t per block named after the
block; RealDouble CoordinateX/CoordinateY vertex coordinates written in
Fortran order (i fastest — cgns.zig:74-102); optional vertex FlowSolution
"Smoothing" with fields P and Q (cgns.zig:110-161).

The reference links the CGNS C library; here we emit the standard
SIDS-to-HDF5 node layout (ADF-compatible node attributes name/label/type
and ' data' datasets) so standard tools (cgnslib, ParaView) can read the
file, with no C dependency on the write path.

Beyond the reference (which writes coordinates + P,Q only): ZoneBC_t
boundary-condition nodes (inlet/outlet/wall -> BCInflow/BCOutflow/BCWall
with PointRange) and GridConnectivity1to1_t abutting-interface nodes
(PointRange/PointRangeDonor/Transform, periodic Translation property),
so the written files carry the full multi-block topology for downstream
solvers.
"""

from __future__ import annotations

import numpy as np

CGNS_VERSION = np.float32(4.2)


def _set_node_attrs(group, name: str, label: str, type_code: str) -> None:
    group.attrs.create("name", np.bytes_(name.encode().ljust(33, b"\x00")[:33]), dtype="S33")
    group.attrs.create("label", np.bytes_(label.encode().ljust(33, b"\x00")[:33]), dtype="S33")
    group.attrs.create("type", np.bytes_(type_code.encode().ljust(3, b"\x00")[:3]), dtype="S3")
    group.attrs.create("flags", np.array([1], dtype=np.int32))


def _node(parent, name: str, label: str, type_code: str, data=None):
    g = parent.create_group(name)
    # CGNS/HDF5 stores link-order tracking; harmless if absent for readers
    _set_node_attrs(g, name, label, type_code)
    if data is not None:
        g.create_dataset(" data", data=data)
    return g


def _c1(parent, name: str, label: str, text: str):
    data = np.frombuffer(text.encode(), dtype=np.int8)
    return _node(parent, name, label, "C1", data)


def _range_points(rng, size):
    """CGNS 1-based (i, j) begin/end of a side Range (boundary.py Side
    semantics: I_MIN/I_MAX vary i at j = 0 / nj-1; J_MIN/J_MAX vary j at
    i = 0 / ni-1)."""
    from ..boundary import Side

    ni, nj = size
    s, e = rng.start + 1, rng.end + 1
    if rng.side is Side.I_MIN:
        return (s, 1), (e, 1)
    if rng.side is Side.I_MAX:
        return (s, nj), (e, nj)
    if rng.side is Side.J_MIN:
        return (1, s), (1, e)
    if rng.side is Side.J_MAX:
        return (ni, s), (ni, e)
    raise AssertionError


def _range_axes(rng):
    """(along_axis, normal_axis, outward_sign) of a Range, 1-based axes.
    I_MIN/I_MAX sides vary i -> along axis 1, normal axis 2."""
    from ..boundary import Side

    if rng.side in (Side.I_MIN, Side.I_MAX):
        along, norm = 1, 2
        out = -1 if rng.side is Side.I_MIN else 1
    else:
        along, norm = 2, 1
        out = -1 if rng.side is Side.J_MIN else 1
    return along, norm, out


def _transform(r0, r1):
    """GridConnectivity1to1 Transform vector (2-D): index_donor =
    T (index - begin) + begin_donor. Along-face axes map with the
    ranges' relative walk direction; normal axes map with a sign flip
    (stepping out of one zone steps into the other)."""
    a0, n0, o0 = _range_axes(r0)
    a1, n1, o1 = _range_axes(r1)
    d0 = 1 if r0.end >= r0.start else -1
    d1 = 1 if r1.end >= r1.start else -1
    t = [0, 0]
    t[a0 - 1] = (d0 * d1) * a1
    t[n0 - 1] = (-o0 * o1) * n1
    return np.array(t, dtype=np.int32)


def write_cgns(mesh, filename: str, control_function=None) -> None:
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

        # base: cell dimension 2, physical dimension 2 (cgns.zig:43)
        base = _node(root, "Base", "CGNSBase_t", "I4", np.array([2, 2], dtype=np.int32))

        row_start = 0
        for name, block in zip(mesh.names, mesh.blocks):
            ni, nj = block.size
            # Zone_t data: rows vertex/cell/boundary sizes, Fortran dims
            # (IndexDim, 3) -> h5py shape (3, IndexDim)
            size = np.array([[ni, nj], [ni - 1, nj - 1], [0, 0]], dtype=np.int32)
            zone = _node(base, name, "Zone_t", "I4", size)
            _c1(zone, "ZoneType", "ZoneType_t", "Structured")

            gc = _node(zone, "GridCoordinates", "GridCoordinates_t", "MT")
            # Fortran order (i fastest) for dims (ni, nj) == C array (nj, ni)
            x = np.ascontiguousarray(block.points[:, :, 0].T)
            y = np.ascontiguousarray(block.points[:, :, 1].T)
            _node(gc, "CoordinateX", "DataArray_t", "R8", x)
            _node(gc, "CoordinateY", "DataArray_t", "R8", y)

            if control_function is not None:
                sol = _node(zone, "Smoothing", "FlowSolution_t", "MT")
                _c1(sol, "GridLocation", "GridLocation_t", "Vertex")
                n = ni * nj
                cf = np.asarray(control_function)[row_start : row_start + n].reshape(ni, nj, 2)
                _node(sol, "P", "DataArray_t", "R8", np.ascontiguousarray(cf[:, :, 0].T))
                _node(sol, "Q", "DataArray_t", "R8", np.ascontiguousarray(cf[:, :, 1].T))
            row_start += ni * nj

            # boundary conditions of this zone (beyond the reference)
            bcs = [bc for bc in mesh.boundary_conditions
                   if bc.range.block == mesh.names.index(name)]
            if bcs:
                zbc = _node(zone, "ZoneBC", "ZoneBC_t", "MT")
                kind_map = {"wall": "BCWall", "inlet": "BCInflow",
                            "outlet": "BCOutflow"}
                for k, bc in enumerate(bcs):
                    bcnode = _c1(zbc, f"BC{k + 1}", "BC_t",
                                 kind_map[bc.kind.value])
                    b0, b1 = _range_points(bc.range, block.size)
                    pr = np.array([b0, b1], dtype=np.int32)
                    _node(bcnode, "PointRange", "IndexRange_t", "I4", pr)

            # 1-to-1 abutting interfaces owned by this zone (range 0)
            conns = [(ci, c) for ci, c in enumerate(mesh.connections)
                     if c.ranges[0].block == mesh.names.index(name)]
            if conns:
                zgc = _node(zone, "ZoneGridConnectivity",
                            "ZoneGridConnectivity_t", "MT")
                for ci, c in conns:
                    r0, r1 = c.ranges
                    donor = mesh.names[r1.block]
                    g = _c1(zgc, f"Connection{ci + 1}",
                            "GridConnectivity1to1_t", donor)
                    b0, e0 = _range_points(r0, mesh.blocks[r0.block].size)
                    b1, e1 = _range_points(r1, mesh.blocks[r1.block].size)
                    _node(g, "PointRange", "IndexRange_t", "I4",
                          np.array([b0, e0], dtype=np.int32))
                    _node(g, "PointRangeDonor", "IndexRange_t", "I4",
                          np.array([b1, e1], dtype=np.int32))
                    _node(g, "Transform", '"int[IndexDimension]"', "I4",
                          _transform(r0, r1))
                    if c.periodicity is not None:
                        prop = _node(g, "GridConnectivityProperty",
                                     "GridConnectivityProperty_t", "MT")
                        per = _node(prop, "Periodic", "Periodic_t", "MT")
                        _node(per, "RotationCenter", "DataArray_t", "R4",
                              np.zeros(2, dtype=np.float32))
                        _node(per, "RotationAngle", "DataArray_t", "R4",
                              np.zeros(1, dtype=np.float32))
                        _node(per, "Translation", "DataArray_t", "R4",
                              np.asarray(c.periodicity, dtype=np.float32))


def read_cgns(filename: str):
    """Read back block names and (Ni, Nj, 2) coordinate arrays."""
    import h5py

    names, blocks = [], []
    with h5py.File(filename, "r") as f:
        base = f["Base"]
        for key, node in base.items():
            if node.attrs.get("label", b"").rstrip(b"\x00") != b"Zone_t":
                continue
            x = node["GridCoordinates/CoordinateX/ data"][()]  # (nj, ni)
            y = node["GridCoordinates/CoordinateY/ data"][()]
            pts = np.stack([x.T, y.T], axis=-1)
            names.append(key)
            blocks.append(pts)
    return names, blocks
