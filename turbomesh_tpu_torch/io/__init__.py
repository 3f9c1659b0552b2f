"""Mesh output writers: CGNS (HDF5 layout) and legacy VTK."""

from .vtk import write_vtk
from .cgns import write_cgns, read_cgns


def write_mesh(mesh, filename: str, control_function=None) -> None:
    if filename.endswith(".vtk"):
        write_vtk(mesh, filename)
    elif filename.endswith(".cgns") or filename.endswith(".hdf") or filename.endswith(".h5"):
        write_cgns(mesh, filename, control_function)
    elif filename.endswith(".npz"):
        from .npz import write_npz

        write_npz(mesh, filename)
    else:
        raise ValueError(f"unknown output format for {filename!r}")


__all__ = ["write_mesh", "write_vtk", "write_cgns", "read_cgns"]
