"""Seconds per mesh: the window's seconds over the meshes completed in
it, the one in flight at the close by its share of Picard iterations."""


def read(run):
    meshes = run.meshes
    return run.seconds / meshes if meshes > 0 else None
