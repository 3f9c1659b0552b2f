"""Port of the 3-D stacked-cuts path (turbomesh_tpu_torch.extrude,
io/cgns3d) vs the JAX package, and the toy pipeline of
tests/test_extrude3d_sharded.py on a spawned gloo world of 2."""

import functools

import numpy as np
import pytest
import torch

from turbomesh_tpu import boundary as jbnd
from turbomesh_tpu import extrude as jextrude
from turbomesh_tpu import mesh as jmesh
from turbomesh_tpu.clustering import Uniform as JUniform
from turbomesh_tpu.io.cgns3d import read_cgns3d as jax_read_cgns3d

from turbomesh_tpu_torch import boundary as tbnd
from turbomesh_tpu_torch import extrude as textrude
from turbomesh_tpu_torch import mesh as tmesh
from turbomesh_tpu_torch.clustering import Uniform
from turbomesh_tpu_torch.extrude import from_cuts
from turbomesh_tpu_torch.io.cgns3d import read_cgns3d, write_cgns3d
from turbomesh_tpu_torch.parallel import dist as pdist
from turbomesh_tpu_torch.parallel import shard
from turbomesh_tpu_torch.smoothing.classify import classify
from turbomesh_tpu_torch.smoothing.control_function import Laplace
from turbomesh_tpu_torch.smoothing.system import SparseSystem

torch.set_num_threads(1)


def _cut_mesh(mod, bnd, unif, scale=1.0, seed=0):
    """The two-block cut of tests/test_extrude3d_sharded.py."""
    mesh = mod.Mesh()
    u = unif()(9)
    v = unif()(7)
    rng = np.random.default_rng(seed)
    for k, x0 in enumerate((0.0, 1.0)):
        pts = np.stack(np.meshgrid(scale * (x0 + u), scale * v,
                                   indexing="ij"), axis=-1)
        pts[1:-1, 1:-1] += 0.02 * scale * rng.standard_normal(
            pts[1:-1, 1:-1].shape)
        mesh.add_block(f"b{k}", mod.Block2d(points=pts))
    mesh.connections.append(bnd.Connection((
        bnd.Range(0, bnd.Side.J_MAX, 0, 6), bnd.Range(1, bnd.Side.J_MIN, 0, 6))))
    mesh.blocks[1].points[0, :, :] = mesh.blocks[0].points[-1, :, :]
    return mesh


def _port_cut(scale=1.0, seed=0):
    return _cut_mesh(tmesh, tbnd, Uniform, scale, seed)


def _jax_cut(scale=1.0, seed=0):
    return _cut_mesh(jmesh, jbnd, JUniform, scale, seed)


@pytest.mark.parametrize("twist, scale", [(None, None),
                                          ([0.0, 0.1, 0.25], None),
                                          (None, [1.0, 0.9, 0.8]),
                                          ([0.0, -0.2, 0.3], [1.1, 1.0, 0.7])])
def test_extrude_bit_identical_to_jax(twist, scale):
    spans = [0.0, 0.4, 1.0]
    got = textrude.extrude(_port_cut(seed=3), spans, twist=twist, scale=scale)
    want = jextrude.extrude(_jax_cut(seed=3), spans, twist=twist, scale=scale)
    assert got.names == want.names and got.num_points == want.num_points
    for a, b in zip(got.blocks, want.blocks):
        assert a.size == b.size
        np.testing.assert_array_equal(a.points, b.points)


def test_from_cuts_bit_identical_to_jax():
    spans = [0.0, 0.5, 1.0]
    scales = [1.0, 0.9, 0.8]
    got = from_cuts([_port_cut(s, k) for k, s in enumerate(scales)], spans)
    want = jextrude.from_cuts([_jax_cut(s, k) for k, s in enumerate(scales)],
                              spans)
    assert got.names == want.names
    for a, b in zip(got.blocks, want.blocks):
        np.testing.assert_array_equal(a.points, b.points)
    with pytest.raises(AssertionError):
        from_cuts([_port_cut(), _port_cut()], [0.0])


def test_cgns3d_round_trip(tmp_path):
    pytest.importorskip("h5py")
    m3 = textrude.extrude(_port_cut(seed=1), [0.0, 0.3, 0.7, 1.0],
                          twist=[0.0, 0.1, 0.2, 0.3])
    path = str(tmp_path / "m3.cgns")
    write_cgns3d(m3, path)
    for reader in (read_cgns3d, jax_read_cgns3d):
        names, blocks = reader(path)
        got = dict(zip(names, blocks))
        assert sorted(names) == sorted(m3.names)
        for nm, blk in zip(m3.names, m3.blocks):
            np.testing.assert_array_equal(got[nm], blk.points)


def test_stacked_cuts_sharded_pipeline(tmp_path):
    """Per-cut smoothing on a gloo world of 2 (two Picard iterations of
    the sharded run), against the oracle to 1e-9, then from_cuts and the
    CGNS-3D round trip."""
    spans = np.array([0.0, 0.5, 1.0])
    scales = [1.0, 0.9, 0.8]
    cuts = [_port_cut(s, k) for k, s in enumerate(scales)]
    cf = Laplace().init(cuts[0])
    tasks = [dict(mesh=m, cf=cf.copy(), iterations=2) for m in cuts]
    recs = pdist.spawn(functools.partial(shard.run_tasks, device="cpu"), 2,
                       "gloo", "cpu", args=(tasks,))
    for k, mesh in enumerate(cuts):
        oracle = SparseSystem(mesh, classify(mesh))
        co = mesh.flat_coords()
        for _ in range(2):
            co = oracle.solve(co, cf)
        for rank in recs:
            assert rank[k]["n_done"] == 2
            err = np.abs(rank[k]["coords"] - co).max()
            assert err < 1e-9, f"cut {k}: sharded vs oracle {err:.3e}"
        mesh.set_flat_coords(recs[0][k]["coords"])

    m3 = from_cuts(cuts, spans)
    assert m3.num_points == 3 * cuts[0].num_points
    assert not np.allclose(m3.blocks[0].points[0, ..., :2],
                           m3.blocks[0].points[2, ..., :2])
    pytest.importorskip("h5py")
    path = str(tmp_path / "cuts3d.cgns")
    write_cgns3d(m3, path)
    names, blocks = read_cgns3d(path)
    got = dict(zip(names, blocks))
    for nm, blk in zip(m3.names, m3.blocks):
        np.testing.assert_array_equal(got[nm], blk.points)
