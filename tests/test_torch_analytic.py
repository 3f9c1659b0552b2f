"""Parity mirrors of the JAX package's device-solver anchors, with the
port's DeviceSmoother on the CPU at the JAX tests' own sizes:

- tests/test_mg_alignment.py::test_even_size_block_device_parity: the
  14 x 12 block (both axes go even at the first coarsening, so the
  boundary-aligned maps run) against the sparse-direct oracle, 1e-10;
- tests/test_analytic_winslow.py::test_annulus_winslow_second_order: the
  fixed point converges to the exact log-polar harmonic inverse map at
  second order;
- tests/test_periodic_junction_analytic.py::
  test_periodic_junction_second_order: the same across periodic
  connections and junction points.

The meshes are built by the JAX tests' own generators and copied into
the port's classes, point for point.
"""

import numpy as np

import test_analytic_winslow as jaw
import test_periodic_junction_analytic as jpj
from test_device_solver import _uniform_block
from turbomesh_tpu.mesh import Mesh as JMesh

from turbomesh_tpu_torch import boundary as tbnd
from turbomesh_tpu_torch import mesh as tmesh
from turbomesh_tpu_torch.smoothing.classify import classify
from turbomesh_tpu_torch.smoothing.control_function import Laplace
from turbomesh_tpu_torch.smoothing.device import DeviceSmoother
from turbomesh_tpu_torch.smoothing.system import SparseSystem


def _port_mesh(jm):
    """The JAX-package mesh ``jm`` in the port's classes."""
    def rng(r):
        return tbnd.Range(r.block, tbnd.Side[r.side.name], r.start, r.end)

    mesh = tmesh.Mesh()
    for name, b in zip(jm.names, jm.blocks):
        mesh.add_block(name, tmesh.Block2d(points=np.array(b.points)))
    for c in jm.connections:
        mesh.connections.append(tbnd.Connection(
            tuple(rng(r) for r in c.ranges), periodicity=c.periodicity))
    for c in jm.boundary_conditions:
        mesh.boundary_conditions.append(
            tbnd.Condition(rng(c.range), tbnd.BCKind[c.kind.name]))
    return mesh


def _device(mesh, info):
    return DeviceSmoother(mesh, info, device="cpu", rtol=1e-12, atol=1e-14)


def _fixed_point(mesh, iters):
    """The JAX tests' Picard loop to the 1e-26 displacement bar; returns
    the smoothed flat coordinates."""
    solver = _device(mesh, classify(mesh))
    cf = Laplace().init(mesh)
    coords = mesh.flat_coords()
    for _ in range(iters):
        new = solver.solve(coords, cf)
        d = new - coords
        coords = new
        if float(d[:, 0] @ d[:, 0] + d[:, 1] @ d[:, 1]) < 1e-26:
            break
    return coords


def test_even_size_block_device_parity():
    jm = JMesh()
    jm.add_block("b", _uniform_block(14, 12, distort=0.04))
    mesh = _port_mesh(jm)
    info = classify(mesh)
    dev = DeviceSmoother(mesh, info, device="cpu")
    # the boundary-aligned maps must run on some level
    assert any("li_map" in gl for gl in dev._glue_dev)
    oracle = SparseSystem(mesh, info)
    cf = Laplace().init(mesh)
    co = mesh.flat_coords()
    cd = co.copy()
    for _ in range(2):
        co = oracle.solve(co, cf)
        cd = dev.solve(cd, cf)
        assert dev.last_linear_converged
        err = np.abs(co - cd).max()
        assert err < 1e-10, f"device vs oracle mismatch {err:.3e}"


def _annulus_error(n, m, seed=0):
    exact = jaw._annulus_exact(n, m)
    pts = exact.copy()
    rng = np.random.default_rng(seed)
    pts[1:-1, 1:-1] += (0.2 / n) * rng.standard_normal(pts[1:-1, 1:-1].shape)
    mesh = tmesh.Mesh()
    mesh.add_block("annulus", tmesh.Block2d(points=pts.copy()))
    sol = _fixed_point(mesh, 60).reshape(n, m, 2)
    return np.abs(sol[1:-1, 1:-1] - exact[1:-1, 1:-1]).max()


def test_annulus_winslow_second_order():
    e_coarse = _annulus_error(17, 13)
    e_fine = _annulus_error(33, 25)
    assert e_coarse < 2e-3, e_coarse
    assert e_fine < 6e-4, e_fine
    ratio = e_coarse / e_fine
    assert 3.0 < ratio < 5.5, (e_coarse, e_fine, ratio)


def _strip_error(n, m, seed=0):
    jm = jpj._strip_mesh(n, m)
    mesh = _port_mesh(jm)
    h = np.pi / (n - 1)
    exact = mesh.flat_coords().copy()
    rng = np.random.default_rng(seed)
    for b in mesh.blocks:
        p = b.points.copy()
        p[1:-1, 1:-1] += (0.3 * h) * rng.standard_normal(
            p[1:-1, 1:-1].shape)
        b.points[...] = p
    return np.abs(_fixed_point(mesh, 80) - exact).max()


def test_periodic_junction_second_order():
    e_coarse = _strip_error(9, 5)
    e_fine = _strip_error(17, 9)
    assert e_coarse < 5e-3, e_coarse
    assert e_fine < 1.5e-3, e_fine
    ratio = e_coarse / e_fine
    assert 3.0 < ratio < 5.6, (e_coarse, e_fine, ratio)
