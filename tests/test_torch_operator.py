"""Port operator, preconditioner and Krylov pieces vs the JAX package.

f64 pieces (``_stage_base``, ``_stage_apply64``, Krylov and tridiagonal
solves) must match the JAX functions to 1e-12 relative; the f32
preconditioner ``_stage_Minv`` to 5e-5 relative (its smoother runs the
zebra PCR math where the JAX package on the CPU runs the XLA Thomas
expression; the repo's kernel-vs-XLA bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbomesh_tpu import input as jax_input
from turbomesh_tpu.boundary import (BCKind as JBCKind, Condition as JCondition,
                                    Connection as JConnection, Range as JRange,
                                    Side as JSide)
from turbomesh_tpu.mesh import Block2d as JBlock2d, Mesh as JMesh
from turbomesh_tpu.smoothing import krylov as jkrylov
from turbomesh_tpu.smoothing.classify import classify as jax_classify
from turbomesh_tpu.smoothing.control_function import White as JWhite
from turbomesh_tpu.smoothing.device import DeviceSmoother as JaxSmoother

from turbomesh_tpu_torch import input as torch_input
from turbomesh_tpu_torch.boundary import BCKind, Condition, Connection, Range, Side
from turbomesh_tpu_torch.mesh import Block2d, Mesh
from turbomesh_tpu_torch.smoothing import krylov
from turbomesh_tpu_torch.smoothing.classify import classify
from turbomesh_tpu_torch.smoothing.control_function import White
from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

from test_torch_frontend import ROOT, SMALL_O4H

torch.set_num_threads(1)


def _strip(mesh_cls, block_cls, conn_cls, range_cls, side, cond_cls, bck):
    """Channel with a periodic i_min/i_max connection and a sliding inlet
    (tests/test_device_solver.py::test_periodic_and_sliding_parity)."""
    n, m = 9, 7
    u = np.linspace(0.0, 1.0, n)
    v = np.linspace(0.0, 1.0, m)
    pts = np.stack(np.meshgrid(u, v, indexing="ij"), axis=-1)
    rng = np.random.default_rng(2)
    pts[1:-1, 1:-1] += 0.04 * rng.standard_normal(pts[1:-1, 1:-1].shape)
    pts[:, -1, :] = pts[:, 0, :] + np.array([0.0, 1.0])
    mesh = mesh_cls()
    mesh.add_block("b", block_cls(points=pts))
    mesh.connections.append(conn_cls(
        (range_cls(0, side.I_MIN, 0, n - 1), range_cls(0, side.I_MAX, 0, n - 1)),
        periodicity=(0.0, 1.0)))
    mesh.boundary_conditions.append(
        cond_cls(range_cls(0, side.J_MIN, 0, m - 1), bck.INLET))
    return mesh


def _pair(case):
    """(jax smoother, port smoother, padded X, padded cf) on one mesh."""
    if case == "o4h":
        mj = jax_input.load(SMALL_O4H, base_dir=str(ROOT))
        mj = mj.template.run(mj.geometry)
        mt = torch_input.load(SMALL_O4H, base_dir=str(ROOT))
        mt = mt.template.run(mt.geometry)
        cf = JWhite(ds_target=1e-4).init(mj)
        np.testing.assert_array_equal(cf, White(ds_target=1e-4).init(mt))
    else:
        mj = _strip(JMesh, JBlock2d, JConnection, JRange, JSide, JCondition,
                    JBCKind)
        mt = _strip(Mesh, Block2d, Connection, Range, Side, Condition, BCKind)
        cf = 0.1 * np.random.default_rng(4).standard_normal(
            (mj.num_points, 2))
    js = JaxSmoother(mj, jax_classify(mj))
    ts = DeviceSmoother(mt, classify(mt), device="cpu")
    p = js.plan
    X = p.pad_coords(mj.flat_coords()).reshape(p.B, p.N, p.M, 2)
    C = p.pad_cf(cf).reshape(p.B, p.N, p.M, 2)
    return js, ts, X, C


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("case", ["o4h", "strip"])
def test_stage_base_and_apply64_match_jax(case):
    js, ts, X, C = _pair(case)
    jbase, jb = js._jit_base(js._plans_arg, jnp.asarray(X), jnp.asarray(C))
    tbase, tb = ts._stage_base(torch.as_tensor(X), torch.as_tensor(C))
    assert _rel(tbase.numpy(), jbase) < 1e-12
    assert _rel(tb.numpy(), jb) < 1e-12
    v = np.random.default_rng(7).standard_normal(tuple(tb.shape))
    jav = js._jit_apply64(js._plans_arg, jbase, jnp.asarray(C),
                          jnp.asarray(v))
    tav = ts._stage_apply64(tbase, torch.as_tensor(C), torch.as_tensor(v))
    assert _rel(tav.numpy(), jav) < 1e-12


@pytest.mark.parametrize("case", ["o4h", "strip"])
def test_stage_Minv_matches_jax(case):
    js, ts, X, C = _pair(case)
    jbase, _ = js._jit_base(js._plans_arg, jnp.asarray(X), jnp.asarray(C))
    jctx = js._jit_prepare32(js._plans_arg, jbase, jnp.asarray(C))
    tbase, _ = ts._stage_base(torch.as_tensor(X), torch.as_tensor(C))
    tctx = ts._stage_prepare32(tbase, torch.as_tensor(C))
    np.testing.assert_allclose(tctx["diag"].numpy(), np.asarray(jctx["diag"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(tctx["G"].numpy(), np.asarray(jctx["G"]))
    v = np.random.default_rng(8).standard_normal(
        (X.size // 2, 2)).astype(np.float32)
    jz = js._jit_Minv(js._plans_arg, jctx, jnp.asarray(v))
    tz = ts._stage_Minv(tctx, torch.as_tensor(v))
    assert _rel(tz.numpy(), jz) < 5e-5


def test_restarted_fgmres_matches_jax():
    rng = np.random.default_rng(11)
    n = 40
    A = rng.standard_normal((n, n)) + 8.0 * np.eye(n)
    b = rng.standard_normal(n)
    dinv = 1.0 / np.diag(A)
    jA, jd = jnp.asarray(A), jnp.asarray(dinv)
    tA, td = torch.as_tensor(A), torch.as_tensor(dinv)

    jx, jrn = jax.jit(lambda bb: jkrylov.restarted_fgmres(
        lambda v: jA @ v, bb, lambda v: jd * v,
        dot=lambda x, y: jnp.sum(x * y), rtol=1e-12, atol=0.0,
        restart=6, max_restarts=30))(jnp.asarray(b))
    tx, trn = krylov.restarted_fgmres(
        lambda v: tA @ v, torch.as_tensor(b), lambda v: td * v,
        dot=lambda x, y: torch.sum(x * y), rtol=1e-12, atol=0.0,
        restart=6, max_restarts=30)
    assert _rel(tx.numpy(), jx) < 1e-12
    assert float(trn) <= 1e-12 * np.linalg.norm(b)
    np.testing.assert_allclose(A @ tx.numpy(), b, atol=1e-10)


def test_lsq_givens_matches_jax():
    rng = np.random.default_rng(12)
    m = 7
    H = np.triu(rng.standard_normal((m + 1, m)), -1)
    g = rng.standard_normal(m + 1)
    jy = jkrylov._lsq_givens(jnp.asarray(H), jnp.asarray(g), m)
    ty = krylov._lsq_givens(torch.as_tensor(H), torch.as_tensor(g), m)
    assert _rel(ty.numpy(), jy) < 1e-12
    ref, *_ = np.linalg.lstsq(H, g, rcond=None)
    np.testing.assert_allclose(ty.numpy(), ref, rtol=1e-10)


@pytest.mark.parametrize("solver", ["thomas", "tridiag_pcr", "tridiag_solve"])
def test_tridiagonal_solves_match_jax(solver):
    rng = np.random.default_rng(13)
    for n in (9, 130):
        shape = (3, 4, n)
        d = 4.0 + rng.random(shape)
        dl = -rng.random(shape)
        du = -rng.random(shape)
        rhs = rng.standard_normal(shape + (2,))
        jx = getattr(jkrylov, solver)(*map(jnp.asarray, (dl, d, du, rhs)))
        tx = getattr(krylov, solver)(*map(torch.as_tensor, (dl, d, du, rhs)))
        assert _rel(tx.numpy(), jx) < 1e-12, (solver, n)


def test_mapped_transfers_match_jax():
    """Boundary-aligned coarsening transfers (gather subsample, bracketed
    prolongation) and the stride-2 prolongation, on a misaligned lattice."""
    import turbomesh_tpu.smoothing.multigrid as jmg
    import turbomesh_tpu_torch.smoothing.multigrid as tmg
    from turbomesh_tpu_torch.smoothing.glue import _bracket, _subsample_positions

    rng = np.random.default_rng(14)
    B, Nf, Mf = 2, 10, 12
    pos_i, pos_j = _subsample_positions(Nf), _subsample_positions(Mf)
    tile = lambda a: np.tile(a, (B, 1))
    im, jm = tile(pos_i), tile(pos_j)
    a = rng.standard_normal((B, Nf, Mf, 2))
    got = tmg._subsample_mapped(torch.as_tensor(a), torch.as_tensor(im),
                                torch.as_tensor(jm))
    want = jmg._subsample_mapped(jnp.asarray(a), jnp.asarray(im),
                                 jnp.asarray(jm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    zc = rng.standard_normal((B, len(pos_i), len(pos_j), 2))
    pil, piw = _bracket(pos_i, Nf)
    pjl, pjw = _bracket(pos_j, Mf)
    maps = [tile(x) for x in (pil, piw, pjl, pjw)]
    got = tmg._prolong_mapped(torch.as_tensor(zc), (B, Nf, Mf),
                              *map(torch.as_tensor, maps))
    want = jmg._prolong_mapped(jnp.asarray(zc), (B, Nf, Mf),
                               *map(jnp.asarray, maps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15,
                               atol=1e-15)
    zc = rng.standard_normal((B, 5, 6, 2))
    got = tmg._prolong(torch.as_tensor(zc), (B, 9, 11))
    want = jmg._prolong(jnp.asarray(zc), (B, 9, 11))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vcycle_matches_jax_on_misaligned_block():
    """The glued V-cycle on a 14 x 12 block, whose lattice lengths go even
    at the first coarsening, so restriction, subsampling and prolongation
    run through the boundary-aligned maps."""
    from turbomesh_tpu.mesh import Block2d as JB, Mesh as JM

    n, m = 14, 12
    u, v = np.linspace(0.0, 1.0, n), np.linspace(0.0, 1.0, m)
    pts = np.stack(np.meshgrid(u, v, indexing="ij"), axis=-1)
    pts[1:-1, 1:-1] += 0.04 * np.random.default_rng(0).standard_normal(
        pts[1:-1, 1:-1].shape)
    mj, mt = JM(), Mesh()
    mj.add_block("b", JB(points=pts.copy()))
    mt.add_block("b", Block2d(points=pts.copy()))
    js = JaxSmoother(mj, jax_classify(mj))
    ts = DeviceSmoother(mt, classify(mt), device="cpu")
    assert any("li_map" in gl for gl in ts._glue_dev)
    p = js.plan
    X = p.pad_coords(mj.flat_coords()).reshape(p.B, p.N, p.M, 2)
    C = np.zeros_like(X)
    jbase, _ = js._jit_base(js._plans_arg, jnp.asarray(X), jnp.asarray(C))
    jctx = js._jit_prepare32(js._plans_arg, jbase, jnp.asarray(C))
    tbase, _ = ts._stage_base(torch.as_tensor(X), torch.as_tensor(C))
    tctx = ts._stage_prepare32(tbase, torch.as_tensor(C))
    r = np.random.default_rng(15).standard_normal(
        (X.size // 2, 2)).astype(np.float32)
    jz = js._jit_vcycle(js._plans_arg, jctx, jnp.asarray(r))
    tz = ts._stage_vcycle_interior(tctx, torch.as_tensor(r))
    assert _rel(tz.numpy(), jz) < 5e-5
