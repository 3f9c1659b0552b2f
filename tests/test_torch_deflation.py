"""Opt-in coarse-space deflation of the port's DeviceSmoother vs the JAX
package's (``mg_opts={"deflation": ...}``).

The basis (profiles, keep mask, junction rows) must equal JAX's bit for
bit; the Galerkin matrix, its scaling and one safeguarded coarse solve
match to 5e-5 relative (f32 operator applications, the repo's
kernel-vs-XLA bar); the deflated solves stay within 1e-9 of the
undeflated one over 3 White iterations (tests/test_device_solver.py::
test_deflation_optin_parity) and within 1e-10 of JAX's deflated solve.
With deflation off the preconditioner is the undeflated composition, bit
for bit, with the same zebra launches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbomesh_tpu import input as jax_input
from turbomesh_tpu.smoothing import device as jdevice
from turbomesh_tpu.smoothing.classify import classify as jax_classify
from turbomesh_tpu.smoothing.control_function import White as JWhite
from turbomesh_tpu.smoothing.device import DeviceSmoother as JaxSmoother

import turbomesh_tpu_torch.smoothing.multigrid as tmg
from turbomesh_tpu_torch import input as torch_input
from turbomesh_tpu_torch.ops import zebra
from turbomesh_tpu_torch.smoothing import device as tdevice
from turbomesh_tpu_torch.smoothing.classify import classify
from turbomesh_tpu_torch.smoothing.control_function import Laplace, White
from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

from test_torch_frontend import ROOT, SMALL_O4H
from test_torch_zebra import thomas_half_sweep

torch.set_num_threads(1)

MODES = ("y", "xy", "j")


def _meshes():
    mj = jax_input.load(SMALL_O4H, base_dir=str(ROOT))
    mt = torch_input.load(SMALL_O4H, base_dir=str(ROOT))
    return mj.template.run(mj.geometry), mt.template.run(mt.geometry)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def pair():
    mj, mt = _meshes()
    return mj, jax_classify(mj), mt, classify(mt)


@pytest.mark.parametrize("mode", MODES)
def test_basis_matches_jax(pair, mode):
    mj, ij, mt, it = pair
    js = JaxSmoother(mj, ij, mg_opts={"deflation": mode})
    ts = DeviceSmoother(mt, it, device="cpu", deflation=mode)
    assert ts._defl_K == js._defl_K > 0
    assert ts._defl_comps == tuple(js._defl_comps)
    assert ts._defl_mode == js._defl_mode
    p32 = js._jnp_plan32
    np.testing.assert_array_equal(ts._dkeep.numpy(),
                                  np.asarray(js._jnp_plan["dkeep"]))
    if mode == "j":
        np.testing.assert_array_equal(ts._djr.numpy(),
                                      np.asarray(p32["djr"]))
        return
    np.testing.assert_array_equal(ts._dfu.numpy(), np.asarray(p32["dfu"]))
    np.testing.assert_array_equal(ts._dfv.numpy(), np.asarray(p32["dfv"]))
    # the builders themselves, in f64, on the storage-frame extents
    p = ts.plan
    comps = tdevice.DEFLATION_COMPS[mode]
    mine = tdevice._defl_basis_arrays(js._block_sizes, p.N, p.M,
                                      p.free_mask, comps)
    theirs = jdevice._defl_basis_arrays(js._block_sizes, p.N, p.M,
                                        p.free_mask, comps)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    assert any(p.transposed)   # the O4H mesh stores wide blocks transposed


def test_unknown_mode_raises_and_env_overrides(pair, monkeypatch):
    _, _, mt, it = pair
    with pytest.raises(ValueError):
        DeviceSmoother(mt, it, device="cpu", deflation="yz")
    monkeypatch.setenv("TURBOMESH_DEFLATION", "xy")
    assert DeviceSmoother(mt, it, device="cpu")._defl_comps == (0, 1)
    monkeypatch.setenv("TURBOMESH_DEFLATION", "0")
    assert DeviceSmoother(mt, it, device="cpu", deflation="y")._defl_K == 0


@pytest.mark.parametrize("mode", MODES)
def test_galerkin_and_coarse_solve_match_jax(pair, mode):
    """dG, dD from each package's prepare on the same base and cf, then
    ``_defl_apply`` on one seeded residual: 5e-5 relative."""
    mj, ij, mt, it = pair
    js = JaxSmoother(mj, ij, mg_opts={"deflation": mode})
    ts = DeviceSmoother(mt, it, device="cpu", deflation=mode)
    p = js.plan
    cf = JWhite(ds_target=1e-4).init(mj)
    X = p.pad_coords(mj.flat_coords()).reshape(p.B, p.N, p.M, 2)
    C = p.pad_cf(cf).reshape(p.B, p.N, p.M, 2)
    jbase, _ = js._jit_base(js._plans_arg, jnp.asarray(X), jnp.asarray(C))
    jctx = js._jit_prepare32(js._plans_arg, jbase, jnp.asarray(C))
    tbase, _ = ts._stage_base(torch.as_tensor(X), torch.as_tensor(C))
    tctx = ts._stage_prepare32(tbase, torch.as_tensor(C))
    assert _rel(tctx["defl"]["G"].numpy(), jctx["dG"]) < 5e-5
    assert _rel(tctx["defl"]["D"].numpy(), jctx["dD"]) < 5e-5
    v = np.random.default_rng(11).standard_normal(
        (X.size // 2, 2)).astype(np.float32)
    jz0, jv = js._jit_defl(js._plans_arg, jctx, jnp.asarray(v))
    tz0, tv = ts._defl_apply(tctx, torch.as_tensor(v))
    assert float(np.abs(np.asarray(jz0)).max()) > 0
    assert _rel(tz0.numpy(), jz0) < 5e-5
    assert _rel(tv.numpy(), jv) < 5e-5


def test_deflation_optin_parity(pair):
    """The port's mirror of tests/test_device_solver.py::
    test_deflation_optin_parity: three linearized solves with host White
    updates between them, every mode converged and within 1e-9 of the
    undeflated solve at each. FGMRES(30): at FGMRES(10) the third solve
    takes 18-31 restart cycles on this mesh, which the test budget does
    not hold; the bar and the tolerances are JAX's."""
    _, _, mesh, info = pair
    white = White(ds_target=1e-4)
    sms = {m: DeviceSmoother(mesh, info, device="cpu", deflation=m,
                             restart=30) for m in (None,) + MODES}
    assert sms[None]._defl_K == 0 and sms["j"]._defl_mode == "junction"
    cf = white.init(mesh)
    cs = {m: mesh.flat_coords() for m in sms}
    try:
        for n in range(3):
            if n > 0:
                mesh.set_flat_coords(cs[None])
                white.update(cf, mesh)
            for m, sm in sms.items():
                cs[m] = sm.solve(cs[m], cf)
                assert sm.last_linear_converged, (m, n)
            for m in MODES:
                err = np.abs(cs[m] - cs[None]).max()
                assert err < 1e-9, (m, n, err)
    finally:
        mesh.set_flat_coords(_meshes()[1].flat_coords())


def test_deflated_solve_matches_jax(pair):
    """Two deflated ("y") Laplace solves of the port against JAX's
    deflated DeviceSmoother: 1e-10."""
    mj, ij, mt, it = pair
    js = JaxSmoother(mj, ij, mg_opts={"deflation": "y"})
    ts = DeviceSmoother(mt, it, device="cpu", deflation="y")
    cf = Laplace().init(mt)
    cj = ct = mt.flat_coords()
    for _ in range(2):
        cj = js.solve(cj, cf)
        ct = ts.solve(ct, cf)
        assert ts.last_linear_converged
        assert np.abs(ct - cj).max() < 1e-10, np.abs(ct - cj).max()


def _undeflated_Minv(sm, ctx, vflat):
    """The preconditioner composition as it stands without deflation."""
    e = sm._stage_interface(ctx, vflat)
    ze = sm._stage_vcycle_interior(ctx, vflat - sm._stage_A32(ctx, e)) + e
    rr = vflat - sm._stage_A32(ctx, ze)
    return ze + sm._interface_passes(ctx, rr)


def test_deflation_off_is_bitwise_unchanged(pair, monkeypatch):
    """With deflation off (the default, and TURBOMESH_DEFLATION=0) the
    solve equals the undeflated composition bit for bit, with the same
    zebra launches, counted through the kernel's Thomas arithmetic."""
    _, _, mt, it = pair

    def counted(*args, **kwargs):
        zebra.ZEBRA_LAUNCHES += 1
        return thomas_half_sweep(*args, **kwargs)

    monkeypatch.setattr(tmg, "zebra_half_sweep", counted)
    cf = White(ds_target=1e-4).init(mt)
    out = []
    for env, composition in (("", None), ("0", None), ("", _undeflated_Minv)):
        monkeypatch.setenv("TURBOMESH_DEFLATION", env)
        sm = DeviceSmoother(mt, it, device="cpu")
        assert sm._defl_K == 0
        if composition is not None:
            monkeypatch.setattr(sm, "_stage_Minv",
                                lambda ctx, v, sm=sm: composition(sm, ctx, v))
        zebra.ZEBRA_LAUNCHES = 0
        coords = sm.solve(mt.flat_coords(), cf)
        out.append((coords, zebra.ZEBRA_LAUNCHES, sm.last_restarts))
    (c0, n0, r0), *rest = out
    assert n0 > 0
    for c, n, r in rest:
        np.testing.assert_array_equal(c, c0)
        assert (n, r) == (n0, r0)
