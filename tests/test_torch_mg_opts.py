"""The preconditioner's options (``mg_opts``) of the port's smoothers vs the
JAX package's: the stages.

One ``_stage_Minv`` application and one V-cycle per option match JAX's
(an instance with the same ``mg_opts``, on the same f32 context and
residual) to 5e-5 relative, the repo's kernel-vs-XLA bar. The sharded
smoother raises on the schedule keys, both smoothers on unknown keys, the
env switches TURBOMESH_SCHUR and TURBOMESH_ADAPTIVE_RTOL take effect
(the latter read as JAX reads it),
``max_iters`` maps as JAX's, and ``multigrid.vcycle_half_sweeps`` counts
the half-sweeps of a V-cycle. The solves under the options are in
tests/test_torch_mg_opts_solve.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_schur import _mesh_all_row_kinds
from turbomesh_tpu import input as jax_input
from turbomesh_tpu.smoothing.classify import classify as jax_classify
from turbomesh_tpu.smoothing.control_function import Laplace as JLaplace
from turbomesh_tpu.smoothing.control_function import White as JWhite
from turbomesh_tpu.smoothing.device import DeviceSmoother as JaxSmoother

import turbomesh_tpu_torch.smoothing.device as device_mod
import turbomesh_tpu_torch.smoothing.multigrid as tmg
from turbomesh_tpu_torch import input as torch_input
from turbomesh_tpu_torch.parallel import ShardedSmoother
from turbomesh_tpu_torch.smoothing.classify import classify
from turbomesh_tpu_torch.smoothing.control_function import Laplace
from turbomesh_tpu_torch.smoothing.device import DeviceSmoother
from turbomesh_tpu_torch.smoothing.system import SparseSystem

from test_torch_analytic import _port_mesh
from test_torch_frontend import ROOT, SMALL_O4H
from test_torch_shard import world1  # noqa: F401

torch.set_num_threads(1)

#: one non-default value of each option the JAX package honours; the
#: small O4H mesh coarsens to two levels, so the depth option takes one
OPTIONS = {
    "base": {"schur": False},
    "ip1": {"interface_passes": 1},
    "ip4": {"interface_passes": 4},
    "split_dirs": {"pre_dirs": "j", "post_dirs": "i"},
    "counts": {"pre": 2, "post": 2, "coarse_iters": 8},
    "n_levels1": {"n_levels": 1},
}
#: the options that change the V-cycle itself
VCYCLE_OPTIONS = ("split_dirs", "counts", "n_levels1")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def o4h():
    mj = jax_input.load(SMALL_O4H, base_dir=str(ROOT))
    mt = torch_input.load(SMALL_O4H, base_dir=str(ROOT))
    mj, mt = mj.template.run(mj.geometry), mt.template.run(mt.geometry)
    return mj, jax_classify(mj), mt, classify(mt)


@pytest.fixture(scope="module")
def strip():
    """tests/test_schur.py's strip (periodic slaves, chains, a junction
    on the periodic seam, sliding rows) in both packages, its Laplace cf
    and the oracle's solve."""
    mj = _mesh_all_row_kinds()
    mt = _port_mesh(mj)
    info = classify(mt)
    cf = Laplace().init(mt)
    np.testing.assert_array_equal(cf, JLaplace().init(mj))
    ref = SparseSystem(mt, info).solve(mt.flat_coords(), cf)
    return mj, jax_classify(mj), mt, info, cf, ref


def _contexts(js, ts, mj):
    """Each package's f32 context on the same base (the mesh's
    coordinates) and White cf."""
    p = js.plan
    cf = JWhite(ds_target=1e-4).init(mj)
    X = p.pad_coords(mj.flat_coords()).reshape(p.B, p.N, p.M, 2)
    C = p.pad_cf(cf).reshape(p.B, p.N, p.M, 2)
    jbase, _ = js._jit_base(js._plans_arg, jnp.asarray(X), jnp.asarray(C))
    jctx = js._jit_prepare32(js._plans_arg, jbase, jnp.asarray(C))
    tbase, _ = ts._stage_base(torch.as_tensor(X), torch.as_tensor(C))
    return jctx, ts._stage_prepare32(tbase, torch.as_tensor(C))


@pytest.fixture(scope="module")
def o4h_ctx(o4h):
    """The default-depth contexts (every option but n_levels reads the
    same one), a seeded f32 residual and the default application on it."""
    mj, ij, mt, it = o4h
    ts = DeviceSmoother(mt, it, device="cpu")
    jctx, tctx = _contexts(JaxSmoother(mj, ij), ts, mj)
    v = np.random.default_rng(3).standard_normal(
        (ts.plan.B * ts.plan.N * ts.plan.M, 2)).astype(np.float32)
    default = ts._stage_Minv(tctx, torch.as_tensor(v)).numpy()
    return jctx, tctx, v, default


def _pair(o4h, o4h_ctx, name):
    """JAX and port smoothers with option ``name`` and their contexts."""
    mj, ij, mt, it = o4h
    opts = OPTIONS[name]
    js = JaxSmoother(mj, ij, mg_opts=opts)
    ts = DeviceSmoother(mt, it, device="cpu", mg_opts=opts)
    if "n_levels" in opts:
        assert len(ts._glue_dev) == len(js._glue) == opts["n_levels"]
        return js, ts, *_contexts(js, ts, mj)
    return js, ts, *o4h_ctx[:2]


@pytest.mark.parametrize("name", list(OPTIONS))
def test_Minv_matches_jax(o4h, o4h_ctx, name):
    """One preconditioner application, port vs JAX ``_jit_Minv`` with the
    same mg_opts, on the same f32 context and residual: 5e-5 relative.
    The option must also change the application (else the case tests
    nothing)."""
    js, ts, jctx, tctx = _pair(o4h, o4h_ctx, name)
    v, default = o4h_ctx[2:]
    want = np.asarray(js._jit_Minv(js._plans_arg, jctx, jnp.asarray(v)))
    got = ts._stage_Minv(tctx, torch.as_tensor(v)).numpy()
    assert _rel(got, want) < 5e-5, _rel(got, want)
    assert _rel(got, default) > 1e-3


@pytest.mark.parametrize("name", VCYCLE_OPTIONS)
def test_vcycle_matches_jax(o4h, o4h_ctx, name):
    """``_stage_vcycle_interior`` against JAX ``_jit_vcycle`` under the
    schedule and depth options: 5e-5 relative."""
    js, ts, jctx, tctx = _pair(o4h, o4h_ctx, name)
    v = o4h_ctx[2]
    want = np.asarray(js._jit_vcycle(js._plans_arg, jctx, jnp.asarray(v)))
    got = ts._stage_vcycle_interior(tctx, torch.as_tensor(v)).numpy()
    assert float(np.abs(want).max()) > 0
    assert _rel(got, want) < 5e-5, _rel(got, want)


@pytest.mark.parametrize("key,value", [
    ("pre", 2), ("post", 0), ("coarse_iters", 8), ("pre_dirs", "j"),
    ("post_dirs", "i"), ("n_levels", 3)])
def test_sharded_schedule_keys_raise(world1, strip, key, value):
    mt, it = strip[2], strip[3]
    with pytest.raises(ValueError, match="single-device"):
        ShardedSmoother(mt, it, device="cpu", mg_opts={key: value})


def test_sharded_accepts_composition_keys(world1, strip, monkeypatch):
    mt, it = strip[2], strip[3]
    sm = ShardedSmoother(mt, it, device="cpu", mg_opts=dict(
        ShardedSmoother.MG_DEFAULTS, schur=False, interface_passes=3,
        deflation="y", adaptive_rtol=False))
    assert not sm._schur and sm._defl_K > 0
    assert sm.mg_opts["interface_passes"] == 3
    monkeypatch.setenv("TURBOMESH_SCHUR", "0")
    assert not ShardedSmoother(mt, it, device="cpu")._schur
    assert ShardedSmoother(mt, it, device="cpu",
                           mg_opts={"schur": True})._schur


def test_unknown_keys_and_bad_values_raise(strip, world1):
    mt, it = strip[2], strip[3]
    for cls in (DeviceSmoother, ShardedSmoother):
        with pytest.raises(ValueError, match="unknown mg_opts"):
            cls(mt, it, device="cpu", mg_opts={"interface_pases": 4})
        with pytest.raises(ValueError, match="both"):
            cls(mt, it, device="cpu", deflation="y",
                mg_opts={"deflation": "xy"})
    with pytest.raises(ValueError, match="pre_dirs"):
        DeviceSmoother(mt, it, device="cpu", mg_opts={"pre_dirs": "k"})
    sm = DeviceSmoother(mt, it, device="cpu", mg_opts={"deflation": "y"})
    assert sm._defl_mode == "bilinear" and sm.mg_opts["deflation"] == "y"


def test_env_switches(strip, monkeypatch):
    """TURBOMESH_SCHUR=0 selects the base composition unless mg_opts says
    otherwise; TURBOMESH_ADAPTIVE_RTOL=0 (or mg_opts adaptive_rtol False)
    keeps every linear solve of a run to target at the instance rtol."""
    mt, it = strip[2], strip[3]
    monkeypatch.setenv("TURBOMESH_SCHUR", "0")
    assert not DeviceSmoother(mt, it, device="cpu")._schur
    assert DeviceSmoother(mt, it, device="cpu", mg_opts={"schur": True})._schur
    monkeypatch.delenv("TURBOMESH_SCHUR")
    assert DeviceSmoother(mt, it, device="cpu")._schur

    cf = Laplace().init(mt)
    kw = dict(device="cpu", rtol=1e-6, atol=1e-8)
    adaptive = DeviceSmoother(mt, it, **kw)
    adaptive.run(mt.flat_coords(), cf.copy(), 2, target_residual=1e-10)
    assert adaptive.last_run_rtols[0] == 1e-2
    for env, opts in (("0", None), ("", {"adaptive_rtol": False})):
        monkeypatch.setenv("TURBOMESH_ADAPTIVE_RTOL", env)
        sm = DeviceSmoother(mt, it, mg_opts=opts, **kw)
        sm.run(mt.flat_coords(), cf.copy(), 2, target_residual=1e-10)
        assert sm.last_run_rtols == [1e-6, 1e-6], (env, opts)


@pytest.mark.parametrize("value", ["", "false", "2"])
def test_adaptive_rtol_env_reads_as_jax(monkeypatch, value):
    """TURBOMESH_ADAPTIVE_RTOL set to anything but "1" turns run's
    adaptive forcing off, as the JAX package's ``== "1"`` does; "1" and
    the variable unset leave it on."""
    monkeypatch.setenv("TURBOMESH_ADAPTIVE_RTOL", value)
    assert device_mod._adaptive_rtol_env() is False
    monkeypatch.setenv("TURBOMESH_ADAPTIVE_RTOL", "1")
    assert device_mod._adaptive_rtol_env() is True
    monkeypatch.delenv("TURBOMESH_ADAPTIVE_RTOL")
    assert device_mod._adaptive_rtol_env() is True


@pytest.mark.parametrize("max_iters,restart", [(95, 10), (5, 10), (None, 10),
                                               (300, 30)])
def test_max_iters_alias(strip, max_iters, restart):
    mj, ij, mt, it = strip[:4]
    ts = DeviceSmoother(mt, it, device="cpu", restart=restart,
                        max_restarts=7, max_iters=max_iters)
    js = JaxSmoother(mj, ij, restart=restart, max_restarts=7,
                     max_iters=max_iters)
    assert ts.max_restarts == js.max_restarts
    assert ts.max_restarts == (7 if max_iters is None
                               else max(1, max_iters // restart))


@pytest.mark.parametrize("opts,levels", [
    ({}, 5), ({"pre": 2, "post": 2, "coarse_iters": 8}, 5),
    ({"pre_dirs": "i", "post_dirs": "ij"}, 3), ({"post": 0}, 2)])
def test_vcycle_half_sweeps_counts_the_vcycle(monkeypatch, opts, levels):
    """``vcycle_half_sweeps`` against the half-sweeps one v_cycle_glued
    call makes on a stand-in hierarchy of ``levels`` levels."""
    calls = []
    monkeypatch.setattr(tmg, "_smooth_glued",
                        lambda level, r, z, directions="ij":
                        calls.append(2 * len(directions)) or z)
    monkeypatch.setattr(tmg, "_apply_glued", lambda level, z: z)
    monkeypatch.setattr(tmg, "_restrict_glued", lambda lv, r, c: r)
    monkeypatch.setattr(tmg, "_prolong", lambda zc, shape: zc)
    lv = {"interior": torch.ones((1, 3, 3), dtype=torch.bool)}
    r = torch.zeros((1, 3, 3, 2))
    tmg.v_cycle_glued([lv] * levels, r, **opts)
    assert sum(calls) == tmg.vcycle_half_sweeps(levels, **opts)
