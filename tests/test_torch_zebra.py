"""Port zebra half-sweep and glued smoother vs the JAX package.

``zebra_half_sweep_ref`` (the plain PyTorch version of the CUDA kernel)
is held against the JAX kernel contract ``zebra_pass(use_pallas=False)``
and the three Pallas variants in interpret mode (1e-5, the repo's
kernel-vs-math bar); the port's ``_smooth_glued`` against JAX
``multigrid._smooth_glued`` on a glued O4H level (5e-5 relative, the
repo's kernel-vs-XLA bar). The CUDA kernel itself is compared with the
plain version only on a card; on the CPU its arithmetic (the same
residual, then Thomas elimination along each line) is emulated by
``thomas_half_sweep`` and held against the plain version on the real
T106 level-0 planes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import turbomesh_tpu.smoothing.multigrid as jmg
from turbomesh_tpu import input as jax_input
from turbomesh_tpu.ops.zebra import zebra_pass
from turbomesh_tpu.smoothing.classify import classify as jax_classify
from turbomesh_tpu.smoothing.device import DeviceSmoother as JaxSmoother

import turbomesh_tpu_torch.smoothing.multigrid as tmg
from turbomesh_tpu_torch import input as torch_input
from turbomesh_tpu_torch.ops import zebra
from turbomesh_tpu_torch.smoothing.classify import classify
from turbomesh_tpu_torch.smoothing.device import DeviceSmoother, build_plan
from turbomesh_tpu_torch.smoothing.glue import build_glue
from turbomesh_tpu_torch.smoothing.krylov import thomas

from chip_smoke import PLANE_RTOL, level0_sweeps, max_rel_err
from test_torch_frontend import ROOT, SMALL_O4H, T106

torch.set_num_threads(1)


def thomas_half_sweep(bx, by, cfp, cfq, dl, d, du, msk, sel, rx, ry, zx, zy,
                      axis):
    """The CUDA kernel's arithmetic on CPU tensors: the masked residual of
    the plain version, then sequential Thomas elimination along each line
    (x and y with shared diagonals), then z + sel * sol."""
    resx, resy = zebra.residual_ref(bx, by, cfp, cfq, msk, rx, ry, zx, zy)
    rhs = torch.stack([resx, resy], dim=-1)
    if axis == 0:  # lines along i: put the line axis last
        t = lambda a: a.transpose(1, 2)
        sol = thomas(t(dl), t(d), t(du), rhs.transpose(1, 2)).transpose(1, 2)
    else:
        sol = thomas(dl, d, du, rhs)
    return zx + sel * sol[..., 0], zy + sel * sol[..., 1]


def _planes(shape=(3, 14, 12), seed=2):
    """Kernel operands as in tests/test_zebra.py: unit-normal planes,
    masked ghost frame, nonzero P != Q, diagonally dominant lines."""
    rng = np.random.default_rng(seed)
    B, Ng, Mg = shape

    def mk(scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    bx, by, rx, ry, zx, zy = mk(), mk(), mk(), mk(), mk(), mk()
    cfp, cfq = mk(0.1), mk(0.1)
    d = np.full(shape, 4.0, np.float32)
    dl = -np.ones(shape, np.float32)
    du = -np.ones(shape, np.float32)
    msk = np.ones(shape, np.float32)
    msk[:, [0, -1], :] = 0.0
    msk[:, :, [0, -1]] = 0.0
    sel = ((np.arange(Mg) % 2 == 0).astype(np.float32)[None, None] * msk)
    return [bx, by, cfp, cfq, dl, d, du, msk, sel, rx, ry, zx, zy]


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("variant", ["math", "pcr", "thomas", "split"])
def test_ref_matches_jax_zebra_pass(axis, variant):
    ops = _planes()
    if variant == "math":
        want = zebra_pass(*map(jnp.asarray, ops), axis=axis, use_pallas=False)
    else:
        want = zebra_pass(*map(jnp.asarray, ops), axis=axis, use_pallas=True,
                          interpret=True, variant=variant)
    got = zebra.zebra_half_sweep_ref(*map(torch.as_tensor, ops), axis=axis)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_wrapper_cpu_runs_plain_version_and_checks_inputs():
    ops = [torch.as_tensor(a) for a in _planes()]
    before = zebra.ZEBRA_LAUNCHES
    for axis in (0, 1):
        got = zebra.zebra_half_sweep(*ops, axis=axis)
        want = zebra.zebra_half_sweep_ref(*ops, axis=axis)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert zebra.ZEBRA_LAUNCHES == before  # CPU never counts a launch
    with pytest.raises(TypeError):
        zebra.zebra_half_sweep(*[o.double() for o in ops], axis=0)
    bad = list(ops)
    bad[0] = torch.zeros(3, 12, 14).transpose(1, 2)  # right shape, strided
    with pytest.raises(ValueError, match="contiguous"):
        zebra.zebra_half_sweep(*bad, axis=0)
    bad[0] = torch.zeros(3, 14, 13)
    with pytest.raises(ValueError, match="shape"):
        zebra.zebra_half_sweep(*bad, axis=0)
    with pytest.raises(ValueError, match="axis"):
        zebra.zebra_half_sweep(*ops, axis=2)


@pytest.fixture(scope="module")
def glued_levels():
    """Level 0 of the glued hierarchy of the small O4H mesh, built by
    both packages from the same coordinates (zero control function)."""
    inp = jax_input.load(SMALL_O4H, base_dir=str(ROOT))
    mesh = inp.template.run(inp.geometry)
    sm = JaxSmoother(mesh, jax_classify(mesh))
    p = sm.plan
    X = p.pad_coords(mesh.flat_coords()).reshape(p.B, p.N, p.M, 2)
    C = np.zeros((p.B, p.N, p.M, 2))
    baseF, _ = sm._jit_base(sm._plans_arg, jnp.asarray(X), jnp.asarray(C))
    ctx = sm._jit_prepare32(sm._plans_arg, baseF, jnp.asarray(C))
    jlevel = jmg.MGLevel(ctx["mg"][0])

    tinp = torch_input.load(SMALL_O4H, base_dir=str(ROOT))
    tmesh = tinp.template.run(tinp.geometry)
    dev = DeviceSmoother(tmesh, classify(tmesh), device="cpu")
    tbase, _ = dev._stage_base(torch.as_tensor(X), torch.as_tensor(C))
    tctx = dev._stage_prepare32(tbase, torch.as_tensor(C))
    return jlevel, tctx["mg"][0]


def test_glued_level_matches_jax(glued_levels):
    jl, tl = glued_levels
    np.testing.assert_array_equal(tl["interior"].numpy(),
                                  np.asarray(jl.interior))
    np.testing.assert_allclose(tl["baseg"].numpy(), np.asarray(jl.baseg),
                               rtol=1e-6, atol=0)
    for key in ("lj", "li"):  # ghost-framed zebra planes vs JAX factors
        for a, b in zip(tl["zebra"][key], jl[key]):
            np.testing.assert_allclose(a[:, 1:-1, 1:-1].numpy(),
                                       np.asarray(b), rtol=1e-5, atol=1e-12)


def test_smooth_glued_matches_jax(glued_levels):
    jl, tl = glued_levels
    rng = np.random.default_rng(0)
    shape = tuple(tl["interior"].shape) + (2,)
    mask = tl["interior"].numpy()[..., None]
    r = np.where(mask, rng.standard_normal(shape), 0.0).astype(np.float32)
    z0 = np.zeros_like(r)
    want = np.asarray(jmg._smooth_glued(jl, jnp.asarray(r), jnp.asarray(z0)))
    got = tmg._smooth_glued(tl, torch.as_tensor(r), torch.as_tensor(z0))
    err = float(np.abs(got.numpy() - want).max())
    scale = float(np.abs(want).max()) or 1.0
    assert err / scale < 5e-5, f"smoother mismatch: rel {err / scale:.2e}"


def test_glue_correction_matches_jax(glued_levels):
    jl, tl = glued_levels
    rng = np.random.default_rng(3)
    v = rng.standard_normal(tuple(tl["interior"].shape) + (2,)).astype(
        np.float32)
    want = np.asarray(jmg._glue_correction(jl, jnp.asarray(v)))
    got = tmg._glue_correction(tl, torch.as_tensor(v)).numpy()
    # copies are exact; junction means are K-term sums whose order
    # differs between the two reductions (1 ulp)
    jrows = np.zeros(want.shape[:3], bool).reshape(-1)
    jrows[tl["gjdst"].numpy()] = True
    jrows = jrows.reshape(want.shape[:3])
    assert jrows.any()
    np.testing.assert_array_equal(got[~jrows], want[~jrows])
    np.testing.assert_allclose(got[jrows], want[jrows], rtol=1e-6, atol=0)


def test_zebra_reduces_residual(glued_levels):
    _, tl = glued_levels
    rng = np.random.default_rng(1)
    shape = tuple(tl["interior"].shape) + (2,)
    mask = tl["interior"][..., None]
    r = torch.where(mask, torch.as_tensor(
        rng.standard_normal(shape).astype(np.float32)), 0.0)
    z = torch.zeros_like(r)
    for _ in range(3):
        z = tmg._smooth_glued(tl, r, z)
    res = torch.where(mask, r - tmg._apply_glued(tl, z), 0.0)
    assert float(torch.linalg.vector_norm(res)) < \
        0.2 * float(torch.linalg.vector_norm(r))


@pytest.fixture(scope="module")
def t106_mesh():
    inp = torch_input.load(str(T106), base_dir=str(T106.parent))
    return inp.template.run(inp.geometry)


def test_kernel_arithmetic_matches_plain_on_t106_planes(t106_mesh):
    """The kernel's arithmetic (Thomas, f32) against the plain version
    (PCR) evaluated in f64 on the same operands, on the real T106 level-0
    planes, both line axes, at the bar chip_smoke.py holds the kernel to
    there: max |err| <= 1e-5 max |plain|. Elementwise 1e-5 cannot hold
    between two correct f32 line solvers on these planes: the wall-normal
    lines are only weakly diagonally dominant, and Thomas and PCR differ
    there by up to 14x that bar at small entries. A swapped P and Q moves
    the result by over 100x the bar."""
    for axis, ops in level0_sweeps(t106_mesh, "cpu", seed=1):
        want = zebra.zebra_half_sweep_ref(*[o.double() for o in ops],
                                          axis=axis)

        def rel(planes):
            got = thomas_half_sweep(*planes, axis=axis)
            return max_rel_err([g.double() for g in got], want)

        assert rel(ops) < PLANE_RTOL
        swapped = list(ops)
        swapped[2], swapped[3] = ops[3], ops[2]
        assert rel(swapped) > 100 * PLANE_RTOL


def test_glue_duplicates_resolved_as_xla_cpu(t106_mesh):
    """The reference's glue map has duplicate destinations (4 of 1690 on
    level 0 of the scale-1 T106 mesh, 3 of them between sources whose
    coordinates differ). The port keeps the entry XLA:CPU keeps (the
    last), so its unique-index copies give the reference's glued base
    bit for bit on every level."""
    mesh = t106_mesh
    info = classify(mesh)
    p = build_plan(mesh, info)
    glue = build_glue(mesh, info, p.N, p.M, transposed=p.transposed,
                      keep_boundaries=True)
    assert len(np.unique(glue[0].dst)) < len(glue[0].dst)  # the finding
    X = p.pad_coords(mesh.flat_coords()).reshape(p.B, p.N, p.M, 2)
    X32 = X.astype(np.float32)
    C32 = np.zeros_like(X32)

    prepped = tmg.prep_glue_arrays(glue, "cpu")
    for rec in prepped:
        d = rec["gdst"].numpy()
        assert len(np.unique(d)) == len(d)
    tl = tmg.build_glued_levels(torch.as_tensor(X32), torch.as_tensor(C32),
                                prepped)
    jl = jmg.build_glued_levels(jnp.asarray(X32), jnp.asarray(C32),
                                jmg.prep_glue_arrays(glue))
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a["baseg"].numpy(), np.asarray(b.baseg))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for shape, seed in (((3, 14, 12), 2), ((8, 223, 43), 5)):
        ops = [torch.as_tensor(a, device="cuda") for a in _planes(shape, seed)]
        for axis in (0, 1):
            before = zebra.ZEBRA_LAUNCHES
            got = zebra.zebra_half_sweep(*ops, axis=axis)
            assert zebra.ZEBRA_LAUNCHES == before + 1
            want = zebra.zebra_half_sweep_ref(*ops, axis=axis)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
