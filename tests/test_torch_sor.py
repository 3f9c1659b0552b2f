"""Port red-black SOR (turbomesh_tpu_torch.ops.sor) and the probe kernel
(ops.probe) vs the JAX package.

The same seeded numpy inputs go through JAX ``red_black_sor`` (its XLA
math, and its Pallas kernel in interpret mode) and the port's wrapper,
which runs the plain version ``red_black_sor_ref`` on CPU tensors. The
``cuda``-marked tests hold the CUDA kernels against their plain versions
on the card and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbomesh_tpu.ops.sor import red_black_sor as jax_red_black_sor

from turbomesh_tpu_torch.clustering import Uniform
from turbomesh_tpu_torch.ops import probe as probe_mod
from turbomesh_tpu_torch.ops import sor

torch.set_num_threads(1)


def _square(n, m, dtype=np.float64):
    u = Uniform()(n)
    v = Uniform()(m)
    return np.stack(np.meshgrid(u, v, indexing="ij"), axis=-1).astype(dtype)


def _interior(n, m):
    mask = np.zeros((n, m), dtype=bool)
    mask[1:-1, 1:-1] = True
    return mask


def _g11_g12(base):
    """The reference's metrics g11 and g12 of ``base`` (circular shifts)."""
    x_xi = 0.5 * (np.roll(base, -1, 0) - np.roll(base, 1, 0))
    x_eta = 0.5 * (np.roll(base, -1, 1) - np.roll(base, 1, 1))
    return (x_xi * x_xi).sum(-1), (x_xi * x_eta).sum(-1)


def _case(n, m, seed, dtype=np.float64, mask=None):
    """(base, cf, x0, mask): a non-orthogonal base (the unit square
    sheared, x += 0.3 y, with a seeded perturbation of its interior, so
    that g12 and with it the stencil's cross terms are not 0), perturbed
    interior, random P, Q (P != Q)."""
    rng = np.random.default_rng(seed)
    base = _square(n, m)
    base[..., 0] += 0.3 * base[..., 1]
    base[1:-1, 1:-1] += (0.2 / max(n, m)
                         * rng.standard_normal((n - 2, m - 2, 2)))
    base = base.astype(dtype)
    mask = _interior(n, m) if mask is None else mask
    g11, g12 = _g11_g12(base.astype(np.float64))
    assert np.abs(g12[mask]).max() >= 0.1 * np.abs(g11[mask]).max()
    x0 = base.copy()
    x0[mask] += (0.02 * rng.standard_normal(x0[mask].shape)).astype(dtype)
    cf = (0.1 * rng.standard_normal((n, m, 2))).astype(dtype)
    return base, cf, x0, mask


def _both(args, sweeps, **jax_kwargs):
    """(JAX result, port result) as numpy arrays."""
    want = jax_red_black_sor(*[jnp.asarray(a) for a in args], omega=1.5,
                             sweeps=sweeps, **jax_kwargs)
    got = sor.red_black_sor(*[torch.as_tensor(a) for a in args], omega=1.5,
                            sweeps=sweeps)
    return np.asarray(want), got.numpy()


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_matches_jax_xla_f64():
    """f64, 17 x 13, random perturbation and cf, 25 sweeps: the same
    operations in the same order, so agreement to roundoff (measured
    6.0e-16 relative). Bar 1e-12."""
    args = _case(17, 13, seed=0)
    want, got = _both(args, 25, use_pallas=False)
    assert _rel(got, want) <= 1e-12
    assert np.abs(got - args[2]).max() > 1e-3  # the sweeps moved points


def test_matches_jax_pallas_interpret_f32():
    """f32, 16 x 16, against the Pallas kernel run in interpret mode (as
    tests/test_sor.py runs it on the CPU). XLA:CPU may contract and fuse
    differently from PyTorch's elementwise kernels: measured max |err|
    4.2e-7 at max |x| 1.3, about 3.5 ulp. Bar: atol 1e-6, rtol 0."""
    args = _case(16, 16, seed=1, dtype=np.float32)
    want, got = _both(args, 5, use_pallas=True, interpret=True)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_mask_on_the_edges_wraps_around():
    """A mask that holds row 0 and column 0: their neighbours are row N-1
    and column M-1 (the reference's circular shifts), in the port as in
    JAX."""
    n, m = 11, 9
    rng = np.random.default_rng(2)
    mask = rng.random((n, m)) < 0.6
    mask[0, :] = True
    mask[:, 0] = True
    args = _case(n, m, seed=3, mask=mask)
    want, got = _both(args, 25, use_pallas=False)
    assert _rel(got, want) <= 1e-12
    # the edge rows did move, so the wrapped neighbours were used
    assert np.abs(got[0] - args[2][0]).max() > 1e-3
    assert np.abs(got[:, 0] - args[2][:, 0]).max() > 1e-3
    # points outside the mask are copied through bit for bit
    np.testing.assert_array_equal(got[~mask], args[2][~mask])


def test_rb_sor_converges_to_uniform():
    """Mirror of tests/test_sor.py: frozen Laplace coefficients at the
    uniform grid relax a distorted interior back to it."""
    n, m = 17, 13
    exact = _square(n, m)
    rng = np.random.default_rng(0)
    x0 = exact.copy()
    x0[1:-1, 1:-1] += 0.02 * rng.standard_normal(x0[1:-1, 1:-1].shape)
    base = torch.as_tensor(exact)
    cf = torch.zeros(n, m, 2, dtype=torch.float64)
    mask = torch.as_tensor(_interior(n, m))
    x = torch.as_tensor(x0)
    for _ in range(20):
        x = sor.red_black_sor(base, cf, x, mask, omega=1.5, sweeps=25)
    err = np.abs(x.numpy() - exact).max()
    assert err < 1e-10, err


def test_rb_sor_boundary_fixed():
    n = m = 9
    exact = _square(n, m)
    x0 = exact.copy()
    x0[1:-1, 1:-1] += 0.05
    x = sor.red_black_sor(torch.as_tensor(exact),
                          torch.zeros(n, m, 2, dtype=torch.float64),
                          torch.as_tensor(x0),
                          torch.as_tensor(_interior(n, m)), sweeps=3).numpy()
    np.testing.assert_array_equal(x[0, :], exact[0, :])
    np.testing.assert_array_equal(x[-1, :], exact[-1, :])
    np.testing.assert_array_equal(x[:, 0], exact[:, 0])
    np.testing.assert_array_equal(x[:, -1], exact[:, -1])


def test_wrapper_cpu_runs_plain_version_and_checks_inputs():
    base, cf, x0, mask = [torch.as_tensor(a) for a in _case(8, 6, seed=4)]
    keep = x0.clone()
    before = sor.SOR_LAUNCHES
    got = sor.red_black_sor(base, cf, x0, mask, omega=1.3, sweeps=4)
    assert sor.SOR_LAUNCHES == before  # the plain version is no launch
    torch.testing.assert_close(
        got, sor.red_black_sor_ref(base, cf, x0, mask, 1.3, 4), rtol=0,
        atol=0)
    assert torch.equal(x0, keep)  # x0 is not modified
    with pytest.raises(TypeError):
        sor.red_black_sor(base.half(), cf.half(), x0.half(), mask)
    with pytest.raises(ValueError):
        sor.red_black_sor(base.float(), cf, x0, mask)
    with pytest.raises(ValueError):
        sor.red_black_sor(base, cf, x0, mask.double())
    with pytest.raises(ValueError):
        sor.red_black_sor(base[..., 0], cf[..., 0], x0[..., 0], mask)


def test_probe_plain_version():
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(probe_mod.SHAPE)
    before = probe_mod.PROBE_LAUNCHES
    assert torch.equal(probe_mod.probe(x), x + 1.0)
    assert torch.equal(probe_mod.probe_ref(x), x + 1.0)
    assert probe_mod.PROBE_LAUNCHES == before
    with pytest.raises(TypeError):
        probe_mod.probe(x.double())
    with pytest.raises(ValueError):
        probe_mod.probe(x.t())


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    before = probe_mod.PROBE_LAUNCHES
    probe_mod.check_card("cuda")
    assert probe_mod.PROBE_LAUNCHES == before + 1

    edge = np.ones((11, 9), dtype=bool)
    edge[4:7, 3:5] = False
    for n, m, seed, mask in ((17, 13, 0, None), (64, 48, 5, None),
                             (11, 9, 3, edge)):
        for dtype, bar in ((np.float64, 1e-12), (np.float32, 1e-5)):
            args = _case(n, m, seed, dtype=dtype, mask=mask)
            dev = [torch.as_tensor(a, device="cuda") for a in args]
            before = sor.SOR_LAUNCHES
            got = sor.red_black_sor(*dev, omega=1.5, sweeps=50)
            assert sor.SOR_LAUNCHES == before + 100
            want = sor.red_black_sor_ref(
                *[t.double() if t.is_floating_point() else t for t in dev],
                1.5, 50)
            torch.cuda.synchronize()
            assert got.dtype == dev[2].dtype
            err = float((got.double() - want).abs().max()
                        / want.abs().max())
            assert err <= bar, (n, m, dtype, err)
