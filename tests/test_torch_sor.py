"""Port red-black SOR (turbomesh_tpu_torch.ops.sor) and the probe kernel
(ops.probe) vs the JAX package.

The same seeded numpy inputs go through JAX ``red_black_sor`` (its XLA
math, and its Pallas kernel in interpret mode) and the port's wrapper,
which runs the plain version ``red_black_sor_ref`` on CPU tensors.
``tiled_red_black_sor`` emulates the SOR kernel's order of work (tiles
and halos, several half-sweeps a launch) on the CPU. The ``cuda``-marked
tests hold the CUDA kernels against their plain versions on the card and
skip without one. Neither module imports JAX.
"""

import math
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbomesh_tpu.ops.sor import red_black_sor as jax_red_black_sor

from turbomesh_tpu_torch.clustering import Uniform
from turbomesh_tpu_torch.ops import probe as probe_mod
from turbomesh_tpu_torch.ops import sor

from test_torch_frontend import _no_jax_env

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
    mask = _edge_mask(n, m, 2)
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


def _coefficients(base, cf, omega):
    """The frozen (diag, c_ip, c_im, c_jp, c_jm, h, scale) planes of the
    plain version's half-sweep; scale = -omega / diag_safe."""
    bx, by = base[..., 0], base[..., 1]
    x_xi_x = 0.5 * (torch.roll(bx, -1, 0) - torch.roll(bx, 1, 0))
    x_xi_y = 0.5 * (torch.roll(by, -1, 0) - torch.roll(by, 1, 0))
    x_eta_x = 0.5 * (torch.roll(bx, -1, 1) - torch.roll(bx, 1, 1))
    x_eta_y = 0.5 * (torch.roll(by, -1, 1) - torch.roll(by, 1, 1))
    g11 = x_xi_x * x_xi_x + x_xi_y * x_xi_y
    g22 = x_eta_x * x_eta_x + x_eta_y * x_eta_y
    g12 = x_xi_x * x_eta_x + x_xi_y * x_eta_y
    cfp, cfq = cf[..., 0], cf[..., 1]
    diag = -2.0 * (g11 + g22)
    return (diag, g22 * (1 + 0.5 * cfp), g22 * (1 - 0.5 * cfp),
            g11 * (1 + 0.5 * cfq), g11 * (1 - 0.5 * cfq), 0.5 * g12,
            (-omega) / torch.where(diag == 0.0, 1.0, diag))


def tiled_red_black_sor(base, cf, x0, mask, omega, sweeps, tile, s):
    """The SOR kernel's order of work (csrc/sor.cu) on CPU tensors.

    The coefficients are formed once a call. Tile launch l runs steps =
    min(s, 2 * sweeps - l * s) colored half-sweeps, the first of color
    (l * s) % 2. Each ti x tj tile loads x and the coefficients on the tile
    grown by steps (indices modulo N and M), its colors from the wrapped
    indices; half-sweep k updates the points at least k from the grown
    tile's edge, and the inner tile is written back where it lies in the
    block. Everything the kernel holds but must not read (points outside
    the exact region, the coefficients of the edge and of points outside
    the mask) is NaN here, so a read of it shows.
    """
    N, M = x0.shape[:2]
    ti, tj = tile
    nan = float("nan")
    coef = _coefficients(base, cf, omega)
    ii = torch.arange(N)[:, None]
    jj = torch.arange(M)[None, :]
    color = torch.where(mask, (ii + jj) % 2, 2)
    total = 2 * sweeps
    x = x0.clone()
    for launch in range(math.ceil(total / s)):
        steps = min(s, total - launch * s)
        new = torch.full_like(x, nan)
        H, W = ti + 2 * steps, tj + 2 * steps
        r = torch.arange(H)[:, None]
        c = torch.arange(W)[None, :]
        edge = torch.minimum(torch.minimum(r, H - 1 - r),
                             torch.minimum(c, W - 1 - c))
        for bi in range(math.ceil(N / ti)):
            gi = (bi * ti - steps + torch.arange(H)) % N
            for bj in range(math.ceil(M / tj)):
                gj = (bj * tj - steps + torch.arange(W)) % M
                col = color[gi][:, gj]
                known = (edge >= 1) & (col != 2)
                diag, cip, cim, cjp, cjm, h, scale = [
                    torch.where(known, v[gi][:, gj], nan)[..., None]
                    for v in coef]
                z = x[gi][:, gj]
                for k in range(1, steps + 1):
                    up = torch.roll(z, -1, 0)
                    dn = torch.roll(z, 1, 0)
                    res = (diag * z + cip * up + cim * dn
                           + cjp * torch.roll(z, -1, 1)
                           + cjm * torch.roll(z, 1, 1)
                           - h * torch.roll(up, -1, 1)
                           + h * torch.roll(up, 1, 1)
                           + h * torch.roll(dn, -1, 1)
                           - h * torch.roll(dn, 1, 1))
                    moves = (col == (launch * s + k - 1) % 2)[..., None]
                    z = torch.where(moves, z + scale * res, z)
                    z = torch.where((edge >= k)[..., None], z, nan)
                rows = min(ti, N - bi * ti)
                cols = min(tj, M - bj * tj)
                new[bi * ti:bi * ti + rows, bj * tj:bj * tj + cols] = \
                    z[steps:steps + rows, steps:steps + cols]
        x = new
    return x


def _edge_mask(n, m, seed):
    """The random mask of ``test_mask_on_the_edges_wraps_around``: row 0
    and column 0 inside it."""
    mask = np.random.default_rng(seed).random((n, m)) < 0.6
    mask[0, :] = True
    mask[:, 0] = True
    return mask


@pytest.mark.parametrize("n, m, mask, tile, s, sweeps", [
    (17, 13, None, (8, 8), 4, 25),       # N, M odd, not multiples of the tile
    (24, 20, None, (8, 16), 6, 7),       # 14 half-sweeps: launches 6, 6, 2
    (11, 9, "edge", (8, 8), 8, 25),      # edge mask; grown tile 24 x 24
    (11, 9, "edge", (4, 4), 8, 5),       # the halo wraps twice (below -N)
    (6, 5, None, (6, 5), 8, 3),          # one tile holds the block
    (17, 13, None, (8, 8), 8, 1),        # one sweep, one launch
    (17, 13, None, (8, 8), 1, 5),        # s = 1: a launch a half-sweep
    (64, 48, None, (16, 32), 16, 10),    # the small schedule
    (70, 100, None, (32, 48), 8, 9),     # the large schedule
])
def test_tiled_schedule_matches_plain(n, m, mask, tile, s, sweeps):
    """The kernel's tiling, halos, launches and starting colors give the
    plain version's result: the same arithmetic in another order of
    work, so bitwise in practice. Bar 1e-14 relative; no NaN (nothing
    outside the exact region was read); the points outside the mask
    unchanged."""
    mask = _edge_mask(n, m, 2) if mask == "edge" else None
    base, cf, x0, mask = [torch.as_tensor(a)
                          for a in _case(n, m, seed=3, mask=mask)]
    got = tiled_red_black_sor(base, cf, x0, mask, 1.5, sweeps, tile, s)
    want = sor.red_black_sor_ref(base, cf, x0, mask, 1.5, sweeps)
    assert not torch.isnan(got).any()
    assert _rel(got.numpy(), want.numpy()) <= 1e-14
    assert torch.equal(got[~mask], x0[~mask])
    assert (got - x0).abs().max() > 1e-4  # the sweeps moved points


def test_schedule_fits_the_card():
    """sor_schedule at the bench's 256 x 256, the scale-4 block and small
    blocks: a schedule the kernel takes (shared memory within 227 KB a
    CTA, at most 512 threads, a grown tile of at most 64 columns), a tile
    no larger than the block, s >= 4, and 1 + ceil(2 * sweeps / s)
    launches a call (the coefficients' and the tiles': at most 14 for 50
    sweeps, against 100 at one half-sweep a launch)."""
    f32, f64 = torch.float32, torch.float64
    for dtype in (f32, f64):
        for n, m in ((256, 256), (881, 161), (64, 48), (24, 20), (17, 13),
                     (11, 9), (5, 4)):
            ti, tj, s, rows = sor.sor_schedule(n, m)
            assert sor.sor_schedule_fits(ti, tj, s, rows, dtype)
            assert sor.sor_schedule_fits(*sor.sor_schedule(n, m, 8), dtype)
            assert ti <= n and tj <= m + 1 and s >= 4
            for sweeps in (1, 5, 50):
                assert sor.sor_launches(sweeps, s) == 1 + math.ceil(
                    2 * sweeps / s)
            assert sor.sor_launches(50, s) <= 14
            assert sor.sor_launches(0, s) == 0
    # small tiles where large ones would leave SMs idle
    assert sor.sor_schedule(256, 256) == (16, 32, 16, 16)
    # even tiles: 161 columns in four tiles of 42 (not 48, 48, 48, 17)
    assert sor.sor_schedule(881, 161) == (32, 42, 8, 16)
    assert sor.sor_schedule(881, 161, sms=200) == (16, 28, 16, 16)
    assert sor.sor_schedule(11, 9) == (11, 10, 16, 16)
    assert sor.sor_schedule(24, 20) == (12, 20, 16, 16)
    # (8 + 8 * 2)^2 points x 9 values, a byte a row and a column
    assert sor.sor_smem_bytes(8, 8, 8, f32) == 576 * 36 + 48
    assert sor.sor_smem_bytes(16, 32, 16, f64) == 48 * 64 * 72 + 112
    assert not sor.sor_schedule_fits(16, 33, 8, 16, f64)   # tj odd
    assert not sor.sor_schedule_fits(16, 40, 16, 16, f64)  # 72 columns
    assert not sor.sor_schedule_fits(40, 32, 16, 16, f64)  # 72 rows > 64
    assert not sor.sor_schedule_fits(16, 32, 16, 32, f64)  # 1024 threads
    assert not sor.sor_schedule_fits(32, 32, 16, 16, f64)  # 295 KB


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
            s = sor.sor_schedule(n, m)[2]
            assert sor.SOR_LAUNCHES == before + sor.sor_launches(50, s)
            want = sor.red_black_sor_ref(
                *[t.double() if t.is_floating_point() else t for t in dev],
                1.5, 50)
            torch.cuda.synchronize()
            assert got.dtype == dev[2].dtype
            err = float((got.double() - want).abs().max()
                        / want.abs().max())
            assert err <= bar, (n, m, dtype, err)


def test_sor_and_probe_import_no_jax():
    code = ("import sys\n"
            "import turbomesh_tpu_torch.ops.sor\n"
            "import turbomesh_tpu_torch.ops.probe\n"
            "assert 'jax' not in sys.modules, 'the port imported jax'\n")
    res = subprocess.run([sys.executable, "-c", code], env=_no_jax_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
