"""Port zebra half-sweep and glued smoother vs the JAX package.

``zebra_half_sweep_ref`` (the plain PyTorch version of the CUDA kernel)
is held against the JAX kernel contract ``zebra_pass(use_pallas=False)``
and the three Pallas variants in interpret mode (1e-5, the repo's
kernel-vs-math bar); the port's ``_smooth_glued`` against JAX
``multigrid._smooth_glued`` on a glued O4H level (5e-5 relative, the
repo's kernel-vs-XLA bar). The CUDA kernel itself is compared with the
plain version only on a card; on the CPU its arithmetic (the same
residual, then the partitioned line solve over ``zebra.zebra_chunks(n)``
chunks, Thomas where that is 1) is emulated by ``partitioned_half_sweep``
and held against the plain version, the f64 plain version and JAX
``zebra_pass(use_pallas=False)`` on unit-normal planes, the real T106
level-0 planes and every level of the small O4H mesh's hierarchy.
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

from chip_smoke import PLANE_RTOL, level0_sweeps, level_sweeps, max_rel_err
from test_torch_frontend import ROOT, SMALL_O4H, T106

torch.set_num_threads(1)


def thomas_half_sweep(bx, by, cfp, cfq, dl, d, du, msk, sel, rx, ry, zx, zy,
                      axis):
    """The CUDA kernel's arithmetic for K = 1 (lines of fewer than 16
    points) on CPU tensors: the masked residual of the plain version, then
    sequential f32 Thomas elimination along each line (x and y with shared
    diagonals), then z + sel * sol."""
    resx, resy = zebra.residual_ref(bx, by, cfp, cfq, msk, rx, ry, zx, zy)
    rhs = torch.stack([resx, resy], dim=-1)
    if axis == 0:  # lines along i: put the line axis last
        t = lambda a: a.transpose(1, 2)
        sol = thomas(t(dl), t(d), t(du), rhs.transpose(1, 2)).transpose(1, 2)
    else:
        sol = thomas(dl, d, du, rhs)
    return zx + sel * sol[..., 0], zy + sel * sol[..., 1]


def _nonzero(v):
    return torch.where(v == 0, torch.ones_like(v), v)


def _reduced_thomas(rows):
    """Thomas over the reduced system's rows (A, C, RX, RY), unit diagonal,
    as the kernel's one thread per line runs it; returns [(x, y)]."""
    cpp = torch.zeros_like(rows[0][0])
    dx = torch.zeros_like(cpp)
    dy = torch.zeros_like(cpp)
    fwd = []
    for a, c, rx, ry in rows:
        r = 1.0 / _nonzero(1.0 - a * cpp)
        cpp = c * r
        dx = (rx - a * dx) * r
        dy = (ry - a * dy) * r
        fwd.append((cpp, dx, dy))
    out = [None] * len(rows)
    out[-1] = (dx, dy)
    for r in range(len(rows) - 2, -1, -1):
        cpp, ex, ey = fwd[r]
        dx = ex - cpp * dx
        dy = ey - cpp * dy
        out[r] = (dx, dy)
    return out


def partitioned_solve(a, b, c, rx, ry, chunks):
    """The kernel's line solve on CPU tensors with the line axis last:
    (..., n) f32 diagonals a, b, c and right-hand sides rx, ry -> (x, y).

    ``chunks`` is held to [1, min(MAX_CHUNKS, n // 2)] as in the kernel's
    entry point. K = 1 is Thomas along the line in f32. Otherwise chunk k
    holds [k n / K, (k + 1) n / K); in f64, a forward and a backward
    elimination write each point as px - ap x_s - cp x_e in the chunk's
    end values, the 2K end rows form a reduced system solved by Thomas,
    and the chunks back-substitute; x and y come back in f64. Zero
    denominators become 1 in every elimination."""
    n = b.shape[-1]
    K = max(1, min(chunks, zebra.MAX_CHUNKS, n // 2))
    a = a.clone()
    c = c.clone()
    a[..., 0] = 0.0
    c[..., n - 1] = 0.0
    if K == 1:
        sol = thomas(a, b, c, torch.stack([rx, ry], dim=-1))
        return sol[..., 0], sol[..., 1]
    a, b, c, rx, ry = (v.double() for v in (a, b, c, rx, ry))
    ap, cp = torch.empty_like(b), torch.empty_like(b)
    px, py = torch.empty_like(rx), torch.empty_like(ry)
    bounds = [k * n // K for k in range(K + 1)]
    rows = []
    for k in range(K):
        s0, L = bounds[k], bounds[k + 1] - bounds[k]
        for g in range(s0, s0 + L):
            if g - s0 < 2:
                r = 1.0 / _nonzero(b[..., g])
                ap[..., g] = a[..., g] * r
                px[..., g] = rx[..., g] * r
                py[..., g] = ry[..., g] * r
            else:
                ag = a[..., g]
                r = 1.0 / _nonzero(b[..., g] - ag * cp[..., g - 1])
                ap[..., g] = -(ag * ap[..., g - 1]) * r
                px[..., g] = (rx[..., g] - ag * px[..., g - 1]) * r
                py[..., g] = (ry[..., g] - ag * py[..., g - 1]) * r
            cp[..., g] = c[..., g] * r
        e = s0 + L - 1
        end_row = (ap[..., e], cp[..., e], px[..., e], py[..., e])
        for g in range(s0 + L - 3, s0, -1):
            cpt = cp[..., g].clone()
            px[..., g] = px[..., g] - cpt * px[..., g + 1]
            py[..., g] = py[..., g] - cpt * py[..., g + 1]
            ap[..., g] = ap[..., g] - cpt * ap[..., g + 1]
            cp[..., g] = -(cpt * cp[..., g + 1])
        ap0, cp0, px0, py0 = (ap[..., s0], cp[..., s0], px[..., s0],
                              py[..., s0])
        if L >= 3:
            r = 1.0 / _nonzero(1.0 - cp0 * ap[..., s0 + 1])
            px0 = (px0 - cp0 * px[..., s0 + 1]) * r
            py0 = (py0 - cp0 * py[..., s0 + 1]) * r
            ap0 = ap0 * r
            cp0 = -(cp0 * cp[..., s0 + 1]) * r
        rows += [(ap0, cp0, px0, py0), end_row]
    ends = _reduced_thomas(rows)
    x, y = torch.empty_like(rx), torch.empty_like(ry)
    for k in range(K):
        s0, e = bounds[k], bounds[k + 1] - 1
        (xs, ys), (xe, ye) = ends[2 * k], ends[2 * k + 1]
        inner = slice(s0 + 1, e)
        x[..., inner] = (px[..., inner] - ap[..., inner] * xs[..., None]
                         - cp[..., inner] * xe[..., None])
        y[..., inner] = (py[..., inner] - ap[..., inner] * ys[..., None]
                         - cp[..., inner] * ye[..., None])
        x[..., s0], y[..., s0], x[..., e], y[..., e] = xs, ys, xe, ye
    return x, y


def partitioned_half_sweep(bx, by, cfp, cfq, dl, d, du, msk, sel, rx, ry, zx,
                           zy, axis, chunks=None):
    """The CUDA kernel's arithmetic on CPU tensors: the masked residual of
    the plain version, the partitioned line solve along ``axis`` over
    ``chunks`` chunks (default: the package's rule ``zebra_chunks``), and
    z + sel * sol; a line whose sel is 0 everywhere keeps z. Where the
    kernel's entry point holds K to 1, its Thomas (``thomas_half_sweep``)."""
    n = zx.shape[1 + axis]
    K = zebra.zebra_chunks(n) if chunks is None else chunks
    if min(K, n // 2) <= 1:  # the kernel's Thomas path
        return thomas_half_sweep(bx, by, cfp, cfq, dl, d, du, msk, sel, rx,
                                 ry, zx, zy, axis)
    resx, resy = zebra.residual_ref(bx, by, cfp, cfq, msk, rx, ry, zx, zy)
    # lines along the last axis: axis 0 lines run along i (dim 1)
    t = (lambda v: v.transpose(1, 2)) if axis == 0 else (lambda v: v)
    x, y = partitioned_solve(t(dl), t(d), t(du), t(resx), t(resy), K)
    x, y = t(x).float(), t(y).float()
    active = (sel != 0).any(dim=1 + axis, keepdim=True)
    return (torch.where(active, zx + sel * x, zx),
            torch.where(active, zy + sel * y, zy))


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
    got = tl["glue"].correction(torch.as_tensor(v)).numpy()
    # copies are exact; junction means are K-term sums whose order
    # differs between the two reductions (1 ulp)
    jrows = np.zeros(want.shape[:3], bool).reshape(-1)
    jrows[tl["glue"].jdst.numpy()] = True
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
    """The kernel's arithmetic (the partitioned solve, f32 residual, f64
    recurrences) against the plain version (PCR) evaluated in f64 on the
    same operands, on the real T106 level-0 planes, both line axes, at the
    bar chip_smoke.py holds the kernel to there: max |err| <= 1e-5 max
    |plain|. Elementwise 1e-5 cannot hold between two correct f32 line
    solvers on these planes: the wall-normal lines are only weakly
    diagonally dominant, and Thomas and PCR differ there by up to 14x that
    bar at small entries. A swapped P and Q moves the result by over 100x
    the bar."""
    for axis, ops in level0_sweeps(t106_mesh, "cpu", seed=1):
        want = zebra.zebra_half_sweep_ref(*[o.double() for o in ops],
                                          axis=axis)

        def rel(planes):
            got = partitioned_half_sweep(*planes, axis=axis)
            return max_rel_err([g.double() for g in got], want)

        assert rel(ops) < PLANE_RTOL
        swapped = list(ops)
        swapped[2], swapped[3] = ops[3], ops[2]
        assert rel(swapped) > 100 * PLANE_RTOL


@pytest.fixture(scope="module")
def t106_level0(t106_mesh):
    """Level-0 sweeps of T106 with their f64 plain results."""
    out = []
    for axis, ops in level0_sweeps(t106_mesh, "cpu", seed=1):
        want = zebra.zebra_half_sweep_ref(*[o.double() for o in ops],
                                          axis=axis)
        out.append((axis, ops, want))
    return out


# every K the rule can choose, and one above what any line can take
ALL_K = list(range(1, zebra.MAX_CHUNKS + 1)) + [100]


@pytest.mark.parametrize("K", ALL_K)
def test_partitioned_matches_f64_plain_on_t106_planes(t106_level0, K):
    """The partitioned solve at every K (held to n // 2 and 32) on the real
    T106 level-0 planes (8, 223, 43), both axes, against the f64 plain
    version: max |err| <= PLANE_RTOL max |plain|, the kernel's bar on the
    card. The f64 recurrences keep it near 1e-6 at every K (my CPU run: at
    most 8e-7 on axis 0, 4.2e-6 on axis 1, where K = 1 is f32 Thomas)."""
    for axis, ops, want in t106_level0:
        got = partitioned_half_sweep(*ops, axis=axis, chunks=K)
        assert max_rel_err([g.double() for g in got], want) < PLANE_RTOL


def test_zebra_chunks_rule():
    """K = n // MIN_CHUNK within [1, MAX_CHUNKS]: every chunk holds at least
    MIN_CHUNK points, K = 1 (Thomas) exactly below 2 * MIN_CHUNK, and the
    scale-4 level-0 lines (883 and 163 points) get 32 and 20 chunks."""
    M = zebra.MIN_CHUNK
    for n in range(1, 1500):
        K = zebra.zebra_chunks(n)
        assert 1 <= K <= zebra.MAX_CHUNKS
        assert (K == 1) == (n < 2 * M)
        if K > 1:
            sizes = [(k + 1) * n // K - k * n // K for k in range(K)]
            assert min(sizes) >= M and sum(sizes) == n
            assert max(sizes) - min(sizes) <= 1
    assert [zebra.zebra_chunks(n) for n in (5, 15, 16, 43, 163, 883, 5000)] \
        == [1, 1, 2, 5, 20, 32, 32]


LINE_CASES = [(1, 1), (1, 4), (2, 1), (2, 2), (2, 5), (3, 2), (5, 2), (7, 3),
              (17, 3), (17, 4), (17, 40), (64, 32), (100, 7), (250, 32)]


@pytest.mark.parametrize("n, K", LINE_CASES)
def test_partitioned_line_solve(n, K):
    """The line solve alone against a dense f64 solve, for n = 1 and 2, K
    that does not divide n and K > n (held to n // 2), with identity rows
    inside a line and on chunk edges. The systems are diagonally dominant
    (|d| >= 3, |dl| + |du| <= 2.4, condition number below 10), so f32 input
    rounding bounds the error near 1e-7 relative; the bar is 1e-6."""
    rng = np.random.default_rng(n * 100 + K)
    B = 6
    d = (4.0 + rng.uniform(-1, 1, (B, n))).astype(np.float32)
    dl = (-1.0 + rng.uniform(-0.2, 0.2, (B, n))).astype(np.float32)
    du = (-1.0 + rng.uniform(-0.2, 0.2, (B, n))).astype(np.float32)
    rx = rng.standard_normal((B, n)).astype(np.float32)
    ry = rng.standard_normal((B, n)).astype(np.float32)
    Ke = max(1, min(K, zebra.MAX_CHUNKS, n // 2))
    edges = sorted({k * n // Ke for k in range(Ke)}
                   | {(k + 1) * n // Ke - 1 for k in range(Ke)})
    ident = set(edges[1::2]) | ({n // 2} if n > 2 else set())
    for i in ident:  # identity rows on chunk edges and inside a chunk
        dl[:, i], d[:, i], du[:, i] = 0.0, 1.0, 0.0
    x, y = partitioned_solve(*map(torch.as_tensor, (dl, d, du, rx, ry)), K)
    T = np.zeros((B, n, n))
    for i in range(n):
        T[:, i, i] = d[:, i]
        if i > 0:
            T[:, i, i - 1] = dl[:, i]
        if i < n - 1:
            T[:, i, i + 1] = du[:, i]
    want = np.linalg.solve(T, np.stack([rx, ry], -1).astype(np.float64))
    for got, w in ((x, want[..., 0]), (y, want[..., 1])):
        got = got.double().numpy()
        assert np.abs(got - w).max() <= 1e-6 * np.abs(w).max()


@pytest.fixture(scope="module")
def unit_planes_refs():
    """Unit-normal planes long enough for K = 32 on both axes, with the
    plain version and JAX zebra_pass(use_pallas=False) on each axis."""
    ops = _planes(shape=(3, 70, 66), seed=4)
    refs = {}
    for axis in (0, 1):
        plain = zebra.zebra_half_sweep_ref(*map(torch.as_tensor, ops),
                                           axis=axis)
        jax_out = zebra_pass(*map(jnp.asarray, ops), axis=axis,
                             use_pallas=False)
        refs[axis] = ([p.numpy() for p in plain],
                      [np.asarray(j) for j in jax_out])
    return [torch.as_tensor(a) for a in ops], refs


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("K", ALL_K)
def test_partitioned_matches_plain_and_jax_on_unit_planes(unit_planes_refs,
                                                          axis, K):
    """The partitioned solve at every K against the plain version and JAX
    zebra_pass(use_pallas=False) on unit-normal planes with diagonally
    dominant lines: rtol = atol = 1e-5, the repo's kernel-vs-math bar
    (tests/test_zebra.py:103)."""
    ops, refs = unit_planes_refs
    got = partitioned_half_sweep(*ops, axis=axis, chunks=K)
    for want in refs[axis]:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def o4h_hierarchy():
    """Every level of the glued hierarchy of the small O4H mesh: both
    colors of both axes (chip_smoke.level_sweeps)."""
    inp = torch_input.load(SMALL_O4H, base_dir=str(ROOT))
    mesh = inp.template.run(inp.geometry)
    return level_sweeps(mesh, "cpu", seed=2, colors=(0, 1))


def test_partitioned_on_every_o4h_level(o4h_hierarchy):
    """On every level of the small O4H mesh's hierarchy (level 0 lines of
    38 and 9 points: K = 4 and 1), the kernel's arithmetic against the
    f64 plain version at PLANE_RTOL, and against JAX
    zebra_pass(use_pallas=False) on the same operands at 1e-5 max |JAX|
    (JAX's f32 PCR carries its own error of that order, as the plain
    version's does)."""
    assert len(o4h_hierarchy) >= 2
    for sweeps in o4h_hierarchy:
        for axis, ops in sweeps:
            got = partitioned_half_sweep(*ops, axis=axis)
            want = zebra.zebra_half_sweep_ref(*[o.double() for o in ops],
                                              axis=axis)
            assert max_rel_err([g.double() for g in got], want) < PLANE_RTOL
            jax_out = zebra_pass(*[jnp.asarray(o.numpy()) for o in ops],
                                 axis=axis, use_pallas=False)
            jw = [torch.as_tensor(np.array(j)).double() for j in jax_out]
            assert max_rel_err([g.double() for g in got], jw) < PLANE_RTOL


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
    # Thomas (K = 1) and partitioned (K = 27 and 5) lines
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
