"""The V-cycle's correction glue on the zebra planes, K-G (``ops/glue.py``).

On the CPU: the plain version ``glue_planes_ref``, which reads the
level's K-G tables, equals ``MapGlue.correction`` between the smooth mask
and the split into planes bit for bit, on every level of T106, LS89 (its
6-point block 3, 2 and 1 wide below level 0) and the medium grid
(``t106_x2``), from both input forms: the level's field and two framed
planes. The table checks raise on corrupted tables; the tables take at
most 0.5 % of each cell's ``peak_mib``. ``v_cycle_glued`` equals the
V-cycle of the per-half-sweep loop it replaces (``smooth_glued_loop``,
kept here as the reference) bit for bit, and launches no K-G on the CPU.
On a card (``-m cuda``): the kernel against the plain version on the same
CUDA tensors, bit for bit; ``v_cycle_glued`` and a replayed
preconditioner application against the loop's, bit for bit, with one
``GLUE_LAUNCHES`` a zebra half-sweep; none under ``ShardedSmoother``.
This file imports no JAX, so its card tests do not reach the JAX package.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import turbomesh_tpu_torch.smoothing.multigrid as tmg
from turbomesh_tpu_torch import input as torch_input
from turbomesh_tpu_torch.ops import glue as kg
from turbomesh_tpu_torch.ops import zebra
from turbomesh_tpu_torch.ops.zebra import zebra_half_sweep
from turbomesh_tpu_torch.smoothing.classify import classify
from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
T106 = ROOT / "examples" / "T106" / "T106.json"
MESHES = ("t106", "ls89", "t106_x2")
#: 0.5 % of each cell's peak_mib (PERF.md §4), in bytes
TABLE_BUDGET = {"t106": 0.43 * 2**20, "ls89": 0.65 * 2**20,
                "t106_x2": 1.2 * 2**20}


def smooth_glued_loop(level, r, z, directions="ij"):
    """The V-cycle's smooth before K-G: per half-sweep the correction glue
    on the (B, N, M, 2) field, two plane copies, the zebra half-sweep,
    the interiors stacked back and masked."""
    zb = level["zebra"]
    rx = tmg._pad1(r[..., 0]).contiguous()
    ry = tmg._pad1(r[..., 1]).contiguous()
    passes = []
    if "i" in directions:
        passes += [(zb["li"], 0, sel) for sel in zb["sel_j"]]
    if "j" in directions:
        passes += [(zb["lj"], 1, sel) for sel in zb["sel_i"]]
    mask = level["interior"][..., None]
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    for (dl, d, du), axis, sel in passes:
        zg = level["glue"].correction(z)
        zx, zy = zebra_half_sweep(
            zb["bx"], zb["by"], zb["cfp"], zb["cfq"], dl, d, du, zb["msk"],
            sel, rx, ry, zg[..., 0].contiguous(), zg[..., 1].contiguous(),
            axis=axis)
        z = torch.stack([zx[:, 1:-1, 1:-1], zy[:, 1:-1, 1:-1]], dim=-1)
        z = torch.where(mask, z, zero)
    return z


def _load(name):
    if name == "t106":
        return torch_input.load(str(T106), base_dir=str(T106.parent))
    cfg = ROOT / "meshbench" / "configs" / f"{name}.json"
    return torch_input.load(json.loads(cfg.read_text()))


def _case(name, device):
    """A smoother of mesh ``name`` on ``device`` and its f32 context (the
    glued levels) at a seeded perturbation and control function."""
    inp = _load(name)
    mesh = inp.template.run(inp.geometry)
    sm = DeviceSmoother(mesh, classify(mesh), device=device)
    rng = np.random.default_rng(7)
    coords = mesh.flat_coords()
    coords = coords + 1e-4 * np.ptp(coords) * rng.standard_normal(
        coords.shape)
    cf = 0.1 * rng.standard_normal((mesh.num_points, 2))
    X, C = sm._upload(coords, cf)
    base, _ = sm._stage_base(X, C)
    return sm, sm._stage_prepare32(base, C)


_CASES = {}


def _cached(name, device):
    if (name, device) not in _CASES:
        _CASES.clear()
        _CASES[name, device] = _case(name, device)
    return _CASES[name, device]


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _inputs(level, seed, device):
    """A field (nonzero off the mask too) and two framed planes (nonzero
    on the ghost ring too) of the level's shape, seeded."""
    B, N, M = level["interior"].shape
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((B, N, M, 2), generator=g).to(device)
    x = torch.randn((B, N + 2, M + 2), generator=g).to(device)
    y = torch.randn((B, N + 2, M + 2), generator=g).to(device)
    return z, (x, y)


def _composition(glue, v, mask):
    """MapGlue.correction between the mask and the split: what the
    V-cycle glued before K-G."""
    if not isinstance(v, torch.Tensor):
        x, y = v
        v = torch.stack([x[:, 1:-1, 1:-1], y[:, 1:-1, 1:-1]], dim=-1)
        v = torch.where(mask[..., None], v,
                        torch.zeros((), dtype=v.dtype, device=v.device))
    vg = glue.correction(v)
    return vg[..., 0].contiguous(), vg[..., 1].contiguous()


# -- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("name", MESHES)
def test_tables_fit_their_budget(name):
    """Every level carries checked K-G tables, within 0.5 % of the cell's
    peak_mib in all."""
    sm, ctx = _cached(name, "cpu")
    tables = [lv["glue"].tables for lv in ctx["mg"]]
    assert all(isinstance(t, kg.GlueTables) for t in tables)
    assert sum(t.nbytes for t in tables) <= TABLE_BUDGET[name]
    for lv, t in zip(ctx["mg"], tables):
        assert t.shape == tuple(lv["interior"].shape)
        assert t.junction.shape[0] > 0 and t.copy.shape[0] > 0


@pytest.mark.parametrize("form", ["field", "planes"])
@pytest.mark.parametrize("name", MESHES)
def test_plain_version_equals_the_correction_glue(name, form):
    """glue_planes (its plain version, on CPU tensors) against
    MapGlue.correction between the mask and the split, every level, bit
    for bit."""
    sm, ctx = _cached(name, "cpu")
    n0 = kg.GLUE_LAUNCHES
    for lvl, level in enumerate(ctx["mg"]):
        z, planes = _inputs(level, 11 + lvl, "cpu")
        v = z if form == "field" else planes
        got = kg.glue_planes(level["glue"].tables, v)
        want = _composition(level["glue"], v, level["interior"])
        for g, w in zip(got, want):
            assert g.is_contiguous() and _same_bits(g, w)
        # the V-cycle's route on the CPU: the composition itself
        for g, w in zip(level["glue"].correction_planes(v, level["interior"]),
                        want):
            assert _same_bits(g, w)
    assert kg.GLUE_LAUNCHES == n0


def test_frame_and_unframe_planes():
    """frame_planes pads by a ring of zeros; unframe_planes selects the
    interior on the mask (a select: -0.0 off the mask becomes +0.0)."""
    g = torch.Generator().manual_seed(3)
    v = torch.randn((3, 5, 4, 2), generator=g)
    x, y = kg.frame_planes(v)
    assert torch.equal(x, F.pad(v[..., 0], (1, 1, 1, 1)))
    assert torch.equal(y, F.pad(v[..., 1], (1, 1, 1, 1)))
    mask = torch.rand((3, 5, 4), generator=g) > 0.5
    x = torch.randn((3, 7, 6), generator=g)
    y = -torch.zeros((3, 7, 6))
    out = kg.unframe_planes(x, y, mask)
    assert torch.equal(out[..., 0], torch.where(mask, x[:, 1:-1, 1:-1], 0.0))
    assert not torch.signbit(out[..., 1][~mask]).any()
    with pytest.raises(ValueError):
        kg.unframe_planes(x[:, :-1], y, mask)
    with pytest.raises(TypeError):
        kg.frame_planes(v.double())


def _t106_level_maps(level_index):
    """(mask, cdst, csrc, jdst, jsrc) of one T106 level as numpy arrays."""
    sm, _ = _cached("t106", "cpu")
    gl = sm._glue_dev[level_index]
    return tuple(gl[k].numpy() for k in ("smooth_mask", "gcdst", "gcsrc",
                                         "gjdst", "gjsrc"))


def _corrupt(kind, code, copy, junction, mask):
    code, copy, junction = code.copy(), copy.copy(), junction.copy()
    framed = np.zeros((mask.shape[0], mask.shape[1] + 2, mask.shape[2] + 2),
                      bool)
    framed[:, 1:-1, 1:-1] = mask
    on = np.flatnonzero(framed)
    if kind == "duplicate destination":
        copy[1, 0] = copy[0, 0]
    elif kind == "destination on the mask":
        code[copy[0, 0]] = kg.ON
        copy[0, 0] = on[0]
        code[on[0]] = kg.DEST
    elif kind == "index outside the frame":
        junction[0, 1] = code.size
    elif kind == "destination without an entry":
        code[np.flatnonzero(code == kg.OFF)[0]] = kg.DEST
    elif kind == "mask point marked off":
        code[on[0]] = kg.OFF
    elif kind == "code of another dtype":
        code = code.astype(np.int32)
    return code, copy, junction


CORRUPTIONS = ("duplicate destination", "destination on the mask",
               "index outside the frame", "destination without an entry",
               "mask point marked off", "code of another dtype")


@pytest.mark.parametrize("kind", CORRUPTIONS)
def test_corrupted_tables_raise(kind):
    """check_tables raises on tables that would leave a framed point with
    no writer or two, or read outside the frame."""
    mask, cdst, csrc, jdst, jsrc = _t106_level_maps(2)
    code, copy, junction = kg.build_tables(mask, cdst, csrc, jdst, jsrc)
    kg.check_tables(code, copy, junction, mask)
    with pytest.raises(ValueError):
        kg.check_tables(*_corrupt(kind, code, copy, junction, mask), mask)


def test_build_tables_raises_on_a_destination_on_the_mask():
    mask, cdst, csrc, jdst, jsrc = _t106_level_maps(1)
    framed = np.zeros((mask.shape[0], mask.shape[1] + 2, mask.shape[2] + 2),
                      bool)
    framed[:, 1:-1, 1:-1] = mask
    cdst = cdst.copy()
    cdst[0] = np.flatnonzero(framed)[0]
    with pytest.raises(ValueError, match="on the smooth mask"):
        kg.build_tables(mask, cdst, csrc, jdst, jsrc)


def test_glue_tables_check_the_tensors():
    """GlueTables raises on a weight of another dtype or shape."""
    sm, ctx = _cached("t106", "cpu")
    t = ctx["mg"][3]["glue"].tables
    with pytest.raises(ValueError):
        kg.GlueTables(t.mask, t.code, t.copy, t.junction, t.cw.double(),
                      t.jw)
    with pytest.raises(ValueError):
        kg.GlueTables(t.mask, t.code, t.copy, t.junction, t.cw,
                      t.jw[:, :-1].contiguous())
    with pytest.raises(ValueError):
        kg.glue_planes(t, torch.zeros((1, 2, 3, 2)))
    with pytest.raises(ValueError, match="mask"):
        kg.GlueTables(t.mask.to(torch.uint8), t.code, t.copy, t.junction,
                      t.cw, t.jw)


def test_correction_planes_takes_only_its_tables_mask():
    """A glue with tables raises on a smooth mask other than the one its
    tables were built from, even one of equal values."""
    sm, ctx = _cached("t106", "cpu")
    level = ctx["mg"][1]
    z, planes = _inputs(level, 5, "cpu")
    for v in (z, planes):
        with pytest.raises(ValueError, match="smooth mask"):
            level["glue"].correction_planes(v, level["interior"].clone())


SCHEDULES = ({}, {"pre": 2, "post": 1, "coarse_iters": 3,
                  "pre_dirs": "j", "post_dirs": "i"})


@pytest.mark.parametrize("opts", SCHEDULES, ids=("default", "split"))
@pytest.mark.parametrize("name", MESHES)
def test_vcycle_equals_the_per_half_sweep_loop(name, opts, monkeypatch):
    """v_cycle_glued on the planes against the V-cycle of the loop it
    replaces, bit for bit, launching no K-G on the CPU."""
    sm, ctx = _cached(name, "cpu")
    levels = ctx["mg"]
    B, N, M = levels[0]["interior"].shape
    g = torch.Generator().manual_seed(5)
    r = torch.randn((B, N, M, 2), generator=g)
    n0 = kg.GLUE_LAUNCHES
    got = tmg.v_cycle_glued(levels, r, **opts)
    assert kg.GLUE_LAUNCHES == n0
    monkeypatch.setattr(tmg, "_smooth_glued", smooth_glued_loop)
    want = tmg.v_cycle_glued(levels, r, **opts)
    assert _same_bits(got, want)
    assert float(want.abs().max()) > 0


# -- on a card ----------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K-G has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", MESHES)
def test_kernel_equals_plain_version_on_the_card(name):
    """K-G against glue_planes_ref on the same CUDA tensors, both forms,
    every level, bit for bit (junction sums included), one GLUE_LAUNCHES
    a call; frame_planes and unframe_planes against their CPU versions."""
    _needs_card()
    sm, ctx = _cached(name, "cuda")
    for lvl, level in enumerate(ctx["mg"]):
        t = level["glue"].tables
        z, planes = _inputs(level, 23 + lvl, "cuda")
        for v in (z, planes):
            n0 = kg.GLUE_LAUNCHES
            got = kg.glue_planes(t, v)
            assert kg.GLUE_LAUNCHES == n0 + 1
            want = kg.glue_planes_ref(t, v)
            torch.cuda.synchronize()
            for g_, w in zip(got, want):
                assert g_.is_contiguous() and _same_bits(g_, w), (lvl, g_.shape)
        for g_, w in zip(kg.frame_planes(z), kg.frame_planes(z.cpu())):
            assert _same_bits(g_.cpu(), w)
        mask = level["interior"]
        assert _same_bits(kg.unframe_planes(*planes, mask).cpu(),
                          kg.unframe_planes(planes[0].cpu(),
                                            planes[1].cpu(), mask.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("opts", SCHEDULES, ids=("default", "split"))
@pytest.mark.parametrize("name", MESHES)
def test_vcycle_on_the_card_equals_the_loop(name, opts, monkeypatch):
    """v_cycle_glued with K-G against the loop's V-cycle on the card, bit
    for bit; GLUE_LAUNCHES rises by the V-cycle's half-sweeps, as
    ZEBRA_LAUNCHES."""
    _needs_card()
    sm, ctx = _cached(name, "cuda")
    levels = ctx["mg"]
    B, N, M = levels[0]["interior"].shape
    g = torch.Generator().manual_seed(9)
    r = torch.randn((B, N, M, 2), generator=g).cuda()
    n0, z0 = kg.GLUE_LAUNCHES, zebra.ZEBRA_LAUNCHES
    got = tmg.v_cycle_glued(levels, r, **opts)
    half = tmg.vcycle_half_sweeps(len(levels), **opts)
    assert kg.GLUE_LAUNCHES - n0 == half == zebra.ZEBRA_LAUNCHES - z0
    monkeypatch.setattr(tmg, "_smooth_glued", smooth_glued_loop)
    n0 = kg.GLUE_LAUNCHES
    want = tmg.v_cycle_glued(levels, r, **opts)
    assert kg.GLUE_LAUNCHES == n0
    torch.cuda.synchronize()
    assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", MESHES)
def test_replayed_application_equals_the_loop(name, monkeypatch):
    """The preconditioner's applications through its CUDA graph (eager,
    capture, replays) with K-G against _stage_Minv with the loop, bit for
    bit; each application counts one GLUE_LAUNCHES a zebra half-sweep."""
    _needs_card()
    sm, _ = _case(name, "cuda")
    ctx = sm._ctx
    P = ctx["baseF32"].shape[0]
    g = torch.Generator().manual_seed(17)
    vs = [torch.randn((P, 2), generator=g).cuda() for _ in range(4)]
    got = []
    for v in vs:
        n0, z0 = kg.GLUE_LAUNCHES, zebra.ZEBRA_LAUNCHES
        # the capture keeps its input as the graph's static input, which
        # every later application overwrites: hand it a copy
        got.append(sm._apply_Minv(ctx, v.clone()).clone())
        assert kg.GLUE_LAUNCHES - n0 == zebra.ZEBRA_LAUNCHES - z0 > 0
    monkeypatch.setattr(tmg, "_smooth_glued", smooth_glued_loop)
    for v, z in zip(vs, got):
        want = sm._stage_Minv(ctx, v)
        torch.cuda.synchronize()
        assert _same_bits(z, want)


@pytest.mark.cuda
def test_no_glue_launch_under_the_sharded_smoother():
    """ShardedSmoother (a world of 1 on the card) glues with ShardGlue's
    exchange arithmetic: K-A launches, K-G does not."""
    _needs_card()
    import torch.distributed as dist

    from turbomesh_tpu_torch.parallel import ShardedSmoother
    from turbomesh_tpu_torch.parallel import dist as pdist

    inp = _load("t106")
    mesh = inp.template.run(inp.geometry)
    pdist.ensure_group("cuda")
    try:
        sm = ShardedSmoother(mesh, classify(mesh), device="cuda",
                             max_restarts=1)
        n0, z0 = kg.GLUE_LAUNCHES, zebra.ZEBRA_LAUNCHES
        sm.solve(mesh.flat_coords(), np.zeros((mesh.num_points, 2)))
        torch.cuda.synchronize()
        assert zebra.ZEBRA_LAUNCHES > z0
        assert kg.GLUE_LAUNCHES == n0
    finally:
        dist.destroy_process_group()
