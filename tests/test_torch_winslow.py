"""The linear Winslow operator K-W (``ops/winslow.py``).

On the CPU: the plain version ``winslow_apply_ref``, which reads the
mesh's K-W tables, equals ``DeviceSmoother._apply`` (the operator through
the exchange hooks, as the sharded subclass runs it) bit for bit on the
small O4H, T106 and medium-grid (``t106_x2``) plans, in f32 with the
metrics ``G`` / ``cG`` and in f64 with ``cG64``, with and without the
offsets and the row scale; so does the smoother's own route ``_op`` (the
wrapper, which runs the plain version there and launches nothing), and the
per-point tables take at most 8 bytes a padded point. The wrapper's checks
raise. On a card (``-m cuda``): the kernel against the plain version on
the same CUDA tensors, bit for bit outside the junction rows and within
1e-14 (f64) / 1e-6 (f32) relative in them, one ``WINSLOW_LAUNCHES`` a call;
a 10-iteration T106 ``smooth_mesh`` through K-W within 1e-10 of the run
through the hooks, with as many iterations; the medium grid under Laplace
control reaches 1e-10 in the hook run's Picard iterations.
"""

import json

import numpy as np
import pytest
import torch

from turbomesh_tpu_torch import input as torch_input
from turbomesh_tpu_torch.ops import winslow
from turbomesh_tpu_torch.smoothing import smooth_mesh
from turbomesh_tpu_torch.smoothing.classify import classify
from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

from test_torch_chain import ROOT, SMALL_CELLS, T106

torch.set_num_threads(1)

T106_X2 = ROOT / "meshbench" / "configs" / "t106_x2.json"
MESHES = ("small", "t106", "t106_x2")
DTYPES = {"f32": torch.float32, "f64": torch.float64}
#: the junction rows' bar on the card, relative to their largest value
JUNCTION_RTOL = {torch.float32: 1e-6, torch.float64: 1e-14}


def _load(name):
    if name == "small":
        cfg = json.loads(T106.read_text())
        cfg["template"]["O4H"]["num_cells"] = dict(SMALL_CELLS)
        return torch_input.load(cfg, base_dir=str(ROOT))
    if name == "t106":
        return torch_input.load(str(T106), base_dir=str(T106.parent))
    return torch_input.load(json.loads(T106_X2.read_text()))


def _case(name, device):
    """A smoother of mesh ``name`` on ``device``, its base and f32
    context at a seeded perturbation of the mesh and a seeded control
    function."""
    inp = _load(name)
    mesh = inp.template.run(inp.geometry)
    sm = DeviceSmoother(mesh, classify(mesh), device=device)
    rng = np.random.default_rng(3)
    coords = mesh.flat_coords()
    coords = coords + 1e-4 * np.ptp(coords) * rng.standard_normal(
        coords.shape)
    cf = 0.1 * rng.standard_normal((mesh.num_points, 2))
    X, C = sm._upload(coords, cf)
    base, _ = sm._stage_base(X, C)
    return sm, base, C, sm._stage_prepare32(base, C)


_CASES = {}


def _cached(name, device):
    if (name, device) not in _CASES:
        _CASES.clear()
        _CASES[name, device] = _case(name, device)
    return _CASES[name, device]


def _operands(case, dtype, scaled, seed):
    """(field, control function, connection metrics, base, G, scale) of
    one call in ``dtype``, as ``_stage_A32`` (f32) and FGMRES's operator
    (f64) pass them."""
    sm, base, C, ctx = case
    gen = torch.Generator(device=base.device).manual_seed(seed)
    V = torch.randn(tuple(base.shape), generator=gen, dtype=dtype,
                    device=base.device)
    scale = (torch.randn(tuple(base.shape), generator=gen, dtype=dtype,
                         device=base.device) if scaled else None)
    if dtype == torch.float32:
        return V, ctx["cf32"], ctx["cG"], None, ctx["G"], scale
    return V, C, ctx["cG64"], base, None, scale


def _hooks(sm, V, cf, cG, w, base, G, scale, ctx):
    """The operator through ``_apply`` and the exchange hooks."""
    B, N, M = sm._shape
    baseF = ctx["baseF32"] if G is not None else base
    R = sm._apply(baseF.reshape(B, N, M, 2), baseF, cf, V, w, G=G, cG=cG)
    return R if scale is None else scale * R


def same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
@pytest.mark.parametrize("w", [0.0, 1.0], ids=["linear", "affine"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", MESHES)
def test_plain_version_on_the_tables_is_apply(name, dtype, w, scaled):
    sm, base, C, ctx = case = _cached(name, "cpu")
    t = sm._winslow
    assert t is not None and t.nbytes <= 8 * t.row.numel()
    V, cf, cG, b, G, scale = _operands(case, DTYPES[dtype], scaled, 7)
    want = _hooks(sm, V, cf, cG, w, b, G, scale, ctx)
    got = winslow.winslow_apply_ref(t, V, cf, cG, w, base=b, G=G,
                                    scale=scale)
    assert same_bits(got, want)
    n = winslow.WINSLOW_LAUNCHES
    baseF = ctx["baseF32"] if G is not None else base
    assert same_bits(sm._op(baseF, cf, V, w, G=G, cG=cG, scale=scale), want)
    assert winslow.WINSLOW_LAUNCHES == n
    # every row kind is there, and each free component is written
    d = t.decoded(DTYPES[dtype])
    assert all(d[k].shape[0] for k in ("c_row", "l_row", "s_row", "sl_row"))
    assert int((want != 0).sum()) > 0.9 * int(d["free_mask"].sum())


def _bad(kind):
    sm, base, C, ctx = case = _cached("small", "cpu")
    args = dict(zip(("V", "cf", "cG", "base", "G", "scale"),
                    _operands(case, torch.float64, True, 8)))
    if kind == "int field":
        args["V"] = args["V"].to(torch.int64)
    elif kind == "f32 control function":
        args["cf"] = args["cf"].float()
    elif kind == "field shape":
        args["V"] = args["V"][:-1]
    elif kind == "metrics shape":
        args["cG"] = args["cG"][:-1]
    elif kind == "non-contiguous field":
        args["V"] = args["V"].t().contiguous().t()
    elif kind == "f64 without base":
        args["base"] = None
    elif kind == "f64 with G":
        args["G"] = ctx["G"]
    elif kind == "f32 without G":
        args.update(V=args["V"].float(), cf=ctx["cf32"], cG=ctx["cG"],
                    base=None, scale=None)
    return sm._winslow, args


@pytest.mark.parametrize("kind, error", [
    ("int field", TypeError), ("f32 control function", TypeError),
    ("field shape", ValueError), ("metrics shape", ValueError),
    ("non-contiguous field", ValueError), ("f64 without base", ValueError),
    ("f64 with G", ValueError), ("f32 without G", ValueError)])
def test_wrapper_raises(kind, error):
    t, a = _bad(kind)
    with pytest.raises(error, match="winslow_apply"):
        winslow.winslow_apply(t, a["V"], a["cf"], a["cG"], 0.0,
                              base=a["base"], G=a["G"], scale=a["scale"])


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
@pytest.mark.parametrize("w", [0.0, 1.0], ids=["linear", "affine"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["t106", "t106_x2"])
def test_kernel_equals_plain_on_card(name, dtype, w, scaled):
    _needs_card()
    sm, base, C, ctx = case = _cached(name, "cuda")
    t = sm._winslow
    V, cf, cG, b, G, scale = _operands(case, DTYPES[dtype], scaled, 9)
    n = winslow.WINSLOW_LAUNCHES
    got = winslow.winslow_apply(t, V, cf, cG, w, base=b, G=G, scale=scale)
    assert winslow.WINSLOW_LAUNCHES == n + 1
    want = winslow.winslow_apply_ref(t, V, cf, cG, w, base=b, G=G,
                                     scale=scale)
    torch.cuda.synchronize()
    junction = torch.zeros(got.shape[0], dtype=torch.bool, device="cuda")
    junction[t.decoded(V.dtype)["l_row"]] = True
    assert same_bits(got[~junction], want[~junction])
    gap = (got[junction] - want[junction]).abs().max()
    assert float(gap) <= JUNCTION_RTOL[V.dtype] * float(
        want[junction].abs().max())


def _job(name, route, monkeypatch, **kw):
    """One job of mesh ``name`` through smooth_mesh on the card, the
    operator through K-W (route "kernel") or through the hooks ("hooks":
    no tables). Returns (coordinates, iterations, K-W launches)."""
    inp = _load(name)
    mesh = inp.template.run(inp.geometry)
    hist = []
    n = winslow.WINSLOW_LAUNCHES
    with monkeypatch.context() as mp:
        if route == "hooks":
            mp.setattr(winslow, "WinslowTables", lambda *args: None)
        smooth_mesh(mesh, kw.pop("iterations", inp.smoothing.iterations),
                    solver="device", residual_history=hist, device="cuda",
                    **kw)
    return mesh.flat_coords(), len(hist), winslow.WINSLOW_LAUNCHES - n


@pytest.mark.cuda
def test_t106_smooth_mesh_through_the_kernel_is_the_hook_run(monkeypatch):
    """10 White iterations of T106: through K-W within 1e-10 of the run
    through the hooks, as many iterations; K-W launched in every operator
    call (25.2 f64 calls, 63 f32 calls in the replays and 2 more an
    iteration: about 90), none in the hook run."""
    _needs_card()
    wall = _load("t106").smoothing.wall_control_function
    got, n_got, launches = _job("t106", "kernel", monkeypatch,
                                wall_control_function=wall)
    want, n_want, none = _job("t106", "hooks", monkeypatch,
                              wall_control_function=wall)
    assert np.abs(got - want).max() <= 1e-10
    assert n_got == n_want == 10
    assert none == 0 and launches >= 60 * n_got


@pytest.mark.cuda
def test_t106_x2_laplace_reaches_target_in_the_hook_runs_iterations(
        monkeypatch):
    _needs_card()
    kw = dict(iterations=30, wall_control_function="laplace",
              target_residual=1e-10)
    _, n_got, launches = _job("t106_x2", "kernel", monkeypatch, **dict(kw))
    _, n_want, none = _job("t106_x2", "hooks", monkeypatch, **dict(kw))
    assert n_got == n_want < 30
    assert none == 0 and launches > 0
