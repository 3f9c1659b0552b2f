"""The preconditioner's kept context and its CUDA graph
(``DeviceSmoother._stage_prepare32``, ``_apply_Minv``).

On the CPU: the split context (the parts that depend on the mesh alone
built once, ``multigrid.glued_level_statics``; the per-solve parts written
every solve into the tensors of the first) gives levels and a context
equal bit for bit to a build from scratch, keeps its tensors' addresses
and refreshes every per-solve tensor from one solve to the next, on one
device and on the sharded path (a world of 1); a
3-iteration small-O4H ``run`` gives the coordinates of a run that builds
its context from scratch every solve, with the same zebra launches, under
the default options, ``schur`` False, the split "j" / "i" schedule and
``n_levels`` 3; a smoother on the CPU has no graph. On a card (``-m cuda``):
the replayed application equals the eager one bit for bit over 30
applications spanning two solves (T106 and the medium grid), with its K-A,
K-I and K-W launches, a 10-iteration
T106 ``smooth_mesh`` gives the eager run's coordinates and launch counts
with one capture, the deflated path and ``ShardedSmoother`` capture
nothing, a capture succeeds while a collection frees another smoother's
graph, two threads capture at once, and neither the peak memory nor the
memory the allocator holds grows over consecutive jobs.
"""

import gc
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import turbomesh_tpu_torch.smoothing.device as device_mod
import turbomesh_tpu_torch.smoothing.multigrid as tmg
from turbomesh_tpu_torch import input as torch_input
from turbomesh_tpu_torch.ops import chain, winslow, zebra
from turbomesh_tpu_torch.parallel import ShardedSmoother
from turbomesh_tpu_torch.parallel import dist as pdist
from turbomesh_tpu_torch.smoothing import smooth_mesh
from turbomesh_tpu_torch.smoothing.classify import classify
from turbomesh_tpu_torch.smoothing.control_function import White
from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

from test_torch_chain import ROOT, SMALL_CELLS, T106

torch.set_num_threads(1)

#: the medium grid of the benchmark (98,228 points)
T106_X2 = ROOT / "meshbench" / "configs" / "t106_x2.json"

#: the options the kept context is held under
OPTIONS = {
    "defaults": None,
    "base": {"schur": False},
    "split_dirs": {"pre_dirs": "j", "post_dirs": "i"},
    "n_levels3": {"n_levels": 3},
}


def _mesh(name):
    if name == "small":
        cfg = json.loads(T106.read_text())
        cfg["template"]["O4H"]["num_cells"] = dict(SMALL_CELLS)
        inp = torch_input.load(cfg, base_dir=str(ROOT))
    elif name == "t106":
        inp = torch_input.load(str(T106), base_dir=str(T106.parent))
    else:
        inp = torch_input.load(json.loads(T106_X2.read_text()))
    return inp.template.run(inp.geometry)


@pytest.fixture(scope="module")
def t106():
    mesh = _mesh("t106")
    return mesh, classify(mesh)


@pytest.fixture(scope="module")
def small():
    mesh = _mesh("small")
    return mesh, classify(mesh)


def _leaves(tree, path=()):
    """(path, tensor) of every tensor of a context or level tree."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return []
    return [leaf for k, v in items for leaf in _leaves(v, path + (k,))]


def _same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


def _assert_trees_equal(got, want):
    lg, lw = _leaves(got), _leaves(want)
    assert [p for p, _ in lg] == [p for p, _ in lw]
    for (path, a), (_, b) in zip(lg, lw):
        assert _same_bits(a.contiguous(), b.contiguous()), path


def _inputs(sm, mesh, seed):
    """A padded coordinate stack and control function: the mesh moved by
    a seeded perturbation of 1e-4 of its extent, and a seeded random
    control function."""
    rng = np.random.default_rng(seed)
    coords = mesh.flat_coords()
    coords = coords + 1e-4 * np.ptp(coords) * rng.standard_normal(
        coords.shape)
    cf = 0.1 * rng.standard_normal((mesh.num_points, 2))
    return sm._upload(coords, cf)


def _new_smoother(mesh, info, name):
    """A DeviceSmoother on the CPU under the options ``name``, or with
    "sharded_world1" a ShardedSmoother of the world of 1."""
    if name == "sharded_world1":
        return ShardedSmoother(mesh, info, device="cpu")
    return DeviceSmoother(mesh, info, device="cpu", mg_opts=OPTIONS[name])


def _scratch_ctx(mesh, info, name, X, C):
    """The context a new smoother builds on its first solve, and its
    levels built by ``build_glued_levels`` from nothing (the sharded one's
    from the single-device maps of its logical frame)."""
    sm = _new_smoother(mesh, info, name)
    base, _ = sm._stage_base(X, C)
    ctx = sm._stage_prepare32(base, C)
    B, N, M = sm._shape
    glue = (tmg.prep_glue_arrays(sm.layout.glue_levels, "cpu")
            if name == "sharded_world1" else sm._glue_dev)
    levels = tmg.build_glued_levels(
        base.to(torch.float32).reshape(B, N, M, 2), C.to(torch.float32),
        glue)
    return ctx, levels


@pytest.mark.parametrize("name", ["defaults", "n_levels3", "sharded_world1"])
def test_kept_context_equals_a_build_from_scratch(t106, request, name):
    """Two solves in a row on T106: after each the kept context equals a
    new smoother's context of the same solve and its levels equal
    ``build_glued_levels`` from nothing, bit for bit; the kept tensors keep
    their addresses; every tensor that is not the mesh's alone changes
    from the first solve to the second. The sharded smoother (a world of
    1) keeps its context the same way."""
    mesh, info = t106
    if name == "sharded_world1":
        pdist.ensure_group("cpu")
        request.addfinalizer(dist.destroy_process_group)
    sm = _new_smoother(mesh, info, name)
    if name == "n_levels3":
        assert len(sm._glue_dev) == 3
    snaps = []
    for seed in (1, 2):
        X, C = _inputs(sm, mesh, seed)
        base, _ = sm._stage_base(X, C)
        ctx = sm._stage_prepare32(base, C)
        assert ctx is sm._ctx
        want, levels = _scratch_ctx(mesh, info, name, X, C)
        _assert_trees_equal(ctx, want)
        _assert_trees_equal(ctx["mg"], levels)
        snaps.append([(p, t.data_ptr(), t.clone()) for p, t in _leaves(ctx)])
    static = {id(t) for _, t in _leaves(sm._mg_static)}
    changed = 0
    for (path, ptr1, t1), (_, ptr2, t2), (_, t) in zip(*snaps,
                                                         _leaves(sm._ctx)):
        assert ptr1 == ptr2, path
        if id(t) in static:
            assert _same_bits(t1, t2), path
        else:
            assert not torch.equal(t1, t2), path
            changed += 1
    assert changed > 20


def _fresh_every_solve(sm):
    """Make ``sm`` build its context from scratch at every solve, as the
    port did before it kept one."""
    inner = sm._stage_prepare32

    def prepare(base, cf):
        sm._ctx = None
        return inner(base, cf)

    sm._stage_prepare32 = prepare


def _counted(monkeypatch):
    """Count the zebra half-sweeps of the plain version in
    ZEBRA_LAUNCHES, as the kernel's wrapper does on a card."""
    sweep = tmg.zebra_half_sweep

    def counted(*args, **kwargs):
        zebra.ZEBRA_LAUNCHES += 1
        return sweep(*args, **kwargs)

    monkeypatch.setattr(tmg, "zebra_half_sweep", counted)


def _checked_every_solve(sm, mesh, info, opts):
    """After each of ``sm``'s solves builds its context, hold it bit for
    bit to the context a new smoother builds from scratch for the same
    solve; returns the list of the solves checked."""
    inner = sm._stage_prepare32
    scratch = DeviceSmoother(mesh, info, device="cpu", mg_opts=opts)
    checked = []

    def prepare(base, cf):
        ctx = inner(base, cf)
        scratch._ctx = None
        _assert_trees_equal(ctx, scratch._stage_prepare32(base, cf))
        checked.append(ctx is sm._ctx)
        return ctx

    sm._stage_prepare32 = prepare
    return checked


def _run3(sm, mesh):
    zebra.ZEBRA_LAUNCHES = chain.CHAIN_LAUNCHES = 0
    alg = White(ds_target=1e-4)
    coords, cf, disp, n = sm.run(mesh.flat_coords(), alg.init(mesh), 3,
                                 algorithm=alg)
    assert n == 3 and sm._graph is None
    return (coords, cf, disp, zebra.ZEBRA_LAUNCHES, chain.CHAIN_LAUNCHES,
            sm.last_run_rtols)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_run_with_the_kept_context_is_bitwise(small, monkeypatch, name):
    """A 3-iteration White run on the small O4H mesh with the kept
    context: at each of its solves the kept context equals, bit for bit,
    the one a new smoother builds from scratch, so the run is the run
    that builds its context every solve. With the default options that
    run is made too: coordinates, control function, residual and zebra
    launches equal. CPU tensors capture and replay no graph."""
    mesh, info = small
    _counted(monkeypatch)
    device_mod.PRECOND_CAPTURES = device_mod.PRECOND_REPLAYS = 0
    opts = OPTIONS[name]
    sm = DeviceSmoother(mesh, info, device="cpu", mg_opts=opts)
    checked = _checked_every_solve(sm, mesh, info, opts)
    kept = _run3(sm, mesh)
    assert checked == [True] * 3
    assert kept[3] > 0
    if name == "defaults":
        fresh = DeviceSmoother(mesh, info, device="cpu", mg_opts=opts)
        _fresh_every_solve(fresh)
        (c0, f0, *rest0), (c1, f1, *rest1) = kept, _run3(fresh, mesh)
        np.testing.assert_array_equal(c0, c1)
        np.testing.assert_array_equal(f0, f1)
        assert rest0 == rest1
    assert device_mod.PRECOND_CAPTURES == device_mod.PRECOND_REPLAYS == 0


def test_no_graph_on_cpu_tensors(small):
    """A smoother on the CPU has no graph: ``_apply_Minv`` runs
    ``_stage_Minv`` eagerly every time, the same values, no capture."""
    mesh, info = small
    sm = DeviceSmoother(mesh, info, device="cpu")
    X, C = _inputs(sm, mesh, 3)
    base, _ = sm._stage_base(X, C)
    ctx = sm._stage_prepare32(base, C)
    rng = np.random.default_rng(4)
    captures = device_mod.PRECOND_CAPTURES
    for _ in range(3):
        v = torch.as_tensor(rng.standard_normal((base.shape[0], 2)),
                            dtype=torch.float32)
        assert _same_bits(sm._apply_Minv(ctx, v), sm._stage_Minv(ctx, v))
    assert sm._graph is None
    assert device_mod.PRECOND_CAPTURES == captures


# -- on a card --------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")


def _eager(monkeypatch):
    """Every application eager, as the port ran before the graph."""
    monkeypatch.setattr(DeviceSmoother, "_apply_Minv",
                        lambda self, ctx, v: self._stage_Minv(ctx, v))


def _launches():
    """The K-A, K-I and K-W launches so far."""
    return (zebra.ZEBRA_LAUNCHES, chain.CHAIN_LAUNCHES,
            winslow.WINSLOW_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["t106", "t106_x2"])
def test_replay_equals_eager_over_two_solves(name):
    """30 applications over two solves: each through ``_apply_Minv``
    (eager, capture, then replays) equals the eager ``_stage_Minv`` on the
    same context and input, bit for bit, with the eager application's
    zebra, chain and K-W launches (K-W: 3 a default application); one
    capture, 29 replays."""
    _needs_card()
    mesh = _mesh(name)
    sm = DeviceSmoother(mesh, classify(mesh), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    c0, r0 = device_mod.PRECOND_CAPTURES, device_mod.PRECOND_REPLAYS
    for seed in (1, 2):
        X, C = _inputs(sm, mesh, seed)
        base, _ = sm._stage_base(X, C)
        ctx = sm._stage_prepare32(base, C)
        for _ in range(15):
            v = torch.randn((base.shape[0], 2), generator=gen, device="cuda")
            n = _launches()
            got = sm._apply_Minv(ctx, v).clone()
            n_got = tuple(b - a for a, b in zip(n, _launches()))
            n = _launches()
            want = sm._stage_Minv(ctx, v)
            n_want = tuple(b - a for a, b in zip(n, _launches()))
            assert _same_bits(got, want)
            assert n_got == n_want and n_want[0] > 0 and n_want[2] == 3
    assert device_mod.PRECOND_CAPTURES - c0 == 1
    assert device_mod.PRECOND_REPLAYS - r0 == 29


def _job(iterations=10, **kw):
    inp = torch_input.load(str(T106), base_dir=str(T106.parent))
    mesh = inp.template.run(inp.geometry)
    n = (zebra.ZEBRA_LAUNCHES, chain.CHAIN_LAUNCHES,
         device_mod.PRECOND_CAPTURES)
    smooth_mesh(mesh, iterations, solver="device",
                wall_control_function=inp.smoothing.wall_control_function,
                device="cuda", **kw)
    return (mesh.flat_coords(), zebra.ZEBRA_LAUNCHES - n[0],
            chain.CHAIN_LAUNCHES - n[1], device_mod.PRECOND_CAPTURES - n[2])


@pytest.mark.cuda
def test_smooth_mesh_with_the_graph_is_the_eager_run(monkeypatch):
    """A 10-iteration T106 smooth_mesh on the device: with the graph, the
    eager run's coordinates bit for bit, its zebra and chain launches
    (1,008 and 63 an iteration), and one capture."""
    _needs_card()
    coords, nz, nc, caps = _job()
    with monkeypatch.context() as mp:
        _eager(mp)
        e_coords, e_nz, e_nc, e_caps = _job()
    np.testing.assert_array_equal(coords, e_coords)
    assert (nz, nc) == (e_nz, e_nc) == (10080, 630)
    assert (caps, e_caps) == (1, 0)


@pytest.mark.cuda
def test_no_capture_deflated_or_sharded(monkeypatch):
    """TURBOMESH_DEFLATION=y and a ShardedSmoother of world 1 have no
    graph and run every application eagerly (the sharded one with its
    kept context): no capture, no replay."""
    _needs_card()
    mesh = _mesh("small")
    info = classify(mesh)
    cf = White(ds_target=1e-4).init(mesh)
    n = (device_mod.PRECOND_CAPTURES, device_mod.PRECOND_REPLAYS)
    with monkeypatch.context() as mp:
        mp.setenv("TURBOMESH_DEFLATION", "y")
        sm = DeviceSmoother(mesh, info, device="cuda")
        sm.solve(mesh.flat_coords(), cf)
        assert sm._graph is None
    sh = ShardedSmoother(mesh, info, device="cuda")
    try:
        sh.solve(mesh.flat_coords(), cf)
    finally:
        dist.destroy_process_group()
    assert sh._graph is None and sh._ctx is not None
    assert (device_mod.PRECOND_CAPTURES,
            device_mod.PRECOND_REPLAYS) == n


@pytest.mark.cuda
def test_capture_survives_a_collection_of_another_graph():
    """A smoother whose graph is cyclic garbage, collected in the middle of
    another smoother's capture (in the capturing thread): the collector
    stays on, the old graph is kept until the capture ends (destroying it
    there would invalidate the capture) and freed then, and the capture
    replays the eager application."""
    _needs_card()
    mesh = _mesh("small")
    info = classify(mesh)
    old = DeviceSmoother(mesh, info, device="cuda")
    old.solve(mesh.flat_coords(), White(ds_target=1e-4).init(mesh))
    assert old._graph.graph is not None
    sm = DeviceSmoother(mesh, info, device="cuda")
    X, C = _inputs(sm, mesh, 6)
    base, _ = sm._stage_base(X, C)
    ctx = sm._stage_prepare32(base, C)
    v = torch.randn((base.shape[0], 2), device="cuda")
    sm._apply_Minv(ctx, v)
    seen = []
    inner = sm._stage_Minv

    def stage(ctx, v):
        gc.collect()
        seen.append((gc.isenabled(), len(device_mod._KEPT)))
        return inner(ctx, v)

    sm._stage_Minv = stage
    old.cycle = old
    del old
    got = sm._apply_Minv(ctx, v).clone()
    assert sm._graph.graph is not None and seen == [(True, 1)]
    assert device_mod._KEPT == [] and device_mod._CAPTURING is None
    assert _same_bits(got, inner(ctx, v))


@pytest.mark.cuda
def test_two_threads_capture_at_once():
    """Two threads, each a smoother of its own, solve at the same time (as
    ``MeshService`` runs two requests): the captures take turns, the
    collector is left on, and each thread's solve equals the eager one bit
    for bit."""
    import threading

    _needs_card()
    mesh = _mesh("small")
    info = classify(mesh)
    cfs = [White(ds_target=1e-4).init(mesh), 0.5 * White(
        ds_target=1e-4).init(mesh)]
    want = []
    for cf in cfs:
        sm = DeviceSmoother(mesh, info, device="cuda")
        sm._apply_Minv = lambda ctx, v, sm=sm: sm._stage_Minv(ctx, v)
        want.append(sm.solve(mesh.flat_coords(), cf))
    torch.cuda.synchronize()
    start = threading.Barrier(2)
    got, errors, enabled = [None, None], [], []

    def solve(k):
        try:
            sm = DeviceSmoother(mesh, info, device="cuda")
            start.wait()
            got[k] = sm.solve(mesh.flat_coords(), cfs[k])
            torch.cuda.current_stream().synchronize()
            enabled.append(gc.isenabled())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    captures = device_mod.PRECOND_CAPTURES
    threads = [threading.Thread(target=solve, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert device_mod.PRECOND_CAPTURES - captures == 2
    assert enabled == [True, True] and gc.isenabled()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_peak_memory_does_not_grow_over_jobs():
    """Four T106 jobs in a row, each with its own smoother and graph:
    the peak allocated memory of each is no larger than the one before,
    the memory held after each is what was held before it (the graph, its
    pool's output and the kept context go with the smoother), and the
    memory the allocator holds from the card after each does not grow
    (the next capture hands the pools of freed graphs back)."""
    _needs_card()
    torch.cuda.synchronize()
    held0 = torch.cuda.memory_allocated()
    peaks, held, reserved = [], [], []
    for _ in range(4):
        torch.cuda.reset_peak_memory_stats()
        _job(iterations=3)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        held.append(torch.cuda.memory_allocated())
        reserved.append(torch.cuda.memory_reserved())
    assert all(b <= a for a, b in zip(peaks, peaks[1:])), peaks
    assert held == [held0] * 4, (held0, held)
    assert reserved[3] <= reserved[2] <= reserved[1], reserved
