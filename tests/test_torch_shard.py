"""Port of the block-sharded smoother (turbomesh_tpu_torch.parallel) vs
the JAX package's ShardedSmoother and the host oracle.

The plans (exchange schedules, per-rank row tables, chain tables, split
glue maps, multigrid masks and maps) must equal JAX's bit for bit at
D = 2, 3, 4, 8 on the meshes of tests/test_sharded_solver.py. The solves
run on spawned gloo worlds of at most four CPU processes (three worlds
here) and on an in-process world of 1, against the oracle (1e-9, O4H
1e-8, as the JAX tests), JAX's two-device ShardedSmoother (1e-9) and the
port's DeviceSmoother.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from turbomesh_tpu import boundary as jbnd
from turbomesh_tpu import input as jax_input
from turbomesh_tpu import mesh as jmesh
from turbomesh_tpu.clustering import Uniform as JUniform
from turbomesh_tpu.parallel import ShardedSmoother as JaxSharded
from turbomesh_tpu.smoothing.classify import classify as jax_classify

import turbomesh_tpu_torch.smoothing.multigrid as tmg
from turbomesh_tpu_torch import boundary as tbnd
from turbomesh_tpu_torch import input as torch_input
from turbomesh_tpu_torch import mesh as tmesh
from turbomesh_tpu_torch.clustering import Uniform
from turbomesh_tpu_torch.parallel import ShardedSmoother
from turbomesh_tpu_torch.parallel import dist as pdist
from turbomesh_tpu_torch.parallel import shard
from turbomesh_tpu_torch.smoothing import smooth_mesh
from turbomesh_tpu_torch.smoothing.classify import classify
from turbomesh_tpu_torch.smoothing.control_function import Laplace, White
from turbomesh_tpu_torch.smoothing.device import DeviceSmoother
from turbomesh_tpu_torch.smoothing.system import SparseSystem

from test_torch_frontend import ROOT, SMALL_O4H

torch.set_num_threads(1)

PORT = types.SimpleNamespace(mesh=tmesh, bnd=tbnd, unif=Uniform,
                             inp=torch_input)
JAX = types.SimpleNamespace(mesh=jmesh, bnd=jbnd, unif=JUniform,
                            inp=jax_input)
MESHES = ("two", "chain", "even", "o4h")


def _block(ns, n, m, x0=0.0, distort=0.0, seed=0):
    u = x0 + ns.unif()(n)
    v = ns.unif()(m)
    pts = np.stack(np.meshgrid(u, v, indexing="ij"), axis=-1)
    if distort:
        rng = np.random.default_rng(seed)
        pts[1:-1, 1:-1] += distort * rng.standard_normal(pts[1:-1, 1:-1].shape)
    return ns.mesh.Block2d(points=pts)


def _connect(ns, mesh, k, m):
    b = ns.bnd
    mesh.connections.append(b.Connection((b.Range(k - 1, b.Side.J_MAX, 0, m - 1),
                                          b.Range(k, b.Side.J_MIN, 0, m - 1))))
    mesh.blocks[k].points[0, :, :] = mesh.blocks[k - 1].points[-1, :, :]


def build(case, ns):
    """The meshes of tests/test_sharded_solver.py, in either package."""
    if case == "o4h":
        inp = ns.inp.load(SMALL_O4H, base_dir=str(ROOT))
        return inp.template.run(inp.geometry)
    mesh = ns.mesh.Mesh()
    if case == "two":
        mesh.add_block("left", _block(ns, 7, 5, distort=0.03))
        mesh.add_block("right", _block(ns, 7, 5, x0=1.0, distort=0.03, seed=5))
        _connect(ns, mesh, 1, 5)
    elif case == "chain":
        for k in range(16):
            mesh.add_block(f"b{k}", _block(ns, 7, 5, x0=float(k),
                                           distort=0.03, seed=k))
        for k in range(1, 16):
            _connect(ns, mesh, k, 5)
    else:  # "even": even lattice lengths, boundary-aligned maps
        n, m = 44, 36
        for k in range(4):
            mesh.add_block(f"b{k}", _block(ns, n, m, x0=float(k)))
        rng = np.random.default_rng(3)
        for b in mesh.blocks:
            b.points[1:-1, 1:-1] += (0.3 / n) * rng.standard_normal(
                b.points[1:-1, 1:-1].shape)
        for k in range(1, 4):
            _connect(ns, mesh, k, m)
    return mesh


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _eq_exchange(ex_p, ex_j, what):
    assert ex_p.offsets == ex_j.offsets, what
    assert ex_p.lengths == ex_j.lengths, what
    assert ex_p.base == ex_j.base, what
    assert ex_p.total == ex_j.total, what
    for o in ex_j.offsets:
        _eq(ex_p.send_idx[o], ex_j.send_idx[o], f"{what} send_idx[{o}]")


# ---------------------------------------------------------------------------
# plans, no processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [2, 3, 4, 8])
@pytest.mark.parametrize("case", MESHES)
def test_plans_bit_identical_to_jax(case, D):
    mj, mt = build(case, JAX), build(case, PORT)
    js = JaxSharded(mj, jax_classify(mj), n_devices=D)
    lay = shard.ShardLayout(mt, classify(mt), D)
    assert (lay.B, lay.N, lay.M, lay.D, lay.Bl) == (js.B, js.N, js.M, js.D,
                                                    js.Bl)
    _eq(lay.interior_mask, js.interior_mask, "interior_mask")
    _eq(lay.free_mask, js.free_mask, "free_mask")
    _eq(lay.scatter_idx, js.scatter_idx, "scatter_idx")
    _eq_exchange(lay.ex_S, js.ex_S, "ex_S")
    _eq_exchange(lay.ex_F, js.ex_F, "ex_F")
    for f in shard.ShardPlanArrays.__dataclass_fields__:
        _eq(getattr(lay.shard_plan, f), getattr(js.shard_plan, f), f)
    _eq(lay.cseg, js.cseg, "cseg")
    _eq(lay.cseg_valid, js.cseg_valid, "cseg_valid")
    assert len(lay.glue_ex) == len(js.glue_ex)
    for lvl in range(len(js.glue_ex)):
        _eq_exchange(lay.glue_ex[lvl], js.glue_ex[lvl], f"glue_ex {lvl}")
        for mine, theirs, name in ((lay.glue_local, js.glue_local, "local"),
                                   (lay.glue_cross, js.glue_cross, "cross")):
            (arrs, valid), (jarrs, jvalid) = mine[lvl], theirs[lvl]
            _eq(valid, jvalid, f"glue_{name} {lvl} valid")
            for k, (a, b) in enumerate(zip(arrs, jarrs, strict=True)):
                _eq(a, b, f"glue_{name} {lvl} [{k}]")
        _eq(lay.mg_masks[lvl], js.mg_masks[lvl], f"mg_masks {lvl}")
        mp, jmp = lay.mg_maps[lvl], js.mg_maps[lvl]
        assert (mp is None) == (jmp is None), lvl
        if mp is not None:
            assert mp.keys() == jmp.keys()
            for k in jmp:
                _eq(mp[k], jmp[k], f"mg_maps {lvl} {k}")
    if case == "even":
        assert any(m is not None for m in lay.mg_maps)


def test_chain_exchange_stays_neighbour_bound():
    """16 chained blocks on 8 ranks: only self (0) and next-rank (1, 7)
    offsets carry traffic, and a rank's exchanged volume is O(one
    connection's perimeter), not O(blocks x perimeter)."""
    m = 5
    lay = shard.ShardLayout(build("chain", PORT), classify(build("chain", PORT)),
                            8)
    assert set(lay.ex_F.offsets) <= {0, 1, 7}, lay.ex_F.offsets
    assert lay.ex_F.total <= 3 * 3 * m + 8


# ---------------------------------------------------------------------------
# multigrid hooks and the glue's duplicate destinations
# ---------------------------------------------------------------------------


def test_vcycle_local_glue_bit_identical():
    """Glue, masks and maps that a caller supplies (``glued_level_statics``)
    and that do what the levels' own maps do give the same hierarchy and
    V-cycle, bit for bit (even lattice: mapped levels; no sliding or
    junction rows, so the correction glue is the plain map)."""
    mesh = build("even", PORT)
    dev = DeviceSmoother(mesh, classify(mesh), device="cpu")
    p = dev.plan
    rng = np.random.default_rng(2)
    X, C = dev._upload(mesh.flat_coords(),
                       0.1 * rng.standard_normal((mesh.num_points, 2)))
    base, _ = dev._stage_base(X, C)
    base32 = base.to(torch.float32).reshape(p.B, p.N, p.M, 2)
    cf32 = C.to(torch.float32)
    gd = dev._glue_dev
    for gl in gd:
        assert torch.equal(gl["gcsrc"], gl["gsrc"])
        assert torch.equal(gl["gcdst"], gl["gdst"])
        assert gl["gjdst"].shape[0] == 0

    class LocalGlue(tmg.MapGlue):
        """The glue interface written out over a level's plain map (its
        zebra planes glued by MapGlue's composition of ``correction``)."""

        def __init__(self, gl):
            self.gl = gl

        def pad(self, v, coord_field=False):
            vg = torch.nn.functional.pad(v, (0, 0, 1, 1, 1, 1))
            vf = vg.reshape(-1, v.shape[-1])
            vals = vf[self.gl["gsrc"]]
            if coord_field:
                vals = vals + self.gl["goff"].to(v.dtype)
            vf.index_copy_(0, self.gl["gdst"], vals)
            return vg

        def correction(self, v):
            return self.pad(v)

    maps = [{k: gl[k] for k in tmg.MAP_KEYS} if "li_map" in gl else None
            for gl in gd]
    assert any(mp is not None for mp in maps)
    ref = tmg.build_glued_levels(base32, cf32, gd)
    got = list(tmg.iter_glued_levels(base32, cf32, tmg.glued_level_statics(
        [LocalGlue(gl) for gl in gd], [gl["smooth_mask"] for gl in gd],
        maps, torch.float32)))
    for a, b in zip(ref, got):
        assert torch.equal(a["baseg"], b["baseg"])
        for k in ("bx", "by", "cfp", "cfq", "msk"):
            assert torch.equal(a["zebra"][k], b["zebra"][k])
    r = torch.as_tensor(rng.standard_normal((p.B, p.N, p.M, 2)),
                        dtype=torch.float32)
    z0 = tmg.v_cycle_glued(ref, r)
    z1 = tmg.v_cycle_glued(got, r)
    assert torch.equal(z0, z1)
    assert float(z0.abs().max()) > 0


@pytest.fixture
def world1():
    """An in-process gloo world of 1, torn down after the test."""
    pdist.ensure_group("cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_duplicate_glue_destinations_last_entry_wins(world1):
    """The small O4H mesh's level-0 glue map lists 4 destinations twice.
    JAX's sharded glue writes ``.at[dst].add(val - vf[dst])`` per entry,
    so such a destination ends at v1 + v2 - cur, neither entry's value;
    the port keeps the last entry, as the single-device glue does."""
    mt, mj = build("o4h", PORT), build("o4h", JAX)
    sm = ShardedSmoother(mt, classify(mt), device="cpu")
    js = JaxSharded(mj, jax_classify(mj), n_devices=1)
    lay = sm.layout
    gl = lay.glue_levels[0]
    _, counts = np.unique(gl.dst, return_counts=True)
    assert (counts > 1).sum() == 4
    rng = np.random.default_rng(5)
    v = rng.standard_normal((lay.Bl, gl.N, gl.M, 2))

    # JAX's split-map glue at D = 1 (every entry local), as its shard body
    (lsrc, ldst, loff), lval = js.glue_local[0]
    vf = jnp.pad(jnp.asarray(v), ((0, 0), (1, 1), (1, 1), (0, 0))).reshape(-1, 2)
    val = vf[lsrc[0]] + loff[0]
    jax_glued = np.asarray(vf.at[ldst[0]].add(
        jnp.where(lval[0][:, None], val - vf[ldst[0]], 0.0)))

    port = sm._rank_glue(0, torch.float64).pad(
        torch.as_tensor(v), True).reshape(-1, 2).numpy()
    prep = tmg.prep_glue_arrays([gl], "cpu")[0]
    single = tmg.MapGlue.from_prep(prep, torch.float64).pad(
        torch.as_tensor(v), True).reshape(-1, 2).numpy()
    np.testing.assert_array_equal(port, single)

    cur = np.pad(v, ((0, 0), (1, 1), (1, 1), (0, 0))).reshape(-1, 2)
    dup = [d for d in np.unique(gl.dst) if (gl.dst == d).sum() > 1]
    differ = 0
    for d in dup:
        (e1, e2) = np.nonzero(gl.dst == d)[0]
        v1 = cur[gl.src[e1]] + gl.off[e1]
        v2 = cur[gl.src[e2]] + gl.off[e2]
        np.testing.assert_allclose(jax_glued[d], v1 + v2 - cur[d],
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(port[d], v2)
        differ += not np.allclose(jax_glued[d], v2)
    assert differ == len(dup)
    # every other destination: both glues write the one entry's value
    mask = np.ones(len(cur), bool)
    mask[dup] = False
    np.testing.assert_allclose(port[mask], jax_glued[mask], rtol=1e-14,
                               atol=1e-14)


# ---------------------------------------------------------------------------
# solves: a world of 1 in-process, spawned gloo worlds
# ---------------------------------------------------------------------------


def test_world_of_one_matches_device_solve(world1):
    mesh = build("o4h", PORT)
    info = classify(mesh)
    cf = White(ds_target=1e-4).init(mesh)
    sm = ShardedSmoother(mesh, info, device="cpu", rtol=1e-12, atol=1e-14)
    dev = DeviceSmoother(mesh, info, device="cpu", rtol=1e-12, atol=1e-14)
    cs = sm.solve(mesh.flat_coords(), cf)
    cd = dev.solve(mesh.flat_coords(), cf)
    assert sm.last_linear_converged and sm.last_restarts >= 1
    assert np.abs(cs - cd).max() < 1e-9, np.abs(cs - cd).max()


def test_smooth_mesh_sharded_matches_device(world1, monkeypatch):
    """The "sharded" backend of smooth_mesh on a world of 1 reaches the
    device backend's fixed point. Each solves a Picard step only to
    smooth_mesh's rtol 1e-4, so the comparison is at the fixed point (the
    two-block mesh is there in two iterations), not step by step."""
    monkeypatch.delenv("TURBOMESH_SHARDED", raising=False)
    out = {}
    for solver in ("sharded", "device"):
        mesh = build("two", PORT)
        hist = []
        smooth_mesh(mesh, 4, solver=solver, wall_control_function="laplace",
                    residual_history=hist, device="cpu")
        out[solver] = (mesh.flat_coords(), hist)
    (cs, hs), (cd, hd) = out["sharded"], out["device"]
    assert len(hs) == len(hd) == 4 and hs[-1] < 1e-40 and hd[-1] < 1e-40
    assert np.abs(cs - cd).max() < 1e-12, np.abs(cs - cd).max()
    np.testing.assert_allclose(hs[0], hd[0], rtol=1e-3)


def test_auto_shard_rule(world1, monkeypatch):
    from turbomesh_tpu_torch.smoothing.smooth import _auto_shard

    monkeypatch.delenv("TURBOMESH_SHARDED", raising=False)
    assert _auto_shard("device") == "device"        # a world of 1
    assert _auto_shard("direct") == "direct"
    monkeypatch.setenv("TURBOMESH_SHARDED", "1")
    assert _auto_shard("device") == "sharded"
    monkeypatch.setattr(pdist, "world_size", lambda: 4)
    monkeypatch.setenv("TURBOMESH_SHARDED", "auto")
    assert _auto_shard("device") == "sharded"
    monkeypatch.setenv("TURBOMESH_SHARDED", "0")
    assert _auto_shard("device") == "device"


def _oracle(mesh, cf, steps):
    oracle = SparseSystem(mesh, classify(mesh))
    co, out = mesh.flat_coords(), []
    for _ in range(steps):
        co = oracle.solve(co, cf)
        out.append(co)
    return out


def _spawn(D, tasks):
    return pdist.spawn(functools.partial(shard.run_tasks, device="cpu"), D,
                       "gloo", "cpu", args=(tasks,))


def _same_on_every_rank(recs, key):
    for r in recs[1:]:
        np.testing.assert_array_equal(r[key], recs[0][key])


def test_two_ranks_match_oracle_jax_and_device_run():
    """D = 2: two solves of the two-block mesh against the oracle and
    JAX's two-device ShardedSmoother; the sharded run with White (3
    iterations) on O4H against the port's DeviceSmoother.run."""
    mt, mj, o4h = build("two", PORT), build("two", JAX), build("o4h", PORT)
    cf = Laplace().init(mt)
    algo = White(ds_target=1e-4, theta_target=1.570796327)
    recs = _spawn(2, [dict(mesh=mt, cf=cf, solves=2),
                      dict(mesh=o4h, cf=algo.init(o4h), iterations=3,
                           algorithm=algo,
                           smoother=dict(rtol=1e-10, atol=1e-12))])
    (two0, run0), (two1, run1) = recs
    for a, b in zip(two0["solves"], two1["solves"]):
        np.testing.assert_array_equal(a, b)
    for got, want in zip(two0["solves"], _oracle(mt, cf, 2)):
        assert np.abs(got - want).max() < 1e-9
    js = JaxSharded(mj, jax_classify(mj), n_devices=2)
    cj = mj.flat_coords()
    for got in two0["solves"]:
        cj = js.solve(cj, cf)
        assert np.abs(got - cj).max() < 1e-9, np.abs(got - cj).max()
    assert two0["exchanges"] > 0 and two0["all_reduces"] > 0

    # two different solvers each at rtol 1e-10, amplified by the White
    # feedback (the bound of tests/test_sharded_solver.py)
    for key in ("coords", "cf"):
        _same_on_every_rank([run0, run1], key)
    assert run0["n_done"] == 3 and len(run0["restart_history"]) == 3
    dev = DeviceSmoother(o4h, classify(o4h), device="cpu", rtol=1e-10,
                         atol=1e-12)
    hd = []
    cd, cfd, _, _ = dev.run(o4h.flat_coords(), algo.init(o4h), 3,
                            algorithm=algo, residual_history=hd)
    assert np.abs(cd - run0["coords"]).max() < 1e-6
    assert np.abs(cfd - run0["cf"]).max() < 1e-6
    np.testing.assert_allclose(run0["residual_history"], hd, rtol=1e-5)


def test_three_ranks_with_dummy_blocks():
    """D = 3: the two-block mesh gets a dummy block (rank 2 holds no row
    of any kind) and O4H's 8 blocks a ninth; every rank still posts the
    same exchanges and all_reduces."""
    tasks = []
    for case in ("two", "o4h"):
        mesh = build(case, PORT)
        tasks.append(dict(mesh=mesh, cf=Laplace().init(mesh), solves=1))
    recs = _spawn(3, tasks)
    for k, (task, tol) in enumerate(zip(tasks, (1e-9, 1e-8))):
        ranks = [r[k] for r in recs]
        want = _oracle(task["mesh"], task["cf"], 1)[0]
        for rec in ranks:
            assert np.abs(rec["solves"][0] - want).max() < tol
        assert len({(r["exchanges"], r["all_reduces"]) for r in ranks}) == 1


def test_four_ranks_chain_and_even_lattice():
    """D = 4: the 16-block chain (4 blocks a rank) and the even-lattice
    mesh, whose mapped coarse levels ride as per-rank slices."""
    chain, even = build("chain", PORT), build("even", PORT)
    tasks = [dict(mesh=chain, cf=Laplace().init(chain), solves=1),
             dict(mesh=even, cf=Laplace().init(even), solves=1,
                  smoother=dict(rtol=1e-8, atol=0.0))]
    recs = _spawn(4, tasks)
    for k, task in enumerate(tasks):
        want = _oracle(task["mesh"], task["cf"], 1)[0]
        for rank in recs:
            err = np.abs(rank[k]["solves"][0] - want).max()
            assert err < 1e-9, (k, err)
