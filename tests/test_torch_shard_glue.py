"""The sharded V-cycle's correction glue and the sharded deflation.

``ShardedSmoother``'s per-level glue (``shard.ShardGlue``) glues
corrections with the sliding and junction embeddings of the single-device
correction glue (``multigrid.MapGlue.correction``): at a world of 1 the
sharded V-cycle equals the single-device V-cycle on the logical frame bit
for bit. The
sharded coarse-space deflation ("y") on a gloo world of 2 stays within
1e-9 of the host oracle (tests/test_sharded_solver.py::
test_sharded_deflation_optin_parity); the junction mode raises there.
"""

import functools

import numpy as np
import pytest
import torch

import turbomesh_tpu_torch.smoothing.multigrid as tmg
from turbomesh_tpu_torch import input as torch_input
from turbomesh_tpu_torch.parallel import ShardedSmoother
from turbomesh_tpu_torch.parallel import dist as pdist
from turbomesh_tpu_torch.parallel import shard
from turbomesh_tpu_torch.smoothing.classify import classify
from turbomesh_tpu_torch.smoothing.control_function import Laplace, White
from turbomesh_tpu_torch.smoothing.glue import build_glue

from chip_smoke import scaled_t106_config
from test_torch_frontend import ROOT, SMALL_O4H
from test_torch_shard import PORT, _block, _oracle, world1  # noqa: F401

torch.set_num_threads(1)


def _cut_cascade():
    """The scaled T106 cascade at scale 1 with every cell count cut to
    0.3 (2,501 points): sliding and junction rows at every level."""
    cfg = scaled_t106_config(1)
    cells = cfg["template"]["O4H"]["num_cells"]
    for k in cells:
        cells[k] = max(2, int(cells[k] * 0.3))
    return cfg


def _mesh(case):
    inp = torch_input.load(SMALL_O4H if case == "o4h" else _cut_cascade(),
                           base_dir=str(ROOT))
    return inp.template.run(inp.geometry)


@pytest.mark.parametrize("case", ["o4h", "cascade"])
def test_world_of_one_vcycle_bit_identical(world1, case):
    """The sharded hierarchy and V-cycle at a world of 1 against the
    single-device ones built on the logical frame (``build_plan(...,
    transpose=False)``, the sharded layout's), on the same f32 base and
    cf: bit for bit. The plain glue alone (``pad`` in place of
    ``correction``) gives a different V-cycle on these meshes, which have
    sliding and junction rows at every level."""
    mesh = _mesh(case)
    info = classify(mesh)
    sm = ShardedSmoother(mesh, info, device="cpu")
    X, C = sm._upload(mesh.flat_coords(), White(ds_target=1e-4).init(mesh))
    base, _ = sm._stage_base(X, C)
    B, N, M = sm._shape
    base32 = base.to(torch.float32).reshape(B, N, M, 2)
    cf32 = C.to(torch.float32)
    glue = build_glue(mesh, info, N, M, keep_boundaries=True)
    assert all(len(gl.jdst) and len(gl.cdst) for gl in glue)
    gd = tmg.prep_glue_arrays(glue, "cpu")
    ref = tmg.build_glued_levels(base32, cf32, gd)
    got = list(tmg.iter_glued_levels(base32, cf32, sm._mg_static))
    assert all(isinstance(b["glue"], shard.ShardGlue) for b in got)
    r = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (B, N, M, 2)), dtype=torch.float32)
    z_ref = tmg.v_cycle_glued(ref, r)
    z_got = tmg.v_cycle_glued(got, r)
    assert float(z_ref.abs().max()) > 0
    assert torch.equal(z_got, z_ref)
    for lvl, (a, b) in enumerate(zip(ref, got)):
        v = torch.as_tensor(np.random.default_rng(lvl).standard_normal(
            tuple(a["interior"].shape) + (2,)), dtype=torch.float32)
        assert torch.equal(b["glue"].correction(v), a["glue"].correction(v))

    class Plain(tmg.MapGlue):
        def __init__(self, glue):
            self.pad = self.correction = glue.pad

    z_plain = tmg.v_cycle_glued([dict(b, glue=Plain(b["glue"]))
                                 for b in got], r)
    assert not torch.equal(z_plain, z_ref)


def test_junction_deflation_raises_on_the_sharded_path(world1, monkeypatch):
    mesh = _mesh("o4h")
    info = classify(mesh)
    with pytest.raises(ValueError, match="single-device"):
        ShardedSmoother(mesh, info, device="cpu", deflation="j")
    monkeypatch.setenv("TURBOMESH_DEFLATION", "j")
    with pytest.raises(ValueError, match="single-device"):
        ShardedSmoother(mesh, info, device="cpu")
    monkeypatch.setenv("TURBOMESH_DEFLATION", "y")
    assert ShardedSmoother(mesh, info, device="cpu")._defl_K == 8 * 4


def _two_blocks():
    """tests/test_sharded_solver.py::test_sharded_deflation_optin_parity's
    mesh: two distorted 9 x 7 blocks joined along one face."""
    b = PORT.bnd
    mesh = PORT.mesh.Mesh()
    mesh.add_block("left", _block(PORT, 9, 7, distort=0.03))
    mesh.add_block("right", _block(PORT, 9, 7, x0=1.0, distort=0.03, seed=5))
    mesh.connections.append(b.Connection((b.Range(0, b.Side.J_MAX, 0, 6),
                                          b.Range(1, b.Side.J_MIN, 0, 6))))
    mesh.blocks[1].points[0, :, :] = mesh.blocks[0].points[-1, :, :]
    return mesh


def test_two_ranks_deflation_matches_oracle():
    """D = 2, deflation "y": two solves of the two-block mesh within 1e-9
    of the oracle, and one of the small O4H mesh, whose junction rows take
    their correction-glue members from the other rank, within 1e-8 (the
    O4H bar of tests/test_torch_shard.py)."""
    two, o4h = _two_blocks(), _mesh("o4h")
    tasks = [dict(mesh=m, cf=Laplace().init(m), solves=s,
                  smoother=dict(deflation="y"))
             for m, s in ((two, 2), (o4h, 1))]
    recs = pdist.spawn(functools.partial(shard.run_tasks, device="cpu"), 2,
                       "gloo", "cpu", args=(tasks,))
    for k, (task, tol) in enumerate(zip(tasks, (1e-9, 1e-8))):
        want = _oracle(task["mesh"], task["cf"], task["solves"])
        for rank in recs:
            rec = rank[k]
            assert rec["defl_K"] == len(task["mesh"].blocks) * 4
            assert rec["converged"]
            for got, ref in zip(rec["solves"], want):
                err = np.abs(got - ref).max()
                assert err < tol, (k, rec["rank"], err)
        np.testing.assert_array_equal(recs[0][k]["solves"][-1],
                                      recs[1][k]["solves"][-1])
