"""K-A's byte count on logical points, against a hand count on T106."""

import pytest

from meshbench import roofline
from meshbench.reference.input import build_mesh
from meshbench.tests import tiny

T106_BLOCKS = [(221, 41), (121, 41), (11, 41), (11, 51), (121, 41),
               (161, 11), (21, 91), (11, 131)]


def test_t106_blocks():
    assert [b.size for b in build_mesh(tiny.t106()).blocks] == T106_BLOCKS


def test_level_points_by_hand():
    # each lattice of n points keeps (n - 1) // 2 + 1
    level1 = (111 * 21 + 61 * 21 + 6 * 21 + 6 * 26 + 61 * 21 + 81 * 6
              + 11 * 46 + 6 * 66)
    assert level1 == 6563
    pts = roofline.level_points(T106_BLOCKS)
    assert pts[:2] == [25118, level1]
    # padded dims 221 x 131 -> 111 x 66 -> 56 x 33 -> 28 x 17 -> 14 x 9:
    # the block (11, 41) reaches 3 x 6 at level 3 (min <= 5), but others
    # do not; the stack stops once its shorter padded dim is <= 5 or
    # every block's shorter side is
    assert len(pts) == 5


def test_vcycle_bytes_by_hand():
    hs, nbytes = roofline.vcycle_bytes(T106_BLOCKS)
    assert hs == 48                     # 8 (L - 1) + 16 at L = 5
    pts = roofline.level_points(T106_BLOCKS)
    assert nbytes == 60 * (8 * sum(pts[:-1]) + 16 * pts[-1]) == 16_400_160


def test_against_the_port():
    """The frozen rules give the port's own level count and launches."""
    from turbomesh_tpu_torch.smoothing.classify import classify
    from turbomesh_tpu_torch.smoothing.device import build_plan
    from turbomesh_tpu_torch.smoothing.glue import build_glue
    from turbomesh_tpu_torch.smoothing.multigrid import vcycle_half_sweeps

    for cfg in (tiny.t106(), tiny.small()):
        mesh = build_mesh(cfg)
        info = classify(mesh)
        plan = build_plan(mesh, info)
        glue = build_glue(mesh, info, plan.N, plan.M,
                          transposed=plan.transposed, keep_boundaries=True)
        sizes = [b.size for b in mesh.blocks]
        assert len(roofline.level_points(sizes)) == len(glue)
        assert roofline.vcycle_bytes(sizes)[0] == vcycle_half_sweeps(len(glue))
        # level 0's smooth lattice holds the logical points
        assert roofline.level_points(sizes)[0] == mesh.num_points


def test_peaks():
    assert roofline.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == 3.35e12
    assert roofline.peak("cpu", "hbm_bytes_per_s") is None


def test_roofline_reader():
    from meshbench import manifest
    from meshbench.tests.test_counting import _job, _run
    from meshbench.trace import TraceSummary

    j = _job(0, 0.0, [1.0 + k for k in range(10)])
    j.block_sizes = T106_BLOCKS
    run = _run([j])
    # 96 launches = 2 V-cycles, K-A busy 1 ms in all
    run.trace = TraceSummary(0.5, 0.05, {
        "void zebra_partitioned_kernel<0>(Planes, float*)": 0.0006,
        "void zebra_thomas_kernel<1>(Planes, float*)": 0.0004,
        "elementwise": 0.049}, {}, {"zebra": 96}, 1)
    pct = manifest.reader("zebra_roofline_pct")(run)
    assert pct == pytest.approx(100 * 2 * 16_400_160 / 3.35e12 / 0.001)
    assert manifest.reader("device_idle_pct")(run) == pytest.approx(90.0)
