"""The job stream: the same seed gives the same jobs."""

import numpy as np

from meshbench import generator
from meshbench.reference.input import build_mesh
from meshbench.tests import tiny


def _traffic():
    from meshbench import manifest
    import json

    return json.loads((manifest.PACKAGE / "traffic" /
                       "design_loop.json").read_text())


def test_same_seed_same_jobs():
    cfg, tr = tiny.t106(), _traffic()
    seed = 2**31 + 12345
    a = [generator.job(tr, cfg, seed, k) for k in range(4)]
    b = [generator.job(tr, cfg, seed, k) for k in range(4)]
    for x, y in zip(a, b):
        assert x.restagger_deg == y.restagger_deg
        assert x.config == y.config
    other = generator.job(tr, cfg, seed + 1, 0)
    assert other.restagger_deg != a[0].restagger_deg
    assert len({j.restagger_deg for j in a}) == 4
    assert all(-1.0 <= j.restagger_deg <= 1.0 for j in a)
    assert all(j.iterations == 10 for j in a)
    assert all(j.smooth_mesh == {"solver": "device"} for j in a)


def test_restagger_is_a_rigid_rotation():
    cfg = tiny.t106()
    data = cfg["geometry"]["profile"]["data"]
    down0, up0 = np.array(data["down"]), np.array(data["up"])
    c0 = generator.profile_centroid(down0, up0)
    job = generator.restagger(cfg, 0.75)
    d = job["geometry"]["profile"]["data"]
    down, up = np.array(d["down"]), np.array(d["up"])
    # leading and trailing edges stay bit-for-bit shared
    assert np.array_equal(down[0], up[0]) and np.array_equal(down[-1], up[-1])
    # distances to the centroid are kept, the centroid stays
    np.testing.assert_allclose(np.linalg.norm(down - c0, axis=1),
                               np.linalg.norm(down0 - c0, axis=1), rtol=1e-13)
    np.testing.assert_allclose(generator.profile_centroid(down, up), c0,
                               atol=1e-13)
    ang = np.degrees(np.arctan2(*(down[5] - c0)[::-1])
                     - np.arctan2(*(down0[5] - c0)[::-1]))
    np.testing.assert_allclose(ang, 0.75, rtol=1e-9)
    assert cfg["geometry"]["profile"]["data"]["down"] == data["down"]
    assert build_mesh(job).num_points == 25118


def test_warmup_job_is_not_in_the_stream():
    w = generator.warmup_job(_traffic(), tiny.t106())
    assert w.index == -1 and w.iterations == 2 and w.restagger_deg == 0.0
    assert w.config["smoothing"]["iterations"] == 2
    assert w.smooth_mesh == {"solver": "device"}


def test_traffic_carries_the_smooth_mesh_call():
    """A traffic file alone sets the call: ``iterations``,
    ``wall_control_function`` and ``target_residual`` go into the job's
    configuration (the reference reads them there), the rest to
    ``smooth_mesh``."""
    cfg = tiny.t106()
    traffic = {"restagger_deg": {"uniform": [0.0, 0.5]},
               "smooth_mesh": {"solver": "device", "iterations": 30,
                               "wall_control_function": "laplace",
                               "target_residual": 1e-10}}
    job = generator.job(traffic, cfg, 7, 3)
    assert job.iterations == 30 and job.smooth_mesh == {"solver": "device"}
    assert job.config["smoothing"]["iterations"] == 30
    assert job.config["smoothing"]["wall_control_function"] == "laplace"
    assert job.config["smoothing"]["target_residual"] == 1e-10
    assert cfg["smoothing"]["iterations"] == 10
    assert traffic["smooth_mesh"]["iterations"] == 30
