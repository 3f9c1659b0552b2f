"""Linearized solves of the port's smoothers under the preconditioner's
options (``mg_opts``).

The base (non-Schur) composition stays within 1e-10 of the JAX package's
solve with the same option and 1e-8 of the host oracle on the mesh with
every eliminated row kind (tests/test_schur.py:66), and within 1e-8 of
the oracle on a gloo world of 2 (tests/test_schur.py:70-80); four
interface passes stay within 1e-9 of two (tests/test_device_solver.py:
363). With ``mg_opts=None`` the solve is the fixed composition bit for
bit, with the zebra half-sweeps the schedule predicts; the split "j" /
"i" schedule solves through the kernel's arithmetic to the oracle with
half the half-sweeps on every level above the coarsest.
"""

import functools

import numpy as np
import torch

from turbomesh_tpu.smoothing.device import DeviceSmoother as JaxSmoother

import turbomesh_tpu_torch.smoothing.multigrid as tmg
from turbomesh_tpu_torch.ops import zebra
from turbomesh_tpu_torch.parallel import dist as pdist
from turbomesh_tpu_torch.parallel import shard
from turbomesh_tpu_torch.smoothing.control_function import Laplace, White
from turbomesh_tpu_torch.smoothing.device import DeviceSmoother
from turbomesh_tpu_torch.smoothing.system import SparseSystem

from test_torch_mg_opts import o4h, strip  # noqa: F401
from test_torch_zebra import partitioned_half_sweep, thomas_half_sweep

torch.set_num_threads(1)


def test_base_composition_solve_matches_jax_and_oracle(strip):
    """``schur`` False: a linearized solve on the strip with every
    eliminated row kind, 1e-10 from JAX's solve with the same option and
    1e-8 from the oracle (tests/test_schur.py:66)."""
    mj, ij, mt, it, cf, ref = strip
    ts = DeviceSmoother(mt, it, device="cpu", mg_opts={"schur": False})
    js = JaxSmoother(mj, ij, mg_opts={"schur": False})
    assert not ts._schur and not js._schur
    got = ts.solve(mt.flat_coords(), cf)
    want = js.solve(mj.flat_coords(), cf)
    assert ts.last_linear_converged
    assert np.abs(got - want).max() < 1e-10, np.abs(got - want).max()
    assert np.abs(got - ref).max() < 1e-8, np.abs(got - ref).max()


def test_four_interface_passes_match_two(o4h):
    """tests/test_device_solver.py::test_interface_passes_three_plus_parity
    on the port: four passes within 1e-9 of the default two."""
    _, _, mt, it = o4h
    cf = Laplace().init(mt)
    base = DeviceSmoother(mt, it, device="cpu")
    ip4 = DeviceSmoother(mt, it, device="cpu", mg_opts={"interface_passes": 4})
    cb = base.solve(mt.flat_coords(), cf)
    c4 = ip4.solve(mt.flat_coords(), cf)
    assert base.last_linear_converged and ip4.last_linear_converged
    assert np.abs(cb - c4).max() < 1e-9, np.abs(cb - c4).max()


def test_sharded_base_composition_matches_oracle(strip):
    """``ShardedSmoother(mg_opts={"schur": False})`` on a gloo world of 2:
    1e-8 from the oracle (tests/test_schur.py:70-80), the same on both
    ranks, with the default two interface passes and with one."""
    _, _, mt, _, cf, ref = strip
    tasks = [dict(mesh=mt, cf=cf, solves=1, smoother=dict(mg_opts=o))
             for o in ({"schur": False},
                       {"schur": False, "interface_passes": 1})]
    recs = pdist.spawn(functools.partial(shard.run_tasks, device="cpu"), 2,
                       "gloo", "cpu", args=(tasks,))
    for k in range(len(tasks)):
        for rank in recs:
            err = np.abs(rank[k]["solves"][0] - ref).max()
            assert err < 1e-8, (k, rank[k]["rank"], err)
        np.testing.assert_array_equal(recs[0][k]["solves"][0],
                                      recs[1][k]["solves"][0])


def _counted(monkeypatch, sweep):
    """Count the zebra half-sweeps of ``sweep`` (the kernel's arithmetic
    on the CPU) in ZEBRA_LAUNCHES."""
    def counted(*args, **kwargs):
        zebra.ZEBRA_LAUNCHES += 1
        return sweep(*args, **kwargs)

    monkeypatch.setattr(tmg, "zebra_half_sweep", counted)


def _fixed_Minv(sm, ctx, vflat):
    """The undeflated Schur composition with two interface passes and the
    V-cycle's fixed schedule, written out as the port had it before the
    options."""
    e = sm._stage_interface(ctx, vflat)
    ze = sm._stage_vcycle_interior(ctx, vflat - sm._stage_A32(ctx, e)) + e
    rr = vflat - sm._stage_A32(ctx, ze)
    z = sm._stage_interface(ctx, rr)
    r_c, dz = rr, z
    r_c = r_c - sm._stage_A32(ctx, dz)
    dz = sm._stage_interface(ctx, r_c)
    return ze + (z + dz)


def _applications(sm):
    """Wrap ``sm._stage_Minv`` to count its applications in ``sm.calls``."""
    sm.calls = 0
    inner = sm._stage_Minv

    def counted(ctx, v):
        sm.calls += 1
        return inner(ctx, v)

    sm._stage_Minv = counted


def test_defaults_bitwise_unchanged(o4h, monkeypatch):
    """``mg_opts=None``, the explicit defaults and the fixed composition
    give the same solve bit for bit, with the same restarts and zebra
    launches: the applications times 8 (L - 1) + 16 on L levels."""
    _, _, mt, it = o4h
    _counted(monkeypatch, thomas_half_sweep)
    cf = White(ds_target=1e-4).init(mt)
    out = []
    for opts, fixed in ((None, False), (dict(DeviceSmoother.MG_DEFAULTS),
                                        False), (None, True)):
        sm = DeviceSmoother(mt, it, device="cpu", mg_opts=opts)
        if fixed:
            monkeypatch.setattr(sm, "_stage_Minv",
                                lambda ctx, v, sm=sm: _fixed_Minv(sm, ctx, v))
        _applications(sm)
        zebra.ZEBRA_LAUNCHES = 0
        coords = sm.solve(mt.flat_coords(), cf)
        L = len(sm._glue_dev)
        assert zebra.ZEBRA_LAUNCHES == sm.calls * (8 * (L - 1) + 16)
        assert zebra.ZEBRA_LAUNCHES == sm.calls * tmg.vcycle_half_sweeps(L)
        out.append((coords, zebra.ZEBRA_LAUNCHES, sm.last_restarts))
    (c0, n0, r0), *rest = out
    assert n0 > 0
    for c, n, r in rest:
        np.testing.assert_array_equal(c, c0)
        assert (n, r) == (n0, r0)


def test_split_schedule_with_kernel_arithmetic(o4h, monkeypatch):
    """The split "j" / "i" schedule through the kernel's arithmetic (the
    partitioned line solve, as tests/test_torch_solver.py:111), White
    control function: within 1e-10 of the oracle, with the zebra
    half-sweeps the schedule predicts, half of the default's on every
    level above the coarsest."""
    _, _, mt, it = o4h
    _counted(monkeypatch, partitioned_half_sweep)
    cf = White(ds_target=1e-4).init(mt)
    ts = DeviceSmoother(mt, it, device="cpu",
                        mg_opts={"pre_dirs": "j", "post_dirs": "i"})
    _applications(ts)
    zebra.ZEBRA_LAUNCHES = 0
    got = ts.solve(mt.flat_coords(), cf)
    L = len(ts._glue_dev)
    per = tmg.vcycle_half_sweeps(L, pre_dirs="j", post_dirs="i")
    assert L >= 2 and per == 4 * (L - 1) + 16
    assert zebra.ZEBRA_LAUNCHES == ts.calls * per > 0
    assert ts.last_linear_converged
    ref = SparseSystem(mt, it).solve(mt.flat_coords(), cf)
    assert np.abs(got - ref).max() < 1e-10, np.abs(got - ref).max()
