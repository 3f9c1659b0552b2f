"""A whole run but for the look for a card, with the timed path broken
underneath: ``correct`` comes out false for each fault the cells can have
(a Picard step that returns its state unchanged, half of the blocks left
out, an answer altered where it is produced), true without one, on the
CPU at the small mesh under Laplace control (the port's plain zebra);
and false with the control in the program's place, at the cell's own
size."""

import numpy as np
import pytest

from meshbench import manifest
from meshbench import run as R
from meshbench.jobs import unpad
from meshbench.tests import tiny


def _plant(monkeypatch, fault):
    from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

    orig = DeviceSmoother._solve_impl
    calls = []

    def broken(self, Xpad, cf_pad, rtol):
        X1, stats = orig(self, Xpad, cf_pad, rtol)
        calls.append(1)
        if fault == "unchanged_step" and len(calls) % 2 == 0:
            return Xpad, stats
        if fault == "half_batch":
            X1 = X1.clone()
            X1[: X1.shape[0] // 2] = Xpad[: X1.shape[0] // 2]
        if fault == "answer_altered":
            X1 = X1.clone()
            X1[0, 2, 2, 0] += 1e-4      # an interior point of block 0
        return X1, stats

    monkeypatch.setattr(DeviceSmoother, "_solve_impl", broken)


def plant_control(monkeypatch, config, last_only=False, dtype=np.float32):
    """The control in the program's place: each linearized solve (with
    ``last_only`` the last Picard step's alone, the program's solves before
    it) is the reference's, assembled and solved (sparse LU) in ``dtype``
    at the step's state, with the control function the reference works
    out along the run (White's init at a smoother's first step, its
    feedback after); the padded stack and the stats the Picard loop reads
    have the layout the program's solve hands back."""
    import torch

    from meshbench.reference.classify import classify
    from meshbench.reference.control_function import from_config
    from meshbench.reference.input import build_mesh
    from meshbench.reference.winslow import WinslowSystem, solve
    from turbomesh_tpu_torch.smoothing.device import DeviceSmoother

    orig = DeviceSmoother._solve_impl
    last = int(config["smoothing"]["iterations"]) - 1
    mesh = build_mesh(config)
    winslow = WinslowSystem(mesh, classify(mesh))
    algorithm = from_config(config["smoothing"].get("wall_control_function",
                                                    "laplace"))

    def control(self, Xpad, cf_pad, rtol):
        X = Xpad.detach().cpu().numpy()
        sizes = [b.size for b in self._mesh.blocks]
        x = unpad(X, sizes)
        mesh.set_flat_coords(x)
        if getattr(self, "control_cf", None) is None:
            self.control_cf, self.control_step = algorithm.init(mesh), 0
        else:
            algorithm.update(self.control_cf, mesh)
            self.control_step += 1
        if last_only and self.control_step != last:
            return orig(self, Xpad, cf_pad, rtol)
        x1 = solve(winslow.systems(x, self.control_cf, dtype))
        x1 = x1.astype(np.float64)
        X1, start = X.copy(), 0
        for b, (ni, nj) in enumerate(sizes):
            blk = x1[start:start + ni * nj].reshape(ni, nj, 2)
            if nj > ni:
                X1[b, :nj, :ni] = blk.transpose(1, 0, 2)
            else:
                X1[b, :ni, :nj] = blk
            start += ni * nj
        disp = float(np.sum((x1 - x) ** 2) ** 2)
        return (torch.as_tensor(X1, device=Xpad.device),
                torch.tensor([0.0, 1.0, disp], dtype=torch.float64))

    monkeypatch.setattr(DeviceSmoother, "_solve_impl", control)


@pytest.mark.parametrize("fault", [None, "unchanged_step", "half_batch",
                                   "answer_altered"])
def test_fault_fails_the_check(monkeypatch, fault):
    if fault is not None:
        _plant(monkeypatch, fault)
    cell = tiny.cell(tiny.small())
    run, configs = R.measure(cell, 2**31 + 99, 3.0, False, "cpu")
    assert len(run.jobs) >= 1 and run.meshes > 0
    correct, checks, why = R.judge(run, configs)
    assert correct is (fault is None), (fault, checks, why)


@pytest.mark.parametrize("last_only", [False, True],
                         ids=["every_step", "last_step"])
def test_control_fails_the_check_at_the_cells_size(monkeypatch, last_only):
    """In every step the control folds the wall cells and the job raises;
    in the last step alone it fails the comparison."""
    cell = manifest.load_cell("t106.design_loop")
    plant_control(monkeypatch, cell.config, last_only)
    run, configs = R.measure(cell, 2**33 + 5, 0.5, False, "cpu")
    assert len(run.jobs) == 1
    correct, checks, why = R.judge(run, configs)
    assert correct is False, (checks, why)
    if last_only:
        assert run.meshes > 0 and not run.jobs[0].error
        assert checks["step_residual"]["value"] > \
            3 * checks["step_residual"]["limit"], checks
    else:
        assert run.jobs[0].error, why


def test_traffic_environment_reaches_the_program(monkeypatch):
    # an empty value is no mode; monkeypatch takes the variable away after
    monkeypatch.setenv("TURBOMESH_DEFLATION", "")
    cell = tiny.cell(tiny.small())
    cell.traffic["environment"] = {"TURBOMESH_DEFLATION": "no_such_mode"}
    with pytest.raises(RuntimeError, match="warm-up job failed.*no_such_mode"):
        R.measure(cell, 11, 1.0, False, "cpu")


def test_target_residual_stops_early_and_is_judged():
    """A traffic file's ``target_residual``: the jobs stop before the cap
    once the displacement residual is below it, and are judged so."""
    cell = tiny.cell(tiny.small())
    cell.traffic["smooth_mesh"] = {"solver": "device", "iterations": 8,
                                   "target_residual": 1e-7}
    run, configs = R.measure(cell, 2**31 + 3, 3.0, False, "cpu")
    done = run.finished()
    assert done and all(len(j.iteration_ends) == 5 for j in done)
    correct, checks, why = R.judge(run, configs)
    assert correct, (checks, why)
