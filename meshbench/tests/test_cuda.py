"""On the card (marker ``cuda``; skips without one): the faults of
``test_faults`` planted under the card's path, through the K-A kernel, and
the control in the program's place at the cell's own size.

    python -m pytest -m cuda meshbench/tests -p no:cacheprovider
"""

import pytest

from meshbench import run as R
from meshbench.tests import tiny
from meshbench.tests.test_faults import _plant


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "unchanged_step", "half_batch",
                                   "answer_altered"])
def test_fault_fails_the_check_on_the_card(monkeypatch, fault):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if fault is not None:
        _plant(monkeypatch, fault)
    cell = tiny.cell(tiny.half_t106(), limits={"frontend_gap": 1e-10,
                                               "step_residual": 0.05})
    run, configs = R.measure(cell, 2**31 + 7, 2.0, False, "cuda")
    assert run.meshes > 0 and run.peak_bytes > 0
    correct, checks, why = R.judge(run, configs)
    assert correct is (fault is None), (fault, checks, why)


@pytest.mark.cuda
@pytest.mark.parametrize("last_only", [False, True],
                         ids=["every_step", "last_step"])
def test_control_fails_the_check_on_the_card(monkeypatch, last_only):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from meshbench import manifest
    from meshbench.tests.test_faults import plant_control

    cell = manifest.load_cell("t106.design_loop")
    plant_control(monkeypatch, cell.config, last_only)
    run, configs = R.measure(cell, 2**33 + 17, 0.5, False, "cuda")
    correct, checks, why = R.judge(run, configs)
    assert correct is False, (checks, why)
    if last_only:
        assert run.meshes > 0 and checks["step_residual"]["value"] > \
            3 * checks["step_residual"]["limit"], checks
