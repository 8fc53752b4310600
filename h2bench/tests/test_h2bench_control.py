"""The cells' lower-precision control on the card, at 2^16 points: the
sound runs meet the limits of ``limits/<cell>.json``, the control fails
the number it is there to fail.  ``python -m pytest -m cuda
h2bench/tests`` on a machine with a CUDA card."""
import pytest

from _small import GRID, ROOT


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is one precision "
                    "below float32 on the card's matrix products (TF32)")
    return torch


@pytest.mark.cuda
@pytest.mark.parametrize("workload,number", [
    ("hgemv-2d-exp-4m-nv16", "hgemv_rel_err"),
    ("compress-2d-exp-4m-tol1e-3", "coupling_defect")])
def test_control_fails_and_sound_runs_pass(card, workload, number):
    from h2bench import control, harness

    def small(cell):
        cell.config["points"] = dict(GRID, side=256)
        cell.traffic.update(check_rows=256)
        if "pool" in cell.traffic:
            cell.traffic.update(pool=2, warmup=2)
    s = control.readings(workload, [31, 32, 33], [41, 42, 43], 0.5,
                         adjust=small)
    limits = harness.resolve(harness.load_spec(ROOT), workload,
                             ROOT).limits
    for k, v in s.items():
        assert v["lower"] <= limits[k], (k, v)
    assert s[number]["upper"] > limits[number], s[number]
