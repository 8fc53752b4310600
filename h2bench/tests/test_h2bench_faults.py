"""A run of each cell, at a small size on the CPU with the chip's look
skipped, comes out correct; with its timed path broken underneath, it
comes out not correct: a step that returns its state unchanged, half of a
batch left out, an answer altered where it is produced, the points' order
that is no permutation."""
import pytest

from _small import run_small, small_cell
from h2bench import control

HGEMV = "hgemv-2d-exp-4m-nv16"
COMPRESS = "compress-2d-exp-4m-tol1e-3"


@pytest.mark.parametrize("workload", [HGEMV, COMPRESS])
def test_sound_run_is_correct(workload):
    out = run_small(small_cell(workload))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for v in out["checks"].values())


# ``compress.rank_cut`` sets the upper reading of ``compress_rel_err`` at
# the cell's own size; at this small size its ranks are too few to read
# past the limit (3.1e-3 against 4e-3)
@pytest.mark.parametrize("fault", sorted(set(control.FAULTS)
                                         - {"compress.rank_cut"}))
def test_fault_is_caught(monkeypatch, fault):
    mod, attr, broken = control.FAULTS[fault]()
    monkeypatch.setattr(mod, attr, broken)
    out = run_small(small_cell(HGEMV if fault.startswith("hgemv.")
                               else COMPRESS))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", [HGEMV, COMPRESS])
def test_order_that_is_no_permutation_is_caught(monkeypatch, workload):
    from h2bench.cells import kernel_operator
    real = kernel_operator.build

    def broken(cfg, dev):
        op = real(cfg, dev)
        op.perm = op.perm.clone()
        op.perm[1] = op.perm[0]
        return op
    monkeypatch.setattr(kernel_operator, "build", broken)
    out = run_small(small_cell(workload))
    assert not out["correct"], out["checks"]
