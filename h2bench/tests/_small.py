"""Small versions of the benchmark's cells, which the CPU runs in a
second or two: the same runners, limits and checks at a smaller size."""
from pathlib import Path

from h2bench import harness

ROOT = Path(__file__).resolve().parents[2]
GRID = {"kind": "regular_grid", "side": 128, "dim": 2, "lo": 0.0, "hi": 1.0}


def small_cell(workload: str) -> harness.Cell:
    cell = harness.resolve(harness.load_spec(ROOT), workload, ROOT)
    if cell.traffic["op"] == "hgemv":
        cell.config["points"] = dict(GRID)
        cell.traffic.update(pool=2, warmup=2, check_rows=128)
    elif cell.traffic["op"] == "compress":
        # 2^16 points: at 2^14 the construction's interpolation error
        # alone reads 2.1e-5 against the coupling limit of 2e-5
        cell.config["points"] = dict(GRID, side=256)
        cell.traffic.update(warmup=1, check_rows=128)
    return cell


def run_small(cell: harness.Cell, seed: int = 7, seconds: float = 0.2
              ) -> dict:
    import time
    return harness.run(cell, seed, seconds, False, time.perf_counter(),
                       device="cpu")
