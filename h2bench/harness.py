"""The benchmark's harness: it reads ``BENCHMARK.json``, finds a cell's
configuration, traffic mix, limits, runner and per-layer readers by their
names, runs the cell and prints its result.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by name:

- ``h2bench/configs/<config>.json``: the configuration's sizes (the file
  ``BENCHMARK.json`` names);
- ``h2bench/traffic/<traffic>.json``: the mix's parameters; its ``op``
  names the runner, ``h2bench/cells/<op>.py``, which calls the port;
- ``h2bench/limits/<workload>.json``: the limit of each number that the
  cell's check compares, with the readings it was set from;
- ``h2bench/metrics/<metric>.py``: a reader, ``read(ctx)``, returning the
  metric's value or None where it finds nothing to read;
- ``h2bench/points/<kind>.py``, ``h2bench/cells/kernels/<name>.py`` and
  ``h2bench/reference/kernels/<name>.py``: a configuration's point set,
  and its kernel on the port's side and the reference's
  (``cells/kernel_operator.py``).

A later cell, configuration or metric is added by adding such files and
entries; no file here changes.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
#: top-level module names that no run may load: JAX, its libraries and the
#: JAX package this port was made from (compared whole: ``repro_torch``
#: is the port and is allowed)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class SpecError(ValueError):
    """``BENCHMARK.json`` or a file it leads to breaks the benchmark's
    rules."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise SpecError(f"{what} {name!r}: a name is 1 to 64 letters, "
                        f"digits, '_', '.' and '-', not starting with "
                        f"'.' or '-'")
    return name


def check_unit(unit: str, what: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise SpecError(f"{what} unit {unit!r}: 1 to 16 letters, digits, "
                        f"'_', '/', '%', '.' and '-'")
    return unit


def load_spec(root: Path) -> dict:
    """``BENCHMARK.json`` under ``root``, its names and units checked."""
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no BENCHMARK.json in {root}")
    spec = json.loads(path.read_text())
    for c in spec["configs"]:
        check_name(c["name"], "configuration")
    for w in spec["workloads"]:
        check_name(w["name"], "workload")
        check_name(w["config"], "workload config")
        check_name(w["traffic"], "workload traffic")
    for m in spec["end_to_end"] + spec["per_layer"]:
        check_name(m["name"], "metric")
        check_unit(m["unit"], f"metric {m['name']}")
    return spec


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def _load_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise SpecError(f"{what}: no file {path}")
    return json.loads(path.read_text())


def load_module(path: Path, what: str):
    """The module in the file ``path`` (a runner, a reader, a point set or
    a kernel found by its name)."""
    if not path.is_file():
        raise SpecError(f"{what}: no file {path}")
    tag = "_".join(p.replace(".", "_") for p in path.parts[-3:-1])
    spec = importlib.util.spec_from_file_location(
        f"h2bench_{tag}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with every file it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    runner: object
    base: Path = HERE


def resolve(spec: dict, workload: str, root: Path) -> Cell:
    """The cell ``workload``: its configuration file, traffic file, limits,
    runner module, and the metrics it reports."""
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {workload}: no configuration "
                        f"{w['config']!r}")
    config = _load_json(root / configs[w["config"]]["file"],
                        f"configuration {w['config']}")
    base = root / "h2bench"
    traffic = _load_json(base / "traffic" / f"{w['traffic']}.json",
                         f"traffic {w['traffic']}")
    limits = _load_json(base / "limits" / f"{workload}.json",
                        f"limits of {workload}")["limits"]
    op = check_name(traffic["op"], f"traffic {w['traffic']} op")
    runner = load_module(base / "cells" / f"{op}.py", f"runner {op}")

    def here(m):
        return workload in m.get("workloads", [workload])
    e2e = [m for m in spec["end_to_end"] if here(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if m["moves"] in moved and here(m)]
    return Cell(workload, int(w["chips"]), config, traffic,
                {k: float(v["limit"]) for k, v in limits.items()}, e2e,
                layer, runner, base)


def reader(metric: str, base: Path = HERE) -> Callable:
    """The ``read`` function of ``<base>/metrics/<metric>.py``."""
    return load_module(base / "metrics" / f"{metric}.py",
                        f"metric {metric}").read


def power_limit() -> Callable[[], str]:
    """Start ``nvidia-smi`` on the card's name and power limit; the
    returned function waits for it and gives what it read (so that its
    start-up runs beside the cell's set-up, not inside it)."""
    try:
        proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    except OSError as exc:
        return lambda: f"nvidia-smi unavailable ({exc})"

    def result() -> str:
        try:
            out, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            return "nvidia-smi did not answer"
        return out.strip().replace("\n", "; ") or err.strip()
    return result


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def seed_rng(seed: int):
    """Non-negative 63-bit seed for ``torch`` and ``numpy``."""
    return int(seed) & ((1 << 63) - 1)


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the traced window's summary, the
    measured window, the runner's counters and the work of each span per
    call."""

    trace: object
    window_s: float
    calls: int
    counters: Dict[str, float]
    work: Dict[str, object]
    call_span: str


def run(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", control: Optional[str] = None,
        after_setup: Callable[[], None] = lambda: None) -> dict:
    """Set the cell up, measure its window, read its trace and check its
    answers; returns the result's object (``control`` runs the cell's
    lower-precision control in the program's place: not a benchmark
    run)."""
    import torch

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    runner = cell.runner.Cell(cell.config, cell.traffic, seed_rng(seed),
                           device, control=control)
    t_runner = time.perf_counter()
    runner.setup()
    sync()
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    setup_s = time.perf_counter() - t0
    log(f"setup {setup_s:.3f} s: {t_runner - t0:.3f} s before the cell's "
        f"runner (imports, the card), then (s) "
        f"{getattr(runner, 'parts', {})}")
    after_setup()
    calls, t_start = 0, time.perf_counter()
    while True:
        runner.call()
        calls += 1
        if time.perf_counter() - t_start >= seconds and \
                calls >= runner.min_calls:
            break
    sync()
    window_s = time.perf_counter() - t_start
    metrics: Dict[str, dict] = {}
    device_info: Dict[str, object] = {}
    breakdown = None
    if trace:
        counters = runner.counters()
        summary = runner.traced()
        ctx = Context(summary, window_s, calls, counters, runner.work(),
                      runner.SPAN)
        for m in cell.per_layer:
            v = reader(m["name"], cell.base)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info = {"busy_s": summary.busy_s,
                       "window_s": summary.window_s}
        breakdown = {"device_ops": summary.device_ops,
                     "idle_gaps": summary.idle_gaps}
    else:
        values = runner.end_to_end(window_s, calls)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    runner.release()
    checks, attempted, failed = runner.check(calls)
    compared = {k: {"value": v, "limit": cell.limits[k]}
                for k, v in checks.items()}
    correct = failed == 0 and all(
        v == v and v <= cell.limits[k] for k, v in checks.items())
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": torch.cuda.get_device_name(0) if on_card
                      else "cpu",
                      "count": cell.chips, "memory_peak_bytes": int(peak),
                      **device_info}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = compared
    return out


class ForbiddenImport(RuntimeError):
    def __init__(self, found: List[str]):
        super().__init__("forbidden modules loaded: " + ", ".join(found))
        self.found = found


def main(argv: List[str], t0: float, root: Path) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec(root)
    cell = resolve(spec, args.workload, root)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA card: the benchmark runs only on one")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"the cell needs {cell.chips} cards, this machine has "
            f"{torch.cuda.device_count()}")
        return 3
    smi = power_limit()
    log(f"card: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, {cell.chips} used")

    def card_line():
        log(f"nvidia-smi (name, power limit): {smi()}")
    try:
        out = run(cell, args.seed, args.seconds, bool(args.trace), t0,
                  after_setup=card_line)
    except ForbiddenImport as exc:
        log(str(exc))
        return 4
    found = forbidden_modules()
    if found:
        log("forbidden modules loaded: " + ", ".join(found))
        return 4
    for k, v in out["checks"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0
