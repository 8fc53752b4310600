"""The harness's guards: no card, forbidden imports, names and units, and
discovery of a configuration, mix and metric added as new files."""
import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from _small import ROOT
from h2bench import harness


@pytest.mark.parametrize("mods,found", [
    (["repro_torch", "repro_torch.core.matvec", "reproducible", "jaxtyping",
      "torch"], []),
    (["repro", "repro.core"], ["repro", "repro.core"]),
    (["jax", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jaxlib.xla_client"]),
])
def test_forbidden_modules_compare_whole_top_level_names(mods, found):
    assert harness.forbidden_modules(mods) == found


def test_no_forbidden_module_in_a_cell_run():
    from _small import run_small, small_cell
    run_small(small_cell("hgemv-2d-exp-4m-nv16"))
    assert harness.forbidden_modules() == []


@pytest.mark.parametrize("name,ok", [
    ("hgemv_ms", True), ("device_idle.hgemv", True), ("h2-2d-exp-4m", True),
    ("_x", True), ("a" * 64, True), ("a" * 65, False), ("has space", False),
    ("a,b", False), ("a/b", False), ("-lead", False), (".lead", False),
    ("muµ", False), ("", False)])
def test_names(name, ok):
    if ok:
        assert harness.check_name(name, "t") == name
    else:
        with pytest.raises(harness.SpecError):
            harness.check_name(name, "t")


@pytest.mark.parametrize("unit,ok", [
    ("ms", True), ("%", True), ("ms/iter", True), ("tokens/s", True),
    ("count", True), ("a" * 16, True), ("a" * 17, False),
    ("per second", False), ("µs", False), ("", False)])
def test_units(unit, ok):
    if ok:
        assert harness.check_unit(unit, "t") == unit
    else:
        with pytest.raises(harness.SpecError):
            harness.check_unit(unit, "t")


def test_spec_with_a_bad_name_is_refused(tmp_path):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["per_layer"][0]["unit"] = "per call"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(harness.SpecError):
        harness.load_spec(tmp_path)


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(ROOT / "h2bench" / "run.py"), "--workload",
         "hgemv-2d-exp-4m-nv16", "--seed", "2147483900", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_run_outside_a_checkout_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "h2bench", tmp_path / "h2bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "h2bench/run.py", "--workload",
         "hgemv-2d-exp-4m-nv16", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _digest(root):
    return {str(p.relative_to(root)): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_are_found_without_editing(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "h2bench", tmp_path / "h2bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "h2bench")
    b = tmp_path / "h2bench"
    cfg = json.loads((b / "configs" / "h2-2d-exp-4m.json").read_text())
    cfg["points"] = {"kind": "random_square", "n": 256}
    cfg["kernel"] = {"name": "gaussian", "length": 0.2}
    (b / "points" / "random_square.py").write_text(
        "import numpy as np\n"
        "def points(spec):\n"
        "    return np.random.default_rng(0).random((spec['n'], 2))\n")
    (b / "reference" / "kernels" / "gaussian.py").write_text(
        "import torch\n"
        "def kernel(spec):\n"
        "    return lambda x, y: torch.exp(-((x - y) ** 2).sum(-1)"
        " / spec['length'] ** 2)\n")
    (b / "cells" / "kernels" / "gaussian.py").write_text(
        "def kernel(spec):\n    return 'the port kernel'\n")
    (b / "configs" / "h2-2d-exp-64.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "hgemv-nv16.json").read_text())
    mix.update(nv=4, pool=2, warmup=2, check_rows=64)
    (b / "traffic" / "hgemv-nv4.json").write_text(json.dumps(mix))
    (b / "limits" / "hgemv-2d-exp-64-nv4.json").write_text(json.dumps(
        {"limits": {"hgemv_rel_err": {"limit": 1e-2}}}))
    (b / "metrics" / "hgemv.calls_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.calls)\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "h2-2d-exp-64", "source": "x",
                            "file": "h2bench/configs/h2-2d-exp-64.json",
                            "reduced": ["points"], "why": "x"})
    spec["workloads"].append({"name": "hgemv-2d-exp-64-nv4",
                              "config": "h2-2d-exp-64",
                              "traffic": "hgemv-nv4", "chips": 1,
                              "why": "x"})
    spec["end_to_end"][0]["workloads"].append("hgemv-2d-exp-64-nv4")
    spec["per_layer"].append({"name": "hgemv.calls_seen", "unit": "count",
                              "better": "higher",
                              "source": "program_counter",
                              "layer": "sweeps", "moves": "hgemv_ms",
                              "workloads": ["hgemv-2d-exp-64-nv4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(tmp_path / "h2bench")
    assert all(after[k] == v for k, v in before.items())
    cell = harness.resolve(harness.load_spec(tmp_path),
                           "hgemv-2d-exp-64-nv4", tmp_path)
    assert cell.config["points"]["n"] == 256 and cell.traffic["nv"] == 4
    assert [m["name"] for m in cell.end_to_end] == ["hgemv_ms", "setup_s"]
    assert "hgemv.calls_seen" in [m["name"] for m in cell.per_layer]
    assert cell.limits == {"hgemv_rel_err": 1e-2}
    # the harness, pointed at the copy, reads the new metric's file
    # the harness, pointed at the copy, reads the new metric's, point set's
    # and kernels' files
    code = ("import sys, torch; sys.path[:0] = [sys.argv[1], sys.argv[2]];"
            "from h2bench import harness;"
            "from h2bench.cells import kernel_operator as ko;"
            "ctx = harness.Context(None, 1.0, 7, {}, {}, 'x');"
            "print(harness.reader('hgemv.calls_seen')(ctx));"
            "cfg = harness.resolve(harness.load_spec(harness.Path(sys.argv[1])),"
            " 'hgemv-2d-exp-64-nv4', harness.Path(sys.argv[1])).config;"
            "p = torch.as_tensor(ko.points(cfg));"
            "print(tuple(p.shape), ko.program_kernel(cfg));"
            "print(float(ko.reference_kernel(cfg)(p[0], p[0])))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                          str(ROOT / "src")], capture_output=True,
                         text=True, check=True)
    assert out.stdout.split("\n")[:3] == ["7.0", "(256, 2) the port kernel",
                                          "1.0"]


@pytest.mark.parametrize("entry,value,find", [
    ("points", {"kind": "random_cube", "n": 8}, "points"),
    ("points", {"kind": "../configs/x", "n": 8}, "points"),
    ("kernel", {"name": "matern", "length": 0.1}, "program_kernel"),
    ("kernel", {"name": "matern", "length": 0.1}, "reference_kernel")])
def test_an_unknown_point_set_or_kernel_is_refused(entry, value, find):
    from h2bench.cells import kernel_operator
    with pytest.raises(harness.SpecError):
        getattr(kernel_operator, find)({entry: value})
