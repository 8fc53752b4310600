"""Read a cell's checked numbers over many seeds, on sound runs, under
its lower-precision control and with a fault planted in the program, to
set the limits of ``limits/<cell>.json``.

    python3 h2bench/control.py --workload <name> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ... \
        [--faults <name> ... --fault-seeds <n> ...]

The control is one precision below the configuration's float32 (TF32,
float32 with TF32 off being the port's precision): the reference rounded
to float32 and multiplied in TF32 in the program's place where the
program's timed path has no matrix product of PyTorch's (the HGEMV's
kernels), and the program itself with TF32 switched on where it has
(the recompression).  Each run is a whole cell run, a short window at
the cell's own sizes, in this one process; the
operator, which no seed changes, is built once for the sound runs and
once for the control's.  The benchmark's own runs never run this.  Prints
one JSON line per run and the largest sound and smallest control reading
of each number.  ``FAULTS`` are the faults a cell's check has to fail,
planted where the program produces its answer.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from h2bench import harness  # noqa: E402


def _hgemv_fault(kind):
    from repro_torch.core import matvec
    real = matvec.h2_matvec

    def broken(shape, data, x, backend="cuda"):
        if kind == "unchanged":
            return x.clone()
        y = real(shape, data, x, backend)
        if kind == "half":
            y[:, y.shape[1] // 2:] = y[:, :y.shape[1] // 2].mean(
                dim=1, keepdim=True)
        elif kind == "altered":
            y[::7] *= 1.01
        return y
    return matvec, "h2_matvec", broken


def _compress_fault(kind):
    import dataclasses
    from repro_torch.core import compression
    real = compression.compress

    def broken(shape, data, tol=None, **kw):
        if kind == "unchanged":
            return shape, data
        s, d = real(shape, data, tol=tol, **kw)
        if kind == "altered":
            lv = max(range(len(d.s)), key=lambda i: d.s[i].shape[0])
            s_new = list(d.s)
            s_new[lv] = s_new[lv] * 1.05
            return s, dataclasses.replace(d, s=s_new)
        # the rank pick one short at every level: the same recompression
        # to the ranks the tolerance picked, less one
        cut = [max(r - 1, 1) if r else 0 for r in s.ranks]
        del s, d
        return real(shape, data, target_ranks=cut, **kw)
    return compression, "compress", broken


#: a fault by its name: ``(module, attribute, replacement)`` to plant
FAULTS = {
    "hgemv.unchanged": lambda: _hgemv_fault("unchanged"),
    "hgemv.half": lambda: _hgemv_fault("half"),
    "hgemv.altered": lambda: _hgemv_fault("altered"),
    "compress.unchanged": lambda: _compress_fault("unchanged"),
    "compress.altered": lambda: _compress_fault("altered"),
    "compress.rank_cut": lambda: _compress_fault("rank_cut"),
}


def _built_once():
    """Build the operator once for each configuration and precision."""
    import torch
    from h2bench.cells import kernel_operator
    real, last = kernel_operator.build, {}

    def build(cfg, dev):
        key = (json.dumps(cfg, sort_keys=True), str(dev),
               torch.backends.cuda.matmul.allow_tf32)
        if last.get("key") != key:
            last.clear()
            last["op"] = real(cfg, dev)
            last["key"] = key
        return last["op"]
    kernel_operator.build = build
    return lambda: setattr(kernel_operator, "build", real)


def readings(workload: str, seeds, control_seeds, seconds: float,
             device: str = "cuda", root: Path = ROOT, adjust=None,
             faults=(), fault_seeds=()) -> dict:
    """Sound, control and fault readings of each checked number;
    ``adjust`` edits the cell (its configuration and traffic) before the
    runs, ``faults`` names some of ``FAULTS``, each run on
    ``fault_seeds``."""
    import torch
    cell = harness.resolve(harness.load_spec(root), workload, root)
    if adjust is not None:
        adjust(cell)
    runs = []
    restore = _built_once()
    groups = [(None, seeds), ("tf32", control_seeds)]
    groups += [(f, fault_seeds) for f in faults]
    for control, group in groups:
        planted = None
        if control in FAULTS:
            mod, attr, broken = FAULTS[control]()
            planted = (mod, attr, getattr(mod, attr))
            setattr(mod, attr, broken)
        for seed in group:
            t = time.perf_counter()
            try:
                out = harness.run(cell, seed, seconds, False, t,
                                  device=device,
                                  control="tf32" if control == "tf32"
                                  else None)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            row = {"control": control, "seed": seed,
                   "correct": out["correct"], "failed": out["failed"],
                   "attempted": out["attempted"],
                   "checks": {k: v["value"] for k, v in
                              out["checks"].items()}}
            print(json.dumps(row), flush=True)
            runs.append(row)
        if planted:
            setattr(*planted)
    restore()
    names = sorted({k for r in runs for k in r["checks"]})
    summary = {}
    for k in names:
        sound = [r["checks"][k] for r in runs if r["control"] is None]
        ctrl = [r["checks"][k] for r in runs if r["control"] == "tf32"]
        bad = {f: [r["checks"][k] for r in runs if r["control"] == f]
               for f in faults}
        summary[k] = {"lower": max(sound) if sound else None,
                      "upper": min(ctrl) if ctrl else None,
                      "sound": sound, "control": ctrl, "faults": bad}
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[],
                    choices=sorted(FAULTS))
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    summary = readings(args.workload, args.seeds, args.control_seeds,
                       args.seconds, faults=args.faults,
                       fault_seeds=args.fault_seeds)
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
