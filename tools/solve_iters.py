#!/usr/bin/env python3
"""Iteration counts of the §6.4 fractional-diffusion solve at several grid
sides: the port's ``repro_torch.apps.fractional.solve`` on ``--device``
(default ``cuda``), or with ``--reference`` the JAX package's
``repro.apps.fractional.solve`` (XLA, on the CPU here).

    PYTHONPATH=src python tools/solve_iters.py --device cpu 16 32 64 128
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/solve_iters.py \\
        --reference 16 32 64 128

One line per n: PCG iterations, recurrence relres, status, and the
iterations before the relative residual first reached 1e-6 and 1e-7 (the
convergence rate; the final count at tol = 1e-8 sits on the float32
rounding floor and moves with the summation order).  ``--stag-window``
sets the port's PCG stagnation window (the reference's solve has the
default, 30), ``--backend`` the port's HGEMV backend, ``--threads`` its
CPU threads, and ``--tail K`` adds the last K residuals of the history.
These are counts, not speeds: no time is printed.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def reached(hist, level: float) -> int:
    h = np.asarray(hist)
    hit = np.flatnonzero(h <= level)
    return int(hit[0]) if hit.size else -1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="+", help="grid sides")
    ap.add_argument("--reference", action="store_true",
                    help="run the JAX reference instead of the port")
    ap.add_argument("--device", default="cuda", help="the port's device")
    ap.add_argument("--maxiter", type=int, default=500)
    ap.add_argument("--stag-window", type=int, default=30,
                    help="the port's PCG stagnation window")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch CPU threads (0: torch's default)")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"),
                    help="the port's HGEMV backend")
    ap.add_argument("--tail", type=int, default=0,
                    help="print the history's last TAIL residuals")
    args = ap.parse_args()
    if args.reference:
        from repro.apps.fractional import solve
        what = "reference (repro, XLA)"
    else:
        import torch
        from repro_torch.apps.fractional import solve
        if args.threads:
            torch.set_num_threads(args.threads)
        what = f"port (repro_torch, backend={args.backend}) on {args.device}"
        if args.device == "cuda":
            what += f" ({torch.cuda.get_device_name(0)})"
    for n in args.n:
        kw = {} if args.reference else {"device": args.device,
                                        "stag_window": args.stag_window,
                                        "backend": args.backend}
        r = solve(n, maxiter=args.maxiter, **kw)
        hist = r["history"]
        hist = hist.cpu().numpy() if hasattr(hist, "cpu") else hist
        print(f"{what}: n={n} N={n * n} iters={r['iters']} relres="
              f"{r['relres']:.3e} status={r['status']} to_1e-6="
              f"{reached(hist, 1e-6)} to_1e-7={reached(hist, 1e-7)}" +
              ("".join(f" {v:.3g}" for v in hist[max(r["iters"] + 1 -
                                                      args.tail, 0):
                                                  r["iters"] + 1])
               if args.tail else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
