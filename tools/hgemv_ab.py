#!/usr/bin/env python3
"""Time the single-device HGEMV of several source trees in turns on one card.

    python3 tools/hgemv_ab.py build/parent/src src src build/parent/src

Each argument is a ``src`` directory holding ``repro_torch``; each is run
in a child process of its own, in the order given (parent, change, change,
parent compares two versions within one call, on one card).  A child
builds that tree's kernels, constructs the main path's operator (N = 2^20
by default: 2D exponential kernel, l = 0.1, leaf 64, Chebyshev p = 6,
eta = 0.9), compresses it (tol = 1e-3) and prints one JSON line: the
median warm HGEMV nv = 16, uncompressed and compressed (host clock around
a synchronize), the host time to enqueue one HGEMV (no synchronize), and
the four phases by CUDA events.  The last line is a table of the runs.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def child(src: str, log2n: int, reps: int) -> dict:
    sys.path.insert(0, src)
    import torch
    from repro_torch.core import matvec as mv
    from repro_torch.core.clustering import regular_grid_points
    from repro_torch.core.compression import compress
    from repro_torch.core.construction import construct_h2
    from repro_torch.core.kernels_fn import exponential_kernel
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    side = 1 << (log2n // 2)
    x = torch.randn(side * side, 16, generator=torch.Generator().manual_seed(1)
                    ).cuda()
    shape, data, _, _ = construct_h2(regular_grid_points(side, 2),
                                     exponential_kernel(0.1), leaf_size=64,
                                     cheb_p=6, eta=0.9, device="cuda")
    cshape, cdata = compress(shape, data, tol=1e-3, backend="cuda")
    out = {"src": src, "card": torch.cuda.get_device_name(0)}
    for what, s, d in (("uncompressed", shape, data),
                       ("compressed", cshape, cdata)):
        ts = []
        for i in range(reps + 3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            mv.h2_matvec(s, d, x, backend="cuda")
            torch.cuda.synchronize()
            if i >= 3:
                ts.append((time.perf_counter() - t) * 1e3)
        out[f"{what}_ms"] = statistics.median(ts)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            mv.h2_matvec(s, d, x, backend="cuda")
        out[f"{what}_enqueue_ms"] = (time.perf_counter() - t) * 1e3 / reps
        torch.cuda.synchronize()
        xl = x.reshape(s.n_leaves, s.leaf_size, 16)
        names = ("upsweep", "coupling", "downsweep", "dense")
        ph = {k: [] for k in names}
        for i in range(reps + 2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            xhat = mv.upsweep(s, d, xl, "cuda")
            ev[1].record()
            yhat = mv.coupling_multiply(s, d, xhat, "cuda")
            ev[2].record()
            mv.downsweep(s, d, yhat, "cuda")
            ev[3].record()
            mv.dense_multiply(s, d, xl, "cuda")
            ev[4].record()
            torch.cuda.synchronize()
            if i >= 2:
                for j, k in enumerate(names):
                    ph[k].append(ev[j].elapsed_time(ev[j + 1]))
        out[f"{what}_phases_ms"] = {k: statistics.median(v)
                                    for k, v in ph.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("srcs", nargs="+")
    ap.add_argument("--log2n", type=int, default=20)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.srcs[0], args.log2n, args.reps)),
              flush=True)
        return 0
    rows = []
    for src in args.srcs:
        p = subprocess.run([sys.executable, __file__, "--child", src,
                            "--log2n", str(args.log2n), "--reps",
                            str(args.reps)], capture_output=True, text=True)
        if p.returncode != 0:
            print(p.stdout + p.stderr, file=sys.stderr)
            return p.returncode
        rows.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps([{k: r[k] for k in ("src", "uncompressed_ms",
                                         "compressed_ms",
                                         "uncompressed_enqueue_ms",
                                         "compressed_enqueue_ms")}
                      for r in rows]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
