#!/usr/bin/env python3
"""Per-device collective bytes by kind, matrix-product flops and argument
and output bytes of LM dry-run cells at a cut depth: the port's per-rank
walk (``repro_torch.launch.dryrun.dry_cell(..., rank=)`` on ``meta``), or
with ``--reference`` the JAX package's ``repro.launch.dryrun.lower_cell(...,
compile_=True)`` on XLA's CPU backend (its ``collectives``, ``xla_flops``
and ``memory``, read from the compiled, partitioned program).

    PYTHONPATH=src python tools/dry_collectives.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dry_collectives.py \\
        --reference

The cells are qwen3-0.6b train_4k on the (16, 16) and (2, 16, 16)
layouts and qwen3-moe-30b-a3b decode_32k on the (16, 16) one, at 2
layers, rank 0.  One JSON line per cell.  These are counts, not speeds:
no time is printed but the walk's and the compile's seconds.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# (arch, shape, multi-pod)
CELLS = (("qwen3-0.6b", "train_4k", False), ("qwen3-0.6b", "train_4k", True),
         ("qwen3-moe-30b-a3b", "decode_32k", False))
LAYERS = 2


def port(arch: str, shape: str, multi_pod: bool) -> dict:
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import production_layout
    r = D.dry_cell(arch, shape, layout=production_layout(
        multi_pod=multi_pod), n_layers=LAYERS, rank=0)
    keys = ("rank_coords", "collectives", "recv_bytes_by_kind",
            "rank_flops", "rank_matmul_flops", "memory", "rank_walk_s",
            "matmul_flops_per_device", "rank_skipped")
    return {k: r[k] for k in keys if k in r}


def reference(arch: str, shape: str, multi_pod: bool) -> dict:
    import repro.launch.dryrun as R      # sets XLA_FLAGS: 512 host devices
    get = R.get_config

    def cut(name):
        return dataclasses.replace(get(name), n_layers=LAYERS)
    R.get_config = cut
    try:
        r = R.lower_cell(arch, shape, multi_pod=multi_pod, compile_=True)
    finally:
        R.get_config = get
    keys = ("collectives", "collectives_flat", "xla_flops", "memory",
            "flops_per_device", "compile_s")
    return {k: r[k] for k in keys if k in r}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", action="store_true")
    args = ap.parse_args(argv)
    for arch, shape, multi_pod in CELLS:
        out = (reference if args.reference else port)(arch, shape,
                                                       multi_pod)
        print(json.dumps({"arch": arch, "shape": shape,
                          "multi_pod": multi_pod, "layers": LAYERS,
                          "side": "reference" if args.reference
                          else "port", **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
