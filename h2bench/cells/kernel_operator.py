"""The H² operator of a kernel configuration, as the port's
``construct_h2`` builds it, and what a check needs beside it.  The point
set and the kernel are found by the names the configuration gives:

- ``h2bench/points/<points.kind>.py``: ``points(spec)``, the point set
  (NumPy float64) that both sides are handed;
- ``h2bench/cells/kernels/<kernel.name>.py``: ``kernel(spec)``, the port's
  kernel function;
- ``h2bench/reference/kernels/<kernel.name>.py``: ``kernel(spec)``, the
  plain float64 one.

A configuration with another point set or kernel adds those files.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from h2bench import harness, work

BASE = Path(__file__).resolve().parent.parent


def _found(folder: Path, name: str, what: str):
    return harness.load_module(
        folder / f"{harness.check_name(name, what)}.py", what)


def points(cfg: dict) -> np.ndarray:
    spec = cfg["points"]
    return _found(BASE / "points", spec["kind"], "point set").points(spec)


def program_kernel(cfg: dict) -> Callable:
    spec = cfg["kernel"]
    return _found(BASE / "cells" / "kernels", spec["name"],
                  "kernel").kernel(spec)


def reference_kernel(cfg: dict) -> Callable:
    spec = cfg["kernel"]
    return _found(BASE / "reference" / "kernels", spec["name"],
                  "reference kernel").kernel(spec)


@dataclasses.dataclass
class Operator:
    pts: np.ndarray               # the points in their own order
    shape: object                 # the port's H2Shape
    data: object                  # the port's H2Data, in tree order
    perm: torch.Tensor            # tree position -> point index
    opshape: work.OpShape


def build(cfg: dict, dev: torch.device) -> Operator:
    from repro_torch.core.construction import construct_h2
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    pts = points(cfg)
    shape, data, tree, _ = construct_h2(
        pts, program_kernel(cfg), leaf_size=cfg["leaf_size"],
        cheb_p=cfg["cheb_p"], eta=cfg["eta"], device=dev)
    return Operator(pts, shape, data, torch.as_tensor(tree.perm, device=dev),
                    work.op_shape(data.u_leaf, data.e, data.s, data.dense,
                                  symmetric=data.v_leaf is data.u_leaf))


def tree_points(op: Operator) -> Optional[torch.Tensor]:
    """The points in the operator's tree order, float64, on the
    operator's device; None where the port's order is no permutation of
    the points."""
    n = op.pts.shape[0]
    perm = op.perm.long()
    if perm.shape != (n,) or int(perm.min()) < 0 or int(perm.max()) >= n \
            or not bool((torch.bincount(perm, minlength=n) == 1).all()):
        return None
    p = torch.as_tensor(op.pts, dtype=torch.float64, device=op.perm.device)
    return p[perm]
