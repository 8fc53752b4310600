"""A regular grid: ``side**dim`` points on ``[lo, hi]^dim``, the last
coordinate running fastest (the paper's §6.1 point sets)."""
from __future__ import annotations

import numpy as np


def points(spec: dict) -> np.ndarray:
    """The grid of a configuration's ``points`` entry, [N, dim] float64."""
    side, dim = int(spec["side"]), int(spec["dim"])
    axes = [np.linspace(spec["lo"], spec["hi"], side) for _ in range(dim)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=-1)
