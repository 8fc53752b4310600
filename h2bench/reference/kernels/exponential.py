"""The exponential covariance kernel ``exp(-|x - y| / l)`` (§6.1), plain
PyTorch on float64 tensors."""
from __future__ import annotations

from typing import Callable

import torch


def kernel(spec: dict) -> Callable:
    """The kernel of a configuration's ``kernel`` entry (``length`` l)."""
    length = float(spec["length"])

    def k(x, y):
        return torch.exp(-torch.linalg.norm(x - y, dim=-1) / length)
    return k
