"""Balanced binary KD cluster tree over a point set (host-side, numpy).

The tree is built once on the host and gives the static scaffolding of an
H^2 matrix: a *perfectly balanced* tree (median split on the widest
bounding-box dimension) with ``N = m * 2**depth`` points, so level ``l`` has
exactly ``2**l`` nodes and node data is stored in dense ``[2**l, ...]``
tensors.  The split rule is the reference's, so ``perm`` is identical.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClusterTree:
    """Balanced binary cluster tree.

    Level ``l`` in ``0..depth`` has ``2**l`` nodes; node ``(l, i)`` owns the
    contiguous index range ``[i * N >> l, (i+1) * N >> l)`` of the *permuted*
    point set.
    """

    points: np.ndarray          # [N, dim] points in tree (permuted) order
    perm: np.ndarray            # [N] original index of permuted point i
    depth: int                  # leaf level
    leaf_size: int              # m
    box_min: Tuple[np.ndarray, ...]   # per level: [2**l, dim]
    box_max: Tuple[np.ndarray, ...]   # per level: [2**l, dim]

    @property
    def n(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    def nodes(self, level: int) -> int:
        return 1 << level

    def index_range(self, level: int, i: int) -> Tuple[int, int]:
        w = self.n >> level
        return i * w, (i + 1) * w

    def centers(self, level: int) -> np.ndarray:
        return 0.5 * (self.box_min[level] + self.box_max[level])

    def diameters(self, level: int) -> np.ndarray:
        d = self.box_max[level] - self.box_min[level]
        return np.linalg.norm(d, axis=-1)


def _split_recursive(pts: np.ndarray, idx: np.ndarray, level: int, depth: int,
                     out_perm: np.ndarray, pos: int) -> int:
    """Recursively median-split ``idx`` until ``level == depth``."""
    if level == depth:
        n = idx.shape[0]
        out_perm[pos:pos + n] = idx
        return pos + n
    sub = pts[idx]
    widths = sub.max(axis=0) - sub.min(axis=0)
    axis = int(np.argmax(widths))
    order = np.argsort(sub[:, axis], kind="stable")
    half = idx.shape[0] // 2
    left, right = idx[order[:half]], idx[order[half:]]
    pos = _split_recursive(pts, left, level + 1, depth, out_perm, pos)
    pos = _split_recursive(pts, right, level + 1, depth, out_perm, pos)
    return pos


def build_cluster_tree(points: np.ndarray, leaf_size: int) -> ClusterTree:
    """Build a balanced KD tree; requires ``N == leaf_size * 2**depth``."""
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    if n % leaf_size != 0:
        raise ValueError(f"N={n} must be a multiple of leaf_size={leaf_size}")
    n_leaves = n // leaf_size
    depth = int(round(np.log2(n_leaves)))
    if (1 << depth) != n_leaves:
        raise ValueError(f"N/leaf_size={n_leaves} must be a power of two")

    perm = np.empty(n, dtype=np.int64)
    _split_recursive(points, np.arange(n, dtype=np.int64), 0, depth, perm, 0)
    pts = points[perm]

    box_min, box_max = [], []
    for l in range(depth + 1):
        w = n >> l
        resh = pts.reshape(1 << l, w, -1)
        box_min.append(resh.min(axis=1))
        box_max.append(resh.max(axis=1))
    return ClusterTree(points=pts, perm=perm, depth=depth, leaf_size=leaf_size,
                       box_min=tuple(box_min), box_max=tuple(box_max))


def regular_grid_points(side: int, dim: int, lo: float = 0.0,
                        hi: float = 1.0) -> np.ndarray:
    """Points on a regular ``side**dim`` grid — the paper's §6.1 test sets."""
    axes = [np.linspace(lo, hi, side) for _ in range(dim)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=-1)
