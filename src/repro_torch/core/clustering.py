"""Balanced binary KD cluster tree over a point set.

The tree is built once, level by level on the construction's device, and
gives the static scaffolding of an H^2 matrix: a *perfectly balanced* tree
(median split on the widest bounding-box dimension) with
``N = m * 2**depth`` points, so level ``l`` has exactly ``2**l`` nodes and
node data is stored in dense ``[2**l, ...]`` tensors.  The split rule is
the reference's, so ``perm``, ``points`` and every box equal its own (a
box side that is zero may differ in the sign of that zero: which one a
min or max keeps follows its order of evaluation); the finished tree is
held in numpy on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


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


def build_cluster_tree(points: np.ndarray, leaf_size: int,
                       device="cpu") -> ClusterTree:
    """Build a balanced KD tree; requires ``N == leaf_size * 2**depth``.

    One pass a level on ``device`` (a ``meta`` device builds on the CPU):
    level ``l``'s nodes are ``2**l`` contiguous runs of ``N >> l`` points
    in the current order, so their boxes are one reduction and their
    median splits one segmented stable sort.  A stable sort of a node's
    keys in the order inherited from its parent is the reference's
    per-node ``argsort(kind="stable")``; adding 0.0 to the keys turns -0.0
    into +0.0, so a radix sort sees the one zero that a comparison sees.
    """
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    if n % leaf_size != 0:
        raise ValueError(f"N={n} must be a multiple of leaf_size={leaf_size}")
    n_leaves = n // leaf_size
    depth = int(round(np.log2(n_leaves)))
    if (1 << depth) != n_leaves:
        raise ValueError(f"N/leaf_size={n_leaves} must be a power of two")

    device = torch.device(device)
    if device.type == "meta":
        device = torch.device("cpu")
    pts = torch.as_tensor(points, device=device)
    dim = pts.shape[1]
    idx = torch.arange(n, device=device)
    boxes = []
    for l in range(depth + 1):
        sub = pts[idx].view(1 << l, n >> l, dim)
        lo, hi = sub.amin(1), sub.amax(1)
        boxes.append(torch.stack((lo, hi)))
        if l == depth:
            break
        axis = (hi - lo).argmax(1)
        key = torch.take_along_dim(sub, axis[:, None, None], 2)[..., 0] + 0.0
        order = torch.sort(key, dim=1, stable=True).indices
        idx = torch.take_along_dim(idx.view(1 << l, -1), order, 1).view(-1)

    # one copy back: every level's boxes side by side, [2, 2**(depth+1)-1, dim]
    lo_hi = torch.cat(boxes, 1).cpu().numpy()
    cuts = [(1 << l) - 1 for l in range(1, depth + 1)]
    return ClusterTree(points=sub.reshape(n, dim).cpu().numpy(),
                       perm=idx.cpu().numpy(), depth=depth,
                       leaf_size=leaf_size,
                       box_min=tuple(np.split(lo_hi[0], cuts)),
                       box_max=tuple(np.split(lo_hi[1], cuts)))


def regular_grid_points(side: int, dim: int, lo: float = 0.0,
                        hi: float = 1.0) -> np.ndarray:
    """Points on a regular ``side**dim`` grid — the paper's §6.1 test sets."""
    axes = [np.linspace(lo, hi, side) for _ in range(dim)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=-1)
