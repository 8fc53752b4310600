"""Tensor-product Chebyshev interpolation bases, batched on the device.

The paper's initial H^2 approximation (§5, §6.3) interpolates the kernel with
Chebyshev polynomials on cluster bounding boxes: a 6x6 grid in 2D (rank 36),
tri-cubic in 3D (rank 64).  The leaf bases U/V are Lagrange-Chebyshev
evaluations at the cluster's points; interlevel transfers E/F re-interpolate a
parent's polynomial basis at the child's Chebyshev nodes (nested bases);
coupling blocks S are kernel evaluations at Chebyshev node pairs.

Same formulas as the reference's numpy builders, evaluated in float64, but
every level is one batched tensor expression over all of its nodes (or over
chunks of its blocks, so the memory stays bounded) instead of a Python loop
over nodes and blocks.
"""
from __future__ import annotations

import math
from typing import Callable, List, Tuple

import numpy as np
import torch

from .clustering import ClusterTree

# blocks per kernel-evaluation chunk: bounds the float64 temporaries
# ([chunk, k, k, dim] coordinate differences) to a few hundred MB
COUPLING_CHUNK = 1 << 14
DENSE_CHUNK = 1 << 12


def cheb_nodes(p: int, device="cpu") -> torch.Tensor:
    """Chebyshev points of the first kind on [-1, 1] (float64)."""
    i = torch.arange(p, dtype=torch.float64, device=device)
    return torch.cos((2 * i + 1) * math.pi / (2 * p))


def lagrange_eval(nodes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """L[j](x): Lagrange basis on ``nodes`` evaluated at ``x`` -> [*x.shape, p]."""
    p = nodes.shape[0]
    cols = []
    for j in range(p):
        col = torch.ones_like(x)
        for q in range(p):
            if q != j:
                col = col * ((x - nodes[q]) / (nodes[j] - nodes[q]))
        cols.append(col)
    return torch.stack(cols, dim=-1)


def box_nodes(p: int, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Tensor Chebyshev grids in boxes ``[..., dim]`` -> ``[..., p**dim, dim]``.

    The first dimension varies slowest (``meshgrid(indexing="ij")`` order).
    Degenerate box dimensions (hi==lo) collapse to the box's coordinate.
    """
    dim = lo.shape[-1]
    t = 0.5 * (cheb_nodes(p, lo.device) + 1.0)            # [p] in [0, 1]
    axes = lo[..., :, None] + (hi - lo)[..., :, None] * t  # [..., dim, p]
    batch = lo.shape[:-1]
    coords = []
    for d in range(dim):
        shape = [1] * dim
        shape[d] = p
        ax = axes[..., d, :].reshape(*batch, *shape)
        coords.append(ax.expand(*batch, *([p] * dim)).reshape(*batch, p ** dim))
    return torch.stack(coords, dim=-1)


def box_lagrange(p: int, lo: torch.Tensor, hi: torch.Tensor,
                 pts: torch.Tensor) -> torch.Tensor:
    """Tensor Lagrange basis of boxes evaluated at points.

    ``lo``/``hi``: ``[B, dim]``, ``pts``: ``[B, npts, dim]`` ->
    ``[B, npts, p**dim]``.  A degenerate box dimension (width <= 0) gets the
    constant weight ``1/p`` on every node, as in the reference.
    """
    dim = lo.shape[-1]
    nodes = cheb_nodes(p, lo.device)
    out = None
    for d in range(dim):
        w = (hi[:, d] - lo[:, d])[:, None]                 # [B, 1]
        flat = w <= 0
        xr = 2.0 * (pts[..., d] - lo[:, d, None]) / torch.where(
            flat, torch.ones_like(w), w) - 1.0
        ld = lagrange_eval(nodes, xr)                      # [B, npts, p]
        ld = torch.where(flat[..., None], torch.full_like(ld, 1.0 / p), ld)
        out = ld if out is None else \
            (out[..., :, None] * ld[..., None, :]).reshape(
                *ld.shape[:-1], -1)
    return out


def _level_boxes(tree: ClusterTree, level: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    lo = torch.as_tensor(tree.box_min[level], dtype=torch.float64,
                         device=device)
    hi = torch.as_tensor(tree.box_max[level], dtype=torch.float64,
                         device=device)
    return lo, hi


def build_chebyshev_bases(tree: ClusterTree, p: int, device,
                          dtype=torch.float32
                          ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Leaf bases and transfer matrices for every level.

    Returns (u_leaf [2**depth, m, k], transfers list e[l] [2**l, k, k] for
    l=1..depth, with ``e[0]`` an empty ``[0, 0, 0]`` tensor), k = p**dim,
    evaluated in float64 and rounded to ``dtype``.
    """
    depth, m, dim = tree.depth, tree.leaf_size, tree.dim
    nl = 1 << depth
    pts = torch.as_tensor(tree.points, dtype=torch.float64,
                          device=device).reshape(nl, m, dim)
    lo, hi = _level_boxes(tree, depth, device)
    u_leaf = torch.cat([
        box_lagrange(p, lo[a:a + DENSE_CHUNK], hi[a:a + DENSE_CHUNK],
                     pts[a:a + DENSE_CHUNK]).to(dtype)
        for a in range(0, nl, DENSE_CHUNK)])

    transfers = [torch.zeros((0, 0, 0), dtype=dtype, device=device)]
    for l in range(1, depth + 1):
        clo, chi = _level_boxes(tree, l, device)
        plo, phi = _level_boxes(tree, l - 1, device)
        child_nodes = box_nodes(p, clo, chi)               # [2**l, k, dim]
        par = torch.arange(1 << l, device=device) // 2
        transfers.append(box_lagrange(p, plo[par], phi[par],
                                      child_nodes).to(dtype))
    return u_leaf, transfers


def build_coupling(tree: ClusterTree, p: int, level: int, rows: np.ndarray,
                   cols: np.ndarray, kernel: Callable, device,
                   dtype=torch.float32) -> torch.Tensor:
    """S_ts = kernel at Chebyshev-node pairs -> [nb, k, k]."""
    k = p ** tree.dim
    nb = rows.shape[0]
    if nb == 0:
        return torch.zeros((0, k, k), dtype=dtype, device=device)
    lo, hi = _level_boxes(tree, level, device)
    grids = box_nodes(p, lo, hi)                           # [2**l, k, dim]
    r = torch.as_tensor(rows, device=device)
    c = torch.as_tensor(cols, device=device)
    out = torch.empty((nb, k, k), dtype=dtype, device=device)
    for a in range(0, nb, COUPLING_CHUNK):
        b = min(nb, a + COUPLING_CHUNK)
        xt = grids[r[a:b]][:, :, None, :]
        ys = grids[c[a:b]][:, None, :, :]
        out[a:b] = kernel(xt, ys).to(dtype)
    return out


def build_dense(tree: ClusterTree, rows: np.ndarray, cols: np.ndarray,
                kernel: Callable, device, dtype=torch.float32
                ) -> torch.Tensor:
    """Dense leaf blocks ``kernel(x_t, x_s)`` -> [nbd, m, m]."""
    m, nl = tree.leaf_size, 1 << tree.depth
    nb = rows.shape[0]
    out = torch.empty((nb, m, m), dtype=dtype, device=device)
    if nb == 0:
        return out
    pts = torch.as_tensor(tree.points, dtype=torch.float64,
                          device=device).reshape(nl, m, -1)
    r = torch.as_tensor(rows, device=device)
    c = torch.as_tensor(cols, device=device)
    for a in range(0, nb, DENSE_CHUNK):
        b = min(nb, a + DENSE_CHUNK)
        out[a:b] = kernel(pts[r[a:b]][:, :, None, :],
                          pts[c[a:b]][:, None, :, :]).to(dtype)
    return out
