"""Construct a concrete H^2 matrix from (points, kernel, admissibility).

Two construction paths share this entry point:

- ``method="cheb"`` (default) -- the paper's path: cluster tree (built on
  ``device``) -> dual-tree traversal (host numpy, vectorized) -> Chebyshev
  interpolation for the low-rank blocks and direct kernel evaluation for
  the dense leaves.  The kernel evaluations run batched on ``device`` in
  float64 and are rounded to ``dtype``.
- ``method="sketch"`` -- the on-device randomized sketching path
  (``repro_torch.sketch``): batched kernel-block sampling + nested-basis
  rangefinder, in ``dtype`` on ``device``; extra options go in
  ``sketch_opts`` (tol, max_rank, oversample, n_samples0, seed, chunk,
  backend).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.trace import phase

from .admissibility import BlockStructure, build_block_structure
from .chebyshev import build_chebyshev_bases, build_coupling, build_dense
from .clustering import ClusterTree, build_cluster_tree
from .structure import H2Data, H2Shape, build_coupling_plan, remarshal


def construct_h2(points: np.ndarray, kernel: Callable, leaf_size: int,
                 cheb_p: int, eta: float, dtype=torch.float32,
                 min_level: int = 1, method: str = "cheb",
                 sketch_opts: Optional[dict] = None, device="cuda"
                 ) -> Tuple[H2Shape, H2Data, ClusterTree, BlockStructure]:
    """Build an H^2 approximation of the kernel matrix K[i,j]=kernel(x_i,x_j).

    ``kernel`` takes torch tensors (``repro_torch.core.kernels_fn``).  The
    matrix acts on vectors in *tree (permuted) order*; ``tree.perm`` maps
    between orderings.
    """
    if method == "sketch":
        from repro_torch.sketch.construct import sketch_construct
        return sketch_construct(points, kernel, leaf_size, eta,
                                min_level=min_level, dtype=dtype,
                                device=device, **(sketch_opts or {}))
    if method != "cheb":
        raise ValueError(f"unknown construction method {method!r}")
    device = torch.device(device)
    # the spans are host time (no synchronize): a stage's queued device
    # work lands in the next span that waits for the device
    with phase("construct/cluster-tree"):
        tree = build_cluster_tree(points, leaf_size, device)
    with phase("construct/block-structure"):
        bs = build_block_structure(tree, eta, min_level=min_level)
    k = cheb_p ** tree.dim
    depth = tree.depth

    with phase("construct/bases"):
        u_leaf, e_list = build_chebyshev_bases(tree, cheb_p, device, dtype)
    with phase("construct/coupling"):
        s_list = [build_coupling(tree, cheb_p, l, bs.s_rows[l],
                                 bs.s_cols[l], kernel, device, dtype)
                  for l in range(depth + 1)]
    with phase("construct/dense"):
        dense = build_dense(tree, bs.d_rows, bs.d_cols, kernel, device,
                            dtype)

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    with phase("construct/marshal"):
        plan = build_coupling_plan(depth, bs.s_rows, bs.s_cols,
                                   bs.d_rows, bs.d_cols, device)
        data = remarshal(H2Data(
            u_leaf=u_leaf, v_leaf=u_leaf, e=e_list, f=list(e_list),
            s=s_list, s_rows=[i32(r) for r in bs.s_rows],
            s_cols=[i32(c) for c in bs.s_cols],
            dense=dense, d_rows=i32(bs.d_rows), d_cols=i32(bs.d_cols),
            plan=plan))

    shape = H2Shape(
        n=tree.n, leaf_size=leaf_size, depth=depth,
        ranks=tuple([k] * (depth + 1)),
        coupling_counts=bs.coupling_counts(),
        dense_count=int(bs.d_rows.shape[0]),
        symmetric=True,
        row_maxb=bs.row_maxb(), col_maxb=bs.col_maxb(),
        dense_maxb=int(plan.dblk.shape[0]) >> depth)
    return shape, data, tree, bs


def dense_reference(points: np.ndarray, kernel: Callable, perm: np.ndarray,
                    device="cpu") -> torch.Tensor:
    """Exact dense kernel matrix in tree order, float64 (small N only)."""
    p = torch.as_tensor(points[perm] if perm is not None else points,
                        dtype=torch.float64, device=device)
    return kernel(p[:, None, :], p[None, :, :])

