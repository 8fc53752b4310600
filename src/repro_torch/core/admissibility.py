"""Admissibility: vectorized level-by-level dual-tree traversal (host/numpy).

Geometric admissibility (paper §2.2):

    eta * ||C_t - C_s||  >=  (D_t + D_s) / 2

with C and D the bounding-box centers and diagonals.  The frontier of
*inadmissible* same-level pairs is expanded level by level into its 2x2
children pairs; admissible pairs become coupling blocks at that level, pairs
surviving to the leaf level become dense blocks.  Same traversal and sort
order as the reference, so the block lists are identical.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .clustering import ClusterTree


@dataclasses.dataclass(frozen=True)
class BlockStructure:
    """Per-level coupling block lists + dense leaf blocks (numpy, host)."""
    depth: int
    s_rows: Tuple[np.ndarray, ...]   # per level l: [nb_l] int64, sorted by row
    s_cols: Tuple[np.ndarray, ...]
    d_rows: np.ndarray
    d_cols: np.ndarray

    def coupling_counts(self) -> Tuple[int, ...]:
        return tuple(int(r.shape[0]) for r in self.s_rows)

    def row_maxb(self) -> Tuple[int, ...]:
        """Max blocks per block row at each level."""
        return tuple(int(np.bincount(r).max()) if r.size else 0
                     for r in self.s_rows)

    def col_maxb(self) -> Tuple[int, ...]:
        return tuple(int(np.bincount(c).max()) if c.size else 0
                     for c in self.s_cols)

    def sparsity_constant(self) -> int:
        """C_sp: the most blocks in any block row at any level, the dense
        leaves included."""
        rows = [r for r in (*self.s_rows, self.d_rows) if r.size]
        return max((int(np.bincount(r).max()) for r in rows), default=0)


def is_admissible(tree: ClusterTree, level: int, t: np.ndarray, s: np.ndarray,
                  eta: float) -> np.ndarray:
    c = tree.centers(level)
    d = tree.diameters(level)
    dist = np.linalg.norm(c[t] - c[s], axis=-1)
    return eta * dist >= 0.5 * (d[t] + d[s])


def build_block_structure(tree: ClusterTree, eta: float,
                          min_level: int = 1) -> BlockStructure:
    """Level-by-level dual tree traversal.

    ``min_level``: coupling blocks are only emitted at levels >= min_level.
    """
    depth = tree.depth
    s_rows: List[np.ndarray] = [np.zeros(0, np.int64) for _ in range(depth + 1)]
    s_cols: List[np.ndarray] = [np.zeros(0, np.int64) for _ in range(depth + 1)]

    ft = np.zeros(1, np.int64)
    fs = np.zeros(1, np.int64)
    for l in range(depth + 1):
        if l >= min_level and ft.size:
            adm = is_admissible(tree, l, ft, fs, eta)
            s_rows[l], s_cols[l] = ft[adm], fs[adm]
            ft, fs = ft[~adm], fs[~adm]
        if l == depth:
            break
        t2 = 2 * ft
        s2 = 2 * fs
        ft = np.stack([t2, t2, t2 + 1, t2 + 1], axis=1).ravel()
        fs = np.stack([s2, s2 + 1, s2, s2 + 1], axis=1).ravel()

    d_rows, d_cols = ft, fs
    out_r, out_c = [], []
    for l in range(depth + 1):
        order = np.lexsort((s_cols[l], s_rows[l]))
        out_r.append(s_rows[l][order])
        out_c.append(s_cols[l][order])
    order = np.lexsort((d_cols, d_rows))
    return BlockStructure(depth=depth, s_rows=tuple(out_r), s_cols=tuple(out_c),
                          d_rows=d_rows[order], d_cols=d_cols[order])


def structure_stats(bs: BlockStructure) -> dict:
    """Coupling blocks per level, dense blocks and C_sp."""
    return {
        "coupling_counts": list(bs.coupling_counts()),
        "dense_count": int(bs.d_rows.shape[0]),
        "C_sp": bs.sparsity_constant(),
    }
