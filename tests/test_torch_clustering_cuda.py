"""The cluster tree built on the card against the per-node recursion
(the reference's algorithm, kept here in plain numpy so that this file
needs no JAX): ``perm`` and ``points`` bit for bit, and every level's
boxes (a zero side taken as +0.0).  Run on the card with
``python -m pytest -q -m cuda tests/test_torch_clustering_cuda.py``."""
import types

import numpy as np
import pytest
import torch

from repro_torch.core.clustering import build_cluster_tree
from torch_clustering_sets import SETS, assert_same_tree


def _split(pts, idx, level, depth, out, pos):
    if level == depth:
        out[pos:pos + idx.shape[0]] = idx
        return pos + idx.shape[0]
    sub = pts[idx]
    axis = int(np.argmax(sub.max(axis=0) - sub.min(axis=0)))
    order = np.argsort(sub[:, axis], kind="stable")
    half = idx.shape[0] // 2
    pos = _split(pts, idx[order[:half]], level + 1, depth, out, pos)
    return _split(pts, idx[order[half:]], level + 1, depth, out, pos)


def loop_tree(points, leaf):
    """Perm, points and boxes by the reference's recursion, one node at a
    time, with its boxes reduced from the leaves upward."""
    n = points.shape[0]
    depth = (n // leaf).bit_length() - 1
    perm = np.empty(n, dtype=np.int64)
    _split(points, np.arange(n, dtype=np.int64), 0, depth, perm, 0)
    pts = points[perm]
    lo = [pts.reshape(1 << depth, leaf, -1).min(axis=1)]
    hi = [pts.reshape(1 << depth, leaf, -1).max(axis=1)]
    for _ in range(depth):
        lo.insert(0, np.minimum(lo[0][0::2], lo[0][1::2]))
        hi.insert(0, np.maximum(hi[0][0::2], hi[0][1::2]))
    return types.SimpleNamespace(points=pts, perm=perm, depth=depth,
                                 leaf_size=leaf, box_min=lo, box_max=hi)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tree is built on it")
    return torch.device("cuda")


def test_loop_tree_is_the_reference_algorithm():
    """On the CPU: the loop version above gives the port's CPU tree."""
    pts = SETS["ties"](1 << 12, seed=1)
    assert_same_tree(loop_tree(pts, 8), build_cluster_tree(pts, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("leaf", [8, 64])
@pytest.mark.parametrize("kind", sorted(SETS))
def test_card_tree_matches(cuda, kind, leaf):
    pts = SETS[kind](1 << 16, seed=leaf)
    assert_same_tree(build_cluster_tree(pts, leaf, device=cuda),
                     loop_tree(pts, leaf))


@pytest.mark.cuda
def test_card_tree_matches_on_the_configuration_grid(cuda):
    """The 2048 x 2048 grid on [0, 1]^2 at leaf 64 of ``h2-2d-exp-4m``."""
    pts = SETS["grid"](1 << 22, seed=0)
    assert_same_tree(build_cluster_tree(pts, 64, device=cuda),
                     loop_tree(pts, 64))
